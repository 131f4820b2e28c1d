// K1: column-major Forward fill of a chain-x x DAG-y merge on Hopper.
//
// Replaces the Pallas TPU kernel
// historian_tpu/ops/pallas_colforward.py::pallas_col_forward_cells
// (body `_kernel` / `_column_step`, scans `_affine_scan_lanes`), with the
// same arguments and the same [5, SY, SX] output (IMM, IMD, IDM, IMI, IIW).
// The match emission and the band gate are read from the [SY, SX] planes
// `absorb` and `maskg` that the bridge built; `lanes` (may be null) says
// which lanes of each column can be inside the band, and the strips with
// none skip the column.
//
// The column fill itself, what bounds it on this card (a sequential
// column chain, a chain of log-sum-exps a lane: latency) and the design
// against that bound (a pipeline of lane strips, one block each, across
// the SMs) are in colforward_step.cuh, which K2 (colforward_fused.cu)
// shares.  The kernel allocates nothing and launches on the caller's
// stream.

#include "colforward_step.cuh"

namespace {

// K1's emission: the bridge's planes, one coalesced read each per cell.
template <typename T>
struct PlaneEmission {
  const T* __restrict__ absorb;
  const T* __restrict__ maskg;
  __device__ __forceinline__ void start(int) {}
  __device__ __forceinline__ void column(int) {}
  __device__ __forceinline__ void cell(int, int, size_t at, T& a, T& mg) {
    a = absorb[at];
    mg = maskg[at];
  }
};

template <typename T, int NT>
__global__ void __launch_bounds__(NT) colforward_kernel(
    const int* __restrict__ y_src, const T* __restrict__ y_lp,
    const T* __restrict__ y_flags, const T* __restrict__ absorb,
    const T* __restrict__ maskg, const T* __restrict__ xvec,
    const T* __restrict__ trans, const int* __restrict__ lanes, int* progress, T* rec,
    T* out, int SY, int SX, int KY) {
  PlaneEmission<T> em{absorb, maskg};
  colfill::column_fill<T, NT>(y_src, y_lp, y_flags, 4, xvec, trans, lanes, progress, rec, out,
                              SY, SX, KY, em);
}

// K1's strip width (ops/colforward.py STRIP_WIDTH): the fastest of 64,
// 128, 256 and 512 lanes at long12's first-merge shape in both dtypes
// (PERF.md).
constexpr int kNS = 128;

template <typename T>
int launch(const int* y_src, const T* y_lp, const T* y_flags, const T* absorb,
           const T* maskg, const T* xvec, const T* trans, const int* lanes, int* progress,
           T* rec, T* out, int SY, int SX, int KY, int NS, cudaStream_t stream) {
  if (NS != kNS) return int(cudaErrorInvalidValue);
  void* args[] = {&y_src, &y_lp, &y_flags, &absorb, &maskg, &xvec, &trans, &lanes,
                  &progress, &rec, &out, &SY, &SX, &KY};
  return colfill::launch_strips(colforward_kernel<T, kNS>, (SX + kNS - 1) / kNS, kNS, 0, args,
                                stream);
}

}  // namespace

extern "C" int colforward_f32(const int* y_src, const float* y_lp,
                              const float* y_flags, const float* absorb,
                              const float* maskg, const float* xvec,
                              const float* trans, const int* lanes, int* progress,
                              float* rec, float* out, int SY, int SX, int KY, int NS,
                              void* stream) {
  return launch<float>(y_src, y_lp, y_flags, absorb, maskg, xvec, trans, lanes, progress, rec,
                       out, SY, SX, KY, NS, static_cast<cudaStream_t>(stream));
}

extern "C" int colforward_f64(const int* y_src, const double* y_lp,
                              const double* y_flags, const double* absorb,
                              const double* maskg, const double* xvec,
                              const double* trans, const int* lanes, int* progress,
                              double* rec, double* out, int SY, int SX, int KY, int NS,
                              void* stream) {
  return launch<double>(y_src, y_lp, y_flags, absorb, maskg, xvec, trans, lanes, progress, rec,
                        out, SY, SX, KY, NS, static_cast<cudaStream_t>(stream));
}

// Strips of kNS lanes that can be resident at once (the cooperative
// launch's limit), or -(CUDA error).
extern "C" int colforward_capacity_f32() {
  return colfill::resident_blocks(colforward_kernel<float, kNS>, kNS, 0);
}
extern "C" int colforward_capacity_f64() {
  return colfill::resident_blocks(colforward_kernel<double, kNS>, kNS, 0);
}
