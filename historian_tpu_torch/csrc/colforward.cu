// K1: column-major Forward fill of a chain-x x DAG-y merge on Hopper.
//
// Replaces the Pallas TPU kernel
// historian_tpu/ops/pallas_colforward.py::pallas_col_forward_cells
// (body `_kernel` / `_column_step`, scans `_affine_scan_lanes`), with the
// same arguments and the same [5, SY, SX] output (IMM, IMD, IDM, IMI, IIW).
// The match emission and the band gate are read from the [SY, SX] planes
// `absorb` and `maskg` that the bridge built.
//
// The column fill itself, what bounds it on this card (a sequential
// column chain on one SM: latency) and the design against that bound are
// in colforward_step.cuh, which K2 (colforward_fused.cu) shares.  The
// kernel allocates nothing and launches on the caller's stream.

#include "colforward_step.cuh"

namespace {

// K1's emission: the bridge's planes, one coalesced read each per cell.
template <typename T>
struct PlaneEmission {
  const T* __restrict__ absorb;
  const T* __restrict__ maskg;
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
    const T* __restrict__ trans, T* out, int SY, int SX, int KY) {
  PlaneEmission<T> em{absorb, maskg};
  colfill::column_fill<T, NT>(y_src, y_lp, y_flags, 4, xvec, trans, out, SY, SX, KY, em);
}

template <typename T, int NT>
int launch(const int* y_src, const T* y_lp, const T* y_flags, const T* absorb,
           const T* maskg, const T* xvec, const T* trans, T* out, int SY,
           int SX, int KY, cudaStream_t stream) {
  colforward_kernel<T, NT><<<1, NT, 0, stream>>>(
      y_src, y_lp, y_flags, absorb, maskg, xvec, trans, out, SY, SX, KY);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int colforward_f32(const int* y_src, const float* y_lp,
                              const float* y_flags, const float* absorb,
                              const float* maskg, const float* xvec,
                              const float* trans, float* out, int SY, int SX,
                              int KY, void* stream) {
  return launch<float, 1024>(y_src, y_lp, y_flags, absorb, maskg, xvec, trans,
                             out, SY, SX, KY, static_cast<cudaStream_t>(stream));
}

extern "C" int colforward_f64(const int* y_src, const double* y_lp,
                              const double* y_flags, const double* absorb,
                              const double* maskg, const double* xvec,
                              const double* trans, double* out, int SY, int SX,
                              int KY, void* stream) {
  return launch<double, 512>(y_src, y_lp, y_flags, absorb, maskg, xvec, trans,
                             out, SY, SX, KY, static_cast<cudaStream_t>(stream));
}
