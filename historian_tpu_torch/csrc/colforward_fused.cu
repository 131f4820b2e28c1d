// K2: K1's column fill with the match emission and the band mask built
// in the kernel from O(L) factors, on Hopper.
//
// Replaces the Pallas TPU kernel
// historian_tpu/ops/pallas_colforward.py::pallas_col_forward_cells_fused
// (body `_kernel_fused`), with its argument layout:
//   y_src [SY, KY] int32, y_lp [SY, KY]
//   y_flags [SY, 8]: null, ready, rootsub_y, ins_y, m2, y_near_end,
//                    shift_y, unused
//   ey [SY, CA], ex_t [CA, SX]: exp-shifted emission factors
//   xvec [8, SX]: rootsub_x, ins_x, x_gate, x_eos, shift_x, m1,
//                 x_near_start, x_in_range
//   params [32]: 23 transitions, [23] band distance D, [24] ny
// and K1's [5, SY, SX] output.  For cell (j, i):
//   absorb = max(log(sum_c ey[j, c] ex_t[c, i]) + shift_y[j] + shift_x[i], NEG)
//   in     = (|m2[j] - m1[i]| <= D | x_near_start[i] | y_near_end[j])
//            & x_in_range[i] & j < ny
// and (absorb, 0) inside the band, (NEG, NEG) outside: the planes the
// bridge builds for K1 (ops/devicedp.py fill_planes), which are therefore
// never materialized.
//
// What bounds it on this card: the same as K1 (colforward_step.cuh, the
// shared column fill): one block walks the sequential column chain, so it
// is latency-bound.  K2 adds CA multiply-adds per cell to that chain and
// saves the four [SY, SX] planes the K1 route builds per merge (`dense`,
// `mask`, `absorb`, `maskg`; ~150 MB each in f32 at long12's first merge).
// Design: at the start of column j the block stages ey[j, :] in shared
// memory; each lane then reads its column of ex_t, one value per factor,
// coalesced across the lanes.  ex_t does not fit shared memory at long12
// size (20 x 6100 x 4 B ~ 0.5 MB), but it stays L2-resident: the cost is
// CA L2 reads per cell on the sequential chain, which no later column can
// overlap.  The kernel allocates nothing and launches on the caller's
// stream.

#include "colforward_step.cuh"

namespace {

// largest CA the shared ey row holds (the wrapper checks too)
constexpr int kMaxCA = 256;

template <typename T>
struct FusedEmission {
  const T* __restrict__ y_flags;
  const T* __restrict__ ey;
  const T* __restrict__ ex_t;
  const T* __restrict__ xvec;
  T* ey_s;  // [CA] in shared memory: this column's ey row
  int SX, CA;
  T dist, ny;
  T m2, yne, sy;
  bool row_live;

  __device__ __forceinline__ void column(int j) {
    // the previous column's readers of ey_s passed the fill's end-of-column
    // barrier, so the row can be overwritten here
    for (int c = threadIdx.x; c < CA; c += blockDim.x) ey_s[c] = ey[size_t(j) * CA + c];
    __syncthreads();
    const T* fl = y_flags + size_t(8) * j;
    m2 = fl[4];
    yne = fl[5];
    sy = fl[6];
    row_live = T(j) < ny;
  }

  __device__ __forceinline__ void cell(int, int i, size_t, T& a, T& mg) {
    const T neg = T(colfill::kNeg);
    const T m1 = xvec[5 * SX + i];
    const T gap = m1 > m2 ? m1 - m2 : m2 - m1;
    const bool in = (gap <= dist || xvec[6 * SX + i] > T(0.5) || yne > T(0.5)) &&
                    xvec[7 * SX + i] > T(0.5) && row_live;
    if (!in) {
      a = neg;
      mg = neg;
      return;
    }
    T s = T(0);
    for (int c = 0; c < CA; ++c) s += ey_s[c] * ex_t[size_t(c) * SX + i];
    a = colfill::cmax(colfill::dlog(s) + sy + xvec[4 * SX + i], neg);
    mg = T(0);
  }
};

template <typename T, int NT>
__global__ void __launch_bounds__(NT) colforward_fused_kernel(
    const int* __restrict__ y_src, const T* __restrict__ y_lp,
    const T* __restrict__ y_flags, const T* __restrict__ ey,
    const T* __restrict__ ex_t, const T* __restrict__ xvec,
    const T* __restrict__ params, T* out, int SY, int SX, int KY, int CA) {
  __shared__ T ey_s[kMaxCA];
  FusedEmission<T> em{y_flags, ey, ex_t, xvec, ey_s, SX, CA, params[23], params[24]};
  colfill::column_fill<T, NT>(y_src, y_lp, y_flags, 8, xvec, params, out, SY, SX, KY, em);
}

template <typename T, int NT>
int launch(const int* y_src, const T* y_lp, const T* y_flags, const T* ey,
           const T* ex_t, const T* xvec, const T* params, T* out, int SY,
           int SX, int KY, int CA, cudaStream_t stream) {
  if (CA < 1 || CA > kMaxCA) return int(cudaErrorInvalidValue);
  colforward_fused_kernel<T, NT><<<1, NT, 0, stream>>>(
      y_src, y_lp, y_flags, ey, ex_t, xvec, params, out, SY, SX, KY, CA);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int colforward_fused_f32(const int* y_src, const float* y_lp,
                                    const float* y_flags, const float* ey,
                                    const float* ex_t, const float* xvec,
                                    const float* params, float* out, int SY,
                                    int SX, int KY, int CA, void* stream) {
  return launch<float, 1024>(y_src, y_lp, y_flags, ey, ex_t, xvec, params, out,
                             SY, SX, KY, CA, static_cast<cudaStream_t>(stream));
}

extern "C" int colforward_fused_f64(const int* y_src, const double* y_lp,
                                    const double* y_flags, const double* ey,
                                    const double* ex_t, const double* xvec,
                                    const double* params, double* out, int SY,
                                    int SX, int KY, int CA, void* stream) {
  return launch<double, 512>(y_src, y_lp, y_flags, ey, ex_t, xvec, params, out,
                             SY, SX, KY, CA, static_cast<cudaStream_t>(stream));
}
