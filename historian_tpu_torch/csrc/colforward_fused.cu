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
// never materialized.  The wrapper derives `lanes` (the band's lane
// intervals a column, colforward_step.cuh) from the same vectors.
//
// What bounds it on this card: the same as K1 (colforward_step.cuh, the
// shared column fill, a pipeline of lane strips across the SMs): the
// sequential column chain.  K2 adds CA multiply-adds per cell to that
// chain and saves the four [SY, SX] planes the K1 route builds per merge
// (`dense`, `mask`, `absorb`, `maskg`; ~150 MB each in f32 at long12's
// first merge).  Design: each block stages its strip's slice of ex_t,
// [CA, NT], in dynamic shared memory once, with cp.async, before the
// column loop (20 x 256 x 4 B = 20 KB at long12); at the start of column
// j it stages ey[j, :] in shared memory, so the CA products of a cell read
// shared memory only.  The kernel allocates nothing and launches on the
// caller's stream.

#include "colforward_step.cuh"

namespace {

// largest CA the shared ey row holds (the wrapper checks too)
constexpr int kMaxCA = 256;

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(N));
}

template <typename T, int NT>
struct FusedEmission {
  const T* __restrict__ y_flags;
  const T* __restrict__ ey;
  const T* __restrict__ ex_t;
  const T* __restrict__ xvec;
  T* ey_s;  // [CA] in shared memory: this column's ey row
  T* ex_s;  // [CA, NT] in shared memory: the strip's slice of ex_t
  int SX, CA;
  T dist, ny;
  // per lane, constant over the columns
  T shift_x, m1;
  bool x_ok, near_start;
  // per column
  T m2, yne, sy;
  bool row_live;

  __device__ __forceinline__ void start(int i0) {
    const int i = i0 + int(threadIdx.x);
    if (i < SX) {
      for (int c = 0; c < CA; ++c)
        cp_async<sizeof(T)>(ex_s + c * NT + threadIdx.x, ex_t + size_t(c) * SX + i);
      shift_x = xvec[4 * SX + i];
      m1 = xvec[5 * SX + i];
      near_start = xvec[6 * SX + i] > T(0.5);
      x_ok = xvec[7 * SX + i] > T(0.5);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    // the fill's barrier after start() publishes the slice to the block
  }

  __device__ __forceinline__ void column(int j) {
    // the previous column's readers of ey_s passed the fill's end-of-column
    // barrier, so the row can be overwritten here
    for (int c = threadIdx.x; c < CA; c += NT) ey_s[c] = ey[size_t(j) * CA + c];
    __syncthreads();
    const T* fl = y_flags + size_t(8) * j;
    m2 = fl[4];
    yne = fl[5];
    sy = fl[6];
    row_live = T(j) < ny;
  }

  __device__ __forceinline__ void cell(int, int, size_t, T& a, T& mg) {
    const T neg = T(colfill::kNeg);
    const T gap = m1 > m2 ? m1 - m2 : m2 - m1;
    const bool in = (gap <= dist || near_start || yne > T(0.5)) && x_ok && row_live;
    if (!in) {
      a = neg;
      mg = neg;
      return;
    }
    T s = T(0);
    for (int c = 0; c < CA; ++c) s += ey_s[c] * ex_s[c * NT + threadIdx.x];
    a = colfill::cmax(colfill::dlog(s) + sy + shift_x, neg);
    mg = T(0);
  }
};

template <typename T, int NT>
__global__ void __launch_bounds__(NT) colforward_fused_kernel(
    const int* __restrict__ y_src, const T* __restrict__ y_lp,
    const T* __restrict__ y_flags, const T* __restrict__ ey,
    const T* __restrict__ ex_t, const T* __restrict__ xvec,
    const T* __restrict__ params, const int* __restrict__ lanes, int* progress, T* rec,
    T* out, int SY, int SX, int KY, int CA) {
  __shared__ T ey_s[kMaxCA];
  extern __shared__ __align__(16) unsigned char dyn[];
  FusedEmission<T, NT> em{y_flags, ey, ex_t, xvec, ey_s, reinterpret_cast<T*>(dyn), SX, CA,
                          params[23], params[24]};
  colfill::column_fill<T, NT>(y_src, y_lp, y_flags, 8, xvec, params, lanes, progress, rec, out,
                              SY, SX, KY, em);
}

template <typename T, int NT>
size_t slice_bytes(int CA) { return size_t(CA) * NT * sizeof(T); }

template <typename T, int NT>
int capacity_ns(int CA) {
  const size_t smem = slice_bytes<T, NT>(CA);
  const cudaError_t e = cudaFuncSetAttribute(colforward_fused_kernel<T, NT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             int(smem));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -int(e);
  }
  return colfill::resident_blocks(colforward_fused_kernel<T, NT>, NT, smem);
}

template <typename T, int NT>
int launch_ns(const int* y_src, const T* y_lp, const T* y_flags, const T* ey, const T* ex_t,
              const T* xvec, const T* params, const int* lanes, int* progress, T* rec, T* out,
              int SY, int SX, int KY, int CA, cudaStream_t stream) {
  const size_t smem = slice_bytes<T, NT>(CA);
  const cudaError_t e = cudaFuncSetAttribute(colforward_fused_kernel<T, NT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             int(smem));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return int(e);
  }
  void* args[] = {&y_src, &y_lp, &y_flags, &ey, &ex_t, &xvec, &params, &lanes,
                  &progress, &rec, &out, &SY, &SX, &KY, &CA};
  return colfill::launch_strips(colforward_fused_kernel<T, NT>, (SX + NT - 1) / NT, NT, smem,
                                args, stream);
}

// NS is K1's strip width, 128, or 64 where a [CA, 128] slice of ex_t does
// not fit shared memory (CA above ~220 in float64); the wrapper picks it.
template <typename T>
int launch(const int* y_src, const T* y_lp, const T* y_flags, const T* ey, const T* ex_t,
           const T* xvec, const T* params, const int* lanes, int* progress, T* rec, T* out,
           int SY, int SX, int KY, int CA, int NS, cudaStream_t stream) {
  if (CA < 1 || CA > kMaxCA) return int(cudaErrorInvalidValue);
  switch (NS) {
    case 64: return launch_ns<T, 64>(y_src, y_lp, y_flags, ey, ex_t, xvec, params, lanes,
                                     progress, rec, out, SY, SX, KY, CA, stream);
    case 128: return launch_ns<T, 128>(y_src, y_lp, y_flags, ey, ex_t, xvec, params, lanes,
                                       progress, rec, out, SY, SX, KY, CA, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int capacity(int NS, int CA) {
  if (CA < 1 || CA > kMaxCA) return -int(cudaErrorInvalidValue);
  switch (NS) {
    case 64: return capacity_ns<T, 64>(CA);
    case 128: return capacity_ns<T, 128>(CA);
    default: return -int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int colforward_fused_f32(const int* y_src, const float* y_lp,
                                    const float* y_flags, const float* ey,
                                    const float* ex_t, const float* xvec,
                                    const float* params, const int* lanes, int* progress,
                                    float* rec, float* out, int SY, int SX, int KY, int CA,
                                    int NS, void* stream) {
  return launch<float>(y_src, y_lp, y_flags, ey, ex_t, xvec, params, lanes, progress, rec, out,
                       SY, SX, KY, CA, NS, static_cast<cudaStream_t>(stream));
}

extern "C" int colforward_fused_f64(const int* y_src, const double* y_lp,
                                    const double* y_flags, const double* ey,
                                    const double* ex_t, const double* xvec,
                                    const double* params, const int* lanes, int* progress,
                                    double* rec, double* out, int SY, int SX, int KY, int CA,
                                    int NS, void* stream) {
  return launch<double>(y_src, y_lp, y_flags, ey, ex_t, xvec, params, lanes, progress, rec,
                        out, SY, SX, KY, CA, NS, static_cast<cudaStream_t>(stream));
}

// Strips of NS lanes, with CA emission factors, that can be resident at
// once (the cooperative launch's limit), or -(CUDA error), e.g. when the
// [CA, NS] slice does not fit shared memory.
extern "C" int colforward_fused_capacity_f32(int NS, int CA) { return capacity<float>(NS, CA); }
extern "C" int colforward_fused_capacity_f64(int NS, int CA) { return capacity<double>(NS, CA); }
