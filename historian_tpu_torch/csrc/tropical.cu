// Kernel (f): the tropical (max-plus, Viterbi) pair DP of one chain x
// chain pair on Hopper, with its envelope mask, every cell written.
//
// Replaces historian_tpu/ops/tropical.py::tropical_pair_forward, an XLA
// `lax.scan` over the x rows with two associative max-affine scans along
// y (`max_affine_scan`).  Inputs: absorb [X1, Y1], rootsub_x and ins_x
// [X1], rootsub_y and ins_y [Y1], mask [X1, Y1] (bytes), trans [23]
// (ops/pairforward.py `pack_transitions`); out: cells [X1, Y1, 5] (IMM,
// IMD, IDM, IMI, IIW) and lp_best [1].  The recurrence is the JAX
// kernel's, with NEG = -1e30 as its zero and no input clamped: every max
// is exact, so the cells differ from the JAX kernel's only in how the two
// scans associate their sums of b.
//
// Design: K3's (pairforward.cu), as the MaxPlus instance of its row step
// under the JAX rules (pairstep.cuh `warp_row`, JaxRules<MaxPlus>): one
// block, M lanes a thread, the row state in registers, rows piped down the
// warps with no block barrier in the row loop; each thread reads row i+1's
// absorb and mask at its lanes while it computes row i.  A warp's lanes
// of a row are one run of cells in memory, 5 M values a thread: stored
// straight from the registers, each store instruction of a warp touches
// ~30 cache lines (20 M bytes a thread apart), and at 6100 columns in
// float32 that held a row at ~31 us on an H100, where K4's LogSum row at
// that width takes ~7.8.  So each warp writes its row through its own
// slice of shared memory: C threads put their 5 M values there, then the
// warp stores the run with consecutive threads on consecutive values.
//
// What bounds it on this card: the rows are a chain of X1 dependent steps
// and each row a chain of shifts and two scans, so one SM fills the grid
// in about X1 + W warp steps, and stores every cell.  Bytes: the cells
// written, 5 values a cell, and absorb and the mask read once; the
// operations (about 48 adds, maxima and gates a cell) are far from the
// card's rate, so the bound is the bytes, and the row chain keeps it from
// them.

#include <cstdint>

#include "pairstep.cuh"

namespace {

using namespace pairstep;
using Rules = JaxRules<MaxPlus>;

// A thread's values in a warp's slice, 5 M of them at a stride made odd so
// that the threads' writes meet no bank twice.
template <int M>
constexpr int kStride = (5 * M) | 1;

// Threads a warp stages at once: all 32, or 16 in float64 on 32 warps (the
// slices then fit the 227 KB of shared memory a block may take).
template <typename T, int NWMAX>
constexpr int kChunk = sizeof(T) == 8 && NWMAX == 32 ? 16 : 32;

template <typename T, int M, int NWMAX>
constexpr size_t stage_bytes(int warps) {
  return size_t(warps) * kChunk<T, NWMAX> * kStride<M> * sizeof(T);
}

// Row i's cells of the calling warp's lanes [w0, w0 + 32 M) (those below
// Y1) through the warp's slice `stage`: kChunk threads' values at a time,
// then one coalesced run of stores.  Every thread of the warp calls it.
template <typename T, int M, int NWMAX>
__device__ __forceinline__ void write_row(const Lanes<T, M>& st, T* __restrict__ stage,
                                          T* __restrict__ out, int nvals) {
  constexpr int C = kChunk<T, NWMAX>, S = kStride<M>, V = 5 * M;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 32; h += C) {
    if (unsigned(lane - h) < unsigned(C)) {
      T* s = stage + (lane - h) * S;
#pragma unroll
      for (int k = 0; k < M; ++k) {
        s[5 * k] = st.imm[k];
        s[5 * k + 1] = st.imd[k];
        s[5 * k + 2] = st.idm[k];
        s[5 * k + 3] = st.imi[k];
        s[5 * k + 4] = st.iiw[k];
      }
    }
    __syncwarp();
    const int base = h * V, n = min(C * V, nvals - base);
    for (int v = lane; v < n; v += 32) out[base + v] = stage[(v / V) * S + v % V];
    __syncwarp();
  }
}

template <typename T, int M, int NWMAX>
__global__ void __launch_bounds__(NWMAX * 32, 1) tropical_kernel(
    const T* __restrict__ absorb, const T* __restrict__ rsx, const T* __restrict__ rsy,
    const T* __restrict__ ix, const T* __restrict__ iy, const uint8_t* __restrict__ mask,
    const T* __restrict__ trans, T* __restrict__ cells, T* __restrict__ lp_best, int X1,
    int Y1) {
  __shared__ PfSmem<T, NWMAX> sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int l0 = threadIdx.x * M, w0 = (threadIdx.x & ~31) * M;
  T* const stage =
      reinterpret_cast<T*>(dyn) + (threadIdx.x >> 5) * kChunk<T, NWMAX> * kStride<M>;
  const int nvals = (min(Y1, w0 + 32 * M) - w0) * 5;
  setup<MaxPlus>(sm, trans);
  const Cols g{Y1, 0, Y1 - 1, Y1 == 1};
  Lanes<T, M> st;
  fill_neg(st);
  T a[M], next[M];
  load_row(next, absorb, l0, Y1);
  unsigned in_next = load_mask<M>(mask, l0, Y1);
  for (int i = 0; i < X1; ++i) {
#pragma unroll
    for (int k = 0; k < M; ++k) a[k] = next[k];
    const RowX<T> x{__ldg(rsx + i), __ldg(ix + i), i == 0, i < X1 - 1 || X1 == 1, in_next};
    if (i + 1 < X1) {  // row i+1's loads fly while row i is computed
      load_row(next, absorb + size_t(i + 1) * Y1, l0, Y1);
      in_next = load_mask<M>(mask + size_t(i + 1) * Y1, l0, Y1);
    }
    warp_row<Rules, T, M, NWMAX>(st, i, x, a, rsy, iy, g, sm, GridEdge<Rules>{}, NoTail{});
    write_row<T, M, NWMAX>(st, stage, cells + (size_t(i) * Y1 + w0) * 5, nvals);
  }
  T lp;
  if (end_value<MaxPlus>(st, sm.tr, l0, Y1 - 1, lp)) *lp_best = lp;
}

template <typename T>
int launch(const T* absorb, const T* rsx, const T* rsy, const T* ix, const T* iy,
           const uint8_t* mask, const T* trans, T* cells, T* lp_best, int X1, int Y1,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (X1 < 1 || Y1 < 1) return int(cudaErrorInvalidValue);
  return dispatch<T>(Y1, [&](auto nw, auto m) {
    constexpr int NWMAX = decltype(nw)::value, M = decltype(m)::value;
    const int threads = threads_for(Y1, M);
    const size_t bytes = stage_bytes<T, M, NWMAX>(threads / 32);
    auto kernel = tropical_kernel<T, M, NWMAX>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return int(err);
    kernel<<<1, threads, bytes, s>>>(absorb, rsx, rsy, ix, iy, mask, trans, cells, lp_best, X1,
                                     Y1);
    return int(cudaGetLastError());
  });
}

}  // namespace

// cells [X1, Y1, 5] and lp_best [1] of one pair (at most pairstep::kMaxCols
// columns); mask [X1, Y1] bytes, 0 out.  Returns the launch's error.
extern "C" int tropical_f32(const float* absorb, const float* rsx, const float* rsy,
                            const float* ix, const float* iy, const uint8_t* mask,
                            const float* trans, float* cells, float* lp_best, int X1, int Y1,
                            void* stream) {
  return launch<float>(absorb, rsx, rsy, ix, iy, mask, trans, cells, lp_best, X1, Y1, stream);
}

extern "C" int tropical_f64(const double* absorb, const double* rsx, const double* rsy,
                            const double* ix, const double* iy, const uint8_t* mask,
                            const double* trans, double* cells, double* lp_best, int X1, int Y1,
                            void* stream) {
  return launch<double>(absorb, rsx, rsy, ix, iy, mask, trans, cells, lp_best, X1, Y1, stream);
}
