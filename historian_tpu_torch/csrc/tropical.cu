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
// Design: the pair's columns cut into strips of whole warps, one block a
// strip on its own SM (ops/pairstrips.py `strip_plan`; the strip section
// of pairstep.cuh).  A block runs the MaxPlus instance of K3's row step
// under the JAX rules (pairstep.cuh `warp_row`, JaxRules<MaxPlus>) on its
// strip, M lanes a thread, the row state in registers, rows piped down its
// few warps with no block barrier in the row loop; each thread reads row
// i+1's absorb and mask at its lanes while it computes row i.  Warp 0
// takes the left strip's five values of each row (the IMM source, the two
// scans' sources and u) from its block's shared memory, where the io warp
// put them.  So a row costs about one warp step's latency, not one SM's
// issue over a whole row of 6100 columns (7.2 us a row in float32 when
// one block held the grid), and no float64 instance needs 32 warps of 6
// lanes (which spilled 1.6 KB a thread).  A strip boundary at a warp
// boundary passes what the warp ring passes, so layouts of the same lanes
// a thread give the same cells.  A warp's lanes of a row are one run of
// cells in memory, 5 M values a thread: stored straight from the registers
// each store instruction of a warp touches ~30 cache lines, so each warp
// writes its row through its own slice of shared memory, then one run of
// stores with consecutive threads on consecutive values.
//
// What bounds it on this card: the rows are a chain of X1 dependent steps
// and each row a chain of shifts and two scans across the strips, so the
// grid takes about X1 warp steps plus the pipeline's fill (its warps and
// its strip hops); bytes: the cells written, 5 values a cell, and absorb
// and the mask read once; the operations (about 48 adds, maxima and gates
// a cell) are far from the card's rate, so the bound is the bytes, and the
// row chain keeps the kernel from them.

#include <cstdint>

#include "pairstep.cuh"

namespace {

using namespace pairstep;
using Rules = JaxRules<MaxPlus>;

// A thread's values in a warp's slice, 5 M of them at a stride made odd so
// that the threads' writes meet no bank twice.
template <int M>
constexpr int kStride = (5 * M) | 1;

template <typename T, int M>
constexpr size_t stage_bytes(int warps) {
  return size_t(warps) * 32 * kStride<M> * sizeof(T);
}

// Row i's cells of the calling warp's lanes (nvals values from `out`)
// through the warp's slice `stage`, then one coalesced run of stores.
// Every thread of the warp calls it.
template <typename T, int M>
__device__ __forceinline__ void write_row(const Lanes<T, M>& st, T* __restrict__ stage,
                                          T* __restrict__ out, int nvals) {
  constexpr int S = kStride<M>, V = 5 * M;
  const int lane = threadIdx.x & 31;
  T* s = stage + lane * S;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    s[5 * k] = st.imm[k];
    s[5 * k + 1] = st.imd[k];
    s[5 * k + 2] = st.idm[k];
    s[5 * k + 3] = st.imi[k];
    s[5 * k + 4] = st.iiw[k];
  }
  __syncwarp();
  for (int v = lane; v < nvals; v += 32) out[v] = stage[(v / V) * S + v % V];
  __syncwarp();
}

template <typename T>
struct Args {
  const StripEntry* table;
  const T *absorb, *rsx, *rsy, *ix, *iy;  // [X1, Y1], [X1], [Y1], [X1], [Y1]
  const uint8_t* mask;                    // [X1, Y1]
  const T* trans;                         // [23]
  T *cells, *lp_best;                     // [X1, Y1, 5], [1]
  int X1, Y1;
};

template <typename T, int M>
__global__ void __launch_bounds__(32 * (kStripWarps + 1), 1) tropical_kernel(const Args<T> a) {
  __shared__ PfSmem<T, kStripWarps> sm;
  __shared__ EdgeSmem<T> es;
  extern __shared__ __align__(16) unsigned char dyn[];
  const StripEntry e = a.table[blockIdx.x];
  const int X1 = a.X1, Y1 = a.Y1, c0 = int(e.c0), nc = int(e.nc);
  const int rows_warps = (blockDim.x >> 5) - 1;
  strip_init(es);
  setup<MaxPlus>(sm, a.trans);
  cluster_sync();
  if (nc > 0 && (threadIdx.x >> 5) == rows_warps) {
    strip_io(e, es, &sm.prog[0], X1);
  } else if (nc > 0) {
    const int l0 = threadIdx.x * M, w0 = (threadIdx.x & ~31) * M;
    T* const stage = reinterpret_cast<T*>(dyn) + (threadIdx.x >> 5) * 32 * kStride<M>;
    const int nvals = max(0, min(nc, w0 + 32 * M) - w0) * 5;
    const T* absorb = a.absorb + c0;
    const uint8_t* mask = a.mask + c0;
    const T* rsy = a.rsy + c0;
    const T* iy = a.iy + c0;
    T* cells = a.cells + size_t(c0 + w0) * 5;
    const StripEdge<Rules, T> edge{&es, e.left != kNone};
    const StripTail<T> tail{&es, e.right != kNone};
    const Cols g{nc, c0, Y1 - 1 - c0, Y1 == 1};
    Lanes<T, M> st;
    fill_neg(st);
    T ab[M], next[M];
    load_row(next, absorb, l0, nc);
    unsigned in_next = load_mask<M>(mask, l0, nc);
    for (int i = 0; i < X1; ++i) {
#pragma unroll
      for (int k = 0; k < M; ++k) ab[k] = next[k];
      const RowX<T> x{__ldg(a.rsx + i), __ldg(a.ix + i), i == 0, i < X1 - 1 || X1 == 1, in_next};
      if (i + 1 < X1) {  // row i+1's loads fly while row i is computed
        load_row(next, absorb + size_t(i + 1) * Y1, l0, nc);
        in_next = load_mask<M>(mask + size_t(i + 1) * Y1, l0, nc);
      }
      warp_row<Rules, T, M, kStripWarps>(st, i, x, ab, rsy, iy, g, sm, edge, tail);
      write_row<T, M>(st, stage, cells + size_t(i) * Y1 * 5, nvals);
    }
    T lp;
    if (c0 + nc == Y1 && end_value<MaxPlus>(st, sm.tr, l0, g.ylast, lp)) *a.lp_best = lp;
  }
  __syncwarp();
  cluster_sync();
}

template <typename T>
int launch(const void* table, int blocks, int lanes, int warps, int cluster, const T* absorb,
           const T* rsx, const T* rsy, const T* ix, const T* iy, const uint8_t* mask,
           const T* trans, T* cells, T* lp_best, int X1, int Y1, void* stream) {
  if (X1 < 1 || Y1 < 1) return int(cudaErrorInvalidValue);
  const Args<T> a{static_cast<const StripEntry*>(table), absorb, rsx, rsy, ix, iy, mask, trans,
                  cells, lp_best, X1, Y1};
  return by_lanes(lanes, [&](auto m) {
    constexpr int M = decltype(m)::value;
    return strip_launch(tropical_kernel<T, M>, a, blocks, warps, cluster,
                        stage_bytes<T, M>(warps), static_cast<cudaStream_t>(stream));
  });
}

template <typename T>
int capacity_of(int lanes, int warps, int cluster) {
  if (lanes != 1 && lanes != 2 && lanes != 4) return -int(cudaErrorInvalidValue);
  return by_lanes(lanes, [&](auto m) {
    constexpr int M = decltype(m)::value;
    return strip_capacity(tropical_kernel<T, M>, warps, stage_bytes<T, M>(warps), cluster);
  });
}

}  // namespace

// cells [X1, Y1, 5] and lp_best [1] of one pair; mask [X1, Y1] bytes, 0
// out; table: `blocks` StripEntry rows on the device (ops/pairstrips.py),
// each strip `warps` warps of `lanes` lanes a thread, in clusters of
// `cluster`.  Returns the launch's error (cudaErrorCooperativeLaunchTooLarge:
// more blocks than can be resident at once).
extern "C" int tropical_f32(const void* table, int blocks, int lanes, int warps, int cluster,
                            const float* absorb, const float* rsx, const float* rsy,
                            const float* ix, const float* iy, const uint8_t* mask,
                            const float* trans, float* cells, float* lp_best, int X1, int Y1,
                            void* stream) {
  return launch<float>(table, blocks, lanes, warps, cluster, absorb, rsx, rsy, ix, iy, mask,
                       trans, cells, lp_best, X1, Y1, stream);
}

extern "C" int tropical_f64(const void* table, int blocks, int lanes, int warps, int cluster,
                            const double* absorb, const double* rsx, const double* rsy,
                            const double* ix, const double* iy, const uint8_t* mask,
                            const double* trans, double* cells, double* lp_best, int X1, int Y1,
                            void* stream) {
  return launch<double>(table, blocks, lanes, warps, cluster, absorb, rsx, rsy, ix, iy, mask,
                        trans, cells, lp_best, X1, Y1, stream);
}

// Blocks of kernel (f) with `warps` row warps of `lanes` lanes a thread
// that can be resident at once in clusters of `cluster`, or -(CUDA error).
extern "C" int tropical_capacity_f32(int lanes, int warps, int cluster) {
  return capacity_of<float>(lanes, warps, cluster);
}

extern "C" int tropical_capacity_f64(int lanes, int warps, int cluster) {
  return capacity_of<double>(lanes, warps, cluster);
}
