// Kernel (g2): the sequence-parallel pair Forward, the Y columns of each
// chain x chain pair cut into shards, on Hopper.
//
// Replaces historian_tpu/ops/sp_pairforward.py::sp_pair_forward and
// ::sp_pair_forward_batch, XLA `shard_map` kernels (body `_sp_kernel`)
// that run `pair_forward`'s recurrence with Y sharded over a mesh axis:
// every row, each device receives three shifted values from its left
// neighbour (`_shift_from_left`) and the two affine scans' carries from a
// log2(n)-step ring scan (`_ring_affine_carry`), and the device that holds
// column Y1 - 1 gives lp_end (`psum`).
//
// Design: each shard of a pair cut into strips of whole warps, one block a
// strip on its own SM (ops/pairstrips.py `strip_plan`; the strip section
// of pairstep.cuh), each block K3's row step under the JAX rules
// (pairstep.cuh `warp_row`, JaxRules<LogSum>) on its strip, M lanes a
// thread, the rows piped down its few warps.  In place of the ring scan
// the carries pass from strip to strip in order: the thread of a strip's
// last column hands each row's five values (the IMM source, the two scans'
// sources and the two scans' u) to its block's io warp, which sends them
// to the right strip, through distributed shared memory within a thread
// block cluster, or as a record [X1, 8] with a counter between clusters
// and at every shard boundary; the right strip's warp 0 takes them as the
// row's left edge.  So the warps of a pair's strips form one pipeline, and
// the values are the JAX kernel's up to the association of the scans'
// sums.  Columns past Y1 (the JAX kernel's padding, masked) are not
// computed: they lie right of every real column and change none.  The
// blocks of one card are one launch whose layout is checked to be
// resident at once; between cards a shard boundary's record lies in the
// reading card's memory (peer access) or in pinned host memory, and its
// counter is published and acquired at system scope
// (ops/sp_colforward.py `_record_place`, `_record_buffer`, as kernel (g1)
// places its records).  A strip of a few warps of one or two lanes runs a
// float64 row at about one warp step's latency, where a shard of 12 warps
// on one SM was bound by that SM's float64 pipe.
//
// What bounds it on this card: a pair's rows are a chain of X1 steps, each
// a chain of shifts and scans across its strips; bytes: absorb and the
// mask read once; operations: ~13 log-sum-exps and ~26 adds a cell.

#include <cstdint>

#include "pairstep.cuh"

namespace {

using namespace pairstep;
using Rules = JaxRules<LogSum>;

template <typename T>
struct Args {
  const StripEntry* table;
  const T *absorb, *rsx, *rsy, *ix, *iy;  // [B, X1, Y1], [B, X1], [B, Y1], [B, X1], [B, Y1]
  const uint8_t* mask;                    // [X1, Y1], shared by the batch
  const T* trans;                         // [23]
  T* lp_end;                              // [B]
  int X1, Y1;
};

template <typename T, int M>
__global__ void __launch_bounds__(32 * (kStripWarps + 1), 1) sppair_kernel(const Args<T> a) {
  __shared__ PfSmem<T, kStripWarps> sm;
  __shared__ EdgeSmem<T> es;
  const StripEntry e = a.table[blockIdx.x];
  const int X1 = a.X1, Y1 = a.Y1, c0 = int(e.c0), nc = int(e.nc);
  const int rows_warps = (blockDim.x >> 5) - 1;
  strip_init(es);
  setup<LogSum>(sm, a.trans);
  cluster_sync();
  if (nc > 0 && (threadIdx.x >> 5) == rows_warps) {
    strip_io(e, es, &sm.prog[0], X1);
  } else if (nc > 0) {
    const int l0 = threadIdx.x * M;
    const size_t b = size_t(e.chain);
    const T* absorb = a.absorb + b * X1 * Y1 + c0;
    const T* rsx = a.rsx + b * X1;
    const T* ix = a.ix + b * X1;
    const T* rsy = a.rsy + b * Y1 + c0;
    const T* iy = a.iy + b * Y1 + c0;
    const uint8_t* mask = a.mask + c0;
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
      const RowX<T> x{LogSum::clamp(__ldg(rsx + i)), LogSum::clamp(__ldg(ix + i)), i == 0,
                      i < X1 - 1 || X1 == 1, in_next};
      if (i + 1 < X1) {  // row i+1's loads fly while row i is computed
        load_row(next, absorb + size_t(i + 1) * Y1, l0, nc);
        in_next = load_mask<M>(mask + size_t(i + 1) * Y1, l0, nc);
      }
      warp_row<Rules, T, M, kStripWarps>(st, i, x, ab, rsy, iy, g, sm, edge, tail);
    }
    T lp;
    if (c0 + nc == Y1 && end_value<LogSum>(st, sm.tr, l0, g.ylast, lp)) a.lp_end[b] = lp;
  }
  __syncwarp();
  cluster_sync();
}

template <typename T>
int launch(const void* table, int blocks, int lanes, int warps, int cluster, const T* absorb,
           const T* rsx, const T* rsy, const T* ix, const T* iy, const uint8_t* mask,
           const T* trans, T* lp_end, int X1, int Y1, void* stream) {
  if (X1 < 1 || Y1 < 1) return int(cudaErrorInvalidValue);
  const Args<T> a{static_cast<const StripEntry*>(table), absorb, rsx, rsy, ix, iy, mask, trans,
                  lp_end, X1, Y1};
  return by_lanes(lanes, [&](auto m) {
    constexpr int M = decltype(m)::value;
    return strip_launch(sppair_kernel<T, M>, a, blocks, warps, cluster, 0,
                        static_cast<cudaStream_t>(stream));
  });
}

template <typename T>
int capacity_of(int lanes, int warps, int cluster) {
  if (lanes != 1 && lanes != 2 && lanes != 4) return -int(cudaErrorInvalidValue);
  return by_lanes(lanes, [&](auto m) {
    constexpr int M = decltype(m)::value;
    return strip_capacity(sppair_kernel<T, M>, warps, 0, cluster);
  });
}

}  // namespace

// table: `blocks` StripEntry rows on the device (ops/pairstrips.py; a strip
// of a shard of a pair, `chain` the pair), each `warps` warps of `lanes`
// lanes a thread, in clusters of `cluster`; absorb [B, X1, Y1], rsx and ix
// [B, X1], rsy and iy [B, Y1], mask [X1, Y1] bytes, trans [23] on the
// device; lp_end [B] gets each pair whose last strip is here.  Returns the
// launch's error (cudaErrorCooperativeLaunchTooLarge: more blocks than can
// be resident at once).
extern "C" int sppairforward_f32(const void* table, int blocks, int lanes, int warps, int cluster,
                                 const float* absorb, const float* rsx, const float* rsy,
                                 const float* ix, const float* iy, const uint8_t* mask,
                                 const float* trans, float* lp_end, int X1, int Y1,
                                 void* stream) {
  return launch<float>(table, blocks, lanes, warps, cluster, absorb, rsx, rsy, ix, iy, mask,
                       trans, lp_end, X1, Y1, stream);
}

extern "C" int sppairforward_f64(const void* table, int blocks, int lanes, int warps, int cluster,
                                 const double* absorb, const double* rsx, const double* rsy,
                                 const double* ix, const double* iy, const uint8_t* mask,
                                 const double* trans, double* lp_end, int X1, int Y1,
                                 void* stream) {
  return launch<double>(table, blocks, lanes, warps, cluster, absorb, rsx, rsy, ix, iy, mask,
                        trans, lp_end, X1, Y1, stream);
}

// Blocks of kernel (g2) with `warps` row warps of `lanes` lanes a thread
// that can be resident at once in clusters of `cluster`, or -(CUDA error).
extern "C" int sppairforward_capacity_f32(int lanes, int warps, int cluster) {
  return capacity_of<float>(lanes, warps, cluster);
}

extern "C" int sppairforward_capacity_f64(int lanes, int warps, int cluster) {
  return capacity_of<double>(lanes, warps, cluster);
}
