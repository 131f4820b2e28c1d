// Kernel (g3): the pipeline-parallel pair Forward, the X rows of a batch
// of chain x chain pairs cut into stages, on Hopper.
//
// Replaces historian_tpu/parallel/pp_pairforward.py::pp_pair_forward_lp,
// an XLA `shard_map` kernel (body `_pp_kernel`): stage k owns rows
// [k xb, (k + 1) xb) (xb = ceil(X1 / n); rows past X1 pass the carry
// through), fills them for pair p at pipeline step k + p from the [5, Y1]
// boundary row that stage k - 1 hands it (`ppermute`), and the last stage
// gives lp_end [PAIRS].  No mask.
//
// Design: the lock-step schedule is not copied, only its dependencies.  A
// card's work items, a (stage, pair) each in stage order, go round-robin
// to `slots` slots (item t to slot t mod slots); a slot is a chain of
// strips of whole warps over the row's Y1 columns, one block a strip
// (ops/pairstrips.py `slot_plan`), and runs its items in order.  Each
// block is K3's row step under the JAX rules (pairstep.cuh `warp_row`,
// JaxRules<LogSum>) on its strip, M lanes a thread, the rows piped down
// its warps (up to kStripWarps; a short row whole in one strip of up to
// kRowWarps warps of one lane, K3's own block shape, where a stage holds
// many pairs and the card's issue rate, not a row's latency, bounds the
// batch), and hands each row's five boundary values to the next
// strip of its slot through its io warp: distributed shared memory within
// a thread block cluster, a record with a counter between clusters (the
// strip section of pairstep.cuh, as kernels (f) and (g2) do).  The row
// counts run on from item to item, so no ring needs a reset.  At an
// item's end each row warp writes its lanes of the last row into the next
// stage's boundary buffer [PAIRS, 5, Y1] and adds one to the count of
// (pair, strip) with a release; strip s of the next stage starts the pair
// once that count holds every row warp of strip s, so it waits on its own
// columns of the row alone.  The first stage starts from a NEG row.  An
// item's dependency, the same pair on the stage before, comes earlier in
// stage order, so with every block resident (the layout is checked
// against cudaOccupancyMaxActiveClusters; no cooperative launch) each item
// ends.  Between cards the boundary buffer and its counts lie in the
// reading card's memory or in pinned host memory, published and acquired
// at system scope.
//
// What bounds it on this card: a pair's rows are a chain of X1 steps, each
// a chain of shifts and scans across its strips; the stages only pipeline
// pairs; bytes: absorb read once; operations: ~13 log-sum-exps and ~26
// adds a cell.

#include <cstdint>

#include "pairstep.cuh"

namespace {

using namespace pairstep;
using Rules = JaxRules<LogSum>;

// One of the card's stages as the wrapper lays it out
// (parallel/pp_pairforward.py): 8 int64.
struct PpStage {
  long long r0, r1;             // its real rows [r0, r1) (r1 <= r0: pass-through)
  long long in_buf, in_cnt;     // the boundary rows [PAIRS, 5, Y1] and counts
                                // [PAIRS, strips] (0: stage 0)
  long long out_buf, out_cnt;   // the next stage's (0: last stage)
  long long sys, pad;
};

template <typename T>
struct Args {
  const StripEntry* table;                // a block a strip; `chain` its slot
  const PpStage* stages;                  // the card's stages
  const int* items;                       // [n_items, 2]: stage (of the card's), pair
  const T *absorb, *rsx, *rsy, *ix, *iy;  // [P, X1, Y1], [P, X1], [P, Y1], [P, X1], [P, Y1]
  const T* trans;                         // [23]
  T* lp_end;                              // [P]
  int n_items, slots, X1, Y1;
};

// NW: the row warps a block takes at most (kStripWarps, or kRowWarps for
// a whole row of up to kRowWarps warps of one lane in one strip).
template <typename T, int M, int NW>
__global__ void __launch_bounds__(32 * (NW + 1), 1) pppair_kernel(const Args<T> a) {
  __shared__ PfSmem<T, NW> sm;
  __shared__ EdgeSmem<T> es;
  const StripEntry e = a.table[blockIdx.x];
  const int slot = int(e.chain), c0 = int(e.c0), nc = int(e.nc);
  const int X1 = a.X1, Y1 = a.Y1;
  const int warps = (blockDim.x >> 5) - 1, warp = threadIdx.x >> 5;
  strip_init(es);
  setup<LogSum>(sm, a.trans);
  cluster_sync();
  if (nc > 0 && warp == warps) {
    int rows = 0;
    for (int t = slot; t < a.n_items; t += a.slots) {
      const PpStage& s = a.stages[a.items[2 * t]];
      rows += max(0, int(s.r1 - s.r0));
    }
    strip_io(e, es, &sm.prog[0], rows);
  } else if (nc > 0) {
    const int lane = threadIdx.x & 31, l0 = threadIdx.x * M;
    const int width = 32 * M * warps, strip = c0 / width, nstrips = (Y1 + width - 1) / width;
    const StripEdge<Rules, T> edge{&es, e.left != kNone};
    const StripTail<T> tail{&es, e.right != kNone};
    const Cols g{nc, c0, Y1 - 1 - c0, Y1 == 1};
    int step = 0;  // the block's rows so far
    for (int t = slot; t < a.n_items; t += a.slots) {
      const PpStage s = a.stages[a.items[2 * t]];
      const int p = a.items[2 * t + 1], r0 = int(s.r0), r1 = int(s.r1);
      const bool sys = s.sys != 0;
      const size_t pb = size_t(p);
      Lanes<T, M> st;
      if (s.in_buf == 0) {
        fill_neg(st);
      } else {
        // every lane its own acquire of the strip's count, then its lanes
        wait_global(reinterpret_cast<const int*>(s.in_cnt) + pb * nstrips + strip, warps, sys);
        const T* row = reinterpret_cast<const T*>(s.in_buf) + pb * 5 * Y1 + c0;
#pragma unroll
        for (int k = 0; k < M; ++k) {
          const int l = l0 + k;
          const bool live = l < nc;
          auto in = [&](int v) {
            return live ? ld_shared_value(row + size_t(v) * Y1 + l, sys) : T(kNeg);
          };
          st.imm[k] = in(0);
          st.imd[k] = in(1);
          st.idm[k] = in(2);
          st.imi[k] = in(3);
          st.iiw[k] = in(4);
        }
      }
      const T* absorb = a.absorb + pb * X1 * Y1 + c0;
      const T* rsx = a.rsx + pb * X1;
      const T* ix = a.ix + pb * X1;
      const T* rsy = a.rsy + pb * Y1 + c0;
      const T* iy = a.iy + pb * Y1 + c0;
      T ab[M], next[M];
      if (r0 < r1) load_row(next, absorb + size_t(r0) * Y1, l0, nc);
      for (int i = r0; i < r1; ++i, ++step) {
#pragma unroll
        for (int k = 0; k < M; ++k) ab[k] = next[k];
        const RowX<T> x{LogSum::clamp(__ldg(rsx + i)), LogSum::clamp(__ldg(ix + i)), i == 0,
                        i < X1 - 1 || X1 == 1, ~0u};
        if (i + 1 < r1) load_row(next, absorb + size_t(i + 1) * Y1, l0, nc);
        warp_row<Rules, T, M, NW>(st, step, x, ab, rsy, iy, g, sm, edge, tail);
      }
      if (s.out_buf != 0) {
        T* row = reinterpret_cast<T*>(s.out_buf) + pb * 5 * Y1 + c0;
#pragma unroll
        for (int k = 0; k < M; ++k) {
          const int l = l0 + k;
          if (l < nc) {
            row[l] = st.imm[k];
            row[size_t(Y1) + l] = st.imd[k];
            row[size_t(2) * Y1 + l] = st.idm[k];
            row[size_t(3) * Y1 + l] = st.imi[k];
            row[size_t(4) * Y1 + l] = st.iiw[k];
          }
        }
        __syncwarp();  // every lane's values are out before the warp's count
        if (lane == 0) {
          if (sys) {
            __threadfence_system();
          } else {
            __threadfence();
          }
          red_release(reinterpret_cast<int*>(s.out_cnt) + pb * nstrips + strip, 1, sys);
        }
      } else {
        T lp;
        if (c0 + nc == Y1 && end_value<LogSum>(st, sm.tr, l0, g.ylast, lp)) a.lp_end[p] = lp;
      }
    }
  }
  __syncwarp();
  cluster_sync();
}

template <typename T>
int launch(const void* table, int blocks, int lanes, int warps, int cluster, const void* stages,
           const int* items, int n_items, int slots, const T* absorb, const T* rsx, const T* rsy,
           const T* ix, const T* iy, const T* trans, T* lp_end, int X1, int Y1, void* stream) {
  if (X1 < 1 || Y1 < 1 || n_items < 1 || slots < 1) return int(cudaErrorInvalidValue);
  const Args<T> a{static_cast<const StripEntry*>(table), static_cast<const PpStage*>(stages),
                  items, absorb, rsx, rsy, ix, iy, trans, lp_end, n_items, slots, X1, Y1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warps > kStripWarps) {
    if (lanes != 1) return int(cudaErrorInvalidValue);
    return strip_launch(pppair_kernel<T, 1, kRowWarps>, a, blocks, warps, cluster, 0, s,
                        kRowWarps);
  }
  return by_lanes(lanes, [&](auto m) {
    constexpr int M = decltype(m)::value;
    return strip_launch(pppair_kernel<T, M, kStripWarps>, a, blocks, warps, cluster, 0, s);
  });
}

template <typename T>
int capacity_of(int lanes, int warps, int cluster) {
  if (lanes != 1 && lanes != 2 && lanes != 4) return -int(cudaErrorInvalidValue);
  if (warps > kStripWarps) {
    if (lanes != 1) return -int(cudaErrorInvalidValue);
    return strip_capacity(pppair_kernel<T, 1, kRowWarps>, warps, 0, cluster, kRowWarps);
  }
  return by_lanes(lanes, [&](auto m) {
    constexpr int M = decltype(m)::value;
    return strip_capacity(pppair_kernel<T, M, kStripWarps>, warps, 0, cluster);
  });
}

}  // namespace

// table: `blocks` StripEntry rows on the device (ops/pairstrips.py
// `slot_plan`, `strip_table`; `chain` a strip's slot), each `warps` warps
// of `lanes` lanes a thread (more than kStripWarps, up to kRowWarps, of
// one lane), in clusters of `cluster`; stages: the card's
// PpStage rows, items [n_items, 2] (stage, pair) in stage order, both on
// the device; absorb [P, X1, Y1], rsx and ix [P, X1], rsy and iy [P, Y1],
// trans [23] on the device; lp_end [P] is written by the last stage.
// Returns the launch's error (cudaErrorCooperativeLaunchTooLarge: more
// blocks than can be resident at once).
extern "C" int pppairforward_f32(const void* table, int blocks, int lanes, int warps, int cluster,
                                 const void* stages, const int* items, int n_items, int slots,
                                 const float* absorb, const float* rsx, const float* rsy,
                                 const float* ix, const float* iy, const float* trans,
                                 float* lp_end, int X1, int Y1, void* stream) {
  return launch<float>(table, blocks, lanes, warps, cluster, stages, items, n_items, slots,
                       absorb, rsx, rsy, ix, iy, trans, lp_end, X1, Y1, stream);
}

extern "C" int pppairforward_f64(const void* table, int blocks, int lanes, int warps, int cluster,
                                 const void* stages, const int* items, int n_items, int slots,
                                 const double* absorb, const double* rsx, const double* rsy,
                                 const double* ix, const double* iy, const double* trans,
                                 double* lp_end, int X1, int Y1, void* stream) {
  return launch<double>(table, blocks, lanes, warps, cluster, stages, items, n_items, slots,
                        absorb, rsx, rsy, ix, iy, trans, lp_end, X1, Y1, stream);
}

// Blocks of kernel (g3) with `warps` row warps of `lanes` lanes a thread
// that can be resident at once in clusters of `cluster`, or -(CUDA error).
extern "C" int pppairforward_capacity_f32(int lanes, int warps, int cluster) {
  return capacity_of<float>(lanes, warps, cluster);
}

extern "C" int pppairforward_capacity_f64(int lanes, int warps, int cluster) {
  return capacity_of<double>(lanes, warps, cluster);
}
