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
// Design: a block a shard of a pair, run as K3's block (pairforward.cu):
// the LogSum instance of its row step under the JAX rules (pairstep.cuh
// `warp_row`, JaxRules<LogSum>), the shard's columns M lanes a thread, the
// rows piped down the warps.  In place of the ring scan the carries pass
// from shard to shard in order: the thread that holds a shard's last
// column, once it has row i, writes a record of five values (the IMM
// source, the two scans' sources and the two scans' u there) to the right
// shard's buffer [X1, 8] and publishes the row with a release store of a
// counter; lane 0 of the right shard's warp 0 acquires that counter,
// reads the record and hands it to its warp as the row's left edge.  So
// the warps of a pair's shards form one pipeline, shard d's warp 0 on row
// i while shard d - 1's last warp is on row i + 1, and the values are the
// JAX kernel's up to the association of the scans' sums.  Columns past Y1
// (the JAX kernel's padding, masked) are not computed: they lie right of
// every real column and change none.  The blocks of one card are one
// cooperative launch, so every shard's left neighbour is resident (two
// launches on two streams could deadlock); between cards the buffer lies
// in the reading card's memory (peer access) or in pinned host memory,
// and the counter is published and acquired at system scope
// (ops/sp_colforward.py `_record_place`, `_record_buffer`, as kernel (g1)
// places its records).
//
// What bounds it on this card: a pair's rows are a chain of X1 steps, each
// a chain of shifts and scans across its shards (a record hop a shard);
// bytes: absorb and the mask read once; operations: ~13 log-sum-exps and
// ~26 adds a cell.

#include <cstdint>

#include "pairstep.cuh"

namespace {

using namespace pairstep;
using Rules = JaxRules<LogSum>;

// One block as the wrapper lays it out (ops/sp_pairforward.py): 8 int64.
struct SpEntry {
  long long pair, c0, nc;
  long long in_rec, in_cnt;    // the left shard's records [X1, 8] and counter (0: first shard)
  long long out_rec, out_cnt;  // the right shard's (0: last shard)
  long long sys;               // a boundary of this block crosses cards
};

template <typename T>
struct Args {
  const SpEntry* table;
  const T *absorb, *rsx, *rsy, *ix, *iy;  // [B, X1, Y1], [B, X1], [B, Y1], [B, X1], [B, Y1]
  const uint8_t* mask;                    // [X1, Y1], shared by the batch
  const T* trans;                         // [23]
  T* lp_end;                              // [B]
  int X1, Y1;
};

constexpr int kRecord = 8;  // values a row's record

// Warp 0's left edge: the grid's, or the left shard's record of the row.
template <typename T>
struct RecordEdge {
  const T* rec;  // null: the first shard
  const int* cnt;
  bool sys;
  __device__ __forceinline__ void operator()(int i, T& src, T& so, T& io, T& c1, T& c2) const {
    if (rec == nullptr) {
      GridEdge<Rules>{}(i, src, so, io, c1, c2);
      return;
    }
    T v[kSlot];
    if ((threadIdx.x & 31) == 0) {
      wait_global(cnt, i + 1, sys);
#pragma unroll
      for (int k = 0; k < kSlot; ++k) v[k] = ld_shared_value(rec + size_t(i) * kRecord + k, sys);
    }
#pragma unroll
    for (int k = 0; k < kSlot; ++k) v[k] = __shfl_sync(kFull, v[k], 0);
    src = v[0];
    so = v[1];
    io = v[2];
    c1 = v[3];
    c2 = v[4];
  }
};

// The shard's last column to the right shard's record of the row.
template <typename T>
struct RecordTail {
  T* rec;  // null: the last shard
  int* cnt;
  bool sys;
  __device__ __forceinline__ void operator()(int i, T src, T so, T io, T u1, T u2) const {
    if (rec == nullptr) return;
    T* r = rec + size_t(i) * kRecord;
    r[0] = src;
    r[1] = so;
    r[2] = io;
    r[3] = u1;
    r[4] = u2;
    if (sys) __threadfence_system();
    st_release(cnt, i + 1, sys);
  }
};

template <typename T, int M, int NWMAX>
__global__ void __launch_bounds__(NWMAX * 32, 1) sppair_kernel(const Args<T> a) {
  __shared__ PfSmem<T, NWMAX> sm;
  const SpEntry e = a.table[blockIdx.x];
  const int l0 = threadIdx.x * M;
  const int X1 = a.X1, Y1 = a.Y1, c0 = int(e.c0), nc = int(e.nc);
  const bool sys = e.sys != 0;
  setup<LogSum>(sm, a.trans);
  const size_t b = size_t(e.pair);
  const T* absorb = a.absorb + b * X1 * Y1 + c0;
  const T* rsx = a.rsx + b * X1;
  const T* ix = a.ix + b * X1;
  const T* rsy = a.rsy + b * Y1 + c0;
  const T* iy = a.iy + b * Y1 + c0;
  const uint8_t* mask = a.mask + c0;
  const RecordEdge<T> edge{reinterpret_cast<const T*>(e.in_rec),
                           reinterpret_cast<const int*>(e.in_cnt), sys};
  const RecordTail<T> tail{reinterpret_cast<T*>(e.out_rec), reinterpret_cast<int*>(e.out_cnt),
                           sys};
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
    warp_row<Rules, T, M, NWMAX>(st, i, x, ab, rsy, iy, g, sm, edge, tail);
  }
  T lp;
  if (c0 + nc == Y1 && end_value<LogSum>(st, sm.tr, l0, g.ylast, lp)) a.lp_end[b] = lp;
}

template <typename T>
int launch(const void* table, int blocks, int nc, const T* absorb, const T* rsx, const T* rsy,
           const T* ix, const T* iy, const uint8_t* mask, const T* trans, T* lp_end, int X1,
           int Y1, void* stream) {
  if (blocks < 1 || nc < 1 || X1 < 1 || Y1 < 1) return int(cudaErrorInvalidValue);
  const Args<T> a{static_cast<const SpEntry*>(table), absorb, rsx, rsy, ix, iy, mask, trans,
                  lp_end, X1, Y1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<T>(nc, [&](auto nw, auto m) {
    constexpr int NWMAX = decltype(nw)::value, M = decltype(m)::value;
    const int threads = threads_for(nc, M);
    auto kernel = sppair_kernel<T, M, NWMAX>;
    if (blocks > capacity(kernel, threads)) return int(cudaErrorCooperativeLaunchTooLarge);
    void* args[] = {const_cast<Args<T>*>(&a)};
    const cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                                        dim3(blocks), dim3(threads), args, 0, s);
    return err ? int(err) : int(cudaGetLastError());
  });
}

}  // namespace

// table: `blocks` SpEntry rows on the device (one a shard of a pair), nc
// the widest shard's columns (at most pairstep::kMaxCols); absorb [B, X1,
// Y1], rsx and ix [B, X1], rsy and iy [B, Y1], mask [X1, Y1] bytes, trans
// [23] on the device; lp_end [B] gets each pair whose last shard is here.
// Returns the launch's error (cudaErrorCooperativeLaunchTooLarge: more
// blocks than can be resident).
extern "C" int sppairforward_f32(const void* table, int blocks, int nc, const float* absorb,
                                 const float* rsx, const float* rsy, const float* ix,
                                 const float* iy, const uint8_t* mask, const float* trans,
                                 float* lp_end, int X1, int Y1, void* stream) {
  return launch<float>(table, blocks, nc, absorb, rsx, rsy, ix, iy, mask, trans, lp_end, X1, Y1,
                       stream);
}

extern "C" int sppairforward_f64(const void* table, int blocks, int nc, const double* absorb,
                                 const double* rsx, const double* rsy, const double* ix,
                                 const double* iy, const uint8_t* mask, const double* trans,
                                 double* lp_end, int X1, int Y1, void* stream) {
  return launch<double>(table, blocks, nc, absorb, rsx, rsy, ix, iy, mask, trans, lp_end, X1, Y1,
                        stream);
}
