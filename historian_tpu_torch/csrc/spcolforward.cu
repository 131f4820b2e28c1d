// (g1): the sequence-parallel column fill of a chain-x x DAG-y merge, the
// x lanes sharded over several devices (or several times over one).
//
// Replaces the JAX package's XLA shard_map kernel
// historian_tpu/ops/sp_colforward.py::sp_col_forward_cells (body
// `_sp_col_kernel`): K1's recurrence with x cut into per-device blocks and,
// per column, five scalars crossing each block boundary (three shifted
// boundary values, two affine-scan carries passed round a ring).
//
// Design: the ring scan is not ported step by step.  K1 (colforward.cu,
// colforward_step.cuh) already is a pipeline of 128-lane strips in which
// exactly two dependencies cross a strip boundary: the diagonal halo and
// the IMD/IIW scan carry.  A shard here is a run of whole K1 strips with
// its own planes [5, SY, W], x vectors and emission, and each strip runs
// K1's per-lane arithmetic unchanged, so the cells are bit-equal to K1's
// in the same dtype for any number of shards.  What differs is how the
// two dependencies travel (colforward_step.cuh `StripLink`, `col_io`):
// each strip block has an io warp beside its 128 lanes; a strip's last
// lane puts a record a column (its five cells, its two pre-scan sources
// and its t5a, the right strip's halo) in shared memory, and the io warp
// sends it on: into
// the right block's shared memory through distributed shared memory
// within a thread block cluster of up to 8 adjacent strips of a shard (a
// cluster-scope release), else into a record [SY, 8] in device memory
// with a counter published once a batch (across a cluster's end; at a
// shard boundary the exchange record, at system scope where it crosses
// cards).  The right block takes the halo and the carry from the record of
// the column, which hold K1's own arithmetic's values, its compute
// threads reading only its own shared memory; where the left strip has
// no band lane in the column (so computes no t5a there) the right block
// forms the halo from the left's records of the in-edges' columns.  The
// strip's own previous column stays in registers for a chain y's in-edge;
// in-edges older than the ring (kHalo columns; a DAG y) read the planes
// and the left edge's record in device memory, which every edge then has.
//
// Launches: one launch a device, holding every strip of every shard
// placed on that device, in shard order, in clusters (ops/pairstrips.py
// `strip_plan` at 1 lane x 4 warps, K1's 128 lanes), checked against
// cudaOccupancyMaxActiveClusters so that all its blocks are resident at
// once; no cooperative launch.  A block waits only on its left strip (in
// its cluster, or through a record written by a resident block or by
// another card), and within a cluster a left block on its right block's
// progress, so no wait closes a cycle.  Between cards nothing waits in a
// cycle (a shard waits only on its left neighbour), so each card's launch
// may start in any order.  Where the boundary crosses cards the record
// buffer lies in the reading card's memory, written through peer access,
// or in mapped pinned host memory where the cards have no peer access
// (`sys`: system-scope release, acquire and loads).  Every wait is
// bounded and ends in __trap().
//
// What bounds it on this card: K1's column chain (latency, see
// colforward_step.cuh), the strips' hand-offs on it; bytes: K1's plus 8
// values a column an edge kept in device memory.

#include <cstring>

#include "colforward_step.cuh"

namespace {

using pairstep::StripEntry;

// One shard as the wrapper lays it out (ops/sp_colforward.py, a row of
// its host table): 4 pointers, then 2 integers, all 64-bit.
template <typename T>
struct SpShard {
  const T* absorb;  // [SY, W]
  const T* maskg;   // [SY, W]
  const T* xvec;    // [4, W]
  T* out;           // [5, SY, W]
  long long lane0, W;
};

constexpr int kNS = 128;  // K1's strip width: whole K1 strips make the bits K1's
constexpr int kMaxShards = 16;  // shards a launch (a device) takes
constexpr int kWarps = kNS / 32;  // compute warps a block; the io warp follows

// The launch's arguments, passed by value as a kernel parameter (no copy up).
template <typename T>
struct Args {
  SpShard<T> s[kMaxShards];
  const StripEntry* table;  // a block a strip (ops/pairstrips.py; `chain` its shard)
  const int* y_src;
  const T *y_lp, *y_flags, *trans;
  const int* lanes;
  int SY, KY;
};

template <typename T, int NT>
__global__ void __launch_bounds__(NT + 32, 1)
    spcolforward_kernel(const __grid_constant__ Args<T> a) {
  __shared__ colfill::LinkSmem<T> ls;
  const StripEntry e = a.table[blockIdx.x];
  colfill::link_init(ls);
  __syncthreads();
  pairstep::cluster_sync();
  if (e.nc > 0) {
    const SpShard<T>& sh = a.s[e.chain];
    const int gi0 = int(e.c0), gi_end = int(e.c0 + e.nc);
    if (threadIdx.x >= NT) {
      colfill::col_io<T, NT>(e, ls, a.lanes, gi0, gi_end, a.SY);
    } else {
      colfill::PlaneEmission<T> em{sh.absorb, sh.maskg};
      const colfill::Strips g{int((e.c0 - sh.lane0) / NT), int((sh.W + NT - 1) / NT),
                              int(sh.lane0), int(sh.W)};
      const colfill::StripLink<T> link{&ls, reinterpret_cast<const T*>(e.in_rec),
                                       reinterpret_cast<const int*>(e.in_cnt),
                                       e.left != pairstep::kNone, e.right != pairstep::kNone,
                                       e.sys != 0};
      colfill::column_fill<T, NT>(a.y_src, a.y_lp, a.y_flags, 4, sh.xvec, a.trans, a.lanes,
                                  nullptr, nullptr, sh.out, a.SY, g, a.KY, em, link);
    }
  }
  __syncwarp();
  pairstep::cluster_sync();
}

template <typename T>
int launch(const void* shards, int n_shards, const void* table, int blocks, int cluster,
           const int* y_src, const T* y_lp, const T* y_flags, const T* trans, const int* lanes,
           int SY, int KY, int NS, cudaStream_t stream) {
  if (NS != kNS || n_shards < 1 || n_shards > kMaxShards) return int(cudaErrorInvalidValue);
  Args<T> a{};
  std::memcpy(a.s, shards, sizeof(SpShard<T>) * n_shards);
  a.table = static_cast<const StripEntry*>(table);
  a.y_src = y_src;
  a.y_lp = y_lp;
  a.y_flags = y_flags;
  a.trans = trans;
  a.lanes = lanes;
  a.SY = SY;
  a.KY = KY;
  return pairstep::strip_launch(spcolforward_kernel<T, kNS>, a, blocks, kWarps, cluster, 0,
                                stream);
}

}  // namespace

// shards: the device's SpShard rows in host memory (at most kMaxShards);
// table: `blocks` StripEntry rows on the device (ops/pairstrips.py, 1
// lane x 4 warps; `chain` the row of `shards`), in clusters of `cluster`.
// Returns the launch's error (cudaErrorCooperativeLaunchTooLarge: more
// blocks than can be resident at once).
extern "C" int spcolforward_f32(const void* shards, int n_shards, const void* table, int blocks,
                                int cluster, const int* y_src, const float* y_lp,
                                const float* y_flags, const float* trans, const int* lanes,
                                int SY, int KY, int NS, void* stream) {
  return launch<float>(shards, n_shards, table, blocks, cluster, y_src, y_lp, y_flags, trans,
                       lanes, SY, KY, NS, static_cast<cudaStream_t>(stream));
}

extern "C" int spcolforward_f64(const void* shards, int n_shards, const void* table, int blocks,
                                int cluster, const int* y_src, const double* y_lp,
                                const double* y_flags, const double* trans, const int* lanes,
                                int SY, int KY, int NS, void* stream) {
  return launch<double>(shards, n_shards, table, blocks, cluster, y_src, y_lp, y_flags, trans,
                        lanes, SY, KY, NS, static_cast<cudaStream_t>(stream));
}

// Blocks of kernel (g1) (1 lane a thread, 4 compute warps: K1's 128
// lanes, and the io warp) that can be resident at once in clusters of
// `cluster`, or -(CUDA error); any other block shape is refused.
extern "C" int spcolforward_capacity_f32(int lanes, int warps, int cluster) {
  if (lanes != 1 || warps != kWarps) return -int(cudaErrorInvalidValue);
  return pairstep::strip_capacity(spcolforward_kernel<float, kNS>, kWarps, 0, cluster);
}
extern "C" int spcolforward_capacity_f64(int lanes, int warps, int cluster) {
  if (lanes != 1 || warps != kWarps) return -int(cudaErrorInvalidValue);
  return pairstep::strip_capacity(spcolforward_kernel<double, kNS>, kWarps, 0, cluster);
}

// Lets `writer` store into `reader`'s memory: 1 when peer access is on
// (now or before), 0 when the two cannot reach each other, -(CUDA error).
extern "C" int spcolforward_peer(int writer, int reader) {
  int can = 0, prev = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, writer, reader);
  if (e != cudaSuccess) return -int(e);
  if (!can) return 0;
  e = cudaGetDevice(&prev);
  if (e == cudaSuccess) e = cudaSetDevice(writer);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(reader, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      e = cudaSuccess;
    }
    const cudaError_t back = cudaSetDevice(prev);
    if (e == cudaSuccess) e = back;
  }
  return e == cudaSuccess ? 1 : -int(e);
}
