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
// its own planes [5, SY, W], x vectors and emission; inside a shard the
// strips run K1's body unchanged, and at a shard boundary the left shard's
// last strip hands the right shard's first strip a record a column
// (colforward_step.cuh `Exchange`: its last lane's five cells and its two
// pre-scan sources, 7 values, then a column counter with a release store).
// The right strip forms the halo and the carry from the records with K1's
// own arithmetic, so the cells are bit-equal to K1's in the same dtype for
// any number of shards.  The JAX kernel's five messages become one record;
// the halo is formed on the reading side because a strip skips a column in
// which it has no band lane and so computes no t5 there, while its right
// neighbour may still need that halo.
//
// Launches: one cooperative launch a device, holding every strip of every
// shard placed on that device, block b the b-th of them in shard order.
// The shards of one card therefore exchange inside one cooperative launch
// whose blocks are all resident: the other choice, a launch a shard on a
// stream of its own, cannot be made safe, since nothing orders two
// launches on two streams and a right shard scheduled first would hold the
// SMs its left neighbour needs while it waits.  Between cards nothing
// waits in a cycle (a shard waits only on its left neighbour), so each
// card's launch may start in any order.  Where the boundary crosses cards
// the record buffer lies in the reading card's memory, written through
// peer access, or in mapped pinned host memory where the cards have no
// peer access (`sys`: system-scope release, acquire and loads).  Every
// wait is K1's bounded spin that ends in __trap().
//
// What bounds it on this card: K1's column chain (latency, see
// colforward_step.cuh); a boundary adds one record write and one counter
// publication a column on the left and the record reads on the right.
// Bytes: K1's plus 8 values a column a boundary.

#include <cstring>

#include "colforward_step.cuh"

namespace {

// One shard as the wrapper lays it out (ops/sp_colforward.py, a row of
// its host table): 10 pointers, then 4 integers, all 64-bit.
template <typename T>
struct SpShard {
  const T* absorb;   // [SY, W]
  const T* maskg;    // [SY, W]
  const T* xvec;     // [4, W]
  T* out;            // [5, SY, W]
  int* progress;     // [nstrips]
  T* rec;            // [nstrips, SY, 4]
  const T* in;       // [SY, 8] records of the left shard (null: first shard)
  const int* in_cnt;
  T* out_x;          // [SY, 8] the right shard's buffer (null: last shard)
  int* out_cnt;
  long long lane0, W, nstrips, sys;
};

constexpr int kNS = 128;  // K1's strip width: whole K1 strips make the bits K1's
constexpr int kMaxShards = 16;  // shards a launch (a device) takes

// The device's shards, passed by value as a kernel parameter (no copy up).
template <typename T>
struct SpTable {
  SpShard<T> s[kMaxShards];
};

template <typename T, int NT>
__global__ void __launch_bounds__(NT) spcolforward_kernel(
    const __grid_constant__ SpTable<T> table, int n_shards, const int* __restrict__ y_src,
    const T* __restrict__ y_lp, const T* __restrict__ y_flags, const T* __restrict__ trans,
    const int* __restrict__ lanes, int SY, int KY) {
  int b = blockIdx.x, d = 0;
  while (d + 1 < n_shards && b >= int(table.s[d].nstrips)) {
    b -= int(table.s[d].nstrips);
    ++d;
  }
  const SpShard<T>& sh = table.s[d];
  colfill::PlaneEmission<T> em{sh.absorb, sh.maskg};
  const colfill::Strips g{b, int(sh.nstrips), int(sh.lane0), int(sh.W)};
  const colfill::Exchange<T> edge{sh.in, sh.in_cnt, sh.out_x, sh.out_cnt, sh.sys != 0};
  colfill::column_fill<T, NT>(y_src, y_lp, y_flags, 4, sh.xvec, trans, lanes, sh.progress,
                              sh.rec, sh.out, SY, g, KY, em, edge);
}

template <typename T>
int launch(const void* shards, int n_shards, int strips, const int* y_src, const T* y_lp,
           const T* y_flags, const T* trans, const int* lanes, int SY, int KY, int NS,
           cudaStream_t stream) {
  if (NS != kNS || n_shards < 1 || n_shards > kMaxShards) return int(cudaErrorInvalidValue);
  SpTable<T> table{};
  std::memcpy(table.s, shards, sizeof(SpShard<T>) * n_shards);
  void* args[] = {&table, &n_shards, &y_src, &y_lp, &y_flags, &trans, &lanes, &SY, &KY};
  return colfill::launch_strips(spcolforward_kernel<T, kNS>, strips, kNS, 0, args, stream);
}

}  // namespace

// shards: the device's SpShard rows in host memory (at most kMaxShards);
// strips: their strips in all (the grid).
extern "C" int spcolforward_f32(const void* shards, int n_shards, int strips, const int* y_src,
                                const float* y_lp, const float* y_flags, const float* trans,
                                const int* lanes, int SY, int KY, int NS, void* stream) {
  return launch<float>(shards, n_shards, strips, y_src, y_lp, y_flags, trans, lanes, SY, KY, NS,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int spcolforward_f64(const void* shards, int n_shards, int strips, const int* y_src,
                                const double* y_lp, const double* y_flags, const double* trans,
                                const int* lanes, int SY, int KY, int NS, void* stream) {
  return launch<double>(shards, n_shards, strips, y_src, y_lp, y_flags, trans, lanes, SY, KY,
                        NS, static_cast<cudaStream_t>(stream));
}

// Strips of kNS lanes that can be resident at once on the current device
// (the cooperative launch's limit), or -(CUDA error).
extern "C" int spcolforward_capacity_f32() {
  return colfill::resident_blocks(spcolforward_kernel<float, kNS>, kNS, 0);
}
extern "C" int spcolforward_capacity_f64() {
  return colfill::resident_blocks(spcolforward_kernel<double, kNS>, kNS, 0);
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
