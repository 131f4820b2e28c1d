// K3 and K4: batched chain x chain pair-Forward on Hopper, lp_end only.
//
// Replaces the Pallas TPU kernels of historian_tpu/ops/pallas_pairforward.py:
// - K3 `pallas_pair_forward_lp` (body `_kernel`, scans `_affine_scan_row`)
//   as `pairforward_lp_{f32,f64}`;
// - K4 `pallas_pair_forward_lp_tiled` (body `_tiled_kernel`) as
//   `pairforward_lp_tiled_{f32,f64}`.
// Inputs: absorb [B, X1, Y1], rsx/ix [B, X1], rsy/iy [B, Y1], trans [23];
// output lp_end [B].  Both kernels compute K3's recurrence: the start row
// seeded as `_kernel` seeds it (IMM 1 at the start cell, its IDM/IMI
// scans), then per row i >= 1
//   IMD, IIW  from row i-1 at the same lane, plus max(rsx[i], NEG) or
//             max(ix[i], NEG), gated to NEG on the last lane (y not ready);
//   IMM       from row i-1 at lane j-1 (shift1), plus absorb[i, j];
//   IDM, IMI  inclusive affine log-sum-exp scans along the row,
//             u[j] = lse(a[j], u[j-1] + b[j]);
// and lp_end read at the corner from IMM, IMD and IIW only (x waits on the
// last row).  NEG = -1e30 is the finite semiring zero; every max(., NEG)
// clamp of the TPU kernel is kept.
//
// What bounds it on this card: each pair is a chain of X1 dependent rows,
// and each row is a dependent chain of lane shifts and two scans, so a
// pair runs on one SM and its time is X1 times the time of a row there.
// The batch is small (the headline batch of 128 pairs of 384 x 384 is ~95
// M state-cells, ~75 MB of absorb in float32): neither the card's memory
// rate nor its summed arithmetic rate is near.  A row done block-wide
// costs several block barriers (a lane shift, the scan's warp totals, the
// scan of those totals by one warp), and no lane of row i+1 starts before
// every lane of row i is done; without them, a narrow row (the headline's
// 385 lanes) is bound by the latency of a warp's row, and a wide row
// (3001 lanes) by the SM's instruction issue and its special-function
// units (two an lse: an exp and a log).
// Design against that bound:
// - one thread block per pair (grid = B); the block has W warps, W <= 32
//   (16 in float64), sized to the live lanes: warp w owns the contiguous
//   lane segment [32 M w, 32 M (w + 1)), M lanes a thread in order (see
//   `lanes_per_thread`) and W the fewest warps that cover Y1 with it;
// - each thread keeps the row state (IMM, IMD, IDM, IMI, IIW of its M
//   lanes) in registers for the whole fill;
// - rows are piped down the warps: warp w computes row i once it has
//   finished row i-1 and warp w-1 has published row i's values at its
//   last lane (the IMM source, the IDM and IMI sources and the two scans'
//   u), so warp w works on row i while warp w+1 is on row i-1, and a fill
//   takes ~X1 + W warp steps.  The handoff is a ring of kRing row slots a
//   warp in shared memory and a per-warp count of published rows, stored
//   with release and polled with acquire at CTA scope; a warp does not
//   overwrite a slot that warp w+1 has not read (it polls that warp's
//   count).  No block barrier in the row loop;
// - a warp step (pairstep.cuh `warp_row` under K3Rules, shared by both
//   kernels and, under the JAX package's rules, by kernels (f), (g2) and
//   (g3)) spends few instructions a lane: IMD, IIW and the IMM source
//   from the thread's registers (in float64 in linear space: five exps
//   and three logs a lane, not nine log-sum-exps); shift1 by
//   __shfl_up_sync, lane 0 taking
//   the published value; each scan composed over the thread's M lanes in
//   order, a 5-level shuffle scan of the thread aggregates, then the
//   carry-in from warp w-1 applied with one lse a lane and scan:
//   u = lse(u_local, c + W_local), W_local the clamped sum of b that the
//   composition carries.  float32 exps and logs are single special-function
//   instructions (Pf<float>), and no log-sum-exp branches (every value is
//   finite: inputs are clamped at NEG where they are read);
// - K3 reads row i+1's absorb segment with __ldg while it computes row i;
//   K4 streams it through shared memory instead: each thread stages its
//   own lanes of the next tile of rows with cp.async, double buffered,
//   and waits for its own copies, so no warp waits for another's.
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_runtime.h>

#include "pairstep.cuh"

namespace {

using namespace pairstep;

// ops/pairforward.py K4_STATIC_SMEM: what K4 leaves beside its slabs
static_assert(sizeof(PfSmem<double, 16>) <= 8192 && sizeof(PfSmem<float, 32>) <= 8192,
              "the handoff ring outgrew K4_STATIC_SMEM");

// lp_end at the corner, written by the thread that owns lane Y1 - 1.
template <typename T, int M, int NWMAX>
__device__ __forceinline__ void write_corner(const Lanes<T, M>& st, int l0, int Y1,
                                             const PfSmem<T, NWMAX>& sm, T* out) {
#pragma unroll
  for (int k = 0; k < M; ++k) {
    if (l0 + k == Y1 - 1) {
      *out = plse(plse(st.imm[k] + sm.tr[5], st.imd[k] + sm.tr[9]), st.iiw[k] + sm.tr[22]);
    }
  }
}

template <typename T, int M, int NWMAX>
__global__ void __launch_bounds__(NWMAX * 32, 1) pairforward_lp_kernel(
    const T* __restrict__ absorb, const T* __restrict__ rsx, const T* __restrict__ rsy,
    const T* __restrict__ ix, const T* __restrict__ iy, const T* __restrict__ trans,
    T* out, int X1, int Y1) {
  __shared__ PfSmem<T, NWMAX> sm;
  const int b = blockIdx.x;
  const int l0 = threadIdx.x * M;
  const T neg = T(kNeg);
  const T* ab = absorb + size_t(b) * X1 * Y1;
  const T* rx = rsx + size_t(b) * X1;
  const T* xi = ix + size_t(b) * X1;
  const T* ry = rsy + size_t(b) * Y1;
  const T* yi = iy + size_t(b) * Y1;
  setup<LogSum>(sm, trans);
  const Cols g{Y1, 0, Y1 - 1, false};
  Lanes<T, M> st;
  T a[M];
  warp_row<K3Rules, T, M, NWMAX>(st, 0, RowX<T>{T(0), T(0), true, true, ~0u}, a, ry, yi, g, sm,
                                 GridEdge<K3Rules>{}, NoTail{});
  T next[M], nrx = neg, nxi = neg;
  if (X1 > 1) {
    load_row(next, ab + Y1, l0, Y1);
    nrx = __ldg(rx + 1);
    nxi = __ldg(xi + 1);
  }
  for (int i = 1; i < X1; ++i) {
#pragma unroll
    for (int k = 0; k < M; ++k) a[k] = next[k];
    const T rsx_i = cmax(nrx, neg), ix_i = cmax(nxi, neg);
    if (i + 1 < X1) {  // row i+1's loads fly while row i is computed
      load_row(next, ab + size_t(i + 1) * Y1, l0, Y1);
      nrx = __ldg(rx + i + 1);
      nxi = __ldg(xi + i + 1);
    }
    warp_row<K3Rules, T, M, NWMAX>(st, i, RowX<T>{rsx_i, ix_i, false, true, ~0u}, a, ry, yi, g,
                                   sm, GridEdge<K3Rules>{}, NoTail{});
  }
  write_corner<T, M, NWMAX>(st, l0, Y1, sm, out + b);
}

template <int N>
__device__ __forceinline__ void cp_async(unsigned s, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(N));
}

// Stage the thread's own lanes of absorb rows [i0, i1) into the slab at
// shared address `slab` (one commit group; the thread alone reads them
// back).
template <typename T, int M>
__device__ __forceinline__ void stage_rows(unsigned slab, const T* ab, int i0, int i1, int l0,
                                           int Y1) {
  for (int r = i0; r < i1; ++r) {
    const T* g = ab + size_t(r) * Y1 + l0;
    const unsigned d = slab + unsigned((r - i0) * Y1 + l0) * sizeof(T);
#pragma unroll
    for (int k = 0; k < M; ++k) {
      if (l0 + k < Y1) cp_async<sizeof(T)>(d + k * sizeof(T), g + k);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <typename T, int M, int NWMAX>
__global__ void __launch_bounds__(NWMAX * 32, 1) pairforward_lp_tiled_kernel(
    const T* __restrict__ absorb, const T* __restrict__ rsx, const T* __restrict__ rsy,
    const T* __restrict__ ix, const T* __restrict__ iy, const T* __restrict__ trans,
    T* out, int X1, int Y1, int rows) {
  __shared__ PfSmem<T, NWMAX> sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  T* const slabs = reinterpret_cast<T*>(dyn);  // tile t's slab: slabs + (t & 1) * rows * Y1
  const int b = blockIdx.x;
  const int l0 = threadIdx.x * M;
  const T neg = T(kNeg);
  const T* ab = absorb + size_t(b) * X1 * Y1;
  const T* rx = rsx + size_t(b) * X1;
  const T* xi = ix + size_t(b) * X1;
  const T* ry = rsy + size_t(b) * Y1;
  const T* yi = iy + size_t(b) * Y1;
  if (X1 > 1) stage_rows<T, M>(smem_addr(slabs), ab, 1, min(1 + rows, X1), l0, Y1);
  setup<LogSum>(sm, trans);
  const Cols g{Y1, 0, Y1 - 1, false};
  Lanes<T, M> st;
  T a[M];
  warp_row<K3Rules, T, M, NWMAX>(st, 0, RowX<T>{T(0), T(0), true, true, ~0u}, a, ry, yi, g, sm,
                                 GridEdge<K3Rules>{}, NoTail{});
  const T* row = slabs;
  for (int i = 1, left = 0, t = 0; i < X1; ++i, --left, row += Y1) {
    if (left == 0) {  // a tile starts: the next one streams in while it is computed
      const int i1 = min(i + rows, X1);
      if (i1 < X1) {
        stage_rows<T, M>(smem_addr(slabs + size_t((t + 1) & 1) * rows * Y1), ab, i1,
                         min(i1 + rows, X1), l0, Y1);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      row = slabs + size_t(t & 1) * rows * Y1;
      left = rows;
      ++t;
    }
#pragma unroll
    for (int k = 0; k < M; ++k) a[k] = l0 + k < Y1 ? row[l0 + k] : T(0);
    warp_row<K3Rules, T, M, NWMAX>(
        st, i, RowX<T>{cmax(__ldg(rx + i), neg), cmax(__ldg(xi + i), neg), false, true, ~0u}, a,
        ry, yi, g, sm, GridEdge<K3Rules>{}, NoTail{});
  }
  write_corner<T, M, NWMAX>(st, l0, Y1, sm, out + b);
}

template <typename T, int M, int NWMAX>
int launch_cfg(bool tiled, const T* absorb, const T* rsx, const T* rsy, const T* ix,
               const T* iy, const T* trans, T* out, int B, int X1, int Y1, int rows,
               cudaStream_t stream) {
  const int threads = 32 * ((Y1 + 32 * M - 1) / (32 * M));
  if (!tiled) {
    pairforward_lp_kernel<T, M, NWMAX><<<B, threads, 0, stream>>>(absorb, rsx, rsy, ix, iy,
                                                                   trans, out, X1, Y1);
    return int(cudaGetLastError());
  }
  const size_t bytes = 2 * size_t(rows) * Y1 * sizeof(T);
  auto kernel = pairforward_lp_tiled_kernel<T, M, NWMAX>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  kernel<<<B, threads, bytes, stream>>>(absorb, rsx, rsy, ix, iy, trans, out, X1, Y1, rows);
  return int(cudaGetLastError());
}

#define PF_DISPATCH(M_, CALL) \
  switch (M_) {               \
    case 1: return CALL(1);   \
    case 2: return CALL(2);   \
    case 4: return CALL(4);   \
    case 6: return CALL(6);   \
    case 8: return CALL(8);   \
    default: return int(cudaErrorInvalidValue); \
  }

template <typename T, int NWMAX>
int launch(bool tiled, const T* absorb, const T* rsx, const T* rsy, const T* ix,
           const T* iy, const T* trans, T* out, int B, int X1, int Y1, int rows,
           cudaStream_t stream) {
#define PF_CFG(M) \
  launch_cfg<T, M, NWMAX>(tiled, absorb, rsx, rsy, ix, iy, trans, out, B, X1, Y1, rows, stream)
  PF_DISPATCH(lanes_per_thread<NWMAX>(Y1), PF_CFG)
#undef PF_CFG
}

// out: lanes a thread, warps a block, registers a thread, local (spill)
// bytes a thread, static shared bytes of the instance that takes Y1 lanes.
template <typename T, int M, int NWMAX>
int attrs_cfg(bool tiled, int Y1, int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = tiled
      ? cudaFuncGetAttributes(&fa, pairforward_lp_tiled_kernel<T, M, NWMAX>)
      : cudaFuncGetAttributes(&fa, pairforward_lp_kernel<T, M, NWMAX>);
  out[0] = M;
  out[1] = (Y1 + 32 * M - 1) / (32 * M);
  out[2] = fa.numRegs;
  out[3] = int(fa.localSizeBytes);
  out[4] = int(fa.sharedSizeBytes);
  return int(err);
}

template <typename T, int NWMAX>
int attrs(bool tiled, int Y1, int* out) {
#define PF_ATTR(M) attrs_cfg<T, M, NWMAX>(tiled, Y1, out)
  PF_DISPATCH(lanes_per_thread<NWMAX>(Y1), PF_ATTR)
#undef PF_ATTR
}

#undef PF_DISPATCH

}  // namespace

// float32: up to 32 warps (1024 threads, 64 registers a thread); float64:
// up to 16 (512 threads, 128 registers), for the wider state a lane.
extern "C" int pairforward_lp_f32(const float* absorb, const float* rsx, const float* rsy,
                                  const float* ix, const float* iy, const float* trans,
                                  float* out, int B, int X1, int Y1, void* stream) {
  return launch<float, 32>(false, absorb, rsx, rsy, ix, iy, trans, out, B, X1, Y1, 0,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int pairforward_lp_f64(const double* absorb, const double* rsx, const double* rsy,
                                  const double* ix, const double* iy, const double* trans,
                                  double* out, int B, int X1, int Y1, void* stream) {
  return launch<double, 16>(false, absorb, rsx, rsy, ix, iy, trans, out, B, X1, Y1, 0,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int pairforward_lp_tiled_f32(const float* absorb, const float* rsx,
                                        const float* rsy, const float* ix, const float* iy,
                                        const float* trans, float* out, int B, int X1, int Y1,
                                        int rows, void* stream) {
  return launch<float, 32>(true, absorb, rsx, rsy, ix, iy, trans, out, B, X1, Y1, rows,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int pairforward_lp_tiled_f64(const double* absorb, const double* rsx,
                                        const double* rsy, const double* ix, const double* iy,
                                        const double* trans, double* out, int B, int X1, int Y1,
                                        int rows, void* stream) {
  return launch<double, 16>(true, absorb, rsx, rsy, ix, iy, trans, out, B, X1, Y1, rows,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int pairforward_attrs_f32(int tiled, int Y1, int* out) {
  return attrs<float, 32>(tiled != 0, Y1, out);
}

extern "C" int pairforward_attrs_f64(int tiled, int Y1, int* out) {
  return attrs<double, 16>(tiled != 0, Y1, out);
}
