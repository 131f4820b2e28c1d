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
//   IDM, IMI  inclusive affine log-sum-exp scans along the row;
// and lp_end read at the corner from IMM, IMD and IIW only (x waits on the
// last row).  NEG = -1e30 is the finite semiring zero; every max(., NEG)
// clamp of the TPU kernel is kept.
//
// What bounds it on this card: each pair is a chain of X1 dependent rows,
// and each row is a dependent chain of lane shifts and two scans, so a
// pair is latency-bound: one row costs a few block barriers whatever its
// width.  The work of the batch is small (the headline batch of 128 pairs
// of 384 x 384 is ~95 M state-cells, ~75 MB of absorb in float32), so
// neither the card's memory rate nor its arithmetic rate is near: the
// bound is the row chain times the barrier latency.
// Design against that bound:
// - one thread block per pair (grid = B, no padding to a group of pairs:
//   the GPU needs no 8-sublane pack), so the B row chains run side by side
//   on the SMs;
// - the threads split the Y1 lanes, one lane per thread, NT lanes a tile,
//   NTILE tiles a row; the row state (IMM, IMD, IDM, IMI, IIW of every
//   lane of the previous row) stays in registers for the whole fill;
// - row i reads its absorb row coalesced and takes rsx[i] and ix[i] as
//   scalars (one broadcast load each);
// - shift1 is a warp shuffle plus one shared word per warp;
// - IDM and IMI are the block scan of logspace.cuh (shared with K1 and
//   K2), carried across tiles;
// - K4 streams the absorb rows through shared memory instead: the block
//   stages the slab of the next tile of rows with cp.async, double
//   buffered, while it computes the current tile, so the row step reads
//   its absorb row from shared memory.  The row step is one __device__
//   function shared by both kernels.
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_runtime.h>

#include "logspace.cuh"

namespace {

using namespace logspace;

template <typename T, int NT>
struct PfSmem {
  T tr[23];
  T buf[3][2][NT / 32];  // last lane of each warp: IMM source, IDM and IMI sources
  ScanSmem<T, NT> scan;
};

template <typename T, int NTILE>
struct RowState {
  T imm[NTILE], imd[NTILE], idm[NTILE], imi[NTILE], iiw[NTILE];
};

// One row of the recurrence for one pair, in place on the row state.
// `start` is the start row (no absorb read); otherwise arow is row i of
// absorb (device memory for K3, shared memory for K4) and rsx_i, ix_i
// are max(rsx[i], NEG) and max(ix[i], NEG).  Every thread calls it.
template <typename T, int NT, int NTILE>
__device__ __forceinline__ void row_step(RowState<T, NTILE>& st, bool start,
                                         const T* arow, T rsx_i, T ix_i,
                                         const T* __restrict__ rsy,
                                         const T* __restrict__ iy, int Y1,
                                         PfSmem<T, NT>& sm) {
  const T neg = T(kNeg);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* tr = sm.tr;
#pragma unroll
  for (int t = 0; t < NTILE; ++t) {
    const int par = t & 1;
    const int l = t * NT + tid;
    const bool live = l < Y1;
    T imm, imd, iiw;
    if (start) {
      imm = l == 0 ? T(0) : neg;
      imd = neg;
      iiw = neg;
    } else {
      const T pm = st.imm[t], pd = st.imd[t], pi = st.idm[t], pn = st.imi[t], pw = st.iiw[t];
      imd = lse(lse(pm + tr[1], pd + tr[7]), lse(pi + tr[11], pn + tr[15])) + rsx_i;
      iiw = lse(lse(pm + tr[4], pn + tr[17]), pw + tr[21]) + ix_i;
      if (l >= Y1 - 1) {  // y is not ready on the last lane
        imd = neg;
        iiw = neg;
      }
      const T src = lse(lse(lse(pm + tr[0], pd + tr[6]), lse(pi + tr[10], pn + tr[14])),
                        pw + tr[19]);
      imm = prev_lane<T, NT>(src, sm.buf[0], par, t, lane, warp, neg) + (live ? arow[l] : neg);
    }
    // the IDM and IMI sources at lane l-1: two shuffles, one barrier
    const T so = start ? imm + tr[2] : lse(lse(imm + tr[2], imd + tr[8]), iiw + tr[20]);
    const T io = imm + tr[3];
    T up_o = __shfl_up_sync(0xffffffffu, so, 1);
    T up_i = __shfl_up_sync(0xffffffffu, io, 1);
    if (lane == 31) {
      sm.buf[1][par][warp] = so;
      sm.buf[2][par][warp] = io;
    }
    __syncthreads();
    if (lane == 0) {
      const bool first = warp == 0;
      up_o = !first ? sm.buf[1][par][warp - 1] : (t > 0 ? sm.buf[1][par ^ 1][NT / 32 - 1] : neg);
      up_i = !first ? sm.buf[2][par][warp - 1] : (t > 0 ? sm.buf[2][par ^ 1][NT / 32 - 1] : neg);
    }
    T v1 = neg, w1 = neg, v2 = neg, w2 = neg;
    if (live) {
      const T ry = rsy[l], yi = iy[l];
      v1 = up_o + ry;
      w1 = tr[12] + ry;
      v2 = up_i + yi;
      w2 = tr[16] + yi;
    }
    block_affine_scan2<T, NT>(v1, w1, v2, w2, sm.scan, par, t, tid, lane, warp, neg);
    st.imm[t] = imm;
    st.imd[t] = imd;
    st.idm[t] = v1;
    st.imi[t] = v2;
    st.iiw[t] = iiw;
  }
}

// Set up the block (transitions in shared memory) and run the start row.
template <typename T, int NT, int NTILE>
__device__ __forceinline__ void start_pair(RowState<T, NTILE>& st, const T* __restrict__ trans,
                                           const T* rsy, const T* iy, int Y1,
                                           PfSmem<T, NT>& sm) {
  if (threadIdx.x < 23) sm.tr[threadIdx.x] = trans[threadIdx.x];
  __syncthreads();
  row_step<T, NT, NTILE>(st, true, nullptr, T(0), T(0), rsy, iy, Y1, sm);
}

// lp_end at the corner, written by the thread that owns lane Y1 - 1.
template <typename T, int NT, int NTILE>
__device__ __forceinline__ void write_corner(const RowState<T, NTILE>& st, int Y1,
                                             const PfSmem<T, NT>& sm, T* out) {
#pragma unroll
  for (int t = 0; t < NTILE; ++t) {
    if (t * NT + int(threadIdx.x) == Y1 - 1) {
      *out = lse(lse(st.imm[t] + sm.tr[5], st.imd[t] + sm.tr[9]), st.iiw[t] + sm.tr[22]);
    }
  }
}

template <typename T, int NT, int NTILE>
__global__ void __launch_bounds__(NT) pairforward_lp_kernel(
    const T* __restrict__ absorb, const T* __restrict__ rsx, const T* __restrict__ rsy,
    const T* __restrict__ ix, const T* __restrict__ iy, const T* __restrict__ trans,
    T* out, int X1, int Y1) {
  __shared__ PfSmem<T, NT> sm;
  const int b = blockIdx.x;
  const T neg = T(kNeg);
  const T* ab = absorb + size_t(b) * X1 * Y1;
  const T* ry = rsy + size_t(b) * Y1;
  const T* yi = iy + size_t(b) * Y1;
  RowState<T, NTILE> st;
  start_pair<T, NT, NTILE>(st, trans, ry, yi, Y1, sm);
  for (int i = 1; i < X1; ++i) {
    row_step<T, NT, NTILE>(st, false, ab + size_t(i) * Y1,
                           cmax(__ldg(rsx + size_t(b) * X1 + i), neg),
                           cmax(__ldg(ix + size_t(b) * X1 + i), neg), ry, yi, Y1, sm);
  }
  write_corner<T, NT, NTILE>(st, Y1, sm, out + b);
}

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(N));
}

// Stage absorb rows [i0, i1) of one pair into `slab` (one commit group).
template <typename T, int NT>
__device__ __forceinline__ void stage_rows(T* slab, const T* ab, int i0, int i1, int Y1) {
  const T* g = ab + size_t(i0) * Y1;
  const int n = (i1 - i0) * Y1;
  for (int e = threadIdx.x; e < n; e += NT) cp_async<sizeof(T)>(slab + e, g + e);
  asm volatile("cp.async.commit_group;\n" ::);
}

template <typename T, int NT, int NTILE>
__global__ void __launch_bounds__(NT) pairforward_lp_tiled_kernel(
    const T* __restrict__ absorb, const T* __restrict__ rsx, const T* __restrict__ rsy,
    const T* __restrict__ ix, const T* __restrict__ iy, const T* __restrict__ trans,
    T* out, int X1, int Y1, int rows) {
  __shared__ PfSmem<T, NT> sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  T* slabs[2] = {reinterpret_cast<T*>(dyn), reinterpret_cast<T*>(dyn) + size_t(rows) * Y1};
  const int b = blockIdx.x;
  const T neg = T(kNeg);
  const T* ab = absorb + size_t(b) * X1 * Y1;
  const T* ry = rsy + size_t(b) * Y1;
  const T* yi = iy + size_t(b) * Y1;
  if (X1 > 1) stage_rows<T, NT>(slabs[0], ab, 1, min(1 + rows, X1), Y1);
  RowState<T, NTILE> st;
  start_pair<T, NT, NTILE>(st, trans, ry, yi, Y1, sm);
  for (int i0 = 1, k = 0; i0 < X1; i0 += rows, ++k) {
    const int i1 = min(i0 + rows, X1);
    if (i1 < X1) {  // the next tile's slab streams in while this one is computed
      stage_rows<T, NT>(slabs[(k + 1) & 1], ab, i1, min(i1 + rows, X1), Y1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // every thread's copies of this tile have landed
    const T* slab = slabs[k & 1];
    for (int i = i0; i < i1; ++i) {
      row_step<T, NT, NTILE>(st, false, slab + size_t(i - i0) * Y1,
                             cmax(__ldg(rsx + size_t(b) * X1 + i), neg),
                             cmax(__ldg(ix + size_t(b) * X1 + i), neg), ry, yi, Y1, sm);
    }
    __syncthreads();  // this slab is free for the tile after next
  }
  write_corner<T, NT, NTILE>(st, Y1, sm, out + b);
}

template <typename T, int NT, int NTILE>
int launch_cfg(bool tiled, const T* absorb, const T* rsx, const T* rsy, const T* ix,
               const T* iy, const T* trans, T* out, int B, int X1, int Y1, int rows,
               cudaStream_t stream) {
  if (!tiled) {
    pairforward_lp_kernel<T, NT, NTILE><<<B, NT, 0, stream>>>(absorb, rsx, rsy, ix, iy,
                                                               trans, out, X1, Y1);
    return int(cudaGetLastError());
  }
  const size_t bytes = 2 * size_t(rows) * Y1 * sizeof(T);
  auto kernel = pairforward_lp_tiled_kernel<T, NT, NTILE>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  kernel<<<B, NT, bytes, stream>>>(absorb, rsx, rsy, ix, iy, trans, out, X1, Y1, rows);
  return int(cudaGetLastError());
}

// The smallest block that covers Y1 lanes: NT threads (NBIG at most,
// 1024 in float32 and 512 in float64, so that a thread may hold the row
// state of up to 8 tiles in registers), NTILE tiles a row.
template <typename T, int NBIG>
int launch(bool tiled, const T* absorb, const T* rsx, const T* rsy, const T* ix,
           const T* iy, const T* trans, T* out, int B, int X1, int Y1, int rows,
           cudaStream_t stream) {
#define PF_CFG(NT, NTILE) \
  launch_cfg<T, NT, NTILE>(tiled, absorb, rsx, rsy, ix, iy, trans, out, B, X1, Y1, rows, stream)
  if (Y1 <= 512) return PF_CFG(512, 1);
  if (Y1 <= NBIG) return PF_CFG(NBIG, 1);
  if (Y1 <= 2 * NBIG) return PF_CFG(NBIG, 2);
  if (Y1 <= 4 * NBIG) return PF_CFG(NBIG, 4);
  if (Y1 <= 8 * NBIG) return PF_CFG(NBIG, 8);
#undef PF_CFG
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int pairforward_lp_f32(const float* absorb, const float* rsx, const float* rsy,
                                  const float* ix, const float* iy, const float* trans,
                                  float* out, int B, int X1, int Y1, void* stream) {
  return launch<float, 1024>(false, absorb, rsx, rsy, ix, iy, trans, out, B, X1, Y1, 0,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int pairforward_lp_f64(const double* absorb, const double* rsx, const double* rsy,
                                  const double* ix, const double* iy, const double* trans,
                                  double* out, int B, int X1, int Y1, void* stream) {
  return launch<double, 512>(false, absorb, rsx, rsy, ix, iy, trans, out, B, X1, Y1, 0,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int pairforward_lp_tiled_f32(const float* absorb, const float* rsx,
                                        const float* rsy, const float* ix, const float* iy,
                                        const float* trans, float* out, int B, int X1, int Y1,
                                        int rows, void* stream) {
  return launch<float, 1024>(true, absorb, rsx, rsy, ix, iy, trans, out, B, X1, Y1, rows,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int pairforward_lp_tiled_f64(const double* absorb, const double* rsx,
                                        const double* rsy, const double* ix, const double* iy,
                                        const double* trans, double* out, int B, int X1, int Y1,
                                        int rows, void* stream) {
  return launch<double, 512>(true, absorb, rsx, rsy, ix, iy, trans, out, B, X1, Y1, rows,
                             static_cast<cudaStream_t>(stream));
}
