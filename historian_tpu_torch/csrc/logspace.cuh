// Log-space helpers of the Forward kernels: the column fills K1 and K2
// (colforward_step.cuh) use all of them but lse2, the pair-Forward kernels
// K3 and K4 (pairforward.cu) NEG and cmax, the sibling fill (d)
// (siblingfill.cu) and the DAG fill (a) (dagfill.cu) lse2.
//
// NEG = -1e30 is the finite semiring zero.  lse never forms
// (-inf) - (-inf).  The block scan solves the affine recurrence
// u[l] = lse(a[l], u[l-1] + b[l]) along the lanes of a block, NT lanes a
// tile, one lane per thread, for two recurrences at once: it scans the
// pairs (v, w) = (a, b) with the combine
//   (vl, wl) o (vr, wr) = (lse(vr, vl + wr), max(wl + wr, NEG))
// by warp shuffles, then a scan of the warp totals by warp 0, then the
// carry of the previous tile's last lane.  Buffers are double-buffered by
// tile parity, so consecutive tiles need no extra barrier.

#pragma once

#include <cuda_runtime.h>

namespace logspace {

constexpr double kNeg = -1e30;

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dlog1p(float x) { return log1pf(x); }
__device__ __forceinline__ double dlog1p(double x) { return log1p(x); }

template <typename T>
__device__ __forceinline__ T lse(T a, T b) {
  const T m = a > b ? a : b;
  const T n = a > b ? b : a;
  if (n == -INFINITY) return m;  // covers both -inf: no (-inf) - (-inf)
  return m + dlog1p(dexp(n - m));
}

template <typename T>
__device__ __forceinline__ T cmax(T a, T b) { return a > b ? a : b; }

constexpr double kLog2 = 0.693147180559945309417232121458176568;  // fill.cpp LOG2

// csrc/fill.cpp lse2 (the host fills' log-sum-exp of two, numpy's
// logaddexp formulation) with every sum rounded as the host rounds it
// (__dadd_rn, never contracted), so a kernel that keeps fill.cpp's order
// differs from it only where the card's exp and log1p round otherwise.
__device__ __forceinline__ double lse2(double x, double y) {
  if (x == y) return __dadd_rn(x, kLog2);  // also both -inf
  const double d = __dsub_rn(x, y);
  if (d > 0) return __dadd_rn(x, log1p(exp(-d)));
  if (d <= 0) return __dadd_rn(y, log1p(exp(d)));
  return __dadd_rn(x, y);  // nan propagation
}

// The barrier of the threads that run a block scan: the whole block, or
// (NamedBar) the first N threads, where the block has more warps (an io
// warp) that do not take part.
struct BlockBar {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

template <int N>
struct NamedBar {
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync 1, %0;" ::"n"(N) : "memory");
  }
};

// Value of `v` at lane l-1.  Lane 0 of the tile takes the previous tile's
// last lane, lane 0 of tile 0 takes `neg`.  buf holds each warp's last
// lane, by tile parity.
template <typename T, int NT, typename Bar = BlockBar>
__device__ __forceinline__ T prev_lane(T v, T (&buf)[2][NT / 32], int par,
                                       int t, int lane, int warp, T neg) {
  T up = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 31) buf[par][warp] = v;
  Bar{}();
  if (lane == 0) up = warp > 0 ? buf[par][warp - 1] : (t > 0 ? buf[par ^ 1][NT / 32 - 1] : neg);
  return up;
}

template <typename T, int NT>
struct ScanSmem {
  T sc[4][2][NT / 32];  // warp totals of the two scans (by tile parity)
  T carry[2][2];        // the previous tile's last lane of each scan (by parity)
};

// Two inclusive affine scans over lanes, tile t of a row: on entry
// (v1, w1) and (v2, w2) are each lane's (a, b); on exit v1 and v2 are u.
// Every thread of the block calls it.
template <typename T, int NT, typename Bar = BlockBar>
__device__ __forceinline__ void block_affine_scan2(T& v1, T& w1, T& v2, T& w2,
                                                   ScanSmem<T, NT>& s, int par, int t,
                                                   int tid, int lane, int warp, T neg) {
  constexpr int NW = NT / 32;
  for (int d = 1; d < 32; d <<= 1) {
    const T ov1 = __shfl_up_sync(0xffffffffu, v1, d);
    const T ow1 = __shfl_up_sync(0xffffffffu, w1, d);
    const T ov2 = __shfl_up_sync(0xffffffffu, v2, d);
    const T ow2 = __shfl_up_sync(0xffffffffu, w2, d);
    if (lane >= d) {
      v1 = lse(v1, ov1 + w1);
      w1 = cmax(w1 + ow1, neg);
      v2 = lse(v2, ov2 + w2);
      w2 = cmax(w2 + ow2, neg);
    }
  }
  if (lane == 31) {
    s.sc[0][par][warp] = v1;
    s.sc[1][par][warp] = w1;
    s.sc[2][par][warp] = v2;
    s.sc[3][par][warp] = w2;
  }
  Bar{}();
  if (warp == 0) {
    T sv1 = lane < NW ? s.sc[0][par][lane] : neg;
    T sw1 = lane < NW ? s.sc[1][par][lane] : neg;
    T sv2 = lane < NW ? s.sc[2][par][lane] : neg;
    T sw2 = lane < NW ? s.sc[3][par][lane] : neg;
    for (int d = 1; d < NW; d <<= 1) {
      const T ov1 = __shfl_up_sync(0xffffffffu, sv1, d);
      const T ow1 = __shfl_up_sync(0xffffffffu, sw1, d);
      const T ov2 = __shfl_up_sync(0xffffffffu, sv2, d);
      const T ow2 = __shfl_up_sync(0xffffffffu, sw2, d);
      if (lane >= d) {
        sv1 = lse(sv1, ov1 + sw1);
        sw1 = cmax(sw1 + ow1, neg);
        sv2 = lse(sv2, ov2 + sw2);
        sw2 = cmax(sw2 + ow2, neg);
      }
    }
    if (lane < NW) {
      s.sc[0][par][lane] = sv1;
      s.sc[1][par][lane] = sw1;
      s.sc[2][par][lane] = sv2;
      s.sc[3][par][lane] = sw2;
    }
  }
  Bar{}();
  if (warp > 0) {  // prefix of the earlier warps of this tile
    v1 = lse(v1, s.sc[0][par][warp - 1] + w1);
    w1 = cmax(w1 + s.sc[1][par][warp - 1], neg);
    v2 = lse(v2, s.sc[2][par][warp - 1] + w2);
    w2 = cmax(w2 + s.sc[3][par][warp - 1], neg);
  }
  if (t > 0) {  // u at the previous tile's last lane
    v1 = lse(v1, s.carry[par ^ 1][0] + w1);
    v2 = lse(v2, s.carry[par ^ 1][1] + w2);
  }
  if (tid == NT - 1) {
    s.carry[par][0] = v1;
    s.carry[par][1] = v2;
  }
}

}  // namespace logspace
