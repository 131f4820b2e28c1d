// The row step of the chain x chain pair DP on Hopper, one warp's lanes
// of one row: K3 and K4's step (pairforward.cu), and the step of kernels
// (f) (tropical.cu), (g2) (sppairforward.cu) and (g3) (pppairforward.cu),
// which are instances of it.
//
// A block holds a run of a grid's columns, M lanes a thread in order (warp
// w the lanes [32 M w, 32 M (w + 1))), and keeps the five states (IMM, IMD,
// IDM, IMI, IIW) of its lanes' last row in registers.  Rows are piped down
// the warps: warp w computes row i once it has finished row i-1 and warp
// w-1 has published row i's values at its last lane (the IMM source, the
// IDM and IMI sources and the two scans' u), so warp w works on row i
// while warp w+1 is on row i-1.  The handoff is a ring of kRing row slots a
// warp in shared memory and a per-warp count of published rows, stored
// with release and polled with acquire at CTA scope; a warp does not
// overwrite a slot that warp w+1 has not read.  Warp 0 takes its left
// neighbour's values from an `Edge`: the grid's left edge, or the strip
// to its left (kernels (f), (g2) and (g3), the strip section below).
//
// Row i, as ops/pairforward.py `pair_forward` computes it, in a semiring S
// (LogSum: log-sum-exp; MaxPlus: max):
//   IMD, IIW  from row i-1 at the same lane, plus rootsub_x[i] or ins_x[i],
//             NEG where y is not ready (the last column);
//   IMM       from row i-1 at lane j-1 (shift1), plus absorb[i, j];
//   IDM, IMI  inclusive affine scans along the row, u[j] = S(a[j], u[j-1]
//             + b[j]), each thread composing its M lanes in order, a
//             5-level shuffle scan of the thread aggregates, then the
//             carry-in from warp w-1 applied with one S a lane.
// NEG = -1e30 is the finite semiring zero.  Two sets of rules:
// - K3Rules (K3, K4: lp_end only): the start row seeded apart (IMM 0 at
//   lane 0), no mask, y not ready on every lane from Y1 - 1 on, the scans
//   not gated (lp_end reads IMM, IMD, IIW only);
// - JaxRules<S> (the JAX package's `pair_forward` and
//   `tropical_pair_forward` in full): row 0 from a NEG row (IMM 0 at
//   column 0, IMD = IIW = NEG), y ready on every column when Y1 = 1, every
//   state NEG outside the mask, the scans' a and b NEG where a cell is out
//   of the mask or x is not ready (the last row, unless X1 = 1), and IDM,
//   IMI NEG there; lp_end over all five states.
// LogSum clamps every input at NEG where it is read (so every value is
// finite and no log-sum-exp needs a branch) and the scans' sums of b at
// NEG; MaxPlus clamps nothing, since every max is exact: an input of -inf
// (float32's log(0 + 1e-300)) gives -inf cells, as in the JAX package.
//
// float32 takes exp and log as one ex2.approx / lg2.approx instruction
// each and the pairwise log-sum-exps of the plain version; float64 takes
// IMD, IIW and the IMM source in linear space scaled by the lane's largest
// state (five exps and three logs, not nine log-sum-exps).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "logspace.cuh"
#include "sync.cuh"

namespace pairstep {

using namespace hsync;
using logspace::cmax;
using logspace::kNeg;

//: row slots a warp in the handoff ring
constexpr int kRing = 4;
//: the slot of a row: the warp's last lane's IMM source, IDM and IMI
//: sources, and the two scans' u
constexpr int kSlot = 5;
//: polls of a counter before a wait gives up (a shared-memory poll is tens
//: of cycles, an L2 or system one hundreds: seconds, far beyond any fill)
constexpr long long kMaxPolls = 1LL << 26;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int NWMAX>
struct PfSmem {
  T tr[23];
  T etr[23];                         // exp(tr), for float64's linear step
  int prog[NWMAX];                   // rows each warp has published
  T ring[NWMAX][kRing][kSlot];       // each warp's published rows
};

// The step's arithmetic, in natural units as the plain version's, so
// both round the long chains of additions alike (log2 units, tried, moved
// a float32 lp_end at 3000 x 3000 far outside 1e-6 of the plain version).
// float32 takes exp and log as one ex2.approx / lg2.approx instruction
// each and a scaling (denormals flushed; ~2^-22 absolute on log(1 + e),
// below the rounding of any lp of magnitude > 4); float64 the accurate
// exp, log and log1p.
template <typename T>
struct Pf;

template <>
struct Pf<float> {
  __device__ static float ex(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
    return y;
  }
  __device__ static float lg(float x) {
    float y;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y * 0.6931471805599453f;
  }
  __device__ static float lg1p(float x) { return lg(1.f + x); }
  __device__ static float max(float a, float b) { return fmaxf(a, b); }
};

template <>
struct Pf<double> {
  __device__ static double ex(double x) { return exp(x); }
  __device__ static double lg(double x) { return log(x); }
  __device__ static double lg1p(double x) { return log1p(x); }
  __device__ static double max(double a, double b) { return fmax(a, b); }
};

// log-sum-exp of two and of three, without a branch.  Every value of the
// LogSum step is finite, and the one -inf, the scans' identity, meets only
// finite values: no (-inf) - (-inf) arises.
template <typename T>
__device__ __forceinline__ T plse(T a, T b) {
  return Pf<T>::max(a, b) + Pf<T>::lg1p(Pf<T>::ex(-fabs(a - b)));
}

template <typename T>
__device__ __forceinline__ T plse3(T a, T b, T c) {
  const T m = Pf<T>::max(Pf<T>::max(a, b), c);
  return m + Pf<T>::lg(Pf<T>::ex(a - m) + Pf<T>::ex(b - m) + Pf<T>::ex(c - m));
}

struct LogSum {
  static constexpr bool kMax = false;
  template <typename T>
  __device__ __forceinline__ static T add(T a, T b) { return plse(a, b); }
  template <typename T>
  __device__ __forceinline__ static T add3(T a, T b, T c) { return plse3(a, b, c); }
  template <typename T>
  __device__ __forceinline__ static T clamp(T a) { return Pf<T>::max(a, T(kNeg)); }
};

struct MaxPlus {
  static constexpr bool kMax = true;
  template <typename T>
  __device__ __forceinline__ static T add(T a, T b) { return a > b ? a : b; }
  template <typename T>
  __device__ __forceinline__ static T add3(T a, T b, T c) { return add(add(a, b), c); }
  template <typename T>
  __device__ __forceinline__ static T clamp(T a) { return a; }
};

struct K3Rules {
  using S = LogSum;
  static constexpr bool kJax = false;
};

template <typename S_>
struct JaxRules {
  using S = S_;
  static constexpr bool kJax = true;
};

template <typename T, int M>
struct Lanes {
  T imm[M], imd[M], idm[M], imi[M], iiw[M];
};

// The block's columns: lanes [0, nc) are live, lane l holds the grid's
// column c0 + l, and the grid's last column is at lane ylast (which may
// lie past nc); y1_one: the grid has one column.
struct Cols {
  int nc, c0, ylast;
  bool y1_one;
};

// Row i's values besides absorb and the y vectors.  K3Rules: rsx, ix
// clamped by the caller, `in` and x_ready unused.
template <typename T>
struct RowX {
  T rsx, ix;
  bool start, x_ready;
  unsigned in;  // bit k: the thread's lane k is in the mask (JaxRules)
};

// The handoff's shared-memory accesses are all volatile asm, so the
// compiler keeps their order and needs no memory clobber: the transitions
// and other loads of the row loop stay free to move.
__device__ __forceinline__ int ld_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)));
  return v;
}

__device__ __forceinline__ void st_release_cta(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(smem_addr(p)), "r"(v));
}

__device__ __forceinline__ void ld_slot(const float* p, float& v) {
  asm volatile("ld.volatile.shared.f32 %0, [%1];" : "=f"(v) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ld_slot(const double* p, double& v) {
  asm volatile("ld.volatile.shared.f64 %0, [%1];" : "=d"(v) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void st_slot(float* p, float v) {
  asm volatile("st.volatile.shared.f32 [%0], %1;" ::"r"(smem_addr(p)), "f"(v));
}

__device__ __forceinline__ void st_slot(double* p, double v) {
  asm volatile("st.volatile.shared.f64 [%0], %1;" ::"r"(smem_addr(p)), "d"(v));
}

// Wait until *p >= want.  Traps when it never comes.
__device__ __forceinline__ void wait_at_least(const int* p, int want) {
  for (long long n = 0; ld_acquire_cta(p) < want; ++n) {
    if (n >= kMaxPolls) __trap();
  }
}

// Warp 0's left neighbour when the block starts at the grid's column 0:
// K3Rules take NEG for all five values, JaxRules the scans' identity -inf
// for the two u (`max_affine_scan`'s u[-1]).  kIoWarps: warps at the end
// of the block that run no row (an `Edge`'s own; none here).
template <typename R>
struct GridEdge {
  static constexpr int kIoWarps = 0;
  template <typename T>
  __device__ __forceinline__ void operator()(int, T&, T&, T&, T& c1, T& c2) const {
    if constexpr (R::kJax) c1 = c2 = T(-INFINITY);
  }
};

// No hand-off of the block's last column.
struct NoTail {
  template <typename T>
  __device__ __forceinline__ void operator()(int, T, T, T, T, T) const {}
};

// Row `x` of one pair for the calling warp, in place on its threads'
// lanes; `step` counts the block's rows from 0 (the ring's slot and the
// warps' counts).  a[k] is absorb at the thread's lane k.  `edge(step,
// src, so, io, u1, u2)` (every lane of warp 0) gives the values left of
// lane 0; `tail(step, src, so, io, u1, u2)` is called by the thread that
// holds lane nc - 1 with that lane's values.  Every thread of the warp
// calls it.
template <typename R, typename T, int M, int NWMAX, typename Edge, typename Tail>
__device__ __forceinline__ void warp_row(Lanes<T, M>& st, int step, const RowX<T>& x,
                                         const T (&a)[M], const T* __restrict__ rsy,
                                         const T* __restrict__ iy, const Cols& g,
                                         PfSmem<T, NWMAX>& sm, const Edge& edge,
                                         const Tail& tail) {
  using P = Pf<T>;
  using S = typename R::S;
  const T neg = T(kNeg);
  const unsigned full = kFull;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x >> 5) - Edge::kIoWarps;
  const int l0 = threadIdx.x * M;
  const bool start = x.start;
  const T* tr = sm.tr;
  T imm[M], imd[M], iiw[M], src[M];
  // 1. IMD, IIW and the IMM source from the thread's own lanes of row i-1.
  //    float32 LogSum takes the plain version's pairwise log-sum-exps, so
  //    both round alike (the linear form below, tried in float32, put the
  //    headline's lp more than 1e-6 of |lp| off the plain version's).
  //    float64 rounds far inside its tolerance either way and takes them
  //    in linear space scaled by the lane's largest state r: five exps
  //    and three logs, not nine log-sum-exps (faster on an H100 than the
  //    pairwise form, which was slower there than the kernel it replaced).
  //    Each sum holds the r state's term exp(tr) > 0 unless its
  //    transition is zero, so the scale loses nothing
#pragma unroll
  for (int k = 0; k < M; ++k) {
    if (!R::kJax && start) {
      imd[k] = iiw[k] = src[k] = neg;
      continue;
    }
    const T pm = st.imm[k], pd = st.imd[k], pi = st.idm[k], pn = st.imi[k], pw = st.iiw[k];
    if constexpr (S::kMax) {
      imd[k] = S::add(S::add3(pm + tr[1], pd + tr[7], pi + tr[11]), pn + tr[15]) + x.rsx;
      iiw[k] = S::add3(pm + tr[4], pn + tr[17], pw + tr[21]) + x.ix;
      src[k] = S::add(S::add(S::add3(pm + tr[0], pd + tr[6], pi + tr[10]), pn + tr[14]),
                      pw + tr[19]);
    } else if constexpr (std::is_same<T, float>::value) {
      imd[k] = plse(plse(pm + tr[1], pd + tr[7]), plse(pi + tr[11], pn + tr[15])) + x.rsx;
      iiw[k] = plse(plse(pm + tr[4], pn + tr[17]), pw + tr[21]) + x.ix;
      src[k] = plse(plse(plse(pm + tr[0], pd + tr[6]), plse(pi + tr[10], pn + tr[14])),
                    pw + tr[19]);
    } else {
      const T* etr = sm.etr;
      const T r = P::max(P::max(P::max(pm, pd), P::max(pi, pn)), pw);
      const T em = P::ex(pm - r), ed = P::ex(pd - r), ei = P::ex(pi - r), en = P::ex(pn - r),
              ew = P::ex(pw - r);
      imd[k] = r + P::lg(em * etr[1] + ed * etr[7] + ei * etr[11] + en * etr[15]) + x.rsx;
      iiw[k] = r + P::lg(em * etr[4] + en * etr[17] + ew * etr[21]) + x.ix;
      src[k] = r + P::lg(em * etr[0] + ed * etr[6] + ei * etr[10] + en * etr[14] + ew * etr[19]);
    }
    if (l0 + k >= g.ylast && !(R::kJax && g.y1_one)) {  // y is not ready on the last lane
      imd[k] = neg;
      iiw[k] = neg;
    }
  }
  // 2. warp w-1's last lane of row i, or the block's left edge
  T p_src = neg, p_so = neg, p_io = neg, c1 = neg, c2 = neg;
  if (warp > 0) {
    wait_at_least(&sm.prog[warp - 1], step + 1);
    const T* s = sm.ring[warp - 1][step % kRing];
    ld_slot(s, p_src);
    ld_slot(s + 1, p_so);
    ld_slot(s + 2, p_io);
    ld_slot(s + 3, c1);
    ld_slot(s + 4, c2);
  } else {
    edge(step, p_src, p_so, p_io, c1, c2);
  }
  // 3. IMM: the source at lane l-1; JaxRules: then the start row and the mask
  T up = __shfl_up_sync(full, src[M - 1], 1);
  if (lane == 0) up = p_src;
  unsigned gate = 0;  // JaxRules: bit k, lane k's scans are live
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int l = l0 + k;
    if constexpr (R::kJax) {
      T m = up + S::clamp(a[k]);
      if (start) {
        if (g.c0 + l == 0) m = T(0);
        imd[k] = iiw[k] = neg;
      }
      const bool in = l < g.nc && (x.in >> k & 1u);
      if (!in) m = imd[k] = iiw[k] = neg;
      imm[k] = m;
      if (in && x.x_ready) gate |= 1u << k;
    } else {
      imm[k] = start ? (l == 0 ? T(0) : neg) : (l < g.nc ? up + P::max(a[k], neg) : neg);
    }
    up = src[k];
  }
  // 4. the IDM and IMI sources at lane l-1, then each lane's (a, b) pairs
  T so[M], io[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    so[k] = !R::kJax && start ? imm[k] + tr[2]
                              : S::add3(imm[k] + tr[2], imd[k] + tr[8], iiw[k] + tr[20]);
    io[k] = imm[k] + tr[3];
  }
  T uo = __shfl_up_sync(full, so[M - 1], 1);
  T ui = __shfl_up_sync(full, io[M - 1], 1);
  if (lane == 0) {
    uo = p_so;
    ui = p_io;
  }
  T v1[M], w1[M], v2[M], w2[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int l = l0 + k;
    const bool live = R::kJax ? (gate >> k & 1u) != 0 : l < g.nc;
    const T ry = live ? S::clamp(__ldg(rsy + l)) : neg;
    const T yi = live ? S::clamp(__ldg(iy + l)) : neg;
    v1[k] = live ? uo + ry : neg;
    w1[k] = live ? tr[12] + ry : neg;
    v2[k] = live ? ui + yi : neg;
    w2[k] = live ? tr[16] + yi : neg;
    uo = so[k];
    ui = io[k];
  }
  // 5. both scans over the thread's lanes in order: v the local u, w the
  //    sum of b from the thread's first lane (LogSum: clamped at NEG)
#pragma unroll
  for (int k = 1; k < M; ++k) {
    v1[k] = S::add(v1[k], v1[k - 1] + w1[k]);
    w1[k] = S::clamp(w1[k - 1] + w1[k]);
    v2[k] = S::add(v2[k], v2[k - 1] + w2[k]);
    w2[k] = S::clamp(w2[k - 1] + w2[k]);
  }
  // 6. the thread aggregates scanned across the warp (Hillis-Steele; a
  //    lane below d combines with the identity (-inf, 0), branch-free)
  T av1 = v1[M - 1], aw1 = w1[M - 1], av2 = v2[M - 1], aw2 = w2[M - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const bool in = lane >= d;
    T ov1 = __shfl_up_sync(full, av1, d), ow1 = __shfl_up_sync(full, aw1, d);
    T ov2 = __shfl_up_sync(full, av2, d), ow2 = __shfl_up_sync(full, aw2, d);
    ov1 = in ? ov1 : T(-INFINITY);
    ow1 = in ? ow1 : T(0);
    ov2 = in ? ov2 : T(-INFINITY);
    ow2 = in ? ow2 : T(0);
    av1 = S::add(av1, ov1 + aw1);
    aw1 = S::clamp(aw1 + ow1);
    av2 = S::add(av2, ov2 + aw2);
    aw2 = S::clamp(aw2 + ow2);
  }
  // 7. the carry into the thread: warp w-1's u through the earlier threads
  const T ev1 = __shfl_up_sync(full, av1, 1), ew1 = __shfl_up_sync(full, aw1, 1);
  const T ev2 = __shfl_up_sync(full, av2, 1), ew2 = __shfl_up_sync(full, aw2, 1);
  const T cin1 = lane == 0 ? c1 : S::add(ev1, c1 + ew1);
  const T cin2 = lane == 0 ? c2 : S::add(ev2, c2 + ew2);
  T u1 = neg, u2 = neg;  // the thread's last lane's u
#pragma unroll
  for (int k = 0; k < M; ++k) {
    u1 = S::add(v1[k], cin1 + w1[k]);
    u2 = S::add(v2[k], cin2 + w2[k]);
    const bool live = !R::kJax || (gate >> k & 1u) != 0;
    st.imm[k] = imm[k];
    st.imd[k] = imd[k];
    st.idm[k] = live ? u1 : neg;
    st.imi[k] = live ? u2 : neg;
    st.iiw[k] = iiw[k];
    if (l0 + k == g.nc - 1) tail(step, src[k], so[k], io[k], u1, u2);
  }
  // 8. publish the warp's last lane for warp w+1, and the row as read
  __syncwarp();  // every lane has read its values of warp w-1's slot
  if (lane == 31) {
    if (warp + 1 < nwarps) {
      if (step >= kRing) wait_at_least(&sm.prog[warp + 1], step - kRing + 1);
      T* s = sm.ring[warp][step % kRing];
      st_slot(s, src[M - 1]);
      st_slot(s + 1, so[M - 1]);
      st_slot(s + 2, io[M - 1]);
      st_slot(s + 3, u1);
      st_slot(s + 4, u2);
    }
    st_release_cta(&sm.prog[warp], step + 1);
  }
}

// Transitions (LogSum: clamped at NEG; and exp(tr)) into shared memory,
// counts to 0: a block barrier.
template <typename S, typename T, int NWMAX>
__device__ __forceinline__ void setup(PfSmem<T, NWMAX>& sm, const T* __restrict__ trans) {
  if (threadIdx.x < 23) {
    sm.tr[threadIdx.x] = S::clamp(trans[threadIdx.x]);
    sm.etr[threadIdx.x] = exp(trans[threadIdx.x]);
  }
  if (threadIdx.x < NWMAX) sm.prog[threadIdx.x] = 0;
  __syncthreads();
}

template <typename T, int M>
__device__ __forceinline__ void fill_neg(Lanes<T, M>& st) {
#pragma unroll
  for (int k = 0; k < M; ++k) st.imm[k] = st.imd[k] = st.idm[k] = st.imi[k] = st.iiw[k] = T(kNeg);
}

// JaxRules' lp_end at the lane that holds the grid's last column (l0 + k
// == ylast): S over the five states plus their end transitions.
template <typename S, typename T, int M>
__device__ __forceinline__ bool end_value(const Lanes<T, M>& st, const T* tr, int l0, int ylast,
                                          T& out) {
#pragma unroll
  for (int k = 0; k < M; ++k) {
    if (l0 + k == ylast) {
      out = S::add(S::add(S::add3(st.imm[k] + tr[5], st.imd[k] + tr[9], st.idm[k] + tr[13]),
                          st.imi[k] + tr[18]),
                   st.iiw[k] + tr[22]);
      return true;
    }
  }
  return false;
}

template <typename T, int M>
__device__ __forceinline__ void load_row(T (&a)[M], const T* __restrict__ row, int l0, int n) {
#pragma unroll
  for (int k = 0; k < M; ++k) a[k] = l0 + k < n ? __ldg(row + l0 + k) : T(0);
}

// The mask bits of the thread's lanes of one row (bytes, 0 out).
template <int M>
__device__ __forceinline__ unsigned load_mask(const uint8_t* __restrict__ row, int l0, int n) {
  unsigned in = 0;
#pragma unroll
  for (int k = 0; k < M; ++k)
    if (l0 + k < n && __ldg(row + l0 + k) != 0) in |= 1u << k;
  return in;
}

// Lanes a thread for n lanes at NWMAX warps at most (0: too wide): the
// fewest of {1, 2, 4, 6, 8}.  No 3: at 3001 lanes 24 warps of 4 lanes
// ran faster on an H100 than 32 warps of 3 (a wide row is bound by the
// SM's instruction issue, and a thread's share of the warp scan falls
// with its lanes).
template <int NWMAX>
int lanes_per_thread(int n) {
  constexpr int kM[] = {1, 2, 4, 6, 8};
  const int need = (n + 32 * NWMAX - 1) / (32 * NWMAX);
  for (int m : kM)
    if (need <= m) return m;
  return 0;
}

// ------------------------------------------ exchange between blocks (global)
__device__ __forceinline__ int ld_acquire(const int* p, bool sys) {
  return sys ? ld_acquire_sys(p) : ld_acquire_gpu(p);
}

__device__ __forceinline__ void st_release(int* p, int v, bool sys) {
  if (sys) {
    st_release_sys(p, v);
  } else {
    st_release_gpu(p, v);
  }
}

// A value another block (or card) wrote: past L1, at system scope for sys.
__device__ __forceinline__ float ld_shared_value(const float* p, bool sys) {
  float v;
  if (sys) {
    asm volatile("ld.relaxed.sys.global.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  } else {
    v = __ldcg(p);
  }
  return v;
}

__device__ __forceinline__ double ld_shared_value(const double* p, bool sys) {
  double v;
  if (sys) {
    asm volatile("ld.relaxed.sys.global.f64 %0, [%1];" : "=d"(v) : "l"(p) : "memory");
  } else {
    v = __ldcg(p);
  }
  return v;
}

// *p += v with release semantics (system scope for sys).
__device__ __forceinline__ void red_release(int* p, int v, bool sys) {
  if (sys) {
    asm volatile("red.release.sys.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
  } else {
    asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
  }
}

// Wait until *p >= want (one thread); traps when it never comes.
__device__ __forceinline__ void wait_global(const int* p, int want, bool sys) {
  for (long long n = 0; ld_acquire(p, sys) < want; ++n) {
    if (n >= kMaxPolls) __trap();
    if (n >= 32) __nanosleep(64);
  }
}

// ------------------------------------------ strips over SMs (kernels (f), (g2), (g3))
//
// Kernels (f), (g2) and (g3) cut a pair's columns (or each shard's, or
// each slot's) into strips of whole warps, one block a strip
// (ops/pairstrips.py `strip_plan`, `slot_plan`), so
// that a wide row runs over tens of SMs at about one warp step's latency a
// row rather than at one SM's issue rate over the whole row.  A strip
// block runs `warps` row warps as above and one io warp, its last, which
// runs no row: it moves the strip's boundary values between blocks, so
// the row warps only touch their own block's shared memory, at CTA scope.
// - In: warp 0's left neighbour comes from the block's `in` ring (kEdge
//   row slots; `in_prog` rows published at CTA scope).  From the left
//   strip of the same thread block cluster, the left block's io warp
//   stores the rows straight into this ring through distributed shared
//   memory (mapa, st.shared::cluster) and publishes them in `in_remote`
//   with a cluster-scope release; this block's io warp hands them on to
//   warp 0 and sends warp 0's progress back to the left block's
//   `right_ack`, so the left never overwrites a slot warp 0 has not read.
//   From a strip of another cluster, or a shard on another card, this io
//   warp polls the left strip's record counter and copies every row it
//   shows into the ring, up to kEdge rows ahead of warp 0: the acquire's
//   latency overlaps the rows before instead of standing on each row.
// - Out: the thread of the strip's last column puts each row's five values
//   in the block's `out` ring (CTA scope); the io warp sends them on, to
//   the right block's `in` ring (at most kEdge rows ahead of the right
//   block's warp 0) or to the record buffer [X1, 8], publishing what it
//   wrote with one release of the counter (system scope where the record
//   crosses cards).
// A record is never waited on by its writer, so a block waits on a block
// of another cluster only to its left: with every block resident (the
// layout is checked against cudaOccupancyMaxActiveClusters) no wait closes
// a cycle.  A cluster synchronises after its counters are set and before
// it exits, so no block's shared memory is written before it is set or
// after it is gone.

//: row warps a strip at most
constexpr int kStripWarps = 8;
//: row warps of kernel (g3)'s whole-row strips at most (16 warps a block
//: with the io warp: 128 registers a thread, as K3's float64 block takes)
constexpr int kRowWarps = 15;
//: row slots of each edge ring
constexpr int kEdge = 32;
//: values a row's record in global memory (5 used)
constexpr int kRecord = 8;
//: the kinds of a strip's left and right edge
constexpr long long kNone = 0, kCluster = 1, kRecordEdge = 2;

// One block of a strip layout (ops/pairstrips.py `strip_table`): 10 int64.
struct StripEntry {
  long long chain, c0, nc;      // the pair (g2) and the strip's columns; nc 0: an idle block
  long long left, right;        // kNone (the chain's end), kCluster or kRecordEdge
  long long in_rec, in_cnt;     // left == kRecordEdge: the left strip's records [X1, 8], counter
  long long out_rec, out_cnt;   // right == kRecordEdge: this strip's
  long long sys;                // a record of this block crosses cards: system scope
};

template <typename T>
struct EdgeSmem {
  T in[kEdge][kSlot];   // the left strip's rows, read by warp 0
  T out[kEdge][kSlot];  // the strip's last column, sent on by the io warp
  int in_prog;          // rows of `in` published to warp 0 (CTA scope)
  int in_remote;        // rows the left block's io warp stored in `in` (cluster scope)
  int out_prog;         // rows of `out` the tail thread published (CTA scope)
  int out_sent;         // rows of `out` the io warp has sent on (CTA scope)
  int right_ack;        // rows the right block's warp 0 has read (cluster scope)
};

// The edge counters to 0; the caller's block barrier (`setup`) and the
// cluster barrier that follows publish them.
template <typename T>
__device__ __forceinline__ void strip_init(EdgeSmem<T>& es) {
  if (threadIdx.x == 0) es.in_prog = es.in_remote = es.out_prog = es.out_sent = es.right_ack = 0;
}

// Warp 0's left neighbour in a strip block: the chain's edge (GridEdge's
// values) or row i of the `in` ring (lane 0 waits and reads, the warp
// takes the values by shuffles).
template <typename R, typename T>
struct StripEdge {
  static constexpr int kIoWarps = 1;
  const EdgeSmem<T>* es;
  bool live;  // the strip has a left neighbour
  __device__ __forceinline__ void operator()(int i, T& src, T& so, T& io, T& c1, T& c2) const {
    if (!live) {
      GridEdge<R>{}(i, src, so, io, c1, c2);
      return;
    }
    T v[kSlot] = {};
    if ((threadIdx.x & 31) == 0) {
      wait_at_least(&es->in_prog, i + 1);
      const T* s = es->in[i % kEdge];
#pragma unroll
      for (int k = 0; k < kSlot; ++k) ld_slot(s + k, v[k]);
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

// The strip's last column, row i, into the `out` ring (the thread that
// holds it; none where the strip ends its chain).
template <typename T>
struct StripTail {
  EdgeSmem<T>* es;
  bool live;  // the strip has a right neighbour
  __device__ __forceinline__ void operator()(int i, T src, T so, T io, T u1, T u2) const {
    if (!live) return;
    if (i >= kEdge) wait_at_least(&es->out_sent, i - kEdge + 1);
    T* s = es->out[i % kEdge];
    st_slot(s, src);
    st_slot(s + 1, so);
    st_slot(s + 2, io);
    st_slot(s + 3, u1);
    st_slot(s + 4, u2);
    st_release_cta(&es->out_prog, i + 1);
  }
};

// The io warp of a strip block (all its lanes): moves X1 rows in and out
// as the section's note says; prog0 counts the rows warp 0 has finished.
// Every count it polls is taken by each lane's own acquire, then the
// warp's least, so the lanes agree and each lane's reads are ordered
// after its acquire.
template <typename T>
__device__ void strip_io(const StripEntry& e, EdgeSmem<T>& es, const int* prog0, int X1) {
  const int lane = threadIdx.x & 31;
  const bool sys = e.sys != 0;
  const unsigned rank = cluster_rank();
  const unsigned left_ack = e.left == kCluster ? remote_addr(&es.right_ack, rank - 1) : 0u;
  const unsigned right_in = e.right == kCluster ? remote_addr(&es.in[0][0], rank + 1) : 0u;
  const unsigned right_cnt = e.right == kCluster ? remote_addr(&es.in_remote, rank + 1) : 0u;
  const T* in_rec = reinterpret_cast<const T*>(e.in_rec);
  const int* in_cnt = reinterpret_cast<const int*>(e.in_cnt);
  T* out_rec = reinterpret_cast<T*>(e.out_rec);
  int* out_cnt = reinterpret_cast<int*>(e.out_cnt);
  // got: rows handed to warp 0; acked: warp 0's rows told to the left
  // block; known: rows the left record's counter showed; sent: rows sent
  // on; taken: rows the right block's warp 0 has read
  int got = 0, acked = 0, known = 0, sent = 0, taken = 0;
  bool in_open = e.left != kNone, out_open = e.right != kNone;
  long long idle = 0;
  while (in_open || out_open) {
    bool moved = false;
    if (in_open) {
      const int done = __reduce_min_sync(kFull, ld_acquire_cta(prog0));
      if (e.left == kRecordEdge) {
        const int space = min(done + kEdge, X1) - got;
        if (space > 0 && known <= got) known = __reduce_min_sync(kFull, ld_acquire(in_cnt, sys));
        const int n = min(known - got, space);
        if (n > 0) {
          for (int v = lane; v < n * kSlot; v += 32) {
            const int r = got + v / kSlot, k = v % kSlot;
            st_slot(&es.in[r % kEdge][k], ld_shared_value(in_rec + size_t(r) * kRecord + k, sys));
          }
          __syncwarp();
          got += n;
          if (lane == 0) st_release_cta(&es.in_prog, got);
          moved = true;
        }
        in_open = got < X1;
      } else {
        const int r = __reduce_min_sync(kFull, ld_acquire_cluster(&es.in_remote));
        if (r > got) {
          got = r;
          if (lane == 0) st_release_cta(&es.in_prog, got);
          moved = true;
        }
        if (done > acked) {
          acked = done;
          if (lane == 0) st_release_remote(left_ack, acked);
          moved = true;
        }
        in_open = acked < X1;
      }
    }
    if (out_open) {
      int n = __reduce_min_sync(kFull, ld_acquire_cta(&es.out_prog)) - sent;
      if (e.right == kCluster) {
        if (n > taken + kEdge - sent) taken = __reduce_min_sync(kFull, ld_acquire_cluster(&es.right_ack));
        n = min(n, taken + kEdge - sent);
      }
      if (n > 0) {
        for (int v = lane; v < n * kSlot; v += 32) {
          const int r = sent + v / kSlot, k = v % kSlot;
          T x;
          ld_slot(&es.out[r % kEdge][k], x);
          if (e.right == kCluster) {
            st_remote(right_in + unsigned(((r % kEdge) * kSlot + k) * sizeof(T)), x);
          } else {
            out_rec[size_t(r) * kRecord + k] = x;
          }
        }
        __syncwarp();
        sent += n;
        if (lane == 0) {
          if (e.right == kCluster) {
            st_release_remote(right_cnt, sent);
          } else {
            if (sys) {
              __threadfence_system();
            } else {
              __threadfence();
            }
            st_release(out_cnt, sent, sys);
          }
          st_release_cta(&es.out_sent, sent);
        }
        moved = true;
      }
      out_open = sent < X1;
    }
    if (moved) {
      idle = 0;
    } else {
      if (++idle >= kMaxPolls) __trap();
      __nanosleep(32);
    }
  }
}

// A strip launch's configuration: `blocks` blocks of `threads` in clusters
// of `cluster` along x.
inline void strip_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int blocks,
                         int threads, size_t smem, int cluster, cudaStream_t s) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// Blocks of a strip kernel (`warps` row warps, at most `max_warps`, and
// the io warp, `smem` dynamic bytes) that can be resident at once in
// clusters of `cluster` (cudaOccupancyMaxActiveClusters times the
// cluster), or -(CUDA error).
template <typename K>
int strip_capacity(K kernel, int warps, size_t smem, int cluster, int max_warps = kStripWarps) {
  if (warps < 1 || warps > max_warps || cluster < 1 || cluster > 16) {
    return -int(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSuccess;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  }
  if (err != cudaSuccess) return -int(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  strip_config(cfg, attr, cluster, 32 * (warps + 1), smem, cluster, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &cfg);
  return err != cudaSuccess ? -int(err) : n * cluster;
}

// Launches a strip kernel on `args`: `blocks` blocks (a whole number of
// clusters) of `warps` row warps and the io warp.  A layout that cannot be
// resident at once is refused (cudaErrorCooperativeLaunchTooLarge).
template <typename K, typename A>
int strip_launch(K kernel, const A& args, int blocks, int warps, int cluster, size_t smem,
                 cudaStream_t s, int max_warps = kStripWarps) {
  if (blocks < 1 || cluster < 1 || blocks % cluster) return int(cudaErrorInvalidValue);
  const int cap = strip_capacity(kernel, warps, smem, cluster, max_warps);
  if (cap < 0) return -cap;
  if (blocks > cap) return int(cudaErrorCooperativeLaunchTooLarge);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  strip_config(cfg, attr, blocks, 32 * (warps + 1), smem, cluster, s);
  void* argv[] = {const_cast<A*>(&args)};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), argv);
  return err != cudaSuccess ? int(err) : int(cudaGetLastError());
}

// f(std::integral_constant<int, M>) for the lanes a thread the strip
// kernels are built for (1, 2, 4); cudaErrorInvalidValue for any other.
template <typename F>
int by_lanes(int lanes, F&& f) {
  switch (lanes) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace pairstep
