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
// - a warp step (`warp_row`, shared by both kernels) spends few
//   instructions a lane: IMD, IIW and the IMM source from the thread's
//   registers (in float64 in linear space: five exps and three logs a
//   lane, not nine log-sum-exps); shift1 by __shfl_up_sync, lane 0 taking
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

#include <type_traits>

#include "logspace.cuh"

namespace {

using namespace logspace;

//: row slots a warp in the handoff ring
constexpr int kRing = 4;
//: the slot of a row: the warp's last lane's IMM source, IDM and IMI
//: sources, and the two scans' u
constexpr int kSlot = 5;
//: polls of a counter before a wait gives up (a shared-memory poll is tens
//: of cycles, so this is about a second, far beyond any fill's skew)
constexpr long long kMaxPolls = 1LL << 26;

template <typename T, int NWMAX>
struct PfSmem {
  T tr[23];
  T etr[23];                         // exp(tr), for float64's linear step
  int prog[NWMAX];                   // rows each warp has published
  T ring[NWMAX][kRing][kSlot];       // each warp's published rows
};
// ops/pairforward.py K4_STATIC_SMEM: what K4 leaves beside its slabs
static_assert(sizeof(PfSmem<double, 16>) <= 8192 && sizeof(PfSmem<float, 32>) <= 8192,
              "the handoff ring outgrew K4_STATIC_SMEM");

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
// step is finite (inputs are clamped at NEG where they are read), and the
// one -inf, the scans' identity, meets only finite values: no
// (-inf) - (-inf) arises.
template <typename T>
__device__ __forceinline__ T plse(T a, T b) {
  return Pf<T>::max(a, b) + Pf<T>::lg1p(Pf<T>::ex(-fabs(a - b)));
}

template <typename T>
__device__ __forceinline__ T plse3(T a, T b, T c) {
  const T m = Pf<T>::max(Pf<T>::max(a, b), c);
  return m + Pf<T>::lg(Pf<T>::ex(a - m) + Pf<T>::ex(b - m) + Pf<T>::ex(c - m));
}

template <typename T, int M>
struct Lanes {
  T imm[M], imd[M], idm[M], imi[M], iiw[M];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

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

// Row i of one pair for the calling warp, in place on its threads' lanes.
// `start`: the start row (no absorb); otherwise a[k] is absorb[i, l0 + k]
// and rsx_i, ix_i are max(rsx[i], NEG) and max(ix[i], NEG).  l0 is the
// thread's first lane; every thread of the warp calls it.
template <typename T, int M, int NWMAX>
__device__ __forceinline__ void warp_row(Lanes<T, M>& st, int i, bool start, const T (&a)[M],
                                         T rsx_i, T ix_i, const T* __restrict__ rsy,
                                         const T* __restrict__ iy, int l0, int Y1,
                                         PfSmem<T, NWMAX>& sm) {
  using P = Pf<T>;
  const T neg = T(kNeg);
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const T* tr = sm.tr;
  T imm[M], imd[M], iiw[M], src[M];
  // 1. IMD, IIW and the IMM source from the thread's own lanes of row i-1.
  //    float32 takes the plain version's pairwise log-sum-exps, so both
  //    round alike (the linear form below, tried in float32, put the
  //    headline's lp more than 1e-6 of |lp| off the plain version's).
  //    float64 rounds far inside its tolerance either way and takes them
  //    in linear space scaled by the lane's largest state r: five exps
  //    and three logs, not nine log-sum-exps (faster on an H100 than the
  //    pairwise form, which was slower there than the kernel it replaced).
  //    Each sum holds the r state's term exp(tr) > 0 unless its
  //    transition is zero, so the scale loses nothing
#pragma unroll
  for (int k = 0; k < M; ++k) {
    if (start) {
      imd[k] = iiw[k] = src[k] = neg;
      continue;
    }
    const T pm = st.imm[k], pd = st.imd[k], pi = st.idm[k], pn = st.imi[k], pw = st.iiw[k];
    if constexpr (std::is_same<T, float>::value) {
      imd[k] = plse(plse(pm + tr[1], pd + tr[7]), plse(pi + tr[11], pn + tr[15])) + rsx_i;
      iiw[k] = plse(plse(pm + tr[4], pn + tr[17]), pw + tr[21]) + ix_i;
      src[k] = plse(plse(plse(pm + tr[0], pd + tr[6]), plse(pi + tr[10], pn + tr[14])),
                    pw + tr[19]);
    } else {
      const T* etr = sm.etr;
      const T r = P::max(P::max(P::max(pm, pd), P::max(pi, pn)), pw);
      const T em = P::ex(pm - r), ed = P::ex(pd - r), ei = P::ex(pi - r), en = P::ex(pn - r),
              ew = P::ex(pw - r);
      imd[k] = r + P::lg(em * etr[1] + ed * etr[7] + ei * etr[11] + en * etr[15]) + rsx_i;
      iiw[k] = r + P::lg(em * etr[4] + en * etr[17] + ew * etr[21]) + ix_i;
      src[k] = r + P::lg(em * etr[0] + ed * etr[6] + ei * etr[10] + en * etr[14] + ew * etr[19]);
    }
    if (l0 + k >= Y1 - 1) {  // y is not ready on the last lane
      imd[k] = neg;
      iiw[k] = neg;
    }
  }
  // 2. warp w-1's last lane of row i
  T p_src = neg, p_so = neg, p_io = neg, c1 = neg, c2 = neg;
  if (warp > 0) {
    wait_at_least(&sm.prog[warp - 1], i + 1);
    const T* s = sm.ring[warp - 1][i % kRing];
    ld_slot(s, p_src);
    ld_slot(s + 1, p_so);
    ld_slot(s + 2, p_io);
    ld_slot(s + 3, c1);
    ld_slot(s + 4, c2);
  }
  // 3. IMM: the source at lane l-1
  T up = __shfl_up_sync(full, src[M - 1], 1);
  if (lane == 0) up = p_src;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int l = l0 + k;
    imm[k] = start ? (l == 0 ? T(0) : neg) : (l < Y1 ? up + P::max(a[k], neg) : neg);
    up = src[k];
  }
  // 4. the IDM and IMI sources at lane l-1, then each lane's (a, b) pairs
  T so[M], io[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    so[k] = start ? imm[k] + tr[2] : plse3(imm[k] + tr[2], imd[k] + tr[8], iiw[k] + tr[20]);
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
    const bool live = l < Y1;
    const T ry = live ? P::max(__ldg(rsy + l), neg) : neg;
    const T yi = live ? P::max(__ldg(iy + l), neg) : neg;
    v1[k] = live ? uo + ry : neg;
    w1[k] = live ? tr[12] + ry : neg;
    v2[k] = live ? ui + yi : neg;
    w2[k] = live ? tr[16] + yi : neg;
    uo = so[k];
    ui = io[k];
  }
  // 5. both scans over the thread's lanes in order: v the local u, w the
  //    clamped sum of b from the thread's first lane
#pragma unroll
  for (int k = 1; k < M; ++k) {
    v1[k] = plse(v1[k], v1[k - 1] + w1[k]);
    w1[k] = P::max(w1[k - 1] + w1[k], neg);
    v2[k] = plse(v2[k], v2[k - 1] + w2[k]);
    w2[k] = P::max(w2[k - 1] + w2[k], neg);
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
    av1 = plse(av1, ov1 + aw1);
    aw1 = P::max(aw1 + ow1, neg);
    av2 = plse(av2, ov2 + aw2);
    aw2 = P::max(aw2 + ow2, neg);
  }
  // 7. the carry into the thread: warp w-1's u through the earlier threads
  const T ev1 = __shfl_up_sync(full, av1, 1), ew1 = __shfl_up_sync(full, aw1, 1);
  const T ev2 = __shfl_up_sync(full, av2, 1), ew2 = __shfl_up_sync(full, aw2, 1);
  const T cin1 = lane == 0 ? c1 : plse(ev1, c1 + ew1);
  const T cin2 = lane == 0 ? c2 : plse(ev2, c2 + ew2);
#pragma unroll
  for (int k = 0; k < M; ++k) {
    st.imm[k] = imm[k];
    st.imd[k] = imd[k];
    st.idm[k] = plse(v1[k], cin1 + w1[k]);
    st.imi[k] = plse(v2[k], cin2 + w2[k]);
    st.iiw[k] = iiw[k];
  }
  // 8. publish the warp's last lane for warp w+1, and the row as read
  __syncwarp();  // every lane has read its values of warp w-1's slot
  if (lane == 31) {
    if (warp + 1 < nwarps) {
      if (i >= kRing) wait_at_least(&sm.prog[warp + 1], i - kRing + 1);
      T* s = sm.ring[warp][i % kRing];
      st_slot(s, src[M - 1]);
      st_slot(s + 1, so[M - 1]);
      st_slot(s + 2, io[M - 1]);
      st_slot(s + 3, st.idm[M - 1]);
      st_slot(s + 4, st.imi[M - 1]);
    }
    st_release_cta(&sm.prog[warp], i + 1);
  }
}

// Transitions (clamped at NEG, and exp(tr)) into shared memory, counts to
// 0: the block's only barrier.
template <typename T, int NWMAX>
__device__ __forceinline__ void setup(PfSmem<T, NWMAX>& sm, const T* __restrict__ trans) {
  if (threadIdx.x < 23) {
    sm.tr[threadIdx.x] = cmax(trans[threadIdx.x], T(kNeg));
    sm.etr[threadIdx.x] = exp(trans[threadIdx.x]);
  }
  if (threadIdx.x < NWMAX) sm.prog[threadIdx.x] = 0;
  __syncthreads();
}

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

template <typename T, int M>
__device__ __forceinline__ void load_row(T (&a)[M], const T* __restrict__ row, int l0, int Y1) {
#pragma unroll
  for (int k = 0; k < M; ++k) a[k] = l0 + k < Y1 ? __ldg(row + l0 + k) : T(0);
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
  setup(sm, trans);
  Lanes<T, M> st;
  T a[M];
  warp_row<T, M, NWMAX>(st, 0, true, a, T(0), T(0), ry, yi, l0, Y1, sm);
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
    warp_row<T, M, NWMAX>(st, i, false, a, rsx_i, ix_i, ry, yi, l0, Y1, sm);
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
  setup(sm, trans);
  Lanes<T, M> st;
  T a[M];
  warp_row<T, M, NWMAX>(st, 0, true, a, T(0), T(0), ry, yi, l0, Y1, sm);
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
    warp_row<T, M, NWMAX>(st, i, false, a, cmax(__ldg(rx + i), neg), cmax(__ldg(xi + i), neg),
                          ry, yi, l0, Y1, sm);
  }
  write_corner<T, M, NWMAX>(st, l0, Y1, sm, out + b);
}

// Lanes a thread for Y1 lanes at NWMAX warps at most (0: too wide): the
// fewest of {1, 2, 4, 6, 8}.  No 3: at 3001 lanes 24 warps of 4 lanes
// ran faster on an H100 than 32 warps of 3 (a wide row is bound by the
// SM's instruction issue, and a thread's share of the warp scan falls
// with its lanes).
template <int NWMAX>
int lanes_per_thread(int Y1) {
  constexpr int kM[] = {1, 2, 4, 6, 8};
  const int need = (Y1 + 32 * NWMAX - 1) / (32 * NWMAX);
  for (int m : kM)
    if (need <= m) return m;
  return 0;
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
