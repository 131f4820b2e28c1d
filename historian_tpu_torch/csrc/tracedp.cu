// Trace walker over resident fill planes, on Hopper.
//
// Replaces historian_tpu/ops/tracedp.py::pair_trace_device, an XLA
// while_loop (not Pallas): in eager PyTorch that loop would cost some
// thirty launches per step and up to SX + SY steps per merge.  The JAX
// walker's candidate semantics, exactly:
// - candidates in the host's sorted order: the y-move rows first (y
//   in-edges pre-sorted by source, s' inner), then the x-move row;
// - best traces take the first maximum (strict >);
// - the first step leaves EEE through the end in-edges.
// Sampled traces take the host's rule (DPMatrix.sample_cell), so that they
// use the run's mt19937 draws one for one: weights exp(lp - lpmax), ptot
// summed in candidate order, p = u * ptot, then p -= w_k in that order, and
// the first candidate of positive weight with p <= 0 wins (every product,
// sum and difference rounded on its own, no fused multiply-add).  A walk
// draws once a step, the EEE step included; the sampled walks of a merge
// run one after another in one block, walk t reading its draws from where
// walk t - 1 stopped in one flat buffer, while a second block walks the
// best trace.
//
// What bounds it on this card: each step depends on the one before and
// reads 5 (KY + 1) scattered plane cells, so a walk is a chain of
// dependent latencies: the cell reads (the planes, 0.7 GB at long12's
// first merge in f32, are far larger than the 50 MB L2, though a walk's
// neighbouring cells share cache lines, so most reads hit L2) and the one
// warp's own chain of instructions, which measures as the larger.  Design
// against that bound:
// - one warp walks a trace, lane k evaluating candidate k, so all of a
//   step's loads issue at once; the best walk and the chain of sampled
//   walks run in two blocks side by side.  The sampled walks cannot run
//   side by side: a walk's first draw is known only when the walk before
//   it ends, and one launch carrying the offset from walk to walk costs no
//   read-back between walks.  Where M =
//   5 (KY + 1) <= 32 each lane keeps its move's constants for the whole
//   walk, the first maximum is two or three warp reductions (redux) of
//   order-preserving keys, the smallest lane winning ties, and the chosen
//   move comes from its lane by shuffle; otherwise candidates go in rounds
//   of 32 and a shuffle reduction keeps the smallest k on equal values.  A
//   sampled step sums its weights and subtracts them from u * ptot in
//   candidate order, as the plain walker does (on every lane through
//   shuffles, or by lane 0 over shared memory in rounds), and a ballot
//   finds the first live k whose running p is <= 0;
// - the y side (y_src, y_lp, y_null, tx, t6) is staged into shared
//   memory by the whole block once, where it fits (the launcher decides
//   from the sizes); otherwise it is read from device memory;
// - the plane cells are read from device memory.  A ring of the rows
//   below the walk in shared memory, kept filled by a producer warp with
//   cp.async, made the walk slower: the rows' cells hit L2 already.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr double kNeg = -1e30;
constexpr int IMM = 0, IMD = 1, IDM = 2, IMI = 3, IIW = 4, EEE = 5;
// the shared ints: the path's (i, j, s) of 32 steps
constexpr int kInts = 3 * 32;
// every thread stages the y side; then warp 0 walks
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// PairHMM.sources as a [dest][src] table
__device__ __forceinline__ bool is_source(int dest, int src) {
  switch (dest) {
    case IMM: return true;
    case IMD: return src != IIW;
    case IDM: return src != IMI;
    case IMI: return src == IMM || src == IMI;
    case IIW: return src == IMM || src == IIW || src == IMI;
  }
  return false;
}

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
// rounded one at a time, as the host's floats are: never contracted to FMA
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__device__ __forceinline__ T cmax(T a, T b) { return a > b ? a : b; }

// The y side, in shared or device memory.
template <typename T>
struct YSide {
  const int* y_src;
  const T* y_lp;
  const unsigned char* y_null;
  const T* tx;
  const T* t6;
};

// Candidate k of dest (i, j, s): the log weight of its move, its source
// cell (ci, cj, cs) and whether the move is live for state s.
template <typename T>
__device__ __forceinline__ T move_lp(const YSide<T>& y, int KY, int SX, int i, int j, int s,
                                     int k, int& ci, int& cj, int& cs, bool& live) {
  const T neg = T(kNeg);
  const T txi = y.tx[i < 0 ? i + SX : i];
  if (k < KY * 5) {
    const int kk = k / 5, sp = k % 5;
    const T yl = y.y_lp[j * KY + kk];
    const bool ynul = y.y_null[j] != 0;
    const bool is_imm = s == IMM;
    T lp;
    if (ynul) {
      lp = sp == (is_imm ? IMM : s) ? yl : neg;
    } else {
      const T emit = is_imm ? (is_source(IMM, sp) ? T(0) : neg) + y.t6[sp * 6 + IMM] + txi
                            : (is_source(s, sp) ? T(0) : neg) + y.t6[sp * 6 + s];
      lp = yl + emit;
    }
    ci = is_imm && !ynul ? i - 1 : i;
    cj = y.y_src[j * KY + kk];
    cs = sp;
    live = s == IMM || s == IDM || s == IMI;
    return lp;
  }
  const int sp = k - KY * 5;
  ci = i - 1;
  cj = j;
  cs = sp;
  live = s == IMD || s == IIW;
  return (is_source(s, sp) ? T(0) : neg) + y.t6[sp * 6 + s] + txi;
}

// Order-preserving unsigned keys (-0 taken as +0, as > takes them equal).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ unsigned long long order_key(double v) {
  const unsigned long long u = static_cast<unsigned long long>(__double_as_longlong(v + 0.0));
  return (u >> 63) ? ~u : (u | (1ull << 63));
}

// The lane holding the first maximum of v among the lanes with `valid`,
// the same on every lane: warp reductions of the keys, then the smallest
// lane among the equal ones.
__device__ __forceinline__ int first_max_lane(float v, bool valid, int lane) {
  const unsigned key = valid ? order_key(v) : 0u;
  const unsigned top = __reduce_max_sync(kFull, key);
  return int(__reduce_min_sync(kFull, key == top ? unsigned(lane) : 32u));
}
__device__ __forceinline__ int first_max_lane(double v, bool valid, int lane) {
  const unsigned long long key = valid ? order_key(v) : 0ull;
  const unsigned hi = unsigned(key >> 32), lo = unsigned(key);
  const unsigned th = __reduce_max_sync(kFull, hi);
  const unsigned tl = __reduce_max_sync(kFull, hi == th ? lo : 0u);
  return int(__reduce_min_sync(kFull, hi == th && lo == tl ? unsigned(lane) : 32u));
}

// The host's sampled pick over lanes 0..M-1 (M <= 32), lane k holding
// weight w_k (0 on lanes >= M), the same on every lane: ptot and then p
// run through the weights in lane order on every lane; the first lane of
// positive weight whose p is <= 0 wins, else (p above 0 by rounding) the
// last lane of positive weight.
template <typename T>
__device__ __forceinline__ int sampled_lane(T w, T u, int M, int lane) {
  T ptot = T(0);
  for (int k = 0; k < M; ++k) ptot = add_rn(ptot, __shfl_sync(kFull, w, k));
  T p = mul_rn(u, ptot), mine = T(0);
  for (int k = 0; k < M; ++k) {
    p = sub_rn(p, __shfl_sync(kFull, w, k));
    if (k == lane) mine = p;
  }
  const unsigned live = __ballot_sync(kFull, w > T(0));
  const unsigned hit = __ballot_sync(kFull, w > T(0) && mine <= T(0));
  return hit ? __ffs(hit) - 1 : (live ? 31 - __clz(live) : 0);
}

// The chosen index among M candidates, the same on every lane.  eval(k,
// cv) returns candidate k's value and its cell value cv; both are kept in
// sv, sc [M] (shared memory).  Best: the first maximum.  Sampled: the
// host's rule (sampled_lane), by lane 0 over shared memory.
template <typename T, typename F>
__device__ int choose(F eval, int M, T u, bool best, T* sv, T* sc, int lane) {
  T lb = T(-INFINITY);
  int lk = M;
  for (int k0 = 0; k0 < M; k0 += 32) {
    const int k = k0 + lane;
    if (k < M) {
      T cv;
      const T v = eval(k, cv);
      sv[k] = v;
      sc[k] = cv;
      if (v > lb) {
        lb = v;
        lk = k;
      }
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    const T ov = __shfl_xor_sync(kFull, lb, d);
    const int ok = __shfl_xor_sync(kFull, lk, d);
    if (ov > lb || (ov == lb && ok < lk)) {
      lb = ov;
      lk = ok;
    }
  }
  __syncwarp();
  if (best) return lk;
  for (int k = lane; k < M; k += 32) sv[k] = dexp(sv[k] - lb);
  __syncwarp();
  int pick = 0;
  if (lane == 0) {  // the host's rule, serially in candidate order
    T ptot = T(0);
    for (int k = 0; k < M; ++k) ptot = add_rn(ptot, sv[k]);
    T p = mul_rn(u, ptot);
    for (int k = 0; k < M; ++k) {
      p = sub_rn(p, sv[k]);
      if (sv[k] > T(0)) {
        pick = k;
        if (p <= T(0)) break;
      }
    }
  }
  return __shfl_sync(kFull, pick, 0);
}

template <typename T, bool STAGED>
__global__ void __launch_bounds__(kThreads) pairtrace_kernel(
    const T* __restrict__ planes, int SY, int SX, YSide<T> yg, int KY, int xe_src,
    const T* __restrict__ xe_lp, const int* __restrict__ ye_src, const T* __restrict__ ye_lp,
    int KE, const T* __restrict__ uniforms, int n_best, int T_, int L, int Mpad,
    int* pi, int* pj, int* ps, T* vals, int* n_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  T* sv = reinterpret_cast<T*>(smem);  // [Mpad] candidate values, then weights
  T* sc = sv + Mpad;                   // [Mpad] candidate cell values
  T* bv = sc + Mpad;                   // [32] the path's last values, before they are stored
  int* bi = reinterpret_cast<int*>(bv + 32);  // [3][32] the path's last cells
  int* bj = bi + 32;
  int* bs = bj + 32;
  YSide<T> y = yg;
  if constexpr (STAGED) {
    const size_t ny = size_t(SY) * KY;
    T* s_lp = reinterpret_cast<T*>(bi + kInts);
    T* s_tx = s_lp + ny;
    T* s_t6 = s_tx + SX;
    int* s_src = reinterpret_cast<int*>(s_t6 + 36);
    unsigned char* s_null = reinterpret_cast<unsigned char*>(s_src + ny);
#pragma unroll 4
    for (size_t k = tid; k < ny; k += kThreads) {
      s_lp[k] = yg.y_lp[k];
      s_src[k] = yg.y_src[k];
    }
#pragma unroll 4
    for (int k = tid; k < SX; k += kThreads) s_tx[k] = yg.tx[k];
#pragma unroll 4
    for (int k = tid; k < SY; k += kThreads) s_null[k] = yg.y_null[k];
    if (tid < 36) s_t6[tid] = yg.t6[tid];
    y = YSide<T>{s_src, s_lp, s_null, s_tx, s_t6};
    __syncthreads();
  }
  if (tid >= 32) return;

  // ---- the walks: block 0 walks the best trace where there is one, the
  // other block the sampled traces one after another, walk t taking its
  // draws from where walk t - 1 stopped ----
  const T neg = T(kNeg);
  const size_t plane = size_t(SY) * SX;
  auto cell = [&](int q, int row, int col) -> T {
    return planes[q * plane + size_t(row) * SX + col];
  };
  const bool best = n_best && blockIdx.x == 0;
  size_t off = 0;
  for (int t = best ? 0 : n_best; t < (best ? 1 : T_); ++t) {
    const T* u = uniforms + off;
    int* opi = pi + size_t(t) * L;
    int* opj = pj + size_t(t) * L;
    int* ops = ps + size_t(t) * L;
    T* ov = vals + size_t(t) * L;

    // ---- EEE step: the end in-edges ----
    const T xl = *xe_lp;
    const int k0 = choose<T>(
        [&](int k, T& cv) -> T {
          const int kk = k / 5, sp = k % 5;
          cv = cell(sp, ye_src[kk], xe_src);
          return cmax(ye_lp[kk] + y.t6[sp * 6 + EEE] + xl + cv, neg);
        },
        KE * 5, best ? T(0) : u[0], best, sv, sc, lane);
    int i = xe_src, j = ye_src[k0 / 5], s = k0 % 5;
    // the path goes to the buffers first, to device memory 32 steps at a time
    auto record = [&](int m, T v) {
      if (lane == 0) {
        bi[m & 31] = i;
        bj[m & 31] = j;
        bs[m & 31] = s;
        bv[m & 31] = i >= 0 ? v : neg;
      }
    };
    auto flush = [&](int m) {  // steps m - (m & 31) .. m
      __syncwarp();
      const int base = m - (m & 31);
      if (lane <= (m & 31)) {
        opi[base + lane] = bi[lane];
        opj[base + lane] = bj[lane];
        ops[base + lane] = bs[lane];
        ov[base + lane] = bv[lane];
      }
      __syncwarp();
    };
    record(0, sc[k0]);
    int n = 0, count = i >= 0;
    const int M = (KY + 1) * 5;
    // M <= 32 (KY <= 5): lane k holds candidate k for the whole walk, so its
    // move's constants are set once
    const bool one_round = M <= 32, has_cand = lane < M, is_y = lane < KY * 5;
    const int lk = lane / 5, lsp = lane % 5;
    unsigned gate = 0;  // bit d: lsp is a source of dest state d
    for (int d = 0; d < 5; ++d) gate |= unsigned(is_source(d, lsp)) << d;
    // y-moves are live into IMM, IDM and IMI, x-moves into IMD and IIW
    const unsigned live_into =
        is_y ? (1u << IMM) | (1u << IDM) | (1u << IMI) : (1u << IMD) | (1u << IIW);
    const T* t6c = y.t6 + lsp * 6;
    while (!(i == 0 && j == 0) && n + 1 < L) {
      const T un = best ? T(0) : u[n + 1];
      __syncwarp();  // every lane has read the last step's sv, sc
      if (one_round) {
        // the move's log weight as move_lp computes it, from this lane's constants
        const T txi = y.tx[i < 0 ? i + SX : i];
        const T gated = (gate >> s) & 1 ? T(0) : neg;
        T lp;
        int ci = i - 1, cj = j;
        const T emit = gated + t6c[s];
        if (is_y) {
          const int e = j * KY + lk;
          const T yl = y.y_lp[e];
          const bool ynul = y.y_null[j] != 0;
          lp = ynul ? (lsp == s ? yl : neg) : yl + (s == IMM ? emit + txi : emit);
          ci = s == IMM && !ynul ? i - 1 : i;
          cj = y.y_src[e];
        } else {
          lp = emit + txi;
        }
        T cv = T(0), v = neg;
        if (has_cand) {
          cv = cell(lsp, cj, ci > 0 ? ci : 0);
          v = (live_into >> s) & 1 ? cmax(lp + cv, neg) : neg;
        }
        int kc = first_max_lane(v, has_cand, lane);
        if (!best) {
          const T top = __shfl_sync(kFull, v, kc);
          kc = sampled_lane(has_cand ? dexp(v - top) : T(0), un, M, lane);
        }
        i = __shfl_sync(kFull, ci, kc);
        j = __shfl_sync(kFull, cj, kc);
        s = kc % 5;
        ++n;
        record(n, __shfl_sync(kFull, cv, kc));
        if ((n & 31) == 31) flush(n);
        count += i >= 0;
        continue;
      }
      const int ci = i, cj = j, cs = s;
      const int k = choose<T>(
          [&](int kk, T& cv) -> T {
            int a, b, c;
            bool live;
            const T lp = move_lp(y, KY, SX, ci, cj, cs, kk, a, b, c, live);
            cv = cell(c, b, a > 0 ? a : 0);
            return live ? cmax(lp + cv, neg) : neg;
          },
          M, un, best, sv, sc, lane);
      bool live;
      move_lp(y, KY, SX, ci, cj, cs, k, i, j, s, live);
      ++n;
      record(n, sc[k]);
      if ((n & 31) == 31) flush(n);
      count += i >= 0;
    }
    if ((n & 31) != 31) flush(n);
    for (int m = n + 1 + lane; m < L; m += 32) {
      opi[m] = -1;
      opj[m] = -1;
      ops[m] = -1;
      ov[m] = neg;
    }
    if (lane == 0) n_steps[t] = count;
    off += n + 1;  // a walk draws once a step, the EEE step included
  }
}

template <typename T>
int launch(const T* planes, int SY, int SX, const int* y_src, const T* y_lp, int KY,
           const unsigned char* y_null, const T* tx, const T* t6, int xe_src, const T* xe_lp,
           const int* ye_src, const T* ye_lp, int KE, const T* uniforms,
           int n_best, int T_, int L, int* pi, int* pj, int* ps, T* vals,
           int* n_steps, cudaStream_t stream) {
  const int M = 5 * (KY + 1 > KE ? KY + 1 : KE);
  const int Mpad = (M + 31) / 32 * 32;
  const size_t base = (2 * size_t(Mpad) + 32) * sizeof(T) + kInts * sizeof(int);
  const size_t yside = (size_t(SY) * KY + SX + 36) * sizeof(T) +
                       size_t(SY) * KY * sizeof(int) + size_t(SY);
  int dev = 0, maxb = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&maxb, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return int(e);
  const bool staged = base + yside <= size_t(maxb);
  const size_t bytes = staged ? base + yside : base;
  if (bytes > size_t(maxb)) return int(cudaErrorInvalidValue);
  auto kernel = staged ? pairtrace_kernel<T, true> : pairtrace_kernel<T, false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return int(e);
  const YSide<T> y{y_src, y_lp, y_null, tx, t6};
  const int blocks = n_best + (T_ > n_best ? 1 : 0);
  kernel<<<blocks, kThreads, bytes, stream>>>(planes, SY, SX, y, KY, xe_src, xe_lp, ye_src, ye_lp,
                                             KE, uniforms, n_best, T_, L, Mpad, pi, pj, ps,
                                             vals, n_steps);
  return int(cudaGetLastError());
}

}  // namespace

#define PAIRTRACE_ENTRY(NAME, T)                                                         \
  extern "C" int NAME(const T* planes, int SY, int SX, const int* y_src, const T* y_lp,   \
                      int KY, const unsigned char* y_null, const T* tx, const T* t6,      \
                      int xe_src, const T* xe_lp, const int* ye_src, const T* ye_lp,      \
                      int KE, const T* uniforms, int n_best, int T_,                     \
                      int L, int* pi, int* pj, int* ps, T* vals, int* n_steps,            \
                      void* stream) {                                                     \
    return launch<T>(planes, SY, SX, y_src, y_lp, KY, y_null, tx, t6, xe_src, xe_lp,     \
                     ye_src, ye_lp, KE, uniforms, n_best, T_, L, pi, pj, ps, vals,        \
                     n_steps, static_cast<cudaStream_t>(stream));                         \
  }

PAIRTRACE_ENTRY(pairtrace_f32, float)
PAIRTRACE_ENTRY(pairtrace_f64, double)
