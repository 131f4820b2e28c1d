// Trace walker over resident fill planes, on Hopper.
//
// Replaces historian_tpu/ops/tracedp.py::pair_trace_device, an XLA
// while_loop (not Pallas): in eager PyTorch that loop would cost some
// thirty launches per step and up to SX + SY steps per merge.  Here one
// thread walks one trace from the EEE cell back to the start cell, with
// the JAX walker's candidate semantics exactly:
// - candidates in the host's sorted order: the y-move rows first (y
//   in-edges pre-sorted by source, s' inner), then the x-move row;
// - best traces take the first maximum (strict >);
// - sampled traces take the first candidate whose running weight
//   exp(lp - lpmax) reaches u * ptot;
// - the first step leaves EEE through the end in-edges.
// What bounds it on this card: each step depends on the previous one and
// gathers (KY + 1) * 5 scattered plane cells, so a walk is a chain of
// dependent memory latencies; traces run in parallel, one per thread.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr double kNeg = -1e30;
constexpr int IMM = 0, IMD = 1, IDM = 2, IMI = 3, IIW = 4, EEE = 5;

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

template <typename T>
__device__ __forceinline__ T cmax(T a, T b) { return a > b ? a : b; }

template <typename T>
struct Walk {
  const T* planes;
  size_t plane;
  int SX;
  const int* y_src;
  const T* y_lp;
  int KY;
  const unsigned char* y_null;
  const T* tx;
  const T* t6;

  __device__ T cell(int q, int jj, int ii) const {
    return planes[q * plane + size_t(jj) * SX + ii];
  }

  // Candidate k of dest (i, j, s): its log weight and source cell.
  __device__ T candidate(int i, int j, int s, int k, int& ci, int& cj, int& cs) const {
    const T neg = T(kNeg);
    const T txi = tx[i < 0 ? i + SX : i];
    if (k < KY * 5) {
      const int kk = k / 5, sp = k % 5;
      const int src = y_src[j * KY + kk];
      const T yl = y_lp[j * KY + kk];
      const bool ynul = y_null[j] != 0;
      const bool is_imm = s == IMM;
      T lp;
      if (ynul) {
        lp = sp == (is_imm ? IMM : s) ? yl : neg;
      } else {
        const T emit = is_imm ? (is_source(IMM, sp) ? T(0) : neg) + t6[sp * 6 + IMM] + txi
                              : (is_source(s, sp) ? T(0) : neg) + t6[sp * 6 + s];
        lp = yl + emit;
      }
      const int yi = is_imm && !ynul ? i - 1 : i;
      ci = yi;
      cj = src;
      cs = sp;
      const bool live = s == IMM || s == IDM || s == IMI;
      return live ? cmax(lp + cell(sp, src, yi > 0 ? yi : 0), neg) : neg;
    }
    const int sp = k - KY * 5;
    const T lp = (is_source(s, sp) ? T(0) : neg) + t6[sp * 6 + s] + txi;
    ci = i - 1;
    cj = j;
    cs = sp;
    const bool live = s == IMD || s == IIW;
    return live ? cmax(lp + cell(sp, j, i - 1 > 0 ? i - 1 : 0), neg) : neg;
  }
};

// First-max (best) or cumulative-weight (sampled) choice among M
// candidates produced by cand(k, ci, cj, cs).
template <typename T, typename F>
__device__ void pick(F cand, int M, T u, bool best, int& ni, int& nj, int& ns) {
  int ci, cj, cs;
  T top = cand(0, ni, nj, ns);
  for (int k = 1; k < M; ++k) {
    const T v = cand(k, ci, cj, cs);
    if (v > top) {
      top = v;
      ni = ci;
      nj = cj;
      ns = cs;
    }
  }
  if (best) return;
  T ptot = T(0);
  for (int k = 0; k < M; ++k) ptot += dexp(cand(k, ci, cj, cs) - top);
  const T p = u * ptot;
  T cum = T(0);
  for (int k = 0; k < M; ++k) {
    cum += dexp(cand(k, ci, cj, cs) - top);
    if (cum >= p) {
      ni = ci;
      nj = cj;
      ns = cs;
      return;
    }
  }
  cand(0, ni, nj, ns);  // no index reached p: index 0, as argmax of all-false
}

template <typename T>
__global__ void pairtrace_kernel(Walk<T> w, int xe_src, const T* xe_lp,
                                 const int* ye_src, const T* ye_lp, int KE,
                                 const T* uniforms, const unsigned char* is_best,
                                 int T_, int L, int* pi, int* pj, int* ps,
                                 T* vals, int* n_steps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T_) return;
  const T neg = T(kNeg);
  const bool best = is_best[t] != 0;
  const T* u = uniforms + size_t(t) * L;
  int* opi = pi + size_t(t) * L;
  int* opj = pj + size_t(t) * L;
  int* ops = ps + size_t(t) * L;
  T* ov = vals + size_t(t) * L;
  const T xl = *xe_lp;

  int i, j, s;
  auto end_cand = [&](int k, int& ci, int& cj, int& cs) -> T {
    const int kk = k / 5, sp = k % 5;
    ci = xe_src;
    cj = ye_src[kk];
    cs = sp;
    return cmax(ye_lp[kk] + w.t6[sp * 6 + EEE] + xl + w.cell(sp, cj, xe_src), neg);
  };
  pick<T>(end_cand, KE * 5, u[0], best, i, j, s);

  int n = 0, count = 0;
  auto record = [&](int m) {
    opi[m] = i;
    opj[m] = j;
    ops[m] = s;
    ov[m] = i >= 0 ? w.cell(s, j, i) : neg;
    count += i >= 0;
  };
  record(0);
  const int M = (w.KY + 1) * 5;
  while (!(i == 0 && j == 0) && n + 1 < L) {
    const int ci = i, cj = j, cs = s;
    auto step_cand = [&](int k, int& a, int& b, int& c) -> T {
      return w.candidate(ci, cj, cs, k, a, b, c);
    };
    pick<T>(step_cand, M, u[n + 1], best, i, j, s);
    ++n;
    record(n);
  }
  for (int m = n + 1; m < L; ++m) {
    opi[m] = -1;
    opj[m] = -1;
    ops[m] = -1;
    ov[m] = neg;
  }
  n_steps[t] = count;
}

template <typename T>
int launch(const T* planes, int SY, int SX, const int* y_src, const T* y_lp,
           int KY, const unsigned char* y_null, const T* tx, const T* t6,
           int xe_src, const T* xe_lp, const int* ye_src, const T* ye_lp,
           int KE, const T* uniforms, const unsigned char* is_best, int T_,
           int L, int* pi, int* pj, int* ps, T* vals, int* n_steps,
           cudaStream_t stream) {
  Walk<T> w{planes, size_t(SY) * SX, SX, y_src, y_lp, KY, y_null, tx, t6};
  const int threads = 32;
  pairtrace_kernel<T><<<(T_ + threads - 1) / threads, threads, 0, stream>>>(
      w, xe_src, xe_lp, ye_src, ye_lp, KE, uniforms, is_best, T_, L, pi, pj,
      ps, vals, n_steps);
  return int(cudaGetLastError());
}

}  // namespace

#define PAIRTRACE_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* planes, int SY, int SX, const int* y_src,       \
                      const T* y_lp, int KY, const unsigned char* y_null,      \
                      const T* tx, const T* t6, int xe_src, const T* xe_lp,    \
                      const int* ye_src, const T* ye_lp, int KE,               \
                      const T* uniforms, const unsigned char* is_best, int T_, \
                      int L, int* pi, int* pj, int* ps, T* vals,               \
                      int* n_steps, void* stream) {                            \
    return launch<T>(planes, SY, SX, y_src, y_lp, KY, y_null, tx, t6, xe_src,  \
                     xe_lp, ye_src, ye_lp, KE, uniforms, is_best, T_, L, pi,   \
                     pj, ps, vals, n_steps,                                    \
                     static_cast<cudaStream_t>(stream));                       \
  }

PAIRTRACE_ENTRY(pairtrace_f32, float)
PAIRTRACE_ENTRY(pairtrace_f64, double)
