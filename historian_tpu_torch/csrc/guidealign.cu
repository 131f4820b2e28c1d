// The guide kernel: banded 3-state (M/I/D) Viterbi fill, best end cell
// and traceback for a batch of sequence pairs, on Hopper.
//
// Replaces historian_tpu/ops/guidedp.py::guide_align_device, which the
// TPU ran as XLA (a vmapped column scan of ops/pairdp.py::
// banded_viterbi_fill plus a batched while_loop traceback), with the same
// outputs: step codes end to start (0 M, 1 I, 2 D, 3 pad), n_steps, the
// best end cell, the cell where the walk took Start (lead_i, lead_j) and
// the end score.  NEG = -1e30 is the semiring zero, as in the JAX fill.
//
// What bounds it on this card: each pair is a sequential chain of y
// columns (column j reads column j-1), so one pair is latency-bound on
// one SM; the batch (~44 pairs for a 12-sequence guide graph) is what
// fills the card.  Design against that bound:
// - one block per pair, all pairs in one launch, so the pairs run on as
//   many SMs at once;
// - a column is swept in tiles of NT lanes, one x lane per thread; the
//   previous and current columns live in a small device scratch
//   (6 x (X+1) values per pair, L1/L2-resident), and the lane-(i-1)
//   reads go through it after a __syncthreads();
// - the Delete chain del[i] = max(base[i], del[i-1] + d2d) is the JAX
//   fill's telescoped form: z = base - i*d2d, a segmented running max
//   (reset at out-of-envelope cells) as warp shuffles plus a scan of the
//   warp totals plus the carry of the previous tile, then + i*d2d.  The
//   multiply and the adds are written with __fmul_rn/__dmul_rn and
//   __fadd_rn/__dadd_rn so nvcc cannot contract them into an FMA: the
//   JAX CPU route rounds each operation separately and the guide must
//   agree bit for bit in float64;
// - no score plane is kept.  Three [Y+1, X+1] planes would be ~450 MB a
//   pair in f32 at 6000 aa; instead the fill stores one back-pointer byte
//   per cell (bits 0-1 the choice of state M, bit 2 of I, bits 3-4 of D),
//   computed with exactly the traceback's candidate sums and its order
//   M, I, D, Start with strict > (the first maximum wins), so the walk
//   reads one byte a step;
// - the end cell is a per-thread running best in (j, i) order with strict
//   >, then one block reduction that keeps the smallest (j, i) on ties:
//   the host's flat argmax over [Y, X];
// - one thread walks the traceback over the back-pointers.
// The kernel allocates nothing (the wrapper passes the scratch) and
// launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kNeg = -1e30;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }

template <typename T, int NT>
__global__ void __launch_bounds__(NT) guidealign_kernel(
    const int* __restrict__ x_tok, const int* __restrict__ y_tok,
    const unsigned char* __restrict__ lut, const int* __restrict__ x_len,
    const int* __restrict__ y_len, const T* __restrict__ submat, int A,
    const T* __restrict__ trans, const T* __restrict__ sg,
    const T* __restrict__ end_x, const T* __restrict__ end_y, int PX, int PY,
    unsigned char* bp_all, const long long* __restrict__ bp_off, T* col_all,
    signed char* steps, int* n_steps, int* x_end, int* y_end, int* lead_i,
    int* lead_j, T* score) {
  constexpr int NW = NT / 32;
  __shared__ T tot_v[NW];
  __shared__ int tot_f[NW];
  __shared__ T carry[2];
  __shared__ T red_v[NW];
  __shared__ int red_j[NW], red_i[NW];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int X = x_len[b], Y = y_len[b];
  const int W = X + 1;
  const int* xt = x_tok + size_t(b) * PX;
  const int* yt = y_tok + size_t(b) * PY;
  const unsigned char* lt = lut + size_t(b) * (PX + PY + 1);
  const T* ex = end_x + size_t(b) * (PX + 1);
  const T* ey = end_y + size_t(b) * (PY + 1);
  unsigned char* bp = bp_all + bp_off[b];
  T* col = col_all + size_t(b) * 6 * (PX + 1);
  const T neg = T(kNeg);
  const T m2m = trans[0], m2i = trans[1], m2d = trans[2], i2i = trans[3],
          i2m = trans[4], i2d = trans[5], d2d = trans[6], d2m = trans[7];

  T* pM = col;
  T* pI = col + (PX + 1);
  T* pD = col + 2 * (PX + 1);
  T* cM = col + 3 * (PX + 1);
  T* cI = col + 4 * (PX + 1);
  T* cD = col + 5 * (PX + 1);
  for (int i = tid; i < W; i += NT) pM[i] = pI[i] = pD[i] = neg;  // column 0
  __syncthreads();

  T best_v = T(-INFINITY);
  int best_j = 0, best_i = 0;
  const int ntiles = (W + NT - 1) / NT;

  for (int j = 1; j <= Y; ++j) {
    const int ytk = yt[j - 1];
    const T sgj = sg[j], endj = ey[j];
    unsigned char* bpj = bp + size_t(j) * W;
    for (int t = 0; t < ntiles; ++t) {
      const int par = t & 1;
      const int i = t * NT + tid;
      const bool live = i < W;
      const bool inner = live && i >= 1;
      const bool msk = inner && lt[i - j + PY] != 0;

      // ---- Match and Insert: the previous column only ----
      const T mp_sh = inner ? pM[i - 1] : neg, ip_sh = inner ? pI[i - 1] : neg,
              dp_sh = inner ? pD[i - 1] : neg;
      const T mp = live ? pM[i] : neg, ip = live ? pI[i] : neg;
      T e = T(0);
      if (inner) {
        const int xtk = xt[i - 1];
        if (xtk >= 0 && ytk >= 0) e = submat[xtk * A + ytk];
      }
      const T c_m = mp_sh + m2m, c_d = dp_sh + d2m, c_i = ip_sh + i2m;
      const T c_s = (live ? sg[i] : neg) + sgj;
      const T m = msk ? vmax(vmax(vmax(c_m, c_d), c_i), c_s) + e : neg;
      const T ci_i = ip + i2i, ci_m = mp + m2i;
      const T ins = msk ? vmax(ci_i, ci_m) : neg;
      // back-pointer of M: the traceback's sums, order M, I, D, Start
      int ch_m = 0;
      T bm = c_m + e;
      T v = c_i + e;
      if (v > bm) { ch_m = 1; bm = v; }
      v = c_d + e;
      if (v > bm) { ch_m = 2; bm = v; }
      v = c_s + e;
      if (v > bm) ch_m = 3;
      const int ch_i = ci_i > ci_m ? 1 : 0;
      if (live) {
        cM[i] = m;
        cI[i] = ins;
      }
      __syncthreads();

      // ---- Delete: segmented max-plus scan down the column ----
      const T m_sh = inner ? cM[i - 1] : neg, i_sh = inner ? cI[i - 1] : neg;
      const T cd_m = m_sh + m2d, cd_i = i_sh + i2d;
      const T prod = mul_rn(T(i), d2d);
      T sv = msk ? add_rn(vmax(cd_i, cd_m), -prod) : neg;
      int sf = msk ? 0 : 1;
      for (int d = 1; d < 32; d <<= 1) {
        const T ov = __shfl_up_sync(0xffffffffu, sv, d);
        const int of = __shfl_up_sync(0xffffffffu, sf, d);
        if (lane >= d) {
          if (!sf) sv = vmax(sv, ov);
          sf |= of;
        }
      }
      if (lane == 31) {
        tot_v[warp] = sv;
        tot_f[warp] = sf;
      }
      __syncthreads();
      if (warp == 0) {
        T wv = lane < NW ? tot_v[lane] : neg;
        int wf = lane < NW ? tot_f[lane] : 1;
        for (int d = 1; d < NW; d <<= 1) {
          const T ov = __shfl_up_sync(0xffffffffu, wv, d);
          const int of = __shfl_up_sync(0xffffffffu, wf, d);
          if (lane >= d) {
            if (!wf) wv = vmax(wv, ov);
            wf |= of;
          }
        }
        if (lane < NW) {
          tot_v[lane] = wv;
          tot_f[lane] = wf;
        }
      }
      __syncthreads();
      if (warp > 0 && !sf) {
        sv = vmax(sv, tot_v[warp - 1]);
        sf = tot_f[warp - 1];
      }
      if (t > 0 && !sf) sv = vmax(sv, carry[par ^ 1]);
      if (tid == NT - 1) carry[par] = sv;
      const T dv = msk ? add_rn(sv, prod) : neg;
      if (live) cD[i] = dv;
      __syncthreads();

      // ---- back-pointers of I and D, and the end cell ----
      const T d_sh = inner ? cD[i - 1] : neg;
      const T cd_d = d_sh + d2d;
      int ch_d = 0;
      T bd = cd_m;
      if (cd_i > bd) { ch_d = 1; bd = cd_i; }
      if (cd_d > bd) ch_d = 2;
      if (live) bpj[i] = (unsigned char)(ch_m | (ch_i << 2) | (ch_d << 3));
      if (inner) {
        const T sc = m + (ex[i] + endj);
        if (sc > best_v) {
          best_v = sc;
          best_j = j;
          best_i = i;
        }
      }
    }
    T* s;
    s = pM; pM = cM; cM = s;
    s = pI; pI = cI; cI = s;
    s = pD; pD = cD; cD = s;
    __syncthreads();
  }

  // ---- end cell: max over threads, the smallest (j, i) on ties ----
  for (int d = 16; d > 0; d >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, best_v, d);
    const int oj = __shfl_down_sync(0xffffffffu, best_j, d);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, d);
    if (ov > best_v || (ov == best_v && (oj < best_j || (oj == best_j && oi < best_i)))) {
      best_v = ov;
      best_j = oj;
      best_i = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = best_v;
    red_j[warp] = best_j;
    red_i[warp] = best_i;
  }
  __syncthreads();
  if (tid != 0) return;
  for (int w = 1; w < NW; ++w) {
    const T ov = red_v[w];
    const int oj = red_j[w], oi = red_i[w];
    if (ov > best_v || (ov == best_v && (oj < best_j || (oj == best_j && oi < best_i)))) {
      best_v = ov;
      best_j = oj;
      best_i = oi;
    }
  }
  score[b] = best_v;
  x_end[b] = best_i;
  y_end[b] = best_j;

  // ---- traceback over the back-pointers ----
  signed char* st = steps + size_t(b) * (PX + PY);
  int i = best_i, j = best_j, state = 0, n = 0;
  const int L = X + Y;
  while (state != 3 && n < L && i >= 1 && j >= 1) {
    const unsigned char c = bp[size_t(j) * W + i];
    const int nxt = state == 0 ? (c & 3) : (state == 1 ? ((c >> 2) & 1) : ((c >> 3) & 3));
    st[n++] = (signed char)state;
    if (state != 1) --i;
    if (state != 2) --j;
    state = nxt;
  }
  n_steps[b] = n;
  lead_i[b] = i;
  lead_j[b] = j;
}

template <typename T, int NT>
int launch(const int* x_tok, const int* y_tok, const unsigned char* lut,
           const int* x_len, const int* y_len, const T* submat, int A,
           const T* trans, const T* sg, const T* end_x, const T* end_y, int PX,
           int PY, unsigned char* bp, const long long* bp_off, T* col,
           signed char* steps, int* n_steps, int* x_end, int* y_end,
           int* lead_i, int* lead_j, T* score, int B, cudaStream_t stream) {
  guidealign_kernel<T, NT><<<B, NT, 0, stream>>>(
      x_tok, y_tok, lut, x_len, y_len, submat, A, trans, sg, end_x, end_y,
      PX, PY, bp, bp_off, col, steps, n_steps, x_end, y_end, lead_i, lead_j,
      score);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int guidealign_f32(const int* x_tok, const int* y_tok,
                              const unsigned char* lut, const int* x_len,
                              const int* y_len, const float* submat, int A,
                              const float* trans, const float* sg,
                              const float* end_x, const float* end_y, int PX,
                              int PY, unsigned char* bp, const long long* bp_off,
                              float* col, signed char* steps, int* n_steps,
                              int* x_end, int* y_end, int* lead_i, int* lead_j,
                              float* score, int B, void* stream) {
  return launch<float, 512>(x_tok, y_tok, lut, x_len, y_len, submat, A, trans,
                            sg, end_x, end_y, PX, PY, bp, bp_off, col, steps,
                            n_steps, x_end, y_end, lead_i, lead_j, score, B,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int guidealign_f64(const int* x_tok, const int* y_tok,
                              const unsigned char* lut, const int* x_len,
                              const int* y_len, const double* submat, int A,
                              const double* trans, const double* sg,
                              const double* end_x, const double* end_y, int PX,
                              int PY, unsigned char* bp, const long long* bp_off,
                              double* col, signed char* steps, int* n_steps,
                              int* x_end, int* y_end, int* lead_i, int* lead_j,
                              double* score, int B, void* stream) {
  return launch<double, 512>(x_tok, y_tok, lut, x_len, y_len, submat, A, trans,
                             sg, end_x, end_y, PX, PY, bp, bp_off, col, steps,
                             n_steps, x_end, y_end, lead_i, lead_j, score, B,
                             static_cast<cudaStream_t>(stream));
}
