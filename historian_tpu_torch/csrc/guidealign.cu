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
// fills the card.  The envelope keeps 1-3 % of a long pair's diagonals,
// so the kernel works on those only:
// - one block per pair, all pairs in one launch;
// - the wrapper gives each pair its kept diagonals d_0 < ... < d_{ND-1}
//   (diag) and, per column j, the contiguous rank range [lo_j, hi_j) of
//   its live cells (i = j + d_r, 1 <= i <= X); a column runs tiles of
//   31 NT / 32 ranks over [lo_j, hi_j] only (rank hi_j takes NEG, so
//   that the next column's Insert read past the range finds NEG);
// - in rank space M reads rank r of column j-1, I rank r+1 of column j-1
//   where d_{r+1} = d_r + 1 (else NEG), D rank r-1 of column j where
//   d_{r-1} = d_r - 1 (else the Delete chain starts a segment there);
// - the previous and current columns (6 x ND values) and the diagonals
//   live in dynamic shared memory where they fit, else in the device
//   scratch `col` (a full envelope has ND = X + Y - 1);
// - the Delete chain del[i] = max(base[i], del[i-1] + d2d) is the JAX
//   fill's telescoped form: z = base - i*d2d, a segmented running max as
//   warp shuffles plus a scan of the warp totals plus the carry of the
//   previous tile, then + i*d2d.  The multiply and the adds are written
//   with __fmul_rn/__dmul_rn and __fadd_rn/__dadd_rn so nvcc cannot
//   contract them into an FMA: the JAX CPU route rounds each operation
//   separately and the guide must agree bit for bit in float64.  Lane 0
//   of each warp is a halo that evaluates the rank before the warp's
//   first (transparent in the scan), so M, I and D of rank r-1 reach
//   lane r by shuffle: a tile of 31 ranks a warp needs two barriers;
// - no score plane is kept: one back-pointer byte per kept cell,
//   [Y+1, ND] a pair (bits 0-1 the choice of state M, bit 2 of I, bits
//   3-4 of D), computed with exactly the traceback's candidate sums and
//   its order M, I, D, Start with strict > (the first maximum wins);
// - the end cell is a per-thread running best in (j, i) order with strict
//   >, then one block reduction that compares (j, i) and keeps the
//   smallest on ties: the host's flat argmax over [Y, X];
// - the traceback moves by rank (M keeps r, I goes to r+1, D to r-1);
//   the block stages a window of WR back-pointer rows by WC ranks in
//   shared memory, thread 0 walks it, and the window moves when the walk
//   leaves it.
// The kernel allocates nothing (the wrapper passes the scratch) and
// launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kNeg = -1e30;
constexpr int kThreads = 256;
// the traceback's window of back-pointers: rows by ranks
constexpr int kWinRows = 128, kWinRanks = 64;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }

__device__ __forceinline__ bool before(int ja, int ia, int jb, int ib) {
  return ja < jb || (ja == jb && ia < ib);
}

template <typename T, int NT>
__global__ void __launch_bounds__(NT) guidealign_kernel(
    const int* __restrict__ x_tok, const int* __restrict__ y_tok,
    const int* __restrict__ diag, const int* __restrict__ nd_all,
    const int* __restrict__ rank_lo, const int* __restrict__ rank_hi, int NDP,
    const int* __restrict__ x_len, const int* __restrict__ y_len, const T* __restrict__ submat,
    int A, const T* __restrict__ trans, const T* __restrict__ sg, const T* __restrict__ end_x,
    const T* __restrict__ end_y, int PX, int PY, unsigned char* bp_all,
    const long long* __restrict__ bp_off, T* col_all, int in_smem, signed char* steps,
    int* n_steps, int* x_end, int* y_end, int* lead_i, int* lead_j, T* score) {
  constexpr int NW = NT / 32;
  constexpr int kTile = 31 * NW;  // ranks a tile: each warp's lanes 1-31
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ T tot_v[2][NW];
  __shared__ int tot_f[2][NW];
  __shared__ T carry[2];
  __shared__ T red_v[NW];
  __shared__ int red_j[NW], red_i[NW], red_r[NW];
  __shared__ unsigned char win[kWinRows * kWinRanks];
  __shared__ int tb[6];  // the walk: i, j, state, n, rank, finished

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int X = x_len[b], Y = y_len[b], ND = nd_all[b];
  const int* xt = x_tok + size_t(b) * PX;
  const int* yt = y_tok + size_t(b) * PY;
  const T* ex = end_x + size_t(b) * (PX + 1);
  const T* ey = end_y + size_t(b) * (PY + 1);
  const int* lo_b = rank_lo + size_t(b) * (PY + 1);
  const int* hi_b = rank_hi + size_t(b) * (PY + 1);
  unsigned char* bp = bp_all + bp_off[b];
  const T neg = T(kNeg);
  const T m2m = trans[0], m2i = trans[1], m2d = trans[2], i2i = trans[3],
          i2m = trans[4], i2d = trans[5], d2d = trans[6], d2m = trans[7];

  T* colbase;
  const int* dg;
  if (in_smem) {
    colbase = reinterpret_cast<T*>(dyn);
    int* ds = reinterpret_cast<int*>(colbase + 6 * size_t(NDP));
    for (int k = tid; k < ND; k += NT) ds[k] = diag[size_t(b) * NDP + k];
    dg = ds;
  } else {
    colbase = col_all + size_t(b) * 6 * NDP;
    dg = diag + size_t(b) * NDP;
  }
  for (int k = tid; k < 6 * NDP; k += NT) colbase[k] = neg;  // column 0, and every rank
  T* pM = colbase;
  T* pI = colbase + NDP;
  T* pD = colbase + 2 * NDP;
  T* cM = colbase + 3 * NDP;
  T* cI = colbase + 4 * NDP;
  T* cD = colbase + 5 * NDP;
  __syncthreads();

  T best_v = T(-INFINITY);
  int best_j = 0, best_i = 0, best_r = 0;
  // the next column's inputs, loaded a column ahead
  int lo_n = Y >= 1 ? lo_b[1] : 0, hi_n = Y >= 1 ? hi_b[1] : 0, ytk_n = yt[0];
  T sg_n = sg[1], ey_n = ey[1];

  for (int j = 1; j <= Y; ++j) {
    const int lo = lo_n, hi = hi_n, ytk = ytk_n;
    const T sgj = sg_n, endj = ey_n;
    if (j < Y) {
      lo_n = lo_b[j + 1];
      hi_n = hi_b[j + 1];
      ytk_n = yt[j];
      sg_n = sg[j + 1];
      ey_n = ey[j + 1];
    }
    unsigned char* bpj = bp + size_t(j) * ND;
    const int top = min(hi + 1, ND);  // ranks [lo, top): the live ones, then NEG at hi
    const int ntiles = (top - lo + kTile - 1) / kTile;

    // M and I of the live cell at rank q (diagonal dq) of this column
    auto match_insert = [&](int q, int dq, T& m, T& ins, int& ch_m, int& ch_i) {
      const int iq = j + dq;
      T e = T(0);
      const int xtk = xt[iq - 1];
      if (xtk >= 0 && ytk >= 0) e = submat[xtk * A + ytk];
      const T c_m = pM[q] + m2m, c_d = pD[q] + d2m, c_i = pI[q] + i2m;
      const T c_s = sg[iq] + sgj;
      m = vmax(vmax(vmax(c_m, c_d), c_i), c_s) + e;
      const bool up = q + 1 < ND && dg[q + 1] == dq + 1;
      const T ci_i = (up ? pI[q + 1] : neg) + i2i, ci_m = (up ? pM[q + 1] : neg) + m2i;
      ins = vmax(ci_i, ci_m);
      // back-pointer of M: the traceback's sums, order M, I, D, Start
      ch_m = 0;
      T bm = c_m + e;
      T v = c_i + e;
      if (v > bm) { ch_m = 1; bm = v; }
      v = c_d + e;
      if (v > bm) { ch_m = 2; bm = v; }
      v = c_s + e;
      if (v > bm) ch_m = 3;
      ch_i = ci_i > ci_m ? 1 : 0;
    };

    for (int t = 0; t < ntiles; ++t) {
      const int par = t & 1;
      // lane 0 of a warp is its halo: the rank before the warp's first
      const bool own = lane > 0;
      const int r = lo + t * kTile + warp * 31 + lane - 1;
      const bool live = r >= lo && r < hi, in_range = own && r < top;
      const int d = live ? dg[r] : 0;
      const int i = j + d;
      T m = neg, ins = neg;
      int ch_m = 0, ch_i = 0;
      if (live) match_insert(r, d, m, ins, ch_m, ch_i);
      // the cell (i-1, j) is a live envelope cell: rank r-1 on diagonal d-1,
      // held by the lane before
      const bool left = own && live && r - 1 >= lo && dg[r - 1] == d - 1;
      const T m_up = __shfl_up_sync(0xffffffffu, m, 1);
      const T i_up = __shfl_up_sync(0xffffffffu, ins, 1);
      const T m_sh = left ? m_up : neg, i_sh = left ? i_up : neg;

      // ---- Delete: segmented max-plus scan down the ranks; the halo lane
      // is transparent (NEG, no segment start) ----
      const T cd_m = m_sh + m2d, cd_i = i_sh + i2d;
      const T prod = mul_rn(T(i), d2d);
      T sv = own && live ? add_rn(vmax(cd_i, cd_m), -prod) : neg;
      int sf = own && !left ? 1 : 0;
      for (int k = 1; k < 32; k <<= 1) {
        const T ov = __shfl_up_sync(0xffffffffu, sv, k);
        const int of = __shfl_up_sync(0xffffffffu, sf, k);
        if (lane >= k) {
          if (!sf) sv = vmax(sv, ov);
          sf |= of;
        }
      }
      if (lane == 31) {
        tot_v[par][warp] = sv;
        tot_f[par][warp] = sf;
      }
      __syncthreads();
      if (warp == 0) {
        T wv = lane < NW ? tot_v[par][lane] : neg;
        int wf = lane < NW ? tot_f[par][lane] : 1;
        for (int k = 1; k < NW; k <<= 1) {
          const T ov = __shfl_up_sync(0xffffffffu, wv, k);
          const int of = __shfl_up_sync(0xffffffffu, wf, k);
          if (lane >= k) {
            if (!wf) wv = vmax(wv, ov);
            wf |= of;
          }
        }
        if (lane < NW) {
          tot_v[par][lane] = wv;
          tot_f[par][lane] = wf;
        }
      }
      __syncthreads();
      if (warp > 0 && !sf) {
        sv = vmax(sv, tot_v[par][warp - 1]);
        sf = tot_f[par][warp - 1];
      }
      if (t > 0 && !sf) sv = vmax(sv, carry[par ^ 1]);
      if (tid == NT - 1) carry[par] = sv;
      // the halo's value is now the scan's at the rank before: that of the
      // warp before, or the tile before
      const T dv = live ? add_rn(sv, prod) : neg;

      // ---- back-pointers of I and D, and the end cell ----
      const T d_up = __shfl_up_sync(0xffffffffu, dv, 1);
      const T cd_d = (left ? d_up : neg) + d2d;
      int ch_d = 0;
      T bd = cd_m;
      if (cd_i > bd) { ch_d = 1; bd = cd_i; }
      if (cd_d > bd) ch_d = 2;
      if (in_range) {
        cM[r] = m;
        cI[r] = ins;
        cD[r] = dv;
      }
      if (own && live) {
        bpj[r] = (unsigned char)(ch_m | (ch_i << 2) | (ch_d << 3));
        const T sc = m + (ex[i] + endj);
        if (sc > best_v) {
          best_v = sc;
          best_j = j;
          best_i = i;
          best_r = r;
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
  for (int k = 16; k > 0; k >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, best_v, k);
    const int oj = __shfl_down_sync(0xffffffffu, best_j, k);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, k);
    const int orr = __shfl_down_sync(0xffffffffu, best_r, k);
    if (ov > best_v || (ov == best_v && before(oj, oi, best_j, best_i))) {
      best_v = ov;
      best_j = oj;
      best_i = oi;
      best_r = orr;
    }
  }
  if (lane == 0) {
    red_v[warp] = best_v;
    red_j[warp] = best_j;
    red_i[warp] = best_i;
    red_r[warp] = best_r;
  }
  __syncthreads();
  signed char* st = steps + size_t(b) * (PX + PY);
  if (tid == 0) {
    for (int w = 1; w < NW; ++w) {
      const T ov = red_v[w];
      if (ov > best_v || (ov == best_v && before(red_j[w], red_i[w], best_j, best_i))) {
        best_v = ov;
        best_j = red_j[w];
        best_i = red_i[w];
        best_r = red_r[w];
      }
    }
    if (best_v == T(-INFINITY)) {
      // no kept cell in the grid: every cell is NEG, the host's argmax is
      // (1, 1), and its walk takes Start after one Match step
      score[b] = neg + (ex[1] + ey[1]);
      x_end[b] = 1;
      y_end[b] = 1;
      st[0] = 0;
      tb[0] = 0, tb[1] = 0, tb[2] = 3, tb[3] = 1, tb[4] = 0, tb[5] = 1;
    } else {
      score[b] = best_v;
      x_end[b] = best_i;
      y_end[b] = best_j;
      tb[0] = best_i, tb[1] = best_j, tb[2] = 0, tb[3] = 0, tb[4] = best_r, tb[5] = 0;
    }
  }
  __syncthreads();

  // ---- traceback over windows of back-pointers ----
  const int L = X + Y;
  while (!tb[5]) {
    const int j0 = tb[1], r0 = tb[4];
    const int c0 = max(0, min(r0 - kWinRanks / 2, ND - kWinRanks));
    for (int k = tid; k < kWinRows * kWinRanks; k += NT) {
      const int row = j0 - k / kWinRanks, q = c0 + k % kWinRanks;
      if (row >= 1 && q < ND) win[k] = bp[size_t(row) * ND + q];
    }
    __syncthreads();
    if (tid == 0) {
      int i = tb[0], j = tb[1], state = tb[2], n = tb[3], r = tb[4];
      bool more = true;
      for (;;) {
        more = state != 3 && n < L && i >= 1 && j >= 1 && r >= 0 && r < ND;
        if (!more || j <= j0 - kWinRows || r < c0 || r >= c0 + kWinRanks) break;
        const unsigned char c = win[(j0 - j) * kWinRanks + r - c0];
        const int nxt = state == 0 ? (c & 3) : (state == 1 ? ((c >> 2) & 1) : ((c >> 3) & 3));
        st[n++] = (signed char)state;
        if (state != 1) --i;
        if (state != 2) --j;
        r += (state == 1) - (state == 2);
        state = nxt;
      }
      tb[0] = i, tb[1] = j, tb[2] = state, tb[3] = n, tb[4] = r, tb[5] = !more;
    }
    __syncthreads();
  }
  if (tid == 0) {
    n_steps[b] = tb[3];
    lead_i[b] = tb[0];
    lead_j[b] = tb[1];
  }
}

template <typename T>
int launch(const int* x_tok, const int* y_tok, const int* diag, const int* nd,
           const int* rank_lo, const int* rank_hi, int NDP, const int* x_len,
           const int* y_len, const T* submat, int A, const T* trans, const T* sg,
           const T* end_x, const T* end_y, int PX, int PY, unsigned char* bp,
           const long long* bp_off, T* col, signed char* steps, int* n_steps, int* x_end,
           int* y_end, int* lead_i, int* lead_j, T* score, int B, cudaStream_t stream) {
  auto kernel = guidealign_kernel<T, kThreads>;
  int dev = 0, maxb = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&maxb, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return int(e);
  // the two columns and the diagonals in shared memory where they fit
  const size_t cols = 6 * size_t(NDP) * sizeof(T) + size_t(NDP) * sizeof(int);
  const int in_smem = cols + attr.sharedSizeBytes <= size_t(maxb);
  const size_t bytes = in_smem ? cols : 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return int(e);
  kernel<<<B, kThreads, bytes, stream>>>(
      x_tok, y_tok, diag, nd, rank_lo, rank_hi, NDP, x_len, y_len, submat, A, trans, sg,
      end_x, end_y, PX, PY, bp, bp_off, col, in_smem, steps, n_steps, x_end, y_end, lead_i,
      lead_j, score);
  return int(cudaGetLastError());
}

}  // namespace

#define GUIDEALIGN_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const int* x_tok, const int* y_tok, const int* diag, const int* nd,   \
                      const int* rank_lo, const int* rank_hi, int NDP, const int* x_len,    \
                      const int* y_len, const T* submat, int A, const T* trans,             \
                      const T* sg, const T* end_x, const T* end_y, int PX, int PY,          \
                      unsigned char* bp, const long long* bp_off, T* col,                   \
                      signed char* steps, int* n_steps, int* x_end, int* y_end,             \
                      int* lead_i, int* lead_j, T* score, int B, void* stream) {            \
    return launch<T>(x_tok, y_tok, diag, nd, rank_lo, rank_hi, NDP, x_len, y_len, submat, \
                     A, trans, sg, end_x, end_y, PX, PY, bp, bp_off, col, steps, n_steps, \
                     x_end, y_end, lead_i, lead_j, score, B,                                \
                     static_cast<cudaStream_t>(stream));                                    \
  }

GUIDEALIGN_ENTRY(guidealign_f32, float)
GUIDEALIGN_ENTRY(guidealign_f64, double)
