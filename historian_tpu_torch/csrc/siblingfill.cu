// Sibling fill (kernel (d)) on Hopper: the 11-state sibling-transducer
// Forward that aligns two sibling profiles (left x, right y) under their
// parent, in float64, within an envelope mask.
//
// Replaces historian_tpu/ops/siblingdp.py::sibling_forward, an XLA scan
// over x rows with two associative scans along y.  This kernel keeps the
// host route's per-cell order instead (csrc/fill.cpp `sibling_fill`, the
// JAX package's native fill, bit-identical to its Python fill): cell
// (x, y) reads only (x - 1, y), (x, y - 1) and (x - 1, y - 1), each only
// where that neighbour lies in the mask, and computes
//   from (x - 1, y): IIW, IIX, IMD, then WWW and WWX      (+ l_emit[x - 1])
//   from (x, y - 1): IMI, IDI, IDM, then WWW and WXW      (+ r_emit[y - 1])
//   from (x - 1, y - 1): IMM, then WWW                    (+ match emission)
//   and last IDD = lse(WWW, WWX, WXW to IDD)
// with fill.cpp's lse2 and its Neumaier-compensated lse_list.  Every sum
// is __dadd_rn / __dsub_rn, so nothing is contracted; the cells differ
// from fill.cpp only where the card's exp, log and log1p round otherwise
// than the host's libm.  A cell outside the mask is -inf in every state,
// as fill.cpp's grid starts.
//
// The band.  The kernel reads and writes only the band (band.cuh, as
// ops/branchdp.py `band_layout` packs it from each row's hull of in-mask
// interior columns): the emission and the mask byte come in at the band's
// cells, the 11 states go out there, and a neighbour outside the band is
// outside the mask.
//
// What bounds it on this card.  Bytes: 88 B a band cell written, 9 B read.
// The recurrence allows parallel work only along an anti-diagonal, and a
// cell of diagonal k needs diagonals k - 1 and k - 2, so the floor is one
// cell's chain of dependent steps a diagonal (`siblingfill_chain` times
// one): about seven dependent log-sum-exps in float64.
//
// Design (a simple one first).  Threads stride over each diagonal's cells
// and read the neighbours back from the band they write in device memory
// (through L2, __ldcg, since another SM may have written them), with a
// barrier a diagonal.  A banded fill (a diagonal of a few dozen cells)
// takes one block and __syncthreads; a wide one (a full mask: up to 6 000
// cells a diagonal at long6) takes as many blocks as its widest diagonal
// needs, all resident (a cooperative launch), and a grid barrier: a
// monotone arrival counter, bounded spin, __trap() on a lost block.

#include <cstdint>
#include <cuda_runtime.h>

#include "band.cuh"
#include "logspace.cuh"

namespace {

using namespace band;
using logspace::lse2;

constexpr int kStates = 11;
enum { IMM, IMD, IDM, IDD, WWW, WWX, WXW, IMI, IIW, IDI, IIX, EEE };

// fill.cpp sib::lse_list: max shift, then CPython's Neumaier sum.
template <int N>
__device__ __forceinline__ double lse_list(const double (&v)[N]) {
  double m = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k)
    if (v[k] > m) m = v[k];
  if (m == -INFINITY) return -INFINITY;
  double s = 0.0, c = 0.0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const double x = exp(__dsub_rn(v[k], m));
    const double t = __dadd_rn(s, x);
    if (fabs(s) >= fabs(x)) {
      c = __dadd_rn(c, __dadd_rn(__dsub_rn(s, t), x));
    } else {
      c = __dadd_rn(c, __dadd_rn(__dsub_rn(x, t), s));
    }
    s = t;
  }
  return __dadd_rn(m, log(__dadd_rn(s, c)));
}

struct Trans {
  const double* t;  // [12 * 12], t[src * 12 + dest]
  __device__ __forceinline__ double operator()(int s, int d) const { return t[s * 12 + d]; }
};

__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

// fill.cpp's sib_cell for an in-mask cell: `l` is (x - 1, y) or null
// where it is off the grid or outside the mask, `r` is (x, y - 1), `lr`
// (x - 1, y - 1), likewise; le = l_emit[x - 1], ren = r_emit[y - 1], me
// the match emission at (x, y).
__device__ __forceinline__ void sib_cell(double* dest, const double* l, const double* r,
                                         const double* lr, double le, double ren, double me,
                                         bool origin, const Trans& T) {
#pragma unroll
  for (int s = 0; s < kStates; ++s) dest[s] = -INFINITY;
  if (l) {
    {
      const double v[3] = {add(l[IMM], T(IMM, IIW)), add(l[IMI], T(IMI, IIW)),
                           add(l[IIW], T(IIW, IIW))};
      dest[IIW] = add(le, lse_list(v));
    }
    dest[IIX] = add(le, lse2(add(l[IMD], T(IMD, IIX)), add(l[IIX], T(IIX, IIX))));
    {
      const double v[4] = {add(l[WWW], T(WWW, IMD)), add(l[WWX], T(WWX, IMD)),
                           add(l[WXW], T(WXW, IMD)), add(l[IDD], T(IDD, IMD))};
      dest[IMD] = add(le, lse_list(v));
    }
    dest[WWW] = add(dest[IIW], T(IIW, WWW));
    dest[WWX] = lse2(add(dest[IIX], T(IIX, WWX)), add(dest[IMD], T(IMD, WWX)));
  }
  if (r) {
    dest[IMI] = add(ren, lse2(add(r[IMM], T(IMM, IMI)), add(r[IMI], T(IMI, IMI))));
    dest[IDI] = add(ren, lse2(add(r[IDM], T(IDM, IDI)), add(r[IDI], T(IDI, IDI))));
    {
      const double v[4] = {add(r[WWW], T(WWW, IDM)), add(r[WWX], T(WWX, IDM)),
                           add(r[WXW], T(WXW, IDM)), add(r[IDD], T(IDD, IDM))};
      dest[IDM] = add(ren, lse_list(v));
    }
    dest[WWW] = lse2(dest[WWW], add(dest[IMI], T(IMI, WWW)));
    dest[WXW] = lse2(add(dest[IDI], T(IDI, WXW)), add(dest[IDM], T(IDM, WXW)));
  }
  if (lr) {
    const double v[4] = {add(lr[WWW], T(WWW, IMM)), add(lr[WWX], T(WWX, IMM)),
                         add(lr[WXW], T(WXW, IMM)), add(lr[IDD], T(IDD, IMM))};
    dest[IMM] = add(me, lse_list(v));
    dest[WWW] = lse2(dest[WWW], add(dest[IMM], T(IMM, WWW)));
  }
  if (origin) {
    dest[IMM] = 0.0;
    dest[WWW] = T(IMM, WWW);
  }
  const double v[3] = {add(dest[WWW], T(WWW, IDD)), add(dest[WWX], T(WWX, IDD)),
                       add(dest[WXW], T(WXW, IDD))};
  dest[IDD] = lse_list(v);
}

// A neighbour's 11 states read through L2 into `buf`; null where it lies
// outside the band or the mask.
__device__ __forceinline__ const double* neighbour(int kind, int x, int y, const int* rowpos,
                                                   const int* off, int offX,
                                                   const uint8_t* mask, const double* cells,
                                                   double* buf) {
  if (kind == kNone) return nullptr;
  const int pos = pos_of(kind, x, y, rowpos, off, offX);
  if (!mask[pos]) return nullptr;
  const double* c = cells + static_cast<int64_t>(pos) * kStates;
#pragma unroll
  for (int s = 0; s < kStates; ++s) buf[s] = __ldcg(c + s);
  return buf;
}

__global__ void __launch_bounds__(256) siblingfill_kernel(
    const double* __restrict__ emit, const uint8_t* __restrict__ mask,
    const double* __restrict__ l_emit, const double* __restrict__ r_emit,
    const double* __restrict__ t144, const int* __restrict__ rowpos,
    const int* __restrict__ off, const int2* __restrict__ diag, double* cells,
    double* lp_end, unsigned* arrivals, int sx, int sy) {
  const int X = sx - 1, Y = sy - 1, K = sx + sy - 1;
  const int offX = off[X];
  const Trans T{t144};
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  double bl[kStates], br[kStates], blr[kStates], out[kStates];
  for (int k = 0; k < K; ++k) {
    const int2 r = diag[k];
    const int2 r1 = k >= 1 ? diag[k - 1] : r;
    const int2 r2 = k >= 2 ? diag[k - 2] : r;
    const int n = diag_cells(k, r, X, Y);
    for (int t = first; t < n; t += stride) {
      int x = 0;
      const int kind = cell_at(t, k, r, X, Y, x);
      const int y = k - x;
      const int pos = pos_of(kind, x, y, rowpos, off, offX);
      double* dest = cells + static_cast<int64_t>(pos) * kStates;
      if (!mask[pos]) {
#pragma unroll
        for (int s = 0; s < kStates; ++s) dest[s] = -INFINITY;
        continue;
      }
      const double* l = x >= 1 ? neighbour(kind_of(x - 1, y, r1, X, Y), x - 1, y, rowpos, off,
                                           offX, mask, cells, bl)
                               : nullptr;
      const double* rr = y >= 1 ? neighbour(kind_of(x, y - 1, r1, X, Y), x, y - 1, rowpos, off,
                                            offX, mask, cells, br)
                                : nullptr;
      const double* lr = (x >= 1 && y >= 1)
                             ? neighbour(kind_of(x - 1, y - 1, r2, X, Y), x - 1, y - 1, rowpos,
                                         off, offX, mask, cells, blr)
                             : nullptr;
      sib_cell(out, l, rr, lr, x >= 1 ? l_emit[x - 1] : 0.0, y >= 1 ? r_emit[y - 1] : 0.0,
               emit[pos], x == 0 && y == 0, T);
#pragma unroll
      for (int s = 0; s < kStates; ++s) dest[s] = out[s];
    }
    step_sync(arrivals, k);
  }
  if (first == 0) {
    const double* end = cells + static_cast<int64_t>(offX + Y) * kStates;
    const double v[4] = {add(__ldcg(end + IDD), T(IDD, EEE)), add(__ldcg(end + WWW), T(WWW, EEE)),
                         add(__ldcg(end + WWX), T(WWX, EEE)), add(__ldcg(end + WXW), T(WXW, EEE))};
    *lp_end = lse_list(v);
  }
}

// The dependency floor's step: one thread computes `steps` cells in a
// chain, each from three neighbours that are the cell before it (an
// interior cell, every neighbour in the mask), and writes the last.
__global__ void siblingfill_chain(const double* __restrict__ t144, int steps, double* out) {
  const Trans T{t144};
  double c[kStates], n[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) c[s] = -1.0 - 0.1 * s;
  for (int i = 0; i < steps; ++i) {
    sib_cell(n, c, c, c, -3.0, -3.0, -5.0, false, T);
#pragma unroll
    for (int s = 0; s < kStates; ++s) c[s] = n[s] + 3.0;  // keep the values in range
  }
#pragma unroll
  for (int s = 0; s < kStates; ++s) out[s] = c[s];
}

}  // namespace

// Blocks of `threads` threads that can be resident at once on this card
// (a wide fill's cooperative launch takes at most this many).
extern "C" int siblingfill_capacity_f64(int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, siblingfill_kernel, threads, 0))
    return 0;
  return sms * per_sm;
}

// The band's cells [n, 11] (IMM IMD IDM IDD WWW WWX WXW IMI IIW IDI IIX;
// `cells`) and lp_end [1] from the band's match emission [n] and mask
// bytes [n], l_emit [sx - 1], r_emit [sy - 1], the transitions t144
// [12 * 12] (t[src * 12 + dest], -inf where none, as fill.cpp takes them),
// the rows' `rowpos` [sx] and `off` [sx + 1] and the diagonals' (xa, xb)
// [sx + sy - 1], all on the device (ops/branchdp.py `band_layout`), for a
// grid of sx = X + 1 rows and sy = Y + 1 columns.  `blocks` blocks of
// `threads` threads (a multiple of 32, at most 256); more than one block
// is a cooperative launch, and `arrivals` [1] must then be zero.  Returns
// the launch's error.
extern "C" int siblingfill_f64(const double* emit, const uint8_t* mask, const double* l_emit,
                               const double* r_emit, const double* t144, const int* rowpos,
                               const int* off, const int* diag, double* cells, double* lp_end,
                               unsigned* arrivals, int sx, int sy, int blocks, int threads,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int2* dg = reinterpret_cast<const int2*>(diag);
  if (threads < 32 || threads > 256 || threads % 32 || blocks < 1)
    return int(cudaErrorInvalidValue);
  if (blocks == 1) {
    siblingfill_kernel<<<1, threads, 0, s>>>(emit, mask, l_emit, r_emit, t144, rowpos, off, dg,
                                             cells, lp_end, arrivals, sx, sy);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&emit, &mask, &l_emit, &r_emit, &t144, &rowpos, &off,
                  &dg,   &cells, &lp_end, &arrivals, &sx, &sy};
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(siblingfill_kernel),
                                                    dim3(blocks), dim3(threads), args, 0, s);
  return e ? static_cast<int>(e) : static_cast<int>(cudaGetLastError());
}

// `steps` dependent cells in one thread (the dependency floor's step;
// chip_smoke.py times it); out [11].
extern "C" int siblingfill_chain_f64(const double* t144, int steps, double* out, void* stream) {
  siblingfill_chain<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(t144, steps, out);
  return static_cast<int>(cudaGetLastError());
}
