// DAG x DAG merge fill (kernel (a)) on Hopper: the 5-state pair-HMM
// Forward of a merge whose x is not a chain (a sampled or posterior
// profile) against any profile y, in float64, within the guide envelope.
//
// Replaces historian_tpu/ops/dagforward.py::dag_pair_forward_cells, an
// XLA scan over x rows that solves the y recurrences with null-state
// gathers, an affine scan and a junction scan.  This kernel keeps the host
// route's per-cell order instead (csrc/fill.cpp `fwd_cell`): a cell (i, j)
// sums, in-edge by in-edge in CSR order,
//   from (x source, j):          IMD and IIW (+ rootsubx, insx), or, x null,
//                                IMD, IIW and IMM passed on;
//   from (i, y source):          IDM and IMI (+ rootsuby, insy), or, y null,
//                                IDM, IMI and (x emit or start) IMM passed on;
//   from (x source, y source):   IMM, x in-edges outer (+ absorb);
// with fill.cpp's lse2 (logspace.cuh) and every sum __dadd_rn, so nothing
// is contracted and the cells differ from fill.cpp only where the card's
// exp and log1p round otherwise than the host's libm.
//
// Order.  Profile states are toposorted; with each state's level (1 + the
// largest level of its in-edges' sources; fill.cpp `in_levels`) a cell
// reads only cells of a smaller level_x[i] + level_y[j], its wavefront.
// The host plans the in-envelope cells sorted by wavefront
// (ops/dagforward.py `plan`): `plan` holds each cell's (i, j), `wave` where
// each wavefront starts.  An in-edge may reach far back, so every cell
// stays in device memory.
//
// The band.  The cells live in the band of each row's hull of the
// envelope (band.cuh, ops/branchdp.py `band_layout`); a source is found
// through the layout's row offsets, and one outside the band reads -inf,
// as the host grid holds there.  Band cells outside the envelope stay
// -inf (the kernel writes -inf over the band first).
//
// What bounds it on this card.  Bytes: 40 B a band cell written, the
// plan's 8 B and the absorb's 8 B an in-envelope cell read.  The floor is
// one cell's chain of steps a wavefront (`dagfill_chain` times one): one
// thread works out a cell's ~20 log-sum-exps in float64 one after another
// (5.76 us a cell on an H100 80GB HBM3 at 700 W, chip_smoke.py (o)).
//
// Design (a simple one first).  One thread a cell of a wavefront (threads
// stride over a wavefront wider than the launch), neighbours read back
// from device memory through L2 (__ldcg: another SM may have written
// them), a barrier a wavefront.  A banded fill takes one block and
// __syncthreads; a wider one as many blocks as its widest wavefront needs,
// all resident (a cooperative launch), and band.cuh's grid barrier.

#include <cstdint>
#include <cuda_runtime.h>

#include "band.cuh"
#include "logspace.cuh"

namespace {

using namespace band;
using logspace::lse2;

enum { IMM, IMD, IDM, IMI, IIW };
constexpr int kStates = 5;
constexpr uint8_t kXNull = 1, kXReady = 2, kXEos = 4;  // ops/dagforward.py X_*
constexpr uint8_t kYNull = 1, kYReady = 2;             // Y_*

// fill.cpp's Trans, in its order.
struct Trans {
  double imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw;
  double imd_imm, imd_imd, imd_idm;
  double idm_imm, idm_imd, idm_idm;
  double imi_imm, imi_imd, imi_imi, imi_iiw;
  double iiw_imm, iiw_idm, iiw_iiw;
};

struct Args {
  const int2* plan;        // [N] (i, j), by wavefront
  const int* wave;         // [W + 1]
  const double* absorb;    // [N]
  const int *x_ptr, *x_src;  // in-edge CSR of x states 0..sx-1
  const double* x_lp;
  const int *y_ptr, *y_src;
  const double* y_lp;
  const uint8_t *x_flags, *y_flags;
  const double *insx, *rootsubx, *insy, *rootsuby;
  const Trans* t;
  const int *rowpos, *off;
  const int2* diag;
  double* cells;           // [n, 5], the band
  int n, W, sx, sy;
};

__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

// A cell's five states read through L2 into `c`; -inf outside the band.
__device__ __forceinline__ void load(const Args& a, int x, int y, double (&c)[kStates]) {
  const int X = a.sx - 1, Y = a.sy - 1;
  const int kind = kind_of(x, y, a.diag[x + y], X, Y);
  if (kind == kNone) {
#pragma unroll
    for (int s = 0; s < kStates; ++s) c[s] = -INFINITY;
    return;
  }
  const double* p =
      a.cells + static_cast<int64_t>(pos_of(kind, x, y, a.rowpos, a.off, a.off[X])) * kStates;
#pragma unroll
  for (int s = 0; s < kStates; ++s) c[s] = __ldcg(p + s);
}

// fill.cpp fwd_cell for the in-envelope cell (i, j); `ab` its absorb.
__device__ __forceinline__ void fwd_cell(const Args& a, int i, int j, double ab,
                                         double (&out)[kStates]) {
  const Trans& t = *a.t;
  const uint8_t xf = a.x_flags[i], yf = a.y_flags[j];
  const bool xnull = xf & kXNull, x_ready = xf & kXReady;
  const bool ynull = yf & kYNull, y_ready = yf & kYReady;
  const bool origin = i == 0 && j == 0;
  const int xe0 = a.x_ptr[i], xe1 = a.x_ptr[i + 1];
  const int ye0 = a.y_ptr[j], ye1 = a.y_ptr[j + 1];
  double imm = origin ? 0.0 : -INFINITY;
  double imd = -INFINITY, idm = -INFINITY, imi = -INFINITY, iiw = -INFINITY;
  double sc[kStates];

  if (!xnull) {
    if (y_ready) {
      for (int e = xe0; e < xe1; ++e) {
        const double lp = a.x_lp[e];
        load(a, a.x_src[e], j, sc);
        imd = lse2(imd, add(lse2(lse2(lse2(add(sc[IMM], t.imm_imd), add(sc[IMD], t.imd_imd)),
                                      add(sc[IDM], t.idm_imd)), add(sc[IMI], t.imi_imd)), lp));
        iiw = lse2(iiw, add(lse2(lse2(add(sc[IMM], t.imm_iiw), add(sc[IMI], t.imi_iiw)),
                                 add(sc[IIW], t.iiw_iiw)), lp));
      }
      imd = add(imd, a.rootsubx[i]);
      iiw = add(iiw, a.insx[i]);
    }
  } else if (y_ready) {
    for (int e = xe0; e < xe1; ++e) {
      const double lp = a.x_lp[e];
      load(a, a.x_src[e], j, sc);
      imd = lse2(imd, add(sc[IMD], lp));
      iiw = lse2(iiw, add(sc[IIW], lp));
    }
  }

  if (!ynull) {
    if (x_ready) {
      for (int e = ye0; e < ye1; ++e) {
        const double lp = a.y_lp[e];
        load(a, i, a.y_src[e], sc);
        idm = lse2(idm, add(lse2(lse2(lse2(add(sc[IMM], t.imm_idm), add(sc[IMD], t.imd_idm)),
                                      add(sc[IDM], t.idm_idm)), add(sc[IIW], t.iiw_idm)), lp));
        imi = lse2(imi, add(lse2(add(sc[IMM], t.imm_imi), add(sc[IMI], t.imi_imi)), lp));
      }
      idm = add(idm, a.rootsuby[j]);
      imi = add(imi, a.insy[j]);
    }
  } else {
    for (int e = ye0; e < ye1; ++e) {
      const double lp = a.y_lp[e];
      load(a, i, a.y_src[e], sc);
      idm = lse2(idm, add(sc[IDM], lp));
      imi = lse2(imi, add(sc[IMI], lp));
    }
  }

  if (!xnull && !ynull) {
    for (int ex = xe0; ex < xe1; ++ex) {
      const int xs = a.x_src[ex];
      const double xlp = a.x_lp[ex];
      for (int ey = ye0; ey < ye1; ++ey) {
        load(a, xs, a.y_src[ey], sc);
        imm = lse2(imm, add(add(lse2(lse2(lse2(lse2(add(sc[IMM], t.imm_imm),
                                                    add(sc[IMD], t.imd_imm)),
                                               add(sc[IDM], t.idm_imm)),
                                          add(sc[IMI], t.imi_imm)),
                                     add(sc[IIW], t.iiw_imm)),
                                xlp),
                            a.y_lp[ey]));
      }
    }
    imm = add(imm, ab);
  } else if (ynull && (xf & kXEos)) {
    for (int e = ye0; e < ye1; ++e) {
      load(a, i, a.y_src[e], sc);
      imm = lse2(imm, add(sc[IMM], a.y_lp[e]));
    }
  } else if (xnull) {
    double acc = -INFINITY;
    if (y_ready) {
      for (int e = xe0; e < xe1; ++e) {
        load(a, a.x_src[e], j, sc);
        acc = lse2(acc, add(sc[IMM], a.x_lp[e]));
      }
    }
    imm = acc;
  }
  out[IMM] = origin ? 0.0 : imm;
  out[IMD] = imd;
  out[IDM] = idm;
  out[IMI] = imi;
  out[IIW] = iiw;
}

__global__ void __launch_bounds__(256) dagfill_kernel(Args a, unsigned* arrivals) {
  const int X = a.sx - 1;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t q = first; q < static_cast<int64_t>(a.n) * kStates; q += stride)
    a.cells[q] = -INFINITY;
  step_sync(arrivals, 0);
  double out[kStates];
  for (int w = 0; w < a.W; ++w) {
    const int end = a.wave[w + 1];
    for (int t = a.wave[w] + first; t < end; t += stride) {
      const int2 c = a.plan[t];
      fwd_cell(a, c.x, c.y, a.absorb[t], out);
      const int kind = kind_of(c.x, c.y, a.diag[c.x + c.y], X, a.sy - 1);
      double* dst =
          a.cells + static_cast<int64_t>(pos_of(kind, c.x, c.y, a.rowpos, a.off, a.off[X])) *
                        kStates;
#pragma unroll
      for (int s = 0; s < kStates; ++s) dst[s] = out[s];
    }
    step_sync(arrivals, w + 1);
  }
}

// The dependency floor's step: one thread computes `steps` cells in a
// chain, each an emitting cell with one x, one y and one xy in-edge, all
// three the cell before it, and writes the last.
__global__ void dagfill_chain(const Trans* __restrict__ t, int steps, double* out) {
  double c[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) c[s] = -1.0 - 0.1 * s;
  for (int k = 0; k < steps; ++k) {
    const double imd = add(lse2(lse2(lse2(add(c[IMM], t->imm_imd), add(c[IMD], t->imd_imd)),
                                     add(c[IDM], t->idm_imd)), add(c[IMI], t->imi_imd)), -0.1);
    const double iiw = add(lse2(lse2(add(c[IMM], t->imm_iiw), add(c[IMI], t->imi_iiw)),
                                add(c[IIW], t->iiw_iiw)), -0.1);
    const double idm = add(lse2(lse2(lse2(add(c[IMM], t->imm_idm), add(c[IMD], t->imd_idm)),
                                     add(c[IDM], t->idm_idm)), add(c[IIW], t->iiw_idm)), -0.1);
    const double imi = add(lse2(add(c[IMM], t->imm_imi), add(c[IMI], t->imi_imi)), -0.1);
    const double imm = add(add(lse2(lse2(lse2(lse2(add(c[IMM], t->imm_imm),
                                                   add(c[IMD], t->imd_imm)),
                                              add(c[IDM], t->idm_imm)),
                                         add(c[IMI], t->imi_imm)),
                                    add(c[IIW], t->iiw_imm)), -0.2), -3.0);
    // one lse2 more each, the accumulator's; keep the values in range
    c[IMM] = lse2(-INFINITY, imm) + 3.0;
    c[IMD] = lse2(-INFINITY, imd) + 1.0;
    c[IDM] = lse2(-INFINITY, idm) + 1.0;
    c[IMI] = lse2(-INFINITY, imi) + 1.0;
    c[IIW] = lse2(-INFINITY, iiw) + 1.0;
  }
#pragma unroll
  for (int s = 0; s < kStates; ++s) out[s] = c[s];
}

}  // namespace

// Blocks of `threads` threads that can be resident at once on this card
// (a wide fill's cooperative launch takes at most this many).
extern "C" int dagfill_capacity_f64(int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dagfill_kernel, threads, 0))
    return 0;
  return sms * per_sm;
}

// The band's cells [n, 5] (IMM IMD IDM IMI IIW; `cells`) of a grid of
// sx x sy cells (x states 0..sx-1, y states 0..sy-1, END excluded) from
// the plan's in-envelope cells `plan` [N, 2] (i, j) sorted by wavefront,
// `wave` [W + 1] where each wavefront starts, their absorb values [N]; the
// in-edge CSRs (ptr [s + 1], src, lp) of x and y; the state flags
// (ops/dagforward.py X_*, Y_*); insx, rootsubx [sx], insy, rootsuby [sy];
// the 18 transitions in fill.cpp's Trans order; the band layout's rowpos
// [sx], off [sx + 1] and diag [sx + sy - 1, 2] (ops/branchdp.py
// `band_layout`), all on the device.  `blocks` blocks of `threads`
// threads (a multiple of 32, at most 256); more than one block is a
// cooperative launch, and `arrivals` [1] must then be zero.  Returns the
// launch's error.
extern "C" int dagfill_f64(const int* plan, const int* wave, const double* absorb,
                           const int* x_ptr, const int* x_src, const double* x_lp,
                           const int* y_ptr, const int* y_src, const double* y_lp,
                           const uint8_t* x_flags, const uint8_t* y_flags, const double* insx,
                           const double* rootsubx, const double* insy, const double* rootsuby,
                           const double* trans18, const int* rowpos, const int* off,
                           const int* diag, double* cells, unsigned* arrivals, int n, int W,
                           int sx, int sy, int blocks, int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads < 32 || threads > 256 || threads % 32 || blocks < 1)
    return int(cudaErrorInvalidValue);
  Args a{reinterpret_cast<const int2*>(plan), wave, absorb, x_ptr, x_src, x_lp, y_ptr, y_src,
         y_lp, x_flags, y_flags, insx, rootsubx, insy, rootsuby,
         reinterpret_cast<const Trans*>(trans18), rowpos, off,
         reinterpret_cast<const int2*>(diag), cells, n, W, sx, sy};
  if (blocks == 1) {
    dagfill_kernel<<<1, threads, 0, s>>>(a, arrivals);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&a, &arrivals};
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(dagfill_kernel),
                                                    dim3(blocks), dim3(threads), args, 0, s);
  return e ? static_cast<int>(e) : static_cast<int>(cudaGetLastError());
}

// `steps` dependent cells in one thread (the dependency floor's step;
// chip_smoke.py times it); trans18 as above, out [5].
extern "C" int dagfill_chain_f64(const double* trans18, int steps, double* out, void* stream) {
  dagfill_chain<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const Trans*>(trans18), steps, out);
  return static_cast<int>(cudaGetLastError());
}
