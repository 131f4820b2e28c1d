// The column fill shared by K1 (colforward.cu) and K2
// (colforward_fused.cu): the 5-state Forward recurrence of a chain-x x
// DAG-y merge, one y column after another, by one thread block.
//
// The recurrence is that of the Pallas kernels'
// historian_tpu/ops/pallas_colforward.py::_column_step.  The two kernels
// differ only in where a cell's match emission `absorb` and its band gate
// `mg` (0 inside the band, NEG outside) come from, so the body takes an
// Emission policy:
//   em.column(j)          called by every thread at the start of column j
//                         (may __syncthreads());
//   em.cell(j, i, at)     the (absorb, mg) pair of live lane i, `at` being
//                         j * SX + i.
// NEG = -1e30 is the finite semiring zero; every max(., NEG) clamp of the
// TPU kernel is kept, and logaddexp never forms (-inf) - (-inf).
//
// What bounds it on this card: the columns form a sequential chain (column
// j gathers its y in-edge source columns, all earlier and final), so the
// fill is latency-bound, not bandwidth- or FLOP-bound: one thread block on
// one SM walks the columns in order and its threads split the SX lanes.
// Design against that bound:
// - no look-back ring: the TPU kept the last 128 columns in VMEM (and so
//   bounded the in-edge distance and SX); here the output planes in device
//   memory, mostly L2-resident, are the look-back, so neither is bounded;
// - a column is swept in tiles of NT lanes, one lane per thread, so every
//   plane read and write is coalesced;
// - the lane-(i-1) reads of the recurrence (shift1) are warp shuffles plus
//   one shared-memory word per warp, carried across tiles;
// - IMD and IIW are inclusive affine log-sum-exp scans along x,
//   u[i] = lse(a[i], u[i-1] + b[i]): the block scan of logspace.cuh
//   (warp shuffles, then a scan of the warp totals, then the carry of
//   the previous tile), which the pair-Forward kernels share;
// - __syncthreads() at the end of a column makes its plane rows visible
//   to every later column of the block.

#pragma once

#include <cuda_runtime.h>

#include "logspace.cuh"

namespace colfill {

using namespace logspace;

template <typename T, int NT>
struct Smem {
  static constexpr int NW = NT / 32;
  T tr[23];
  T ex[3][2][NW];  // last lane of each warp: t5, pre-IMD, pre-IIW (by tile parity)
  ScanSmem<T, NT> scan;
};

// The whole fill.  y_flags rows hold (null, ready, rootsub_y, ins_y, ...)
// with `fstride` values a row; xvec rows 0-3 are rootsub_x, ins_x, x_gate,
// x_eos (more rows may follow).  Writes the planes [5, SY, SX] to `out`.
template <typename T, int NT, typename Emission>
__device__ __forceinline__ void column_fill(
    const int* __restrict__ y_src, const T* __restrict__ y_lp,
    const T* __restrict__ y_flags, int fstride, const T* __restrict__ xvec,
    const T* __restrict__ trans, T* out, int SY, int SX, int KY, Emission& em) {
  constexpr int NW = NT / 32;
  __shared__ Smem<T, NT> sm;
  const T neg = T(kNeg);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 23) sm.tr[tid] = trans[tid];
  __syncthreads();
  const T imm_imm = sm.tr[0], imm_imd = sm.tr[1], imm_idm = sm.tr[2],
          imm_imi = sm.tr[3], imm_iiw = sm.tr[4];
  const T imd_imm = sm.tr[6], imd_imd = sm.tr[7], imd_idm = sm.tr[8];
  const T idm_imm = sm.tr[10], idm_imd = sm.tr[11], idm_idm = sm.tr[12];
  const T imi_imm = sm.tr[14], imi_imd = sm.tr[15], imi_imi = sm.tr[16],
          imi_iiw = sm.tr[17];
  const T iiw_imm = sm.tr[19], iiw_idm = sm.tr[20], iiw_iiw = sm.tr[21];
  const size_t plane = size_t(SY) * SX;
  const int ntiles = (SX + NT - 1) / NT;

  for (int j = 0; j < SY; ++j) {
    em.column(j);
    const T* fl = y_flags + size_t(fstride) * j;
    const T rdy = fl[1], rsy = fl[2], isy = fl[3];
    const bool is_null = fl[0] > T(0.5);
    const T ygate = rdy > T(0.5) ? T(0) : neg;
    for (int t = 0; t < ntiles; ++t) {
      const int par = t & 1;
      const int i = t * NT + tid;
      const bool live = i < SX;

      // ---- gather + reduce over the y in-edges (all sources final) ----
      T t5a = neg, immn = neg, idma = neg, idmn = neg, imia = neg, imin = neg;
      if (live) {
        for (int k = 0; k < KY; ++k) {
          const int src = y_src[j * KY + k];
          if (src >= j) continue;  // toposort: a real in-edge comes from an earlier column
          const T w = y_lp[j * KY + k];
          const T* c = out + size_t(src) * SX + i;
          const T s_imm = c[0], s_imd = c[plane], s_idm = c[2 * plane],
                  s_imi = c[3 * plane], s_iiw = c[4 * plane];
          const T t5 = lse(lse(lse(s_imm + imm_imm, s_imd + imd_imm),
                               lse(s_idm + idm_imm, s_imi + imi_imm)),
                           s_iiw + iiw_imm);
          t5a = lse(t5a, cmax(t5 + w, neg));
          immn = lse(immn, cmax(s_imm + w, neg));
          const T kn_idm = lse(lse(s_imm + imm_idm, s_imd + imd_idm),
                               lse(s_idm + idm_idm, s_iiw + iiw_idm));
          idma = lse(idma, cmax(kn_idm + w, neg));
          idmn = lse(idmn, cmax(s_idm + w, neg));
          const T kn_imi = lse(s_imm + imm_imi, s_imi + imi_imi);
          imia = lse(imia, cmax(kn_imi + w, neg));
          imin = lse(imin, cmax(s_imi + w, neg));
        }
      }
      const T t5p = prev_lane<T, NT>(t5a, sm.ex[0], par, t, lane, warp, neg);

      // ---- IMM, IDM, IMI (pointwise given the shifted gather) ----
      const size_t at = size_t(j) * SX + i;
      T absorb = neg, mg = neg;
      if (live) em.cell(j, i, at, absorb, mg);
      const T rsx = live ? xvec[i] : neg;
      const T isx = live ? xvec[SX + i] : neg;
      T imm, idm, imi;
      if (is_null) {
        imm = cmax(immn + (live ? xvec[3 * SX + i] : neg), neg);
        idm = idmn;
        imi = imin;
      } else {
        const T x_gate = live ? xvec[2 * SX + i] : neg;
        imm = t5p + absorb;
        idm = cmax(idma + rsy + x_gate, neg);
        imi = cmax(imia + isy + x_gate, neg);
      }
      if (j == 0 && i == 0) imm = cmax(imm, T(0));  // the start cell
      imm = cmax(imm + mg, neg);
      idm = cmax(idm + mg, neg);
      imi = cmax(imi + mg, neg);

      // ---- IMD / IIW: affine scans along x ----
      const T pre_imd = lse(lse(imm + imm_imd, idm + idm_imd), imi + imi_imd);
      const T pre_iiw = lse(imm + imm_iiw, imi + imi_iiw);
      T pa = __shfl_up_sync(0xffffffffu, pre_imd, 1);
      T pb = __shfl_up_sync(0xffffffffu, pre_iiw, 1);
      if (lane == 31) {
        sm.ex[1][par][warp] = pre_imd;
        sm.ex[2][par][warp] = pre_iiw;
      }
      __syncthreads();
      if (lane == 0) {
        pa = warp > 0 ? sm.ex[1][par][warp - 1] : (t > 0 ? sm.ex[1][par ^ 1][NW - 1] : neg);
        pb = warp > 0 ? sm.ex[2][par][warp - 1] : (t > 0 ? sm.ex[2][par ^ 1][NW - 1] : neg);
      }
      T v1 = cmax(pa + rsx + ygate + mg, neg);
      T w1 = cmax(imd_imd + rsx + mg, neg);
      T v2 = cmax(pb + isx + ygate + mg, neg);
      T w2 = cmax(iiw_iiw + isx + mg, neg);
      block_affine_scan2<T, NT>(v1, w1, v2, w2, sm.scan, par, t, tid, lane, warp, neg);
      if (live) {
        out[at] = imm;
        out[plane + at] = v1;
        out[2 * plane + at] = idm;
        out[3 * plane + at] = imi;
        out[4 * plane + at] = v2;
      }
    }
    __syncthreads();  // column j is final for every later column
  }
}

}  // namespace colfill
