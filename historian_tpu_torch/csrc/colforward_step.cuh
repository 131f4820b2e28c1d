// The column fill shared by K1 (colforward.cu) and K2
// (colforward_fused.cu): the 5-state Forward recurrence of a chain-x x
// DAG-y merge, one y column after another, as a pipeline of lane strips.
//
// The recurrence is that of the Pallas kernels'
// historian_tpu/ops/pallas_colforward.py::_column_step.  The two kernels
// differ only in where a cell's match emission `absorb` and its band gate
// `mg` (0 inside the band, NEG outside) come from, so the body takes an
// Emission policy:
//   em.start(i0)          called once by every thread before the first
//                         column, i0 being the strip's first lane (the
//                         fill's barrier follows);
//   em.column(j)          called by every thread at the start of each
//                         column the strip computes (may __syncthreads());
//   em.cell(j, i, at, ..) the (absorb, mg) pair of live lane i, `at` being
//                         j * SX + i.
// NEG = -1e30 is the finite semiring zero; every max(., NEG) clamp of the
// TPU kernel is kept, and logaddexp never forms (-inf) - (-inf).
//
// What bounds it on this card: the columns form a sequential chain (column
// j gathers its y in-edge source columns, all earlier and final), and a
// column is a chain of ~20 dependent log-sum-exps a lane plus two scans
// along x.  One block over all SX lanes is held by one SM's instruction rate
// and its barriers.  Design against that bound:
// - the x lanes are cut into strips of NT lanes, one block a strip, one
//   lane a thread; every block walks all SY columns in order over its own
//   strip, so the strips run side by side on NT-lane columns: strip s
//   works on column j while strip s-1 is already on later columns;
// - two dependencies cross a strip boundary, both on strip s-1:
//   (a) the diagonal halo: IMM at the strip's first lane needs t5a at lane
//       i0-1, gathered from the planes at the in-edge source columns.
//       The block computes that one extra lane itself once strip s-1 has
//       published every column before j;
//   (b) the scan carry: IMD and IIW are affine scans along x,
//       u[i] = lse(a[i], u[i-1] + b[i]), that need u, pre-IMD and pre-IIW
//       at lane i0-1 of column j.  A decoupled look-back, as in a
//       single-pass chained scan: the block scans its strip with carry-in
//       NEG (lane 0 as (NEG, 0)), then waits for strip s-1's record of
//       column j, computes its true u at lane 0, c0, and fixes up every
//       lane as lse(u_local[i], c0 + W[i]), W being the clamped sum of b
//       over lanes 1..i that the scan already carries;
// - a block publishes its record (u and pre of its last lane) and its
//   plane rows, then a progress counter (the columns it has finished)
//   with __threadfence() and a release store; a reader acquires the
//   counter and reads another strip's data with ld.global.cg (L2), since
//   L1 is not coherent across SMs;
// - a strip with no band lane in column j (per `lanes`, see below) does no
//   work and waits for nothing there: its cells keep the NEG the wrapper
//   filled, and its carry-out is exactly NEG (every lane has a = b = NEG,
//   and lse(NEG, x + NEG) rounds to NEG in float32 and float64), so the
//   strip to its right takes NEG without waiting either.  It still
//   advances its counter, so (a) stays well defined;
// - every spin-wait is bounded and ends in __trap(): a lost dependency
//   faults at the next synchronize instead of hanging.  The wrapper
//   launches cooperatively, so all strips are resident or the launch
//   fails;
// - no look-back ring: the TPU kept the last 128 columns in VMEM (and so
//   bounded the in-edge distance and SX); here the output planes in device
//   memory, mostly L2-resident, are the look-back, so neither is bounded;
// - one lane a thread, so every plane read and write is coalesced; the
//   lane-(i-1) reads (shift1) are warp shuffles plus one shared word per
//   warp; the scans are the block scans of logspace.cuh.
//
// lanes [SY, 3] int32 (may be null: every lane): per column j the lanes
// [0, head) and [lo, hi), whose union holds every lane of column j inside
// the band.  Lanes outside it must have mg = NEG.
//
// Sync buffers, allocated and zeroed by the wrapper: progress [strips]
// int32 (columns finished), rec [strips, SY, 4] (u-IMD, u-IIW, pre-IMD,
// pre-IIW at the strip's last lane).

// Shards (the sequence-parallel fill, spcolforward.cu): the x lanes may
// also be cut into shards, each a run of whole strips with planes of its
// own (possibly on another card).  `Strips` places a block's strip in its
// shard; the `Exchange` policy carries the two dependencies across a
// shard boundary.  The last strip of a shard writes, for each column j,
// a record of its last lane into the right shard's exchange buffer
// [SY, 8]: the five cells (IMM, IMD, IDM, IMI, IIW) and pre-IMD,
// pre-IIW, then publishes a column counter; the right shard's first strip
// reads the halo's source cells and the carry from those records exactly
// where K1 reads the planes and `rec` of strip s-1, so the arithmetic,
// and the bits, are K1's for any cut.  With `sys` set (the buffer in
// another card's memory or in mapped host memory) the counter is
// published and acquired at system scope and the records are read with
// system-scope loads.  `NoExchange` (K1, K2) compiles none of it.

#pragma once

#include <cuda_runtime.h>

#include "logspace.cuh"

namespace colfill {

using namespace logspace;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

//: polls of a counter before a wait gives up (each poll is an L2 round
//: trip, so this is tens of seconds, far beyond any fill)
constexpr long long kMaxPolls = 1LL << 26;

// Wait until *p >= want; returns the value seen.  Traps when it never comes.
__device__ __forceinline__ int wait_at_least(const int* p, int want) {
  int v = ld_acquire(p);
  for (long long n = 0; v < want; ++n) {
    if (n >= kMaxPolls) __trap();
    if (n >= 32) __nanosleep(64);
    v = ld_acquire(p);
  }
  return v;
}

__device__ __forceinline__ int ld_acquire_sys(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(int* p, int v) {
  asm volatile("st.release.sys.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ float ld_sys(const float* p) {
  float v;
  asm volatile("ld.relaxed.sys.global.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ double ld_sys(const double* p) {
  double v;
  asm volatile("ld.relaxed.sys.global.f64 %0, [%1];" : "=d"(v) : "l"(p) : "memory");
  return v;
}

// wait_at_least at system scope (a counter another card publishes)
__device__ __forceinline__ int wait_at_least_sys(const int* p, int want) {
  int v = ld_acquire_sys(p);
  for (long long n = 0; v < want; ++n) {
    if (n >= kMaxPolls) __trap();
    if (n >= 32) __nanosleep(64);
    v = ld_acquire_sys(p);
  }
  return v;
}

// Where a block's strip lies: strip s of a shard of `nstrips` strips and
// W lanes (the row length of the shard's planes and x vectors), whose
// lane 0 is lane `lane0` of the whole grid.  K1 and K2: one shard, the
// grid.
struct Strips {
  int s, nstrips, lane0, W;
};

// K1, K2: no shard boundary.
struct NoExchange {
  static constexpr bool kOn = false;
};

// A shard's two boundaries: `in` [SY, 8] the records of the left shard's
// last lane and `in_cnt` its column counter (null in the first shard);
// `out` and `out_cnt` the right shard's (null in the last); `sys`: a
// boundary crosses cards (system scope).
template <typename T>
struct Exchange {
  static constexpr bool kOn = true;
  const T* in;
  const int* in_cnt;
  T* out;
  int* out_cnt;
  bool sys;
};

//: values a column's exchange record holds (7 used)
constexpr int kRecord = 8;

// Does the strip of lanes [a, b) hold a band lane of column j?
__device__ __forceinline__ bool strip_active(const int* __restrict__ lanes, int j, int a, int b) {
  if (lanes == nullptr) return true;
  const int head = __ldg(lanes + 3 * j), lo = __ldg(lanes + 3 * j + 1),
            hi = __ldg(lanes + 3 * j + 2);
  return a < head || (lo < hi && a < hi && lo < b);
}

template <typename T, int NT>
struct Smem {
  static constexpr int NW = NT / 32;
  T tr[23];
  T ex[3][2][NW];  // last lane of each warp: t5, pre-IMD, pre-IIW (by column parity)
  ScanSmem<T, NT> scan;
  T fix[2];        // c0 of the IMD and IIW scans
};

// The whole fill of one strip.  y_flags rows hold (null, ready, rootsub_y,
// ins_y, ...) with `fstride` values a row; xvec rows 0-3 are rootsub_x,
// ins_x, x_gate, x_eos (more rows may follow), g.W values a row.  Writes
// the strip's cells of the shard's planes [5, SY, g.W] in `out`; progress
// and rec are the shard's.  `lanes` and the start cell are in the grid's
// lanes.
template <typename T, int NT, typename Emission, typename Edge>
__device__ __forceinline__ void column_fill(
    const int* __restrict__ y_src, const T* __restrict__ y_lp,
    const T* __restrict__ y_flags, int fstride, const T* __restrict__ xvec,
    const T* __restrict__ trans, const int* __restrict__ lanes, int* progress, T* rec,
    T* out, int SY, const Strips g, int KY, Emission& em, const Edge& edge) {
  __shared__ Smem<T, NT> sm;
  const T neg = T(kNeg);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = g.s, nstrips = g.nstrips, SX = g.W;
  const int i0 = s * NT, i = i0 + tid;
  const int i_end = min(SX, i0 + NT);
  const int gi0 = g.lane0 + i0, gi_end = g.lane0 + i_end;  // in the grid's lanes
  const bool live = i < SX;
  // the left neighbour of strip s: strip s-1 of this shard, or the left
  // shard's last strip through the exchange
  bool from_edge = false, to_edge = false, sys = false;
  if constexpr (Edge::kOn) {
    from_edge = s == 0 && edge.in != nullptr;
    to_edge = s + 1 == nstrips && edge.out != nullptr;
    sys = edge.sys;
  }
  const bool has_left = s > 0 || from_edge;
  if (tid < 23) sm.tr[tid] = trans[tid];
  em.start(i0);
  __syncthreads();
  const T imm_imm = sm.tr[0], imm_imd = sm.tr[1], imm_idm = sm.tr[2],
          imm_imi = sm.tr[3], imm_iiw = sm.tr[4];
  const T imd_imm = sm.tr[6], imd_imd = sm.tr[7], imd_idm = sm.tr[8];
  const T idm_imm = sm.tr[10], idm_imd = sm.tr[11], idm_idm = sm.tr[12];
  const T imi_imm = sm.tr[14], imi_imd = sm.tr[15], imi_imi = sm.tr[16],
          imi_iiw = sm.tr[17];
  const T iiw_imm = sm.tr[19], iiw_idm = sm.tr[20], iiw_iiw = sm.tr[21];
  const size_t plane = size_t(SY) * SX;
  const T rsx = live ? xvec[i] : neg;
  const T isx = live ? xvec[SX + i] : neg;
  const T x_gate = live ? xvec[2 * SX + i] : neg;
  const T x_eos = live ? xvec[3 * SX + i] : neg;
  int seen = 0;  // thread 0: the largest progress of the left neighbour it has acquired

  for (int j = 0; j < SY; ++j) {
    if (!strip_active(lanes, j, gi0, gi_end)) {
      // no band lane: the cells keep the wrapper's NEG; publish the
      // progress on the way (every 16 columns and before active work)
      if (tid == 0 && (j + 1 == SY || (j & 15) == 15 || strip_active(lanes, j + 1, gi0, gi_end))) {
        st_release(progress + s, j + 1);
        if constexpr (Edge::kOn) {
          if (to_edge) {
            if (sys)
              st_release_sys(edge.out_cnt, j + 1);
            else
              st_release(edge.out_cnt, j + 1);
          }
        }
      }
      continue;
    }
    const bool left = has_left && strip_active(lanes, j, gi0 - NT, gi0);
    const int par = j & 1;
    em.column(j);
    const T* fl = y_flags + size_t(fstride) * j;
    const T rdy = fl[1], rsy = fl[2], isy = fl[3];
    const bool is_null = fl[0] > T(0.5);
    const T ygate = rdy > T(0.5) ? T(0) : neg;

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
    // (a) the halo: t5a at lane i0-1, from the left neighbour's finished
    // columns (strip s-1's planes, or the left shard's records)
    T halo = neg;
    if (tid == 0 && has_left) {
      if (!from_edge) {
        if (seen < j) seen = wait_at_least(progress + s - 1, j);
      } else if constexpr (Edge::kOn) {
        if (seen < j) seen = sys ? wait_at_least_sys(edge.in_cnt, j)
                                 : wait_at_least(edge.in_cnt, j);
      }
      for (int k = 0; k < KY; ++k) {
        const int src = y_src[j * KY + k];
        if (src >= j) continue;
        const T w = y_lp[j * KY + k];
        T s_imm, s_imd, s_idm, s_imi, s_iiw;
        if (!from_edge) {
          const T* c = out + size_t(src) * SX + (i0 - 1);
          s_imm = __ldcg(c);
          s_imd = __ldcg(c + plane);
          s_idm = __ldcg(c + 2 * plane);
          s_imi = __ldcg(c + 3 * plane);
          s_iiw = __ldcg(c + 4 * plane);
        } else if constexpr (Edge::kOn) {
          const T* c = edge.in + size_t(src) * kRecord;
          s_imm = sys ? ld_sys(c) : __ldcg(c);
          s_imd = sys ? ld_sys(c + 1) : __ldcg(c + 1);
          s_idm = sys ? ld_sys(c + 2) : __ldcg(c + 2);
          s_imi = sys ? ld_sys(c + 3) : __ldcg(c + 3);
          s_iiw = sys ? ld_sys(c + 4) : __ldcg(c + 4);
        }
        const T t5 = lse(lse(lse(s_imm + imm_imm, s_imd + imd_imm),
                             lse(s_idm + idm_imm, s_imi + imi_imm)),
                         s_iiw + iiw_imm);
        halo = lse(halo, cmax(t5 + w, neg));
      }
    }
    T t5p = prev_lane<T, NT>(t5a, sm.ex[0], par, 0, lane, warp, neg);
    if (tid == 0) t5p = halo;

    // ---- IMM, IDM, IMI (pointwise given the shifted gather) ----
    const size_t at = size_t(j) * SX + i;
    T absorb = neg, mg = neg;
    if (live) em.cell(j, i, at, absorb, mg);
    T imm, idm, imi;
    if (is_null) {
      imm = cmax(immn + x_eos, neg);
      idm = idmn;
      imi = imin;
    } else {
      imm = t5p + absorb;
      idm = cmax(idma + rsy + x_gate, neg);
      imi = cmax(imia + isy + x_gate, neg);
    }
    if (j == 0 && g.lane0 + i == 0) imm = cmax(imm, T(0));  // the start cell
    imm = cmax(imm + mg, neg);
    idm = cmax(idm + mg, neg);
    imi = cmax(imi + mg, neg);

    // ---- IMD / IIW: affine scans along x, carry-in NEG ----
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
      pa = warp > 0 ? sm.ex[1][par][warp - 1] : neg;
      pb = warp > 0 ? sm.ex[2][par][warp - 1] : neg;
    }
    T v1 = cmax(pa + rsx + ygate + mg, neg);
    T w1 = cmax(imd_imd + rsx + mg, neg);
    T v2 = cmax(pb + isx + ygate + mg, neg);
    T w2 = cmax(iiw_iiw + isx + mg, neg);
    const T b1 = w1, b2 = w2;
    if (tid == 0) w1 = w2 = T(0);  // lane 0 enters as (NEG, 0): W sums lanes 1..i
    block_affine_scan2<T, NT>(v1, w1, v2, w2, sm.scan, par, 0, tid, lane, warp, neg);

    // (b) the carry: the left neighbour's record of column j, then the
    // fix-up.  Without an active left neighbour the carry is exactly NEG
    // and the local scan is already the answer.
    if (left) {
      if (tid == 0) {
        T u1, u2, p1, p2;
        if (!from_edge) {
          if (seen < j + 1) seen = wait_at_least(progress + s - 1, j + 1);
          const T* r = rec + (size_t(s - 1) * SY + j) * 4;
          u1 = __ldcg(r);
          u2 = __ldcg(r + 1);
          p1 = __ldcg(r + 2);
          p2 = __ldcg(r + 3);
        } else if constexpr (Edge::kOn) {
          if (seen < j + 1) seen = sys ? wait_at_least_sys(edge.in_cnt, j + 1)
                                       : wait_at_least(edge.in_cnt, j + 1);
          const T* r = edge.in + size_t(j) * kRecord;
          u1 = sys ? ld_sys(r + 1) : __ldcg(r + 1);
          u2 = sys ? ld_sys(r + 4) : __ldcg(r + 4);
          p1 = sys ? ld_sys(r + 5) : __ldcg(r + 5);
          p2 = sys ? ld_sys(r + 6) : __ldcg(r + 6);
        }
        sm.fix[0] = lse(cmax(p1 + rsx + ygate + mg, neg), u1 + b1);
        sm.fix[1] = lse(cmax(p2 + isx + ygate + mg, neg), u2 + b2);
      }
      __syncthreads();
      const T c1 = sm.fix[0], c2 = sm.fix[1];
      v1 = tid == 0 ? c1 : lse(v1, c1 + w1);
      v2 = tid == 0 ? c2 : lse(v2, c2 + w2);
    }
    if (live) {
      out[at] = imm;
      out[plane + at] = v1;
      out[2 * plane + at] = idm;
      out[3 * plane + at] = imi;
      out[4 * plane + at] = v2;
    }
    if (tid == NT - 1 && s + 1 < nstrips) {
      T* r = rec + (size_t(s) * SY + j) * 4;
      r[0] = v1;
      r[1] = v2;
      r[2] = pre_imd;
      r[3] = pre_iiw;
    }
    if constexpr (Edge::kOn) {
      if (tid == NT - 1 && to_edge) {
        T* r = edge.out + size_t(j) * kRecord;
        r[0] = imm;
        r[1] = v1;
        r[2] = idm;
        r[3] = imi;
        r[4] = v2;
        r[5] = pre_imd;
        r[6] = pre_iiw;
      }
    }
    __syncthreads();  // column j is final for every later column of the strip
    if (tid == 0) {
      __threadfence();
      st_release(progress + s, j + 1);
      if constexpr (Edge::kOn) {
        if (to_edge) {
          if (sys) {
            __threadfence_system();
            st_release_sys(edge.out_cnt, j + 1);
          } else {
            st_release(edge.out_cnt, j + 1);
          }
        }
      }
    }
  }
}

// K1's and K2's fill: one shard, the whole grid of SX lanes, block b
// strip b.
template <typename T, int NT, typename Emission>
__device__ __forceinline__ void column_fill(
    const int* __restrict__ y_src, const T* __restrict__ y_lp,
    const T* __restrict__ y_flags, int fstride, const T* __restrict__ xvec,
    const T* __restrict__ trans, const int* __restrict__ lanes, int* progress, T* rec,
    T* out, int SY, int SX, int KY, Emission& em) {
  const Strips g{int(blockIdx.x), int(gridDim.x), 0, SX};
  column_fill<T, NT>(y_src, y_lp, y_flags, fstride, xvec, trans, lanes, progress, rec, out, SY,
                     g, KY, em, NoExchange{});
}

// K1's emission: the bridge's planes, one coalesced read each per cell.
template <typename T>
struct PlaneEmission {
  const T* __restrict__ absorb;
  const T* __restrict__ maskg;
  __device__ __forceinline__ void start(int) {}
  __device__ __forceinline__ void column(int) {}
  __device__ __forceinline__ void cell(int, int, size_t at, T& a, T& mg) {
    a = absorb[at];
    mg = maskg[at];
  }
};

// Blocks of column_fill<T, NT, ...> that can be resident at once on the
// current device, or -(CUDA error) when the query fails.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -int(e);
  }
  return per * sms;
}

// Cooperative launch of `strips` blocks: all resident at once, or the
// launch fails and returns its error.
template <typename Kernel>
int launch_strips(Kernel kernel, int strips, int threads, size_t smem, void** args,
                  cudaStream_t stream) {
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                                    dim3(strips), dim3(threads), args, smem,
                                                    stream);
  const cudaError_t last = cudaGetLastError();
  return int(e != cudaSuccess ? e : last);
}

}  // namespace colfill
