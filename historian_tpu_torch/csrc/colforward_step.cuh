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
// also be cut into shards, each a run of whole strips with planes of
// its own (possibly on another card).  `Strips` places a block's strip
// in its shard, and the `StripLink` policy carries the two dependencies
// from strip to strip in place of K1's progress counters, `rec` and
// plane reads: each strip block has an io warp beside its NT lanes, and
// the thread of the strip's last lane puts a record of each column it
// computes (the five cells IMM, IMD, IDM, IMI, IIW, pre-IMD, pre-IIW
// and its t5a, which is the right strip's halo) in its block's `out`
// ring; the io warp sends it on.  Within a thread block cluster of
// adjacent strips of a shard the io warp stores the records straight
// into the right block's `in` ring through distributed shared memory
// and publishes them with a cluster-scope release; across a cluster's
// end, a shard boundary (the [SY, 8] exchange record, at system scope
// where it crosses cards) or where the y DAG has in-edges older than
// the ring (kHalo columns), it writes them into a record in device
// memory and publishes a counter with one release a batch, and the
// right block's io warp copies them into its ring.  The compute threads
// touch only their block's shared memory at CTA scope on a column's
// path: the halo and the carry come from the `in` ring's record of the
// column (where the left strip has no band lane in it, the halo from
// its records of the in-edges' columns, one older than kHalo from the
// record in device memory), the strip's own last column from registers.
// The arithmetic and its order are K1's, so the cells are K1's bit for
// bit for any cut.  No barrier or fence joins the strips: the blocks of
// a card are one launch, checked to be resident at once, and a block
// waits on another cluster only to its left.  `NoExchange` (K1, K2)
// compiles none of it.

#pragma once

#include <cuda_runtime.h>

#include "logspace.cuh"
#include "pairstep.cuh"

namespace colfill {

using namespace logspace;

//: polls of a counter before a wait gives up (each poll is an L2 round
//: trip, so this is tens of seconds, far beyond any fill)
constexpr long long kMaxPolls = 1LL << 26;

// Wait until *p >= want; returns the value seen.  Traps when it never comes.
__device__ __forceinline__ int wait_at_least(const int* p, int want) {
  int v = hsync::ld_acquire_gpu(p);
  for (long long n = 0; v < want; ++n) {
    if (n >= kMaxPolls) __trap();
    if (n >= 32) __nanosleep(64);
    v = hsync::ld_acquire_gpu(p);
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
  static constexpr bool kIo = false;
};

//: values a column's record holds: the five cells, pre-IMD, pre-IIW and
//: the right strip's halo (the last lane's t5a)
constexpr int kRecord = 8;
//: columns of a strip edge's rings
constexpr int kRing = 32;
//: in-edges at most this many columns back are read from the `in` ring;
//: older ones from the record in device memory (kHalo < kRing: the left
//: strip runs at most kRing - kHalo columns ahead of the right)
constexpr int kHalo = 16;

// A (g1) strip block's edges in shared memory (StripLink, col_io).
template <typename T>
struct LinkSmem {
  T in[kRing][kRecord];   // the left strip's records, column c in slot c % kRing
  T out[kRing][kRecord];  // the strip's own, for the io warp
  int in_prog;            // columns of `in` final for the compute threads (CTA scope)
  int in_remote;          // columns the left block's io warp stored in `in` (cluster scope)
  int out_prog;           // columns the tail thread put in `out` (CTA scope)
  int out_sent;           // columns of `out` the io warp has sent on (CTA scope)
  int done;               // columns the compute threads have finished reading `in` for
  int right_ack;          // the right block's `done` (cluster scope)
};

// A column count c publishes every column < c in which the writer's strip
// is active (holds a band lane); the reader reads only such columns, and
// takes NEG, exactly what K1 reads there, for the others.
template <typename T>
__device__ __forceinline__ void link_init(LinkSmem<T>& ls) {
  if (threadIdx.x == 0) {
    ls.in_prog = ls.in_remote = ls.out_prog = ls.out_sent = ls.done = ls.right_ack = 0;
  }
}

// (g1): the strip's two edges through `ls` (see the note at the top);
// `in_rec`/`in_cnt`: the left edge's record in device memory [SY, 8] and
// its counter (null where the left strip is of the same cluster and no
// in-edge is older than kHalo).
template <typename T>
struct StripLink {
  static constexpr bool kIo = true;
  LinkSmem<T>* ls;
  const T* in_rec;
  const int* in_cnt;
  bool has_left, has_right, sys;
};

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
// and rec are K1's (unused under a StripLink).  `lanes` and the start
// cell are in the grid's lanes.  Under a StripLink only the NT compute
// threads call it (its barriers are named barriers of NT threads).
template <typename T, int NT, typename Emission, typename Edge>
__device__ __forceinline__ void column_fill(
    const int* __restrict__ y_src, const T* __restrict__ y_lp,
    const T* __restrict__ y_flags, int fstride, const T* __restrict__ xvec,
    const T* __restrict__ trans, const int* __restrict__ lanes, int* progress, T* rec,
    T* out, int SY, const Strips g, int KY, Emission& em, const Edge& edge) {
  using Bar = std::conditional_t<Edge::kIo, NamedBar<NT>, BlockBar>;
  __shared__ Smem<T, NT> sm;
  const T neg = T(kNeg);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = g.s, nstrips = g.nstrips, SX = g.W;
  const int i0 = s * NT, i = i0 + tid;
  const int i_end = min(SX, i0 + NT);
  const int gi0 = g.lane0 + i0, gi_end = g.lane0 + i_end;  // in the grid's lanes
  const bool live = i < SX;
  // the left neighbour of strip s: strip s-1 of this shard (K1), or the
  // link's left strip
  bool has_left = s > 0, has_right = false;
  if constexpr (Edge::kIo) {
    has_left = edge.has_left;
    has_right = edge.has_right;
  }
  if (tid < 23) sm.tr[tid] = trans[tid];
  em.start(i0);
  Bar{}();
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
  // StripLink: the lane's cells of the strip's last computed column, and
  // (the tail thread) the `out` count it last published
  int last_j = -1, published = 0;
  T own[5] = {neg, neg, neg, neg, neg};

  for (int j = 0; j < SY; ++j) {
    if (!strip_active(lanes, j, gi0, gi_end)) {
      // no band lane: the cells keep the wrapper's NEG; publish the
      // progress on the way (every 16 columns and before active work)
      if (tid == 0 && (j + 1 == SY || (j & 15) == 15 || strip_active(lanes, j + 1, gi0, gi_end))) {
        if constexpr (Edge::kIo) {
          pairstep::st_release_cta(&edge.ls->done, j + 1);
        } else {
          hsync::st_release_gpu(progress + s, j + 1);
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
        T s_imm, s_imd, s_idm, s_imi, s_iiw;
        if (Edge::kIo && src == last_j) {  // the strip's last column, kept on chip
          s_imm = own[0];
          s_imd = own[1];
          s_idm = own[2];
          s_imi = own[3];
          s_iiw = own[4];
        } else {
          const T* c = out + size_t(src) * SX + i;
          s_imm = c[0];
          s_imd = c[plane];
          s_idm = c[2 * plane];
          s_imi = c[3 * plane];
          s_iiw = c[4 * plane];
        }
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
    // columns (K1: strip s-1's planes).  StripLink: where the left strip
    // has a band lane in column j its last lane formed that t5a itself and
    // sent it in its record of column j, with the carry's four values;
    // elsewhere the halo comes from its records of the in-edges' columns.
    T halo = neg, cu1 = neg, cu2 = neg, cp1 = neg, cp2 = neg;
    if (tid == 0 && has_left) {
      if constexpr (Edge::kIo) {
        if (left) {
          pairstep::wait_at_least(&edge.ls->in_prog, j + 1);
          const T* r = edge.ls->in[j % kRing];
          pairstep::ld_slot(r + 1, cu1);
          pairstep::ld_slot(r + 4, cu2);
          pairstep::ld_slot(r + 5, cp1);
          pairstep::ld_slot(r + 6, cp2);
          pairstep::ld_slot(r + 7, halo);
        } else {
          for (int k = 0; k < KY; ++k) {
            const int src = y_src[j * KY + k];
            if (src >= j) continue;
            // a column in which the left strip has no band lane holds K1's
            // NEG there, whose term leaves the halo as it is
            if (!strip_active(lanes, src, gi0 - NT, gi0)) continue;
            const T w = y_lp[j * KY + k];
            T s_imm, s_imd, s_idm, s_imi, s_iiw;
            pairstep::wait_at_least(&edge.ls->in_prog, src + 1);
            if (j - src <= kHalo) {
              const T* r = edge.ls->in[src % kRing];
              pairstep::ld_slot(r, s_imm);
              pairstep::ld_slot(r + 1, s_imd);
              pairstep::ld_slot(r + 2, s_idm);
              pairstep::ld_slot(r + 3, s_imi);
              pairstep::ld_slot(r + 4, s_iiw);
            } else {  // older than the ring: the record in device memory
              pairstep::wait_global(edge.in_cnt, src + 1, edge.sys);
              const T* r = edge.in_rec + size_t(src) * kRecord;
              s_imm = pairstep::ld_shared_value(r, edge.sys);
              s_imd = pairstep::ld_shared_value(r + 1, edge.sys);
              s_idm = pairstep::ld_shared_value(r + 2, edge.sys);
              s_imi = pairstep::ld_shared_value(r + 3, edge.sys);
              s_iiw = pairstep::ld_shared_value(r + 4, edge.sys);
            }
            const T t5 = lse(lse(lse(s_imm + imm_imm, s_imd + imd_imm),
                                 lse(s_idm + idm_imm, s_imi + imi_imm)),
                             s_iiw + iiw_imm);
            halo = lse(halo, cmax(t5 + w, neg));
          }
        }
      } else {
        if (seen < j) seen = wait_at_least(progress + s - 1, j);
        for (int k = 0; k < KY; ++k) {
          const int src = y_src[j * KY + k];
          if (src >= j) continue;
          const T w = y_lp[j * KY + k];
          const T* c = out + size_t(src) * SX + (i0 - 1);
          const T s_imm = __ldcg(c);
          const T s_imd = __ldcg(c + plane);
          const T s_idm = __ldcg(c + 2 * plane);
          const T s_imi = __ldcg(c + 3 * plane);
          const T s_iiw = __ldcg(c + 4 * plane);
          const T t5 = lse(lse(lse(s_imm + imm_imm, s_imd + imd_imm),
                               lse(s_idm + idm_imm, s_imi + imi_imm)),
                           s_iiw + iiw_imm);
          halo = lse(halo, cmax(t5 + w, neg));
        }
      }
    }
    T t5p = prev_lane<T, NT, Bar>(t5a, sm.ex[0], par, 0, lane, warp, neg);
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
    Bar{}();
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
    block_affine_scan2<T, NT, Bar>(v1, w1, v2, w2, sm.scan, par, 0, tid, lane, warp, neg);

    // (b) the carry: the left neighbour's record of column j, then the
    // fix-up.  Without an active left neighbour the carry is exactly NEG
    // and the local scan is already the answer.
    if (left) {
      if (tid == 0) {
        T u1, u2, p1, p2;
        if constexpr (Edge::kIo) {  // read with the halo
          u1 = cu1;
          u2 = cu2;
          p1 = cp1;
          p2 = cp2;
        } else {
          if (seen < j + 1) seen = wait_at_least(progress + s - 1, j + 1);
          const T* r = rec + (size_t(s - 1) * SY + j) * 4;
          u1 = __ldcg(r);
          u2 = __ldcg(r + 1);
          p1 = __ldcg(r + 2);
          p2 = __ldcg(r + 3);
        }
        sm.fix[0] = lse(cmax(p1 + rsx + ygate + mg, neg), u1 + b1);
        sm.fix[1] = lse(cmax(p2 + isx + ygate + mg, neg), u2 + b2);
      }
      Bar{}();
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
    if constexpr (Edge::kIo) {
      // the `in` ring's column j is read: the io warp may refill it
      if (tid == 0) pairstep::st_release_cta(&edge.ls->done, j + 1);
      last_j = j;
      own[0] = imm;
      own[1] = v1;
      own[2] = idm;
      own[3] = imi;
      own[4] = v2;
      if (tid == NT - 1 && has_right) {  // the record of the strip's last lane
        LinkSmem<T>& ls = *edge.ls;
        // slot j % kRing last held a column <= j - kRing that was published
        // (columns with no band lane are not): the io warp has sent it
        const int sent = min(j - kRing + 1, published);
        if (sent > 0) pairstep::wait_at_least(&ls.out_sent, sent);
        T* r = ls.out[j % kRing];
        pairstep::st_slot(r, imm);
        pairstep::st_slot(r + 1, v1);
        pairstep::st_slot(r + 2, idm);
        pairstep::st_slot(r + 3, imi);
        pairstep::st_slot(r + 4, v2);
        pairstep::st_slot(r + 5, pre_imd);
        pairstep::st_slot(r + 6, pre_iiw);
        pairstep::st_slot(r + 7, t5a);  // the right strip's halo of column j
        pairstep::st_release_cta(&ls.out_prog, j + 1);
        published = j + 1;
      }
    } else {
      if (tid == NT - 1 && s + 1 < nstrips) {
        T* r = rec + (size_t(s) * SY + j) * 4;
        r[0] = v1;
        r[1] = v2;
        r[2] = pre_imd;
        r[3] = pre_iiw;
      }
      __syncthreads();  // column j is final for every later column of the strip
      if (tid == 0) {
        __threadfence();
        hsync::st_release_gpu(progress + s, j + 1);
      }
    }
  }
  if constexpr (Edge::kIo) {
    if (tid == NT - 1) pairstep::st_release_cta(&edge.ls->out_prog, SY);
    if (tid == 0) pairstep::st_release_cta(&edge.ls->done, SY);
  }
}

// (g1)'s io warp (all its lanes): moves the strip's records in and out
// as the note at the top says, for the strip of grid lanes [gi0, gi_end)
// whose left strip is [gi0 - NT, gi0).  Every count it polls is taken by
// each lane's own acquire, then the warp's least, so the lanes agree and
// each lane's reads are ordered after its acquire.
template <typename T, int NT>
__device__ void col_io(const pairstep::StripEntry& e, LinkSmem<T>& ls,
                       const int* __restrict__ lanes, int gi0, int gi_end, int SY) {
  using namespace pairstep;
  const int lane = threadIdx.x & 31;
  const bool sys = e.sys != 0;
  const unsigned rank = cluster_rank();
  const unsigned left_ack = e.left == kCluster ? remote_addr(&ls.right_ack, rank - 1) : 0u;
  const unsigned right_in = e.right == kCluster ? remote_addr(&ls.in[0][0], rank + 1) : 0u;
  const unsigned right_cnt = e.right == kCluster ? remote_addr(&ls.in_remote, rank + 1) : 0u;
  const T* in_rec = reinterpret_cast<const T*>(e.in_rec);
  const int* in_cnt = reinterpret_cast<const int*>(e.in_cnt);
  T* out_rec = reinterpret_cast<T*>(e.out_rec);
  int* out_cnt = reinterpret_cast<int*>(e.out_cnt);
  // got: columns handed to the compute threads; acked: their `done` told
  // to the left block; known: the left record's counter; sent: columns
  // sent on; taken: the right block's `done`
  int got = 0, acked = 0, known = 0, sent = 0, taken = 0;
  bool in_open = e.left != kNone, out_open = e.right != kNone;
  long long idle = 0;
  while (in_open || out_open) {
    bool moved = false;
    if (in_open) {
      const int done = __reduce_min_sync(kFull, ld_acquire_cta(&ls.done));
      if (e.left == kRecordEdge) {
        // column c may take ring slot c % kRing once column c - kRing is
        // older than every column the compute threads still read
        const int limit = min(done - kHalo + kRing, SY);
        if (got < limit && known <= got) {
          known = __reduce_min_sync(kFull, pairstep::ld_acquire(in_cnt, sys));
        }
        const int n = min(known, limit) - got;
        if (n > 0) {
          for (int v = lane; v < n * kRecord; v += 32) {
            const int c = got + v / kRecord, k = v % kRecord;
            if (strip_active(lanes, c, gi0 - NT, gi0)) {
              st_slot(&ls.in[c % kRing][k], ld_shared_value(in_rec + size_t(c) * kRecord + k, sys));
            }
          }
          __syncwarp();
          got += n;
          if (lane == 0) st_release_cta(&ls.in_prog, got);
          moved = true;
        }
        in_open = got < SY;
      } else {
        const int r = __reduce_min_sync(kFull, ld_acquire_cluster(&ls.in_remote));
        if (r > got) {
          got = r;
          if (lane == 0) st_release_cta(&ls.in_prog, got);
          moved = true;
        }
        if (done > acked) {
          acked = done;
          if (lane == 0) st_release_remote(left_ack, acked);
          moved = true;
        }
        in_open = acked < SY;
      }
    }
    if (out_open) {
      int end = __reduce_min_sync(kFull, ld_acquire_cta(&ls.out_prog));
      if (e.right == kCluster) {
        if (end > taken - kHalo + kRing) {
          taken = __reduce_min_sync(kFull, ld_acquire_cluster(&ls.right_ack));
        }
        end = min(end, taken - kHalo + kRing);
      }
      if (end > sent) {
        for (int v = lane; v < (end - sent) * kRecord; v += 32) {
          const int c = sent + v / kRecord, k = v % kRecord;
          if (strip_active(lanes, c, gi0, gi_end)) {
            T x;
            ld_slot(&ls.out[c % kRing][k], x);
            if (e.right == kCluster) {
              st_remote(right_in + unsigned(((c % kRing) * kRecord + k) * sizeof(T)), x);
            }
            if (out_rec != nullptr) out_rec[size_t(c) * kRecord + k] = x;
          }
        }
        __syncwarp();
        sent = end;
        if (lane == 0) {
          if (out_rec != nullptr) {
            if (sys) {
              __threadfence_system();
            } else {
              __threadfence();
            }
          }
          if (e.right == kCluster) st_release_remote(right_cnt, sent);
          if (out_rec != nullptr) pairstep::st_release(out_cnt, sent, sys);
          st_release_cta(&ls.out_sent, sent);
        }
        moved = true;
      }
      out_open = sent < SY;
    }
    if (moved) {
      idle = 0;
    } else {
      if (++idle >= kMaxPolls) __trap();
      __nanosleep(32);
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
