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
// exp and log1p round otherwise than the host's libm (and the absorb
// values, summed here in order of k, otherwise than the host's matrix
// product).
//
// Order.  Profile states are toposorted; with each state's level (1 + the
// largest level of its in-edges' sources; fill.cpp `in_levels`) a cell
// reads only cells of a smaller level_x[i] + level_y[j], its wavefront.
// The host sorts the in-envelope cells by wavefront (ops/dagforward.py
// `plan`).  The cells live in the band of each row's hull of the envelope
// (band.cuh, ops/branchdp.py `band_layout`); a source outside the band
// reads -inf, as the host grid holds there.
//
// The plan (`dagplan_count`, `dagplan_records`, one thread a cell).  It
// sets the band to -inf and maps each in-envelope band cell to its place
// in the plan, counts each cell's terms, and (after a prefix sum of the
// counts) writes a 64-byte record a cell (`Rec`) and a 32-byte entry a
// term (`Term`).  A term is one sum of fwd_cell's: one in-edge's IMD,
// IIW, IDM or IMI, one (x, y) pair's IMM, or a null state's pass-through;
// a cell's terms go state by state, each state's in CSR order.  A term
// names its source once and for all: its band position, "outside the
// band" (-inf), or its slot in the ring when the ring holds it; and its
// lp (and the y lp of an IMM term, added after the x lp, as fwd_cell
// does).  The record holds the cell's band position and ring slot, its
// first term, the end of each state's terms, and the value each state
// adds after its sum (absorb, rootsub, ins; the absorb computed here from
// the factors ex [S, C*A], ey [S, C*A] and their shifts).
//
// What bounds it on this card.  Bytes: 40 B a band cell written, the
// plan's 8 B an in-envelope cell and the per-state arrays read; some
// 0.005 ms at long12's first sampled-x merge.  The dependency floor is a
// wavefront's longest chain: with a cell's terms over lanes, the IMM
// term's four lse2 and its adds, and a state's fold where it has more
// than one term (`dagfill_chain_split`); one thread doing a whole cell,
// ~20 lse2 in a row, is the first design's floor (`dagfill_chain`).
//
// Design.  A lane group of kLanes lanes a cell.  Lane k computes the
// cell's terms k, k + kLanes, ... (each a chain of at most four lse2) and
// writes each to shared memory; lane s < 5 then folds state s's terms in
// CSR order with lse2 (its first term taken as it is: lse2(-inf, t) is
// t), adds the state's value with __dadd_rn and writes the state out.  A
// cell with more terms than lanes takes them in rounds of kLanes.  lse2 is
// written with selects (`lse2s`: the same exp, log1p and sums), so that
// lanes of a warp taking its two sides do not run both in turn.
//
// Ring design (the widest wavefront at most kRingMaxCells): one block of
// kLanes threads a cell of the widest wavefront.  The cells of the last
// kRingWaves wavefronts stay in shared memory (slot (w mod kRingWaves) *
// width + the cell's rank in wavefront w), with a guard slot of -inf; a
// term's source fewer than kRingWaves wavefronts back is read there (the
// plan says so), an older one from the band through L2.  Each wavefront's
// records and terms come in with cp.async kLead wavefronts ahead into a
// stage of kStages, one commit group a wavefront; one __syncthreads a
// wavefront.  The band is written for the readback and the older sources.
//
// Wide design (a wavefront wider than that): a cooperative launch of as
// many blocks of 256 threads as the widest wavefront needs (and the card
// holds), the same lane groups, records, terms and sources read from
// device memory (sources through L2: other SMs wrote them), and band.cuh's
// grid barrier a wavefront.

#include <cstdint>
#include <cuda_runtime.h>

#include "band.cuh"
#include "logspace.cuh"
#include "sync.cuh"

namespace {

using namespace band;
using namespace hsync;

enum { IMM, IMD, IDM, IMI, IIW };
constexpr int kStates = 5;
constexpr int kKinds = 2 * kStates;  // full forms 0-4, pass-throughs 5-9
constexpr uint8_t kXNull = 1, kXReady = 2, kXEos = 4;  // ops/dagforward.py X_*
constexpr uint8_t kYNull = 1, kYReady = 2;             // Y_*
constexpr int kOrigin = 32;                            // ORIGIN
constexpr int kLanes = 8;                              // LANES
constexpr int kRingWaves = 8;                          // RING_WAVES
constexpr int kRingMaxCells = 1024 / kLanes;           // RING_MAX_CELLS
constexpr int kWideThreads = 256;                      // WIDE_THREADS
constexpr int kLead = 3;    // wavefronts the records come in ahead
constexpr int kStages = 4;  // the records' stage: a power of two > kLead
constexpr int kStageTerms = 6;  // stage room for terms a cell of the widest wavefront
constexpr int kPlanThreads = 256;

// One cell of the plan (64 bytes; ops/dagforward.py REC_WORDS).
struct __align__(16) Rec {
  double add[kStates];  // the value state s adds after its sum (flag bit s)
  int pos;              // the cell's band position
  int slot;             // its ring slot; -1 in the wide design
  int t0;               // its first term
  unsigned e01, e23, e4f;  // ends of IMM|IMD, IDM|IMI (16 bits each), IIW | flags << 16
};
static_assert(sizeof(Rec) == 64, "a record is four 16-byte copies");

// One term (32 bytes; TERM_WORDS).
struct __align__(16) Term {
  double lpa, lpb;  // its lp; an IMM term's y lp (added after the x lp)
  int loc;          // the source: band position, -1 outside, -2 - r ring slot r
  int kind;         // state s: full form s, pass-through 5 + s
  int pad0, pad1;
};
static_assert(sizeof(Term) == 32, "a term is two 16-byte copies");

struct Cell5 {
  double v[kStates];
};

__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

// logspace.cuh's lse2 (fill.cpp's) with its two sides as selects: d > 0
// gives x + log1p(exp(-d)), d <= 0 y + log1p(exp(d)), so both are
// max + log1p(exp(-|d|)), computed once; x == y gives x + LOG2, a NaN x +
// y.  The same operations on the same operands: the same bits.
__device__ __forceinline__ double lse2s(double x, double y) {
  const double d = __dsub_rn(x, y);
  const bool up = d > 0;
  const double r = __dadd_rn(up ? x : y, log1p(exp(up ? -d : d)));
  return x == y ? __dadd_rn(x, logspace::kLog2) : (up || d <= 0) ? r : __dadd_rn(x, y);
}

// The terms' forms: for kind q, its sources' states and transitions in
// fwd_cell's order of the sum, and how many.
struct Forms {
  double tr[kKinds][kStates];
  int comp[kKinds][kStates];
  int n[kKinds];
};

// fill.cpp's Trans indices (ops/dagforward.py FULL_FORMS).
__device__ __forceinline__ void init_forms(Forms& f, const double* trans18, int t) {
  constexpr int comp[kStates][kStates] = {{IMM, IMD, IDM, IMI, IIW},
                                          {IMM, IMD, IDM, IMI, 0},
                                          {IMM, IMD, IDM, IIW, 0},
                                          {IMM, IMI, 0, 0, 0},
                                          {IMM, IMI, IIW, 0, 0}};
  constexpr int tri[kStates][kStates] = {{0, 5, 8, 11, 15},
                                         {1, 6, 9, 12, 0},
                                         {2, 7, 10, 16, 0},
                                         {3, 13, 0, 0, 0},
                                         {4, 14, 17, 0, 0}};
  constexpr int len[kStates] = {5, 4, 4, 2, 3};
  if (t < kKinds * kStates) {
    const int q = t / kStates, m = t % kStates;
    if (q < kStates) {
      f.comp[q][m] = comp[q][m];
      f.tr[q][m] = trans18[tri[q][m]];
      if (m == 0) f.n[q] = len[q];
    } else {
      f.comp[q][m] = q - kStates;
      f.tr[q][m] = 0.0;
      if (m == 0) f.n[q] = 1;
    }
  }
}

// A term's value from its source's cells `c` (a band cell, a ring slot or
// the guard's -inf): a full form's lse2 chain plus lpa (and lpb), or a
// pass-through's cell plus lpa.
__device__ __forceinline__ double term_value(const Forms& f, int kind, const double* c,
                                             bool global, double lpa, double lpb) {
  const int n = f.n[kind];
  double a[kStates];
#pragma unroll
  for (int m = 0; m < kStates; ++m)
    if (m < n) a[m] = global ? __ldcg(c + f.comp[kind][m]) : c[f.comp[kind][m]];
  double v = kind >= kStates ? a[0] : add(a[0], f.tr[kind][0]);
#pragma unroll
  for (int m = 1; m < kStates; ++m)
    if (m < n) v = lse2s(v, add(a[m], f.tr[kind][m]));
  v = add(v, lpa);
  return kind == IMM ? add(v, lpb) : v;
}

__device__ __forceinline__ int term_end(const Rec& r, int s) {
  switch (s) {
    case 0: return r.e01 & 0xffff;
    case 1: return r.e01 >> 16;
    case 2: return r.e23 & 0xffff;
    case 3: return r.e23 >> 16;
    default: return r.e4f & 0xffff;
  }
}

__device__ __forceinline__ int r_terms(const Rec& r) { return r.e4f & 0xffff; }

// A cell's states by its lane group: lane k computes terms k, k + kLanes,
// ... (`term_at(t)` gives term t, `source(term)` its cells and whether
// they are in device memory), lanes 0-4 fold their state's terms and
// return it in `out` (the state of lane k); `scratch` holds the group's
// kLanes terms of a round.
template <typename TermAt, typename Source>
__device__ __forceinline__ bool cell_state(const Forms& f, const Rec& rec, int k,
                                           unsigned gmask, double* scratch, TermAt term_at,
                                           Source source, double& out) {
  const int nt = r_terms(rec);
  const int first = k < kStates ? (k == 0 ? 0 : term_end(rec, k - 1)) : 0;
  const int last = k < kStates ? term_end(rec, k) : 0;
  double acc = -INFINITY;
  for (int base = 0; base < nt; base += kLanes) {
    const int t = base + k;
    if (t < nt) {
      const Term e = term_at(rec.t0 + t);
      bool global = false;
      const double* c = source(e.loc, global);
      scratch[k] = term_value(f, e.kind, c, global, e.lpa, e.lpb);
    }
    __syncwarp(gmask);
    const int lo = max(first, base), hi = min(last, base + kLanes);
    for (int u = lo; u < hi; ++u) {
      const double v = scratch[u - base];
      acc = u == first ? v : lse2s(acc, v);
    }
    if (base + kLanes < nt) __syncwarp(gmask);
  }
  if (k >= kStates) return false;
  const int flags = static_cast<int>(rec.e4f >> 16);
  if (flags >> k & 1) acc = add(acc, rec.add[k]);
  if (k == IMM && (flags & kOrigin)) acc = 0.0;
  out = acc;
  return true;
}

struct FillArgs {
  const Rec* recs;
  const Term* terms;
  const int4* spans;  // [W] first and end record, first and end term
  const double* trans18;
  double* cells;      // [n, 5], the band
  int W, width, stage_terms;
};

// The ring design's shared memory: the ring [kRingWaves * width + 1]
// (the last slot the guard), then the stage's records [kStages][width]
// and terms [kStages][stage_terms], its spans [kStages], the groups'
// scratch [width][kLanes] and the forms.
__host__ __device__ size_t ring_bytes(int width) {
  return (sizeof(Cell5) * (kRingWaves * width + 1) + 15) / 16 * 16;
}

__host__ __device__ size_t smem_bytes(int width, int stage_terms) {
  return ring_bytes(width) + kStages * (sizeof(Rec) * width + sizeof(Term) * stage_terms)
         + kStages * sizeof(int4) + sizeof(double) * width * kLanes + sizeof(Forms);
}

__global__ void __launch_bounds__(1024, 1) dagfill_ring(FillArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int q = tid / kLanes, k = tid % kLanes;
  const unsigned gmask = 0xffu << (tid & 31 & ~(kLanes - 1));
  const int width = a.width, ST = a.stage_terms;
  Cell5* ring = reinterpret_cast<Cell5*>(smem);
  unsigned char* p = smem + ring_bytes(width);
  Rec* srec = reinterpret_cast<Rec*>(p);
  p += kStages * sizeof(Rec) * width;
  Term* sterm = reinterpret_cast<Term*>(p);
  p += kStages * sizeof(Term) * ST;
  int4* sspan = reinterpret_cast<int4*>(p);
  p += kStages * sizeof(int4);
  double* scratch = reinterpret_cast<double*>(p) + q * kLanes;
  p += sizeof(double) * width * kLanes;
  Forms& f = *reinterpret_cast<Forms*>(p);
  for (int u = tid; u < kKinds * kStates; u += T) init_forms(f, a.trans18, u);
  const int guard = kRingWaves * width;
  if (tid < kStates) ring[guard].v[tid] = -INFINITY;

  // wavefront d's records and terms in (a commit group even past the end)
  auto fetch = [&](int d, int4 sp) {
    if (d < a.W) {
      const int st = d & (kStages - 1);
      const int nr = (sp.y - sp.x) * 4, nt = min(sp.w - sp.z, ST) * 2;
      const unsigned char* gr = reinterpret_cast<const unsigned char*>(a.recs + sp.x);
      unsigned char* dr = reinterpret_cast<unsigned char*>(srec + st * width);
      for (int c = tid; c < nr; c += T) cp_async16(dr + 16 * c, gr + 16 * c);
      const unsigned char* gt = reinterpret_cast<const unsigned char*>(a.terms + sp.z);
      unsigned char* dt = reinterpret_cast<unsigned char*>(sterm + st * ST);
      for (int c = tid; c < nt; c += T) cp_async16(dt + 16 * c, gt + 16 * c);
      if (tid == 0) sspan[st] = sp;
    }
    cp_commit();
  };
  int4 next = a.W > 0 ? __ldg(a.spans) : make_int4(0, 0, 0, 0);
  for (int d = 0; d < kLead; ++d) {
    const int4 sp = next;
    next = d + 1 < a.W ? __ldg(a.spans + d + 1) : make_int4(0, 0, 0, 0);
    fetch(d, sp);
  }
  cp_wait<kLead - 1>();
  __syncthreads();

  for (int w = 0; w < a.W; ++w) {
    {
      const int4 sp = next;
      next = w + kLead + 1 < a.W ? __ldg(a.spans + w + kLead + 1) : make_int4(0, 0, 0, 0);
      fetch(w + kLead, sp);
    }
    const int st = w & (kStages - 1);
    const int4 sp = sspan[st];
    if (q < sp.y - sp.x) {
      const Rec& rec = srec[st * width + q];
      const Term* stage_t = sterm + st * ST;
      auto term_at = [&](int t) -> Term {
        const int r = t - sp.z;
        return r < ST ? stage_t[r] : a.terms[t];
      };
      auto source = [&](int loc, bool& global) -> const double* {
        if (loc >= 0) {
          global = true;
          return a.cells + static_cast<int64_t>(loc) * kStates;
        }
        return ring[loc == -1 ? guard : -2 - loc].v;
      };
      double v;
      if (cell_state(f, rec, k, gmask, scratch, term_at, source, v)) {
        ring[rec.slot].v[k] = v;
        a.cells[static_cast<int64_t>(rec.pos) * kStates + k] = v;
      }
    }
    cp_wait<kLead - 1>();  // wavefront w + 1's records, this thread's copies
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kWideThreads) dagfill_wide(FillArgs a, unsigned* arrivals) {
  __shared__ double scratch_all[kWideThreads];
  __shared__ double neg[kStates];  // a source outside the band
  __shared__ Forms f;
  const int tid = threadIdx.x;
  const int q = tid / kLanes, k = tid % kLanes;
  const unsigned gmask = 0xffu << (tid & 31 & ~(kLanes - 1));
  double* scratch = scratch_all + q * kLanes;
  for (int u = tid; u < kKinds * kStates; u += blockDim.x) init_forms(f, a.trans18, u);
  if (tid < kStates) neg[tid] = -INFINITY;
  __syncthreads();
  const int per_block = blockDim.x / kLanes, stride = gridDim.x * per_block;
  for (int w = 0; w < a.W; ++w) {
    const int4 sp = __ldg(a.spans + w);
    for (int c = blockIdx.x * per_block + q; c < sp.y - sp.x; c += stride) {
      const Rec& rec = a.recs[sp.x + c];
      auto term_at = [&](int t) -> Term { return a.terms[t]; };
      auto source = [&](int loc, bool& global) -> const double* {
        global = loc >= 0;
        return global ? a.cells + static_cast<int64_t>(loc) * kStates : neg;
      };
      double v;
      if (cell_state(f, rec, k, gmask, scratch, term_at, source, v))
        a.cells[static_cast<int64_t>(rec.pos) * kStates + k] = v;
    }
    step_sync(arrivals, w);
  }
}

// ---------------------------------------------------------------- the plan
struct PlanArgs {
  const int2* cells;  // [N] (i, j), by wavefront
  const int* wave;    // [W + 1]
  const int *x_ptr, *x_src;
  const double* x_lp;
  const int *y_ptr, *y_src;
  const double* y_lp;
  const uint8_t *x_flags, *y_flags;
  const double *insx, *rootsubx, *insy, *rootsuby;
  const double *ex, *shift_x, *ey, *shift_y;  // [sx, CA], [sx], [sy, CA], [sy]
  const int *rowpos, *off;
  const int2* diag;
};

__device__ __forceinline__ int band_pos(const PlanArgs& a, int x, int y, int X, int Y) {
  const int kind = kind_of(x, y, a.diag[x + y], X, Y);
  return kind == kNone ? -1 : pos_of(kind, x, y, a.rowpos, a.off, a.off[X]);
}

// The wavefront of plan cell t: the last w with wave[w] <= t.
__device__ __forceinline__ int wave_at(const int* wave, int W, int t) {
  int lo = 0, hi = W - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (wave[mid] <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// A cell's terms by state (IMM, IMD, IDM, IMI, IIW), as fwd_cell sums them.
__device__ __forceinline__ void term_counts(const PlanArgs& a, int i, int j, int (&n)[kStates]) {
  const uint8_t xf = a.x_flags[i], yf = a.y_flags[j];
  const bool xnull = xf & kXNull, xrdy = xf & kXReady, xeos = xf & kXEos;
  const bool ynull = yf & kYNull, yrdy = yf & kYReady;
  const int kx = a.x_ptr[i + 1] - a.x_ptr[i], ky = a.y_ptr[j + 1] - a.y_ptr[j];
  n[IMM] = (!xnull && !ynull) ? kx * ky : (ynull && xeos) ? ky : (xnull && yrdy) ? kx : 0;
  n[IMD] = n[IIW] = yrdy ? kx : 0;
  n[IDM] = n[IMI] = (ynull || xrdy) ? ky : 0;
}

// The band to -inf, the source map to -1 (grid-stride).
__global__ void dagplan_init(double* band, int* rank_of, int n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < n;
       p += stride) {
    rank_of[p] = -1;
#pragma unroll
    for (int s = 0; s < kStates; ++s) band[p * kStates + s] = -INFINITY;
  }
}

// Per cell: its wavefront, the source map at its band position, its terms.
__global__ void dagplan_count(PlanArgs a, int* rank_of, int* wave_of, int* counts, int N, int W,
                              int sx, int sy) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= N) return;
  const int2 c = a.cells[t];
  wave_of[t] = wave_at(a.wave, W, t);
  rank_of[band_pos(a, c.x, c.y, sx - 1, sy - 1)] = t;
  int n[kStates];
  term_counts(a, c.x, c.y, n);
  counts[t] = n[0] + n[1] + n[2] + n[3] + n[4];
}

// Per cell: its record, its terms and (the first cell of a wavefront) the
// wavefront's span; `incl` the inclusive prefix sum of the counts.
__global__ void dagplan_records(PlanArgs a, const int* rank_of, const int* wave_of,
                                const int* counts, const int* incl, Rec* recs, Term* terms,
                                int4* spans, int N, int W, int sx, int sy, int CA, int R,
                                int width, int ring) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= N) return;
  const int X = sx - 1, Y = sy - 1;
  const int2 c = a.cells[t];
  const int i = c.x, j = c.y, w = wave_of[t];
  const int t0 = incl[t] - counts[t];
  if (t == a.wave[w])
    spans[w] = int4{a.wave[w], a.wave[w + 1], t0, incl[a.wave[w + 1] - 1]};
  const uint8_t xf = a.x_flags[i], yf = a.y_flags[j];
  const bool xnull = xf & kXNull, xrdy = xf & kXReady, xeos = xf & kXEos;
  const bool ynull = yf & kYNull, yrdy = yf & kYReady;
  const bool full = !xnull && !ynull, pass_y = !full && ynull && xeos;
  const bool add_x = !xnull && yrdy, add_y = !ynull && xrdy;
  int n[kStates];
  term_counts(a, i, j, n);
  Rec rec;
  rec.add[IMM] = 0.0;
  if (full) {  // DPMatrix.absorb at (i, j): the products summed in order of k
    double s = 0.0;
    for (int q = 0; q < CA; ++q)
      s = __dadd_rn(s, __dmul_rn(a.ex[static_cast<int64_t>(i) * CA + q],
                                 a.ey[static_cast<int64_t>(j) * CA + q]));
    rec.add[IMM] = __dadd_rn(__dadd_rn(log(s), a.shift_x[i]), a.shift_y[j]);
  }
  rec.add[IMD] = add_x ? a.rootsubx[i] : 0.0;
  rec.add[IDM] = add_y ? a.rootsuby[j] : 0.0;
  rec.add[IMI] = add_y ? a.insy[j] : 0.0;
  rec.add[IIW] = add_x ? a.insx[i] : 0.0;
  rec.pos = band_pos(a, i, j, X, Y);
  const int rank = t - a.wave[w];
  rec.slot = ring ? (w % R) * width + rank : -1;
  rec.t0 = t0;
  const int e0 = n[0], e1 = e0 + n[1], e2 = e1 + n[2], e3 = e2 + n[3], e4 = e3 + n[4];
  const int flags = int(full) | int(add_x) << IMD | int(add_y) << IDM | int(add_y) << IMI
                    | int(add_x) << IIW | (i == 0 && j == 0 ? kOrigin : 0);
  rec.e01 = static_cast<unsigned>(e0) | static_cast<unsigned>(e1) << 16;
  rec.e23 = static_cast<unsigned>(e2) | static_cast<unsigned>(e3) << 16;
  rec.e4f = static_cast<unsigned>(e4) | static_cast<unsigned>(flags) << 16;
  recs[t] = rec;

  // a source's place: outside (-1), its ring slot (-2 - slot) or the band
  auto loc_of = [&](int x, int y) -> int {
    const int p = band_pos(a, x, y, X, Y);
    if (p < 0) return -1;
    const int r = rank_of[p];
    if (r < 0) return -1;
    if (ring) {
      const int ws = wave_of[r];
      if (w - ws < R) return -2 - ((ws % R) * width + r - a.wave[ws]);
    }
    return p;
  };
  auto put = [&](int at, int loc, int kind, double lpa, double lpb) {
    Term e;
    e.lpa = lpa;
    e.lpb = lpb;
    e.loc = loc;
    e.kind = kind;
    e.pad0 = e.pad1 = 0;
    terms[at] = e;
  };
  const int xe0 = a.x_ptr[i], ye0 = a.y_ptr[j];
  const int kx = a.x_ptr[i + 1] - xe0, ky = a.y_ptr[j + 1] - ye0;
  int at = t0;
  if (full) {
    for (int ex = 0; ex < kx; ++ex)
      for (int ey = 0; ey < ky; ++ey)
        put(at++, loc_of(a.x_src[xe0 + ex], a.y_src[ye0 + ey]), IMM, a.x_lp[xe0 + ex],
            a.y_lp[ye0 + ey]);
  } else if (pass_y) {
    for (int e = 0; e < n[IMM]; ++e)
      put(at++, loc_of(i, a.y_src[ye0 + e]), kStates + IMM, a.y_lp[ye0 + e], 0.0);
  } else {
    for (int e = 0; e < n[IMM]; ++e)
      put(at++, loc_of(a.x_src[xe0 + e], j), kStates + IMM, a.x_lp[xe0 + e], 0.0);
  }
  constexpr int rest[4] = {IMD, IDM, IMI, IIW};
  for (int u = 0; u < 4; ++u) {
    const int s = rest[u];
    const bool from_x = s == IMD || s == IIW;
    const int kind = (from_x ? xnull : ynull) ? kStates + s : s;
    for (int e = 0; e < n[s]; ++e) {
      if (from_x)
        put(at++, loc_of(a.x_src[xe0 + e], j), kind, a.x_lp[xe0 + e], 0.0);
      else
        put(at++, loc_of(i, a.y_src[ye0 + e]), kind, a.y_lp[ye0 + e], 0.0);
    }
  }
}

// ------------------------------------------------------- dependency floors
// The first design's floor step: one thread computes `steps` cells in a
// chain, each an emitting cell with one x, one y and one xy in-edge, all
// three the cell before it, and writes the last.
__global__ void dagfill_chain(const double* __restrict__ t, int steps, double* out) {
  using logspace::lse2;
  double c[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) c[s] = -1.0 - 0.1 * s;
  for (int k = 0; k < steps; ++k) {
    const double imd = add(lse2(lse2(lse2(add(c[IMM], t[1]), add(c[IMD], t[6])),
                                     add(c[IDM], t[9])), add(c[IMI], t[12])), -0.1);
    const double iiw = add(lse2(lse2(add(c[IMM], t[4]), add(c[IMI], t[14])),
                                add(c[IIW], t[17])), -0.1);
    const double idm = add(lse2(lse2(lse2(add(c[IMM], t[2]), add(c[IMD], t[7])),
                                     add(c[IDM], t[10])), add(c[IIW], t[16])), -0.1);
    const double imi = add(lse2(add(c[IMM], t[3]), add(c[IMI], t[13])), -0.1);
    const double imm = add(add(lse2(lse2(lse2(lse2(add(c[IMM], t[0]), add(c[IMD], t[5])),
                                              add(c[IDM], t[8])), add(c[IMI], t[11])),
                                    add(c[IIW], t[15])), -0.2), -3.0);
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

// This design's floor step: one lane group computes the same chain of
// cells as the fill does a cell, lane s < 5 state s's one term
// (`term_value`, its source the cell before in shared memory) and its
// value; so a step is the longest term, IMM's four lse2 and its adds, and
// the shared-memory round trip (a state of one term folds nothing).
__global__ void dagfill_chain_split(const double* __restrict__ t, int steps, double* out) {
  __shared__ Forms f;
  __shared__ double c[kStates];
  const int s = threadIdx.x;
  for (int u = s; u < kKinds * kStates; u += kLanes) init_forms(f, t, u);
  if (s < kStates) c[s] = -1.0 - 0.1 * s;
  __syncwarp(0xffu);
  for (int k = 0; k < steps; ++k) {
    double v = 0.0;
    if (s < kStates) v = add(term_value(f, s, c, false, -0.1, -0.1), s == IMM ? 3.0 : 1.0);
    __syncwarp(0xffu);
    if (s < kStates) c[s] = v;
    __syncwarp(0xffu);
  }
  if (s < kStates) out[s] = c[s];
}

}  // namespace

// Blocks of the wide design's `threads` threads that can be resident at
// once on this card (its cooperative launch takes at most this many).
extern "C" int dagfill_capacity_f64(int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dagfill_wide, threads, 0))
    return 0;
  return sms * per_sm;
}

// The plan's first half: the band `band` [n, 5] to -inf and the source map
// `rank_of` [n] to -1, then per cell of the plan `cells` [N, 2] (i, j)
// sorted by wavefront (`wave` [W + 1] where each starts) its wavefront
// `wave_of` [N], the map at its band position, its terms `counts` [N].
// The other inputs: the in-edge CSRs (ptr [s + 1], src, lp) of x and y;
// the state flags (ops/dagforward.py X_*, Y_*); insx, rootsubx [sx], insy,
// rootsuby [sy]; the absorb factors ex [sx, CA], shift_x [sx], ey [sy,
// CA], shift_y [sy]; the band layout's rowpos [sx], off [sx + 1] and diag
// [sx + sy - 1, 2] (ops/branchdp.py `band_layout`); all on the device.
extern "C" int dagplan_count_f64(const int* cells, const int* wave, const int* x_ptr,
                                 const int* x_src, const double* x_lp, const int* y_ptr,
                                 const int* y_src, const double* y_lp, const uint8_t* x_flags,
                                 const uint8_t* y_flags, const double* insx,
                                 const double* rootsubx, const double* insy,
                                 const double* rootsuby, const double* ex, const double* shift_x,
                                 const double* ey, const double* shift_y, const int* rowpos,
                                 const int* off, const int* diag, double* band, int* rank_of,
                                 int* wave_of, int* counts, int n, int N, int W, int sx, int sy,
                                 int CA, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  PlanArgs a{reinterpret_cast<const int2*>(cells), wave, x_ptr, x_src, x_lp, y_ptr, y_src, y_lp,
             x_flags, y_flags, insx, rootsubx, insy, rootsuby, ex, shift_x, ey, shift_y,
             rowpos, off, reinterpret_cast<const int2*>(diag)};
  (void)CA;
  if (n > 0) {
    const int64_t need = (static_cast<int64_t>(n) + kPlanThreads - 1) / kPlanThreads;
    const int blocks = static_cast<int>(need < 4096 ? need : 4096);
    dagplan_init<<<blocks, kPlanThreads, 0, s>>>(band, rank_of, n);
  }
  if (N > 0)
    dagplan_count<<<(N + kPlanThreads - 1) / kPlanThreads, kPlanThreads, 0, s>>>(
        a, rank_of, wave_of, counts, N, W, sx, sy);
  return static_cast<int>(cudaGetLastError());
}

// The plan's second half: per cell its record `recs` [N] (64 B), its
// terms `terms` [incl[N - 1]] (32 B each; `incl` the inclusive prefix sum
// of `counts`) and, the first cell of each wavefront, the wavefront's span
// `spans` [W] (first and end record, first and end term).  A source fewer
// than R wavefronts back gets its ring slot where `ring` is set (slots of
// `width` a wavefront).  The other inputs as dagplan_count_f64's.
extern "C" int dagplan_records_f64(const int* cells, const int* wave, const int* x_ptr,
                                   const int* x_src, const double* x_lp, const int* y_ptr,
                                   const int* y_src, const double* y_lp, const uint8_t* x_flags,
                                   const uint8_t* y_flags, const double* insx,
                                   const double* rootsubx, const double* insy,
                                   const double* rootsuby, const double* ex,
                                   const double* shift_x, const double* ey,
                                   const double* shift_y, const int* rowpos, const int* off,
                                   const int* diag, const int* rank_of, const int* wave_of,
                                   const int* counts, const int* incl, void* recs, void* terms,
                                   int* spans, int n, int N, int W, int sx, int sy, int CA,
                                   int R, int width, int ring, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  PlanArgs a{reinterpret_cast<const int2*>(cells), wave, x_ptr, x_src, x_lp, y_ptr, y_src, y_lp,
             x_flags, y_flags, insx, rootsubx, insy, rootsuby, ex, shift_x, ey, shift_y,
             rowpos, off, reinterpret_cast<const int2*>(diag)};
  (void)n;
  if (ring && (R != kRingWaves || width < 1)) return int(cudaErrorInvalidValue);
  if (N > 0)
    dagplan_records<<<(N + kPlanThreads - 1) / kPlanThreads, kPlanThreads, 0, s>>>(
        a, rank_of, wave_of, counts, incl, static_cast<Rec*>(recs), static_cast<Term*>(terms),
        reinterpret_cast<int4*>(spans), N, W, sx, sy, CA, R, width, ring);
  return static_cast<int>(cudaGetLastError());
}

// The band's cells [n, 5] (IMM IMD IDM IMI IIW; `cells`, set to -inf by
// the plan) from the plan's records, terms and spans [W] and the 18
// transitions in fill.cpp's Trans order, all on the device.  R =
// kRingWaves: the ring design, one block of `threads` (kLanes a cell of
// the widest wavefront, `width` cells, at most kRingMaxCells); R = 0: the
// wide design, `blocks` blocks of kWideThreads, more than one a
// cooperative launch (`arrivals` [1] zero).  Returns the launch's error.
extern "C" int dagfill_f64(const void* recs, const void* terms, const int* spans,
                           const double* trans18, double* cells, unsigned* arrivals, int W, int R,
                           int width, int blocks, int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  FillArgs a{static_cast<const Rec*>(recs), static_cast<const Term*>(terms),
             reinterpret_cast<const int4*>(spans), trans18, cells, W, width, 0};
  if (R == kRingWaves) {
    if (width < 1 || width > kRingMaxCells || threads < width * kLanes || threads > 1024 ||
        threads % 32 || blocks != 1)
      return int(cudaErrorInvalidValue);
    int dev = 0, limit = 0;
    if (cudaGetDevice(&dev) ||
        cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
      return int(cudaErrorInvalidValue);
    int st = kStageTerms * width;
    while (st > width && smem_bytes(width, st) > static_cast<size_t>(limit)) st -= width;
    a.stage_terms = st;
    const size_t bytes = smem_bytes(width, st);
    if (bytes > static_cast<size_t>(limit)) return int(cudaErrorInvalidValue);
    const cudaError_t e = cudaFuncSetAttribute(
        dagfill_ring, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e) return static_cast<int>(e);
    dagfill_ring<<<1, threads, bytes, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (R != 0 || threads != kWideThreads || blocks < 1) return int(cudaErrorInvalidValue);
  if (blocks == 1) {
    dagfill_wide<<<1, threads, 0, s>>>(a, arrivals);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&a, &arrivals};
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(dagfill_wide),
                                                    dim3(blocks), dim3(threads), args, 0, s);
  return e ? static_cast<int>(e) : static_cast<int>(cudaGetLastError());
}

// `steps` dependent cells (the dependency floors' steps; chip_smoke.py
// times them): split = 0, one thread a cell (the first design); split =
// 1, a lane group, a state a lane (this one).  trans18 as above, out [5].
extern "C" int dagfill_chain_f64(const double* trans18, int steps, int split, double* out,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split)
    dagfill_chain_split<<<1, kLanes, 0, s>>>(trans18, steps, out);
  else
    dagfill_chain<<<1, 1, 0, s>>>(trans18, steps, out);
  return static_cast<int>(cudaGetLastError());
}
