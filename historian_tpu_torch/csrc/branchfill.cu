// Branch fill (kernel (e)) on Hopper: the 3-state Match/Insert/Delete
// alignment of a parent position-weight matrix to a child PWM, Viterbi or
// Forward, in float64, within an envelope mask.
//
// Replaces historian_tpu/ops/branchdp.py::_branch_fill (branch_viterbi and
// branch_forward), an XLA scan over y columns with the Delete recursion as
// a segmented prefix scan.  This kernel keeps the host route's per-cell
// expressions instead (csrc/fill.cpp branch_fill, the JAX package's native
// fill), so that its Viterbi cells equal the host's bit for bit and a
// refine step takes the same traceback on either route:
//   m = red2(red2(p0 + mm, p1 + im), p2 + dm) + emit   p = cell (x-1, y-1)
//   i = red2(q0 + mi, q1 + ii) + ins[y]                 q = cell (x, y-1)
//   d = red2(d(x-1, y) + dd, red2(m(x-1, y) + md, i(x-1, y) + id))
// with the x = 0 and y = 0 forms of fill.cpp; a cell outside the mask is
// BNEG in all three states.  red2 is max (first operand on ties) for
// Viterbi and fill.cpp's lse2 for Forward.  Every sum is __dadd_rn, so
// nothing is contracted.
//
// The band.  The kernel reads and writes only the band (ops/branchdp.py
// `band_layout`): rows 0 and X whole, and on each row 0 < x < X its
// column 0, its hull [lo(x), hi(x)] (the in-mask interior columns, widened
// where needed so that lo and hi never fall as x grows) and its column Y,
// packed row after row.  The emission and the mask byte come in at the
// band's cells, and M, I, D go out there; a hull cell outside the mask is
// written BNEG, and a cell outside the band is BNEG by definition, as
// fill.cpp has it.  Per row, `rowpos[x]` + y is the packed position of a
// hull cell (of any cell of rows 0 and X), `off[x]` that of (x, 0) and
// `off[x + 1] - 1` that of (x, Y); per anti-diagonal x + y = k, `diag[k]`
// holds the first and the last hull row (xa > xb where none).  Since lo
// and hi never fall, a diagonal's hull rows are contiguous, and its cells
// are, in order of x: (0, k), (k - Y, Y), the hull rows xa..xb, (k, 0),
// (X, k - X), each where it lies on the grid.
//
// What bounds it on this card.  Bytes: 24 B a band cell written, 9 B a
// band cell read (~10 MB at a long6 branch, ~3 us at 3.35 TB/s).  But the
// recurrence allows parallel work only along an anti-diagonal, and a
// diagonal needs the two before it, so the floor is one chain of
// dependent steps a diagonal (`branchfill_chain` times one), some 12 000
// of them at a long6 branch.  The design shortens each diagonal's chain.
//
// Ring design (a diagonal of at most kRingMaxCells cells): two kernels.
// The plan (`branchfill_plan`, a thread per cell slot of each diagonal,
// all diagonals at once) writes a 32-byte record a cell, diagonal after
// diagonal: the cell's packed position, its emission, ins[y] and mask
// flag, and the ring slots of the cell and of its three neighbours.  The
// fill (`branchfill_ring`) is one block of one to eight warps a state
// group, a thread a cell of the diagonal: one group for Viterbi, three for
// Forward, each computing one of the cell's states, since Forward's red2
// (exp and log1p in float64) makes a cell's three chains long enough to be
// worth three warps' schedulers.  The cells of diagonals k - 1 and k - 2
// stay in shared memory, in a ring of three planes of row slots: row x of
// the hull in slot x mod R (R a power of two no smaller than any
// diagonal's hull rows), the four boundary lines in four slots of their
// own, and a guard slot that always holds BNEG, which a neighbour outside
// the band reads.  The records come in with cp.async kLead diagonals ahead
// of the wavefront, into a shared-memory stage, one commit group a
// diagonal.  So no device-memory load and no integer bookkeeping stands
// on the chain, which is: the barrier, a shared-memory read of (x - 1, y),
// the Delete step (an add and two red2), a shared-memory write.  The
// barrier is __syncwarp for one warp and a named barrier over the block's
// warps for more.  The band goes out to device memory, which the fill only
// writes.  A cell's step has no branch (selects only, down to Forward's
// log1p), so that a warp's lanes never split.
//
// Strip design (a diagonal wider than the ring's block: a full mask, a
// wide envelope): a pipeline of row strips over many SMs, as kernel (d)'s
// strip design (csrc/siblingfill.cu), with the handoff taken off the
// diagonals' chain.  Block b owns rows [b H, (b + 1) H) of the band, a
// thread a row and state group (one group for Viterbi, three for
// Forward, as the ring's), and walks the diagonals that cross its strip,
// keeping the strip's last two diagonals in shared memory (three planes
// of a slot a row, and slot 0 for the row above the strip).  Each row
// keeps its hull (band.cuh's positions, lo and hi from `off` and
// `rowpos`), so the band's cells are the ring's, bit for bit.  A row's
// packed position, mask byte, emission and ins[y] load three diagonals
// ahead, through L1, and nothing reads them before their diagonal: a
// warp's rows miss L1 on different diagonals, so a load read early would
// stall the warp on most diagonals.  The barrier a diagonal is a named
// barrier over the row threads and a publishing warp, which then stores
// the count of diagonals done in shared memory (st.release.cta), so that
// no row thread's release waits for its loads in flight.  The strip's
// last row puts its cell of each diagonal in an `out` ring in shared
// memory.  An io warp, on which no diagonal waits, carries the handoff:
// it sends the `out` ring's cells to the exchange buffer in device memory
// (a cell a column) and publishes a count with st.release.gpu, and it
// polls the strip above's count (ld.acquire.gpu) and copies that strip's
// last row into the `above` stage, up to `lead` diagonals ahead of the
// row threads, with a count at CTA scope that the first row alone reads.
// Each pass moves every diagonal that is ready, so its fences and L2
// round trips cost a pass, not a diagonal.  The strips
// run in step a handoff apart, and the fill takes about (X + Y) diagonals'
// time plus, at each strip boundary, the handoff's longest latency.  The
// launch is cooperative, so every strip's predecessor is resident; where
// strips outnumber the resident blocks, block b takes strips b, b + G, ...
// in order.  Every poll is bounded and ends in __trap().
//
// The wrapper chooses the design before the launch and counts each
// (ops/branchdp.py DESIGNS, `strip_plan`).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "band.cuh"
#include "sync.cuh"

namespace {

using namespace band;
using namespace hsync;

constexpr double kBNeg = -1e30;  // ops/branchdp.py NEG
constexpr double kLog2 = 0.693147180559945309417232121458176568;  // fill.cpp LOG2
constexpr int kRingMaxCells = 256;  // ops/branchdp.py RING_MAX_CELLS
constexpr int kRingMaxThreads = 3 * kRingMaxCells;  // three state groups (Forward)
constexpr int kLead = 12;           // diagonals the records come in ahead
constexpr int kStages = 16;         // the records' stage: a power of two > kLead
constexpr int kStripMaxRows = 256;  // ops/branchdp.py STRIP_MAX_ROWS
constexpr int kStripMaxLead = 254;  // STRIP_MAX_LEAD: the stage holds lead + 2 diagonals
constexpr long long kPollLimit = 1ll << 26;  // polls of a count before __trap()

struct Cell3 {
  double m, i, d;
};

// log1p(exp(t)) for -708 <= t <= 0 with no branch: w = exp(t) in (0, 1],
// log1p(w) = 2 atanh(s), s = w / (2 + w) <= 1/3, by its series in s^2 to
// 17 terms (the 18th is under 2^-56 of the sum), so that a warp's lanes
// do not split between a library log1p's paths.
__device__ __forceinline__ double log1p_exp(double t) {
  const double w = exp(t);
  const double s = __ddiv_rn(w, __dadd_rn(2.0, w));
  const double s2 = __dmul_rn(s, s);
  double p = 1.0 / 33;
#pragma unroll
  for (int k = 15; k >= 0; --k) p = __fma_rn(p, s2, 1.0 / (2 * k + 1));
  return __dmul_rn(__dadd_rn(s, s), p);
}

template <bool VIT>
__device__ __forceinline__ double red2(double a, double b) {
  if (VIT) return a > b ? a : b;
  // fill.cpp lse2, with selects for its branches so that a warp's lanes do
  // not diverge: a == b gives a + LOG2; d > 0, a + log1p(exp(-d)); d <= 0,
  // b + log1p(exp(d)); else (a NaN) a + b.  Below -708 (a BNEG beside a
  // number, often) log1p(exp(t)) is under 1e-307, which leaves the sum
  // unchanged, and exp is not called there, off its slow range.
  const double d = __dsub_rn(a, b);
  const bool up = d > 0;
  const double t = up ? -d : d;
  const double r = __dadd_rn(up ? a : b, t < -708.0 ? 0.0 : log1p_exp(fmax(t, -708.0)));
  return a == b ? __dadd_rn(a, kLog2) : (up || d <= 0) ? r : __dadd_rn(a, b);
}

__device__ __forceinline__ int slot_of(int kind, int x, int R) {
  return kind == kHull ? (x & (R - 1)) : R + kind - kRow0;
}

// fill.cpp's cell (x, y) from its neighbours p (x-1, y-1), q (x, y-1),
// u (x-1, y) (BNEG where they lie outside the band or the grid, and u
// BNEG where x = 0); x_in is x > 0, y_in is y > 0.  The three states'
// full forms are computed on every lane, in fill.cpp's order, and its
// special cases chosen by selects, so that the lanes of a warp do not
// diverge and the three chains interleave: where x = 0, fill.cpp's Delete
// base red2(BNEG + md, BNEG + id) and run BNEG are the full form on u =
// BNEG, and its Match is BNEG + emit.
template <bool VIT>
__device__ __forceinline__ double m_value(bool x_in, bool y_in, bool in_env, double e,
                                          const Cell3& p, const double* tr) {
  const double mr = red2<VIT>(red2<VIT>(__dadd_rn(p.m, tr[0]), __dadd_rn(p.i, tr[3])),
                              __dadd_rn(p.d, tr[6]));
  return !in_env ? kBNeg : !y_in ? (x_in ? kBNeg : 0.0) : __dadd_rn(x_in ? mr : kBNeg, e);
}

template <bool VIT>
__device__ __forceinline__ double i_value(bool y_in, bool in_env, double ins_y, const Cell3& q,
                                          const double* tr) {
  const double ir = __dadd_rn(red2<VIT>(__dadd_rn(q.m, tr[1]), __dadd_rn(q.i, tr[4])), ins_y);
  return (in_env && y_in) ? ir : kBNeg;
}

template <bool VIT>
__device__ __forceinline__ double d_value(bool in_env, const Cell3& u, const double* tr) {
  const double dr = red2<VIT>(__dadd_rn(u.d, tr[7]),
                              red2<VIT>(__dadd_rn(u.m, tr[2]), __dadd_rn(u.i, tr[5])));
  return in_env ? dr : kBNeg;
}

template <bool VIT>
__device__ __forceinline__ Cell3 cell_value(bool x_in, bool y_in, bool in_env, double e,
                                            double ins_y, const Cell3& p, const Cell3& q,
                                            const Cell3& u, const double* tr) {
  return Cell3{m_value<VIT>(x_in, y_in, in_env, e, p, tr), i_value<VIT>(y_in, in_env, ins_y, q, tr),
               d_value<VIT>(in_env, u, tr)};
}

__device__ __forceinline__ void store(double* cells, int pos, const Cell3& c) {
  double* o = cells + static_cast<int64_t>(pos) * 3;
  o[0] = c.m;
  o[1] = c.i;
  o[2] = c.d;
}

// The block's barrier: the warp's for one warp, else named barrier 1 over
// the block's threads.
__device__ __forceinline__ void block_sync(int threads) {
  if (threads == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
  }
}

// One cell of the ring design's plan (32 bytes).
struct __align__(16) Rec {
  double e;      // the emission at the cell
  double ins;    // ins[y]
  int pos;       // its packed position; -1: no cell in this slot
  unsigned short self, p, q, u;  // ring slots of the cell and of p, q, u
  int flags;     // 1: in the mask, 2: x > 0, 4: y > 0
};
static_assert(sizeof(Rec) == 32, "a plan record is two 16-byte copies");

// The ring's planes: slots [0, R) the hull's rows, R..R+3 the boundary
// lines, R + 4 the guard (BNEG); padded to 16 bytes.
__host__ __device__ size_t ring_bytes(int R) {
  return (sizeof(Cell3) * 3 * (R + 5) + 15) / 16 * 16;
}

size_t ring_smem_bytes(int lanes, int R) {
  return ring_bytes(R) + sizeof(Rec) * kStages * lanes;
}

__global__ void branchfill_plan(const double* __restrict__ emit, const uint8_t* __restrict__ mask,
                                const double* __restrict__ ins, const int* __restrict__ rowpos,
                                const int* __restrict__ off, const int2* __restrict__ diag,
                                Rec* __restrict__ plan, int sx, int sy, int T, int R) {
  const int X = sx - 1, Y = sy - 1, K = sx + sy - 1;
  const int64_t id = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (id >= static_cast<int64_t>(K) * T) return;
  const int k = static_cast<int>(id / T), t = static_cast<int>(id % T);
  const unsigned short guard = static_cast<unsigned short>(R + 4);
  Rec rec{0.0, 0.0, -1, guard, guard, guard, guard, 0};
  int x = 0;
  const int kind = cell_at(t, k, diag[k], X, Y, x);
  if (kind != kNone) {
    const int y = k - x;
    const int pos = pos_of(kind, x, y, rowpos, off, off[X]);
    rec.pos = pos;
    rec.e = emit[pos];
    rec.ins = ins[y];
    rec.flags = (mask[pos] != 0) | ((x > 0) << 1) | ((y > 0) << 2);
    rec.self = static_cast<unsigned short>(slot_of(kind, x, R));
    if (x >= 1 && y >= 1) {
      const int kp = kind_of(x - 1, y - 1, diag[k - 2], X, Y);
      if (kp != kNone) rec.p = static_cast<unsigned short>(slot_of(kp, x - 1, R));
    }
    if (y >= 1) {
      const int kq = kind_of(x, y - 1, diag[k - 1], X, Y);
      if (kq != kNone) rec.q = static_cast<unsigned short>(slot_of(kq, x, R));
    }
    if (x >= 1) {
      const int ku = kind_of(x - 1, y, diag[k - 1], X, Y);
      if (ku != kNone) rec.u = static_cast<unsigned short>(slot_of(ku, x - 1, R));
    }
  }
  plan[id] = rec;
}

// The fill: `lanes` threads a state group, one a cell slot of the
// diagonal.  Without SPLIT one group computes whole cells; with SPLIT
// (Forward, whose red2 is long) three groups split a cell's states, group
// g computing state g (M, I, D), so that the three chains run on three
// warps' schedulers, and group 0 brings the records in.
template <bool VIT, bool SPLIT>
__global__ void __launch_bounds__(kRingMaxThreads) branchfill_ring(
    const Rec* __restrict__ plan, const double* __restrict__ trans8, double* __restrict__ cells,
    int K, int R, int lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, t = threadIdx.x;
  const int g = SPLIT ? t / lanes : 0, c = t - g * lanes;  // state group, cell slot
  double tr[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) tr[j] = trans8[j];
  Cell3* ring = reinterpret_cast<Cell3*>(smem);  // [3][R + 5]
  Rec* stage = reinterpret_cast<Rec*>(smem + ring_bytes(R));  // [kStages][lanes]
  if (t < 3) ring[t * (R + 5) + R + 4] = Cell3{kBNeg, kBNeg, kBNeg};
  // diagonal d's records in, one commit group a diagonal
  auto fetch = [&](int d) {
    if (d < K) {
      const Rec* src = plan + static_cast<int64_t>(d) * lanes + c;
      Rec* dst = stage + (d & (kStages - 1)) * lanes + c;
      cp_async16(dst, src);
      cp_async16(reinterpret_cast<unsigned char*>(dst) + 16,
                 reinterpret_cast<const unsigned char*>(src) + 16);
    }
    cp_commit();
  };
  if (g == 0) {
    for (int d = 0; d < kLead; ++d) fetch(d);
    cp_wait<kLead - 1>();  // diagonal 0's records
  }
  block_sync(T);
  for (int k = 0; k < K; ++k) {
    if (g == 0) fetch(k + kLead);
    if (!SPLIT) cp_wait<kLead>();  // diagonal k's records, this thread's own
    const Rec rec = stage[(k & (kStages - 1)) * lanes + c];
    if (rec.pos >= 0) {
      const Cell3* r1 = ring + ((k + 2) % 3) * (R + 5);  // diagonal k - 1
      const Cell3* r2 = ring + ((k + 1) % 3) * (R + 5);  // diagonal k - 2
      Cell3* out = ring + (k % 3) * (R + 5) + rec.self;
      const bool x_in = rec.flags & 2, y_in = rec.flags & 4, in_env = rec.flags & 1;
      if (!SPLIT) {
        const Cell3 v = cell_value<VIT>(x_in, y_in, in_env, rec.e, rec.ins, r2[rec.p], r1[rec.q],
                                        r1[rec.u], tr);
        *out = v;
        store(cells, rec.pos, v);
      } else {
        const double v = g == 0 ? m_value<VIT>(x_in, y_in, in_env, rec.e, r2[rec.p], tr)
                         : g == 1 ? i_value<VIT>(y_in, in_env, rec.ins, r1[rec.q], tr)
                                  : d_value<VIT>(in_env, r1[rec.u], tr);
        (&out->m)[g] = v;
        cells[static_cast<int64_t>(rec.pos) * 3 + g] = v;
      }
    }
    // with SPLIT, group 0 waits for diagonal k + 1's records before the
    // barrier, which then shows them to the other groups
    if (SPLIT && g == 0) cp_wait<kLead - 1>();
    block_sync(T);
  }
}

// ----------------------------------------------------------- strip design
struct StripArgs {
  const double* emit;
  const uint8_t* mask;
  const double *ins, *trans8;
  const int *rowpos, *off;
  double* cells;
  double* exch;        // [strips][sy][3]: each strip's last row, by column
  unsigned* progress;  // [strips]: strip b's last row is published for diagonals < progress[b]
  int sx, sy, H, strips, lead;
};

// The slots of the stage and of the `out` ring: a power of two no smaller
// than lead + 2 (the two diagonals the first row reads, and the lead) nor
// than 64, so that one pass of the io warp may move many diagonals.
__host__ __device__ __forceinline__ int stage_slots(int lead) {
  int s = 64;
  while (s < lead + 2) s <<= 1;
  return s;
}

// The counts the row threads and the io warp share (shared memory).
struct StripCounts {
  int done;     // the row threads have finished the diagonals < done
  int in_prog;  // `above` holds the row above's diagonals < in_prog
  int sent;     // `out` is sent on for the diagonals < sent
};

size_t strip_smem_bytes(int H, int lead) {
  return sizeof(Cell3) * (3 * (H + 1) + 2 * stage_slots(lead)) + sizeof(StripCounts);
}

__device__ __forceinline__ int ld_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cta(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(smem_addr(p)), "r"(v) : "memory");
}

// Wait until the shared count *p reaches want; returns what it saw.
__device__ __forceinline__ int wait_count(const int* p, int want) {
  int v = ld_acquire_cta(p);
  for (long long n = 0; v < want; ++n) {
    if (n >= kPollLimit) __trap();
    v = ld_acquire_cta(p);
  }
  return v;
}

// Row x's band cell on diagonal k: its packed position, or -1 outside the
// band or the grid, its mask byte, its emission and ins[y] (each loaded
// only by the state group that reads it), as loaded: nothing reads them
// before the diagonal that uses them, so a load in flight stalls no one.
struct RowCell {
  int pos, mask;
  double e, ins;
};

// The strip design's fill: G = 1 (Viterbi, whole cells) or 3 (Forward,
// group g computing state g) groups of H row threads, then the publishing
// warp and the io warp.
template <bool VIT, bool SPLIT>
__global__ void __launch_bounds__(3 * kStripMaxRows + 64) branchfill_strip(StripArgs a) {
  constexpr int G = SPLIT ? 3 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, X = a.sx - 1, Y = a.sy - 1, S = stage_slots(a.lead);
  const int tid = threadIdx.x, rows_threads = G * H;
  const bool pub = tid >= rows_threads && tid < rows_threads + 32;
  const int g = tid / H, i = tid - g * H;  // a row thread's state group and row in the strip
  const int lane = tid & 31;
  Cell3* planes = reinterpret_cast<Cell3*>(smem);  // [3][H + 1]: slot s, row x0 + s - 1
  Cell3* above = planes + 3 * (H + 1);             // [S]: the row above, by diagonal
  Cell3* out = above + S;                          // [S]: the strip's last row, by diagonal
  StripCounts* cnt = reinterpret_cast<StripCounts*>(out + S);
  const Cell3 neg{kBNeg, kBNeg, kBNeg};
  double tr[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) tr[j] = a.trans8[j];
  const int offX = a.off[X];
  for (int b = blockIdx.x; b < a.strips; b += gridDim.x) {
    const int x0 = b * H, xl = min(x0 + H - 1, X), k0 = x0, k1 = xl + Y;
    const bool has_above = b > 0, has_below = b + 1 < a.strips;
    for (int u = tid; u < 3 * (H + 1) + 2 * S; u += blockDim.x) planes[u] = neg;
    if (tid == 0) {
      cnt->done = k0;
      cnt->in_prog = has_above ? k0 - 1 : INT_MAX;  // the top strip's row above is BNEG
      cnt->sent = has_below ? k0 : INT_MAX;
    }
    __syncthreads();
    if (pub) {
      for (int k = k0; k <= k1; ++k) {
        block_sync(rows_threads + 32);
        if (lane == 0) st_release_cta(&cnt->done, k + 1);
      }
    } else if (tid < rows_threads) {
      // this thread's row and its band
      const int x = x0 + i;
      const bool row = x <= xl;
      int o0 = 0, oY = 0, rp = 0, lo = 1, hi = 0;
      if (row) {
        o0 = a.off[x];
        oY = a.off[x + 1] - 1;
        rp = a.rowpos[x];
        lo = o0 + 1 - rp;
        hi = lo + (oY - o0 - (Y >= 1 ? 1 : 0)) - 1;
      }
      auto cell_of = [&](int k) -> RowCell {
        const int y = k - x;
        RowCell c{-1, 0, 0.0, 0.0};
        if (!row || y < 0 || y > Y) return c;
        const bool inner = x > 0 && x < X && y > 0 && y < Y;
        if (inner && (y < lo || y > hi)) return c;
        c.pos = x == 0 ? y : x == X ? offX + y : y == 0 ? o0 : y == Y ? oY : rp + y;
        c.mask = __ldg(a.mask + c.pos);
        if (!SPLIT || g == 0) c.e = __ldg(a.emit + c.pos);
        if (!SPLIT || g == 1) c.ins = __ldg(a.ins + y);
        return c;
      };
      const bool last = i == xl - x0 && has_below;
      int have = has_above ? k0 - 1 : INT_MAX, sent = has_below ? k0 : INT_MAX;
      // diagonal k from its cell `cur`
      auto diagonal = [&](int k, const RowCell& cur) {
        if (i == 0 && have < k) have = wait_count(&cnt->in_prog, k);
        const Cell3* p1 = planes + ((k + 2) % 3) * (H + 1);  // diagonal k - 1
        const Cell3* p2 = planes + ((k + 1) % 3) * (H + 1);  // diagonal k - 2
        Cell3* dst = planes + (k % 3) * (H + 1) + i + 1;
        const bool live = cur.pos >= 0, in_env = cur.mask != 0;
        const bool x_in = x > 0, y_in = k - x > 0;
        if (!SPLIT) {
          const Cell3 p = i == 0 ? above[(k - 2) & (S - 1)] : p2[i];
          const Cell3 u = i == 0 ? above[(k - 1) & (S - 1)] : p1[i];
          const Cell3 v = cell_value<VIT>(x_in, y_in, in_env, cur.e, cur.ins, p, p1[i + 1], u, tr);
          *dst = live ? v : neg;
          if (live) store(a.cells, cur.pos, v);
          if (last) {
            if (sent <= k - S) sent = wait_count(&cnt->sent, k - S + 1);
            out[k & (S - 1)] = live ? v : neg;
          }
        } else {
          double v;
          if (g == 0) {
            const Cell3 p = i == 0 ? above[(k - 2) & (S - 1)] : p2[i];
            v = m_value<VIT>(x_in, y_in, in_env, cur.e, p, tr);
          } else if (g == 1) {
            v = i_value<VIT>(y_in, in_env, cur.ins, p1[i + 1], tr);
          } else {
            const Cell3 u = i == 0 ? above[(k - 1) & (S - 1)] : p1[i];
            v = d_value<VIT>(in_env, u, tr);
          }
          (&dst->m)[g] = live ? v : kBNeg;
          if (live) a.cells[static_cast<int64_t>(cur.pos) * 3 + g] = v;
          if (last) {
            if (sent <= k - S) sent = wait_count(&cnt->sent, k - S + 1);
            (&out[k & (S - 1)].m)[g] = live ? v : kBNeg;
          }
        }
        block_sync(rows_threads + 32);
      };
      // four cells in registers, each loaded three diagonals before its use
      // and read only then: unrolled, so that no register move waits on a
      // load in flight
      RowCell c0 = cell_of(k0), c1 = cell_of(k0 + 1), c2 = cell_of(k0 + 2), c3;
      for (int k = k0; k <= k1; k += 4) {
        c3 = cell_of(k + 3);
        diagonal(k, c0);
        if (k + 1 > k1) break;
        c0 = cell_of(k + 4);
        diagonal(k + 1, c1);
        if (k + 2 > k1) break;
        c1 = cell_of(k + 5);
        diagonal(k + 2, c2);
        if (k + 3 > k1) break;
        c2 = cell_of(k + 6);
        diagonal(k + 3, c3);
      }
    } else {
      // the io warp: the row above in, the last row out, as the note says
      const int lastA = x0 - 1 + Y;  // the row above's last diagonal on the grid
      int got = k0 - 1, sent = k0, known = 0;
      bool in_open = has_above, out_open = has_below;
      long long idle = 0;
      while (in_open || out_open) {
        const int done = __reduce_min_sync(0xffffffffu, ld_acquire_cta(&cnt->done));
        bool moved = false;
        if (in_open) {
          int lim = min(k1, done + a.lead);  // stage the diagonals < lim
          if (got <= lastA && known <= got)
            known = static_cast<int>(__reduce_min_sync(
                0xffffffffu, ld_acquire_gpu(a.progress + b - 1)));
          if (got <= lastA && known <= lastA) lim = min(lim, known);
          const int n = lim - got;
          if (n > 0) {
            for (int t = lane; t < n; t += 32) {
              const int d = got + t, y = d - (x0 - 1);
              Cell3 v = neg;
              if (y <= Y) {
                const double* src = a.exch + (static_cast<int64_t>(b - 1) * a.sy + y) * 3;
                v = Cell3{__ldcg(src), __ldcg(src + 1), __ldcg(src + 2)};
              }
              above[d & (S - 1)] = v;
            }
            __syncwarp();
            got += n;
            if (lane == 0) st_release_cta(&cnt->in_prog, got);
            moved = true;
          }
          in_open = got < k1;
        }
        if (out_open) {
          const int n = done - sent;
          if (n > 0) {
            for (int t = lane; t < n; t += 32) {
              const int d = sent + t, y = d - xl;
              if (y >= 0 && y <= Y) {
                const Cell3 v = out[d & (S - 1)];
                double* dst = a.exch + (static_cast<int64_t>(b) * a.sy + y) * 3;
                __stcg(dst, v.m);
                __stcg(dst + 1, v.i);
                __stcg(dst + 2, v.d);
              }
            }
            __syncwarp();
            sent += n;
            if (lane == 0) {
              __threadfence();
              st_release_gpu(a.progress + b, static_cast<unsigned>(sent));
              st_release_cta(&cnt->sent, sent);
            }
            moved = true;
          }
          out_open = sent <= k1;
        }
        if (moved) {
          idle = 0;
        } else {
          if (++idle > kPollLimit) __trap();
          __nanosleep(32);
        }
      }
    }
    __syncthreads();
  }
}

// The shortest dependent step of the recurrence, for the dependency floor:
// one thread runs `steps` Delete steps in a chain, each waiting on the one
// before as d(x, y) waits on cell (x - 1, y) of the diagonal before (an
// add and red2 of two adds beside it, then red2 of the two), and writes
// the last so that nothing is dropped.
template <bool VIT>
__global__ void branchfill_chain(const double* __restrict__ trans8, int steps, double* out) {
  const double md = trans8[2], id = trans8[5], dd = trans8[7];
  double d = trans8[0];
  for (int s = 0; s < steps; ++s)
    d = red2<VIT>(__dadd_rn(d, dd), red2<VIT>(__dadd_rn(d, md), __dadd_rn(d, id)));
  *out = d;
}

}  // namespace

// The band's cells [n, 3] (M, I, D; `cells`) from the band's emission [n]
// and mask bytes [n], ins [sy], trans8 (mm mi md im ii id dm dd), the rows'
// `rowpos` [sx] and `off` [sx + 1] and the diagonals' (xa, xb)
// [sx + sy - 1], all on the device (ops/branchdp.py `band_layout`), for a
// grid of sx = X + 1 rows and sy = Y + 1 columns.  design 0 is the ring
// (`threads` a multiple of 32 no larger than kRingMaxCells and no fewer
// than any diagonal's cells; `ring_rows` a power of two no smaller than
// any diagonal's hull rows; `plan` scratch of (sx + sy - 1) * threads * 32
// bytes), design 1 the strips (`strip_rows` a multiple of 32 at most
// kStripMaxRows, `lead` 1 to kStripMaxLead, `blocks` at most
// branchfill_capacity_f64's; `exch` scratch of ceil(sx / strip_rows) * sy
// * 3 doubles, `progress` [ceil(sx / strip_rows)] zero).  Returns the
// launches' error.
extern "C" int branchfill_f64(const double* emit, const uint8_t* mask, const double* ins,
                              const double* trans8, const int* rowpos, const int* off,
                              const int* diag, double* cells, void* plan, double* exch,
                              unsigned* progress, int sx, int sy, int viterbi, int design,
                              int threads, int ring_rows, int strip_rows, int lead, int blocks,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int2* dg = reinterpret_cast<const int2*>(diag);
  if (design == 0) {
    if (threads < 32 || threads % 32 || threads > kRingMaxCells || ring_rows < 1 ||
        (ring_rows & (ring_rows - 1)) || !plan)
      return int(cudaErrorInvalidValue);
    const int K = sx + sy - 1;
    Rec* recs = static_cast<Rec*>(plan);
    const int64_t n = static_cast<int64_t>(K) * threads;
    branchfill_plan<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
        emit, mask, ins, rowpos, off, dg, recs, sx, sy, threads, ring_rows);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    const size_t bytes = ring_smem_bytes(threads, ring_rows);
    if (viterbi) {
      cudaFuncSetAttribute(branchfill_ring<true, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      branchfill_ring<true, false><<<1, threads, bytes, s>>>(recs, trans8, cells, K, ring_rows,
                                                             threads);
    } else {
      cudaFuncSetAttribute(branchfill_ring<false, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      branchfill_ring<false, true><<<1, 3 * threads, bytes, s>>>(recs, trans8, cells, K,
                                                                 ring_rows, threads);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (design != 1 || strip_rows < 32 || strip_rows % 32 || strip_rows > kStripMaxRows ||
      lead < 1 || lead > kStripMaxLead || blocks < 1 || !exch || !progress)
    return int(cudaErrorInvalidValue);
  StripArgs a{emit, mask, ins, trans8, rowpos, off, cells, exch, progress,
              sx, sy, strip_rows, (sx + strip_rows - 1) / strip_rows, lead};
  if (blocks > a.strips) return int(cudaErrorInvalidValue);
  const int nthreads = (viterbi ? 1 : 3) * strip_rows + 64;
  const size_t bytes = strip_smem_bytes(strip_rows, lead);
  void* kernel = viterbi ? reinterpret_cast<void*>(branchfill_strip<true, false>)
                         : reinterpret_cast<void*>(branchfill_strip<false, true>);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e) return static_cast<int>(e);
  void* args[] = {&a};
  e = blocks == 1 ? cudaLaunchKernel(kernel, dim3(1), dim3(nthreads), args, bytes, s)
                  : cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(nthreads), args,
                                                bytes, s);
  return e ? static_cast<int>(e) : static_cast<int>(cudaGetLastError());
}

// Blocks of the strip design (`strip_rows` rows, `lead`, Viterbi or
// Forward) that can be resident at once on this card: the most a launch
// takes.  0 where the query fails.
extern "C" int branchfill_capacity_f64(int strip_rows, int lead, int viterbi) {
  int dev = 0, sms = 0, per_sm = 0;
  const int nthreads = (viterbi ? 1 : 3) * strip_rows + 64;
  const size_t bytes = strip_smem_bytes(strip_rows, lead);
  void* kernel = viterbi ? reinterpret_cast<void*>(branchfill_strip<true, false>)
                         : reinterpret_cast<void*>(branchfill_strip<false, true>);
  if (cudaGetDevice(&dev) || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes)) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nthreads, bytes))
    return 0;
  return sms * per_sm;
}

// `steps` dependent Delete steps in one thread (the dependency floor's
// step; chip_smoke.py times it); out [1].
extern "C" int branchfill_chain_f64(const double* trans8, int steps, int viterbi, double* out,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (viterbi) {
    branchfill_chain<true><<<1, 1, 0, s>>>(trans8, steps, out);
  } else {
    branchfill_chain<false><<<1, 1, 0, s>>>(trans8, steps, out);
  }
  return static_cast<int>(cudaGetLastError());
}
