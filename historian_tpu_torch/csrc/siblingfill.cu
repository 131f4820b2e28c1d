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
// as fill.cpp's grid starts; a neighbour outside the band or the mask
// reads -inf, which gives every state fill.cpp's value for a skipped
// neighbour (lse2 with -inf is the identity, a -inf term adds nothing).
//
// The band.  The kernel reads and writes only the band (band.cuh, as
// ops/branchdp.py `band_layout` packs it from each row's hull of in-mask
// interior columns): the emission and the mask byte come in at the band's
// cells, the 11 states go out there.
//
// What bounds it on this card.  Bytes: 88 B a band cell written, 9 B read.
// The recurrence allows parallel work only along an anti-diagonal, and a
// cell of diagonal k needs diagonals k - 1 and k - 2, so the floor is one
// cell's chain of dependent steps a diagonal.
//
// A lane group of kLanes = 4 lanes a cell.  Given the three neighbours,
// seven states are independent: lane j computes one 4-term lse_list (IMM,
// IMD, IDM, or IIW with a -inf fourth term, which leaves its bits as they
// are) and one lse2 (IIX, IMI, IDI; none on lane 3) side by side.  Width-4
// shuffles then bring lane 0 IIW, IMI and IMM for WWW (fill.cpp's fixed
// order: IIW + t, lse2 with IMI + t, lse2 with IMM + t), lane 1 IIX and
// IMD for WWX, lane 2 IDI and IDM for WXW, and every lane those three for
// IDD, a 3-term lse_list, which lane 3 keeps.  So a cell's chain is one
// 4-term lse_list, two lse2 and one 3-term lse_list, against about twelve
// log-sum-exps in a row for one thread.  Every lane runs every step (lse2
// and lse_list in select form, `lse2g`, `lse_lists`: the same operations,
// so the same bits; exp skipped where its argument is below -708, see
// `exp_le0`), so a warp's lanes split only inside log1p; a lane group of
// 8 would issue the same instructions for half the cells.
//
// Ring design (the widest diagonal at most kRingMaxCells cells; a banded
// fill): two kernels.  The plan (`siblingplan`, a thread per cell slot of
// each diagonal, all diagonals at once) writes a 48-byte record a cell:
// its band position, its match emission, l_emit[x - 1], r_emit[y - 1],
// its mask and origin flags, and the ring slots of the cell and of its
// three neighbours, a guard slot (-inf) where a neighbour lies outside the
// band or the mask.  The fill (`siblingfill_ring`) is one block, a lane
// group a cell slot of the widest diagonal.  The cells of diagonals k - 1
// and k - 2 stay in shared memory, in three planes of row slots (row x of
// the hull in slot x mod R, the four boundary lines in four slots of their
// own, the guard).  The records come in with cp.async kLead diagonals
// ahead, one commit group a diagonal, and one barrier closes a diagonal
// (__syncwarp where the block is one warp).  So no device-memory load and
// no band arithmetic stands on the chain; the band goes out to device
// memory, which the fill only writes.
//
// Strip design (a wider diagonal: a full mask holds up to ~6000 cells a
// diagonal at long6): a pipeline of row strips in place of a grid barrier.
// Block b owns rows [b H, (b + 1) H), a lane group a row, and walks the
// diagonals that cross its strip, keeping the strip's last two diagonals
// in shared memory (a slot a row, and slot 0 for the row above the strip).
// Its last row's cell of each diagonal goes to an exchange buffer in
// device memory, and a publishing warp stores the count of diagonals done
// with st.release.gpu after each block barrier.  The block below reads
// that row through a fetching warp: ld.acquire.gpu on the counter (a
// bounded spin, then __trap()), the cell by cp.async kExLead diagonals
// ahead into a stage, and into slot 0 before the barrier that opens the
// diagonal which needs it.  So a strip runs kExLead + 1 diagonals behind
// the strip above, and no block waits on all the others.  A row's band
// position, mask byte and emissions for the next diagonal load while the
// current one computes.  The launch is cooperative, so every strip's
// predecessor is resident; where strips outnumber the resident blocks,
// block b takes strips b, b + G, ... in order.
//
// The wrapper chooses the design before the launch (ops/siblingdp.py
// DESIGNS).

#include <cstdint>
#include <cuda_runtime.h>

#include "band.cuh"
#include "logspace.cuh"
#include "sync.cuh"

namespace {

using namespace band;
using namespace hsync;
using logspace::lse2;

constexpr int kStates = 11;
enum { IMM, IMD, IDM, IDD, WWW, WWX, WXW, IMI, IIW, IDI, IIX, EEE };
constexpr int kLanes = 4;            // ops/siblingdp.py LANES
constexpr int kPitch = 12;           // doubles a cell slot (shared memory, exchange)
constexpr int kRingMaxCells = 128;   // RING_MAX_CELLS
constexpr int kRingMaxThreads = kLanes * kRingMaxCells;
constexpr int kLead = 3;             // diagonals the records come in ahead
constexpr int kStages = 4;           // the records' stage: a power of two > kLead
constexpr int kStripMaxRows = 64;    // STRIP_MAX_ROWS
constexpr int kCouriers = 64;        // a fetching and a publishing warp
constexpr int kStripMaxThreads = kLanes * kStripMaxRows + kCouriers;
constexpr int kExLead = 2;           // diagonals the row above comes in ahead
constexpr int kExStages = 4;         // its stage: a power of two >= kExLead
constexpr long long kSpinLimit = 1ll << 26;  // polls of the row above before __trap()
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

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

// exp(t) for t <= 0, -inf or NaN: exp itself from -708 up, 0 below it
// (and for -inf or NaN) without calling exp, whose slow path for those
// inputs would otherwise cost every lane of the warp.  Below -708 exp(t)
// is under 3.3e-308: added to a Neumaier sum of at least 1 it changes no
// bit of lse_list, and beside an lse2 operand it can change the bits only
// where that operand lies within ~1e-291 of zero.
__device__ __forceinline__ double exp_le0(double t) {
  const bool none = !(t >= -708.0);
  const double e = exp(none ? 0.0 : t);
  return none ? 0.0 : e;
}

// lse_list with its branches as selects: the same operations on the same
// operands where the largest term is finite (the same bits), -inf where
// it is not.
template <int N>
__device__ __forceinline__ double lse_lists(const double (&v)[N]) {
  double m = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k) m = v[k] > m ? v[k] : m;
  const bool none = m == -INFINITY;
  const double mm = none ? 0.0 : m;
  double s = 0.0, c = 0.0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const double x = exp_le0(__dsub_rn(v[k], mm));
    const double t = __dadd_rn(s, x);
    const double big = __dadd_rn(__dsub_rn(s, t), x), small = __dadd_rn(__dsub_rn(x, t), s);
    c = __dadd_rn(c, fabs(s) >= fabs(x) ? big : small);
    s = t;
  }
  return none ? -INFINITY : __dadd_rn(mm, log(__dadd_rn(s, c)));
}

// logspace.cuh's lse2s (fill.cpp's lse2 in select form), exp and log1p
// skipped as exp_le0 skips exp: where the smaller operand lies more than
// 708 below the larger (or either is -inf or NaN), the larger plus 0,
// with log1p given a dummy 1 so that its lane takes no special path.
__device__ __forceinline__ double lse2g(double x, double y) {
  const double d = __dsub_rn(x, y);
  const bool up = d > 0;
  const double t = up ? -d : d;
  const bool none = !(t >= -708.0);
  const double l = log1p(exp(none ? 0.0 : t));
  const double r = __dadd_rn(up ? x : y, none ? 0.0 : l);
  return x == y ? __dadd_rn(x, logspace::kLog2) : (up || d <= 0) ? r : __dadd_rn(x, y);
}

struct Trans {
  const double* t;  // [12 * 12], t[src * 12 + dest]
  __device__ __forceinline__ double operator()(int s, int d) const { return t[s * 12 + d]; }
};

// ------------------------------------------------ the first design's cell
// fill.cpp's sib_cell for an in-mask cell in one thread: `l` is (x - 1, y)
// or null where it is off the grid or outside the mask, `r` is (x, y - 1),
// `lr` (x - 1, y - 1), likewise; le = l_emit[x - 1], ren = r_emit[y - 1],
// me the match emission at (x, y).  Kept for the first design's
// dependency floor (`siblingfill_chain`).
__device__ __forceinline__ void sib_cell(double* dest, const double* l, const double* r,
                                         const double* lr, double le, double ren, double me,
                                         const Trans& T) {
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
  const double v[3] = {add(dest[WWW], T(WWW, IDD)), add(dest[WWX], T(WWX, IDD)),
                       add(dest[WXW], T(WXW, IDD))};
  dest[IDD] = lse_list(v);
}

// ------------------------------------------------------ the lane group
// Lane j's part of a cell, fixed for a whole fill.
struct Lane {
  int j;
  int cL[4], cP[2];     // the neighbour's states its lse_list and its lse2 read
  double tL[4], tP[2];  // and their transitions (-inf pads IIW's list, lane 3's lse2)
  int srcA, srcB;       // phase 2: the lanes whose values it takes
  bool aP, bP;          // ... their lse2 (else their lse_list)
  double tA, tB, tC, tD0, tD1, tD2, tOrigin;
  int sL, sP, sW;       // the states it writes (sW: WWW, WWX, WXW; lane 3 IDD)
};

__device__ __forceinline__ Lane make_lane(int j, const double* t144) {
  const Trans T{t144};
  Lane ln;
  ln.j = j;
  const int lst = j == 0 ? IMM : j == 1 ? IMD : j == 2 ? IDM : IIW;
  const int pst = j == 0 ? IIX : j == 1 ? IMI : IDI;
  if (j < 3) {
    ln.cL[0] = WWW, ln.cL[1] = WWX, ln.cL[2] = WXW, ln.cL[3] = IDD;
  } else {
    ln.cL[0] = IMM, ln.cL[1] = IMI, ln.cL[2] = IIW, ln.cL[3] = IMM;
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) ln.tL[m] = (j == 3 && m == 3) ? -INFINITY : T(ln.cL[m], lst);
  ln.cP[0] = j == 0 ? IMD : j == 1 ? IMM : IDM;
  ln.cP[1] = j == 0 ? IIX : j == 1 ? IMI : IDI;
  ln.tP[0] = j < 3 ? T(ln.cP[0], pst) : -INFINITY;
  ln.tP[1] = j < 3 ? T(ln.cP[1], pst) : -INFINITY;
  // phase 2: WWW from (lane 3's IIW, lane 1's IMI, lane 0's IMM), WWX from
  // (lane 0's IIX, lane 1's IMD), WXW from (lane 2's IDI, lane 2's IDM);
  // lane 3 repeats lane 0
  const int w = j == 1 ? WWX : j == 2 ? WXW : WWW;
  ln.srcA = j == 1 ? 0 : j == 2 ? 2 : 3;
  ln.srcB = j == 2 ? 2 : 1;
  ln.aP = j == 1 || j == 2;
  ln.bP = j == 0 || j == 3;
  ln.tA = T(j == 1 ? IIX : j == 2 ? IDI : IIW, w);
  ln.tB = T(j == 1 ? IMD : j == 2 ? IDM : IMI, w);
  ln.tC = T(IMM, WWW);
  ln.tD0 = T(WWW, IDD), ln.tD1 = T(WWX, IDD), ln.tD2 = T(WXW, IDD);
  ln.tOrigin = T(IMM, WWW);
  ln.sL = lst;
  ln.sP = pst;
  ln.sW = j < 3 ? w : IDD;
  return ln;
}

struct Out {
  double L, P, W;  // the lane's states sL, sP, sW
};

// Lane j's share of one cell: nL and nP point at the neighbours its
// lse_list and its lse2 read (slots of -inf where a neighbour is absent),
// eL and eP the emissions they add.  Every lane of the group's warp
// (`mask`) runs it together.
__device__ __forceinline__ Out sib_lanes(const Lane& ln, const double* nL, const double* nP,
                                         double eL, double eP, bool origin, unsigned mask) {
  double a[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) a[m] = add(nL[ln.cL[m]], ln.tL[m]);
  double L = add(eL, lse_lists(a));
  const double P = add(eP, lse2g(add(nP[ln.cP[0]], ln.tP[0]), add(nP[ln.cP[1]], ln.tP[1])));
  const double aL = __shfl_sync(mask, L, ln.srcA, kLanes);
  const double aP = __shfl_sync(mask, P, ln.srcA, kLanes);
  const double bL = __shfl_sync(mask, L, ln.srcB, kLanes);
  const double bP = __shfl_sync(mask, P, ln.srcB, kLanes);
  const double cL = __shfl_sync(mask, L, 0, kLanes);
  const double w1 = lse2g(add(ln.aP ? aP : aL, ln.tA), add(ln.bP ? bP : bL, ln.tB));
  const double w2 = lse2g(w1, add(cL, ln.tC));
  double W = ln.j == 0 ? (origin ? ln.tOrigin : w2) : w1;
  const double www = __shfl_sync(mask, W, 0, kLanes);
  const double wwx = __shfl_sync(mask, W, 1, kLanes);
  const double wxw = __shfl_sync(mask, W, 2, kLanes);
  const double d[3] = {add(www, ln.tD0), add(wwx, ln.tD1), add(wxw, ln.tD2)};
  const double idd = lse_lists(d);
  if (ln.j == 0 && origin) L = 0.0;
  if (ln.j == 3) W = idd;
  return Out{L, P, W};
}

// The lane's states to `dst` (a shared-memory slot, a band cell, an
// exchange cell): -inf in every state where the cell is outside the mask.
__device__ __forceinline__ void put(double* dst, const Lane& ln, const Out& o, bool in) {
  dst[ln.sL] = in ? o.L : -INFINITY;
  dst[ln.sW] = in ? o.W : -INFINITY;
  if (ln.j < 3) dst[ln.sP] = in ? o.P : -INFINITY;
}

// The block's barrier: the warp's for one warp, else the block's.
__device__ __forceinline__ void block_sync(int threads) {
  if (threads == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// lp_end from cell (X, Y), in fill.cpp's order.
__device__ __forceinline__ double lp_end_of(const double* c, const Trans& T) {
  const double v[4] = {add(c[IDD], T(IDD, EEE)), add(c[WWW], T(WWW, EEE)),
                       add(c[WWX], T(WWX, EEE)), add(c[WXW], T(WXW, EEE))};
  return lse_list(v);
}

// ------------------------------------------------------------ ring design
// One cell of the plan (48 bytes; ops/siblingdp.py REC_BYTES).
struct __align__(16) Rec {
  double me, le, ren;  // the match emission, l_emit[x - 1], r_emit[y - 1] (0 off the grid)
  int pos;             // the band position; -1: no cell in this slot
  unsigned short self, l, r, lr;  // ring slots of the cell, (x-1, y), (x, y-1), (x-1, y-1)
  int flags;           // 1: in the mask, 2: the origin
  int pad0, pad1;
};
static_assert(sizeof(Rec) == 48, "a plan record is three 16-byte copies");

__device__ __forceinline__ int slot_of(int kind, int x, int R) {
  return kind == kHull ? (x & (R - 1)) : R + kind - kRow0;
}

// The ring's planes: slots [0, R) the hull's rows, R..R+3 the boundary
// lines, R + 4 the guard (-inf); kPitch doubles a slot.
__host__ __device__ size_t ring_bytes(int R) { return sizeof(double) * kPitch * 3 * (R + 5); }

size_t ring_smem_bytes(int width, int R) { return ring_bytes(R) + sizeof(Rec) * kStages * width; }

__global__ void siblingplan(const double* __restrict__ emit, const uint8_t* __restrict__ mask,
                            const double* __restrict__ l_emit, const double* __restrict__ r_emit,
                            const int* __restrict__ rowpos, const int* __restrict__ off,
                            const int2* __restrict__ diag, Rec* __restrict__ plan, int sx, int sy,
                            int width, int R) {
  const int X = sx - 1, Y = sy - 1, K = sx + sy - 1;
  const int64_t id = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (id >= static_cast<int64_t>(K) * width) return;
  const int k = static_cast<int>(id / width), t = static_cast<int>(id % width);
  const int offX = off[X];
  const unsigned short guard = static_cast<unsigned short>(R + 4);
  Rec rec{0.0, 0.0, 0.0, -1, guard, guard, guard, guard, 0, 0, 0};
  // a neighbour's ring slot: the guard outside the band or the mask
  auto slot = [&](int x, int y, int2 r) -> unsigned short {
    const int kind = kind_of(x, y, r, X, Y);
    if (kind == kNone || !mask[pos_of(kind, x, y, rowpos, off, offX)]) return guard;
    return static_cast<unsigned short>(slot_of(kind, x, R));
  };
  int x = 0;
  const int kind = cell_at(t, k, diag[k], X, Y, x);
  if (kind != kNone) {
    const int y = k - x;
    const int pos = pos_of(kind, x, y, rowpos, off, offX);
    rec.pos = pos;
    rec.me = emit[pos];
    rec.le = x >= 1 ? l_emit[x - 1] : 0.0;
    rec.ren = y >= 1 ? r_emit[y - 1] : 0.0;
    rec.flags = (mask[pos] != 0) | (x == 0 && y == 0 ? 2 : 0);
    rec.self = static_cast<unsigned short>(slot_of(kind, x, R));
    if (x >= 1) rec.l = slot(x - 1, y, diag[k - 1]);
    if (y >= 1) rec.r = slot(x, y - 1, diag[k - 1]);
    if (x >= 1 && y >= 1) rec.lr = slot(x - 1, y - 1, diag[k - 2]);
  }
  plan[id] = rec;
}

// The fill: a lane group a cell slot of the diagonal (`width` slots).
__global__ void __launch_bounds__(kRingMaxThreads) siblingfill_ring(
    const Rec* __restrict__ plan, const double* __restrict__ t144, double* __restrict__ cells,
    double* __restrict__ lp_end, int K, int width, int R, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int threads = blockDim.x, tid = threadIdx.x;
  const int q = tid / kLanes, j = tid % kLanes;
  const int plane = (R + 5) * kPitch;
  double* ring = reinterpret_cast<double*>(smem);  // [3][R + 5][kPitch]
  Rec* stage = reinterpret_cast<Rec*>(smem + ring_bytes(R));  // [kStages][width]
  const Lane ln = make_lane(j, t144);
  for (int u = tid; u < 3 * kPitch; u += threads)
    ring[(u / kPitch) * plane + (R + 4) * kPitch + u % kPitch] = -INFINITY;
  // diagonal d's records in (a commit group even past the end)
  auto fetch = [&](int d) {
    if (d < K && tid < 3 * width) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          plan + static_cast<int64_t>(d) * width);
      unsigned char* dst = reinterpret_cast<unsigned char*>(stage + (d & (kStages - 1)) * width);
      cp_async16(dst + 16 * tid, src + 16 * tid);
    }
    cp_commit();
  };
  for (int d = 0; d < kLead; ++d) fetch(d);
  cp_wait<kLead - 1>();  // diagonal 0's records
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    fetch(k + kLead);
    const Rec rec = stage[(k & (kStages - 1)) * width + q];
    const double* p1 = ring + ((k + 2) % 3) * plane;  // diagonal k - 1
    const double* p2 = ring + ((k + 1) % 3) * plane;  // diagonal k - 2
    const double* nL = j == 0 ? p2 + rec.lr * kPitch : p1 + (j == 2 ? rec.r : rec.l) * kPitch;
    const double* nP = p1 + (j == 0 ? rec.l : j < 3 ? rec.r : R + 4) * kPitch;
    const double eL = j == 0 ? rec.me : j == 2 ? rec.ren : rec.le;
    const double eP = j == 0 ? rec.le : rec.ren;
    const Out o = sib_lanes(ln, nL, nP, eL, eP, rec.flags & 2, kFull);
    if (rec.pos >= 0) {
      put(ring + (k % 3) * plane + rec.self * kPitch, ln, o, rec.flags & 1);
      put(cells + static_cast<int64_t>(rec.pos) * kStates, ln, o, rec.flags & 1);
    }
    cp_wait<kLead - 1>();  // diagonal k + 1's records, this thread's copies
    block_sync(threads);
  }
  if (tid == 0) *lp_end = lp_end_of(cells + static_cast<int64_t>(n - 1) * kStates, Trans{t144});
}

// ----------------------------------------------------------- strip design
struct StripArgs {
  const double* emit;
  const uint8_t* mask;
  const double *l_emit, *r_emit, *t144;
  const int *rowpos, *off;
  double* cells;
  double* lp_end;
  double* exch;        // [strips][sy][kPitch]: each strip's last row, by column
  unsigned* progress;  // [strips]: diagonals whose last-row cell is published
  int sx, sy, H, strips;
};

size_t strip_smem_bytes(int H) { return sizeof(double) * kPitch * (3 * (H + 1) + kExStages); }

// Row x's band cell on diagonal k (its position, or -1) and the emission
// lane j adds from it: the match emission (lane 0), r_emit[y - 1] (lanes
// 1 and 2); loaded one diagonal ahead of their use, through L2.
struct RowCell {
  int pos;
  bool in;
  double e;
};

__global__ void __launch_bounds__(kStripMaxThreads) siblingfill_strip(StripArgs a) {
  extern __shared__ __align__(16) double sm[];
  const int H = a.H, X = a.sx - 1, Y = a.sy - 1;
  const int threads = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int compute = kLanes * H;
  const bool fetcher = tid >= compute && tid < compute + 32, publisher = tid >= compute + 32;
  const int i = tid / kLanes, j = tid % kLanes;
  const int plane = (H + 1) * kPitch;
  double* planes = sm;                   // [3][H + 1][kPitch]
  double* stage = sm + 3 * plane;        // [kExStages][kPitch]
  const Trans T{a.t144};
  Lane ln{};
  if (tid < compute) ln = make_lane(j, a.t144);
  const int offX = a.off[X];
  for (int b = blockIdx.x; b < a.strips; b += gridDim.x) {
    const int x0 = b * H, xl = min(x0 + H - 1, X), k0 = x0, k1 = xl + Y;
    for (int u = tid; u < 3 * plane; u += threads) planes[u] = -INFINITY;
    // this lane group's row and its band
    const int x = x0 + i;
    const bool row = tid < compute && x <= X;
    int o0 = 0, oY = 0, rp = 0, lo = 1, hi = 0;
    double le = 0.0;
    if (row) {
      o0 = a.off[x];
      oY = a.off[x + 1] - 1;
      rp = a.rowpos[x];
      lo = o0 + 1 - rp;
      hi = lo + (oY - o0 - (Y >= 1 ? 1 : 0)) - 1;
      le = x >= 1 ? a.l_emit[x - 1] : 0.0;
    }
    auto cell_of = [&](int k) -> RowCell {
      const int y = k - x;
      RowCell c{-1, false, 0.0};
      if (!row || y < 0 || y > Y) return c;
      const bool inner = x > 0 && x < X && y > 0 && y < Y;
      if (inner && (y < lo || y > hi)) return c;
      c.pos = x == 0 ? y : x == X ? offX + y : y == 0 ? o0 : y == Y ? oY : rp + y;
      c.in = __ldcg(a.mask + c.pos) != 0;
      c.e = j == 0 ? __ldcg(a.emit + c.pos) : (j < 3 && y >= 1) ? __ldcg(a.r_emit + y - 1) : 0.0;
      return c;
    };
    // the fetching warp: the row above's cell of diagonal d (strip b - 1's
    // exchange) into the stage, -inf off its row; lanes 0-5 a 16-byte part
    unsigned seen = 0;
    auto fetch = [&](int d) {
      if (b > 0 && lane < 6 && d < k1) {
        const int y = d - (x0 - 1);
        double* dst = stage + (d & (kExStages - 1)) * kPitch + 2 * lane;
        if (y < 0 || y > Y) {
          dst[0] = dst[1] = -INFINITY;
        } else {
          long long spins = 0;
          while (seen <= static_cast<unsigned>(d)) {
            seen = ld_acquire_gpu(a.progress + b - 1);
            if (seen > static_cast<unsigned>(d)) break;
            if (++spins > kSpinLimit) __trap();
            __nanosleep(32);
          }
          cp_async16(dst, a.exch + (static_cast<int64_t>(b - 1) * a.sy + y) * kPitch + 2 * lane);
        }
      }
      cp_commit();
    };
    // ... and from the stage into slot 0 of diagonal d's plane
    auto land = [&](int d) {
      cp_wait<kExLead - 1>();
      if (b > 0 && lane < 6) {
        const double* src = stage + (d & (kExStages - 1)) * kPitch + 2 * lane;
        double* dst = planes + ((d + 3) % 3) * plane + 2 * lane;
        dst[0] = src[0];
        dst[1] = src[1];
      }
    };
    __syncthreads();
    if (fetcher) {
      for (int d = k0 - 1; d < k0 - 1 + kExLead; ++d) fetch(d);
      land(k0 - 1);
    }
    RowCell cur = cell_of(k0);
    __syncthreads();
    for (int k = k0; k <= k1; ++k) {
      if (tid < compute) {
        const RowCell next = cell_of(k + 1);
        const double* p1 = planes + ((k + 2) % 3) * plane;  // diagonal k - 1
        const double* p2 = planes + ((k + 1) % 3) * plane;  // diagonal k - 2
        // slot s holds row x0 + s - 1: (x-1, y) and (x-1, y-1) in slot i,
        // (x, y-1) in slot i + 1
        const double* nL = j == 0 ? p2 + i * kPitch : p1 + (j == 2 ? i + 1 : i) * kPitch;
        const double* nP = p1 + (j == 0 ? i : i + 1) * kPitch;
        const double eL = (j == 0 || j == 2) ? cur.e : le;
        const double eP = (j == 1 || j == 2) ? cur.e : le;
        const Out o = sib_lanes(ln, nL, nP, eL, eP, x == 0 && k == 0, kFull);
        put(planes + (k % 3) * plane + (i + 1) * kPitch, ln, o, cur.in);
        if (cur.pos >= 0) put(a.cells + static_cast<int64_t>(cur.pos) * kStates, ln, o, cur.in);
        const int y = k - x;
        if (i == H - 1 && b + 1 < a.strips && y >= 0 && y <= Y)
          put(a.exch + (static_cast<int64_t>(b) * a.sy + y) * kPitch, ln, o, cur.in);
        cur = next;
      } else if (fetcher) {
        fetch(k + kExLead - 1);
        land(k);
      } else if (publisher && lane == 0 && b + 1 < a.strips) {
        st_release_gpu(a.progress + b, static_cast<unsigned>(k));  // diagonals < k done
      }
      __syncthreads();
    }
    if (publisher && lane == 0 && b + 1 < a.strips)
      st_release_gpu(a.progress + b, static_cast<unsigned>(k1 + 1));
    if (tid == 0 && xl == X)
      *a.lp_end = lp_end_of(planes + (k1 % 3) * plane + (X - x0 + 1) * kPitch, T);
    if (fetcher) cp_wait<0>();
    __syncthreads();
  }
}

// ------------------------------------------------------ dependency floors
// The first design's floor step: one thread computes `steps` cells in a
// chain, each from three neighbours that are the cell before it (an
// interior cell, every neighbour in the mask), and writes the last.
__global__ void siblingfill_chain(const double* __restrict__ t144, int steps, double* out) {
  const Trans T{t144};
  double c[kStates], n[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) c[s] = -1.0 - 0.1 * s;
  for (int i = 0; i < steps; ++i) {
    sib_cell(n, c, c, c, -3.0, -3.0, -5.0, T);
#pragma unroll
    for (int s = 0; s < kStates; ++s) c[s] = n[s] + 3.0;  // keep the values in range
  }
#pragma unroll
  for (int s = 0; s < kStates; ++s) out[s] = c[s];
}

// This design's floor step: one lane group computes the same chain of
// cells as the fill does a cell (`sib_lanes`, the three neighbours the
// cell before it, in shared memory), so a step is one 4-term lse_list, two
// lse2, one 3-term lse_list, the shuffles and the shared-memory round trip.
__global__ void siblingfill_chain_split(const double* __restrict__ t144, int steps,
                                        double* out) {
  __shared__ double c[kPitch];
  const int j = threadIdx.x;
  const unsigned mask = (1u << kLanes) - 1;
  const Lane ln = make_lane(j, t144);
  for (int s = j; s < kStates; s += kLanes) c[s] = -1.0 - 0.1 * s;
  __syncwarp(mask);
  const double eL = j == 0 ? -5.0 : -3.0, eP = -3.0;
  for (int i = 0; i < steps; ++i) {
    const Out o = sib_lanes(ln, c, c, eL, eP, false, mask);
    __syncwarp(mask);
    c[ln.sL] = o.L + 3.0;  // keep the values in range
    c[ln.sW] = o.W + 3.0;
    if (j < 3) c[ln.sP] = o.P + 3.0;
    __syncwarp(mask);
  }
  for (int s = j; s < kStates; s += kLanes) out[s] = c[s];
}


// ----------------------------------------------------- the batch, (d')
// Kernel (d'): K sibling fills in one launch (replaces
// historian_tpu/ops/siblingdp.py::sibling_forward_batch, a `vmap` of the
// XLA row scan over grids padded to one shape).  A thread block cluster of
// C blocks an item, block c a strip of H rows [c H, (c + 1) H) of the
// padded grid, a lane group a row (`sib_lanes`, so each cell is computed
// as kernel (d) computes it, in fill.cpp's order; a grid of more rows than
// a cluster's lane groups gives each R rows, one after another, R turns).
// The cluster walks the item's diagonals x + y = k up to its own corner
// `ends` in step, one cluster barrier a diagonal.  Each block keeps its
// strip's last two diagonals in shared memory (three planes of a slot a
// row, slot 0 the row above the strip), so no neighbour is read from
// device memory: the strip's last row's lane group stores its cell of
// each diagonal straight into slot 0 of the next block of the cluster
// (distributed shared memory), which the barrier publishes.  Where a
// strip's planes outgrow a block's shared memory (grids of more than
// ~6400 rows), the same planes lie in device memory (kDev; `ring`), one
// run of slots an item, so that the next block's slot 0 is this block's
// last slot and the barrier publishes it as it is.  A row's match
// emission, mask byte and r_emit[y - 1] load three diagonals ahead (in one
// turn) and are read only on their diagonal.  A neighbour outside the grid reads the -inf the
// planes start with, one outside the mask the -inf written there.  Cells
// past the item's corner (the batch's padding) are -inf, written by their
// row's lane group in the same walk, a cell a diagonal, the rest after
// it.  Emissions at or below -1e29 (the JAX package's NEG for -inf) are
// read as -inf, as fill.cpp takes them.  Bounded, as kernel (d), by the
// chain of a cell a diagonal, plus the cluster barrier; the clusters meet
// no other, so the K items run side by side.
constexpr int kBatchMaxGroups = 160;  // ops/siblingdp.py BATCH_MAX_GROUPS

__device__ __forceinline__ double inf_below(double v) { return v <= -1e29 ? -INFINITY : v; }

// The cluster barrier a diagonal: the block's own barrier orders its
// shared memory, the arrive is relaxed (a release would wait for every
// thread's global loads and stores in flight), and the wait acquires what
// the strips' last rows released into other blocks (`put_remote`'s
// fence).
__device__ __forceinline__ void diagonal_sync() {
  __syncthreads();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\tbarrier.cluster.wait.aligned;"
               ::: "memory");
}

// The lane's states into another block's slot (`put`'s, through `a`, the
// slot's shared::cluster address), released to the cluster.  The lane's
// last load went out before this diagonal's cell step, a chain of
// log-sum-exps before the fence, so the fence waits for little more than
// these stores.
__device__ __forceinline__ void put_remote(unsigned a, const Lane& ln, const Out& o, bool in) {
  st_remote(a + 8 * ln.sL, in ? o.L : -INFINITY);
  st_remote(a + 8 * ln.sW, in ? o.W : -INFINITY);
  if (ln.j < 3) st_remote(a + 8 * ln.sP, in ? o.P : -INFINITY);
  asm volatile("fence.acq_rel.cluster;" ::: "memory");
}

size_t batch_smem_bytes(int H) { return sizeof(double) * kPitch * 3 * (H + 1); }

// Row x's cell of diagonal k: in the item's grid, its mask byte and the
// emission lane j adds from it (the match emission on lane 0, r_emit[y - 1]
// on lanes 1 and 2), as loaded: nothing reads them before the diagonal
// that uses them, so a load in flight stalls no one.
struct BatchCell {
  int live, mask;
  double e;
};

template <bool kDev>
__global__ void __launch_bounds__(kLanes * kBatchMaxGroups) siblingbatch(
    const double* __restrict__ l_emit, const double* __restrict__ r_emit,
    const double* __restrict__ emit, const uint8_t* __restrict__ mask,
    const double* __restrict__ t144, const int* __restrict__ ends, double* cells,
    double* lp_end, double* ring, int sx, int sy, int R) {
  // the planes, slot s (row x0 + s - 1) of plane p at pl[p * plane + s * kPitch]:
  // [3][H + 1][kPitch] in shared memory, or the block's run of its item's
  // [3][C H + 1][kPitch] in device memory (kDev)
  extern __shared__ __align__(16) double sm[];
  const unsigned rank = cluster_rank(), csize = cluster_blocks();
  const int W = blockDim.x / kLanes, H = W * R;  // lane groups, rows of the strip
  const int item = blockIdx.x / csize, tid = threadIdx.x;
  const int q = tid / kLanes, j = tid % kLanes;
  const int X = ends[2 * item], Y = ends[2 * item + 1];  // the item's corner
  const int x0 = static_cast<int>(rank) * H;
  const int plane = ((kDev ? static_cast<int>(csize) * H : H) + 1) * kPitch;
  double* pl = kDev ? ring + size_t(3) * plane * item + size_t(x0) * kPitch : sm;
  const double* T144 = t144 + 144 * item;
  const Lane ln = make_lane(j, T144);
  const size_t grid = size_t(sx) * sy;
  double* out = cells + grid * kStates * item;
  const double* em = emit + grid * item;
  const uint8_t* mk = mask + grid * item;
  const double* lem = l_emit + size_t(sx - 1) * item;
  const double* re = r_emit + size_t(sy - 1) * item;
  for (int u = tid; u < 3 * (H + 1) * kPitch; u += blockDim.x)
    pl[u / ((H + 1) * kPitch) * plane + u % ((H + 1) * kPitch)] = -INFINITY;
  // the next block's planes, where this strip's last row goes to slot 0
  const bool has_next = rank + 1 < csize;
  const unsigned next = has_next && !kDev ? remote_addr(pl, rank + 1) : 0u;
  auto le_of = [&](int x) { return x >= 1 && x <= X ? inf_below(__ldg(lem + x - 1)) : 0.0; };
  auto cell_of = [&](int x, int k) -> BatchCell {
    const int y = k - x;
    BatchCell c{0, 0, 0.0};
    if (x > X || y < 0 || y > Y) return c;
    c.live = 1;
    c.mask = __ldg(mk + size_t(x) * sy + y);
    if (j == 0) {
      c.e = __ldg(em + size_t(x) * sy + y);
    } else if (j < 3 && y >= 1) {
      c.e = __ldg(re + y - 1);
    }
    return c;
  };
  // the padding of row x: (x, Y + 1 .. sy - 1) on a row of the item, the
  // whole row past it (none past the padded grid); its cell t
  auto pad_cell = [&](int x, int t) {
    const int pad = x >= sx ? 0 : x > X ? sy : sy - 1 - Y;
    if (t < pad) {
      double* c = out + (size_t(x) * sy + (x > X ? 0 : Y + 1) + t) * kStates;
      for (int s = j; s < kStates; s += kLanes) c[s] = -INFINITY;
    }
  };
  // slot i's row (x0 + i) on diagonal k, from its cell c and l_emit le
  auto step = [&](int i, int k, const BatchCell& c, double le) {
    const int x = x0 + i;
    const double* p1 = pl + ((k + 2) % 3) * plane;  // diagonal k - 1
    const double* p2 = pl + ((k + 1) % 3) * plane;  // diagonal k - 2
    // (x-1, y) and (x-1, y-1) in slot i, (x, y-1) in slot i + 1
    const double* nL = j == 0 ? p2 + i * kPitch : p1 + (j == 2 ? i + 1 : i) * kPitch;
    const double* nP = p1 + (j == 0 ? i : i + 1) * kPitch;
    const double e = inf_below(c.e);
    const double eL = (j == 0 || j == 2) ? e : le;
    const double eP = (j == 1 || j == 2) ? e : le;
    const Out o = sib_lanes(ln, nL, nP, eL, eP, x == 0 && k == 0, kFull);
    const bool in = c.live && c.mask;
    put(pl + (k % 3) * plane + (i + 1) * kPitch, ln, o, in);
    if (i == H - 1 && has_next) {
      if (kDev) {
        asm volatile("fence.acq_rel.cluster;" ::: "memory");  // the slot put above
      } else {
        put_remote(next + static_cast<unsigned>((k % 3) * plane * sizeof(double)), ln, o, in);
      }
    }
    if (c.live) put(out + (size_t(x) * sy + (k - x)) * kStates, ln, o, in);
    pad_cell(x, k);
  };
  cluster_sync();  // every plane of the cluster is -inf before any slot 0 is written
  const int K = X + Y + 1;
  if (R == 1) {
    // four cells in registers, each loaded three diagonals before its use
    // and read only then (unrolled, so that no register move waits on a
    // load in flight); a load is a diagonal's chain old at the last row's
    // fence
    const int x = x0 + q;
    const double le = le_of(x);
    BatchCell c0 = cell_of(x, 0), c1 = cell_of(x, 1), c2 = cell_of(x, 2), c3;
    for (int k = 0; k < K; k += 4) {
      c3 = cell_of(x, k + 3);
      step(q, k, c0, le);
      diagonal_sync();
      if (k + 1 >= K) break;
      c0 = cell_of(x, k + 4);
      step(q, k + 1, c1, le);
      diagonal_sync();
      if (k + 2 >= K) break;
      c1 = cell_of(x, k + 5);
      step(q, k + 2, c2, le);
      diagonal_sync();
      if (k + 3 >= K) break;
      c2 = cell_of(x, k + 6);
      step(q, k + 3, c3, le);
      diagonal_sync();
    }
  } else {
    for (int k = 0; k < K; ++k) {
      for (int t = 0; t < R; ++t) {
        const int x = x0 + q + t * W;
        step(q + t * W, k, cell_of(x, k), le_of(x));
      }
      diagonal_sync();
    }
  }
  for (int t = 0; t < R; ++t) {
    const int x = x0 + q + t * W;
    for (int c = K; c < sy; ++c) pad_cell(x, c);
  }
  // the loop's last cluster barrier ended every store into another block
  if (tid == 0 && X >= x0 && X < x0 + H)
    lp_end[item] = lp_end_of(pl + ((K - 1) % 3) * plane + (X - x0 + 1) * kPitch, Trans{T144});
}

}  // namespace

// Blocks of the strip design with `strip_rows` rows that can be resident
// at once on this card (its cooperative launch takes at most this many).
extern "C" int siblingfill_capacity_f64(int strip_rows) {
  int dev = 0, sms = 0, per_sm = 0;
  const int threads = kLanes * strip_rows + kCouriers;
  if (cudaGetDevice(&dev) || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, siblingfill_strip, threads,
                                                    strip_smem_bytes(strip_rows)))
    return 0;
  return sms * per_sm;
}

// The ring design's plan: a 48-byte record (Rec) for each of `width` cell
// slots of each of the sx + sy - 1 diagonals, into `plan`, from the band's
// match emission [n] and mask bytes [n], l_emit [sx - 1], r_emit [sy - 1],
// the rows' `rowpos` [sx] and `off` [sx + 1] and the diagonals' (xa, xb)
// [sx + sy - 1] (ops/branchdp.py `band_layout`), with R = `ring_rows` hull
// slots (a power of two no smaller than any diagonal's hull rows).
extern "C" int siblingplan_f64(const double* emit, const uint8_t* mask, const double* l_emit,
                               const double* r_emit, const int* rowpos, const int* off,
                               const int* diag, void* plan, int sx, int sy, int width,
                               int ring_rows, void* stream) {
  if (width < 1 || ring_rows < 1 || (ring_rows & (ring_rows - 1)) || ring_rows + 4 > 0xffff ||
      !plan)
    return int(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(sx + sy - 1) * width;
  siblingplan<<<static_cast<unsigned>((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      emit, mask, l_emit, r_emit, rowpos, off, reinterpret_cast<const int2*>(diag),
      static_cast<Rec*>(plan), sx, sy, width, ring_rows);
  return static_cast<int>(cudaGetLastError());
}

// The band's n cells [n, 11] (IMM IMD IDM IDD WWW WWX WXW IMI IIW IDI IIX;
// `cells`) and lp_end [1], for a grid of sx = X + 1 rows and sy = Y + 1
// columns, with the transitions t144 [12 * 12] (t[src * 12 + dest], -inf
// where none, as fill.cpp takes them).  design 0, the ring: from `plan`
// (siblingplan_f64's, `width` slots a diagonal, a multiple of 8 at most
// kRingMaxCells, and `ring_rows`), one block of 4 width threads.  design
// 1, the strips: from the band's emit, mask, l_emit, r_emit, rowpos and
// off (as siblingplan_f64 takes them), `blocks` blocks (at most the
// resident capacity) of strips of `strip_rows` rows (a multiple of 8, at
// most kStripMaxRows), `exch` scratch of ceil(sx / strip_rows) * sy * 12
// doubles and `progress` [ceil(sx / strip_rows)] zero.  Returns the
// launch's error.
extern "C" int siblingfill_f64(const void* plan, const double* emit, const uint8_t* mask,
                               const double* l_emit, const double* r_emit, const double* t144,
                               const int* rowpos, const int* off, double* cells, double* lp_end,
                               double* exch, unsigned* progress, int sx, int sy, int n,
                               int design, int width, int ring_rows, int strip_rows, int blocks,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
    return int(cudaErrorInvalidValue);
  if (design == 0) {
    if (width < 8 || width > kRingMaxCells || width % 8 || ring_rows < 1 ||
        (ring_rows & (ring_rows - 1)) || !plan)
      return int(cudaErrorInvalidValue);
    const size_t bytes = ring_smem_bytes(width, ring_rows);
    if (bytes > static_cast<size_t>(limit)) return int(cudaErrorInvalidValue);
    const cudaError_t e = cudaFuncSetAttribute(
        siblingfill_ring, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e) return static_cast<int>(e);
    const int K = sx + sy - 1;
    siblingfill_ring<<<1, kLanes * width, bytes, s>>>(static_cast<const Rec*>(plan), t144,
                                                      cells, lp_end, K, width, ring_rows, n);
    return static_cast<int>(cudaGetLastError());
  }
  if (design != 1 || strip_rows < 8 || strip_rows > kStripMaxRows || strip_rows % 8 ||
      blocks < 1 || !exch || !progress)
    return int(cudaErrorInvalidValue);
  StripArgs a{emit, mask, l_emit, r_emit, t144, rowpos, off, cells, lp_end, exch, progress,
              sx, sy, strip_rows, (sx + strip_rows - 1) / strip_rows};
  const int threads = kLanes * strip_rows + kCouriers;
  const size_t bytes = strip_smem_bytes(strip_rows);
  if (bytes > static_cast<size_t>(limit)) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      siblingfill_strip, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e) return static_cast<int>(e);
  if (blocks == 1) {
    siblingfill_strip<<<1, threads, bytes, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(siblingfill_strip), dim3(blocks),
                                  dim3(threads), args, bytes, s);
  return e ? static_cast<int>(e) : static_cast<int>(cudaGetLastError());
}

// `steps` dependent cells (the dependency floors' steps; chip_smoke.py
// times them): split = 0, one thread a cell (the first design); split =
// 1, a lane group (this one).  t144 as above, out [11].
extern "C" int siblingfill_chain_f64(const double* t144, int steps, int split, double* out,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split)
    siblingfill_chain_split<<<1, kLanes, 0, s>>>(t144, steps, out);
  else
    siblingfill_chain<<<1, 1, 0, s>>>(t144, steps, out);
  return static_cast<int>(cudaGetLastError());
}

// Kernel (d'): K items' fills into cells [K, sx, sy, 11] and lp_end [K],
// from l_emit [K, sx - 1], r_emit [K, sy - 1], emit and mask [K, sx, sy]
// (bytes), t144 [K, 144] (as siblingfill_f64 takes them) and each item's
// corner `ends` [K, 2] (x, y): a cluster of `cluster` blocks an item (1,
// 2, 4 or 8), each of `groups` lane groups (4 threads each; a multiple of
// 8 at most kBatchMaxGroups) and `turns` rows a lane group, cluster *
// groups * turns >= sx.  `ring` null: the planes in shared memory
// (batch_smem_bytes, at most the card's opt-in limit); else in `ring`,
// K * 3 * (cluster * groups * turns + 1) * kPitch doubles of device
// memory.  Returns the launch's error.
extern "C" int siblingbatch_f64(const double* l_emit, const double* r_emit, const double* emit,
                                const uint8_t* mask, const double* t144, const int* ends,
                                double* cells, double* lp_end, double* ring, int K, int sx,
                                int sy, int groups, int turns, int cluster, void* stream) {
  if (K < 1 || sx < 1 || sy < 1 || groups < 8 || groups > kBatchMaxGroups || groups % 8 ||
      turns < 1 || (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      static_cast<long long>(cluster) * groups * turns < sx)
    return int(cudaErrorInvalidValue);
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
    return int(cudaErrorInvalidValue);
  const size_t bytes = ring ? 0 : batch_smem_bytes(groups * turns);
  if (bytes > static_cast<size_t>(limit)) return int(cudaErrorInvalidValue);
  auto kernel = siblingbatch<false>;
  if (ring) kernel = siblingbatch<true>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e) return static_cast<int>(e);
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(K * cluster);
  cfg.blockDim = dim3(kLanes * groups);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, l_emit, r_emit, emit, mask, t144, ends, cells, lp_end,
                         ring, sx, sy, turns);
  return e ? static_cast<int>(e) : static_cast<int>(cudaGetLastError());
}

// The shared memory a block of this card may take (its opt-in limit), 0
// if the card cannot be asked.
extern "C" int smem_optin() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
    return 0;
  return limit;
}
