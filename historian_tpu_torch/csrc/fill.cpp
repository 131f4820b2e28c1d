// Native host runtime of the port: transducer-composition Forward/Backward
// fills (a copy of the JAX package's native/fill.cpp).
//
// The regular tensor compute (emission products, column-batched
// sum-product, the chain-pair kernels) runs on the card through PyTorch
// and the kernels of csrc/*.cu; this library is the native "executor"
// for the irregular part -- the sparse-DAG DP fill over profile-state
// pairs (reference semantics: forward.cpp:68-223 and 975-1097) -- where
// per-cell control flow dominates and Python loop overhead would
// otherwise bound throughput.
//
// Built as a plain shared library with g++, loaded via ctypes (see
// historian_tpu_torch/native.py).  All inputs are flat C arrays prepared
// by the Python caller (CSR edge lists per profile state).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <sys/mman.h>
#include <thread>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#ifndef MADV_POPULATE_WRITE
#define MADV_POPULATE_WRITE 23
#endif

// Prefault an anonymous mapping with parallel MADV_POPULATE_WRITE.
// This host's first-touch faults are serviced by a slow (and erratically
// very slow) virtualized demand-paging path; bulk-populating with several
// threads measures ~3x a single-thread touch, and populating once at
// arena allocation means every later pass (std::fill pins, matmul
// outputs) runs at warm-page speed.
extern "C" void prefault(void* p, int64_t n) {
  const int hw = static_cast<int>(std::thread::hardware_concurrency());
  const int T = std::max(1, std::min(hw, 8));
  const int64_t page = 4096;
  const int64_t chunk = ((n / T + page - 1) / page) * page;
  if (T == 1 || chunk <= 0) {
    if (madvise(p, n, MADV_POPULATE_WRITE) != 0) {
      volatile char* c = static_cast<volatile char*>(p);
      for (int64_t off = 0; off < n; off += page) c[off] = 0;
    }
    return;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < T; ++t) {
    const int64_t lo = t * chunk;
    if (lo >= n) break;
    const int64_t len = std::min(chunk, n - lo);
    ts.emplace_back([p, lo, len, page] {
      char* base = static_cast<char*>(p) + lo;
      if (madvise(base, len, MADV_POPULATE_WRITE) != 0) {
        volatile char* c = base;
        for (int64_t off = 0; off < len; off += page) c[off] = 0;
      }
    });
  }
  for (auto& th : ts) th.join();
}

// Guide-envelope mask in one fused parallel pass (alignpath.h:56-61
// inRange + near-start/end edge cells), replacing several grid-size
// numpy broadcast temporaries.
extern "C" void envelope_mask(
    int64_t sx, int64_t sy,
    const int64_t* m1,            // [sx] cumulative matches, x closest-leaf
    const int64_t* m2,            // [sy]
    int64_t max_distance,
    const uint8_t* x_near_start,  // [sx]
    const uint8_t* y_near_end,    // [sy]
    uint8_t* out                  // [sx * sy]
) {
  #pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < sx; ++i) {
    uint8_t* row = out + i * sy;
    const int64_t a = m1[i];
    const uint8_t xe = x_near_start[i];
    for (int64_t j = 0; j < sy; ++j) {
      const int64_t d = a - m2[j];
      row[j] = (uint8_t)(xe | y_near_end[j] | ((d < 0 ? -d : d) <= max_distance));
    }
  }
}

static const double NEG_INF = -INFINITY;
static const double LOG2 = 0.693147180559945309417232121458176568;

static inline double lse2(double x, double y) {
  if (x == y) return x + LOG2;  // also handles both == -inf
  const double d = x - y;
  if (d > 0) return x + log1p(exp(-d));
  if (d <= 0) return y + log1p(exp(d));
  return x + y;  // nan propagation
}

// state indices (match engine/pairhmm.py)
enum { IMM = 0, IMD = 1, IDM = 2, IMI = 3, IIW = 4 };

struct Trans {
  double imm_imm, imm_imd, imm_idm, imm_imi, imm_iiw;
  double imd_imm, imd_imd, imd_idm;
  double idm_imm, idm_imd, idm_idm;
  double imi_imm, imi_imd, imi_imi, imi_iiw;
  double iiw_imm, iiw_idm, iiw_iiw;
};

// ---------------------------------------------------------------------------
// Wavefront decomposition.  Profile states are toposorted, so a DP level
// per state (1 + max level over edge sources/dests) makes every cell
// (i, j) depend only on cells with a strictly smaller level_x[i] +
// level_y[j]; cells sharing that wavefront sum are independent and are
// filled in parallel.  Per-cell arithmetic is untouched, so results are
// bit-identical to the sequential fill.

namespace {

struct Levels {
  std::vector<int32_t> lvl;                  // level per state
  std::vector<std::vector<int32_t>> bucket;  // states per level (ascending)
};

// forward levels over in-edge CSR, for states [0, n)
static Levels in_levels(int64_t n, const int64_t* ptr, const int64_t* src) {
  Levels L;
  L.lvl.assign(n, 0);
  int32_t maxl = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t m = -1;
    for (int64_t e = ptr[i]; e < ptr[i + 1]; ++e) {
      const int64_t s = src[e];
      if (s >= 0 && s < i && L.lvl[s] > m) m = L.lvl[s];
    }
    L.lvl[i] = m + 1;
    if (L.lvl[i] > maxl) maxl = L.lvl[i];
  }
  L.bucket.assign(maxl + 1, {});
  for (int64_t i = 0; i < n; ++i) L.bucket[L.lvl[i]].push_back((int32_t)i);
  return L;
}

// reverse levels over two out-edge CSRs, for states [0, n); dests >= cap
// impose no ordering (they index pre-seeded rows the fill never writes)
static Levels out_levels(int64_t n, int64_t cap,
                         const int64_t* ptr_a, const int64_t* dst_a,
                         const int64_t* ptr_b, const int64_t* dst_b) {
  Levels L;
  L.lvl.assign(n, 0);
  int32_t maxl = 0;
  for (int64_t i = n - 1; i >= 0; --i) {
    int32_t m = -1;
    for (int64_t e = ptr_a[i]; e < ptr_a[i + 1]; ++e) {
      const int64_t d = dst_a[e];
      if (d > i && d < cap && L.lvl[d] > m) m = L.lvl[d];
    }
    for (int64_t e = ptr_b[i]; e < ptr_b[i + 1]; ++e) {
      const int64_t d = dst_b[e];
      if (d > i && d < cap && L.lvl[d] > m) m = L.lvl[d];
    }
    L.lvl[i] = m + 1;
    if (L.lvl[i] > maxl) maxl = L.lvl[i];
  }
  L.bucket.assign(maxl + 1, {});
  for (int64_t i = 0; i < n; ++i) L.bucket[L.lvl[i]].push_back((int32_t)i);
  return L;
}

}  // namespace

namespace {

struct FwdArgs {
  int64_t sx, sy;
  const int64_t *x_in_ptr, *x_in_src;
  const double* x_in_lp;
  const int64_t *y_in_ptr, *y_in_src;
  const double* y_in_lp;
  const uint8_t *x_null, *y_null, *x_ready, *y_ready, *x_emit_or_start;
  uint8_t x_empty, y_empty;
  const double *insx, *rootsubx, *insy, *rootsuby, *absorb;
  const Trans* t;
  double* cells;
};

#define CELL(i, j, s) A.cells[(((i) * A.sy) + (j)) * 5 + (s)]

static inline void fwd_cell(const FwdArgs& A, int64_t i, int64_t j) {
  const Trans* t = A.t;
  const bool xnull = A.x_null[i];
  const bool x_ready_or_empty = A.x_ready[i] || A.x_empty;
  const bool ynull = A.y_null[j];
  const bool y_ready_or_empty = A.y_ready[j] || A.y_empty;
  double imm = (i == 0 && j == 0) ? 0.0 : NEG_INF;
  double imd = NEG_INF, idm = NEG_INF, imi = NEG_INF, iiw = NEG_INF;

  if (!xnull) {
    // x-absorbing transitions into IMD, IIW
    if (y_ready_or_empty) {
      for (int64_t e = A.x_in_ptr[i]; e < A.x_in_ptr[i + 1]; ++e) {
        const int64_t src = A.x_in_src[e];
        const double lp = A.x_in_lp[e];
        const double* sc = &CELL(src, j, 0);
        imd = lse2(imd, lse2(lse2(lse2(sc[IMM] + t->imm_imd, sc[IMD] + t->imd_imd),
                                  sc[IDM] + t->idm_imd), sc[IMI] + t->imi_imd) + lp);
        iiw = lse2(iiw, lse2(lse2(sc[IMM] + t->imm_iiw, sc[IMI] + t->imi_iiw),
                             sc[IIW] + t->iiw_iiw) + lp);
      }
      imd += A.rootsubx[i];
      iiw += A.insx[i];
    }
  } else {
    // x-nonabsorbing transitions in IMD, IIW
    if (y_ready_or_empty) {
      for (int64_t e = A.x_in_ptr[i]; e < A.x_in_ptr[i + 1]; ++e) {
        const double* sc = &CELL(A.x_in_src[e], j, 0);
        imd = lse2(imd, sc[IMD] + A.x_in_lp[e]);
        iiw = lse2(iiw, sc[IIW] + A.x_in_lp[e]);
      }
    }
  }

  if (!ynull) {
    // y-absorbing transitions into IDM, IMI
    if (x_ready_or_empty) {
      for (int64_t e = A.y_in_ptr[j]; e < A.y_in_ptr[j + 1]; ++e) {
        const int64_t src = A.y_in_src[e];
        const double lp = A.y_in_lp[e];
        const double* sc = &CELL(i, src, 0);
        idm = lse2(idm, lse2(lse2(lse2(sc[IMM] + t->imm_idm, sc[IMD] + t->imd_idm),
                                  sc[IDM] + t->idm_idm), sc[IIW] + t->iiw_idm) + lp);
        imi = lse2(imi, lse2(sc[IMM] + t->imm_imi, sc[IMI] + t->imi_imi) + lp);
      }
      idm += A.rootsuby[j];
      imi += A.insy[j];
    }
  } else {
    // y-nonabsorbing transitions in IDM, IMI
    for (int64_t e = A.y_in_ptr[j]; e < A.y_in_ptr[j + 1]; ++e) {
      const double* sc = &CELL(i, A.y_in_src[e], 0);
      idm = lse2(idm, sc[IDM] + A.y_in_lp[e]);
      imi = lse2(imi, sc[IMI] + A.y_in_lp[e]);
    }
  }

  if (!xnull && !ynull) {
    // xy-absorbing transitions into IMM
    for (int64_t ex = A.x_in_ptr[i]; ex < A.x_in_ptr[i + 1]; ++ex) {
      const int64_t xsrc = A.x_in_src[ex];
      const double xlp = A.x_in_lp[ex];
      for (int64_t ey = A.y_in_ptr[j]; ey < A.y_in_ptr[j + 1]; ++ey) {
        const double* sc = &CELL(xsrc, A.y_in_src[ey], 0);
        imm = lse2(imm,
                   lse2(lse2(lse2(lse2(sc[IMM] + t->imm_imm, sc[IMD] + t->imd_imm),
                                  sc[IDM] + t->idm_imm), sc[IMI] + t->imi_imm),
                        sc[IIW] + t->iiw_imm)
                   + xlp + A.y_in_lp[ey]);
      }
    }
    imm += A.absorb[i * A.sy + j];
    if (i == 0 && j == 0) imm = 0.0;
  } else if (ynull && A.x_emit_or_start[i]) {
    // y-nonabsorbing transitions in IMM
    for (int64_t e = A.y_in_ptr[j]; e < A.y_in_ptr[j + 1]; ++e)
      imm = lse2(imm, CELL(i, A.y_in_src[e], IMM) + A.y_in_lp[e]);
    if (i == 0 && j == 0) imm = 0.0;
  } else if (xnull) {
    // x-nonabsorbing transitions in IMM
    if (y_ready_or_empty) {
      double acc = NEG_INF;
      for (int64_t e = A.x_in_ptr[i]; e < A.x_in_ptr[i + 1]; ++e)
        acc = lse2(acc, CELL(A.x_in_src[e], j, IMM) + A.x_in_lp[e]);
      imm = (i == 0 && j == 0) ? 0.0 : acc;
    } else
      imm = (i == 0 && j == 0) ? 0.0 : NEG_INF;
  }

  double* dst = &CELL(i, j, 0);
  dst[IMM] = imm;
  dst[IMD] = imd;
  dst[IDM] = idm;
  dst[IMI] = imi;
  dst[IIW] = iiw;
}

#undef CELL

// run `body(i, j)` over every in-envelope cell of [0,nx) x [0,ny),
// wavefront-parallel when the grid is big enough to amortize barriers
template <typename Body>
static void wavefront_run(int64_t nx, int64_t ny, int64_t sy_stride,
                          const uint8_t* env_mask,
                          const Levels& LX, const Levels& LY,
                          const Body& body) {
  const int64_t wmax =
      (int64_t)(LX.bucket.size() - 1) + (int64_t)(LY.bucket.size() - 1);
  std::vector<int64_t> work;
  for (int64_t w = 0; w <= wmax; ++w) {
    const int64_t lx_lo = w >= (int64_t)LY.bucket.size()
                              ? w - (int64_t)LY.bucket.size() + 1
                              : 0;
    const int64_t lx_hi = w < (int64_t)LX.bucket.size()
                              ? w
                              : (int64_t)LX.bucket.size() - 1;
    work.clear();
    for (int64_t lx = lx_lo; lx <= lx_hi; ++lx) {
      const auto& rows = LX.bucket[lx];
      const auto& cols = LY.bucket[w - lx];
      for (const int32_t i : rows) {
        if (i >= nx) continue;
        const uint8_t* mrow = env_mask + (int64_t)i * sy_stride;
        for (const int32_t j : cols)
          if (j < ny && mrow[j]) work.push_back(((int64_t)i << 32) | (uint32_t)j);
      }
    }
    if (work.empty()) continue;
    const int64_t n = (int64_t)work.size();
    #pragma omp parallel for schedule(static) if (n > 256)
    for (int64_t k = 0; k < n; ++k) {
      const int64_t i = work[k] >> 32;
      const int64_t j = work[k] & 0xffffffff;
      body(i, j);
    }
  }
}

}  // namespace

extern "C" void forward_fill(
    int64_t sx, int64_t sy,
    const int64_t* x_in_ptr, const int64_t* x_in_src, const double* x_in_lp,
    const int64_t* y_in_ptr, const int64_t* y_in_src, const double* y_in_lp,
    const uint8_t* x_null, const uint8_t* y_null,
    const uint8_t* x_ready, const uint8_t* y_ready,
    const uint8_t* x_emit_or_start,
    uint8_t x_empty, uint8_t y_empty,
    const double* insx, const double* rootsubx,
    const double* insy, const double* rootsuby,
    const double* absorb,        // [sx * sy]
    const uint8_t* env_mask,     // [sx * sy]
    const double* trans18,       // 18 transition log-probs, Trans order
    double* cells                // [sx * sy * 5], pre-filled with -inf
) {
  FwdArgs A{sx, sy, x_in_ptr, x_in_src, x_in_lp, y_in_ptr, y_in_src, y_in_lp,
            x_null, y_null, x_ready, y_ready, x_emit_or_start,
            x_empty, y_empty, insx, rootsubx, insy, rootsuby, absorb,
            reinterpret_cast<const Trans*>(trans18), cells};

  // the caller may hand us uninitialized storage: pin everything to
  // -inf at stream speed; the DP below overwrites in-envelope cells
  const int64_t total = sx * sy * 5;
  #pragma omp parallel for schedule(static) if (total > (1 << 20))
  for (int64_t b = 0; b < total; b += (1 << 20)) {
    const int64_t e = b + (1 << 20) < total ? b + (1 << 20) : total;
    std::fill(cells + b, cells + e, NEG_INF);
  }
  cells[IMM] = 0.0;  // start cell (0, 0)

  if ((sx - 1) * (sy - 1) >= (1 << 16)) {
    const Levels LX = in_levels(sx, x_in_ptr, x_in_src);
    const Levels LY = in_levels(sy, y_in_ptr, y_in_src);
    wavefront_run(sx - 1, sy - 1, sy, env_mask, LX, LY,
                  [&A](int64_t i, int64_t j) { fwd_cell(A, i, j); });
    return;
  }
  for (int64_t i = 0; i < sx - 1; ++i)
    for (int64_t j = 0; j < sy - 1; ++j)
      if (env_mask[i * sy + j]) fwd_cell(A, i, j);
}

namespace {

struct BwdArgs {
  int64_t sx, sy;
  const int64_t *x_abs_ptr, *x_abs_dest;
  const double* x_abs_lp;
  const int64_t *x_nul_ptr, *x_nul_dest;
  const double* x_nul_lp;
  const int64_t *y_abs_ptr, *y_abs_dest;
  const double* y_abs_lp;
  const int64_t *y_nul_ptr, *y_nul_dest;
  const double* y_nul_lp;
  const uint8_t *x_ready, *y_ready, *x_emit_or_start;
  uint8_t x_empty, y_empty;
  const double *insx, *rootsubx, *insy, *rootsuby, *absorb;
  const Trans* t;
  double* cells;
};

#define CELL(i, j, s) A.cells[(((i) * A.sy) + (j)) * 5 + (s)]

static inline void bwd_cell(const BwdArgs& A, int64_t i, int64_t j) {
  const Trans* t = A.t;
  const bool x_ready_or_empty = A.x_ready[i] || A.x_empty;
  const bool y_ready_or_empty = A.y_ready[j] || A.y_empty;
  double* dst = &CELL(i, j, 0);
  double imm = dst[IMM], imd = dst[IMD], idm = dst[IDM], imi = dst[IMI], iiw = dst[IIW];

  // xy-absorbing transitions into IMM
  for (int64_t ex = A.x_abs_ptr[i]; ex < A.x_abs_ptr[i + 1]; ++ex) {
    const int64_t xd = A.x_abs_dest[ex];
    const double xlp = A.x_abs_lp[ex];
    for (int64_t ey = A.y_abs_ptr[j]; ey < A.y_abs_ptr[j + 1]; ++ey) {
      const int64_t yd = A.y_abs_dest[ey];
      const double dest_imm =
          xlp + A.y_abs_lp[ey] + A.absorb[xd * A.sy + yd] + CELL(xd, yd, IMM);
      imm = lse2(imm, t->imm_imm + dest_imm);
      imd = lse2(imd, t->imd_imm + dest_imm);
      idm = lse2(idm, t->idm_imm + dest_imm);
      imi = lse2(imi, t->imi_imm + dest_imm);
      iiw = lse2(iiw, t->iiw_imm + dest_imm);
    }
  }

  // x-absorbing transitions into IMD, IIW
  if (y_ready_or_empty) {
    for (int64_t ex = A.x_abs_ptr[i]; ex < A.x_abs_ptr[i + 1]; ++ex) {
      const int64_t xd = A.x_abs_dest[ex];
      const double dest_imd = A.x_abs_lp[ex] + A.rootsubx[xd] + CELL(xd, j, IMD);
      const double dest_iiw = A.x_abs_lp[ex] + A.insx[xd] + CELL(xd, j, IIW);
      imm = lse2(imm, t->imm_imd + dest_imd);
      imd = lse2(imd, t->imd_imd + dest_imd);
      idm = lse2(idm, t->idm_imd + dest_imd);
      imi = lse2(imi, t->imi_imd + dest_imd);
      imm = lse2(imm, t->imm_iiw + dest_iiw);
      imi = lse2(imi, t->imi_iiw + dest_iiw);
      iiw = lse2(iiw, t->iiw_iiw + dest_iiw);
    }
  }

  // y-absorbing transitions into IDM, IMI
  if (x_ready_or_empty) {
    for (int64_t ey = A.y_abs_ptr[j]; ey < A.y_abs_ptr[j + 1]; ++ey) {
      const int64_t yd = A.y_abs_dest[ey];
      const double dest_idm = A.y_abs_lp[ey] + A.rootsuby[yd] + CELL(i, yd, IDM);
      const double dest_imi = A.y_abs_lp[ey] + A.insy[yd] + CELL(i, yd, IMI);
      imm = lse2(imm, t->imm_idm + dest_idm);
      imd = lse2(imd, t->imd_idm + dest_idm);
      idm = lse2(idm, t->idm_idm + dest_idm);
      iiw = lse2(iiw, t->iiw_idm + dest_idm);
      imm = lse2(imm, t->imm_imi + dest_imi);
      imi = lse2(imi, t->imi_imi + dest_imi);
    }
  }

  // x-nonabsorbing (null) transitions: IMD, IIW, IMM propagate
  if (y_ready_or_empty) {
    for (int64_t ex = A.x_nul_ptr[i]; ex < A.x_nul_ptr[i + 1]; ++ex) {
      const int64_t xd = A.x_nul_dest[ex];
      const double lp = A.x_nul_lp[ex];
      if (xd >= A.sx) continue;
      imd = lse2(imd, lp + CELL(xd, j, IMD));
      iiw = lse2(iiw, lp + CELL(xd, j, IIW));
      imm = lse2(imm, lp + CELL(xd, j, IMM));
    }
  }

  // y-nonabsorbing (null) transitions: IDM, IMI, IMM propagate
  for (int64_t ey = A.y_nul_ptr[j]; ey < A.y_nul_ptr[j + 1]; ++ey) {
    const int64_t yd = A.y_nul_dest[ey];
    const double lp = A.y_nul_lp[ey];
    if (yd >= A.sy - 1) continue;
    idm = lse2(idm, lp + CELL(i, yd, IDM));
    imi = lse2(imi, lp + CELL(i, yd, IMI));
    if (A.x_emit_or_start[i])
      imm = lse2(imm, lp + CELL(i, yd, IMM));
  }

  dst[IMM] = imm;
  dst[IMD] = imd;
  dst[IDM] = idm;
  dst[IMI] = imi;
  dst[IIW] = iiw;
}

#undef CELL

}  // namespace

extern "C" void backward_fill(
    int64_t sx, int64_t sy,
    const int64_t* x_abs_ptr, const int64_t* x_abs_dest, const double* x_abs_lp,
    const int64_t* x_nul_ptr, const int64_t* x_nul_dest, const double* x_nul_lp,
    const int64_t* y_abs_ptr, const int64_t* y_abs_dest, const double* y_abs_lp,
    const int64_t* y_nul_ptr, const int64_t* y_nul_dest, const double* y_nul_lp,
    const uint8_t* x_ready, const uint8_t* y_ready,
    const uint8_t* x_emit_or_start,
    uint8_t x_empty, uint8_t y_empty,
    const double* insx, const double* rootsubx,
    const double* insy, const double* rootsuby,
    const double* absorb,
    const uint8_t* env_mask,
    const double* trans18,
    double* cells  // [sx * sy * 5], pre-seeded with end transitions by caller
) {
  BwdArgs A{sx, sy,
            x_abs_ptr, x_abs_dest, x_abs_lp, x_nul_ptr, x_nul_dest, x_nul_lp,
            y_abs_ptr, y_abs_dest, y_abs_lp, y_nul_ptr, y_nul_dest, y_nul_lp,
            x_ready, y_ready, x_emit_or_start, x_empty, y_empty,
            insx, rootsubx, insy, rootsuby, absorb,
            reinterpret_cast<const Trans*>(trans18), cells};

  if ((sx - 1) * (sy - 1) >= (1 << 16)) {
    // reverse levels: dests at the pre-seeded end row/column (index
    // sx-1 / sy-1) impose no ordering; every filled cell depends only
    // on cells at a strictly smaller reverse-wavefront sum
    const Levels LX =
        out_levels(sx - 1, sx - 1, x_abs_ptr, x_abs_dest, x_nul_ptr, x_nul_dest);
    const Levels LY =
        out_levels(sy - 1, sy - 1, y_abs_ptr, y_abs_dest, y_nul_ptr, y_nul_dest);
    wavefront_run(sx - 1, sy - 1, sy, env_mask, LX, LY,
                  [&A](int64_t i, int64_t j) { bwd_cell(A, i, j); });
    return;
  }
  for (int64_t i = sx - 2; i >= 0; --i)
    for (int64_t j = sy - 2; j >= 0; --j)
      if (env_mask[i * sy + j]) bwd_cell(A, i, j);
}

// ---------------------------------------------------------------------------
// Posterior cell selection for BackwardMatrix::postProbProfile
// (reference forward.cpp:1302-1341).  One fused pass over the forward
// and backward cell tensors: lpp = (bwd + fwd) - lp_end, keep in-band
// cells with lpp >= threshold, sort by (lpp desc, i, j, s) -- the same
// order as the python np.lexsort((s, j, i, -lpp)).  Returns the total
// above-threshold count; writes at most `cap` sorted entries (the
// caller re-invokes with a larger cap in the rare overflow case).

#include <vector>

namespace {
struct PostCell {
  double lpp;
  int64_t i, j, s;
};
}  // namespace

// Positive posterior cells in scan order (i, j, s ascending) with their
// weights exp(fwd + bwd - lp_end); NaNs and masked cells excluded.  Same
// selection and order as the numpy nonzero(post > 0) path in
// BackwardMatrix::get_counts, without materializing any grid-size
// temporary.  Returns the total count; writes at most `cap` entries.
extern "C" int64_t posterior_cells(
    int64_t sx, int64_t sy,
    const double* bwd,       // [sx * sy * 5]
    const double* fwd,       // [sx * sy * 5]
    const uint8_t* env_mask, // [sx * sy]
    double lp_end,
    int64_t cap,
    int64_t* out_ijs,        // [cap * 3]
    double* out_w            // [cap]
) {
  int64_t n = 0;
  for (int64_t i = 0; i < sx - 1; ++i) {
    const double* brow = bwd + i * sy * 5;
    const double* frow = fwd + i * sy * 5;
    const uint8_t* mrow = env_mask + i * sy;
    for (int64_t j = 0; j < sy - 1; ++j) {
      if (!mrow[j]) continue;
      const double* b = brow + j * 5;
      const double* f = frow + j * 5;
      for (int64_t s = 0; s < 5; ++s) {
        const double w = exp(f[s] + b[s] - lp_end);
        if (w > 0.0) {  // excludes NaN and zero
          if (n < cap) {
            out_ijs[n * 3] = i;
            out_ijs[n * 3 + 1] = j;
            out_ijs[n * 3 + 2] = s;
            out_w[n] = w;
          }
          ++n;
        }
      }
    }
  }
  return n;
}

extern "C" int64_t postprob_select(
    int64_t sx, int64_t sy,
    const double* bwd,       // [sx * sy * 5]
    const double* fwd,       // [sx * sy * 5]
    const uint8_t* env_mask, // [sx * sy]
    double lp_end, double lpp_threshold,
    int64_t cap,
    int64_t* out_ijs,        // [cap * 3]
    double* out_lpp          // [cap]
) {
  std::vector<PostCell> hits;
  for (int64_t i = 0; i < sx - 1; ++i) {
    const double* brow = bwd + i * sy * 5;
    const double* frow = fwd + i * sy * 5;
    const uint8_t* mrow = env_mask + i * sy;
    for (int64_t j = 0; j < sy - 1; ++j) {
      if (!mrow[j]) continue;
      const double* b = brow + j * 5;
      const double* f = frow + j * 5;
      for (int64_t s = 0; s < 5; ++s) {
        const double lpp = (b[s] + f[s]) - lp_end;
        if (lpp >= lpp_threshold) hits.push_back({lpp, i, j, s});
      }
    }
  }
  std::sort(hits.begin(), hits.end(), [](const PostCell& a, const PostCell& b) {
    if (a.lpp != b.lpp) return a.lpp > b.lpp;
    if (a.i != b.i) return a.i < b.i;
    if (a.j != b.j) return a.j < b.j;
    return a.s < b.s;
  });
  const int64_t n = static_cast<int64_t>(hits.size());
  const int64_t m = n < cap ? n : cap;
  for (int64_t k = 0; k < m; ++k) {
    out_ijs[k * 3] = hits[k].i;
    out_ijs[k * 3 + 1] = hits[k].j;
    out_ijs[k * 3 + 2] = hits[k].s;
    out_lpp[k] = hits[k].lpp;
  }
  return n;
}

// ---------------------------------------------------------------------------
// 11-state sibling transducer fill (sampler/sibling.py::_fill_host).
// Bit-exact with the python fill: the scalar log-sum-exp uses the same
// max-shift formulation with left-to-right summation and libm exp/log
// (python's math.exp/math.log wrap the same libm), and two-term adds use
// the numpy-compatible lse2 above.

namespace sib {
enum { IMM, IMD, IDM, IDD, WWW, WWX, WXW, IMI, IIW, IDI, IIX, EEE, NST = 11 };

static inline double lse_list(const double* v, int n) {
  double m = v[0];
  for (int k = 1; k < n; ++k) if (v[k] > m) m = v[k];
  if (m == -INFINITY) return -INFINITY;
  // CPython >= 3.12's builtin sum() uses Neumaier compensated summation;
  // replicate it so results stay bit-identical with the python fill
  double s = 0.0, c = 0.0;
  for (int k = 0; k < n; ++k) {
    const double x = exp(v[k] - m);
    const double t = s + x;
    if (fabs(s) >= fabs(x)) c += (s - t) + x; else c += (x - t) + s;
    s = t;
  }
  return m + log(s + c);
}
}  // namespace sib

extern "C" void sibling_fill(
    int64_t sx, int64_t sy,
    const double* l_emit,      // [sx-1]
    const double* r_emit,      // [sy-1]
    const double* match_emit,  // [sx * sy]
    const uint8_t* mask,       // [sx * sy]
    const double* t,           // [12 * 12]: t[src * 12 + dest]
    double* cells,             // [sx * sy * 11], pre-filled with -inf
    double* lp_end_out) {
  #define T(s, d) t[(s) * 12 + (d)]
  #define C(x, y) (&cells[(((x) * sy) + (y)) * sib::NST])
  C(0, 0)[sib::IMM] = 0.0;
  C(0, 0)[sib::WWW] = T(sib::IMM, sib::WWW);
  // cell (x,y) reads only (x-1,y), (x,y-1), (x-1,y-1): cells on one
  // anti-diagonal are independent, so the fill runs wavefront-parallel.
  // Each cell's arithmetic is unchanged, so the result stays bit-exact
  // with the sequential (and python) fill.
  auto sib_cell = [&](int64_t x, int64_t y) {
      if (!mask[x * sy + y]) return;
      double* dest = C(x, y);
      if (x > 0 && mask[(x - 1) * sy + y]) {
        const double* l_src = C(x - 1, y);
        const double le = l_emit[x - 1];
        {
          const double v[3] = {l_src[sib::IMM] + T(sib::IMM, sib::IIW), l_src[sib::IMI] + T(sib::IMI, sib::IIW),
                               l_src[sib::IIW] + T(sib::IIW, sib::IIW)};
          dest[sib::IIW] = le + sib::lse_list(v, 3);
        }
        dest[sib::IIX] = le + lse2(l_src[sib::IMD] + T(sib::IMD, sib::IIX), l_src[sib::IIX] + T(sib::IIX, sib::IIX));
        {
          const double v[4] = {l_src[sib::WWW] + T(sib::WWW, sib::IMD), l_src[sib::WWX] + T(sib::WWX, sib::IMD),
                               l_src[sib::WXW] + T(sib::WXW, sib::IMD), l_src[sib::IDD] + T(sib::IDD, sib::IMD)};
          dest[sib::IMD] = le + sib::lse_list(v, 4);
        }
        dest[sib::WWW] = dest[sib::IIW] + T(sib::IIW, sib::WWW);
        dest[sib::WWX] = lse2(dest[sib::IIX] + T(sib::IIX, sib::WWX), dest[sib::IMD] + T(sib::IMD, sib::WWX));
      }
      if (y > 0 && mask[x * sy + y - 1]) {
        const double* r_src = C(x, y - 1);
        const double ren = r_emit[y - 1];
        dest[sib::IMI] = ren + lse2(r_src[sib::IMM] + T(sib::IMM, sib::IMI), r_src[sib::IMI] + T(sib::IMI, sib::IMI));
        dest[sib::IDI] = ren + lse2(r_src[sib::IDM] + T(sib::IDM, sib::IDI), r_src[sib::IDI] + T(sib::IDI, sib::IDI));
        {
          const double v[4] = {r_src[sib::WWW] + T(sib::WWW, sib::IDM), r_src[sib::WWX] + T(sib::WWX, sib::IDM),
                               r_src[sib::WXW] + T(sib::WXW, sib::IDM), r_src[sib::IDD] + T(sib::IDD, sib::IDM)};
          dest[sib::IDM] = ren + sib::lse_list(v, 4);
        }
        dest[sib::WWW] = lse2(dest[sib::WWW], dest[sib::IMI] + T(sib::IMI, sib::WWW));
        dest[sib::WXW] = lse2(dest[sib::IDI] + T(sib::IDI, sib::WXW), dest[sib::IDM] + T(sib::IDM, sib::WXW));
      }
      if (x > 0 && y > 0 && mask[(x - 1) * sy + y - 1]) {
        const double* lr = C(x - 1, y - 1);
        const double v[4] = {lr[sib::WWW] + T(sib::WWW, sib::IMM), lr[sib::WWX] + T(sib::WWX, sib::IMM),
                             lr[sib::WXW] + T(sib::WXW, sib::IMM), lr[sib::IDD] + T(sib::IDD, sib::IMM)};
        dest[sib::IMM] = match_emit[x * sy + y] + sib::lse_list(v, 4);
        dest[sib::WWW] = lse2(dest[sib::WWW], dest[sib::IMM] + T(sib::IMM, sib::WWW));
      }
      if (x == 0 && y == 0) {
        dest[sib::IMM] = 0.0;
        dest[sib::WWW] = T(sib::IMM, sib::WWW);
      }
      {
        const double v[3] = {dest[sib::WWW] + T(sib::WWW, sib::IDD), dest[sib::WWX] + T(sib::WWX, sib::IDD),
                             dest[sib::WXW] + T(sib::WXW, sib::IDD)};
        dest[sib::IDD] = sib::lse_list(v, 3);
      }
  };
  // wavefront parallelism only pays when diagonals carry enough LIVE
  // cells: a guide-banded MCMC grid leaves ~band-width live cells per
  // diagonal, and forking OMP for each of sx+sy diagonals of ~2us work
  // made fills 2.4x SLOWER than the sequential order (profiled on
  // gp120 mcmc).  Count live cells once and pick the schedule.
  int64_t live = 0;
  const int64_t total_cells = sx * sy;
  #pragma omp parallel for schedule(static) reduction(+:live) if (total_cells > (1 << 20))
  for (int64_t c = 0; c < total_cells; ++c) live += mask[c] != 0;
  const int64_t wmax = (sx - 1) + (sy - 1);
  // >= 128 live cells per diagonal on average: enough work per OMP fork
  // (a banded gp120 mcmc grid averages ~band-width live/diag and stays
  // sequential; dense wide grids take the wavefront)
  if (live >= (wmax + 1) * 128) {
    for (int64_t w = 0; w <= wmax; ++w) {
      const int64_t x_lo = w > sy - 1 ? w - (sy - 1) : 0;
      const int64_t x_hi = w < sx - 1 ? w : sx - 1;
      const int64_t n = x_hi - x_lo + 1;
      #pragma omp parallel for schedule(static) if (n > 128)
      for (int64_t x = x_lo; x <= x_hi; ++x) sib_cell(x, w - x);
    }
  } else {
    for (int64_t x = 0; x < sx; ++x)
      for (int64_t y = 0; y < sy; ++y) sib_cell(x, y);
  }
  const double* end = C(sx - 1, sy - 1);
  const double v[4] = {end[sib::IDD] + T(sib::IDD, sib::EEE), end[sib::WWW] + T(sib::WWW, sib::EEE),
                       end[sib::WWX] + T(sib::WWX, sib::EEE), end[sib::WXW] + T(sib::WXW, sib::EEE)};
  *lp_end_out = sib::lse_list(v, 4);
  #undef T
  #undef C
}

// ---------------------------------------------------------------------------
// Pooled posterior transition weights for count extraction (the reference's
// getCounts transition walk, forward.cpp:1183-1214; python mirror
// engine/forward.py BackwardMatrix.get_counts).  For every in-envelope cell
// with positive posterior, enumerate its source transitions exactly as
// ForwardMatrix.source_transitions does, with w = exp(fwd[src] + lp_trans +
// lp_emit_or_absorb(dest) + bwd[dest] - lp_end), and pool:
//   wx[edge]                      per x-profile transition (x-moving)
//   wy[edge]                      per y-profile transition (y-moving)
//   wcat[((ss*5 + s)*2 + xn)*2 + yn]   per (src state, dest state,
//       x_null[dest.i], y_null[dest.j]) -- the only inputs of the scalar
//       indel bookkeeping, applied once per category on the python side.
namespace pool {

static const int SRC_IMM[5] = {IMM, IMD, IDM, IMI, IIW};
static const int SRC_IMD[4] = {IMM, IMD, IDM, IMI};
static const int SRC_IDM[4] = {IMM, IMD, IDM, IIW};
static const int SRC_IMI[2] = {IMM, IMI};
static const int SRC_IIW[3] = {IMM, IIW, IMI};

static inline const int* sources(int s, int* n) {
  switch (s) {
    case IMM: *n = 5; return SRC_IMM;
    case IMD: *n = 4; return SRC_IMD;
    case IDM: *n = 4; return SRC_IDM;
    case IMI: *n = 2; return SRC_IMI;
    default:  *n = 3; return SRC_IIW;
  }
}

}  // namespace pool

extern "C" void transition_pool(
    int64_t sx, int64_t sy,
    const double* fwd,        // [sx * sy * 5]
    const double* bwd,        // [sx * sy * 5]
    const uint8_t* env_mask,  // [sx * sy]
    double lp_end,
    const int64_t* x_in_ptr, const int64_t* x_in_src,
    const double* x_in_lp, const int64_t* x_in_edge,
    const int64_t* y_in_ptr, const int64_t* y_in_src,
    const double* y_in_lp, const int64_t* y_in_edge,
    const uint8_t* x_null, const uint8_t* y_null,
    const uint8_t* x_ready, const uint8_t* y_ready,
    const uint8_t* x_emit_or_start,
    uint8_t x_empty, uint8_t y_empty,
    const double* insx, const double* rootsubx,
    const double* insy, const double* rootsuby,
    const double* absorb,     // [sx * sy]
    const double* trans_tab,  // [6 * 6] lp_trans, -inf where disallowed
    int64_t n_x_trans, int64_t n_y_trans,
    double* wx,               // [n_x_trans] out, caller-zeroed
    double* wy,               // [n_y_trans] out, caller-zeroed
    double* wcat              // [5 * 5 * 2 * 2] out, caller-zeroed
) {
  #define FWD(i, j, s) fwd[(((i) * sy) + (j)) * 5 + (s)]
  #define TAB(ss, s) trans_tab[(ss) * 6 + (s)]
  const int n_threads =
  #ifdef _OPENMP
      omp_get_max_threads();
  #else
      1;
  #endif
  std::vector<std::vector<double>> twx(n_threads), twy(n_threads), twc(n_threads);

  #pragma omp parallel
  {
    const int tid =
    #ifdef _OPENMP
        omp_get_thread_num();
    #else
        0;
    #endif
    std::vector<double>& lwx = twx[tid];
    std::vector<double>& lwy = twy[tid];
    std::vector<double>& lwc = twc[tid];
    lwx.assign(n_x_trans, 0.0);
    lwy.assign(n_y_trans, 0.0);
    lwc.assign(5 * 5 * 2 * 2, 0.0);

    // static: a fixed row->thread partition keeps the per-thread partial
    // sums (and thus the merged float totals) identical run to run
    #pragma omp for schedule(static)
    for (int64_t i = 0; i < sx - 1; ++i) {
      const uint8_t xn = x_null[i];
      for (int64_t j = 0; j < sy - 1; ++j) {
        if (!env_mask[i * sy + j]) continue;
        const uint8_t yn = y_null[j];
        const double* bc = bwd + ((i * sy) + j) * 5;
        const double* fc = fwd + ((i * sy) + j) * 5;
        for (int s = 0; s < 5; ++s) {
          const double post = exp(fc[s] + bc[s] - lp_end);
          if (!(post > 0.0)) continue;
          // lp_cell_emit_or_absorb(dest)
          double lp_abs = 0.0;
          if (s == IMD && !xn) lp_abs = rootsubx[i];
          else if (s == IIW && !xn) lp_abs = insx[i];
          else if (s == IDM && !yn) lp_abs = rootsuby[j];
          else if (s == IMI && !yn) lp_abs = insy[j];
          else if (s == IMM && !xn && !yn) lp_abs = absorb[i * sy + j];
          const double base = lp_abs + bc[s] - lp_end;
          const int cat_base = (s * 2 + xn) * 2 + yn;  // + ss*5*2*2

          if (s == IMD || s == IIW) {
            if (xn) {
              if (y_ready[j] || y_empty) {
                for (int64_t e = x_in_ptr[i]; e < x_in_ptr[i + 1]; ++e) {
                  const double w = exp(FWD(x_in_src[e], j, s) + x_in_lp[e] + base);
                  if (w > 0.0) {
                    lwx[x_in_edge[e]] += w;
                    lwc[s * 20 + cat_base] += w;
                  }
                }
              }
            } else if (y_ready[j] || y_empty) {
              int ns; const int* srcs = pool::sources(s, &ns);
              for (int64_t e = x_in_ptr[i]; e < x_in_ptr[i + 1]; ++e) {
                const double lp_e = x_in_lp[e] + base;
                const double* fs = &FWD(x_in_src[e], j, 0);
                for (int k = 0; k < ns; ++k) {
                  const int ss = srcs[k];
                  const double w = exp(fs[ss] + TAB(ss, s) + lp_e);
                  if (w > 0.0) {
                    lwx[x_in_edge[e]] += w;
                    lwc[ss * 20 + cat_base] += w;
                  }
                }
              }
            }
          } else if (s == IDM || s == IMI) {
            if (yn) {
              for (int64_t e = y_in_ptr[j]; e < y_in_ptr[j + 1]; ++e) {
                const double w = exp(FWD(i, y_in_src[e], s) + y_in_lp[e] + base);
                if (w > 0.0) {
                  lwy[y_in_edge[e]] += w;
                  lwc[s * 20 + cat_base] += w;
                }
              }
            } else if (x_ready[i] || x_empty) {
              int ns; const int* srcs = pool::sources(s, &ns);
              for (int64_t e = y_in_ptr[j]; e < y_in_ptr[j + 1]; ++e) {
                const double lp_e = y_in_lp[e] + base;
                const double* fs = &FWD(i, y_in_src[e], 0);
                for (int k = 0; k < ns; ++k) {
                  const int ss = srcs[k];
                  const double w = exp(fs[ss] + TAB(ss, s) + lp_e);
                  if (w > 0.0) {
                    lwy[y_in_edge[e]] += w;
                    lwc[ss * 20 + cat_base] += w;
                  }
                }
              }
            }
          } else {  // IMM
            if (yn && x_emit_or_start[i]) {
              for (int64_t e = y_in_ptr[j]; e < y_in_ptr[j + 1]; ++e) {
                const double w = exp(FWD(i, y_in_src[e], IMM) + y_in_lp[e] + base);
                if (w > 0.0) {
                  lwy[y_in_edge[e]] += w;
                  lwc[IMM * 20 + cat_base] += w;
                }
              }
            } else if (xn) {
              if (y_ready[j] || y_empty) {
                for (int64_t e = x_in_ptr[i]; e < x_in_ptr[i + 1]; ++e) {
                  const double w = exp(FWD(x_in_src[e], j, IMM) + x_in_lp[e] + base);
                  if (w > 0.0) {
                    lwx[x_in_edge[e]] += w;
                    lwc[IMM * 20 + cat_base] += w;
                  }
                }
              }
            } else if (!yn) {
              for (int64_t ex = x_in_ptr[i]; ex < x_in_ptr[i + 1]; ++ex) {
                const double lp_x = x_in_lp[ex] + base;
                for (int64_t ey = y_in_ptr[j]; ey < y_in_ptr[j + 1]; ++ey) {
                  const double lp_xy = lp_x + y_in_lp[ey];
                  const double* fs = &FWD(x_in_src[ex], y_in_src[ey], 0);
                  for (int k = 0; k < 5; ++k) {
                    const int ss = pool::SRC_IMM[k];
                    const double w = exp(fs[ss] + TAB(ss, IMM) + lp_xy);
                    if (w > 0.0) {
                      lwx[x_in_edge[ex]] += w;
                      lwy[y_in_edge[ey]] += w;
                      lwc[ss * 20 + cat_base] += w;
                    }
                  }
                }
              }
            }
          }
        }
      }
    }
  }

  for (int t = 0; t < n_threads; ++t) {
    if (twx[t].empty()) continue;
    for (int64_t e = 0; e < n_x_trans; ++e) wx[e] += twx[t][e];
    for (int64_t e = 0; e < n_y_trans; ++e) wy[e] += twy[t][e];
    for (int k = 0; k < 100; ++k) wcat[k] += twc[t][k];
  }
  #undef FWD
  #undef TAB
}

// ---------------------------------------------------------------------------
// Synchronized multi-alignment merge (reference alignPathMerge,
// alignpath.cpp:153-203; python mirror core/alignpath.py align_path_merge).
// Each column of each input defines an anchor set {(row, residue#)};
// columns sharing an anchor merge into one output column, with linkage
// transitively closed and every input's column order respected.
// Returns the output column count, or a negative code the python caller
// maps to ValueError: -1 empty input column, -2 inconsistent linkage,
// -3 ordering cycle.
extern "C" int64_t align_merge(
    int64_t n_aligns,
    const int64_t* rows_ptr,  // [n_aligns + 1] CSR offsets into row_ids
    const int64_t* row_ids,   // dense row index per (align, local row)
    const int64_t* cols,      // [n_aligns] column counts
    const int64_t* cell_ptr,  // [n_aligns + 1] element offsets into cells
    const uint8_t* cells,     // per align, row-major [R_n, L_n]
    int64_t n_rows,           // number of distinct dense rows
    const int64_t* seq_len,   // [n_rows] residues per row
    uint8_t* out              // [n_rows, sum(cols)] zeroed by caller
) {
  const int64_t out_stride = [&] {
    int64_t s = 0;
    for (int64_t n = 0; n < n_aligns; ++n) s += cols[n];
    return s;
  }();

  // per-(align, col) anchors and per-(row, pos) linked columns
  struct Anchor { int32_t row, pos; };
  struct Link { int32_t align, col; };
  std::vector<std::vector<std::vector<Anchor>>> col_anchors(n_aligns);
  std::vector<int64_t> row_pos_ptr(n_rows + 1, 0);
  for (int64_t r = 0; r < n_rows; ++r) row_pos_ptr[r + 1] = row_pos_ptr[r] + seq_len[r];
  std::vector<std::vector<Link>> anchor_links(row_pos_ptr[n_rows]);

  for (int64_t n = 0; n < n_aligns; ++n) {
    const int64_t L = cols[n];
    col_anchors[n].assign(L, {});
    const int64_t r0 = rows_ptr[n], r1 = rows_ptr[n + 1];
    const uint8_t* base = cells + cell_ptr[n];
    for (int64_t ri = r0; ri < r1; ++ri) {
      const int64_t row = row_ids[ri];
      const uint8_t* rp = base + (ri - r0) * L;
      int32_t pos = 0;
      for (int64_t c = 0; c < L; ++c) {
        if (rp[c]) {
          col_anchors[n][c].push_back({(int32_t)row, pos});
          anchor_links[row_pos_ptr[row] + pos].push_back({(int32_t)n, (int32_t)c});
          ++pos;
        }
      }
    }
    for (int64_t c = 0; c < L; ++c)
      if (col_anchors[n][c].empty()) return -1;
  }

  std::vector<int64_t> next_col(n_aligns, 0);
  std::vector<int64_t> seen(n_aligns, -1);
  std::vector<int32_t> touched;
  std::vector<Link> stack;
  int64_t out_col = 0;

  for (;;) {
    bool all_done = true, progressed = false;
    for (int64_t n = 0; n < n_aligns && !progressed; ++n) {
      if (next_col[n] >= cols[n]) continue;
      all_done = false;
      // transitive closure from (n, next_col[n])
      touched.clear();
      stack.clear();
      stack.push_back({(int32_t)n, (int32_t)next_col[n]});
      bool bad = false;
      while (!stack.empty() && !bad) {
        const Link cur = stack.back();
        stack.pop_back();
        if (seen[cur.align] != -1) {
          if (seen[cur.align] != cur.col) bad = true;
          continue;
        }
        seen[cur.align] = cur.col;
        touched.push_back(cur.align);
        for (const Anchor& a : col_anchors[cur.align][cur.col]) {
          for (const Link& link : anchor_links[row_pos_ptr[a.row] + a.pos]) {
            if (seen[link.align] == -1) stack.push_back(link);
            else if (seen[link.align] != link.col) { bad = true; break; }
          }
          if (bad) break;
        }
      }
      if (bad) {
        for (int32_t t : touched) seen[t] = -1;
        return -2;
      }
      bool ready = true;
      for (int32_t an : touched)
        if (next_col[an] != seen[an]) { ready = false; break; }
      if (ready) {
        for (int32_t an : touched) {
          for (const Anchor& a : col_anchors[an][seen[an]])
            out[a.row * out_stride + out_col] = 1;
          next_col[an] += 1;
        }
        out_col += 1;
        progressed = true;
      }
      for (int32_t t : touched) seen[t] = -1;
    }
    if (all_done) return out_col;
    if (!progressed) return -3;
  }
}

// ---------------------------------------------------------------------------
// 3-state (Match/Insert/Delete) branch alignment DP over PWMs (reference
// BranchMatrixBase, sampler.cpp:1005-1160; device twin ops/branchdp.py).
// Same recurrences as the device kernel; the Delete within-column
// recursion runs sequentially instead of via the prefix-scan shift trick,
// so values may differ from the device fill in the last bits.
extern "C" void branch_fill(
    int64_t sx, int64_t sy,      // X+1, Y+1
    const double* match_emit,    // [sx * sy], valid at x,y >= 1
    const double* ins_emit,      // [sy]
    const uint8_t* mask,         // [sx * sy]
    const double* trans8,        // mm mi md im ii id dm dd
    uint8_t viterbi,
    double* cells                // [sx * sy * 3] (Match, Insert, Delete)
) {
  const double BNEG = -1e30;  // matches ops/branchdp.NEG
  const double mm = trans8[0], mi = trans8[1], md = trans8[2];
  const double im = trans8[3], ii = trans8[4], id_ = trans8[5];
  const double dm = trans8[6], dd = trans8[7];
  const bool vit = viterbi != 0;
  auto red2 = [vit](double a, double b) {
    return vit ? (a > b ? a : b) : lse2(a, b);
  };
  #define BC(x, y, s) cells[(((x) * sy) + (y)) * 3 + (s)]
  for (int64_t y = 0; y < sy; ++y) {
    const bool is_first = (y == 0);
    double run = BNEG;  // Delete within-column accumulator
    for (int64_t x = 0; x < sx; ++x) {
      const bool in_env = mask[x * sy + y];
      double m, i;
      if (is_first) {
        m = (x == 0) ? 0.0 : BNEG;
        i = BNEG;
        if (!in_env) m = BNEG;
      } else {
        if (in_env) {
          if (x > 0) {
            const double* p = &BC(x - 1, y - 1, 0);
            m = red2(red2(p[0] + mm, p[1] + im), p[2] + dm)
                + match_emit[x * sy + y];
          } else {
            m = BNEG + match_emit[y];  // shift_down pads with NEG
          }
          const double* q = &BC(x, y - 1, 0);
          i = red2(q[0] + mi, q[1] + ii) + ins_emit[y];
        } else {
          m = BNEG;
          i = BNEG;
        }
      }
      double base;
      if (x > 0) {
        const double pm = BC(x - 1, y, 0);
        const double pi = BC(x - 1, y, 1);
        base = red2(pm + md, pi + id_);
      } else {
        base = red2(BNEG + md, BNEG + id_);
      }
      double d;
      if (!in_env) {
        run = BNEG;
        d = BNEG;
      } else {
        run = red2(run + dd, base);
        d = run;
      }
      BC(x, y, 0) = m;
      BC(x, y, 1) = i;
      BC(x, y, 2) = d;
    }
  }
  #undef BC
}

// ---------------------------------------------------------------------------
// Column-batched Felsenstein sum-product fill (reference SumProduct,
// sumprod.cpp:99-198; device twin ops/felsenstein.py _fill_up_batch /
// _fill_down_batch).  The device kernel is a lax.scan over postorder
// nodes whose per-step overhead dominates small fills (an MCMC proposal
// refills ~hundreds of columns over ~hundreds of nodes); this native twin
// runs the same recurrences sequentially per column, OMP-parallel over
// columns.  Dot-product accumulation order differs from XLA, so values
// can differ from the device fill in the last bits.
extern "C" void sumprod_fill(
    int64_t L, int64_t N, int64_t C, int64_t A,
    const int32_t* tokens,   // [N, L]; >=0 token, -1 gap, other <0 wildcard
    const int64_t* parent, const int64_t* left, const int64_t* right,
    const int64_t* sibling,
    const double* sub,       // [N, C, A, A]
    const double* ins,       // [C, A]
    const double* lcw,       // [C] log component weights
    uint8_t down,            // also fill G/logG
    double* F, double* logF,  // [L, N, C, A] / [L, N, C]
    double* E, double* logE,
    double* G, double* logG,  // only written when down != 0
    double* cpt_ll,           // [L, C]
    double* col_ll            // [L]
) {
  const double TINY = 2.2250738585072014e-308;  // smallest normal f64
  #pragma omp parallel
  {
    std::vector<double> fn(C * A), en(C * A);
    #pragma omp for schedule(static)
    for (int64_t l = 0; l < L; ++l) {
      double* Fl = F + l * N * C * A;
      double* El = E + l * N * C * A;
      double* lFl = logF + l * N * C;
      double* lEl = logE + l * N * C;
      double* cl = cpt_ll + l * C;
      bool any_ungapped = false;
      for (int64_t c = 0; c < C; ++c) cl[c] = 0.0;
      // ---- up pass (postorder: nodes are toposorted children-first)
      for (int64_t n = 0; n < N; ++n) {
        const bool gap_n = tokens[n * L + l] == -1;
        const int64_t p = parent[n];
        const bool gap_p = p < 0 || tokens[p * L + l] == -1;
        const bool is_root = !gap_n && gap_p;
        if (!gap_n) any_ungapped = true;
        const int64_t lc = left[n], rc = right[n];
        const int32_t tok = tokens[n * L + l];
        for (int64_t c = 0; c < C; ++c) {
          const double* el = lc >= 0 ? El + (lc * C + c) * A : nullptr;
          const double* er = rc >= 0 ? El + (rc * C + c) * A : nullptr;
          double log_children =
              (lc >= 0 ? lEl[lc * C + c] : 0.0) + (rc >= 0 ? lEl[rc * C + c] : 0.0);
          // Fn_raw = prod(children E) * obs; rescale by per-component max
          double fmax = 0.0;
          for (int64_t a = 0; a < A; ++a) {
            double v = (el ? el[a] : 1.0) * (er ? er[a] : 1.0);
            if (tok >= 0 && a != tok) v = 0.0;
            fn[c * A + a] = v;
            if (v > fmax) fmax = v;
          }
          const double safe = fmax > TINY ? fmax : TINY;
          for (int64_t a = 0; a < A; ++a) fn[c * A + a] /= safe;
          const double logFn = log_children + log(safe);
          // root contribution to the column likelihood
          if (is_root) {
            double dot = 0.0;
            for (int64_t a = 0; a < A; ++a) dot += fn[c * A + a] * ins[c * A + a];
            cl[c] += logFn + log(dot > TINY ? dot : TINY);
          }
          // message up the branch: En = sub[n] . Fn
          const double* M = sub + ((n * C + c) * A) * A;
          double* Edst = El + (n * C + c) * A;
          double* Fdst = Fl + (n * C + c) * A;
          if (gap_n || is_root) {
            for (int64_t a = 0; a < A; ++a) Edst[a] = 1.0;
            lEl[n * C + c] = 0.0;
          } else {
            for (int64_t i = 0; i < A; ++i) {
              double acc = 0.0;
              const double* Mi = M + i * A;
              for (int64_t j = 0; j < A; ++j) acc += Mi[j] * fn[c * A + j];
              en[c * A + i] = acc;
            }
            for (int64_t a = 0; a < A; ++a) Edst[a] = en[c * A + a];
            lEl[n * C + c] = logFn;
          }
          if (gap_n) {
            for (int64_t a = 0; a < A; ++a) Fdst[a] = 0.0;
            lFl[n * C + c] = 0.0;
          } else {
            for (int64_t a = 0; a < A; ++a) Fdst[a] = fn[c * A + a];
            lFl[n * C + c] = logFn;
          }
        }
      }
      // col_ll = logsumexp_c(lcw + cpt_ll); 0 for all-gap columns
      if (!any_ungapped) {
        col_ll[l] = 0.0;
      } else {
        double m = -INFINITY;
        for (int64_t c = 0; c < C; ++c) {
          const double v = lcw[c] + cl[c];
          if (v > m) m = v;
        }
        double s = 0.0;
        for (int64_t c = 0; c < C; ++c) s += exp(lcw[c] + cl[c] - m);
        col_ll[l] = m + log(s);
      }
      // ---- down pass (preorder = reverse postorder)
      if (down) {
        double* Gl = G + l * N * C * A;
        double* lGl = logG + l * N * C;
        for (int64_t n = N - 1; n >= 0; --n) {
          const int64_t p = parent[n];
          const int64_t s = sibling[n];
          const bool gap_p = p < 0 || tokens[p * L + l] == -1;
          for (int64_t c = 0; c < C; ++c) {
            double* Gdst = Gl + (n * C + c) * A;
            if (gap_p) {  // root (or gapped parent): G = insProb
              for (int64_t a = 0; a < A; ++a) Gdst[a] = ins[c * A + a];
              lGl[n * C + c] = 0.0;
              continue;
            }
            const double* Gp = Gl + (p * C + c) * A;
            const bool use_sib = s >= 0 && tokens[s * L + l] != -1;
            const double* Es = use_sib ? El + (s * C + c) * A : nullptr;
            const double* M = sub + ((n * C + c) * A) * A;
            // Gn[j] = sum_i (Gp*Es)[i] * sub[n][i][j]
            for (int64_t j = 0; j < A; ++j) {
              double acc = 0.0;
              for (int64_t i = 0; i < A; ++i)
                acc += Gp[i] * (Es ? Es[i] : 1.0) * M[i * A + j];
              Gdst[j] = acc;
            }
            lGl[n * C + c] = lGl[p * C + c] + (s >= 0 ? lEl[s * C + c] : 0.0);
          }
        }
      }
    }
  }
}
