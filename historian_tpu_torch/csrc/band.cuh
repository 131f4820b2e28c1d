// The band of a grid's fill, as ops/branchdp.py `band_layout` packs it,
// shared by kernel (e) (branchfill.cu), kernel (d) (siblingfill.cu) and
// kernel (a) (dagfill.cu):
// rows 0 and X whole, and on each row 0 < x < X its column 0, its hull of
// columns and its column Y, packed row after row.  `rowpos[x]` + y is the
// packed position of a hull cell (of any cell of rows 0 and X), `off[x]`
// that of (x, 0) and `off[x + 1] - 1` that of (x, Y); `diag[k]` holds the
// first and the last hull row of anti-diagonal k (xa > xb where none).
// A diagonal's cells are, in order of x: (0, k), (k - Y, Y), the hull rows
// xa..xb, (k, 0), (X, k - X), each where it lies on the grid.

#pragma once

#include <cuda_runtime.h>

namespace band {

enum Kind { kNone = 0, kRow0, kRowX, kCol0, kColY, kHull };

// The cell of rank t on diagonal k (hull rows r.x..r.y), in order of x:
// its kind, and its row in x.
__device__ __forceinline__ int cell_at(int t, int k, int2 r, int X, int Y, int& x) {
  if (k <= Y) {
    if (t == 0) { x = 0; return kRow0; }
    --t;
  }
  if (Y >= 1 && k - Y >= 1 && k - Y <= X - 1) {
    if (t == 0) { x = k - Y; return kColY; }
    --t;
  }
  const int nh = r.y >= r.x ? r.y - r.x + 1 : 0;
  if (t < nh) { x = r.x + t; return kHull; }
  t -= nh;
  if (k >= 1 && k <= X - 1) {
    if (t == 0) { x = k; return kCol0; }
    --t;
  }
  if (X >= 1 && k >= X && k - X <= Y && t == 0) { x = X; return kRowX; }
  return kNone;
}

// The cells on diagonal k.
__device__ __forceinline__ int diag_cells(int k, int2 r, int X, int Y) {
  return (k <= Y) + (Y >= 1 && k - Y >= 1 && k - Y <= X - 1) + (r.y >= r.x ? r.y - r.x + 1 : 0)
         + (k >= 1 && k <= X - 1) + (X >= 1 && k >= X && k - X <= Y);
}

// The kind of cell (x, y) (0 <= x <= X, 0 <= y <= Y) on a diagonal whose
// hull rows are r.x..r.y; kNone outside the band.
__device__ __forceinline__ int kind_of(int x, int y, int2 r, int X, int Y) {
  if (x == 0) return kRow0;
  if (x == X) return kRowX;
  if (y == 0) return kCol0;
  if (y == Y) return kColY;
  return (x >= r.x && x <= r.y) ? kHull : kNone;
}

// The packed position of a band cell.
__device__ __forceinline__ int pos_of(int kind, int x, int y, const int* rowpos, const int* off,
                                      int offX) {
  switch (kind) {
    case kRow0: return y;
    case kRowX: return offX + y;
    case kCol0: return off[x];
    case kColY: return off[x + 1] - 1;
    default: return rowpos[x] + y;
  }
}

constexpr long long kSpinLimit = 1ll << 26;  // a grid barrier's polls before __trap()

// Every block's threads past step k of a fill (a diagonal, a wavefront):
// __syncthreads for one block, else a grid barrier on a counter that each
// block adds one to a step (all blocks resident: a cooperative launch).
__device__ __forceinline__ void step_sync(unsigned* arrivals, int k) {
  __syncthreads();
  if (gridDim.x == 1) return;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrivals, 1u);
    const unsigned target = static_cast<unsigned>(k + 1) * gridDim.x;
    long long spins = 0;
    while (atomicAdd(arrivals, 0u) < target) {
      if (++spins > kSpinLimit) __trap();
      __nanosleep(20);
    }
    __threadfence();
  }
  __syncthreads();
}

}  // namespace band
