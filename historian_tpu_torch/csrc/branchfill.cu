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
// What bounds it on this card: the grid's bytes, 24 B a cell written once,
// with the mask's byte a cell and the emission at the in-mask cells only
// (0.90 GB at a 6000 x 6000 long6 branch, 0.27 ms at 3.35 TB/s), but the
// recurrence allows parallel work only along an anti-diagonal, so the floor
// in practice is one chain of dependent reads a diagonal, some 12 000 of
// them.  Design: one block walks
// the anti-diagonals x + y = k in order, one block barrier a diagonal.  The
// wrapper fills the grid with BNEG first and gives each diagonal the rows
// of its in-mask interior cells (`xa[k]..xb[k]`, ops/branchdp.py
// `diagonal_ranges`); the block computes those and the diagonal's cells on
// the four always-in boundary lines, and leaves the rest BNEG, as fill.cpp
// writes them.  Under a band the block is one to four warps, sized by the
// wrapper to the widest diagonal, so a barrier is cheap; the neighbours'
// cells (diagonals k - 1 and k - 2) are read back from device memory, where
// the 50 MB L2 still holds them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr double kBNeg = -1e30;  // ops/branchdp.py NEG
constexpr double kLog2 = 0.693147180559945309417232121458176568;  // fill.cpp LOG2
constexpr int kThreads = 1024;

template <bool VIT>
__device__ __forceinline__ double red2(double a, double b) {
  if (VIT) return a > b ? a : b;
  // fill.cpp lse2
  if (a == b) return __dadd_rn(a, kLog2);
  const double d = __dsub_rn(a, b);
  if (d > 0) return __dadd_rn(a, log1p(exp(-d)));
  if (d <= 0) return __dadd_rn(b, log1p(exp(d)));
  return __dadd_rn(a, b);
}

// The rows x of the cells of diagonal k on the four boundary lines
// (x = 0, y = 0, x = X, y = Y), each once; returns how many.
__device__ __forceinline__ int boundary_rows(int k, int X, int Y, int (&bx)[4]) {
  int n = 0;
  if (k <= Y) bx[n++] = 0;                           // x = 0
  if (k >= 1 && k <= X) bx[n++] = k;                 // y = 0
  if (X >= 1 && k - X >= 1 && k - X <= Y) bx[n++] = X;  // x = X
  if (Y >= 1 && k - Y >= 1 && k - Y <= X - 1) bx[n++] = k - Y;  // y = Y
  return n;
}

template <bool VIT>
__global__ void __launch_bounds__(kThreads) branchfill_kernel(
    int sx, int sy, const double* __restrict__ emit, const double* __restrict__ ins,
    const uint8_t* __restrict__ mask, const double* __restrict__ trans8,
    const int* __restrict__ xa, const int* __restrict__ xb, double* cells) {
  const double mm = trans8[0], mi = trans8[1], md = trans8[2];
  const double im = trans8[3], ii = trans8[4], id = trans8[5];
  const double dm = trans8[6], dd = trans8[7];
  const int ndiag = sx + sy - 1;
  for (int k = 0; k < ndiag; ++k) {
    int bx[4];
    const int nb = boundary_rows(k, sx - 1, sy - 1, bx);
    const int a = xa[k];
    const int n_in = xb[k] >= a ? xb[k] - a + 1 : 0;
    for (int t = static_cast<int>(threadIdx.x); t < n_in + nb; t += blockDim.x) {
      const int x = t < n_in ? a + t : bx[t - n_in];
      const int y = k - x;
      const int64_t at = static_cast<int64_t>(x) * sy + y;
      const bool in_env = mask[at] != 0;
      double m, i;
      if (y == 0) {
        m = (x == 0 && in_env) ? 0.0 : kBNeg;
        i = kBNeg;
      } else if (in_env) {
        if (x > 0) {
          const double* p = cells + (at - sy - 1) * 3;
          m = __dadd_rn(red2<VIT>(red2<VIT>(__dadd_rn(p[0], mm), __dadd_rn(p[1], im)),
                                  __dadd_rn(p[2], dm)),
                        emit[at]);
        } else {
          m = __dadd_rn(kBNeg, emit[y]);
        }
        const double* q = cells + (at - 1) * 3;
        i = __dadd_rn(red2<VIT>(__dadd_rn(q[0], mi), __dadd_rn(q[1], ii)), ins[y]);
      } else {
        m = kBNeg;
        i = kBNeg;
      }
      double d = kBNeg;
      if (in_env) {
        double base, run;
        if (x > 0) {
          const double* u = cells + (at - sy) * 3;
          base = red2<VIT>(__dadd_rn(u[0], md), __dadd_rn(u[1], id));
          run = u[2];
        } else {
          base = red2<VIT>(__dadd_rn(kBNeg, md), __dadd_rn(kBNeg, id));
          run = kBNeg;
        }
        d = red2<VIT>(__dadd_rn(run, dd), base);
      }
      double* c = cells + at * 3;
      c[0] = m;
      c[1] = i;
      c[2] = d;
    }
    __syncthreads();
  }
}

}  // namespace

// cells [sx, sy, 3] (sx = X + 1, sy = Y + 1; filled with BNEG by the
// caller) from emit [sx, sy], ins [sy], mask [sx, sy] (0/1 bytes), trans8
// (mm mi md im ii id dm dd) and each diagonal's interior rows xa, xb
// [sx + sy - 1], all on the device, with `threads` (a multiple of 32, at
// most 1024) in the block; returns the launch's cudaGetLastError().
extern "C" int branchfill_f64(const double* emit, const double* ins, const uint8_t* mask,
                              const double* trans8, const int* xa, const int* xb,
                              double* cells, int sx, int sy, int viterbi, int threads,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads < 32 || threads > kThreads || threads % 32) return int(cudaErrorInvalidValue);
  if (viterbi) {
    branchfill_kernel<true><<<1, threads, 0, s>>>(sx, sy, emit, ins, mask, trans8, xa, xb,
                                                  cells);
  } else {
    branchfill_kernel<false><<<1, threads, 0, s>>>(sx, sy, emit, ins, mask, trans8, xa, xb,
                                                   cells);
  }
  return static_cast<int>(cudaGetLastError());
}
