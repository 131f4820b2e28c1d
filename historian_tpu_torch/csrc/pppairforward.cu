// Kernel (g3): the pipeline-parallel pair Forward, the X rows of a batch
// of chain x chain pairs cut into stages, on Hopper.
//
// Replaces historian_tpu/parallel/pp_pairforward.py::pp_pair_forward_lp,
// an XLA `shard_map` kernel (body `_pp_kernel`): stage k owns rows
// [k xb, (k + 1) xb) (xb = ceil(X1 / n); rows past X1 pass the carry
// through), fills them for pair p at pipeline step k + p from the [5, Y1]
// boundary row that stage k - 1 hands it (`ppermute`), and the last stage
// gives lp_end [PAIRS].  No mask.
//
// Design: the lock-step schedule is not copied, only its dependencies.
// Each stage is a group of G blocks of one cooperative launch; block g of
// a stage takes pairs g, g + G, ... in order, whole rows, run as K3's
// block (pairforward.cu): the LogSum instance of its row step under the
// JAX rules (pairstep.cuh `warp_row`, JaxRules<LogSum>), M lanes a thread,
// the row in registers, the rows piped down the warps (their count runs
// on from pair to pair, so the handoff ring needs no reset).  For pair p
// it waits on the ready flag of (stage k - 1, p) (thread 0, an acquire
// load, then a block barrier), reads the boundary row from memory, fills
// its rows, writes its last row to the next stage's buffer [PAIRS, 5, Y1]
// and publishes (stage k, p) with a release store after a barrier and a
// fence.  So stage k starts pair p only once stage k - 1 has finished it,
// and the G groups run G pairs of a stage side by side.  The stages of one
// card share the launch, so each waits only on resident blocks; between
// cards the buffer and flags lie in the reading card's memory or in
// pinned host memory, published and acquired at system scope.
//
// What bounds it on this card: a pair's rows are a chain of X1 steps (the
// stages only pipeline pairs); bytes: absorb read once; operations: ~13
// log-sum-exps and ~26 adds a cell.

#include <cstdint>

#include "pairstep.cuh"

namespace {

using namespace pairstep;
using Rules = JaxRules<LogSum>;

// One stage as the wrapper lays it out (parallel/pp_pairforward.py): 8 int64.
struct PpEntry {
  long long r0, r1;             // its real rows [r0, r1) (r1 <= r0: pass-through)
  long long in_buf, in_flag;    // the boundary rows [PAIRS, 5, Y1] and flags [PAIRS] (0: stage 0)
  long long out_buf, out_flag;  // the next stage's (0: last stage)
  long long sys, pad;
};

template <typename T>
struct Args {
  const PpEntry* table;
  const T *absorb, *rsx, *rsy, *ix, *iy;  // [P, X1, Y1], [P, X1], [P, Y1], [P, X1], [P, Y1]
  const T* trans;                         // [23]
  T* lp_end;                              // [P]
  int pairs, X1, Y1, groups;
};

template <typename T, int M, int NWMAX>
__global__ void __launch_bounds__(NWMAX * 32, 1) pppair_kernel(const Args<T> a) {
  __shared__ PfSmem<T, NWMAX> sm;
  const PpEntry e = a.table[blockIdx.x / a.groups];
  const int group = blockIdx.x % a.groups;
  const int tid = threadIdx.x, l0 = tid * M;
  const int X1 = a.X1, Y1 = a.Y1, r0 = int(e.r0), r1 = int(e.r1);
  const bool sys = e.sys != 0;
  const T* in_buf = reinterpret_cast<const T*>(e.in_buf);
  const int* in_flag = reinterpret_cast<const int*>(e.in_flag);
  T* out_buf = reinterpret_cast<T*>(e.out_buf);
  int* out_flag = reinterpret_cast<int*>(e.out_flag);
  setup<LogSum>(sm, a.trans);
  const Cols g{Y1, 0, Y1 - 1, Y1 == 1};
  int step = 0;  // the block's rows so far
  for (int p = group; p < a.pairs; p += a.groups) {
    const size_t pb = size_t(p);
    Lanes<T, M> st;
    if (in_buf == nullptr) {
      fill_neg(st);
    } else {
      if (tid == 0) wait_global(in_flag + p, 1, sys);
      __syncthreads();
      const T* row = in_buf + pb * 5 * Y1;
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const int l = l0 + k;
        const bool live = l < Y1;
        auto in = [&](int v) {
          return live ? ld_shared_value(row + size_t(v) * Y1 + l, sys) : T(kNeg);
        };
        st.imm[k] = in(0);
        st.imd[k] = in(1);
        st.idm[k] = in(2);
        st.imi[k] = in(3);
        st.iiw[k] = in(4);
      }
    }
    const T* absorb = a.absorb + pb * X1 * Y1;
    const T* rsx = a.rsx + pb * X1;
    const T* ix = a.ix + pb * X1;
    T ab[M], next[M];
    if (r0 < r1) load_row(next, absorb + size_t(r0) * Y1, l0, Y1);
    for (int i = r0; i < r1; ++i, ++step) {
#pragma unroll
      for (int k = 0; k < M; ++k) ab[k] = next[k];
      const RowX<T> x{LogSum::clamp(__ldg(rsx + i)), LogSum::clamp(__ldg(ix + i)), i == 0,
                      i < X1 - 1 || X1 == 1, ~0u};
      if (i + 1 < r1) load_row(next, absorb + size_t(i + 1) * Y1, l0, Y1);
      warp_row<Rules, T, M, NWMAX>(st, step, x, ab, a.rsy + pb * Y1, a.iy + pb * Y1, g, sm,
                                   GridEdge<Rules>{}, NoTail{});
    }
    if (out_buf != nullptr) {
      T* row = out_buf + pb * 5 * Y1;
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const int l = l0 + k;
        if (l < Y1) {
          row[l] = st.imm[k];
          row[size_t(Y1) + l] = st.imd[k];
          row[size_t(2) * Y1 + l] = st.idm[k];
          row[size_t(3) * Y1 + l] = st.imi[k];
          row[size_t(4) * Y1 + l] = st.iiw[k];
        }
      }
      __syncthreads();  // every warp has its last row out
      if (tid == 0) {
        if (sys) {
          __threadfence_system();
        } else {
          __threadfence();
        }
        st_release(out_flag + p, 1, sys);
      }
    } else {
      T lp;
      if (end_value<LogSum>(st, sm.tr, l0, Y1 - 1, lp)) a.lp_end[p] = lp;
    }
  }
}

template <typename T>
int launch(const void* table, int stages, const T* absorb, const T* rsx, const T* rsy,
           const T* ix, const T* iy, const T* trans, T* lp_end, int pairs, int X1, int Y1,
           int* groups, void* stream) {
  if (stages < 1 || pairs < 1 || X1 < 1 || Y1 < 1 || !groups) return int(cudaErrorInvalidValue);
  Args<T> a{static_cast<const PpEntry*>(table), absorb, rsx, rsy, ix, iy, trans, lp_end,
            pairs, X1, Y1, 1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch<T>(Y1, [&](auto nw, auto m) {
    constexpr int NWMAX = decltype(nw)::value, M = decltype(m)::value;
    const int threads = threads_for(Y1, M);
    auto kernel = pppair_kernel<T, M, NWMAX>;
    const int cap = capacity(kernel, threads);
    if (cap < stages) return int(cudaErrorCooperativeLaunchTooLarge);
    a.groups = cap / stages < pairs ? cap / stages : pairs;
    *groups = a.groups;
    void* args[] = {&a};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(kernel), dim3(stages * a.groups), dim3(threads), args, 0, s);
    return err ? int(err) : int(cudaGetLastError());
  });
}

}  // namespace

// table: `stages` PpEntry rows on the device (this card's stages, in
// order); absorb [P, X1, Y1], rsx and ix [P, X1], rsy and iy [P, Y1], trans
// [23] on the device (Y1 at most pairstep::kMaxCols); lp_end [P] is written
// by the last stage.  *groups gets the blocks a stage took (as many as fit
// resident beside the other stages, at most P).  Returns the launch's
// error.
extern "C" int pppairforward_f32(const void* table, int stages, const float* absorb,
                                 const float* rsx, const float* rsy, const float* ix,
                                 const float* iy, const float* trans, float* lp_end, int pairs,
                                 int X1, int Y1, int* groups, void* stream) {
  return launch<float>(table, stages, absorb, rsx, rsy, ix, iy, trans, lp_end, pairs, X1, Y1,
                       groups, stream);
}

extern "C" int pppairforward_f64(const void* table, int stages, const double* absorb,
                                 const double* rsx, const double* rsy, const double* ix,
                                 const double* iy, const double* trans, double* lp_end, int pairs,
                                 int X1, int Y1, int* groups, void* stream) {
  return launch<double>(table, stages, absorb, rsx, rsy, ix, iy, trans, lp_end, pairs, X1, Y1,
                        groups, stream);
}
