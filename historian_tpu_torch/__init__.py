"""historian-tpu on PyTorch and CUDA: the port of the JAX package.

The `recon -fast` path runs here on an NVIDIA Hopper card: the column
fills, the trace walk, the guide fill and the batched pair-Forward are
hand-written CUDA kernels (`csrc/`), the surrounding tensor code is
PyTorch, and the host data model (profiles, pair HMM, envelope, trees,
models, the native host fill) is this package's own copy of the JAX
package's host modules, under the same names.  Nothing in this package
imports jax or the JAX package.
"""

__version__ = "0.1.0"


def _tune_malloc() -> None:
    """Keep glibc from returning big numpy temporaries to the kernel.

    The host DP and profile code allocate multi-hundred-MB temporaries
    every merge.  With glibc defaults, allocations over the (dynamic,
    <=32MB) threshold are mmap'd and munmap'd on free, so every merge
    re-faults its pages.  Raising M_MMAP_THRESHOLD and M_TRIM_THRESHOLD
    keeps freed blocks on the heap for reuse; the process RSS stays at its
    high-water mark.  Disable with HISTORIAN_MALLOC=0.
    """
    import os

    if os.environ.get("HISTORIAN_MALLOC", "1") == "0":
        return
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        m_trim_threshold, m_top_pad, m_mmap_threshold = -1, -2, -3
        libc.mallopt(m_mmap_threshold, 1 << 30)
        libc.mallopt(m_trim_threshold, 1 << 30)
        libc.mallopt(m_top_pad, 1 << 24)
    except Exception:
        pass  # non-glibc platform: defaults stand


_tune_malloc()
