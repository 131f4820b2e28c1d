"""Mersenne-twister RNG bit-compatible with C++ std::mt19937 (libstdc++).

The reference golden tests fix stochastic outputs by seeding std::mt19937
with its default seed 5489 (reference src/forward.h:49-50, the -seed
flag recon.cpp:745-748).  To let our stochastic tracebacks reproduce those
goldens we provide the same generator and the same libstdc++
uniform_real_distribution draw order (generate_canonical<double,53> = two
32-bit draws).  This is host-side control-flow code, not device code.
"""

from __future__ import annotations

DEFAULT_SEED = 5489

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER_MASK = 0x80000000
_LOWER_MASK = 0x7FFFFFFF
_MASK32 = 0xFFFFFFFF


class MT19937:
    """std::mt19937-compatible generator (32-bit output)."""

    def __init__(self, seed: int = DEFAULT_SEED):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        mt = [0] * _N
        mt[0] = seed & _MASK32
        for i in range(1, _N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) & _MASK32
        self.mt = mt
        self.mti = _N

    def _generate(self) -> None:
        mt = self.mt
        for i in range(_N):
            y = (mt[i] & _UPPER_MASK) | (mt[(i + 1) % _N] & _LOWER_MASK)
            mt[i] = mt[(i + _M) % _N] ^ (y >> 1) ^ (_MATRIX_A if y & 1 else 0)
        self.mti = 0

    def next_u32(self) -> int:
        if self.mti >= _N:
            self._generate()
        y = self.mt[self.mti]
        self.mti += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & _MASK32

    def uniform(self, a: float = 0.0, b: float = 1.0) -> float:
        """libstdc++ uniform_real_distribution<double>(a, b) draw.

        generate_canonical<double, 53, mt19937>: k = ceil(53/32) = 2 calls,
        accumulated low-word-first over the 2**32 radix, normalized.
        """
        r1 = self.next_u32()
        r2 = self.next_u32()
        ret = (r1 + r2 * 4294967296.0) / 18446744073709551616.0
        if ret >= 1.0:  # libstdc++ clamps to nextafter(1, 0)
            ret = 0.9999999999999999
        return a + ret * (b - a)

    def _numpy_twin(self):
        """A numpy.random.MT19937 in this generator's state."""
        import numpy as np

        bits = np.random.MT19937()
        bits.state = {"bit_generator": "MT19937",
                      "state": {"key": np.array(self.mt, dtype=np.uint32), "pos": self.mti}}
        return bits

    def uniforms_ahead(self, n: int):
        """The next n uniform() draws as a float64 array, bit for bit,
        without moving the generator (drawn in bulk by numpy's MT19937)."""
        import numpy as np

        raw = self._numpy_twin().random_raw(2 * n).astype(np.float64)
        ret = (raw[0::2] + raw[1::2] * 4294967296.0) / 18446744073709551616.0
        return np.where(ret >= 1.0, 0.9999999999999999, ret)

    def advance_uniforms(self, n: int) -> None:
        """Move the generator past n uniform() calls."""
        bits = self._numpy_twin()
        bits.random_raw(2 * n)
        state = bits.state["state"]
        self.mt = [int(v) for v in state["key"]]
        self.mti = int(state["pos"])
