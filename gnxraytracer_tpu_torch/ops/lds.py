"""Low-discrepancy helpers the Sobol' sampler needs: the host-side PCG32
stream (bit-for-bit the reference renderer's generator, which seeds the
Sobol' direction numbers) and the 32-bit bit reversal.  The Halton tables
and radical inverses of the JAX package's ops/lds.py are not ported yet.
"""

from .rng import MASK32


class PCG32:
    """Host-side PCG32 with the default state and stream."""

    MULT = 0x5851F42D4C957F2D
    DEFAULT_STATE = 0x853C49E6748FEA9B
    DEFAULT_STREAM = 0xDA3E39CB94B95BDB
    MASK64 = (1 << 64) - 1

    def __init__(self):
        self.state = self.DEFAULT_STATE
        self.inc = self.DEFAULT_STREAM

    def uniform_u32(self):
        oldstate = self.state
        self.state = (oldstate * self.MULT + self.inc) & self.MASK64
        xorshifted = (((oldstate >> 18) ^ oldstate) >> 27) & 0xFFFFFFFF
        rot = oldstate >> 59
        return ((xorshifted >> rot) | (xorshifted << ((~rot + 1) & 31))) & 0xFFFFFFFF

    def uniform_u32_bounded(self, b):
        threshold = (0x100000000 - b) % b
        while True:
            r = self.uniform_u32()
            if r >= threshold:
                return r % b


def reverse_bits_32(n):
    """Bit reversal of a u32 held in an int64 tensor (see ops/rng.py)."""
    n = ((n << 16) & MASK32) | (n >> 16)
    n = ((n & 0x00FF00FF) << 8) | ((n & 0xFF00FF00) >> 8)
    n = ((n & 0x0F0F0F0F) << 4) | ((n & 0xF0F0F0F0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xCCCCCCCC) >> 2)
    n = ((n & 0x55555555) << 1) | ((n & 0xAAAAAAAA) >> 1)
    return n
