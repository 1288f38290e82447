"""Low-discrepancy sequences: vectorized Halton with scrambled radical
inverse, and the host-side PCG32 stream both the Halton permutations and the
Sobol' direction numbers are drawn from.

  * Digit permutations are generated host-side, once, with an exact PCG32
    replica of the reference renderer's default RNG stream, so the
    permutation tables are bit-identical to the reference's (and to the JAX
    package's).
  * The per-sample radical inverse is a fixed-trip-count digit loop over a
    whole ray wavefront.
  * The pixel -> first-sample-index offset (CRT with multiplicative
    inverses) is precomputed for the whole film as an (H, W) uint32 array.

A 32-bit word lives in an int64 tensor whose value is kept in [0, 2^32)
(see ops/rng.py); the float steps keep the JAX package's order of float32
operations, so every function here is bit-equal to its counterpart there.
Sample indices must stay below 2**27 so the scrambled digit accumulator
cannot overflow 32 bits.
"""

import functools
import os

import numpy as np
import torch

from ..constants import ONE_MINUS_EPSILON
from ..utils.stats import spanned
from .rng import MASK32, as_u32

K_MAX_RESOLUTION = 128
MAX_DIGITS = 32


# ---------------------------------------------------------------------------
# Host-side tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def primes(n=1000):
    """First n primes."""
    out = []
    candidate = 2
    while len(out) < n:
        if all(candidate % p for p in out if p * p <= candidate):
            out.append(candidate)
        candidate += 1
    return np.array(out, dtype=np.int32)


@functools.lru_cache(maxsize=1)
def prime_sums(n=1000):
    """Exclusive prefix sums of the primes."""
    p = primes(n)
    return np.concatenate([[0], np.cumsum(p)[:-1]]).astype(np.int64)


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


def permutations_python(p):
    """The digit permutations of the primes `p`, one after the other in a
    flat int32 array: the default-seeded PCG32 shuffling each identity
    permutation in turn (for i: swap(i, i + rng(count - i)))."""
    p = np.asarray(p, np.int64)
    sums = np.concatenate([[0], np.cumsum(p)[:-1]])
    perms = np.zeros(int(p.sum()), dtype=np.int32)
    rng = PCG32()
    for i in range(len(p)):
        n = int(p[i])
        arr = np.arange(n, dtype=np.int32)
        for j in range(n):
            other = j + rng.uniform_u32_bounded(n - j)
            arr[j], arr[other] = arr[other], arr[j]
        perms[sums[i]: sums[i] + n] = arr
    return perms


@functools.lru_cache(maxsize=1)
@spanned("sampler.tables")
def radical_inverse_permutations():
    """Flat per-prime digit permutation table of the first 1000 primes.

    Built by the native library (native/bvh_builder.cpp) or, without a C++
    compiler, by the pure-Python shuffle; the table is deterministic, so it
    is cached in the package's build directory after the first build."""
    from ..kernels.build import BUILD_DIR

    path = os.path.join(BUILD_DIR, "halton_perms_v1.npy")
    if os.path.exists(path):
        return np.load(path)
    from ..native import halton_permutations

    try:
        perms = halton_permutations(primes())
    except FileNotFoundError:  # no g++ to build the library with
        perms = permutations_python(primes())
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, perms)
    os.replace(tmp, path)  # atomic: a concurrent reader sees all or nothing
    return perms


def _mult_inverse(a, n):
    """Multiplicative inverse of a mod n."""
    def ext_gcd(a, b):
        if b == 0:
            return 1, 0
        xp, yp = ext_gcd(b, a % b)
        d = a // b
        return yp, xp - d * yp
    x, _ = ext_gcd(a, n)
    return x % n


def halton_pixel_offsets(width, height):
    """(H, W) uint32 array of first-sample Halton indices per pixel, and the
    stride / scales / exponents that go with it: CRT over base-2/base-3
    scales covering min(res, 128)."""
    scales, exps = [], []
    for i, base in enumerate((2, 3)):
        res = (width, height)[i]
        scale, e = 1, 0
        while scale < min(res, K_MAX_RESOLUTION):
            scale *= base
            e += 1
        scales.append(scale)
        exps.append(e)
    stride = scales[0] * scales[1]
    mult_inv = [_mult_inverse(scales[1], scales[0]),
                _mult_inverse(scales[0], scales[1])]

    def inverse_radical_inverse(base, inverse, n_digits):
        index = np.zeros_like(inverse)
        for _ in range(n_digits):
            digit = inverse % base
            inverse = inverse // base
            index = index * base + digit
        return index

    xs = np.arange(width, dtype=np.int64) % K_MAX_RESOLUTION
    ys = np.arange(height, dtype=np.int64) % K_MAX_RESOLUTION
    dim_off_x = inverse_radical_inverse(2, xs, exps[0])  # (W,)
    dim_off_y = inverse_radical_inverse(3, ys, exps[1])  # (H,)
    off = (
        dim_off_x[None, :] * (stride // scales[0]) * mult_inv[0]
        + dim_off_y[:, None] * (stride // scales[1]) * mult_inv[1]
    ) % stride
    meta = dict(stride=stride, scales=tuple(scales), exponents=tuple(exps))
    return off.astype(np.uint32), meta


# ---------------------------------------------------------------------------
# Device-side sample evaluation
# ---------------------------------------------------------------------------

def reverse_bits_32(n):
    """Bit reversal of a u32 held in an int64 tensor (see ops/rng.py)."""
    n = ((n << 16) & MASK32) | (n >> 16)
    n = ((n & 0x00FF00FF) << 8) | ((n & 0xFF00FF00) >> 8)
    n = ((n & 0x0F0F0F0F) << 4) | ((n & 0xF0F0F0F0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xCCCCCCCC) >> 2)
    n = ((n & 0x55555555) << 1) | ((n & 0xAAAAAAAA) >> 1)
    return n


def _finish(x):
    return torch.clamp(x, max=ONE_MINUS_EPSILON)


def radical_inverse_base2(a):
    """Base-2 radical inverse of a u32 index: bit reversal at 32 bits,
    scaled by 2^-32."""
    rev = reverse_bits_32(as_u32(a))
    return _finish(rev.to(torch.float32) * 2.3283064365386963e-10)


def _n_digits(base: int):
    return int(np.ceil(32.0 / np.log2(base)))


def _digit_loop(a, base, n_steps, inv_base, pdigit_of=None):
    """The masked digit loop all radical inverses share.  a: u32-in-int64
    tensor; base: Python int or int64 tensor; inv_base: float32 scalar or
    tensor; pdigit_of maps a digit tensor to its permuted digit.  Returns
    (reversed digits as u32-in-int64, inv_base ** digits as float32)."""
    shape = torch.broadcast_shapes(
        a.shape, base.shape if torch.is_tensor(base) else ())
    rev = torch.zeros(shape, dtype=torch.int64, device=a.device)
    ibn = torch.ones(shape, dtype=torch.float32, device=a.device)
    for _ in range(n_steps):
        active = a > 0
        nxt = torch.div(a, base, rounding_mode="floor")
        digit = a - nxt * base
        if pdigit_of is not None:
            digit = pdigit_of(digit)
        # the product wraps at 32 bits, as the uint32 arithmetic does
        rev = torch.where(active, (rev * base + digit) & MASK32, rev)
        ibn = torch.where(active, ibn * inv_base, ibn)
        a = nxt
    return rev, ibn


def radical_inverse(base, a):
    """General-base radical inverse; `base` may be a tensor of bases (one
    per lane).  Fixed 32-iteration digit loop with masked updates."""
    a = as_u32(a)
    if torch.is_tensor(base):
        base = as_u32(base)
        inv_base = 1.0 / base.to(torch.float32)
    else:
        base = int(base)
        inv_base = 1.0 / torch.tensor(float(base), dtype=torch.float32,
                                      device=a.device)
    rev, ibn = _digit_loop(a, base, MAX_DIGITS, inv_base)
    return _finish(rev.to(torch.float32) * ibn)


def radical_inverse_static(base: int, a):
    """Radical inverse with a static (Python int) base: the digit loop runs
    exactly ceil(32 / log2(base)) iterations, e.g. 4 for base 389, and
    involves no tables."""
    a = as_u32(a)
    inv_base = float(np.float32(1.0 / base))
    rev, ibn = _digit_loop(a, int(base), _n_digits(base), inv_base)
    return _finish(rev.to(torch.float32) * ibn)


@functools.lru_cache(maxsize=4096)
def _perm_on(device_str, perm_bytes):
    perm = np.frombuffer(perm_bytes, np.int32).astype(np.int64)
    return torch.from_numpy(perm).to(device_str)


def scrambled_radical_inverse_static(base: int, a, perm):
    """Scrambled radical inverse with static base and its (base,) perm
    slice (host array): the digit permutation is a gather into that tiny
    table, not into the flat table of all primes."""
    a = as_u32(a)
    base = int(base)
    perm = np.ascontiguousarray(np.asarray(perm), np.int32)
    table = _perm_on(str(a.device), perm.tobytes())
    inv_base = np.float32(1.0 / base)
    rev, ibn = _digit_loop(a, base, _n_digits(base), float(inv_base),
                           pdigit_of=lambda digit: table[digit])
    # the infinite tail of permuted zero digits, in the float32 steps of the
    # JAX package's expression inv_base * perm0 / (1.0 - inv_base)
    tail = float(np.float32(inv_base * np.float32(perm[0]))
                 / np.float32(1.0 - inv_base))
    return _finish(ibn * (rev.to(torch.float32) + tail))


def scrambled_radical_inverse(base, a, perm_table, perm_offset):
    """Scrambled radical inverse with per-lane bases.

    perm_table:  flat integer device tensor of all digit permutations
    perm_offset: offset of each lane's base's permutation (prime_sums[dim])
    """
    a = as_u32(a)
    base = as_u32(base, a.device)
    perm_offset = torch.as_tensor(perm_offset, device=a.device).to(torch.int64)
    inv_base = 1.0 / base.to(torch.float32)
    rev, ibn = _digit_loop(
        a, base, MAX_DIGITS, inv_base,
        pdigit_of=lambda digit: perm_table[perm_offset + digit].to(torch.int64))
    perm0 = perm_table[perm_offset].to(torch.float32)
    tail = inv_base * perm0 / (1.0 - inv_base)
    return _finish(ibn * (rev.to(torch.float32) + tail))
