"""Sobol' sequence: generator matrices built from scratch on the host, and
Owen-scrambled sampling on the device.

The matrices are generated from first principles:

  * primitive polynomials over GF(2) found by exhaustive search
    (irreducibility + order 2^d - 1),
  * initial direction numbers m_i (odd, < 2^i) drawn from the host PCG32
    stream (deterministic),
  * the standard recurrence m_k = XOR_j 2^j a_j m_{k-j} XOR m_{k-d}.

Per-pixel decorrelation is Owen scrambling through the Laine-Karras hash:
each (pixel, dim) pair gets an independent scramble of the global sequence.
32-bit words are held in int64 tensors (see ops/rng.py).
"""

import functools
import os

import numpy as np
import torch

from ..constants import ONE_MINUS_EPSILON
from ..utils.stats import spanned
from .lds import PCG32, reverse_bits_32
from .rng import MASK32, mul32

N_DIMS = 256
N_BITS = 32


# ---------------------------------------------------------------------------
# Host-side matrix generation
# ---------------------------------------------------------------------------

def _gf2_mod(a, m, dm):
    """a mod m over GF(2); dm = degree of m."""
    da = a.bit_length() - 1
    while da >= dm:
        a ^= m << (da - dm)
        da = a.bit_length() - 1
    return a


def _gf2_mulmod(a, b, m, dm):
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a = _gf2_mod(a << 1, m, dm)
    return _gf2_mod(r, m, dm)


def _x_pow_mod(e, m, dm):
    """x^e mod m over GF(2) by square-and-multiply."""
    result = 1
    base = 2  # the polynomial x
    while e:
        if e & 1:
            result = _gf2_mulmod(result, base, m, dm)
        base = _gf2_mulmod(base, base, m, dm)
        e >>= 1
    return result


def _prime_factors(n):
    fs = set()
    d = 2
    while d * d <= n:
        while n % d == 0:
            fs.add(d)
            n //= d
        d += 1
    if n > 1:
        fs.add(n)
    return fs


def _is_primitive(poly, d):
    """poly (degree d, bit i = coefficient of x^i) primitive over GF(2)?"""
    if not (poly & 1):
        return False
    order = (1 << d) - 1
    if _x_pow_mod(order, poly, d) != 1:
        return False
    return all(_x_pow_mod(order // p, poly, d) != 1
               for p in _prime_factors(order))


def build_matrices(n_dims):
    """(n_dims, 32) uint32 generator matrices, computed (no cache)."""
    mats = np.zeros((n_dims, N_BITS), np.uint32)
    # dim 0: van der Corput (identity matrix)
    for k in range(N_BITS):
        mats[0, k] = np.uint32(1 << (31 - k))

    rng = PCG32()
    dim = 1
    degree = 1
    while dim < n_dims:
        for rest in range(1 << degree):
            poly = (1 << degree) | rest
            if dim >= n_dims:
                break
            if not _is_primitive(poly, degree):
                continue
            d = degree
            # initial direction numbers: m_i odd, < 2^i (deterministic PCG)
            m = [0] * (N_BITS + 1)
            for i in range(1, d + 1):
                m[i] = (rng.uniform_u32() % (1 << i)) | 1
            # m_k = XOR_{j=1..d-1} a_j 2^j m_{k-j}  XOR  m_{k-d}  XOR 2^d m_{k-d}
            for k in range(d + 1, N_BITS + 1):
                acc = m[k - d] ^ (m[k - d] << d)
                for j in range(1, d):
                    if (poly >> (d - j)) & 1:
                        acc ^= m[k - j] << j
                m[k] = acc
            for k in range(1, N_BITS + 1):
                mats[dim, k - 1] = np.uint32((m[k] << (N_BITS - k)) & 0xFFFFFFFF)
            dim += 1
        degree += 1
        if degree > 20:
            raise RuntimeError("not enough primitive polynomials")
    return mats


@functools.lru_cache(maxsize=1)
@spanned("sampler.tables")
def sobol_matrices(n_dims=N_DIMS):
    """(n_dims, 32) uint32 generator matrices, cached on disk under
    ``.cache/`` beside the package after the first build."""
    cache = os.path.join(os.path.dirname(__file__), "..", "..", ".cache")
    path = os.path.join(cache, f"sobol_matrices_{n_dims}_v1.npy")
    if os.path.exists(path):
        return np.load(path)
    mats = build_matrices(n_dims)
    os.makedirs(cache, exist_ok=True)
    np.save(path, mats)
    return mats


@functools.lru_cache(maxsize=8)
def _matrices_on(device_str, n_dims):
    """The first n_dims generator matrices as an (n_dims, 32) int64 tensor
    on the device (uploaded once per device and width)."""
    mats = sobol_matrices()[:n_dims].astype(np.int64)
    return torch.from_numpy(mats).to(device_str)


def matrices_tensor(device, n_dims):
    return _matrices_on(str(device), int(n_dims))


# ---------------------------------------------------------------------------
# Device-side sampling
# ---------------------------------------------------------------------------

def sobol_u32(mats, index):
    """Unscrambled Sobol' words.  mats: (D, 32) int64 rows of generator
    matrices; index: (N,) u32-in-int64.  Returns (N, D)."""
    v = torch.zeros((index.shape[0], mats.shape[0]), dtype=torch.int64,
                    device=index.device)
    for k in range(N_BITS):
        bit = (index >> k) & 1
        # all-ones where the bit is set: XOR-select without a where
        v = v ^ (mats[None, :, k] & -bit[:, None])
    return v


def sobol_u32_static(dim: int, index):
    """Unscrambled Sobol' word of one static dimension, (N,)."""
    return sobol_u32(matrices_tensor(index.device, N_DIMS)[dim:dim + 1],
                     index)[:, 0]


def laine_karras_permutation(x, seed):
    """Owen-scramble hash in reversed-bit space (public LK hash)."""
    x = (x + seed) & MASK32
    x = x ^ mul32(x, 0x6C50B47C)
    x = x ^ mul32(x, 0xB82F1E52)
    x = x ^ mul32(x, 0xC7AFE638)
    x = x ^ mul32(x, 0x8D22F6E6)
    return x


def owen_scramble(u32, seed):
    """Owen scrambling of a radical-inverse-space value."""
    x = reverse_bits_32(u32)
    x = laine_karras_permutation(x, seed)
    return reverse_bits_32(x)


def to_unit_float(u32):
    # int64 -> float32 rounds to nearest, as a uint32 -> float32 cast does
    return torch.clamp(u32.to(torch.float32) * 2.3283064365386963e-10,
                       max=ONE_MINUS_EPSILON)
