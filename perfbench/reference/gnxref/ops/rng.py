"""Stateless, counter-based random numbers for wavefront rendering.

Every (pixel, sample, dim) triple maps to an independent uniform through a
PCG-output-style integer hash (Jarzynski & Olano 2020, "Hash Functions for
GPU Rendering"), so any lane can draw any dimension with no carried state.

PyTorch has next to no uint32 operators, so a 32-bit word lives in an int64
tensor whose value is kept in [0, 2^32): products are taken so that they
cannot leave int64, then masked; a right shift of a non-negative int64 is
already logical.  The results are bit-equal to the JAX package's uint32
arithmetic.
"""

import torch

from ..constants import ONE_MINUS_EPSILON

MASK32 = 0xFFFFFFFF


def as_u32(x, device=None):
    """Tensor or Python int -> int64 tensor holding the value mod 2^32
    (what ``astype(uint32)`` does to an int32)."""
    if not torch.is_tensor(x):
        x = torch.tensor(int(x), dtype=torch.int64, device=device)
    return x.to(torch.int64) & MASK32


def mul32(x, c: int):
    """(x * c) mod 2^32 for a u32-in-int64 tensor x and a constant c < 2^32.
    c >= 2^31 is replaced by c - 2^32 (the same residue), which keeps the
    product's magnitude below 2^63."""
    if c >= 1 << 31:
        c -= 1 << 32
    return (x * c) & MASK32


def _pcg_hash(x):
    """One round of a PCG-style 32-bit hash. x: u32 in int64."""
    state = (mul32(x, 747796405) + 2891336453) & MASK32
    word = mul32((state >> ((state >> 28) + 4)) ^ state, 277803737)
    return (word >> 22) ^ word


def hash_combine(*xs):
    """Hash a tuple of integer tensors / Python ints into one u32 tensor."""
    device = next((x.device for x in xs if torch.is_tensor(x)), None)
    h = torch.tensor(0x9E3779B9, dtype=torch.int64, device=device)
    for x in xs:
        h = _pcg_hash(h ^ as_u32(x, device))
    return h


def uniform_u32(pixel, sample, dim, seed=0):
    """u32 uniform for a (pixel, sample, dim) counter triple."""
    return hash_combine(pixel, sample, dim, seed)


def uniform_float(pixel, sample, dim, seed=0):
    """float32 uniform in [0, 1) for a counter triple (broadcasting)."""
    u = uniform_u32(pixel, sample, dim, seed)
    # 24 high bits -> [0,1) exactly representable in float32
    f = (u >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.clamp(f, max=ONE_MINUS_EPSILON)


def uniform_float2(pixel, sample, dim, seed=0):
    """Two consecutive dims as an (..., 2) tensor."""
    return torch.stack(
        [uniform_float(pixel, sample, dim, seed),
         uniform_float(pixel, sample, dim + 1, seed)], dim=-1)
