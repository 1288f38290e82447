"""Stateless wavefront samplers.

The sampler is a pure function  sample(pixel, sample_index, dim) -> u, so
any lane of any bounce can evaluate any dimension with no carried state.
Dimension assignment is static per bounce (see the integrators).

Kinds:
  * "random":  counter-based hash RNG (ops/rng.py).
  * "sobol":   Owen-scrambled padded Sobol' (ops/sobol.py).
  * "halton":  scrambled Halton global sampler (ops/lds.py): dims 0-1
               encode the pixel via CRT index offsets, dims >= 2 use the
               digit-permuted radical inverse in the dim-th prime base.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.stats import span, spanned
from . import lds, rng
from . import sobol as _sobol


class Sampler(NamedTuple):
    """Static metadata + device tables for Halton: pixel_offset is the
    (H*W,) table of per-pixel first-sample Halton indices (u32 words held in
    int64, see ops/rng.py); primes, prime_sums and perms are the int32 tables
    of ops/lds.py; stride / exp2 / scale3 per lds.halton_pixel_offsets.  The
    field names are those of the JAX package's Sampler; ``device`` is the
    port's addition."""
    kind: str
    spp: int
    seed: int
    pixel_offset: Optional[torch.Tensor] = None
    primes: Optional[torch.Tensor] = None
    prime_sums: Optional[torch.Tensor] = None
    perms: Optional[torch.Tensor] = None
    stride: int = 1
    exp2: int = 0
    scale3: int = 1
    device: str = "cuda"


def make_random_sampler(spp, seed=0, device="cuda"):
    return Sampler(kind="random", spp=spp, seed=seed,
                   device=str(resolve_device(device)))


def make_sobol_sampler(spp, seed=0, device="cuda"):
    """Owen-scrambled padded Sobol' sampler: global index = sample number;
    each (pixel, dim) pair gets an independent Owen scramble, so pixels
    decorrelate without per-pixel index offsets."""
    dev = resolve_device(device)
    _sobol.sobol_matrices()  # build/cache host-side
    return Sampler(kind="sobol", spp=spp, seed=seed, device=str(dev))


def halton_sampler_from_tables(spp, seed, pixel_offset, stride, exp2, scale3,
                               device="cuda"):
    """A Halton Sampler from its per-film table (host array) and metadata;
    the prime and permutation tables are the fixed ones of ops/lds.py."""
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.asarray(a).astype(dtype)).to(dev)

    return Sampler(
        kind="halton", spp=int(spp), seed=int(seed),
        pixel_offset=put(np.asarray(pixel_offset).reshape(-1), np.int64),
        primes=put(lds.primes(), np.int32),
        prime_sums=put(lds.prime_sums(), np.int32),
        perms=put(lds.radical_inverse_permutations(), np.int32),
        stride=int(stride), exp2=int(exp2), scale3=int(scale3),
        device=str(dev))


@spanned("sampler.tables")
def make_halton_sampler(spp, width, height, seed=0, device="cuda"):
    resolve_device(device)  # refuse a missing device before building tables
    offsets, meta = lds.halton_pixel_offsets(width, height)
    return halton_sampler_from_tables(
        spp, seed, offsets, meta["stride"], meta["exponents"][0],
        meta["scales"][1], device=device)


def global_index(s: Sampler, pixel, sample):
    """Global sample index for (pixel, sample) lanes (u32 in int64)."""
    if s.kind == "halton":
        return (s.pixel_offset[pixel.long()]
                + rng.as_u32(sample) * s.stride) & rng.MASK32
    return rng.as_u32(sample)


def _sobol_dims(s: Sampler, pixel, sample, base: int, k: int):
    mats = _sobol.matrices_tensor(pixel.device, _sobol.N_DIMS)[base:base + k]
    v = _sobol.sobol_u32(mats, rng.as_u32(sample))
    dims = torch.arange(base, base + k, dtype=torch.int64, device=pixel.device)
    seeds = rng.hash_combine(pixel[:, None], dims[None, :], s.seed)
    return _sobol.to_unit_float(_sobol.owen_scramble(v, seeds))


def sample_dim(s: Sampler, pixel, sample, dim: int):
    """Evaluate static dimension `dim` for each lane.

    pixel: (N,) int32 flat pixel ids; sample: (N,) int32 sample index.
    Returns (N,) float32 in [0, 1)."""
    if s.kind == "random":
        return rng.uniform_float(pixel, sample, int(dim), s.seed)
    if s.kind == "sobol":
        return _sobol_dims(s, pixel, sample, int(dim), 1)[:, 0]
    if s.kind != "halton":
        raise ValueError(f"unknown sampler kind {s.kind!r}")
    # the generic path: bases and permutations come from the device tables
    # (32 digit steps gathering from the flat permutation table).  The
    # integrators go through static_dim_fn instead.
    idx = global_index(s, pixel, sample)
    dim = int(dim)
    if dim == 0:
        return lds.radical_inverse_base2(idx >> s.exp2)
    if dim == 1:
        return lds.radical_inverse(
            3, torch.div(idx, s.scale3, rounding_mode="floor"))
    d = min(max(dim, 2), 999)
    return lds.scrambled_radical_inverse(s.primes[d], idx, s.perms,
                                         s.prime_sums[d])


def sample_2d(s: Sampler, pixel, sample, dim: int):
    return torch.stack(
        [sample_dim(s, pixel, sample, dim), sample_dim(s, pixel, sample, dim + 1)],
        dim=-1)


@spanned("sampler")
def sample_bounce_dims(s: Sampler, pixel, sample, base: int, k: int,
                       max_dims: int):
    """k consecutive dims starting at `base` for every lane, as (N, k).
    Same values as sample_all_dims(...)[:, base:base+k], without the
    (N, D) matrix in device memory."""
    return _bounce_dims(s, pixel, sample, base, k, max_dims)


def _bounce_dims(s, pixel, sample, base, k, max_dims):
    base = int(base)
    if base + k > max_dims:
        raise ValueError(f"dims {base}..{base + k} exceed max_dims={max_dims}")
    if s.kind == "random":
        dims = torch.arange(base, base + k, dtype=torch.int64,
                            device=pixel.device)
        return rng.uniform_float(pixel[:, None], sample[:, None],
                                 dims[None, :], s.seed)
    if s.kind == "sobol":
        return _sobol_dims(s, pixel, sample, base, k)
    raise ValueError(f"in-loop dims unsupported for sampler kind {s.kind!r}")


@spanned("sampler")
def sample_all_dims(s: Sampler, pixel, sample, n_dims: int):
    """ALL dimensions for a wavefront as one (N, n_dims) tensor.  Every
    Halton column has a static dim, so it runs a static-base digit loop
    (4-18 steps) over a tiny permutation slice."""
    if s.kind in ("random", "sobol"):
        return _bounce_dims(s, pixel, sample, 0, n_dims, n_dims)
    col = static_dim_fn(s, pixel, sample)
    return torch.stack([col(d) for d in range(n_dims)], dim=-1)


def supports_inloop_dims(s: Sampler) -> bool:
    """True when per-bounce dims can be computed inside the bounce loop
    (sobol/random); Halton precomputes the full (N, D) matrix instead."""
    return s.kind in ("sobol", "random")


def static_dim_fn(s: Sampler, pixel, sample):
    """col(d) evaluating STATIC dimension d for every lane by the cheapest
    path of the sampler kind.  For Halton this is the host-table static-base
    digit loop (same values as sample_all_dims' columns); sample_dim's
    generic Halton path for dims >= 2 runs 32 steps gathering from the
    3.7M-entry device permutation table per digit."""
    if s.kind != "halton":
        return lambda d: sample_dim(s, pixel, sample, d)
    host_primes = lds.primes()
    host_sums = lds.prime_sums()
    host_perms = lds.radical_inverse_permutations()
    idx = global_index(s, pixel, sample)

    def col(d):
        if d == 0:
            return lds.radical_inverse_base2(idx >> s.exp2)
        if d == 1:
            return lds.radical_inverse_static(
                3, torch.div(idx, s.scale3, rounding_mode="floor"))
        base = int(host_primes[d])
        off = int(host_sums[d])
        return lds.scrambled_radical_inverse_static(
            base, idx, host_perms[off: off + base])
    return col


def camera_sample(s: Sampler, pixel, sample, width, pixel_filter="box",
                  filter_radius=2.0, filter_alpha=2.0):
    """Camera sample: dims 0-1 film jitter, dim 2 time, dims 3-4 lens.

    pixel_filter "box" (uniform jitter in the pixel) or "gaussian":
    filter-importance-sampled truncated Gaussian around the pixel center.

    Returns (p_film (N,2) raster coords, time (N,), p_lens (N,2))."""
    px = (pixel % width).to(torch.float32)
    py = torch.div(pixel, width, rounding_mode="floor").to(torch.float32)
    with span("sampler"):
        if supports_inloop_dims(s):
            u = _bounce_dims(s, pixel, sample, 0, 5, 5)
        else:
            col = static_dim_fn(s, pixel, sample)
            u = torch.stack([col(d) for d in range(5)], dim=-1)
    jitter = u[:, 0:2]
    if pixel_filter == "gaussian":
        sigma = 1.0 / (2.0 * filter_alpha) ** 0.5
        r = filter_radius
        normal = torch.distributions.Normal(0.0, 1.0)
        # inverse-CDF sampling of the truncated normal on [-r, r]
        lo = float(normal.cdf(torch.tensor(-r / sigma)))
        hi = float(normal.cdf(torch.tensor(r / sigma)))
        uu = lo + jitter * (hi - lo)
        offset = sigma * (2.0 ** 0.5) * torch.erfinv(2.0 * uu - 1.0)
        jitter = 0.5 + offset
    p_film = torch.stack([px, py], dim=-1) + jitter
    return p_film, u[:, 2], u[:, 3:5]
