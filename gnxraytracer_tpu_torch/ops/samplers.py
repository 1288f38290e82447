"""Stateless wavefront samplers.

The sampler is a pure function  sample(pixel, sample_index, dim) -> u, so
any lane of any bounce can evaluate any dimension with no carried state.
Dimension assignment is static per bounce (see the integrators).

Kinds:
  * "random":  counter-based hash RNG (ops/rng.py).
  * "sobol":   Owen-scrambled padded Sobol' (ops/sobol.py).
  * "halton":  not ported yet; ``make_halton_sampler`` raises.
"""

from typing import NamedTuple, Optional

import torch

from ..utils.device import resolve_device
from . import rng
from . import sobol as _sobol


class Sampler(NamedTuple):
    """Static metadata (+ device tables for Halton, unused so far).  The
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


def make_halton_sampler(spp, width, height, seed=0, device="cuda"):
    raise NotImplementedError(
        "the Halton sampler is not ported yet; use make_sobol_sampler "
        "(CLI: --sampler sobol)")


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
    raise NotImplementedError(f"sampler kind {s.kind!r} is not ported yet")


def sample_2d(s: Sampler, pixel, sample, dim: int):
    return torch.stack(
        [sample_dim(s, pixel, sample, dim), sample_dim(s, pixel, sample, dim + 1)],
        dim=-1)


def sample_bounce_dims(s: Sampler, pixel, sample, base: int, k: int,
                       max_dims: int):
    """k consecutive dims starting at `base` for every lane, as (N, k).
    Same values as sample_all_dims(...)[:, base:base+k], without the
    (N, D) matrix in device memory."""
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


def sample_all_dims(s: Sampler, pixel, sample, n_dims: int):
    """ALL dimensions for a wavefront as one (N, n_dims) tensor."""
    if s.kind not in ("random", "sobol"):
        raise NotImplementedError(f"sampler kind {s.kind!r} is not ported yet")
    return sample_bounce_dims(s, pixel, sample, 0, n_dims, n_dims)


def supports_inloop_dims(s: Sampler) -> bool:
    """True when per-bounce dims can be computed inside the bounce loop
    (sobol/random); Halton precomputes the full (N, D) matrix instead."""
    return s.kind in ("sobol", "random")


def camera_sample(s: Sampler, pixel, sample, width, pixel_filter="box",
                  filter_radius=2.0, filter_alpha=2.0):
    """Camera sample: dims 0-1 film jitter, dim 2 time, dims 3-4 lens.

    pixel_filter "box" (uniform jitter in the pixel) or "gaussian":
    filter-importance-sampled truncated Gaussian around the pixel center.

    Returns (p_film (N,2) raster coords, time (N,), p_lens (N,2))."""
    px = (pixel % width).to(torch.float32)
    py = torch.div(pixel, width, rounding_mode="floor").to(torch.float32)
    u = sample_bounce_dims(s, pixel, sample, 0, 5, 5)
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
