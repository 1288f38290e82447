"""Sampling warps, MIS heuristics, and the 1D CDF distribution as tensor
ops, and the 2D marginal/conditional distribution the environment light
samples.  All functions broadcast over leading batch dims.
"""

import math
from typing import NamedTuple

import torch

from ..constants import (
    INV_2PI, INV_4PI, INV_PI, ONE_MINUS_EPSILON, PI, PI_OVER_2, PI_OVER_4,
)


# ---------------------------------------------------------------------------
# Warps
# ---------------------------------------------------------------------------

def uniform_sample_hemisphere(u):
    z = u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_hemisphere_pdf():
    return INV_2PI


def uniform_sample_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sphere_pdf():
    return INV_4PI


def concentric_sample_disk(u):
    """Shirley-Chiu concentric disk warp."""
    u_offset = 2.0 * u - 1.0
    ux, uy = u_offset[..., 0], u_offset[..., 1]
    zero = (ux == 0.0) & (uy == 0.0)
    use_x = torch.abs(ux) > torch.abs(uy)
    r = torch.where(use_x, ux, uy)
    # guard divisions for the degenerate origin lane
    safe_ux = torch.where(ux == 0.0, 1.0, ux)
    safe_uy = torch.where(uy == 0.0, 1.0, uy)
    theta = torch.where(
        use_x,
        PI_OVER_4 * (uy / safe_ux),
        PI_OVER_2 - PI_OVER_4 * (ux / safe_uy),
    )
    p = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return torch.where(zero[..., None], 0.0, p)


def cosine_sample_hemisphere(u):
    d = concentric_sample_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def uniform_sample_cone(u, cos_theta_max):
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = u[..., 1] * 2.0 * PI
    return torch.stack(
        [torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta],
        dim=-1)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * PI * (1.0 - cos_theta_max))


def uniform_sample_triangle(u):
    """Barycentric warp (pbrt UniformSampleTriangle)."""
    su0 = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - su0, u[..., 1] * su0], dim=-1)


# ---------------------------------------------------------------------------
# MIS heuristics
# ---------------------------------------------------------------------------

def balance_heuristic(nf, f_pdf, ng, g_pdf):
    return (nf * f_pdf) / (nf * f_pdf + ng * g_pdf)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    return torch.where(denom > 0.0,
                       f * f / torch.where(denom > 0.0, denom, 1.0), 0.0)


# ---------------------------------------------------------------------------
# Distribution1D as CDF tensors
# ---------------------------------------------------------------------------

class Distribution1D(NamedTuple):
    """Piecewise-constant 1D distribution.

    func:     (..., N)   unnormalized function values
    cdf:      (..., N+1) normalized CDF, cdf[..., 0]=0, cdf[..., -1]=1
    func_int: (...)      integral of func over [0,1]
    """

    func: torch.Tensor
    cdf: torch.Tensor
    func_int: torch.Tensor

    @property
    def count(self):
        return self.func.shape[-1]


def make_distribution1d(func, device=None):
    func = torch.as_tensor(func, dtype=torch.float32, device=device)
    n = func.shape[-1]
    cdf = torch.cumsum(func, dim=-1) / n
    func_int = cdf[..., -1]
    zero = (func_int == 0.0)[..., None]
    # Degenerate all-zero function -> uniform CDF, as the reference does.
    uniform = torch.arange(1, n + 1, dtype=torch.float32,
                           device=func.device) / n
    norm = torch.where(zero, uniform,
                       cdf / torch.where(zero, 1.0, func_int[..., None]))
    cdf_full = torch.cat([torch.zeros_like(norm[..., :1]), norm], dim=-1)
    return Distribution1D(func, cdf_full, func_int)


def _find_interval(cdf, u):
    """Index i with cdf[i] <= u < cdf[i+1]; vectorized FindInterval."""
    if cdf.ndim == 1 and cdf.shape[-1] <= 2048:
        # compare-count == side='right' insertion point
        idx = torch.sum((cdf <= u[..., None]).to(torch.int64), dim=-1) - 1
    else:
        idx = torch.searchsorted(cdf, u.contiguous(), right=True) - 1
    return torch.clamp(idx, 0, cdf.shape[-1] - 2)


def sample_continuous_1d(dist: Distribution1D, u):
    """Returns (x in [0,1), pdf, offset). Batched over u's leading dims."""
    offset = _find_interval(dist.cdf, u)
    c_lo = dist.cdf[offset]
    c_hi = dist.cdf[offset + 1]
    du = u - c_lo
    width = c_hi - c_lo
    du = torch.where(width > 0.0, du / torch.where(width > 0.0, width, 1.0), du)
    f = dist.func[offset]
    pdf = torch.where(dist.func_int > 0.0, f / dist.func_int, 0.0)
    x = (offset.to(torch.float32) + du) / dist.count
    return x, pdf, offset


def sample_discrete_1d(dist: Distribution1D, u):
    """Returns (index, pmf, remapped u)."""
    offset = _find_interval(dist.cdf, u)
    f = dist.func[offset]
    pmf = torch.where(dist.func_int > 0.0, f / (dist.func_int * dist.count), 0.0)
    c_lo = dist.cdf[offset]
    c_hi = dist.cdf[offset + 1]
    width = c_hi - c_lo
    u_remapped = torch.where(
        width > 0.0, (u - c_lo) / torch.where(width > 0.0, width, 1.0), u)
    u_remapped = torch.clamp(u_remapped, max=ONE_MINUS_EPSILON)
    return offset, pmf, u_remapped


def discrete_pdf_1d(dist: Distribution1D, index):
    return dist.func[index] / (dist.func_int * dist.count)


# ---------------------------------------------------------------------------
# Distribution2D
# ---------------------------------------------------------------------------

class Distribution2D(NamedTuple):
    """2D marginal/conditional distribution.

    cond_func: (H, W)    conditional p(u|v) rows
    cond_cdf:  (H, W+1)
    cond_int:  (H,)      per-row integrals
    marg_cdf:  (H+1,)
    marg_int:  ()        total integral
    cond_inv:  always None here.  The JAX package can carry an inverse-CDF
               jump table that shortens its bisection on the TPU; a
               searchsorted per row gives the same indices, so the field is
               kept only for the tables to match by name.
    """

    cond_func: torch.Tensor
    cond_cdf: torch.Tensor
    cond_int: torch.Tensor
    marg_cdf: torch.Tensor
    marg_int: torch.Tensor
    cond_inv: object = None

    @property
    def shape(self):
        return self.cond_func.shape


def make_distribution2d(func, device=None):
    func = torch.as_tensor(func, dtype=torch.float32, device=device)
    cond = make_distribution1d(func)  # batched over rows
    marg = make_distribution1d(cond.func_int)
    return Distribution2D(cond.func, cond.cdf, cond.func_int, marg.cdf,
                          marg.func_int)


def _row_searchsorted(cdf2d, rows, u):
    """Per-lane searchsorted(cdf2d[rows[i]], u[i], side='right') - 1 without
    materializing per-lane CDF rows (an (N, W+1) gather): a bisection over
    the flat table, ceil(log2(W+1)) scalar gathers per lane."""
    w1 = cdf2d.shape[-1]
    flat = cdf2d.reshape(-1)
    base = rows.to(torch.int64) * w1
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, w1)
    # invariant: cdf[lo] <= u (cdf[0] == 0 <= u) and (hi == w1 or cdf[hi] > u)
    for _ in range(int(math.ceil(math.log2(max(w1, 2))))):
        done = (hi - lo) <= 1
        mid = (lo + hi) >> 1
        v = flat[base + torch.clamp(mid, 0, w1 - 1)]
        go_right = (v <= u) & ~done
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(~go_right & ~done, mid, hi)
    return lo


def sample_continuous_2d_idx(dist: Distribution2D, u):
    """u: (..., 2) -> ((..., 2) point in [0,1)^2, iv, iu) WITHOUT the pdf
    func gather: the sampled integer texel (iv, iu) lets callers holding a
    packed [payload, func/marg_int] table serve the pdf AND their payload
    (e.g. env radiance) from ONE per-lane row gather."""
    h, w = dist.shape
    marg = Distribution1D(dist.cond_int, dist.marg_cdf, dist.marg_int)
    d1, _pdf1, v_idx = sample_continuous_1d(marg, u[..., 1])
    u0 = u[..., 0]
    idx = torch.clamp(_row_searchsorted(dist.cond_cdf, v_idx, u0), 0, w - 1)
    w1 = dist.cond_cdf.shape[-1]
    cdf_flat = dist.cond_cdf.reshape(-1)
    base = v_idx.to(torch.int64) * w1
    c_lo = cdf_flat[base + idx]
    c_hi = cdf_flat[base + idx + 1]
    width = c_hi - c_lo
    du = torch.where(width > 0.0,
                     (u0 - c_lo) / torch.where(width > 0.0, width, 1.0),
                     u0 - c_lo)
    d0 = (idx.to(torch.float32) + du) / w
    return (torch.stack([d0, d1], dim=-1), v_idx.to(torch.int32),
            idx.to(torch.int32))


def sample_continuous_2d(dist: Distribution2D, u):
    """u: (..., 2) -> ((..., 2) point in [0,1)^2, pdf).  The pdf is the
    conditional's times the marginal's, each computed once, here."""
    h, w = dist.shape
    p, v_idx, idx = sample_continuous_2d_idx(dist, u)
    vi = v_idx.to(torch.int64)
    cond_int = dist.cond_int[vi]
    f = dist.cond_func.reshape(-1)[vi * w + idx.to(torch.int64)]
    pdf0 = torch.where(cond_int > 0.0,
                       f / torch.where(cond_int > 0.0, cond_int, 1.0), 0.0)
    pdf1 = torch.where(dist.marg_int > 0.0, cond_int / dist.marg_int, 0.0)
    return p, pdf0 * pdf1


def pdf_2d(dist: Distribution2D, p):
    """PDF of a point p in [0,1)^2 w.r.t. the 2D distribution."""
    h, w = dist.shape
    iu = torch.clamp((p[..., 0] * w).to(torch.int64), 0, w - 1)
    iv = torch.clamp((p[..., 1] * h).to(torch.int64), 0, h - 1)
    return dist.cond_func[iv, iu] / dist.marg_int
