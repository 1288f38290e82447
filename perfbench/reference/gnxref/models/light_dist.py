"""Light-selection distributions: "uniform" (1/nLights, handled in the
integrator), "power" (proportional to each light's power; the skybox reports
zero power and is excluded) and "spatial": a voxel grid over the scene's
bounding cube, each voxel with its own light CDF, estimated for every voxel
at once by Monte Carlo at scene set-up (``build_spatial_distribution``) and
looked up per lane by the position being shaded (``spatial_choose_light``).
"""

from typing import NamedTuple

import numpy as np
import torch

from ..constants import PI
from ..scene.scene import (
    LIGHT_AREA, LIGHT_DISTANT, LIGHT_INFINITE, LIGHT_POINT, LIGHT_SKYBOX,
    LIGHT_SPOT,
)
from ..utils.math import cross, length

_LUMINANCE = (0.212671, 0.715160, 0.072169)


def light_powers(scene):
    """Per-light power luminance."""
    L = scene.lights
    kind = L.kind
    lum_w = torch.tensor(_LUMINANCE, dtype=torch.float32, device=L.emit.device)
    lum = L.emit @ lum_w
    wr = scene.world_radius

    power = torch.zeros_like(lum)
    # point: 4 pi I
    power = torch.where(kind == LIGHT_POINT, 4.0 * PI * lum, power)
    # spot: I * 2 pi (1 - .5(cosFalloff + cosTotal))
    spot = lum * 2.0 * PI * (1.0 - 0.5 * (L.cos_falloff + L.cos_total))
    power = torch.where(kind == LIGHT_SPOT, spot, power)
    # distant: pi r^2 L
    power = torch.where(kind == LIGHT_DISTANT, PI * wr * wr * lum, power)
    # diffuse area light: (two_sided ? 2 : 1) * L * area * pi
    tri = scene.geom.triangles[torch.clamp(L.tri, min=0).long()].long()
    p0 = scene.geom.vertices[tri[:, 0]]
    p1 = scene.geom.vertices[tri[:, 1]]
    p2 = scene.geom.vertices[tri[:, 2]]
    area = 0.5 * length(cross(p1 - p0, p2 - p0))
    area_pow = torch.where(L.two_sided > 0.5, 2.0, 1.0) * lum * area * PI
    power = torch.where(kind == LIGHT_AREA, area_pow, power)
    # environment map: pi r^2 * mean radiance luminance
    if scene.env is not None:
        env_lum = torch.mean(scene.env.image @ lum_w)
        power = torch.where(kind == LIGHT_INFINITE, PI * wr * wr * env_lum,
                            power)
    # skybox: power 0 (excluded from power heuristics)
    power = torch.where(kind == LIGHT_SKYBOX, 0.0, power)
    return power


class SpatialLightDist(NamedTuple):
    """Dense voxel grid of per-voxel light CDFs."""
    cdf: torch.Tensor         # (V, L+1) per-voxel CDF
    pmf: torch.Tensor         # (V, L)
    res: tuple                # (nx, ny, nz)
    lo: torch.Tensor          # (3,) low corner of the grid in world space
    inv_extent: torch.Tensor  # (3,)


def build_spatial_distribution(scene, cfg, res=16, n_samples=64, seed=7):
    """Every voxel's light distribution: each light's unoccluded
    contribution (luminance of Li / pdf) averaged over n_samples jittered
    points of the voxel, each weight raised to at least 1% of the voxel's
    largest so that every light stays selectable (the estimator stays
    unbiased), normalized into a CDF.  Voxels where no light contributes
    take the uniform distribution."""
    from ..ops import rng
    from . import lights as lights_mod

    dev = scene.device
    nl = cfg.n_lights
    lo = scene.world_center - scene.world_radius
    extent = (scene.world_center + scene.world_radius) - lo
    nv = res ** 3
    ii = torch.arange(nv, dtype=torch.int32, device=dev)
    cell = torch.stack([ii % res, (ii // res) % res, ii // (res * res)],
                       -1).to(torch.float32)
    key = torch.arange(nv * n_samples, dtype=torch.int32, device=dev)
    u3 = torch.stack([rng.uniform_float(key, 0, 11 + k, seed)
                      for k in range(3)], -1).reshape(nv, n_samples, 3)
    pts = ((cell[:, None] + u3) / res * extent + lo).reshape(-1, 3)
    u2 = torch.stack([rng.uniform_float(key, 1, 21, seed),
                      rng.uniform_float(key, 1, 22, seed)], -1)
    lum_w = torch.tensor(_LUMINANCE, dtype=torch.float32, device=dev)

    contrib = np.zeros((nv, nl), np.float32)
    for li in range(nl):
        lidx = torch.full((pts.shape[0],), li, dtype=torch.int32, device=dev)
        ls = lights_mod.sample_li(scene, cfg, lidx, pts, u2)
        lum = ls.li @ lum_w
        est = torch.where(ls.pdf > 0, lum / torch.clamp(ls.pdf, min=1e-12), 0.0)
        contrib[:, li] = est.reshape(nv, n_samples).mean(dim=1).cpu().numpy()

    sums = contrib.sum(axis=1, keepdims=True)
    w = np.where(sums > 0, contrib, np.full_like(contrib, 1.0 / nl))
    w = np.maximum(w, 0.01 * w.max(axis=1, keepdims=True))
    pmf = w / w.sum(axis=1, keepdims=True)
    cdf = np.concatenate([np.zeros((nv, 1), np.float32),
                          np.cumsum(pmf, axis=1)], axis=1).astype(np.float32)
    return SpatialLightDist(
        cdf=torch.from_numpy(cdf).to(dev),
        pmf=torch.from_numpy(pmf.astype(np.float32)).to(dev),
        res=(res, res, res), lo=lo, inv_extent=1.0 / extent)


def spatial_choose_light(dist: SpatialLightDist, p, u):
    """A light index (N,) int32 from the CDF of the voxel holding each p,
    and its selection pdf (N,)."""
    res = dist.res[0]
    q = torch.clamp((p - dist.lo) * dist.inv_extent * res, 0, res - 1e-3)
    qi = q.to(torch.int64)
    vox = (qi[:, 2] * res + qi[:, 1]) * res + qi[:, 0]
    cdf = dist.cdf[vox]  # (N, L+1)
    idx = torch.clamp(
        torch.sum((cdf <= u[:, None]).to(torch.int64), dim=1) - 1,
        0, dist.pmf.shape[1] - 1)
    return idx.to(torch.int32), dist.pmf[vox, idx]
