"""Light-selection distributions.  Ported: "uniform" (1/nLights, handled in
the integrator) and "power" (proportional to each light's power; the skybox
reports zero power and is excluded).  The spatial voxel-grid distribution
is not ported yet.
"""

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
