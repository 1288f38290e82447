"""Procedural texturing: Perlin noise, FBm and Turbulence, the 2D and 3D
texture-coordinate mappings, and the FBm, windy and marble textures
(counterpart of the JAX package's ops/procedural.py; pbrt's
core/Texture.cpp).

Plain PyTorch on the device of the query points, batched over lanes:
`noise` is Ken Perlin's improved gradient noise with its own copy of the
public permutation table, the gradient picked from the hashed index without
branches; `fbm` / `turbulence` sum octaves with the reference's 1.99
lacunarity, the SmoothStep fade of the partial octave and (turbulence) the
0.2 mean of the octaves the footprint clamps away.  Everything is
differentiable with respect to the query points (the quintic fade makes the
noise C2).
"""

import numpy as np
import torch

from ..constants import PI
from ..utils.math import normalize, spherical_phi, spherical_theta

# Ken Perlin's reference permutation (public domain), doubled so that the
# nested lookups never wrap.
_PERM = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64,
    52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212,
    207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213,
    119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
    218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241,
    81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157,
    184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
    222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
], np.int32)

_NOISE_PERM = np.concatenate([_PERM, _PERM])
_perm_on = {}


def _perm(device):
    """The doubled permutation table on `device` (made once a device)."""
    key = str(device)
    if key not in _perm_on:
        _perm_on[key] = torch.as_tensor(_NOISE_PERM, dtype=torch.long,
                                        device=device)
    return _perm_on[key]


def _grad(perm, ix, iy, iz, dx, dy, dz):
    """Grad: the hash picks one of 16 gradient directions, evaluated without
    branches."""
    h = perm[perm[perm[ix] + iy] + iz] & 15
    u = torch.where((h < 8) | (h == 12) | (h == 13), dx, dy)
    v = torch.where((h < 4) | (h == 12) | (h == 13), dy, dz)
    return (torch.where((h & 1) != 0, -u, u)
            + torch.where((h & 2) != 0, -v, v))


def _noise_weight(t):
    """Quintic fade 6t^5 - 15t^4 + 10t^3."""
    t3 = t * t * t
    t4 = t3 * t
    return 6.0 * t4 * t - 15.0 * t4 + 10.0 * t3


def noise(p):
    """Perlin Noise(p) at (..., 3) points."""
    p = torch.as_tensor(p, dtype=torch.float32)
    perm = _perm(p.device)
    pf = torch.floor(p)
    d = p - pf
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    pi = pf.to(torch.int32).long() & 255
    ix, iy, iz = pi[..., 0], pi[..., 1], pi[..., 2]

    w000 = _grad(perm, ix, iy, iz, dx, dy, dz)
    w100 = _grad(perm, ix + 1, iy, iz, dx - 1, dy, dz)
    w010 = _grad(perm, ix, iy + 1, iz, dx, dy - 1, dz)
    w110 = _grad(perm, ix + 1, iy + 1, iz, dx - 1, dy - 1, dz)
    w001 = _grad(perm, ix, iy, iz + 1, dx, dy, dz - 1)
    w101 = _grad(perm, ix + 1, iy, iz + 1, dx - 1, dy, dz - 1)
    w011 = _grad(perm, ix, iy + 1, iz + 1, dx, dy - 1, dz - 1)
    w111 = _grad(perm, ix + 1, iy + 1, iz + 1, dx - 1, dy - 1, dz - 1)

    wx, wy, wz = _noise_weight(dx), _noise_weight(dy), _noise_weight(dz)
    x00 = w000 + wx * (w100 - w000)
    x10 = w010 + wx * (w110 - w010)
    x01 = w001 + wx * (w101 - w001)
    x11 = w011 + wx * (w111 - w011)
    y0 = x00 + wy * (x10 - x00)
    y1 = x01 + wy * (x11 - x01)
    return y0 + wz * (y1 - y0)


def _smooth_step(lo, hi, v):
    t = torch.clamp((v - lo) / (hi - lo), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _octave_count(dpdx, dpdy, max_octaves):
    """The footprint's octave count clamp(-1 - 0.5 log2(len^2), 0, max)."""
    len2 = torch.maximum(torch.sum(dpdx * dpdx, -1), torch.sum(dpdy * dpdy, -1))
    len2 = torch.clamp(len2, min=1e-20)
    return torch.clamp(-1.0 - 0.5 * torch.log2(len2), 0.0, float(max_octaves))


def _octaves(p, dpdx, dpdy, max_octaves):
    p = torch.as_tensor(p, dtype=torch.float32)
    if dpdx is None:
        n = torch.full(p.shape[:-1], float(max_octaves), device=p.device)
    else:
        n = _octave_count(torch.as_tensor(dpdx, dtype=torch.float32,
                                          device=p.device),
                          torch.as_tensor(dpdy, dtype=torch.float32,
                                          device=p.device), max_octaves)
    return p, n, torch.floor(n)


def fbm(p, dpdx=None, dpdy=None, omega=0.5, max_octaves=8):
    """FBm; without dpdx / dpdy the point is sampled at the full octave
    count."""
    p, n, n_int = _octaves(p, dpdx, dpdy, max_octaves)
    sum_ = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    lam = 1.0
    o = torch.ones_like(sum_)
    fade = _smooth_step(0.3, 0.7, n - n_int)
    partial_at = n_int.to(torch.int32)
    for i in range(max_octaves):
        active = i < n_int
        nz = noise(lam * p)
        sum_ = sum_ + torch.where(active, o * nz, 0.0)
        # the fade of the partial octave at i == floor(n)
        sum_ = sum_ + torch.where(partial_at == i, o * fade * nz, 0.0)
        lam *= 1.99
        o = torch.where(active, o * omega, o)
    return sum_


def turbulence(p, dpdx=None, dpdy=None, omega=0.5, max_octaves=8):
    """Turbulence: |noise| octaves, and the 0.2 mean for the octaves that
    the footprint clamps away."""
    p, n, n_int = _octaves(p, dpdx, dpdy, max_octaves)
    sum_ = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    lam = 1.0
    o = torch.ones_like(sum_)
    t = _smooth_step(0.3, 0.7, n - n_int)
    partial_at = n_int.to(torch.int32)
    for i in range(max_octaves):
        active = i < n_int
        nz = torch.abs(noise(lam * p))
        sum_ = sum_ + torch.where(active, o * nz, 0.0)
        partial = partial_at == i
        sum_ = sum_ + torch.where(partial, o * ((1.0 - t) * 0.2 + t * nz), 0.0)
        sum_ = sum_ + torch.where((i >= n_int) & ~partial, o * 0.2, 0.0)
        lam *= 1.99
        o = o * omega
    return sum_


# ---------------------------------------------------------------------------
# Texture-coordinate mappings
# ---------------------------------------------------------------------------

def uv_mapping(uv, su=1.0, sv=1.0, du=0.0, dv=0.0):
    """UVMapping2D: st = (su u + du, sv v + dv)."""
    return torch.stack([su * uv[..., 0] + du, sv * uv[..., 1] + dv], dim=-1)


def spherical_mapping(p, world_to_texture=None):
    """SphericalMapping2D: (theta / pi, phi / 2 pi) of the direction from the
    texture frame's origin."""
    if world_to_texture is not None:
        p = _apply44(world_to_texture, p)
    vec = normalize(p, eps=1e-20)
    return torch.stack([spherical_theta(vec) / PI,
                        spherical_phi(vec) / (2.0 * PI)], dim=-1)


def cylindrical_mapping(p, world_to_texture=None):
    """CylindricalMapping2D: (phi / 2 pi, z) of the normalized point."""
    if world_to_texture is not None:
        p = _apply44(world_to_texture, p)
    vec = normalize(p, eps=1e-20)
    return torch.stack([spherical_phi(vec) / (2.0 * PI), vec[..., 2]], dim=-1)


def planar_mapping(p, vs=(1.0, 0.0, 0.0), vt=(0.0, 1.0, 0.0), ds=0.0, dt=0.0):
    """PlanarMapping2D: st = (ds + p.vs, dt + p.vt)."""
    vs = torch.as_tensor(vs, dtype=torch.float32, device=p.device)
    vt = torch.as_tensor(vt, dtype=torch.float32, device=p.device)
    return torch.stack([ds + torch.sum(p * vs, -1),
                        dt + torch.sum(p * vt, -1)], dim=-1)


def transform_mapping_3d(p, world_to_texture=None):
    """TransformMapping3D: the texture-space point of a solid texture."""
    if world_to_texture is None:
        return p
    return _apply44(world_to_texture, p)


def _apply44(m, p):
    m = torch.as_tensor(m, dtype=torch.float32, device=p.device)
    ph = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3] + m[3, 3]
    return ph / w[..., None]


# ---------------------------------------------------------------------------
# Procedural textures
# ---------------------------------------------------------------------------

_MARBLE = ((0.58, 0.58, 0.6), (0.58, 0.58, 0.6), (0.58, 0.58, 0.6),
           (0.5, 0.5, 0.5), (0.6, 0.59, 0.58), (0.58, 0.58, 0.6),
           (0.58, 0.58, 0.6), (0.2, 0.2, 0.33), (0.58, 0.58, 0.6))


def fbm_texture(p, omega=0.5, octaves=8, world_to_texture=None):
    return fbm(transform_mapping_3d(p, world_to_texture), omega=omega,
               max_octaves=octaves)


def windy_texture(p, world_to_texture=None):
    """pbrt's WindyTexture: |FBm(0.1 p)| wind strength times FBm(p) waves."""
    pt = transform_mapping_3d(p, world_to_texture)
    wind_strength = fbm(0.1 * pt, max_octaves=3)
    wave_height = fbm(pt, max_octaves=6)
    return torch.abs(wind_strength) * wave_height


def marble_texture(p, scale=1.0, variation=0.2, omega=0.5, octaves=8):
    """pbrt's MarbleTexture: FBm-warped sine bands through the 9-knot
    palette spline (de Casteljau's lerps).  Returns (..., 3)."""
    pt = scale * p
    marble = pt[..., 1] * scale + variation * fbm(pt, omega=omega,
                                                  max_octaves=octaves)
    t = 0.5 + 0.5 * torch.sin(marble)
    c = torch.tensor(_MARBLE, dtype=torch.float32, device=p.device)
    nseg = c.shape[0] - 3
    first = torch.clamp((t * nseg).to(torch.int32), 0, nseg - 1).long()
    tt = (t * nseg - first.to(torch.float32))[..., None]
    c0, c1, c2, c3 = (c[first + k] for k in range(4))
    s0 = (1 - tt) * c0 + tt * c1
    s1 = (1 - tt) * c1 + tt * c2
    s2 = (1 - tt) * c2 + tt * c3
    s0 = (1 - tt) * s0 + tt * s1
    s1 = (1 - tt) * s1 + tt * s2
    return 1.5 * ((1 - tt) * s0 + tt * s1)
