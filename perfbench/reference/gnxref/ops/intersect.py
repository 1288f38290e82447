"""Batched ray-primitive intersection in plain PyTorch.

The watertight ray-triangle test (translate to the ray origin, permute axes
so |d| is largest in z, shear, signed edge functions, conservative deltaT
error bound) runs as a loop over triangles of flat (N,) tensor math.  Edge
functions that land within the FMA residue bound of zero are snapped to
exactly zero (_edge_fn): eager PyTorch rounds each product separately, but
the snap is kept so that every implementation of the test (this one, the
CUDA kernel, the JAX package) accepts the same edge hits.

The JAX package also has (N, T) broadcast and 128-triangle blocked variants
for the TPU's lanes; in eager PyTorch they would materialise N*T
temporaries, so the triangle loop serves every T here.

Sphere intersection is the full quadratic hit.
"""

from typing import NamedTuple

import torch

from ..constants import INFINITY, gamma

GAMMA2 = gamma(2)
GAMMA3 = gamma(3)
GAMMA5 = gamma(5)

# f32 machine epsilon scale for the edge-function zero snap (see _edge_fn)
_EDGE_EPS = 4.0 * 1.1920929e-07


def _edge_fn(ax, ay, bx, by):
    """2D edge function a.x*b.y - a.y*b.x with a zero snap: values within
    the FMA residue bound of zero become exactly zero, so a ray through a
    shared edge is accepted by both triangles whatever the compiler fuses."""
    p = ax * by
    q = ay * bx
    e = p - q
    tiny = torch.abs(e) <= _EDGE_EPS * (torch.abs(p) + torch.abs(q))
    return torch.where(tiny, 0.0, e)


class TriHit(NamedTuple):
    """Per-ray closest triangle hit (SoA)."""
    hit: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,)
    tri: torch.Tensor  # (N,) int32, valid where hit
    b: torch.Tensor  # (N,3) barycentrics (b0, b1, b2)


def _permute_shear(d):
    """Axis permutation masks + shear for each ray.

    kz = first largest |d| component; (m0, m1) say kz == 0 / kz == 1 (else
    2), and permuted components come from where-chains.  Returns
    ((m0, m1), (sx, sy, sz))."""
    dx0, dy0, dz0 = d[..., 0], d[..., 1], d[..., 2]
    adx, ady, adz = torch.abs(dx0), torch.abs(dy0), torch.abs(dz0)
    m0 = (adx >= ady) & (adx >= adz)  # perm (kx,ky,kz) = (1,2,0)
    m1 = (~m0) & (ady >= adz)         # (2,0,1); else identity
    dz = torch.where(m0, dx0, torch.where(m1, dy0, dz0))
    dx = torch.where(m0, dy0, torch.where(m1, dz0, dx0))
    dy = torch.where(m0, dz0, torch.where(m1, dx0, dy0))
    return (m0, m1), (-dx / dz, -dy / dz, 1.0 / dz)


def _watertight_one(ox, oy, oz, m0, m1, sx, sy, sz, t_max, q0, q1, q2):
    """Watertight test of all rays against ONE triangle (flat (N,) math).

    q0/q1/q2: (3,) triangle vertices. Returns (valid, t, b0, b1, b2)."""
    def permuted(q):
        px = q[0] - ox
        py = q[1] - oy
        pz = q[2] - oz
        x = torch.where(m0, py, torch.where(m1, pz, px))
        y = torch.where(m0, pz, torch.where(m1, px, py))
        z = torch.where(m0, px, torch.where(m1, py, pz))
        return x + sx * z, y + sy * z, z

    x0, y0, z0 = permuted(q0)
    x1, y1, z1 = permuted(q1)
    x2, y2, z2 = permuted(q2)
    e0 = _edge_fn(x1, y1, x2, y2)
    e1 = _edge_fn(x2, y2, x0, y0)
    e2 = _edge_fn(x0, y0, x1, y1)
    neg = (e0 < 0) | (e1 < 0) | (e2 < 0)
    pos = (e0 > 0) | (e1 > 0) | (e2 > 0)
    det = e0 + e1 + e2
    valid = ~(neg & pos) & (det != 0)
    z0 = sz * z0
    z1 = sz * z1
    z2 = sz * z2
    t_scaled = e0 * z0 + e1 * z1 + e2 * z2
    det_neg = det < 0
    lim = t_max * det
    bad = torch.where(det_neg,
                      (t_scaled >= 0) | (t_scaled < lim),
                      (t_scaled <= 0) | (t_scaled > lim))
    valid = valid & ~bad
    inv_det = torch.where(det != 0, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    t = t_scaled * inv_det

    def max3abs(a, b, c):
        return torch.maximum(torch.maximum(torch.abs(a), torch.abs(b)),
                             torch.abs(c))

    # conservative deltaT bound
    max_zt = max3abs(z0, z1, z2)
    max_xt = max3abs(x0, x1, x2)
    max_yt = max3abs(y0, y1, y2)
    delta_x = GAMMA5 * (max_xt + max_zt)
    delta_y = GAMMA5 * (max_yt + max_zt)
    delta_e = 2.0 * (GAMMA2 * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt)
    max_e = max3abs(e0, e1, e2)
    delta_t = 3.0 * (GAMMA3 * max_e * max_zt + delta_e * max_zt
                     + GAMMA3 * max_zt * max_e) * torch.abs(inv_det)
    valid = valid & (t > delta_t)
    return valid, t, e0 * inv_det, e1 * inv_det, e2 * inv_det


def _lane_t_max(t_max, n, device):
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=device)
    return t_max.expand(n) if t_max.ndim == 0 else t_max


def closest_triangle_hit(o, d, t_max, vertices, triangles):
    """Brute-force closest hit over an indexed mesh, plain PyTorch.

    o, d: (N,3); t_max: (N,) or scalar; vertices: (V,3); triangles: (T,3)."""
    return closest_hit_reference(
        o, d, _lane_t_max(t_max, o.shape[0], o.device),
        tri_soa_from_mesh(vertices, triangles))


closest_triangle_hit_small = closest_triangle_hit


def tri_soa_from_mesh(vertices, triangles):
    """(T,9) [p0|p1|p2] float32 layout the kernel reads."""
    tri = triangles.long()
    return torch.cat([vertices[tri[:, k]] for k in range(3)], dim=1).contiguous()


def closest_hit_reference(o, d, t_max, tri_soa):
    """Plain PyTorch version: a loop over triangles of flat (N,) tensor
    math, carrying the running best hit.  Any device."""
    n = o.shape[0]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    (m0, m1), (sx, sy, sz) = _permute_shear(d)
    best_t = t_max.to(torch.float32).clone()
    best_tri = torch.zeros((n,), dtype=torch.int32, device=o.device)
    best_b = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    hit = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for ti in range(tri_soa.shape[0]):
        tv = tri_soa[ti]
        valid, t, b0, b1, b2 = _watertight_one(
            ox, oy, oz, m0, m1, sx, sy, sz, best_t, tv[0:3], tv[3:6], tv[6:9])
        better = valid & (t < best_t)
        best_t = torch.where(better, t, best_t)
        best_tri = torch.where(better, ti, best_tri)
        best_b = torch.where(better[:, None],
                             torch.stack([b0, b1, b2], dim=-1), best_b)
        hit = hit | better
    return TriHit(hit=hit, t=torch.where(hit, best_t, INFINITY), tri=best_tri,
                  b=best_b)


def any_hit_reference(o, d, t_max, tri_soa):
    """Plain PyTorch version of the any hit (shadow ray, IntersectP
    semantics): a loop over triangles of flat (N,) tensor math; a lane is
    occluded when any triangle's full test is valid with t <= t_max.  Any
    device."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    (m0, m1), (sx, sy, sz) = _permute_shear(d)
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    for ti in range(tri_soa.shape[0]):
        tv = tri_soa[ti]
        valid, _, _, _, _ = _watertight_one(
            ox, oy, oz, m0, m1, sx, sy, sz, t_max, tv[0:3], tv[3:6], tv[6:9])
        occ = occ | valid
    return occ


def any_triangle_hit(o, d, t_max, vertices, triangles):
    """Brute-force any-hit (shadow ray, IntersectP semantics), plain
    PyTorch.  Arguments as closest_triangle_hit's."""
    return any_hit_reference(
        o, d, _lane_t_max(t_max, o.shape[0], o.device),
        tri_soa_from_mesh(vertices, triangles))


# ---------------------------------------------------------------------------
# Spheres
# ---------------------------------------------------------------------------

class SphHit(NamedTuple):
    hit: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,)
    sph: torch.Tensor  # (N,) int32


def ray_spheres(o, d, t_max, center, radius):
    """N rays vs S spheres; returns (valid (N,S), t (N,S)) nearest positive
    root."""
    oc = o[:, None] - center[None]  # (N,S,3)
    a = torch.sum(d * d, dim=-1)[:, None]
    b = 2.0 * torch.sum(oc * d[:, None], dim=-1)
    c = torch.sum(oc * oc, dim=-1) - (radius * radius)[None]
    disc = b * b - 4 * a * c
    ok = disc > 0
    # the square root rounded correctly, as XLA's: float32 torch.sqrt on the
    # CPU is not (an ulp off on some lanes, and with several intra-op
    # threads now and then a chunk of lanes off by up to 3e-4 relative);
    # rounding the float64 root to float32 is exact for every float32 input
    sq = torch.sqrt(torch.clamp(disc, min=0.0).double()).float()
    q = torch.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
    t0 = q / a
    t1 = c / torch.where(q == 0, 1.0, q)
    t_near = torch.minimum(t0, t1)
    t_far = torch.maximum(t0, t1)
    eps = 1e-4
    t = torch.where(t_near > eps, t_near, t_far)
    t_max = _lane_t_max(t_max, o.shape[0], o.device)
    ok = ok & (t > eps) & (t < t_max[:, None])
    return ok, t


def closest_sphere_hit(o, d, t_max, center, radius):
    valid, t = ray_spheres(o, d, t_max, center, radius)
    t_masked = torch.where(valid, t, INFINITY)
    best = torch.argmin(t_masked, dim=-1)
    rows = torch.arange(o.shape[0], device=o.device)
    hit = valid[rows, best]
    return SphHit(hit=hit, t=torch.where(hit, t_masked[rows, best], INFINITY),
                  sph=best.to(torch.int32))
