"""Participating media: phase functions, transmittance, distance sampling.

  * Henyey-Greenstein p and its sampling
  * homogeneous media: analytic Tr = exp(-sigma_t t) and spectral-MIS
    distance sampling
  * grid media: trilinear density, delta tracking for the distance sample,
    ratio tracking for Tr; the unbounded rejection loops run at most
    MAX_TRACKING_STEPS steps (and stop as soon as every lane is done)

Randomness inside the tracking loops is counter-based (ops/rng.py), keyed on
(lane, bounce, step), the JAX package's streams bit for bit.
"""

from typing import NamedTuple

import torch

from ..constants import INV_4PI, PI
from ..ops import rng
from ..utils.math import coordinate_system, normalize

MAX_TRACKING_STEPS = 256
MEDIUM_HOMOGENEOUS = 0
MEDIUM_GRID = 1


# ---------------------------------------------------------------------------
# Henyey-Greenstein phase function
# ---------------------------------------------------------------------------

def hg_p(cos_theta, g):
    """The Henyey-Greenstein phase function."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / (denom * torch.sqrt(
        torch.clamp(denom, min=1e-8)))


def hg_sample(wo, u, g):
    """Sample the HG phase function around wo: returns (wi detached, p)."""
    small = torch.abs(g) < 1e-3
    safe_g = torch.where(small, 1e-3, g)
    sqr = (1.0 - safe_g * safe_g) / (1.0 + safe_g - 2.0 * safe_g * u[..., 0])
    cos_theta = torch.where(
        small, 1.0 - 2.0 * u[..., 0],
        -(1.0 + safe_g * safe_g - sqr * sqr) / (2.0 * safe_g))
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * PI * u[..., 1]
    v1, v2 = coordinate_system(wo)
    wi = (sin_theta[..., None] * torch.cos(phi)[..., None] * v1
          + sin_theta[..., None] * torch.sin(phi)[..., None] * v2
          + cos_theta[..., None] * wo)
    return normalize(wi).detach(), hg_p(cos_theta, g)


# ---------------------------------------------------------------------------
# Grid density lookup
# ---------------------------------------------------------------------------

def grid_density(density, p_medium):
    """Trilinear density at medium-space points in [0,1]^3; density is
    (nz, ny, nx), zero outside the grid."""
    nz, ny, nx = density.shape
    res = torch.tensor([nx, ny, nz], dtype=torch.float32,
                       device=p_medium.device)
    ps = p_medium * res - 0.5
    pi = torch.floor(ps)
    d = ps - pi
    pi = pi.to(torch.int64)

    def at(ix, iy, iz):
        inb = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0)
               & (iz < nz))
        v = density[torch.clamp(iz, 0, nz - 1), torch.clamp(iy, 0, ny - 1),
                    torch.clamp(ix, 0, nx - 1)]
        return torch.where(inb, v, 0.0)

    x, y, z = pi[..., 0], pi[..., 1], pi[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    d00 = at(x, y, z) * (1 - dx) + at(x + 1, y, z) * dx
    d10 = at(x, y + 1, z) * (1 - dx) + at(x + 1, y + 1, z) * dx
    d01 = at(x, y, z + 1) * (1 - dx) + at(x + 1, y, z + 1) * dx
    d11 = at(x, y + 1, z + 1) * (1 - dx) + at(x + 1, y + 1, z + 1) * dx
    d0 = d00 * (1 - dy) + d10 * dy
    d1 = d01 * (1 - dy) + d11 * dy
    return d0 * (1 - dz) + d1 * dz


def _xform_pt(m, p):
    """Apply (N,4,4) or (4,4) to (N,3) points."""
    if m.ndim == 3:
        return torch.einsum("nij,nj->ni", m[:, :3, :3], p) + m[:, :3, 3]
    return p @ m[:3, :3].T + m[:3, 3]


def _box_clip(o_m, d_m, t_max):
    """Clip rays to the [0,1]^3 medium box; returns (t0, t1)."""
    inv = 1.0 / torch.where(torch.abs(d_m) < 1e-12,
                            torch.where(d_m < 0, -1e-12, 1e-12), d_m)
    ta = (0.0 - o_m) * inv
    tb = (1.0 - o_m) * inv
    t0 = torch.amax(torch.minimum(ta, tb), dim=-1)
    t1 = torch.amin(torch.maximum(ta, tb), dim=-1)
    return torch.clamp(t0, min=0.0), torch.minimum(t1, t_max)


def _grid_frame(media, mid, o, d, t_max):
    """Medium-space rays, 1/max density and the box clip of the lanes' grid
    media: (o_m, d_m, inv_max_density, t0, t1)."""
    w2m = media.world_to_medium[mid]
    o_m = _xform_pt(w2m, o)
    d_m = torch.einsum("nij,nj->ni", w2m[:, :3, :3], d)
    t0, t1 = _box_clip(o_m, d_m, t_max)
    return o_m, d_m, media.inv_max_density[mid], t0, t1


# ---------------------------------------------------------------------------
# Medium interaction sampling (per lane, masked)
# ---------------------------------------------------------------------------

class MediumSample(NamedTuple):
    sampled_medium: torch.Tensor  # (N,) bool: scattering event before surface
    t: torch.Tensor               # (N,) event distance (valid if sampled)
    weight: torch.Tensor          # (N,3) beta multiplier (Tr/pdf terms)


def sample_medium(media, medium_id, o, d, t_surf, lane_key, bounce, seed):
    """Sample a scattering event in each lane's medium (lanes with
    medium_id >= 0) before the surface at t_surf (INFINITY if none).
    o, d: rays (d unit); lane_key: (N,) per-lane key of the hash RNG."""
    n = o.shape[0]
    dev = o.device
    active = medium_id >= 0
    mid = torch.clamp(medium_id, min=0).long()
    kind = media.kind[mid]
    sigma_a = media.sigma_a[mid]
    sigma_s = media.sigma_s[mid]
    sigma_t = sigma_a + sigma_s

    sampled = torch.zeros((n,), dtype=torch.bool, device=dev)
    t_event = torch.zeros((n,), dtype=torch.float32, device=dev)
    weight = torch.ones((n, 3), dtype=torch.float32, device=dev)

    # --- homogeneous --------------------------------------------------------
    hom = active & (kind == MEDIUM_HOMOGENEOUS)
    u_ch = rng.uniform_float(lane_key, bounce, 9001, seed)
    u_t = rng.uniform_float(lane_key, bounce, 9002, seed)
    channel = torch.clamp((u_ch * 3).to(torch.int64), max=2)
    sig_c = torch.gather(sigma_t, 1, channel[:, None])[:, 0]
    # the sampled distance is DETACHED: radiance is discontinuous in t
    # (occlusion boundaries), so an attached t biases d/d(sigma); Tr and the
    # spectral-MIS pdf stay attached at the fixed t and carry the gradient
    dist = (-torch.log(torch.clamp(1.0 - u_t, min=1e-10))
            / torch.clamp(sig_c, min=1e-10)).detach()
    t_h = torch.minimum(dist, t_surf)
    sampled_h = dist < t_surf
    tr_h = torch.exp(-sigma_t * torch.clamp(t_h, max=1e7)[:, None])
    # spectral MIS pdf: average over channels
    density_h = torch.where(sampled_h[:, None], sigma_t * tr_h, tr_h)
    pdf_h = torch.mean(density_h, dim=-1)
    pdf_h = torch.where(pdf_h == 0, 1.0, pdf_h)
    w_h = torch.where(sampled_h[:, None], tr_h * sigma_s / pdf_h[:, None],
                      tr_h / pdf_h[:, None])
    sampled = torch.where(hom, sampled_h, sampled)
    t_event = torch.where(hom, t_h, t_event)
    weight = torch.where(hom[:, None], w_h, weight)

    # --- grid: delta tracking -------------------------------------------------
    if media.density is not None:
        grd = active & (kind == MEDIUM_GRID)
        o_m, d_m, inv_max_d, t0, t1 = _grid_frame(media, mid, o, d, t_surf)
        # tracking uses channel 0 of sigma_t (spectrally uniform media)
        sig0 = sigma_t[:, 0]
        inside = grd & (t0 < t1)
        t = t0
        done = ~inside
        hit_t = torch.zeros((n,), dtype=torch.float32, device=dev)
        step = 0
        while step < MAX_TRACKING_STEPS and not bool(done.all()):
            u1 = rng.uniform_float(lane_key, bounce * 1000 + step, 9101, seed)
            u2 = rng.uniform_float(lane_key, bounce * 1000 + step, 9102, seed)
            t = t - (torch.log(torch.clamp(1.0 - u1, min=1e-10)) * inv_max_d
                     / torch.clamp(sig0, min=1e-10))
            escaped = t >= t1
            dens = grid_density(media.density, o_m + t[:, None] * d_m)
            real = u2 < dens * inv_max_d
            newly_hit = ~done & inside & ~escaped & real
            hit_t = torch.where(newly_hit, t, hit_t)
            done = done | escaped | newly_hit | ~inside
            step += 1
        sampled_g = inside & (hit_t > 0)
        w_g = torch.where(sampled_g[:, None],
                          sigma_s / torch.clamp(sigma_t, min=1e-10), 1.0)
        sampled = torch.where(grd, sampled_g, sampled)
        t_event = torch.where(grd, hit_t, t_event)
        weight = torch.where(grd[:, None], w_g, weight)

    return MediumSample(sampled & active, t_event,
                        torch.where(active[:, None], weight, 1.0))


def medium_tr(media, medium_id, o, d, t_max, lane_key, salt, seed):
    """Transmittance of each lane's medium along [0, t_max]: analytic for a
    homogeneous medium, ratio tracking with Russian roulette for a grid."""
    n = o.shape[0]
    dev = o.device
    active = medium_id >= 0
    mid = torch.clamp(medium_id, min=0).long()
    kind = media.kind[mid]
    sigma_t = media.sigma_a[mid] + media.sigma_s[mid]
    tr = torch.ones((n, 3), dtype=torch.float32, device=dev)

    hom = active & (kind == MEDIUM_HOMOGENEOUS)
    tr_h = torch.exp(-sigma_t * torch.clamp(t_max, max=1e7)[:, None])
    tr = torch.where(hom[:, None], tr_h, tr)

    if media.density is not None:
        grd = active & (kind == MEDIUM_GRID)
        o_m, d_m, inv_max_d, t0, t1 = _grid_frame(media, mid, o, d, t_max)
        sig0 = sigma_t[:, 0]
        inside = grd & (t0 < t1)
        t = t0
        tr_g = torch.ones((n, 3), dtype=torch.float32, device=dev)
        done = ~inside
        step = 0
        while step < MAX_TRACKING_STEPS and not bool(done.all()):
            u1 = rng.uniform_float(lane_key, salt * 1000 + step, 9201, seed)
            u2 = rng.uniform_float(lane_key, salt * 1000 + step, 9202, seed)
            t = t - (torch.log(torch.clamp(1.0 - u1, min=1e-10)) * inv_max_d
                     / torch.clamp(sig0, min=1e-10))
            escaped = t >= t1
            dens = grid_density(media.density, o_m + t[:, None] * d_m)
            factor = 1.0 - torch.clamp(dens * inv_max_d, min=0.0)
            tr_new = torch.where((~done & ~escaped & inside)[:, None],
                                 tr_g * factor[:, None], tr_g)
            # Russian roulette on low Tr (threshold 0.1)
            rr = (tr_new[:, 0] < 0.1) & ~done & ~escaped
            kill = rr & (u2 >= torch.clamp(tr_new[:, 0], min=0.0))
            tr_new = torch.where(
                (rr & ~kill)[:, None],
                tr_new / torch.clamp(tr_new[:, 0:1], min=1e-8), tr_new)
            tr_g = torch.where(kill[:, None], 0.0, tr_new)
            done = done | escaped | kill
            step += 1
        tr = torch.where(grd[:, None], tr_g, tr)

    return torch.where(active[:, None], tr, 1.0)


def transmittance_walk(scene, cfg, o, d, t_max, medium0, lane_key, salt,
                       seed):
    """Shadow-ray transmittance through null-material boundaries: re-cast
    from each boundary hit, multiply the current medium's Tr over each
    segment, switch the current medium at each crossing (by the side the
    ray enters from), and return 0 on any real-material blocker.  At most
    cfg.tr_walk_segments casts (nesting depth, not path length); lanes still
    walking after the last keep their accumulated Tr.

    Returns (tr (N,3), blocked (N,) bool)."""
    from ..ops import trace as trace_mod
    from ..utils.math import cross

    n = o.shape[0]
    dev = o.device
    g = scene.geom
    tr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    cur_o = o
    cur_med = medium0
    t_rem = torch.as_tensor(t_max, dtype=torch.float32, device=dev) \
        * torch.ones((n,), dtype=torch.float32, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    blocked = torch.zeros((n,), dtype=torch.bool, device=dev)
    for k in range(max(cfg.tr_walk_segments, 1)):
        hit = trace_mod.scene_intersect(scene, cfg, cur_o, d, t_rem)
        seg_t = torch.where(hit.hit, hit.t, t_rem)
        seg_tr = medium_tr(scene.media, cur_med, cur_o, d, seg_t, lane_key,
                           salt * 13 + k, seed)
        tr = torch.where(done[:, None], tr, tr * seg_tr)
        # a hit on a real-material primitive is an opaque blocker: Tr = 0
        is_tri = hit.kind == trace_mod.PRIM_TRI
        prim = torch.where(is_tri, hit.prim, 0).long()
        mat = torch.where(is_tri, g.tri_mat[prim], 0)
        if cfg.n_sphs > 0:
            is_sph = hit.kind == trace_mod.PRIM_SPH
            sp = torch.where(is_sph, hit.prim, 0).long()
            mat = torch.where(is_sph, g.sph_mat[sp], mat)
        blk = hit.hit & (mat >= 0) & ~done
        blocked = blocked | blk
        tr = torch.where(blk[:, None], 0.0, tr)
        now_done = done | blk | ~hit.hit
        # cross the null boundary into the medium on the far side
        tmed = g.tri_medium[prim]
        tv = g.triangles[prim].long()
        p0, p1, p2 = g.vertices[tv[:, 0]], g.vertices[tv[:, 1]], \
            g.vertices[tv[:, 2]]
        entering = torch.sum(d * cross(p1 - p0, p2 - p0), dim=-1) < 0
        new_med = torch.where(entering, tmed[:, 0], tmed[:, 1])
        cur_med = torch.where(now_done, cur_med, new_med)
        adv = seg_t + 1e-4 * torch.clamp(torch.abs(seg_t), min=1.0)
        cur_o = torch.where(now_done[:, None], cur_o, cur_o + adv[:, None] * d)
        t_rem = torch.where(now_done, t_rem, torch.clamp(t_rem - adv, min=0.0))
        done = now_done
    return tr, blocked
