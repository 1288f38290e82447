"""Wavefront volumetric path integrator.

Each bounce first samples the lane's current medium along the segment to
the next surface (delta tracking for grids); a medium event does next-event
estimation with Tr-attenuated shadow rays and Henyey-Greenstein phase
sampling; a surface event behaves as in the surface path integrator.  Media
change at null-material boundaries (material id < 0) through the
tri_medium table's (inside, outside) pair.

Null-boundary crossings do not consume path depth: each lane carries a
logical `depth` incremented only at real scattering vertices (medium events
and non-null surface hits), and the loop runs max_depth + 1 +
cfg.vol_null_extra iterations to bound the extra crossings.  Crossings also
skip Russian roulette.

Shadow-ray transmittance: with cfg.tr_walk_segments > 0 (make_config's
default for a scene with media) shadow rays walk the null boundaries
(media.transmittance_walk); otherwise Tr counts the lane's current medium
over the segment only.
"""

import torch

from ...constants import INFINITY
from ...ops import rng, samplers, trace
from ...ops.sampling import power_heuristic
from ...scene import camera as cam_mod
from ...utils.math import cross, dot, normalize
from .. import lights as lights_mod
from .. import materials as mat_mod
from .. import media as media_mod
from .path import (  # noqa: F401  (make_config: the same configuration)
    CAMERA_DIMS, DIMS_PER_BOUNCE, RenderCfg, _choose_light, estimate_direct,
    make_config)

SEED = 0x5EED


def _medium_nee(scene, cfg, p, wo, g_hg, medium_id, u_sel, u_light, u_scat,
                lane_key, bounce, mask=None):
    """Direct light at a medium vertex: the light-sample strategy with the
    phase function and Tr-attenuated visibility, and the phase-sample
    strategy, MIS-weighted.  mask: the lanes that are medium vertices; the
    scene casts get t_max = 0 elsewhere (the caller discards those
    values)."""
    n = p.shape[0]
    dev = p.device
    light_idx, light_pdf = _choose_light(scene, cfg, u_sel, p)
    ls = lights_mod.sample_li(scene, cfg, light_idx, p, u_light)
    phase_p = media_mod.hg_p(dot(wo, ls.wi), g_hg)
    to_t = ls.target - p
    dist = torch.sqrt(torch.clamp(torch.sum(to_t * to_t, -1), min=1e-20))
    sd = to_t / dist[:, None]
    st = torch.where(ls.is_infinite, INFINITY, dist * (1 - 1e-3))
    if mask is not None:
        st = torch.where(mask, st, 0.0)
    if cfg.tr_walk_segments > 0:
        tr, occ = media_mod.transmittance_walk(
            scene, cfg, p, sd, st, medium_id, lane_key, bounce * 7 + 1, SEED)
    else:
        occ = trace.scene_occluded(scene, cfg, p, sd, st)
        tr = media_mod.medium_tr(scene.media, medium_id, p, sd, st, lane_key,
                                 bounce * 7 + 1, SEED)
    w_l = torch.where(ls.is_delta, 1.0,
                      power_heuristic(1.0, ls.pdf, 1.0, phase_p))
    ld = (phase_p[..., None] * ls.li * tr
          * (w_l / torch.clamp(ls.pdf, min=1e-12))[..., None])
    ok = (ls.pdf > 0) & (phase_p > 0) & ~occ
    ld = torch.where(ok[..., None], ld, 0.0)

    # strategy 2: phase sampling toward the chosen (area) light
    wi2, p2 = media_mod.hg_sample(wo, u_scat, g_hg)
    l_pdf2 = lights_mod.pdf_li(scene, cfg, light_idx, p, wi2)
    w_b = power_heuristic(1.0, p2, 1.0, l_pdf2)
    t_ph = torch.full((n,), INFINITY, dtype=torch.float32, device=dev)
    if mask is not None:
        t_ph = torch.where(mask, t_ph, 0.0)
    bhit = trace.scene_intersect(scene, cfg, p, wi2, t_ph)
    li_b = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if cfg.has_area:
        g = scene.geom
        hit_tri = bhit.hit & (bhit.kind == trace.PRIM_TRI)
        tl = torch.where(hit_tri,
                         g.tri_light[torch.where(hit_tri, bhit.prim, 0).long()],
                         -1)
        same = hit_tri & (tl == light_idx)
        tri = g.triangles[torch.where(same, bhit.prim, 0).long()].long()
        p0, p1, p2v = g.vertices[tri[:, 0]], g.vertices[tri[:, 1]], \
            g.vertices[tri[:, 2]]
        nl = normalize(cross(p1 - p0, p2v - p0))
        le = lights_mod.area_light_emitted(scene, light_idx, nl, -wi2,
                                           cfg.reference_area_bug)
        tr2 = media_mod.medium_tr(scene.media, medium_id, p, wi2, bhit.t,
                                  lane_key, bounce * 7 + 2, SEED)
        li_b = torch.where(same[..., None], le * tr2, li_b)
    ld = ld + torch.where((p2 > 0)[..., None], li_b * w_b[..., None], 0.0)
    return ld / torch.clamp(light_pdf, min=1e-12)[..., None]


def trace_paths(scene, cfg: RenderCfg, sampler, pixel, sample, o, d):
    """Volumetric path tracing of the lanes (pixel, sample) with camera rays
    (o, d).  Returns (N,3) radiance, or ((N,3), lanes still alive after the
    last iteration) when cfg.count_rays: a nonzero count means those lanes
    crossed more null boundaries than cfg.vol_null_extra allows for."""
    n = o.shape[0]
    dev = o.device
    n_iters = cfg.max_depth + 1 + (cfg.vol_null_extra if cfg.has_media else 0)
    U = samplers.sample_all_dims(sampler, pixel, sample,
                                 CAMERA_DIMS + DIMS_PER_BOUNCE * n_iters)
    lane_key = rng.hash_combine(pixel, sample)

    state = dict(
        o=o, d=d,
        beta=torch.ones((n, 3), dtype=torch.float32, device=dev),
        L=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        specular=torch.zeros((n,), dtype=torch.bool, device=dev),
        eta_scale=torch.ones((n,), dtype=torch.float32, device=dev),
        medium=torch.full((n,), scene.camera_medium, dtype=torch.int32,
                          device=dev),
        depth=torch.zeros((n,), dtype=torch.int32, device=dev),
    )
    for b in range(n_iters):
        state = _bounce(scene, cfg, b, state, U, lane_key)
    if cfg.count_rays:
        return state["L"], torch.sum(state["alive"].to(torch.float32))
    return state["L"]


def _bounce(scene, cfg, b, state, U, lane_key):
    n = state["o"].shape[0]
    base = CAMERA_DIMS + b * DIMS_PER_BOUNCE
    ub = U[:, base:base + DIMS_PER_BOUNCE]
    # dead lanes cast with t_max = 0 and hit nothing
    hit = trace.scene_intersect(scene, cfg, state["o"], state["d"],
                                torch.where(state["alive"], INFINITY, 0.0))
    it = trace.make_interaction(scene, cfg, state["o"], state["d"], hit)
    L = state["L"]
    beta = state["beta"]

    # ---- medium sampling along the segment ---------------------------------
    if cfg.has_media:
        ms = media_mod.sample_medium(scene.media, state["medium"], state["o"],
                                     state["d"], hit.t, lane_key, b, SEED)
        beta = beta * torch.where(state["alive"][:, None], ms.weight, 1.0)
        med_event = state["alive"] & ms.sampled_medium
    else:
        med_event = torch.zeros((n,), dtype=torch.bool, device=L.device)
    surf_lane = state["alive"] & ~med_event

    # ---- emission (surface lanes, depth 0 or after specular) ----------------
    emit_ok = surf_lane & ((state["depth"] == 0) | state["specular"])
    if cfg.has_area:
        is_emitter = hit.hit & (hit.kind == trace.PRIM_TRI) & (it.light >= 0)
        le = lights_mod.area_light_emitted(
            scene, torch.clamp(it.light, min=0), it.ng, -state["d"],
            cfg.reference_area_bug)
        L = L + torch.where((emit_ok & is_emitter)[..., None], beta * le, 0.0)
    if cfg.has_skybox or cfg.has_env:
        esc = emit_ok & ~hit.hit
        le_inf = lights_mod.escaped_radiance(scene, cfg, state["o"],
                                             state["d"])
        L = L + torch.where(esc[..., None], beta * le_inf, 0.0)

    alive = (state["alive"] & (med_event | hit.hit)
             & (state["depth"] < cfg.max_depth))
    u_sel, u_light, u_scat = ub[:, 0], ub[:, 1:3], ub[:, 3:5]
    u_bsdf, u_rr = ub[:, 5:7], ub[:, 7]

    # ---- medium vertex: NEE + phase sampling --------------------------------
    if cfg.has_media:
        p_med = state["o"] + ms.t[:, None] * state["d"]
        g_hg = scene.media.g[torch.clamp(state["medium"], min=0).long()]
        wo = -state["d"]
        ld_med = _medium_nee(scene, cfg, p_med, wo, g_hg, state["medium"],
                             u_sel, u_light, u_scat, lane_key, b,
                             mask=alive & med_event)
        L = L + torch.where((alive & med_event)[..., None], beta * ld_med, 0.0)
        wi_med, _p = media_mod.hg_sample(wo, u_bsdf, g_hg)

    # ---- surface vertex -------------------------------------------------------
    is_null = it.mat < 0  # null-material boundary: pass straight through
    mat = torch.clamp(it.mat, min=0)
    wo_local = trace.to_local(it, it.wo)
    has_ns = mat_mod.has_nonspecular(scene.materials, mat, cfg)
    light_idx, light_pdf = _choose_light(scene, cfg, u_sel, it.p)
    it_safe = it._replace(mat=mat)
    nee_ok = alive & surf_lane & hit.hit & has_ns & ~is_null
    vis_fn = None
    if cfg.tr_walk_segments > 0:
        # the shadow ray starts in the lane's current medium and walks the
        # null boundaries
        def vis_fn(so, sdir, stmax):
            trv, blk = media_mod.transmittance_walk(
                scene, cfg, so, sdir, stmax, state["medium"], lane_key,
                b * 7 + 3, SEED)
            return blk, trv
    ld = estimate_direct(scene, cfg, it_safe, wo_local, u_light, u_scat,
                         light_idx, vis_fn=vis_fn, mask=nee_ok)
    L = L + torch.where(
        nee_ok[..., None],
        beta * ld / torch.clamp(light_pdf, min=1e-12)[..., None], 0.0)

    smp = mat_mod.sample(scene.materials, mat, cfg, wo_local, u_bsdf,
                         u_bsdf[..., 0])
    wi_surf = trace.to_world(it, smp.wi)
    wi_world = torch.where(is_null[:, None], state["d"], wi_surf)
    beta_next = torch.where((surf_lane & ~is_null)[:, None],
                            beta * smp.weight, beta)
    surf_valid = torch.where(is_null, True, smp.valid)
    specular = torch.where(is_null, state["specular"], smp.specular)

    # medium transitions at boundary crossings (triangles only)
    if cfg.has_media:
        is_tri = hit.kind == trace.PRIM_TRI
        tmed = scene.geom.tri_medium[torch.where(is_tri, hit.prim, 0).long()]
        entering = dot(wi_world, it.ng) < 0
        crossed = dot(wi_world, it.ng) * dot(-state["d"], it.ng) < 0
        new_med = torch.where(entering, tmed[:, 0], tmed[:, 1])
        medium = torch.where(surf_lane & hit.hit & is_tri & crossed, new_med,
                             state["medium"])
    else:
        medium = state["medium"]

    # merge the medium and surface continuations
    no_s, nd_s = trace.spawn_ray(it, wi_world)
    if cfg.has_media:
        no = torch.where(med_event[:, None], p_med, no_s)
        nd = torch.where(med_event[:, None], wi_med, nd_s)
        specular = torch.where(med_event, False, specular)
    else:
        no, nd = no_s, nd_s
    valid = torch.where(med_event, True, surf_valid)
    alive = alive & valid & torch.any(beta_next > 0, dim=-1)

    # etaScale + RR as the surface path; null crossings skip RR and keep
    # their depth
    real_scatter = alive & (med_event | ~is_null)
    entering_s = dot(it.wo, it.ng) > 0
    eta2 = smp.eta * smp.eta
    es_up = torch.where(entering_s, eta2, 1.0 / torch.clamp(eta2, min=1e-12))
    eta_scale = torch.where(surf_lane & smp.specular & smp.transmission,
                            state["eta_scale"] * es_up, state["eta_scale"])
    # q detached: an attached 1/(1-q) reweight biases the gradients
    rr_max = torch.max(beta_next * eta_scale[:, None], dim=-1).values.detach()
    do_rr = real_scatter & (rr_max < cfg.rr_threshold) & (state["depth"] > 3)
    q = torch.clamp(1.0 - rr_max, min=0.05)
    killed = do_rr & (u_rr < q)
    beta_next = torch.where((do_rr & ~killed)[:, None],
                            beta_next / torch.clamp(1.0 - q, min=1e-6)[:, None],
                            beta_next)
    alive = alive & ~killed
    depth = state["depth"] + (alive & real_scatter).to(torch.int32)

    return dict(
        o=torch.where(alive[:, None], no, state["o"]),
        d=torch.where(alive[:, None], nd, state["d"]),
        beta=torch.where(alive[:, None], beta_next, beta),
        L=L,
        alive=alive,
        specular=torch.where(alive, specular, state["specular"]),
        eta_scale=torch.where(alive, eta_scale, state["eta_scale"]),
        medium=torch.where(alive, medium, state["medium"]),
        depth=depth,
    )


def render_chunk(scene, camera, sampler, cfg, sample_start, n_samples):
    """Render n_samples spp of every pixel on the scene's device; returns the
    (H*W, 3) radiance sum, or (sum, truncated lanes) when cfg.count_rays."""
    dev = scene.device
    hw = cfg.width * cfg.height
    pixel = torch.arange(hw, dtype=torch.int32, device=dev).repeat(n_samples)
    sample = torch.repeat_interleave(
        int(sample_start) + torch.arange(n_samples, dtype=torch.int32,
                                         device=dev), hw)
    p_film, t_u, l_u = samplers.camera_sample(
        sampler, pixel, sample, cfg.width, cfg.pixel_filter,
        cfg.filter_radius, cfg.filter_alpha)
    o, d, _ = cam_mod.generate_rays(camera, p_film, t_u, l_u)
    out = trace_paths(scene, cfg, sampler, pixel, sample, o, d)
    L, n_trunc = out if cfg.count_rays else (out, None)
    img = torch.sum(L.reshape(n_samples, hw, 3), dim=0)
    if cfg.count_rays:
        return img, n_trunc
    return img


def render(scene, camera, sampler, cfg):
    """Full render, spp chunks accumulated on the device: (H, W, 3) linear
    HDR radiance (mean over spp)."""
    hw = cfg.width * cfg.height
    acc = torch.zeros((hw, 3), dtype=torch.float32, device=scene.device)
    s = 0
    while s < cfg.spp:
        ns = min(cfg.spp_chunk, cfg.spp - s)
        out = render_chunk(scene, camera, sampler, cfg, s, ns)
        acc = acc + (out[0] if cfg.count_rays else out)
        s += ns
    return (acc / cfg.spp).reshape(cfg.height, cfg.width, 3)
