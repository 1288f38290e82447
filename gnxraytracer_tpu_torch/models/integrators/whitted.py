"""Wavefront Whitted integrator (the reference application's default,
depth 5):

  * at each hit: emitted L, then *all lights* sampled once each with
    f·Li·|cos|/pdf (no MIS — Whitted's direct loop),
  * then recursion only through specular reflection/transmission.

Wavefront deviation (documented): the reference recurses into BOTH the
specular reflection and the specular transmission (a branching tree); a
wavefront keeps one continuation ray per lane, so dielectric lanes pick
reflect/transmit stochastically by Fresnel weight (same estimator in
expectation).  Mirror lanes (the default scene's only specular) are identical
to the reference.  ``cfg.whitted_faithful`` runs the branching tree instead
(``trace_paths_faithful``).

Dimension layout: dims 0-4 camera; per depth d, base = 5 + d*(2*n_lights+2):
2 dims per light sample + 2 for the specular lobe choice.
"""

import torch

from ...constants import INFINITY
from ...ops import samplers, trace
from ...scene import camera as cam_mod
from ...scene.scene import MAT_GLASS, MAT_MIRROR
from ...utils.math import absdot, dot, refract
from .. import bxdf
from .. import lights as lights_mod
from .. import materials as mat_mod
from .path import CAMERA_DIMS, RenderCfg, make_config  # noqa: F401  (shared cfg)


def _static_dim_fn(sampler, pixel, sample):
    """Per-column sampler evaluation with STATIC dims — the in-loop
    alternative to materializing the full (N, 5 + d*(2L+2)) sample matrix.
    Same values as sample_all_dims' columns: Halton runs the same host-table
    static-base digit loops."""
    if samplers.supports_inloop_dims(sampler):
        def col(d):
            return samplers.sample_bounce_dims(
                sampler, pixel, sample, d, 1, d + 1)[:, 0]
        return col
    return samplers.static_dim_fn(sampler, pixel, sample)


def _specular_diff_update(it, d_in, rd, wi_world, is_transmit, eta_mat,
                          dpdx, dpdy):
    """Propagate ray differentials through a specular bounce, with
    dndx = dndy = 0: exact for triangles, a flat-shading approximation for
    spheres.  All vectors world-space; eta_mat is the material (interior)
    IOR for transmit lanes."""
    wo = -d_in
    ns = it.ns
    rxo2, ryo2 = it.p + dpdx, it.p + dpdy
    dwodx = -rd.rx_d - wo
    dwody = -rd.ry_d - wo

    # reflect branch
    rxd_r = wi_world - dwodx + 2.0 * dot(dwodx, ns)[:, None] * ns
    ryd_r = wi_world - dwody + 2.0 * dot(dwody, ns)[:, None] * ns

    # transmit branch: flip ns into wo's hemisphere; eta is the wo-side ->
    # wi-side relative IOR
    entering = dot(wo, ns) > 0
    eta = torch.where(entering, 1.0 / eta_mat, eta_mat)
    ns_t = torch.where(entering[:, None], ns, -ns)
    dDNdx = dot(dwodx, ns_t)
    dDNdy = dot(dwody, ns_t)
    won = dot(wo, ns_t)
    win = torch.clamp(torch.abs(dot(wi_world, ns_t)), min=1e-8)
    dmu_f = eta - (eta * eta * won) / win
    rxd_t = wi_world - eta[:, None] * dwodx + (dmu_f * dDNdx)[:, None] * ns_t
    ryd_t = wi_world - eta[:, None] * dwody + (dmu_f * dDNdy)[:, None] * ns_t

    tm = is_transmit[:, None]
    return cam_mod.RayDifferentials(
        rx_o=rxo2, rx_d=torch.where(tm, rxd_t, rxd_r),
        ry_o=ryo2, ry_d=torch.where(tm, ryd_t, ryd_r))


def _emitted(scene, cfg, o, d, hit, it, active, beta=None):
    """Radiance emitted at the hit (area lights) or by the infinite lights
    where the ray escaped, on the `active` lanes, times beta if given."""
    n = o.shape[0]
    L = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    if cfg.has_area:
        is_emitter = hit.hit & (it.light >= 0)
        le = lights_mod.area_light_emitted(
            scene, torch.clamp(it.light, min=0), it.ng, -d,
            cfg.reference_area_bug)
        L = L + torch.where((active & is_emitter)[..., None],
                            le if beta is None else beta * le, 0.0)
    if cfg.has_skybox or cfg.has_env:
        esc = active & ~hit.hit
        le_inf = lights_mod.escaped_radiance(scene, cfg, o, d)
        L = L + torch.where(esc[..., None],
                            le_inf if beta is None else beta * le_inf, 0.0)
    return L


def _light_term(scene, cfg, it, li_idx, u_l, alive, wo_local, mats, mid,
                kd_ov, beta=None):
    """One sample of light li_idx for every lane: (N,3) f·Li·|cos|/pdf
    (times beta if given) where the sample can contribute and is not
    occluded, else 0."""
    n = it.p.shape[0]
    lidx = torch.full((n,), li_idx, dtype=torch.int32, device=it.p.device)
    ls = lights_mod.sample_li(scene, cfg, lidx, it.p, u_l)
    wi_local = trace.to_local(it, ls.wi)
    f, _pdf = mat_mod.evaluate(mats, mid, cfg, wo_local, wi_local,
                               kd_override=kd_ov)
    f = f * absdot(ls.wi, it.ns)[..., None]
    can = (alive & (ls.pdf > 0) & torch.any(ls.li > 0, -1)
           & torch.any(f > 0, -1))
    so, sd, st = trace.shadow_ray(it, ls.target, ls.is_infinite)
    occ = trace.scene_occluded(scene, cfg, so, sd, torch.where(can, st, 0.0))
    if beta is not None:
        f = beta * f
    contrib = f * ls.li / torch.clamp(ls.pdf, min=1e-12)[..., None]
    return torch.where((can & ~occ)[..., None], contrib, 0.0)


def trace_paths(scene, cfg: RenderCfg, sampler, pixel, sample, o, d, rd=None):
    n = o.shape[0]
    dev = o.device
    dims_per_depth = 2 * cfg.n_lights + 2
    dim_col = _static_dim_fn(sampler, pixel, sample)
    filtered_tex = (rd is not None and cfg.has_textures
                    and cfg.texture_filter != "bilinear")

    # STATIC recursion bound: Whitted only continues through specular
    # reflection/transmission, so a scene with no specular material never
    # recurses and the depth loop is depth-1 with no extension machinery.
    has_specular = (MAT_MIRROR in cfg.mat_kinds) or (MAT_GLASS in cfg.mat_kinds)
    eff_depth = cfg.max_depth if has_specular else 1

    light_kinds = (cfg.light_kind_seq if len(cfg.light_kind_seq) == cfg.n_lights
                   else (-1,) * cfg.n_lights)  # unknown: skip nothing

    state = dict(
        o=o, d=d,
        beta=torch.ones((n, 3), dtype=torch.float32, device=dev),
        L=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
    )
    if filtered_tex:
        # ray-differential state, propagated through specular bounces (the
        # path integrator instead drops differentials on spawned rays)
        state.update(rxo=rd.rx_o, rxd=rd.rx_d, ryo=rd.ry_o, ryd=rd.ry_d)

    def depth_step(b, state):
        base = CAMERA_DIMS + b * dims_per_depth
        # dead lanes cast with t_max = 0 and can hit nothing
        hit = trace.scene_intersect(scene, cfg, state["o"], state["d"],
                                    torch.where(state["alive"], INFINITY, 0.0))
        it = trace.make_interaction(scene, cfg, state["o"], state["d"], hit)
        # emitted + escaped (infinite lights)
        L = state["L"] + _emitted(scene, cfg, state["o"], state["d"], hit, it,
                                  state["alive"], state["beta"])

        alive = state["alive"] & hit.hit
        wo_local = trace.to_local(it, it.wo)
        mats_row = mat_mod.gather_material_table(scene.materials,
                                                 torch.clamp(it.mat, min=0))

        # textured kd, filtered through the CURRENT depth's differentials
        # (camera footprint at b=0, specular-propagated after)
        kd_ov = None
        cur_rd = dpdx = dpdy = None
        if cfg.has_textures:
            if filtered_tex:
                cur_rd = cam_mod.RayDifferentials(
                    state["rxo"], state["rxd"], state["ryo"], state["ryd"])
                dpdu, dpdv = trace.triangle_dpduv(scene, hit)
                duvdx, duvdy, dpdx, dpdy = trace.compute_differentials(
                    it.p, it.ns, dpdu, dpdv, cur_rd, return_dp=True)
                kd_ov = mat_mod.resolve_kd(scene, cfg, None, it.uv,
                                           mats=mats_row, duv=(duvdx, duvdy))
            else:
                kd_ov = mat_mod.resolve_kd(scene, cfg, None, it.uv,
                                           mats=mats_row)

        # direct lighting: one sample from EVERY light (Whitted loop).
        # Skybox lights are statically skipped: their light-sampling side is
        # black with pdf 0, so the term is always exactly zero.
        for li_idx in range(cfg.n_lights):
            if light_kinds[li_idx] == 5:  # skybox
                continue
            u_l = torch.stack([dim_col(base + 2 * li_idx),
                               dim_col(base + 2 * li_idx + 1)], dim=-1)
            L = L + _light_term(scene, cfg, it, li_idx, u_l, alive, wo_local,
                                mats_row, None, kd_ov, beta=state["beta"])

        if not (has_specular and b + 1 < cfg.max_depth):
            return dict(state, L=L, alive=torch.zeros_like(alive))

        # specular continuation
        u_s = torch.stack([dim_col(base + 2 * cfg.n_lights),
                           dim_col(base + 2 * cfg.n_lights + 1)], dim=-1)
        smp = mat_mod.sample(mats_row, None, cfg, wo_local, u_s,
                             u_s[..., 0], kd_override=kd_ov)
        continue_spec = alive & smp.specular & smp.valid
        beta = state["beta"] * smp.weight
        wi_world = trace.to_world(it, smp.wi)
        no, nd = trace.spawn_ray(it, wi_world)

        c = continue_spec[..., None]
        out = dict(
            o=torch.where(c, no, state["o"]),
            d=torch.where(c, nd, state["d"]),
            beta=torch.where(c, beta, state["beta"]),
            L=L,
            alive=continue_spec,
        )
        if filtered_tex:
            # the sampled lobe's own transmission flag selects the transmit
            # update against the reflect update
            new_rd = _specular_diff_update(it, state["d"], cur_rd, wi_world,
                                           smp.transmission, mats_row.eta,
                                           dpdx, dpdy)
            out.update(
                rxo=torch.where(c, new_rd.rx_o, state["rxo"]),
                rxd=torch.where(c, new_rd.rx_d, state["rxd"]),
                ryo=torch.where(c, new_rd.ry_o, state["ryo"]),
                ryd=torch.where(c, new_rd.ry_d, state["ryd"]),
            )
        return out

    # every sampler dim is STATIC, so Halton columns run their static-base
    # digit loops in place (no matrix)
    for b in range(eff_depth):
        state = depth_step(b, state)
    return state["L"]


def _specular_branches(scene, cfg, it, wo_local):
    """Deterministic specular reflect/transmit branch directions + weights:
      mirror: reflect weight Kr, no transmit
      glass:  reflect Kr*Fr, transmit Kt*(1-Fr)*eta^2 (radiance mode)
    Returns (wi_r_local, w_r, has_r, wi_t_local, w_t, has_t)."""
    mid = torch.clamp(it.mat, min=0).long()
    mats = scene.materials
    kind = mats.kind[mid]
    n = kind.shape[0]
    dev = kind.device
    ct = wo_local[..., 2]
    wi_r = torch.stack([-wo_local[..., 0], -wo_local[..., 1], ct], dim=-1)
    w_r = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    w_t = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    wi_t = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    has_r = torch.zeros((n,), dtype=torch.bool, device=dev)
    has_t = torch.zeros((n,), dtype=torch.bool, device=dev)
    if MAT_MIRROR in cfg.mat_kinds:
        m = kind == MAT_MIRROR
        w_r = torch.where(m[:, None], mats.kr[mid], w_r)
        has_r = has_r | m
    if MAT_GLASS in cfg.mat_kinds:
        eta_b = mats.eta[mid]
        smooth = (mats.rough_u[mid] <= 0) & (mats.rough_v[mid] <= 0)
        m = (kind == MAT_GLASS) & smooth
        kr = mats.kr[mid]
        kt = mats.kt[mid]
        fr = bxdf.fr_dielectric(ct, torch.ones_like(eta_b), eta_b)
        w_r = torch.where(m[:, None], kr * fr[:, None], w_r)
        has_r = has_r | m
        entering = ct > 0
        ei = torch.where(entering, 1.0, eta_b)
        et = torch.where(entering, eta_b, 1.0)
        eta = ei / et
        nrm = torch.cat(
            [torch.zeros((n, 2), dtype=torch.float32, device=dev),
             torch.where(entering, 1.0, -1.0)[:, None]], dim=-1)
        ok, wi_tt = refract(wo_local, nrm, eta)
        wi_t = torch.where(m[:, None], wi_tt, wi_t)
        w_t = torch.where(m[:, None],
                          kt * ((1.0 - fr) * eta * eta)[:, None], w_t)
        has_t = has_t | (m & ok)
    return wi_r, w_r, has_r, wi_t, w_t, has_t


def trace_paths_faithful(scene, cfg: RenderCfg, sampler, pixel, sample, o, d):
    """The branching Whitted tree: every specular hit recurses into BOTH the
    reflect and the transmit branch — a binary tree of full-width wavefront
    passes instead of the stochastic single-branch estimator.  Each tree node
    consumes its own sampler dimension block, so per-sample values depend
    only on the branch history.  Cost grows as 2^depth; for parity and
    golden runs at Whitted's small depths.  Textured kd is resolved
    UNFILTERED (bilinear, no ray differentials)."""
    n = o.shape[0]
    dims_per_depth = 2 * cfg.n_lights + 2
    max_nodes = 2 ** cfg.max_depth - 1
    n_dims = CAMERA_DIMS + dims_per_depth * max_nodes
    U = samplers.sample_all_dims(sampler, pixel, sample, n_dims)
    counter = [0]

    def li(depth, o, d, active):
        node = counter[0]
        counter[0] += 1
        base = CAMERA_DIMS + node * dims_per_depth
        hit = trace.scene_intersect(scene, cfg, o, d,
                                    torch.where(active, INFINITY, 0.0))
        it = trace.make_interaction(scene, cfg, o, d, hit)
        L = _emitted(scene, cfg, o, d, hit, it, active)
        alive = active & hit.hit
        wo_local = trace.to_local(it, it.wo)
        kd_ov = None
        if cfg.has_textures:
            mats_row = mat_mod.gather_material_table(
                scene.materials, torch.clamp(it.mat, min=0))
            kd_ov = mat_mod.resolve_kd(scene, cfg, None, it.uv, mats=mats_row)
        ub = U[:, base:base + dims_per_depth]
        for li_idx in range(cfg.n_lights):
            L = L + _light_term(
                scene, cfg, it, li_idx, ub[:, 2 * li_idx: 2 * li_idx + 2],
                alive, wo_local, scene.materials, it.mat, kd_ov)
        if depth + 1 < cfg.max_depth:
            wi_r, w_r, has_r, wi_t, w_t, has_t = _specular_branches(
                scene, cfg, it, wo_local)
            for wi_l, w, has in ((wi_r, w_r, has_r), (wi_t, w_t, has_t)):
                act2 = alive & has & torch.any(w > 0, dim=-1)
                wi_w = trace.to_world(it, wi_l)
                no, nd = trace.spawn_ray(it, wi_w)
                lc = li(depth + 1, no, nd, act2)
                L = L + torch.where(act2[..., None], w * lc, 0.0)
        return L

    return li(0, o, d, torch.ones((n,), dtype=torch.bool, device=o.device))


def render_chunk(scene, camera, sampler, cfg: RenderCfg, sample_start, n_samples):
    """Render n_samples spp for every pixel on the scene's device; returns
    the (H*W, 3) radiance sum."""
    dev = scene.geom.vertices.device
    hw = cfg.width * cfg.height
    pixel = torch.arange(hw, dtype=torch.int32, device=dev).repeat(n_samples)
    sample = torch.repeat_interleave(
        int(sample_start) + torch.arange(n_samples, dtype=torch.int32,
                                         device=dev), hw)
    p_film, t_u, l_u = samplers.camera_sample(
        sampler, pixel, sample, cfg.width, cfg.pixel_filter,
        cfg.filter_radius, cfg.filter_alpha)
    rd = None
    faithful = cfg.whitted_faithful
    # faithful mode has no differential plumbing: none are generated
    if cfg.has_textures and cfg.texture_filter != "bilinear" and not faithful:
        o, d, _t, rd = cam_mod.generate_ray_differentials(
            camera, p_film, t_u, l_u)
        rd = cam_mod.scale_differentials(o, d, rd, 1.0 / (cfg.spp ** 0.5))
    else:
        o, d, _ = cam_mod.generate_rays(camera, p_film, t_u, l_u)
    if faithful:
        L = trace_paths_faithful(scene, cfg, sampler, pixel, sample, o, d)
    else:
        L = trace_paths(scene, cfg, sampler, pixel, sample, o, d, rd=rd)
    return torch.sum(L.reshape(n_samples, hw, 3), dim=0)


def render(scene, camera, sampler, cfg: RenderCfg):
    """Full render: loops spp chunks on the host, accumulating on the
    device.  Returns (H, W, 3) linear HDR radiance (mean over spp)."""
    dev = scene.geom.vertices.device
    hw = cfg.width * cfg.height
    acc = torch.zeros((hw, 3), dtype=torch.float32, device=dev)
    s = 0
    while s < cfg.spp:
        ns = min(cfg.spp_chunk, cfg.spp - s)
        acc = acc + render_chunk(scene, camera, sampler, cfg, s, ns)
        s += ns
    return (acc / cfg.spp).reshape(cfg.height, cfg.width, 3)
