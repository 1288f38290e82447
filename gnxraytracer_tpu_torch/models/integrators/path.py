"""Wavefront path integrator.

The recursive per-pixel Li() of a CPU path tracer becomes a bounce loop over
a dense SoA ray wavefront: every lane is one (pixel, sample) path and dead
lanes are masked.  Two estimators share the loop runner.  The faithful one
(``fast_mis=False``, ``trace_paths``) makes three scene casts per bounce: the
closest hit, and inside ``estimate_direct`` the shadow ray of the light sample
and the re-intersection of the BSDF sample, with emission added only at
bounce 0 and after a specular bounce.  The folded-MIS one (``fast_mis=True``)
lets the extension ray double as the BSDF-side MIS sample of next-event
estimation — two scene casts per bounce:

  * emission found by the extension ray, weighted by the power heuristic
    against the previous bounce's BSDF pdf (weight 1 at bounce 0 or after a
    specular bounce)
  * NEE with the light-sample strategy, one shadow cast
  * beta *= f |cos| / pdf extension step, etaScale tracking
  * Russian roulette: q = max(.05, 1 - maxComp(beta*etaScale)) when
    maxComp < rrThreshold and bounces > 3

``pipeline_casts=True`` runs the software-pipelined loop
(_trace_loop_pipelined), which compacts the wavefront between a bounce's cast
and its shading.

Sample-dimension layout per lane (stateless sampler, ops/samplers.py):
dims 0-4 camera; per bounce b, base = 5 + 8b:
  +0 light select, +1..2 uLight, +3..4 uScattering of estimate_direct
  (faithful estimator only), +5..6 BSDF extension sample, +7 RR; one further
  dim per compaction stage at the end.
"""

from typing import NamedTuple

import numpy as np
import torch

from ...constants import INFINITY
from ...ops import samplers, trace
from ...ops.sampling import power_heuristic
from ...scene import camera as cam_mod
from ...utils.math import absdot, cross, dot, normalize
from .. import lights as lights_mod
from .. import materials as mat_mod

DIMS_PER_BOUNCE = 8
CAMERA_DIMS = 5


class RenderCfg(NamedTuple):
    """Static (hashable) render configuration.  Every field name and default
    is the JAX package's RenderCfg, so a config carries across by
    ``_asdict()``; fields that only steer unported branches are kept and
    refused where they would be used."""
    width: int
    height: int
    spp: int
    max_depth: int = 5
    rr_threshold: float = 1.0
    mat_kinds: tuple = ()
    light_kinds: tuple = ()
    # per-light kind sequence (index -> kind)
    light_kind_seq: tuple = ()
    n_tris: int = 0
    n_sphs: int = 0
    n_big: int = 0
    n_lights: int = 0
    use_bvh: bool = False
    bvh_stackless: bool = True
    bvh_mode: str = "packet"
    sort_key: str = "oct_morton"
    reference_area_bug: bool = True
    spp_chunk: int = 4
    light_strategy: str = "uniform"  # uniform | power
    has_media: bool = False
    has_textures: bool = False
    # the brute-force cast goes through the hand-written kernel
    # (kernels/closest_hit.py); the name is the JAX package's
    use_pallas: bool = False
    fast_mis: bool = False    # single-extension-ray MIS (2 casts/bounce vs 3)
    # Tail compaction: after bounce `compact_from`, survivors are compacted
    # into a buffer n//compact_frac wide and the remaining bounces run at
    # that width.  Unbiased: an extra Russian-roulette pass (see _prethin_p)
    # keeps the fixed buffer from overflowing; when the survivors already
    # fit, p == 1 and the result equals the uncompacted loop's.
    compact_tail: bool = False
    compact_from: int = 5     # first compacted bounce (> 4 so RR has run)
    compact_frac: int = 8     # tail buffer width = n // compact_frac
    # multi-stage compaction: ((bounce, frac), ...); overrides
    # compact_from/compact_frac when non-empty
    compact_stages: tuple = ()
    pipeline_casts: bool = False
    has_bump: bool = False
    pixel_filter: str = "box"  # box | gaussian (filter importance sampling)
    filter_radius: float = 2.0
    filter_alpha: float = 2.0
    # Count useful scene casts (lanes actually tracing, not dispatch width):
    # trace_paths* then return (L, n_rays) and render_chunk (img, n_rays).
    count_rays: bool = False
    n_inst: int = 0
    n_inst_tris: int = 0
    tr_walk_segments: int = 0
    vol_null_extra: int = 3
    whitted_faithful: bool = False
    texture_filter: str = "ewa"

    # -- derived static predicates ------------------------------------------
    @property
    def has_point_like(self):
        return 0 in self.light_kinds or 1 in self.light_kinds

    @property
    def has_spot(self):
        return 1 in self.light_kinds

    @property
    def has_distant(self):
        return 2 in self.light_kinds

    @property
    def has_area(self):
        return 3 in self.light_kinds

    @property
    def has_env(self):
        return 4 in self.light_kinds

    @property
    def has_skybox(self):
        return 5 in self.light_kinds


def make_config(scene, width, height, spp, **kw):
    """Derive the static kind sets from a built scene (host-side)."""
    # mat_kinds from materials actually REFERENCED by geometry, not every
    # table row: the reference scene registers a mirror it never assigns
    kinds_tab = scene.materials.kind.cpu().numpy()
    used = np.concatenate([scene.geom.tri_mat.cpu().numpy(),
                           scene.geom.sph_mat.cpu().numpy()])
    used = used[used >= 0]
    if used.size:
        mat_kinds = tuple(sorted(set(kinds_tab[used].tolist())))
    else:
        mat_kinds = tuple(sorted(set(kinds_tab.tolist())))
    light_seq = tuple(scene.lights.kind.cpu().numpy().tolist())
    n_tris = int(scene.geom.triangles.shape[0])
    # a scene built with a BVH casts through it (the JAX package brute-forces
    # below 32k triangles, a threshold measured on the TPU; the brute-force
    # any-hit here is a Python loop over triangles).  Override with use_bvh.
    kw.setdefault("use_bvh", scene.bvh is not None)
    if scene.media is not None:
        # shadow rays walk the null-material medium shells (medium Tr through
        # each); without the walk they take the shells for opaque occluders
        kw.setdefault("tr_walk_segments", 4)
    if kw.get("use_bvh") and "bvh_mode" not in kw:
        # the hand-written kernels where the scene lies on a CUDA device, the
        # plain walk elsewhere
        if scene.geom.vertices.device.type == "cuda":
            kw["bvh_mode"] = "pallas"
    has_bump = bool(scene.textures is not None
                    and (scene.materials.bump_tex >= 0).any())
    if has_bump:
        raise NotImplementedError("bump maps are not ported yet")
    return RenderCfg(
        width=width, height=height, spp=spp,
        mat_kinds=mat_kinds, light_kinds=tuple(sorted(set(light_seq))),
        light_kind_seq=light_seq,
        n_tris=n_tris,
        n_sphs=int(scene.geom.sph_center.shape[0]),
        n_big=(0 if scene.big_tri_idx is None
               else int(scene.big_tri_idx.shape[0])),
        n_lights=int(scene.lights.kind.shape[0]),
        has_media=scene.media is not None,
        has_textures=scene.textures is not None,
        has_bump=False,
        n_inst=0, n_inst_tris=0,
        **kw,
    )


# ---------------------------------------------------------------------------
# Light selection
# ---------------------------------------------------------------------------

def _choose_light(scene, cfg, u, p=None):
    """Light selection by the configured strategy:
      uniform — 1/nLights
      power   — proportional to each light's power
    Returns (index (N,) int32, selection pdf (N,))."""
    nl = cfg.n_lights
    if cfg.light_strategy == "spatial":
        raise NotImplementedError("the spatial light distribution is not "
                                  "ported yet")
    if cfg.light_strategy == "power":
        pmf = _power_pmf(scene, nl)
        cdf = torch.cat([torch.zeros((1,), device=pmf.device),
                         torch.cumsum(pmf, dim=0)])
        idx = torch.clamp(
            torch.sum((cdf <= u[:, None]).to(torch.int32), dim=1) - 1,
            0, nl - 1)
        return idx.to(torch.int32), pmf[idx.long()]
    idx = torch.clamp((u * nl).to(torch.int32), max=nl - 1)
    pdf = torch.full(u.shape, 1.0 / nl, dtype=torch.float32, device=u.device)
    return idx, pdf


def _power_pmf(scene, nl):
    """Power-strategy pmf: precomputed at scene build (scene.light_pmf);
    recomputed for hand-constructed Scene values."""
    if scene.light_pmf is not None:
        return scene.light_pmf
    from ...scene.scene import with_light_pmf

    return with_light_pmf(scene).light_pmf


# ---------------------------------------------------------------------------
# Direct lighting (one light sample + one BSDF sample, MIS-weighted)
# ---------------------------------------------------------------------------

def estimate_direct(scene, cfg, it, wo_local, u_light, u_scatter, light_idx,
                    kd_override=None, mats_row=None, vis_fn=None, mask=None):
    """Direct lighting from light `light_idx` for all lanes at once: the
    light-sampling and the BSDF-sampling strategy, combined by the power
    heuristic.

    mats_row: optional pre-gathered per-lane MaterialTable.
    vis_fn: optional (o, d, t_max) -> (occluded (N,), tr (N,3)) replacing
    the binary shadow cast: the volumetric integrator's transmittance walk.
    mask: optional (N,) bool — lanes whose result will actually be used; the
    two scene casts get t_max = 0 outside it, so the walks skip those lanes
    (the caller's downstream where-mask makes the values irrelevant).
    Returns (N,3) direct radiance (before division by light-select pdf)."""
    n = it.p.shape[0]
    dev = it.p.device
    if mats_row is None:
        mats_row = scene.materials
        mat_idx = it.mat
    else:
        mat_idx = None

    # ---- strategy 1: sample the light ------------------------------------
    ls = lights_mod.sample_li(scene, cfg, light_idx, it.p, u_light)
    wi_local = trace.to_local(it, ls.wi)
    f_light, scat_pdf = mat_mod.evaluate(mats_row, mat_idx, cfg, wo_local,
                                         wi_local, kd_override)
    f_light = f_light * absdot(ls.wi, it.ns)[..., None]
    contrib_possible = ((ls.pdf > 0) & torch.any(ls.li > 0, dim=-1)
                        & torch.any(f_light > 0, dim=-1))
    if mask is not None:
        contrib_possible = contrib_possible & mask
    # visibility (shadow ray) only where it can matter
    so, sd, st = trace.shadow_ray(it, ls.target, ls.is_infinite)
    st = torch.where(contrib_possible, st, 0.0)
    if vis_fn is not None:
        occluded, tr_vis = vis_fn(so, sd, st)
    else:
        occluded = trace.scene_occluded(scene, cfg, so, sd, st)
        tr_vis = None
    vis = contrib_possible & ~occluded
    w_l = torch.where(ls.is_delta, 1.0,
                      power_heuristic(1.0, ls.pdf, 1.0, scat_pdf))
    ld_light = f_light * ls.li * (w_l / torch.clamp(ls.pdf, min=1e-12))[..., None]
    if tr_vis is not None:
        ld_light = ld_light * tr_vis
    ld = torch.where(vis[..., None], ld_light, 0.0)

    # ---- strategy 2: sample the BSDF (non-delta lights only) --------------
    smp = mat_mod.sample(mats_row, mat_idx, cfg, wo_local, u_scatter,
                         u_scatter[..., 0], kd_override)
    wi_world = trace.to_world(it, smp.wi)
    f_b = smp.f * absdot(wi_world, it.ns)[..., None]
    do_bsdf = ((~ls.is_delta) & smp.valid & (smp.pdf > 0)
               & (torch.any(f_b > 0, dim=-1) | smp.specular))
    l_pdf = lights_mod.pdf_li(scene, cfg, light_idx, it.p, wi_world)
    w_b = torch.where(smp.specular, 1.0,
                      power_heuristic(1.0, smp.pdf, 1.0, l_pdf))
    # specular lanes: the specular weight already folds the pdf
    contrib_scale = torch.where(
        smp.specular[..., None], smp.weight,
        f_b / torch.clamp(smp.pdf, min=1e-12)[..., None])
    w_b = torch.where(do_bsdf & ((l_pdf > 0) | smp.specular), w_b, 0.0)
    # trace the BSDF-sampled ray; add only if it hits *this* light (or the
    # light is infinite and the ray escapes)
    bo, bd = trace.spawn_ray(it, wi_world)
    bhit_relevant = do_bsdf if mask is None else (do_bsdf & mask)
    bhit = trace.scene_intersect(scene, cfg, bo, bd,
                                 torch.where(bhit_relevant, INFINITY, 0.0))
    li_b = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if cfg.has_area:
        hit_it_light = bhit.hit & (bhit.kind == trace.PRIM_TRI)
        p0, p1, p2, tri_light = trace.tri_emission_attrs(
            scene, cfg, torch.where(hit_it_light, bhit.prim, 0))
        tri_light = torch.where(hit_it_light, tri_light, -1)
        same_light = hit_it_light & (tri_light == light_idx)
        # emitted radiance toward -wi
        nl = normalize(cross(p1 - p0, p2 - p0))
        le = lights_mod.area_light_emitted(scene, light_idx, nl, -bd,
                                           cfg.reference_area_bug)
        li_b = torch.where(same_light[..., None], le, li_b)
    if cfg.has_skybox or cfg.has_env:
        escaped = ~bhit.hit
        lkind = scene.lights.kind[light_idx.long()]
        if cfg.has_skybox:
            # the skybox's radiance counts on the BSDF side even though its
            # light-sampling side is black
            m = escaped & (lkind == 5)
            li_b = torch.where(m[..., None],
                               lights_mod.skybox_le(scene, bo, bd), li_b)
        if cfg.has_env:
            m = escaped & (lkind == 4)
            li_b = torch.where(m[..., None], lights_mod.envmap_le(scene, bd),
                               li_b)
    return ld + contrib_scale * li_b * w_b[..., None]


# ---------------------------------------------------------------------------
# Faithful estimator: three scene casts per bounce
# ---------------------------------------------------------------------------

def _make_faithful_bounce(scene, cfg: RenderCfg, get_ub, n, rd=None):
    """Per-bounce body of the faithful estimator (closest hit + NEE shadow +
    NEE BSDF-side re-intersection).  Same dict-state layout as
    _make_fast_bounce so the compaction runner is shared; prev_pdf/prev_p
    are carried but unused here."""

    def bounce(b, state):
        ub = get_ub(b)
        # dead lanes cast with t_max = 0 and can hit nothing
        hit = trace.scene_intersect(scene, cfg, state["o"], state["d"],
                                    torch.where(state["alive"], INFINITY, 0.0))
        it = trace.make_interaction(scene, cfg, state["o"], state["d"], hit)

        L = state["L"]
        # emission at path vertex (bounce 0 or after specular)
        emit_ok = state["alive"] & ((b == 0) | state["specular"])
        if cfg.has_area:
            is_emitter = hit.hit & (hit.kind == trace.PRIM_TRI) & (it.light >= 0)
            le = lights_mod.area_light_emitted(
                scene, torch.clamp(it.light, min=0), it.ng, -state["d"],
                cfg.reference_area_bug)
            L = L + torch.where((emit_ok & is_emitter)[..., None],
                                state["beta"] * le, 0.0)
        if cfg.has_skybox or cfg.has_env:
            esc = emit_ok & ~hit.hit
            le_inf = lights_mod.escaped_radiance(scene, cfg, state["o"],
                                                 state["d"])
            L = L + torch.where(esc[..., None], state["beta"] * le_inf, 0.0)

        alive = state["alive"] & hit.hit & (b < cfg.max_depth)

        # NEE (skipped for perfectly specular BSDFs)
        wo_local = trace.to_local(it, it.wo)
        mats_row = mat_mod.gather_material_table(scene.materials,
                                                 torch.clamp(it.mat, min=0))
        has_ns = mat_mod.has_nonspecular(mats_row, None, cfg)
        u_sel = ub[:, 0]
        u_light = ub[:, 1:3]
        u_scat = ub[:, 3:5]
        light_idx, light_pdf = _choose_light(scene, cfg, u_sel, it.p)
        kd_ov = _resolve_kd_hit(scene, cfg, hit, it, rd, mats_row)
        nee_ok = alive & has_ns
        ld = estimate_direct(scene, cfg, it, wo_local, u_light, u_scat,
                             light_idx, kd_ov, mats_row=mats_row, mask=nee_ok)
        L = L + torch.where(
            nee_ok[..., None],
            state["beta"] * ld / torch.clamp(light_pdf, min=1e-12)[..., None],
            0.0)

        # extension: sample the BSDF
        u_bsdf = ub[:, 5:7]
        smp = mat_mod.sample(mats_row, None, cfg, wo_local, u_bsdf,
                             u_bsdf[..., 0], kd_ov)
        beta = state["beta"] * smp.weight
        alive = alive & smp.valid & torch.any(beta > 0, dim=-1)
        # etaScale update for specular transmission
        entering = dot(it.wo, it.ng) > 0
        eta2 = smp.eta * smp.eta
        es_up = torch.where(entering, eta2, 1.0 / torch.clamp(eta2, min=1e-12))
        eta_scale = torch.where(smp.specular & smp.transmission,
                                state["eta_scale"] * es_up, state["eta_scale"])
        wi_world = trace.to_world(it, smp.wi)
        no, nd = trace.spawn_ray(it, wi_world)

        # Russian roulette; q detached (see _fast_parts)
        rr_max = torch.max(beta * eta_scale[..., None], dim=-1).values.detach()
        do_rr = (rr_max < cfg.rr_threshold) & (b > 3)
        q = torch.clamp(1.0 - rr_max, min=0.05)
        u_rr = ub[:, 7]
        killed = do_rr & (u_rr < q)
        beta = torch.where((do_rr & ~killed)[..., None],
                           beta / torch.clamp(1.0 - q, min=1e-6)[..., None], beta)
        alive = alive & ~killed

        a3 = alive[..., None]
        out = dict(
            o=torch.where(a3, no, state["o"]),
            d=torch.where(a3, nd, state["d"]),
            beta=torch.where(a3, beta, state["beta"]),
            L=L,
            alive=alive,
            specular=torch.where(alive, smp.specular, state["specular"]),
            eta_scale=torch.where(alive, eta_scale, state["eta_scale"]),
            prev_pdf=state["prev_pdf"],
            prev_p=state["prev_p"],
        )
        if cfg.count_rays:
            # 1 closest-hit cast per alive-at-entry lane; estimate_direct's
            # shadow ray + BSDF-side re-intersection for NEE candidates
            out["nrays"] = (state["nrays"] + _count(state["alive"])
                            + 2.0 * _count(nee_ok))
        return out

    return bounce


def trace_paths(scene, cfg: RenderCfg, sampler, pixel, sample, o, d, rd=None):
    """Wavefront path tracing with the faithful estimator (3 casts/bounce).
    Returns (N,3) radiance, or ((N,3), n_rays) when cfg.count_rays."""
    return _trace_loop(scene, cfg, sampler, pixel, sample, o, d,
                       _make_faithful_bounce, rd=rd)


# ---------------------------------------------------------------------------
# Fast-MIS variant: one extension + one shadow cast per bounce
# ---------------------------------------------------------------------------

def _resolve_kd_hit(scene, cfg, hit, it, rd, mats_row=None):
    """Per-hit base color; with camera differentials (rd, bounce 0 only) the
    uv footprint feeds the filtered texture lookup."""
    if not cfg.has_textures:
        return None
    mid = None if mats_row is not None else it.mat
    if rd is None or cfg.texture_filter == "bilinear":
        return mat_mod.resolve_kd(scene, cfg, mid, it.uv, mats=mats_row)
    dpdu, dpdv = trace.triangle_dpduv(scene, hit)
    duvdx, duvdy = trace.compute_differentials(it.p, it.ns, dpdu, dpdv, rd)
    return mat_mod.resolve_kd(scene, cfg, mid, it.uv, mats=mats_row,
                              duv=(duvdx, duvdy))


def _count(mask):
    return torch.sum(mask.to(torch.float32))


def _fast_parts(scene, cfg: RenderCfg, get_ub, n, rd=None):
    """The fast-MIS bounce body split into its three phases:

      cast(state)          -> Hit          (closest-hit cast)
      emit(b, state, hit)  -> (N,3) L add  (emission/escape with MIS)
      work(b, state, hit)  -> state'       (interaction + NEE + extension
                                            sample + RR)

    _make_fast_bounce composes them into the per-bounce body; the pipelined
    runner compacts the wavefront between the cast and the work."""

    def cast(state):
        # dead lanes cast with t_max = 0 and can hit nothing
        return trace.scene_intersect(
            scene, cfg, state["o"], state["d"],
            torch.where(state["alive"], INFINITY, 0.0))

    def emit(b, state, hit, it=None):
        """Emission/escape contribution of the vertex `hit` (MIS-weighted
        against the previous bounce's BSDF pdf)."""
        m = hit.t.shape[0]
        L = torch.zeros((m, 3), dtype=torch.float32, device=hit.t.device)

        if cfg.has_area:
            if it is not None:
                light_id, ng = it.light, it.ng
            else:
                light_id, ng = trace.tri_light_and_ng(scene, cfg, hit)
            is_emitter = hit.hit & (hit.kind == trace.PRIM_TRI) & (light_id >= 0)
            lidx = torch.clamp(light_id, min=0)
            le = lights_mod.area_light_emitted(scene, lidx, ng, -state["d"],
                                               cfg.reference_area_bug)
            # pdf of having sampled this emission point via NEE from prev_p
            lrow = lights_mod.light_rows(scene, lidx)
            cr = cross(lrow.p1 - lrow.p0, lrow.p2 - lrow.p0)
            area = 0.5 * torch.sqrt(torch.clamp(torch.sum(cr * cr, -1), min=1e-20))
            nl_ = cr / torch.clamp(2.0 * area, min=1e-12)[..., None]
            dist2 = torch.clamp(hit.t * hit.t, min=1e-12)
            cos_l = torch.abs(dot(nl_, -state["d"]))
            pdf_area = dist2 / torch.clamp(cos_l * area, min=1e-12)
            # no light-select pmf here: per-light MIS family (selection is
            # unbiased by the NEE /selectPdf division)
            w = torch.where(
                state["specular"], 1.0,
                power_heuristic(1.0, state["prev_pdf"], 1.0, pdf_area))
            L = L + torch.where((state["alive"] & is_emitter)[..., None],
                                state["beta"] * le * w[..., None], 0.0)
        if cfg.has_skybox or cfg.has_env:
            esc = state["alive"] & ~hit.hit
            if cfg.has_env and not cfg.has_skybox:
                # fused Le + light pdf: one packed gather, one trig pass
                le_inf, env_pdf = lights_mod.envmap_le_pdf(scene, state["d"])
                w = torch.where(
                    state["specular"], 1.0,
                    power_heuristic(1.0, state["prev_pdf"], 1.0, env_pdf))
            elif cfg.has_env:
                le_inf = lights_mod.escaped_radiance(scene, cfg,
                                                     state["o"], state["d"])
                # MIS against env importance sampling
                env_idx = torch.argmax(
                    (scene.lights.kind == 4).to(torch.int32)).to(torch.int32)
                env_pdf = lights_mod.pdf_li(scene, cfg, env_idx.expand(m),
                                            state["o"], state["d"])
                w = torch.where(
                    state["specular"], 1.0,
                    power_heuristic(1.0, state["prev_pdf"], 1.0, env_pdf))
            else:
                # the skybox's light-sampling pdf is 0, so the BSDF-side
                # sample is dropped: it reaches the image only through the
                # bounce-0/specular escape path (weight 0 on non-specular
                # escapes)
                le_inf = lights_mod.escaped_radiance(scene, cfg,
                                                     state["o"], state["d"])
                w = torch.where(state["specular"], 1.0, 0.0)
            L = L + torch.where(esc[..., None],
                                state["beta"] * le_inf * w[..., None], 0.0)
        return L

    def work(b, state, hit, it=None, count_cast=True):
        if it is None:
            it = trace.make_interaction(scene, cfg, state["o"], state["d"],
                                        hit)
        ub = get_ub(b)
        L = state["L"]
        alive = state["alive"] & hit.hit & (b < cfg.max_depth)

        # ---- NEE: light-sample strategy only -------------------------------
        wo_local = trace.to_local(it, it.wo)
        mats_row = mat_mod.gather_material_table(scene.materials,
                                                 torch.clamp(it.mat, min=0))
        has_ns = mat_mod.has_nonspecular(mats_row, None, cfg)
        u_sel = ub[:, 0]
        u_light = ub[:, 1:3]
        light_idx, light_pdf_sel = _choose_light(scene, cfg, u_sel, it.p)
        kd_ov = _resolve_kd_hit(scene, cfg, hit, it, rd, mats_row)
        ls = lights_mod.sample_li(scene, cfg, light_idx, it.p, u_light)
        wi_local = trace.to_local(it, ls.wi)
        f_l, scat_pdf = mat_mod.evaluate(mats_row, None, cfg, wo_local,
                                         wi_local, kd_ov)
        f_l = f_l * absdot(ls.wi, it.ns)[..., None]
        can = ((ls.pdf > 0) & torch.any(ls.li > 0, -1)
               & torch.any(f_l > 0, -1))
        so, sd, st = trace.shadow_ray(it, ls.target, ls.is_infinite)
        # shadow cast only where the NEE sample can contribute
        occ = trace.scene_occluded(scene, cfg, so, sd,
                                   torch.where(alive & has_ns & can, st, 0.0))
        w_l = torch.where(ls.is_delta, 1.0,
                          power_heuristic(1.0, ls.pdf, 1.0, scat_pdf))
        ld = f_l * ls.li * (w_l / torch.clamp(ls.pdf, min=1e-12))[..., None]
        nee_ok = alive & has_ns & can & ~occ
        L = L + torch.where(
            nee_ok[..., None],
            state["beta"] * ld / torch.clamp(light_pdf_sel, min=1e-12)[..., None],
            0.0)

        # ---- extension ------------------------------------------------------
        u_bsdf = ub[:, 5:7]
        smp = mat_mod.sample(mats_row, None, cfg, wo_local, u_bsdf,
                             u_bsdf[..., 0], kd_ov)
        beta = state["beta"] * smp.weight
        alive = alive & smp.valid & torch.any(beta > 0, dim=-1)
        entering = dot(it.wo, it.ng) > 0
        eta2 = smp.eta * smp.eta
        es_up = torch.where(entering, eta2, 1.0 / torch.clamp(eta2, min=1e-12))
        eta_scale = torch.where(smp.specular & smp.transmission,
                                state["eta_scale"] * es_up, state["eta_scale"])
        wi_world = trace.to_world(it, smp.wi)
        no, nd = trace.spawn_ray(it, wi_world)

        # ---- RR.  q MUST be detached: it is a function of the attached
        # beta, and AD cannot see the survival indicator's matching boundary
        # term, so an attached 1/(1-q) reweight biases d(image)/d(params).
        rr_max = torch.max(beta * eta_scale[..., None], dim=-1).values.detach()
        do_rr = (rr_max < cfg.rr_threshold) & (b > 3)
        q = torch.clamp(1.0 - rr_max, min=0.05)
        u_rr = ub[:, 7]
        killed = do_rr & (u_rr < q)
        beta = torch.where((do_rr & ~killed)[..., None],
                           beta / torch.clamp(1.0 - q, min=1e-6)[..., None], beta)
        alive = alive & ~killed

        a3 = alive[..., None]
        out = dict(
            o=torch.where(a3, no, state["o"]),
            d=torch.where(a3, nd, state["d"]),
            beta=torch.where(a3, beta, state["beta"]),
            L=L,
            alive=alive,
            specular=torch.where(alive, smp.specular, state["specular"]),
            eta_scale=torch.where(alive, eta_scale, state["eta_scale"]),
            prev_pdf=torch.where(alive, torch.clamp(smp.pdf, min=1e-12),
                                 state["prev_pdf"]),
            prev_p=torch.where(a3, it.p, state["prev_p"]),
        )
        if cfg.count_rays:
            # 1 closest-hit cast per alive-at-entry lane + 1 shadow cast per
            # NEE candidate (folded MIS: the extension ray IS the BSDF-side
            # MIS sample, so no third cast)
            nrays = state["nrays"] + _count(alive & has_ns & can)
            if count_cast:
                nrays = nrays + _count(state["alive"])
            out["nrays"] = nrays
        return out

    return cast, emit, work


def _make_fast_bounce(scene, cfg: RenderCfg, get_ub, n, rd=None):
    """The per-bounce body of the fast-MIS loop.  get_ub(b) returns the
    (n, DIMS_PER_BOUNCE) sample dims for bounce b."""
    cast, emit, work = _fast_parts(scene, cfg, get_ub, n, rd=rd)

    def bounce(b, state):
        hit = cast(state)
        it = trace.make_interaction(scene, cfg, state["o"], state["d"], hit)
        state = dict(state, L=state["L"] + emit(b, state, hit, it=it))
        return work(b, state, hit, it=it)

    return bounce


def trace_paths_fast(scene, cfg: RenderCfg, sampler, pixel, sample, o, d,
                     rd=None):
    """Path tracing with the folded-MIS estimator: emission found by the
    extension ray is weighted by PowerHeuristic(bsdf_pdf, light_pdf) instead
    of spawning a third per-bounce ray.  Same expectation, ~1/3 fewer scene
    casts and one fewer BSDF sample per bounce."""
    if cfg.pipeline_casts:
        return _trace_loop_pipelined(scene, cfg, sampler, pixel, sample,
                                     o, d, rd=rd)
    return _trace_loop(scene, cfg, sampler, pixel, sample, o, d,
                       _make_fast_bounce, rd=rd)


def _prethin_p(alive, m):
    """Pre-thinning RR survival probability for a compaction into an
    m-slot buffer: p = min(1, (m - 4*sqrt(m)) / alive), a 0-dim tensor (no
    host sync).  Unbiased (beta/p); E[kept] <= m - 4*sqrt(m) puts overflow
    tens of sigmas out (kept is Binomial, std <= sqrt(m)/2), and p == 1 — a
    no-op — in the common case where the survivors already fit."""
    alive_count = _count(alive)
    margin = m - 4.0 * float(m) ** 0.5
    return torch.clamp(margin / torch.clamp(alive_count, min=1.0), max=1.0)


def _compaction_stages(cfg, n, increasing_bounces=False):
    """The (bounce, frac) stages that apply at width n: within max_depth,
    dividing n, at least 256 lanes wide, widths strictly shrinking (and, for
    the pipelined loop, bounces strictly increasing)."""
    stages = (tuple(cfg.compact_stages) if cfg.compact_stages
              else ((cfg.compact_from, cfg.compact_frac),))
    keep, last, last_b = [], n, -1
    for b, f in stages:
        if (b <= cfg.max_depth and n % f == 0 and n // f >= 256
                and n // f < last and (b > last_b or not increasing_bounces)):
            keep.append((b, f))
            last, last_b = n // f, b
    return tuple(keep)


def _initial_state(cfg, o, d):
    n = o.shape[0]
    dev = o.device
    state = dict(
        o=o, d=d,
        beta=torch.ones((n, 3), dtype=torch.float32, device=dev),
        L=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        specular=torch.ones((n,), dtype=torch.bool, device=dev),  # bounce 0
        eta_scale=torch.ones((n,), dtype=torch.float32, device=dev),
        prev_pdf=torch.ones((n,), dtype=torch.float32, device=dev),
        prev_p=o,
    )
    if cfg.count_rays:
        state["nrays"] = torch.zeros((), dtype=torch.float32, device=dev)
    return state


def _compact(cfg, state, survivors, m, u_thin):
    """Pre-thin (RR, unbiased) the `survivors` of a wavefront and compact
    them into a fixed m-slot buffer.  Returns (state at width m, src, valid):
    slot i came from lane src[i] and is real where valid[i].  Buffer widths
    are fixed, as in the JAX package, so both compute the same thing; slot m
    is a spare that takes every lane that is not kept (and any overflow) and
    is sliced off."""
    dev = state["o"].device
    n_cur = state["o"].shape[0]
    p_keep = _prethin_p(survivors, m)
    kept = survivors & (u_thin < p_keep)
    beta = state["beta"] / p_keep
    slots = torch.cumsum(kept.to(torch.int64), dim=0) - 1
    lane_id = torch.arange(n_cur, dtype=torch.int64, device=dev)
    src = torch.zeros((m + 1,), dtype=torch.int64, device=dev)
    src[torch.where(kept, torch.clamp(slots, max=m), m)] = lane_id
    src = src[:m]
    kept_count = torch.sum(kept.to(torch.int64))
    valid = torch.arange(m, dtype=torch.int64, device=dev) < kept_count
    new_state = dict(
        o=state["o"][src], d=state["d"][src],
        beta=beta[src],
        L=torch.zeros((m, 3), dtype=torch.float32, device=dev),
        alive=valid,
        specular=state["specular"][src],
        eta_scale=state["eta_scale"][src],
        prev_pdf=state["prev_pdf"][src],
        prev_p=state["prev_p"][src],
    )
    if cfg.count_rays:
        new_state["nrays"] = state["nrays"]  # scalar: carries across widths
    return new_state, src, valid


def _scatter_back(L, outer):
    """Add the partial radiances of the compacted stages back through the
    composed source maps; outer: [(L_at_this_width, src, valid), ...]."""
    for L_outer, src, valid in reversed(outer):
        L = L_outer.index_add(0, src, torch.where(valid[..., None], L, 0.0))
    return L


class _Dims:
    """The per-bounce sample dims of a wavefront.  Sobol' and random dims are
    computed where they are used; Halton needs a static prime base per dim,
    so its full (N, D) matrix is computed once and sliced."""

    def __init__(self, cfg, sampler, pixel, sample, n_stages, U=None):
        self.sampler, self.pixel, self.sample = sampler, pixel, sample
        # dims before the per-stage thinning dims, and all dims
        self.n_dims = CAMERA_DIMS + DIMS_PER_BOUNCE * (cfg.max_depth + 1)
        self.n_dims_tot = self.n_dims + n_stages
        self.cfg, self.n_stages = cfg, n_stages
        self.U = U
        if U is None and not samplers.supports_inloop_dims(sampler):
            self.U = samplers.sample_all_dims(sampler, pixel, sample,
                                              self.n_dims_tot)

    def _dims(self, base, k):
        if self.U is not None:
            return self.U[:, base:base + k]
        return samplers.sample_bounce_dims(
            self.sampler, self.pixel, self.sample, base, k, self.n_dims_tot)

    def ub(self, b):
        """(N, DIMS_PER_BOUNCE) dims of bounce b."""
        return self._dims(CAMERA_DIMS + b * DIMS_PER_BOUNCE, DIMS_PER_BOUNCE)

    def thin(self, si):
        """(N,) pre-thinning dim of compaction stage si."""
        return self._dims(self.n_dims + si, 1)[:, 0]

    def take(self, src):
        """The dims of the lanes src (a compacted wavefront)."""
        return _Dims(self.cfg, self.sampler, self.pixel[src], self.sample[src],
                     self.n_stages, None if self.U is None else self.U[src])


def _peel0(cfg, rd):
    """Bounce 0 is peeled out when camera differentials drive a filtered
    texture lookup: only camera rays carry a valid footprint, spawned rays
    fall back to bilinear."""
    return (rd is not None and cfg.has_textures
            and cfg.texture_filter != "bilinear")


def _trace_loop(scene, cfg: RenderCfg, sampler, pixel, sample, o, d,
                make_bounce, rd=None):
    """The bounce-loop runner.

    With cfg.compact_tail: Russian roulette leaves only a few percent of
    lanes alive past bounce 4, so survivors are compacted into an
    n//compact_frac buffer after bounce `compact_from` and the tail bounces
    run at that width; radiance is scattered back at the end.

    Returns (N,3) radiance, or ((N,3), n_rays) when cfg.count_rays (n_rays
    = useful scene casts: lanes actually tracing, not dispatch width)."""
    n = o.shape[0]
    stages = _compaction_stages(cfg, n) if cfg.compact_tail else ()
    dims = _Dims(cfg, sampler, pixel, sample, len(stages))

    state = _initial_state(cfg, o, d)
    bounce = make_bounce(scene, cfg, dims.ub, n)
    b_prev = 0
    if _peel0(cfg, rd):
        bounce0 = make_bounce(scene, cfg, dims.ub, n, rd=rd)
        state = bounce0(0, state)
        b_prev = 1

    # --- multi-stage compaction: run to each stage bounce, pre-thin
    # survivors into an n//frac buffer, continue; scatter the partial
    # radiances back at the end.
    outer = []  # (L_at_this_width, src, valid) per stage
    for si, (cb, frac) in enumerate(stages):
        for b in range(b_prev, cb):
            state = bounce(b, state)
        b_prev = max(b_prev, cb)
        m = n // frac
        L_wide = state["L"]
        state, src, valid = _compact(cfg, state, state["alive"], m,
                                     dims.thin(si))
        outer.append((L_wide, src, valid))
        dims = dims.take(src)
        bounce = make_bounce(scene, cfg, dims.ub, m)
    for b in range(b_prev, cfg.max_depth + 1):
        state = bounce(b, state)
    L = _scatter_back(state["L"], outer)
    if cfg.count_rays:
        return L, state["nrays"]
    return L


def _pipelined_stages(cfg, n):
    """The stages of the pipelined loop at width n."""
    return _compaction_stages(cfg, n, increasing_bounces=True)


def pipelined_cast_counts(cfg, n):
    """(closest-hit casts, shadow casts) that one call of the pipelined loop
    makes at width n: one closest-hit cast at the camera and one after every
    `work`; one shadow cast per `work`; `work` runs once per bounce below
    max_depth."""
    if cfg.compact_tail and _pipelined_stages(cfg, n):
        return cfg.max_depth + 1, cfg.max_depth
    return cfg.max_depth + 1, cfg.max_depth + 1


def _trace_loop_pipelined(scene, cfg: RenderCfg, sampler, pixel, sample,
                          o, d, rd=None):
    """Software-pipelined fast-MIS runner (cfg.pipeline_casts).

    Each iteration runs emit(b) -> work(b) -> cast(b+1), so a
    compact_stages entry (b, frac) compacts the wavefront AFTER bounce b's
    cast + emission but BEFORE its shading work: a stage at bounce 0 runs
    all NEE/texture/material shading only on camera rays that actually hit,
    and later stages shrink each bounce's shading width the moment its cast
    resolves instead of one bounce later.  Identical estimator math to
    _trace_loop: the same sample dims feed the same computations, only
    dispatch widths differ.
    """
    n = o.shape[0]
    stages = _pipelined_stages(cfg, n) if cfg.compact_tail else ()
    if not stages:
        return _trace_loop(scene, cfg, sampler, pixel, sample, o, d,
                           _make_fast_bounce, rd=rd)
    dims = _Dims(cfg, sampler, pixel, sample, len(stages))
    peel0 = _peel0(cfg, rd)
    cur_rd = rd
    state = _initial_state(cfg, o, d)

    def make_parts(m, with_rd):
        return _fast_parts(scene, cfg, dims.ub, m,
                           rd=cur_rd if with_rd else None)

    def counted_cast(cast, state):
        if cfg.count_rays:
            state = dict(state, nrays=state["nrays"] + _count(state["alive"]))
        return state, cast(state)

    def run_span(b0, b1, state, hit, m):
        """Full emit->work->cast iterations for bounces [b0, b1)."""
        for bb in range(b0, b1):
            # bounce 0 peeled: camera differentials drive the filtered
            # texture lookup only there
            cast, emit, work = make_parts(m, with_rd=peel0 and bb == 0)
            state = dict(state, L=state["L"] + emit(bb, state, hit))
            state = work(bb, state, hit, count_cast=False)
            state, hit = counted_cast(cast, state)
        return state, hit

    # camera cast (bounce 0) at full width
    cast, _e, _w = make_parts(n, with_rd=False)
    state, hit = counted_cast(cast, state)

    outer = []  # (L_at_this_width, src, valid) per stage
    b = 0
    m_cur = n
    for si, (cb, frac) in enumerate(stages):
        state, hit = run_span(b, cb, state, hit, m_cur)
        # emission of bounce cb at the pre-compaction width (escaped lanes
        # contribute here and are then dropped)
        _c, emit, _w = make_parts(m_cur, with_rd=False)
        L_wide = state["L"] + emit(cb, state, hit)
        # ---- compact survivors (lanes that hit AND pass pre-thin RR) ------
        m = n // frac
        state, src, valid = _compact(cfg, state, state["alive"] & hit.hit, m,
                                     dims.thin(si))
        outer.append((L_wide, src, valid))
        hit = trace.Hit(hit=hit.hit[src] & valid, t=hit.t[src],
                        kind=hit.kind[src], prim=hit.prim[src], b=hit.b[src])
        dims = dims.take(src)
        if cur_rd is not None:
            cur_rd = type(cur_rd)(*(x[src] for x in cur_rd))
        m_cur = m
        # work + next cast for bounce cb at the compacted width
        castc, _e, workc = make_parts(m, with_rd=peel0 and cb == 0)
        state = workc(cb, state, hit, count_cast=False)
        state, hit = counted_cast(castc, state)
        b = cb + 1
    state, hit = run_span(b, cfg.max_depth, state, hit, m_cur)
    _c, emit, _w = make_parts(m_cur, with_rd=False)
    L = _scatter_back(state["L"] + emit(cfg.max_depth, state, hit), outer)
    if cfg.count_rays:
        return L, state["nrays"]
    return L


# ---------------------------------------------------------------------------
# Render loop
# ---------------------------------------------------------------------------

def render_chunk(scene, camera, sampler, cfg: RenderCfg, sample_start, n_samples):
    """Render n_samples spp for every pixel on the scene's device; returns
    the (H*W, 3) radiance sum, or (sum, n_rays) when cfg.count_rays."""
    dev = scene.geom.vertices.device
    hw = cfg.width * cfg.height
    pixel = torch.arange(hw, dtype=torch.int32, device=dev).repeat(n_samples)
    sample = torch.repeat_interleave(
        int(sample_start) + torch.arange(n_samples, dtype=torch.int32,
                                         device=dev), hw)
    p_film, time_u, p_lens = samplers.camera_sample(
        sampler, pixel, sample, cfg.width, cfg.pixel_filter,
        cfg.filter_radius, cfg.filter_alpha)
    rd = None
    if cfg.has_textures and cfg.texture_filter != "bilinear":
        o, d, _t, rd = cam_mod.generate_ray_differentials(
            camera, p_film, time_u, p_lens)
        rd = cam_mod.scale_differentials(o, d, rd, 1.0 / (cfg.spp ** 0.5))
    else:
        o, d, _t = cam_mod.generate_rays(camera, p_film, time_u, p_lens)
    tracer = trace_paths_fast if cfg.fast_mis else trace_paths
    out = tracer(scene, cfg, sampler, pixel, sample, o, d, rd=rd)
    L, nrays = out if cfg.count_rays else (out, None)
    # box filter: each sample belongs to its own pixel -> segment sum by
    # reshape (samples are pixel-major tiles)
    img = torch.sum(L.reshape(n_samples, hw, 3), dim=0)
    if cfg.count_rays:
        return img, nrays
    return img


def render(scene, camera, sampler, cfg: RenderCfg):
    """Full render: loops spp chunks on the host, accumulating on the
    device.  Returns (H, W, 3) linear HDR radiance (mean over spp)."""
    dev = scene.geom.vertices.device
    hw = cfg.width * cfg.height
    acc = torch.zeros((hw, 3), dtype=torch.float32, device=dev)
    s = 0
    while s < cfg.spp:
        ns = min(cfg.spp_chunk, cfg.spp - s)
        out = render_chunk(scene, camera, sampler, cfg, s, ns)
        acc = acc + (out[0] if cfg.count_rays else out)
        s += ns
    img = acc / cfg.spp
    return img.reshape(cfg.height, cfg.width, 3)
