"""Wavefront direct-lighting integrator: single-bounce direct illumination
via estimate_direct (with MIS), with specular recursion up to max_depth.  Two
strategies: "all" (every light, one sample each) and "one" (one light chosen
by the configured strategy).

Dimension layout per depth: strategy "one": 1 (select) + 2 + 2 MIS dims +
2 specular continuation = 7; strategy "all": n_lights * 4 + 2.
"""

import torch

from ...constants import INFINITY
from ...ops import samplers, trace
from ...scene import camera as cam_mod
from .. import materials as mat_mod
from .path import CAMERA_DIMS, RenderCfg, _choose_light, estimate_direct, make_config  # noqa: F401
from .whitted import _emitted


def trace_paths(scene, cfg: RenderCfg, sampler, pixel, sample, o, d,
                strategy="one"):
    if strategy not in ("one", "all"):
        raise ValueError(f"unknown direct-lighting strategy {strategy!r}")
    n = o.shape[0]
    dev = o.device
    if strategy == "one":
        dims_per_depth = 7
    else:
        dims_per_depth = 4 * cfg.n_lights + 2

    n_dims = CAMERA_DIMS + dims_per_depth * cfg.max_depth
    U = samplers.sample_all_dims(sampler, pixel, sample, n_dims)
    state = dict(
        o=o, d=d,
        beta=torch.ones((n, 3), dtype=torch.float32, device=dev),
        L=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
    )
    t_inf = torch.full((n,), INFINITY, dtype=torch.float32, device=dev)

    def depth_step(b, state):
        base = CAMERA_DIMS + b * dims_per_depth
        ub = U[:, base:base + dims_per_depth]
        # every lane casts, dead ones too: the image is the JAX package's
        # lane for lane
        hit = trace.scene_intersect(scene, cfg, state["o"], state["d"], t_inf)
        it = trace.make_interaction(scene, cfg, state["o"], state["d"], hit)
        L = state["L"] + _emitted(scene, cfg, state["o"], state["d"], hit, it,
                                  state["alive"], state["beta"])

        alive = state["alive"] & hit.hit
        wo_local = trace.to_local(it, it.wo)
        has_ns = mat_mod.has_nonspecular(scene.materials, it.mat, cfg)
        use = (alive & has_ns)[..., None]

        if strategy == "one":
            u_sel = ub[:, 0]
            u_light = ub[:, 1:3]
            u_scat = ub[:, 3:5]
            lidx, lpdf = _choose_light(scene, cfg, u_sel)
            ld = estimate_direct(scene, cfg, it, wo_local, u_light, u_scat, lidx)
            L = L + torch.where(use, state["beta"] * ld / lpdf[..., None], 0.0)
            spec_off = 5
        else:
            for li in range(cfg.n_lights):
                u_light = ub[:, 4 * li: 4 * li + 2]
                u_scat = ub[:, 4 * li + 2: 4 * li + 4]
                lidx = torch.full((n,), li, dtype=torch.int32, device=dev)
                ld = estimate_direct(scene, cfg, it, wo_local, u_light, u_scat,
                                     lidx)
                L = L + torch.where(use, state["beta"] * ld, 0.0)
            spec_off = 4 * cfg.n_lights

        u_s = ub[:, spec_off: spec_off + 2]
        smp = mat_mod.sample(scene.materials, it.mat, cfg, wo_local, u_s,
                             u_s[..., 0])
        continue_spec = alive & smp.specular & smp.valid
        if not b + 1 < cfg.max_depth:
            continue_spec = torch.zeros_like(continue_spec)
        beta = state["beta"] * smp.weight
        wi_world = trace.to_world(it, smp.wi)
        no, nd = trace.spawn_ray(it, wi_world)
        c = continue_spec[..., None]
        return dict(
            o=torch.where(c, no, state["o"]),
            d=torch.where(c, nd, state["d"]),
            beta=torch.where(c, beta, state["beta"]),
            L=L,
            alive=continue_spec,
        )

    for b in range(cfg.max_depth):
        state = depth_step(b, state)
    return state["L"]


def render_chunk(scene, camera, sampler, cfg, sample_start, n_samples,
                 strategy="one"):
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
    o, d, _ = cam_mod.generate_rays(camera, p_film, t_u, l_u)
    L = trace_paths(scene, cfg, sampler, pixel, sample, o, d, strategy)
    return torch.sum(L.reshape(n_samples, hw, 3), dim=0)


def render(scene, camera, sampler, cfg, strategy="one"):
    """Full render: loops spp chunks on the host, accumulating on the
    device.  Returns (H, W, 3) linear HDR radiance (mean over spp)."""
    dev = scene.geom.vertices.device
    hw = cfg.width * cfg.height
    acc = torch.zeros((hw, 3), dtype=torch.float32, device=dev)
    s = 0
    while s < cfg.spp:
        ns = min(cfg.spp_chunk, cfg.spp - s)
        acc = acc + render_chunk(scene, camera, sampler, cfg, s, ns, strategy)
        s += ns
    return (acc / cfg.spp).reshape(cfg.height, cfg.width, 3)
