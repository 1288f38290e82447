"""The reference's inverse-rendering step: the mean squared error of the
per-pixel mean of `spp_chunk` samples (the faithful estimator) against a
target, its gradient with respect to the parameters by autograd, and one
plain gradient step.  A frozen copy of the port's
parallel/sharding.py (insert_params, pixel_radiance, pass_image and the
step) for one device, over the whole film in passes of whole rows.
"""

import torch

from .gnxref.models.integrators import path as path_mod
from .gnxref.ops import samplers as samplers_mod
from .gnxref.scene import camera as cam_mod

_MAT_PARAM_COLS = (
    "kd", "sigma", "kr", "kt", "ks", "eta", "rough_u", "rough_v",
    "metallic", "spec_trans", "specular_tint", "anisotropic", "sheen",
    "sheen_tint", "clearcoat", "clearcoat_gloss", "flatness", "diff_trans",
)


def insert_params(scene, p):
    """The scene with the material and light tensors of p in place of its
    own."""
    mats = scene.materials._replace(
        **{c: p[c] for c in _MAT_PARAM_COLS if c in p})
    lights = scene.lights
    if "light_emit" in p:
        lights = lights._replace(emit=p["light_emit"])
    return scene._replace(materials=mats, lights=lights)


def pixel_radiance(scene, camera, sampler, cfg, pixel, sample_start,
                   n_samples):
    """(n_samples, P, 3) radiance of the pixels `pixel` at samples
    sample_start .. + n_samples: lanes are the pixels tiled n_samples times,
    the camera sample with the box filter, the faithful estimator."""
    n_pix = pixel.shape[0]
    pix = pixel.repeat(n_samples)
    smp = torch.repeat_interleave(
        int(sample_start) + torch.arange(n_samples, dtype=torch.int32,
                                         device=pixel.device), n_pix)
    p_film, t_u, l_u = samplers_mod.camera_sample(sampler, pix, smp,
                                                  cfg.width)
    o, d, _ = cam_mod.generate_rays(camera, p_film, t_u, l_u)
    L = path_mod.trace_paths(scene, cfg, sampler, pix, smp, o, d)
    return L.reshape(n_samples, n_pix, 3)


def step(params, scene, camera, sampler, cfg, target, sample_start, lr,
         rows_per_pass=None):
    """(loss, new params, grads): one step of plain gradient descent on
    sum((img - target)^2) / (3 H W).  rows_per_pass: pixel rows a pass (all
    by default); the gradients of the passes add up before the update."""
    hw = cfg.width * cfg.height
    dev = scene.geom.vertices.device
    target = target.reshape(hw, 3)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    rows = cfg.height if rows_per_pass is None else rows_per_pass
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    for r0 in range(0, cfg.height, rows):
        p0, p1 = r0 * cfg.width, min(r0 + rows, cfg.height) * cfg.width
        pixel = torch.arange(p0, p1, dtype=torch.int32, device=dev)
        img = torch.mean(pixel_radiance(insert_params(scene, leaves), camera,
                                        sampler, cfg, pixel, sample_start,
                                        cfg.spp_chunk), dim=0)
        part = torch.sum((img - target[p0:p1]) ** 2) / (3 * hw)
        part.backward()
        loss = loss + part.detach()
    grads = {k: (torch.zeros_like(v) if v.grad is None else v.grad)
             for k, v in leaves.items()}
    with torch.no_grad():
        new = {k: v - lr * grads[k] for k, v in leaves.items()}
    return loss, {k: v.detach() for k, v in new.items()}, grads
