"""Inverse rendering on one device: the differentiable scene parameters and
the train step.

Counterpart of the JAX package's parallel/sharding.py (``extract_params``,
``insert_params``, ``make_train_step``).  The JAX step shards pixels over a
device mesh; this one runs on one device and instead takes the pixels in
passes sized to the device's memory, accumulating their gradients before
one update.  The mesh-sharded render and the pixel-parallel step over
torch.distributed are not ported yet.

Gradients flow through autograd: the hand-written casts return hit records
that depend on no parameter (rays and triangles are constants of the step,
sampled directions are detached), so they need no backward.
"""

import time

import torch

from ..models.integrators import path as path_mod
from ..models.integrators import volpath as volpath_mod
from ..ops import samplers as samplers_mod
from ..scene import camera as cam_mod
from ..scene.scene import MAT_DISNEY
from ..utils.device import resolve_device

# Every MaterialTable column that is a gradient target: diffuse/specular
# scales, roughness, IOR and the ten Disney parameters (the JAX package's
# list, in its order).
_MAT_PARAM_COLS = (
    "kd", "sigma", "kr", "kt", "ks", "eta", "rough_u", "rough_v",
    "metallic", "spec_trans", "specular_tint", "anisotropic", "sheen",
    "sheen_tint", "clearcoat", "clearcoat_gloss", "flatness", "diff_trans",
)

# Peak device bytes one lane of the faithful estimator takes through its
# forward pass and backward(), per bounce (max_depth + 1 bounces): the
# tensors autograd keeps for backward plus the working memory of the
# largest step, every class of extract_params requiring grad.  Measured
# with torch.cuda.max_memory_allocated by tools/train_memory.py on an NVIDIA
# H100 80GB HBM3 (700 W) at 500x500 pixels, depth 8, 250,000 and 500,000
# lanes, rounded up to 64 bytes: "surface" is the Cornell box (area lights,
# matte walls; 442-444 measured), "shaded" the mesh scene (Disney,
# textured floor, environment light; 4,791-4,819 measured), and a scene
# with any of those features or with media is sized with the latter.
BYTES_PER_LANE_BOUNCE = {"surface": 448, "shaded": 4864}
# share of the device's free memory a step's passes may fill: the caching
# allocator reserves more than it hands out, and a scene of a kind may need
# more than the one the figure was measured on
MEMORY_FRACTION = 0.5


def extract_params(scene):
    """The differentiable parameters of a scene: a dict of its tensors (the
    JAX package's keys) — every material column of _MAT_PARAM_COLS,
    ``light_emit``, ``env_image`` when the scene has an environment map,
    ``med_sigma_a`` / ``med_sigma_s`` / ``med_g`` when it has media and
    ``tex_atlas`` when it has image textures."""
    p = {c: getattr(scene.materials, c) for c in _MAT_PARAM_COLS}
    p["light_emit"] = scene.lights.emit
    if scene.env is not None:
        p["env_image"] = scene.env.image
    if scene.media is not None:
        p["med_sigma_a"] = scene.media.sigma_a
        p["med_sigma_s"] = scene.media.sigma_s
        p["med_g"] = scene.media.g
    if scene.textures is not None:
        p["tex_atlas"] = scene.textures[0]
    return p


def insert_params(scene, p):
    """The scene with the tensors of p (extract_params' keys) in place of
    its own.  The packed environment table ``le_func`` is rebuilt from
    ``env_image`` so that radiance reads stay attached to the parameter; its
    channel 3 (the sampling pdf) is a build-time constant, as the CDFs it
    must match are."""
    mats = scene.materials._replace(
        **{c: p[c] for c in _MAT_PARAM_COLS if c in p})
    lights = scene.lights
    if "light_emit" in p:
        lights = lights._replace(emit=p["light_emit"])
    env = scene.env
    if env is not None and "env_image" in p:
        env = env._replace(image=p["env_image"])
        if env.le_func is not None:
            env = env._replace(le_func=torch.cat(
                [p["env_image"], env.le_func[..., 3:]], dim=-1))
    media = scene.media
    if media is not None and "med_sigma_a" in p:
        media = media._replace(sigma_a=p["med_sigma_a"],
                               sigma_s=p["med_sigma_s"], g=p["med_g"])
    textures = scene.textures
    if textures is not None and "tex_atlas" in p:
        textures = (p["tex_atlas"],) + tuple(textures[1:])
    return scene._replace(materials=mats, lights=lights, env=env,
                          media=media, textures=textures)


def lane_bytes(cfg):
    """Peak device bytes a lane of the train step takes (see
    BYTES_PER_LANE_BOUNCE)."""
    shaded = (cfg.has_textures or cfg.has_env or cfg.has_media
              or MAT_DISNEY in cfg.mat_kinds)
    per_bounce = BYTES_PER_LANE_BOUNCE["shaded" if shaded else "surface"]
    return per_bounce * (cfg.max_depth + 1)


def default_lane_budget(cfg, device):
    """Lanes (pixels x spp_chunk) a pass may take on `device`: on a CUDA
    device MEMORY_FRACTION of its free memory over lane_bytes(cfg); on the
    CPU every lane (one pass)."""
    if device.type != "cuda":
        return cfg.width * cfg.height * cfg.spp_chunk
    free, _total = torch.cuda.mem_get_info(device)
    return int(free * MEMORY_FRACTION) // lane_bytes(cfg)


def pixel_passes(cfg, lane_budget):
    """The passes of a step: [(first pixel, end pixel), ...], whole rows of
    the image, as few passes as lane_budget lanes a pass allows, of equal
    rows but the last.  Raises MemoryError when one row does not fit."""
    row_lanes = cfg.width * cfg.spp_chunk
    max_rows = int(lane_budget) // row_lanes
    if max_rows < 1:
        raise MemoryError(
            f"a pass of one pixel row takes {row_lanes} lanes, over the "
            f"budget of {int(lane_budget)}; render fewer samples a step "
            "(spp_chunk) or free device memory")
    n_passes = -(-cfg.height // max_rows)
    rows = -(-cfg.height // n_passes)
    return [(r * cfg.width, min(r + rows, cfg.height) * cfg.width)
            for r in range(0, cfg.height, rows)]


def pass_image(scene, camera, sampler, cfg, pixel, sample_start,
               integrator="path"):
    """Per-pixel mean radiance (P, 3) of the pixels `pixel` over samples
    sample_start .. + spp_chunk, as the JAX step's loss computes it: lanes
    are the pixels tiled spp_chunk times, the camera sample takes the
    default box filter, the estimator is the path integrator's faithful one
    (or, with integrator="volpath", the volumetric path integrator)."""
    tracer = {"path": path_mod.trace_paths,
              "volpath": volpath_mod.trace_paths}[integrator]
    n_samples = cfg.spp_chunk
    n_pix = pixel.shape[0]
    pix = pixel.repeat(n_samples)
    smp = torch.repeat_interleave(
        int(sample_start) + torch.arange(n_samples, dtype=torch.int32,
                                         device=pixel.device), n_pix)
    p_film, t_u, l_u = samplers_mod.camera_sample(sampler, pix, smp, cfg.width)
    o, d, _ = cam_mod.generate_rays(camera, p_film, t_u, l_u)
    out = tracer(scene, cfg, sampler, pix, smp, o, d)
    L = out[0] if cfg.count_rays else out
    return torch.mean(L.reshape(n_samples, n_pix, 3), dim=0)


def make_train_step(cfg, device=None, lane_budget=None, integrator="path"):
    """The single-device train step for RenderCfg cfg.

    Returns run(params, scene, camera, sampler, target, sample_start=0,
    lr=1e-2) -> (loss, new_params): the mean squared error of the per-pixel
    mean over cfg.spp_chunk samples (faithful estimator, whatever
    cfg.fast_mis says) against target (H, W, 3), and params - lr * grad.
    params is a dict of extract_params' keys (any subset that insert_params
    takes); the tensors are not changed.

    The pixels go in passes of at most lane_budget lanes (pixels x
    spp_chunk; default: default_lane_budget), each with its own forward and
    backward() on its share of the loss, sum((img - target)**2) / (3 H W);
    the gradients add up in the parameters' .grad before the one update.
    Each lane depends only on its (pixel, sample), so this is the function of
    one pass up to the order of float sums.  Tail compaction couples the
    lanes of a wavefront, so cfg.compact_tail allows one pass only.

    device: where the step runs ("cuda" when None); the scene must lie
    there.  integrator: "path" (the JAX step's) or "volpath", whose
    estimator sees the scene's media and so gives their parameters a
    gradient.  stats: an optional dict that gets the step's passes, the lanes
    of each, forward_ms and backward_ms summed over the passes (CUDA events
    on a CUDA device) and the gradients (grads: {key: tensor}, zeros for
    a parameter the image does not depend on)."""
    dev = resolve_device("cuda" if device is None else device)

    def run(params, scene, camera, sampler, target, sample_start=0, lr=1e-2,
            stats=None):
        if scene.device.type != dev.type:
            raise ValueError(f"the scene lies on {scene.device}, the step "
                             f"runs on {dev}")
        hw = cfg.width * cfg.height
        target = torch.as_tensor(target, dtype=torch.float32,
                                 device=scene.device).reshape(hw, 3)
        budget = (default_lane_budget(cfg, scene.device) if lane_budget is None
                  else lane_budget)
        passes = pixel_passes(cfg, budget)
        if cfg.compact_tail and len(passes) > 1:
            raise ValueError("cfg.compact_tail couples the lanes of a "
                             "wavefront: the step cannot split it into "
                             f"{len(passes)} passes")
        clock = _Clock(scene.device if stats is not None else None)
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        loss = torch.zeros((), dtype=torch.float32, device=scene.device)
        for p0, p1 in passes:
            pixel = torch.arange(p0, p1, dtype=torch.int32, device=scene.device)
            clock.mark()
            img = pass_image(insert_params(scene, leaves), camera, sampler,
                             cfg, pixel, sample_start, integrator)
            part = torch.sum((img - target[p0:p1]) ** 2) / (3 * hw)
            clock.mark()
            part.backward()
            clock.mark()
            loss = loss + part.detach()
        with torch.no_grad():
            new_params = {k: v if v.grad is None else v - lr * v.grad
                          for k, v in leaves.items()}
        if stats is not None:
            spans = clock.spans()
            stats.update(
                passes=len(passes), lanes=[(p1 - p0) * cfg.spp_chunk
                                           for p0, p1 in passes],
                forward_ms=sum(spans[0::2]), backward_ms=sum(spans[1::2]),
                grads={k: (torch.zeros_like(v) if v.grad is None else v.grad)
                       for k, v in leaves.items()})
        return loss, {k: v.detach() for k, v in new_params.items()}

    return run


class _Clock:
    """Marks between the pieces of a step: CUDA events on a CUDA device
    (read once, after the step), the host clock elsewhere; inert when
    device is None."""

    def __init__(self, device):
        self.device, self.marks = device, []

    def mark(self):
        if self.device is None:
            return
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def spans(self):
        """Milliseconds between marks 3k and 3k+1 (forward) and 3k+1 and
        3k+2 (backward) of each pass, in order."""
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            ms = [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        else:
            ms = [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return [t for i, t in enumerate(ms) if i % 3 != 2]
