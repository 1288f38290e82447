"""Pixel data parallelism over a torch.distributed process group, and
inverse rendering: the differentiable scene parameters and the train step.

Counterpart of the JAX package's parallel/sharding.py.  The JAX package
shards the pixel axis of one logical wavefront over a jax.sharding.Mesh of
devices in one program; here a Mesh is the ranks of a process group (one
device each, see parallel/multihost.py), and each rank traces the lanes of
its own rows of the image: the film is summed over the ranks with
all_reduce, and so are the train step's loss and gradients.  With one rank
nothing is communicated.  The scene, camera and sampler are built on every
rank alike (they are replicated, as in the JAX package).

Two things depend on the lanes of a wavefront, not on each lane alone: the
compaction stages that apply (path._compaction_stages needs the width to
divide and leave >= 256 lanes) and the pre-thinning probability of each
compaction (path._prethin_p).  The JAX package compacts the whole
wavefront; here each rank compacts its own lanes.  Where every stage
applies at both widths and every p_keep is 1 (path.recording_prethin), a
run over several ranks computes what one rank does, up to the order of
float sums.

The sharded render, like the JAX package's, takes the box filter whatever
cfg.pixel_filter says, and generates no ray differentials.

The train step takes the pixels of a rank in passes sized to the device's
memory, accumulating their gradients before one update.  Gradients flow
through autograd: the hand-written casts return hit records that depend on
no parameter (rays and triangles are constants of the step, sampled
directions are detached), so they need no backward.
"""

import time
from typing import NamedTuple

import torch
import torch.distributed as dist

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


class Mesh(NamedTuple):
    """The ranks that split the pixels: this process's rank among them and
    their number (1: this process alone, no collective; else every rank of
    the default process group)."""
    rank: int
    size: int


def make_mesh(n_ranks=None):
    """The mesh of n_ranks ranks: every rank of the default process group
    (n_ranks None, or the group's size), or this process alone (1; also
    where no process group is initialised).  Raises ValueError when fewer
    ranks exist than were asked for, and for a mesh over part of a larger
    group, where the ranks left out would have nothing to do."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_ranks is None:
        n_ranks = world
    if n_ranks > world:
        raise ValueError(
            f"make_mesh({n_ranks}) but only {world} rank(s) in the process "
            "group (start the ranks with torchrun, or multihost.init)")
    if n_ranks == 1:
        return Mesh(rank=0, size=1)
    if n_ranks != world:
        raise ValueError(f"make_mesh({n_ranks}): a mesh is one rank or all "
                         f"{world} ranks of the process group")
    return Mesh(rank=dist.get_rank(), size=world)


def split_range(total, index, count):
    """(start, length) of part `index` of `count` contiguous parts of
    range(total), each ceil(total / count) long but the last (the JAX
    package's split; the length is <= 0 for a part past the end)."""
    per = (total + count - 1) // count
    start = index * per
    return start, min(per, total - start)


def mesh_rows(cfg, mesh):
    """(first row, end row) of the image that `mesh.rank` renders."""
    start, rows = split_range(cfg.height, mesh.rank, mesh.size)
    return start, start + max(rows, 0)


def all_reduce_sum(t, mesh):
    """The sum of t over the mesh's ranks, on every rank; t itself on a mesh
    of one rank.  A failed collective raises."""
    if mesh.size == 1:
        return t
    buf = t.detach().contiguous().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf


def pixel_radiance(scene, camera, sampler, cfg, pixel, sample_start,
                   n_samples, tracer, filtered=False):
    """(n_samples, P, 3) radiance of the pixels `pixel` at samples
    sample_start .. + n_samples, as the JAX package's sharded paths compute
    it: lanes are the pixels tiled n_samples times, no ray differentials, the
    camera sample with the box filter (with filtered=True, cfg.pixel_filter:
    the row split of parallel/multihost.py)."""
    n_pix = pixel.shape[0]
    pix = pixel.repeat(n_samples)
    smp = torch.repeat_interleave(
        int(sample_start) + torch.arange(n_samples, dtype=torch.int32,
                                         device=pixel.device), n_pix)
    filt = ((cfg.pixel_filter, cfg.filter_radius, cfg.filter_alpha)
            if filtered else ())
    p_film, t_u, l_u = samplers_mod.camera_sample(sampler, pix, smp,
                                                  cfg.width, *filt)
    o, d, _ = cam_mod.generate_rays(camera, p_film, t_u, l_u)
    out = tracer(scene, cfg, sampler, pix, smp, o, d)
    L = out[0] if cfg.count_rays else out
    return L.reshape(n_samples, n_pix, 3)


def render_chunk_sharded(scene, camera, sampler, cfg, mesh, sample_start,
                         n_samples):
    """One spp chunk with the rows of the image split over the mesh's ranks:
    each rank traces its own rows' lanes (sample-major) and the (H*W, 3)
    radiance sum is gathered on every rank."""
    dev = scene.geom.vertices.device
    r0, r1 = mesh_rows(cfg, mesh)
    pixel = torch.arange(r0 * cfg.width, r1 * cfg.width, dtype=torch.int32,
                         device=dev)
    tracer = path_mod.trace_paths_fast if cfg.fast_mis else path_mod.trace_paths
    part = torch.sum(pixel_radiance(scene, camera, sampler, cfg, pixel,
                                    sample_start, n_samples, tracer), dim=0)
    if mesh.size == 1:
        return part
    film = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32,
                       device=dev)
    film[r0 * cfg.width:r1 * cfg.width] = part
    return all_reduce_sum(film, mesh)


def render_sharded(scene, camera, sampler, cfg, mesh):
    """Full sharded render: (H, W, 3) linear HDR radiance (mean over spp) on
    every rank."""
    dev = scene.geom.vertices.device
    acc = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32,
                      device=dev)
    s = 0
    while s < cfg.spp:
        ns = min(cfg.spp_chunk, cfg.spp - s)
        acc = acc + render_chunk_sharded(scene, camera, sampler, cfg, mesh, s,
                                         ns)
        s += ns
    return (acc / cfg.spp).reshape(cfg.height, cfg.width, 3)


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


def pixel_passes(cfg, lane_budget, rows=None):
    """The passes of a step over the image rows rows = (first, end) (default:
    all): [(first pixel, end pixel), ...], whole rows, as few passes as
    lane_budget lanes a pass allows, of equal rows but the last.  Raises
    MemoryError when one row does not fit."""
    r_lo, r_hi = (0, cfg.height) if rows is None else rows
    row_lanes = cfg.width * cfg.spp_chunk
    max_rows = int(lane_budget) // row_lanes
    if max_rows < 1:
        raise MemoryError(
            f"a pass of one pixel row takes {row_lanes} lanes, over the "
            f"budget of {int(lane_budget)}; render fewer samples a step "
            "(spp_chunk) or free device memory")
    if r_hi <= r_lo:
        return []
    n_passes = -(-(r_hi - r_lo) // max_rows)
    step = -(-(r_hi - r_lo) // n_passes)
    return [(r * cfg.width, min(r + step, r_hi) * cfg.width)
            for r in range(r_lo, r_hi, step)]


def pass_image(scene, camera, sampler, cfg, pixel, sample_start,
               integrator="path"):
    """Per-pixel mean radiance (P, 3) of the pixels `pixel` over samples
    sample_start .. + spp_chunk, as the JAX step's loss computes it: lanes
    are the pixels tiled spp_chunk times, the camera sample takes the
    default box filter, the estimator is the path integrator's faithful one
    (or, with integrator="volpath", the volumetric path integrator)."""
    tracer = {"path": path_mod.trace_paths,
              "volpath": volpath_mod.trace_paths}[integrator]
    return torch.mean(pixel_radiance(scene, camera, sampler, cfg, pixel,
                                     sample_start, cfg.spp_chunk, tracer),
                      dim=0)


def make_train_step(cfg, device=None, lane_budget=None, integrator="path",
                    mesh=None):
    """The train step for RenderCfg cfg, on one device or data-parallel over
    the ranks of `mesh` (make_mesh; None: this process alone).

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

    Over a mesh of several ranks each rank takes the passes of its own rows
    (mesh_rows); the loss is still the mean over all H W pixels, and the
    loss and every gradient are summed over the ranks with all_reduce
    before the update, so every rank returns the same new parameters.  Each
    rank compacts its own lanes (see the module's note).

    device: where the step runs ("cuda" when None); the scene must lie
    there.  integrator: "path" (the JAX step's) or "volpath", whose
    estimator sees the scene's media and so gives their parameters a
    gradient.  stats: an optional dict that gets the step's passes, the lanes
    of each, forward_ms and backward_ms summed over the passes (CUDA events
    on a CUDA device) and the gradients (grads: {key: tensor}, zeros for
    a parameter the image does not depend on)."""
    dev = resolve_device("cuda" if device is None else device)
    mesh = make_mesh(1) if mesh is None else mesh

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
        passes = pixel_passes(cfg, budget, rows=mesh_rows(cfg, mesh))
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
        grads = {k: v.grad for k, v in leaves.items()}
        if mesh.size > 1:
            loss = all_reduce_sum(loss, mesh)
            grads = _all_reduce_grads(grads, leaves, mesh)
        with torch.no_grad():
            new_params = {k: v if grads[k] is None else v - lr * grads[k]
                          for k, v in leaves.items()}
        if stats is not None:
            spans = clock.spans()
            stats.update(
                passes=len(passes), lanes=[(p1 - p0) * cfg.spp_chunk
                                           for p0, p1 in passes],
                forward_ms=sum(spans[0::2]), backward_ms=sum(spans[1::2]),
                grads={k: (torch.zeros_like(leaves[k]) if g is None else g)
                       for k, g in grads.items()})
        return loss, {k: v.detach() for k, v in new_params.items()}

    return run


def _all_reduce_grads(grads, leaves, mesh):
    """grads ({key: tensor or None}) summed over the mesh's ranks in one
    collective (a rank whose image does not depend on a parameter adds
    zeros); every key gets a tensor."""
    keys = sorted(grads)
    parts = [(torch.zeros_like(leaves[k]) if grads[k] is None else grads[k])
             for k in keys]
    flat = all_reduce_sum(torch.cat([p.reshape(-1) for p in parts]), mesh)
    out, i = {}, 0
    for k, p in zip(keys, parts):
        out[k] = flat[i:i + p.numel()].reshape(p.shape)
        i += p.numel()
    return out


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
