"""The reference's render of one pass (perfbench/reference/gnxref)."""

from .. import scenes
from .gnxref.models.integrators import path
from .gnxref.ops import samplers
from .gnxref.scene import camera as cam_mod
from .gnxref.scene import scene as scene_mod

# the reference's casts: the plain watertight loop over triangles, and the
# per-lane threaded walk of its own tree where the scene has one
CFG = {"use_pallas": False, "bvh_mode": "stackless"}


def build(config, device, overrides=None):
    """(scene, camera) of `config`, built by the reference."""
    return scenes.build_scene(config, scene_mod.SceneBuilder,
                              cam_mod.make_perspective_camera, device,
                              **(overrides or {}))


def sobol(spp, seed, device):
    return samplers.make_sobol_sampler(spp, seed=seed, device=device)


def halton(spp, width, height, device):
    return samplers.make_halton_sampler(spp, width, height, device=device)


def pass_film(scene, camera, sampler, cfg, sample_start, n_samples):
    """(H*W, 3) radiance sum of samples sample_start .. + n_samples."""
    return path.render_chunk(scene, camera, sampler, cfg, sample_start,
                             n_samples)
