"""State carried across from the JAX package to the PyTorch port.

``convert.py`` takes the JAX package's tables with every leaf already a
numpy array (this test does the ``jax.tree.map(np.asarray, ...)``; the port
imports no jax) and returns the port's tables, so both packages can run on
identical state.  A second group builds the same scenes through each
package's own SceneBuilder and asserts the tables equal field by field.

The helpers here (``np_tree``, ``scene_pair``) also serve the other
tests/test_torch_*.py files."""

import jax
import numpy as np
import pytest
import torch

from gnxraytracer_tpu.models.integrators import path as J_path
from gnxraytracer_tpu.ops import samplers as J_smp
from gnxraytracer_tpu.scene import camera as J_cam
from gnxraytracer_tpu.scene import presets as J_presets
from gnxraytracer_tpu.scene import scene as J_scene
from gnxraytracer_tpu_torch import convert
from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.ops import samplers as T_smp
from gnxraytracer_tpu_torch.scene import camera as T_cam
from gnxraytracer_tpu_torch.scene import presets as T_presets
from gnxraytracer_tpu_torch.scene import scene as T_scene


def np_tree(tree):
    """Every array leaf of a JAX-package table as a numpy array."""
    return jax.tree.map(np.asarray, tree)


def _fill_mixed(b, presets):
    """Cornell walls and area lights plus every other ported primitive,
    material and light kind, through either package's builder."""
    mats = presets.reference_materials(b, sigma=60.0)
    presets.add_cornell(b, mats["red"], mats["blue"], mats["white"])
    presets.add_area_lights(b, mats["dragon"])
    lambert = b.add_matte((0.3, 0.6, 0.9), sigma=0.0)
    glass = b.add_glass(kr=(0.9, 1.0, 0.95), kt=(0.95, 0.9, 1.0), eta=1.45)
    b.add_sphere((-1.0, -1.5, 0.5), 0.8, mats["mirror"])
    b.add_sphere((1.2, -1.6, 0.0), 0.7, glass)
    b.add_sphere((0.0, 0.5, -1.0), 0.5, lambert)
    tri_v = np.asarray([[-0.5, -2.4, 1.5], [0.5, -2.4, 1.5], [0.0, -1.6, 1.2]],
                       np.float32)
    tri_n = np.asarray([[0.1, 0.3, 1.0], [-0.1, 0.3, 1.0], [0.0, 0.5, 1.0]],
                       np.float32)
    tri_n /= np.linalg.norm(tri_n, axis=1, keepdims=True)
    tri_uv = np.asarray([[0.0, 0.0], [1.0, 0.1], [0.4, 0.9]], np.float32)
    b.add_mesh(tri_v, np.asarray([[0, 1, 2]]), lambert, normals=tri_n,
               uvs=tri_uv)
    b.add_point_light((1.0, 2.0, 2.0), (30.0, 25.0, 20.0))
    b.add_spot_light((-1.5, 2.0, 2.0), (0.4, -1.0, -0.6), (40.0, 40.0, 60.0),
                     35.0, 20.0)
    b.add_distant_light((0.2, -1.0, -0.3), (0.5, 0.4, 0.3))
    b.add_skybox_light()


def scene_pair(name, w=32, h=32):
    """(JAX scene, JAX camera, torch scene, torch camera), each built by its
    own package."""
    if name == "cornell":
        return (*J_presets.cornell_box(w, h),
                *T_presets.cornell_box(w, h, device="cpu"))
    if name == "sphere":
        return (*J_presets.sphere_point_light(w, h),
                *T_presets.sphere_point_light(w, h, device="cpu"))
    assert name == "mixed"
    jb, tb = J_scene.SceneBuilder(), T_scene.SceneBuilder()
    _fill_mixed(jb, J_presets)
    _fill_mixed(tb, T_presets)
    kw = dict(eye=(0.0, 0.0, 5.0), look=(0.0, 0.0, 0.0), lens_radius=0.05,
              focal_distance=4.0)
    return (jb.build(bvh=False), J_cam.make_perspective_camera(w, h, **kw),
            tb.build(device="cpu"),
            T_cam.make_perspective_camera(w, h, device="cpu", **kw))


# every table is host-side numpy data put on the device, and so equal bit for
# bit, except the power pmf, which each package computes in f32 with its own
# cos() and summation order (a last-ulp difference)
COMPUTED_ON_DEVICE = ("scene.light_pmf",)


def assert_tables_equal(ours, theirs, path=""):
    """Port table (tensors) == JAX-package table (numpy leaves), field by
    field: same None-ness, dtype, shape and values (COMPUTED_ON_DEVICE
    fields to rtol 1e-6)."""
    if theirs is None or ours is None:
        assert ours is None and theirs is None, path
    elif isinstance(ours, tuple) and hasattr(ours, "_fields"):
        for f in theirs._fields:
            assert_tables_equal(getattr(ours, f), getattr(theirs, f),
                                f"{path}.{f}")
    elif torch.is_tensor(ours):
        theirs = np.asarray(theirs)
        assert ours.numpy().dtype == theirs.dtype, (path, ours.dtype,
                                                    theirs.dtype)
        assert tuple(ours.shape) == theirs.shape, path
        if path in COMPUTED_ON_DEVICE:
            np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-6,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=path)
    else:
        assert ours == theirs, (path, ours, theirs)


SCENES = ["cornell", "sphere", "mixed"]


@pytest.mark.parametrize("name", SCENES)
def test_builders_make_equal_tables(name):
    js, jc, ts, tc = scene_pair(name)
    assert_tables_equal(ts, np_tree(js), "scene")
    assert_tables_equal(tc, np_tree(jc), "camera")


@pytest.mark.parametrize("name", SCENES)
def test_scene_and_camera_from_numpy(name):
    js, jc, ts, tc = scene_pair(name)
    got = convert.scene_from_numpy(np_tree(js), device="cpu")
    assert_tables_equal(got, np_tree(js), "scene")
    assert type(got) is T_scene.Scene and got.device.type == "cpu"
    cam = convert.camera_from_numpy(np_tree(jc), device="cpu")
    assert_tables_equal(cam, np_tree(jc), "camera")
    assert type(cam) is T_cam.Camera


@pytest.mark.parametrize("name", SCENES)
def test_make_config_equal_and_cfg_from_dict(name):
    js, _, ts, _ = scene_pair(name)
    kw = dict(spp=8, max_depth=8, spp_chunk=4, fast_mis=True,
              compact_tail=True, compact_stages=((2, 2), (5, 8)),
              count_rays=True, light_strategy="power")
    jcfg = J_path.make_config(js, 32, 32, **kw)
    tcfg = T_path.make_config(ts, 32, 32, **kw)
    assert tcfg._asdict() == jcfg._asdict()
    assert T_path.RenderCfg._fields == J_path.RenderCfg._fields
    assert T_path.RenderCfg._field_defaults == J_path.RenderCfg._field_defaults
    carried = convert.cfg_from_dict(jcfg._asdict())
    assert carried == tcfg and hash(carried) == hash(tcfg)
    for prop in ("has_point_like", "has_spot", "has_distant", "has_area",
                 "has_env", "has_skybox"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop)


def test_cfg_from_dict_refuses_unknown_field():
    with pytest.raises(ValueError):
        convert.cfg_from_dict(dict(width=4, height=4, spp=1, no_such_field=1))


@pytest.mark.parametrize("kind", ["sobol", "random"])
def test_sampler_from_numpy(kind):
    make = (J_smp.make_sobol_sampler if kind == "sobol"
            else J_smp.make_random_sampler)
    got = convert.sampler_from_numpy(np_tree(make(16, seed=3)), device="cpu")
    want = (T_smp.make_sobol_sampler if kind == "sobol"
            else T_smp.make_random_sampler)(16, seed=3, device="cpu")
    assert got == want


def test_unported_state_is_refused():
    js, _ = J_presets.cornell_box(16, 16, bvh=True)
    with pytest.raises(NotImplementedError):
        convert.scene_from_numpy(np_tree(js), device="cpu")
    with pytest.raises(NotImplementedError):
        convert.sampler_from_numpy(
            np_tree(J_smp.make_halton_sampler(4, 8, 8)), device="cpu")
