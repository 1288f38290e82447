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
from gnxraytracer_tpu.scene import loaders as J_load
from gnxraytracer_tpu.scene import presets as J_presets
from gnxraytracer_tpu.scene import scene as J_scene
from gnxraytracer_tpu_torch import convert
from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.ops import samplers as T_smp
from gnxraytracer_tpu_torch.ops import wbvh as T_wbvh
from gnxraytracer_tpu_torch.scene import camera as T_cam
from gnxraytracer_tpu_torch.scene import loaders as T_load
from gnxraytracer_tpu_torch.scene import presets as T_presets
from gnxraytracer_tpu_torch.scene import scene as T_scene

# One intra-op thread for eager PyTorch on the CPU.  Under pytest-xdist every
# worker process imports this module at collection and would otherwise start
# a thread pool as wide as the machine; several such pools on the same cores
# spin at each operator's barrier, and a 64x64 render of a few seconds takes
# minutes.  The tensors here are small: one thread costs next to nothing.
torch.set_num_threads(1)


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


def procedural_hdr(h=32, w=64):
    """A small equirect radiance image with a bright patch, so that the
    environment light has something to importance-sample."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([0.3 + 0.2 * np.sin(x / 7.0), 0.4 + 0.3 * np.cos(y / 5.0),
                    0.6 + 0.1 * np.sin((x + y) / 9.0)], -1)
    img[5:8, 20:24] += 40.0
    return img.astype(np.float32)


def _fill_mesh(b, presets, load, n_seg=8):
    """A small twin of presets.envmap_mesh through either package's builder:
    a Disney blob with normals and uvs, the checker-textured floor, and an
    HDR environment light from an in-code image."""
    mat = b.add_disney((0.6, 0.5, 0.45), rough_u=0.35, metallic=0.1)
    v, t, n, uv = load.make_blob_mesh(n_seg)
    b.add_mesh(v, t, mat, transform=presets._translate([0.0, -0.5, 0.0]),
               normals=n, uvs=uv)
    y, x = np.mgrid[0:128, 0:128]
    tex = b.add_texture(0.2 + 0.6 * np.stack(
        [(((x // 16) + (y // 16)) % 2).astype(np.float32)] * 3, -1))
    floor_mat = b.add_matte((1.0, 1.0, 1.0), sigma=0.0, kd_tex=tex)
    g = 6.0
    gv = np.array([[-g, -1.7, g], [g, -1.7, g], [-g, -1.7, -g],
                   [g, -1.7, g], [g, -1.7, -g], [-g, -1.7, -g]], np.float32)
    guv = np.array([[0, 0], [4, 0], [0, 4], [4, 0], [4, 4], [0, 4]],
                   np.float32)
    b.add_mesh(gv, np.arange(6).reshape(2, 3), floor_mat, uvs=guv)
    b.set_environment(procedural_hdr(), light_to_world=(
        presets._rot_x(20) @ presets._rot_y(-90) @ presets._rot_x(-90)))


def mesh_pair(w=32, h=32, n_seg=8):
    """The mesh twin built with a BVH by each package's own builder.  With
    n_seg >= 46 the mesh has more than 4096 triangles and the floor's two
    are kept out of the tree (big-prim separation)."""
    jb, tb = J_scene.SceneBuilder(), T_scene.SceneBuilder()
    _fill_mesh(jb, J_presets, J_load, n_seg)
    _fill_mesh(tb, T_presets, T_load, n_seg)
    kw = dict(eye=(0.0, 0.8, 5.0), look=(0.0, -0.3, 0.0))
    return (jb.build(bvh=True), J_cam.make_perspective_camera(w, h, **kw),
            tb.build(bvh=True, device="cpu"),
            T_cam.make_perspective_camera(w, h, device="cpu", **kw))


def scene_pair(name, w=32, h=32):
    """(JAX scene, JAX camera, torch scene, torch camera), each built by its
    own package."""
    if name == "mesh":
        return mesh_pair(w, h)
    if name == "mesh_big":
        return mesh_pair(w, h, n_seg=46)
    if name == "cornell_mesh_bvh":
        return (*J_presets.cornell_box(w, h, mesh=J_load.make_test_mesh(2),
                                       bvh=True),
                *T_presets.cornell_box(w, h, mesh=T_load.make_test_mesh(2),
                                       bvh=True, device="cpu"))
    if name == "envmap_preset":  # no assets: checker texture and skybox
        mesh = J_load.make_blob_mesh(8)[:2]
        return (*J_presets.envmap_mesh(w, h, mesh=mesh),
                *T_presets.envmap_mesh(w, h, mesh=mesh, device="cpu"))
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
# bit, except the power pmf and the environment map's distribution tables,
# which each package computes in f32 on the device with its own cos() and
# summation order (a last-ulp difference)
COMPUTED_ON_DEVICE = ("scene.light_pmf", "scene.env.cond_func",
                      "scene.env.cond_cdf", "scene.env.cond_int",
                      "scene.env.marg_cdf", "scene.env.marg_int",
                      "scene.env.le_func")
# the JAX package's TPU-only tables, which the port does not carry
TPU_ONLY = ("scene.env.cond_inv", "scene.bvh.treelets", "scene.bvh.wtreelets")


def assert_tables_equal(ours, theirs, path=""):
    """Port table (tensors) == JAX-package table (numpy leaves), field by
    field: same None-ness, dtype, shape and values (COMPUTED_ON_DEVICE
    fields to rtol 1e-6)."""
    if path in TPU_ONLY:
        return
    if theirs is None or ours is None:
        assert ours is None and theirs is None, path
    elif isinstance(ours, tuple) and hasattr(ours, "_fields"):
        for f in theirs._fields:
            if f"{path}.{f}" not in TPU_ONLY:
                assert_tables_equal(getattr(ours, f), getattr(theirs, f),
                                    f"{path}.{f}")
        if path == "scene.bvh":
            assert_wide_pack_is_made_from(ours)
    elif isinstance(ours, tuple):  # the texture atlas: a plain tuple
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_tables_equal(a, b, f"{path}[{i}]")
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


def assert_wide_pack_is_made_from(bvh):
    """The width-8 table of a BVH is the GPU pack of its binary tables."""
    want = T_wbvh.build_wide_pack(
        *(getattr(bvh, f).numpy() for f in (
            "offset", "n_prims", "axis", "bounds_lo", "bounds_hi", "prim_idx",
            "leaf_soa")))
    for a, b in zip(bvh.wide, want):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b


SCENES = ["cornell", "sphere", "mixed", "mesh", "mesh_big", "cornell_mesh_bvh",
          "envmap_preset"]


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
    # the one default that differs: a scene built with a BVH casts through it
    # in the port, while the JAX package brute-forces below 32k triangles (a
    # threshold measured on the TPU), so the comparison names use_bvh
    assert T_path.make_config(ts, 32, 32, **kw).use_bvh == (ts.bvh is not None)
    kw["use_bvh"] = js.bvh is not None
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


@pytest.mark.parametrize("wh", [(16, 16), (100, 37)])
def test_halton_sampler_from_numpy(wh):
    """A Halton sampler crosses over with its per-film table and metadata;
    every table equals the JAX package's and the port's own."""
    js = J_smp.make_halton_sampler(8, *wh, seed=2)
    got = convert.sampler_from_numpy(np_tree(js), device="cpu")
    want = T_smp.make_halton_sampler(8, *wh, seed=2, device="cpu")
    for f in T_smp.Sampler._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b, f
    for f in ("pixel_offset", "primes", "prime_sums", "perms"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    assert (got.stride, got.exp2, got.scale3) == (js.stride, js.exp2, js.scale3)
    assert got.kind == "halton" and got.device == "cpu"


@pytest.mark.parametrize("name", ["mesh", "cornell_mesh_bvh"])
def test_carried_bvh_gets_the_packet_pack(name):
    """A JAX BVH crosses over with the binary threaded table made from its
    binary tables: equal to the port's own build, and to what the JAX
    package packs per cast (pack_bvh_for_pallas)."""
    from gnxraytracer_tpu.ops import pallas_bvh as J_pb

    js, _, ts, _ = scene_pair(name)
    got = convert.scene_from_numpy(np_tree(js), device="cpu").bvh
    assert got.treelets is None and got.packet is not None
    for a, b, c in zip(got.packet, ts.bvh.packet,
                       J_pb.pack_bvh_for_pallas(js.bvh)):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    nn = int(js.bvh.offset.shape[0])
    assert tuple(got.packet.meta.shape) == (8, nn, 2)


def test_mesh_scene_carries_bvh_env_textures_and_big_prims():
    """What the mesh path adds to a scene crosses over: the BVH (binary
    tables as they are, the width-8 table made from them), the environment
    map, the texture atlas, and the ids of the triangles kept out of the
    tree."""
    js, _, ts, _ = scene_pair("mesh_big")
    got = convert.scene_from_numpy(np_tree(js), device="cpu")
    assert got.bvh is not None and got.env is not None
    assert got.textures is not None and got.env.cond_inv is None
    np.testing.assert_array_equal(got.big_tri_idx.numpy(),
                                  np.asarray(js.big_tri_idx))
    n_tris = int(js.geom.triangles.shape[0])
    assert got.big_tri_idx.numpy().tolist() == [n_tris - 2, n_tris - 1]
    assert got.bvh.treelets is None
    # carried and own-built tables walk the same tree
    for a, b in zip(got.bvh.wide, ts.bvh.wide):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    ids = got.bvh.wide.tid.numpy()
    assert ids.max() == n_tris - 3 and (ids >= 0).sum() == n_tris - 2
    cfg = T_path.make_config(got, 8, 8, spp=1)
    assert cfg.use_bvh and cfg.n_big == 2 and cfg.has_env and cfg.has_textures
    assert cfg.bvh_mode == "packet"  # CPU tensors: the plain walk


def test_unported_state_is_refused():
    b = J_scene.SceneBuilder()
    med = b.add_homogeneous_medium((0.1, 0.1, 0.1), (0.5, 0.5, 0.5))
    b.add_sphere((0, 0, 0), 1.0, b.add_matte((0.5, 0.5, 0.5)),
                 medium=(med, -1))
    b.add_point_light((0, 3, 0), (10, 10, 10))
    tree = np_tree(b.build())
    # media cross over since the volumetric slice; the spatial light
    # distribution and instancing are refused
    got = convert.scene_from_numpy(tree, device="cpu")
    assert_tables_equal(got.media, tree.media, "scene.media")
    for field in ("light_dist", "instanced"):
        with pytest.raises(NotImplementedError, match=field):
            convert.scene_from_numpy(tree._replace(**{field: ("x",)}),
                                     device="cpu")
    # a tree without octant links (the on-device morton build)
    js, _ = J_presets.cornell_box(16, 16, bvh=True)
    with pytest.raises(NotImplementedError):
        convert.bvh_from_numpy_tree(np_tree(js.bvh)._replace(first8=None),
                                    device="cpu")
    # the Halton sampler crosses over now; an unknown kind is refused
    with pytest.raises(ValueError):
        convert.sampler_from_numpy(
            np_tree(J_smp.make_random_sampler(4))._replace(kind="stratified"),
            device="cpu")
