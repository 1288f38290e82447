"""Scene features of the port against the JAX package, on the CPU: the
Metal and Plastic materials and the cornell_glass / cornell_metal /
cornell_instanced presets, bump maps, the spatial light distribution, the
CLI's remaining presets, and the gradients of plastic roughness and glass
eta.

The same scenes are built by each package's own SceneBuilder (their tables
are asserted equal) or carried across with convert.py, and rendered with the
same samples.  Tolerances are those of tests/test_torch_path.py for images
(>= 99% of pixels within rtol 1e-3 + atol 1e-4, means within 0.5%) and of
tests/test_torch_shading.py for interactions (rtol 1e-5 + atol 1e-6), unless
stated in place."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnxraytracer_tpu.models import light_dist as J_ld
from gnxraytracer_tpu.models.integrators import path as J_path
from gnxraytracer_tpu.ops import samplers as J_smp
from gnxraytracer_tpu.ops import trace as J_trace
from gnxraytracer_tpu.scene import camera as J_cam
from gnxraytracer_tpu.scene import presets as J_presets
from gnxraytracer_tpu.scene import scene as J_scene
from gnxraytracer_tpu_torch import cli, convert
from gnxraytracer_tpu_torch.models import light_dist as T_ld
from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.ops import samplers as T_smp
from gnxraytracer_tpu_torch.ops import trace as T_trace
from gnxraytracer_tpu_torch.scene import camera as T_cam
from gnxraytracer_tpu_torch.scene import presets as T_presets
from gnxraytracer_tpu_torch.scene import scene as T_scene

from test_torch_convert import assert_tables_equal, np_tree
from test_torch_shading import _thit, close_tuple, tt

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def pixels_agree(ours, theirs, frac=0.99, rtol=1e-3, atol=1e-4):
    ok = (np.abs(ours - theirs) <= atol + rtol * np.abs(theirs)).all(axis=-1)
    assert ok.mean() >= frac, f"{(~ok).sum()} of {ok.size} pixels differ"
    assert abs(ours.mean() / theirs.mean() - 1.0) < 0.005


# -- builder and presets --------------------------------------------------------------

def _fill_materials(b):
    b.add_metal()  # copper
    b.add_metal((0.2, 0.2, 0.8), (0.11, 0.11, 0.11), roughness=0.15,
                remap_rough=0.0)
    b.add_plastic((0.35, 0.12, 0.48), ks=(0.65, 0.88, 0.52), roughness=0.1)
    b.add_plastic((0.5, 0.5, 0.5))
    b.add_sphere((0, 0, 0), 1.0, 0)
    b.add_point_light((0, 3, 0), (10, 10, 10))


def test_metal_and_plastic_rows_match_jax():
    jb, tb = J_scene.SceneBuilder(), T_scene.SceneBuilder()
    _fill_materials(jb)
    _fill_materials(tb)
    assert tb.COPPER_ETA == jb.COPPER_ETA and tb.COPPER_K == jb.COPPER_K
    assert_tables_equal(tb.build(device="cpu").materials,
                        jb.build().materials, "scene.materials")


PRESETS = {
    "cornell_glass": dict(),
    "cornell_metal": dict(),
    "cornell_instanced": dict(),
    "cornell_instanced_bvh": dict(bvh=True),
    "cornell_instanced_flat": dict(flatten=True, n_inst=2),
}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_presets_make_equal_tables(name):
    fn = name if name in ("cornell_glass", "cornell_metal") else \
        "cornell_instanced"
    js, jc = getattr(J_presets, fn)(16, 16, **PRESETS[name])
    ts, tc = getattr(T_presets, fn)(16, 16, device="cpu", **PRESETS[name])
    assert_tables_equal(ts, js, "scene")
    assert_tables_equal(tc, jc, "camera")
    jcfg = J_path.make_config(js, 16, 16, spp=1, use_bvh=False)
    tcfg = T_path.make_config(ts, 16, 16, spp=1, use_bvh=False)
    assert jcfg._asdict() == tcfg._asdict()


def test_instances_count_in_the_config_and_the_bounds():
    scene, _ = T_presets.cornell_instanced(8, 8, n_inst=4, device="cpu")
    cfg = T_path.make_config(scene, 8, 8, spp=1)
    assert (cfg.n_inst, cfg.n_inst_tris) == (4, 12)
    assert cfg.mat_kinds == (T_scene.MAT_MATTE,)
    b = T_scene.SceneBuilder()
    v, f = T_presets._box_mesh((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
    far = np.eye(4)
    far[:3, 3] = [10.0, 0.0, 0.0]
    b.add_instances(v, f, far[None], material=b.add_metal())
    with pytest.raises(ValueError, match="one instanced mesh"):
        b.add_instances(v, f, far[None])
    scene = b.build(device="cpu")
    # the world sphere holds the transformed instance (x up to 10.5)
    assert float(scene.world_center[0] + scene.world_radius) >= 10.5 - 1e-5
    assert T_path.make_config(scene, 8, 8, spp=1).mat_kinds == (
        T_scene.MAT_METAL,)


# -- images against the JAX package ----------------------------------------------------

W = 24
SPP = 3


@pytest.mark.parametrize("name", ["cornell_metal", "cornell_glass"])
def test_material_presets_render_as_jax(name):
    js, jc = getattr(J_presets, name)(W, W)
    ts, tc = getattr(T_presets, name)(W, W, device="cpu")
    kw = dict(spp=SPP, spp_chunk=SPP, max_depth=5, fast_mis=True,
              count_rays=True, use_pallas=False)
    jcfg = J_path.make_config(js, W, W, **kw)
    tcfg = T_path.make_config(ts, W, W, **kw)
    assert jcfg._asdict() == tcfg._asdict()
    jimg, _ = J_path._render_chunk_jit(js, jc, J_smp.make_sobol_sampler(SPP),
                                       jcfg, 0, SPP)
    timg, _ = T_path.render_chunk(ts, tc, T_smp.make_sobol_sampler(
        SPP, device="cpu"), tcfg, 0, SPP)
    assert np.isfinite(timg.numpy()).all()
    pixels_agree(timg.numpy(), np.asarray(jimg))


def test_cornell_glass_meets_the_jax_golden():
    """tests/golden/cornell_glass_path_32.npy (the JAX package's golden:
    32x32, 8 spp Halton, depth 8, the faithful estimator) at its own
    tolerance, rtol 2e-3 + atol 2e-4, on >= 98% of pixels, and the mean
    within 0.1%: a lane whose refraction or Russian-roulette decision falls
    the other way carries a whole different sample down a depth-8 glass
    path (measured 99.0% of pixels, mean 3e-5 off)."""
    ts, tc = T_presets.cornell_glass(32, 32, device="cpu")
    cfg = T_path.make_config(ts, 32, 32, spp=8, max_depth=8, spp_chunk=8)
    img = T_path.render(ts, tc, T_smp.make_halton_sampler(8, 32, 32,
                                                          device="cpu"),
                        cfg).numpy()
    ref = np.load(os.path.join(GOLDEN, "cornell_glass_path_32.npy"))
    ok = (np.abs(img - ref) <= 2e-4 + 2e-3 * np.abs(ref)).all(axis=-1)
    assert ok.mean() >= 0.98, f"{(~ok).sum()} of {ok.size} pixels off"
    assert abs(img.mean() / ref.mean() - 1.0) < 1e-3


# -- the spatial light distribution ------------------------------------------------------

@pytest.fixture(scope="module")
def spatial():
    """Cornell without the skybox (as the JAX test: the skybox's tiny pmf
    makes the estimator heavy-tailed), each package's own grid."""
    js, jc = J_presets.cornell_box(width=16, height=16, skybox=False)
    ts, tc = T_presets.cornell_box(width=16, height=16, skybox=False,
                                   device="cpu")
    kw = dict(spp=32, max_depth=3, spp_chunk=32, light_strategy="spatial")
    jcfg = J_path.make_config(js, 16, 16, **kw)
    tcfg = T_path.make_config(ts, 16, 16, **kw)
    jd = J_ld.build_spatial_distribution(js, jcfg, res=8, n_samples=16)
    td = T_ld.build_spatial_distribution(ts, tcfg, res=8, n_samples=16)
    return dict(js=js, jc=jc, ts=ts, tc=tc, jcfg=jcfg, tcfg=tcfg, jd=jd,
                td=td)


def test_spatial_grid_matches_jax(spatial):
    """The voxel CDFs: each package averages its own float32 estimates
    (summation order), so rtol 1e-5."""
    jd, td = spatial["jd"], spatial["td"]
    assert td.res == tuple(jd.res) == (8, 8, 8)
    for f in ("cdf", "pmf", "lo", "inv_extent"):
        np.testing.assert_allclose(getattr(td, f).numpy(),
                                   np.asarray(getattr(jd, f)), rtol=1e-5,
                                   atol=1e-7, err_msg=f)
    # voxels differ: the two area lights are not everywhere equally useful
    assert np.ptp(td.pmf.numpy()[:, 0]) > 0.1


def test_spatial_choose_light_matches_jax(spatial):
    """On the JAX package's grid carried across: identical choices."""
    rs = np.random.RandomState(5)
    p = ((rs.rand(4000, 3) - 0.5) * 6).astype(np.float32)
    u = rs.rand(4000).astype(np.float32)
    jd = spatial["jd"]
    got = T_ld.spatial_choose_light(
        convert.scene_from_numpy(np_tree(spatial["js"]._replace(
            light_dist=jd)), device="cpu").light_dist, tt(p), tt(u))
    want = J_ld.spatial_choose_light(jd, jnp.asarray(p), jnp.asarray(u))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-7)


def test_spatial_render_matches_jax(spatial):
    """path.render with the spatial strategy: the JAX package's scene and
    grid carried across against the JAX render, and the port's own grid by
    the JAX test's rule (mean within 10% of the uniform strategy's, the
    walls' colours where they belong)."""
    js, jc, jcfg = spatial["js"], spatial["jc"], spatial["jcfg"]
    js2 = js._replace(light_dist=spatial["jd"])
    jimg = np.asarray(J_path.render(js2, jc, J_smp.make_random_sampler(
        32, seed=2), jcfg))
    ts2 = convert.scene_from_numpy(np_tree(js2), device="cpu")
    smp = T_smp.make_random_sampler(32, seed=2, device="cpu")
    img = T_path.render(ts2, spatial["tc"], smp, spatial["tcfg"]).numpy()
    pixels_agree(img, jimg)
    own = T_path.render(spatial["ts"]._replace(light_dist=spatial["td"]),
                        spatial["tc"], smp, spatial["tcfg"]).numpy()
    uni = T_path.render(spatial["ts"], spatial["tc"], smp, spatial["tcfg"]
                        ._replace(light_strategy="uniform")).numpy()
    assert np.isfinite(own).all() and own.mean() > 0.05
    assert abs(own.mean() - uni.mean()) / uni.mean() < 0.1
    left, right = own[5:11, 2:6], own[5:11, 10:14]
    assert left[..., 2].mean() > 3 * left[..., 0].mean()
    assert right[..., 0].mean() > 3 * right[..., 2].mean()


def test_spatial_without_a_grid_is_the_power_strategy(spatial):
    ts, cfg = spatial["ts"], spatial["tcfg"]
    u = torch.rand(500, generator=torch.Generator().manual_seed(0))
    p = torch.zeros((500, 3))
    power = cfg._replace(light_strategy="power")
    for got, want in zip(T_path._choose_light(ts, cfg, u, p),
                         T_path._choose_light(ts, power, u, p)):
        assert torch.equal(got, want)
    with_grid = ts._replace(light_dist=spatial["td"])
    for got, want in zip(T_path._choose_light(with_grid, cfg, u),
                         T_path._choose_light(ts, power, u)):
        assert torch.equal(got, want)  # no position given: power


# -- bump maps --------------------------------------------------------------------------

def _bump_quad(b):
    y, x = np.mgrid[0:64, 0:64] / 64.0
    h = (0.5 + 0.5 * np.sin(x * 20) * np.sin(y * 20)).astype(np.float32)
    t = b.add_texture(np.stack([h] * 3, -1))
    m = b.add_material(0, kd=(0.8, 0.8, 0.8), bump_tex=t, bump_scale=1.0)
    v = np.array([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]], np.float32)
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    b.add_mesh(v, np.array([[0, 1, 2], [0, 2, 3]], np.int32), m, uvs=uv)
    b.add_point_light((3, 3, 4), (60, 60, 60))


@pytest.fixture(scope="module")
def bump():
    jb, tb = J_scene.SceneBuilder(), T_scene.SceneBuilder()
    _bump_quad(jb)
    _bump_quad(tb)
    kw = dict(eye=(0, 0, 4.0), look=(0, 0, 0))
    js, ts = jb.build(), tb.build(device="cpu")
    jc = J_cam.make_perspective_camera(32, 32, **kw)
    tc = T_cam.make_perspective_camera(32, 32, device="cpu", **kw)
    jcfg = J_path.make_config(js, 32, 32, spp=4, max_depth=1, spp_chunk=4)
    tcfg = T_path.make_config(ts, 32, 32, spp=4, max_depth=1, spp_chunk=4)
    assert jcfg._asdict() == tcfg._asdict() and tcfg.has_bump
    return dict(js=js, ts=ts, jc=jc, tc=tc, jcfg=jcfg, tcfg=tcfg)


def test_bump_interaction_matches_jax(bump):
    rs = np.random.RandomState(6)
    n = 3000
    o = np.tile(np.float32([0, 0, 4.0]), (n, 1))
    tgt = np.concatenate([rs.uniform(-2, 2, (n, 2)), np.zeros((n, 1))], 1)
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    t_max = np.full(n, 1e30, np.float32)
    jh = J_trace.scene_intersect(bump["js"], bump["jcfg"], jnp.asarray(o),
                                 jnp.asarray(d), jnp.asarray(t_max))
    jit_ = J_trace.make_interaction(bump["js"], bump["jcfg"], jnp.asarray(o),
                                    jnp.asarray(d), jh)
    tit = T_trace.make_interaction(bump["ts"], bump["tcfg"], tt(o), tt(d),
                                   _thit(jh))
    h = np.asarray(jh.hit)
    assert h.all()
    # the height differences divide by half a texel: rtol 1e-4 + atol 1e-5
    close_tuple(tit, jit_, h, rtol=1e-4, atol=1e-5)
    flat = T_trace.make_interaction(bump["ts"], bump["tcfg"]._replace(
        has_bump=False), tt(o), tt(d), _thit(jh))
    assert (tit.ns - flat.ns).abs().max() > 0.1  # the normal moved


def test_bump_render_matches_jax_and_changes_shading(bump):
    """Twin of TestSpatialStrategy::test_bump_mapping_changes_shading: the
    bumped render against the JAX package's, and against the flat one."""
    smp = T_smp.make_random_sampler(4, device="cpu")
    img = T_path.render(bump["ts"], bump["tc"], smp, bump["tcfg"]).numpy()
    jimg = np.asarray(J_path.render(bump["js"], bump["jc"],
                                    J_smp.make_random_sampler(4),
                                    bump["jcfg"]))
    pixels_agree(img, jimg)
    flat = T_path.render(bump["ts"], bump["tc"], smp,
                         bump["tcfg"]._replace(has_bump=False)).numpy()
    assert np.isfinite(img).all()
    assert np.abs(img - flat).max() > 0.1


# -- the CLI -----------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["cornell-glass", "metal", "volume"])
def test_cli_renders_the_new_presets(preset, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("GNX_RESOURCES", raising=False)
    npy = tmp_path / "x.npy"
    argv = ["render", "--preset", preset, "--width", "12", "--height", "12",
            "--spp", "1", "--spp-chunk", "1", "--max-depth", "3", "--cpu",
            "--out-npy", str(npy)]
    if preset == "volume":
        argv += ["--integrator", "volpath"]
    cli.main(argv)
    img = np.load(npy)
    assert img.shape == (12, 12, 3) and np.isfinite(img).all()
    assert img.mean() > 0.01
    assert '"device": "cpu"' in capsys.readouterr().out


def test_cli_gridvol_names_the_missing_file(tmp_path, monkeypatch):
    monkeypatch.setenv("GNX_RESOURCES", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        cli.main(["render", "--preset", "gridvol", "--width", "8", "--height",
                  "8", "--spp", "1", "--cpu"])
    assert "density_render.70.volume" in str(e.value)


# -- gradients against the JAX package's AD -------------------------------------------

def _jax_grad(scene, cam, cfg, smp, col_names):
    def loss(x):
        sc = scene._replace(materials=scene.materials._replace(
            **{c: x for c in col_names}))
        img = J_path.render_chunk(sc, cam, smp, cfg, 0, cfg.spp_chunk)
        return jnp.mean(img / cfg.spp_chunk)

    return np.asarray(jax.grad(loss)(getattr(scene.materials, col_names[0])))


def _port_grad(scene, cam, cfg, smp, col_names):
    x = getattr(scene.materials, col_names[0]).clone().requires_grad_(True)
    sc = scene._replace(materials=scene.materials._replace(
        **{c: x for c in col_names}))
    img = T_path.render_chunk(sc, cam, smp, cfg, 0, cfg.spp_chunk)
    (g,) = torch.autograd.grad(torch.mean(img / cfg.spp_chunk), x)
    return g.numpy()


def _plastic_plane(pkg_scene, pkg_cam, **dev):
    b = pkg_scene.SceneBuilder()
    m = b.add_plastic((0.4, 0.4, 0.4), roughness=0.3)
    fv = np.array([[-2, -1, 2], [2, -1, 2], [2, -1, -2], [-2, -1, -2]],
                  np.float32)
    b.add_mesh(fv, np.array([[0, 1, 2], [0, 2, 3]]), m)
    b.add_point_light((1.5, 2.0, 1.5), (30, 30, 30))
    return b.build(**dev), pkg_cam.make_perspective_camera(
        16, 16, eye=(0, 0.5, 3), look=(0, -0.5, 0), **dev)


def _recorded_glass_eta(js, jc, jcfg, cols):
    """The JAX package's AD of the glass twin, recorded by
    tests/jax_glass_eta_grad.py: XLA's CPU compile of this graph takes about
    ten minutes."""
    with open(os.path.join(GOLDEN, "jax_grad_glass_eta.json")) as f:
        rec = json.load(f)
    assert (rec["width"], rec["height"], rec["spp"], rec["max_depth"],
            rec["spp_chunk"]) == (jcfg.width, jcfg.height, jcfg.spp,
                                  jcfg.max_depth, jcfg.spp_chunk)
    assert not jcfg.fast_mis and rec["estimator"] == "faithful"
    return np.asarray(rec["grad_eta"], np.float32)


GRADS = {
    # twin of TestGradientSurface.test_grad_wrt_roughness
    "plastic_roughness": (lambda: _plastic_plane(J_scene, J_cam),
                          lambda: _plastic_plane(T_scene, T_cam, device="cpu"),
                          dict(spp=16, max_depth=2, spp_chunk=16),
                          ("rough_u", "rough_v"), _jax_grad),
    # twin of TestGradientSurface.test_grad_wrt_eta_finite_and_nonzero
    "glass_eta": (lambda: J_presets.cornell_glass(16, 16),
                  lambda: T_presets.cornell_glass(16, 16, device="cpu"),
                  dict(spp=16, max_depth=4, spp_chunk=16), ("eta",),
                  lambda js, jc, jcfg, smp, cols: _recorded_glass_eta(
                      js, jc, jcfg, cols)),
}


@pytest.mark.parametrize("name", sorted(GRADS))
def test_gradient_matches_jax_ad(name):
    """The port's AD within 5% of the JAX package's AD (of the largest
    element), finite, and non-zero, on the same scene, samples and loss."""
    jmake, tmake, kw, cols, jax_ad = GRADS[name]
    js, jc = jmake()
    ts, tc = tmake()
    jcfg = J_path.make_config(js, 16, 16, **kw)
    tcfg = T_path.make_config(ts, 16, 16, **kw)
    assert jcfg._asdict() == tcfg._asdict()
    want = jax_ad(js, jc, jcfg, J_smp.make_halton_sampler(16, 16, 16), cols)
    got = _port_grad(ts, tc, tcfg, T_smp.make_halton_sampler(
        16, 16, 16, device="cpu"), cols)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05 * scale)
