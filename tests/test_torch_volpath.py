"""Participating media and the volumetric path integrator of the port
(models/media.py, models/integrators/volpath.py) against the JAX package on
the CPU.

Both packages build the scene with their own SceneBuilder (the medium
table is compared field by field) and draw the same samples; the tracking
loops draw from the same counter-based hash stream.  Renders: the Cornell
box with a homogeneous medium in a null-material box (the reference
renderer's `volpath` parity scene) and the procedural-density grid medium
with a glass sphere holding a homogeneous medium (``volumetric_cornell``
without its asset), at the tolerances of tests/test_torch_path.py: >= 99% of
pixels within rtol 1e-3 + atol 1e-4, the mean within 0.5%.

Then the twins of tests/test_tr_walk.py (the shadow ray's boundary walk
against a float64 oracle), the gradients of the medium classes against the
JAX package's (one value_and_grad of the volumetric loss), FD against AD
for sigma_a (twin of TestGradientSurface::test_grad_wrt_medium_sigma), the
train step moving the medium classes, and the golden twins (slow, as their
JAX originals)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnxraytracer_tpu.models import media as J_media
from gnxraytracer_tpu.models.integrators import volpath as J_vol
from gnxraytracer_tpu.ops import samplers as J_smp
from gnxraytracer_tpu.parallel import sharding as J_sh
from gnxraytracer_tpu.scene import camera as J_cam
from gnxraytracer_tpu.scene import presets as J_presets
from gnxraytracer_tpu.scene import scene as J_scene
from gnxraytracer_tpu_torch import convert
from gnxraytracer_tpu_torch.models import media as T_media
from gnxraytracer_tpu_torch.models.integrators import volpath as T_vol
from gnxraytracer_tpu_torch.ops import samplers as T_smp
from gnxraytracer_tpu_torch.parallel import sharding as T_sh
from gnxraytracer_tpu_torch.scene import camera as T_cam
from gnxraytracer_tpu_torch.scene import loaders as T_load
from gnxraytracer_tpu_torch.scene import presets as T_presets
from gnxraytracer_tpu_torch.scene import scene as T_scene

from test_torch_convert import assert_tables_equal, np_tree

W = 16
SPP = 4
CFG = dict(spp=SPP, spp_chunk=SPP, max_depth=5, count_rays=True)

SCENES = {
    "homogeneous": (J_presets.cornell_homogeneous,
                    T_presets.cornell_homogeneous, {}),
    "grid": (J_presets.volumetric_cornell, T_presets.volumetric_cornell,
             dict(use_reference_volume=False)),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def render_pair(request):
    jmake, tmake, kw = SCENES[request.param]
    js, jc = jmake(W, W, **kw)
    ts, tc = tmake(W, W, device="cpu", **kw)
    jcfg = J_vol.make_config(js, W, W, **CFG)
    tcfg = T_vol.make_config(ts, W, W, **CFG)
    jimg, jn = J_vol._render_chunk_jit(js, jc, J_smp.make_sobol_sampler(SPP),
                                       jcfg, 0, SPP)
    timg, tn = T_vol.render_chunk(ts, tc, T_smp.make_sobol_sampler(
        SPP, device="cpu"), tcfg, 0, SPP)
    return dict(js=js, ts=ts, jcfg=jcfg, tcfg=tcfg, jax=np.asarray(jimg),
                torch=timg.numpy(), jax_trunc=float(jn), torch_trunc=float(tn))


def test_configs_and_tables_match(render_pair):
    assert render_pair["tcfg"]._asdict() == render_pair["jcfg"]._asdict()
    assert render_pair["tcfg"].has_media
    assert render_pair["tcfg"].tr_walk_segments == 4
    assert_tables_equal(render_pair["ts"], np_tree(render_pair["js"]), "scene")


def test_render_chunk_pixels_match_jax(render_pair):
    a, b = render_pair["torch"], render_pair["jax"]
    assert a.shape == b.shape == (W * W, 3) and np.isfinite(a).all()
    ok = (np.abs(a - b) <= 1e-4 + 1e-3 * np.abs(b)).all(axis=-1)
    assert ok.mean() >= 0.99, f"{(~ok).sum()} of {ok.size} pixels differ"


def test_render_chunk_mean_matches_jax(render_pair):
    assert render_pair["jax"].mean() > 0.1
    assert abs(render_pair["torch"].mean() / render_pair["jax"].mean()
               - 1.0) < 0.005


def test_truncated_lanes_match_jax(render_pair):
    assert render_pair["torch_trunc"] == render_pair["jax_trunc"]


def test_carried_scene_renders_the_same(render_pair):
    """The JAX scene carried across by convert (media included) renders
    bit for bit what the port's own build renders."""
    carried = convert.scene_from_numpy(np_tree(render_pair["js"]),
                                       device="cpu")
    assert_tables_equal(carried, np_tree(render_pair["js"]), "scene")
    cam = T_cam.make_perspective_camera(W, W, eye=(0.0, 0.0, 5.0),
                                        look=(0.0, 0.0, 0.0), device="cpu")
    img, _ = T_vol.render_chunk(carried, cam, T_smp.make_sobol_sampler(
        SPP, device="cpu"), render_pair["tcfg"], 0, SPP)
    np.testing.assert_array_equal(img.numpy(), render_pair["torch"])


# -- media against the JAX package, one function at a time -----------------------

def test_phase_function_and_its_samples_match_jax():
    rs = np.random.default_rng(0)
    n = 500
    wo = rs.standard_normal((n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    u = rs.uniform(0, 1, (n, 2)).astype(np.float32)
    g = rs.uniform(-0.9, 0.9, n).astype(np.float32)
    g[:20] = 0.0  # the isotropic branch
    jwi, jp = J_media.hg_sample(jnp.asarray(wo), jnp.asarray(u), jnp.asarray(g))
    twi, tp = T_media.hg_sample(torch.from_numpy(wo), torch.from_numpy(u),
                                torch.from_numpy(g))
    np.testing.assert_allclose(twi.numpy(), np.asarray(jwi), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6)


def test_grid_density_matches_jax():
    rs = np.random.default_rng(1)
    dens = rs.uniform(0, 1, (5, 6, 7)).astype(np.float32)
    p = rs.uniform(-0.2, 1.2, (300, 3)).astype(np.float32)
    want = np.asarray(J_media.grid_density(jnp.asarray(dens), jnp.asarray(p)))
    got = T_media.grid_density(torch.from_numpy(dens), torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["homogeneous", "grid"])
def test_sample_medium_and_tr_match_jax(kind):
    """Distance sampling (delta tracking for the grid) and Tr (ratio
    tracking) on rays through each medium, the same hash stream."""
    jmake, tmake, kw = SCENES[kind]
    js, _ = jmake(8, 8, **kw)
    ts, _ = tmake(8, 8, device="cpu", **kw)
    rs = np.random.default_rng(2)
    n = 400
    o = rs.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    o[:, 1] = rs.uniform(-2.6, 0.0, n)
    d = rs.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_surf = rs.uniform(0.1, 4.0, n).astype(np.float32)
    t_surf[:40] = np.inf
    med = np.zeros(n, np.int32)
    med[:30] = -1
    key = np.arange(n, dtype=np.int32) * 7919
    jms = J_media.sample_medium(js.media, jnp.asarray(med), jnp.asarray(o),
                                jnp.asarray(d), jnp.asarray(t_surf),
                                jnp.asarray(key), 3, 0x5EED)
    tms = T_media.sample_medium(ts.media, torch.from_numpy(med),
                                torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(t_surf),
                                torch.from_numpy(key), 3, 0x5EED)
    same = tms.sampled_medium.numpy() == np.asarray(jms.sampled_medium)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(tms.t.numpy()[same], np.asarray(jms.t)[same],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tms.weight.numpy()[same],
                               np.asarray(jms.weight)[same], rtol=1e-4,
                               atol=1e-5)
    t_max = np.minimum(t_surf, 5.0)
    jtr = J_media.medium_tr(js.media, jnp.asarray(med), jnp.asarray(o),
                            jnp.asarray(d), jnp.asarray(t_max),
                            jnp.asarray(key), 5, 0x5EED)
    ttr = T_media.medium_tr(ts.media, torch.from_numpy(med),
                            torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(t_max), torch.from_numpy(key),
                            5, 0x5EED)
    close = np.isclose(ttr.numpy(), np.asarray(jtr), rtol=1e-4,
                       atol=1e-5).all(-1)
    assert close.mean() >= 0.99


def test_load_volume_reads_the_text_format(tmp_path):
    nx, ny, nz = 3, 2, 4
    vals = np.arange(nx * ny * nz, dtype=np.float32) / 10
    f = tmp_path / "grid.volume"
    f.write_text(f"nx {nx} ny {ny} nz {nz}\np0 -1 -2 -3\np1 1 2 3\n"
                 "sigma_a 1 2 3\nsigma_s 4 5 6\n"
                 + " ".join(f"{v:g}" for v in vals) + "\n")
    vol = T_load.load_volume(str(f))
    assert vol["density"].shape == (nz, ny, nx)
    np.testing.assert_array_equal(vol["density"].reshape(-1), vals)
    np.testing.assert_array_equal(vol["sigma_s"], [4, 5, 6])
    np.testing.assert_array_equal(vol["p0"], [-1, -2, -3])
    from gnxraytracer_tpu.scene import loaders as J_load

    jv = J_load.load_volume(str(f))
    for k in jv:
        np.testing.assert_array_equal(vol[k], jv[k], err_msg=k)


def test_gridvol_preset_needs_its_asset(monkeypatch, tmp_path):
    monkeypatch.setenv("GNX_RESOURCES", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="density_render"):
        T_presets.cornell_gridvol(8, 8, device="cpu")


# -- the shadow ray's boundary walk (twins of tests/test_tr_walk.py) --------------

SIG_A = np.array([0.9, 0.5, 0.2])
SIG_B = np.array([0.1, 0.3, 0.6])


def _nested_shells(builder, presets):
    b = builder()
    med_a = b.add_homogeneous_medium(SIG_A * 0.5, SIG_A * 0.5, g=0.0)
    med_b = b.add_homogeneous_medium(SIG_B * 0.5, SIG_B * 0.5, g=0.0)
    vi, fi = presets._box_mesh((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
    vo, fo = presets._box_mesh((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
    b.add_mesh(vi, fi, material=-1, medium=(med_a, med_b))
    b.add_mesh(vo, fo, material=-1, medium=(med_b, -1))
    b.add_point_light((5.0, 0.0, 0.0), (50.0, 50.0, 50.0))
    return b, med_a


def test_walk_matches_analytic_nested_shells():
    b, med_a = _nested_shells(T_scene.SceneBuilder, T_presets)
    scene = b.build(device="cpu")
    cfg = T_vol.make_config(scene, 8, 8, spp=1, max_depth=6,
                            tr_walk_segments=4)
    x0 = np.array([-0.3, 0.0, 0.2, 0.45], np.float32)
    n = len(x0)
    o = torch.from_numpy(np.stack([x0, np.zeros(n), np.zeros(n)],
                                  -1).astype(np.float32))
    d = torch.tensor([[1.0, 0.0, 0.0]]).repeat(n, 1)
    tr, blocked = T_media.transmittance_walk(
        scene, cfg, o, d, torch.full((n,), 4.0),
        torch.full((n,), med_a, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32), 3, 0x5EED)
    assert not blocked.any()
    la = 0.5 - x0.astype(np.float64)
    want = np.exp(-np.outer(la, SIG_A) - 1.0 * SIG_B[None, :])
    np.testing.assert_allclose(tr.numpy(), want, rtol=2e-3)


def test_walk_matches_jax_and_blocks_on_real_material():
    """The walk on the nested shells plus an opaque box, against the JAX
    package's walk: Tr and blocked equal; a ray straight at the box is
    blocked with Tr = 0, one above it is not."""
    outs = []
    for builder, presets, device in (
            (J_scene.SceneBuilder, J_presets, None),
            (T_scene.SceneBuilder, T_presets, "cpu")):
        b, med_a = _nested_shells(builder, presets)
        m = b.add_matte((0.5, 0.5, 0.5))
        vw, fw = presets._box_mesh((1.6, -0.2, -0.2), (1.8, 0.2, 0.2))
        b.add_mesh(vw, fw, material=m)
        o = np.asarray([[0.0, 0.0, 0.0], [0.0, 0.6, 0.0], [0.2, 0.1, 0.1]],
                       np.float32)
        d = np.asarray([[1.0, 0.0, 0.0]] * 3, np.float32)
        if device is None:
            scene = b.build()
            cfg = J_vol.make_config(scene, 8, 8, spp=1, max_depth=6)
            tr, blk = J_media.transmittance_walk(
                scene, cfg, jnp.asarray(o), jnp.asarray(d),
                jnp.full((3,), 4.0), jnp.full((3,), med_a, jnp.int32),
                jnp.arange(3, dtype=jnp.int32), 1, 0)
        else:
            scene = b.build(device=device)
            cfg = T_vol.make_config(scene, 8, 8, spp=1, max_depth=6)
            tr, blk = T_media.transmittance_walk(
                scene, cfg, torch.from_numpy(o), torch.from_numpy(d),
                torch.full((3,), 4.0), torch.full((3,), med_a,
                                                  dtype=torch.int32),
                torch.arange(3, dtype=torch.int32), 1, 0)
        outs.append((np.asarray(tr), np.asarray(blk)))
    (jtr, jblk), (ttr, tblk) = outs
    np.testing.assert_array_equal(tblk, jblk)
    np.testing.assert_allclose(ttr, jtr, rtol=1e-5, atol=1e-7)
    assert tblk[0] and not tblk[1] and ttr[0].max() == 0.0


def test_single_medium_shortcut_is_wrong_here():
    """The current-medium-only Tr disagrees with the walk's oracle on the
    nested shells: the walk is load-bearing."""
    b, med_a = _nested_shells(T_scene.SceneBuilder, T_presets)
    scene = b.build(device="cpu")
    n = 3
    tr_fast = T_media.medium_tr(
        scene.media, torch.full((n,), med_a, dtype=torch.int32),
        torch.zeros((n, 3)), torch.tensor([[1.0, 0.0, 0.0]]).repeat(n, 1),
        torch.full((n,), 4.0), torch.arange(n, dtype=torch.int32), 3, 0)
    want = np.exp(-0.5 * SIG_A - 1.0 * SIG_B)
    assert np.abs(tr_fast.numpy() - want[None, :]).max() > 0.1


def test_volpath_renders_with_walk():
    """The walk changes the image on the nested shells (the shells would
    otherwise be opaque to shadow rays through the thinner medium)."""
    b, _ = _nested_shells(T_scene.SceneBuilder, T_presets)
    m = b.add_matte((0.7, 0.7, 0.7))
    fv, ff = T_presets._box_mesh((-3, -2.2, -3), (3, -2.0, 3))
    b.add_mesh(fv, ff, material=m)
    scene = b.build(device="cpu")
    cam = T_cam.make_perspective_camera(24, 24, eye=(0, 0.3, 5.0),
                                        look=(0, -0.2, 0), device="cpu")
    s = T_smp.make_random_sampler(8, seed=1, device="cpu")
    cfg_w = T_vol.make_config(scene, 24, 24, spp=8, max_depth=6, spp_chunk=8,
                              tr_walk_segments=4)
    img_w = T_vol.render(scene, cam, s, cfg_w).numpy()
    img_0 = T_vol.render(scene, cam, s,
                         cfg_w._replace(tr_walk_segments=0)).numpy()
    assert np.isfinite(img_w).all()
    assert np.abs(img_w - img_0).mean() > 1e-4


# -- gradients of the medium classes -----------------------------------------------

@pytest.fixture(scope="module")
def grad_pair():
    """One jax.value_and_grad of the volumetric loss (the train step's,
    with volpath's estimator) over extract_params on the homogeneous
    scene, and the port's autograd of the same loss."""
    w = 12
    js, jc = J_presets.cornell_homogeneous(w, w)
    ts, tc = T_presets.cornell_homogeneous(w, w, device="cpu")
    kw = dict(spp=8, spp_chunk=8, max_depth=4)
    jcfg = J_vol.make_config(js, w, w, **kw)
    tcfg = T_vol.make_config(ts, w, w, **kw)
    jsmp = J_smp.make_halton_sampler(8, w, w)
    tsmp = T_smp.make_halton_sampler(8, w, w, device="cpu")
    hw = w * w
    target = (np.random.default_rng(3).uniform(0.5, 1.5, (hw, 3))
              * 0.8).astype(np.float32)
    pix = jnp.tile(jnp.arange(hw, dtype=jnp.int32), (8,))
    sidx = jnp.repeat(jnp.arange(8, dtype=jnp.int32), hw)

    def jloss(p):
        sc = J_sh.insert_params(js, p)
        p_film, t_u, l_u = J_smp.camera_sample(jsmp, pix, sidx, w)
        o, d, _ = J_cam.generate_rays(jc, p_film, t_u, l_u)
        L = J_vol.trace_paths(sc, jcfg, jsmp, pix, sidx, o, d)
        img = jnp.mean(L.reshape(8, hw, 3), axis=0)
        return jnp.mean((img - jnp.asarray(target)) ** 2)

    jl, jg = jax.value_and_grad(jloss)(J_sh.extract_params(js))
    step = T_sh.make_train_step(tcfg, device="cpu", integrator="volpath")
    stats = {}
    tl, _ = step(T_sh.extract_params(ts), ts, tc, tsmp, target.reshape(w, w, 3),
                 stats=stats)
    return dict(jax_loss=float(jl), jax={k: np.asarray(v) for k, v in jg.items()},
                port_loss=float(tl),
                port={k: v.numpy() for k, v in stats["grads"].items()})


@pytest.mark.parametrize("key", ["med_sigma_a", "med_sigma_s", "med_g", "kd",
                                 "light_emit"])
def test_medium_grads_match_jax(grad_pair, key):
    """Per class max|g_port - g_jax| <= 1e-4 * max|g_jax| + 1e-7, as for the
    surface classes (tests/test_torch_gradients.py)."""
    a, b = grad_pair["port"][key], grad_pair["jax"][key]
    assert np.abs(b).max() > 0, key
    assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max() + 1e-7, key
    np.testing.assert_allclose(grad_pair["port_loss"], grad_pair["jax_loss"],
                               rtol=1e-5)


def test_grad_wrt_medium_sigma():
    """Twin of TestGradientSurface::test_grad_wrt_medium_sigma: more
    absorption darkens the image; and AD against central FD along sigma_a
    (the same stream both sides; the sampled distance is detached, so the
    event positions do not move with sigma)."""
    b = T_scene.SceneBuilder()
    med = b.add_homogeneous_medium((0.3, 0.3, 0.3), (0.4, 0.4, 0.4))
    vi, fi = T_presets._box_mesh((-1, -1, -1), (1, 1, 1))
    b.add_mesh(vi, fi, material=-1, medium=(med, -1))
    floor = b.add_matte((0.7, 0.7, 0.7))
    fv = np.array([[-3, -1.5, 3], [3, -1.5, 3], [3, -1.5, -3],
                   [-3, -1.5, -3]], np.float32)
    b.add_mesh(fv, np.array([[0, 1, 2], [0, 2, 3]]), floor)
    b.add_point_light((2, 3, 2), (60, 60, 60))
    scene = b.build(device="cpu")
    cam = T_cam.make_perspective_camera(12, 12, eye=(0, 0.3, 4),
                                        look=(0, -0.3, 0), device="cpu")
    cfg = T_vol.make_config(scene, 12, 12, spp=8, max_depth=4, spp_chunk=8)
    s = T_smp.make_random_sampler(8, seed=5, device="cpu")

    def loss(sa):
        sc = scene._replace(media=scene.media._replace(sigma_a=sa))
        return torch.mean(T_vol.render_chunk(sc, cam, s, cfg, 0, 8))

    sa = scene.media.sigma_a.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(sa), sa)
    assert torch.isfinite(g).all()
    assert float(g[0].sum()) < 0
    eps = 1e-2
    with torch.no_grad():
        fd = (loss(scene.media.sigma_a + eps) - loss(scene.media.sigma_a - eps)
              ) / (2 * eps)
    np.testing.assert_allclose(float(g.sum()), float(fd), rtol=0.08)


def test_extract_insert_medium_classes():
    scene, _ = T_presets.cornell_homogeneous(8, 8, device="cpu")
    p = T_sh.extract_params(scene)
    for k in ("med_sigma_a", "med_sigma_s", "med_g"):
        assert k in p
    p2 = dict(p, med_sigma_a=p["med_sigma_a"] * 2, med_g=p["med_g"] + 0.1)
    sc = T_sh.insert_params(scene, p2)
    assert sc.media.sigma_a is p2["med_sigma_a"] and sc.media.g is p2["med_g"]
    assert sc.media.density is None


def test_train_step_moves_the_medium_classes():
    w = 12
    scene, cam = T_presets.cornell_homogeneous(w, w, device="cpu")
    cfg = T_vol.make_config(scene, w, w, spp=4, spp_chunk=4, max_depth=4)
    smp = T_smp.make_halton_sampler(4, w, w, device="cpu")
    hw = w * w
    target = T_sh.pass_image(scene, cam, smp, cfg,
                             torch.arange(hw, dtype=torch.int32), 0,
                             "volpath").reshape(w, w, 3)
    p = T_sh.extract_params(scene)
    p = dict(p, med_sigma_a=p["med_sigma_a"] * 2.0)
    step = T_sh.make_train_step(cfg, device="cpu", integrator="volpath")
    loss, new = step(p, scene, cam, smp, target, lr=1.0)
    for k in ("med_sigma_a", "med_sigma_s", "med_g"):
        assert torch.isfinite(new[k]).all()
        assert float((new[k] - p[k]).abs().max()) > 0, k
    # the surface estimator sees no medium: the JAX step's integrator
    step_path = T_sh.make_train_step(cfg, device="cpu")
    _, new_path = step_path(p, scene, cam, smp, target, lr=1.0)
    assert float((new_path["med_sigma_a"] - p["med_sigma_a"]).abs().max()) \
        == 0.0


# -- the goldens (slow, as their JAX originals; phase 11 of chip_smoke.py runs
# them on the card) ----------------------------------------------------------------

@pytest.mark.slow
def test_volpath_golden():
    """Twin of test_reference_parity.py::test_reference_parity_volpath:
    64x64, 64 spp Halton against ref_volpath_hom (block-8 < 0.025, channel
    means < 0.02)."""
    import chip_smoke as cs

    berr, merr = cs.volpath_golden(torch.device("cpu"))
    assert berr < 0.025 and merr < 0.02, (berr, merr)


@pytest.mark.slow
def test_medium_sigma_gradient_golden():
    """Twin of the ref_grad_med_sigma case of
    test_reference_gradient_parity_breadth: rtol 0.08 against the golden
    where the JAX package's own AD passes it, else within 5% of the JAX
    package's AD (tests/golden/jax_grad_ad.json; chip_smoke.py's rule)."""
    import chip_smoke as cs

    ad, fd = cs.medium_grad_golden(torch.device("cpu"))
    from test_torch_gradients import assert_gradient_golden

    assert_gradient_golden("ref_grad_med_sigma", ad, 0.08)
