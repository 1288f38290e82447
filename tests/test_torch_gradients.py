"""Gradients and the train step of the port (parallel/sharding.py) against
the JAX package's on the CPU.

Both packages build the same scene with their own SceneBuilder (tables equal,
tests/test_torch_convert.py) and draw the same samples (bit-equal,
tests/test_torch_samplers.py).  Each side differentiates one loss, the JAX
train step's: the mean squared error between the per-pixel sample mean of
the faithful estimator and a target made from a seed, over the WHOLE
parameter dict of extract_params.  The JAX side is one jax.value_and_grad,
computed once a scene in a module-scoped fixture (one XLA compile); the
port's is autograd through ``sharding.pass_image``.

Scenes: the Cornell box at 16x16, depth 3, 32 spp, Halton (the setup of
tests/test_gradients.py), and ``presets.envmap_mesh(8, 8, mesh_tris=50)``
with a procedural HDR file written here and handed to both packages (Disney
blob, textured floor, environment light: every class of extract_params).

Tolerance per class: max|g_port - g_jax| <= 1e-4 * max|g_jax| + 1e-7.  The
rays, hits and sampled directions are the same on both sides and depend on
no parameter; what differs is the order of float sums (XLA contracts FMAs
and fuses reductions, eager PyTorch does neither) and the order of the
scatter-adds of the gathers' transposes.  Measured about 1e-6 relative on
Cornell.

Then the port alone: the FD-against-AD twins of tests/test_gradients.py
(the same rtol), the train step against the JAX train step, a step that
lowers the loss, and one pass against four (rtol 1e-5: only the order of the
gradient sums differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnxraytracer_tpu.models.integrators import path as J_path
from gnxraytracer_tpu.ops import samplers as J_smp
from gnxraytracer_tpu.parallel import sharding as J_sh
from gnxraytracer_tpu.scene import camera as J_cam
from gnxraytracer_tpu.scene import presets as J_presets
from gnxraytracer_tpu_torch import convert
from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.ops import samplers as T_smp
from gnxraytracer_tpu_torch.parallel import sharding as T_sh
from gnxraytracer_tpu_torch.scene import camera as T_cam
from gnxraytracer_tpu_torch.scene import presets as T_presets
from gnxraytracer_tpu_torch.scene import scene as T_scene

from chip_smoke import write_procedural_hdr
from test_torch_convert import np_tree, procedural_hdr

RTOL_CLASS = 1e-4
ATOL_CLASS = 1e-7


def _target(shape, scale, seed):
    return (np.random.default_rng(seed).uniform(0.5, 1.5, shape)
            * scale).astype(np.float32)


def _jax_loss(cfg, scene, cam, smp, target):
    """The JAX train step's loss_fn (parallel/sharding.py:155-166) over the
    param dict, line for line, for one device (it is a closure there):
    pixels tiled spp_chunk times, the default box filter, camera rays
    without differentials, the faithful estimator."""
    hw = cfg.width * cfg.height
    pixel = jnp.arange(hw, dtype=jnp.int32)
    n = cfg.spp_chunk
    pix = jnp.tile(pixel, (n,))
    smp_idx = jnp.repeat(jnp.arange(n, dtype=jnp.int32), hw)

    def loss(p):
        sc = J_sh.insert_params(scene, p)
        p_film, t_u, l_u = J_smp.camera_sample(smp, pix, smp_idx, cfg.width)
        o, d, _ = J_cam.generate_rays(cam, p_film, t_u, l_u)
        L = J_path.trace_paths(sc, cfg, smp, pix, smp_idx, o, d)
        img = jnp.mean(L.reshape(n, hw, 3), axis=0)
        return jnp.mean((img - target.reshape(hw, 3)) ** 2)
    return loss


def _port_grads(cfg, scene, cam, smp, target, params):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    hw = cfg.width * cfg.height
    pixel = torch.arange(hw, dtype=torch.int32)
    img = T_sh.pass_image(T_sh.insert_params(scene, leaves), cam, smp, cfg,
                          pixel, 0)
    loss = torch.sum((img - torch.from_numpy(target).reshape(hw, 3)) ** 2) \
        / (3 * hw)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return float(loss.detach()), {
        k: (torch.zeros_like(leaves[k]) if g is None else g)
        for k, g in zip(leaves, grads)}


def _twin(js, jc, jsmp, jcfg, ts, tc, tsmp, tcfg, seed):
    assert tcfg._asdict() == jcfg._asdict()
    jp = J_sh.extract_params(js)
    tp = T_sh.extract_params(ts)
    mean = float(np.asarray(J_path.render_chunk(
        js, jc, jsmp, jcfg, 0, jcfg.spp_chunk)).mean()) / jcfg.spp_chunk
    target = _target((jcfg.height, jcfg.width, 3), mean, seed)
    jl, jg = jax.value_and_grad(_jax_loss(jcfg, js, jc, jsmp,
                                          jnp.asarray(target)))(jp)
    tl, tg = _port_grads(tcfg, ts, tc, tsmp, target, tp)
    return dict(js=js, jc=jc, jsmp=jsmp, jcfg=jcfg, ts=ts, tc=tc, tsmp=tsmp,
                tcfg=tcfg, target=target, jax_loss=float(jl),
                jax_grads={k: np.asarray(v) for k, v in jg.items()},
                port_loss=tl, port_grads={k: v.numpy() for k, v in tg.items()})


@pytest.fixture(scope="module")
def cornell():
    w = h = 16
    js, jc = J_presets.cornell_box(width=w, height=h)
    ts, tc = T_presets.cornell_box(w, h, device="cpu")
    kw = dict(spp=32, max_depth=3, spp_chunk=32)
    return _twin(js, jc, J_smp.make_halton_sampler(32, w, h),
                 J_path.make_config(js, w, h, **kw), ts, tc,
                 T_smp.make_halton_sampler(32, w, h, device="cpu"),
                 T_path.make_config(ts, w, h, **kw), seed=1)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    w = h = 8
    hdr = write_procedural_hdr(
        str(tmp_path_factory.mktemp("hdr") / "env.hdr"), h=16, w=32)
    js, jc = J_presets.envmap_mesh(w, h, mesh_tris=50, hdr_path=hdr)
    ts, tc = T_presets.envmap_mesh(w, h, mesh_tris=50, hdr_path=hdr,
                                   device="cpu")
    kw = dict(spp=4, max_depth=3, spp_chunk=4, use_bvh=True)
    return _twin(js, jc, J_smp.make_sobol_sampler(4),
                 J_path.make_config(js, w, h, bvh_mode="packet", **kw),
                 ts, tc, T_smp.make_sobol_sampler(4, device="cpu"),
                 T_path.make_config(ts, w, h, **kw), seed=2)


# the classes the JAX package's multichip dry run asks to move on this
# scene, and the Disney parameters of the blob
MESH_CLASSES = ("kd", "rough_u", "metallic", "env_image", "tex_atlas")


def _assert_class_close(twin, key):
    a, b = twin["port_grads"][key], twin["jax_grads"][key]
    assert a.shape == b.shape and np.isfinite(a).all()
    err = np.abs(a - b).max()
    assert err <= RTOL_CLASS * np.abs(b).max() + ATOL_CLASS, (
        key, err, np.abs(b).max())


@pytest.mark.parametrize("key", T_sh._MAT_PARAM_COLS + ("light_emit",))
def test_cornell_grads_match_jax(cornell, key):
    _assert_class_close(cornell, key)


@pytest.mark.parametrize("key", T_sh._MAT_PARAM_COLS
                         + ("light_emit", "env_image", "tex_atlas"))
def test_mesh_grads_match_jax(mesh, key):
    _assert_class_close(mesh, key)


@pytest.mark.parametrize("scene", ["cornell", "mesh"])
def test_losses_match_jax(scene, request):
    twin = request.getfixturevalue(scene)
    np.testing.assert_allclose(twin["port_loss"], twin["jax_loss"], rtol=1e-5)


def test_the_param_classes_carry_signal(cornell, mesh):
    """The comparison is not of zeros: the classes each scene exercises
    have gradients, as in the JAX package."""
    for key in ("kd", "sigma", "light_emit"):
        assert np.abs(cornell["jax_grads"][key]).max() > 0, key
    for key in MESH_CLASSES:
        assert np.abs(mesh["jax_grads"][key]).max() > 0, key


def test_params_from_numpy_is_extract_params(mesh):
    """The JAX extract_params pytree carried across equals the port's own
    extract_params on the scene built by the port's builder."""
    carried = convert.params_from_numpy(
        np_tree(J_sh.extract_params(mesh["js"])), device="cpu")
    own = T_sh.extract_params(mesh["ts"])
    assert set(carried) == set(own)
    for k in own:
        assert carried[k].dtype == own[k].dtype, k
        np.testing.assert_array_equal(carried[k].numpy(), own[k].numpy(),
                                      err_msg=k)


def test_extract_insert_roundtrip_covers_all_classes():
    """Twin of the JAX test of the same name, with the environment from an
    in-code HDR array: every class is there, and insert_params puts the
    tensors in place (the packed env table's rgb channels too)."""
    b = T_scene.SceneBuilder()
    mat = b.add_disney((0.6, 0.5, 0.45), rough_u=0.35, metallic=0.1)
    tex = b.add_texture(np.full((8, 8, 3), 0.4, np.float32))
    floor = b.add_matte((1.0, 1.0, 1.0), kd_tex=tex)
    b.add_sphere((0.0, 0.0, 0.0), 1.0, mat)
    quad = np.array([[-3, -1, 3], [3, -1, 3], [3, -1, -3], [-3, -1, -3]],
                    np.float32)
    b.add_mesh(quad, np.array([[0, 1, 2], [0, 2, 3]]), floor,
               uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
    b.set_environment(procedural_hdr())
    scene = b.build(device="cpu")
    p = T_sh.extract_params(scene)
    for k in ("kd", "rough_u", "eta", "metallic", "sheen", "clearcoat",
              "light_emit", "env_image", "tex_atlas"):
        assert k in p, k
    p2 = {k: v * 2.0 for k, v in p.items()}
    sc2 = T_sh.insert_params(scene, p2)
    np.testing.assert_allclose(sc2.materials.metallic.numpy(),
                               2.0 * scene.materials.metallic.numpy())
    assert sc2.textures[0] is p2["tex_atlas"]
    assert sc2.env.image is p2["env_image"]
    np.testing.assert_array_equal(sc2.env.le_func[..., :3].numpy(),
                                  p2["env_image"].numpy())
    np.testing.assert_array_equal(sc2.env.le_func[..., 3:].numpy(),
                                  scene.env.le_func[..., 3:].numpy())
    sc1 = T_sh.insert_params(scene, {k: v * 1.0 for k, v in p.items()})
    np.testing.assert_array_equal(sc1.materials.metallic.numpy(),
                                  scene.materials.metallic.numpy())


# -- the train step -------------------------------------------------------------

def test_train_step_matches_the_jax_step(cornell):
    """make_train_step against the JAX make_train_step on a one-device mesh:
    the same loss, and the same updated parameters within 5e-3 of each
    class's largest move.  That tolerance is the JAX step's own: jitted over
    the mesh, XLA fuses the backward differently from the un-jitted
    value_and_grad above, and the two JAX gradients differ by up to 3.7e-4
    (kd) and 2.3e-3 (sigma) of the class's largest element, where the
    port's differs from the un-jitted one by 4e-7 and 1.2e-6."""
    mesh1 = J_sh.make_mesh(1)
    jstep = J_sh.make_train_step(cornell["jcfg"], mesh1)
    jp = J_sh.extract_params(cornell["js"])
    lr = 5.0
    jl, jnew = jstep(jp, cornell["js"], cornell["jc"], cornell["jsmp"],
                     jnp.asarray(cornell["target"]), lr=lr)
    step = T_sh.make_train_step(cornell["tcfg"], device="cpu")
    tp = T_sh.extract_params(cornell["ts"])
    tl, tnew = step(tp, cornell["ts"], cornell["tc"], cornell["tsmp"],
                    cornell["target"], lr=lr)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in tp:
        a, b = tnew[k].numpy(), np.asarray(jnew[k])
        moved = np.abs(np.asarray(jp[k]) - b).max()
        assert np.abs(a - b).max() <= 5e-3 * moved + 1e-7, k
        assert not tnew[k].requires_grad
        # the caller's tensors are left as they were
        np.testing.assert_array_equal(tp[k].numpy(),
                                      np.asarray(jp[k]), err_msg=k)


def test_passes_are_the_same_function(cornell):
    """Four passes of four pixel rows against one pass of all sixteen: the
    same loss and update up to the order of float sums."""
    cfg = cornell["tcfg"]
    p = {k: cornell["ts"].materials.kd if k == "kd" else v
         for k, v in T_sh.extract_params(cornell["ts"]).items()}
    args = (p, cornell["ts"], cornell["tc"], cornell["tsmp"],
            cornell["target"])
    one = T_sh.make_train_step(cfg, device="cpu")
    four = T_sh.make_train_step(cfg, device="cpu",
                                lane_budget=4 * cfg.width * cfg.spp_chunk)
    assert len(T_sh.pixel_passes(cfg, 4 * cfg.width * cfg.spp_chunk)) == 4
    l1, p1 = one(*args, lr=1.0)
    l4, p4 = four(*args, lr=1.0)
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-5)
    for k in p:
        g1 = (p[k] - p1[k]).numpy()
        g4 = (p[k] - p4[k]).numpy()
        np.testing.assert_allclose(g4, g1, rtol=1e-5,
                                   atol=1e-5 * np.abs(g1).max() + 1e-12,
                                   err_msg=k)


def test_pixel_passes_cover_the_image_in_rows():
    cfg = T_path.RenderCfg(width=10, height=7, spp=4, spp_chunk=4)
    assert T_sh.pixel_passes(cfg, 10 ** 9) == [(0, 70)]
    passes = T_sh.pixel_passes(cfg, 3 * 40 + 39)
    assert passes == [(0, 30), (30, 60), (60, 70)]
    with pytest.raises(MemoryError, match="one pixel row"):
        T_sh.pixel_passes(cfg, 39)
    # tail compaction couples a wavefront's lanes: one pass only
    scene, cam = T_presets.cornell_box(8, 8, device="cpu")
    ccfg = T_path.make_config(scene, 8, 8, spp=1, spp_chunk=1, max_depth=1,
                              compact_tail=True)
    step = T_sh.make_train_step(ccfg, device="cpu", lane_budget=8)
    with pytest.raises(ValueError, match="compact_tail"):
        step(T_sh.extract_params(scene), scene, cam,
             T_smp.make_sobol_sampler(1, device="cpu"),
             np.zeros((8, 8, 3), np.float32))


def test_train_step_reduces_loss(cornell):
    """Twin of tests/test_gradients.py::test_train_step_reduces_loss: kd
    moved off the truth, one step back toward a target rendered with the
    true kd lowers the loss."""
    cfg, scene = cornell["tcfg"], cornell["ts"]
    hw = cfg.width * cfg.height
    target = T_sh.pass_image(scene, cornell["tc"], cornell["tsmp"], cfg,
                             torch.arange(hw, dtype=torch.int32), 0)
    target = target.reshape(cfg.height, cfg.width, 3)
    kd_wrong = torch.clamp(scene.materials.kd + 0.2, 0.0, 1.0)
    step = T_sh.make_train_step(cfg, device="cpu")
    p = {"kd": kd_wrong}
    l0, p1 = step(p, scene, cornell["tc"], cornell["tsmp"], target, lr=2.0)
    l1, _ = step(p1, scene, cornell["tc"], cornell["tsmp"], target, lr=2.0)
    assert float(l1) < float(l0), (float(l0), float(l1))


def test_step_runs_where_it_is_asked(cornell):
    step = T_sh.make_train_step(cornell["tcfg"], device="cpu")
    assert callable(step)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T_sh.make_train_step(cornell["tcfg"])
    assert T_sh.default_lane_budget(cornell["tcfg"], torch.device("cpu")) \
        == 16 * 16 * 32


# -- FD against AD in the port (twins of tests/test_gradients.py) ----------------

def _mean_loss(cornell, **replace):
    scene = cornell["ts"]
    cfg = cornell["tcfg"]
    mats = scene.materials._replace(**{k: v for k, v in replace.items()
                                       if k != "emit"})
    lights = scene.lights
    if "emit" in replace:
        lights = lights._replace(emit=replace["emit"])
    img = T_path.render_chunk(scene._replace(materials=mats, lights=lights),
                              cornell["tc"], cornell["tsmp"], cfg, 0,
                              cfg.spp_chunk)
    return torch.mean(img / cfg.spp_chunk)


def test_grad_wrt_kd_matches_fd(cornell):
    kd0 = cornell["ts"].materials.kd.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(_mean_loss(cornell, kd=kd0), kd0)
    assert torch.isfinite(g).all()
    eps = 1e-2
    e = torch.zeros_like(kd0)
    e[0, 0] = eps
    with torch.no_grad():
        fd = (_mean_loss(cornell, kd=kd0 + e)
              - _mean_loss(cornell, kd=kd0 - e)) / (2 * eps)
    np.testing.assert_allclose(float(g[0, 0]), float(fd), rtol=0.08, atol=1e-5)
    assert float(g[0, 0]) > 0


def test_grad_wrt_light_emission(cornell):
    e0 = cornell["ts"].lights.emit.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(_mean_loss(cornell, emit=e0), e0)
    assert torch.isfinite(g).all()
    eps = 1e-2
    de = torch.zeros_like(e0)
    de[0, 1] = eps
    with torch.no_grad():
        fd = (_mean_loss(cornell, emit=e0 + de)
              - _mean_loss(cornell, emit=e0 - de)) / (2 * eps)
    np.testing.assert_allclose(float(g[0, 1]), float(fd), rtol=2e-2)
    assert float(g[0, 1]) > 0


def test_grad_wrt_sigma_finite(cornell):
    s0 = cornell["ts"].materials.sigma.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(_mean_loss(cornell, sigma=s0), s0)
    assert torch.isfinite(g).all()


def _dir_fd_check(loss, x0, eps, rtol, seed=0):
    """Directional FD against AD along a seeded random direction, as
    TestGradientSurface._dir_fd_check does."""
    x = x0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(x), x)
    assert torch.isfinite(g).all()
    v = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        tuple(x0.shape)).astype(np.float32))
    with torch.no_grad():
        fd = (loss(x0 + eps * v) - loss(x0 - eps * v)) / (2 * eps)
    ad = torch.sum(g * v)
    np.testing.assert_allclose(float(ad), float(fd), rtol=rtol, atol=5e-4)
    return g


def _plane_scene(material_fn):
    b = T_scene.SceneBuilder()
    m = material_fn(b)
    fv = np.array([[-2, -1, 2], [2, -1, 2], [2, -1, -2], [-2, -1, -2]],
                  np.float32)
    b.add_mesh(fv, np.array([[0, 1, 2], [0, 2, 3]]), m)
    b.add_point_light((1.5, 2.0, 1.5), (30, 30, 30))
    scene = b.build(device="cpu")
    cam = T_cam.make_perspective_camera(16, 16, eye=(0, 0.5, 3),
                                        look=(0, -0.5, 0), device="cpu")
    cfg = T_path.make_config(scene, 16, 16, spp=16, max_depth=2, spp_chunk=16)
    return scene, cam, cfg, T_smp.make_halton_sampler(16, 16, 16, device="cpu")


def _render_mean(scene, cam, smp, cfg):
    return torch.mean(T_path.render_chunk(scene, cam, smp, cfg, 0,
                                          cfg.spp_chunk) / cfg.spp_chunk)


def test_grad_wrt_disney_params():
    """Twin of TestGradientSurface::test_grad_wrt_disney_params."""
    scene, cam, cfg, smp = _plane_scene(lambda b: b.add_disney(
        (0.6, 0.3, 0.2), rough_u=0.4, metallic=0.4, sheen=0.5, clearcoat=0.5))

    def loss_col(col):
        def loss(x):
            sc = scene._replace(materials=scene.materials._replace(
                **{col: x}))
            return _render_mean(sc, cam, smp, cfg)
        return loss

    _dir_fd_check(loss_col("metallic"), scene.materials.metallic, 1e-3, 0.25)
    for col in ("sheen", "clearcoat", "spec_trans"):
        x = getattr(scene.materials, col).clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_col(col)(x), x)
        assert torch.isfinite(g).all(), col


def test_grad_wrt_texture_texels():
    """Twin of TestGradientSurface::test_grad_wrt_texture_texels."""
    b = T_scene.SceneBuilder()
    rs = np.random.RandomState(0)
    t = b.add_texture(0.2 + 0.6 * rs.rand(64, 64, 3).astype(np.float32))
    m = b.add_matte((1, 1, 1), kd_tex=t)
    fv = np.array([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]], np.float32)
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    b.add_mesh(fv, np.array([[0, 1, 2], [0, 2, 3]]), m, uvs=uv)
    b.add_point_light((2, 2, 3), (40, 40, 40))
    scene = b.build(device="cpu")
    cam = T_cam.make_perspective_camera(16, 16, eye=(0, 0, 3.5),
                                        look=(0, 0, 0), device="cpu")
    cfg = T_path.make_config(scene, 16, 16, spp=8, max_depth=2, spp_chunk=8,
                             texture_filter="bilinear")
    smp = T_smp.make_halton_sampler(8, 16, 16, device="cpu")

    def loss(atlas):
        sc = scene._replace(textures=(atlas,) + tuple(scene.textures[1:]))
        return _render_mean(sc, cam, smp, cfg)

    _dir_fd_check(loss, scene.textures[0], 1e-2, 0.15)


def test_grad_wrt_roughness():
    """Twin of TestGradientSurface::test_grad_wrt_roughness with a Disney
    plane in place of the plastic one (the port's plastic builder comes in a
    later slice): directional FD against AD, the same rtol."""
    scene, cam, cfg, smp = _plane_scene(lambda b: b.add_disney(
        (0.4, 0.4, 0.4), rough_u=0.3, rough_v=0.3))

    def loss(r):
        sc = scene._replace(materials=scene.materials._replace(
            rough_u=r, rough_v=r))
        return _render_mean(sc, cam, smp, cfg)

    _dir_fd_check(loss, scene.materials.rough_u, 1e-3, 0.25)


# -- gradients where a square root meets zero ------------------------------------

def test_sqrt0_is_sqrt_with_a_zero_gradient_at_zero():
    from gnxraytracer_tpu_torch.utils.math import sqrt0

    x = torch.tensor([-1.0, -0.0, 0.0, 1e-45, 1e-30, 0.25, 1.0, 3.0])
    np.testing.assert_array_equal(
        sqrt0(x).numpy(), torch.sqrt(torch.clamp(x, min=0.0)).numpy())
    xg = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(sqrt0(xg) * 0.0 + sqrt0(xg)), xg)
    assert torch.isfinite(g).all()
    np.testing.assert_array_equal(g[:3].numpy(), [0.0, 0.0, 0.0])
    np.testing.assert_allclose(g[5:].numpy(), 0.5 / np.sqrt([0.25, 1.0, 3.0]),
                               rtol=1e-6)


def test_transmission_grad_at_normal_incidence_is_finite():
    """Refraction straight through (wo = z, wi = -z): the half vector is the
    normal, sin(theta_h) = 0 and |wo.wh| = 1, and the square roots of
    sin2_theta and of 1 - cos^2 in the Fresnel term sit at 0.  On an H100 a
    500x500 mesh step met such a lane on its Disney blob and eta's
    gradient came out NaN (the same formulas in the JAX package give NaN
    there); with sqrt0 it is finite and the value is unchanged."""
    from gnxraytracer_tpu_torch.models import bxdf
    from gnxraytracer_tpu_torch.models import microfacet as mf

    eta_b = torch.tensor([1.5], requires_grad=True)
    wo = torch.tensor([[0.0, 0.0, 1.0]])
    wi = torch.tensor([[0.0, 0.0, -1.0]])
    a = torch.tensor([0.3])
    f = mf.microfacet_transmission_f(wo, wi, a, a, torch.tensor([1.0]),
                                     eta_b, torch.ones(1, 3))
    (g,) = torch.autograd.grad(f.sum(), eta_b)
    assert torch.isfinite(f).all() and torch.isfinite(g).all()
    ci = torch.tensor([1.0, -1.0], requires_grad=True)
    fr = bxdf.fr_dielectric(ci, torch.ones(2), torch.full((2,), 1.5))
    (g,) = torch.autograd.grad(fr.sum(), ci)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(fr.detach().numpy(), [0.04, 0.04], rtol=1e-6)


def test_step_casts_through_the_kernel_wrappers(cornell, monkeypatch):
    """With use_pallas every cast of the step goes through the brute-force
    kernels' wrappers (which run their plain versions on CPU tensors): per
    pass and bounce the closest hit, the BSDF sample's re-intersection and
    one shadow ray, the counts chip_smoke.py's phase 10 holds the card's
    launches to."""
    from gnxraytracer_tpu_torch.kernels import closest_hit as ch

    from chip_smoke import expected_step_launches

    calls = {"closest_hit": 0, "brute_any_hit": 0}
    for name, key in (("closest_hit", "closest_hit"),
                      ("any_hit", "brute_any_hit")):
        def counted(*a, _fn=getattr(ch, name), _key=key):
            calls[_key] += 1
            return _fn(*a)
        monkeypatch.setattr(ch, name, counted)
    cfg = cornell["tcfg"]._replace(use_pallas=True, spp_chunk=2, max_depth=2)
    step = T_sh.make_train_step(cfg, device="cpu",
                                lane_budget=8 * cfg.width * cfg.spp_chunk)
    stats = {}
    step({"kd": cornell["ts"].materials.kd}, cornell["ts"], cornell["tc"],
         cornell["tsmp"], cornell["target"], stats=stats)
    assert stats["passes"] == 2 and stats["lanes"] == [256, 256]
    want = expected_step_launches(cfg, 2, 1, bvh=False)
    assert calls == {k: want[k] for k in calls}, (calls, want)
    assert set(stats["grads"]) == {"kd"} and stats["forward_ms"] > 0


# -- the gradient goldens (slow, as their JAX originals; phase 10 of
# chip_smoke.py runs them on the card) ---------------------------------------------

def assert_gradient_golden(name, ad, rtol):
    """chip_smoke.check_gradient_golden's rule: the port's AD against the
    reference renderer's FD within rtol where the JAX package's own AD
    (tests/golden/jax_grad_ad.json) passes that golden, else within
    chip_smoke.JAX_AD_RTOL of the JAX package's AD."""
    import json
    import os

    import chip_smoke as cs

    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "jax_grad_ad.json")) as f:
        rec = json.load(f)[name]
    fd = cs.oracle_fd(name)
    if rec["jax_rel_err"] < rtol:
        assert abs(ad - fd) / abs(fd) < rtol, (name, ad, fd)
    else:
        assert abs(ad - rec["jax_ad"]) / abs(rec["jax_ad"]) \
            < cs.JAX_AD_RTOL, (name, ad, rec)


@pytest.mark.slow
@pytest.mark.parametrize("index", range(4))
def test_reference_gradient_goldens(index):
    """Twins of test_reference_parity.py's gradient goldens ref_grad_kd,
    ref_grad_le, ref_grad_sigma (rtol 0.05) and ref_grad_disney_rough
    (rtol 0.25): 32x32, 256 spp Halton, depth 8, through the brute-force
    kernels' wrappers."""
    import chip_smoke as cs

    dev = torch.device("cpu")
    name, make_scene, scale, rtol, sign = cs.gradient_goldens(dev)[index]
    ad = cs.golden_grad(dev, name, make_scene, scale)
    assert np.isfinite(ad) and (sign == 0 or np.sign(ad) == sign)
    assert_gradient_golden(name, ad, rtol)


def test_microfacet_d_grad_at_grazing_half_vector_is_finite():
    """A half vector in the tangent plane (cos theta = 0): the plain
    tan^2 theta quotient is inf there, the masks zero it, and its backward
    gave NaN to everything upstream (eta's gradient on an H100 1M-lane mesh
    step).  D and Lambda keep their values and get finite gradients."""
    from gnxraytracer_tpu_torch.models import microfacet as mf

    wh = torch.tensor([[1.0, 0.0, 0.0], [0.6, 0.0, 0.8], [0.0, 0.0, 1.0]])
    a = torch.full((3,), 0.3)
    want = (mf.tr_d(wh, a, a), mf.beckmann_d(wh, a, a),
            mf.tr_lambda(wh, a, a), mf.beckmann_lambda(wh, a, a))
    assert float(want[0][0]) == 0.0 and float(want[1][0]) == 0.0
    for fn, w in zip((mf.tr_d, mf.beckmann_d, mf.tr_lambda,
                      mf.beckmann_lambda), want):
        x = wh.clone().requires_grad_(True)
        y = fn(x, a, a)
        np.testing.assert_array_equal(y.detach().numpy(), w.numpy())
        (g,) = torch.autograd.grad(y.sum(), x)
        assert torch.isfinite(g).all(), fn.__name__
