"""The port's Whitted and direct-lighting integrators (and estimate_direct
under them) against the JAX package on the CPU, and against the reference
renderer's golden images.

Both packages build the same scenes with their own SceneBuilder (equal
tables, tests/test_torch_convert.py) and draw the same Halton or Sobol'
samples (bit-equal, tests/test_torch_samplers.py).  The JAX side runs its
jitted render_chunk; a scene with a BVH walks it with bvh_mode="packet" (the
XLA walk: the Pallas mode of ops/trace.py is not in interpret mode and cannot
run on the CPU), the port walks the binary threaded table's plain version
(GNX_WIDE_BVH=0).

Tolerance: per pixel rtol 1e-4 + atol 1e-5.  XLA on the CPU contracts FMAs
and has its own sin/cos, eager PyTorch does neither, so a lane at a discrete
decision (a light choice, a shared-edge tie, a Fresnel branch) may take the
other side and move its pixel by a whole sample: at most 0.5% of the pixels
may differ (on this build none does), and the image mean within 1e-4."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnxraytracer_tpu.models.integrators import direct as J_direct
from gnxraytracer_tpu.models.integrators import path as J_path
from gnxraytracer_tpu.models.integrators import whitted as J_whitted
from gnxraytracer_tpu.models import lights as J_lights
from gnxraytracer_tpu.ops import samplers as J_smp
from gnxraytracer_tpu.ops import trace as J_trace
from gnxraytracer_tpu.scene import camera as J_cam
from gnxraytracer_tpu.scene import presets as J_presets
from gnxraytracer_tpu.scene import scene as J_scene
from gnxraytracer_tpu_torch.models.integrators import direct as T_direct
from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.models.integrators import whitted as T_whitted
from gnxraytracer_tpu_torch.models import lights as T_lights
from gnxraytracer_tpu_torch.ops import samplers as T_smp
from gnxraytracer_tpu_torch.ops import trace as T_trace
from gnxraytracer_tpu_torch.scene import camera as T_cam
from gnxraytracer_tpu_torch.scene import presets as T_presets
from gnxraytracer_tpu_torch.scene import scene as T_scene

from test_torch_convert import scene_pair

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
J_MODS = {"path": J_path, "whitted": J_whitted, "direct": J_direct}
T_MODS = {"path": T_path, "whitted": T_whitted, "direct": T_direct}


def _fill_specular(b, presets):
    """The Cornell box with a mirror sphere and a smooth-glass sphere."""
    mats = presets.reference_materials(b, sigma=60.0)
    presets.add_cornell(b, mats["red"], mats["blue"], mats["white"])
    presets.add_area_lights(b, mats["dragon"])
    glass = b.add_glass(kr=(0.9, 1.0, 0.95), kt=(0.95, 0.9, 1.0), eta=1.45)
    b.add_sphere((-1.0, -1.5, 0.5), 0.8, mats["mirror"])
    b.add_sphere((1.2, -1.6, 0.0), 0.7, glass)
    b.add_skybox_light()


def pair_of(name, w):
    """(JAX scene, JAX camera, port scene, port camera)."""
    if name != "specular":
        return scene_pair(name, w, w)
    jb, tb = J_scene.SceneBuilder(), T_scene.SceneBuilder()
    _fill_specular(jb, J_presets)
    _fill_specular(tb, T_presets)
    kw = dict(eye=(0.0, 0.0, 5.0), look=(0.0, 0.0, 0.0))
    return (jb.build(bvh=False), J_cam.make_perspective_camera(w, w, **kw),
            tb.build(device="cpu"),
            T_cam.make_perspective_camera(w, w, device="cpu", **kw))


def make_samplers(kind, spp, w):
    if kind == "halton":
        return (J_smp.make_halton_sampler(spp, w, w),
                T_smp.make_halton_sampler(spp, w, w, device="cpu"))
    return (J_smp.make_sobol_sampler(spp),
            T_smp.make_sobol_sampler(spp, device="cpu"))


def render_both(scene_name, integrator, sampler, w, spp, strategy=None, **kw):
    """One chunk of all spp through both packages; a scene with a BVH is
    walked by the JAX XLA packet walk and by the port's binary plain walk."""
    js, jc, ts, tc = pair_of(scene_name, w)
    if js.bvh is not None:
        kw = dict(kw, use_bvh=True, bvh_mode="packet")
    kw = dict(dict(max_depth=3), **kw)
    jcfg = J_path.make_config(js, w, w, spp=spp, spp_chunk=spp, **kw)
    tcfg = T_path.make_config(ts, w, w, spp=spp, spp_chunk=spp, **kw)
    assert tcfg._asdict() == jcfg._asdict()
    jsm, tsm = make_samplers(sampler, spp, w)
    extra = () if strategy is None else (strategy,)
    jimg = J_MODS[integrator]._render_chunk_jit(js, jc, jsm, jcfg, 0, spp,
                                                *extra)
    old = os.environ.get("GNX_WIDE_BVH")
    os.environ["GNX_WIDE_BVH"] = "0"
    try:
        timg = T_MODS[integrator].render_chunk(ts, tc, tsm, tcfg, 0, spp,
                                               *extra)
    finally:
        if old is None:
            del os.environ["GNX_WIDE_BVH"]
        else:
            os.environ["GNX_WIDE_BVH"] = old
    if tcfg.count_rays:  # (image, useful casts)
        return dict(jax_out=(np.asarray(jimg[0]), float(jimg[1])),
                    torch_out=(timg[0].numpy(), float(timg[1])), w=w, spp=spp,
                    scene=ts, cam=tc, cfg=tcfg, sampler=tsm)
    return dict(jax=np.asarray(jimg), torch=timg.numpy(), w=w, spp=spp,
                scene=ts, cam=tc, cfg=tcfg, sampler=tsm, strategy=strategy,
                integrator=integrator)


def assert_images_match(a, b, what=""):
    """Port image a against JAX image b: see the module docstring."""
    assert a.shape == b.shape and np.isfinite(a).all()
    assert b.mean() > 0.1  # not black
    ok = (np.abs(a - b) <= 1e-5 + 1e-4 * np.abs(b)).all(axis=-1)
    flipped = int((~ok).sum())
    assert flipped <= ok.size // 200, \
        f"{what}: {flipped} of {ok.size} pixels differ"
    assert abs(a.mean() / b.mean() - 1.0) < 1e-4 * max(1, flipped * 50)
    return flipped


# name -> (scene, integrator, sampler, width, spp, keywords)
VARIANTS = {
    "whitted-cornell-halton": ("cornell", "whitted", "halton", 24, 3, {}),
    "whitted-cornell-sobol": ("cornell", "whitted", "sobol", 24, 3, {}),
    # mirror and glass: the depth loop recurses, dielectric lanes pick a
    # branch by the Fresnel weight
    "whitted-specular-halton": ("specular", "whitted", "halton", 24, 3, {}),
    # the branching tree (both branches, a dims block per tree node)
    "whitted_faithful-specular-halton": (
        "specular", "whitted", "halton", 16, 2,
        dict(whitted_faithful=True, max_depth=2)),
    "whitted-mesh_bvh-halton": ("cornell_mesh_bvh", "whitted", "halton", 24,
                                3, {}),
    "direct_one-cornell-halton": ("cornell", "direct", "halton", 24, 3,
                                  dict(strategy="one")),
    "direct_all-cornell-halton": ("cornell", "direct", "halton", 24, 3,
                                  dict(strategy="all")),
    "direct_one-specular-sobol": ("specular", "direct", "sobol", 24, 3,
                                  dict(strategy="one")),
    "direct_one-mesh_bvh-halton": ("cornell_mesh_bvh", "direct", "halton", 24,
                                   3, dict(strategy="one")),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    scene, integrator, sampler, w, spp, kw = VARIANTS[request.param]
    out = render_both(scene, integrator, sampler, w, spp, **kw)
    out["name"] = request.param
    return out


def test_render_chunk_pixels_match_jax(pair):
    a, b = pair["torch"], pair["jax"]
    assert a.shape == (pair["w"] ** 2, 3)
    assert_images_match(a, b, pair["name"])


def test_render_accumulates_chunks(pair):
    """render() = mean over chunks of render_chunk, (H, W, 3); chunks of one
    spp draw the same samples as one chunk of all spp."""
    mod = T_MODS[pair["integrator"]]
    extra = () if pair["strategy"] is None else (pair["strategy"],)
    cfg = pair["cfg"]._replace(spp_chunk=1)
    os.environ["GNX_WIDE_BVH"] = "0"
    try:
        img = mod.render(pair["scene"], pair["cam"], pair["sampler"], cfg,
                         *extra)
    finally:
        del os.environ["GNX_WIDE_BVH"]
    assert tuple(img.shape) == (pair["w"], pair["w"], 3)
    np.testing.assert_allclose(img.numpy().reshape(-1, 3),
                               pair["torch"] / pair["spp"], rtol=1e-5,
                               atol=1e-6)


def test_whitted_depth_is_one_without_a_specular_material():
    """No mirror or glass assigned: one depth step whatever max_depth says,
    so depth 1 and depth 5 give the same image, bit for bit."""
    scene, cam = T_presets.cornell_box(16, 16, device="cpu")
    smp = T_smp.make_halton_sampler(2, 16, 16, device="cpu")
    imgs = [T_whitted.render_chunk(
        scene, cam, smp, T_path.make_config(scene, 16, 16, spp=2, max_depth=d),
        0, 2) for d in (1, 5)]
    assert torch.equal(*imgs)
    assert float(imgs[0].mean()) > 0.1


def test_whitted_casts_follow_the_depth_loop(monkeypatch):
    """One closest-hit cast a depth and one shadow cast a non-skybox light a
    depth: the skybox's light sample is black and is skipped statically."""
    js, jc, ts, tc = pair_of("specular", 8)
    cfg = T_path.make_config(ts, 8, 8, spp=1, max_depth=4)
    assert cfg.light_kind_seq.count(5) == 1 and cfg.n_lights == 3
    calls = dict(closest=0, shadow=0)
    closest, shadow = T_trace.scene_intersect, T_trace.scene_occluded

    def count_closest(*a, **kw):
        calls["closest"] += 1
        return closest(*a, **kw)

    def count_shadow(*a, **kw):
        calls["shadow"] += 1
        return shadow(*a, **kw)

    monkeypatch.setattr(T_trace, "scene_intersect", count_closest)
    monkeypatch.setattr(T_trace, "scene_occluded", count_shadow)
    T_whitted.render_chunk(ts, tc, T_smp.make_sobol_sampler(1, device="cpu"),
                           cfg, 0, 1)
    assert calls == dict(closest=4, shadow=4 * 2)


def test_direct_casts_every_lane_at_every_depth(monkeypatch):
    """direct.trace_paths casts dead lanes too (t_max = INFINITY on every
    lane), as the JAX package does; strategy is checked."""
    js, jc, ts, tc = pair_of("cornell", 8)
    cfg = T_path.make_config(ts, 8, 8, spp=1, max_depth=2)
    seen = []
    closest = T_trace.scene_intersect

    def spy(scene, cfg_, o, d, t_max):
        seen.append(t_max.clone())
        return closest(scene, cfg_, o, d, t_max)

    monkeypatch.setattr(T_trace, "scene_intersect", spy)
    smp = T_smp.make_sobol_sampler(1, device="cpu")
    T_direct.render_chunk(ts, tc, smp, cfg, 0, 1, "one")
    inf = np.finfo(np.float32).max
    # per depth: the camera/continuation cast, then estimate_direct's
    # BSDF-side cast (which does mask its lanes)
    assert len(seen) == 4
    assert all(bool((t == inf).all()) for t in seen[0::2])
    with pytest.raises(ValueError, match="strategy"):
        T_direct.render_chunk(ts, tc, smp, cfg, 0, 1, "some")


# -- estimate_direct on fixed interactions -----------------------------------------

def _fixed_interactions(scene_name, n=600, seed=4):
    """Interactions of random rays from inside the box, through both
    packages' own casts."""
    js, jc, ts, tc = pair_of(scene_name, 8)
    kw = dict(spp=1)
    if js.bvh is not None:
        kw.update(use_bvh=True, bvh_mode="packet")
    jcfg = J_path.make_config(js, 8, 8, **kw)
    tcfg = T_path.make_config(ts, 8, 8, **kw)
    rs = np.random.RandomState(seed)
    o = (rs.rand(n, 3) * 2.0 - 1.0).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, 1e30, np.float32)
    jhit = J_trace.scene_intersect(js, jcfg, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(t_max))
    jit_ = J_trace.make_interaction(js, jcfg, jnp.asarray(o), jnp.asarray(d),
                                    jhit)
    thit = T_trace.scene_intersect(ts, tcfg, torch.from_numpy(o),
                                   torch.from_numpy(d), torch.from_numpy(t_max))
    tit = T_trace.make_interaction(ts, tcfg, torch.from_numpy(o),
                                   torch.from_numpy(d), thit)
    np.testing.assert_array_equal(thit.hit.numpy(), np.asarray(jhit.hit))
    u = rs.rand(n, 4).astype(np.float32)
    return dict(js=js, ts=ts, jcfg=jcfg, tcfg=tcfg, jit=jit_, tit=tit,
                hit=thit.hit.numpy(), u=u, rs=rs, n=n)


@pytest.fixture(scope="module", params=["cornell", "specular", "mixed"])
def fixed(request):
    return _fixed_interactions(request.param)


@pytest.mark.parametrize("with_mask", [False, True])
def test_estimate_direct_matches_jax(fixed, with_mask):
    """Every light of the scene in turn (area, skybox, and for "mixed"
    point, spot and distant), with and without the lane mask: rtol 1e-5 on
    the lanes that hit (atol 1e-6 for sums that cancel)."""
    f = fixed
    n = f["n"]
    mask = (f["rs"].rand(n) < 0.7) if with_mask else None
    for li in range(f["tcfg"].n_lights):
        jl = J_path.estimate_direct(
            f["js"], f["jcfg"], f["jit"],
            J_trace.to_local(f["jit"], f["jit"].wo),
            jnp.asarray(f["u"][:, 0:2]), jnp.asarray(f["u"][:, 2:4]),
            jnp.full((n,), li, jnp.int32),
            mask=None if mask is None else jnp.asarray(mask))
        tl = T_path.estimate_direct(
            f["ts"], f["tcfg"], f["tit"],
            T_trace.to_local(f["tit"], f["tit"].wo),
            torch.from_numpy(f["u"][:, 0:2]), torch.from_numpy(f["u"][:, 2:4]),
            torch.full((n,), li, dtype=torch.int32),
            mask=None if mask is None else torch.from_numpy(mask))
        use = f["hit"] if mask is None else (f["hit"] & mask)
        a, b = tl.numpy()[use], np.asarray(jl)[use]
        assert np.isfinite(a).all()
        close = np.isclose(a, b, rtol=1e-5, atol=1e-6).all(-1)
        assert close.mean() >= 0.995, \
            f"light {li}: {(~close).sum()} of {close.size} lanes differ"


def test_estimate_direct_refuses_the_media_hook(fixed):
    f = fixed
    with pytest.raises(NotImplementedError, match="media"):
        T_path.estimate_direct(
            f["ts"], f["tcfg"], f["tit"], None, None, None, None,
            vis_fn=lambda o, d, t: None)


def test_pdf_li_matches_jax_on_every_light_kind(fixed):
    """lights.pdf_li, which only estimate_direct's BSDF side uses."""
    f = fixed
    n = f["n"]
    wi = f["rs"].randn(n, 3).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    for li in range(f["tcfg"].n_lights):
        a = T_lights.pdf_li(f["ts"], f["tcfg"],
                            torch.full((n,), li, dtype=torch.int32),
                            f["tit"].p, torch.from_numpy(wi)).numpy()
        b = np.asarray(J_lights.pdf_li(f["js"], f["jcfg"],
                                       jnp.full((n,), li, jnp.int32),
                                       f["jit"].p, jnp.asarray(wi)))
        h = f["hit"]
        close = np.isclose(a[h], b[h], rtol=1e-4, atol=1e-6)
        assert close.mean() >= 0.995, f"light {li}"


# -- the reference renderer's goldens ------------------------------------------------

def block_mean(img, b=8):
    h, w, c = img.shape
    return img[: h // b * b, : w // b * b].reshape(
        h // b, b, w // b, b, c).mean((1, 3))


@pytest.mark.parametrize("name", ["ref_whitted_cornell", "ref_direct_cornell",
                                  "ref_path_cornell"])
def test_port_meets_reference_golden(name):
    """The port alone, 32 spp Halton with the integrators' defaults, against
    the reference renderer's own 2048-spp image, with the limits the JAX
    package is held to (tests/test_reference_parity.py: block8 < 0.035,
    channel means < 0.03)."""
    z = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    ref, meta = z["image"], json.loads(str(z["meta"]))
    w, h, spp = meta["w"], meta["h"], 32
    scene, cam = T_presets.cornell_box(w, h, sigma=meta["sigma"],
                                       skybox=bool(meta["skybox"]),
                                       device="cpu")
    cfg = T_path.make_config(scene, w, h, spp=spp,
                             max_depth=meta["max_depth"], spp_chunk=32)
    assert not cfg.fast_mis
    smp = T_smp.make_halton_sampler(spp, w, h, device="cpu")
    ours = T_MODS[meta["integrator"]].render(scene, cam, smp, cfg).numpy()
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    mean_err = np.abs(ours.mean((0, 1)) - ref.mean((0, 1))) / ref.mean()
    assert mean_err.max() < 0.03, f"{name}: channel means off by {mean_err}"
    berr = np.abs(block_mean(ours) - block_mean(ref)).mean() / ref.mean()
    assert berr < 0.035, f"{name}: block8 rel err {berr:.4f}"
