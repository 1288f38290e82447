"""The ported path as a whole: the port's path tracer (the fast-MIS estimator
and, further down, the faithful three-cast one with Halton and Sobol')
against the JAX package on the CPU, and against the reference renderer's
golden image.

Both packages render the Cornell box (and a scene that mixes in every other
ported primitive, material and light kind) with their own SceneBuilder (the
tables are equal, tests/test_torch_convert.py) with the same Sobol' samples
(bit-equal, tests/test_torch_samplers.py).  The JAX side runs with
``use_pallas=False``, i.e. the XLA twin of the TPU kernel; the port runs the
kernel's plain version, as it does for every CPU tensor.

Tolerance of the comparison: XLA on the CPU contracts FMAs and has its own
sin/cos/exp, eager PyTorch does neither, so a lane near a discrete decision
(light choice, Russian-roulette kill, an edge hit) can take the other branch
and change its pixel by a whole sample.  Hence >= 99% of pixels within
rtol 1e-3 + atol 1e-4, and the image mean and the ray count within 0.5%."""

import json
import os

import numpy as np
import pytest

from gnxraytracer_tpu.models.integrators import path as J_path
from gnxraytracer_tpu.ops import samplers as J_smp
from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.ops import samplers as T_smp
from gnxraytracer_tpu_torch.scene import presets as T_presets

from test_torch_convert import scene_pair

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
W = 32
BASE = dict(max_depth=5, fast_mis=True, count_rays=True)
# name -> (scene of test_torch_convert.scene_pair, width, config)
VARIANTS = {
    # 3 spp = 3072 lanes: at exactly 4096 lanes XLA's CPU compiler takes
    # many minutes over the uncompacted bounce loop (2048, 2304 and 3072
    # lanes compile in seconds, and so does the compacted loop at 4096)
    "full_width": ("cornell", W, dict(spp=3, compact_tail=False)),
    # 4096 lanes // 8 = 512 >= 256: the compaction engages at this size
    "compact": ("cornell", W, dict(spp=4, compact_tail=True, compact_from=2,
                                   compact_frac=8)),
    # every other ported primitive, material and light kind (spheres, mirror,
    # glass with its etaScale, Lambert, point/spot/distant lights, a thin
    # lens), the power light strategy, two compaction stages
    "mixed_power": ("mixed", 24, dict(
        spp=4, max_depth=6, light_strategy="power", compact_tail=True,
        compact_stages=((2, 2), (4, 8)))),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    scene_name, w, variant = VARIANTS[request.param]
    kw = dict(BASE, **variant)
    spp = kw["spp_chunk"] = kw["spp"]
    js, jc, ts, tc = scene_pair(scene_name, w, w)
    jcfg = J_path.make_config(js, w, w, use_pallas=False, **kw)
    jimg, jn = J_path._render_chunk_jit(js, jc, J_smp.make_sobol_sampler(spp),
                                        jcfg, 0, spp)
    tcfg = T_path.make_config(ts, w, w, use_pallas=False, **kw)
    assert tcfg._asdict() == jcfg._asdict()
    timg, tn = T_path.render_chunk(
        ts, tc, T_smp.make_sobol_sampler(spp, device="cpu"), tcfg, 0, spp)
    return dict(spp=spp, w=w, jax=np.asarray(jimg), jax_rays=float(jn),
                torch=timg.numpy(), torch_rays=float(tn), scene=ts, cam=tc,
                cfg=tcfg)


def test_render_chunk_pixels_match_jax(pair):
    a, b = pair["torch"], pair["jax"]
    assert a.shape == b.shape == (pair["w"] ** 2, 3) and np.isfinite(a).all()
    ok = (np.abs(a - b) <= 1e-4 + 1e-3 * np.abs(b)).all(axis=-1)
    assert ok.mean() >= 0.99, f"{(~ok).sum()} of {ok.size} pixels differ"


def test_render_chunk_mean_matches_jax(pair):
    assert pair["jax"].mean() > 0.1  # not black
    assert abs(pair["torch"].mean() / pair["jax"].mean() - 1.0) < 0.005


def test_ray_count_matches_jax(pair):
    # more than the camera casts alone
    assert pair["jax_rays"] > pair["w"] ** 2 * pair["spp"]
    assert abs(pair["torch_rays"] / pair["jax_rays"] - 1.0) < 0.005


def test_kernel_flag_is_the_same_function_on_cpu(pair):
    """use_pallas routes the cast through the kernel's wrapper, which on CPU
    tensors runs the plain version: same image, bit for bit."""
    cfg = pair["cfg"]._replace(use_pallas=True)
    spp = pair["spp"]
    img, n = T_path.render_chunk(
        pair["scene"], pair["cam"], T_smp.make_sobol_sampler(spp, device="cpu"),
        cfg, 0, spp)
    np.testing.assert_array_equal(img.numpy(), pair["torch"])
    assert float(n) == pair["torch_rays"]


def test_render_accumulates_chunks(pair):
    """render() = mean over chunks of render_chunk, (H, W, 3); without
    count_rays render_chunk returns the image alone."""
    spp = pair["spp"]
    cfg = pair["cfg"]._replace(spp_chunk=2, count_rays=False)
    smp = T_smp.make_sobol_sampler(spp, device="cpu")
    img = T_path.render(pair["scene"], pair["cam"], smp, cfg)
    assert tuple(img.shape) == (pair["w"], pair["w"], 3)
    parts = sum(T_path.render_chunk(pair["scene"], pair["cam"], smp, cfg, s,
                                    min(2, spp - s)) for s in (0, 2))
    np.testing.assert_allclose(img.numpy().reshape(-1, 3),
                               parts.numpy() / spp, rtol=1e-6)
    # chunks of 2 spp draw the same samples as one chunk of all spp, at
    # fewer lanes: only the compaction stage (which needs >= 256-lane
    # buffers dividing the width) may differ
    if not cfg.compact_tail:
        np.testing.assert_allclose(parts.numpy(), pair["torch"], rtol=1e-5,
                                   atol=1e-6)


def test_prethin_and_stage_rules():
    import torch

    alive = torch.zeros(4096, dtype=torch.bool)
    alive[:100] = True
    assert float(T_path._prethin_p(alive, 512)) == 1.0  # survivors fit
    alive[:] = True
    p = float(T_path._prethin_p(alive, 512))
    np.testing.assert_allclose(p, (512 - 4 * 512 ** 0.5) / 4096, rtol=1e-6)
    cfg = T_path.RenderCfg(8, 8, 1, max_depth=8, compact_tail=True,
                           compact_stages=((2, 2), (4, 2), (5, 8), (9, 16),
                                           (6, 64)))
    # kept: within max_depth, dividing n, >= 256 wide, strictly shrinking
    assert T_path._compaction_stages(cfg, 4096) == ((2, 2), (5, 8))


# -- the faithful estimator (fast_mis=False) ----------------------------------------

# name -> (scene, width, sampler, config).  Tolerance as in
# tests/test_torch_whitted_direct.py: per pixel rtol 1e-4 + atol 1e-5, at most
# 0.5% of the pixels on the other side of a discrete decision (none on this
# build), ray counts within 0.5%.
FAITHFUL = {
    "cornell_halton": ("cornell", 24, "halton", dict(spp=3, max_depth=3)),
    "cornell_sobol": ("cornell", 24, "sobol", dict(spp=3, max_depth=3)),
    # spheres, mirror, glass with its etaScale, point/spot/distant lights, a
    # thin lens, the power light strategy, Russian roulette past bounce 3
    "mixed_sobol_power": ("mixed", 24, "sobol", dict(
        spp=3, max_depth=6, light_strategy="power")),
    # 4096 lanes // 8 = 512 >= 256: the compaction engages, and the Halton
    # sample matrix is carried through it row for row
    "compact_halton": ("cornell", 32, "halton", dict(
        spp=4, max_depth=5, compact_tail=True, compact_from=2, compact_frac=8)),
    # the binary threaded walk against the JAX XLA packet walk
    "mesh_bvh_halton": ("cornell_mesh_bvh", 24, "halton",
                        dict(spp=3, max_depth=3)),
}


@pytest.fixture(scope="module", params=sorted(FAITHFUL))
def faithful(request):
    from test_torch_whitted_direct import render_both

    scene, w, sampler, kw = FAITHFUL[request.param]
    kw = dict(kw, fast_mis=False, count_rays=True)
    spp = kw.pop("spp")
    out = render_both(scene, "path", sampler, w, spp, **kw)
    out["name"] = request.param
    return out


def test_faithful_render_chunk_matches_jax(faithful):
    from test_torch_whitted_direct import assert_images_match

    (jimg, jn), (timg, tn) = faithful["jax_out"], faithful["torch_out"]
    assert timg.shape == (faithful["w"] ** 2, 3)
    assert_images_match(timg, jimg, faithful["name"])
    # more than the camera casts alone, and the same count
    assert jn > faithful["w"] ** 2 * faithful["spp"]
    assert abs(tn / jn - 1.0) < 0.005


def test_faithful_differs_from_fast_mis_only_by_noise(faithful):
    """Same scene, same samples, the other estimator: another image (three
    casts against two), the same expectation."""
    cfg = faithful["cfg"]._replace(fast_mis=True)
    import os

    os.environ["GNX_WIDE_BVH"] = "0"
    try:
        img, n = T_path.render_chunk(faithful["scene"], faithful["cam"],
                                     faithful["sampler"], cfg, 0,
                                     faithful["spp"])
    finally:
        del os.environ["GNX_WIDE_BVH"]
    timg, tn = faithful["torch_out"]
    assert float(n) < tn  # fewer casts a path
    assert not np.allclose(img.numpy(), timg)
    assert abs(img.numpy().mean() / timg.mean() - 1.0) < 0.15


def test_halton_sample_matrix_is_what_the_loop_reads():
    """_Dims of a Halton sampler slices the precomputed (N, D) matrix; of a
    Sobol' sampler it computes the same dims in place; take() follows a
    compaction's source map."""
    import torch

    pix = torch.arange(64, dtype=torch.int32)
    smp = torch.zeros(64, dtype=torch.int32) + 2
    cfg = T_path.RenderCfg(8, 8, 4, max_depth=2)
    src = torch.tensor([5, 9, 63, 0])
    for make in (lambda: T_smp.make_halton_sampler(4, 8, 8, device="cpu"),
                 lambda: T_smp.make_sobol_sampler(4, device="cpu")):
        s = make()
        dims = T_path._Dims(cfg, s, pix, smp, 2)
        n_tot = 5 + 8 * 3 + 2
        assert (dims.n_dims, dims.n_dims_tot) == (n_tot - 2, n_tot)
        U = T_smp.sample_all_dims(s, pix, smp, n_tot)
        assert (dims.U is None) == T_smp.supports_inloop_dims(s)
        assert torch.equal(dims.ub(1), U[:, 13:21])
        assert torch.equal(dims.thin(1), U[:, n_tot - 1])
        assert torch.equal(dims.take(src).ub(2), U[src, 21:29])


def block_mean(img, b=8):
    h, w, c = img.shape
    return img[: h // b * b, : w // b * b].reshape(
        h // b, b, w // b, b, c).mean((1, 3))


def test_port_meets_reference_golden():
    """The port alone against the reference renderer's own 2048-spp image
    (tests/golden/ref_path_cornell.npz), with the estimator configuration of
    tests/test_reference_parity.py::test_reference_parity_bench_estimator
    and the thresholds the JAX package is held to there."""
    z = np.load(os.path.join(GOLDEN, "ref_path_cornell.npz"))
    ref, meta = z["image"], json.loads(str(z["meta"]))
    w, h, spp = meta["w"], meta["h"], 64
    scene, cam = T_presets.cornell_box(w, h, sigma=meta["sigma"],
                                       skybox=bool(meta["skybox"]),
                                       device="cpu")
    cfg = T_path.make_config(scene, w, h, spp=spp,
                             max_depth=meta["max_depth"], spp_chunk=32,
                             fast_mis=True, compact_tail=True, compact_from=5,
                             compact_frac=2)
    smp = T_smp.make_sobol_sampler(spp, device="cpu")
    ours = T_path.render(scene, cam, smp, cfg).numpy()
    assert np.isfinite(ours).all()
    berr = np.abs(block_mean(ours) - block_mean(ref)).mean() / ref.mean()
    assert berr < 0.025, f"block8 rel err {berr:.4f}"
    assert np.abs(ours.mean() - ref.mean()) / ref.mean() < 0.02
