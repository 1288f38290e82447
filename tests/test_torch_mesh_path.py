"""The mesh path as a whole: a small twin of the mesh bench (a Disney blob
with normals and uvs over a BVH, the checker-textured floor with EWA-filtered
lookups driven by camera ray differentials, an HDR environment light from an
in-code image, Sobol' samples, the folded-MIS estimator in the
software-pipelined loop with four compaction stages) rendered by the port on
the CPU and by the JAX package.

The JAX side runs with ``bvh_mode="packet"`` (its XLA walk); the port runs
the plain walk over its width-8 table, as it does for every CPU tensor.  The
port renders twice: on the scene its own SceneBuilder made, and on the JAX
package's scene carried across by ``convert`` (tables asserted equal in
tests/test_torch_convert.py).

Sizes: 32x32 at 4 spp is 4096 lanes; the stages ((0,2),(1,4),(2,8),(3,16))
are the bench's, scaled so that the last keeps 256 lanes, the least the loop
accepts.  (The compacted loop compiles in seconds at this lane count; it is
the uncompacted one that XLA's CPU compiler chokes on at 4096.)

Tolerance, as in tests/test_torch_path.py: XLA contracts FMAs and has its own
sin/cos/exp, eager PyTorch does neither, so a lane near a discrete decision
(a cdf step of the environment map, a Russian-roulette kill, an edge hit, a
lobe choice) can take the other branch and change its pixel by a whole
sample.  Hence >= 99% of pixels within rtol 1e-3 + atol 1e-4, and the image
mean and the ray count within 0.5%."""

import numpy as np
import pytest
import torch

from gnxraytracer_tpu.models.integrators import path as J_path
from gnxraytracer_tpu.ops import samplers as J_smp
from gnxraytracer_tpu_torch import convert
from gnxraytracer_tpu_torch.kernels import wide_bvh as T_wk
from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.ops import samplers as T_smp
from gnxraytracer_tpu_torch.ops import trace as T_trace

from test_torch_convert import assert_tables_equal, mesh_pair, np_tree

W = 32
SPP = 4
DEPTH = 4
STAGES = ((0, 2), (1, 4), (2, 8), (3, 16))
CFG = dict(spp=SPP, spp_chunk=SPP, max_depth=DEPTH, use_bvh=True,
           fast_mis=True, compact_tail=True, pipeline_casts=True,
           compact_stages=STAGES, count_rays=True)


@pytest.fixture(scope="module")
def twin():
    js, jc, ts, tc = mesh_pair(W, W)
    jcfg = J_path.make_config(js, W, W, bvh_mode="packet", **CFG)
    tcfg = T_path.make_config(ts, W, W, **CFG)
    assert tcfg._asdict() == jcfg._asdict()
    assert tcfg.has_env and tcfg.has_textures and tcfg.texture_filter == "ewa"
    assert T_path._pipelined_stages(tcfg, W * W * SPP) == STAGES
    jimg, jn = J_path._render_chunk_jit(js, jc, J_smp.make_sobol_sampler(SPP),
                                        jcfg, 0, SPP)
    smp = T_smp.make_sobol_sampler(SPP, device="cpu")
    timg, tn = T_path.render_chunk(ts, tc, smp, tcfg, 0, SPP)
    carried = convert.scene_from_numpy(np_tree(js), device="cpu")
    cimg, cn = T_path.render_chunk(carried, tc, smp, tcfg, 0, SPP)
    return dict(js=js, ts=ts, tc=tc, carried=carried, cfg=tcfg, smp=smp,
                jax=np.asarray(jimg), jax_rays=float(jn),
                own=timg.numpy(), own_rays=float(tn),
                carried_img=cimg.numpy(), carried_rays=float(cn))


def test_carried_and_own_tables_are_equal(twin):
    assert_tables_equal(twin["ts"], np_tree(twin["js"]), "scene")
    assert_tables_equal(twin["carried"], np_tree(twin["js"]), "scene")
    for a, b in zip(twin["carried"].bvh.wide, twin["ts"].bvh.wide):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b


@pytest.mark.parametrize("which", ["own", "carried_img"])
def test_render_chunk_pixels_match_jax(twin, which):
    a, b = twin[which], twin["jax"]
    assert a.shape == b.shape == (W * W, 3) and np.isfinite(a).all()
    ok = (np.abs(a - b) <= 1e-4 + 1e-3 * np.abs(b)).all(axis=-1)
    assert ok.mean() >= 0.99, f"{(~ok).sum()} of {ok.size} pixels differ"


@pytest.mark.parametrize("which", ["own", "carried_img"])
def test_render_chunk_mean_matches_jax(twin, which):
    assert twin["jax"].mean() > 0.1  # not black
    assert abs(twin[which].mean() / twin["jax"].mean() - 1.0) < 0.005


@pytest.mark.parametrize("which", ["own_rays", "carried_rays"])
def test_ray_count_matches_jax(twin, which):
    # more than the camera casts alone
    assert twin["jax_rays"] > W * W * SPP
    assert abs(twin[which] / twin["jax_rays"] - 1.0) < 0.005


def test_kernel_mode_is_the_same_function_on_cpu(twin):
    """bvh_mode='pallas' routes the casts through the kernels' wrappers, which
    on CPU tensors sort the rays and run the plain walks: same image, bit for
    bit, and no launch is counted."""
    before = (T_wk.closest_launch_count, T_wk.any_launch_count)
    img, n = T_path.render_chunk(twin["ts"], twin["tc"], twin["smp"],
                                 twin["cfg"]._replace(bvh_mode="pallas"),
                                 0, SPP)
    np.testing.assert_array_equal(img.numpy(), twin["own"])
    assert float(n) == twin["own_rays"]
    assert (T_wk.closest_launch_count, T_wk.any_launch_count) == before


def _count_casts(monkeypatch, scene, cam, smp, cfg):
    calls = {"closest": 0, "shadow": 0}
    closest, shadow = T_trace.scene_intersect, T_trace.scene_occluded

    def counted_closest(*a, **kw):
        calls["closest"] += 1
        return closest(*a, **kw)

    def counted_shadow(*a, **kw):
        calls["shadow"] += 1
        return shadow(*a, **kw)

    monkeypatch.setattr(T_trace, "scene_intersect", counted_closest)
    monkeypatch.setattr(T_trace, "scene_occluded", counted_shadow)
    T_path.render_chunk(scene, cam, smp, cfg, 0, SPP)
    monkeypatch.undo()
    return calls["closest"], calls["shadow"]


def test_pipelined_cast_counts(twin, monkeypatch):
    """One closest-hit cast at the camera and one after every work, one shadow
    cast per work: what chip_smoke.py holds the kernels' launch counts to."""
    cfg = twin["cfg"]
    n = W * W * SPP
    got = _count_casts(monkeypatch, twin["ts"], twin["tc"], twin["smp"], cfg)
    assert got == T_path.pipelined_cast_counts(cfg, n) == (DEPTH + 1, DEPTH)
    # no stage applies (buffers under 256 lanes): the classic loop, with a
    # shadow cast at the last bounce too
    small = cfg._replace(compact_stages=((1, 64),))
    assert T_path._pipelined_stages(small, n) == ()
    got = _count_casts(monkeypatch, twin["ts"], twin["tc"], twin["smp"], small)
    assert got == T_path.pipelined_cast_counts(small, n) == (DEPTH + 1,
                                                             DEPTH + 1)


def test_pipelined_stage_rules():
    cfg = T_path.RenderCfg(8, 8, 1, max_depth=8, compact_tail=True,
                           compact_stages=((0, 2), (1, 16), (1, 32), (2, 8),
                                           (4, 64), (9, 128), (5, 4096)))
    # kept: within max_depth, dividing n, >= 256 wide, widths strictly
    # shrinking, bounces strictly increasing
    assert T_path._pipelined_stages(cfg, 1_000_000) == ((0, 2), (1, 16),
                                                        (4, 64))
    bench = cfg._replace(compact_stages=((0, 2), (1, 16), (2, 32), (4, 64)))
    assert T_path._pipelined_stages(bench, 1_000_000) == bench.compact_stages
    assert T_path.pipelined_cast_counts(bench, 1_000_000) == (9, 8)


def test_bilinear_filter_needs_no_differentials(twin):
    """texture_filter='bilinear' renders without camera differentials (no
    peeled bounce 0) and differs from the EWA image only on the floor."""
    cfg = twin["cfg"]._replace(texture_filter="bilinear")
    img, _ = T_path.render_chunk(twin["ts"], twin["tc"], twin["smp"], cfg, 0,
                                 SPP)
    a, b = img.numpy(), twin["own"]
    assert np.isfinite(a).all()
    assert 0.9 < a.mean() / b.mean() < 1.1
    assert not np.array_equal(a, b)


def test_render_accumulates_chunks_without_ray_count(twin):
    cfg = twin["cfg"]._replace(count_rays=False)
    img = T_path.render(twin["ts"], twin["tc"], twin["smp"], cfg)
    assert tuple(img.shape) == (W, W, 3)
    np.testing.assert_allclose(img.numpy().reshape(-1, 3), twin["own"] / SPP,
                               rtol=1e-6)
