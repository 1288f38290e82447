"""path.render_fused of the port: the whole frame as a loop of render_chunk,
bit-equal to path.render whenever spp is a multiple of spp_chunk, the
ragged-spp assert and the count_rays refusal; and its image against the
JAX package's at tests/test_torch_path.py's tolerances (>= 99% of pixels
within rtol 1e-3 + atol 1e-4, the mean within 0.5%).

The JAX side of that comparison is its path.render: its render_fused is the
same sum of the same chunks, but XLA's CPU compiler takes far too long over
the fused loop (over 40 minutes at 16x16, 2 chunks of 2 spp)."""

import numpy as np
import pytest

from gnxraytracer_tpu.models.integrators import path as J_path
from gnxraytracer_tpu.ops import samplers as J_smp
from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.ops import samplers as T_smp
from gnxraytracer_tpu_torch.scene import presets as T_presets

from test_torch_convert import scene_pair

W = 16


def _cornell(bvh=False):
    return T_presets.cornell_box(W, W, bvh=bvh, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(fast_mis=True, spp=4, spp_chunk=2),
    dict(fast_mis=True, spp=6, spp_chunk=3, compact_tail=True),
    dict(fast_mis=False, spp=4, spp_chunk=1),
    dict(fast_mis=True, spp=2, spp_chunk=1, use_bvh=True, bvh_mode="stack"),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_render_fused_is_render_bit_for_bit(kw):
    scene, cam = _cornell(bvh=kw.get("use_bvh", False))
    cfg = T_path.make_config(scene, W, W, max_depth=4, **kw)
    smp = T_smp.make_sobol_sampler(cfg.spp, device="cpu")
    fused = T_path.render_fused(scene, cam, smp, cfg)
    assert tuple(fused.shape) == (W, W, 3) and bool(fused.isfinite().all())
    np.testing.assert_array_equal(fused.numpy(),
                                  T_path.render(scene, cam, smp, cfg).numpy())


def test_render_fused_takes_n_chunks():
    """An explicit n_chunks renders that many chunks of spp_chunk samples,
    whatever cfg.spp says (no assert then), as the JAX function does."""
    scene, cam = _cornell()
    cfg = T_path.make_config(scene, W, W, spp=5, spp_chunk=2, max_depth=3)
    smp = T_smp.make_sobol_sampler(8, device="cpu")
    got = T_path.render_fused(scene, cam, smp, cfg, n_chunks=2)
    want = T_path.render(scene, cam, smp, cfg._replace(spp=4))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_render_fused_refuses_ragged_spp_and_count_rays():
    scene, cam = _cornell()
    smp = T_smp.make_sobol_sampler(5, device="cpu")
    cfg = T_path.make_config(scene, W, W, spp=5, spp_chunk=2, max_depth=3)
    with pytest.raises(AssertionError, match="spp % spp_chunk"):
        T_path.render_fused(scene, cam, smp, cfg)
    with pytest.raises(ValueError, match="count_rays"):
        T_path.render_fused(scene, cam, smp, cfg._replace(spp=4,
                                                          count_rays=True))


def test_render_fused_matches_jax():
    js, jc, ts, tc = scene_pair("cornell", W, W)
    kw = dict(spp=4, spp_chunk=2, max_depth=5, fast_mis=True)
    jcfg = J_path.make_config(js, W, W, use_pallas=False, **kw)
    tcfg = T_path.make_config(ts, W, W, use_pallas=False, **kw)
    assert tcfg._asdict() == jcfg._asdict()
    want = np.asarray(J_path.render(js, jc, J_smp.make_sobol_sampler(4), jcfg))
    got = T_path.render_fused(ts, tc, T_smp.make_sobol_sampler(4, device="cpu"),
                              tcfg).numpy()
    assert want.mean() > 0.1
    ok = (np.abs(got - want) <= 1e-4 + 1e-3 * np.abs(want)).all(axis=-1)
    assert ok.mean() >= 0.99, f"{(~ok).sum()} of {ok.size} pixels differ"
    assert abs(got.mean() / want.mean() - 1.0) < 0.005
