"""utils/stats.py of the port against the JAX package's: the wavefront
counters on the same rays of the same scene, FrameStats' records and
summary, and the profiler capture.

Tolerance of the counters: each side casts its own rays (the same camera
samples through each package's float code), so a ray grazing an edge may
go the other way: the shares agree within 2 lanes in 256."""

import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnxraytracer_tpu.models.integrators import path as J_path
from gnxraytracer_tpu.ops import samplers as J_smp
from gnxraytracer_tpu.scene import camera as J_cam
from gnxraytracer_tpu.utils import stats as J_stats
from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.ops import samplers as T_smp
from gnxraytracer_tpu_torch.scene import camera as T_cam
from gnxraytracer_tpu_torch.utils import stats as T_stats

from test_torch_convert import scene_pair

W = 16


def _rays_jax(scene, cam, cfg, spp):
    pix = jnp.tile(jnp.arange(W * W, dtype=jnp.int32), (spp,))
    smp = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), W * W)
    sampler = J_smp.make_sobol_sampler(spp)
    p_film, t_u, l_u = J_smp.camera_sample(sampler, pix, smp, W)
    o, d, _ = J_cam.generate_rays(cam, p_film, t_u, l_u)
    return sampler, pix, smp, o, d


def _rays_torch(scene, cam, cfg, spp):
    pix = torch.arange(W * W, dtype=torch.int32).repeat(spp)
    smp = torch.repeat_interleave(torch.arange(spp, dtype=torch.int32), W * W)
    sampler = T_smp.make_sobol_sampler(spp, device="cpu")
    p_film, t_u, l_u = T_smp.camera_sample(sampler, pix, smp, W)
    o, d, _ = T_cam.generate_rays(cam, p_film, t_u, l_u)
    return sampler, pix, smp, o, d


@pytest.mark.parametrize("name", ["cornell", "cornell_mesh_bvh"])
def test_wavefront_counters_match_jax(name):
    """16x16, depth 2: the Cornell box (brute force) and the Cornell box
    with a mesh behind a BVH (the JAX package's XLA walk against the port's
    plain walk)."""
    js, jc, ts, tc = scene_pair(name, W, W)
    kw = dict(spp=1, max_depth=2, spp_chunk=1)
    jcfg = J_path.make_config(js, W, W, use_pallas=False, **kw)
    tcfg = T_path.make_config(ts, W, W, **kw)
    if name == "cornell_mesh_bvh":
        jcfg = jcfg._replace(use_bvh=True, bvh_mode="packet")
        assert tcfg.use_bvh and tcfg.bvh_mode == "packet"
    theirs = J_stats.wavefront_counters(js, jcfg, *_rays_jax(js, jc, jcfg, 1))
    ours = T_stats.wavefront_counters(ts, tcfg, *_rays_torch(ts, tc, tcfg, 1))
    assert set(ours) == set(theirs) == {"lanes", "primary_hit_rate",
                                        "bounce_survival"}
    assert ours["lanes"] == theirs["lanes"] == W * W
    assert isinstance(ours["primary_hit_rate"], float)
    assert abs(ours["primary_hit_rate"] - theirs["primary_hit_rate"]) <= 2 / W**2
    assert len(ours["bounce_survival"]) == len(theirs["bounce_survival"]) == 3
    np.testing.assert_allclose(ours["bounce_survival"],
                               theirs["bounce_survival"], atol=2 / W**2)
    assert ours["bounce_survival"][0] > 0.5  # the camera sees the box


def test_frame_stats_records_have_the_jax_keys():
    outs = {}
    for name, mod in (("jax", J_stats), ("torch", T_stats)):
        buf = io.StringIO()
        fs = mod.FrameStats(out=buf)
        for _ in range(3):
            with fs.frame(n_paths=1000):
                sum(range(1000))
        outs[name] = (fs.frames, fs.summary(), buf.getvalue())
        assert mod.FrameStats().summary() == {}
    (jf, js, jbuf), (tf, ts, tbuf) = outs["jax"], outs["torch"]
    assert [set(r) for r in tf] == [set(r) for r in jf]
    assert {"frame_time_s", "fps", "Mpaths_per_s", "rss_mb",
            "peak_mb"} == set(tf[0])
    assert set(ts) == set(js) and ts["frames"] == 3
    assert [json.loads(line) for line in tbuf.splitlines()] == tf
    assert set(T_stats.process_memory_mb()) == set(J_stats.process_memory_mb())


def test_frame_stats_on_the_cpu_device_takes_no_sync():
    fs = T_stats.FrameStats(device="cpu")
    with fs.frame(n_paths=10):
        pass
    assert fs.summary()["frames"] == 1


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with T_stats.profiler_trace(log_dir) as d:
        assert d == log_dir
        torch.ones(64).cumsum(0)
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::cumsum" in names
