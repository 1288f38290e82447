"""The benchmark's metric arithmetic on synthetic inputs (CPU)."""

import pytest
import torch

from perfbench import harness, tracing


def e2e(name):
    return harness.load_module("end_to_end", name)


def layer(name):
    return harness.load_module("metrics", name)


def test_pass_p90_is_over_all_passes():
    walls = [0.1 * (i + 1) for i in range(100)]  # 0.1 .. 10.0 s
    assert e2e("pass_p90_ms").read({"walls": walls}) == pytest.approx(9000.0)
    # nearest rank: with 10 passes the 9th
    assert e2e("pass_p90_ms").percentile(list(range(10, 0, -1)), 90) == 9
    assert e2e("pass_p90_ms").percentile([5.0], 90) == 5.0


def test_render_rate_is_over_the_whole_window():
    rec = {"paths": 3 * 1_000_000, "window_s": 1.5}
    assert e2e("render_mpaths_s").read(rec) == pytest.approx(2.0)


def test_train_step_time_is_window_over_whole_steps():
    rec = {"window_s": 52.0, "walls": [5.0] * 10}
    assert e2e("train_step_s").read(rec) == pytest.approx(5.2)


def test_setup_is_the_record():
    assert e2e("setup_s").read({"setup_s": 12.5}) == 12.5


def _kernel(ts, dur, corr, name="k", ext=None):
    args = {"correlation": corr}
    if ext is not None:
        args["External id"] = ext
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "tid": 7, "args": args}


def _launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "tid": tid, "args": {"correlation": corr}}


def synthetic_trace():
    """Two kernels launched inside a closest-cast span, one any-hit kernel
    in its span, one kernel outside; two kernels overlap on two streams."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.cast.closest",
         "ts": 0, "dur": 20, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.cast.any",
         "ts": 50, "dur": 10, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::where", "ts": 70,
         "dur": 5, "tid": 1, "args": {"External id": 9}},
        _launch(2, 1), _launch(10, 2), _launch(55, 3), _launch(71, 4),
        _kernel(100, 30, 1, "a"), _kernel(120, 20, 2, "b"),  # union 100-140
        _kernel(200, 10, 3, "c"),
        _kernel(300, 50, 4, "d", ext=9),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 400,
         "dur": 10, "tid": 7, "args": {}},
    ]
    return ev


def test_summary_of_a_synthetic_trace():
    s = tracing.summarize(synthetic_trace())
    assert s["kernels"] == 4
    assert s["busy_s"] == pytest.approx((40 + 10 + 50 + 10) / 1e6)
    assert s["work_s"] == s["busy_s"]
    assert s["span_device_s"]["perfbench.cast.closest"] == pytest.approx(50e-6)
    assert s["span_device_s"]["perfbench.cast.any"] == pytest.approx(10e-6)
    tops = dict(s["breakdown"]["device_ops"])
    assert tops["d"] == pytest.approx(50e-6)
    gaps = dict(s["breakdown"]["idle_gaps"])
    # the gap before kernel d is named by the operator that launched it
    assert gaps["aten::where"] == pytest.approx(90e-6)
    assert len(s["breakdown"]["device_ops"]) <= 10


def test_a_collective_spinning_is_no_work():
    ev = synthetic_trace() + [_kernel(500, 300, 9, "ncclDevKernel_AllReduce")]
    s = tracing.summarize(ev)
    assert s["busy_s"] == pytest.approx(410e-6)
    assert s["work_s"] == pytest.approx(110e-6)


def test_idle_share_uses_the_unprofiled_wall_time():
    tr = {"kind": "render", "work_s": 0.3, "units": 3, "unit_wall_s": 0.4}
    assert layer("device_idle.render").read(tr) == pytest.approx(75.0)
    assert layer("device_idle.train").read(tr) is None
    tr = dict(tr, kind="train")
    assert layer("device_idle.train").read(tr) == pytest.approx(75.0)


def test_launches_a_pass():
    tr = {"kind": "render", "kernels": 30_000, "units": 3}
    assert layer("launches_per_pass.render").read(tr) == 10_000


def test_launches_a_step():
    tr = {"kind": "train", "kernels": 32_000, "units": 2}
    assert layer("launches_per_step.train").read(tr) == 16_000
    # a render's trace, or none, gives nothing to read
    assert layer("launches_per_step.train").read(dict(tr, kind="render")) is None
    assert layer("launches_per_step.train").read(None) is None
    # no kernel seen (a trace of the CPU): nothing, never a 0
    assert layer("launches_per_step.train").read(dict(tr, kernels=0)) is None
    assert layer("launches_per_pass.render").read(tr) is None


def test_cast_bytes_closest_and_any_hit(monkeypatch):
    from gnxraytracer_tpu_torch.ops import trace

    monkeypatch.setattr(trace, "scene_intersect", lambda *a: "closest")
    monkeypatch.setattr(trace, "scene_occluded", lambda *a: "any")
    o = torch.zeros((1000, 3))
    with tracing.cast_spans(n_tris=12) as calls:
        assert trace.scene_intersect(None, None, o, o, None) == "closest"
        assert trace.scene_occluded(None, None, o[:10], o[:10], None) == "any"
    assert calls == [("perfbench.cast.closest", 1000 * 44 + 12 * 36),
                     ("perfbench.cast.any", 10 * 29 + 12 * 36)]
    # the wraps are gone afterwards
    assert trace.scene_intersect(None, None, o, o, None) == "closest"


def test_cast_roofline():
    read = layer("cast_roofline.render").read
    nbytes = 3.35e12 * 1e-3  # a millisecond's worth
    tr = {"kind": "render", "cast_bytes": {"c": nbytes},
          "span_device_s": {"c": 4e-3}}
    assert read(tr) == pytest.approx(25.0)
    # nothing read: nothing reported, never a 0
    assert read(dict(tr, span_device_s={})) is None


def test_combine_wait_and_backward_means():
    assert layer("combine_wait_ms.render").read(
        {"combine_wait_s": [0.001, 0.003]}) == pytest.approx(2.0)
    assert layer("combine_wait_ms.render").read({"kind": "render"}) is None
    assert layer("backward_ms.train").read(
        {"backward_ms": [4000.0, 5000.0]}) == pytest.approx(4500.0)
