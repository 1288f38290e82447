"""The port's recorder of spans and counters (utils/stats.py): off it leaves
no range in a profiler trace, launches nothing and changes no image; on, its
spans nest as the layers do and its lane counters equal a direct count of
the same wavefronts; the benchmark's trace summary reads the same with
program spans in the trace as without."""

import contextlib
import json
from collections import Counter

import pytest
import torch

from gnxraytracer_tpu_torch.constants import INFINITY
from gnxraytracer_tpu_torch.models.integrators import path
from gnxraytracer_tpu_torch.ops import samplers, trace
from gnxraytracer_tpu_torch.parallel import sharding
from gnxraytracer_tpu_torch.scene import presets
from gnxraytracer_tpu_torch.scene.loaders import make_test_mesh
from gnxraytracer_tpu_torch.utils import stats
from perfbench import tracing

W = 16
SPP = 4  # 1,024 lanes: compaction stages down to 256 lanes apply
DEPTH = 4
LOOPS = {
    "fast": dict(fast_mis=True, compact_tail=True, compact_stages=((2, 4),)),
    "pipelined": dict(fast_mis=True, pipeline_casts=True, compact_tail=True,
                      compact_stages=((0, 2), (2, 4))),
    "faithful": dict(fast_mis=False, compact_tail=True,
                     compact_stages=((2, 4),)),
}
# (parent, span) of every span a Cornell pass opens in each loop: the
# compaction's thinning dims are made in the pass, between the bounces
_TREE = {("", "pass"), ("pass", "camera"), ("camera", "sampler"),
         ("pass", "sampler"), ("pass", "cast"), ("pass", "shade"),
         ("shade", "cast"), ("pass", "compact")}
PASS_TREE = {
    "fast": _TREE | {("shade", "sampler"), ("pass", "emit")},
    "pipelined": _TREE | {("shade", "sampler"), ("pass", "emit")},
    # Halton: every dim of the wavefront made once, in the pass; no emit
    "faithful": _TREE,
}


@pytest.fixture(scope="module")
def cornell():
    return presets.cornell_box(W, W, device="cpu")


def _setup(cornell, loop):
    scene, cam = cornell
    cfg = path.make_config(scene, W, W, spp=SPP, spp_chunk=SPP,
                           max_depth=DEPTH, **LOOPS[loop])
    if loop == "faithful":
        smp = samplers.make_halton_sampler(SPP, W, W, device="cpu")
    else:
        smp = samplers.make_sobol_sampler(SPP, seed=3, device="cpu")
    return scene, cam, smp, cfg


def _edges(rec):
    return {(rec.rows[p][0] if p >= 0 else "", name)
            for name, p, _t0, _t1 in rec.rows}


def _profiled(fn, tmp_path):
    """fn() under torch.profiler: (its result, the trace's events)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    p = tmp_path / "trace.json"
    prof.export_chrome_trace(str(p))
    return out, json.loads(p.read_text())["traceEvents"]


def _ops(events):
    return Counter(e["name"] for e in events if e.get("cat") == "cpu_op")


def _count_ops(tmp_path, n):
    """The operators of n counts of a mask under one name: n sums on the
    device (with the conversions a sum makes), and n - 1 adds to the
    counter's total."""
    mask = torch.tensor([True, False])
    _, ev_sum = _profiled(lambda: torch.sum(mask), tmp_path)
    total = torch.sum(mask)
    _, ev_add = _profiled(lambda: total + total, tmp_path)
    out = Counter()
    for _ in range(n):
        out += _ops(ev_sum)
    for _ in range(n - 1):
        out += _ops(ev_add)
    return out


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_off_leaves_no_span_and_the_same_image(cornell, loop, tmp_path):
    """Off: no gnx.* range, and on adds no operator but the lane counter's
    sums (a span launches nothing); the image is bit for bit the same
    whether the recorder is off or on."""
    scene, cam, smp, cfg = _setup(cornell, loop)

    def chunk():
        return path.render_chunk(scene, cam, smp, cfg, 0, SPP)

    chunk()  # the per-process caches (tables on the device) filled
    img_off, ev_off = _profiled(chunk, tmp_path)
    assert not [e for e in ev_off
                if e.get("name", "").startswith(stats.SPAN_PREFIX)]
    calls = []
    orig = stats.Recording.count

    def tally(self, name, value):
        calls.append(name)
        return orig(self, name, value)

    stats.Recording.count = tally
    try:
        with stats.recording() as rec:
            img_on, ev_on = _profiled(chunk, tmp_path)
    finally:
        stats.Recording.count = orig
    assert torch.equal(img_off, img_on)
    ops_off, ops_on = _ops(ev_off), _ops(ev_on)
    n_masks = calls.count("lanes.alive")
    assert n_masks > 0
    assert not ops_off - ops_on
    assert ops_on - ops_off == _count_ops(tmp_path, n_masks)
    ranges = {e["name"] for e in ev_on if e.get("cat") == "user_annotation"}
    assert {"gnx.pass", "gnx.cast", "gnx.shade"} <= ranges
    assert rec.counters["lanes.dispatched"] > 0
    assert stats.span("x") is stats.span("y")


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_pass_span_tree(cornell, loop):
    scene, cam, smp, cfg = _setup(cornell, loop)
    with stats.recording() as rec:
        path.render_chunk(scene, cam, smp, cfg, 0, SPP)
    assert _edges(rec) == PASS_TREE[loop]
    s = rec.summary()["spans"]
    assert s["pass"]["calls"] == 1
    assert s["cast"]["parents"] == ["pass", "shade"]
    # self times add up to the pass's whole time
    assert sum(e["self_s"] for e in s.values()) == pytest.approx(
        s["pass"]["total_s"], rel=1e-6)


def test_build_sampler_and_train_span_trees(cornell):
    scene, cam = cornell
    with stats.recording() as rec:
        presets.envmap_mesh(W, W, mesh=make_test_mesh(1), device="cpu")
        samplers.make_halton_sampler(1, 8, 8, device="cpu")
    assert _edges(rec) == {
        ("", "build"), ("build", "build.bvh"),
        ("build.bvh", "build.wide_pack"), ("build.bvh", "build.packet_pack"),
        ("build", "build.textures"), ("build", "build.lights"),
        ("", "sampler.tables")}
    s = rec.summary()["spans"]
    assert s["build"]["total_s"] >= s["build.bvh"]["total_s"] > 0

    small, scam = presets.cornell_box(8, 8, device="cpu")
    cfg = path.make_config(small, 8, 8, spp=1, spp_chunk=1, max_depth=2)
    smp = samplers.make_halton_sampler(1, 8, 8, device="cpu")
    step = sharding.make_train_step(cfg, device="cpu")
    params = sharding.extract_params(small)
    with stats.recording() as rec:
        step({"kd": params["kd"]}, small, scam, smp,
             torch.zeros((8, 8, 3)), stats={})
    # the step's forward pass opens the loop's spans at the top; its phases
    # are timed by the step's own clock (stats), not by spans
    edges = _edges(rec)
    assert {("", "sampler"), ("", "cast"), ("", "shade"),
            ("shade", "cast")} <= edges
    assert {p for p, _ in edges} <= {"", "shade"}


def _direct_lane_count(monkeypatch, cfg):
    """Counts, at each bounce's shading, the lanes and those alive, hit and
    below max_depth, from the state and hit the shading is handed."""
    seen = {"lanes.dispatched": 0, "lanes.alive": 0}

    def tally(b, state, hit):
        go = state["alive"] & hit.hit & (b < cfg.max_depth)
        seen["lanes.dispatched"] += go.shape[0]
        seen["lanes.alive"] += int(go.sum())

    fast_parts, faithful = path._fast_parts, path._make_faithful_bounce

    def parts(scene, cfg, get_ub, n, rd=None):
        cast, emit, work = fast_parts(scene, cfg, get_ub, n, rd=rd)

        def counted(b, state, hit, *args, **kw):
            tally(b, state, hit)
            return work(b, state, hit, *args, **kw)
        return cast, emit, counted

    def make_faithful(scene, cfg, get_ub, n, rd=None):
        bounce = faithful(scene, cfg, get_ub, n, rd=rd)

        def counted(b, state):
            # the bounce's own closest-hit cast, made again
            hit = trace.scene_intersect(
                scene, cfg, state["o"], state["d"],
                torch.where(state["alive"], INFINITY, 0.0))
            tally(b, state, hit)
            return bounce(b, state)
        return counted

    monkeypatch.setattr(path, "_fast_parts", parts)
    monkeypatch.setattr(path, "_make_faithful_bounce", make_faithful)
    return seen


@pytest.mark.parametrize("loop", sorted(LOOPS) + ["uncompacted"])
def test_lane_counters_equal_a_direct_count(cornell, loop, monkeypatch):
    scene, cam, smp, cfg = _setup(cornell, "fast" if loop == "uncompacted"
                                  else loop)
    if loop == "uncompacted":
        cfg = cfg._replace(compact_tail=False)
    seen = _direct_lane_count(monkeypatch, cfg)
    with stats.recording() as rec:
        path.render_chunk(scene, cam, smp, cfg, 0, SPP)
    assert rec.counters == seen
    n = W * W * SPP
    if loop == "uncompacted":
        assert seen["lanes.dispatched"] == n * (DEPTH + 1)
    assert 0 < seen["lanes.alive"] < seen["lanes.dispatched"]


def test_recordings_do_not_nest():
    with stats.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with stats.recording():
                pass
    assert stats.span("x") is stats.span("y")


def test_counters_take_ints_and_tensors():
    with stats.recording() as rec:
        stats.count("a", 3)
        stats.count("a", torch.tensor(4))
        stats.count("b", torch.tensor([True, False, True]))  # a mask
        stats.count("b", torch.tensor([[2, 3], [0, 1]], dtype=torch.int32))
    assert rec.counters == {"a": 7, "b": 8}
    stats.count("a", 1)  # no recording: nothing
    assert rec.counters["a"] == 7


@pytest.mark.parametrize("on", [False, True])
def test_span_and_count_launch_nothing_off(on, tmp_path):
    """A span never adds an operator, and a count adds its sum only while a
    recording is open; spanned() keeps the function's name and result."""
    mask = torch.tensor([True, False, True, True])

    @stats.spanned("piece")
    def piece(x):
        stats.count("n", x)
        return x.shape[0]

    ctx = stats.recording() if on else contextlib.nullcontext()
    with ctx as rec:
        got, events = _profiled(lambda: piece(mask), tmp_path)
    assert got == 4 and piece.__name__ == "piece"
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    if on:  # the first count of a name is its sum alone
        _, ev_sum = _profiled(lambda: torch.sum(mask), tmp_path)
        assert _ops(events) == _ops(ev_sum)
        assert ranges == ["gnx.piece"] and rec.counters == {"n": 3}
        assert rec.summary()["spans"]["piece"]["calls"] == 1
    else:
        assert not _ops(events) and not ranges


# --- a synthetic Chrome trace: program spans inside and around the
# benchmark's cast spans

def _range(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def _launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "tid": tid, "args": {"correlation": corr}}


def _kernel(ts, dur, corr, ext):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts,
            "dur": dur, "tid": 7,
            "args": {"correlation": corr, "External id": ext}}


def _base_trace():
    """Six kernels launched at 5, 15, 25, 45, 55 and 70 us of thread 1,
    the one at 25 inside the benchmark's any-hit cast span; operators of
    thread 1 own each launch."""
    ev = [_range("perfbench.cast.any", 20, 10)]
    for i, ts in enumerate((5, 15, 25, 45, 55, 70)):
        ev.append({"ph": "X", "cat": "cpu_op", "name": f"aten::op{i}",
                   "ts": ts - 1, "dur": 3, "tid": 1,
                   "args": {"External id": 100 + i}})
        ev.append(_launch(ts, i))
    # device: 200-210, 205-215 (overlap), gaps of 10, 20, 30, 40 us
    for corr, (ts, dur) in enumerate(((200, 10), (205, 10), (225, 5),
                                      (250, 5), (285, 5), (330, 5))):
        ev.append(_kernel(ts, dur, corr, 100 + corr))
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
               "ts": 400, "dur": 10, "tid": 7, "args": {}})
    return ev


def _program_spans():
    """pass [0, 100) > shade [10, 60) > (gnx.cast [21, 29) inside the
    benchmark's span, sampler [40, 50)); another thread's span is
    ignored for thread 1's launches."""
    return [_range("gnx.pass", 0, 100), _range("gnx.shade", 10, 50),
            _range("gnx.cast", 21, 8), _range("gnx.sampler", 40, 10),
            _range("gnx.build", 0, 500, tid=2)]


def test_benchmark_summary_is_blind_to_program_spans():
    base = _base_trace()
    assert tracing.summarize(base + _program_spans()) == tracing.summarize(base)


def test_cli_render_trace_writes_the_trace_and_the_spans(tmp_path):
    from gnxraytracer_tpu_torch import cli

    cli.main(["render", "--preset", "cornell", "--width", "8", "--height",
              "8", "--spp", "2", "--spp-chunk", "1", "--max-depth", "2",
              "--sampler", "sobol", "--fast-mis", "--cpu",
              "--trace", str(tmp_path)])
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"gnx.pass", "gnx.shade", "gnx.cast"} <= names
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert set(spans) == {"spans", "counters"}
    assert spans["spans"]["pass"]["calls"] == 2
    assert spans["spans"]["build"]["parents"] == [""]
    assert 0 < spans["counters"]["lanes.alive"] < spans["counters"][
        "lanes.dispatched"]
