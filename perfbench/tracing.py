"""The traced part of a run: torch.profiler over a few passes or steps, and
the reduction of its trace to what the per-layer readers take.

The benchmark's own spans are torch.profiler ``record_function`` ranges that
the harness puts around calls into the port (``cast_spans``); nothing inside
the port is touched.  The trace is exported as Chrome JSON under TMPDIR,
read back and deleted.  From it:

  * ``busy_s``: the union of the device's kernel, copy and fill intervals,
    and ``work_s``, the same without the collectives' kernels;
  * ``kernels``: the device kernels it saw;
  * the device time of the kernels launched inside each span (a kernel is
    inside when the runtime call that launched it lies in the span, on the
    span's thread);
  * ``breakdown``: the device operations that took most time, and the idle
    gaps of the device summed by the operator whose launch ended each gap.
"""

import contextlib
import json
import os
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "perfbench."
COLLECTIVE_PREFIX = "nccl"
# a kernel's name in the breakdown is cut to this many characters
NAME_CHARS = 160


def sync(dev):
    """torch.cuda.synchronize on a CUDA device; nothing on the CPU."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile(fn, n, dev, tmpdir, tag="trace"):
    """Run fn(i) for i in range(n) under torch.profiler; returns the
    summary of its trace (summarize) with window_s, the traced wall time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(dev)
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        sync(dev)
        window_s = time.perf_counter() - t0
    path = os.path.join(tmpdir, f"perfbench_{tag}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = summarize(events)
    out["window_s"] = window_s
    return out


def _union(intervals):
    """Total length and merged list of [start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def summarize(events):
    """The numbers the readers take from one Chrome trace (times in s)."""
    dev_ops = [e for e in events
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    kernels = [e for e in dev_ops if e["cat"] == "kernel"]
    busy_us, merged = _union((e["ts"], e["ts"] + e["dur"]) for e in dev_ops)
    # a collective's kernel spins on the device while it waits for the
    # slowest rank: busy for the device, but no work of this rank
    work_us, _ = _union((e["ts"], e["ts"] + e["dur"]) for e in dev_ops
                        if not e["name"].startswith(COLLECTIVE_PREFIX))

    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (e.get("tid"), e["ts"])
    spans = defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name", "").startswith(SPAN_PREFIX)):
            spans[e["name"]].append((e.get("tid"), e["ts"], e["ts"] + e["dur"]))
    span_us = {name: 0.0 for name in spans}
    unplaced = 0
    if spans:
        by_tid = defaultdict(list)
        for name, rows in spans.items():
            for tid, s, t in rows:
                by_tid[tid].append((s, t, name))
        for rows in by_tid.values():
            rows.sort()
        import bisect

        starts = {tid: [r[0] for r in rows] for tid, rows in by_tid.items()}
        for k in kernels:
            lt = launch.get(k.get("args", {}).get("correlation"))
            if lt is None:
                unplaced += 1
                continue
            rows = by_tid.get(lt[0])
            if not rows:
                continue
            i = bisect.bisect_right(starts[lt[0]], lt[1]) - 1
            if i >= 0 and rows[i][0] <= lt[1] <= rows[i][1]:
                span_us[rows[i][2]] += k["dur"]

    by_name = defaultdict(float)
    for e in dev_ops:
        by_name[e["name"]] += e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # idle gaps, named by the operator that launched the kernel after each
    op_of_ext = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                op_of_ext[ext] = e["name"]
    first_at = {}
    for k in kernels:
        first_at.setdefault(k["ts"], k)
    gaps = defaultdict(float)
    for (s0, e0), (s1, _e1) in zip(merged, merged[1:]):
        k = first_at.get(s1)
        ext = None if k is None else k.get("args", {}).get("External id")
        name = op_of_ext.get(ext, "(launch outside an operator)") if k else "(copy)"
        gaps[name] += s1 - e0
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_us / 1e6,
        "work_s": work_us / 1e6,
        "kernels": len(kernels),
        "span_device_s": {k: v / 1e6 for k, v in span_us.items()},
        "span_calls": {k: len(v) for k, v in spans.items()},
        "unplaced_kernels": unplaced,
        "breakdown": {"device_ops": [[n[:NAME_CHARS], us / 1e6]
                                     for n, us in top],
                      "idle_gaps": [[n[:NAME_CHARS], us / 1e6]
                                    for n, us in top_gaps]},
    }


@contextlib.contextmanager
def cast_spans(n_tris):
    """Wrap the port's two scene casts (ops/trace.scene_intersect and
    scene_occluded, which the integrators call through the module) in
    record_function spans, and count the bytes a cast needs: per ray 28 B
    in (o, d, t_max) and 16 B out for the closest hit (t, tri, u, v) or 1 B
    for the any hit, and the scene's n_tris triangles read once (36 B each).
    Yields the list of (span name, bytes) a call; no synchronisation."""
    from gnxraytracer_tpu_torch.ops import trace

    calls = []
    orig = (trace.scene_intersect, trace.scene_occluded)

    def wrap(fn, name, out_bytes):
        def cast(scene, cfg, o, d, t_max):
            calls.append((name, o.shape[0] * (28 + out_bytes) + 36 * n_tris))
            with torch.profiler.record_function(name):
                return fn(scene, cfg, o, d, t_max)
        return cast

    trace.scene_intersect = wrap(orig[0], SPAN_PREFIX + "cast.closest", 16)
    trace.scene_occluded = wrap(orig[1], SPAN_PREFIX + "cast.any", 1)
    try:
        yield calls
    finally:
        trace.scene_intersect, trace.scene_occluded = orig
