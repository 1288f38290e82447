"""Render statistics and profiling: a per-frame stats record with the
reference renderer's status lines (frame time, frames per second) and the
process memory, ray and bounce counters of one wavefront computed on the
device, a torch.profiler capture, and the program's recorder of spans and
counters.

Counterpart of the JAX package's utils/stats.py, with the same records;
the recorder is the port's own.

The recorder.  ``span(name)`` marks a piece of a layer and ``count(name,
value)`` adds to a named counter; both do nothing unless a ``recording()``
is open, so off they cost one read of a module global (``span`` returns a
shared no-op context, ``count`` returns at once).  On, a span keeps (name,
parent, start, end) on the host clock (``time.perf_counter_ns``), and while
a torch profiler records it also enters
``torch.profiler.record_function("gnx." + name)``: the span then lies in
the profiler's Chrome trace beside the device kernels, on the same clock,
so a trace's kernels and idle gaps can be put on the innermost span open
when their launch was made.  Counters take ints or device tensors (summed
on the device) and are read once, with one synchronisation a device, when
the recording ends.
"""

import contextlib
import functools
import json
import os
import tempfile
import threading
import time
from collections import defaultdict

import torch

# the name of a span in a profiler trace is this prefix and its own name
SPAN_PREFIX = "gnx."


def process_memory_mb():
    """Resident and peak resident memory of this process in MiB (from
    /proc/self/status; {} where there is none)."""
    try:
        with open("/proc/self/status") as f:
            fields = {}
            for line in f:
                if line.startswith(("VmRSS", "VmHWM")):
                    k, v = line.split(":")
                    fields[k] = int(v.strip().split()[0]) / 1024.0
        return {"rss_mb": round(fields.get("VmRSS", 0), 1),
                "peak_mb": round(fields.get("VmHWM", 0), 1)}
    except OSError:
        return {}


def wavefront_counters(scene, cfg, sampler, pixel, sample, o, d):
    """Path statistics of one wavefront of rays (o, d): the lanes, the share
    whose camera ray hits, and after each of max_depth + 1 casts the share of
    lanes whose every cast so far hit, each ray continuing straight on from
    its hit.  The casts are trace.scene_intersect's, so on a CUDA scene they
    go through the hand-written kernels (make_config's default there)."""
    from ..ops import trace

    n = o.shape[0]
    alive = torch.ones((n,), dtype=torch.bool, device=o.device)
    oo, dd = o, d
    survival = []
    for b in range(cfg.max_depth + 1):
        hit = trace.scene_intersect(
            scene, cfg, oo, dd,
            torch.full((n,), float("inf"), dtype=torch.float32,
                       device=o.device))
        alive = alive & hit.hit
        survival.append(torch.mean(alive.to(torch.float32)))
        if b >= cfg.max_depth:
            break
        it = trace.make_interaction(scene, cfg, oo, dd, hit)
        oo, dd = trace.spawn_ray(it, dd)  # probe continuation straight on
    survival = torch.stack(survival).tolist()  # one copy to the host
    return {
        "lanes": n,
        "primary_hit_rate": survival[0],
        "bounce_survival": [round(s, 4) for s in survival],
    }


class FrameStats:
    """Per-frame timings with the reference renderer's status lines ('One
    Frame Time', 'Frame pre second') and the process memory.  On a CUDA
    `device` a frame ends with torch.cuda.synchronize(device), so its time
    covers the device's work; out: an optional text stream that gets each
    record as a JSON line."""

    def __init__(self, out=None, device=None):
        self.frames = []
        self.out = out
        self.device = None if device is None else torch.device(device)

    @contextlib.contextmanager
    def frame(self, n_paths):
        t0 = time.time()
        yield
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.time() - t0
        rec = {
            "frame_time_s": round(dt, 4),
            "fps": round(1.0 / dt, 3),
            "Mpaths_per_s": round(n_paths / dt / 1e6, 4),
            **process_memory_mb(),
        }
        self.frames.append(rec)
        if self.out:
            self.out.write(json.dumps(rec) + "\n")
            self.out.flush()

    def summary(self):
        if not self.frames:
            return {}
        ts = [f["frame_time_s"] for f in self.frames]
        return {
            "frames": len(self.frames),
            "mean_frame_s": round(sum(ts) / len(ts), 4),
            "best_frame_s": round(min(ts), 4),
            "total_s": round(sum(ts), 3),
        }


@contextlib.contextmanager
def profiler_trace(log_dir=None):
    """torch.profiler capture of the block (the CPU, and the CUDA devices
    where there are any), written as a Chrome trace to log_dir/trace.json
    (default: gnx_trace under the temporary directory); yields log_dir."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "gnx_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------------
# The recorder of spans and counters
# ---------------------------------------------------------------------------

_OFF = contextlib.nullcontext()
_rec = None  # the open Recording, else None


class Recording:
    """The spans and counters of one ``recording()``.

    rows: one [name, parent row (-1 at the top), start ns, end ns] a span,
    in the order they opened; counters: {name: int}, read when the
    recording ended."""

    def __init__(self):
        self.rows, self.counters = [], {}
        self._open = []
        self._thread = threading.get_ident()

    def count(self, name, value):
        if torch.is_tensor(value):
            value = torch.sum(value)  # on its device; integers sum to int64
        old = self.counters.get(name)
        self.counters[name] = value if old is None else old + value

    def _read_counters(self):
        """Counters to ints: one stack and one copy to the host a device."""
        by_dev = defaultdict(list)
        for k, v in self.counters.items():
            if torch.is_tensor(v):
                by_dev[v.device].append(k)
        for names in by_dev.values():
            vals = torch.stack([self.counters[k] for k in names]).tolist()
            self.counters.update(zip(names, vals))
        self.counters = {k: int(v) for k, v in self.counters.items()}

    def summary(self):
        """{"spans": {name: {calls, self_s, total_s, parents}}, "counters"}:
        self_s is the spans' time less their children's; total_s counts a
        span only where no enclosing span has its name; parents are the
        names of the spans it opened in ("" at the top)."""
        rows = self.rows
        child_ns = [0] * len(rows)
        above = [frozenset()] * len(rows)  # names of the enclosing spans
        out = {}
        for i, (name, p, t0, t1) in enumerate(rows):
            if not t1:  # still open
                continue
            if p >= 0:
                child_ns[p] += t1 - t0
                above[i] = above[p] | {rows[p][0]}
            e = out.setdefault(name, {"calls": 0, "self_s": 0.0,
                                      "total_s": 0.0, "parents": set()})
            e["calls"] += 1
            e["parents"].add(rows[p][0] if p >= 0 else "")
            if name not in above[i]:
                e["total_s"] += (t1 - t0) / 1e9
        for i, (name, _p, t0, t1) in enumerate(rows):
            if t1:
                out[name]["self_s"] += (t1 - t0 - child_ns[i]) / 1e9
        for e in out.values():
            e["parents"] = sorted(e["parents"])
        return {"spans": out, "counters": dict(self.counters)}


class _Span:
    __slots__ = ("rec", "name", "row", "rf")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.row = [self.name, rec._open[-1] if rec._open else -1,
                    time.perf_counter_ns(), 0]
        rec._open.append(len(rec.rows))
        rec.rows.append(self.row)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(SPAN_PREFIX + self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.row[3] = time.perf_counter_ns()
        self.rec._open.pop()
        return False


def span(name):
    """Context manager around one piece of a layer (see the module's note).
    Spans opened on another thread than the recording's are not kept."""
    rec = _rec
    if rec is None or rec._thread != threading.get_ident():
        return _OFF
    return _Span(rec, name)


def spanned(name):
    """Decorator: each call of the function runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name, value):
    """Add value to the counter `name` of the open recording: an int, or a
    tensor whose elements are summed on its device (a mask counts its True
    lanes).  Nothing without a recording, and no device work."""
    rec = _rec
    if rec is not None:
        rec.count(name, value)


@contextlib.contextmanager
def recording():
    """Turn the recorder's spans and counters on for the block; yields the
    Recording, whose counters are read (one synchronisation a device) when
    the block ends."""
    global _rec
    if _rec is not None:
        raise RuntimeError("a recording is already open")
    rec = _rec = Recording()
    try:
        yield rec
    finally:
        _rec = None
        rec._read_counters()
