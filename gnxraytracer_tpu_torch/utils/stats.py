"""Render statistics and profiling: a per-frame stats record with the
reference renderer's status lines (frame time, frames per second) and the
process memory, ray and bounce counters of one wavefront computed on the
device, and a torch.profiler capture.

Counterpart of the JAX package's utils/stats.py, with the same records.
"""

import contextlib
import json
import os
import tempfile
import time

import torch


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
