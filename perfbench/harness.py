"""The benchmark's entry: one run of one cell.

A run reads BENCHMARK.json for the cell, finds by name the files that
belong to it, and drives the port (``gnxraytracer_tpu_torch``) through them:

  * ``configs/<config>.json``: the scene (perfbench/scenes.py builds it);
  * ``traffic/<traffic>.json``: the mix, whose ``runner`` names the module
    ``runners/<runner>.py`` that drives the port's entry for it;
  * ``limits/<cell>.json``: the limit of each number the correctness check
    compares (perfbench/reference/compare.py);
  * ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader a
    metric, each taking its number from the run's record (host clock) or
    from its trace (torch.profiler, spans and counters the runner put around
    calls into the port).

A later cell, configuration, traffic mix or metric is new files and new
entries of BENCHMARK.json; nothing here names one.

How a run goes: refuse without enough CUDA devices (no fallback to the
CPU); set up (scene, configuration, the cell's shapes warmed up); measure
for --seconds (nothing compiles inside the window); read the device's peak
memory; with --trace 1, profile a few more passes or steps; free the port's
state; judge what the window produced against the plain reference; refuse
if JAX or the JAX package was loaded; print each compared number beside its
limit on standard error, then the result line on standard output.  A cell
of several chips starts one process a rank (this process is rank 0); they
meet through a TCP store on localhost, and a rank that fails leaves the
run without a result.
"""

import argparse
import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names no process of the benchmark may load, compared
# whole (the port's name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gnxraytracer_tpu")


def load_manifest(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind, name, here=HERE):
    with open(os.path.join(here, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind, name, here=HERE):
    """perfbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(here, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    mod_name = f"perfbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest, workload, kind):
    """The entries of manifest[kind] ("end_to_end" or "per_layer") that the
    cell reports: those that list it under "workloads", and those without
    the key (a per-layer one where the cell reports its `moves`)."""
    e2e = [m["name"] for m in manifest["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    out = []
    for m in manifest[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_loaded(modules=None):
    """Names of loaded modules whose top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in modules if n.split(".")[0] in FORBIDDEN_MODULES)


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(argv, world, port):
    """Start ranks 1..world-1 of this run; their standard output goes to
    this process's standard error."""
    procs = []
    for r in range(1, world):
        cmd = [sys.executable, os.path.join(HERE, "run.py"), *argv,
               "--rank", str(r), "--world", str(world), "--port", str(port)]
        procs.append(subprocess.Popen(cmd, stdout=sys.stderr, cwd=ROOT))
    return procs


def _join_ranks(procs, timeout_s):
    """Wait for every rank; kill the ones left at the timeout.  Returns the
    exit codes."""
    deadline = time.time() + timeout_s
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(1.0, deadline - time.time())))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def device_info(dev, world, peak_bytes):
    import torch

    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": world, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": world,
            "memory_peak_bytes": int(peak_bytes)}


def make_ctx(manifest, workload, seed, seconds, trace, device, t_start,
             rank=0, world=1, port=None, overrides=None, here=HERE):
    """What a runner gets for one run of `workload`: the cell, its files
    (read by name), the run's arguments, the device and this process's
    rank."""
    import torch

    cell = next((w for w in manifest["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    return SimpleNamespace(
        workload=workload, cell=cell,
        config=load_json("configs", cell["config"], here),
        traffic=load_json("traffic", cell["traffic"], here),
        limits=load_json("limits", workload, here),
        seed=int(seed), seconds=float(seconds), trace=bool(trace),
        device=torch.device(device), t_start=t_start, rank=rank, world=world,
        port=port, overrides=overrides or {},
        tmpdir=os.environ.get("TMPDIR") or ROOT)


def run_cell(manifest, workload, seed, seconds, trace, device, t_start,
             rank=0, world=1, port=None, overrides=None, here=HERE):
    """Set up, measure and judge one run of `workload` in this process.
    Returns the result dict on rank 0 (None on the other ranks)."""
    ctx = make_ctx(manifest, workload, seed, seconds, trace, device, t_start,
                   rank, world, port, overrides, here)
    traffic = ctx.traffic
    runner = importlib.import_module(f"perfbench.runners.{traffic['runner']}")
    rec = runner.run(ctx)
    if rank != 0:
        return None
    if trace:
        metrics = {}
        for m in cell_metrics(manifest, workload, "per_layer"):
            value = load_module("metrics", m["name"], here).read(rec["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": load_module("end_to_end", m["name"],
                                                    here).read(rec),
                               "unit": m["unit"]}
                   for m in cell_metrics(manifest, workload, "end_to_end")}
    device = device_info(ctx.device, world, rec["memory_peak_bytes"])
    out = {"correct": rec["correct"], "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = rec["trace"]["breakdown"]
    out["checks"] = rec["checks"]
    return out


def _parse(argv):
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # ranks of a cell of several chips (set by rank 0 for the others)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv, t_start):
    args = _parse(argv)
    manifest = load_manifest()
    cell = next((w for w in manifest["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"perfbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    world = int(cell["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"perfbench: {args.workload} needs {world} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    procs, port = [], args.port
    if world > 1 and args.rank == 0:
        port = _free_port()
        procs = _spawn_ranks(argv, world, port)
    try:
        result = run_cell(manifest, args.workload, args.seed, args.seconds,
                          args.trace, f"cuda:{args.rank}", t_start,
                          rank=args.rank, world=world, port=port)
    finally:
        codes = _join_ranks(procs, 120.0)
    if args.rank != 0:
        return 0
    if any(codes):
        print(f"perfbench: ranks 1..{world - 1} exited with {codes}",
              file=sys.stderr)
        return 1
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: the run loaded forbidden modules: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
