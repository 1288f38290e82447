"""N ranks against one process: runs the worker of parallel/multihost.py in
one process and on N ranks (``spawn_ranks``: one process a rank with
torchrun's environment; one card a rank, NCCL where each rank has a card of
its own; ``--cpu``: gloo CPU ranks) for each mode, and prints one JSON line
a mode: the image's max abs error against one process (or the train step's
loss and parameter errors), each rank's seconds, launches, backend and compaction (stages and
p_keep), beside one process's seconds.

    python -m gnxraytracer_tpu_torch.tools.compare_ranks --nproc 4 \\
        [--spp 256] [--modes samples,rows,pixels,train] [--cpu]

The render modes take the Cornell main path (500x500, depth 8, 4 spp a
chunk, Sobol', fast-MIS, tail compaction, counted casts); the train mode
takes the Cornell train step of chip_smoke.py's phase 10 (4 spp, Halton,
the faithful estimator).  The kernels are built before the first run.  A
rank's seconds run from its first chunk to its result (the first chunk's
warm-up included), not its start-up.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKER = ["-m", "gnxraytracer_tpu_torch.parallel.multihost"]
COMMON = ["--preset", "cornell", "--width", "500", "--height", "500",
          "--max-depth", "8"]


def records(log):
    """The JSON records the ranks printed, in any order, wherever other
    output interleaved with them."""
    dec, out = json.JSONDecoder(), []
    i = log.find('{"rank"')
    while i >= 0:
        out.append(dec.raw_decode(log, i)[0])
        i = log.find('{"rank"', i + 1)
    return out


def spawn_ranks(argv, n, out, timeout_s, env=None):
    """Start n ranks of the worker with its arguments argv, each with
    torchrun's environment on loopback (n = 1: one plain process, no process
    group), under one deadline of timeout_s; every rank still running at the
    deadline is killed.  Each rank's output goes to a file beside out (no
    pipe to fill).  env: more environment for every rank.  Returns (rank 0's
    result, read from out; the ranks' records in rank order).  Raises
    RuntimeError when a rank fails, prints no record or outlives the
    deadline."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = {k: v for k, v in os.environ.items()
            if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                         "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    base.update(TORCH_CPP_LOG_LEVEL="ERROR", **(env or {}))
    procs, logs = [], [f"{out}.rank{rank}.log" for rank in range(n)]
    try:
        for rank in range(n):
            rank_env = dict(base)
            if n > 1:
                rank_env.update(
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                    WORLD_SIZE=str(n), RANK=str(rank), LOCAL_RANK=str(rank),
                    LOCAL_WORLD_SIZE=str(n))
            with open(logs[rank], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, *WORKER, "--out", out, *argv], cwd=ROOT,
                    env=rank_env, stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        for rank, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {rank} of {' '.join(argv)} outlived "
                                   f"{timeout_s} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for rank, (p, name) in enumerate(zip(procs, logs)):
        with open(name) as f:
            log = f.read()
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} of {' '.join(argv)} failed:\n"
                               f"{log[-3000:]}")
        got = records(log)
        if len(got) != 1 or got[0]["rank"] != rank:
            raise RuntimeError(f"rank {rank} of {' '.join(argv)} printed "
                               f"no record:\n{log[-3000:]}")
        recs.append(got[0])
    with np.load(out) as z:
        return dict(z), recs


def main(argv=None):
    ap = argparse.ArgumentParser(prog="compare_ranks")
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--modes", default="samples,rows,pixels,train")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--timeout", type=int, default=600)
    args = ap.parse_args(argv)
    extra = ["--cpu"] if args.cpu else []
    render = COMMON + ["--spp", str(args.spp), "--spp-chunk", "4",
                       "--fast-mis", "--compact-tail", "--count-rays"] + extra
    train = COMMON + ["--spp", "4", "--spp-chunk", "4", "--sampler", "halton",
                      "--lr", "1.0"] + extra
    modes = args.modes.split(",")
    if not args.cpu:
        from ..kernels import build

        names = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR)
                       if f.endswith(".cu"))
        for handle in [build.start_build(n) for n in names]:
            build.finish_build(handle)
    with tempfile.TemporaryDirectory() as tmp:
        one = {}
        if set(modes) - {"train"}:
            # one process: every split of it is path.render's image
            one["render"] = spawn_ranks(["--mode", "pixels"] + render, 1,
                                        os.path.join(tmp, "one_render.npz"),
                                        args.timeout)
        if "train" in modes:
            one["train"] = spawn_ranks(["--mode", "train"] + train, 1,
                                       os.path.join(tmp, "one_train.npz"),
                                       args.timeout)
        for mode in modes:
            key = "train" if mode == "train" else "render"
            want, (one_rec,) = one[key]
            got, recs = spawn_ranks(
                ["--mode", mode] + (train if key == "train" else render),
                args.nproc, os.path.join(tmp, f"{mode}.npz"), args.timeout)
            line = {"mode": mode, "nproc": args.nproc,
                    "one_process_seconds": one_rec["seconds"],
                    "rank_seconds": [r["seconds"] for r in recs],
                    "devices": [r["device"] for r in recs],
                    "backend": recs[0]["backend"],
                    "rank_launches": [r["launches"] for r in recs],
                    "compaction": [dict(r["compaction"], p_keep_all_1=all(
                        p == 1.0 for p in r["compaction"]["p_keep"]))
                        for r in recs]}
            for r in line["compaction"]:
                del r["p_keep"]
            if key == "train":
                line["loss"], line["one_loss"] = (float(got["loss"]),
                                                  float(want["loss"]))
                line["loss_rel_err"] = abs(line["loss"] - line["one_loss"]) / \
                    abs(line["one_loss"])
                line["param_max_abs_err"] = {
                    k[6:]: float(np.abs(got[k] - want[k]).max())
                    for k in want if k.startswith("param_")}
            else:
                line["max_abs_err"] = float(np.abs(got["image"]
                                                   - want["image"]).max())
                line["mean"] = float(got["image"].mean())
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
