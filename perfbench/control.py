"""The readings that the limits of ``correct`` are set from, at a cell's own
size, many seeds in one process:

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--no-program] [--no-control]

For each seed it prints one JSON line with the numbers a run compares,
read twice against the plain reference: for the port (what the timed path
computes: the lower reading) and for the control, the reference itself
computed in the nearest precision below the configuration's float32,
bfloat16 (its throughput, radiance and films held in bfloat16; the upper
reading).  A render cell reads one pass of the seed's first frame (on a
cell of several ranks, the samples of every rank, rendered one after the
other here); a train cell the checked steps and the first window step.  The
benchmark's own runs do
not run this.
"""

import argparse
import json
import os
import random
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import harness, scenes, tracing  # noqa: E402
from perfbench.reference import compare  # noqa: E402
from perfbench.reference import render as ref  # noqa: E402
from perfbench.runners import progressive, train  # noqa: E402

LOWER = torch.bfloat16



def render_readings(ctx, seeds, program=True, control=True):
    """[{seed, pass, port, control}] of pixels_off for a render cell."""
    from gnxraytracer_tpu_torch.models.integrators import path
    from gnxraytracer_tpu_torch.ops import samplers
    from gnxraytracer_tpu_torch.parallel import sharding
    from gnxraytracer_tpu_torch.scene import camera as cam_mod
    from gnxraytracer_tpu_torch.scene import scene as scene_mod

    t, dev, ranks = ctx.traffic, ctx.device, ctx.traffic["ranks"]
    width = ctx.overrides.get("width", ctx.config["width"])
    height = ctx.overrides.get("height", ctx.config["height"])
    per_frame = t["spp_frame"] // (t["spp_pass"] * ranks)
    if program:
        scene, camera = scenes.build_scene(
            ctx.config, scene_mod.SceneBuilder,
            cam_mod.make_perspective_camera, dev, **ctx.overrides)
        cfg = progressive.make_cfg(path, scene, width, height, t)
    rscene, rcam = ref.build(ctx.config, dev, ctx.overrides)
    rcfg = progressive.make_cfg(ref.path, rscene, width, height, t, **ref.CFG)
    out = []
    for seed in seeds:
        fs = progressive.frame_seed(seed, 0)
        k = random.Random(seed).randrange(per_frame)
        starts = [(k * ranks + r) * t["spp_pass"] for r in range(ranks)]
        rsmp = ref.sobol(t["spp_frame"], fs, dev)

        def ref_film():
            return sum(ref.pass_film(rscene, rcam, rsmp, rcfg, s,
                                     t["spp_pass"]) for s in starts)

        want = ref_film()
        row = {"seed": seed, "pass": k}
        if control:
            with ref.path.lower_precision(LOWER):
                row["control"] = compare.pixels_off(ref_film(), want)
        if program:
            smp = samplers.make_sobol_sampler(t["spp_frame"], seed=fs,
                                              device=dev)
            got = None
            for s in starts:
                if ranks == 1:
                    o = path.render_chunk(scene, camera, smp, cfg, s,
                                          t["spp_pass"])
                else:
                    o = sharding.render_chunk_sharded(
                        scene, camera, smp, cfg, sharding.make_mesh(1), s,
                        t["spp_pass"])
                got = o if got is None else got + o
            row["port"] = compare.pixels_off(got, want)
        tracing.sync(dev)
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def train_readings(ctx, seeds, program=True, control=True):
    """[{seed, port: gaps, control: gaps}] for a train cell: the checked
    steps, and the first window step (step `checked_steps`) from the
    parameters before it (the port's where it runs, else the reference's)."""
    t, dev = ctx.traffic, ctx.device
    k = t["checked_steps"]
    out = []
    for seed in seeds:
        ctx.seed = seed
        width = ctx.overrides.get("width", ctx.config["width"])
        height = ctx.overrides.get("height", ctx.config["height"])
        target = train.target_image(seed, width, height, t["target"]["low"],
                                    t["target"]["high"], dev)
        want = train.reference_steps(ctx, target, width, height)
        row = {"seed": seed}
        if control:
            with ref.path.lower_precision(LOWER):
                ctl = train.reference_steps(ctx, target, width, height)
            row["control"] = compare.train_gaps(ctl[0], ctl[1], *want,
                                                t["lr"])
        if program:
            p = train.setup_port(ctx)
            losses, hist, params = [], [p.params], p.params
            for i in range(k + 1):
                loss, params = p.step(params, p.scene, p.camera, p.smp,
                                      target, sample_start=i * t["spp_pass"],
                                      lr=t["lr"], stats={})
                losses.append(float(loss))
                hist.append(params)
            row["port"] = compare.train_gaps(losses[:k], hist[:k + 1], *want,
                                             t["lr"])
            start = hist[k]
            del p
        else:
            start = want[1][-1]
        # the window step from the same parameters: the reference's, the
        # port's and the control's
        w_want = train.reference_steps(ctx, target, width, height,
                                       params=start, first=k, n=1)
        sides = []
        if control:
            with ref.path.lower_precision(LOWER):
                w_ctl = train.reference_steps(ctx, target, width, height,
                                              params=start, first=k, n=1)
            sides.append(("control", w_ctl[0], w_ctl[1]))
        if program:
            sides.append(("port", losses[k:k + 1], hist[k:k + 2]))
        for side, w_loss, w_hist in sides:
            w = compare.train_gaps(w_loss, w_hist, *w_want, t["lr"])
            row[side].update(window_loss_gap=w["loss_gap"],
                             window_grad_gap=w["grad_gap"])
        tracing.sync(dev)
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def readings(workload, seeds, device, program=True, overrides=None,
             manifest=None, control=True):
    ctx = harness.make_ctx(manifest or harness.load_manifest(), workload,
                           seeds[0], 0, 0, device, time.perf_counter(),
                           overrides=overrides)
    fn = {"progressive": render_readings,
          "train": train_readings}[ctx.traffic["runner"]]
    return fn(ctx, seeds, program=program, control=control)


def main(argv=None):
    p = argparse.ArgumentParser(prog="perfbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--no-program", action="store_true")
    p.add_argument("--no-control", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench/control.py reads at the cell's size on a CUDA "
              "device; none found", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    readings(args.workload, seeds, "cuda", program=not args.no_program,
             control=not args.no_control)
    return 0


if __name__ == "__main__":
    sys.exit(main())
