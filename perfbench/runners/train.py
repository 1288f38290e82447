"""Inverse-rendering train steps: the `run` that the port's
``sharding.make_train_step`` returns, called with ``stats={}``, each step
from the parameters the last one returned, at a new ``sample_start``.

Step k takes samples k * spp_pass .. + spp_pass, as a training run that
starts at sample 0 does, so every seed makes the same work; the seed draws
the target image (on the device, without the port).  Set-up builds the
scene and the step and drives the step through its first `checked_steps`
steps, recording each loss and the parameters; the window then runs whole
steps of that same object until --seconds have passed.
The reference follows the checked steps from the same parameters, target
and samples (perfbench/reference/train.py), after the window.  It also
takes one step of the window, drawn from the seed: from the parameters the
port started that step with (the reference cannot afford to follow every
step from the start), with that step's samples, against the loss the port
returned and the parameters it made.
"""

import random
import sys
import time

import torch

from .. import scenes, tracing
from ..reference import compare


def target_image(seed, width, height, low, high, device):
    """(H, W, 3) float32 uniform in [low, high), from the seed."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2 ** 63 - 1))
    u = torch.rand((height, width, 3), generator=g, device=device)
    return low + (high - low) * u



def _start_params(scene, scales):
    return {"kd": scene.materials.kd * scales["kd"],
            "light_emit": scene.lights.emit * scales["light_emit"]}


def setup_port(ctx):
    """The port's side of a run: scene, camera, sampler, the train step,
    the target, the first sample index and the start parameters."""
    from types import SimpleNamespace

    from gnxraytracer_tpu_torch.models.integrators import path
    from gnxraytracer_tpu_torch.ops import samplers
    from gnxraytracer_tpu_torch.parallel import sharding
    from gnxraytracer_tpu_torch.scene import camera as cam_mod
    from gnxraytracer_tpu_torch.scene import scene as scene_mod

    t, dev = ctx.traffic, ctx.device
    if ctx.world != 1 or t["sampler"] != "halton":
        raise ValueError("the train runner takes one rank and Halton")
    scene, camera = scenes.build_scene(
        ctx.config, scene_mod.SceneBuilder, cam_mod.make_perspective_camera,
        dev, **ctx.overrides)
    width, height = camera.width, camera.height
    cfg = path.make_config(scene, width, height, spp=t["spp_pass"],
                           max_depth=t["max_depth"], spp_chunk=t["spp_pass"],
                           rr_threshold=t["rr_threshold"])
    return SimpleNamespace(
        scene=scene, camera=camera,
        smp=samplers.make_halton_sampler(t["spp_pass"], width, height,
                                         device=dev),
        step=sharding.make_train_step(cfg, device=dev),
        target=target_image(ctx.seed, width, height, t["target"]["low"],
                            t["target"]["high"], dev),
        params=_start_params(scene, t["params"]))


def run(ctx):
    t, dev = ctx.traffic, ctx.device
    t_runner = time.perf_counter()
    p = setup_port(ctx)
    t_built = time.perf_counter()
    scene, camera, step, smp = p.scene, p.camera, p.step, p.smp
    target, lr = p.target, t["lr"]
    width, height = camera.width, camera.height
    history, losses = [p.params], []
    state = {"k": 0, "params": p.params}

    def one_step(_i=None, stats=None):
        k = state["k"]
        loss, state["params"] = step(
            state["params"], scene, camera, smp, target,
            sample_start=k * t["spp_pass"], lr=lr,
            stats={} if stats is None else stats)
        state["k"] = k + 1
        return loss

    # set-up: the first steps, recorded for the check (the first one warms
    # up every shape of the step)
    checked_s = []
    for _ in range(t["checked_steps"]):
        t0 = time.perf_counter()
        losses.append(float(one_step()))
        checked_s.append(time.perf_counter() - t0)
        history.append(state["params"])
    tracing.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    # where set-up went: process start to the runner (interpreter, imports,
    # torch), the scene, the CUDA context and the step, each checked step
    print(f"perfbench: set-up parts {t_runner - ctx.t_start:.3f} s to the "
          f"runner, {t_built - t_runner:.3f} s scene and step, checked steps "
          f"{[round(c, 3) for c in checked_s]} s", file=sys.stderr, flush=True)

    walls, backward_ms = [], []
    # every window step's loss and the parameters before and after it (a
    # few floats a step), for the check of one of them
    win_losses, win_hist = [], [state["params"]]
    t_win = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        stats = {}
        win_losses.append(one_step(stats=stats))
        tracing.sync(dev)
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        backward_ms.append(stats["backward_ms"])
        win_hist.append(state["params"])
        if t1 - t_win >= ctx.seconds:
            break
    window_s = time.perf_counter() - t_win
    j = random.Random(ctx.seed).randrange(len(walls))
    win_step = {"k": t["checked_steps"] + j,
                "loss": float(win_losses[j]),
                "params": (win_hist[j], win_hist[j + 1])}
    del win_losses, win_hist
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    trace = None
    if ctx.trace:
        n_prof = t["profile_steps"]
        tr = tracing.profile(one_step, n_prof, dev, ctx.tmpdir, tag="train")
        trace = dict(tr, kind="train", units=n_prof,
                     unit_wall_s=sum(walls) / len(walls),
                     backward_ms=backward_ms)
        print(f"perfbench: traced {n_prof} step(s), {tr['kernels']} kernels",
              file=sys.stderr, flush=True)

    del scene, camera, step, smp, state, p
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"perfbench: set-up {setup_s:.3f} s, {len(walls)} steps in "
          f"{window_s:.3f} s; ms a step {[round(w * 1e3, 1) for w in walls]}",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    checks = judge(ctx, losses, history, win_step, target, width, height)
    print(f"perfbench: reference {time.perf_counter() - t0:.2f} s",
          file=sys.stderr, flush=True)
    failed = sum(int(c["value"] > c["limit"]) for c in checks.values())
    return {"setup_s": setup_s, "window_s": window_s, "walls": walls,
            "attempted": len(walls), "failed": int(failed > 0),
            "correct": failed == 0, "checks": checks,
            "memory_peak_bytes": peak, "trace": trace}


def reference_steps(ctx, target, width, height, params=None, first=0,
                    n=None):
    """The reference's steps first .. first + n - 1 (the checked steps by
    default) from `params` (the configuration's start by default): (each
    step's loss, the parameters before and after each step, the first
    step's gradients)."""
    from ..reference import render as ref
    from ..reference import train as ref_train

    t, dev = ctx.traffic, ctx.device
    rscene, rcam = ref.build(ctx.config, dev, ctx.overrides)
    rcfg = ref.path.make_config(rscene, width, height, spp=t["spp_pass"],
                                max_depth=t["max_depth"],
                                spp_chunk=t["spp_pass"],
                                rr_threshold=t["rr_threshold"],
                                use_pallas=False)
    rsmp = ref.halton(t["spp_pass"], width, height, dev)
    if params is None:
        params = _start_params(rscene, t["params"])
    else:
        params = {k: v.detach().clone() for k, v in params.items()}
    n = t["checked_steps"] if n is None else n
    losses, hist, first_grads = [], [params], None
    for k in range(first, first + n):
        loss, params, grads = ref_train.step(
            params, rscene, rcam, rsmp, rcfg, target, k * t["spp_pass"],
            t["lr"])
        losses.append(float(loss))
        hist.append(params)
        if first_grads is None:
            first_grads = grads
    return losses, hist, first_grads


def window_gaps(ctx, win_step, target, width, height):
    """The reference's step win_step["k"] from the parameters the port
    started it with: {window_loss_gap, window_grad_gap}."""
    p0, p1 = win_step["params"]
    ref_losses, ref_hist, ref_grads = reference_steps(
        ctx, target, width, height, params=p0, first=win_step["k"], n=1)
    gaps = compare.train_gaps([win_step["loss"]], [p0, p1], ref_losses,
                              ref_hist, ref_grads, ctx.traffic["lr"])
    print(f"perfbench: window step {win_step['k']} loss {win_step['loss']} "
          f"reference {ref_losses[0]}", file=sys.stderr, flush=True)
    return {"window_loss_gap": gaps["loss_gap"],
            "window_grad_gap": gaps["grad_gap"]}


def judge(ctx, losses, history, win_step, target, width, height):
    """The reference follows the checked steps from the same start, and
    takes the window's step drawn from the seed."""
    ref_losses, ref_hist, ref_grads = reference_steps(ctx, target, width,
                                                      height)
    gaps = compare.train_gaps(losses, history, ref_losses, ref_hist,
                              ref_grads, ctx.traffic["lr"])
    print(f"perfbench: losses {losses} reference {ref_losses}",
          file=sys.stderr, flush=True)
    gaps.update(window_gaps(ctx, win_step, target, width, height))
    return {k: {"value": v, "limit": ctx.limits[k]} for k, v in gaps.items()}
