"""Progressive rendering: frames of `spp_frame` samples back to back, each a
fresh film with its own scramble seed, rendered in passes of `spp_pass`
samples over the whole film; a pass ends in torch.cuda.synchronize().

One rank: a pass is the port's ``path.render_chunk``, summed into the frame's
film on the device.  Several ranks (``ranks`` in the traffic, one chip a
rank): each renders `spp_pass` samples of its own sample indices through
``sharding.render_chunk_sharded`` and ``multihost.combine_partials`` gives
rank 0 the combined film; a pass then covers ranks x spp_pass samples.

The window runs whole passes until --seconds have passed.  What is judged
is the film of each pass, a sample of them drawn from the seed, against the
plain reference (perfbench/reference) rendering the same samples.
"""

import random
import sys
import time

import numpy as np
import torch

from .. import scenes, tracing
from ..reference import compare


def frame_seed(seed, frame):
    """The scramble seed of frame `frame` of a run seeded `seed` (u32)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), int(frame)])
    return int(ss.generate_state(1, np.uint32)[0])


def tenths_ms(walls):
    """Mean pass wall time (ms) of each tenth of the window, in order."""
    n = len(walls)
    cuts = [round(i * n / 10) for i in range(11)]
    return [round(1e3 * sum(walls[a:b]) / (b - a), 1)
            for a, b in zip(cuts, cuts[1:]) if b > a]



def make_cfg(path_mod, scene, width, height, t, **kw):
    return path_mod.make_config(
        scene, width, height, spp=t["spp_frame"], max_depth=t["max_depth"],
        spp_chunk=t["spp_pass"], rr_threshold=t["rr_threshold"],
        fast_mis=t["fast_mis"], compact_tail=t["compact_tail"],
        pipeline_casts=t.get("pipeline_casts", False),
        compact_stages=tuple(tuple(s) for s in t.get("compact_stages", ())),
        **kw)


class _Frames:
    """The sampler of each frame, made when the frame starts."""

    def __init__(self, make, seed):
        self.make, self.seed, self.frame, self.smp = make, seed, -1, None

    def get(self, frame):
        if frame != self.frame:
            self.frame, self.smp = frame, self.make(frame_seed(self.seed, frame))
        return self.smp


def run(ctx):
    from gnxraytracer_tpu_torch.models.integrators import path
    from gnxraytracer_tpu_torch.ops import samplers
    from gnxraytracer_tpu_torch.scene import camera as cam_mod
    from gnxraytracer_tpu_torch.scene import scene as scene_mod

    t, dev, world, rank = ctx.traffic, ctx.device, ctx.world, ctx.rank
    if t["ranks"] != world:
        raise ValueError(f"traffic {ctx.cell['traffic']} takes {t['ranks']} "
                         f"rank(s), the cell {world}")
    if world > 1:
        from gnxraytracer_tpu_torch.parallel import multihost, sharding

        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        multihost.init(coordinator=f"127.0.0.1:{ctx.port}",
                       num_processes=world, process_id=rank,
                       device="cpu" if dev.type == "cpu" else None,
                       local_rank=rank, local_world_size=world, timeout_s=300)
    if t["sampler"] != "sobol":
        raise ValueError("the progressive runner takes the Sobol' sampler")
    scene, camera = scenes.build_scene(
        ctx.config, scene_mod.SceneBuilder, cam_mod.make_perspective_camera,
        dev, **ctx.overrides)
    width = ctx.overrides.get("width", ctx.config["width"])
    height = ctx.overrides.get("height", ctx.config["height"])
    cfg = make_cfg(path, scene, width, height, t)
    spp_pass = t["spp_pass"]
    per_frame = t["spp_frame"] // (spp_pass * world)
    frames = _Frames(lambda s: samplers.make_sobol_sampler(
        t["spp_frame"], seed=s, device=dev), ctx.seed)
    stop = torch.zeros((1,), dtype=torch.int32, device=dev)
    combine_wait = []

    def one_pass(i, timed_combine=False):
        """Pass i of the run (frame i // per_frame); the (H*W, 3) film of
        its samples on rank 0."""
        f, k = divmod(i, per_frame)
        smp = frames.get(f)
        if world == 1:
            return path.render_chunk(scene, camera, smp, cfg, k * spp_pass,
                                     spp_pass)
        s0 = (k * world + rank) * spp_pass
        part = sharding.render_chunk_sharded(
            scene, camera, smp, cfg, sharding.make_mesh(1), s0, spp_pass)
        if timed_combine:
            tracing.sync(dev)
            tc = time.perf_counter()
        film = multihost.combine_partials(part, 1.0, 1.0)
        if timed_combine:
            tracing.sync(dev)
            combine_wait.append(time.perf_counter() - tc)
        return film

    # set-up: the cell's shapes warmed up by one pass (and, on several
    # ranks, the collective) before the clock stops
    one_pass(0)
    if world > 1:
        torch.distributed.all_reduce(stop)
    tracing.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    films, walls = [], []
    acc = None
    t_win = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        img = one_pass(i, timed_combine=ctx.trace and world > 1)
        if i % per_frame == 0:
            acc = torch.zeros_like(img)
        acc = acc + img
        tracing.sync(dev)
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        films.append(img)
        i += 1
        if world > 1:
            stop.fill_(int(rank == 0 and t1 - t_win >= ctx.seconds))
            torch.distributed.broadcast(stop, 0)
            if int(stop.item()):
                break
        elif t1 - t_win >= ctx.seconds:
            break
    window_s = time.perf_counter() - t_win
    n_pass = len(walls)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if world > 1:
        pk = torch.tensor([peak], dtype=torch.int64, device=dev)
        torch.distributed.all_reduce(pk, op=torch.distributed.ReduceOp.MAX)
        peak = int(pk.item())

    trace = None
    if ctx.trace:
        n_prof = t["profile_passes"]
        with tracing.cast_spans(cfg.n_tris) as calls:
            tr = tracing.profile(lambda j: one_pass(n_pass + j), n_prof, dev,
                                 ctx.tmpdir, tag=f"rank{rank}")
        busy = tr["busy_s"]
        if world > 1:
            b = torch.tensor([busy], dtype=torch.float64, device=dev)
            torch.distributed.all_reduce(b)
            busy = float(b.item()) / world
        bytes_by = {}
        for name, nb in calls:
            bytes_by[name] = bytes_by.get(name, 0) + nb
        trace = dict(tr, kind="render", units=n_prof, busy_s=busy,
                     unit_wall_s=sum(walls) / len(walls),
                     cast_bytes=bytes_by, combine_wait_s=combine_wait)
        print(f"perfbench: traced {n_prof} passes, {tr['kernels']} kernels, "
              f"spans {tr['span_calls']}, cast device s "
              f"{tr['span_device_s']}, unplaced kernels "
              f"{tr['unplaced_kernels']}", flush=True, file=sys.stderr)

    if world > 1:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    # the port's state goes before the reference runs
    del scene, camera, acc, frames
    if rank != 0:
        return None
    rng = random.Random(ctx.seed)
    picked = sorted(rng.sample(range(n_pass), min(t["check_passes"], n_pass)))
    kept = {i: films[i] for i in picked}
    del films
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"perfbench: set-up {setup_s:.3f} s, {n_pass} passes in "
          f"{window_s:.3f} s; ms a pass by tenth of the window "
          f"{tenths_ms(walls)}", file=sys.stderr, flush=True)
    checks, failed = judge(ctx, kept, per_frame, width, height)
    return {"setup_s": setup_s, "window_s": window_s, "walls": walls,
            "paths": n_pass * width * height * spp_pass * world,
            "attempted": n_pass, "failed": failed,
            "correct": failed == 0, "checks": checks,
            "memory_peak_bytes": peak, "trace": trace}


def judge(ctx, kept, per_frame, width, height):
    """The reference's film of each kept pass against the port's: returns
    ({number: {value, limit}}, passes off their limit)."""
    from ..reference import render as ref

    t, world = ctx.traffic, ctx.world
    t0 = time.perf_counter()
    rscene, rcam = ref.build(ctx.config, ctx.device, ctx.overrides)
    print(f"perfbench: reference scene built in {time.perf_counter() - t0:.2f} s",
          file=sys.stderr, flush=True)
    rcfg = make_cfg(ref.path, rscene, width, height, t, **ref.CFG)
    limit = ctx.limits["pixels_off"]
    worst, failed = 0.0, 0
    smp_of = {}
    for i, film in kept.items():
        f, k = divmod(i, per_frame)
        if f not in smp_of:
            smp_of[f] = ref.sobol(t["spp_frame"], frame_seed(ctx.seed, f),
                                  ctx.device)
        want = None
        for r in range(world):
            s0 = (k * world + r) * t["spp_pass"]
            part = ref.pass_film(rscene, rcam, smp_of[f], rcfg, s0,
                                 t["spp_pass"])
            want = part if want is None else want + part
        off = compare.pixels_off(film, want)
        print(f"perfbench: pass {i} (frame {f}, pass {k}) pixels_off {off!r}"
              f" at {time.perf_counter() - t0:.2f} s",
              file=sys.stderr, flush=True)
        worst = max(worst, off)
        failed += int(off > limit)
    return {"pixels_off": {"value": worst, "limit": limit}}, failed
