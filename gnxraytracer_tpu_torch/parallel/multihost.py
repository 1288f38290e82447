"""Rendering across processes: torch.distributed process groups and the
per-process split of the work.

Counterpart of the JAX package's parallel/multihost.py, with one process a
device (a rank) where the JAX package has one process a host:

  * ``init()`` starts the process group (idempotent) when a coordinator is
    known, from its arguments or from torchrun's environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK), with the rank's place on its host
    (LOCAL_RANK, LOCAL_WORLD_SIZE) as arguments or from torchrun; each rank
    takes cuda:(LOCAL_RANK % device_count) unless the caller asks for the
    CPU;
  * the work is split by sample ranges (each rank renders the whole film at
    its share of the samples, and ``combine_partials`` sums the films with
    all_reduce) or by row ranges (each rank renders a slab of rows, which
    ``combine_slabs`` gathers); parallel/sharding.py splits the pixels of
    each chunk instead.

The backend is nccl where every rank has a GPU of its own, else gloo (CPU
ranks, or more ranks than GPUs on a host: NCCL refuses two ranks on one
GPU); init prints which.  A failed collective raises: nothing falls back to
the one-process answer.

Run a sharded render or train step under torchrun, one rank a GPU:

    torchrun --nproc-per-node N -m gnxraytracer_tpu_torch.parallel.multihost \\
        --mode samples|rows|pixels|train --preset cornell --spp 64 --out r.npz

(``--cpu`` for CPU ranks).  Rank 0 writes the image (or the step's loss and
parameters) to --out; every rank prints one JSON line of what it did.
"""

import datetime
import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from . import sharding


def _world():
    """(rank, size) of the default process group; (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device=None, local_rank=None):
    """The device of this rank: the CPU when the caller names it; else
    cuda:(local_rank % device_count), local_rank defaulting to the device
    init set, else to LOCAL_RANK (0 in one process).  Raises without a CUDA
    device."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    resolve_device("cuda")
    if local_rank is None:
        if dist.is_initialized():
            return torch.device("cuda", torch.cuda.current_device())
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(device, local_ranks):
    """nccl when the ranks run on CUDA devices and each of the host's
    local_ranks ranks has a device of its own; gloo otherwise."""
    if device.type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _host_place(local_rank, local_world_size):
    """(local_rank, local_world_size): the arguments, else torchrun's
    LOCAL_RANK and LOCAL_WORLD_SIZE.  Raises where neither gives them: the
    device and the backend depend on how many ranks share the host."""
    if local_rank is None:
        local_rank = os.environ.get("LOCAL_RANK")
    if local_world_size is None:
        local_world_size = os.environ.get("LOCAL_WORLD_SIZE")
    if local_rank is None or local_world_size is None:
        raise ValueError(
            "multihost.init: the rank's place on its host is unknown; pass "
            "local_rank and local_world_size, or set LOCAL_RANK and "
            "LOCAL_WORLD_SIZE (torchrun does)")
    return int(local_rank), int(local_world_size)


def init(coordinator=None, num_processes=None, process_id=None, device=None,
         local_rank=None, local_world_size=None, timeout_s=600):
    """Start the default process group when a coordinator is known;
    idempotent.  coordinator:
    "host:port" (then num_processes and process_id are required), else
    torchrun's environment (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK).
    Either way the rank's place on its host comes from local_rank and
    local_world_size, else from LOCAL_RANK and LOCAL_WORLD_SIZE, and init
    raises without it.  Without a coordinator it does nothing: one process.
    device: "cpu" for CPU ranks."""
    if dist.is_initialized() or (coordinator is None
                                 and not os.environ.get("MASTER_ADDR")):
        return
    local_rank, local_ranks = _host_place(local_rank, local_world_size)
    dev = rank_device(device, local_rank)
    if coordinator is not None:
        init_method = f"tcp://{coordinator}"
        world, rank = int(num_processes), int(process_id)
    else:
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    backend = choose_backend(dev, local_ranks)
    print(f"multihost: rank {rank} of {world} on {dev}, backend {backend}",
          flush=True)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def sample_range_for_host(spp, process_id=None, process_count=None):
    """(first sample, count) of this rank's contiguous share of spp."""
    pid, n = _world()
    pid = pid if process_id is None else process_id
    n = n if process_count is None else process_count
    return sharding.split_range(spp, pid, n)


def row_range_for_host(height, process_id=None, process_count=None):
    """(first row, rows) of this rank's contiguous slab of the film."""
    pid, n = _world()
    pid = pid if process_id is None else process_id
    n = n if process_count is None else process_count
    return sharding.split_range(height, pid, n)


def render_multihost(scene, camera, sampler, cfg, mode="samples"):
    """Render this rank's share.  mode "samples": returns (this rank's
    (H, W, 3) mean over its samples, their count) — combine the ranks with
    combine_partials(partial, count, cfg.spp); the samples keep their global
    index, so the ranks draw disjoint samples.  mode "rows": returns (the
    (rows, W, 3) slab of its rows, rows) — combine with combine_slabs.  The
    row mode takes cfg.pixel_filter; the sample mode, through
    sharding.render_chunk_sharded, the box filter (as in the JAX package)."""
    dev = scene.geom.vertices.device
    if mode == "samples":
        start, count = sample_range_for_host(cfg.spp)
        hw = cfg.width * cfg.height
        acc = torch.zeros((hw, 3), dtype=torch.float32, device=dev)
        s = start
        while s < start + count:
            ns = min(cfg.spp_chunk, start + count - s)
            acc = acc + sharding.render_chunk_sharded(
                scene, camera, sampler, cfg, sharding.make_mesh(1), s, ns)
            s += ns
        count = max(count, 0)
        # mean over this rank's samples: combine_partials weights it by
        # count, so ranks with ragged sample counts combine correctly
        return acc.reshape(cfg.height, cfg.width, 3) / max(count, 1), count
    if mode != "rows":
        raise ValueError(f"render_multihost: mode {mode!r} is not "
                         "'samples' or 'rows'")
    from ..models.integrators import path as path_mod

    start, rows = row_range_for_host(cfg.height)
    rows = max(rows, 0)
    hw = cfg.width * rows
    pixel = start * cfg.width + torch.arange(hw, dtype=torch.int32,
                                             device=dev)
    acc = torch.zeros((hw, 3), dtype=torch.float32, device=dev)
    tracer = path_mod.trace_paths_fast if cfg.fast_mis else path_mod.trace_paths
    s = 0
    while s < cfg.spp:
        ns = min(cfg.spp_chunk, cfg.spp - s)
        acc = acc + torch.sum(sharding.pixel_radiance(
            scene, camera, sampler, cfg, pixel, s, ns, tracer, filtered=True),
            dim=0)
        s += ns
    return acc.reshape(rows, cfg.width, 3) / cfg.spp, rows


def combine_partials(partial, weight, total_weight):
    """Weighted combine of the sample-split partials: sum over the ranks of
    partial * weight, over total_weight, on every rank (all_reduce); in one
    process partial * weight / total_weight.  A failed collective raises."""
    return (sharding.all_reduce_sum(partial * weight, sharding.make_mesh())
            / total_weight)


def combine_slabs(slab, cfg):
    """The (H, W, 3) film from each rank's row slab (render_multihost's
    "rows" mode), on every rank."""
    start, rows = row_range_for_host(cfg.height)
    film = torch.zeros((cfg.height, cfg.width, 3), dtype=slab.dtype,
                       device=slab.device)
    film[start:start + max(rows, 0)] = slab
    return sharding.all_reduce_sum(film, sharding.make_mesh())


# ---------------------------------------------------------------------------
# the worker: one rank of a sharded render or train step
# ---------------------------------------------------------------------------

def _launch_counts():
    from ..kernels import closest_hit, packet_bvh, table_grad, wide_bvh

    return {"closest_hit": closest_hit.launch_count,
            "brute_any_hit": closest_hit.any_launch_count,
            "wide_closest_hit": wide_bvh.closest_launch_count,
            "wide_any_hit": wide_bvh.any_launch_count,
            "packet_closest_hit": packet_bvh.closest_launch_count,
            "packet_any_hit": packet_bvh.any_launch_count,
            "table_grad": table_grad.launch_count}


def _reset_launch_counts():
    from ..kernels import closest_hit, packet_bvh, table_grad, wide_bvh

    closest_hit.reset_launch_count()
    wide_bvh.reset_launch_counts()
    packet_bvh.reset_launch_counts()
    table_grad.reset_launch_count()


def setup(args, device):
    """(scene, camera, sampler, cfg) of the worker's arguments."""
    from ..cli import build_preset
    from ..models.integrators import path as path_mod
    from ..ops import samplers as samplers_mod

    scene, camera = build_preset(args.preset, args.width, args.height, device)
    cfg = path_mod.make_config(
        scene, args.width, args.height, spp=args.spp,
        max_depth=args.max_depth, spp_chunk=args.spp_chunk, rr_threshold=1.0,
        fast_mis=args.fast_mis, compact_tail=args.compact_tail,
        count_rays=args.count_rays)
    if args.sampler == "halton":
        sampler = samplers_mod.make_halton_sampler(args.spp, args.width,
                                                   args.height, device=device)
    else:
        sampler = samplers_mod.make_sobol_sampler(args.spp, device=device)
    return scene, camera, sampler, cfg


def train_inputs(scene, cfg):
    """The worker's train step inputs: kd at 0.8x the scene's and
    light_emit, toward a black target."""
    p = sharding.extract_params(scene)
    params = {"kd": p["kd"] * 0.8, "light_emit": p["light_emit"]}
    target = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                         device=scene.geom.vertices.device)
    return params, target


def compaction_report(cfg, rank_lanes):
    """The compaction stages that apply at the one-process width of a chunk
    and at this rank's (path._compaction_stages; none without
    cfg.compact_tail)."""
    from ..models.integrators import path as path_mod

    full = cfg.width * cfg.height * cfg.spp_chunk

    def stages(n):
        if not cfg.compact_tail or n <= 0:
            return []
        return [list(s) for s in path_mod._compaction_stages(
            cfg, n, increasing_bounces=cfg.pipeline_casts)]
    return {"lanes_one_process": full, "lanes_this_rank": rank_lanes,
            "stages_one_process": stages(full),
            "stages_this_rank": stages(rank_lanes)}


def run_worker(args):
    import json
    import time

    import numpy as np

    from ..models.integrators import path as path_mod

    device = "cpu" if args.cpu else None
    init(device=device)
    dev = rank_device(device)
    rank, world = _world()
    scene, camera, sampler, cfg = setup(args, dev)
    # the lanes of this rank's chunks: the whole film at its share of the
    # samples, or its rows of the film at every sample
    if args.mode == "samples":
        _, count = sample_range_for_host(cfg.spp)
        lanes = cfg.width * cfg.height * min(cfg.spp_chunk, max(count, 0))
    else:
        r0, r1 = sharding.mesh_rows(cfg, sharding.make_mesh())
        lanes = (r1 - r0) * cfg.width * cfg.spp_chunk
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _reset_launch_counts()
    t0 = time.perf_counter()
    with path_mod.recording_prethin() as prethin:
        if args.mode == "samples":
            partial, weight = render_multihost(scene, camera, sampler, cfg,
                                               "samples")
            out = {"image": combine_partials(partial, weight, cfg.spp)}
        elif args.mode == "rows":
            slab, _ = render_multihost(scene, camera, sampler, cfg, "rows")
            out = {"image": combine_slabs(slab, cfg)}
        elif args.mode == "pixels":
            out = {"image": sharding.render_sharded(
                scene, camera, sampler, cfg, sharding.make_mesh())}
        else:
            params, target = train_inputs(scene, cfg)
            step = sharding.make_train_step(cfg, device=dev,
                                            mesh=sharding.make_mesh())
            loss, new = step(params, scene, camera, sampler, target,
                             lr=args.lr)
            out = {"loss": loss, **{f"param_{k}": v for k, v in new.items()}}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    report = compaction_report(cfg, lanes)
    report["p_keep"] = [p for _, _, p in prethin]
    if rank == 0 and args.out:
        np.savez(args.out, **{k: v.cpu().numpy() for k, v in out.items()})
    print(json.dumps({"rank": rank, "world": world, "device": str(dev),
                      "backend": dist.get_backend() if world > 1 else None,
                      "mode": args.mode, "seconds": seconds,
                      "launches": launches, "compaction": report}),
          flush=True)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="gnxraytracer_tpu_torch.parallel.multihost")
    p.add_argument("--mode", default="samples",
                   choices=["samples", "rows", "pixels", "train"])
    p.add_argument("--preset", default="cornell")
    p.add_argument("--width", type=int, default=500)
    p.add_argument("--height", type=int, default=500)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--spp-chunk", type=int, default=4)
    p.add_argument("--max-depth", type=int, default=8)
    p.add_argument("--sampler", default="sobol", choices=["sobol", "halton"])
    p.add_argument("--fast-mis", action="store_true")
    p.add_argument("--compact-tail", action="store_true")
    p.add_argument("--count-rays", action="store_true")
    p.add_argument("--lr", type=float, default=1.0)
    p.add_argument("--cpu", action="store_true", help="CPU ranks (gloo)")
    p.add_argument("--out", default=None, help="rank 0 writes its result here")
    run_worker(p.parse_args(argv))


if __name__ == "__main__":
    main()
