"""Benchmark of the port: Mpaths/s and wall-clock to full spp on the three
workloads of the JAX package's bench.py, on one CUDA device.  Prints ONE
JSON line with bench.py's keys (less its two TPU shares, plus
``mesh_env``).

    python -m gnxraytracer_tpu_torch.bench [--reps N] [--cpu]

Workloads (bench.py's): Cornell 500x500, 256 spp, depth 8, 4 spp a chunk
(1M lanes), Sobol', the folded-MIS estimator with tail compaction and
counted rays; the reference renderer's own default, Whitted at depth 5, 32
spp, Halton, 8 spp a chunk; the ~105k-triangle mesh scene (envmap_mesh), 64
spp, the pipelined casts with four compaction stages.  Every figure is the
median of `reps` runs (min and max beside it), each timed on the host clock
between two torch.cuda.synchronize() calls, after one warm-up chunk.

``vs_baseline`` divides by the reference renderer's Mpaths/s on the same
workload, measured on a CPU (BASELINE_MEASURED.json, written by
tools/parity.py baseline).  The system runs no model, so the bench reports
no utilisation share.  The mesh scene's environment is
$GNX_RESOURCES/MonValley1000.hdr when that file exists, else a procedural
HDR (utils/image.write_procedural_hdr); ``mesh_env`` says which.  A failure
of any workload ends the run with the exception (exit code other than 0).
"""

import argparse
import json
import os
import tempfile
import time

import torch

from .utils.device import describe_device, resolve_device

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_STAGES = ((0, 2), (1, 16), (2, 32), (4, 64))


def measured_baseline(workload):
    """The reference renderer's Mpaths/s on `workload` (a key of
    BASELINE_MEASURED.json's "workloads"), or None where the file has none."""
    try:
        with open(os.path.join(_ROOT, "BASELINE_MEASURED.json")) as f:
            return json.load(f)["workloads"][workload]["Mpaths_per_s"]
    except (OSError, KeyError):
        return None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_chunks(render_chunk, scene, camera, sampler, cfg):
    """The bench's loop: render_chunk over spp_chunk slices of cfg.spp,
    summed on the device.  Returns (the (H*W, 3) radiance sum, useful
    casts) — casts is None unless cfg.count_rays."""
    dev = scene.geom.vertices.device
    acc = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32,
                      device=dev)
    nrays = torch.zeros((), dtype=torch.float32, device=dev)
    s = 0
    while s < cfg.spp:
        ns = min(cfg.spp_chunk, cfg.spp - s)
        out = render_chunk(scene, camera, sampler, cfg, s, ns)
        if cfg.count_rays:
            out, nr = out
            nrays = nrays + nr
        acc = acc + out
        s += ns
    return acc, (float(nrays) if cfg.count_rays else None)


def _reps(fn, reps):
    """(median, min, max) of reps calls of fn(), each returning seconds."""
    walls = sorted(fn() for _ in range(reps))
    return walls[len(walls) // 2], walls[0], walls[-1]


def _timed(render_chunk, scene, camera, sampler, cfg, reps):
    """One warm-up chunk, then reps timed runs of run_chunks.  Returns
    (median, min, max seconds, useful casts of the last run)."""
    dev = scene.geom.vertices.device
    render_chunk(scene, camera, sampler, cfg, 0, min(cfg.spp_chunk, cfg.spp))
    _sync(dev)
    casts = [None]

    def run_once():
        _sync(dev)
        t0 = time.perf_counter()
        _acc, casts[0] = run_chunks(render_chunk, scene, camera, sampler, cfg)
        _sync(dev)
        return time.perf_counter() - t0

    return (*_reps(run_once, reps), casts[0])


def cornell_setup(width, height, spp, max_depth, device):
    """bench.py main's workload: (scene, camera, sampler, cfg)."""
    from .models.integrators import path
    from .ops import samplers
    from .scene import presets

    scene, camera = presets.cornell_box(width=width, height=height,
                                        device=device)
    cfg = path.make_config(scene, width, height, spp=spp, max_depth=max_depth,
                           spp_chunk=4, rr_threshold=1.0, fast_mis=True,
                           compact_tail=True, count_rays=True)
    return scene, camera, samplers.make_sobol_sampler(spp, device=device), cfg


def bench_cornell(width=500, height=500, spp=256, max_depth=8, reps=3,
                  device="cuda"):
    from .models.integrators import path

    dev = resolve_device(device)
    scene, camera, sampler, cfg = cornell_setup(width, height, spp, max_depth,
                                                dev)
    wall, wall_min, wall_max, n_rays = _timed(path.render_chunk, scene, camera,
                                              sampler, cfg, reps)
    n_paths = width * height * spp
    mpaths = n_paths / wall / 1e6
    base = measured_baseline("path_500px_256spp") or 0.4371
    return {
        "metric": "cornell_500px_256spp_Mpaths_per_s",
        "value": mpaths,
        "unit": "Mpaths/s",
        "vs_baseline": mpaths / base,
        "wall_s_256spp": wall,
        "wall_s_min": wall_min,
        "wall_s_max": wall_max,
        "Mrays_per_s": n_rays / wall / 1e6,
        "rays_per_path": n_rays / n_paths,
        "device": describe_device(dev),
    }


def bench_whitted(width=500, height=500, spp=32, max_depth=5, reps=3,
                  device="cuda"):
    from .models.integrators import path, whitted
    from .ops import samplers
    from .scene import presets

    dev = resolve_device(device)
    scene, camera = presets.cornell_box(width=width, height=height, device=dev)
    cfg = path.make_config(scene, width, height, spp=spp, max_depth=max_depth,
                           spp_chunk=8)
    sampler = samplers.make_halton_sampler(spp, width, height, device=dev)
    wall, wall_min, wall_max, _ = _timed(whitted.render_chunk, scene, camera,
                                         sampler, cfg, reps)
    mp = width * height * spp / wall / 1e6
    out = {"whitted_Mpaths_per_s": mp,
           "whitted_wall_s_32spp": wall,
           "whitted_wall_s_min": wall_min,
           "whitted_wall_s_max": wall_max}
    base = measured_baseline("whitted_500px_32spp")
    if base:
        out["whitted_vs_baseline"] = mp / base
    return out


def mesh_environment(tmp):
    """(path of the mesh scene's HDR, its name for ``mesh_env``):
    $GNX_RESOURCES/MonValley1000.hdr when it exists, else a procedural HDR
    written under tmp."""
    root = os.environ.get("GNX_RESOURCES")
    hdr = os.path.join(root, "MonValley1000.hdr") if root else None
    if hdr is not None and os.path.exists(hdr):
        return hdr, "MonValley1000.hdr"
    from .utils.image import write_procedural_hdr

    return (write_procedural_hdr(os.path.join(tmp, "procedural_env.hdr")),
            "procedural")


def bench_mesh(width=500, height=500, spp=64, max_depth=8, reps=3,
               device="cuda"):
    from .models.integrators import path
    from .ops import samplers
    from .scene import presets

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        hdr, env_name = mesh_environment(tmp)
        scene, camera = presets.envmap_mesh(width, height, hdr_path=hdr,
                                            device=dev)
    n_tris = int(scene.geom.triangles.shape[0])
    # pipelined casts with a stage at bounce 0: each bounce's shading runs
    # at the width of the lanes whose cast hit
    cfg = path.make_config(scene, width, height, spp=spp, max_depth=max_depth,
                           spp_chunk=4, rr_threshold=1.0, fast_mis=True,
                           compact_tail=True, pipeline_casts=True,
                           compact_stages=MESH_STAGES, count_rays=True)
    sampler = samplers.make_sobol_sampler(spp, device=dev)
    wall, wall_min, wall_max, n_rays = _timed(path.render_chunk, scene, camera,
                                              sampler, cfg, reps)
    n_paths = width * height * spp
    out = {"mesh_tris": n_tris}
    base = measured_baseline("envmesh_500px_64spp")
    if base:
        out["mesh_vs_baseline"] = n_paths / wall / 1e6 / base
    out.update({
        "mesh_bvh_mode": cfg.bvh_mode,
        "mesh_Mpaths_per_s": n_paths / wall / 1e6,
        "mesh_wall_s_64spp": wall,
        "mesh_wall_s_min": wall_min,
        "mesh_wall_s_max": wall_max,
        "mesh_Mrays_per_s": n_rays / wall / 1e6,
        "mesh_rays_per_path": n_rays / n_paths,
        "mesh_env": env_name,
    })
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="gnxraytracer_tpu_torch.bench")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    result = bench_cornell(reps=args.reps, device=device)
    result.update(bench_whitted(reps=args.reps, device=device))
    result.update(bench_mesh(reps=args.reps, device=device))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
