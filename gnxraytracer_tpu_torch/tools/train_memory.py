"""Device memory and time of one pass of the train step, per lane; a
development measurement on one NVIDIA GPU.

    python -m gnxraytracer_tpu_torch.tools.train_memory [--spp-chunks 1,2]
        [--scenes cornell,mesh]

From the repo root.  For each scene at 500x500, depth 8, and each
spp_chunk, one pass of the train step's loss over every pixel
(parallel/sharding.pass_image, the faithful estimator) with every class of
extract_params requiring grad, then backward(): forward ms and backward ms
(CUDA events), and the peak of torch.cuda.max_memory_allocated above what
was allocated before the pass, over the lanes (pixels x spp_chunk) and over
the lanes and the bounces (max_depth + 1): the figure
sharding.BYTES_PER_LANE_BOUNCE states.  Scenes: "cornell" is
presets.cornell_box with Halton (casts through the brute-force kernels),
"mesh" chip_smoke.mesh_setup's envmap_mesh with a procedural HDR environment
and Sobol' (casts through the BVH kernels).  Prints one JSON line a
measurement, after the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch


def _scene(name, dev, tmp):
    from gnxraytracer_tpu_torch.ops import samplers
    from gnxraytracer_tpu_torch.scene import presets

    w = h = 500
    if name == "cornell":
        scene, cam = presets.cornell_box(w, h, device=dev)
        return scene, cam, lambda spp: samplers.make_halton_sampler(
            spp, w, h, device=dev)
    from gnxraytracer_tpu_torch.utils.image import write_procedural_hdr

    hdr = write_procedural_hdr(os.path.join(tmp, "env.hdr"))
    scene, cam = presets.envmap_mesh(w, h, hdr_path=hdr, device=dev)
    return scene, cam, lambda spp: samplers.make_sobol_sampler(spp, device=dev)


def measure(name, scene, cam, make_sampler, spp_chunk, max_depth=8):
    from gnxraytracer_tpu_torch.models.integrators import path
    from gnxraytracer_tpu_torch.parallel import sharding

    w, h = cam.width, cam.height
    cfg = path.make_config(scene, w, h, spp=spp_chunk, max_depth=max_depth,
                           spp_chunk=spp_chunk, use_pallas=True)
    smp = make_sampler(spp_chunk)
    dev = scene.device
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in sharding.extract_params(scene).items()}
    pixel = torch.arange(w * h, dtype=torch.int32, device=dev)
    target = torch.zeros((w * h, 3), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    img = sharding.pass_image(sharding.insert_params(scene, leaves), cam,
                              smp, cfg, pixel, 0)
    loss = torch.sum((img - target) ** 2) / (3 * w * h)
    ev[1].record()
    loss.backward()
    ev[2].record()
    torch.cuda.synchronize()
    lanes = w * h * spp_chunk
    peak = torch.cuda.max_memory_allocated() - base
    finite = all(bool(torch.isfinite(v.grad).all()) for v in leaves.values()
                 if v.grad is not None)
    return {"scene": name, "lanes": lanes, "max_depth": max_depth,
            "forward_ms": ev[0].elapsed_time(ev[1]),
            "backward_ms": ev[1].elapsed_time(ev[2]),
            "peak_bytes": peak, "bytes_per_lane": peak / lanes,
            "bytes_per_lane_bounce": peak / lanes / (max_depth + 1),
            "loss": float(loss), "grads_finite": finite}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp-chunks", default="1,2")
    ap.add_argument("--scenes", default="cornell,mesh")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.scenes.split(","):
            scene, cam, make_sampler = _scene(name, dev, tmp)
            # a small warm-up pass builds the kernels outside the measurement
            measure(name, scene, cam, make_sampler, 1, max_depth=1)
            for spp in (int(s) for s in args.spp_chunks.split(",")):
                print(json.dumps(measure(name, scene, cam, make_sampler, spp)),
                      flush=True)
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
