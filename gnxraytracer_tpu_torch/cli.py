"""Command-line interface: scene presets, progressive rendering with
per-chunk stats (frame time / FPS / Mpaths/s), PNG export with the
reference tonemap, and checkpoint/resume of the linear accumulation state.

Runs on the CUDA device unless ``--cpu`` is given; without a CUDA device
and without ``--cpu`` it stops with an error.  On a CUDA device the casts
go through the hand-written kernels: the brute-force closest hit
(use_pallas=True) and, for the presets with a BVH, the wide-BVH closest-hit
and any-hit kernels (bvh_mode="pallas"), or with GNX_WIDE_BVH=0 in the
environment the binary threaded-BVH ones.  The defaults are the JAX CLI's:
the faithful path estimator with the Halton sampler at depth 5.

Usage:
  python -m gnxraytracer_tpu_torch.cli render --preset cornell --spp 64 \\
      --out out.png [--cpu]
  python -m gnxraytracer_tpu_torch.cli render --preset cornell-mesh \\
      --integrator whitted --spp 32 --out whitted.png
  python -m gnxraytracer_tpu_torch.cli render --preset cornell \\
      --sampler sobol --fast-mis --spp 64 --out out.png
  python -m gnxraytracer_tpu_torch.cli render --preset envmap \\
      --sampler sobol --fast-mis --max-depth 8 --spp 64 --out mesh.png
  python -m gnxraytracer_tpu_torch.cli presets
"""

import argparse
import json
import time

import numpy as np

PRESETS = {
    "cornell": "Cornell box + area light + skybox (reference default scene)",
    "cornell-mesh": "Cornell + procedural high-poly mesh via BVH (dragon stand-in)",
    "cornell-glass": "Cornell with glass/mirror/disney spheres (BASELINE cfg 3)",
    "sphere": "Single matte sphere + point light (BASELINE cfg 1)",
    "volume": "Volumetric Cornell: grid medium + homogeneous glass (BASELINE cfg 5)",
    "envmap": "Mesh + InfiniteAreaLight HDR environment (BASELINE cfg 4)",
    "gmd": "Cornell + Glass/Mirror/Disney boxes (oracle parity twin)",
    "metal": "Cornell + the reference app's Metal/Plastic presets (parity twin)",
    "gridvol": "Cornell + GridDensityMedium from density_render.70.volume",
}
PORTED_PRESETS = ("cornell", "cornell-mesh", "sphere", "envmap", "gmd")


def build_preset(name, width, height, device):
    from .scene import presets

    if name == "cornell":
        return presets.cornell_box(width, height, device=device)
    if name == "cornell-mesh":
        from .scene.loaders import make_test_mesh

        return presets.cornell_box(width, height, mesh=make_test_mesh(5),
                                   bvh=True, device=device)
    if name == "sphere":
        return presets.sphere_point_light(width, height, device=device)
    if name == "envmap":
        return presets.envmap_mesh(width, height, device=device)
    if name == "gmd":
        return presets.cornell_gmd(width, height, device=device)
    if name in PRESETS:
        raise SystemExit(
            f"preset {name!r} is not ported to PyTorch yet; ported presets: "
            f"{', '.join(PORTED_PRESETS)}")
    raise SystemExit(f"unknown preset {name}; try: {', '.join(PRESETS)}")


def get_integrator(name):
    from .models.integrators import direct, path, volpath, whitted

    return {"path": path, "whitted": whitted, "direct": direct,
            "volpath": volpath}[name]


def cmd_render(args):
    import torch

    from .models.integrators import path as path_mod
    from .ops import samplers
    from .utils.device import resolve_device
    from .utils.image import save_png

    integ = get_integrator(args.integrator)
    if args.live or args.view:
        raise SystemExit("the live viewers (--live, --view) are not ported "
                         "to PyTorch yet")
    try:
        device = resolve_device("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        raise SystemExit(str(e))

    scene, camera = build_preset(args.preset, args.width, args.height, device)
    cfg = path_mod.make_config(
        scene, args.width, args.height, spp=args.spp, max_depth=args.max_depth,
        spp_chunk=args.spp_chunk, rr_threshold=args.rr_threshold,
        fast_mis=args.fast_mis, use_pallas=device.type == "cuda",
    )
    if args.sampler == "halton":
        sampler = samplers.make_halton_sampler(args.spp, args.width,
                                               args.height, device=device)
    elif args.sampler == "sobol":
        sampler = samplers.make_sobol_sampler(args.spp, device=device)
    else:
        sampler = samplers.make_random_sampler(args.spp, seed=args.seed,
                                               device=device)

    hw = args.width * args.height
    acc = torch.zeros((hw, 3), dtype=torch.float32, device=device)
    start_spp = 0
    if args.resume and args.checkpoint:
        try:
            ck = np.load(args.checkpoint)
            acc = torch.from_numpy(ck["acc"]).to(device)
            start_spp = int(ck["spp"])
            print(f"resumed at {start_spp} spp from {args.checkpoint}")
        except FileNotFoundError:
            pass

    t_all = time.time()
    s = start_spp
    while s < args.spp:
        ns = min(args.spp_chunk, args.spp - s)
        t0 = time.time()
        acc = acc + integ.render_chunk(scene, camera, sampler, cfg, s, ns)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        s += ns
        print(json.dumps({
            "spp": s,
            "frame_time_s": round(dt, 3),
            "fps": round(1.0 / dt, 2),
            "Mpaths_per_s": round(ns * hw / dt / 1e6, 3),
        }), flush=True)
        if args.checkpoint and (s % max(args.spp_chunk * 4, 1) == 0 or s >= args.spp):
            np.savez(args.checkpoint, acc=acc.cpu().numpy(), spp=s)

    img = acc.cpu().numpy().reshape(args.height, args.width, 3) / max(s, 1)
    wall = time.time() - t_all
    print(json.dumps({"total_s": round(wall, 2), "spp": s,
                      "mean": float(img.mean()), "device": str(device)}))
    if args.out:
        save_png(args.out, img, tonemap=args.tonemap)
        print(f"wrote {args.out}")
    if args.out_npy:
        np.save(args.out_npy, img)
        print(f"wrote {args.out_npy}")


def cmd_presets(_args):
    for k, v in PRESETS.items():
        ported = "" if k in PORTED_PRESETS else "  [not ported yet]"
        print(f"{k:15s} {v}{ported}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="gnxraytracer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a preset scene")
    r.add_argument("--preset", default="cornell", choices=sorted(PRESETS))
    r.add_argument("--width", type=int, default=500)
    r.add_argument("--height", type=int, default=500)
    r.add_argument("--spp", type=int, default=32)
    r.add_argument("--spp-chunk", type=int, default=4)
    r.add_argument("--max-depth", type=int, default=5)
    r.add_argument("--rr-threshold", type=float, default=1.0)
    r.add_argument("--integrator", default="path",
                   choices=["path", "whitted", "direct", "volpath"])
    r.add_argument("--sampler", default="halton",
                   choices=["halton", "sobol", "random"])
    r.add_argument("--fast-mis", action="store_true",
                   help="folded-MIS estimator (2 scene casts/bounce)")
    r.add_argument("--live", default=None, metavar="PNG",
                   help="rewrite this PNG after every chunk (live viewer)")
    r.add_argument("--view", action="store_true",
                   help="draw a live ANSI preview in the terminal")
    r.add_argument("--view-cols", type=int, default=80)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--out", default=None)
    r.add_argument("--out-npy", default=None)
    r.add_argument("--tonemap", default="reference",
                   choices=["reference", "srgb", "none"])
    r.add_argument("--checkpoint", default=None)
    r.add_argument("--resume", action="store_true")
    r.add_argument("--cpu", action="store_true", help="run on the CPU")
    r.set_defaults(fn=cmd_render)

    q = sub.add_parser("presets", help="list scene presets")
    q.set_defaults(fn=cmd_presets)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
