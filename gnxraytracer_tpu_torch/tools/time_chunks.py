"""Wall time of one chunk of three main paths, through the copy of the port
found under --root; a development measurement on one NVIDIA GPU.

    python gnxraytracer_tpu_torch/tools/time_chunks.py [--root DIR]
        [--chunks N] [--label LABEL] [--paths NAME,...]

Run it as a file, not with -m, so that the package it times is the one
under --root (default: this checkout), for instance the parent commit's
tree unpacked with `git archive` into a git-ignored directory; two trees
are compared by running this script on each in turns (parent, change,
change, parent) in one call.  The chunks are chip_smoke.py's, at 500x500:
the Cornell fast-MIS path (Sobol', depth 8, 1M lanes, tail compaction,
use_pallas), Whitted on the Cornell box (Halton, depth 5, 2M lanes,
use_pallas) and Whitted on the Cornell box with a mirror mesh (20,480
triangles in a BVH, its walls kept out of it, 1M lanes); with --paths,
those whose names hold one of the given words, where "envmap" adds the
mesh main path (chip_smoke.mesh_setup: presets.envmap_mesh with a procedural HDR
environment, Sobol', depth 8, 1M lanes, pipelined casts and four compaction
stages).  Which BVH walk the casts take follows GNX_WIDE_BVH, so the two
walks are compared by running this script with GNX_WIDE_BVH=1 and =0 in
turns.  Each path runs a warm-up chunk, then N chunks, each timed on the
host's clock up to torch.cuda.synchronize(); prints one JSON line with the
times of each.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--label", default="")
    ap.add_argument("--paths", default="cornell,mirror",
                    help="comma-separated words: the paths whose names hold one")
    args = ap.parse_args(argv)
    words = [w for w in args.paths.split(",") if w]
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from gnxraytracer_tpu_torch.models.integrators import path, whitted
    from gnxraytracer_tpu_torch.ops import samplers
    from gnxraytracer_tpu_torch.scene import presets
    from gnxraytracer_tpu_torch.scene.loaders import make_test_mesh

    if not torch.cuda.is_available():
        print("time_chunks: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    w = h = 500
    cornell = presets.cornell_box(w, h, device=dev)
    mirror = presets.cornell_box(w, h, mesh=make_test_mesh(5), bvh=True,
                                 dragon_material=4, device=dev)
    paths = {
        "cornell fast-MIS (1M lanes)": (path, *cornell, path.make_config(
            cornell[0], w, h, spp=8, max_depth=8, spp_chunk=4,
            rr_threshold=1.0, fast_mis=True, compact_tail=True,
            use_pallas=True), samplers.make_sobol_sampler(8, device=dev)),
        "cornell whitted (2M lanes)": (whitted, *cornell, path.make_config(
            cornell[0], w, h, spp=16, max_depth=5, spp_chunk=8,
            use_pallas=True), samplers.make_halton_sampler(16, w, h,
                                                           device=dev)),
        "mirror mesh whitted (1M lanes)": (whitted, *mirror, path.make_config(
            mirror[0], w, h, spp=8, max_depth=5, spp_chunk=4),
            samplers.make_halton_sampler(8, w, h, device=dev)),
    }
    if "envmap" in words:
        import tempfile

        import chip_smoke

        with tempfile.TemporaryDirectory() as tmp:
            scene, cam, cfg, smp, _ = chip_smoke.mesh_setup(dev, tmp)
        paths["envmap mesh fast-MIS (1M lanes)"] = (path, scene, cam, cfg, smp)
    out = {"label": args.label, "root": args.root,
           "device": torch.cuda.get_device_name(0),
           "GNX_WIDE_BVH": os.environ.get("GNX_WIDE_BVH"), "chunk_ms": {}}
    for name, (mod, scene, cam, cfg, smp) in paths.items():
        if not any(w in name for w in words):
            continue
        n = cfg.spp_chunk
        mod.render_chunk(scene, cam, smp, cfg, 0, n)
        torch.cuda.synchronize()
        times = []
        for k in range(args.chunks):
            t0 = time.time()
            mod.render_chunk(scene, cam, smp, cfg, n * (k % 2), n)
            torch.cuda.synchronize()
            times.append((time.time() - t0) * 1e3)
        out["chunk_ms"][name] = times
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
