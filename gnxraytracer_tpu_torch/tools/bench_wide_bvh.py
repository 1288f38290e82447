"""Times the width-8 BVH kernels of csrc/wide_bvh.cu against another version
of that source, on the mesh main path's ray sets; a development measurement
on one NVIDIA GPU.

    python -m gnxraytracer_tpu_torch.tools.bench_wide_bvh [--old DIR]
        [--reps R] [--out FILE]

Run from the repository's root (it takes its scene, ray sets and timers from
chip_smoke.py).  It builds, all nvcc at once and with `-Xptxas -v`:
  * "new": the package's csrc/wide_bvh.cu as it stands,
  * "old": DIR/wide_bvh.cu, another version of the source (for instance the
    parent commit's, unpacked with `git archive`); its entry points may take
    the one-pass design's arguments (no stack size, counter or list),
  * "io": a kernel that only reads each ray and writes a miss record, the
    floor of the ladder below.
On presets.envmap_mesh (500x500, the 104,882-triangle blob) and its 1M-ray
sets (camera, bounce, shadow, rays entering the tree cast closest-hit and
any-hit, and "sparse": the bounce rays with one lane in 32 alive), "old"
must give every lane the same result as "new".  Then each set is timed in
turns (new, old, old, new), each with torch.profiler's device time of the
cast's kernels and with CUDA events around the launch, L2 flushed before
each launch, R launches a turn; and the floor ladder on the bounce and the
entering rays: "io" (ray in, miss out), "root" (the same kernels on a copy
of the tree whose root has no children: the ray, the frame test, the root
and nothing more) and the whole walk.  Prints one JSON object a line; --out
also writes them to FILE.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..kernels import build
from ..kernels import wide_bvh as wb

# the kernels of one wide cast (the triage pass, where the build has one,
# and the walk)
WIDE = ("wide_triage_kernel", "wide_bvh_kernel")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

IO_SOURCE = r"""
#include <cfloat>
#include <cstdint>
extern "C" __global__ void io_kernel(const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ t_max,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ b_out, uint8_t* __restrict__ flag_out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float s = ((o[3 * i] + o[3 * i + 1]) + (o[3 * i + 2] + d[3 * i]))
                  + ((d[3 * i + 1] + d[3 * i + 2]) + t_max[i]);
  t_out[i] = FLT_MAX;
  tri_out[i] = 0;
  b_out[3 * i] = 1.f; b_out[3 * i + 1] = 0.f; b_out[3 * i + 2] = 0.f;
  flag_out[i] = (s == 12345.f) ? 1 : 0;  // keeps the reads
}
extern "C" int gnx_io(const float* o, const float* d, const float* t_max,
                      float* t_out, int* tri_out, float* b_out,
                      uint8_t* flag_out, long long n, void* stream) {
  io_kernel<<<(unsigned)((n + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
      o, d, t_max, t_out, tri_out, b_out, flag_out, n);
  return (int)cudaGetLastError();
}
"""


def start(label, src, out_dir):
    out = os.path.join(out_dir, f"libbench_wide_{label}.so")
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
           src]
    return label, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)


def finish(handle):
    label, out, proc = handle
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {label}:\n{log}")
    return ctypes.CDLL(out), log


def wide_caster(lib, new_args):
    """cast(pack, o, d, t, any_hit) through lib's two entry points, with the
    two-pass design's arguments (stack size, counter, scratch list) or the
    one-pass design's."""
    p = ctypes.c_void_p
    tail = ([ctypes.c_longlong, ctypes.c_int, p, p, p] if new_args
            else [ctypes.c_longlong, p])
    fc, fa = lib.gnx_wide_closest_hit, lib.gnx_wide_any_hit
    fc.argtypes, fa.argtypes = [p] * 11 + tail, [p] * 8 + tail
    fc.restype = fa.restype = ctypes.c_int

    def cast(pack, o, d, t, any_hit):
        n, dev = o.shape[0], o.device
        extra, keep = [], None
        if new_args:
            keep, extra = wb._walk_state(pack, n, lib.gnx_wide_stack_cap(), dev)
        head = [pack.rec.data_ptr(), pack.frame.data_ptr(),
                pack.leafs.data_ptr(), pack.tid.data_ptr(), o.data_ptr(),
                d.data_ptr(), t.data_ptr()]
        stream = torch.cuda.current_stream(dev).cuda_stream
        if any_hit:
            out = torch.empty((n,), dtype=torch.bool, device=dev)
            err = fa(*head, out.data_ptr(), n, *extra, stream)
        else:
            out = wb._empty_trihit(n, dev)
            err = fc(*head, out.t.data_ptr(), out.tri.data_ptr(),
                     out.b.data_ptr(), out.hit.data_ptr(), n, *extra, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out
    return cast


def io_caster(lib):
    p = ctypes.c_void_p
    lib.gnx_io.argtypes = [p] * 7 + [ctypes.c_longlong, p]
    lib.gnx_io.restype = ctypes.c_int

    def cast(pack, o, d, t, any_hit):
        out = wb._empty_trihit(o.shape[0], o.device)
        err = lib.gnx_io(o.data_ptr(), d.data_ptr(), t.data_ptr(),
                         out.t.data_ptr(), out.tri.data_ptr(), out.b.data_ptr(),
                         out.hit.data_ptr(), o.shape[0],
                         torch.cuda.current_stream(o.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out
    return cast


def same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="directory of another wide_bvh.cu")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    lines = []

    def emit(obj):
        cs.emit(obj)
        lines.append(obj)

    if not torch.cuda.is_available():
        print("bench_wide_bvh: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    emit({"device": cs.gpu_name_and_power_limit(), "torch": torch.__version__})
    builds = [("new", os.path.join(build.CSRC_DIR, "wide_bvh.cu"))]
    if args.old:
        builds.append(("old", os.path.join(args.old, "wide_bvh.cu")))
    out_dir = os.path.join(build.BUILD_DIR, "bench_wide_bvh")
    os.makedirs(out_dir, exist_ok=True)
    io_src = os.path.join(out_dir, "io.cu")
    with open(io_src, "w") as f:
        f.write(IO_SOURCE)
    t0 = time.time()
    handles = [start(l, s, out_dir) for l, s in builds]
    handles.append(start("io", io_src, out_dir))
    casters, ptxas, libs = {}, {}, {}
    for (label, src), h in zip(builds + [("io", io_src)], handles):
        lib, log = finish(h)
        libs[label] = lib
        ptxas[label] = cs.ptxas_summary(log)
        if label == "io":
            casters[label] = io_caster(lib)
        else:
            with open(src) as f:
                casters[label] = wide_caster(lib, "gnx_wide_blocks" in f.read())
    emit({"phase": "build", "seconds": time.time() - t0,
          "builds": {l: os.path.relpath(s, ROOT) for l, s in builds},
          "ptxas": ptxas})
    labels = [b[0] for b in builds]

    with tempfile.TemporaryDirectory() as tmp:
        scene, cam, cfg, _smp, _ = cs.mesh_setup(dev, tmp)
        rays = cs.mesh_rays(dev, scene, cam, cfg)
    # and a sparse cast, as the deeper bounces make: 1 lane in 32 alive
    o, d, t = rays["bounce"]
    rays["sparse"] = (o, d, torch.where(
        torch.arange(t.shape[0], device=dev) % 32 == 0, t, 0.0).contiguous())
    pack = scene.bvh.wide
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    n = rays["camera"][0].shape[0]
    grid = {}
    for label in labels:
        if hasattr(libs[label], "gnx_wide_blocks"):
            f = libs[label].gnx_wide_blocks
            f.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
            f.restype = ctypes.c_longlong
            grid[label] = [f(a, n, pack.stack_size) for a in (0, 1)]
    emit({"phase": "launch", "n_rays": n, "stack_size": pack.stack_size,
          "blocks_closest_any": grid})
    rec_root = pack.rec.clone()
    rec_root[0, wb.TARGET_WORD0:wb.TARGET_WORD0 + wb.WIDTH] = 0
    root_only = pack._replace(rec=rec_root)

    for name, (o, d, t) in rays.items():
        any_hit = name in cs.ANY_HIT_SETS
        first = casters[labels[0]](pack, o, d, t, any_hit)
        torch.cuda.synchronize()
        for label in labels[1:]:
            if not same(casters[label](pack, o, d, t, any_hit), first):
                raise SystemExit(f"{name}: {label} differs from {labels[0]}")
        turns = labels + labels[::-1]
        dev_ms = {l: [] for l in labels}
        ev_ms = {l: [] for l in labels}
        for label in turns:
            fn = lambda: casters[label](pack, o, d, t, any_hit)
            dev_ms[label].append(cs.device_ms(fn, args.reps, flush,
                                              names=WIDE))
            ev_ms[label].append(cs.time_cuda(fn, args.reps, flush))
        perm, _ = wb.ray_sort_perm(o, d, *wb._root_box(pack), t_max=t,
                                   key_mode=cfg.sort_key)
        so, sd, st = o[perm].contiguous(), d[perm].contiguous(), t[perm].contiguous()
        sorted_ms = {l: cs.device_ms(
            lambda: casters[l](pack, so, sd, st, any_hit), args.reps, flush,
            names=WIDE) for l in labels}
        sort_ms = cs.time_cuda(
            lambda: wb.ray_sort_perm(o, d, *wb._root_box(pack), t_max=t,
                                     key_mode=cfg.sort_key), args.reps, flush)
        emit({"phase": "times", "rays": name, "any_hit": any_hit,
              "n_rays": o.shape[0], "bit_equal_to": labels[0],
              "alive_fraction": float((t > 0).float().mean()),
              "device_ms": dev_ms, "event_ms": ev_ms,
              "device_ms_median": {l: float(np.median(v)) for l, v in dev_ms.items()},
              "sorted_rays_device_ms": sorted_ms, "sort_perm_ms": sort_ms})

    for name in ("bounce", "entering", "entering_any"):
        o, d, t = rays[name]
        any_hit = name in cs.ANY_HIT_SETS
        ladder = {}
        if not any_hit:
            ladder["io"] = cs.device_ms(
                lambda: casters["io"](pack, o, d, t, False), args.reps, flush,
                names=("io_kernel",))
        for label in labels:
            ladder[f"root:{label}"] = cs.device_ms(
                lambda: casters[label](root_only, o, d, t, any_hit), args.reps,
                flush, names=WIDE)
            ladder[f"walk:{label}"] = cs.device_ms(
                lambda: casters[label](pack, o, d, t, any_hit), args.reps,
                flush, names=WIDE)
        emit({"phase": "ladder", "rays": name, "device_ms": ladder})
    if args.out:
        with open(args.out, "w") as f:
            for obj in lines:
                f.write(json.dumps(obj) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
