#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gnxraytracer_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

needs one CUDA device, nvcc, and no arguments (``--profile`` adds a
torch.profiler breakdown of one chunk of the main path).  It imports nothing of JAX and
nothing of the JAX package.  Phases, each of which fails the run (exit code
other than 0, no result line) when it fails; nothing falls back to the CPU or
to a plain version:

  1. device   CUDA present; name and power limit from nvidia-smi
  2. build    nvcc builds csrc/*.cu (all sources started together) into the
              package's build directory
  3. kernels  each kernel's wrapper against its plain PyTorch version on the
              card, at the shapes the main path gives it, plus a
              1,000-triangle soup and the shared-edge ray set; its time, the
              plain version's time and the card's bound for the same work
  4. main     path.render of the Cornell box at 500x500, depth 8, Sobol',
              spp_chunk=4 (1M lanes a chunk), fast_mis + compact_tail +
              use_pallas, 16 spp, and the CLI's render command; launch
              counts are set to 0 just before and read just after
  5. golden   64x64, 64 spp on the card against the reference renderer's
              image tests/golden/ref_path_cornell.npz

Every phase prints one JSON object on a line of its own.  The line before
the last is the {"kernels": [...]} record, the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet), for the bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# f32 operations of one watertight ray-triangle test (csrc/closest_hit.cu)
OPS_PER_PAIR = 150

WIDTH = HEIGHT = 500
MAX_DEPTH = 8
SPP_CHUNK = 4
SPP = 16

T_RTOL = 1e-5   # t: kernel vs plain version
B_ATOL = 1e-5   # barycentrics: kernel vs plain version


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_name_and_power_limit():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    lines = [l.strip() for l in out.splitlines() if l.strip()]
    check(lines, "nvidia-smi reported no GPU")
    return lines[0]


def time_cuda(fn, reps, flush=None):
    """Median milliseconds of fn() over reps launches, each between its own
    pair of CUDA events; `flush` (a large tensor) is overwritten before each
    so the launch finds the L2 cache cold, as it does on the main path."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 3: the closest-hit kernel against its plain version
# ---------------------------------------------------------------------------

def main_path_rays(dev):
    """1M rays of the kind the main path casts at the Cornell box: 500k
    camera rays (2 spp) and the 500k cosine-fanned bounce rays that leave
    the walls they hit.  Camera rays that escape give dead lanes."""
    from gnxraytracer_tpu_torch.constants import INFINITY
    from gnxraytracer_tpu_torch.models import bxdf
    from gnxraytracer_tpu_torch.models.integrators import path
    from gnxraytracer_tpu_torch.ops import samplers, trace
    from gnxraytracer_tpu_torch.scene import camera, presets

    scene, cam = presets.cornell_box(WIDTH, HEIGHT, device=dev)
    cfg = path.make_config(scene, WIDTH, HEIGHT, spp=2, use_pallas=False)
    smp = samplers.make_sobol_sampler(2, device=dev)
    hw = WIDTH * HEIGHT
    pixel = torch.arange(hw, dtype=torch.int32, device=dev).repeat(2)
    sample = torch.repeat_interleave(
        torch.arange(2, dtype=torch.int32, device=dev), hw)
    p_film, t_u, p_lens = samplers.camera_sample(smp, pixel, sample, WIDTH)
    o, d, _ = camera.generate_rays(cam, p_film, t_u, p_lens)
    t_inf = torch.full((2 * hw,), INFINITY, dtype=torch.float32, device=dev)
    hit = trace.scene_intersect(scene, cfg, o, d, t_inf)  # plain version
    it = trace.make_interaction(scene, cfg, o, d, hit)
    ub = samplers.sample_bounce_dims(smp, pixel, sample, 5, 8, 13)
    wi = bxdf.diffuse_sample_wi(trace.to_local(it, it.wo), ub[:, 5:7])
    o2, d2 = trace.spawn_ray(it, trace.to_world(it, wi))
    o2 = torch.where(hit.hit[:, None], o2, o)
    d2 = torch.where(hit.hit[:, None], d2, d)
    rays_o = torch.cat([o, o2]).contiguous()
    rays_d = torch.cat([d, d2]).contiguous()
    alive = torch.cat([torch.ones_like(hit.hit), hit.hit])
    return scene, rays_o, rays_d, alive


def soup(n_tris, n_rays, dev, seed=0):
    rs = np.random.RandomState(seed)
    tris = (rs.randn(n_tris, 1, 3) * 3
            + rs.randn(n_tris, 3, 3) * 1.5).astype(np.float32)
    o = (rs.randn(n_rays, 3) * 4).astype(np.float32)
    d = rs.randn(n_rays, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n_rays, 1e30, np.float32)
    t_max[1::4] = rs.rand(len(t_max[1::4])).astype(np.float32) * 8
    t_max[2::8] = 0.0
    put = lambda a: torch.from_numpy(a).to(dev)
    return put(tris.reshape(n_tris, 9)), put(o), put(d), put(t_max)


def shared_edge(dev, n=500):
    """Rays aimed exactly at the shared diagonal of a two-triangle quad."""
    soa = np.asarray([[0, 0, 0, 1, 0, 0, 0, 1, 0],
                      [1, 0, 0, 1, 1, 0, 0, 1, 0]], np.float32)
    s = np.random.RandomState(1).rand(n).astype(np.float32)
    targets = np.stack([s, 1 - s, np.zeros_like(s)], -1)
    o = np.broadcast_to(np.asarray([0.3, 0.3, 5.0], np.float32), (n, 3)).copy()
    d = targets - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    put = lambda a: torch.from_numpy(a).to(dev)
    return put(soa), put(o), put(d), put(np.full(n, 1e30, np.float32))


def compare_hits(name, got, ref, t_max):
    """Kernel against plain version: hit and tri identical, t and b within
    the stated tolerances, dead lanes inert.  Returns max |error|."""
    check(torch.equal(got.hit, ref.hit),
          f"{name}: hit differs on {int((got.hit != ref.hit).sum())} lanes")
    check(torch.equal(got.tri, ref.tri),
          f"{name}: tri differs on {int((got.tri != ref.tri).sum())} lanes")
    h = ref.hit
    check(int(h.sum()) > 0, f"{name}: no ray hits anything")
    t_err = (got.t[h] - ref.t[h]).abs()
    check(bool((t_err <= T_RTOL * ref.t[h].abs()).all()),
          f"{name}: t differs by up to {float(t_err.max())}")
    check(torch.equal(got.t[~h], ref.t[~h]), f"{name}: t of a miss differs")
    b_err = (got.b - ref.b).abs()
    check(float(b_err.max()) <= B_ATOL,
          f"{name}: b differs by up to {float(b_err.max())}")
    dead = t_max <= 0
    check(not bool(got.hit[dead].any()), f"{name}: a dead lane hit")
    check(bool((got.tri[~got.hit] == 0).all() and (got.b[~got.hit] == 0).all()),
          f"{name}: a miss does not carry tri = 0, b = 0")
    return max(float(t_err.max()), float(b_err.max()))


def phase_kernels(dev):
    from gnxraytracer_tpu_torch.constants import INFINITY
    from gnxraytracer_tpu_torch.kernels import closest_hit as ch

    scene, o, d, alive = main_path_rays(dev)
    soa = ch.tri_soa_from_mesh(scene.geom.vertices, scene.geom.triangles)
    n, n_tri = o.shape[0], soa.shape[0]
    check(n == 2 * WIDTH * HEIGHT * 2 and n_tri == 12, "unexpected shapes")

    # correctness at the main path's shape: alive lanes unbounded, dead lanes
    # t_max = 0 (as the bounce loop casts them), some lanes cut short
    t_max = torch.where(alive, INFINITY, 0.0).to(torch.float32)
    t_max[5::16] = 2.5
    t_max = t_max.contiguous()
    launches0 = ch.launch_count
    got = ch.closest_hit(o, d, t_max, soa)
    torch.cuda.synchronize()
    check(ch.launch_count == launches0 + 1, "the wrapper did not count its launch")
    ref = ch.closest_hit_reference(o, d, t_max, soa)
    err = compare_hits("cornell 1M", got, ref, t_max)
    cases = [dict(case="cornell", n_rays=n, n_tris=n_tri, max_abs_err=err,
                  hit_fraction=float(ref.hit.float().mean()))]

    # a ragged ray count and more than one shared-memory tile of triangles
    s_soa, s_o, s_d, s_t = soup(1000, 200_003, dev)
    s_got = ch.closest_hit(s_o, s_d, s_t, s_soa)
    s_ref = ch.closest_hit_reference(s_o, s_d, s_t, s_soa)
    cases.append(dict(case="soup", n_rays=s_o.shape[0], n_tris=1000,
                      max_abs_err=compare_hits("soup", s_got, s_ref, s_t),
                      hit_fraction=float(s_ref.hit.float().mean())))
    b_soa, b_o, b_d, b_t = soup(2500, 10_000, dev, seed=2)  # 3 tiles
    cases.append(dict(case="soup-3-tiles", n_rays=10_000, n_tris=2500,
                      max_abs_err=compare_hits(
                          "soup-3-tiles", ch.closest_hit(b_o, b_d, b_t, b_soa),
                          ch.closest_hit_reference(b_o, b_d, b_t, b_soa), b_t)))
    e_soa, e_o, e_d, e_t = shared_edge(dev)
    e_got = ch.closest_hit(e_o, e_d, e_t, e_soa)
    check(bool(e_got.hit.all()),
          f"{int((~e_got.hit).sum())} rays leaked through the shared edge")
    cases.append(dict(case="shared-edge", n_rays=500, n_tris=2,
                      max_abs_err=compare_hits(
                          "shared-edge", e_got,
                          ch.closest_hit_reference(e_o, e_d, e_t, e_soa), e_t)))
    emit({"phase": "kernel_vs_plain", "tolerance": {
        "hit": "identical", "tri": "identical", "t_rtol": T_RTOL,
        "b_atol": B_ATOL}, "cases": cases})

    # times at the main path's shape (bounces 0-4: 1M lanes x 12 triangles),
    # every lane alive, cold L2
    t_all = torch.full((n,), INFINITY, dtype=torch.float32, device=dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = time_cuda(lambda: ch.closest_hit(o, d, t_all, soa), 30, flush)
    plain_ms = time_cuda(lambda: ch.closest_hit_reference(o, d, t_all, soa),
                         3, flush)
    # the tail of the bounce loop casts at 1/8 width
    m = n // 8
    ms_tail = time_cuda(lambda: ch.closest_hit(o[:m], d[:m], t_all[:m], soa),
                        30, flush)
    n_active = int((t_all > 0).sum())
    bytes_moved = n * (28 + 21) + 36 * n_tri
    ops = n_active * n_tri * OPS_PER_PAIR
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOP_PER_S * 1e3
    return ch, dict(
        name="closest_hit", route="cuda",
        source="gnxraytracer_tpu_torch/csrc/closest_hit.cu",
        replaces="gnxraytracer_tpu/ops/pallas_intersect.py:33",
        launches=None, max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None,  # no single PyTorch call computes this function
        shape={"n_rays": n, "n_tris": n_tri}, bytes_ms=bytes_ms, ops_ms=ops_ms,
        ms_tail_125k_rays=ms_tail)


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path and the golden image
# ---------------------------------------------------------------------------

def main_path_setup(dev):
    """Scene, camera, configuration and sampler of the main path: the Cornell
    box at 500x500, depth 8, Sobol', 1M lanes a chunk, tail compaction, the
    closest-hit cast through the kernel."""
    from gnxraytracer_tpu_torch.models.integrators import path
    from gnxraytracer_tpu_torch.ops import samplers
    from gnxraytracer_tpu_torch.scene import presets

    scene, cam = presets.cornell_box(WIDTH, HEIGHT, device=dev)
    cfg = path.make_config(
        scene, WIDTH, HEIGHT, spp=SPP, max_depth=MAX_DEPTH,
        spp_chunk=SPP_CHUNK, rr_threshold=1.0, fast_mis=True,
        compact_tail=True, count_rays=True, use_pallas=True)
    return scene, cam, cfg, samplers.make_sobol_sampler(SPP, device=dev)


def phase_main_path(dev, ch):
    from gnxraytracer_tpu_torch import cli
    from gnxraytracer_tpu_torch.models.integrators import path

    scene, cam, cfg, smp = main_path_setup(dev)
    lanes = WIDTH * HEIGHT * SPP_CHUNK

    # warm-up chunk (also gives the useful casts per path)
    _, n_rays = path.render_chunk(scene, cam, smp, cfg, 0, SPP_CHUNK)
    torch.cuda.synchronize()
    rays_per_path = float(n_rays) / lanes

    ch.reset_launch_count()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    img = path.render(scene, cam, smp, cfg)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ch.launch_count
    chunks = SPP // SPP_CHUNK
    casts = chunks * (MAX_DEPTH + 1)  # one closest-hit cast per bounce
    check(launches == casts,
          f"kernel launches {launches} != closest-hit casts {casts}")
    check(tuple(img.shape) == (HEIGHT, WIDTH, 3), f"image shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "the image is not finite")
    mean = float(img.mean())
    check(0.05 < mean < 5.0, f"image mean {mean}: black or blown out")
    emit({"phase": "main_path", "entry": "path.render", "width": WIDTH,
          "height": HEIGHT, "max_depth": MAX_DEPTH, "spp": SPP,
          "lanes_per_chunk": lanes, "chunks": chunks,
          "kernel_launches": launches, "closest_hit_casts": casts,
          "rays_per_path": rays_per_path, "ms_per_chunk": wall / chunks * 1e3,
          "Mpaths_per_s": WIDTH * HEIGHT * SPP / wall / 1e6,
          "image_mean": mean,
          "peak_device_MiB": torch.cuda.max_memory_allocated() / 2 ** 20})

    # the CLI a user would call (its defaults: 500x500, depth 5); on a CUDA
    # device it turns the kernel on itself
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli.npy")
        cli.main(["render", "--preset", "cornell", "--sampler", "sobol",
                  "--fast-mis", "--spp", "4", "--out-npy", out])
        cli_img = np.load(out)
    cli_launches = ch.launch_count - launches
    check(cli_launches == 6, f"CLI: {cli_launches} kernel launches, expected 6")
    check(cli_img.shape == (HEIGHT, WIDTH, 3) and np.isfinite(cli_img).all()
          and cli_img.mean() > 0.05, "CLI: bad image")
    emit({"phase": "main_path", "entry": "cli render",
          "kernel_launches": cli_launches, "image_mean": float(cli_img.mean())})
    return ch.launch_count


def phase_profile(dev):
    """Where one 1M-lane chunk of the main path spends its time: device-busy
    share and the top kernels by device time (torch.profiler), and the plain
    any-hit shadow cast timed alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from gnxraytracer_tpu_torch.constants import INFINITY
    from gnxraytracer_tpu_torch.models.integrators import path
    from gnxraytracer_tpu_torch.ops import samplers, trace

    scene, cam, cfg, smp = main_path_setup(dev)
    path.render_chunk(scene, cam, smp, cfg, 0, SPP_CHUNK)
    torch.cuda.synchronize()
    t0 = time.time()
    path.render_chunk(scene, cam, smp, cfg, 4, SPP_CHUNK)
    torch.cuda.synchronize()
    wall_plain = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        path.render_chunk(scene, cam, smp, cfg, 8, SPP_CHUNK)
        torch.cuda.synchronize()
        wall_prof = (time.time() - t0) * 1e3
    # kernel-level events only: an operator's row repeats the device time of
    # the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    _, o, d, alive = main_path_rays(dev)
    t_all = torch.full((o.shape[0],), INFINITY, dtype=torch.float32, device=dev)
    any_ms = time_cuda(lambda: trace.scene_occluded(scene, cfg, o, d, t_all), 3)

    class OpCount(TorchDispatchMode):
        """Counts the operators PyTorch dispatches (views included)."""
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with OpCount() as chunk_ops:
        path.render_chunk(scene, cam, smp, cfg, 12, SPP_CHUNK)
    with OpCount() as shadow_ops:
        trace.scene_occluded(scene, cfg, o, d, t_all)
    with OpCount() as dims_ops:
        samplers.sample_bounce_dims(smp, torch.zeros_like(alive, dtype=torch.int32),
                                    torch.zeros_like(alive, dtype=torch.int32),
                                    5, 8, 85)
    torch.cuda.synchronize()
    emit({"phase": "profile", "chunk_wall_ms": wall_plain,
          "chunk_wall_ms_profiled": wall_prof,
          "device_busy_ms": busy if rows else "not measured",
          # against the unprofiled wall time: the profiler slows the host
          "device_idle_share": (1.0 - busy / wall_plain) if rows else "not measured",
          "kernel_launches_in_chunk": sum(r[2] for r in rows),
          "top_kernels": [{"name": k[:80], "ms": ms, "count": c}
                          for k, ms, c in rows[:12]],
          "plain_any_hit_1M_rays_ms": any_ms,
          "dispatched_ops": {"chunk": chunk_ops.n,
                             "one_shadow_cast": shadow_ops.n,
                             "one_bounce_sampler_dims": dims_ops.n}})


def phase_golden(dev):
    from gnxraytracer_tpu_torch.models.integrators import path
    from gnxraytracer_tpu_torch.ops import samplers
    from gnxraytracer_tpu_torch.scene import presets

    z = np.load(os.path.join(HERE, "tests", "golden", "ref_path_cornell.npz"))
    ref, meta = z["image"], json.loads(str(z["meta"]))
    w, h, spp = meta["w"], meta["h"], 64
    scene, cam = presets.cornell_box(w, h, sigma=meta["sigma"],
                                     skybox=bool(meta["skybox"]), device=dev)
    cfg = path.make_config(scene, w, h, spp=spp, max_depth=meta["max_depth"],
                           spp_chunk=32, fast_mis=True, compact_tail=True,
                           compact_from=5, compact_frac=2, use_pallas=True)
    ours = path.render(scene, cam, samplers.make_sobol_sampler(spp, device=dev),
                       cfg).cpu().numpy()
    check(np.isfinite(ours).all(), "golden: the image is not finite")

    def block_mean(img, b=8):
        hh, ww, c = img.shape
        return img.reshape(hh // b, b, ww // b, b, c).mean((1, 3))

    berr = float(np.abs(block_mean(ours) - block_mean(ref)).mean() / ref.mean())
    merr = float(abs(ours.mean() - ref.mean()) / ref.mean())
    emit({"phase": "golden", "reference": "tests/golden/ref_path_cornell.npz",
          "block8_rel_err": berr, "limit": 0.025, "mean_rel_err": merr,
          "mean_limit": 0.02})
    check(berr < 0.025, f"golden: block8 error {berr}")
    check(merr < 0.02, f"golden: mean error {merr}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from gnxraytracer_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the package gnxraytracer_tpu_torch is not beside "
              f"this script: {e}", file=sys.stderr)
        return 3
    t_start = time.time()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # camera transforms in f32

    try:
        smi = gpu_name_and_power_limit()
        emit({"phase": "device", "torch": torch.__version__,
              "cuda": torch.version.cuda, "nvidia_smi": smi})

        names = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR)
                       if f.endswith(".cu"))
        handles = [build.start_build(n) for n in names]  # all nvcc at once
        for hd in handles:
            build.finish_build(hd)
        emit({"phase": "build", "nvcc": build.find_nvcc(),
              "flags": " ".join(build.NVCC_FLAGS),
              "sources": {n: {"seconds": build.build_log[n]["seconds"],
                              "cached": build.build_log[n]["cached"],
                              "ptxas": build.build_log[n]["ptxas"].strip()}
                          for n in names}})

        ch, record = phase_kernels(dev)
        record["launches"] = phase_main_path(dev, ch)
        check(record["launches"] > 0, "the main path never launched the kernel")
        if "--profile" in sys.argv[1:]:
            phase_profile(dev)
        phase_golden(dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    emit({"phase": "done", "seconds": time.time() - t_start})
    print(smi, flush=True)
    emit({"kernels": [record]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
