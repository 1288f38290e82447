#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gnxraytracer_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

needs one CUDA device, nvcc, g++ and no arguments (``--profile`` adds a
torch.profiler breakdown of one chunk of each main path).  It imports nothing
of JAX and nothing of the JAX package.  Phases, each of which fails the run
(exit code other than 0, no result line) when it fails; nothing falls back to
the CPU or to a plain version:

  1. device   CUDA present; name and power limit from nvidia-smi
  2. build    nvcc builds csrc/*.cu (all sources started together) and g++
              the native BVH builder into the package's build directory;
              each entry's registers, stack frame and spills from ptxas
  3. kernels  each kernel's wrapper against its plain PyTorch version on the
              card, at the shapes its main path gives it, plus ragged counts,
              dead lanes, t_max cut short and the shared-edge ray set; its
              time (kernel ms: torch.profiler device time; wrapper ms: CUDA
              events around the call), the plain version's time and the
              card's bound for the same work (3a brute force, closest hit
              and the any hit on the Cornell path's shadow rays, 3b the width-8
              BVH walks on the mesh path's camera, bounce and shadow rays
              and on 1M rays that enter the blob's tree, closest and any
              hit, 3c the binary threaded BVH walks on the same rays, with a
              tree without octant links, the two-phase cast and rays through
              edges shared by two leaves; the binary wrappers do not sort)
  4. cornell  path.render of the Cornell box at 500x500, depth 8, Sobol',
              spp_chunk=4 (1M lanes a chunk), fast_mis + compact_tail +
              use_pallas, 8 spp, and the CLI's render command
  5. mesh     path.render of presets.envmap_mesh (104,882-triangle blob,
              Disney, EWA-textured floor, HDR environment light from a
              procedural .hdr file) at 500x500, depth 8, 1M lanes a chunk,
              pipeline_casts with the bench's four compaction stages, 8 spp;
              the same chunk with the coherence sort on; the CLI's
              ``--preset envmap``; a 64x64 render with the kernels against
              the same render with the plain walk
  6. golden   64x64, 64 spp Cornell on the card against the reference
              renderer's image tests/golden/ref_path_cornell.npz
  7. binary   one chunk of the mesh path of phase 5 with GNX_WIDE_BVH=0: every
              BVH cast through the binary threaded-BVH kernels, none through
              the wide ones, no coherence sort; the image against phase 5's
  8. whitted  the Whitted, direct-lighting and faithful path integrators with
              the Halton sampler at 500x500: whitted.render of the Cornell box
              (depth 5, 2M lanes a chunk), the CLI's ``--preset cornell-mesh
              --integrator whitted`` with its default flags through either
              walk, the same scene with a mirror mesh (reflected rays inside
              the 20,480-triangle tree) through whitted.render and
              path.render(fast_mis=False), binary and wide, with the isolated
              casts of its depth-1 rays, its depth-0 shadow rays and an
              incoherent ray set through both pairs of kernels, each against
              its plain walk; the same scene's camera, bounce and shadow rays
              through both pairs on ONE tree over all its triangles, walls
              and light included (every camera ray hits in it); and
              direct.render with both strategies
  9. goldens  32 spp Halton through whitted, direct and the faithful path
              against the reference renderer's three Cornell goldens
 10. gradients the train step (parallel/sharding.make_train_step) at full
              width: the Cornell box (Halton, depth 8, 1M lanes, the
              brute-force kernels) and the mesh scene of phase 5 (Sobol',
              depth 8, 1M lanes, every parameter class, the wide-BVH
              kernels, pixel passes from the default memory budget), with
              forward / backward / step ms, peak memory, passes and launches;
              one pass against four (64x64); AD against central FD through
              the kernels; the reference renderer's gradient goldens
              ref_grad_{kd,le,sigma} and ref_grad_disney_rough; an
              optimisation that must cut the loss by 30% in 3 steps
 11. volpath  volpath.render of presets.cornell_homogeneous (a homogeneous
              medium in a null-material box) at 500x500, depth 8, Halton,
              1M lanes a chunk, through kernel 1; the reference renderer's
              ref_volpath_hom image and ref_grad_med_sigma gradient; a
              train step with volpath's estimator that moves the medium
              classes

Launch counts are set to 0 just before each main path is driven and read
just after; so are the calls of the brute-force casts' plain versions, which
must stay 0 on the card.  Every phase prints one JSON object on a line of its own.  The
line before the last is the {"kernels": [...]} record, the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import functools
import inspect
import io
import json
import os
import re
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
# f32 operations of one watertight ray-triangle test (csrc/watertight.cuh)
OPS_PER_PAIR = 150
# f32 operations of one quantized child-box test (csrc/wide_bvh.cu): 6
# dequantizations (convert, multiply, add), 6 subtract-multiplies, 10 min/max,
# the widening and 4 compares
OPS_PER_SLAB = 45
# f32 operations of one binary node visit (csrc/packet_bvh.cu): 6
# subtract-multiplies, 10 min/max, the widening and 4 compares
OPS_PER_NODE = 25
# bytes a binary walk loads per visited node (32-byte box row + 8-byte link
# pair) and per tested leaf row (144 bytes of vertices + 16 of ids).  These
# loads are served by the L2 cache and are no part of a kernel's bound: they
# are reported beside it as `table_load_bytes`
BYTES_PER_NODE = 40
BYTES_PER_LEAF_ROW = 160

WIDTH = HEIGHT = 500
MAX_DEPTH = 8
SPP_CHUNK = 4
SPP = 8
MESH_STAGES = ((0, 2), (1, 16), (2, 32), (4, 64))
PLAIN_SUBSAMPLE = 100_000  # rays the plain walk takes of a 1M-ray set
SORT_ROUNDS = 1  # rounds of (off, on, on, off) chunks in phase 5

MIRROR_ID = 4  # the mirror of presets.reference_materials

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


# the names of the hand-written kernels in torch.profiler's CUDA events
KERNEL_NAMES = ("closest_hit_kernel", "brute_any_hit_kernel",
                "wide_triage_kernel", "wide_bvh_kernel",
                "packet_triage_kernel", "packet_walk_kernel")


def device_ms(fn, reps, flush=None, names=KERNEL_NAMES):
    """Device milliseconds of the hand-written kernels one call of fn()
    launches (each of them once a call), from torch.profiler's CUDA kernel
    events over reps calls (`flush` overwritten before each, as in
    time_cuda); None when the profiler saw no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and any(k in e.key for k in names) and e.count > 0]
    # each kernel's mean over the launches the profiler kept (it may drop
    # some), summed over the kernels a call launches
    return sum(t / c for t, c in rows) / 1e3 if rows else None


def ptxas_summary(log):
    """Registers, stack frame and spill bytes of each entry function in an
    `nvcc -Xptxas -v` log: {kernel: {...}}, the kernel named by its
    mangled name's base and, for a template, <false> or <true>."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"\d+([a-z][a-z0-9_]*_kernel)", mangled)
            name = base.group(1) if base else mangled
            if "ILb0E" in mangled:
                name += "<false>"
            elif "ILb1E" in mangled:
                name += "<true>"
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack_frame_bytes=int(m.group(1)),
                             spill_store_bytes=int(m.group(2)),
                             spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def bound(bytes_moved, ops):
    """The least time the card could take: (ms, what binds it, bytes ms,
    operations ms)."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOP_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", bytes_ms, ops_ms)


# ---------------------------------------------------------------------------
# phase 3a: the brute-force closest-hit kernel against its plain version
# ---------------------------------------------------------------------------

def main_path_rays(dev):
    """1M rays of the kind the main path casts at the Cornell box: 500k
    camera rays (2 spp) and the 500k cosine-fanned bounce rays that leave
    the walls they hit.  Camera rays that escape give dead lanes.  Also the
    main path's shadow rays from the hits of both (1M): toward a light point
    sampled as the bounce loop samples it, t_max from the sample, dead where
    nothing was hit or the sample has pdf 0.  Returns (scene, o, d, alive,
    (shadow o, d, t_max))."""
    from gnxraytracer_tpu_torch.constants import INFINITY
    from gnxraytracer_tpu_torch.models import bxdf, lights
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

    hit2 = trace.scene_intersect(scene, cfg, o2, d2,
                                 torch.where(hit.hit, INFINITY, 0.0))
    shadow = []
    for h, itx in ((hit, it), (hit2, trace.make_interaction(scene, cfg, o2,
                                                            d2, hit2))):
        li, _ = path._choose_light(scene, cfg, ub[:, 0], itx.p)
        ls = lights.sample_li(scene, cfg, li, itx.p, ub[:, 1:3])
        so, sd, st = trace.shadow_ray(itx, ls.target, ls.is_infinite)
        shadow.append((so, sd, torch.where(h.hit & (ls.pdf > 0), st, 0.0)))
    shadow = tuple(torch.cat([a, b]).to(torch.float32).contiguous()
                   for a, b in zip(*shadow))
    return scene, rays_o, rays_d, alive, shadow


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


def quad_row(dev, n=400):
    """Eight unit quads in a row (16 triangles, several leaves of a tree)
    and rays aimed exactly at the shared edges x = 1..7 between them:
    (vertices, triangles, o, d, t_max)."""
    xs = np.arange(9, dtype=np.float32)
    verts = np.concatenate([np.stack([xs, np.zeros(9), np.zeros(9)], -1),
                            np.stack([xs, np.ones(9), np.zeros(9)], -1)]
                           ).astype(np.float32)
    tris = np.concatenate([[[i, i + 1, i + 9], [i + 1, i + 10, i + 9]]
                           for i in range(8)]).astype(np.int32)
    rs = np.random.RandomState(3)
    target = np.stack([rs.randint(1, 8, n).astype(np.float32),
                       (0.05 + 0.9 * rs.rand(n)).astype(np.float32),
                       np.zeros(n, np.float32)], -1)
    o = np.broadcast_to(np.asarray([4.2, 0.4, 6.0], np.float32), (n, 3)).copy()
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    put = lambda a: torch.from_numpy(a).to(dev)
    return verts, tris, put(o), put(d), put(np.full(n, 1e30, np.float32))


def brute_pairs(o, d, t_max, tri_soa, any_hit):
    """(pairs tested, pairs that enter the tail) of one brute-force cast as
    csrc/closest_hit.cu runs it: a live lane tests every triangle (closest
    hit) or each one up to its first valid one (any hit); a tested pair
    enters the tail (IEEE division, delta_t, barycentrics) when its edge,
    sign and t range tests pass against the lane's running best (closest
    hit) or its own t_max (any hit).  Plain PyTorch, any device."""
    from gnxraytracer_tpu_torch.ops.intersect import (
        _edge_fn, _permute_shear, _watertight_one)
    ox, oy, oz = o.unbind(1)
    (m0, m1), (sx, sy, sz) = _permute_shear(d)

    def permuted(q):
        px, py, pz = q[0] - ox, q[1] - oy, q[2] - oz
        x = torch.where(m0, py, torch.where(m1, pz, px))
        y = torch.where(m0, pz, torch.where(m1, px, py))
        z = torch.where(m0, px, torch.where(m1, py, pz))
        return x + sx * z, y + sy * z, sz * z

    best = t_max.clone()
    live = ~(t_max <= 0) if any_hit else t_max > 0
    tested = tail = 0
    for ti in range(tri_soa.shape[0]):
        q0, q1, q2 = tri_soa[ti].view(3, 3)
        (x0, y0, z0), (x1, y1, z1), (x2, y2, z2) = map(permuted, (q0, q1, q2))
        e0 = _edge_fn(x1, y1, x2, y2)
        e1 = _edge_fn(x2, y2, x0, y0)
        e2 = _edge_fn(x0, y0, x1, y1)
        neg = (e0 < 0) | (e1 < 0) | (e2 < 0)
        pos = (e0 > 0) | (e1 > 0) | (e2 > 0)
        det = e0 + e1 + e2
        t_scaled = e0 * z0 + e1 * z1 + e2 * z2
        lim = best * det
        bad = torch.where(det < 0, (t_scaled >= 0) | (t_scaled < lim),
                          (t_scaled <= 0) | (t_scaled > lim))
        cand = ~(neg & pos) & (det != 0) & ~bad
        tested += int(live.sum())
        tail += int((live & cand).sum())
        valid, t, _, _, _ = _watertight_one(ox, oy, oz, m0, m1, sx, sy, sz,
                                            best, q0, q1, q2)
        if any_hit:
            live = live & ~valid
        else:
            best = torch.where(valid & (t < best), t, best)
    return tested, tail


def compare_hits(name, got, ref, t_max, miss_b=(0.0, 0.0, 0.0),
                 need_hits=True):
    """Kernel against plain version: hit and tri identical, t within T_RTOL,
    b within B_ATOL, dead lanes inert, a miss carries t = INFINITY, tri = 0
    and b = miss_b.  Returns max |error|."""
    check(torch.equal(got.hit, ref.hit),
          f"{name}: hit differs on {int((got.hit != ref.hit).sum())} lanes")
    check(torch.equal(got.tri, ref.tri),
          f"{name}: tri differs on {int((got.tri != ref.tri).sum())} lanes")
    h = ref.hit
    if int(h.sum()) == 0:
        check(not need_hits, f"{name}: no ray hits anything")
        check(torch.equal(got.t, ref.t) and torch.equal(got.b, ref.b),
              f"{name}: the miss records differ")
        return 0.0
    t_err = (got.t[h] - ref.t[h]).abs()
    check(bool((t_err <= T_RTOL * ref.t[h].abs()).all()),
          f"{name}: t differs by up to {float(t_err.max())}")
    check(torch.equal(got.t[~h], ref.t[~h]), f"{name}: t of a miss differs")
    b_err = (got.b - ref.b).abs()
    check(float(b_err.max()) <= B_ATOL,
          f"{name}: b differs by up to {float(b_err.max())}")
    check(not bool(got.hit[t_max <= 0].any()), f"{name}: a dead lane hit")
    want_b = torch.tensor(miss_b, device=got.b.device)
    check(bool((got.tri[~got.hit] == 0).all()
               and (got.b[~got.hit] == want_b).all()),
          f"{name}: a miss does not carry tri = 0, b = {miss_b}")
    return max(float(t_err.max()), float(b_err.max()))


def phase_kernels(dev):
    from gnxraytracer_tpu_torch.constants import INFINITY
    from gnxraytracer_tpu_torch.kernels import closest_hit as ch

    scene, o, d, alive, shadow = main_path_rays(dev)
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

    # the any-hit kernel: the main path's own shadow rays, the same soups
    # and the shared edge; occlusion identical on every lane
    any_cases = []
    for label, (ao, ad, at, asoa), need in (
            ("cornell shadow rays", (*shadow, soa), True),
            ("soup", (s_o, s_d, s_t, s_soa), True),
            ("soup-3-tiles", (b_o, b_d, b_t, b_soa), True),
            ("shared-edge", (e_o, e_d, e_t, e_soa), True)):
        launches0 = ch.any_launch_count
        occ = ch.any_hit(ao, ad, at, asoa)
        torch.cuda.synchronize()
        check(ch.any_launch_count == launches0 + 1,
              "the any-hit wrapper did not count its launch")
        ref_occ = ch.any_hit_reference(ao, ad, at, asoa)
        check(torch.equal(occ, ref_occ), f"any hit, {label}: occ differs on "
              f"{int((occ != ref_occ).sum())} lanes")
        check(not bool(occ[at <= 0].any()),
              f"any hit, {label}: a dead lane is occluded")
        check(not need or bool(occ.any()), f"any hit, {label}: no ray is "
              "occluded")
        any_cases.append(dict(case=label, n_rays=ao.shape[0],
                              n_tris=asoa.shape[0], max_abs_err=0.0,
                              live_fraction=float((at > 0).float().mean()),
                              occluded_fraction=float(occ.float().mean())))
    check(bool(ch.any_hit(e_o, e_d, e_t, e_soa).all()),
          "any hit: a ray leaked through the shared edge")
    emit({"phase": "any_hit_kernel_vs_plain", "tolerance": {
        "occ": "identical"}, "cases": any_cases})

    # times at the main path's shape (bounces 0-4: 1M lanes x 12 triangles),
    # every lane alive, cold L2
    t_all = torch.full((n,), INFINITY, dtype=torch.float32, device=dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    wrapper_ms = time_cuda(lambda: ch.closest_hit(o, d, t_all, soa), 30, flush)
    ms = device_ms(lambda: ch.closest_hit(o, d, t_all, soa), 30, flush)
    plain_ms = time_cuda(lambda: ch.closest_hit_reference(o, d, t_all, soa),
                         3, flush)
    # the tail of the bounce loop casts at 1/8 width
    m = n // 8
    ms_tail = device_ms(lambda: ch.closest_hit(o[:m], d[:m], t_all[:m], soa),
                        30, flush)
    n_active = int((t_all > 0).sum())
    bound_ms, bound_by, bytes_ms, ops_ms = bound(
        n * (28 + 21) + 36 * n_tri, n_active * n_tri * OPS_PER_PAIR)
    closest = dict(
        name="closest_hit", route="cuda",
        source="gnxraytracer_tpu_torch/csrc/closest_hit.cu",
        replaces="gnxraytracer_tpu/ops/pallas_intersect.py:33",
        launches=None, max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=ms if ms is not None else wrapper_ms,
        ms_source="torch.profiler device time" if ms is not None
        else "CUDA events around the wrapper",
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None,  # no single PyTorch call computes this function
        shape={"n_rays": n, "n_tris": n_tri}, bytes_ms=bytes_ms, ops_ms=ops_ms,
        wrapper_ms_no_sort=wrapper_ms, ms_tail_125k_rays=ms_tail)

    # the any hit on the main path's shadow rays as they come (dead lanes
    # included), and kernel 1 on the same rays
    so, sd, st = shadow
    a_wrapper_ms = time_cuda(lambda: ch.any_hit(so, sd, st, soa), 30, flush)
    a_ms = device_ms(lambda: ch.any_hit(so, sd, st, soa), 30, flush)
    a_plain_ms = time_cuda(lambda: ch.any_hit_reference(so, sd, st, soa), 3,
                           flush)
    closest_same_ms = device_ms(lambda: ch.closest_hit(so, sd, st, soa), 30,
                                flush)
    pairs, _ = brute_pairs(so, sd, st, soa, any_hit=True)
    a_bound_ms, a_bound_by, a_bytes_ms, a_ops_ms = bound(
        so.shape[0] * (28 + 1) + 36 * n_tri, pairs * OPS_PER_PAIR)
    any_hit = dict(
        name="brute_any_hit", route="cuda",
        source="gnxraytracer_tpu_torch/csrc/closest_hit.cu",
        # no TPU kernel: the JAX package casts it with XLA code
        replaces="gnxraytracer_tpu/ops/intersect.py:344",
        replaces_note="no TPU counterpart: XLA code in the JAX package "
                      "(intersect.any_triangle_hit)",
        launches=None, max_abs_err=0.0,
        ms=a_ms if a_ms is not None else a_wrapper_ms,
        ms_source="torch.profiler device time" if a_ms is not None
        else "CUDA events around the wrapper",
        plain_ms=a_plain_ms, bound_ms=a_bound_ms, bound_by=a_bound_by,
        library_ms=None,  # no single PyTorch call computes this function
        shape={"n_rays": so.shape[0], "n_tris": n_tri,
               "live_lanes": int((st > 0).sum()), "pairs_tested": pairs},
        bytes_ms=a_bytes_ms, ops_ms=a_ops_ms, wrapper_ms_no_sort=a_wrapper_ms,
        closest_hit_ms_same_rays=closest_same_ms)
    return ch, closest, any_hit


# ---------------------------------------------------------------------------
# phase 3b: the wide-BVH kernels against their plain versions
# ---------------------------------------------------------------------------

def write_procedural_hdr(path, h=500, w=1000):
    """A flat (non-RLE) Radiance RGBE file: a sky gradient, a darker ground
    half and a small sun, so the environment light has something to
    importance-sample."""
    v = (np.arange(h, dtype=np.float32)[:, None] + 0.5) / h
    u = (np.arange(w, dtype=np.float32)[None, :] + 0.5) / w
    sky = np.clip(1.0 - 1.6 * v, 0.0, 1.0)
    img = np.stack([0.25 + 0.6 * sky + 0.1 * np.sin(6.283 * u),
                    0.30 + 0.8 * sky + 0.0 * u,
                    0.35 + 1.4 * sky + 0.1 * np.cos(6.283 * u)], -1)
    sun = ((u - 0.3) ** 2 * 4 + (v - 0.2) ** 2) < 0.0004
    img[sun] = (900.0, 800.0, 600.0)
    img = img.astype(np.float32)
    m = img.max(-1)
    e = np.ceil(np.log2(np.maximum(m, 1e-30))).astype(np.int32)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img / np.exp2(e)[..., None] * 256.0, 0, 255)
    rgbe[..., 3] = np.where(m > 1e-30, e + 128, 0)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    return path


def mesh_setup(dev, tmp, width=WIDTH, height=HEIGHT, spp=SPP, **kw):
    """Scene, camera, configuration and sampler of the mesh main path:
    presets.envmap_mesh with a procedural HDR environment, depth 8, Sobol',
    1M lanes a chunk at 500x500, fast_mis + compact_tail + pipeline_casts
    with the bench's compaction stages; the casts go through the wide-BVH
    kernels (make_config picks them on a CUDA scene)."""
    from gnxraytracer_tpu_torch.models.integrators import path
    from gnxraytracer_tpu_torch.ops import samplers
    from gnxraytracer_tpu_torch.scene import presets

    hdr = os.path.join(tmp, "procedural_env.hdr")
    if not os.path.exists(hdr):
        write_procedural_hdr(hdr)
    t0 = time.time()
    scene, cam = presets.envmap_mesh(width, height, hdr_path=hdr, device=dev)
    build_s = time.time() - t0
    cfg = path.make_config(
        scene, width, height, spp=spp, max_depth=MAX_DEPTH,
        spp_chunk=SPP_CHUNK, rr_threshold=1.0, fast_mis=True,
        compact_tail=True, pipeline_casts=True, compact_stages=MESH_STAGES,
        count_rays=True, **kw)
    return scene, cam, cfg, samplers.make_sobol_sampler(spp, device=dev), build_s


def path_rays(dev, scene, cam, cfg, light=0):
    """The three kinds of 1M-ray sets a path chunk casts (Sobol', 4 spp):
    camera rays, the cosine-fanned bounce rays that leave the surfaces they
    hit (lanes whose camera ray escaped are dead, t_max = 0), and the shadow
    rays toward samples of light `light` from the same hit points."""
    from gnxraytracer_tpu_torch.constants import INFINITY
    from gnxraytracer_tpu_torch.models import bxdf, lights
    from gnxraytracer_tpu_torch.ops import samplers, trace

    smp = samplers.make_sobol_sampler(SPP_CHUNK, device=dev)
    hw = WIDTH * HEIGHT
    pixel = torch.arange(hw, dtype=torch.int32, device=dev).repeat(SPP_CHUNK)
    sample = torch.repeat_interleave(
        torch.arange(SPP_CHUNK, dtype=torch.int32, device=dev), hw)
    p_film, t_u, p_lens = samplers.camera_sample(smp, pixel, sample, WIDTH)
    from gnxraytracer_tpu_torch.scene import camera
    o, d, _ = camera.generate_rays(cam, p_film, t_u, p_lens)
    n = o.shape[0]
    t_inf = torch.full((n,), INFINITY, dtype=torch.float32, device=dev)
    hit = trace.scene_intersect(scene, cfg, o, d, t_inf)
    it = trace.make_interaction(scene, cfg, o, d, hit)
    ub = samplers.sample_bounce_dims(smp, pixel, sample, 5, 8, 13)
    wi = bxdf.diffuse_sample_wi(trace.to_local(it, it.wo), ub[:, 5:7])
    o2, d2 = trace.spawn_ray(it, trace.to_world(it, wi))
    o2 = torch.where(hit.hit[:, None], o2, o).contiguous()
    d2 = torch.where(hit.hit[:, None], d2, d).contiguous()
    t2 = torch.where(hit.hit, INFINITY, 0.0).to(torch.float32)
    idx = torch.full((n,), light, dtype=torch.int32, device=dev)
    ls = lights.sample_li(scene, cfg, idx, it.p, ub[:, 1:3])
    so, sd, st = trace.shadow_ray(it, ls.target, ls.is_infinite)
    st = torch.where(hit.hit & (ls.pdf > 0), st, 0.0).to(torch.float32)
    return dict(camera=(o.contiguous(), d.contiguous(), t_inf),
                bounce=(o2, d2, t2.contiguous()),
                shadow=(so.contiguous(), sd.contiguous(), st.contiguous()))


def mesh_rays(dev, scene, cam, cfg):
    """The mesh main path's 1M-ray sets (path_rays: camera, bounce, and
    shadow rays toward the environment light), and 1M rays that enter the
    blob's tree (entering_rays), cast closest-hit ("entering") and any-hit
    ("entering_any")."""
    rays = path_rays(dev, scene, cam, cfg, light=0)  # light 0: the env light
    enter = entering_rays(dev, scene.bvh.wide, rays["camera"][0].shape[0])
    return dict(rays, entering=enter, entering_any=enter)


def closed_tree_setup(dev):
    """The mirror-mesh Cornell scene (presets.cornell_box with
    make_test_mesh(5) as a mirror) and ONE tree over all its triangles, the
    12 walls and the light inside it (ops/bvh.build_bvh with no subset): a
    test input on which every camera ray and every bounce hits something in
    the tree.  Returns (scene, camera, configuration, that tree, the first
    light that is not the skybox)."""
    from gnxraytracer_tpu_torch.models.integrators import path
    from gnxraytracer_tpu_torch.ops import bvh as bvh_mod
    from gnxraytracer_tpu_torch.scene import presets
    from gnxraytracer_tpu_torch.scene.loaders import make_test_mesh

    scene, cam = presets.cornell_box(WIDTH, HEIGHT, mesh=make_test_mesh(5),
                                     bvh=True, dragon_material=MIRROR_ID,
                                     device=dev)
    cfg = path.make_config(scene, WIDTH, HEIGHT, spp=SPP_CHUNK, max_depth=1,
                           spp_chunk=SPP_CHUNK)
    tree = bvh_mod.build_bvh(scene.geom.vertices.cpu().numpy(),
                             scene.geom.triangles.cpu().numpy(), device=dev)
    light = next(i for i, k in enumerate(cfg.light_kind_seq) if k != 5)
    return scene, cam, cfg, tree, light


def entering_rays(dev, pack, n, seed=0):
    """n rays that enter the width-8 tree: origins uniform in 1.6x its box
    (the pack's frame), directions uniform on the sphere, t_max = 1e30;
    made on the device from `seed`."""
    lo = pack.frame[0:3]
    hi = lo + 255.0 * pack.frame[3:6]
    gen = torch.Generator(device=dev).manual_seed(seed)
    o = lo + (hi - lo) * (torch.rand((n, 3), generator=gen, device=dev) * 1.6 - 0.3)
    d = torch.randn((n, 3), generator=gen, device=dev)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    return (o.contiguous(), d.contiguous(),
            torch.full((n,), 1e30, dtype=torch.float32, device=dev))


# the ray sets of mesh_rays that go through the any-hit kernels
ANY_HIT_SETS = ("shadow", "entering_any")


def compare_wide_hits(name, got, ref, t_max, need_hits=True):
    """compare_hits with the BVH wrappers' miss record, b = (1, 0, 0)."""
    return compare_hits(name, got, ref, t_max, miss_b=(1.0, 0.0, 0.0),
                        need_hits=need_hits)


def cast_bound(n, name, table_bytes, visits, node_ops):
    """bound() of a BVH cast of n rays of the set `name`: bytes, every ray
    in (28), every result out (21, or 1 for any hit), the tree's tables
    once; operations, node_ops a visited node and 4 triangle tests a leaf
    row, counted from this run's visits."""
    out_bytes = 1 if name in ANY_HIT_SETS else 21
    return bound(n * (28 + out_bytes) + table_bytes,
                 visits["node_visits"] * node_ops
                 + visits["leaf_visits"] * 4 * OPS_PER_PAIR)


def sorts_by_default(wrapper):
    return inspect.signature(wrapper).parameters["sort"].default


def cast_times(fn, pack, o, d, t, lo, hi, key, flush, reps=10):
    """Times of one BVH cast wrapper fn on 1M rays, L2 flushed before each
    launch: the kernel's device time (torch.profiler) on the rays as they
    come and on the same rays in coherence order (ops/bvh.ray_sort_perm over
    the tree's box (lo, hi)); CUDA events around the wrapper with sort=False
    on both; and around the wrapper with its coherence sort."""
    from gnxraytracer_tpu_torch.ops import bvh as bvh_mod

    perm, _ = bvh_mod.ray_sort_perm(o, d, lo, hi, t_max=t, key_mode=key)
    so, sd, st = o[perm].contiguous(), d[perm].contiguous(), t[perm].contiguous()
    return dict(
        kernel_ms_unsorted=device_ms(lambda: fn(pack, o, d, t, sort=False),
                                     reps, flush),
        kernel_ms_sorted=device_ms(lambda: fn(pack, so, sd, st, sort=False),
                                   reps, flush),
        wrapper_ms_unsorted=time_cuda(lambda: fn(pack, o, d, t, sort=False),
                                      reps, flush),
        wrapper_ms_sorted=time_cuda(lambda: fn(pack, so, sd, st, sort=False),
                                    reps, flush),
        wrapper_ms_with_sort=time_cuda(
            lambda: fn(pack, o, d, t, sort=True, sort_key=key), reps, flush),
        alive_fraction=float((t > 0).float().mean()))


def main_path_ms(times, wrapper):
    """The `ms` of a kernel's record: its device time on the rays as its
    wrapper launches them by default (in coherence order or as they come),
    and beside it the wrapper's event time without the sort."""
    sorts = sorts_by_default(wrapper)
    key = "sorted" if sorts else "unsorted"
    ms, source = times[f"kernel_ms_{key}"], "torch.profiler device time"
    if ms is None:  # the profiler saw no kernel: events around the wrapper
        ms, source = times[f"wrapper_ms_{key}"], "CUDA events around the wrapper"
    return dict(ms=ms, ms_source=source, ms_rays="sorted" if sorts else "as they come",
                wrapper_ms_no_sort=times[f"wrapper_ms_{key}"],
                kernel_ms_unsorted=times["kernel_ms_unsorted"],
                kernel_ms_sorted=times["kernel_ms_sorted"],
                wrapper_ms_with_sort=times["wrapper_ms_with_sort"])


def phase_wide_kernels(dev, scene, cfg, rays):
    """Kernels 2 and 3 on the full-width tree: each against its plain walk,
    then timed.  Returns (module, closest record, any-hit record, the times
    and the visit counts per ray set)."""
    from gnxraytracer_tpu_torch.kernels import wide_bvh as wb
    from gnxraytracer_tpu_torch.ops import bvh as bvh_mod

    pack = scene.bvh.wide
    n_tri = int((pack.tid >= 0).sum())
    check(n_tri == 104_882 and cfg.n_big == 2 and cfg.n_tris == 104_884,
          f"unexpected tree: {n_tri} triangles in it, {cfg.n_big} outside")
    n = rays["camera"][0].shape[0]
    check(n == WIDTH * HEIGHT * SPP_CHUNK, "unexpected ray count")
    table_bytes = sum(x.numel() * x.element_size() for x in pack
                      if isinstance(x, torch.Tensor))
    sub = torch.arange(0, n, n // PLAIN_SUBSAMPLE, device=dev)[:PLAIN_SUBSAMPLE]

    cases, visits, plain_ms = [], {}, {}
    c0, a0 = wb.closest_launch_count, wb.any_launch_count
    for name, (o, d, t) in rays.items():
        # the whole 1M-ray set through the kernel, unsorted and sorted: the
        # two must agree with each other everywhere, and with the plain walk
        # on the sub-sample
        so, sd, st = o[sub].contiguous(), d[sub].contiguous(), t[sub].contiguous()
        if name not in ANY_HIT_SETS:
            got = wb.wide_closest_hit(pack, o, d, t, sort=False)
            got_s = wb.wide_closest_hit(pack, o, d, t, sort=True,
                                        sort_key=cfg.sort_key)
            torch.cuda.synchronize()
            for f in got._fields:
                check(torch.equal(getattr(got, f), getattr(got_s, f)),
                      f"{name}: {f} depends on the coherence sort")
            stats = {}
            t0 = time.time()
            ref = wb.wide_closest_hit_reference(pack, so, sd, st, stats=stats)
            torch.cuda.synchronize()
            plain_ms[name] = (time.time() - t0) * 1e3
            got_sub = type(got)(*(x[sub] for x in got))
            err = compare_wide_hits(name, got_sub, ref, st)
            cases.append(dict(kernel="wide_closest_hit", case=name, n_rays=n,
                              plain_on=f"a sub-sample of {len(sub)} rays",
                              max_abs_err=err,
                              hit_fraction=float(got.hit.float().mean())))
        else:
            got = wb.wide_any_hit(pack, o, d, t, sort=False)
            got_s = wb.wide_any_hit(pack, o, d, t, sort=True,
                                    sort_key=cfg.sort_key)
            torch.cuda.synchronize()
            check(torch.equal(got, got_s), f"{name}: occ depends on the sort")
            stats = {}
            t0 = time.time()
            ref = wb.wide_any_hit_reference(pack, so, sd, st, stats=stats)
            torch.cuda.synchronize()
            plain_ms[name] = (time.time() - t0) * 1e3
            check(torch.equal(got[sub], ref),
                  f"{name}: occ differs on {int((got[sub] != ref).sum())} lanes")
            check(not bool(got[t <= 0].any()), f"{name}: a dead lane is occluded")
            check(int(ref.sum()) > 0, f"{name}: no ray is occluded")
            cases.append(dict(kernel="wide_any_hit", case=name, n_rays=n,
                              plain_on=f"a sub-sample of {len(sub)} rays",
                              max_abs_err=0.0,
                              occluded_fraction=float(got.float().mean())))
        visits[name] = {k: v if k == "max_stack" else v * (n / len(sub))
                        for k, v in stats.items()}

    # a ragged count, dead lanes and t_max cut short, all rays through both
    # (every 9th lane: the first rows of the image see only sky)
    o, d, t = (x[::9][:100_003].clone() for x in rays["bounce"])
    check(o.shape[0] == 100_003, "unexpected ragged ray count")
    t[1::4] = 1.5
    t[2::8] = 0.0
    got = wb.wide_closest_hit(pack, o, d, t)
    ref = wb.wide_closest_hit_reference(pack, o, d, t)
    cases.append(dict(kernel="wide_closest_hit", case="ragged+dead+t_max",
                      n_rays=100_003, plain_on="all rays",
                      max_abs_err=compare_wide_hits("ragged", got, ref, t)))
    check(bool((got.t[got.hit] <= t[got.hit]).all()), "ragged: t beyond t_max")
    occ = wb.wide_any_hit(pack, o, d, t)
    check(torch.equal(occ, wb.wide_any_hit_reference(pack, o, d, t)),
          "ragged: occ differs")
    check(torch.equal(occ, got.hit),
          "ragged: any hit and closest hit disagree on which rays hit")
    cases.append(dict(kernel="wide_any_hit", case="ragged+dead+t_max",
                      n_rays=100_003, plain_on="all rays", max_abs_err=0.0))

    # the shared diagonal of a two-triangle quad, through its own tree
    e_soa, e_o, e_d, e_t = shared_edge(dev)
    quad_v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    quad_t = np.asarray([[0, 1, 2], [1, 3, 2]], np.int32)
    quad = bvh_mod.build_bvh(quad_v, quad_t, device=dev).wide
    e_got = wb.wide_closest_hit(quad, e_o, e_d, e_t)
    check(bool(e_got.hit.all()),
          f"{int((~e_got.hit).sum())} rays leaked through the shared edge")
    check(bool(wb.wide_any_hit(quad, e_o, e_d, e_t).all()),
          "any hit: rays leaked through the shared edge")
    cases.append(dict(kernel="wide_closest_hit", case="shared-edge",
                      n_rays=500, plain_on="all rays",
                      max_abs_err=compare_wide_hits(
                          "shared-edge", e_got,
                          wb.wide_closest_hit_reference(quad, e_o, e_d, e_t),
                          e_t)))
    check(wb.closest_launch_count > c0 and wb.any_launch_count > a0,
          "a wrapper did not count its launches")
    emit({"phase": "wide_kernel_vs_plain", "tolerance": {
        "hit": "identical", "occ": "identical", "tri": "identical",
        "t_rtol": T_RTOL, "b_atol": B_ATOL}, "tree": {
        "triangles": n_tri, "wide_nodes": int(pack.rec.shape[0]),
        "leaf_rows": int(pack.leafs.shape[0]), "stack_size": pack.stack_size},
        "cases": cases})

    # isolated-cast times (L2 flushed before each launch), see cast_times
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    lo, hi = pack.frame[0:3], pack.frame[0:3] + 255.0 * pack.frame[3:6]
    times = {}
    for name, (o, d, t) in rays.items():
        fn = wb.wide_any_hit if name in ANY_HIT_SETS else wb.wide_closest_hit
        times[name] = cast_times(fn, pack, o, d, t, lo, hi, cfg.sort_key, flush)
        times[name]["bound_ms"] = cast_bound(
            n, name, table_bytes, visits[name], 8 * OPS_PER_SLAB)[0]
    emit({"phase": "wide_kernel_times", "n_rays": n, "times": times,
          "wrappers_sort_by_default": sorts_by_default(wb.wide_closest_hit),
          "plain_ms_on_subsample": plain_ms, "subsample": len(sub),
          "visits_scaled_to_n_rays": visits})

    def record(name, entry, case):
        v = visits[case]
        bound_ms, bound_by, bytes_ms, ops_ms = cast_bound(
            n, case, table_bytes, v, 8 * OPS_PER_SLAB)
        errs = [c["max_abs_err"] for c in cases if c["kernel"] == name]
        return dict(
            name=name, route="cuda",
            source="gnxraytracer_tpu_torch/csrc/wide_bvh.cu",
            replaces="gnxraytracer_tpu/ops/pallas_wbvh.py:445",
            launches=None, max_abs_err=max(errs),
            plain_ms=plain_ms[case],
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            shape={"n_rays": n, "rays": case, "entry": entry,
                   "plain_n_rays": len(sub)},
            bytes_ms=bytes_ms, ops_ms=ops_ms, table_bytes=table_bytes,
            **main_path_ms(times[case], wb.wide_closest_hit),
            node_visits=v["node_visits"], leaf_visits=v["leaf_visits"])

    return (wb, record("wide_closest_hit", "gnx_wide_closest_hit", "bounce"),
            record("wide_any_hit", "gnx_wide_any_hit", "shadow"), times,
            visits)


# ---------------------------------------------------------------------------
# phase 3c: the binary threaded-BVH kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_packet_kernels(dev, scene, cfg, rays, wide_times, wide_visits):
    """Kernels 4 and 5 on the full-width tree, on the rays of phase 3b: each
    against its plain walk, then timed, with the wide kernels' times on the
    same rays beside them.  Returns (module, closest record, any-hit
    record)."""
    from gnxraytracer_tpu_torch.kernels import packet_bvh as pk
    from gnxraytracer_tpu_torch.ops import bvh as bvh_mod

    pack = scene.bvh.packet
    n_tri = int((pack.tid >= 0).sum())
    check(n_tri == 104_882 and pack.meta.shape[0] == 8,
          f"unexpected tree: {n_tri} triangles, {pack.meta.shape[0]} link tables")
    n = rays["camera"][0].shape[0]
    sub = torch.arange(0, n, n // PLAIN_SUBSAMPLE, device=dev)[:PLAIN_SUBSAMPLE]
    table_bytes = sum(x.numel() * x.element_size() for x in pack)

    cases, visits, plain_ms = [], {}, {}
    c0, a0 = pk.closest_launch_count, pk.any_launch_count
    for name, (o, d, t) in rays.items():
        so, sd, st = o[sub].contiguous(), d[sub].contiguous(), t[sub].contiguous()
        stats = {}
        if name not in ANY_HIT_SETS:
            got = pk.packet_closest_hit(pack, o, d, t, sort=False)
            got_s = pk.packet_closest_hit(pack, o, d, t, sort=True,
                                          sort_key=cfg.sort_key)
            torch.cuda.synchronize()
            for f in got._fields:
                check(torch.equal(getattr(got, f), getattr(got_s, f)),
                      f"binary {name}: {f} depends on the coherence sort")
            t0 = time.time()
            ref = pk.packet_closest_hit_reference(pack, so, sd, st, stats=stats)
            torch.cuda.synchronize()
            plain_ms[name] = (time.time() - t0) * 1e3
            got_sub = type(got)(*(x[sub] for x in got))
            err = compare_wide_hits("binary " + name, got_sub, ref, st)
            cases.append(dict(kernel="packet_closest_hit", case=name, n_rays=n,
                              plain_on=f"a sub-sample of {len(sub)} rays",
                              max_abs_err=err,
                              hit_fraction=float(got.hit.float().mean())))
        else:
            got = pk.packet_any_hit(pack, o, d, t, sort=False)
            got_s = pk.packet_any_hit(pack, o, d, t, sort=True,
                                      sort_key=cfg.sort_key)
            torch.cuda.synchronize()
            check(torch.equal(got, got_s), f"binary {name}: occ depends on the sort")
            t0 = time.time()
            ref = pk.packet_any_hit_reference(pack, so, sd, st, stats=stats)
            torch.cuda.synchronize()
            plain_ms[name] = (time.time() - t0) * 1e3
            check(torch.equal(got[sub], ref), f"binary {name}: occ differs on "
                  f"{int((got[sub] != ref).sum())} lanes")
            check(not bool(got[t <= 0].any()),
                  f"binary {name}: a dead lane is occluded")
            check(int(ref.sum()) > 0, f"binary {name}: no ray is occluded")
            cases.append(dict(kernel="packet_any_hit", case=name, n_rays=n,
                              plain_on=f"a sub-sample of {len(sub)} rays",
                              max_abs_err=0.0,
                              occluded_fraction=float(got.float().mean())))
        visits[name] = {k: v * (n / len(sub)) for k, v in stats.items()}

    # a ragged count, dead lanes and t_max cut short, all rays through both
    o, d, t = (x[::9][:100_003].clone() for x in rays["bounce"])
    t[1::4] = 1.5
    t[2::8] = 0.0
    got = pk.packet_closest_hit(pack, o, d, t)
    ref = pk.packet_closest_hit_reference(pack, o, d, t)
    cases.append(dict(kernel="packet_closest_hit", case="ragged+dead+t_max",
                      n_rays=100_003, plain_on="all rays",
                      max_abs_err=compare_wide_hits("binary ragged", got, ref, t)))
    check(bool((got.t[got.hit] <= t[got.hit]).all()),
          "binary ragged: t beyond t_max")
    occ = pk.packet_any_hit(pack, o, d, t)
    check(torch.equal(occ, pk.packet_any_hit_reference(pack, o, d, t)),
          "binary ragged: occ differs")
    check(torch.equal(occ, got.hit),
          "binary ragged: any hit and closest hit disagree on which rays hit")
    cases.append(dict(kernel="packet_any_hit", case="ragged+dead+t_max",
                      n_rays=100_003, plain_on="all rays", max_abs_err=0.0))

    # the two-phase cast: capped at near_r first, the misses again in full
    two = pk.packet_closest_hit(pack, o, d, t, near_r=0.25)
    for f in got._fields:
        check(torch.equal(getattr(two, f), getattr(got, f)),
              f"binary two-phase cast: {f} differs from the one-phase cast")
    cases.append(dict(kernel="packet_closest_hit", case="two-phase near_r=0.25",
                      n_rays=100_003, plain_on="the one-phase kernel cast",
                      max_abs_err=0.0))

    # a tree without octant links (one link table, the depth-first order),
    # made from the same binary tables
    b = scene.bvh
    host = lambda x: x.cpu().numpy()
    k1 = bvh_mod.build_packet_pack(
        host(b.bounds_lo), host(b.bounds_hi), host(b.offset), host(b.n_prims),
        host(b.prim_idx), host(b.leaf_soa), host(b.miss), device=dev)
    check(k1.meta.shape[0] == 1, "the K = 1 pack has octant links")
    got1 = pk.packet_closest_hit(k1, o, d, t)
    ref1 = pk.packet_closest_hit_reference(k1, o, d, t)
    cases.append(dict(kernel="packet_closest_hit", case="K=1 fixed order",
                      n_rays=100_003, plain_on="all rays",
                      max_abs_err=compare_wide_hits("binary K=1", got1, ref1, t)))
    check(torch.equal(got1.hit, got.hit), "K = 1: another hit set than K = 8")
    check(torch.equal(pk.packet_any_hit(k1, o, d, t), got.hit),
          "K = 1: any hit differs")
    cases.append(dict(kernel="packet_any_hit", case="K=1 fixed order",
                      n_rays=100_003, plain_on="the closest-hit kernel's hit set",
                      max_abs_err=0.0))

    # the shared diagonal of a two-triangle quad, through its own tree
    e_soa, e_o, e_d, e_t = shared_edge(dev)
    quad_v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    quad_t = np.asarray([[0, 1, 2], [1, 3, 2]], np.int32)
    quad = bvh_mod.build_bvh(quad_v, quad_t, device=dev).packet
    e_got = pk.packet_closest_hit(quad, e_o, e_d, e_t)
    check(bool(e_got.hit.all()),
          f"binary: {int((~e_got.hit).sum())} rays leaked through the shared edge")
    check(bool(pk.packet_any_hit(quad, e_o, e_d, e_t).all()),
          "binary any hit: rays leaked through the shared edge")
    cases.append(dict(kernel="packet_closest_hit", case="shared-edge",
                      n_rays=500, plain_on="all rays",
                      max_abs_err=compare_wide_hits(
                          "binary shared-edge", e_got,
                          pk.packet_closest_hit_reference(quad, e_o, e_d, e_t),
                          e_t)))
    # the shared edges between quads in other leaves of one tree
    r_v, r_t, r_o, r_d, r_tm = quad_row(dev)
    row = bvh_mod.build_bvh(r_v, r_t, device=dev).packet
    check(row.nodes.shape[0] > 3, "the quad row's tree has one leaf")
    r_got = pk.packet_closest_hit(row, r_o, r_d, r_tm)
    check(bool(r_got.hit.all()), f"binary: {int((~r_got.hit).sum())} rays "
          "leaked through an edge shared by two leaves")
    r_occ = pk.packet_any_hit(row, r_o, r_d, r_tm)
    check(torch.equal(r_occ, pk.packet_any_hit_reference(row, r_o, r_d, r_tm))
          and bool(r_occ.all()), "binary any hit: the quad row leaks")
    cases.append(dict(kernel="packet_closest_hit",
                      case="shared edge across two leaves", n_rays=400,
                      plain_on="all rays", max_abs_err=compare_wide_hits(
                          "binary quad row", r_got,
                          pk.packet_closest_hit_reference(row, r_o, r_d, r_tm),
                          r_tm)))
    cases.append(dict(kernel="packet_any_hit",
                      case="shared edge across two leaves", n_rays=400,
                      plain_on="all rays", max_abs_err=0.0))
    check(pk.closest_launch_count > c0 and pk.any_launch_count > a0,
          "a wrapper did not count its launches")
    emit({"phase": "packet_kernel_vs_plain", "tolerance": {
        "hit": "identical", "occ": "identical", "tri": "identical",
        "t_rtol": T_RTOL, "b_atol": B_ATOL}, "tree": {
        "triangles": n_tri, "binary_nodes": int(pack.nodes.shape[0]),
        "link_tables": int(pack.meta.shape[0]),
        "leaf_rows": int(pack.leafs.shape[0]), "table_bytes": table_bytes},
        "cases": cases})

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    lo, hi = pack.nodes[0, 0:3], pack.nodes[0, 3:6]
    times = {}
    for name, (o, d, t) in rays.items():
        fn = pk.packet_any_hit if name in ANY_HIT_SETS else pk.packet_closest_hit
        times[name] = cast_times(fn, pack, o, d, t, lo, hi, cfg.sort_key, flush)
        times[name]["wide_kernel_ms_unsorted"] = wide_times[name]["kernel_ms_unsorted"]
        times[name]["wide_kernel_ms_sorted"] = wide_times[name]["kernel_ms_sorted"]
        times[name]["bound_ms"] = cast_bound(
            n, name, table_bytes, visits[name], OPS_PER_NODE)[0]
    sorts = [sorts_by_default(f) for f in (pk.packet_closest_hit,
                                            pk.packet_any_hit)]
    check(not any(sorts), "the binary wrappers sort their rays by default")
    # operators one cast dispatches, as trace._bvh_casts makes it and with
    # the coherence sort the wrappers made before
    o, d, t = rays["bounce"]
    ops = {label: count_dispatched_ops(lambda: pk.packet_closest_hit(
        pack, o, d, t, sort=srt, sort_key=cfg.sort_key))
        for label, srt in (("default", False), ("with_sort", True))}
    emit({"phase": "packet_kernel_times", "n_rays": n, "times": times,
          "wrappers_sort_by_default": sorts,
          "dispatched_ops_per_bounce_cast": ops,
          "plain_ms_on_subsample": plain_ms, "subsample": len(sub),
          "visits_scaled_to_n_rays": visits,
          "wide_visits_scaled_to_n_rays": wide_visits})

    def record(name, entry, body_line, case):
        v = visits[case]
        # what the walk loads per visit comes from the L2 cache and is
        # reported beside the bound, not in it
        bound_ms, bound_by, bytes_ms, ops_ms = cast_bound(
            n, case, table_bytes, v, OPS_PER_NODE)
        errs = [c["max_abs_err"] for c in cases if c["kernel"] == name]
        return dict(
            name=name, route="cuda",
            source="gnxraytracer_tpu_torch/csrc/packet_bvh.cu",
            replaces=f"gnxraytracer_tpu/ops/pallas_bvh.py:{body_line}",
            launches=None, max_abs_err=max(errs),
            plain_ms=plain_ms[case],
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            shape={"n_rays": n, "rays": case, "entry": entry,
                   "plain_n_rays": len(sub)},
            bytes_ms=bytes_ms, ops_ms=ops_ms, table_bytes=table_bytes,
            table_load_bytes=v["node_visits"] * BYTES_PER_NODE
            + v["leaf_visits"] * BYTES_PER_LEAF_ROW,
            **main_path_ms(times[case], pk.packet_closest_hit),
            node_visits=v["node_visits"], leaf_visits=v["leaf_visits"])

    return (pk, record("packet_closest_hit", "gnx_packet_closest_hit", 195,
                       "bounce"),
            record("packet_any_hit", "gnx_packet_any_hit", 544, "shadow"))


# ---------------------------------------------------------------------------
# phases 4 to 6: the two main paths and the golden image
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


# calls of the brute-force casts' plain versions (kernels/closest_hit.py;
# the plain casts of ops/intersect.py call them too), counted from
# count_plain_calls on: a main path on the card makes none
PLAIN_CALLS = {"closest_hit_reference": 0, "any_hit_reference": 0}


def count_plain_calls(ch):
    for name in PLAIN_CALLS:
        def counted(*a, _fn=getattr(ch, name), _name=name, **kw):
            PLAIN_CALLS[_name] += 1
            return _fn(*a, **kw)
        setattr(ch, name, counted)


def reset_counts(ch, wb, pk):
    ch.reset_launch_count()
    wb.reset_launch_counts()
    pk.reset_launch_counts()
    for name in PLAIN_CALLS:
        PLAIN_CALLS[name] = 0


def brute_counts(ch):
    return (ch.launch_count, ch.any_launch_count)


def check_no_plain_brute(what):
    check(not any(PLAIN_CALLS.values()),
          f"{what}: a brute-force cast took its plain version {PLAIN_CALLS}")


def packet_counts(pk):
    return (pk.closest_launch_count, pk.any_launch_count)


def wide_counts(wb):
    return (wb.closest_launch_count, wb.any_launch_count)


@contextlib.contextmanager
def counting_sorts(wb):
    """Counts the coherence sorts the BVH wrappers make while the block runs
    (kernels/wide_bvh._sorted_cast, which both pairs of wrappers share):
    yields a one-entry list."""
    n, sort = [0], wb.ray_sort_perm

    def counted(*a, **kw):
        n[0] += 1
        return sort(*a, **kw)
    wb.ray_sort_perm = counted
    try:
        yield n
    finally:
        wb.ray_sort_perm = sort


@contextlib.contextmanager
def binary_walk():
    """GNX_WIDE_BVH=0 while the block runs: the BVH casts walk the binary
    threaded table (kernels/packet_bvh.py); restored after."""
    old = os.environ.get("GNX_WIDE_BVH")
    os.environ["GNX_WIDE_BVH"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["GNX_WIDE_BVH"]
        else:
            os.environ["GNX_WIDE_BVH"] = old


def phase_main_path(dev, ch, wb, pk):
    """The Cornell main path.  Returns the launches of the brute-force
    kernels (closest, any hit)."""
    from gnxraytracer_tpu_torch import cli
    from gnxraytracer_tpu_torch.models.integrators import path

    scene, cam, cfg, smp = main_path_setup(dev)
    lanes = WIDTH * HEIGHT * SPP_CHUNK

    # warm-up chunk (also gives the useful casts per path)
    _, n_rays = path.render_chunk(scene, cam, smp, cfg, 0, SPP_CHUNK)
    torch.cuda.synchronize()
    rays_per_path = float(n_rays) / lanes

    reset_counts(ch, wb, pk)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    img = path.render(scene, cam, smp, cfg)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = brute_counts(ch)
    chunks = SPP // SPP_CHUNK
    # one closest-hit and one shadow cast per bounce
    casts = chunks * (MAX_DEPTH + 1)
    check(launches == (casts, casts),
          f"kernel launches {launches} != casts {(casts, casts)}")
    check(wide_counts(wb) == (0, 0) and packet_counts(pk) == (0, 0),
          "the Cornell path launched a BVH kernel")
    check_no_plain_brute("cornell path.render")
    check(tuple(img.shape) == (HEIGHT, WIDTH, 3), f"image shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "the image is not finite")
    mean = float(img.mean())
    check(0.05 < mean < 5.0, f"image mean {mean}: black or blown out")
    emit({"phase": "main_path", "scene": "cornell", "entry": "path.render",
          "width": WIDTH,
          "height": HEIGHT, "max_depth": MAX_DEPTH, "spp": SPP,
          "lanes_per_chunk": lanes, "chunks": chunks,
          "kernel_launches": {"closest_hit": launches[0],
                              "brute_any_hit": launches[1]},
          "closest_hit_casts": casts, "shadow_casts": casts,
          "rays_per_path": rays_per_path, "ms_per_chunk": wall / chunks * 1e3,
          "Mpaths_per_s": WIDTH * HEIGHT * SPP / wall / 1e6,
          "image_mean": mean,
          "peak_device_MiB": torch.cuda.max_memory_allocated() / 2 ** 20})

    # the CLI a user would call (its defaults: 500x500, depth 5); on a CUDA
    # device it turns the kernels on itself
    reset_counts(ch, wb, pk)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli.npy")
        cli.main(["render", "--preset", "cornell", "--sampler", "sobol",
                  "--fast-mis", "--spp", "4", "--out-npy", out])
        cli_img = np.load(out)
    cli_launches = brute_counts(ch)
    check(cli_launches == (6, 6),
          f"CLI: {cli_launches} kernel launches, expected (6, 6)")
    check_no_plain_brute("cornell cli render")
    check(cli_img.shape == (HEIGHT, WIDTH, 3) and np.isfinite(cli_img).all()
          and cli_img.mean() > 0.05, "CLI: bad image")
    emit({"phase": "main_path", "scene": "cornell", "entry": "cli render",
          "kernel_launches": {"closest_hit": cli_launches[0],
                              "brute_any_hit": cli_launches[1]},
          "image_mean": float(cli_img.mean())})
    return tuple(a + b for a, b in zip(launches, cli_launches))


@contextlib.contextmanager
def casts_sorted(wb):
    """The wide-BVH wrappers with their coherence sort on (a measurement
    aid: they do not sort by default, and the render configuration has no
    such switch)."""
    closest, any_hit = wb.wide_closest_hit, wb.wide_any_hit
    wb.wide_closest_hit = functools.partial(closest, sort=True)
    wb.wide_any_hit = functools.partial(any_hit, sort=True)
    try:
        yield
    finally:
        wb.wide_closest_hit, wb.wide_any_hit = closest, any_hit


def timed_chunk(path, scene, cam, smp, cfg, start):
    t0 = time.time()
    img, _ = path.render_chunk(scene, cam, smp, cfg, start, SPP_CHUNK)
    torch.cuda.synchronize()
    return (time.time() - t0) * 1e3, img


def phase_mesh_path(dev, ch, wb, pk, setup, tmp):
    """The mesh main path.  Returns the launches of (wide_closest_hit,
    wide_any_hit) in path.render, and the radiance sum of the chunk of
    samples 4-7 for phase 7 to compare with."""
    from gnxraytracer_tpu_torch import cli
    from gnxraytracer_tpu_torch.models.integrators import path

    scene, cam, cfg, smp, build_s = setup
    lanes = WIDTH * HEIGHT * SPP_CHUNK
    check(cfg.use_bvh and cfg.bvh_mode == "pallas" and cfg.has_env
          and cfg.has_textures and not cfg.has_skybox,
          f"unexpected mesh configuration {cfg}")

    # warm-up chunk (also gives the useful casts per path)
    _, n_rays = path.render_chunk(scene, cam, smp, cfg, 0, SPP_CHUNK)
    torch.cuda.synchronize()
    rays_per_path = float(n_rays) / lanes
    check(1.0 < rays_per_path < 6.0, f"rays per path {rays_per_path}")

    reset_counts(ch, wb, pk)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    img = path.render(scene, cam, smp, cfg)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = wide_counts(wb)
    chunks = SPP // SPP_CHUNK
    # one closest-hit cast at the camera and one after every work, one shadow
    # cast per work, in every chunk
    per_chunk = path.pipelined_cast_counts(cfg, lanes)
    check(per_chunk == (MAX_DEPTH + 1, MAX_DEPTH), f"cast counts {per_chunk}")
    want = (chunks * per_chunk[0], chunks * per_chunk[1])
    check(launches == want, f"wide kernel launches {launches} != casts {want}")
    # every BVH cast brute-forces the floor, kept out of the tree, first
    check(cfg.n_big > 0, "the mesh scene keeps no triangle out of its tree")
    brute = brute_counts(ch)
    check(brute == want, f"brute-force kernel launches {brute} != casts {want}")
    check_no_plain_brute("mesh path.render")
    check(packet_counts(pk) == (0, 0),
          "the mesh path launched a binary-BVH kernel without being asked to")
    check(tuple(img.shape) == (HEIGHT, WIDTH, 3), f"image shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "the mesh image is not finite")
    mean = float(img.mean())
    check(0.02 < mean < 50.0, f"mesh image mean {mean}: black or blown out")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20

    # the same chunk with the coherence sort off (the default) and on, in
    # turns (off, on, on, off), SORT_ROUNDS rounds: the chunk is bound by
    # the host, whose times spread, so the medians are what to compare
    sort_on, sort_off = [], []
    for _ in range(SORT_ROUNDS):
        ms, img_off = timed_chunk(path, scene, cam, smp, cfg, 4)
        sort_off.append(ms)
        with casts_sorted(wb):
            ms, img_on = timed_chunk(path, scene, cam, smp, cfg, 4)
            sort_on.append(ms)
            sort_on.append(timed_chunk(path, scene, cam, smp, cfg, 4)[0])
        sort_off.append(timed_chunk(path, scene, cam, smp, cfg, 4)[0])
        check(torch.equal(img_on, img_off),
              "the image depends on the coherence sort")
    emit({"phase": "main_path", "scene": "envmap_mesh", "entry": "path.render",
          "width": WIDTH, "height": HEIGHT, "max_depth": MAX_DEPTH, "spp": SPP,
          "triangles": cfg.n_tris, "compact_stages": MESH_STAGES,
          "lanes_per_chunk": lanes, "chunks": chunks,
          "bvh_build_s": build_s,
          "kernel_launches": {"wide_closest_hit": launches[0],
                              "wide_any_hit": launches[1],
                              "closest_hit": brute[0],
                              "brute_any_hit": brute[1]},
          "casts_per_chunk": {"closest": per_chunk[0], "shadow": per_chunk[1]},
          "rays_per_path": rays_per_path, "ms_per_chunk": wall / chunks * 1e3,
          "Mpaths_per_s": WIDTH * HEIGHT * SPP / wall / 1e6,
          "image_mean": mean, "peak_device_MiB": peak,
          "chunk_ms_sort_on": sort_on, "chunk_ms_sort_off": sort_off,
          "chunk_ms_sort_on_median": float(np.median(sort_on)),
          "chunk_ms_sort_off_median": float(np.median(sort_off))})

    # the CLI a user would call; it takes no HDR path, so without the
    # reference renderer's assets the preset falls back to its skybox
    reset_counts(ch, wb, pk)
    with tempfile.TemporaryDirectory() as out_dir:
        out = os.path.join(out_dir, "cli.npy")
        cli.main(["render", "--preset", "envmap", "--sampler", "sobol",
                  "--fast-mis", "--spp", "4", "--max-depth", str(MAX_DEPTH),
                  "--out-npy", out])
        cli_img = np.load(out)
    cli_launches = wide_counts(wb)
    # the CLI's configuration runs the classic loop: one closest-hit and one
    # shadow cast per bounce, each with its floor cast
    check(cli_launches == (MAX_DEPTH + 1, MAX_DEPTH + 1)
          and brute_counts(ch) == cli_launches,
          f"CLI: wide kernel launches {cli_launches}, brute-force "
          f"{brute_counts(ch)}")
    check_no_plain_brute("mesh cli render")
    check(cli_img.shape == (HEIGHT, WIDTH, 3) and np.isfinite(cli_img).all()
          and cli_img.mean() > 0.02, "CLI: bad mesh image")
    emit({"phase": "main_path", "scene": "envmap_mesh", "entry": "cli render",
          "environment": "skybox fallback (no HDR asset)",
          "kernel_launches": {"wide_closest_hit": cli_launches[0],
                              "wide_any_hit": cli_launches[1],
                              "closest_hit": cli_launches[0],
                              "brute_any_hit": cli_launches[1]},
          "image_mean": float(cli_img.mean())})

    # kernels against the plain walk through the whole path, at 64x64: this
    # stands in for the reference renderer's mesh golden, whose assets are
    # not in the repository
    s64 = mesh_setup(dev, tmp, 64, 64, spp=4)
    img_k = path.render(s64[0], s64[1], s64[3], s64[2])
    img_p = path.render(s64[0], s64[1], s64[3],
                        s64[2]._replace(bvh_mode="packet"))
    torch.cuda.synchronize()
    close = torch.isclose(img_k, img_p, rtol=1e-4, atol=1e-6)
    emit({"phase": "cross_check", "what": "64x64, 4 spp, depth 8: "
          "bvh_mode='pallas' (kernels) against 'packet' (plain walk)",
          "rtol": 1e-4, "pixels_differing": int((~close.all(-1)).sum()),
          "max_abs_diff": float((img_k - img_p).abs().max()),
          "image_mean": float(img_k.mean())})
    check(bool(close.all()), "cross-check: the kernels' image differs from "
          "the plain walk's")
    return launches, brute, img_off


# ---------------------------------------------------------------------------
# phase 7: the mesh main path through the binary threaded-BVH kernels
# ---------------------------------------------------------------------------

def phase_mesh_path_binary(dev, ch, wb, pk, setup, wide_chunk):
    """One chunk of the mesh main path (samples 4-7, after a warm-up chunk)
    with every BVH cast through kernels 4 and 5.  Returns their launches."""
    from gnxraytracer_tpu_torch.models.integrators import path

    scene, cam, cfg, smp, _ = setup
    lanes = WIDTH * HEIGHT * SPP_CHUNK
    with binary_walk():
        _, n_rays = path.render_chunk(scene, cam, smp, cfg, 0, SPP_CHUNK)
        torch.cuda.synchronize()
        reset_counts(ch, wb, pk)
        with counting_sorts(wb) as sorts:
            ms, img = timed_chunk(path, scene, cam, smp, cfg, 4)
        launches = packet_counts(pk)
        brute, wide = brute_counts(ch), wide_counts(wb)
        chunk_ops = count_dispatched_ops(
            lambda: path.render_chunk(scene, cam, smp, cfg, 4, SPP_CHUNK))
    check(sorts[0] == 0, f"GNX_WIDE_BVH=0: the chunk sorted its rays "
          f"{sorts[0]} times")
    per_chunk = path.pipelined_cast_counts(cfg, lanes)
    check(launches == per_chunk,
          f"binary kernel launches {launches} != casts {per_chunk}")
    check(wide == (0, 0),
          "GNX_WIDE_BVH=0: the mesh chunk still launched a wide kernel")
    check(brute == launches, f"GNX_WIDE_BVH=0: brute-force "
          f"launches {brute} != casts {launches}")
    check_no_plain_brute("mesh chunk, GNX_WIDE_BVH=0")
    check(bool(torch.isfinite(img).all()), "binary walk: image not finite")
    diff = (img - wide_chunk).abs()
    rel = float(diff.mean() / wide_chunk.abs().mean())
    emit({"phase": "main_path", "scene": "envmap_mesh",
          "entry": "path.render_chunk, GNX_WIDE_BVH=0",
          "lanes_per_chunk": lanes,
          "kernel_launches": {"packet_closest_hit": launches[0],
                              "packet_any_hit": launches[1],
                              "wide_closest_hit": 0, "wide_any_hit": 0,
                              "closest_hit": launches[0],
                              "brute_any_hit": launches[1]},
          "coherence_sorts": sorts[0], "dispatched_ops_in_chunk": chunk_ops,
          "rays_per_path": float(n_rays) / lanes, "ms_per_chunk": ms,
          "Mpaths_per_s": lanes / ms / 1e3,
          "image_mean": float(img.mean()) / SPP_CHUNK,
          "vs_wide_kernel_chunk": {
              "max_abs_diff": float(diff.max()),
              "mean_abs_diff": float(diff.mean()),
              "mean_rel_diff": rel, "mean_rel_limit": 1e-3,
              "pixels_differing": int((diff.amax(-1) > 0).sum())}})
    check(rel < 1e-3, f"binary walk: the chunk differs from the wide "
          f"kernels' by {rel} (mean, relative)")
    return launches


# ---------------------------------------------------------------------------
# phase 8: Whitted, direct lighting and the faithful path with Halton
# ---------------------------------------------------------------------------

WHITTED_DEPTH = 5


def timed_render(mod, scene, cam, smp, cfg, *extra, reset):
    """A warm-up chunk, then reset() (the launch counts go to 0) and
    mod.render: (image, ms per chunk, peak MiB, chunks)."""
    mod.render_chunk(scene, cam, smp, cfg, 0, cfg.spp_chunk, *extra)
    torch.cuda.synchronize()
    reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    img = mod.render(scene, cam, smp, cfg, *extra)
    torch.cuda.synchronize()
    chunks = -(-cfg.spp // cfg.spp_chunk)
    ms = (time.time() - t0) / chunks * 1e3
    check(tuple(img.shape) == (cfg.height, cfg.width, 3)
          and bool(torch.isfinite(img).all()), "bad image")
    mean = float(img.mean())
    check(0.05 < mean < 5.0, f"image mean {mean}: black or blown out")
    return img, ms, torch.cuda.max_memory_allocated() / 2 ** 20, chunks


def render_record(label, entry, cfg, ms, peak, chunks, mean, launches):
    lanes = cfg.width * cfg.height * cfg.spp_chunk
    return {"phase": "slice3_path", "scene": label, "entry": entry,
            "sampler": "halton", "max_depth": cfg.max_depth, "spp": cfg.spp,
            "lanes_per_chunk": lanes, "chunks": chunks, "ms_per_chunk": ms,
            "Mpaths_per_s": lanes / ms / 1e3, "image_mean": mean,
            "peak_device_MiB": peak, "kernel_launches": launches}


def all_counts(ch, wb, pk):
    """Every kernel's launches since the last reset_counts; fails if a
    brute-force cast took its plain version meanwhile."""
    check_no_plain_brute("phase 8")
    return {"closest_hit": ch.launch_count,
            "brute_any_hit": ch.any_launch_count,
            "wide_closest_hit": wb.closest_launch_count,
            "wide_any_hit": wb.any_launch_count,
            "packet_closest_hit": pk.closest_launch_count,
            "packet_any_hit": pk.any_launch_count}


def camera_hits(scene, cam, cfg, smp):
    """One chunk of camera rays cast at the scene: (pixel, sample, o, d, hit,
    interaction)."""
    from gnxraytracer_tpu_torch.constants import INFINITY
    from gnxraytracer_tpu_torch.ops import samplers, trace
    from gnxraytracer_tpu_torch.scene import camera

    dev = scene.geom.vertices.device
    hw = cfg.width * cfg.height
    pixel = torch.arange(hw, dtype=torch.int32, device=dev).repeat(cfg.spp_chunk)
    sample = torch.repeat_interleave(
        torch.arange(cfg.spp_chunk, dtype=torch.int32, device=dev), hw)
    p_film, t_u, p_lens = samplers.camera_sample(smp, pixel, sample, cfg.width)
    o, d, _ = camera.generate_rays(cam, p_film, t_u, p_lens)
    hit = trace.scene_intersect(
        scene, cfg, o, d,
        torch.full((o.shape[0],), INFINITY, dtype=torch.float32, device=dev))
    return pixel, sample, o, d, hit, trace.make_interaction(scene, cfg, o, d, hit)


def depth1_rays(scene, cam, cfg, smp):
    """The rays Whitted casts at depth 1 in the mirror-mesh scene: camera
    rays (one chunk) reflected where they hit the mirror, dead (t_max = 0)
    elsewhere."""
    from gnxraytracer_tpu_torch.constants import INFINITY
    from gnxraytracer_tpu_torch.models import materials as mat_mod
    from gnxraytracer_tpu_torch.ops import trace

    _, _, o, d, hit, it = camera_hits(scene, cam, cfg, smp)
    n = o.shape[0]
    rows = mat_mod.gather_material_table(scene.materials,
                                         torch.clamp(it.mat, min=0))
    u = torch.full((n, 2), 0.5, dtype=torch.float32, device=o.device)
    smp_b = mat_mod.sample(rows, None, cfg, trace.to_local(it, it.wo), u,
                           u[:, 0])
    go = hit.hit & smp_b.specular & smp_b.valid
    o2, d2 = trace.spawn_ray(it, trace.to_world(it, smp_b.wi))
    o2 = torch.where(go[:, None], o2, o).contiguous()
    d2 = torch.where(go[:, None], d2, d).contiguous()
    return o2, d2, torch.where(go, INFINITY, 0.0).to(torch.float32).contiguous()


def depth0_shadow_rays(scene, cam, cfg, smp, li_idx):
    """The shadow rays Whitted casts at depth 0 toward light li_idx: from
    where the camera rays (one chunk) hit, to the light's Halton samples of
    that depth; lanes that hit nothing or cannot be lit are dead."""
    from gnxraytracer_tpu_torch.models import lights
    from gnxraytracer_tpu_torch.models.integrators import whitted
    from gnxraytracer_tpu_torch.ops import trace

    pixel, sample, o, _, hit, it = camera_hits(scene, cam, cfg, smp)
    dim_col = whitted._static_dim_fn(smp, pixel, sample)
    base = whitted.CAMERA_DIMS + 2 * li_idx
    u_l = torch.stack([dim_col(base), dim_col(base + 1)], dim=-1)
    lidx = torch.full((o.shape[0],), li_idx, dtype=torch.int32, device=o.device)
    ls = lights.sample_li(scene, cfg, lidx, it.p, u_l)
    so, sd, st = trace.shadow_ray(it, ls.target, ls.is_infinite)
    st = torch.where(hit.hit & (ls.pdf > 0), st, 0.0).to(torch.float32)
    return so.contiguous(), sd.contiguous(), st.contiguous()


def cast_both_walks(dev, tree, sort_key, wb, pk, rays_label, o, d, t,
                    need_hits, any_hit=False,
                    scene_label="cornell + mirror mesh"):
    """One ray set through the closest-hit (or, with any_hit, the any-hit)
    kernels of both walks of a tree (ops/bvh.BVH): each against its plain
    walk on a sub-sample, its times, its visits a live ray and its bound."""
    n = o.shape[0]
    sub = torch.arange(0, n, n // PLAIN_SUBSAMPLE, device=dev)[:PLAIN_SUBSAMPLE]
    args_sub = [x[sub].contiguous() for x in (o, d, t)]
    alive = max(int((args_sub[2] > 0).sum()), 1)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    kind = "any_hit" if any_hit else "closest_hit"
    out = {"phase": "slice3_cast", "scene": scene_label,
           "kernels": kind, "rays": rays_label, "n_rays": n,
           "alive_fraction": float((t > 0).float().mean())}
    wide = tree.wide
    hits = {}
    for label, mod, pack, lo, hi, node_ops in (
            ("packet", pk, tree.packet, tree.packet.nodes[0, 0:3],
             tree.packet.nodes[0, 3:6], OPS_PER_NODE),
            ("wide", wb, wide, wide.frame[0:3],
             wide.frame[0:3] + 255.0 * wide.frame[3:6], 8 * OPS_PER_SLAB)):
        cast = getattr(mod, f"{label}_{kind}")
        plain = getattr(mod, f"{label}_{kind}_reference")
        stats = {}
        ref = plain(pack, *args_sub, stats=stats)
        got = cast(pack, o, d, t)
        hits[label] = got
        if any_hit:
            check(torch.equal(got[sub], ref), f"{rays_label}, {label}: occ "
                  f"differs on {int((got[sub] != ref).sum())} lanes")
            check(not bool(got[t <= 0].any()),
                  f"{rays_label}, {label}: a dead lane is occluded")
            check(not need_hits or int(ref.sum()) > 0,
                  f"{rays_label}, {label}: no ray is occluded")
            err, frac = 0.0, {"occluded_fraction": float(got.float().mean())}
        else:
            err = compare_wide_hits(f"{rays_label}, {label}",
                                    type(got)(*(x[sub] for x in got)), ref,
                                    args_sub[2], need_hits=need_hits)
            frac = {"hit_fraction": float(got.hit.float().mean())}
        table_bytes = sum(x.numel() * x.element_size() for x in pack
                          if isinstance(x, torch.Tensor))
        visits = {k: stats[k] * n / len(sub)
                  for k in ("node_visits", "leaf_visits")}
        out[label] = dict(
            **cast_times(cast, pack, o, d, t, lo, hi, sort_key, flush),
            node_visits_per_live_ray=stats["node_visits"] / alive,
            leaf_rows_per_live_ray=stats["leaf_visits"] / alive,
            bound_ms=cast_bound(n, "shadow" if any_hit else "bounce",
                                table_bytes, visits, node_ops)[0],
            max_abs_err_vs_plain=err, **frac)
    if any_hit:
        check(torch.equal(hits["packet"], hits["wide"]),
              f"{rays_label}: binary and wide kernels disagree on occlusion")
        return out
    check(torch.equal(hits["packet"].hit, hits["wide"].hit)
          and torch.allclose(hits["packet"].t, hits["wide"].t, rtol=T_RTOL),
          f"{rays_label}: binary and wide kernels disagree on hits or t")
    out["tri_differs_on_lanes"] = int(
        (hits["packet"].tri != hits["wide"].tri).sum())
    return out


def phase_slice3(dev, ch, wb, pk):
    """Phase 8.  Returns nothing: every number goes out on its own line."""
    from gnxraytracer_tpu_torch import cli
    from gnxraytracer_tpu_torch.models.integrators import direct, path, whitted
    from gnxraytracer_tpu_torch.ops import samplers
    from gnxraytracer_tpu_torch.scene import presets
    from gnxraytracer_tpu_torch.scene.loaders import make_test_mesh
    from gnxraytracer_tpu_torch.scene.scene import MAT_MIRROR

    # (a) the reference application's default workload: Whitted, Cornell,
    # depth 5, Halton, 2M lanes a chunk (8 spp), 16 of its 32 spp
    scene, cam = presets.cornell_box(WIDTH, HEIGHT, device=dev)
    cfg = path.make_config(scene, WIDTH, HEIGHT, spp=16,
                           max_depth=WHITTED_DEPTH, spp_chunk=8,
                           use_pallas=True)
    smp = samplers.make_halton_sampler(16, WIDTH, HEIGHT, device=dev)
    check(not cfg.use_bvh and cfg.n_lights == 3, f"unexpected config {cfg}")
    reset = functools.partial(reset_counts, ch, wb, pk)
    img, ms, peak, chunks = timed_render(whitted, scene, cam, smp, cfg,
                                         reset=reset)
    counts = all_counts(ch, wb, pk)
    # no specular material is assigned: one depth step a chunk, its
    # closest-hit cast through kernel 1 and one shadow cast a light (the
    # skybox is skipped) through the any-hit kernel
    lit = sum(k != 5 for k in cfg.light_kind_seq)
    expect = {"closest_hit": chunks, "brute_any_hit": chunks * lit}
    check(all(counts[k] == expect.get(k, 0) for k in counts),
          f"whitted/cornell: launches {counts}, expected {expect}")
    emit(render_record("cornell", "whitted.render", cfg, ms, peak, chunks,
                       float(img.mean()), counts))

    # (b) the CLI with its default flags (Halton, depth 5) on the mesh
    # preset, as it comes (wide kernels) and through the binary ones
    lights = 2  # the two area-light triangles; the skybox is skipped
    for label, ctx, want in (
            ("wide", contextlib.nullcontext(), "wide"),
            ("GNX_WIDE_BVH=0", binary_walk(), "packet")):
        reset_counts(ch, wb, pk)
        with tempfile.TemporaryDirectory() as out_dir, ctx, \
                counting_sorts(wb) as sorts:
            out = os.path.join(out_dir, "cli.npy")
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                cli.main(["render", "--preset", "cornell-mesh", "--integrator",
                          "whitted", "--spp", "8", "--out-npy", out])
            cli_img = np.load(out)
        counts = all_counts(ch, wb, pk)
        frames = [json.loads(l) for l in log.getvalue().splitlines()
                  if l.startswith("{") and "frame_time_s" in l]
        # the preset's mesh is matte: one depth step a chunk, 2 chunks; each
        # BVH cast brute-forces the walls, kept out of the tree, first
        expect = {f"{want}_closest_hit": 2, f"{want}_any_hit": 2 * lights,
                  "closest_hit": 2, "brute_any_hit": 2 * lights}
        check(all(counts[k] == (expect.get(k, 0)) for k in counts),
              f"CLI whitted/cornell-mesh ({label}): launches {counts}")
        check(sorts[0] == 0, f"CLI whitted/cornell-mesh ({label}): the casts "
              f"sorted their rays {sorts[0]} times")
        check(cli_img.shape == (HEIGHT, WIDTH, 3) and np.isfinite(cli_img).all()
              and cli_img.mean() > 0.05, "CLI whitted: bad image")
        emit({"phase": "slice3_path", "scene": "cornell-mesh (20,480 triangles)",
              "entry": f"cli render --preset cornell-mesh --integrator whitted "
                       f"--spp 8 ({label})", "sampler": "halton",
              "max_depth": WHITTED_DEPTH, "kernel_launches": counts,
              "frame_time_s": [f["frame_time_s"] for f in frames],
              "image_mean": float(cli_img.mean())})

    # (c) the same scene with a mirror mesh: Whitted recurses to depth 5 and
    # the reflected rays start inside the mesh's tree
    t0 = time.time()
    scene, cam = presets.cornell_box(WIDTH, HEIGHT, mesh=make_test_mesh(5),
                                     bvh=True, dragon_material=MIRROR_ID,
                                     device=dev)
    build_s = time.time() - t0
    cfg = path.make_config(scene, WIDTH, HEIGHT, spp=8,
                           max_depth=WHITTED_DEPTH, spp_chunk=SPP_CHUNK)
    check(cfg.use_bvh and cfg.bvh_mode == "pallas" and MAT_MIRROR in cfg.mat_kinds,
          f"unexpected mirror-mesh configuration {cfg}")
    smp = samplers.make_halton_sampler(8, WIDTH, HEIGHT, device=dev)
    images = {}
    for mod, name, per_chunk in (
            (whitted, "whitted.render",
             (WHITTED_DEPTH, WHITTED_DEPTH * lights)),
            # per bounce 0..5: the closest hit, and estimate_direct's shadow
            # ray and BSDF-side closest hit
            (path, "path.render(fast_mis=False)",
             (2 * (WHITTED_DEPTH + 1), WHITTED_DEPTH + 1))):
        for label, ctx, want in (("wide", contextlib.nullcontext(), "wide"),
                                 ("GNX_WIDE_BVH=0", binary_walk(), "packet")):
            with ctx, counting_sorts(wb) as sorts:
                img, ms, peak, chunks = timed_render(mod, scene, cam, smp, cfg,
                                                     reset=reset)
            counts = all_counts(ch, wb, pk)
            check(sorts[0] == 0, f"{name} mirror mesh ({label}): the casts "
                  f"sorted their rays {sorts[0]} times")
            expect = {f"{want}_closest_hit": per_chunk[0] * chunks,
                      f"{want}_any_hit": per_chunk[1] * chunks,
                      "closest_hit": per_chunk[0] * chunks,
                      "brute_any_hit": per_chunk[1] * chunks}
            check(all(counts[k] == expect.get(k, 0) for k in counts),
                  f"{name} mirror mesh ({label}): launches {counts}, "
                  f"expected {expect}")
            images[(name, label)] = img
            rec = render_record("cornell + mirror mesh (20,480 triangles, "
                                f"{cfg.n_big} kept out of the tree)",
                                f"{name} ({label})", cfg, ms, peak, chunks,
                                float(img.mean()), counts)
            rec["bvh_build_s"] = build_s
            emit(rec)
        a, b = images[(name, "wide")], images[(name, "GNX_WIDE_BVH=0")]
        rel = float((a - b).abs().mean() / a.abs().mean())
        check(rel < 1e-3, f"{name}: binary and wide images differ by {rel}")

    # isolated casts through both walks: the depth-1 rays (the mesh is
    # convex and the walls are kept out of the tree, so they leave it without
    # a hit), and rays that mostly enter the tree
    n = WIDTH * HEIGHT * SPP_CHUNK
    box_lo, box_hi = scene.bvh.packet.nodes[0, 0:3], scene.bvh.packet.nodes[0, 3:6]
    gen = torch.Generator(device=dev).manual_seed(0)
    ro = box_lo + (box_hi - box_lo) * (
        torch.rand((n, 3), generator=gen, device=dev) * 1.6 - 0.3)
    rdir = torch.randn((n, 3), generator=gen, device=dev)
    rdir = rdir / torch.linalg.norm(rdir, dim=1, keepdim=True)
    t_far = torch.full((n,), 1e30, dtype=torch.float32, device=dev)
    # the first light that Whitted samples (the skybox is skipped)
    li_idx = next(i for i, k in enumerate(cfg.light_kind_seq) if k != 5)
    for rays_label, (o, d, t), need_hits, any_hit in (
            ("Whitted depth 1 (reflected off the mirror mesh)",
             depth1_rays(scene, cam, cfg, smp), False, False),
            ("incoherent: origins in 1.6x the mesh's box, any direction",
             (ro.contiguous(), rdir.contiguous(), t_far), True, False),
            (f"Whitted depth 0 shadow rays toward light {li_idx}",
             depth0_shadow_rays(scene, cam, cfg, smp, li_idx), True, True),
            ("incoherent shadow rays: the same origins and directions",
             (ro.contiguous(), rdir.contiguous(), t_far), True, True)):
        emit(cast_both_walks(dev, scene.bvh, cfg.sort_key, wb, pk,
                             rays_label, o, d, t, need_hits, any_hit))

    # one tree over every triangle of the scene, the walls and the light in
    # it: every camera ray hits something in the tree, and so do most
    # bounces (a test input, not a scene feature)
    c_scene, c_cam, c_cfg, tree, light = closed_tree_setup(dev)
    check(int((tree.packet.tid >= 0).sum()) == c_cfg.n_tris,
          "the closed tree does not hold every triangle")
    c_rays = path_rays(dev, c_scene, c_cam, c_cfg, light=light)
    label = f"closed tree: the same scene, all {c_cfg.n_tris} triangles in one tree"
    for rays_label, any_hit in (("camera", False), ("bounce", False),
                                (f"shadow toward light {light}", True)):
        rec = cast_both_walks(dev, tree, c_cfg.sort_key, wb, pk, rays_label,
                              *c_rays[rays_label.split()[0]], True, any_hit,
                              scene_label=label)
        check(rays_label != "camera" or rec["packet"]["hit_fraction"] == 1.0,
              "closed tree: a camera ray left the scene")
        emit(rec)

    # (d) direct lighting, both strategies
    scene, cam = presets.cornell_box(WIDTH, HEIGHT, device=dev)
    cfg = path.make_config(scene, WIDTH, HEIGHT, spp=8,
                           max_depth=WHITTED_DEPTH, spp_chunk=SPP_CHUNK,
                           use_pallas=True)
    smp = samplers.make_halton_sampler(8, WIDTH, HEIGHT, device=dev)
    for strategy, lights_sampled in (("one", 1), ("all", cfg.n_lights)):
        img, ms, peak, chunks = timed_render(direct, scene, cam, smp, cfg,
                                             strategy, reset=reset)
        counts = all_counts(ch, wb, pk)
        # per depth: the cast of the depth, and for each light sampled
        # estimate_direct's shadow cast and BSDF-side cast
        expect = {"closest_hit": WHITTED_DEPTH * (1 + lights_sampled) * chunks,
                  "brute_any_hit": WHITTED_DEPTH * lights_sampled * chunks}
        check(all(counts[k] == expect.get(k, 0) for k in counts),
              f"direct({strategy}): launches {counts}, expected {expect}")
        emit(render_record("cornell", f"direct.render(strategy={strategy!r})",
                           cfg, ms, peak, chunks, float(img.mean()), counts))


def count_dispatched_ops(fn):
    """How many operators PyTorch dispatches (views included) while fn()
    runs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with OpCount() as counter:
        fn()
    torch.cuda.synchronize()
    return counter.n


def profile_chunk(label, scene, cam, cfg, smp, mod=None):
    """Where one chunk spends its time: device-busy share, the top kernels
    by device time (torch.profiler) and the operators dispatched.  mod: the
    integrator module (default: path)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gnxraytracer_tpu_torch.models.integrators import path

    mod = mod or path
    n_spp = cfg.spp_chunk
    chunk = lambda start: mod.render_chunk(scene, cam, smp, cfg, start, n_spp)
    chunk(0)
    torch.cuda.synchronize()
    t0 = time.time()
    chunk(n_spp)
    torch.cuda.synchronize()
    wall_plain = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        chunk(n_spp)
        torch.cuda.synchronize()
        wall_prof = (time.time() - t0) * 1e3
    # kernel-level events only: an operator's row repeats the device time of
    # the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    chunk_ops = count_dispatched_ops(lambda: chunk(n_spp))
    ours = [r for r in rows if any(k in r[0] for k in KERNEL_NAMES)]
    emit({"phase": "profile", "scene": label,
          "lanes": cfg.width * cfg.height * n_spp, "chunk_wall_ms": wall_plain,
          "chunk_wall_ms_profiled": wall_prof,
          "device_busy_ms": busy if rows else "not measured",
          # against the unprofiled wall time: the profiler slows the host
          "device_idle_share": (1.0 - busy / wall_plain) if rows else "not measured",
          "kernel_launches_in_chunk": sum(r[2] for r in rows),
          "dispatched_ops_in_chunk": chunk_ops,
          "hand_written_kernels": [{"name": k[:80], "ms": ms, "count": c}
                                   for k, ms, c in ours],
          "top_kernels": [{"name": k[:80], "ms": ms, "count": c}
                          for k, ms, c in rows[:12]]})


def phase_profile(dev, mesh):
    """torch.profiler breakdown of one chunk of each main path, and the
    plain pieces of the Cornell chunk timed or counted alone."""
    from gnxraytracer_tpu_torch.constants import INFINITY
    from gnxraytracer_tpu_torch.ops import samplers, trace

    scene, cam, cfg, smp = main_path_setup(dev)
    profile_chunk("cornell", scene, cam, cfg, smp)
    _, o, d, alive, _ = main_path_rays(dev)
    t_all = torch.full((o.shape[0],), INFINITY, dtype=torch.float32, device=dev)
    plain = cfg._replace(use_pallas=False)
    shadow_ms, shadow_ops = {}, {}
    for label, c in (("kernel", cfg), ("plain", plain)):
        cast = lambda: trace.scene_occluded(scene, c, o, d, t_all)
        shadow_ms[label] = time_cuda(cast, 3)
        shadow_ops[label] = count_dispatched_ops(cast)
    zeros = torch.zeros_like(alive, dtype=torch.int32)
    dims_ops = count_dispatched_ops(
        lambda: samplers.sample_bounce_dims(smp, zeros, zeros, 5, 8, 85))
    emit({"phase": "profile", "scene": "cornell, pieces alone",
          "shadow_cast_1M_rays_ms": shadow_ms,
          "dispatched_ops": {"one_shadow_cast": shadow_ops,
                             "one_bounce_sampler_dims": dims_ops}})
    profile_chunk("envmap_mesh", *mesh[:4])

    # one Whitted chunk of each kind of phase 8
    from gnxraytracer_tpu_torch.models.integrators import path, whitted
    from gnxraytracer_tpu_torch.scene import presets
    from gnxraytracer_tpu_torch.scene.loaders import make_test_mesh

    scene, cam = presets.cornell_box(WIDTH, HEIGHT, device=dev)
    cfg = path.make_config(scene, WIDTH, HEIGHT, spp=16,
                           max_depth=WHITTED_DEPTH, spp_chunk=8, use_pallas=True)
    smp = samplers.make_halton_sampler(16, WIDTH, HEIGHT, device=dev)
    profile_chunk("cornell, whitted, halton", scene, cam, cfg, smp, whitted)
    scene, cam = presets.cornell_box(WIDTH, HEIGHT, mesh=make_test_mesh(5),
                                     bvh=True, dragon_material=MIRROR_ID,
                                     device=dev)
    cfg = path.make_config(scene, WIDTH, HEIGHT, spp=8,
                           max_depth=WHITTED_DEPTH, spp_chunk=SPP_CHUNK)
    smp = samplers.make_halton_sampler(8, WIDTH, HEIGHT, device=dev)
    profile_chunk("cornell + mirror mesh, whitted, halton, wide kernels",
                  scene, cam, cfg, smp, whitted)
    with binary_walk():
        profile_chunk("cornell + mirror mesh, whitted, halton, binary kernels",
                      scene, cam, cfg, smp, whitted)


def block_mean8(img, b=8):
    """Means of the b x b blocks of an (H, W, C) image."""
    hh, ww, c = img.shape
    return img[:hh // b * b, :ww // b * b].reshape(
        hh // b, b, ww // b, b, c).mean((1, 3))


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
    berr = float(np.abs(block_mean8(ours) - block_mean8(ref)).mean()
                 / ref.mean())
    merr = float(abs(ours.mean() - ref.mean()) / ref.mean())
    emit({"phase": "golden", "reference": "tests/golden/ref_path_cornell.npz",
          "block8_rel_err": berr, "limit": 0.025, "mean_rel_err": merr,
          "mean_limit": 0.02})
    check(berr < 0.025, f"golden: block8 error {berr}")
    check(merr < 0.02, f"golden: mean error {merr}")


def phase_goldens_halton(dev):
    """Phase 9: the three Cornell goldens through this slice's integrators,
    32 spp Halton with their default configuration, on the card."""
    from gnxraytracer_tpu_torch.models.integrators import direct, path, whitted
    from gnxraytracer_tpu_torch.ops import samplers
    from gnxraytracer_tpu_torch.scene import presets

    mods = {"path": path, "direct": direct, "whitted": whitted}

    for name in ("ref_whitted_cornell", "ref_direct_cornell", "ref_path_cornell"):
        z = np.load(os.path.join(HERE, "tests", "golden", f"{name}.npz"))
        ref, meta = z["image"], json.loads(str(z["meta"]))
        w, h, spp = meta["w"], meta["h"], 32
        scene, cam = presets.cornell_box(w, h, sigma=meta["sigma"],
                                         skybox=bool(meta["skybox"]), device=dev)
        cfg = path.make_config(scene, w, h, spp=spp,
                               max_depth=meta["max_depth"], spp_chunk=32,
                               use_pallas=True)
        smp = samplers.make_halton_sampler(spp, w, h, device=dev)
        ours = mods[meta["integrator"]].render(scene, cam, smp, cfg).cpu().numpy()
        check(np.isfinite(ours).all(), f"{name}: the image is not finite")
        berr = float(np.abs(block_mean8(ours) - block_mean8(ref)).mean()
                     / ref.mean())
        merr = float((np.abs(ours.mean((0, 1)) - ref.mean((0, 1)))
                      / ref.mean()).max())
        emit({"phase": "golden", "reference": f"tests/golden/{name}.npz",
              "integrator": meta["integrator"], "sampler": "halton", "spp": spp,
              "width": w, "height": h, "max_depth": meta["max_depth"],
              "block8_rel_err": berr, "limit": 0.035,
              "channel_mean_rel_err": merr, "mean_limit": 0.03})
        check(berr < 0.035, f"{name}: block8 error {berr}")
        check(merr < 0.03, f"{name}: channel mean error {merr}")


# ---------------------------------------------------------------------------
# phase 10: gradients and the train step
# ---------------------------------------------------------------------------

GRAD_DEPTH = 8
GRAD_SPP_CHUNK = 4      # 500x500 x 4 = 1M lanes a step
GRAD_STEPS = 3          # timed steps, after one warm-up


def timed_steps(step, params, scene, cam, smp, target, lr, steps=GRAD_STEPS):
    """One warm-up step and `steps` timed ones (each between CUDA events),
    all from the same params.  Returns (loss, new_params, stats of the last
    step, median forward / backward / step ms, peak bytes over the steps)."""
    fwd, bwd, tot = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps + 1):
        stats = {}
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss, new = step(params, scene, cam, smp, target, lr=lr, stats=stats)
        b.record()
        torch.cuda.synchronize()
        if i:
            fwd.append(stats["forward_ms"])
            bwd.append(stats["backward_ms"])
            tot.append(a.elapsed_time(b))
    return (loss, new, stats, float(np.median(fwd)), float(np.median(bwd)),
            float(np.median(tot)), torch.cuda.max_memory_allocated())


def step_record(label, cfg, loss, stats, fwd, bwd, tot, peak, counts, moved):
    lanes = cfg.width * cfg.height * cfg.spp_chunk
    return {"phase": "gradients", "what": label, "width": cfg.width,
            "height": cfg.height, "max_depth": cfg.max_depth,
            "spp_chunk": cfg.spp_chunk, "lanes": lanes,
            "passes": stats["passes"], "lanes_per_pass": stats["lanes"],
            "loss": float(loss), "forward_ms": fwd, "backward_ms": bwd,
            "step_ms": tot, "peak_device_MiB": peak / 2 ** 20,
            "peak_bytes_per_lane_of_largest_pass": peak / max(stats["lanes"]),
            "kernel_launches": counts, "moved": moved}


def check_step(label, params, new, stats, want_moved):
    for k, g in stats["grads"].items():
        check(g is not None and bool(torch.isfinite(g).all()),
              f"{label}: the gradient of {k} is not finite")
    for k in params:
        check(bool(torch.isfinite(new[k]).all()),
              f"{label}: {k} is not finite after the step")
    moved = {k: float((new[k] - params[k]).abs().max()) for k in params}
    for k in want_moved:
        check(moved[k] > 0, f"{label}: {k} did not move")
    return moved


def expected_step_launches(cfg, passes, steps, bvh):
    """Launches a train step makes: each bounce of the faithful estimator
    (max_depth + 1 of them, every lane cast, dead ones with t_max = 0) casts
    the closest hit, the light sample's shadow ray and the BSDF sample's
    re-intersection.  Through a BVH every cast brute-forces the big
    triangles kept out of the tree first."""
    closest = 2 * (cfg.max_depth + 1) * passes * steps
    shadow = (cfg.max_depth + 1) * passes * steps
    if bvh:
        return {"closest_hit": closest, "brute_any_hit": shadow,
                "wide_closest_hit": closest, "wide_any_hit": shadow,
                "packet_closest_hit": 0, "packet_any_hit": 0}
    return {"closest_hit": closest, "brute_any_hit": shadow,
            "wide_closest_hit": 0, "wide_any_hit": 0,
            "packet_closest_hit": 0, "packet_any_hit": 0}


def oracle_fd(name):
    """d(mean image)/d(theta) of the reference renderer: the central
    difference of its two renders in tests/golden/<name>.npz."""
    z = np.load(os.path.join(HERE, "tests", "golden", f"{name}.npz"))
    return float(((z["plus"] - z["minus"]) / (2 * float(z["h"]))).mean())


def golden_grad(dev, name, make_scene, scale, spp=256, chunk=32, w=32, h=32):
    """The port's AD of d(mean image)/d(theta) at theta = 1 (theta = the
    golden's base value for kd/le/sigma), 32x32, 256 spp Halton, depth 8,
    each 32-spp chunk differentiated on its own and the gradients summed,
    as tests/test_reference_parity.py computes it."""
    from gnxraytracer_tpu_torch.models.integrators import path
    from gnxraytracer_tpu_torch.ops import samplers

    scene, cam = make_scene(w, h)
    cfg = path.make_config(scene, w, h, spp=spp, max_depth=8, spp_chunk=chunk,
                           use_pallas=True)
    smp = samplers.make_halton_sampler(spp, w, h, device=dev)
    theta0, scaled = scale(scene)
    theta = torch.tensor(theta0, device=dev, requires_grad=True)
    for s in range(0, spp, chunk):
        img = path.render_chunk(scaled(scene, theta), cam, smp, cfg, s, chunk)
        (torch.mean(img) / spp).backward()
    return float(theta.grad)


def gradient_goldens(dev):
    """(golden name, scene maker (w, h), scale, rtol, sign of the gradient or
    0) of each gradient golden: scale(scene) -> (theta0, scaled(scene,
    theta)), the scene with the golden's parameter set from theta, as
    tests/test_reference_parity.py sets it."""
    from gnxraytracer_tpu_torch.scene import presets
    from gnxraytracer_tpu_torch.scene.scene import MAT_DISNEY

    def kd_white(s):
        return 1.0, lambda s, t: s._replace(materials=s.materials._replace(
            kd=s.materials.kd * torch.where(
                torch.arange(s.materials.kd.shape[0], device=dev) == 0,
                t, torch.ones((), device=dev))[:, None]))

    def le(s):
        return 5.0, lambda s, t: s._replace(lights=s.lights._replace(
            emit=torch.ones_like(s.lights.emit) * t))

    def sigma(s):
        return 60.0, lambda s, t: s._replace(materials=s.materials._replace(
            sigma=torch.ones_like(s.materials.sigma) * t))

    def disney_rough(s):
        is_d = s.materials.kind == MAT_DISNEY

        def scaled(s, t):
            m = s.materials
            return s._replace(materials=m._replace(
                rough_u=torch.where(is_d, m.rough_u * t, m.rough_u),
                rough_v=torch.where(is_d, m.rough_v * t, m.rough_v)))
        return 1.0, scaled

    def cornell(sig):
        return lambda w, h: presets.cornell_box(w, h, sigma=sig, skybox=False,
                                                device=dev)

    goldens = (("ref_grad_kd", cornell(0.0), kd_white, 0.05, 1),
               ("ref_grad_le", cornell(0.0), le, 0.05, 1),
               ("ref_grad_sigma", cornell(60.0), sigma, 0.05, -1),
               ("ref_grad_disney_rough",
                lambda w, h: presets.cornell_gmd(w, h, sigma=0.0, device=dev),
                disney_rough, 0.25, 0))
    return goldens


def phase_gradients(dev, ch, wb, pk, mesh):
    """Phase 10: the train step at full width on the Cornell box and the
    mesh scene, passes against one pass, AD against FD and the reference
    renderer's gradient goldens on the card, and an optimisation that
    descends."""
    from gnxraytracer_tpu_torch.models.integrators import path
    from gnxraytracer_tpu_torch.ops import samplers
    from gnxraytracer_tpu_torch.parallel import sharding
    from gnxraytracer_tpu_torch.scene import presets

    total_bytes = torch.cuda.get_device_properties(dev).total_memory

    # (a) Cornell at full width: 1M lanes, Halton, depth 8, the brute-force
    # kernels; one step on kd and light_emit toward the true image from a
    # perturbed kd
    scene, cam = presets.cornell_box(WIDTH, HEIGHT, device=dev)
    cfg = path.make_config(scene, WIDTH, HEIGHT, spp=GRAD_SPP_CHUNK,
                           max_depth=GRAD_DEPTH, spp_chunk=GRAD_SPP_CHUNK,
                           use_pallas=True)
    smp = samplers.make_halton_sampler(GRAD_SPP_CHUNK, WIDTH, HEIGHT,
                                       device=dev)
    with torch.no_grad():
        target = path.render(scene, cam, smp, cfg)
    full = sharding.extract_params(scene)
    params = {"kd": full["kd"] * 0.8, "light_emit": full["light_emit"]}
    step = sharding.make_train_step(cfg)
    reset_counts(ch, wb, pk)
    loss, new, stats, fwd, bwd, tot, peak = timed_steps(
        step, params, scene, cam, smp, target, lr=1.0)
    check_no_plain_brute("phase 10 cornell train step")
    counts = all_counts(ch, wb, pk)
    want = expected_step_launches(cfg, stats["passes"], GRAD_STEPS + 1, False)
    check(counts == want, f"cornell train step: launches {counts}, "
          f"expected {want}")
    check(bool(torch.isfinite(loss)), f"cornell train step: loss {loss}")
    moved = check_step("cornell train step", params, new, stats,
                       ("kd", "light_emit"))
    check(peak < total_bytes, "cornell train step: peak over the card")
    emit(step_record("train step, cornell (kd, light_emit)", cfg, loss, stats,
                     fwd, bwd, tot, peak, counts, moved))
    del target, new, stats, step
    torch.cuda.empty_cache()

    # (b) the mesh scene at full width: 1M lanes, Sobol', depth 8, every
    # class of extract_params, passes from the default budget
    mscene, mcam = mesh[0], mesh[1]
    mcfg = path.make_config(mscene, WIDTH, HEIGHT, spp=GRAD_SPP_CHUNK,
                            max_depth=GRAD_DEPTH, spp_chunk=GRAD_SPP_CHUNK)
    check(mcfg.use_bvh and mcfg.bvh_mode == "pallas" and mcfg.has_env
          and mcfg.has_textures, f"mesh train step: unexpected config {mcfg}")
    msmp = samplers.make_sobol_sampler(GRAD_SPP_CHUNK, device=dev)
    mparams = sharding.extract_params(mscene)
    with torch.no_grad():
        mtarget = torch.cat([
            sharding.pass_image(mscene, mcam, msmp, mcfg, torch.arange(
                p0, p1, dtype=torch.int32, device=dev), 0)
            for p0, p1 in sharding.pixel_passes(
                mcfg, sharding.default_lane_budget(mcfg, dev))])
    mparams = dict(mparams, kd=mparams["kd"] * 0.8)
    mstep = sharding.make_train_step(mcfg)
    budget = sharding.default_lane_budget(mcfg, dev)
    reset_counts(ch, wb, pk)
    loss, new, stats, fwd, bwd, tot, peak = timed_steps(
        mstep, mparams, mscene, mcam, msmp, mtarget, lr=1.0)
    check_no_plain_brute("phase 10 mesh train step")
    counts = all_counts(ch, wb, pk)
    want = expected_step_launches(mcfg, stats["passes"], GRAD_STEPS + 1, True)
    check(counts == want, f"mesh train step: launches {counts}, "
          f"expected {want}")
    check(bool(torch.isfinite(loss)), f"mesh train step: loss {loss}")
    moved = check_step("mesh train step", mparams, new, stats,
                       ("kd", "env_image", "tex_atlas"))
    check(peak < total_bytes, f"mesh train step: peak {peak} over the card")
    reserved = torch.cuda.max_memory_reserved()
    rec = step_record("train step, envmap_mesh (every class)", mcfg, loss,
                      stats, fwd, bwd, tot, peak, counts, moved)
    rec.update(lane_budget=budget, stated_bytes_per_lane=sharding.lane_bytes(
        mcfg), card_total_MiB=total_bytes / 2 ** 20,
        peak_reserved_MiB=reserved / 2 ** 20)
    emit(rec)
    del mtarget, new, stats, mstep
    torch.cuda.empty_cache()

    # (c) passes are the same function: Cornell 64x64, 8 spp, one pass
    # against four
    w = h = 64
    sc, cm = presets.cornell_box(w, h, device=dev)
    c64 = path.make_config(sc, w, h, spp=8, max_depth=GRAD_DEPTH, spp_chunk=8,
                           use_pallas=True)
    s64 = samplers.make_halton_sampler(8, w, h, device=dev)
    with torch.no_grad():
        t64 = path.render(sc, cm, s64, c64)
    p64 = sharding.extract_params(sc)
    p64 = dict(p64, kd=p64["kd"] * 0.7)
    grads = {}
    for n_pass in (1, 4):
        stats = {}
        sharding.make_train_step(c64, lane_budget=w * h * 8 // n_pass)(
            p64, sc, cm, s64, t64, stats=stats)
        check(stats["passes"] == n_pass, f"passes: {stats['passes']}")
        grads[n_pass] = stats["grads"]
    worst = {}
    for k, g1 in grads[1].items():
        g4 = grads[4][k]
        scale_k = float(g1.abs().max())
        err = (g4 - g1).abs() - 1e-4 * g1.abs()
        worst[k] = float((g4 - g1).abs().max()) / scale_k if scale_k else 0.0
        check(bool((err <= 1e-6 * scale_k).all()),
              f"passes: the gradient of {k} differs between one and four "
              f"passes beyond rtol 1e-4 (largest element {scale_k})")
    emit({"phase": "gradients", "what": "one pass against four, cornell 64x64, "
          "8 spp, depth 8", "rtol": 1e-4,
          "atol": "1e-6 x the class's largest element",
          "max_abs_diff_over_class_max": worst})

    # (d) AD against central FD through the kernels: tests/test_gradients.py's
    # setup (Cornell 16x16, depth 3, 32 spp, Halton), the same stream both
    # sides
    w = h = 16
    sc, cm = presets.cornell_box(w, h, device=dev)
    c16 = path.make_config(sc, w, h, spp=32, max_depth=3, spp_chunk=32,
                           use_pallas=True)
    s16 = samplers.make_halton_sampler(32, w, h, device=dev)

    def mean_img(kd=None, emit_=None):
        mats = sc.materials if kd is None else sc.materials._replace(kd=kd)
        lights = sc.lights if emit_ is None else sc.lights._replace(emit=emit_)
        img = path.render_chunk(sc._replace(materials=mats, lights=lights),
                                cm, s16, c16, 0, 32)
        return torch.mean(img / 32)

    reset_counts(ch, wb, pk)
    fd_rec = {}
    for key, idx, eps, rtol, atol in (("kd", (0, 0), 1e-2, 0.08, 1e-5),
                                      ("light_emit", (0, 1), 1e-2, 2e-2, 0.0)):
        x0 = (sc.materials.kd if key == "kd" else sc.lights.emit).clone()
        x = x0.clone().requires_grad_(True)
        arg = (lambda v: {"kd": v}) if key == "kd" else \
            (lambda v: {"emit_": v})
        (g,) = torch.autograd.grad(mean_img(**arg(x)), x)
        e = torch.zeros_like(x0)
        e[idx] = eps
        with torch.no_grad():
            fd = float((mean_img(**arg(x0 + e)) - mean_img(**arg(x0 - e)))
                       / (2 * eps))
        ad = float(g[idx])
        fd_rec[key] = {"ad": ad, "fd": fd, "rtol": rtol, "atol": atol}
        check(bool(torch.isfinite(g).all()), f"AD vs FD: {key} not finite")
        check(abs(ad - fd) <= atol + rtol * abs(fd) and ad > 0,
              f"AD vs FD: {key}{idx} ad {ad} fd {fd}")
    check_no_plain_brute("phase 10 AD vs FD")
    counts = all_counts(ch, wb, pk)
    check(counts["closest_hit"] > 0 and counts["brute_any_hit"] > 0,
          f"AD vs FD: the kernels did not launch {counts}")
    emit({"phase": "gradients", "what": "AD against central FD, cornell "
          "16x16, 32 spp, depth 3, halton", "cases": fd_rec,
          "kernel_launches": counts})

    # (e) optimisation progress: the JAX package's multichip dry run's third
    # scene (Cornell 64x64, 8 spp, depth 3, kd scaled by 0.55): some lr of
    # (8, 2, 32, 0.5) cuts the loss by 30% in 3 steps
    w = h = 64
    sc, cm = presets.cornell_box(w, h, device=dev)
    c3 = path.make_config(sc, w, h, spp=8, max_depth=3, spp_chunk=8,
                          use_pallas=True)
    s3 = samplers.make_halton_sampler(256, w, h, device=dev)
    with torch.no_grad():
        t3 = path.render(sc, cm, s3, c3)
    p3 = sharding.extract_params(sc)
    step3 = sharding.make_train_step(c3)
    tried = {}
    for lr in (8.0, 2.0, 32.0, 0.5):
        params = dict(p3, kd=p3["kd"] * 0.55)
        losses = []
        for _ in range(3):
            loss, params = step3(params, sc, cm, s3, t3, lr=lr)
            losses.append(float(loss))
        tried[lr] = losses
        if losses[-1] < losses[0] * 0.7:
            break
    emit({"phase": "gradients", "what": "optimisation, cornell 64x64, 8 spp, "
          "depth 3, kd x 0.55", "losses_by_lr": {str(k): v
                                                  for k, v in tried.items()}})
    check(any(v[-1] < v[0] * 0.7 for v in tried.values()),
          f"optimisation: no lr cut the loss by 30% in 3 steps: {tried}")

    # (f) the reference renderer's gradient goldens
    for name, make_scene, scale, rtol, sign in gradient_goldens(dev):
        reset_counts(ch, wb, pk)
        t0 = time.time()
        ad = golden_grad(dev, name, make_scene, scale)
        secs = time.time() - t0
        check_no_plain_brute(f"phase 10 {name}")
        counts = all_counts(ch, wb, pk)
        check_gradient_golden(name, ad, rtol, secs, counts)
        check(sign == 0 or np.sign(ad) == sign, f"{name}: sign of {ad}")
        check(counts["closest_hit"] > 0 and counts["brute_any_hit"] > 0,
              f"{name}: the kernels did not launch {counts}")


# the JAX package's own AD of each gradient golden (tests/golden/
# jax_grad_ad.json, written by tests/jax_gradient_goldens.py), and how close
# the port's AD must come to it where the JAX package fails the golden
JAX_AD_RTOL = 0.05


def check_gradient_golden(name, ad, rtol, secs, counts):
    """The port's AD against the reference renderer's central FD within
    rtol, where the JAX package's AD passes that golden; where the JAX
    package's AD fails it, against the JAX package's AD within JAX_AD_RTOL
    (the port computes the JAX package's estimator, and a golden the
    reference implementation misses is a fault of that estimator, listed
    in ROADMAP.md)."""
    with open(os.path.join(HERE, "tests", "golden", "jax_grad_ad.json")) as f:
        jax_rec = json.load(f)[name]
    fd = oracle_fd(name)
    rel = abs(ad - fd) / abs(fd)
    rel_jax = abs(ad - jax_rec["jax_ad"]) / abs(jax_rec["jax_ad"])
    jax_passes = jax_rec["jax_rel_err"] < rtol
    emit({"phase": "gradients", "what": "golden", "reference":
          f"tests/golden/{name}.npz", "ad": ad, "oracle_fd": fd,
          "rel_err": rel, "rtol": rtol, "jax_ad": jax_rec["jax_ad"],
          "jax_rel_err": jax_rec["jax_rel_err"], "rel_to_jax_ad": rel_jax,
          "gate": "oracle" if jax_passes else
          f"the JAX package's AD, rtol {JAX_AD_RTOL}", "seconds": secs,
          "kernel_launches": counts})
    check(np.isfinite(ad), f"{name}: ad {ad}")
    if jax_passes:
        check(rel < rtol, f"{name}: ad {ad} fd {fd}")
    else:
        check(rel_jax < JAX_AD_RTOL,
              f"{name}: ad {ad}, the JAX package's {jax_rec['jax_ad']}")


# ---------------------------------------------------------------------------
# phase 11: participating media and the volumetric path integrator
# ---------------------------------------------------------------------------

VOL_DEPTH = 8


def volpath_golden(dev):
    """volpath.render of cornell_homogeneous against the reference
    renderer's tests/golden/ref_volpath_hom.npz at its size and depth, 64 spp
    Halton in 32-spp chunks: (block-8 error, largest channel-mean error),
    both relative to the golden's mean."""
    from gnxraytracer_tpu_torch.models.integrators import volpath
    from gnxraytracer_tpu_torch.ops import samplers
    from gnxraytracer_tpu_torch.scene import presets

    z = np.load(os.path.join(HERE, "tests", "golden", "ref_volpath_hom.npz"))
    ref, meta = z["image"], json.loads(str(z["meta"]))
    w, h, spp = meta["w"], meta["h"], 64
    scene, cam = presets.cornell_homogeneous(w, h, device=dev)
    cfg = volpath.make_config(scene, w, h, spp=spp,
                              max_depth=meta["max_depth"], spp_chunk=32,
                              use_pallas=True)
    smp = samplers.make_halton_sampler(spp, w, h, device=dev)
    ours = volpath.render(scene, cam, smp, cfg).cpu().numpy()
    check(np.isfinite(ours).all(), "ref_volpath_hom: the image is not finite")
    berr = float(np.abs(block_mean8(ours) - block_mean8(ref)).mean()
                 / ref.mean())
    merr = float((np.abs(ours.mean((0, 1)) - ref.mean((0, 1)))
                  / ref.mean()).max())
    return berr, merr


def medium_grad_golden(dev, spp=256, chunk=32, w=32, h=32):
    """The port's AD of d(mean image)/d(theta), theta scaling sigma_a and
    sigma_s of cornell_homogeneous, at theta = 1 (32x32, 256 spp Halton,
    depth 8, volpath.render_chunk, each chunk differentiated on its own),
    and the reference renderer's central FD (ref_grad_med_sigma)."""
    from gnxraytracer_tpu_torch.models.integrators import volpath
    from gnxraytracer_tpu_torch.ops import samplers
    from gnxraytracer_tpu_torch.scene import presets

    scene, cam = presets.cornell_homogeneous(w, h, device=dev)
    cfg = volpath.make_config(scene, w, h, spp=spp, max_depth=8,
                              spp_chunk=chunk, use_pallas=True)
    smp = samplers.make_halton_sampler(spp, w, h, device=dev)
    theta = torch.tensor(1.0, device=dev, requires_grad=True)
    for s in range(0, spp, chunk):
        sc = scene._replace(media=scene.media._replace(
            sigma_a=scene.media.sigma_a * theta,
            sigma_s=scene.media.sigma_s * theta))
        img = volpath.render_chunk(sc, cam, smp, cfg, s, chunk)
        (torch.mean(img) / spp).backward()
    return float(theta.grad), oracle_fd("ref_grad_med_sigma")


def phase_volpath(dev, ch, wb, pk):
    """Phase 11: volpath.render of cornell_homogeneous at full width, the
    volumetric golden and gradient golden, and a train step that moves the
    medium classes."""
    from gnxraytracer_tpu_torch.models.integrators import volpath
    from gnxraytracer_tpu_torch.ops import samplers
    from gnxraytracer_tpu_torch.parallel import sharding
    from gnxraytracer_tpu_torch.scene import presets

    # (a) volpath.render at 500x500, depth 8, Halton, 1M lanes a chunk
    scene, cam = presets.cornell_homogeneous(WIDTH, HEIGHT, device=dev)
    cfg = volpath.make_config(scene, WIDTH, HEIGHT, spp=SPP,
                              max_depth=VOL_DEPTH, spp_chunk=SPP_CHUNK,
                              use_pallas=True, count_rays=True)
    smp = samplers.make_halton_sampler(SPP, WIDTH, HEIGHT, device=dev)
    check(cfg.has_media and cfg.tr_walk_segments == 4 and not cfg.use_bvh,
          f"volpath: unexpected config {cfg}")
    volpath.render_chunk(scene, cam, smp, cfg, 0, SPP_CHUNK)  # warm-up
    torch.cuda.synchronize()
    reset_counts(ch, wb, pk)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    img = volpath.render(scene, cam, smp, cfg)
    torch.cuda.synchronize()
    wall = time.time() - t0
    check_no_plain_brute("phase 11 volpath.render")
    counts = all_counts(ch, wb, pk)
    chunks = SPP // SPP_CHUNK
    check(counts["closest_hit"] > 0 and counts["brute_any_hit"] == 0
          and counts["wide_closest_hit"] == 0
          and counts["packet_closest_hit"] == 0,
          f"volpath: launches {counts}: every cast is a closest hit through "
          "kernel 1 (the shadow rays walk the medium shells by closest hits)")
    check(tuple(img.shape) == (HEIGHT, WIDTH, 3)
          and bool(torch.isfinite(img).all()), "volpath: bad image")
    mean = float(img.mean())
    check(0.05 < mean < 5.0, f"volpath: image mean {mean}")
    emit({"phase": "volpath", "scene": "cornell_homogeneous",
          "entry": "volpath.render", "width": WIDTH, "height": HEIGHT,
          "max_depth": VOL_DEPTH, "spp": SPP, "lanes_per_chunk":
          WIDTH * HEIGHT * SPP_CHUNK, "chunks": chunks,
          "ms_per_chunk": wall / chunks * 1e3,
          "Mpaths_per_s": WIDTH * HEIGHT * SPP / wall / 1e6,
          "image_mean": mean, "kernel_launches": counts,
          "peak_device_MiB": torch.cuda.max_memory_allocated() / 2 ** 20})

    # (b) the reference renderer's volumetric golden
    reset_counts(ch, wb, pk)
    berr, merr = volpath_golden(dev)
    check_no_plain_brute("phase 11 ref_volpath_hom")
    emit({"phase": "volpath", "what": "golden", "reference":
          "tests/golden/ref_volpath_hom.npz", "sampler": "halton", "spp": 64,
          "block8_rel_err": berr, "limit": 0.025, "channel_mean_rel_err": merr,
          "mean_limit": 0.02, "kernel_launches": all_counts(ch, wb, pk)})
    check(berr < 0.025, f"ref_volpath_hom: block8 error {berr}")
    check(merr < 0.02, f"ref_volpath_hom: channel mean error {merr}")

    # (c) the medium-sigma gradient golden
    reset_counts(ch, wb, pk)
    t0 = time.time()
    ad, _fd = medium_grad_golden(dev)
    check_no_plain_brute("phase 11 ref_grad_med_sigma")
    check_gradient_golden("ref_grad_med_sigma", ad, 0.08, time.time() - t0,
                          all_counts(ch, wb, pk))

    # (d) one train step with volpath's estimator on every class, from
    # doubled absorption toward the true image: the medium classes move
    w = h = 128
    sc, cm = presets.cornell_homogeneous(w, h, device=dev)
    c = volpath.make_config(sc, w, h, spp=SPP_CHUNK, max_depth=VOL_DEPTH,
                            spp_chunk=SPP_CHUNK, use_pallas=True)
    s = samplers.make_halton_sampler(SPP_CHUNK, w, h, device=dev)
    with torch.no_grad():
        target = volpath.render(sc, cm, s, c)
    p = sharding.extract_params(sc)
    p = dict(p, med_sigma_a=p["med_sigma_a"] * 2.0)
    step = sharding.make_train_step(c, integrator="volpath")
    reset_counts(ch, wb, pk)
    loss, new, stats, fwd, bwd, tot, peak = timed_steps(
        step, p, sc, cm, s, target, lr=1.0, steps=1)
    check_no_plain_brute("phase 11 train step")
    counts = all_counts(ch, wb, pk)
    check(bool(torch.isfinite(loss)), f"volpath train step: loss {loss}")
    moved = check_step("volpath train step", p, new, stats,
                       ("med_sigma_a", "med_sigma_s", "med_g"))
    emit(step_record("train step, cornell_homogeneous, volpath (every class)",
                     c, loss, stats, fwd, bwd, tot, peak, counts, moved))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from gnxraytracer_tpu_torch import native
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
        t0 = time.time()
        native.get_lib()  # g++, while nvcc runs
        native_s = time.time() - t0
        for hd in handles:
            build.finish_build(hd)
        emit({"phase": "build", "nvcc": build.find_nvcc(),
              "native_bvh_builder": {"compiler": "g++",
                                     "flags": " ".join(native.GXX_FLAGS),
                                     "seconds": native_s},
              "flags": " ".join(build.NVCC_FLAGS),
              "sources": {n: {"seconds": build.build_log[n]["seconds"],
                              "cached": build.build_log[n]["cached"],
                              "ptxas": build.build_log[n]["ptxas"].strip(),
                              "entries": ptxas_summary(build.build_log[n]["ptxas"])}
                          for n in names}})

        ch, record, rec_brute_any = phase_kernels(dev)
        count_plain_calls(ch)
        with tempfile.TemporaryDirectory() as tmp:
            mesh = mesh_setup(dev, tmp)
            rays = mesh_rays(dev, *mesh[:3])
            wb, rec_closest, rec_any, wide_times, wide_visits = \
                phase_wide_kernels(dev, mesh[0], mesh[2], rays)
            pk, rec_pclosest, rec_pany = phase_packet_kernels(
                dev, mesh[0], mesh[2], rays, wide_times, wide_visits)
            del rays
            record["launches"], rec_brute_any["launches"] = \
                phase_main_path(dev, ch, wb, pk)
            (rec_closest["launches"], rec_any["launches"]), _, wide_chunk = \
                phase_mesh_path(dev, ch, wb, pk, mesh, tmp)
            rec_pclosest["launches"], rec_pany["launches"] = \
                phase_mesh_path_binary(dev, ch, wb, pk, mesh, wide_chunk)
            records = [record, rec_brute_any, rec_closest, rec_any,
                       rec_pclosest, rec_pany]
            for r in records:
                check(r["launches"] > 0,
                      f"a main path never launched the kernel {r['name']}")
            phase_slice3(dev, ch, wb, pk)
            if "--profile" in sys.argv[1:]:
                phase_profile(dev, mesh)
        phase_golden(dev)
        phase_goldens_halton(dev)
        phase_gradients(dev, ch, wb, pk, mesh)
        phase_volpath(dev, ch, wb, pk)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    emit({"phase": "done", "seconds": time.time() - t_start})
    print(smi, flush=True)
    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
