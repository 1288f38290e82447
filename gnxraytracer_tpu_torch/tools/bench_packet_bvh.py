"""Times the binary threaded-BVH kernels of csrc/packet_bvh.cu against other
versions of that source and against the width-8 kernels of csrc/wide_bvh.cu
on the same rays, and counts their instructions a node visit and a leaf
row; a development measurement on one NVIDIA GPU.

    python -m gnxraytracer_tpu_torch.tools.bench_packet_bvh
        [--old [LABEL=]DIR ...] [--reps R] [--turns K] [--out FILE]
        [--sass-dir DIR] [--sets NAME,...]

Run from the repository's root (it takes its scenes, ray sets and timers
from chip_smoke.py).  It builds, all nvcc at once and with `-Xptxas -v`:
  * "new": the package's csrc/packet_bvh.cu as it stands,
  * each --old: DIR/packet_bvh.cu, another version of the source (for
    instance a commit's, unpacked with `git archive`, or an edited copy for
    an A/B), under LABEL ("old" by default); its entry points may take the
    one-pass design's arguments (node and link tables, no list),
  * "io": a kernel that only reads each ray and writes a miss record.
Ray sets, 1M rays each: the mesh main path's (presets.envmap_mesh) camera,
bounce and shadow rays, rays that enter the blob's tree (closest and any
hit) and "sparse" (the bounce rays, one lane in 32 alive); the mirror-mesh
Cornell scene's Whitted depth-1 rays, depth-0 shadow rays and incoherent
rays through 1.6x the mesh's box (closest and any hit); and the closed tree
(chip_smoke.closed_tree_setup: one tree over the walls and the mesh) with
its camera, bounce and shadow rays.  Every build must give every lane the
same result as "new", and the wide kernels the same hits.  Then each set is
timed in K turns (new, each --old, "wide", then back), torch.profiler's
device time of a cast's kernels and CUDA events around the launch, L2
flushed before each launch, R launches each time a build comes.  The floor
ladder on the bounce, entering and closed-tree camera rays: "io", "root"
(the same tree with the root's link sent to an empty leaf row: the ray, the
root's test and nothing more) and the whole walk.

The plain walk (kernels/packet_bvh.py) counts each set's visits on a
sample of warps: every k-th run of 32 rays in launch order (all rays, as
the one-pass design launches them) and in the triage pass's list (the rays
that the root wants).  From them: node visits and leaf rows (scaled to the
set), and the warps' lane utilisation, the share of lane steps busy when a
warp runs as long as its longest walk.

Instruction counts: `cuobjdump -sass` of each build's walk kernel.  On its
control-flow graph, along forward edges: "node visit", the shortest path
through the smallest loop that holds the slab test's min/max (FMNMX) and no
reciprocal (MUFU.RCP); "leaf row, reject", the shortest path from the block
that loads the leaf row (the first with three or more 16-byte loads) to the
latch of the smallest loop that holds a reciprocal, through no block that
holds one, among those through the most blocks of edge tests (nine selects
and twelve products or more): every pair tested and rejected at its edges
(a design without branches has no such path: there it is the full path);
"leaf row, full", the longest path.  "issue floor" is the node visits times the first plus
the leaf rows times the second at one instruction a lane a cycle on every
SM at the card's maximum SM clock (the tails of the pairs that reach them
are not in it).  Prints one JSON object a line; --out also writes them to
FILE, --sass-dir each build's SASS.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..kernels import build
from ..kernels import packet_bvh as pk
from ..kernels import wide_bvh as wb
from . import bench_closest_hit as bc
from .bench_wide_bvh import IO_SOURCE, finish, io_caster, same, start

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the kernels of one binary cast (the triage pass, where the build has one,
# and the walk; the one-pass design's single kernel), and of a wide one
BINARY = ("packet_triage_kernel", "packet_walk_kernel", "packet_bvh_kernel")
WIDE = ("wide_triage_kernel", "wide_bvh_kernel")
SAMPLE_RAYS = 40_000  # rays of the plain walk's sample of warps, at most


def packet_caster(lib):
    """cast(pack, o, d, t, any_hit) through lib's two entry points, with the
    two-pass design's arguments (the list's counter and scratch) or the
    one-pass design's."""
    p = ctypes.c_void_p
    two_pass = hasattr(lib, "gnx_packet_blocks")
    tail = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    tail += [p, p, p] if two_pass else [p]
    fc, fa = lib.gnx_packet_closest_hit, lib.gnx_packet_any_hit
    fc.argtypes, fa.argtypes = [p] * 11 + tail, [p] * 8 + tail
    fc.restype = fa.restype = ctypes.c_int

    def cast(pack, o, d, t, any_hit):
        n, dev = o.shape[0], o.device
        rays = [o.data_ptr(), d.data_ptr(), t.data_ptr()]
        keep, head, shape = pk._launch_args(pack, n, dev)
        shape = [n, *(shape if two_pass else shape[:2])]
        stream = torch.cuda.current_stream(dev).cuda_stream
        if any_hit:
            out = torch.empty((n,), dtype=torch.bool, device=dev)
            err = fa(*head, *rays, out.data_ptr(), *shape, stream)
        else:
            out = wb._empty_trihit(n, dev)
            err = fc(*head, *rays, out.t.data_ptr(), out.tri.data_ptr(),
                     out.b.data_ptr(), out.hit.data_ptr(), *shape, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        del keep
        return out
    return cast


# -- SASS ---------------------------------------------------------------------

def _forward_path(succ, size, body, src, dst, avoid, longest,
                  prefer=frozenset()):
    """Instructions of the shortest (or longest) path from block src to
    block dst along forward edges inside `body`, through no block in
    `avoid`, among the paths through the most blocks of `prefer`; None if
    there is none."""
    if src in avoid or dst in avoid:
        return None
    best = {src: (int(src in prefer), size[src])}
    for b in sorted(x for x in body if x >= src):
        if b not in best:
            continue
        for s in succ[b]:
            if s <= b or s not in body or s in avoid:
                continue
            cand = (best[b][0] + (s in prefer), best[b][1] + size[s])
            cur = best.get(s)
            if (cur is None or cand[0] > cur[0] or (cand[0] == cur[0] and (
                    cand[1] > cur[1] if longest else cand[1] < cur[1]))):
                best[s] = cand
    return best[dst][1] if dst in best else None


def walk_counts(ins):
    """Instructions of a node visit and of a leaf row (reject, full) in one
    walk kernel's SASS (see the module's note), or a reason why not."""
    blocks, succ = bc._blocks(ins)
    n = len(blocks)
    size = [e - s + 1 for s, e in blocks]

    def count(b, pred):
        return sum(pred(ins[k][2]) for k in range(blocks[b][0], blocks[b][1] + 1))

    rcp = {b for b in range(n) if count(b, lambda op: op.startswith("MUFU.RCP"))}
    # a pair's edge test: the permutation's selects and the shear's and
    # edge functions' products, in one block
    edges = {b for b in range(n) if b not in rcp
             and count(b, lambda op: op.startswith("FSEL")) >= 9
             and count(b, lambda op: op.startswith("FMUL")) >= 12}
    mnmx = {b for b in range(n) if count(b, lambda op: op.startswith("FMNMX"))}
    ld16 = [count(b, lambda op: op.startswith("LDG") and ".128" in op)
            for b in range(n)]
    pred = [[p for p in range(n) if b in succ[p]] for b in range(n)]
    loops = []
    for latch in range(n):
        for head in succ[latch]:
            if head > latch:
                continue  # not a back edge
            body, todo = {head, latch}, [latch]
            while todo:  # the natural loop: blocks that reach the latch
                for p in pred[todo.pop()]:
                    if p not in body and p >= head:
                        body.add(p)
                        todo.append(p)
            loops.append((len(body), head, latch, body))
    loops.sort(key=lambda x: x[0])
    node = next((l for l in loops if l[3] & mnmx and not l[3] & rcp), None)
    if node is None:  # the one-pass design: leaf tests inside the node loop
        node = next((l for l in loops if l[3] & mnmx), None)
    leaf = next((l for l in loops if l[3] & rcp), None)
    if node is None or leaf is None:
        return "not clean: no loop with the slab test or a reciprocal"
    _, head, latch, body = node
    node_path = _forward_path(succ, size, body, head, latch, rcp, False)
    _, head, latch, body = leaf
    row = min((b for b in body if ld16[b] >= 3), default=None)
    if row is None:
        return "not clean: no block loads a leaf row"
    reject = _forward_path(succ, size, body, row, latch, rcp, False,
                           prefer=edges)
    full = _forward_path(succ, size, body, row, latch, set(), True)
    return dict(node_visit=node_path,
                leaf_row_reject=full if reject is None else reject,
                leaf_row_full=full, edge_blocks=len(edges & body),
                loop_instructions={"node": sum(size[b] for b in node[3]),
                                   "leaf": sum(size[b] for b in leaf[3])})


def sass_counts(lib_path, dump_to=None):
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    if dump_to:
        with open(dump_to, "w") as f:
            f.write(text)
    out = {}
    for name, ins in bc.sass_functions(text).items():
        base = next((k for k in ("packet_walk_kernel", "packet_bvh_kernel")
                     if k in name), None)
        if base is None:
            continue
        key = base + ("<any>" if "ILb1E" in name else "<closest>")
        out[key] = walk_counts(ins)
    return out


# -- visits and lane utilisation ----------------------------------------------

def lane_utilisation(visits):
    """Share of lane steps busy over warps of 32 consecutive entries of
    `visits` (each warp as long as its longest walk); None without work."""
    v = visits.to(torch.float64)
    pad = (-v.numel()) % 32
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    w = v.reshape(-1, 32)
    span = 32.0 * float(w.amax(1).sum())
    return float(w.sum()) / span if span > 0 else None


def warp_sample(idx, n_rays):
    """Every k-th run of 32 entries of idx (a launch order), at most
    n_rays entries in all."""
    warps = (idx.numel() + 31) // 32
    k = max(1, -(-warps * 32 // n_rays))
    starts = torch.arange(0, warps, k, device=idx.device) * 32
    take = (starts[:, None] + torch.arange(32, device=idx.device)).reshape(-1)
    return idx[take[take < idx.numel()]], k


def visit_counts(pack, o, d, t, any_hit):
    """The plain walk on a sample of warps in the one-pass launch order and
    in the triage list's: node visits and leaf rows scaled to the set, and
    the lane utilisation of both."""
    plain = pk.packet_any_hit_reference if any_hit else pk.packet_closest_hit_reference
    n = o.shape[0]
    listed = torch.nonzero(pk.entering(pack, o, d, t))[:, 0]
    out = {"listed": int(listed.numel())}
    for label, order in (("all rays", torch.arange(n, device=o.device)),
                         ("triage list", listed)):
        idx, k = warp_sample(order, SAMPLE_RAYS)
        if idx.numel() == 0:
            out[label] = None
            continue
        per_ray = torch.zeros((idx.numel(),), dtype=torch.int64, device=o.device)
        stats = {}
        plain(pack, o[idx].contiguous(), d[idx].contiguous(),
              t[idx].contiguous(), stats=stats, ray_visits=per_ray)
        scale = order.numel() / idx.numel()
        out[label] = {"sampled_rays": int(idx.numel()), "every_kth_warp": k,
                      "node_visits": stats["node_visits"] * scale,
                      "leaf_visits": stats["leaf_visits"] * scale,
                      "lane_utilisation": lane_utilisation(per_ray)}
    return out


# -- ray sets -------------------------------------------------------------------

def ray_sets(cs, dev, wanted):
    """{name: (tree, o, d, t_max, any_hit)} over three trees."""
    import tempfile

    from ..models.integrators import path
    from ..ops import samplers
    from ..scene import presets
    from ..scene.loaders import make_test_mesh

    sets = {}
    with tempfile.TemporaryDirectory() as tmp:
        scene, cam, cfg, _smp, _ = cs.mesh_setup(dev, tmp)
        rays = cs.mesh_rays(dev, scene, cam, cfg)
    o, d, t = rays["bounce"]
    rays["sparse"] = (o, d, torch.where(
        torch.arange(t.shape[0], device=dev) % 32 == 0, t, 0.0).contiguous())
    for name, r in rays.items():
        sets["mesh " + name] = (scene.bvh, *r, name in cs.ANY_HIT_SETS)

    mirror, cam = presets.cornell_box(cs.WIDTH, cs.HEIGHT, mesh=make_test_mesh(5),
                                      bvh=True, dragon_material=cs.MIRROR_ID,
                                      device=dev)
    cfg = path.make_config(mirror, cs.WIDTH, cs.HEIGHT, spp=8,
                           max_depth=cs.WHITTED_DEPTH, spp_chunk=cs.SPP_CHUNK)
    smp = samplers.make_halton_sampler(8, cs.WIDTH, cs.HEIGHT, device=dev)
    li = next(i for i, k in enumerate(cfg.light_kind_seq) if k != 5)
    n = cs.WIDTH * cs.HEIGHT * cs.SPP_CHUNK
    lo, hi = mirror.bvh.packet.nodes[0, 0:3], mirror.bvh.packet.nodes[0, 3:6]
    gen = torch.Generator(device=dev).manual_seed(0)
    ro = (lo + (hi - lo) * (torch.rand((n, 3), generator=gen, device=dev)
                            * 1.6 - 0.3)).contiguous()
    rd = torch.randn((n, 3), generator=gen, device=dev)
    rd = (rd / torch.linalg.norm(rd, dim=1, keepdim=True)).contiguous()
    far = torch.full((n,), 1e30, dtype=torch.float32, device=dev)
    sets["mirror depth1"] = (mirror.bvh, *cs.depth1_rays(mirror, cam, cfg, smp),
                             False)
    sets["mirror shadow"] = (mirror.bvh, *cs.depth0_shadow_rays(
        mirror, cam, cfg, smp, li), True)
    sets["mirror incoherent"] = (mirror.bvh, ro, rd, far, False)
    sets["mirror incoherent_any"] = (mirror.bvh, ro, rd, far, True)

    scene, cam, cfg, tree, light = cs.closed_tree_setup(dev)
    rays = cs.path_rays(dev, scene, cam, cfg, light=light)
    for name, r in rays.items():
        sets["closed " + name] = (tree, *r, name == "shadow")
    return {k: v for k, v in sets.items()
            if not wanted or any(w in k for w in wanted)}


def root_only(tree):
    """The tree with every octant's root link sent to an added leaf row of
    pads: a walk tests the root and an empty row, and ends."""
    pack = tree.packet
    leafs = torch.cat([pack.leafs, pack.leafs.new_zeros((1, pack.leafs.shape[1]))])
    tid = torch.cat([pack.tid, pack.tid.new_full((1, pack.tid.shape[1]), -1)])
    meta = pack.meta.clone()
    meta[:, 0, 0] = -pack.leafs.shape[0] - 1
    return pack._replace(meta=meta, leafs=leafs, tid=tid)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", action="append", default=[],
                    help="[LABEL=]DIR: directory of another packet_bvh.cu")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--out")
    ap.add_argument("--sass-dir")
    ap.add_argument("--sets", default="",
                    help="comma-separated parts of set names to keep")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    out = open(args.out, "w") if args.out else None

    def emit(obj):
        cs.emit(obj)
        if out:
            out.write(json.dumps(obj) + "\n")
            out.flush()

    def device_ms(fn, names):
        # the profiler now and then keeps no kernel event of a window: take
        # that window again
        for _ in range(3):
            ms = cs.device_ms(fn, args.reps, flush, names=names)
            if ms is not None:
                return ms
        raise SystemExit("torch.profiler saw no kernel of the cast")

    if not torch.cuda.is_available():
        print("bench_packet_bvh: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    clock = bc.max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lane_rate = sms * 128 * clock  # instructions a second, one a lane a cycle
    emit({"device": cs.gpu_name_and_power_limit(), "torch": torch.__version__,
          "sms": sms, "max_sm_clock_hz": clock})
    builds = [("new", os.path.join(build.CSRC_DIR, "packet_bvh.cu"))]
    for v in args.old:
        label, _, path = v.rpartition("=")
        builds.append((label or "old", os.path.join(path, "packet_bvh.cu")))
    out_dir = os.path.join(build.BUILD_DIR, "bench_packet_bvh")
    os.makedirs(out_dir, exist_ok=True)
    io_src = os.path.join(out_dir, "io.cu")
    with open(io_src, "w") as f:
        f.write(IO_SOURCE)
    t0 = time.time()
    handles = [start(l, s, out_dir) for l, s in builds + [("io", io_src)]]
    cast, ptxas, sass = {}, {}, {}
    for (label, src), h in zip(builds + [("io", io_src)], handles):
        lib, log = finish(h)
        if label == "io":
            io = io_caster(lib)
            continue
        cast[label] = packet_caster(lib)
        ptxas[label] = cs.ptxas_summary(log)
        dump = (os.path.join(args.sass_dir, f"{label}.sass")
                if args.sass_dir else None)
        if dump:
            os.makedirs(args.sass_dir, exist_ok=True)
        sass[label] = sass_counts(h[1], dump)
    labels = [b[0] for b in builds]
    lib = ctypes.CDLL(handles[0][1])
    lib.gnx_packet_blocks.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.gnx_packet_blocks.restype = ctypes.c_longlong
    blocks = [lib.gnx_packet_blocks(a, 1_000_000) for a in (0, 1)]
    emit({"phase": "build", "seconds": time.time() - t0,
          "builds": {l: os.path.relpath(s, ROOT) for l, s in builds},
          "ptxas": ptxas, "sass": sass,
          "new_walk_blocks_closest_any_1M": blocks})

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    wanted = [w for w in args.sets.split(",") if w]
    sets = ray_sets(cs, dev, wanted)
    for name, (tree, o, d, t, any_hit) in sets.items():
        pack = tree.packet
        first = cast["new"](pack, o, d, t, any_hit)
        torch.cuda.synchronize()
        for label in labels[1:]:
            if not same(cast[label](pack, o, d, t, any_hit), first):
                raise SystemExit(f"{name}: {label} differs from new")
        wide = wb.wide_any_hit if any_hit else wb.wide_closest_hit
        w_out = wide(tree.wide, o, d, t)
        torch.cuda.synchronize()
        if any_hit:
            agree = torch.equal(w_out, first)
        else:
            agree = (torch.equal(w_out.hit, first.hit)
                     and torch.allclose(w_out.t, first.t, rtol=cs.T_RTOL))
        if not agree:
            raise SystemExit(f"{name}: the wide kernels give other hits")
        fns = {l: (lambda l=l: cast[l](pack, o, d, t, any_hit))
               for l in labels}
        fns["wide"] = lambda: wide(tree.wide, o, d, t)
        names = {l: BINARY for l in labels}
        names["wide"] = WIDE
        order = labels + ["wide"]
        dev_ms = {l: [] for l in order}
        ev_ms = {l: [] for l in order}
        for label in (order + order[::-1]) * args.turns:
            dev_ms[label].append(device_ms(fns[label], names[label]))
            ev_ms[label].append(cs.time_cuda(fns[label], args.reps, flush))
        counts = visit_counts(pack, o, d, t, any_hit)
        v = counts["all rays"]
        floors = {}
        for label in labels:
            c = sass[label].get("packet_walk_kernel" + ("<any>" if any_hit else "<closest>"),
                                sass[label].get("packet_bvh_kernel" + ("<any>" if any_hit else "<closest>")))
            if v and isinstance(c, dict) and c["node_visit"] and c["leaf_row_reject"]:
                instr = v["node_visits"] * c["node_visit"] + v["leaf_visits"] * c["leaf_row_reject"]
                floors[label] = instr / lane_rate * 1e3
        table_bytes = sum(x.numel() * x.element_size()
                          for x in pack)
        bnd = (cs.cast_bound(o.shape[0], "shadow" if any_hit else "bounce",
                             table_bytes, v, cs.OPS_PER_NODE)[0] if v else None)
        emit({"phase": "times", "rays": name, "any_hit": any_hit,
              "n_rays": o.shape[0], "bit_equal_to": "new",
              "alive_fraction": float((t > 0).float().mean()),
              "hit_fraction": float((first if any_hit else first.hit).float().mean()),
              "device_ms": dev_ms, "event_ms": ev_ms,
              "device_ms_median": {l: float(np.median(x)) for l, x in dev_ms.items()},
              "bound_ms": bnd, "issue_floor_ms": floors, "visits": counts})

    for name in ("mesh bounce", "mesh entering", "mesh entering_any",
                 "closed camera"):
        if name not in sets:
            continue
        tree, o, d, t, any_hit = sets[name]
        r_pack = root_only(tree)
        ladder = {}
        if not any_hit:
            ladder["io"] = device_ms(lambda: io(tree.packet, o, d, t, False),
                                     ("io_kernel",))
        for label in labels:
            ladder[f"root:{label}"] = device_ms(
                lambda: cast[label](r_pack, o, d, t, any_hit), BINARY)
            ladder[f"walk:{label}"] = device_ms(
                lambda: cast[label](tree.packet, o, d, t, any_hit), BINARY)
        emit({"phase": "ladder", "rays": name, "device_ms": ladder})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
