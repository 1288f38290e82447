"""Times the brute-force kernels of csrc/closest_hit.cu against other
versions of that source, and counts their instructions a ray-triangle pair;
a development measurement on one NVIDIA GPU.

    python -m gnxraytracer_tpu_torch.tools.bench_closest_hit
        [--old [LABEL=]DIR ...] [--reps R] [--turns K] [--out FILE]
        [--sass-dir DIR]

Run from the repository's root (it takes its ray sets, timers and pair
counts from chip_smoke.py).  It builds, all nvcc at once and with
`-Xptxas -v`:
  * "new": the package's csrc/closest_hit.cu as it stands,
  * each --old: DIR/closest_hit.cu, another version of the source (for
    instance a commit's, unpacked with `git archive`; it may have no any-hit
    entry), under LABEL ("old" by default).
Ray sets: the Cornell main path's 1M rays of chip_smoke.py's phase 3a
(camera and bounce rays, every lane alive) and their first 125k (the
compacted tail of the bounce loop), the main path's 1M shadow rays (any
hit, and closest hit on the same rays), and two ray soups (1,000 triangles,
200,003 rays; 2,500 triangles, 10,000 rays: the tiled path).  Every build
must give every lane of every set the same result as "new".  Then each set
is timed in K turns (new, then each --old, then back), torch.profiler's
device time of the kernel and CUDA events around the launch, L2 flushed
before each launch, R launches each time a build comes.

Instruction counts: `cuobjdump -sass` of each build; in each kernel the
smallest loop that holds a reciprocal (`MUFU.RCP`: one a pair, in the
tail's IEEE division) is the pair loop.  On its control-flow graph the
reject path is the shortest path through one iteration that reaches no
reciprocal (the old design has none, so there it is the shortest path
overall: every step but the update of the best), the full path the longest;
both divided by the reciprocals on the full path (the loop's unroll).
"issue floor" is the instructions this set's pairs need at one instruction a
lane a cycle on every SM at the card's maximum SM clock: every pair the
kernel tests on the reject path, and every pair that enters the tail the
rest of the full path (chip_smoke.brute_pairs counts both; in a build that
runs the whole test on every pair, that rest is the update of the best).
Prints one JSON object a line; --out also writes them to FILE,
--sass-dir each build's SASS.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from ..kernels import build
from ..kernels import closest_hit as ch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAMES = ("closest_hit_kernel", "brute_any_hit_kernel")


def start(label, src, out_dir):
    out = os.path.join(out_dir, f"libbench_brute_{label}.so")
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
           "-o", out, src]
    return label, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)


def finish(handle):
    label, out, proc = handle
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {label}:\n{log}")
    return out, ctypes.CDLL(out), log


def casters(lib):
    """(closest(o, d, t, soa) -> TriHit, any(o, d, t, soa) -> occ or None)
    through lib's entry points."""
    p = ctypes.c_void_p
    fc = lib.gnx_closest_hit
    fc.argtypes = [p, ctypes.c_int] + [p] * 7 + [ctypes.c_longlong, p]
    fc.restype = ctypes.c_int

    def closest(o, d, t, soa):
        n, dev = o.shape[0], o.device
        out = ch.TriHit(hit=torch.empty((n,), dtype=torch.bool, device=dev),
                        t=torch.empty((n,), dtype=torch.float32, device=dev),
                        tri=torch.empty((n,), dtype=torch.int32, device=dev),
                        b=torch.empty((n, 3), dtype=torch.float32, device=dev))
        err = fc(soa.data_ptr(), soa.shape[0], o.data_ptr(), d.data_ptr(),
                 t.data_ptr(), out.t.data_ptr(), out.tri.data_ptr(),
                 out.b.data_ptr(), out.hit.data_ptr(), n,
                 torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out

    if not hasattr(lib, "gnx_brute_any_hit"):
        return closest, None
    fa = lib.gnx_brute_any_hit
    fa.argtypes = [p, ctypes.c_int] + [p] * 4 + [ctypes.c_longlong, p]
    fa.restype = ctypes.c_int

    def any_hit(o, d, t, soa):
        n, dev = o.shape[0], o.device
        occ = torch.empty((n,), dtype=torch.bool, device=dev)
        err = fa(soa.data_ptr(), soa.shape[0], o.data_ptr(), d.data_ptr(),
                 t.data_ptr(), occ.data_ptr(), n,
                 torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return occ
    return closest, any_hit


# -- SASS ---------------------------------------------------------------------

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z0-9_.]+)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"(0x[0-9a-f]+|\.L_x_\d+)")


def sass_functions(text):
    """{function name: [(address, predicated, opcode, operands)]} of a
    `cuobjdump -sass` listing, with labels resolved to addresses."""
    funcs, cur, pending = {}, None, []
    labels = {}
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m and cur is not None:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[(id(cur), lab)] = addr
            pending = []
            cur.append([addr, bool(m.group(2)), m.group(3), m.group(4)])
    for name, ins in funcs.items():
        for row in ins:
            t = _TARGET.search(row[3]) if row[2].startswith(("BRA", "BRX")) else None
            row.append(None if t is None else (
                int(t.group(1), 16) if t.group(1).startswith("0x")
                else labels.get((id(ins), t.group(1)))))
    return funcs


def _blocks(ins):
    """Basic blocks: [(first index, last index)], and successors by block."""
    starts = {0}
    addr_at = {row[0]: k for k, row in enumerate(ins)}
    for k, (_, pred, op, _, tgt) in enumerate(ins):
        if op.startswith(("BRA", "EXIT", "RET", "BRX")):
            starts.add(k + 1)
            if tgt is not None and tgt in addr_at:
                starts.add(addr_at[tgt])
    starts = sorted(s for s in starts if s < len(ins))
    blocks = [(s, (starts[i + 1] if i + 1 < len(starts) else len(ins)) - 1)
              for i, s in enumerate(starts)]
    block_of = {s: b for b, (s, _) in enumerate(blocks)}
    succ = []
    for b, (s, e) in enumerate(blocks):
        _, pred, op, _, tgt = ins[e]
        out = []
        if op.startswith("BRA") and tgt is not None and tgt in addr_at:
            out.append(block_of[addr_at[tgt]])
            if pred and b + 1 < len(blocks):
                out.append(b + 1)
        elif op.startswith(("EXIT", "RET")):
            if pred and b + 1 < len(blocks):
                out.append(b + 1)
        elif b + 1 < len(blocks):
            out.append(b + 1)
        succ.append(out)
    return blocks, succ


def _loop_path(body, succ, size, rcp, head, latch, longest, avoid_rcp):
    """(instructions, reciprocals) of the longest or shortest path from head
    to latch through the loop body's acyclic graph (every edge inside the
    body but those back to head), or None; with avoid_rcp through no block
    that holds a reciprocal."""
    edges = {b: [s for s in succ[b] if s in body and s != head] for b in body}
    indeg = {b: 0 for b in body}
    for b in body:
        for s in edges[b]:
            indeg[s] += 1
    order, ready = [], [b for b in body if indeg[b] == 0]
    while ready:  # topological order (Kahn)
        b = ready.pop()
        order.append(b)
        for s in edges[b]:
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    best = {} if avoid_rcp and rcp[head] else {head: (size[head], rcp[head])}
    for b in order:
        if b not in best:
            continue
        for s in edges[b]:
            if avoid_rcp and rcp[s]:
                continue
            cand = (best[b][0] + size[s], best[b][1] + rcp[s])
            if s not in best or ((cand > best[s]) if longest
                                 else (cand < best[s])):
                best[s] = cand
    return best.get(latch)


def pair_loop_counts(ins):
    """Instructions a pair on the reject and on the full path of the pair
    loop (see the module's note), or None when no loop holds a
    reciprocal."""
    blocks, succ = _blocks(ins)
    n = len(blocks)
    size = [e - s + 1 for s, e in blocks]
    rcp = [sum(ins[k][2].startswith("MUFU.RCP") for k in range(s, e + 1))
           for s, e in blocks]
    pred = [[p for p in range(n) if b in succ[p]] for b in range(n)]
    loop = None
    for latch in range(n):
        for head in succ[latch]:
            if head > latch:
                continue  # not a back edge
            body, todo = {head, latch}, [latch]
            while todo:  # the natural loop: blocks that reach the latch
                for p in pred[todo.pop()]:
                    if p not in body:
                        body.add(p)
                        todo.append(p)
            if any(rcp[b] for b in body) and (loop is None
                                              or len(body) < len(loop[2])):
                loop = (head, latch, body)
    if loop is None:
        return None
    head, latch, body = loop
    args = (body, succ, size, rcp, head, latch)
    full, unroll = _loop_path(*args, longest=True, avoid_rcp=False)
    reject = _loop_path(*args, longest=False, avoid_rcp=True)
    skips_tail = reject is not None
    if reject is None:
        reject = _loop_path(*args, longest=False, avoid_rcp=False)
    unroll = max(unroll, 1)
    return dict(reject_per_pair=reject[0] / unroll,
                full_per_pair=full / unroll, pairs_per_iteration=unroll,
                loop_instructions=sum(size[b] for b in body),
                reject_path_skips_the_tail=skips_tail)


def sass_counts(lib_path, dump_to=None):
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    if dump_to:
        with open(dump_to, "w") as f:
            f.write(text)
    out = {}
    for name, ins in sass_functions(text).items():
        base = next((k for k in NAMES if k in name), None)
        if base is None:
            continue
        # a source that splits an entry by a bool template argument (its
        # tiled loop) names each instantiation
        tmpl = {"ILb0E": "<one tile>", "ILb1E": "<tiled>"}
        key = base + next((v for k, v in tmpl.items() if k in name), "")
        out[key] = (pair_loop_counts(ins)
                    or "not clean: no loop holds a reciprocal")
    return out


def max_sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return float(out.splitlines()[0]) * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", action="append", default=[],
                    help="[LABEL=]DIR: directory of another closest_hit.cu")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--out")
    ap.add_argument("--sass-dir")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    out = open(args.out, "w") if args.out else None

    def emit(obj):
        cs.emit(obj)
        if out:
            out.write(json.dumps(obj) + "\n")
            out.flush()

    def device_ms(fn):
        # the profiler now and then keeps no kernel event of a window: take
        # that window again
        for _ in range(3):
            ms = cs.device_ms(fn, args.reps, flush, names=NAMES)
            if ms is not None:
                return ms
        raise SystemExit("torch.profiler saw no brute-force kernel")

    if not torch.cuda.is_available():
        print("bench_closest_hit: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    clock = max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lane_rate = sms * 128 * clock  # instructions a second, one a lane a cycle
    emit({"device": cs.gpu_name_and_power_limit(), "torch": torch.__version__,
          "sms": sms, "max_sm_clock_hz": clock})
    new_src = os.path.join(build.CSRC_DIR, "closest_hit.cu")
    builds = [("new", new_src)]
    for v in args.old:
        label, _, path = v.rpartition("=")
        builds.append((label or "old", os.path.join(path, "closest_hit.cu")))
    out_dir = os.path.join(build.BUILD_DIR, "bench_closest_hit")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    handles = [start(l, s, out_dir) for l, s in builds]
    cast, ptxas, sass = {}, {}, {}
    for (label, src), h in zip(builds, handles):
        path, lib, log = finish(h)
        cast[label] = casters(lib)
        ptxas[label] = cs.ptxas_summary(log)
        dump = (os.path.join(args.sass_dir, f"{label}.sass")
                if args.sass_dir else None)
        if dump:
            os.makedirs(args.sass_dir, exist_ok=True)
        sass[label] = sass_counts(path, dump)
    labels = [b[0] for b in builds]
    emit({"phase": "build", "seconds": time.time() - t0,
          "builds": {l: os.path.relpath(s, ROOT) for l, s in builds},
          "ptxas": ptxas, "sass_per_pair": sass})

    scene, o, d, alive, shadow = cs.main_path_rays(dev)
    soa = ch.tri_soa_from_mesh(scene.geom.vertices, scene.geom.triangles)
    t_all = torch.full((o.shape[0],), 3.4e38, dtype=torch.float32, device=dev)
    m = o.shape[0] // 8
    sets = {"cornell": (o, d, t_all, soa),
            "cornell_tail_125k": (o[:m], d[:m], t_all[:m], soa),
            "cornell_shadow": (*shadow, soa)}
    for name, (n_tri, n_ray, seed) in (("soup", (1000, 200_003, 0)),
                                       ("soup_3_tiles", (2500, 10_000, 2))):
        s_soa, s_o, s_d, s_t = cs.soup(n_tri, n_ray, dev, seed=seed)
        sets[name] = (s_o, s_d, s_t, s_soa)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    for name, (so, sd, st, ssoa) in sets.items():
        for kind in ("closest", "any"):
            if kind == "any" and name in ("cornell", "cornell_tail_125k"):
                continue
            k = 0 if kind == "closest" else 1
            run = [l for l in labels if cast[l][k] is not None]
            first = cast[run[0]][k](so, sd, st, ssoa)
            torch.cuda.synchronize()
            for label in run[1:]:
                got = cast[label][k](so, sd, st, ssoa)
                same = (torch.equal(got, first) if kind == "any" else
                        all(torch.equal(a, b) for a, b in zip(got, first)))
                if not same:
                    raise SystemExit(f"{name} {kind}: {label} differs from "
                                     f"{run[0]}")
            dev_ms = {l: [] for l in run}
            ev_ms = {l: [] for l in run}
            for label in (run + run[::-1]) * args.turns:
                fn = lambda: cast[label][k](so, sd, st, ssoa)
                dev_ms[label].append(device_ms(fn))
                ev_ms[label].append(cs.time_cuda(fn, args.reps, flush))
            n, t = so.shape[0], ssoa.shape[0]
            live = int((st > 0).sum())
            hits = int((first if kind == "any" else first.hit).sum())
            tested, tail = cs.brute_pairs(so, sd, st, ssoa, kind == "any")
            floors = {}
            for label in run:
                kerns = {key: c for key, c in sass[label].items()
                         if key.startswith(NAMES[k])}
                c = kerns.get(NAMES[k] + ("<tiled>" if t > 1024
                                          else "<one tile>"))
                if c is None and len(kerns) == 1:
                    c = next(iter(kerns.values()))
                if isinstance(c, dict):
                    rest = c["full_per_pair"] - c["reject_per_pair"]
                    instr = tested * c["reject_per_pair"] + tail * rest
                    floors[label] = instr / lane_rate * 1e3
            emit({"phase": "times", "rays": name, "kernel": kind,
                  "n_rays": n, "n_tris": t, "live_lanes": live,
                  "hit_lanes": hits, "pairs_tested": tested,
                  "pairs_into_tail": tail, "bit_equal_to": run[0],
                  "device_ms": dev_ms, "event_ms": ev_ms,
                  "device_ms_median": {l: float(np.median(v))
                                       for l, v in dev_ms.items()},
                  "issue_floor_ms": floors})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
