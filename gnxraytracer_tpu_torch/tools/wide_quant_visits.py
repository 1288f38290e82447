"""Counts what the width-8 walk visits under two quantizations of its child
boxes: the one frame of ops/wbvh.pack_wide (lo.xyz and scale.xyz of the
whole tree, so a deep child box is rounded out to 1/255 of the tree's
extent), and one frame per node (the node's own box as lo and power-of-two
scales, as in Ylitie, Karras and Laine, "Efficient Incoherent Ray Traversal
on GPUs Through Compressed Wide BVHs", HPG 2017).  Both are conservative:
lo floored, hi ceiled, checked in float32 as a walk dequantizes them.

    python -m gnxraytracer_tpu_torch.tools.wide_quant_visits [--rays N] [--seed S]

Runs on the host alone (no GPU).  The tree is the 104,882-triangle blob of
presets.envmap_mesh; the rays enter it: origins uniform in 1.6x the tree's
box, directions uniform on the sphere, t_max = 1e30 (the entering set of
chip_smoke.py, made here with numpy).  For each quantization it walks the
rays closest-hit and any-hit (node boxes from the quantized bytes, children
near first in the ray's octant order, leaf rows through the plain watertight
test of kernels/wide_bvh.py) and prints one JSON line: node visits and leaf
rows per ray, their sum, and the hit set, which must be the same under both.
"""

import argparse
import json
import time

import numpy as np
import torch

from ..kernels.wide_bvh import _leaf_rows, _safe_inv
from ..ops import wbvh
from ..ops.intersect import _permute_shear
from ..scene import presets

_SLAB_WIDEN = 1.0 + 2.0 * 7.2e-7


def one_frame_boxes(bounds):
    """(lo, hi) (NW, 3, 8) float32 of the single-frame pack, dequantized as
    the kernel does: lo + byte * scale."""
    q, f_lo, scale = wbvh._quantize_bounds(bounds)
    q = q.astype(np.float32)
    lo = f_lo[None, :, None] + q[:, 0:3] * scale[None, :, None]
    hi = f_lo[None, :, None] + q[:, 3:6] * scale[None, :, None]
    return lo.astype(np.float32), hi.astype(np.float32)


def node_frame_boxes(bounds):
    """(lo, hi) (NW, 3, 8) float32 with a frame per node: origin the node's
    own box corner p, scale a power of two s with p + 255 s past the node's
    far side; a child's byte is floored (lo) or ceiled (hi) and then moved
    until p + byte * s, rounded in float32, contains the float box."""
    valid = bounds[:, 0, :] < wbvh.BIG / 2                    # (NW, 8)
    blo = np.where(valid[:, None], bounds[:, 0:3], np.inf)
    bhi = np.where(valid[:, None], bounds[:, 3:6], -np.inf)
    p = blo.min(-1).astype(np.float32)                        # (NW, 3)
    ext = (bhi.max(-1) - p).astype(np.float64)
    s = np.exp2(np.ceil(np.log2(np.maximum(ext / 254.0, 2.0 ** -100))))
    s = s.astype(np.float32)
    pp, ss = p[:, :, None], s[:, :, None]
    ql = np.floor((np.where(valid[:, None], blo, p[:, :, None]) - pp) / ss)
    qh = np.ceil((np.where(valid[:, None], bhi, p[:, :, None]) - pp) / ss)
    ql, qh = np.clip(ql, 0, 255), np.clip(qh, 0, 255)
    deq = lambda q: (pp + q.astype(np.float32) * ss).astype(np.float32)
    for _ in range(4):  # float32 rounding of the add can cut a box
        ql = np.where(valid[:, None] & (deq(ql) > blo), ql - 1, ql)
        qh = np.where(valid[:, None] & (deq(qh) < bhi), qh + 1, qh)
    assert ql.min() >= 0 and qh.max() <= 255, "a child box left its frame"
    lo, hi = deq(ql), deq(qh)
    assert (lo[valid[:, None].repeat(3, 1)] <= blo[valid[:, None].repeat(3, 1)]).all()
    assert (hi[valid[:, None].repeat(3, 1)] >= bhi[valid[:, None].repeat(3, 1)]).all()
    # an empty slot: a zero-volume box at the node's far corner
    far = deq(np.full_like(ql, 255))
    return np.where(valid[:, None], lo, far), np.where(valid[:, None], hi, far)


def walk(pack, lo, hi, targ, perms, o, d, t_max, any_hit):
    """Lockstep depth-first walk over float child boxes (lo, hi) (NW, 3, 8):
    (node visits, leaf rows, found) summed over rays."""
    n = o.shape[0]
    lo, hi = torch.from_numpy(lo), torch.from_numpy(hi)
    targ = torch.from_numpy(np.asarray(targ, np.int64))
    perms = torch.from_numpy(np.asarray(perms, np.int64))
    inv = _safe_inv(d)
    neg = (d < 0).to(torch.int64)
    octant = neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2)
    (m0, m1), (sx, sy, sz) = _permute_shear(d)
    t_best = t_max.clone()
    tri = torch.full((n,), -1, dtype=torch.int32)
    u, v = torch.zeros(n), torch.zeros(n)
    found = torch.zeros(n, dtype=torch.bool)
    cap = 7 * wbvh.wide_depth(targ.numpy()) + 1
    stack = torch.zeros((n, cap), dtype=torch.int64)
    sp = (t_best > 0).to(torch.int64)
    nodes = rows = 0
    while True:
        live = torch.nonzero(sp > 0)[:, 0]
        if live.numel() == 0:
            break
        sp[live] -= 1
        entry = stack[live, sp[live]]
        ni, li = live[entry >= 0], live[entry < 0]
        if ni.numel():
            nodes += ni.numel()
            e = entry[entry >= 0]
            oo, ii = o[ni][:, :, None], inv[ni][:, :, None]
            t0, t1 = (lo[e] - oo) * ii, (hi[e] - oo) * ii
            tn = torch.amax(torch.minimum(t0, t1), dim=1)
            tf = torch.amin(torch.maximum(t0, t1), dim=1) * _SLAB_WIDEN
            tb = t_best[ni][:, None]
            want = (tn <= tf) & (tf > 0) & (tn < tb) & (tb > 0) & (targ[e] != 0)
            order = perms[e, octant[ni]]                       # (M, 8)
            for j in range(7, -1, -1):
                sl = order[:, j:j + 1]
                push = want.gather(1, sl)[:, 0]
                lanes = ni[push]
                stack[lanes, sp[lanes]] = targ[e][push].gather(1, sl[push])[:, 0]
                sp[lanes] += 1
        if li.numel():
            rows += li.numel()
            row = -entry[entry < 0] - 1
            f = _leaf_rows(pack, row, li, o, (m0, m1, sx, sy, sz), t_best, tri,
                           u, v, found, any_hit)
            if any_hit:
                sp[li[f]] = 0
    return nodes, rows, found


def entering_rays(lo, hi, n, seed):
    rs = np.random.RandomState(seed)
    o = (lo + (hi - lo) * (rs.rand(n, 3) * 1.6 - 0.3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o), torch.from_numpy(d.astype(np.float32)),
            torch.full((n,), 1e30, dtype=torch.float32))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    scene, _ = presets.envmap_mesh(64, 64, device="cpu")
    b = scene.bvh
    host = lambda x: x.numpy()
    bounds, targ, perms = wbvh.collapse_bvhw(
        host(b.offset), host(b.n_prims), host(b.axis), host(b.bounds_lo),
        host(b.bounds_hi), wbvh.WIDTH)
    pack = b.wide
    f_lo, f_sc = pack.frame[0:3].numpy(), pack.frame[3:6].numpy()
    rays = entering_rays(f_lo, f_lo + 255 * f_sc, args.rays, args.seed)
    hits = {}
    for name, boxes in (("one_frame", one_frame_boxes(bounds)),
                        ("frame_per_node", node_frame_boxes(bounds))):
        out = {"quantization": name, "triangles": int((pack.tid >= 0).sum()),
               "wide_nodes": int(targ.shape[0]), "rays": args.rays}
        for mode in ("closest", "any"):
            t0 = time.time()
            nodes, rows, found = walk(pack, *boxes, targ, perms, *rays,
                                      any_hit=mode == "any")
            hits[(name, mode)] = found
            out[mode] = {"node_visits_per_ray": nodes / args.rays,
                         "leaf_rows_per_ray": rows / args.rays,
                         "visits_plus_rows_per_ray": (nodes + rows) / args.rays,
                         "hit_fraction": float(found.float().mean()),
                         "host_s": time.time() - t0}
        print(json.dumps(out), flush=True)
    same = all(torch.equal(hits[("one_frame", m)], hits[("frame_per_node", m)])
               for m in ("closest", "any"))
    print(json.dumps({"same_hit_sets": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
