"""BVH: host-side SAH build in numpy into SoA tables, the per-lane walks of
the tree (the lockstep stack walk and the threaded walk, plain PyTorch),
and the coherence sort of a ray wavefront.

The build is the binary tree of the JAX package's ops/bvh.py, table for table
(the tests hold them byte-equal): a 12-bucket surface-area-heuristic builder
emitting the flattened depth-first layout (interior node n has children n+1
and offset[n]; a leaf covers LEAF_SIZE-aligned rows of the reordered
primitive list starting at offset[n]), threaded miss links, the eight
per-octant near-first threadings, and the packed leaf triangles.  On top of
it ``bvh_from_numpy`` makes the two tables the casts walk: the width-8 table
(ops/wbvh.py, kernels/wide_bvh.py) and the binary threaded table
(``PacketPack``, kernels/packet_bvh.py), which holds the nodes' boxes, the
``first8`` / ``miss8`` links of each direction octant and the packed leaf rows.

Leaves hold up to LEAF_SIZE prims, so a leaf test is a fixed-size masked
intersection.
"""

import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import INFINITY
from ..utils.device import resolve_device
from ..utils.stats import spanned
from .intersect import TriHit

LEAF_SIZE = 4
MAX_STACK = 64  # a stack walk's depth a lane (the reference's 64-deep stack)
MAX_TRAV_STEPS = 4096  # the per-lane walks' step cap


class PacketPack(NamedTuple):
    """The binary threaded (miss-link) tree as the tables a stackless walk
    reads with one row index (kernels/packet_bvh.py), made once per tree."""
    nodes: torch.Tensor  # (NN, 8) f32: lo.xyz hi.xyz pad pad
    # (K, NN, 2) i32 links of direction octant k.  Column 0: a leaf's
    # -(leaf_row + 1), or an inner node's first (nearer) child; node 0 is the
    # root, so child ids are >= 1 and the sign tells the two apart.  Column 1:
    # where the walk goes after a box miss or a finished subtree (-1 = done).
    # K = 8 when the tree carries octant links, else 1 (the depth-first order:
    # first child = node + 1, the fixed miss links).
    meta: torch.Tensor
    leafs: torch.Tensor  # (NL, LEAF_SIZE * 9) f32: one whole leaf per row
    tid: torch.Tensor    # (NL, LEAF_SIZE) i32 triangle ids (-1 pads)


class BVH(NamedTuple):
    bounds_lo: torch.Tensor  # (NN,3)
    bounds_hi: torch.Tensor  # (NN,3)
    offset: torch.Tensor     # (NN,) int32 leaf->prim start | interior->2nd child
    n_prims: torch.Tensor    # (NN,) int32 (0 = interior)
    axis: torch.Tensor       # (NN,) int32 split axis
    prim_idx: torch.Tensor   # (T_padded,) int32 reordered triangle ids (-1 pad)
    miss: torch.Tensor       # (NN,) int32 threaded skip link (-1 = done)
    leaf_soa: torch.Tensor   # (T_padded, 9) packed p0|p1|p2 in leaf order
    # Per-octant front-to-back threading: for direction octant o, a walk that
    # enters inner node n continues at first8[o,n] (the child nearer along
    # the ray) and a miss/finished node jumps to miss8[o,n].
    first8: Optional[torch.Tensor] = None  # (8, NN) int32
    miss8: Optional[torch.Tensor] = None   # (8, NN) int32
    # the JAX package's binary treelet cut exists to fit the TPU's fast
    # memory; it has no counterpart here and stays None
    treelets: object = None
    # width-8 table of the whole tree (ops/wbvh.WidePack), built for every tree
    wide: object = None
    # binary threaded table of the whole tree (PacketPack), built for every tree
    packet: object = None


# ---------------------------------------------------------------------------
# Host build (numpy)
# ---------------------------------------------------------------------------

def _compute_miss_links(offset, n_prims):
    """Threaded-BVH miss links for the depth-first layout: where traversal
    jumps after a box miss / finished leaf.  For interior node i (children
    i+1 and offset[i]): miss[i+1] = offset[i]; miss[offset[i]] = miss[i].
    Root's miss is -1 (terminate)."""
    nn = len(offset)
    miss = np.full(nn, -1, np.int32)
    stack = [(0, -1)]
    while stack:
        node, m = stack.pop()
        miss[node] = m
        if n_prims[node] == 0:  # interior
            right = offset[node]
            stack.append((node + 1, right))  # left child -> sibling
            stack.append((right, m))         # right child -> my miss
    return miss


def _compute_octant_links(offset, n_prims, axis):
    """Eight threaded orderings of the same tree, one per ray-direction
    octant, each visiting the NEAR child first: octant bit a set means the
    direction is negative along axis a, so the right (upper) child is nearer
    and is visited first.

    Vectorized per BFS level (parents strictly precede children in the
    depth-first layout, and a child's miss depends only on its parent's
    already-final miss).  Returns (first8, miss8), both (8, NN) int32."""
    nn = len(offset)
    is_inner = n_prims == 0
    inner = np.nonzero(is_inner)[0]
    left = (inner + 1).astype(np.int32)
    right = offset[inner].astype(np.int32)
    # (8, NI): near child per octant for every inner node
    neg = ((np.arange(8, dtype=np.int32)[:, None] >> axis[inner][None, :]) & 1)
    near = np.where(neg == 1, right[None, :], left[None, :])
    far = np.where(neg == 1, left[None, :], right[None, :])

    first8 = np.full((8, nn), -1, np.int32)
    first8[:, inner] = near

    pos = np.full(nn, -1, np.int64)
    pos[inner] = np.arange(len(inner))
    miss8 = np.full((8, nn), -1, np.int32)
    frontier = np.array([0], dtype=np.int64)
    while len(frontier):
        fi = frontier[is_inner[frontier]]
        if len(fi) == 0:
            break
        p = pos[fi]
        for o in range(8):  # near targets are unique (one parent per child)
            miss8[o, near[o, p]] = far[o, p]
            miss8[o, far[o, p]] = miss8[o, fi]
        frontier = np.concatenate([fi + 1, offset[fi]])
    return first8, miss8


def _pack_leaf_soa(vertices, triangles, order):
    """(T_padded, 9) p0|p1|p2 rows in leaf order: one contiguous row fetch
    per leaf prim instead of an index-chase."""
    v = np.asarray(vertices, np.float32)
    t = np.asarray(triangles, np.int64)
    safe = np.maximum(order.astype(np.int64), 0)
    tri = t[safe]
    soa = np.concatenate([v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]], axis=1)
    soa[order < 0] = 0.0
    return soa.astype(np.float32)


def _align_leaves(off, npr, order, leaf_size=LEAF_SIZE):
    """Normalize the leaf rows so every leaf occupies EXACTLY leaf_size rows
    (short leaves padded with -1), so a whole leaf reads as one packed
    (leaf_size*9,) row.  Returns (new_off, new_order)."""
    off = np.asarray(off, np.int64)
    npr = np.asarray(npr, np.int64)
    order = np.asarray(order, np.int64)
    leaves = np.nonzero(npr > 0)[0]
    if len(leaves) == 0:
        # leafless (empty-mesh) tree: zero leaf rows, offsets untouched
        return off.astype(np.int32), np.zeros((0,), np.int32)
    leaves = leaves[np.argsort(off[leaves], kind="stable")]
    cnt = npr[leaves]
    nl = len(leaves)
    new_order = np.full(nl * leaf_size, -1, np.int64)
    tot = int(cnt.sum())
    leaf_of = np.repeat(np.arange(nl), cnt)
    within = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    src = np.repeat(off[leaves], cnt) + within
    new_order[leaf_of * leaf_size + within] = order[src]
    new_off = off.copy()
    new_off[leaves] = np.arange(nl) * leaf_size
    return new_off.astype(np.int32), new_order.astype(np.int32)


@spanned("build.packet_pack")
def build_packet_pack(lo, hi, off, npr, order, soa, miss, first8=None,
                      miss8=None, device="cuda"):
    """PacketPack of a finished binary tree (host arrays): table for table
    what the JAX package's pack_bvh_for_pallas makes per cast."""
    dev = resolve_device(device)
    off = np.asarray(off, np.int32)
    npr = np.asarray(npr, np.int32)
    nn = len(off)
    nodes = np.zeros((nn, 8), np.float32)
    nodes[:, 0:3] = lo
    nodes[:, 3:6] = hi
    leaf_code = -(off // LEAF_SIZE + 1)
    if first8 is not None:
        first = np.where((npr > 0)[None, :], leaf_code[None, :],
                         np.asarray(first8, np.int32))
        meta = np.stack([first, np.asarray(miss8, np.int32)], axis=-1)
    else:
        seq = np.arange(nn, dtype=np.int32) + 1
        meta = np.stack([np.where(npr > 0, leaf_code, seq),
                         np.asarray(miss, np.int32)], axis=1)[None]
    leafs = np.asarray(soa, np.float32).reshape(-1, LEAF_SIZE * 9)
    tid = np.asarray(order, np.int32).reshape(-1, LEAF_SIZE)

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype, order="C")).to(dev)

    return PacketPack(put(nodes, np.float32), put(meta, np.int32),
                      put(leafs, np.float32), put(tid, np.int32))


def bvh_from_numpy(lo, hi, off, npr, ax, order, miss, soa, first8, miss8,
                   device="cuda"):
    """The BVH tables on a device, from finished host arrays, with the
    width-8 table (ops/wbvh.build_wide_pack) and the binary threaded table
    (build_packet_pack) made from them."""
    from .wbvh import build_wide_pack

    dev = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(dev)  # a copy

    i32, f32 = np.int32, np.float32
    wide = build_wide_pack(off, npr, ax, lo, hi, order, soa, device=dev)
    packet = build_packet_pack(lo, hi, off, npr, order, soa, miss, first8,
                               miss8, device=dev)
    return BVH(put(lo, f32), put(hi, f32), put(off, i32), put(npr, i32),
               put(ax, i32), put(order, i32), put(miss, i32), put(soa, f32),
               None if first8 is None else put(first8, i32),
               None if miss8 is None else put(miss8, i32), None, wide, packet)


def _finish_build(arrs, vertices, triangles, orig_ids=None, device="cuda"):
    lo, hi, off, npr, ax, order = (np.asarray(a) for a in arrs)
    off, order = _align_leaves(off, npr, order)
    if orig_ids is not None:
        # subset build (big-prim separation): remap prim ids to GLOBAL
        # triangle ids before any table packs them
        orig_ids = np.asarray(orig_ids, np.int64)
        order = np.where(order >= 0, orig_ids[np.maximum(order, 0)],
                         -1).astype(np.int32)
    miss = _compute_miss_links(off, npr)
    soa = _pack_leaf_soa(vertices, triangles, order)
    first8, miss8 = _compute_octant_links(off, npr, ax)
    return bvh_from_numpy(lo, hi, off, npr, ax, order, miss, soa, first8,
                          miss8, device=device)


@spanned("build.bvh")
def build_bvh(vertices, triangles, leaf_size=LEAF_SIZE, subset=None,
              builder=None, device="cuda"):
    """SAH BVH over triangles; returns the BVH tables on `device`.

    subset: optional index array — build the tree over triangles[subset]
    only, with prim ids remapped back to GLOBAL triangle ids (big-prim
    separation: the caller brute-forces a few huge triangles instead and
    their hit t tightens the walk's t_max).

    builder: "native" (the C++ builder, native/), "numpy"
    (build_bvh_numpy), or None: the C++ builder, and the numpy one if it
    cannot be compiled or gives up.  On the blob meshes the two make the
    same nodes, boxes and leaf sets but order the triangles inside a leaf
    differently (the C++ builder partitions in place), so the leaf tables
    are not byte-equal and a tie in t can go to another triangle: a caller
    that needs one particular table names its builder."""
    if builder not in (None, "native", "numpy"):
        raise ValueError(f"unknown BVH builder {builder!r}")
    vertices = np.asarray(vertices, np.float32)
    all_triangles = triangles = np.asarray(triangles, np.int32)
    orig_ids = None
    if subset is not None:
        orig_ids = np.asarray(subset, np.int64)
        triangles = triangles[orig_ids]
    built = None
    if builder != "numpy":
        try:
            from ..native import build_bvh_sah

            built = build_bvh_sah(vertices, triangles, leaf_size)
        except (OSError, FileNotFoundError) as e:
            # no g++, or the library cannot be loaded
            if builder == "native":
                raise RuntimeError(f"the native BVH builder is unavailable: {e}")
        except Exception as e:  # subprocess.CalledProcessError and the like
            if builder == "native":
                raise RuntimeError(f"the native BVH builder failed: {e}")
        if built is None and builder == "native":
            raise RuntimeError("the native BVH builder gave up on this mesh")
    if built is None:
        built = build_bvh_numpy(vertices, triangles, leaf_size)
    # the leaf tables are packed by GLOBAL id, so from the whole triangle list
    # (the JAX package packs from the subset list, which is only right when
    # the subset is a prefix, as it is for the floor of presets.envmap_mesh)
    return _finish_build(built, vertices, all_triangles, orig_ids,
                         device=device)


def build_bvh_numpy(vertices, triangles, leaf_size=LEAF_SIZE):
    v = np.asarray(vertices, np.float64)
    t = np.asarray(triangles, np.int64)
    p0, p1, p2 = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    centroid = 0.5 * (lo + hi)
    n = len(t)

    # growable node arrays
    nodes_lo, nodes_hi, nodes_off, nodes_np, nodes_ax = [], [], [], [], []
    order = []

    def new_node():
        nodes_lo.append(np.zeros(3))
        nodes_hi.append(np.zeros(3))
        nodes_off.append(0)
        nodes_np.append(0)
        nodes_ax.append(0)
        return len(nodes_lo) - 1

    def build(idx):
        """idx: array of triangle indices for this subtree. Returns node id.
        Recursion depth ~ log2(T) with SAH splits; degenerate cases fall
        back to a median split."""
        me = new_node()
        b_lo = lo[idx].min(0)
        b_hi = hi[idx].max(0)
        nodes_lo[me] = b_lo
        nodes_hi[me] = b_hi
        if len(idx) <= leaf_size:
            nodes_off[me] = len(order)
            nodes_np[me] = len(idx)
            order.extend(idx.tolist())
            return me
        c = centroid[idx]
        c_lo, c_hi = c.min(0), c.max(0)
        dim = int(np.argmax(c_hi - c_lo))
        if c_hi[dim] - c_lo[dim] < 1e-12:
            # degenerate: all centroids identical.  The leaf intersectors
            # test a fixed LEAF_SIZE window, so an oversized leaf would
            # silently drop prims — split arbitrarily in half until leaves
            # fit.
            half = len(idx) // 2
            nodes_ax[me] = dim
            build(idx[:half])
            second = build(idx[half:])
            nodes_off[me] = second
            nodes_np[me] = 0
            return me
        # 12-bucket SAH
        nb = 12
        which = np.minimum(
            (nb * (c[:, dim] - c_lo[dim]) / (c_hi[dim] - c_lo[dim])).astype(int),
            nb - 1,
        )
        counts = np.bincount(which, minlength=nb)
        blo = np.full((nb, 3), np.inf)
        bhi = np.full((nb, 3), -np.inf)
        for bkt in range(nb):
            m = which == bkt
            if m.any():
                blo[bkt] = lo[idx][m].min(0)
                bhi[bkt] = hi[idx][m].max(0)

        def area(l, h):
            d = np.maximum(h - l, 0)
            return 2 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])

        cost = np.empty(nb - 1)
        for i in range(nb - 1):
            l_lo = blo[: i + 1][counts[: i + 1] > 0]
            l_hi = bhi[: i + 1][counts[: i + 1] > 0]
            r_lo = blo[i + 1:][counts[i + 1:] > 0]
            r_hi = bhi[i + 1:][counts[i + 1:] > 0]
            c0 = counts[: i + 1].sum()
            c1 = counts[i + 1:].sum()
            a0 = area(l_lo.min(0), l_hi.max(0)) if c0 else 0.0
            a1 = area(r_lo.min(0), r_hi.max(0)) if c1 else 0.0
            cost[i] = 1 + (c0 * a0 + c1 * a1) / max(area(b_lo, b_hi), 1e-12)
        # (no "cost >= leaf_cost -> big leaf" branch: len(idx) > leaf_size
        # here, and oversized leaves overflow the fixed LEAF_SIZE window —
        # always split instead)
        split = int(np.argmin(cost))
        left_mask = which <= split
        if not left_mask.any() or left_mask.all():
            half = len(idx) // 2
            srt = idx[np.argsort(c[:, dim])]
            li, ri = srt[:half], srt[half:]
        else:
            li, ri = idx[left_mask], idx[~left_mask]
        nodes_ax[me] = dim
        build(li)
        second = build(ri)
        nodes_off[me] = second
        nodes_np[me] = 0
        return me

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        build(np.arange(n))
    finally:
        sys.setrecursionlimit(old)

    # pad prim order to multiple of leaf_size with -1
    pad = (-len(order)) % leaf_size
    order_arr = np.asarray(order + [-1] * pad, np.int32)
    return (
        np.asarray(nodes_lo, np.float32),
        np.asarray(nodes_hi, np.float32),
        np.asarray(nodes_off, np.int32),
        np.asarray(nodes_np, np.int32),
        np.asarray(nodes_ax, np.int32),
        order_arr,
    )


# ---------------------------------------------------------------------------
# Per-lane walks (plain PyTorch, any device)
# ---------------------------------------------------------------------------
#
# The JAX package's lockstep walks, lane for lane: every lane keeps its own
# cursor (and, in the stack walks, its own stack), and all lanes take one
# step together until none is left walking or MAX_TRAV_STEPS steps have been
# taken.  The leaf test is Moller-Trumbore, not the watertight test of the
# kernels.  A step here is taken only by the lanes that were still walking
# at the last check (every SYNC_STEPS steps): a lane that has finished does
# not change any more, so leaving it out changes no result, and the checks
# never let the loop run past step MAX_TRAV_STEPS.

def _slab_test(lo, hi, o, inv_d, t_max):
    """Bounds3::IntersectP slab test batched over lanes, with the gamma(3)
    widening of the far distance."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1) * (1.0 + 2.0 * 7.2e-7)
    return (t_near <= t_far) & (t_far > 0) & (t_near < t_max)


def _leaf_rows(prim_idx, leaf_off):
    """(N, LEAF_SIZE) rows of the reordered primitive list from leaf_off on.
    An inner node's offset is its second child's node id, which may lie past
    the list: the index is clamped to its last row, as a JAX gather clamps
    it (the values are masked out by the caller)."""
    rows = leaf_off.long()[:, None] + torch.arange(
        LEAF_SIZE, dtype=torch.long, device=leaf_off.device)[None, :]
    return torch.clamp(rows, 0, prim_idx.shape[0] - 1)


def _moller_trumbore(p0, p1, p2, o, d, ok, t_best):
    """Moller-Trumbore against (N, K) triangles: (t, valid, uv (N,K,2))."""
    e1 = p1 - p0
    e2 = p2 - p0
    dv = d[:, None].expand_as(e2)
    pv = torch.linalg.cross(dv, e2, dim=-1)
    det = torch.sum(e1 * pv, dim=-1)
    big = torch.abs(det) > 1e-12
    inv = torch.where(big, 1.0 / det, 0.0)
    tv = o[:, None] - p0
    u = torch.sum(tv * pv, dim=-1) * inv
    qv = torch.linalg.cross(tv, e1, dim=-1)
    v = torch.sum(dv * qv, dim=-1) * inv
    t = torch.sum(e2 * qv, dim=-1) * inv
    valid = ok & big & (u >= 0) & (v >= 0) & (u + v <= 1)
    valid = valid & (t > 1e-5) & (t < t_best[:, None])
    return t, valid, torch.stack([u, v], dim=-1)


def _leaf_intersect(verts, tris, prim_idx, leaf_off, o, d, t_best):
    """Intersect the LEAF_SIZE prims of each lane's leaf (masked),
    Moller-Trumbore, fetching vertices through the triangle list.
    Returns (t (N,K), valid (N,K), ids (N,K), uv (N,K,2))."""
    ids = prim_idx[_leaf_rows(prim_idx, leaf_off)]
    safe = torch.clamp(ids, min=0).long()
    tri = tris[safe].long()
    p0, p1, p2 = (verts[tri[..., k]] for k in range(3))
    t, valid, uv = _moller_trumbore(p0, p1, p2, o, d, ids >= 0, t_best)
    return t, valid, safe, uv


def _leaf_intersect_soa(bvh, leaf_off, o, d, t_best):
    """The same test from the packed (T_padded, 9) leaf rows: one row fetch
    a prim instead of the triangle -> vertex chase."""
    rows = _leaf_rows(bvh.prim_idx, leaf_off)
    ids = bvh.prim_idx[rows]
    soa = bvh.leaf_soa[rows]
    t, valid, uv = _moller_trumbore(soa[..., 0:3], soa[..., 3:6],
                                    soa[..., 6:9], o, d, ids >= 0, t_best)
    return t, valid, torch.clamp(ids, min=0).long(), uv


def _inv_dir(d):
    return 1.0 / torch.where(torch.abs(d) < 1e-20,
                             torch.where(d < 0, -1e-20, 1e-20), d)


def _closest_update(s, t, valid, ids, uv, is_leaf):
    """Fold one leaf test into a lane's best hit: the first of equal t wins
    (argmin), and only a strictly nearer t replaces the best."""
    t_m = torch.where(valid & is_leaf[:, None], t, INFINITY)
    k = torch.argmin(t_m, dim=-1, keepdim=True)
    t_new = torch.gather(t_m, 1, k)[:, 0]
    better = t_new < s["t_best"]
    s["t_best"] = torch.where(better, t_new, s["t_best"])
    s["tri"] = torch.where(better, torch.gather(ids, 1, k)[:, 0].to(torch.int32),
                           s["tri"])
    s["uv"] = torch.where(better[:, None],
                          torch.gather(uv, 1, k[..., None].expand(-1, 1, 2))[:, 0],
                          s["uv"])
    s["found"] = s["found"] | better


SYNC_STEPS = 16  # steps between two checks of which lanes are still walking


def _lockstep(state, step, walking, stats=None):
    """Run step(s, lanes) -> s on the lanes still walking until none is left
    or MAX_TRAV_STEPS steps have been taken (the JAX loop's cap, exactly).
    state: dict of (N, ...) tensors, updated in place; lanes: the global
    lane ids of s's rows.  walking(s) -> (W,) bool.  stats (optional dict)
    gets steps (the loop's iterations, as the JAX loop counts them: the
    steps in which some lane was walking), lane_steps, and capped (lanes
    still walking at the cap)."""
    n = next(iter(state.values())).shape[0]
    dev = next(iter(state.values())).device
    lanes = torch.arange(n, device=dev)
    lane_steps = torch.zeros((n,), dtype=torch.int32, device=dev)
    capped, step_no = 0, 0
    while n > 0 and lanes.numel() and step_no < MAX_TRAV_STEPS:
        whole = lanes.numel() == n
        start = dict(state) if whole else {k: v[lanes]
                                           for k, v in state.items()}
        s = dict(start)
        taken = torch.zeros((lanes.numel(),), dtype=torch.int32, device=dev)
        for _ in range(min(SYNC_STEPS, MAX_TRAV_STEPS - step_no)):
            if stats is not None:
                taken += walking(s).to(torch.int32)
            s = step(s, lanes)
            step_no += 1
        for k, v in s.items():
            if v is start[k]:
                continue  # the rays' own data: never written
            if whole:
                state[k] = v
            else:
                state[k][lanes] = v
        lane_steps[lanes] += taken
        still = walking(s)
        if step_no >= MAX_TRAV_STEPS:
            capped = int(still.sum())
        lanes = lanes[still]
    if stats is not None:
        stats["steps"] = stats.get("steps", 0) + (int(lane_steps.max())
                                                  if n else 0)
        stats["lane_steps"] = stats.get("lane_steps", 0) + int(lane_steps.sum())
        stats["capped"] = stats.get("capped", 0) + capped
    return state


def _trihit(s):
    uv = s["uv"]
    b = torch.stack([1.0 - uv[:, 0] - uv[:, 1], uv[:, 0], uv[:, 1]], dim=-1)
    return TriHit(hit=s["found"],
                  t=torch.where(s["found"], s["t_best"], INFINITY),
                  tri=s["tri"], b=b)


def _rays(o, d, t_max):
    o = o.detach().to(torch.float32)
    d = d.detach().to(torch.float32)
    n = o.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    t_max = t_max.detach().expand(n).clone() if t_max.ndim == 0 \
        else t_max.detach().clone()
    return {"o": o, "d": d, "inv_d": _inv_dir(d)}, n, t_max


def _closest_state(o, d, t_max):
    s, n, t_max = _rays(o, d, t_max)
    dev = o.device
    s.update(t_best=t_max, tri=torch.zeros((n,), dtype=torch.int32, device=dev),
             uv=torch.zeros((n, 2), dtype=torch.float32, device=dev),
             found=torch.zeros((n,), dtype=torch.bool, device=dev))
    return s, n


def _node(bvh, node):
    node = node.long()
    return (bvh.bounds_lo[node], bvh.bounds_hi[node], bvh.n_prims[node],
            bvh.offset[node])


@torch.no_grad()
def bvh_closest_hit_stackless(bvh: BVH, o, d, t_max, stats=None):
    """Threaded (stackless) walk, closest hit: each lane steps to node + 1 on
    an inner box hit and to miss[node] otherwise (left child first); a leaf
    runs the LEAF_SIZE-wide masked Moller-Trumbore test from the packed leaf
    rows.  Returns TriHit with pbrt's barycentrics b = (1-u-v, u, v); t and
    b carry no gradient, as the kernels' casts do not.  stats: see
    _lockstep."""
    s, n = _closest_state(o, d, t_max)
    s["cursor"] = torch.zeros((n,), dtype=torch.int32, device=o.device)

    def step(s, lanes):
        active = s["cursor"] >= 0
        node = torch.clamp(s["cursor"], min=0)
        lo, hi, np_, off = _node(bvh, node)
        box = _slab_test(lo, hi, s["o"], s["inv_d"], s["t_best"]) & active
        is_leaf = (np_ > 0) & box
        is_inner = (np_ == 0) & box
        _closest_update(s, *_leaf_intersect_soa(bvh, off, s["o"], s["d"],
                                                s["t_best"]), is_leaf)
        nxt = torch.where(is_inner, node + 1, bvh.miss[node.long()])
        s["cursor"] = torch.where(active, nxt, s["cursor"])
        return s

    return _trihit(_lockstep(s, step, lambda s: s["cursor"] >= 0, stats))


@torch.no_grad()
def bvh_any_hit_stackless(bvh: BVH, o, d, t_max, stats=None):
    """Threaded walk, occlusion: (N,) bool, a lane ending at its first hit
    before t_max."""
    s, n, t_max = _rays(o, d, t_max)
    s.update(t_max=t_max,
             cursor=torch.zeros((n,), dtype=torch.int32, device=o.device),
             occ=torch.zeros((n,), dtype=torch.bool, device=o.device))

    def step(s, lanes):
        active = s["cursor"] >= 0
        node = torch.clamp(s["cursor"], min=0)
        lo, hi, np_, off = _node(bvh, node)
        box = _slab_test(lo, hi, s["o"], s["inv_d"], s["t_max"]) & active
        is_leaf = (np_ > 0) & box
        is_inner = (np_ == 0) & box
        _, valid, _, _ = _leaf_intersect_soa(bvh, off, s["o"], s["d"],
                                             s["t_max"])
        s["occ"] = s["occ"] | torch.any(valid & is_leaf[:, None], dim=-1)
        nxt = torch.where(is_inner, node + 1, bvh.miss[node.long()])
        s["cursor"] = torch.where(active & ~s["occ"], nxt,
                                  torch.where(active, -1, s["cursor"]))
        return s

    return _lockstep(s, step, lambda s: s["cursor"] >= 0, stats)["occ"]


def _stack_step(bvh, stack, s, lanes, ax, off, node, is_inner, stats):
    """The stack walk's move: an inner node whose box is hit goes on to the
    child nearer along the split axis and pushes the farther one (dropped
    when the lane's MAX_STACK entries are full); any other walking lane pops
    its stack, and retires when it is empty.  stack: the (N, MAX_STACK)
    stacks of all lanes, written in place at the pushing lanes' tops."""
    take_ax = torch.gather(s["dir_neg"], 1, ax.long()[:, None])[:, 0]
    near = torch.where(take_ax, off, node + 1)
    far = torch.where(take_ax, node + 1, off)
    sp = s["sp"]
    can_push = is_inner & (sp < MAX_STACK)
    if stats is not None:
        s["dropped"] = s["dropped"] + (is_inner & ~can_push).to(torch.int32)
    top = torch.clamp(sp, max=MAX_STACK - 1).long()
    stack[lanes, top] = torch.where(can_push, far, stack[lanes, top])
    sp = torch.where(can_push, sp + 1, sp)
    need_pop = s["active"] & ~is_inner
    pop = need_pop & (sp > 0)
    popped = stack[lanes, torch.clamp(sp - 1, min=0).long()]
    s["cursor"] = torch.where(is_inner, near, torch.where(pop, popped, node))
    s["sp"] = torch.where(pop, sp - 1, sp)
    s["active"] = s["active"] & ~(need_pop & (sp == 0))


def _stack_state(s, n, dev, stats):
    s.update(cursor=torch.zeros((n,), dtype=torch.int32, device=dev),
             sp=torch.zeros((n,), dtype=torch.int32, device=dev),
             active=torch.ones((n,), dtype=torch.bool, device=dev),
             dir_neg=s["inv_d"] < 0)
    if stats is not None:
        s["dropped"] = torch.zeros((n,), dtype=torch.int32, device=dev)
    return torch.zeros((n, MAX_STACK), dtype=torch.int32, device=dev)


def _stack_stats(s, stats):
    if stats is not None:
        stats["dropped_pushes"] = (stats.get("dropped_pushes", 0)
                                   + int(s["dropped"].sum()))


@torch.no_grad()
def bvh_closest_hit(bvh: BVH, verts, tris, o, d, t_max, stats=None):
    """Lockstep stack walk, closest hit: near child first by the sign of the
    ray's direction along the node's split axis, a MAX_STACK-deep stack a
    lane; leaves tested through the triangle and vertex lists.  Returns
    TriHit with pbrt's barycentrics b = (1-u-v, u, v); no gradient."""
    s, n = _closest_state(o, d, t_max)
    stack = _stack_state(s, n, o.device, stats)
    verts = verts.detach()

    def step(s, lanes):
        node = s["cursor"]
        lo, hi, np_, off = _node(bvh, node)
        box = _slab_test(lo, hi, s["o"], s["inv_d"], s["t_best"]) & s["active"]
        is_leaf = (np_ > 0) & box
        is_inner = (np_ == 0) & box
        _closest_update(s, *_leaf_intersect(verts, tris, bvh.prim_idx, off,
                                            s["o"], s["d"], s["t_best"]),
                        is_leaf)
        _stack_step(bvh, stack, s, lanes, bvh.axis[node.long()], off, node,
                    is_inner, stats)
        return s

    s = _lockstep(s, step, lambda s: s["active"], stats)
    _stack_stats(s, stats)
    return _trihit(s)


@torch.no_grad()
def bvh_any_hit(bvh: BVH, verts, tris, o, d, t_max, stats=None):
    """Lockstep stack walk, occlusion: (N,) bool; a lane retires at its
    first hit before t_max."""
    s, n, t_max = _rays(o, d, t_max)
    s.update(t_max=t_max,
             occ=torch.zeros((n,), dtype=torch.bool, device=o.device))
    stack = _stack_state(s, n, o.device, stats)
    verts = verts.detach()

    def step(s, lanes):
        node = s["cursor"]
        lo, hi, np_, off = _node(bvh, node)
        box = _slab_test(lo, hi, s["o"], s["inv_d"], s["t_max"]) & s["active"]
        is_leaf = (np_ > 0) & box
        is_inner = (np_ == 0) & box
        _, valid, _, _ = _leaf_intersect(verts, tris, bvh.prim_idx, off,
                                         s["o"], s["d"], s["t_max"])
        s["occ"] = s["occ"] | torch.any(valid & is_leaf[:, None], dim=-1)
        _stack_step(bvh, stack, s, lanes, bvh.axis[node.long()], off, node,
                    is_inner, stats)
        s["active"] = s["active"] & ~s["occ"]
        return s

    s = _lockstep(s, step, lambda s: s["active"], stats)
    _stack_stats(s, stats)
    return s["occ"]


# ---------------------------------------------------------------------------
# Coherence sort
# ---------------------------------------------------------------------------

def _spread3(x):
    """Interleave 10 bits with 2-bit gaps (30-bit 3D morton support);
    x: int64 tensor holding a value below 2^10."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton(o, lo, ext, bits):
    top = float((1 << bits) - 1)
    q = torch.clamp((o - lo) / ext * top, 0, top).to(torch.int64)
    return (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
            | (_spread3(q[:, 2]) << 2))


def ray_sort_perm(o, d, lo, hi, t_max=None, key_mode="oct_morton"):
    """Coherence permutation of a ray wavefront: neighbouring lanes after the
    sort walk neighbouring parts of the tree.

    key_mode:
      "oct_morton"  — direction octant major, 5-bit origin morton minor:
                      for primary/shadow wavefronts where many origins share
                      a direction cone.
      "oct_morton8" — octant major, 8-bit origin morton.
      "morton_oct"  — 8-bit origin morton major, octant minor: for bounce
                      wavefronts whose origins cluster on a surface.
      "morton6d"    — interleaved position (6 bit) + direction (4 bit).

    When t_max is given, lanes with t_max <= 0 (dead wavefront lanes) sort
    to the END.  The sort is stable, as the JAX package's is.  Results of a
    cast do not depend on the permutation.  Returns (perm, inv_perm), int64."""
    ext = torch.clamp(hi - lo, min=1e-6)
    neg = (d < 0).to(torch.int64)
    octant = neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2)
    if key_mode == "oct_morton":
        key = (octant << 15) | _morton(o, lo, ext, 5)
    elif key_mode == "oct_morton8":
        key = (octant << 24) | _morton(o, lo, ext, 8)
    elif key_mode == "morton_oct":
        key = (_morton(o, lo, ext, 8) << 3) | octant
    elif key_mode == "morton6d":
        qd = torch.clamp((d * 0.5 + 0.5) * 15.0, 0, 15).to(torch.int64)
        dm = (_spread3(qd[:, 0]) | (_spread3(qd[:, 1]) << 1)
              | (_spread3(qd[:, 2]) << 2))
        key = (_morton(o, lo, ext, 6) << 12) | dm
    else:
        raise ValueError(key_mode)
    if t_max is not None:
        key = torch.where(t_max <= 0, 0x7FFFFFFF, key)
    perm = torch.argsort(key, stable=True)
    n = perm.shape[0]
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, dtype=perm.dtype, device=perm.device)
    return perm, inv
