"""BVH: host-side SAH build in numpy into SoA tables, and the coherence
sort of a ray wavefront.

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

from ..utils.device import resolve_device

LEAF_SIZE = 4


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
