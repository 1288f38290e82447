"""LBVH build: Morton codes, a stable sort and binary-radix linking on the
scene's device, then a host pass into the tables the casts walk.

  * centroids of the triangle boxes, normalized over their bounds, give
    30-bit Morton codes (``morton3``); a stable argsort orders the
    triangles, equal codes by index;
  * the Karras (2012) binary radix tree links T-1 internal nodes over the
    sorted leaves: each node's direction, the far end of its range (a
    24-step doubling search and a 25-step bisection) and its split (a
    25-step search), every step one elementwise pass over T-1 lanes.  Equal
    codes are told apart by the bits of their indices (``_clz32`` + 32), so
    the tree is strict;
  * the node boxes are fitted bottom up, both children read from the
    previous sweep, until a sweep changes no box;
  * ``lbvh_to_linear`` lays the tree out depth first (left subtree, then
    right) into the SoA arrays of ops/bvh.py, one triangle a leaf, and
    ops/bvh._finish_build makes the padded leaf rows, the miss and octant
    links and the width-8 and binary threaded tables from them.

Words are uint32 in meaning and held in int64 tensors; every product is
masked back to 32 bits.

The JAX package fits the boxes with a fixed ceil(log2 T) + 2 sweeps.  A
Karras tree can be deeper than that (the 104,882-triangle blob mesh of
presets.envmap_mesh: height 29 against 19 sweeps), and then some boxes come
out too small and a walk that culls by box never reaches the triangles
outside them.  The fit here runs to the tree's real height.  Wherever the
JAX package's fit converged, the tables are byte-equal to its own; where it
did not, they differ, and every node box here contains its children.
"""

import numpy as np
import torch

from ..utils.device import resolve_device

_MASK32 = 0xFFFFFFFF


def _expand_bits(v):
    """Spread the low 10 bits of v to every third bit (int64 tensor)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3(p01):
    """30-bit Morton codes (int64) of points normalized to [0,1)^3."""
    q = torch.clamp(p01 * 1024.0, 0.0, 1023.0).to(torch.int64)
    return ((_expand_bits(q[..., 2]) << 2) | (_expand_bits(q[..., 1]) << 1)
            | _expand_bits(q[..., 0]))


def _clz32(x):
    """Leading zeros of a 32-bit word (int64 tensor < 2^32): a bit smear
    and a SWAR popcount, exact for every word."""
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    pop = ((x * 0x01010101) & _MASK32) >> 24
    return 32 - pop


def karras_tree(vertices, triangles):
    """Device part: centroids, Morton codes, the sort and the Karras links.
    vertices (V,3) f32, triangles (T,3) int tensors on one device, T >= 2.

    Returns a dict of tensors: order (T,) triangle ids in Morton order;
    left / right (T-1,) children of each internal node (< T-1: internal,
    >= T-1: the leaf i - (T-1)); first / last (T-1,) the leaf range of each
    node; leaf_lo / leaf_hi (T,3) the sorted leaves' boxes."""
    tri = triangles.long()
    p0, p1, p2 = (vertices[tri[:, k]] for k in range(3))
    lo = torch.minimum(torch.minimum(p0, p1), p2)
    hi = torch.maximum(torch.maximum(p0, p1), p2)
    c = 0.5 * (lo + hi)
    w_lo = torch.amin(c, dim=0)
    w_hi = torch.amax(c, dim=0)
    codes = morton3((c - w_lo) / torch.clamp(w_hi - w_lo, min=1e-12))
    order = torch.argsort(codes, stable=True)
    sc = codes[order]
    t = tri.shape[0]
    n_int = t - 1

    def delta(i, j):
        """Common prefix length of sorted codes i and j (equal codes: 32 +
        that of the indices); -1 where j is out of range."""
        valid = (j >= 0) & (j < t)
        x = sc[torch.clamp(i, 0, t - 1)] ^ sc[torch.clamp(j, 0, t - 1)]
        xi = (i ^ j) & _MASK32
        pre = torch.where(x == 0, _clz32(xi) + 32, _clz32(x))
        return torch.where(valid, pre, -1)

    i = torch.arange(n_int, dtype=torch.int64, device=vertices.device)
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    max_log = 24  # T < 2^24 triangles
    lmax = torch.full_like(i, 2)
    for _ in range(max_log):
        bigger = delta(i, i + lmax * d) > delta_min
        lmax = torch.where(bigger & (lmax < (1 << max_log)), lmax * 2, lmax)
    l = torch.zeros_like(i)
    step = lmax // 2
    for _ in range(max_log + 1):
        cond = delta(i, i + (l + step) * d) > delta_min
        l = torch.where((step > 0) & cond, l + step, l)
        step = step // 2
    j = i + l * d

    delta_node = delta(i, j)
    s = torch.zeros_like(i)
    div = torch.full_like(i, 2)
    for _ in range(max_log + 1):
        tt = (l + div - 1) // div
        cond = delta(i, i + (s + tt) * d) > delta_node
        s = torch.where((tt > 0) & cond, s + tt, s)
        div = div * 2
    gamma = i + s * d + torch.clamp(d, max=0)

    first = torch.minimum(i, j)
    last = torch.maximum(i, j)
    left = torch.where(first == gamma, gamma + n_int, gamma)
    right = torch.where(last == gamma + 1, gamma + 1 + n_int, gamma + 1)
    return dict(order=order, left=left, right=right, first=first, last=last,
                gamma=gamma, leaf_lo=lo[order], leaf_hi=hi[order])


def fit_bounds(tree):
    """Node boxes bottom up: each sweep sets every internal node's box to
    the union of its children's boxes of the previous sweep, until a sweep
    changes nothing (the tree's height + 1 sweeps; a Karras tree over T
    leaves is at most T - 1 high).  Raises ValueError on a non-finite
    vertex, whose NaN boxes would never settle.  Returns (node_lo,
    node_hi)."""
    left, right = tree["left"], tree["right"]
    leaf_lo, leaf_hi = tree["leaf_lo"], tree["leaf_hi"]
    if not bool(torch.isfinite(leaf_lo).all() & torch.isfinite(leaf_hi).all()):
        raise ValueError("LBVH build: a triangle has a non-finite vertex")
    n_int = left.shape[0]
    t = leaf_lo.shape[0]
    node_lo = torch.full((n_int, 3), float("inf"), device=leaf_lo.device)
    node_hi = torch.full((n_int, 3), float("-inf"), device=leaf_lo.device)

    def child(idx, nl, nh):
        is_leaf = (idx >= n_int)[:, None]
        li = torch.clamp(idx - n_int, 0, t - 1)
        ii = torch.clamp(idx, 0, n_int - 1)
        return (torch.where(is_leaf, leaf_lo[li], nl[ii]),
                torch.where(is_leaf, leaf_hi[li], nh[ii]))

    for _ in range(n_int + 1):
        llo, lhi = child(left, node_lo, node_hi)
        rlo, rhi = child(right, node_lo, node_hi)
        new_lo, new_hi = torch.minimum(llo, rlo), torch.maximum(lhi, rhi)
        same = torch.equal(new_lo, node_lo) and torch.equal(new_hi, node_hi)
        node_lo, node_hi = new_lo, new_hi
        if same:
            return node_lo, node_hi
    raise ValueError(f"LBVH box fit did not settle in {n_int + 1} sweeps")


def lbvh_to_linear(tree, node_lo, node_hi):
    """The Karras tree in the depth-first layout of ops/bvh.py, on the host:
    (lo, hi, offset, n_prims, axis, prim order) numpy arrays, one triangle a
    leaf.  A node's position is its parent's + 1 (left child) or + 1 + the
    left subtree's 2k - 1 nodes (right child, k the left child's leaves);
    positions are set one tree level at a time, no recursion."""
    order = tree["order"].cpu().numpy()
    left = tree["left"].cpu().numpy()
    right = tree["right"].cpu().numpy()
    first = tree["first"].cpu().numpy()
    gamma = tree["gamma"].cpu().numpy()
    nlo, nhi = node_lo.cpu().numpy(), node_hi.cpu().numpy()
    llo = tree["leaf_lo"].cpu().numpy()
    lhi = tree["leaf_hi"].cpu().numpy()
    t = len(order)
    n_int = t - 1
    nn = 2 * t - 1
    pos = np.zeros(nn, np.int64)  # tree id (internal i, leaf n_int + l)
    frontier = np.array([0], np.int64)
    while len(frontier):
        p = pos[frontier]
        lc, rc = left[frontier], right[frontier]
        pos[lc] = p + 1
        pos[rc] = p + 1 + 2 * (gamma[frontier] - first[frontier] + 1) - 1
        nxt = np.concatenate([lc, rc])
        frontier = nxt[nxt < n_int]

    lo = np.empty((nn, 3), np.float32)
    hi = np.empty((nn, 3), np.float32)
    off = np.zeros(nn, np.int32)
    npr = np.zeros(nn, np.int32)
    ax = np.zeros(nn, np.int32)
    pi, pl = pos[:n_int], pos[n_int:]
    lo[pi], hi[pi] = nlo, nhi
    off[pi] = pos[right]
    ax[pi] = np.argmax(nhi - nlo, axis=1)
    lo[pl], hi[pl] = llo, lhi
    off[pl] = np.arange(t)  # leaves come in sorted order, depth first
    npr[pl] = 1
    return lo, hi, off, npr, ax, order.astype(np.int32)


def build_lbvh(vertices, triangles, device="cuda"):
    """LBVH over triangles: the Morton sort, the links and the box fit on
    `device`, the layout on the host; returns the BVH tables on `device`
    (ops/bvh.BVH, with the width-8 and binary threaded tables)."""
    from .bvh import _finish_build

    dev = resolve_device(device)
    v = np.asarray(vertices, np.float32)
    tri = np.asarray(triangles, np.int32).reshape(-1, 3)
    if len(tri) == 1:
        p = v[tri[0]]
        arrs = (p.min(0)[None], p.max(0)[None], np.zeros(1, np.int32),
                np.ones(1, np.int32), np.zeros(1, np.int32),
                np.zeros(1, np.int32))
    else:
        tree = karras_tree(torch.from_numpy(v).to(dev),
                           torch.from_numpy(tri).to(dev))
        arrs = lbvh_to_linear(tree, *fit_bounds(tree))
    return _finish_build(arrs, v, tri, device=dev)
