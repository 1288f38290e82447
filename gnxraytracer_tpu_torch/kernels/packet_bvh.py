"""Closest hit and any hit over the binary threaded (miss-link) BVH: the
wrappers of the CUDA kernels in csrc/packet_bvh.cu, and the plain PyTorch
versions beside them.

The kernels replace the JAX package's TPU kernels
ops/pallas_bvh.py::_make_kernel and ::_make_any_kernel (see the note in the
.cu file for what bounds them on an H100 and what the design does about it).
On CUDA tensors ``packet_closest_hit`` / ``packet_any_hit`` launch the kernel
or raise; on CPU tensors they run ``packet_closest_hit_reference`` /
``packet_any_hit_reference``, which are also what the kernels are held
against on the card.

The walk needs no stack: a ray's state is one cursor and its best hit.  From
node ``cur`` it tests the node's box; a wanted inner node sends the cursor to
its first (nearer) child in the order of the ray's direction octant, a wanted
leaf tests its packed row (LEAF_SIZE watertight tests in row order, strict
t < t_best) and then, like a node that is not wanted, follows the miss link;
-1 ends the walk.  The plain versions walk the SAME table (ops/bvh.PacketPack)
in lockstep, every lane with its own cursor and its own octant, so a lane's
sequence of visits is exactly a kernel thread's and ties in t go to the same
triangle in both.  A kernel cast is two launches: a triage of every ray
(``entering`` is its plain version) and the walk of the rays it lists.

``_use_wide`` is the JAX package's rule for which walk serves
``bvh_mode="pallas"`` / ``"packet"``: the wide table unless the environment
says ``GNX_WIDE_BVH=0``.
"""

import ctypes
import os

import torch

from ..ops.intersect import TriHit, _permute_shear
from . import build
from .closest_hit import _check
from .wide_bvh import (_SLAB_WIDEN, _check_leaf_tables, _check_rays,
                       _empty_trihit, _launch, _leaf_rows, _safe_inv,
                       _sorted_cast, _trihit)

# launches of each CUDA kernel (and nothing else) since the last reset
closest_launch_count = 0
any_launch_count = 0


def reset_launch_counts():
    global closest_launch_count, any_launch_count
    closest_launch_count = 0
    any_launch_count = 0


def _use_wide(bvh):
    """Whether the casts of a tree go to the wide walk (kernels/wide_bvh.py):
    whenever the tree carries the wide table, unless GNX_WIDE_BVH=0 (read at
    call time) asks for the binary threaded walk."""
    return (getattr(bvh, "wide", None) is not None
            and os.environ.get("GNX_WIDE_BVH", "1") != "0")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _wants(rows, o, inv, t_best):
    """The slab test of _slab_want: lanes with origins o, safe inverse
    directions inv and best t t_best against the boxes rows[:, 0:6]."""
    tx0 = (rows[:, 0] - o[:, 0]) * inv[:, 0]
    tx1 = (rows[:, 3] - o[:, 0]) * inv[:, 0]
    ty0 = (rows[:, 1] - o[:, 1]) * inv[:, 1]
    ty1 = (rows[:, 4] - o[:, 1]) * inv[:, 1]
    tz0 = (rows[:, 2] - o[:, 2]) * inv[:, 2]
    tz1 = (rows[:, 5] - o[:, 2]) * inv[:, 2]
    tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                     torch.minimum(ty0, ty1)),
                       torch.minimum(tz0, tz1))
    tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                     torch.maximum(ty0, ty1)),
                       torch.maximum(tz0, tz1)) * _SLAB_WIDEN
    return (tn <= tf) & (tf > 0) & (tn < t_best) & (t_best > 0)


def _octant_base(pack, d):
    """Each ray's row offset into pack.meta viewed as (K * NN, 2)."""
    if pack.meta.shape[0] == 8:
        neg = (d < 0).to(torch.int64)
        return (neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2)) * pack.meta.shape[1]
    return torch.zeros((d.shape[0],), dtype=torch.int64, device=d.device)


def entering(pack, o, d, t_max):
    """The plain version of the kernels' first pass: (N,) bool, the rays it
    leaves to the walk, those that are live and that the root wants (or
    whose root miss link goes on: a table that does not thread a tree, which
    the walk then refuses).  Every other ray gets the miss record there, and
    its walk is the root's test (none for a dead ray)."""
    t = t_max.to(torch.float32)
    root = pack.nodes[0:1].expand(o.shape[0], -1)
    miss = pack.meta.reshape(-1, 2)[_octant_base(pack, d), 1]
    return (t > 0) & (_wants(root, o, _safe_inv(d), t) | (miss >= 0))


def _walk(pack, o, d, t_max, any_hit, stats=None, ray_visits=None):
    """The lockstep walk both plain versions share.  Returns (t_best, tri,
    u, v, found); tri = -1 where nothing was found.  ray_visits: an optional
    (N,) int64 tensor that gets each ray's node visits added."""
    n = o.shape[0]
    dev = o.device
    nn = pack.meta.shape[1]
    meta = pack.meta.reshape(-1, 2)

    inv = _safe_inv(d)
    base = _octant_base(pack, d)
    (m0, m1), (sx, sy, sz) = _permute_shear(d)

    t_best = t_max.to(torch.float32).clone()
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    v = torch.zeros((n,), dtype=torch.float32, device=dev)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    # the root, or nowhere for a dead lane (t_max <= 0 wants no node)
    cur = torch.where(t_best > 0, 0, -1)

    node_visits = leaf_visits = steps = 0
    while True:
        live = torch.nonzero(cur >= 0)[:, 0]
        if live.numel() == 0:
            break
        steps += 1
        if steps > nn:  # a threaded walk visits each node at most once
            raise RuntimeError(
                f"binary BVH walk: more than {nn} steps in a tree of {nn} "
                "nodes (its links do not thread a tree)")
        node_visits += int(live.numel())
        if ray_visits is not None:
            ray_visits[live] += 1
        c = cur[live]
        link = meta[base[live] + c]                            # (M, 2)
        want = _wants(pack.nodes[c], o[live], inv[live], t_best[live])
        first = link[:, 0].to(torch.int64)
        is_leaf = first < 0
        nxt = torch.where(want & ~is_leaf, first, link[:, 1].to(torch.int64))
        cur[live] = nxt

        at_leaf = want & is_leaf
        li = live[at_leaf]
        if li.numel():
            leaf_visits += int(li.numel())
            found_l = _leaf_rows(pack, -first[at_leaf] - 1, li, o,
                                 (m0, m1, sx, sy, sz), t_best, tri, u, v,
                                 found, any_hit)
            if any_hit:
                cur[li[found_l]] = -1  # the first hit before t_max ends it
    if stats is not None:
        stats["node_visits"] = stats.get("node_visits", 0) + node_visits
        stats["leaf_visits"] = stats.get("leaf_visits", 0) + leaf_visits
    return t_best, tri, u, v, found


def packet_closest_hit_reference(pack, o, d, t_max, stats=None,
                                 ray_visits=None):
    """Plain PyTorch version of the closest-hit kernel, any device.  stats:
    an optional dict that gets the walk's node_visits (box tests) and
    leaf_visits (leaf rows tested), summed over rays, added; ray_visits: see
    _walk.  The kernel's triage pass makes the root's test of every live ray
    and its walk pass makes it again for the rays it walks; the walk here
    makes it once, and counts it once, as the JAX package's walk does."""
    return _trihit(*_walk(pack, o, d, t_max, any_hit=False, stats=stats,
                          ray_visits=ray_visits))


def packet_any_hit_reference(pack, o, d, t_max, stats=None, ray_visits=None):
    """Plain PyTorch version of the any-hit kernel: (N,) bool."""
    return _walk(pack, o, d, t_max, any_hit=True, stats=stats,
                 ray_visits=ray_visits)[4]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_fns = None


def _kernel_fns():
    global _fns
    if _fns is None:
        lib = build.load("packet_bvh")
        p = ctypes.c_void_p
        # n, n_nodes, n_oct, the list's counter and scratch, the stream
        tail = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, p, p, p]
        lib.gnx_packet_closest_hit.argtypes = [p] * 11 + tail
        lib.gnx_packet_closest_hit.restype = ctypes.c_int
        lib.gnx_packet_any_hit.argtypes = [p] * 8 + tail
        lib.gnx_packet_any_hit.restype = ctypes.c_int
        _fns = (lib.gnx_packet_closest_hit, lib.gnx_packet_any_hit)
    return _fns


def _check_args(pack, o, d, t_max):
    n, dev = _check_rays(o, d, t_max, "binary")
    if pack.nodes.ndim != 2 or pack.nodes.shape[0] < 1:
        raise ValueError("pack.nodes must be (NN, 8) with NN >= 1")
    nn = pack.nodes.shape[0]
    _check("pack.nodes", pack.nodes, (nn, 8), torch.float32, dev)
    if pack.meta.ndim != 3 or pack.meta.shape[0] not in (1, 8):
        raise ValueError("pack.meta must be (K, NN, 2) with K = 1 or 8, got "
                         f"{tuple(pack.meta.shape)}")
    _check("pack.meta", pack.meta, (pack.meta.shape[0], nn, 2), torch.int32, dev)
    _check_leaf_tables(pack, dev)
    if n > 1 << 30:
        raise ValueError(f"a cast takes at most 2**30 rays, not {n}")
    return n, dev


def _root_box(pack):
    return pack.nodes[0, 0:3], pack.nodes[0, 3:6]


def _launch_args(pack, n, dev):
    """The kernels' table arguments, and their last ones but the stream: the
    tree's node count and link tables, the triage list's zeroed counter and
    scratch.  Returns (the counter and scratch, to keep them alive until the
    launch is queued; the tables; the rest)."""
    listed = torch.zeros((1,), dtype=torch.int64, device=dev)
    scratch = torch.empty((n,), dtype=torch.int32, device=dev)
    return ((listed, scratch),
            (pack.nodes.data_ptr(), pack.meta.data_ptr(),
             pack.leafs.data_ptr(), pack.tid.data_ptr()),
            (pack.meta.shape[1], pack.meta.shape[0], listed.data_ptr(),
             scratch.data_ptr()))


def _closest_1(pack, o, d, t_max, sort, sort_key):
    n, dev = _check_args(pack, o, d, t_max)

    def cast(o, d, t_max):
        if dev.type == "cpu":
            return packet_closest_hit_reference(pack, o, d, t_max)
        fn, _ = _kernel_fns()
        out = _empty_trihit(n, dev)
        if n > 0:
            _keep, tables, tail = _launch_args(pack, n, dev)
            _launch(dev, fn, "packet_closest_hit", *tables,
                    o.data_ptr(), d.data_ptr(), t_max.data_ptr(),
                    out.t.data_ptr(), out.tri.data_ptr(), out.b.data_ptr(),
                    out.hit.data_ptr(), n, *tail)
            global closest_launch_count
            closest_launch_count += 1
        return out

    return _sorted_cast(cast, o, d, t_max, lambda: _root_box(pack), sort,
                        sort_key)


def packet_closest_hit(pack, o, d, t_max, sort=False, sort_key="oct_morton",
                       near_r=None):
    """Closest hit of N rays against the binary threaded BVH table `pack`
    (ops/bvh.PacketPack).

    o, d: (N,3) float32; t_max: (N,) float32; all contiguous and on the
    pack's device.  sort: cast the rays in coherence order (results do not
    depend on it; off by default: on an H100 the sort costs several times
    what it saves the kernel, whose triage pass lists the rays that enter
    the tree a warp's together).  near_r: the two-phase cast: first with
    t_max capped at near_r, which prunes every node outside a near_r ball
    around the ray's origin, then the rays that missed again at their full
    t_max (rays that hit go along dead, t_max = 0).  Exact: a closest hit
    within the cap is the closest hit.  Returns TriHit(hit (N,) bool, t (N,)
    f32 — INFINITY on a miss, tri (N,) i32 — 0 on a miss, b (N,3) f32 =
    (1-u-v, u, v))."""
    if near_r is None or near_r <= 0:
        return _closest_1(pack, o, d, t_max, sort, sort_key)
    th1 = _closest_1(pack, o, d, torch.clamp(t_max, max=float(near_r)),
                     sort, sort_key)
    th2 = _closest_1(pack, o, d, torch.where(th1.hit, 0.0, t_max).contiguous(),
                     sort, sort_key)
    return TriHit(hit=th1.hit | th2.hit,
                  t=torch.where(th1.hit, th1.t, th2.t),
                  tri=torch.where(th1.hit, th1.tri, th2.tri),
                  b=torch.where(th1.hit[:, None], th1.b, th2.b))


def packet_any_hit(pack, o, d, t_max, sort=False, sort_key="oct_morton"):
    """Whether each of N rays hits anything before its t_max: (N,) bool.
    Arguments as for packet_closest_hit."""
    n, dev = _check_args(pack, o, d, t_max)

    def cast(o, d, t_max):
        if dev.type == "cpu":
            return packet_any_hit_reference(pack, o, d, t_max)
        _, fn = _kernel_fns()
        occ = torch.empty((n,), dtype=torch.bool, device=dev)
        if n > 0:
            _keep, tables, tail = _launch_args(pack, n, dev)
            _launch(dev, fn, "packet_any_hit", *tables,
                    o.data_ptr(), d.data_ptr(), t_max.data_ptr(),
                    occ.data_ptr(), n, *tail)
            global any_launch_count
            any_launch_count += 1
        return occ

    return _sorted_cast(cast, o, d, t_max, lambda: _root_box(pack), sort,
                        sort_key)
