"""Closest hit and any hit over the width-8 BVH: the wrappers of the CUDA
kernels in csrc/wide_bvh.cu, and the plain PyTorch versions beside them.

The kernels replace the two modes of the JAX package's TPU kernel
ops/pallas_wbvh.py::_make_wide_kernel (see the note in the .cu file for what
bounds them on an H100 and what the design does about it).  On CUDA tensors
``wide_closest_hit`` / ``wide_any_hit`` launch the kernel or raise; on CPU
tensors they run ``wide_closest_hit_reference`` / ``wide_any_hit_reference``,
which are also what the kernels are held against on the card.

The plain versions walk the SAME packed table (ops/wbvh.WidePack) in
lockstep, in the kernel's order: a lane whose ray misses the frame's box
never starts; otherwise it visits the root, and each step takes one entry per
live lane, the next slot of its current node group (a node and its wanted
slots not yet taken, near first in the order word of the lane's own
direction octant): a node (8 quantized child boxes, slab test; its wanted
children become the group, the rest of the old group goes on the lane's
stack) or a leaf row (LEAF_SIZE watertight tests in row order, strict t <
t_best).  A lane's sequence of visits is exactly a kernel thread's, so ties
in t go to the same triangle in both.
"""

import ctypes

import torch

from ..constants import INFINITY
from ..ops.bvh import LEAF_SIZE, ray_sort_perm
from ..ops.intersect import TriHit, _permute_shear, _watertight_one
from ..ops.wbvh import BOUND_WORDS, ORDER_WORD0, REC_WORDS, TARGET_WORD0, WIDTH
from . import build
from .closest_hit import _check

# launches of each CUDA kernel (and nothing else) since the last reset
closest_launch_count = 0
any_launch_count = 0

# far side of the slab widened by gamma(3)-sized slop, as in the JAX package
_SLAB_WIDEN = 1.0 + 2.0 * 7.2e-7


def reset_launch_counts():
    global closest_launch_count, any_launch_count
    closest_launch_count = 0
    any_launch_count = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _safe_inv(v):
    tiny = torch.where(v < 0, -1e-20, 1e-20)
    return 1.0 / torch.where(torch.abs(v) < 1e-20, tiny, v)


def _leaf_rows(pack, row, li, o, frame, t_best, tri, u, v, found, any_hit):
    """Lanes `li` each test leaf row `row` of the pack (LEAF_SIZE watertight
    tests in row order, strict t < t_best, padded ids inert) and update the
    per-ray state tensors in place: found, and for the closest hit t_best,
    tri, u, v.  Returns the lanes' found flags.  Shared by the plain walks
    over the wide and the binary tables."""
    m0, m1, sx, sy, sz = frame
    lr = pack.leafs[row]                                   # (M, 36)
    ids = pack.tid[row]                                    # (M, 4)
    ol = o[li]
    fr = (ol[:, 0], ol[:, 1], ol[:, 2], m0[li], m1[li],
          sx[li], sy[li], sz[li])
    tb = t_best[li]
    tri_l, u_l, v_l, found_l = tri[li], u[li], v[li], found[li]
    for k in range(LEAF_SIZE):
        c = 9 * k
        valid, t, _b0, b1, b2 = _watertight_one(
            *fr, tb, (lr[:, c + 0], lr[:, c + 1], lr[:, c + 2]),
            (lr[:, c + 3], lr[:, c + 4], lr[:, c + 5]),
            (lr[:, c + 6], lr[:, c + 7], lr[:, c + 8]))
        valid = valid & (ids[:, k] >= 0) & (t < tb)
        found_l = found_l | valid
        if not any_hit:
            tb = torch.where(valid, t, tb)
            tri_l = torch.where(valid, ids[:, k], tri_l)
            u_l = torch.where(valid, b1, u_l)
            v_l = torch.where(valid, b2, v_l)
    found[li] = found_l
    if not any_hit:
        t_best[li], tri[li], u[li], v[li] = tb, tri_l, u_l, v_l
    return found_l


def _frame_box_hit(pack, o, inv, t_best):
    """The slab test of the frame's box (bytes 0 and 255 on every axis), as
    the kernel makes it before it loads a node: every child box lies inside
    that box, so a ray that misses it misses the tree."""
    lo = pack.frame[0:3]
    hi = lo + 255.0 * pack.frame[3:6]
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    tn = torch.amax(torch.minimum(t0, t1), dim=1)
    tf = torch.amin(torch.maximum(t0, t1), dim=1) * _SLAB_WIDEN
    return (tn <= tf) & (tf > 0) & (tn < t_best) & (t_best > 0)


# ctz of a byte: the position of its lowest set bit (0 for 0, never asked)
_LOWEST_BIT = [((m & -m).bit_length() - 1) if m else 0 for m in range(256)]


def _walk(pack, o, d, t_max, any_hit, stats=None, trace=None):
    """The lockstep walk both plain versions share.  Returns (t_best, tri,
    u, v, found); tri = -1 where nothing was found.

    A lane's state is its current node group (a node and the mask of its
    wanted slots not yet taken, bit j = the j-th position of the lane's
    octant order) and a stack of such groups, one entry per level at most.
    Each step takes one entry per live lane: the next slot of its group (or,
    with the group spent, of the group it pops), a leaf row or a wide node
    whose wanted children become the new group (the old one, if anything is
    left of it, is pushed).  stats: an optional dict that gets node_visits,
    leaf_visits (summed over rays) and max_stack (entries on a lane's stack
    at most) added.  trace: an optional list that gets one (lanes, entries)
    pair of tensors per step: the node ids (>= 0) and leaf codes (< 0) the
    lanes visited, the root first."""
    n = o.shape[0]
    dev = o.device
    cap = pack.stack_size
    rec = pack.rec
    f_lo = torch.cat([pack.frame[0:3], pack.frame[0:3]])[None, :, None]
    f_sc = torch.cat([pack.frame[3:6], pack.frame[3:6]])[None, :, None]
    # byte s%4 of word 2k + s//4 is component k of slot s
    slot = torch.arange(WIDTH, device=dev)
    word_of = (2 * torch.arange(6, device=dev)[:, None] + slot[None, :] // 4)
    shift_of = (8 * (slot % 4))[None, None, :]
    lowest_bit = torch.tensor(_LOWEST_BIT, dtype=torch.int64, device=dev)

    inv = _safe_inv(d)
    neg = (d < 0).to(torch.int64)
    octant = neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2)
    (m0, m1), (sx, sy, sz) = _permute_shear(d)

    t_best = t_max.to(torch.float32).clone()
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    v = torch.zeros((n,), dtype=torch.float32, device=dev)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    grp_node = torch.zeros((n,), dtype=torch.int64, device=dev)
    grp_mask = torch.zeros((n,), dtype=torch.int64, device=dev)
    stack = torch.zeros((n, max(cap, 1)), dtype=torch.int64, device=dev)
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    node_visits = leaf_visits = max_stack = 0

    def visit(lanes, nodes):
        """Lanes `lanes` visit wide nodes `nodes`: where any child is
        wanted, that node with its wanted positions becomes the group."""
        r = rec[nodes]                                            # (M, 32)
        words = r[:, :BOUND_WORDS].to(torch.int64) & 0xFFFFFFFF
        q = (words[:, word_of] >> shift_of) & 255                 # (M, 6, 8)
        box = f_lo + q.to(torch.float32) * f_sc
        oo = o[lanes][:, :, None]
        ii = inv[lanes][:, :, None]
        t0 = (box[:, 0:3] - oo) * ii
        t1 = (box[:, 3:6] - oo) * ii
        tn = torch.amax(torch.minimum(t0, t1), dim=1)              # (M, 8)
        tf = torch.amin(torch.maximum(t0, t1), dim=1) * _SLAB_WIDEN
        tb = t_best[lanes][:, None]
        tg = r[:, TARGET_WORD0:TARGET_WORD0 + WIDTH]
        want = ((tn <= tf) & (tf > 0) & (tn < tb) & (tb > 0) & (tg != 0))
        rows = torch.arange(lanes.numel(), device=dev)
        order = r[rows, ORDER_WORD0 + octant[lanes]].to(torch.int64) & 0xFFFFFFFF
        pos = torch.zeros_like(nodes)
        for j in range(WIDTH):
            sl = ((order >> (3 * j)) & 7)[:, None]
            pos |= want.gather(1, sl)[:, 0].to(torch.int64) << j
        go = pos != 0
        lanes, nodes, pos = lanes[go], nodes[go], pos[go]
        keep = grp_mask[lanes] != 0
        pl = lanes[keep]
        if pl.numel():
            at = sp[pl]
            if bool((at >= cap).any()):
                raise RuntimeError(
                    "wide BVH walk: traversal stack overflow (the pack's "
                    f"stack_size {cap} is too small for its tree)")
            stack[pl, at] = (grp_node[pl] << 8) | grp_mask[pl]
            sp[pl] = at + 1
        grp_node[lanes] = nodes
        grp_mask[lanes] = pos

    enter = torch.nonzero(_frame_box_hit(pack, o, inv, t_best))[:, 0]
    if enter.numel():
        node_visits += int(enter.numel())
        root = torch.zeros_like(enter)
        if trace is not None:
            trace.append((enter, root))
        visit(enter, root)
    while True:
        # a spent group gives way to the group on top of the stack
        pop = torch.nonzero((grp_mask == 0) & (sp > 0))[:, 0]
        if pop.numel():
            sp[pop] -= 1
            e = stack[pop, sp[pop]]
            grp_node[pop] = e >> 8
            grp_mask[pop] = e & 255
        live = torch.nonzero(grp_mask != 0)[:, 0]
        if live.numel() == 0:
            break
        if stats is not None:
            max_stack = max(max_stack, int(sp.max()))
        m = grp_mask[live]
        j = lowest_bit[m]
        grp_mask[live] = m & (m - 1)
        node = grp_node[live]
        order = rec[node, ORDER_WORD0 + octant[live]].to(torch.int64) & 0xFFFFFFFF
        slot = (order >> (3 * j)) & 7
        target = rec[node, TARGET_WORD0 + slot].to(torch.int64)
        if trace is not None:
            trace.append((live, target))

        is_leaf = target < 0
        ni = live[~is_leaf]
        if ni.numel():
            node_visits += int(ni.numel())
            visit(ni, target[~is_leaf])
        li = live[is_leaf]
        if li.numel():
            leaf_visits += int(li.numel())
            row = -target[is_leaf] - 1
            found_l = _leaf_rows(pack, row, li, o, (m0, m1, sx, sy, sz),
                                 t_best, tri, u, v, found, any_hit)
            if any_hit:  # the first hit before t_max ends the walk
                done = li[found_l]
                grp_mask[done] = 0
                sp[done] = 0
    if stats is not None:
        stats["node_visits"] = stats.get("node_visits", 0) + node_visits
        stats["leaf_visits"] = stats.get("leaf_visits", 0) + leaf_visits
        stats["max_stack"] = max(stats.get("max_stack", 0), max_stack)
    return t_best, tri, u, v, found


def _trihit(t, tri, u, v, found):
    return TriHit(hit=found, t=torch.where(found, t, INFINITY),
                  tri=torch.clamp(tri, min=0),
                  b=torch.stack([1.0 - u - v, u, v], dim=-1))


def wide_closest_hit_reference(pack, o, d, t_max, stats=None, trace=None):
    """Plain PyTorch version of the closest-hit kernel, any device.  stats,
    trace: see _walk (node and leaf visits summed over rays, the deepest
    stack, the sequence of visits)."""
    return _trihit(*_walk(pack, o, d, t_max, any_hit=False, stats=stats,
                          trace=trace))


def wide_any_hit_reference(pack, o, d, t_max, stats=None, trace=None):
    """Plain PyTorch version of the any-hit kernel: (N,) bool."""
    return _walk(pack, o, d, t_max, any_hit=True, stats=stats, trace=trace)[4]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_fns = None


def _kernel_fns():
    global _fns
    if _fns is None:
        lib = build.load("wide_bvh")
        p = ctypes.c_void_p
        lib.gnx_wide_stack_cap.argtypes = []
        lib.gnx_wide_stack_cap.restype = ctypes.c_int
        tail = [ctypes.c_longlong, ctypes.c_int, p, p, p]
        lib.gnx_wide_closest_hit.argtypes = [p] * 11 + tail
        lib.gnx_wide_closest_hit.restype = ctypes.c_int
        lib.gnx_wide_any_hit.argtypes = [p] * 8 + tail
        lib.gnx_wide_any_hit.restype = ctypes.c_int
        _fns = (lib.gnx_wide_closest_hit, lib.gnx_wide_any_hit,
                int(lib.gnx_wide_stack_cap()))
    return _fns


def _check_rays(o, d, t_max, what):
    """The ray arguments of a BVH cast: (N, their device)."""
    n = o.shape[0]
    dev = o.device
    _check("o", o, (n, 3), torch.float32, dev)
    _check("d", d, (n, 3), torch.float32, dev)
    _check("t_max", t_max, (n,), torch.float32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the {what} BVH casts run on cuda or cpu tensors, not {dev}")
    return n, dev


def _check_leaf_tables(pack, dev):
    rows = pack.leafs.shape[0]
    _check("pack.leafs", pack.leafs, (rows, LEAF_SIZE * 9), torch.float32, dev)
    _check("pack.tid", pack.tid, (rows, LEAF_SIZE), torch.int32, dev)


def _check_args(pack, o, d, t_max):
    n, dev = _check_rays(o, d, t_max, "wide")
    if pack.rec.ndim != 2 or pack.rec.shape[0] < 1:
        raise ValueError("pack.rec must be (NW, 32) with NW >= 1")
    _check("pack.rec", pack.rec, (pack.rec.shape[0], REC_WORDS), torch.int32, dev)
    _check("pack.frame", pack.frame, (8,), torch.float32, dev)
    _check_leaf_tables(pack, dev)
    return n, dev


def _sorted_cast(cast, o, d, t_max, root_box, sort, sort_key):
    """cast(o, d, t_max), with `sort` on the rays in coherence order
    (ops/bvh.ray_sort_perm over the tree's bounds (lo, hi) = root_box()) and
    its result, a tensor or a NamedTuple of tensors, put back in the caller's
    order.  Shared by the wrappers of the wide and the binary walks."""
    if not sort or o.shape[0] == 0:
        return cast(o, d, t_max)
    perm, inv = ray_sort_perm(o, d, *root_box(), t_max=t_max, key_mode=sort_key)
    out = cast(o[perm].contiguous(), d[perm].contiguous(),
               t_max[perm].contiguous())
    if isinstance(out, torch.Tensor):
        return out[inv]
    return type(out)(*(x[inv] for x in out))


def _launch(dev, fn, name, *args):
    """fn(*args, stream) on the device's current stream; raises unless the
    launch succeeded."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _empty_trihit(n, dev):
    return TriHit(hit=torch.empty((n,), dtype=torch.bool, device=dev),
                  t=torch.empty((n,), dtype=torch.float32, device=dev),
                  tri=torch.empty((n,), dtype=torch.int32, device=dev),
                  b=torch.empty((n, 3), dtype=torch.float32, device=dev))


def _root_box(pack):
    """The pack's frame spans the tree's bounds."""
    lo = pack.frame[0:3]
    return lo, lo + 255.0 * pack.frame[3:6]


def _walk_state(pack, n, cap, dev):
    """The kernels' last arguments but the stream: the pack's stack size, a
    zeroed int64 counter and an int32 scratch list of n rays (the rays the
    triage pass lists for the walk), allocated on the device's current
    stream.  Returns (the tensors, to keep them alive until the launch is
    queued; the arguments)."""
    if pack.stack_size > cap:
        raise ValueError(
            f"the tree needs a traversal stack of {pack.stack_size} entries; "
            f"the kernel takes at most {cap}")
    if pack.rec.shape[0] >= 1 << 23:
        raise ValueError("a stack entry holds a node id below 2**23, the "
                         f"tree has {pack.rec.shape[0]} nodes")
    if n > 1 << 30:
        raise ValueError(f"a cast takes at most 2**30 rays, not {n}")
    listed = torch.zeros((1,), dtype=torch.int64, device=dev)
    scratch = torch.empty((n,), dtype=torch.int32, device=dev)
    return (listed, scratch), (max(pack.stack_size, 1), listed.data_ptr(),
                               scratch.data_ptr())


def wide_closest_hit(pack, o, d, t_max, sort=False, sort_key="oct_morton"):
    """Closest hit of N rays against the width-8 BVH table `pack`
    (ops/wbvh.WidePack).

    o, d: (N,3) float32; t_max: (N,) float32; all contiguous and on the
    pack's device.  sort: cast the rays in coherence order (results do not
    depend on it; off by default: on an H100 the sort costs several times
    what it saves the kernel, whose warps take new rays as theirs end).
    Returns TriHit(hit (N,) bool, t (N,) f32 — INFINITY on a miss, tri (N,)
    i32 — 0 on a miss, b (N,3) f32 = (1-u-v, u, v))."""
    n, dev = _check_args(pack, o, d, t_max)

    def cast(o, d, t_max):
        if dev.type == "cpu":
            return wide_closest_hit_reference(pack, o, d, t_max)
        fn, _, cap = _kernel_fns()
        out = _empty_trihit(n, dev)
        if n > 0:
            _keep, state = _walk_state(pack, n, cap, dev)
            _launch(dev, fn, "wide_closest_hit",
                    pack.rec.data_ptr(), pack.frame.data_ptr(),
                    pack.leafs.data_ptr(), pack.tid.data_ptr(),
                    o.data_ptr(), d.data_ptr(), t_max.data_ptr(),
                    out.t.data_ptr(), out.tri.data_ptr(), out.b.data_ptr(),
                    out.hit.data_ptr(), n, *state)
            global closest_launch_count
            closest_launch_count += 1
        return out

    return _sorted_cast(cast, o, d, t_max, lambda: _root_box(pack), sort,
                        sort_key)


def wide_any_hit(pack, o, d, t_max, sort=False, sort_key="oct_morton"):
    """Whether each of N rays hits anything before its t_max: (N,) bool.
    Arguments as for wide_closest_hit."""
    n, dev = _check_args(pack, o, d, t_max)

    def cast(o, d, t_max):
        if dev.type == "cpu":
            return wide_any_hit_reference(pack, o, d, t_max)
        _, fn, cap = _kernel_fns()
        occ = torch.empty((n,), dtype=torch.bool, device=dev)
        if n > 0:
            _keep, state = _walk_state(pack, n, cap, dev)
            _launch(dev, fn, "wide_any_hit",
                    pack.rec.data_ptr(), pack.frame.data_ptr(),
                    pack.leafs.data_ptr(), pack.tid.data_ptr(),
                    o.data_ptr(), d.data_ptr(), t_max.data_ptr(),
                    occ.data_ptr(), n, *state)
            global any_launch_count
            any_launch_count += 1
        return occ

    return _sorted_cast(cast, o, d, t_max, lambda: _root_box(pack), sort,
                        sort_key)
