"""Wide (width-8) BVH: the host build that collapses the binary SAH tree of
ops/bvh.py into 8-slot nodes, and the packed table the casts walk.

The collapse (``collapse_bvhw``) and the per-octant near-first slot orders
(``_octant_orders``) are the JAX package's ops/pallas_wbvh.py, array for
array.  ``_quantize_pack`` is a faithful copy of its per-treelet record
(int16 targets), kept so that the tests can hold the quantization and the
order packing byte-equal to the JAX package's.

The table the port walks is ``pack_wide`` / ``build_wide_pack``: ONE table
for the whole tree.  The JAX package cuts big trees into treelets of at most
16k prims to fit the TPU's fast memory, which is why int16 targets suffice
there; one table over a 100k-triangle mesh has more leaf rows than int16
holds, so a record here carries int32 targets:

  words  0..11  uint8 slot bounds: word 2k + s//4, byte s%4 = component k of
                slot s, components [lox loy loz hix hiy hiz], lo floored and
                hi ceiled against the frame, so boxes only grow
  words 12..19  int32 slot targets: > 0 wide child id, < 0 leaf row code
                -(row + 1), 0 an empty slot (no slot may target the root)
  words 20..27  one order word per direction octant: 3 bits per position,
                near slots at low positions
  words 28..31  padding to 128 bytes (one cache line per node)

One quantization frame (lo.xyz, scale.xyz) serves the whole tree.  Empty
slots are a zero-volume box at the frame's far corner with target 0.
"""

import heapq
from typing import NamedTuple

import numpy as np
import torch

from ..utils.stats import spanned
from .bvh import LEAF_SIZE

WIDTH = 8          # node width (slots)
REC_WORDS = 32     # int32 words of one GPU node record (128 bytes)
BOUND_WORDS = 12   # 6 components x 8 slots, 4 bytes a word
TARGET_WORD0 = 12
ORDER_WORD0 = 20

BIG = np.float32(3.0e38)


def _rec_words(width):
    """(bound words, target words, order words/octant, record width) of the
    JAX package's per-treelet record (int16 target pairs)."""
    nbw = 6 * (width // 4)       # 6 components x width slots, 4 bytes/word
    ntw = width // 2             # int16 target pairs
    obits = {4: 2, 8: 3, 16: 4}[width]
    owords = (width * obits + 31) // 32
    return nbw, ntw, owords, nbw + ntw + 8 * owords


# ---------------------------------------------------------------------------
# Host build: binary SAH arrays -> width-W node arrays
# ---------------------------------------------------------------------------

def _expand_wide(n, off, npr, pcount, width):
    """Expand the binary interior node n into <= width slots, SHALLOWEST
    first (BFS by depth; prim count breaks ties within a level), so every
    path through the node advances uniformly.  Returns (kids, slots): kids
    maps each expanded binary node to its (left, right) children; slots =
    the expansion leaves in canonical (octant-0 DFS) order."""
    kids = {}
    heap = [(0, -int(pcount[n]), n)]
    cnt = 1
    while heap and cnt + 1 <= width:
        dep, _, b = heapq.heappop(heap)
        l, r = b + 1, int(off[b])
        kids[b] = (l, r)
        cnt += 1
        for c in (l, r):
            if npr[c] == 0:
                heapq.heappush(heap, (dep + 1, -int(pcount[c]), c))

    def dfs(b, out):
        if b in kids:
            l, r = kids[b]
            dfs(l, out)
            dfs(r, out)
        else:
            out.append(b)

    slots = []
    dfs(n, slots)
    return kids, slots


def _octant_orders(n, kids, slots, axis, width):
    """Per-octant near-first slot permutations for one wide node.
    Returns (8, width) slot indices; tail positions past the real slot
    count repeat an EMPTY slot index when one exists (empty slots can
    never be wanted) or are unused (full node: every j is real)."""
    pos = {b: i for i, b in enumerate(slots)}
    perms = np.zeros((8, width), np.int64)
    for o in range(8):
        order = []

        def dfs(b):
            if b in kids:
                l, r = kids[b]
                a = int(axis[b])
                near, far = (r, l) if (o >> a) & 1 else (l, r)
                dfs(near)
                dfs(far)
            else:
                order.append(pos[b])

        dfs(n)
        pad = len(order) if len(order) < width else 0
        perms[o] = order + [pad] * (width - len(order))
    return perms


def collapse_bvhw(off, npr, axis, lo, hi, width, root=0, row_base=0,
                  pcount=None):
    """Collapse the binary DFS subtree at `root` into width-W node arrays.

    off/npr/axis/lo/hi: the binary arrays (ops/bvh layout).  row_base
    rebases leaf-row codes.  Returns (bounds (NW, 6, W) f32, targ (NW, W)
    i32, perms (NW, 8, W))."""
    off = np.asarray(off, np.int64)
    npr = np.asarray(npr, np.int64)
    axis = np.asarray(axis, np.int64)
    if pcount is None:
        pcount = _subtree_prims(off, npr)

    def leaf_code(b):
        return -int((off[b] - row_base) // LEAF_SIZE + 1)

    if npr[root] > 0:
        # degenerate: the subtree is a single leaf -> one node, 1 slot
        bounds = np.zeros((1, 6, width), np.float32)
        bounds[0, 0:3, :] = BIG
        bounds[0, 3:6, :] = -BIG
        bounds[0, 0:3, 0] = lo[root]
        bounds[0, 3:6, 0] = hi[root]
        targ = np.zeros((1, width), np.int32)
        targ[0, 0] = leaf_code(root)
        perms = np.zeros((1, 8, width), np.int64)
        perms[:, :, :] = 1 if width > 1 else 0  # pad -> empty slot 1
        perms[:, :, 0] = 0
        return bounds, targ, perms

    wide_id = {root: 0}
    worklist = [root]
    entries = {}
    while worklist:
        n = worklist.pop()
        kids, slots = _expand_wide(n, off, npr, pcount, width)
        for b in slots:
            if npr[b] == 0 and b not in wide_id:
                wide_id[b] = len(wide_id)
                worklist.append(b)
        entries[n] = (kids, slots)
    nw = len(wide_id)
    bounds = np.zeros((nw, 6, width), np.float32)
    bounds[:, 0:3, :] = BIG
    bounds[:, 3:6, :] = -BIG
    targ = np.zeros((nw, width), np.int32)
    perms = np.zeros((nw, 8, width), np.int64)
    for n, w in wide_id.items():
        kids, slots = entries[n]
        for k, b in enumerate(slots):
            bounds[w, 0:3, k] = lo[b]
            bounds[w, 3:6, k] = hi[b]
            targ[w, k] = leaf_code(b) if npr[b] > 0 else wide_id[b]
        perms[w] = _octant_orders(n, kids, slots, axis, width)
    return bounds, targ, perms


def _subtree_prims(off, npr):
    """Per-node total prim count (vectorized level sweep)."""
    frontier = np.array([0], dtype=np.int64)
    levels = []
    while len(frontier):
        levels.append(frontier)
        inner_f = frontier[npr[frontier] == 0]
        frontier = np.concatenate([inner_f + 1, off[inner_f]])
    pcount = np.where(npr > 0, npr, 0).astype(np.int64)
    for lvl in reversed(levels[:-1]):
        inner_l = lvl[npr[lvl] == 0]
        pcount[inner_l] = pcount[inner_l + 1] + pcount[off[inner_l]]
    return pcount


# ---------------------------------------------------------------------------
# Quantization and packing
# ---------------------------------------------------------------------------

def _quantize_bounds(bounds):
    """uint8 quantization of (NW, 6, W) slot bounds against one frame.
    Returns (q (NW, 6, W) int64 in [0, 255], f_lo (3,) f32, scale (3,) f32).

    lo components round DOWN and hi components UP, so boxes only grow.
    Empty slots quantize to a ZERO-VOLUME box at the frame's far corner
    (lo = hi = 255): the slab test can only "hit" it on an exact corner
    graze, and even then the push is masked by target != 0."""
    valid = bounds[:, 0, :] < BIG / 2  # (nw, W) real slots
    f_lo = np.zeros(3, np.float32)
    f_hi = np.ones(3, np.float32)
    if valid.any():
        for k in range(3):
            f_lo[k] = bounds[:, k, :][valid].min()
            f_hi[k] = bounds[:, 3 + k, :][valid].max()
    scale = np.maximum((f_hi - f_lo) / 255.0, 1e-12).astype(np.float32)
    q = np.empty(bounds.shape, np.int64)
    for k in range(3):
        b = np.where(valid, bounds[:, k, :], f_lo[k])
        ql = np.clip(np.floor((b - f_lo[k]) / scale[k]), 0, 255)
        q[:, k, :] = np.where(valid, ql, 255)
        b = np.where(valid, bounds[:, 3 + k, :], f_lo[k])
        qh = np.clip(np.ceil((b - f_lo[k]) / scale[k]), 0, 255)
        q[:, 3 + k, :] = np.where(valid, qh, 255)
    return q, f_lo, scale


def _pack_bytes(rec, q, width):
    """q (NW, 6, W) -> words k*(W/4) + s//4, byte s%4 of rec[:NW]."""
    nw = q.shape[0]
    for k in range(6):
        for w4 in range(width // 4):
            word = (q[:, k, 4 * w4] | (q[:, k, 4 * w4 + 1] << 8)
                    | (q[:, k, 4 * w4 + 2] << 16) | (q[:, k, 4 * w4 + 3] << 24))
            rec[:nw, k * (width // 4) + w4] = word.astype(
                np.uint32).view(np.int32)


def _pack_orders(rec, perms, width, col0):
    """perms (NW, 8, W) -> `owords` words per octant from column col0:
    `obits` bits per slot position, far slots at high positions."""
    nw = perms.shape[0]
    obits = {4: 2, 8: 3, 16: 4}[width]
    owords = (width * obits + 31) // 32
    for o in range(8):
        packed = np.zeros((nw, owords), np.int64)
        for j in range(width):
            bit = j * obits
            packed[:, bit // 32] |= perms[:, o, j] << (bit % 32)
        for ow in range(owords):
            rec[:nw, col0 + o * owords + ow] = packed[:, ow].astype(
                np.uint32).view(np.int32)


def _frame(f_lo, scale):
    frame = np.zeros((1, 8), np.float32)
    frame[0, 0:3] = f_lo
    frame[0, 3:6] = scale
    return frame


def _quantize_pack(bounds, targ, perms, width, nw_pad):
    """The JAX package's per-treelet record: bounds + int16 targets +
    per-octant orders as (nw_pad, RW) i32, and the (1, 8) frame."""
    nbw, ntw, _owords, rw = _rec_words(width)
    nw = bounds.shape[0]
    q, f_lo, scale = _quantize_bounds(bounds)
    rec = np.zeros((nw_pad, rw), np.int32)
    _pack_bytes(rec, q, width)
    assert np.abs(targ).max(initial=0) < 32767, "targets overflow int16"
    t16 = targ.astype(np.int64) & 0xFFFF
    for s2 in range(ntw):
        rec[:nw, nbw + s2] = (t16[:, 2 * s2] | (t16[:, 2 * s2 + 1] << 16)
                              ).astype(np.uint32).view(np.int32)
    _pack_orders(rec, perms, width, nbw + ntw)
    return rec, _frame(f_lo, scale)


class WidePack(NamedTuple):
    """The width-8 table of a whole tree, on a device.

    rec:   (NW, 32) i32 node records (see the module docstring)
    frame: (8,) f32 [lo.xyz, scale.xyz, 0, 0] dequantization frame
    leafs: (rows, LEAF_SIZE*9) f32 packed leaf triangle rows
    tid:   (rows, LEAF_SIZE) i32 triangle ids (-1 pad)
    stack_size: entries a per-ray stack of node groups needs at most on
                this tree
    """
    rec: torch.Tensor
    frame: torch.Tensor
    leafs: torch.Tensor
    tid: torch.Tensor
    stack_size: int


def wide_depth(targ):
    """Levels of wide nodes under (and including) the root."""
    depth, level = 0, np.array([0], np.int64)
    while len(level):
        depth += 1
        kids = targ[level].reshape(-1)
        level = kids[kids > 0].astype(np.int64)
    return depth


def pack_wide(bounds, targ, perms):
    """(bounds, targ, perms) of collapse_bvhw at width 8 -> (rec (NW, 32)
    i32, frame (8,) f32, stack_size), host arrays.

    A walk keeps one node group (a node and its wanted slots not yet taken)
    a level of the tree: its stack never holds more than depth - 1 entries
    beside the current group, and depth + 1 leaves room to spare."""
    nw = bounds.shape[0]
    if bounds.shape[2] != WIDTH:
        raise ValueError(f"the GPU record is for width {WIDTH}")
    q, f_lo, scale = _quantize_bounds(bounds)
    rec = np.zeros((nw, REC_WORDS), np.int32)
    _pack_bytes(rec, q, WIDTH)
    rec[:, TARGET_WORD0:TARGET_WORD0 + WIDTH] = targ
    _pack_orders(rec, perms, WIDTH, ORDER_WORD0)
    return rec, _frame(f_lo, scale)[0], wide_depth(targ) + 1


def unpack_wide(rec, frame):
    """Inverse of pack_wide, for tests and tools: (lo (NW, 3, 8), hi
    (NW, 3, 8) dequantized f32, targ (NW, 8) i32, perms (NW, 8, 8) i64)."""
    rec = np.asarray(rec)
    frame = np.asarray(frame, np.float32)
    words = rec[:, :BOUND_WORDS].view(np.uint32).astype(np.int64)
    q = np.empty((rec.shape[0], 6, WIDTH), np.int64)
    for k in range(6):
        for s in range(WIDTH):
            q[:, k, s] = (words[:, 2 * k + s // 4] >> (8 * (s % 4))) & 255
    f_lo, scale = frame[0:3], frame[3:6]
    box = (f_lo[None, :, None]
           + q.reshape(-1, 2, 3, WIDTH).astype(np.float32)
           * scale[None, None, :, None])
    targ = rec[:, TARGET_WORD0:TARGET_WORD0 + WIDTH].astype(np.int32)
    ow = rec[:, ORDER_WORD0:ORDER_WORD0 + 8].view(np.uint32).astype(np.int64)
    perms = np.stack([(ow >> (3 * j)) & 7 for j in range(WIDTH)], axis=-1)
    return box[:, 0], box[:, 1], targ, perms


@spanned("build.wide_pack")
def build_wide_pack(off, npr, axis, lo, hi, prim_idx, leaf_soa, device="cpu"):
    """The whole binary tree as one width-8 table on `device`.  width is 8
    and leaves are LEAF_SIZE rows."""
    bounds, targ, perms = collapse_bvhw(off, npr, axis, lo, hi, WIDTH)
    rec, frame, stack_size = pack_wide(bounds, targ, perms)
    # copies: the tables must not alias the caller's (maybe read-only) arrays
    leafs = np.array(leaf_soa, np.float32).reshape(-1, LEAF_SIZE * 9)
    tid = np.array(prim_idx, np.int32).reshape(-1, LEAF_SIZE)
    dev = torch.device(device)
    return WidePack(torch.from_numpy(rec).to(dev),
                    torch.from_numpy(frame.copy()).to(dev),
                    torch.from_numpy(leafs).to(dev),
                    torch.from_numpy(tid).to(dev), stack_size)
