"""The port's host-side BVH build against the JAX package's: the binary SAH
tables, the width-8 collapse, the quantized records and the coherence sort.

Everything here is host data made by the same algorithm from the same
numpy inputs, so every comparison is byte-equal; the only looser statement is
that dequantized boxes CONTAIN the float boxes (they are rounded outwards),
with 1e-6 absolute slop for the f32 rounding of lo + q * scale.

The two builders of the port (the C++ one under native/, compiled with g++
at first use, and the numpy one) are held against each other on the blob
mesh: same nodes, same boxes, same set of triangles in every leaf; the order
of the triangles INSIDE a leaf differs, which is why ``build_bvh`` takes
``builder=``."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnxraytracer_tpu.ops import bvh as J_bvh
from gnxraytracer_tpu.ops import pallas_wbvh as J_wb
from gnxraytracer_tpu.scene import loaders as J_load
from gnxraytracer_tpu_torch.ops import bvh as T_bvh
from gnxraytracer_tpu_torch.ops import wbvh as T_wb
from gnxraytracer_tpu_torch.scene import loaders as T_load

BINARY_FIELDS = ("bounds_lo", "bounds_hi", "offset", "n_prims", "axis",
                 "prim_idx", "miss", "leaf_soa", "first8", "miss8")


def soup(n_tris, seed=0):
    rs = np.random.RandomState(seed)
    tris = (rs.randn(n_tris, 1, 3) * 3
            + rs.randn(n_tris, 3, 3) * 0.5).astype(np.float32)
    return (tris.reshape(-1, 3),
            np.arange(n_tris * 3).reshape(n_tris, 3).astype(np.int32))


def blob(n_seg):
    v, t, _n, _uv = J_load.make_blob_mesh(n_seg)
    return np.asarray(v, np.float32), np.asarray(t, np.int32)


MESHES = {
    "blob8": lambda: blob(8),        # 128 triangles
    "blob24": lambda: blob(24),      # 1,152 triangles
    "soup37": lambda: soup(37, 1),   # 37 % LEAF_SIZE != 0: short leaves
    "quad": lambda: (np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]],
                                np.float32),
                     np.asarray([[0, 1, 2], [1, 3, 2]], np.int32)),
}


@pytest.fixture(scope="module", params=sorted(MESHES))
def built(request):
    v, t = MESHES[request.param]()
    arrs_j = J_bvh.build_bvh_numpy(v, t)
    arrs_t = T_bvh.build_bvh_numpy(v, t)
    return dict(v=v, t=t, arrs_j=arrs_j, arrs_t=arrs_t,
                jax=J_bvh._finish_build(arrs_j, v, t),
                torch=T_bvh.build_bvh(v, t, builder="numpy", device="cpu"))


def test_loaders_make_equal_meshes():
    for n_seg in (8, 24):
        for a, b in zip(T_load.make_blob_mesh(n_seg),
                        J_load.make_blob_mesh(n_seg)):
            np.testing.assert_array_equal(a, np.asarray(b))
            assert a.dtype == np.asarray(b).dtype
    for a, b in zip(T_load.make_test_mesh(3), J_load.make_test_mesh(3)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert len(T_load.make_blob_mesh(8)[1]) == 128
    assert len(T_load.make_blob_mesh(24)[1]) == 1152


def test_build_bvh_numpy_byte_equal(built):
    for a, b in zip(built["arrs_t"], built["arrs_j"]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_build_helpers_byte_equal(built):
    """_align_leaves, _compute_miss_links, _compute_octant_links and
    _pack_leaf_soa, each on the same inputs."""
    lo, hi, off, npr, ax, order = built["arrs_j"]
    off_j, ord_j = J_bvh._align_leaves(off, npr, order)
    off_t, ord_t = T_bvh._align_leaves(off, npr, order)
    np.testing.assert_array_equal(off_t, off_j)
    np.testing.assert_array_equal(ord_t, ord_j)
    assert off_t.dtype == off_j.dtype and ord_t.dtype == ord_j.dtype
    assert len(ord_t) == T_bvh.LEAF_SIZE * int((npr > 0).sum())
    np.testing.assert_array_equal(T_bvh._compute_miss_links(off_t, npr),
                                  J_bvh._compute_miss_links(off_j, npr))
    for a, b in zip(T_bvh._compute_octant_links(off_t, npr, ax),
                    J_bvh._compute_octant_links(off_j, npr, ax)):
        np.testing.assert_array_equal(a, b)
    soa_t = T_bvh._pack_leaf_soa(built["v"], built["t"], ord_t)
    soa_j = J_bvh._pack_leaf_soa(built["v"], built["t"], ord_j)
    np.testing.assert_array_equal(soa_t, soa_j)
    assert soa_t.dtype == np.float32
    assert (soa_t[ord_t < 0] == 0).all()  # pads are zero rows


def test_finished_tables_byte_equal(built):
    jb, tb = built["jax"], built["torch"]
    for f in BINARY_FIELDS:
        a, b = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert tb.treelets is None and tb.wide is not None


def test_subset_build_remaps_to_global_ids():
    """Big-prim separation builds over a subset and stores GLOBAL ids.  With
    a prefix subset (what presets.envmap_mesh gives: the floor comes last)
    the tables equal the JAX package's; with any other subset the port packs
    each leaf row from the triangle its id names (the JAX package indexes
    the subset list with global ids there and raises or packs another
    triangle)."""
    v, t = blob(8)
    prefix = np.arange(len(t) - 2)
    jb = J_bvh._finish_build(J_bvh.build_bvh_numpy(v, t[prefix]), v, t[prefix],
                             orig_ids=prefix)
    tb = T_bvh.build_bvh(v, t, subset=prefix, builder="numpy", device="cpu")
    for f in BINARY_FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    strided = np.arange(len(t))[1::2]
    tb = T_bvh.build_bvh(v, t, subset=strided, builder="numpy", device="cpu")
    ids = tb.prim_idx.numpy()
    assert set(ids[ids >= 0].tolist()) == set(strided.tolist())
    np.testing.assert_array_equal(tb.wide.tid.numpy().reshape(-1), ids)
    want = v[t[np.maximum(ids, 0)]].reshape(-1, 9)
    want[ids < 0] = 0.0
    np.testing.assert_array_equal(tb.leaf_soa.numpy(), want)


# -- the width-8 collapse -------------------------------------------------------

def _binary(built):
    b = built["jax"]
    return tuple(np.asarray(getattr(b, f)) for f in
                 ("offset", "n_prims", "axis", "bounds_lo", "bounds_hi"))


def test_collapse_and_octant_orders_byte_equal(built):
    off, npr, ax, lo, hi = _binary(built)
    got = T_wb.collapse_bvhw(off, npr, ax, lo, hi, 8)
    want = J_wb.collapse_bvhw(off, npr, ax, lo, hi, 8)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        T_wb._subtree_prims(off.astype(np.int64), npr.astype(np.int64)),
        J_wb._subtree_prims(off.astype(np.int64), npr.astype(np.int64)))
    if npr[0] == 0:
        pc = J_wb._subtree_prims(off.astype(np.int64), npr.astype(np.int64))
        kt, st = T_wb._expand_wide(0, off, npr, pc, 8)
        kj, sj = J_wb._expand_wide(0, off, npr, pc, 8)
        assert kt == kj and st == sj
        np.testing.assert_array_equal(T_wb._octant_orders(0, kt, st, ax, 8),
                                      J_wb._octant_orders(0, kj, sj, ax, 8))
    for w in (4, 8, 16):
        assert T_wb._rec_words(w) == J_wb._rec_words(w)


def test_quantize_pack_byte_equal_to_the_treelet_record(built):
    """The faithful copy of the JAX package's record (int16 targets): equal
    to _quantize_pack and to build_wide_treelets(...).rec[0] of a mesh small
    enough for one treelet."""
    off, npr, ax, lo, hi = _binary(built)
    parts = T_wb.collapse_bvhw(off, npr, ax, lo, hi, 8)
    nw = parts[0].shape[0]
    rec_t, frame_t = T_wb._quantize_pack(*parts, 8, nw)
    rec_j, frame_j = J_wb._quantize_pack(*parts, 8, nw)
    np.testing.assert_array_equal(rec_t, rec_j)
    np.testing.assert_array_equal(frame_t, frame_j)
    assert rec_t.dtype == np.int32 and rec_t.shape == (nw, 24)
    jb = built["jax"]
    tl = J_wb.build_wide_treelets(off, npr, ax, lo, hi,
                                  np.asarray(jb.prim_idx),
                                  np.asarray(jb.leaf_soa), width=8)
    assert tl.rec.shape[0] == 1  # K = 1
    np.testing.assert_array_equal(rec_t, np.asarray(tl.rec[0]))
    np.testing.assert_array_equal(frame_t, np.asarray(tl.frame[0]))


def test_gpu_pack_round_trips_targets_and_orders(built):
    """The GPU record (int32 targets, 32 words), decoded again, gives back
    collapse_bvhw's targets and orders exactly; its bound words are the JAX
    record's; its leaf tables are the binary tree's."""
    off, npr, ax, lo, hi = _binary(built)
    bounds, targ, perms = T_wb.collapse_bvhw(off, npr, ax, lo, hi, 8)
    pack = built["torch"].wide
    rec = pack.rec.numpy()
    assert rec.shape == (targ.shape[0], T_wb.REC_WORDS) and rec.dtype == np.int32
    assert (rec[:, 28:] == 0).all()
    _lo, _hi, targ_back, perms_back = T_wb.unpack_wide(rec, pack.frame.numpy())
    np.testing.assert_array_equal(targ_back, targ)
    np.testing.assert_array_equal(perms_back, perms)
    rec_j, frame_j = J_wb._quantize_pack(bounds, targ, perms, 8, targ.shape[0])
    np.testing.assert_array_equal(rec[:, :12], rec_j[:, :12])
    np.testing.assert_array_equal(rec[:, 20:28], rec_j[:, 16:24])
    np.testing.assert_array_equal(pack.frame.numpy(), frame_j[0])
    jb = built["jax"]
    np.testing.assert_array_equal(pack.leafs.numpy().reshape(-1, 9),
                                  np.asarray(jb.leaf_soa))
    np.testing.assert_array_equal(pack.tid.numpy().reshape(-1),
                                  np.asarray(jb.prim_idx))
    # a walk keeps one node group a level: depth + 1 entries are room enough
    assert pack.stack_size == T_wb.wide_depth(targ) + 1


def test_gpu_pack_boxes_contain_the_float_boxes(built):
    off, npr, ax, lo, hi = _binary(built)
    bounds, targ, _ = T_wb.collapse_bvhw(off, npr, ax, lo, hi, 8)
    pack = built["torch"].wide
    qlo, qhi, _t, _p = T_wb.unpack_wide(pack.rec.numpy(), pack.frame.numpy())
    real = bounds[:, 0, :] < T_wb.BIG / 2
    assert real.any()
    assert ((targ != 0) == real).all()  # empty slots carry target 0
    for k in range(3):
        assert (qlo[:, k][real] <= bounds[:, k][real] + 1e-6).all()
        assert (qhi[:, k][real] >= bounds[:, 3 + k][real] - 1e-6).all()
    # an empty slot is a zero-volume box
    np.testing.assert_array_equal(qlo.transpose(0, 2, 1)[~real],
                                  qhi.transpose(0, 2, 1)[~real])


def test_int32_targets_hold_more_rows_than_int16():
    """One table over a big mesh has leaf codes past int16: the JAX record
    asserts, the GPU record stores them."""
    nw = 2
    bounds = np.zeros((nw, 6, 8), np.float32)
    bounds[:, 0:3] = T_wb.BIG
    bounds[:, 3:6] = -T_wb.BIG
    bounds[:, 0:3, :2] = 0.0
    bounds[:, 3:6, :2] = 1.0
    targ = np.zeros((nw, 8), np.int32)
    targ[0, :2] = (1, -40000)
    targ[1, :2] = (-70001, -2)
    perms = np.zeros((nw, 8, 8), np.int64)
    perms[:, :, 1] = 1
    perms[:, :, 2:] = 2
    with pytest.raises(AssertionError):
        T_wb._quantize_pack(bounds, targ, perms, 8, nw)
    rec, frame, stack = T_wb.pack_wide(bounds, targ, perms)
    np.testing.assert_array_equal(T_wb.unpack_wide(rec, frame)[2], targ)
    assert stack == 3  # two levels of wide nodes


# -- the two builders -----------------------------------------------------------

def test_native_builder_against_numpy_on_the_blob():
    """The C++ builder and the numpy builder on the blob mesh: same nodes,
    boxes, offsets and leaf sizes, same SET of triangles in every leaf, but
    another order inside a leaf (so the leaf tables are not byte-equal and
    build_bvh names its builder)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native builder cannot be compiled")
    from gnxraytracer_tpu_torch import native

    v, t = blob(24)
    a = native.build_bvh_sah(v, t, T_bvh.LEAF_SIZE)
    b = T_bvh.build_bvh_numpy(v, t)
    assert a is not None
    for x, y in zip(a[:5], b[:5]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    off, npr = a[2], a[3]
    for leaf in np.nonzero(npr > 0)[0]:
        rows = slice(off[leaf], off[leaf] + npr[leaf])
        assert sorted(a[5][rows]) == sorted(b[5][rows])
    assert not np.array_equal(a[5], b[5])
    # the port's g++ build of its copy of the source gives what the JAX
    # package's checked-in library gives
    from gnxraytracer_tpu.native import bvh_native

    for n_seg in (8, 24, 46):
        vv, tt_ = blob(n_seg)
        theirs = bvh_native.build(vv, tt_, T_bvh.LEAF_SIZE)
        if theirs is not None:  # None: that library could not be loaded
            for x, y in zip(native.build_bvh_sah(vv, tt_, T_bvh.LEAF_SIZE),
                            theirs):
                np.testing.assert_array_equal(x, y)
    from gnxraytracer_tpu_torch.tools import compare_bvh_builders

    assert compare_bvh_builders.compare(8)  # the script that PERF.md cites
    # the library lies in the package's build directory, named by its source
    assert native.library_path().startswith(native.BUILD_DIR)
    tn = T_bvh.build_bvh(v, t, builder="native", device="cpu")
    tp = T_bvh.build_bvh(v, t, builder="numpy", device="cpu")
    np.testing.assert_array_equal(tn.wide.rec.numpy()[:, :12],
                                  tp.wide.rec.numpy()[:, :12])
    with pytest.raises(ValueError):
        T_bvh.build_bvh(v, t, builder="lbvh", device="cpu")


# -- the coherence sort -----------------------------------------------------------

@pytest.mark.parametrize("key_mode", ["oct_morton", "oct_morton8",
                                      "morton_oct", "morton6d"])
def test_ray_sort_perm_equal_permutations(key_mode):
    rs = np.random.RandomState(5)
    n = 5000
    o = (rs.rand(n, 3).astype(np.float32) - 0.5) * 6
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, 1e30, np.float32)
    t_max[::7] = 0.0
    lo = np.asarray([-2.0, -2.5, -3.0], np.float32)
    hi = np.asarray([2.0, 2.5, 3.0], np.float32)
    for tm in (None, t_max):
        pj, ij = J_bvh.ray_sort_perm(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo), jnp.asarray(hi),
            t_max=None if tm is None else jnp.asarray(tm), key_mode=key_mode)
        pt, it = T_bvh.ray_sort_perm(
            torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lo),
            torch.from_numpy(hi),
            t_max=None if tm is None else torch.from_numpy(tm),
            key_mode=key_mode)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(pt.numpy()[it.numpy()], np.arange(n))
    dead_last = t_max[pt.numpy()]
    n_dead = int((t_max <= 0).sum())
    assert (dead_last[-n_dead:] <= 0).all() and (dead_last[:-n_dead] > 0).all()
    with pytest.raises(ValueError):
        T_bvh.ray_sort_perm(torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(lo), torch.from_numpy(hi),
                            key_mode="nope")
