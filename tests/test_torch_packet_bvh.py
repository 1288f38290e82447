"""The plain PyTorch walks over the binary threaded BVH table (the plain
versions of the CUDA kernels in csrc/packet_bvh.cu, which cannot run without a
card, and what the kernels are held against on the card) against three walks
of the JAX package over the SAME tree:

  * ``pallas_bvh.packet_closest_hit`` / ``packet_any_hit``, the TPU kernels
    these replace, in interpret mode as tests/test_pallas.py runs them on the
    CPU,
  * ``bvh.packet_closest_hit_xla`` / ``packet_any_hit_xla``,
  * the brute-force ``intersect.closest_triangle_hit`` / ``any_triangle_hit``.

The JAX package's tree is carried across with convert.bvh_from_numpy_tree,
which makes the port's PacketPack from the binary tables once per tree.

Tolerances: ``hit`` and ``occ`` identical; ``t`` within rtol 1e-5 (plus atol
1e-6: t is a sum of products that cancel near the origin); barycentrics
within atol 1e-5; ``tri`` identical except on lanes where two triangles tie
in t (a shared edge or vertex): the port walks the links of the ray's own
octant, the JAX walks those of a block's first ray, so another of the tied
triangles may win.  On such a lane the other triangle must really be hit at
the same t."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnxraytracer_tpu.ops import bvh as J_bvh
from gnxraytracer_tpu.ops import intersect as J_int
from gnxraytracer_tpu.ops import pallas_bvh as J_pb
from gnxraytracer_tpu_torch import convert
from gnxraytracer_tpu_torch.kernels import packet_bvh as T_pk
from gnxraytracer_tpu_torch.kernels import wide_bvh as T_wk
from gnxraytracer_tpu_torch.ops import bvh as T_bvh

from test_torch_wide_bvh import (MESHES, N_RAYS, RAYS, _edge_case, _t_of, blob,
                                 incoherent_rays, mixed_t_max)

_cases = {}


def make_case(name):
    if name in _cases:
        return _cases[name]
    mesh, rays = name.split("-")
    v, t = MESHES[mesh]()
    jb = J_bvh._finish_build(J_bvh.build_bvh_numpy(v, t), v, t)
    tb = convert.bvh_from_numpy_tree(jax.tree.map(np.asarray, jb),
                                     device="cpu")
    o, d = RAYS[rays](N_RAYS, v.min(0), v.max(0))
    t_max = mixed_t_max(N_RAYS, float((v.max(0) - v.min(0)).max()) * 2)
    args = [torch.from_numpy(x) for x in (o, d, t_max)]
    _cases[name] = dict(
        v=v, t=t, jb=jb, bvh=tb, pack=tb.packet, o=o, d=d, t_max=t_max,
        closest=T_pk.packet_closest_hit_reference(tb.packet, *args),
        occ=T_pk.packet_any_hit_reference(tb.packet, *args))
    return _cases[name]


@pytest.fixture(scope="module", params=["blob12-camera", "blob20-incoherent",
                                        "soup37-camera", "soup37-incoherent"])
def case(request):
    return make_case(request.param)


# the TPU kernels in interpret mode are compiled anew for every tree (seconds
# a call), so they are held against on two of the cases
@pytest.fixture(scope="module", params=["blob12-camera", "soup37-incoherent"])
def interpret_case(request):
    return make_case(request.param)


def _agree(case, hit, t, tri, b=None):
    """The plain closest-hit walk against a JAX walk's (hit, t, tri[, b])."""
    ours, t_max = case["closest"], case["t_max"]
    h = ours.hit.numpy()
    np.testing.assert_array_equal(h, np.asarray(hit))
    assert h.sum() > N_RAYS // 20  # the ray set exercises real hits
    t1, t2 = ours.t.numpy(), np.asarray(t)
    np.testing.assert_allclose(t1[h], t2[h], rtol=1e-5, atol=1e-6)
    tri1, tri2 = ours.tri.numpy(), np.asarray(tri)
    differ = np.nonzero(h & (tri1 != tri2))[0]
    assert len(differ) <= h.sum() // 50, "too many lanes for ties alone"
    for lane in differ:  # a tie: the other triangle is hit at the same t
        t_other = _t_of(case, lane, int(tri2[lane]))
        assert t_other is not None
        np.testing.assert_allclose(t_other, t1[lane], rtol=1e-5, atol=1e-6)
    if b is not None:
        same = h & (tri1 == tri2)
        np.testing.assert_allclose(ours.b.numpy()[same], np.asarray(b)[same],
                                   atol=1e-5)
    # miss conventions of the wrappers: t = INFINITY, tri = 0, b = (1, 0, 0)
    miss = ~h
    assert (t1[miss] == np.finfo(np.float32).max).all()
    assert (tri1[miss] == 0).all()
    assert (ours.b.numpy()[miss] == np.asarray([1, 0, 0], np.float32)).all()
    # dead lanes are inert; hits respect t_max
    assert not h[t_max <= 0].any()
    assert (t1[h] <= t_max[h]).all()


def _jargs(case):
    return [jnp.asarray(case[k]) for k in ("o", "d", "t_max")]


def test_pack_tables_equal_pack_bvh_for_pallas(case):
    """The once-per-tree pack is, table for table, what the JAX package
    packs per cast."""
    for ours, theirs in zip(case["pack"], J_pb.pack_bvh_for_pallas(case["jb"])):
        theirs = np.asarray(theirs)
        assert ours.numpy().dtype == theirs.dtype
        np.testing.assert_array_equal(ours.numpy(), theirs)
    assert case["pack"].meta.shape[0] == 8
    assert all(x.is_contiguous() for x in case["pack"])


def test_pack_of_own_numpy_build_equals_carried(case):
    own = T_bvh.build_bvh(case["v"], case["t"], builder="numpy", device="cpu")
    for a, b in zip(own.packet, case["pack"]):
        assert torch.equal(a, b)
    assert own.treelets is None


def test_closest_matches_tpu_kernel_interpret(interpret_case):
    case = interpret_case
    t, tri, u, v = J_pb.packet_closest_hit(
        *J_pb.pack_bvh_for_pallas(case["jb"]), *_jargs(case), interpret=True)
    tri = np.asarray(tri)
    b = np.stack([1.0 - np.asarray(u) - np.asarray(v), u, v], -1)
    _agree(case, tri >= 0, t, np.maximum(tri, 0), b)


def test_any_hit_matches_tpu_kernel_interpret(interpret_case):
    case = interpret_case
    occ = J_pb.packet_any_hit(*J_pb.pack_bvh_for_pallas(case["jb"]),
                              *_jargs(case), interpret=True)
    np.testing.assert_array_equal(case["occ"].numpy(), np.asarray(occ))


def test_closest_matches_xla_packet_walk(case):
    ref = J_bvh.packet_closest_hit_xla(case["jb"], *_jargs(case))
    _agree(case, ref.hit, ref.t, ref.tri, ref.b)


def test_closest_matches_brute_force(case):
    ref = J_int.closest_triangle_hit(
        *_jargs(case), jnp.asarray(case["v"]), jnp.asarray(case["t"]))
    _agree(case, ref.hit, ref.t, ref.tri, ref.b)


def test_any_hit_matches_xla_walk_and_brute_force(case):
    occ = case["occ"].numpy()
    assert occ.sum() > N_RAYS // 20
    np.testing.assert_array_equal(
        occ, np.asarray(J_bvh.packet_any_hit_xla(case["jb"], *_jargs(case))))
    np.testing.assert_array_equal(
        occ, np.asarray(J_int.any_triangle_hit(
            *_jargs(case), jnp.asarray(case["v"]), jnp.asarray(case["t"]))))
    # any hit and closest hit agree on which rays are blocked
    np.testing.assert_array_equal(occ, case["closest"].hit.numpy())
    assert not occ[case["t_max"] <= 0].any()


def test_binary_and_wide_walks_agree(case):
    """The port's two plain walks over the same tree: same hits and t; tri
    up to ties (both take the ray's own octant, but a wide node visits its
    eight children in another order than three binary levels do)."""
    args = [torch.from_numpy(case[k]) for k in ("o", "d", "t_max")]
    wide = T_wk.wide_closest_hit_reference(case["bvh"].wide, *args)
    _agree(case, wide.hit.numpy(), wide.t.numpy(), wide.tri.numpy(),
           wide.b.numpy())
    assert torch.equal(T_wk.wide_any_hit_reference(case["bvh"].wide, *args),
                       case["occ"])


def test_wrapper_on_cpu_is_the_plain_walk(case):
    """On CPU tensors the wrappers run the plain versions and count no
    launch; the coherence sort (any key) changes nothing."""
    args = [torch.from_numpy(case[k]) for k in ("o", "d", "t_max")]
    before = (T_pk.closest_launch_count, T_pk.any_launch_count)
    for kw in (dict(sort=False), dict(sort=True),
               dict(sort=True, sort_key="morton_oct")):
        got = T_pk.packet_closest_hit(case["pack"], *args, **kw)
        for a, b in zip(got, case["closest"]):
            assert torch.equal(a, b)
        assert torch.equal(T_pk.packet_any_hit(case["pack"], *args, **kw),
                           case["occ"])
    assert (T_pk.closest_launch_count, T_pk.any_launch_count) == before
    T_pk.reset_launch_counts()
    assert (T_pk.closest_launch_count, T_pk.any_launch_count) == (0, 0)


@pytest.mark.parametrize("near_r", [0.05, 0.6, 50.0])
def test_two_phase_cast_equals_one_phase(case, near_r):
    """near_r caps the first walk and re-casts its misses: the same closest
    hit (tri too: both phases walk in the same order), whatever the cap."""
    args = [torch.from_numpy(case[k]) for k in ("o", "d", "t_max")]
    got = T_pk.packet_closest_hit(case["pack"], *args, near_r=near_r)
    for a, b in zip(got, case["closest"]):
        assert torch.equal(a, b)
    if near_r == 0.6:  # as the JAX wrapper's two-phase cast (interpret mode
        # is slow: the smallest case only)
        if case is not make_case("blob12-camera"):
            return
        ref = J_pb._packet_closest_hit_pallas_1(
            case["jb"]._replace(treelets=None), *_jargs(case), sort=True,
            interpret=True)
        _agree(case, ref.hit, ref.t, ref.tri, ref.b)


def test_walk_counts_its_visits(case):
    args = [torch.from_numpy(case[k]) for k in ("o", "d", "t_max")]
    s_c, s_a = {}, {}
    T_pk.packet_closest_hit_reference(case["pack"], *args, stats=s_c)
    T_pk.packet_any_hit_reference(case["pack"], *args, stats=s_a)
    alive = int((case["t_max"] > 0).sum())
    assert s_c["node_visits"] >= alive  # every live ray tests the root
    assert s_c["leaf_visits"] > 0
    # the any-hit walk ends at its first hit: never more work than closest
    assert s_a["node_visits"] <= s_c["node_visits"]
    # a binary walk tests more boxes than the width-8 walk pops entries
    s_w = {}
    T_wk.wide_closest_hit_reference(case["bvh"].wide, *args, stats=s_w)
    assert s_c["node_visits"] > s_w["node_visits"]


def test_dead_lanes_visit_nothing(case):
    n = 64
    args = [torch.from_numpy(case[k][:n].copy()) for k in ("o", "d")]
    stats = {}
    th = T_pk.packet_closest_hit_reference(
        case["pack"], *args, torch.zeros((n,)), stats=stats)
    assert not bool(th.hit.any()) and stats["node_visits"] == 0
    assert not bool(T_pk.packet_any_hit_reference(
        case["pack"], *args, torch.full((n,), -1.0)).any())


# -- the kernels' first pass and the wrappers' defaults ----------------------------

def test_triage_leaves_results_and_visits_unchanged(case):
    """The rays the kernels' first pass settles (dead, or missing the root,
    whose miss link ends the walk) get the miss record and their whole walk
    is the root's test; walking only the others gives those the same
    results, and the visits add up."""
    args = [torch.from_numpy(case[k]) for k in ("o", "d", "t_max")]
    go = T_pk.entering(case["pack"], *args)
    live = args[2] > 0
    settled = live & ~go
    assert int(go.sum()) > 0 and int(settled.sum()) > 0
    assert not bool(case["closest"].hit[~go].any())
    assert not bool(case["occ"][~go].any())
    s_all, s_go = {}, {}
    per_ray = torch.zeros((N_RAYS,), dtype=torch.int64)
    T_pk.packet_closest_hit_reference(case["pack"], *args, stats=s_all,
                                      ray_visits=per_ray)
    assert int(per_ray.sum()) == s_all["node_visits"]
    assert bool((per_ray[settled] == 1).all())
    assert bool((per_ray[~live] == 0).all())
    sub = [x[go].contiguous() for x in args]
    got = T_pk.packet_closest_hit_reference(case["pack"], *sub, stats=s_go)
    for a, b in zip(got, case["closest"]):
        assert torch.equal(a, b[go])
    assert s_go["node_visits"] + int(settled.sum()) == s_all["node_visits"]
    assert s_go["leaf_visits"] == s_all["leaf_visits"]
    assert torch.equal(T_pk.packet_any_hit_reference(case["pack"], *sub),
                       case["occ"][go])


def test_triage_lists_rays_of_a_table_that_does_not_thread_a_tree():
    """A root whose miss link goes on: the first pass leaves even the rays
    that miss the root to the walk, which refuses the table."""
    v, t = blob(12)
    pack = T_bvh.build_bvh(v, t, builder="numpy", device="cpu").packet
    o = torch.tensor([[0.0, 0.0, 50.0]])
    d = torch.tensor([[0.0, 1.0, 0.0]])  # misses the root's box
    tm = torch.tensor([1e30])
    assert not bool(T_pk.entering(pack, o, d, tm)[0])
    meta = pack.meta.clone()
    meta[:, 0, 1] = 0
    bad = pack._replace(meta=meta)
    assert bool(T_pk.entering(bad, o, d, tm)[0])
    with pytest.raises(RuntimeError, match="do not thread a tree"):
        T_pk.packet_closest_hit(bad, o, d, tm)


@pytest.mark.parametrize("wrapper", ["packet_closest_hit", "packet_any_hit"])
def test_wrappers_do_not_sort_by_default(case, wrapper):
    """sort=False is the default, as for the wide wrappers; the results are
    those of the sorted cast."""
    import inspect

    fn = getattr(T_pk, wrapper)
    assert inspect.signature(fn).parameters["sort"].default is False
    args = [torch.from_numpy(case[k]) for k in ("o", "d", "t_max")]
    plain, srt = fn(case["pack"], *args), fn(case["pack"], *args, sort=True)
    if isinstance(plain, torch.Tensor):
        assert torch.equal(plain, srt)
    else:
        for a, b in zip(plain, srt):
            assert torch.equal(a, b)


# -- a closed tree: the walls and the light inside it ------------------------------

_closed = {}


def closed_case():
    """The Cornell box with a small test mesh, one tree over ALL its
    triangles (walls and light in it), and rays from inside the box."""
    if _closed:
        return _closed
    from gnxraytracer_tpu_torch.scene import loaders as T_load
    from gnxraytracer_tpu_torch.scene import presets as T_presets

    scene, _ = T_presets.cornell_box(8, 8, mesh=T_load.make_test_mesh(2),
                                     bvh=True, device="cpu")
    v = scene.geom.vertices.numpy()
    t = scene.geom.triangles.numpy()
    bvh = T_bvh.build_bvh(v, t, builder="numpy", device="cpu")
    assert int((bvh.packet.tid >= 0).sum()) == len(t)
    lo, hi = v.min(0), v.max(0)
    rs = np.random.RandomState(5)
    o = (lo + (hi - lo) * (0.1 + 0.8 * rs.rand(N_RAYS, 3))).astype(np.float32)
    d = rs.randn(N_RAYS, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = mixed_t_max(N_RAYS, float((hi - lo).max()))
    args = [torch.from_numpy(x) for x in (o, d, t_max)]
    _closed.update(v=v, t=t, bvh=bvh, o=o, d=d, t_max=t_max, args=args,
                   closest=T_pk.packet_closest_hit_reference(bvh.packet, *args),
                   occ=T_pk.packet_any_hit_reference(bvh.packet, *args))
    return _closed


@pytest.mark.parametrize("walk", ["binary", "wide"])
def test_closed_tree_walks_agree_with_brute_force(walk):
    """On a tree that holds the walls, nearly every live ray hits inside
    it; both plain walks against the JAX package's brute force."""
    case = closed_case()
    if walk == "binary":
        got, occ = case["closest"], case["occ"]
    else:
        got = T_wk.wide_closest_hit_reference(case["bvh"].wide, *case["args"])
        occ = T_wk.wide_any_hit_reference(case["bvh"].wide, *case["args"])
    jargs = [jnp.asarray(case[k]) for k in ("o", "d", "t_max")]
    ref = J_int.closest_triangle_hit(*jargs, jnp.asarray(case["v"]),
                                     jnp.asarray(case["t"]))
    live = case["t_max"] > 0
    unbounded = case["t_max"] > 1e29
    assert got.hit.numpy()[unbounded].mean() > 0.7  # the front is open
    _agree(dict(case, closest=got), ref.hit, ref.t, ref.tri, ref.b)
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(J_int.any_triangle_hit(
            *jargs, jnp.asarray(case["v"]), jnp.asarray(case["t"]))))
    assert not occ.numpy()[~live].any()


# -- a tree without octant links: K = 1 -------------------------------------------

def test_fixed_order_tree_k1():
    """A hand-built tree without first8/miss8 packs the single depth-first
    order (first child = node + 1, the fixed miss links), as
    pack_bvh_for_pallas does, and the walk reads octant 0 for every ray."""
    v, t = blob(12)
    jb = J_bvh._finish_build(J_bvh.build_bvh_numpy(v, t), v, t)
    jb1 = jb._replace(first8=None, miss8=None)
    nt = jax.tree.map(np.asarray, jb)
    pack = T_bvh.build_packet_pack(
        nt.bounds_lo, nt.bounds_hi, nt.offset, nt.n_prims, nt.prim_idx,
        nt.leaf_soa, nt.miss, device="cpu")
    assert tuple(pack.meta.shape) == (1, len(nt.offset), 2)
    for ours, theirs in zip(pack, J_pb.pack_bvh_for_pallas(jb1)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    o, d = incoherent_rays(N_RAYS, v.min(0), v.max(0))
    t_max = mixed_t_max(N_RAYS, 4.0)
    args = [torch.from_numpy(x) for x in (o, d, t_max)]
    got = T_pk.packet_closest_hit(pack, *args)
    full = make_case("blob12-camera")["pack"]  # the same tree, octant links
    ref = T_pk.packet_closest_hit(full, *args)
    assert torch.equal(got.hit, ref.hit) and int(got.hit.sum()) > N_RAYS // 20
    np.testing.assert_allclose(got.t.numpy(), ref.t.numpy(), rtol=1e-5)
    assert torch.equal(T_pk.packet_any_hit(pack, *args), got.hit)
    jt, jtri, _, _ = J_pb.packet_closest_hit(
        *J_pb.pack_bvh_for_pallas(jb1), *[jnp.asarray(x) for x in (o, d, t_max)],
        interpret=True)
    np.testing.assert_array_equal(np.asarray(jtri) >= 0, got.hit.numpy())
    h = got.hit.numpy()
    np.testing.assert_allclose(np.asarray(jt)[h], got.t.numpy()[h], rtol=1e-5,
                               atol=1e-6)
    # one order for every ray, the JAX kernel's too: tri agrees everywhere
    np.testing.assert_array_equal(np.asarray(jtri)[h], got.tri.numpy()[h])


# -- the shared-edge sets of tests/test_pallas.py::TestWatertightLeaf --------------

def test_shared_edge_no_leak():
    """Rays aimed exactly at the shared diagonal of a two-triangle quad: none
    leaks through the tree, closest hit or any hit, and the hit set is the
    JAX package's (binary kernel in interpret mode, and brute force)."""
    verts, tris, o, d = _edge_case()
    pack = T_bvh.build_bvh(verts, tris, builder="numpy", device="cpu").packet
    t_max = np.full(len(o), 1e30, np.float32)
    args = [torch.from_numpy(x) for x in (o, d, t_max)]
    th = T_pk.packet_closest_hit(pack, *args)
    assert bool(th.hit.all()), f"{int((~th.hit).sum())} rays leaked"
    assert bool(T_pk.packet_any_hit(pack, *args).all())
    jb = J_bvh._finish_build(J_bvh.build_bvh_numpy(verts, tris), verts, tris)
    jargs = [jnp.asarray(x) for x in (o, d, t_max)]
    jt, jtri, _, _ = J_pb.packet_closest_hit(*J_pb.pack_bvh_for_pallas(jb),
                                             *jargs, interpret=True)
    assert (np.asarray(jtri) >= 0).all()
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jt), rtol=1e-5)
    ref = J_int.closest_triangle_hit(*jargs, jnp.asarray(verts),
                                     jnp.asarray(tris))
    np.testing.assert_array_equal(th.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(ref.t), rtol=1e-5)
    # on the diagonal both triangles tie: row order decides, the first wins
    assert (th.tri.numpy() == 0).sum() > 0


def test_shared_edge_between_two_leaves():
    """Eight quads in a row (16 triangles, several leaves): rays through the
    shared edges of neighbouring quads hit, whichever leaf the walk reaches
    first."""
    xs = np.arange(9, dtype=np.float32)
    verts = np.concatenate([np.stack([xs, np.zeros(9), np.zeros(9)], -1),
                            np.stack([xs, np.ones(9), np.zeros(9)], -1)]
                           ).astype(np.float32)
    tris = np.concatenate([[[i, i + 1, i + 9], [i + 1, i + 10, i + 9]]
                           for i in range(8)]).astype(np.int32)
    rs = np.random.RandomState(3)
    n = 400
    tx = rs.randint(1, 8, n).astype(np.float32)   # on the inner x = k edges
    ty = (0.05 + 0.9 * rs.rand(n)).astype(np.float32)
    target = np.stack([tx, ty, np.zeros(n, np.float32)], -1)
    o = np.broadcast_to(np.asarray([4.2, 0.4, 6.0], np.float32), (n, 3)).copy()
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    bvh = T_bvh.build_bvh(verts, tris, builder="numpy", device="cpu")
    assert bvh.packet.nodes.shape[0] > 3
    args = [torch.from_numpy(x) for x in (o, d, np.full(n, 1e30, np.float32))]
    th = T_pk.packet_closest_hit(bvh.packet, *args)
    assert bool(th.hit.all()), f"{int((~th.hit).sum())} rays leaked"
    assert bool(T_pk.packet_any_hit(bvh.packet, *args).all())
    ref = J_int.closest_triangle_hit(*[jnp.asarray(x.numpy()) for x in args],
                                     jnp.asarray(verts), jnp.asarray(tris))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(ref.t), rtol=1e-5)


def test_first_triangle_of_a_row_wins_a_tie():
    """Two coincident triangles in one leaf row: strict t < t_best keeps the
    first; t_max in front of them gives a miss."""
    verts = np.asarray([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    tris = np.asarray([[0, 1, 2], [0, 1, 2]], np.int32)
    pack = T_bvh.build_bvh(verts, tris, builder="numpy", device="cpu").packet
    o = torch.tensor([[0.0, 0.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    far = T_pk.packet_closest_hit(pack, o, d, torch.tensor([10.0]))
    assert bool(far.hit[0]) and int(far.tri[0]) == int(pack.tid[0, 0])
    np.testing.assert_allclose(float(far.t[0]), 5.0, rtol=1e-5)
    assert not bool(T_pk.packet_closest_hit(pack, o, d, torch.tensor([4.0])).hit[0])
    assert not bool(T_pk.packet_any_hit(pack, o, d, torch.tensor([4.0]))[0])
    assert bool(T_pk.packet_any_hit(pack, o, d, torch.tensor([10.0]))[0])


def test_walk_refuses_links_that_do_not_thread_a_tree():
    """A table whose miss links loop never returns a partial walk: it
    raises once the step count passes the node count."""
    v, t = blob(12)
    pack = T_bvh.build_bvh(v, t, builder="numpy", device="cpu").packet
    meta = pack.meta.clone()
    meta[:, :, 1] = 0  # every miss link back to the root
    o, d = incoherent_rays(50, v.min(0), v.max(0))
    with pytest.raises(RuntimeError, match="do not thread a tree"):
        T_pk.packet_closest_hit(pack._replace(meta=meta), torch.from_numpy(o),
                                torch.from_numpy(d), torch.full((50,), 1e30))


def test_wrapper_refuses_bad_inputs():
    v, t = blob(8)
    pack = T_bvh.build_bvh(v, t, builder="numpy", device="cpu").packet
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    tm = torch.ones((4,))
    for fn in (T_pk.packet_closest_hit, T_pk.packet_any_hit):
        with pytest.raises(TypeError):
            fn(pack, o.double(), d, tm)
        with pytest.raises(ValueError):
            fn(pack, o, d[:3], tm)
        with pytest.raises(ValueError):
            fn(pack, o.T.contiguous().T, d, tm)  # not contiguous
        with pytest.raises(ValueError):
            fn(pack._replace(nodes=pack.nodes[:, :6].contiguous()), o, d, tm)
        with pytest.raises(ValueError):
            fn(pack._replace(meta=pack.meta[:3].contiguous()), o, d, tm)
        with pytest.raises(TypeError):
            fn(pack._replace(tid=pack.tid.long()), o, d, tm)
    # no rays: empty results, nothing walked
    assert T_pk.packet_closest_hit(pack, o[:0], d[:0], tm[:0]).t.shape == (0,)
    assert T_pk.packet_any_hit(pack, o[:0], d[:0], tm[:0]).shape == (0,)


# -- which walk serves a cast ------------------------------------------------------

def test_use_wide_follows_the_environment(monkeypatch):
    v, t = blob(8)
    bvh = T_bvh.build_bvh(v, t, builder="numpy", device="cpu")
    monkeypatch.delenv("GNX_WIDE_BVH", raising=False)
    assert T_pk._use_wide(bvh)
    monkeypatch.setenv("GNX_WIDE_BVH", "0")
    assert not T_pk._use_wide(bvh)          # read at call time
    monkeypatch.setenv("GNX_WIDE_BVH", "1")
    assert T_pk._use_wide(bvh)
    assert not T_pk._use_wide(bvh._replace(wide=None))
    # the JAX package's rule, on its own tree
    jb = J_bvh._finish_build(J_bvh.build_bvh_numpy(v, t), v, t)
    for val in ("0", "1"):
        monkeypatch.setenv("GNX_WIDE_BVH", val)
        assert T_pk._use_wide(bvh) == J_pb._use_wide(jb)


@pytest.mark.parametrize("mode", ["pallas", "packet"])
def test_scene_casts_take_the_binary_walk(mode, monkeypatch):
    """ops/trace with GNX_WIDE_BVH=0: both bvh_modes walk the binary table
    (the wide wrappers are not called) and give the wide walk's hits."""
    from gnxraytracer_tpu_torch.models.integrators import path as T_path
    from gnxraytracer_tpu_torch.ops import trace as T_trace
    from gnxraytracer_tpu_torch.scene import loaders as T_load
    from gnxraytracer_tpu_torch.scene import presets as T_presets

    scene, _ = T_presets.cornell_box(8, 8, mesh=T_load.make_test_mesh(2),
                                     bvh=True, device="cpu")
    cfg = T_path.make_config(scene, 8, 8, spp=1, bvh_mode=mode)
    rs = np.random.RandomState(0)
    o = torch.from_numpy((rs.rand(300, 3) * 3 - 1.5).astype(np.float32))
    d = rs.randn(300, 3).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    t = torch.full((300,), 1e30)
    t[::6] = 0.0
    monkeypatch.delenv("GNX_WIDE_BVH", raising=False)
    want = T_trace.scene_intersect(scene, cfg, o, d, t)
    want_occ = T_trace.scene_occluded(scene, cfg, o, d, t)
    monkeypatch.setenv("GNX_WIDE_BVH", "0")

    def refuse(*a, **kw):
        raise AssertionError("the wide walk was called")

    for name in ("wide_closest_hit", "wide_any_hit",
                 "wide_closest_hit_reference", "wide_any_hit_reference"):
        monkeypatch.setattr(T_wk, name, refuse)
    got = T_trace.scene_intersect(scene, cfg, o, d, t)
    assert torch.equal(got.hit, want.hit) and bool(got.hit.any())
    np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), rtol=1e-5)
    assert torch.equal(T_trace.scene_occluded(scene, cfg, o, d, t), want_occ)


# -- on the card only -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (chip_smoke.py holds them against their plain "
                    "versions on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_walks_on_card(case, cuda_device):
    """The CUDA kernels against their plain versions on the same device: hit,
    occ and tri identical, t rtol 1e-5, b atol 1e-5; launches are counted."""
    pack = type(case["pack"])(*(x.to(cuda_device) for x in case["pack"]))
    args = [torch.from_numpy(case[k]).to(cuda_device)
            for k in ("o", "d", "t_max")]
    before = (T_pk.closest_launch_count, T_pk.any_launch_count)
    got = T_pk.packet_closest_hit(pack, *args)
    occ = T_pk.packet_any_hit(pack, *args)
    torch.cuda.synchronize()
    assert (T_pk.closest_launch_count, T_pk.any_launch_count) == (
        before[0] + 1, before[1] + 1)
    ref = T_pk.packet_closest_hit_reference(pack, *args)
    assert torch.equal(got.hit, ref.hit) and torch.equal(got.tri, ref.tri)
    np.testing.assert_allclose(got.t.cpu().numpy(), ref.t.cpu().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(got.b.cpu().numpy(), ref.b.cpu().numpy(),
                               atol=1e-5)
    assert torch.equal(occ, T_pk.packet_any_hit_reference(pack, *args))
    two = T_pk.packet_closest_hit(pack, *args, near_r=0.5)
    assert torch.equal(two.hit, got.hit) and torch.equal(two.tri, got.tri)
