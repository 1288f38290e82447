"""The plain PyTorch walks over the width-8 BVH table (the plain versions of
the CUDA kernels in csrc/wide_bvh.cu, which cannot run without a card, and
what the kernels are held against on the card) against three walks of the JAX
package over the SAME tree:

  * ``bvh.packet_closest_hit_xla`` / ``packet_any_hit_xla`` (binary tree),
  * ``pallas_wbvh.wide_closest_hit_pallas`` / ``wide_any_hit_pallas``, the
    TPU kernel these replace, in interpret mode as tests/test_pallas.py runs
    the Pallas kernels on the CPU,
  * the brute-force ``intersect.closest_triangle_hit`` / ``any_triangle_hit``.

The JAX package's tree is carried across with convert.bvh_from_numpy_tree,
which makes the port's one-table GPU pack from the binary tables.

Tolerances: ``hit`` and ``occ`` identical; ``t`` within rtol 1e-5 (plus atol
1e-6: t is a sum of products that cancel near the origin); barycentrics
within atol 1e-5; ``tri`` identical except on lanes where two triangles tie
in t (a shared edge or vertex): the port visits children in the order of the
ray's own octant, the JAX walks in the order of a block's first ray, so
another of the tied triangles may win.  On such a lane the other triangle
must really be hit at the same t."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnxraytracer_tpu.ops import bvh as J_bvh
from gnxraytracer_tpu.ops import intersect as J_int
from gnxraytracer_tpu.ops import pallas_wbvh as J_wb
from gnxraytracer_tpu.scene import loaders as J_load
from gnxraytracer_tpu_torch import convert
from gnxraytracer_tpu_torch.constants import INFINITY
from gnxraytracer_tpu_torch.kernels import wide_bvh as T_wk
from gnxraytracer_tpu_torch.ops import bvh as T_bvh
from gnxraytracer_tpu_torch.ops import intersect as T_int
from gnxraytracer_tpu_torch.ops import wbvh as T_wb

N_RAYS = 2048  # one ray block of the TPU kernel: interpret mode is slow


def blob(n_seg):
    v, t, _n, _uv = J_load.make_blob_mesh(n_seg)
    return np.asarray(v, np.float32), np.asarray(t, np.int32)


def soup(n_tris, seed):
    rs = np.random.RandomState(seed)
    tris = (rs.randn(n_tris, 1, 3) * 1.0
            + rs.randn(n_tris, 3, 3) * 0.8).astype(np.float32)
    return (tris.reshape(-1, 3),
            np.arange(n_tris * 3).reshape(n_tris, 3).astype(np.int32))


def camera_rays(n, lo, hi):
    """One origin outside the mesh, directions through a jittered grid over
    its box: coherent, and many pass exactly through shared edges' pixels."""
    rs = np.random.RandomState(2)
    c, ext = (lo + hi) / 2, (hi - lo)
    eye = c + np.asarray([0.3, 0.4, 2.5], np.float32) * ext.max()
    side = int(np.ceil(n ** 0.5))
    gy, gx = np.mgrid[0:side, 0:side].reshape(2, -1)[:, :n]
    px = (gx + rs.rand(n)) / side - 0.5
    py = (gy + rs.rand(n)) / side - 0.5
    target = c + np.stack([px * ext[0] * 1.3, py * ext[1] * 1.3,
                           np.zeros(n)], -1)
    d = (target - eye).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(eye.astype(np.float32), (n, 3)).copy()
    return o, d.astype(np.float32)


def incoherent_rays(n, lo, hi):
    rs = np.random.RandomState(3)
    o = (lo + (hi - lo) * (rs.rand(n, 3) * 1.6 - 0.3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def mixed_t_max(n, scale):
    """Unbounded, cut short, and dead (0) lanes."""
    rs = np.random.RandomState(4)
    t_max = np.full(n, 1e30, np.float32)
    t_max[1::4] = rs.rand(len(t_max[1::4])).astype(np.float32) * scale
    t_max[2::8] = 0.0
    return t_max


MESHES = {"blob12": lambda: blob(12),     # 288 triangles
          "blob20": lambda: blob(20),     # 800 triangles
          "soup37": lambda: soup(37, 1)}  # leaves shorter than LEAF_SIZE
RAYS = {"camera": camera_rays, "incoherent": incoherent_rays}


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
        v=v, t=t, jb=jb, pack=tb.wide, o=o, d=d, t_max=t_max,
        closest=T_wk.wide_closest_hit_reference(tb.wide, *args),
        occ=T_wk.wide_any_hit_reference(tb.wide, *args))
    return _cases[name]


@pytest.fixture(scope="module", params=["blob12-camera", "blob20-incoherent",
                                        "soup37-camera", "soup37-incoherent"])
def case(request):
    return make_case(request.param)


# the TPU kernel in interpret mode takes 15-20 s a call whatever the size (it
# is compiled anew for every tree), so it is held against on two of the cases
@pytest.fixture(scope="module", params=["blob12-camera", "soup37-incoherent"])
def interpret_case(request):
    return make_case(request.param)


def _t_of(case, lane, tri):
    """t of one ray against one triangle, brute force (None on a miss)."""
    th = T_int.closest_triangle_hit(
        torch.from_numpy(case["o"][lane:lane + 1]),
        torch.from_numpy(case["d"][lane:lane + 1]),
        torch.tensor([INFINITY]), torch.from_numpy(case["v"]),
        torch.from_numpy(case["t"][tri:tri + 1]))
    return float(th.t[0]) if bool(th.hit[0]) else None


def _agree(case, ref, compare_b=True):
    ours, t_max = case["closest"], case["t_max"]
    h = ours.hit.numpy()
    np.testing.assert_array_equal(h, np.asarray(ref.hit))
    assert h.sum() > N_RAYS // 20  # the ray set exercises real hits
    t1, t2 = ours.t.numpy(), np.asarray(ref.t)
    np.testing.assert_allclose(t1[h], t2[h], rtol=1e-5, atol=1e-6)
    tri1, tri2 = ours.tri.numpy(), np.asarray(ref.tri)
    differ = np.nonzero(h & (tri1 != tri2))[0]
    assert len(differ) <= h.sum() // 50, "too many lanes for ties alone"
    for lane in differ:  # a tie: the other triangle is hit at the same t
        t_other = _t_of(case, lane, int(tri2[lane]))
        assert t_other is not None
        np.testing.assert_allclose(t_other, t1[lane], rtol=1e-5, atol=1e-6)
    if compare_b:
        same = h & (tri1 == tri2)
        np.testing.assert_allclose(ours.b.numpy()[same],
                                   np.asarray(ref.b)[same], atol=1e-5)
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


def test_closest_matches_xla_packet_walk(case):
    _agree(case, J_bvh.packet_closest_hit_xla(case["jb"], *_jargs(case)))


def test_closest_matches_tpu_kernel_interpret(interpret_case):
    case = interpret_case
    _agree(case, J_wb.wide_closest_hit_pallas(case["jb"], *_jargs(case),
                                              interpret=True))


def test_any_hit_matches_tpu_kernel_interpret(interpret_case):
    case = interpret_case
    np.testing.assert_array_equal(
        case["occ"].numpy(),
        np.asarray(J_wb.wide_any_hit_pallas(case["jb"], *_jargs(case),
                                            interpret=True)))


def test_closest_matches_brute_force(case):
    _agree(case, J_int.closest_triangle_hit(
        *_jargs(case), jnp.asarray(case["v"]), jnp.asarray(case["t"])))


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


def test_wrapper_on_cpu_is_the_plain_walk(case):
    """On CPU tensors the wrappers run the plain versions and count no
    launch; the coherence sort (any key) changes nothing."""
    args = [torch.from_numpy(case[k]) for k in ("o", "d", "t_max")]
    before = (T_wk.closest_launch_count, T_wk.any_launch_count)
    for kw in (dict(sort=False), dict(sort=True),
               dict(sort=True, sort_key="morton_oct")):
        got = T_wk.wide_closest_hit(case["pack"], *args, **kw)
        for a, b in zip(got, case["closest"]):
            assert torch.equal(a, b)
        assert torch.equal(T_wk.wide_any_hit(case["pack"], *args, **kw),
                           case["occ"])
    assert (T_wk.closest_launch_count, T_wk.any_launch_count) == before


def test_walk_counts_its_visits(case):
    args = [torch.from_numpy(case[k]) for k in ("o", "d", "t_max")]
    s_c, s_a = {}, {}
    T_wk.wide_closest_hit_reference(case["pack"], *args, stats=s_c)
    T_wk.wide_any_hit_reference(case["pack"], *args, stats=s_a)
    alive = int((case["t_max"] > 0).sum())
    entering = int(T_wk._frame_box_hit(case["pack"], args[0],
                                       T_wk._safe_inv(args[1]), args[2]).sum())
    assert 0 < entering <= alive
    # every live ray that enters the frame's box visits the root, no other
    assert s_c["node_visits"] >= entering
    assert s_c["leaf_visits"] > 0
    # the any-hit walk ends at its first hit: never more work than closest
    assert s_a["node_visits"] <= s_c["node_visits"]


# -- the shared-edge sets of tests/test_pallas.py::TestWatertightLeaf ------------

def _edge_case(n=500):
    verts = np.asarray([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                        [1.0, 1.0, 0.0]], np.float32)
    tris = np.asarray([[0, 1, 2], [1, 3, 2]], np.int32)
    s = np.random.RandomState(1).rand(n).astype(np.float32)
    targets = np.stack([s, 1 - s, np.zeros_like(s)], -1)
    o = np.broadcast_to(np.asarray([0.3, 0.3, 5.0], np.float32), (n, 3)).copy()
    d = targets - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return verts, tris, o, d


def test_shared_edge_no_leak():
    """Rays aimed exactly at the shared diagonal of a two-triangle quad: none
    leaks through the tree, closest hit or any hit, and the hit set is the
    JAX package's (wide kernel in interpret mode, and brute force)."""
    verts, tris, o, d = _edge_case()
    pack = T_bvh.build_bvh(verts, tris, builder="numpy", device="cpu").wide
    t_max = np.full(len(o), 1e30, np.float32)
    args = [torch.from_numpy(x) for x in (o, d, t_max)]
    th = T_wk.wide_closest_hit(pack, *args)
    assert bool(th.hit.all()), f"{int((~th.hit).sum())} rays leaked"
    assert bool(T_wk.wide_any_hit(pack, *args).all())
    jb = J_bvh._finish_build(J_bvh.build_bvh_numpy(verts, tris), verts, tris)
    jargs = [jnp.asarray(x) for x in (o, d, t_max)]
    for ref in (J_wb.wide_closest_hit_pallas(jb, *jargs, interpret=True),
                J_int.closest_triangle_hit(*jargs, jnp.asarray(verts),
                                           jnp.asarray(tris))):
        np.testing.assert_array_equal(th.hit.numpy(), np.asarray(ref.hit))
        np.testing.assert_allclose(th.t.numpy(), np.asarray(ref.t), rtol=1e-5)
    # on the diagonal both triangles tie: row order decides, the first wins
    assert (th.tri.numpy() == 0).sum() > 0


def test_first_triangle_of_a_row_wins_a_tie():
    """Two coincident triangles in one leaf row: strict t < t_best keeps the
    first; t_max in front of them gives a miss."""
    verts = np.asarray([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    tris = np.asarray([[0, 1, 2], [0, 1, 2]], np.int32)
    pack = T_bvh.build_bvh(verts, tris, builder="numpy", device="cpu").wide
    o = torch.tensor([[0.0, 0.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    far = T_wk.wide_closest_hit(pack, o, d, torch.tensor([10.0]))
    assert bool(far.hit[0]) and int(far.tri[0]) == int(pack.tid[0, 0])
    np.testing.assert_allclose(float(far.t[0]), 5.0, rtol=1e-5)
    assert not bool(T_wk.wide_closest_hit(pack, o, d, torch.tensor([4.0])).hit[0])
    assert not bool(T_wk.wide_any_hit(pack, o, d, torch.tensor([4.0]))[0])
    assert bool(T_wk.wide_any_hit(pack, o, d, torch.tensor([10.0]))[0])


def test_stack_overflow_fails_loudly():
    """A pack whose stack_size is too small for its tree raises; the walk
    never drops a subtree."""
    v, t = blob(12)
    pack = T_bvh.build_bvh(v, t, builder="numpy", device="cpu").wide
    o, d = incoherent_rays(200, v.min(0), v.max(0))
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.full((200,), 1e30))
    stats = {}
    T_wk.wide_closest_hit_reference(pack, *args, stats=stats)
    assert stats["max_stack"] >= 1
    with pytest.raises(RuntimeError, match="stack overflow"):
        T_wk.wide_closest_hit(pack._replace(stack_size=stats["max_stack"] - 1),
                              *args)


# -- the node-group walk: order, stack depth, the frame's box ---------------------

def _dfs_visits(pack, o, d, t_max):
    """A recursive depth-first walk of one ray over unpack_wide's boxes,
    targets and octant orders, written independently of the plain walk: the
    frame's box first, then at each node the 8 slab tests against the t_best
    of that moment and the wanted children nearest first, a leaf row tested
    where it is met.  Returns the visited node ids (>= 0) and leaf codes
    (< 0) in order."""
    lo, hi, targ, perms = T_wb.unpack_wide(pack.rec.numpy(), pack.frame.numpy())
    lo, hi = torch.from_numpy(lo), torch.from_numpy(hi)
    ot, dt = torch.from_numpy(o[None]), torch.from_numpy(d[None])
    inv = T_wk._safe_inv(dt)[0]
    octant = int(sum(1 << k for k in range(3) if d[k] < 0))
    (m0, m1), (sx, sy, sz) = T_int._permute_shear(dt)
    state = dict(t=torch.tensor([float(t_max)]), tri=torch.full((1,), -1, dtype=torch.int32),
                 u=torch.zeros(1), v=torch.zeros(1), found=torch.zeros(1, dtype=torch.bool))
    seq = []

    def want(blo, bhi):
        t0 = (blo - ot[0][:, None]) * inv[:, None]
        t1 = (bhi - ot[0][:, None]) * inv[:, None]
        tn = torch.amax(torch.minimum(t0, t1), dim=0)
        tf = torch.amin(torch.maximum(t0, t1), dim=0) * T_wk._SLAB_WIDEN
        tb = state["t"]
        return (tn <= tf) & (tf > 0) & (tn < tb) & (tb > 0)

    def visit(node):
        seq.append(node)
        w = want(lo[node], hi[node]) & torch.from_numpy(targ[node] != 0)
        for j in range(8):
            slot = int(perms[node, octant, j])
            if not bool(w[slot]):
                continue
            c = int(targ[node, slot])
            if c > 0:
                visit(c)
            else:
                seq.append(c)
                T_wk._leaf_rows(pack, torch.tensor([-c - 1]), torch.tensor([0]),
                                ot, (m0, m1, sx, sy, sz), state["t"],
                                state["tri"], state["u"], state["v"],
                                state["found"], False)

    f_lo, f_sc = pack.frame[0:3], pack.frame[3:6]
    if bool(want((f_lo)[:, None], (f_lo + 255.0 * f_sc)[:, None])[0]):
        visit(0)
    return seq


@pytest.mark.parametrize("name", ["blob20-incoherent", "soup37-camera"])
def test_node_groups_keep_the_depth_first_order(name):
    """The plain walk's sequence of visits, lane by lane, is a recursive
    depth-first walk's over the same boxes (nearest wanted child first in the
    ray's octant order, culled against t_best as it stands): the node-group
    stack keeps the order of pushing every child far to near."""
    case = make_case(name)
    lanes = np.arange(0, N_RAYS, 7)[:300]
    o, d, t_max = (case[k][lanes] for k in ("o", "d", "t_max"))
    trace = []
    T_wk.wide_closest_hit_reference(case["pack"], torch.from_numpy(o),
                                    torch.from_numpy(d), torch.from_numpy(t_max),
                                    trace=trace)
    seqs = [[] for _ in lanes]
    for ln, ent in trace:
        for a, b in zip(ln.tolist(), ent.tolist()):
            seqs[a].append(b)
    deep = 0
    for k in range(len(lanes)):
        assert seqs[k] == _dfs_visits(case["pack"], o[k], d[k], t_max[k]), k
        deep += len(seqs[k]) > 2
    assert deep > len(lanes) // 10  # the set goes below the root


def test_stack_holds_one_group_a_level(case):
    """A lane's stack never holds more than depth + 1 entries (the pack's
    stack_size), closest hit or any hit."""
    depth = T_wb.wide_depth(case["pack"].rec[:, T_wb.TARGET_WORD0:
                                            T_wb.TARGET_WORD0 + 8].numpy())
    assert case["pack"].stack_size == depth + 1
    args = [torch.from_numpy(case[k]) for k in ("o", "d", "t_max")]
    for fn in (T_wk.wide_closest_hit_reference, T_wk.wide_any_hit_reference):
        stats = {}
        fn(case["pack"], *args, stats=stats)
        assert stats["max_stack"] <= depth + 1
        assert stats["max_stack"] <= max(depth - 1, 0)


def test_frame_box_exit_changes_no_result(monkeypatch):
    """Rays aimed just beside the tree, just inside its box and through it:
    the walk with the frame-box test gives the same hits, t, tri and b as
    the same walk that visits the root on every live lane, and as brute
    force; a lane that misses the frame's box visits nothing."""
    v, t = blob(12)
    pack = T_bvh.build_bvh(v, t, builder="numpy", device="cpu").wide
    lo, hi = v.min(0), v.max(0)
    rs = np.random.RandomState(5)
    n = 600
    c, ext = (lo + hi) / 2, hi - lo
    # targets on the box's faces, pushed out by up to 2% or in by up to 2%
    axis = rs.randint(0, 3, n)
    side = rs.randint(0, 2, n)
    target = c + (rs.rand(n, 3) - 0.5) * ext
    push = (rs.rand(n) * 0.04 - 0.02) * ext[axis]
    target[np.arange(n), axis] = np.where(side, hi[axis] + push, lo[axis] - push)
    o = (target + rs.randn(n, 3) * ext.max() * 2).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    args = [torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(mixed_t_max(n, float(ext.max()) * 8))]
    trace = []
    with_exit = T_wk.wide_closest_hit_reference(pack, *args, trace=trace)
    occ = T_wk.wide_any_hit_reference(pack, *args)
    enter = T_wk._frame_box_hit(pack, args[0], T_wk._safe_inv(args[1]), args[2])
    assert 0 < int(enter.sum()) < int((args[2] > 0).sum())  # both kinds
    visited = torch.zeros(n, dtype=torch.bool)
    for ln, _ in trace:
        visited[ln] = True
    assert torch.equal(visited, enter)
    monkeypatch.setattr(T_wk, "_frame_box_hit",
                        lambda pack, o, inv, t_best: t_best > 0)
    without = T_wk.wide_closest_hit_reference(pack, *args)
    for a, b in zip(with_exit, without):
        assert torch.equal(a, b)
    assert torch.equal(occ, T_wk.wide_any_hit_reference(pack, *args))
    bf = T_int.closest_triangle_hit(*args, torch.from_numpy(v), torch.from_numpy(t))
    assert torch.equal(with_exit.hit, bf.hit)
    assert int(bf.hit.sum()) > 0


def test_wrapper_refuses_bad_inputs():
    v, t = blob(8)
    pack = T_bvh.build_bvh(v, t, builder="numpy", device="cpu").wide
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    tm = torch.ones((4,))
    for fn in (T_wk.wide_closest_hit, T_wk.wide_any_hit):
        with pytest.raises(TypeError):
            fn(pack, o.double(), d, tm)
        with pytest.raises(ValueError):
            fn(pack, o, d[:3], tm)
        with pytest.raises(ValueError):
            fn(pack, o.T.contiguous().T, d, tm)  # not contiguous
        with pytest.raises(ValueError):
            fn(pack._replace(rec=pack.rec[:, :24].contiguous()), o, d, tm)
        with pytest.raises(TypeError):
            fn(pack._replace(tid=pack.tid.long()), o, d, tm)
    # no rays: empty results, nothing walked
    assert T_wk.wide_closest_hit(pack, o[:0], d[:0], tm[:0]).t.shape == (0,)
    assert T_wk.wide_any_hit(pack, o[:0], d[:0], tm[:0]).shape == (0,)


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
    pack = type(case["pack"])(*(x.to(cuda_device) if torch.is_tensor(x) else x
                                for x in case["pack"]))
    args = [torch.from_numpy(case[k]).to(cuda_device)
            for k in ("o", "d", "t_max")]
    before = (T_wk.closest_launch_count, T_wk.any_launch_count)
    got = T_wk.wide_closest_hit(pack, *args)
    occ = T_wk.wide_any_hit(pack, *args)
    torch.cuda.synchronize()
    assert (T_wk.closest_launch_count, T_wk.any_launch_count) == (
        before[0] + 1, before[1] + 1)
    ref = T_wk.wide_closest_hit_reference(pack, *args)
    assert torch.equal(got.hit, ref.hit) and torch.equal(got.tri, ref.tri)
    np.testing.assert_allclose(got.t.cpu().numpy(), ref.t.cpu().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(got.b.cpu().numpy(), ref.b.cpu().numpy(),
                               atol=1e-5)
    assert torch.equal(occ, T_wk.wide_any_hit_reference(pack, *args))
