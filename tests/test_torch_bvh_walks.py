"""The per-lane BVH walks of the port (ops/bvh.py: the lockstep stack walk
and the threaded walk, closest and any hit) against brute force, against
each other and against the JAX package's walks, and a render in each
per-lane mode against the JAX package's.

Twins of tests/test_bvh.py's TestBVHTraversal and TestStacklessTraversal
with their tolerances: the walks' leaf test is Moller-Trumbore, the brute
force's the watertight test, so the two may disagree on rays through an
edge (at most 1% of the hit flags) and t agrees within rtol 1e-3 + atol
1e-4 where both hit.  Against the JAX package's walks on the same (carried)
tree the math is the same formulas in another order of float operations:
hit flags, triangles and occlusion agree on all but 0.5% of the lanes (ties
and edges), t within rtol 1e-5 where both hit the same triangle.  The step
cap and the stack depth, made small in both packages, must cut the same
lanes.  Renders: tests/test_torch_path.py's tolerances (>= 99% of pixels
within rtol 1e-3 + atol 1e-4, the image mean within 0.5%)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnxraytracer_tpu.models.integrators import path as J_path
from gnxraytracer_tpu.ops import bvh as J_bvh
from gnxraytracer_tpu.ops import samplers as J_smp
from gnxraytracer_tpu_torch import convert
from gnxraytracer_tpu_torch.models.integrators import direct as T_direct
from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.models.integrators import volpath as T_volpath
from gnxraytracer_tpu_torch.models.integrators import whitted as T_whitted
from gnxraytracer_tpu_torch.ops import bvh as T_bvh
from gnxraytracer_tpu_torch.ops import intersect as T_isect
from gnxraytracer_tpu_torch.ops import lbvh as T_lbvh
from gnxraytracer_tpu_torch.ops import samplers as T_smp
from gnxraytracer_tpu_torch.ops import trace as T_trace
from gnxraytracer_tpu_torch.scene import loaders as T_load
from gnxraytracer_tpu_torch.scene import presets as T_presets
from gnxraytracer_tpu_torch.scene import scene as T_scene

from test_bvh import random_rays, random_scene
from test_torch_convert import _fill_mesh, np_tree, scene_pair

BIG = 1e30


def t_(a):
    return torch.from_numpy(np.array(a))


def port_tree(verts, idx):
    return T_bvh.build_bvh(verts, idx, device="cpu")


def brute(verts, idx, o, d, t_max):
    return T_isect.closest_triangle_hit(t_(o), t_(d), t_(t_max), t_(verts),
                                        t_(idx))


def closest(mode, tree, verts, idx, o, d, t_max, stats=None):
    if mode == "stack":
        return T_bvh.bvh_closest_hit(tree, t_(verts), t_(idx), t_(o), t_(d),
                                     t_(t_max), stats=stats)
    return T_bvh.bvh_closest_hit_stackless(tree, t_(o), t_(d), t_(t_max),
                                           stats=stats)


def any_hit(mode, tree, verts, idx, o, d, t_max, stats=None):
    if mode == "stack":
        return T_bvh.bvh_any_hit(tree, t_(verts), t_(idx), t_(o), t_(d),
                                 t_(t_max), stats=stats)
    return T_bvh.bvh_any_hit_stackless(tree, t_(o), t_(d), t_(t_max),
                                       stats=stats)


def check_against_brute(bh, fh, n_rays, tri_agree=False):
    hb, hf = bh.hit.numpy(), fh.hit.numpy()
    tb, tf = bh.t.numpy(), fh.t.numpy()
    mismatch = (hb != hf).sum()
    assert mismatch <= max(1, n_rays // 100), f"{mismatch} hit mismatches"
    both = hb & hf
    np.testing.assert_allclose(tb[both], tf[both], rtol=1e-3, atol=1e-4)
    if tri_agree:
        close = both & (np.abs(tb - tf) < 1e-5)
        if close.sum():
            assert (bh.tri.numpy()[close] == fh.tri.numpy()[close]).mean() > 0.98


# -- TestBVHTraversal / TestStacklessTraversal twins ---------------------------

WALK_CASES = [("stack", 50, 200, 0), ("stack", 500, 300, 2),
              ("stackless", 50, 200, 0), ("stackless", 500, 300, 2),
              ("stackless", 2000, 256, 9)]


@pytest.mark.parametrize("mode,n_tris,n_rays,seed", WALK_CASES)
def test_matches_bruteforce(mode, n_tris, n_rays, seed):
    verts, idx = random_scene(n_tris, seed)
    o, d = random_rays(n_rays, seed + 10)
    t_max = np.full(n_rays, BIG, np.float32)
    fast = closest(mode, port_tree(verts, idx), verts, idx, o, d, t_max)
    check_against_brute(brute(verts, idx, o, d, t_max), fast, n_rays,
                        tri_agree=mode == "stackless")


def test_stackless_matches_stack_walk():
    verts, idx = random_scene(700, 21)
    o, d = random_rays(500, 22)
    t_max = np.full(500, BIG, np.float32)
    tree = port_tree(verts, idx)
    a = closest("stack", tree, verts, idx, o, d, t_max)
    b = closest("stackless", tree, verts, idx, o, d, t_max)
    np.testing.assert_array_equal(a.hit.numpy(), b.hit.numpy())
    both = a.hit.numpy()
    np.testing.assert_allclose(a.t.numpy()[both], b.t.numpy()[both], rtol=1e-5)


@pytest.mark.parametrize("mode", ["stack", "stackless"])
def test_any_hit_matches(mode):
    verts, idx = random_scene(300, 4)
    o, d = random_rays(400, 5)
    t_max = np.full(400, BIG, np.float32)
    want = T_isect.any_triangle_hit(t_(o), t_(d), t_(t_max), t_(verts),
                                    t_(idx)).numpy()
    got = any_hit(mode, port_tree(verts, idx), verts, idx, o, d, t_max).numpy()
    assert (want != got).sum() <= 4


@pytest.mark.parametrize("mode", ["stack", "stackless"])
def test_tmax_limits_hits(mode):
    verts, idx = random_scene(100, 7)
    o, d = random_rays(100, 8)
    tree = port_tree(verts, idx)
    far = closest(mode, tree, verts, idx, o, d, np.full(100, BIG, np.float32))
    near = closest(mode, tree, verts, idx, o, d, np.full(100, 0.5, np.float32))
    nh, nt = near.hit.numpy(), near.t.numpy()
    assert nh.sum() <= far.hit.numpy().sum()
    assert np.all(nt[nh] <= 0.5)
    # a t_max just short of each lane's closest hit leaves it without a hit;
    # just past it finds that hit, in the closest and the any-hit walk alike
    # rays aimed at triangle centroids, so that most of them hit
    o2, _ = random_rays(100, 9)
    aim = verts.reshape(-1, 3, 3).mean(1)[np.arange(100) % len(idx)]
    d2 = (aim - o2) / np.linalg.norm(aim - o2, axis=1, keepdims=True)
    o, d = o2, d2.astype(np.float32)
    far = closest(mode, tree, verts, idx, o, d, np.full(100, BIG, np.float32))
    fh, ft = far.hit.numpy(), far.t.numpy()
    assert fh.sum() > 90
    for scale, want in ((0.999, np.zeros_like(fh)), (1.001, fh)):
        cut = np.where(fh, ft * scale, BIG).astype(np.float32)
        got = closest(mode, tree, verts, idx, o, d, cut)
        occ = any_hit(mode, tree, verts, idx, o, d, cut)
        np.testing.assert_array_equal(got.hit.numpy()[fh], want[fh])
        np.testing.assert_array_equal(occ.numpy()[fh], want[fh])


@pytest.mark.parametrize("mode", ["stack", "stackless"])
def test_lbvh_matches_bruteforce(mode):
    """The port's LBVH (its box fit run to convergence) walked per lane,
    against brute force (not against a carried JAX LBVH, whose fit is short
    on deep trees: ROADMAP C12)."""
    verts, idx = random_scene(800, 11)
    o, d = random_rays(300, 12)
    t_max = np.full(300, BIG, np.float32)
    tree = T_lbvh.build_lbvh(verts, idx, device="cpu")
    fast = closest(mode, tree, verts, idx, o, d, t_max)
    bh = brute(verts, idx, o, d, t_max)
    assert (bh.hit.numpy() != fast.hit.numpy()).sum() <= 3
    both = bh.hit.numpy() & fast.hit.numpy()
    np.testing.assert_allclose(bh.t.numpy()[both], fast.t.numpy()[both],
                               rtol=1e-3)


# -- against the JAX package's walks on the same tree --------------------------

JAX_WALKS = {
    "stack": (J_bvh.bvh_closest_hit, J_bvh.bvh_any_hit),
    "stackless": (J_bvh.bvh_closest_hit_stackless, J_bvh.bvh_any_hit_stackless),
}


def jax_casts(mode, jtree, verts, idx, o, d, t_max):
    c, a = JAX_WALKS[mode]
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    if mode == "stack":
        args = (jnp.asarray(verts), jnp.asarray(idx)) + args
    return c(jtree, *args), np.asarray(a(jtree, *args))


def hold_to_jax(jh, jocc, th, tocc, n):
    """Hit flags, triangles and occlusion on all but 0.5% of the lanes, t
    within rtol 1e-5 where both hit the same triangle, b within 1e-4."""
    limit = max(1, n // 200)
    jhit = np.asarray(jh.hit)
    assert (jhit != th.hit.numpy()).sum() <= limit
    same = jhit & th.hit.numpy()
    jtri = np.asarray(jh.tri)
    assert (jtri[same] != th.tri.numpy()[same]).sum() <= limit
    same &= jtri == th.tri.numpy()
    np.testing.assert_allclose(th.t.numpy()[same], np.asarray(jh.t)[same],
                               rtol=1e-5)
    np.testing.assert_allclose(th.b.numpy()[same], np.asarray(jh.b)[same],
                               atol=1e-4)
    assert (jocc != tocc.numpy()).sum() <= limit


@pytest.mark.parametrize("mode", ["stack", "stackless"])
@pytest.mark.parametrize("n_tris,n_rays,seed", [(500, 300, 2), (3000, 400, 5)])
def test_matches_jax_walk_on_the_carried_tree(mode, n_tris, n_rays, seed):
    verts, idx = random_scene(n_tris, seed)
    o, d = random_rays(n_rays, seed + 10)
    t_max = np.full(n_rays, BIG, np.float32)
    t_max[1::5] = 3.0
    jtree = J_bvh.build_bvh(verts, idx)
    tree = convert.bvh_from_numpy_tree(np_tree(jtree), device="cpu")
    jh, jocc = jax_casts(mode, jtree, verts, idx, o, d, t_max)
    th = closest(mode, tree, verts, idx, o, d, t_max)
    tocc = any_hit(mode, tree, verts, idx, o, d, t_max)
    assert 0 < th.hit.numpy().sum() < n_rays
    hold_to_jax(jh, jocc, th, tocc, n_rays)


def test_matches_jax_walk_on_a_scene_pair_tree():
    """The tree of a Cornell box with a mesh in it (fewer than 4096
    triangles, so no big-triangle separation and no C3), carried from the
    JAX scene, cast with its camera rays."""
    js, _, ts, tc = scene_pair("cornell_mesh_bvh", 16, 16)
    jtree = js.bvh
    tree = convert.bvh_from_numpy_tree(np_tree(jtree), device="cpu")
    verts, idx = np.asarray(js.geom.vertices), np.asarray(js.geom.triangles)
    rs = np.random.RandomState(4)
    o = np.broadcast_to(np.asarray([0.0, 0.0, 6.0], np.float32), (512, 3))
    d = rs.randn(512, 3).astype(np.float32) * [0.3, 0.3, 0.0] + [0, 0, -1]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = np.full(512, BIG, np.float32)
    for mode in ("stack", "stackless"):
        jh, jocc = jax_casts(mode, jtree, verts, idx, o, d, t_max)
        th = closest(mode, tree, verts, idx, o, d, t_max)
        tocc = any_hit(mode, tree, verts, idx, o, d, t_max)
        assert th.hit.numpy().mean() > 0.5
        hold_to_jax(jh, jocc, th, tocc, 512)


def shared_leaf_tree():
    """A root over two leaves that share the four leaf rows 0-3 (two
    triangles and two pads).  The root's offset (its second child, node 2)
    makes the walks read rows 2..5 of a 4-row list: JAX clamps the gather
    there, a PyTorch index would raise.  (A tree from the builders never
    reaches the clamp: every leaf there has its own LEAF_SIZE rows.)"""
    verts = np.asarray([[-1, -1, 0], [1, -1, 0], [0, 1, 0],
                        [-1, -1, -2], [1, -1, -2], [0, 1, -2]], np.float32)
    idx = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
    lo = np.asarray([[-1, -1, -2]] * 3, np.float32)
    hi = np.asarray([[1, 1, 0]] * 3, np.float32)
    off = np.asarray([2, 0, 0], np.int32)
    npr = np.asarray([0, 2, 2], np.int32)
    ax = np.zeros(3, np.int32)
    order = np.asarray([0, 1, -1, -1], np.int32)
    miss = np.asarray([-1, 2, -1], np.int32)
    soa = np.zeros((4, 9), np.float32)
    soa[0] = verts[idx[0]].reshape(-1)
    soa[1] = verts[idx[1]].reshape(-1)
    tables = (lo, hi, off, npr, ax, order, miss, soa)
    return (verts, idx, J_bvh.BVH(*(jnp.asarray(a) for a in tables)),
            T_bvh.BVH(*(t_(a) for a in tables)))


@pytest.mark.parametrize("mode", ["stack", "stackless"])
def test_out_of_range_leaf_rows_are_clamped_as_jax_does(mode):
    verts, idx, jtree, tree = shared_leaf_tree()
    assert tree.offset[0] + T_bvh.LEAF_SIZE > tree.prim_idx.shape[0]
    rs = np.random.RandomState(0)
    o = np.concatenate([rs.uniform(-0.3, 0.3, (64, 2)),
                        np.full((64, 1), 5.0)], 1).astype(np.float32)
    o[::2, 2] = -5.0  # half of them from behind
    d = np.zeros((64, 3), np.float32)
    d[:, 2] = np.where(o[:, 2] > 0, -1.0, 1.0)
    t_max = np.full(64, BIG, np.float32)
    th = closest(mode, tree, verts, idx, o, d, t_max)
    tocc = any_hit(mode, tree, verts, idx, o, d, t_max)
    assert th.hit.numpy().all() and tocc.numpy().all()
    # the near triangle of each side: z = 0 from the front, z = -2 behind
    np.testing.assert_array_equal(th.tri.numpy(), np.where(o[:, 2] > 0, 0, 1))
    np.testing.assert_allclose(th.t.numpy(), np.where(o[:, 2] > 0, 5.0, 3.0),
                               rtol=1e-6)
    jh, jocc = jax_casts(mode, jtree, verts, idx, o, d, t_max)
    hold_to_jax(jh, jocc, th, tocc, 64)


@pytest.mark.parametrize("mode,cap", [("stack", 20), ("stackless", 20),
                                      ("stack", 37), ("stackless", 37)])
def test_step_cap_stops_the_same_lanes(mode, cap, monkeypatch):
    """MAX_TRAV_STEPS made small in both packages: the same lanes stop
    early, with the same partial results; no lane takes a step past the
    cap, whatever SYNC_STEPS is."""
    verts, idx = random_scene(1500, 3)
    o, d = random_rays(300, 13)
    t_max = np.full(300, BIG, np.float32)
    jtree = J_bvh.build_bvh(verts, idx)
    tree = convert.bvh_from_numpy_tree(np_tree(jtree), device="cpu")
    full = closest(mode, tree, verts, idx, o, d, t_max)
    monkeypatch.setattr(J_bvh, "MAX_TRAV_STEPS", cap)
    monkeypatch.setattr(T_bvh, "MAX_TRAV_STEPS", cap)
    stats = {}
    th = closest(mode, tree, verts, idx, o, d, t_max, stats=stats)
    tocc = any_hit(mode, tree, verts, idx, o, d, t_max)
    assert stats["steps"] == cap and stats["capped"] > 0
    assert (th.hit.numpy() != full.hit.numpy()).any()  # the cap cut hits
    jh, jocc = jax_casts(mode, jtree, verts, idx, o, d, t_max)
    hold_to_jax(jh, jocc, th, tocc, 300)


@pytest.mark.parametrize("depth", [1, 3])
def test_stack_cap_drops_the_same_subtrees(depth, monkeypatch):
    """MAX_STACK made small in both packages: a push past it is dropped, so
    the same lanes lose the same subtrees."""
    verts, idx = random_scene(1500, 6)
    o, d = random_rays(300, 16)
    t_max = np.full(300, BIG, np.float32)
    jtree = J_bvh.build_bvh(verts, idx)
    tree = convert.bvh_from_numpy_tree(np_tree(jtree), device="cpu")
    full = closest("stack", tree, verts, idx, o, d, t_max)
    monkeypatch.setattr(J_bvh, "MAX_STACK", depth)
    monkeypatch.setattr(T_bvh, "MAX_STACK", depth)
    stats = {}
    th = closest("stack", tree, verts, idx, o, d, t_max, stats=stats)
    tocc = any_hit("stack", tree, verts, idx, o, d, t_max)
    assert stats["dropped_pushes"] > 0 and stats["capped"] == 0
    assert (th.hit.numpy() != full.hit.numpy()).any()
    jh, jocc = jax_casts("stack", jtree, verts, idx, o, d, t_max)
    hold_to_jax(jh, jocc, th, tocc, 300)


def test_walk_stats_count_the_loop(monkeypatch):
    """stats: steps as the JAX loop counts them (the steps in which some
    lane walks), lane_steps summed over lanes, no lane capped."""
    verts, idx = random_scene(500, 2)
    o, d = random_rays(300, 12)
    t_max = np.full(300, BIG, np.float32)
    tree = port_tree(verts, idx)
    for mode in ("stack", "stackless"):
        stats = {}
        closest(mode, tree, verts, idx, o, d, t_max, stats=stats)
        assert stats["capped"] == 0
        assert 1 < stats["steps"] < T_bvh.MAX_TRAV_STEPS
        assert stats["steps"] <= stats["lane_steps"] <= 300 * stats["steps"]
        # no lane outlives the loop: capped at exactly the last step
        capped = {}
        with monkeypatch.context() as m:
            m.setattr(T_bvh, "MAX_TRAV_STEPS", stats["steps"])
            closest(mode, tree, verts, idx, o, d, t_max, stats=capped)
        assert capped["capped"] == 0 and capped["steps"] == stats["steps"]


# -- scene casts and renders ------------------------------------------------------

MODES = {"stack": dict(bvh_mode="stack"),
         "stackless": dict(bvh_mode="stackless"),
         "bvh_stackless=False": dict(bvh_stackless=False)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fast_mis_render_matches_jax(mode):
    """A 16x16 fast-MIS render (2 spp, depth 5) of the Cornell box with a
    mesh, the JAX package and the port each in the same per-lane mode."""
    js, jc, ts, tc = scene_pair("cornell_mesh_bvh", 16, 16)
    kw = dict(spp=2, spp_chunk=2, max_depth=5, fast_mis=True, use_bvh=True,
              **MODES[mode])
    jcfg = J_path.make_config(js, 16, 16, use_pallas=False, **kw)
    tcfg = T_path.make_config(ts, 16, 16, use_pallas=False, **kw)
    assert tcfg._asdict() == jcfg._asdict()
    jimg = np.asarray(J_path._render_chunk_jit(
        js, jc, J_smp.make_sobol_sampler(2), jcfg, 0, 2))
    timg = T_path.render_chunk(ts, tc, T_smp.make_sobol_sampler(2, device="cpu"),
                               tcfg, 0, 2).numpy()
    assert np.isfinite(timg).all() and jimg.mean() > 0.1
    ok = (np.abs(timg - jimg) <= 1e-4 + 1e-3 * np.abs(jimg)).all(axis=-1)
    assert ok.mean() >= 0.99, f"{(~ok).sum()} of {ok.size} pixels differ"
    assert abs(timg.mean() / jimg.mean() - 1.0) < 0.005


def _bvh_cornell():
    return T_presets.cornell_box(16, 16, bvh=True, device="cpu")


@pytest.mark.parametrize("integrator", ["whitted", "direct", "volpath",
                                        "path_faithful"])
def test_every_integrator_renders_in_the_per_lane_modes(integrator):
    """Whitted, direct lighting, volpath and the faithful path render in
    every per-lane mode, each giving the image of the plain walk of the
    kernels (bvh_mode="packet") on the same tree: the walks differ only at
    edges, where none of these rays falls (equal within 1e-5)."""
    scene, cam = _bvh_cornell()
    smp = T_smp.make_sobol_sampler(2, device="cpu")
    mod = {"whitted": T_whitted, "direct": T_direct, "volpath": T_volpath,
           "path_faithful": T_path}[integrator]
    kw = dict(spp=2, spp_chunk=2, max_depth=3, use_bvh=True)
    if integrator == "path_faithful":
        kw["fast_mis"] = False
    want = mod.render(scene, cam, smp, T_path.make_config(
        scene, 16, 16, bvh_mode="packet", **kw)).numpy()
    assert np.isfinite(want).all() and want.mean() > 0.01
    for extra in MODES.values():
        got = mod.render(scene, cam, smp, T_path.make_config(
            scene, 16, 16, **kw, **extra)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["stack", "stackless"])
def test_scene_casts_brute_force_the_big_triangles_first(mode):
    """With big-triangle separation (the mesh twin over 4096 triangles), a
    per-lane mode brute-forces the floor kept out of the tree with the plain
    loop (as the JAX package's XLA code does) and walks the tree: the casts
    equal brute force over every triangle except at edges."""
    tb = T_scene.SceneBuilder()
    _fill_mesh(tb, T_presets, T_load, n_seg=46)
    ts = tb.build(bvh=True, device="cpu")
    cfg = T_path.make_config(ts, 8, 8, spp=1, **MODES[mode])
    assert cfg.use_bvh and cfg.n_big == 2
    rs = np.random.RandomState(2)
    o = np.broadcast_to(np.asarray([0.0, 0.8, 5.0], np.float32), (256, 3))
    d = rs.randn(256, 3).astype(np.float32) * [0.25, 0.25, 0.0] + [0, -0.3, -1]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = torch.full((256,), BIG)
    hit = T_trace.scene_intersect(ts, cfg, t_(o), t_(d), t_max)
    occ = T_trace.scene_occluded(ts, cfg, t_(o), t_(d), t_max)
    want = T_isect.closest_triangle_hit(t_(o), t_(d), t_max, ts.geom.vertices,
                                        ts.geom.triangles)
    assert 0.3 < want.hit.float().mean() < 1.0
    assert (hit.hit != want.hit).sum() <= 2 and (occ != want.hit).sum() <= 2
    both = (hit.hit & want.hit).numpy()
    np.testing.assert_allclose(hit.t.numpy()[both], want.t.numpy()[both],
                               rtol=1e-5)
