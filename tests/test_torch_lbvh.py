"""The port's LBVH build (ops/lbvh.py) against the JAX package's
(ops/lbvh.py there) on identical meshes made from a seed, on the CPU.

  * the Morton codes, the sort and the Karras links equal the JAX package's;
  * the finished tables are byte-equal to the JAX package's where its box
    fit converged (800 random triangles, make_test_mesh(3));
  * on a small input whose Karras tree is deeper than the JAX package's
    fixed ceil(log2 T) + 2 fit sweeps, the JAX tree leaves triangles outside
    their ancestors' boxes, and a walk misses a triangle that brute force
    hits; the port's fit runs to the tree's height, so every box contains
    its children's and the walk hits it;
  * casts through the port's LBVH tables equal brute force on every lane,
    and SceneBuilder.build(bvh="lbvh") casts as its SAH build does."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gnxraytracer_tpu.ops import bvh as J_bvh
from gnxraytracer_tpu.ops import intersect as J_int
from gnxraytracer_tpu.ops import lbvh as J_lbvh
from gnxraytracer_tpu.scene import loaders as J_load
from gnxraytracer_tpu_torch import convert
from gnxraytracer_tpu_torch.kernels import closest_hit as T_ch
from gnxraytracer_tpu_torch.kernels import packet_bvh as T_pk
from gnxraytracer_tpu_torch.kernels import wide_bvh as T_wb
from gnxraytracer_tpu_torch.ops import lbvh as T_lbvh
from gnxraytracer_tpu_torch.scene import loaders as T_load
from gnxraytracer_tpu_torch.scene import scene as T_scene

from test_torch_convert import assert_tables_equal, np_tree

# the tables _finish_build makes from the layout, compared byte for byte
TABLES = ("bounds_lo", "bounds_hi", "offset", "n_prims", "axis", "prim_idx",
          "miss", "leaf_soa", "first8", "miss8")


def jax_lbvh(fn, *args):
    """A JAX-package LBVH function run op by op (jax.disable_jit): the same
    values as the jitted build (integer and min / max arithmetic), without
    XLA's CPU compile of its 75 unrolled search steps, about a minute for
    every mesh size."""
    with jax.disable_jit():
        return fn(*args)


def random_scene(n_tris, seed=11, spread=5.0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(n_tris, 1, 3) * spread
    tris = centers + rs.randn(n_tris, 3, 3) * 0.4
    return (tris.reshape(-1, 3).astype(np.float32),
            np.arange(n_tris * 3).reshape(n_tris, 3).astype(np.int32))


def random_rays(n, seed=12, spread=8.0):
    rs = np.random.RandomState(seed)
    o = rs.randn(n, 3).astype(np.float32) * spread
    d = rs.randn(n, 3).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def deep_comb():
    """12 small triangles along x at 0 and 2^k / 128 (k = 0..10): equal
    Morton prefixes peel one triangle off per level, so the Karras tree has
    height 9 (tests/jax_lbvh_fit_shortfall.py) against the JAX package's
    ceil(log2 12) + 2 = 6 sweeps."""
    xs = np.array([0.0] + [2.0 ** k for k in range(11)], np.float32) / 128.0
    tri = np.array([[0, 0, 0], [0.004, 0, 0], [0, 0.004, 0]], np.float32)
    v = (xs[:, None, None] * np.array([1, 0, 0], np.float32)
         + tri[None]).reshape(-1, 3).astype(np.float32)
    return v, np.arange(len(v)).reshape(-1, 3).astype(np.int32)


def mesh(name):
    if name == "random800":
        return random_scene(800)
    if name == "test_mesh3":
        v, t = J_load.make_test_mesh(3)
        tv, tt_ = T_load.make_test_mesh(3)
        np.testing.assert_array_equal(v, tv)
        return np.asarray(v, np.float32), np.asarray(t, np.int32)
    assert name == "deep_comb"
    return deep_comb()


def boxes_contain_children(lo, hi, off, npr):
    """Inner nodes (depth-first layout: children n + 1 and offset[n]) whose
    box does not contain a child's."""
    lo, hi = np.asarray(lo), np.asarray(hi)
    off, npr = np.asarray(off), np.asarray(npr)
    inner = np.nonzero(npr == 0)[0]
    bad = np.zeros(len(inner), bool)
    for child in (inner + 1, off[inner]):
        bad |= ((lo[child] < lo[inner]) | (hi[child] > hi[inner])).any(axis=1)
    return inner[bad]


@pytest.fixture(scope="module", params=["random800", "test_mesh3", "deep_comb"])
def built(request):
    v, t = mesh(request.param)
    jdev = jax_lbvh(J_lbvh.build_lbvh_device, jnp.asarray(v), jnp.asarray(t))
    tree = T_lbvh.karras_tree(torch.from_numpy(v), torch.from_numpy(t))
    return dict(name=request.param, v=v, t=t, jdev=jdev, tree=tree,
                jax=jax_lbvh(J_lbvh.build_lbvh, v, t),
                port=T_lbvh.build_lbvh(v, t, device="cpu"))


def test_morton_codes_match_jax():
    p = np.random.RandomState(0).rand(5000, 3).astype(np.float32)
    p[:4] = [[0, 0, 0], [1, 1, 1], [0.999, 0, 0.5], [0.5, 0.25, 0.125]]
    ours = T_lbvh.morton3(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(J_lbvh.morton3(
        jnp.asarray(p))).astype(np.int64))
    assert ours.max() < 1 << 30


def test_clz32_is_exact():
    x = np.concatenate([[0, 1, 2, 3, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                        np.random.RandomState(1).randint(0, 2 ** 32, 2000,
                                                         dtype=np.int64)])
    want = [32 - int(v).bit_length() for v in x]
    assert T_lbvh._clz32(torch.from_numpy(x)).tolist() == want


def test_karras_links_match_jax(built):
    for k in ("order", "left", "right"):
        np.testing.assert_array_equal(built["tree"][k].numpy(),
                                      np.asarray(built["jdev"][k]), err_msg=k)
    n = len(built["t"])
    # every node but the root is somebody's child, once
    kids = np.concatenate([built["tree"]["left"].numpy(),
                           built["tree"]["right"].numpy()])
    assert sorted(kids.tolist()) == list(range(1, 2 * n - 1))


def test_fit_equals_the_jax_fit_where_it_converged(built):
    """The port's fit gives the JAX package's node boxes bit for bit where
    the JAX package's fixed sweep count reached the tree's height; on the
    deep comb the JAX boxes are short: each lies inside the port's, and
    some differ."""
    lo, hi = (x.numpy() for x in T_lbvh.fit_bounds(built["tree"]))
    jlo = np.asarray(built["jdev"]["node_lo"])
    jhi = np.asarray(built["jdev"]["node_hi"])
    if built["name"] == "deep_comb":
        assert (lo <= jlo).all() and (hi >= jhi).all()
        assert not (np.array_equal(lo, jlo) and np.array_equal(hi, jhi))
    else:
        np.testing.assert_array_equal(lo, jlo)
        np.testing.assert_array_equal(hi, jhi)


def test_fit_refuses_a_non_finite_vertex():
    """A NaN vertex would keep its boxes changing forever: the fit raises
    instead of sweeping on."""
    v, t = deep_comb()
    v[7, 1] = np.nan
    tree = T_lbvh.karras_tree(torch.from_numpy(v), torch.from_numpy(t))
    with pytest.raises(ValueError, match="non-finite"):
        T_lbvh.fit_bounds(tree)
    with pytest.raises(ValueError, match="non-finite"):
        T_lbvh.build_lbvh(v, t, device="cpu")


def test_boxes_contain_their_children(built):
    port = built["port"]
    assert boxes_contain_children(port.bounds_lo, port.bounds_hi, port.offset,
                                  port.n_prims).size == 0
    jax_bad = boxes_contain_children(built["jax"].bounds_lo,
                                     built["jax"].bounds_hi,
                                     built["jax"].offset, built["jax"].n_prims)
    if built["name"] == "deep_comb":
        print(f"deep_comb: {jax_bad.size} JAX node boxes miss a child's")
        assert jax_bad.size > 0  # the JAX package's fault (ROADMAP C12)
    else:
        assert jax_bad.size == 0


def test_tables_byte_equal_where_the_jax_fit_converged(built):
    port, jax = built["port"], built["jax"]
    differ = [f for f in TABLES
              if not np.array_equal(getattr(port, f).numpy(),
                                    np.asarray(getattr(jax, f)))]
    if built["name"] == "deep_comb":  # the boxes, and nothing else
        assert differ and set(differ) <= {"bounds_lo", "bounds_hi"}
    else:
        assert differ == []
    # and the carried JAX tree makes the port's width-8 and binary tables
    # from its own, equal to the port's build where the trees are equal
    carried = convert.bvh_from_numpy_tree(np_tree(jax), device="cpu")
    if not differ:
        assert_tables_equal(carried.packet, port.packet, "packet")


def test_jax_walk_misses_what_the_port_hits():
    """Rays straight down onto each triangle of the deep comb: brute force
    hits all twelve; the JAX package's per-lane walk of its own LBVH misses
    the triangles its root box leaves out; the port's walks hit all
    twelve."""
    v, t = deep_comb()
    c = v.reshape(-1, 3, 3).mean(axis=1)
    o = (c + [0, 0, 1.0]).astype(np.float32)
    d = np.tile(np.float32([0, 0, -1]), (len(c), 1))
    t_max = np.full(len(c), 10.0, np.float32)
    brute = J_int.closest_triangle_hit(jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(t_max), jnp.asarray(v),
                                       jnp.asarray(t))
    assert np.asarray(brute.hit).all()
    jwalk = J_bvh.bvh_closest_hit(jax_lbvh(J_lbvh.build_lbvh, v, t),
                                  jnp.asarray(v),
                                  jnp.asarray(t), jnp.asarray(o),
                                  jnp.asarray(d), jnp.asarray(t_max))
    assert not np.asarray(jwalk.hit).all()
    port = T_lbvh.build_lbvh(v, t, device="cpu")
    args = [torch.from_numpy(a) for a in (o, d, t_max)]
    for th in (T_pk.packet_closest_hit_reference(port.packet, *args),
               T_wb.wide_closest_hit_reference(port.wide, *args)):
        assert th.hit.all()
        np.testing.assert_array_equal(th.tri.numpy(), np.asarray(brute.tri))


@pytest.mark.parametrize("name", ["random800", "deep_comb"])
def test_lbvh_casts_equal_brute_force(name):
    """Both walks of the port's LBVH tables against brute force: zero
    differing lanes in hit and tri, t equal, occlusion equal."""
    v, t = mesh(name)
    tree = T_lbvh.build_lbvh(v, t, device="cpu")
    o, d = random_rays(600)
    if name == "deep_comb":  # rays from above onto the tiny triangles
        rs = np.random.RandomState(5)
        c = v.reshape(-1, 3, 3).mean(axis=1)
        tgt = c[rs.randint(0, len(c), len(o))] + rs.uniform(
            -0.004, 0.004, (len(o), 3)) * [1, 1, 0]
        o = (tgt + rs.uniform(-0.3, 0.3, (len(o), 3)) * [1, 1, 0]
             + [0, 0, 1.0]).astype(np.float32)
        d = tgt - o
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = np.full(len(o), 1e30, np.float32)
    t_max[::5] = 3.0
    args = [torch.from_numpy(a) for a in (o, d, t_max)]
    soa = T_ch.tri_soa_from_mesh(torch.from_numpy(v), torch.from_numpy(t))
    brute = T_ch.closest_hit_reference(*args, soa)
    occ = T_ch.any_hit_reference(*args, soa)
    assert 0.05 < brute.hit.float().mean() < 0.95
    for closest, any_hit, pack in (
            (T_pk.packet_closest_hit_reference, T_pk.packet_any_hit_reference,
             tree.packet),
            (T_wb.wide_closest_hit_reference, T_wb.wide_any_hit_reference,
             tree.wide)):
        th = closest(pack, *args)
        assert torch.equal(th.hit, brute.hit) and torch.equal(th.tri, brute.tri)
        assert torch.equal(th.t, brute.t)
        assert torch.equal(any_hit(pack, *args), occ)


def test_single_triangle_tree():
    v = np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0]])
    tree = T_lbvh.build_lbvh(v, np.int32([[0, 1, 2]]), device="cpu")
    assert tree.n_prims.tolist() == [1] and tree.prim_idx[:1].tolist() == [0]
    o = torch.tensor([[0.2, 0.2, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    th = T_pk.packet_closest_hit_reference(tree.packet, o, d,
                                           torch.tensor([5.0]))
    assert th.hit.item() and abs(th.t.item() - 1.0) < 1e-6


def test_scene_builder_lbvh_mode():
    """Twin of tests/test_bvh.py::test_scene_builder_lbvh_mode: the LBVH
    scene casts as the SAH scene does (same hits, t equal where the triangle
    is the same; every triangle in the tree, none brute-forced)."""
    rng = np.random.default_rng(3)
    v = (rng.random((300, 3), np.float32) * 4 - 2).astype(np.float32)
    t = rng.integers(0, 300, (200, 3)).astype(np.int32)

    def build(mode):
        b = T_scene.SceneBuilder()
        b.add_mesh(v, t, b.add_matte((0.5, 0.5, 0.5)))
        b.add_skybox_light()
        return b.build(bvh=mode, device="cpu")

    s_lbvh, s_sah = build("lbvh"), build(True)
    assert s_lbvh.bvh is not None and s_lbvh.big_tri_idx is None
    n = 256
    o = torch.from_numpy(rng.random((n, 3), np.float32) * 6 - 3)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    tm = torch.full((n,), 1e30)
    h1 = T_pk.packet_closest_hit_reference(s_lbvh.bvh.packet, o, d, tm)
    h2 = T_pk.packet_closest_hit_reference(s_sah.bvh.packet, o, d, tm)
    assert torch.equal(h1.hit, h2.hit) and h1.hit.any()
    same = h1.hit & (h1.tri == h2.tri)
    assert same.float().mean() > 0.95 * h1.hit.float().mean()
    assert torch.equal(h1.t[same], h2.t[same])
    w1 = T_wb.wide_closest_hit_reference(s_lbvh.bvh.wide, o, d, tm)
    assert torch.equal(w1.hit, h1.hit) and torch.equal(w1.t, h1.t)


def test_jax_lbvh_scene_carries_across():
    """A JAX scene built with bvh="lbvh" crosses over through convert: the
    LBVH tree's tables as they are, the port's own walk tables made from
    them, equal to the port's own LBVH scene's."""
    from gnxraytracer_tpu.scene import scene as J_scene

    v, t = random_scene(300, seed=4)

    def fill(b):
        b.add_mesh(v, t, b.add_matte((0.5, 0.5, 0.5)))
        b.add_skybox_light()

    jb, tb = J_scene.SceneBuilder(), T_scene.SceneBuilder()
    fill(jb)
    fill(tb)
    got = convert.scene_from_numpy(np_tree(jax_lbvh(jb.build, "lbvh")),
                                   device="cpu")
    own = tb.build(bvh="lbvh", device="cpu")
    for f in TABLES:
        assert torch.equal(getattr(got.bvh, f), getattr(own.bvh, f)), f
    assert_tables_equal(got.bvh.packet, own.bvh.packet, "packet")
    assert got.big_tri_idx is None


def test_shortfall_script_counts_the_jax_fault(built):
    """tests/jax_lbvh_fit_shortfall.py (the blob figure of ROADMAP C12): on
    the deep comb the JAX package's fixed sweeps stop short of the tree's
    height and leave boxes short and triangles outside their ancestors'
    boxes; on the other inputs the boxes come out right all the same
    (800 random triangles: height 16 against 12 sweeps)."""
    from jax_lbvh_fit_shortfall import shortfall

    got = shortfall(built["jdev"])
    print(built["name"], got)
    assert got["triangles"] == len(built["t"])
    if built["name"] == "deep_comb":
        assert got["height"] == 9 and got["fixed_sweeps"] == 6
        assert got["short_nodes"] > 0
        assert got["triangles_outside_an_ancestor_box"] > 0
    else:
        assert got["short_nodes"] == got["triangles_outside_an_ancestor_box"] == 0
