"""Instancing in the port against the JAX package: the quaternion and
animated-transform helpers (utils/transform.py), the instanced casts and
their geometry (ops/instancing.py), the PRIM_INST branches of the scene
casts and of the surface interaction (ops/trace.py), and whole renders of
the instanced Cornell box.

The same numpy inputs, made from a seed, go through both packages on the
CPU.  Tolerances:
  * transforms: 1e-6 absolute (both packages compute in float32 from the
    same float64 host decomposition);
  * casts fed the JAX package's own object-space rays: hit, inst and tri
    equal, t and b within 1e-5 relative (b with 1e-6 absolute beside, for
    barycentrics near 0);
  * casts fed world rays, each package transforming them itself: XLA
    contracts the transform's multiply-adds into FMAs and eager PyTorch does
    not, so an object-space ray can differ in its last bit and a lane on a
    triangle's edge can fall either way: at most 1 lane in 1,000 may differ
    (the test counts and prints them);
  * hit geometry 1e-5; scene casts and interactions at the tolerances of
    tests/test_torch_shading.py; images at those of tests/test_torch_path.py
    (>= 99% of pixels within rtol 1e-3 + atol 1e-4, means within 0.5%)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnxraytracer_tpu.models.integrators import path as J_path
from gnxraytracer_tpu.ops import bvh as J_bvh
from gnxraytracer_tpu.ops import instancing as J_inst
from gnxraytracer_tpu.ops import samplers as J_smp
from gnxraytracer_tpu.ops import trace as J_trace
from gnxraytracer_tpu.scene import presets as J_presets
from gnxraytracer_tpu.utils import transform as J_tf
from gnxraytracer_tpu_torch import convert
from gnxraytracer_tpu_torch.kernels import closest_hit as T_ch
from gnxraytracer_tpu_torch.kernels import packet_bvh as T_pk
from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.ops import instancing as T_inst
from gnxraytracer_tpu_torch.ops import samplers as T_smp
from gnxraytracer_tpu_torch.ops import trace as T_trace
from gnxraytracer_tpu_torch.scene import presets as T_presets
from gnxraytracer_tpu_torch.utils import transform as T_tf

from test_torch_convert import np_tree
from test_torch_shading import _thit, close, close_tuple, tt

ATOL_TF = 1e-6


def rot_x(a):
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rot_z(a):
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = [x, y, z]
    return m


def scale(s):
    return np.diag([s, s, s, 1.0])


def same(ours, theirs, atol=ATOL_TF):
    np.testing.assert_allclose(ours.numpy() if torch.is_tensor(ours)
                               else np.asarray(ours), np.asarray(theirs),
                               rtol=0, atol=atol)


def f32(m):
    return np.asarray(m, np.float32)


# -- utils/transform ------------------------------------------------------------

MATS = [rot_x(a) @ rot_z(a * 0.7) for a in (0.1, 1.0, 2.5, 3.0)] + [
    np.diag([1.0, -1, -1, 1]), np.diag([-1.0, 1, -1, 1]),
    np.diag([-1.0, -1, 1, 1])]


@pytest.mark.parametrize("k", range(len(MATS)))
def test_quat_from_and_to_matrix_match_jax(k):
    m = f32(MATS[k])
    q = T_tf.quat_from_matrix(torch.from_numpy(m))
    same(q, J_tf.quat_from_matrix(jnp.asarray(m)))
    same(T_tf.quat_to_matrix(q), J_tf.quat_to_matrix(jnp.asarray(q.numpy())))
    np.testing.assert_allclose(T_tf.quat_to_matrix(q).numpy(), m, atol=1e-5)


def test_quat_algebra_matches_jax():
    rs = np.random.RandomState(0)
    a = f32(rs.randn(64, 4))
    b = f32(rs.randn(64, 4))
    same(T_tf.quat_mul(tt(a), tt(b)), J_tf.quat_mul(jnp.asarray(a),
                                                    jnp.asarray(b)))
    same(T_tf.quat_dot(tt(a), tt(b)), J_tf.quat_dot(jnp.asarray(a),
                                                    jnp.asarray(b)))
    same(T_tf.quat_normalize(tt(a)), J_tf.quat_normalize(jnp.asarray(a)))
    same(T_tf.quat_identity(device="cpu"), J_tf.quat_identity())
    qa = T_tf.quat_from_matrix(torch.from_numpy(f32(rot_x(0.4))))
    qb = T_tf.quat_from_matrix(torch.from_numpy(f32(rot_z(1.1))))
    np.testing.assert_allclose(
        T_tf.quat_to_matrix(T_tf.quat_mul(qa, qb)).numpy(),
        rot_x(0.4) @ rot_z(1.1), atol=1e-5)


@pytest.mark.parametrize("angle", [1.0, 1e-4, 2.9])
def test_slerp_matches_jax(angle):
    qa = T_tf.quat_from_matrix(torch.eye(4))
    qb = T_tf.quat_from_matrix(torch.from_numpy(f32(rot_x(angle))))
    t = np.linspace(0, 1, 9).astype(np.float32)
    got = T_tf.slerp(tt(t), qa.expand(9, 4), qb.expand(9, 4))
    want = J_tf.slerp(jnp.asarray(t), jnp.broadcast_to(jnp.asarray(qa.numpy()),
                                                       (9, 4)),
                      jnp.broadcast_to(jnp.asarray(qb.numpy()), (9, 4)))
    same(got, want)
    same(got[0], qa.numpy(), atol=1e-5)
    same(got[-1], qb.numpy(), atol=1e-5)


def test_decompose_matches_jax():
    m = translate(1, 2, 3) @ rot_z(0.7) @ np.diag([2.0, 2.0, 2.0, 1.0])
    for ours, theirs in zip(T_tf.decompose(m), J_tf.decompose(m)):
        same(ours, theirs)
    t, r, s = T_tf.decompose(m)
    np.testing.assert_allclose(t, [1, 2, 3], atol=1e-5)
    np.testing.assert_allclose(s[:3, :3], np.diag([2.0, 2, 2]), atol=1e-4)


PAIRS = {
    "translate_rotate": (translate(0, 0, 0), translate(4, 0, 0) @ rot_x(1.2)),
    "slide": (translate(0, 0, 0), translate(2, 0, 0)),
    "quarter_turn": (np.eye(4), translate(3, 0, 0) @ rot_z(np.pi / 2)),
    "scale_shear": (translate(1, 0, 0) @ scale(1.5),
                    translate(0, 2, 0) @ rot_z(0.3) @ np.diag([1, 2, 1, 1.0])),
    "still": (np.eye(4), np.eye(4)),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_animated_transform_matches_jax(name):
    m0, m1 = PAIRS[name]
    at = T_tf.make_animated_transform(m0, m1, device="cpu")
    jat = J_tf.make_animated_transform(m0, m1)
    for f in T_tf.AnimatedTransform._fields:
        same(getattr(at, f), getattr(jat, f))
    times = np.asarray([0.0, 0.25, 0.5, 0.9, 1.0], np.float32)
    same(T_tf.interpolate(at, tt(times)), J_tf.interpolate(
        jat, jnp.asarray(times)))
    same(T_tf.interpolate(at, 0.0), J_tf.interpolate(jat, 0.0))
    np.testing.assert_allclose(T_tf.interpolate(at, 0.0).numpy(), m0,
                               atol=1e-5)
    np.testing.assert_allclose(T_tf.interpolate(at, 1.0).numpy(), m1,
                               atol=1e-4)
    lo, hi = T_tf.motion_bounds(at, [-1, -1, -1], [1, 1, 1])
    jlo, jhi = J_tf.motion_bounds(jat, [-1, -1, -1], [1, 1, 1])
    same(lo, jlo)
    same(hi, jhi)
    assert bool(at.actually_animated) == (name != "still")


def test_point_and_vector_xform_match_jax():
    rs = np.random.RandomState(1)
    m = f32(translate(1, 0, 0) @ rot_z(np.pi / 2) @ scale(1.3))
    m[3] = [0.01, 0.02, -0.03, 1.0]  # a projective row for the divide
    p = f32(rs.randn(100, 3))
    same(T_tf.xform_point(tt(m), tt(p)), J_tf.xform_point(jnp.asarray(m),
                                                          jnp.asarray(p)))
    same(T_tf.xform_vector(tt(m), tt(p)), J_tf.xform_vector(jnp.asarray(m),
                                                            jnp.asarray(p)))
    per_lane = f32(np.stack([translate(*rs.randn(3)) @ rot_x(rs.randn())
                             for _ in range(100)]))
    same(T_tf.xform_point(tt(per_lane), tt(p)),
         J_tf.xform_point(jnp.asarray(per_lane), jnp.asarray(p)))


# -- ops/instancing -----------------------------------------------------------------

def _unit_quad():
    v = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    t = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return v, t


def _mats():
    """The three transforms of tests/test_instancing.py."""
    return [translate(0, 0, -1.0), translate(2.5, 0, -2.0) @ rot_x(0.3),
            translate(-2.0, 0.5, -3.0) @ scale(2.0)]


N_RAYS = 4096


@pytest.fixture(scope="module")
def rays():
    """Rays from z = 2 toward the instances, and per-lane shutter times."""
    rng = np.random.default_rng(0)
    o = (rng.uniform(-1, 3, (N_RAYS, 3)) * [1, 1, 0] + [0, 0, 2.0]).astype(
        np.float32)
    tgt = rng.uniform(-2, 3, (N_RAYS, 3)) * [1, 1, 0] + [0.3, 0.3, -2.5]
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = np.full(N_RAYS, 1e9, np.float32)
    t_max[::9] = 2.5  # cut short: some hits lie beyond
    t_max[::13] = 0.0  # dead lanes
    time = rng.uniform(0, 1, N_RAYS).astype(np.float32)
    return o, d, t_max, time


def _tables(animated):
    mats = _mats()
    if not animated:
        return (T_inst.make_instances(mats, device="cpu"),
                J_inst.make_instances(mats))
    ends = [translate(0.7, -0.2, 0.1) @ m @ rot_x(0.2) for m in mats]
    return (T_inst.make_animated_instances(mats, ends, device="cpu"),
            J_inst.make_animated_instances(mats, ends))


def _bvh_pair(v, t, use_bvh):
    """The base mesh's tree built by the JAX package and carried across, or
    (None, None)."""
    if not use_bvh:
        return None, None
    jb = J_bvh.build_bvh(v, t)
    return convert.bvh_from_numpy_tree(np_tree(jb), device="cpu"), jb


CASES = [(b, a) for b in (False, True) for a in (False, True)]


def _case_id(c):
    return f"{'bvh' if c[0] else 'brute'}-{'animated' if c[1] else 'static'}"


@pytest.fixture(scope="module", params=CASES, ids=_case_id)
def cast_case(request, rays):
    use_bvh, animated = request.param
    v, t = _unit_quad()
    table, jtable = _tables(animated)
    bvh, jbvh = _bvh_pair(v, t, use_bvh)
    o, d, t_max, time = rays
    times = (tt(time), jnp.asarray(time)) if animated else (None, None)
    jh = J_inst.instanced_closest_hit(jnp.asarray(v), jnp.asarray(t), jtable,
                                      jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(t_max), time=times[1],
                                      bvh=jbvh)
    jocc = J_inst.instanced_any_hit(jnp.asarray(v), jnp.asarray(t), jtable,
                                    jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(t_max), time=times[1],
                                    bvh=jbvh)
    return dict(v=v, t=t, table=table, jtable=jtable, bvh=bvh, jbvh=jbvh,
                o=o, d=d, t_max=t_max, time=times, jh=jh, jocc=jocc,
                animated=animated)


def _cast(c, fn, **kw):
    return fn(tt(c["v"]), tt(c["t"]), c["table"], tt(c["o"]), tt(c["d"]),
              tt(c["t_max"]), time=c["time"][0], bvh=c["bvh"], **kw)


def _jax_object_rays(c, monkeypatch):
    """Feed the port's loop the JAX package's object-space rays: instance
    i's rays are J_inst._xform_ray's."""
    jt = c["jtable"]
    jo, jd = jnp.asarray(c["o"]), jnp.asarray(c["d"])
    obj = []
    for i in range(jt.obj_to_world.shape[0]):
        if c["animated"]:
            w2o = jnp.linalg.inv(J_tf.interpolate(jt.animated[i],
                                                  c["time"][1]))
        else:
            w2o = jt.world_to_obj[i]
        obj.append(tuple(tt(np.asarray(x)) for x in
                         J_inst._xform_ray(w2o, jo, jd)))
    monkeypatch.setattr(T_inst, "_world_to_obj", lambda table, i, time: i)
    monkeypatch.setattr(T_inst, "_xform_ray", lambda i, o, d: obj[i])


def test_closest_hit_on_jax_object_rays(cast_case, monkeypatch):
    _jax_object_rays(cast_case, monkeypatch)
    got = _cast(cast_case, T_inst.instanced_closest_hit)
    jh = cast_case["jh"]
    h = np.asarray(jh.hit)
    assert 0.1 < h.mean() < 0.9, h.mean()
    np.testing.assert_array_equal(got.hit.numpy(), h)
    np.testing.assert_array_equal(got.inst.numpy()[h], np.asarray(jh.inst)[h])
    np.testing.assert_array_equal(got.tri.numpy()[h], np.asarray(jh.tri)[h])
    np.testing.assert_allclose(got.t.numpy(), np.asarray(jh.t), rtol=1e-5)
    np.testing.assert_allclose(got.b.numpy()[h], np.asarray(jh.b)[h],
                               rtol=1e-5, atol=1e-6)
    assert len(set(got.inst.numpy()[h].tolist())) == 3  # every instance hit


def test_any_hit_on_jax_object_rays(cast_case, monkeypatch):
    _jax_object_rays(cast_case, monkeypatch)
    got = _cast(cast_case, T_inst.instanced_any_hit)
    np.testing.assert_array_equal(got.numpy(), np.asarray(cast_case["jocc"]))
    assert not got.numpy()[cast_case["t_max"] == 0].any()


def test_casts_on_world_rays(cast_case):
    """Each package transforms the world rays itself: at most 1 lane in
    1,000 differs, in hit, inst, tri or occlusion."""
    got = _cast(cast_case, T_inst.instanced_closest_hit)
    occ = _cast(cast_case, T_inst.instanced_any_hit)
    jh = cast_case["jh"]
    h = np.asarray(jh.hit)
    differ = ((got.hit.numpy() != h) | (occ.numpy() != np.asarray(
        cast_case["jocc"])) | (h & ((got.inst.numpy() != np.asarray(jh.inst))
                                    | (got.tri.numpy() != np.asarray(jh.tri)))))
    print(f"{_case_id((cast_case['bvh'] is not None, cast_case['animated']))}:"
          f" {int(differ.sum())} of {N_RAYS} lanes differ")
    assert differ.sum() <= N_RAYS // 1000
    ok = h & ~differ
    np.testing.assert_allclose(got.t.numpy()[ok], np.asarray(jh.t)[ok],
                               rtol=1e-5)


def test_hit_geometry_matches_jax(cast_case):
    jh = cast_case["jh"]
    h = np.asarray(jh.hit)
    ours_in = T_inst.InstanceHit(*(tt(np.asarray(x)) for x in jh))
    p, ng = T_inst.instance_hit_geometry(tt(cast_case["v"]),
                                         tt(cast_case["t"]),
                                         cast_case["table"], ours_in,
                                         time=cast_case["time"][0])
    # the hit point lies on the world ray at its t, the normal is unit
    want = cast_case["o"] + np.asarray(jh.t)[:, None] * cast_case["d"]
    np.testing.assert_allclose(p.numpy()[h], want[h], atol=2e-3)
    np.testing.assert_allclose(np.linalg.norm(ng.numpy()[h], axis=-1), 1.0,
                               atol=1e-5)
    if not cast_case["animated"]:
        jp, jng = J_inst.instance_hit_geometry(
            jnp.asarray(cast_case["v"]), jnp.asarray(cast_case["t"]),
            cast_case["jtable"], jh)
        np.testing.assert_allclose(p.numpy()[h], np.asarray(jp)[h],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ng.numpy()[h], np.asarray(jng)[h],
                                   atol=1e-5)


def test_kernel_routing_calls_the_wrappers(cast_case, monkeypatch):
    """kernels=True casts through the wrappers (on CPU tensors they run the
    plain versions: the same result bit for bit): the binary-BVH pair with
    the tree, else the brute-force pair on a triangle table made once a
    cast."""
    calls = {}

    def count(mod, name):
        fn = getattr(mod, name)

        def counted(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)

    for mod, names in ((T_pk, ("packet_closest_hit", "packet_any_hit")),
                       (T_ch, ("closest_hit", "any_hit",
                               "tri_soa_from_mesh"))):
        for name in names:
            count(mod, name)
    plain = _cast(cast_case, T_inst.instanced_closest_hit)
    plain_occ = _cast(cast_case, T_inst.instanced_any_hit)
    assert set(calls) <= {"tri_soa_from_mesh"}
    calls.clear()
    got = _cast(cast_case, T_inst.instanced_closest_hit, kernels=True)
    occ = _cast(cast_case, T_inst.instanced_any_hit, kernels=True)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert torch.equal(occ, plain_occ)
    if cast_case["bvh"] is not None:
        assert calls == {"packet_closest_hit": 3, "packet_any_hit": 3}
    else:
        assert calls == {"closest_hit": 3, "any_hit": 3,
                         "tri_soa_from_mesh": 2}


def test_animated_instances_move_over_the_shutter():
    """Twin of TestInstancedIntersect.test_animated_instances_interpolate."""
    v, t = _unit_quad()
    m1 = translate(2.0, 0, 0)
    at = T_inst.make_animated_instances([np.eye(4)], [m1], device="cpu")
    o = torch.tensor([[0.5, 0.5, 1.0], [1.5, 0.5, 1.0], [2.5, 0.5, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]] * 3)
    tmax = torch.full((3,), 1e9)
    for time, want in ((0.0, [True, False, False]), (1.0, [False, False, True]),
                       (0.5, [False, True, False])):
        h = T_inst.instanced_closest_hit(tt(v), tt(t), at, o, d, tmax,
                                         time=torch.full((3,), time))
        assert h.hit.tolist() == want


# -- the scene casts and the interaction ----------------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["brute", "bvh"])
def inst_world(request):
    """cornell_instanced(32, 32) built by the JAX package and carried
    across; rays from inside the box in every direction."""
    js, jc = J_presets.cornell_instanced(32, 32, bvh=request.param)
    ts = convert.scene_from_numpy(np_tree(js), device="cpu")
    jcfg = J_path.make_config(js, 32, 32, spp=1, use_bvh=False)
    tcfg = T_path.make_config(ts, 32, 32, spp=1, use_bvh=False)
    assert jcfg._asdict() == tcfg._asdict() and tcfg.n_inst == 3
    rs = np.random.RandomState(7)
    n = 3000
    o = ((rs.rand(n, 3) - 0.5) * 4.0).astype(np.float32)
    d = rs.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = np.full(n, 1e30, np.float32)
    t_max[::7] = 0.0
    jhit = J_trace.scene_intersect(js, jcfg, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(t_max))
    return dict(js=js, ts=ts, jcfg=jcfg, tcfg=tcfg, o=o, d=d, t_max=t_max,
                jhit=jhit)


def test_scene_intersect_hits_instances(inst_world):
    w = inst_world
    th = T_trace.scene_intersect(w["ts"], w["tcfg"], tt(w["o"]), tt(w["d"]),
                                 tt(w["t_max"]))
    jh = w["jhit"]
    h = np.asarray(jh.hit)
    assert (np.asarray(jh.kind)[h] == J_trace.PRIM_INST).mean() > 0.05
    close(th.hit, jh.hit, what="hit")
    both = h & th.hit.numpy()
    for f in ("kind", "prim", "t"):
        close(getattr(th, f), getattr(jh, f), both, what=f)
    close(th.b, jh.b, both, atol=1e-5, what="b")


def test_scene_occluded_by_instances(inst_world):
    w = inst_world
    t_max = (np.random.RandomState(3).rand(len(w["o"])) * 6).astype(np.float32)
    a = T_trace.scene_occluded(w["ts"], w["tcfg"], tt(w["o"]), tt(w["d"]),
                               tt(t_max))
    b = J_trace.scene_occluded(w["js"], w["jcfg"], jnp.asarray(w["o"]),
                               jnp.asarray(w["d"]), jnp.asarray(t_max))
    close(a, b, what="occluded")


def test_make_interaction_of_instance_hits(inst_world):
    w = inst_world
    jh = w["jhit"]
    jit_ = J_trace.make_interaction(w["js"], w["jcfg"], jnp.asarray(w["o"]),
                                    jnp.asarray(w["d"]), jh)
    tit = T_trace.make_interaction(w["ts"], w["tcfg"], tt(w["o"]),
                                   tt(w["d"]), _thit(jh))
    close_tuple(tit, jit_, np.asarray(jh.hit))


def test_instances_need_an_instanced_scene():
    scene, _ = T_presets.cornell_box(8, 8, device="cpu")
    cfg = T_path.make_config(scene, 8, 8, spp=1)._replace(n_inst=1,
                                                           n_inst_tris=2)
    o, d, t = torch.zeros((4, 3)), torch.ones((4, 3)), torch.ones((4,))
    for cast in (T_trace.scene_intersect, T_trace.scene_occluded):
        with pytest.raises(ValueError, match="add_instances"):
            cast(scene, cfg, o, d, t)


# -- whole renders ----------------------------------------------------------------

W = 24
SPP = 3


@pytest.fixture(scope="module", params=[False, True], ids=["brute", "bvh"])
def render_pair(request):
    js, jc = J_presets.cornell_instanced(W, W, bvh=request.param)
    ts = convert.scene_from_numpy(np_tree(js), device="cpu")
    tc = convert.camera_from_numpy(np_tree(jc), device="cpu")
    kw = dict(spp=SPP, spp_chunk=SPP, max_depth=4, fast_mis=True,
              count_rays=True, use_bvh=False)
    jcfg = J_path.make_config(js, W, W, use_pallas=False, **kw)
    tcfg = T_path.make_config(ts, W, W, use_pallas=False, **kw)
    assert jcfg._asdict() == tcfg._asdict()
    jimg, _ = J_path._render_chunk_jit(js, jc, J_smp.make_sobol_sampler(SPP),
                                       jcfg, 0, SPP)
    timg, _ = T_path.render_chunk(ts, tc, T_smp.make_sobol_sampler(
        SPP, device="cpu"), tcfg, 0, SPP)
    return dict(jax=np.asarray(jimg), torch=timg.numpy(), ts=ts, tc=tc,
                tcfg=tcfg, bvh=request.param)


def test_instanced_render_matches_jax(render_pair):
    a, b = render_pair["torch"], render_pair["jax"]
    assert np.isfinite(a).all() and b.mean() > 0.1
    ok = (np.abs(a - b) <= 1e-4 + 1e-3 * np.abs(b)).all(axis=-1)
    assert ok.mean() >= 0.99, f"{(~ok).sum()} of {ok.size} pixels differ"
    assert abs(a.mean() / b.mean() - 1.0) < 0.005


def test_instanced_render_matches_the_flattened_twin(render_pair):
    """The port's own instanced scene against its flattened one (the JAX
    test's rule: under 1% of pixels off by more than 1e-3, means within
    5e-3 relative), and the kernel flag is the same function on the CPU."""
    ts, tc, tcfg = render_pair["ts"], render_pair["tc"], render_pair["tcfg"]
    fs, _ = T_presets.cornell_instanced(W, W, flatten=True,
                                        bvh=render_pair["bvh"], device="cpu")
    fcfg = T_path.make_config(fs, W, W, spp=SPP, spp_chunk=SPP, max_depth=4,
                              fast_mis=True, count_rays=True, use_bvh=False)
    smp = T_smp.make_sobol_sampler(SPP, device="cpu")
    flat, _ = T_path.render_chunk(fs, tc, smp, fcfg, 0, SPP)
    diff = np.abs(render_pair["torch"] - flat.numpy()).max(axis=-1)
    assert (diff > 1e-3).mean() < 0.01
    np.testing.assert_allclose(render_pair["torch"].mean(), flat.numpy().mean(),
                               rtol=5e-3)
    img, _ = T_path.render_chunk(ts, tc, smp, tcfg._replace(use_pallas=True),
                                 0, SPP)
    np.testing.assert_array_equal(img.numpy(), render_pair["torch"])


# -- on the card only -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (chip_smoke.py holds them against their plain "
                    "versions on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_bvh", [False, True], ids=["brute", "bvh"])
def test_instance_casts_through_kernels_on_card(use_bvh, rays, cuda_device):
    """kernels=True on CUDA tensors launches the kernels, once an instance a
    cast, bit-equal to the plain versions on the same object-space rays."""
    v, t = _unit_quad()
    table = T_inst.make_instances(_mats(), device=cuda_device)
    bvh = None
    if use_bvh:
        from gnxraytracer_tpu_torch.ops.bvh import build_bvh

        bvh = build_bvh(v, t, device=cuda_device)
    args = [torch.from_numpy(a).to(cuda_device) for a in rays[:3]]
    vv, ttri = tt(v).to(cuda_device), tt(t).to(cuda_device)
    T_pk.reset_launch_counts()
    T_ch.reset_launch_count()
    got = T_inst.instanced_closest_hit(vv, ttri, table, *args, bvh=bvh,
                                       kernels=True)
    occ = T_inst.instanced_any_hit(vv, ttri, table, *args, bvh=bvh,
                                   kernels=True)
    torch.cuda.synchronize()
    launches = ((T_pk.closest_launch_count, T_pk.any_launch_count) if use_bvh
                else (T_ch.launch_count, T_ch.any_launch_count))
    assert launches == (3, 3)
    ref = T_inst.instanced_closest_hit(vv, ttri, table, *args, bvh=bvh)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(occ, T_inst.instanced_any_hit(vv, ttri, table, *args,
                                                      bvh=bvh))


@pytest.mark.cuda
def test_make_config_picks_the_kernels_on_card(cuda_device):
    """An instanced scene on the card, its configuration from make_config's
    defaults: the instances' casts launch the binary-BVH kernels and the
    walls' the brute-force ones, with no flag asking for them."""
    ts, tc = T_presets.cornell_instanced(8, 8, bvh=True, device=cuda_device)
    cfg = T_path.make_config(ts, 8, 8, spp=1, max_depth=1)
    assert cfg.use_pallas and not cfg.use_bvh
    T_pk.reset_launch_counts()
    T_ch.reset_launch_count()
    smp = T_smp.make_sobol_sampler(1, device=cuda_device)
    img = T_path.render(ts, tc, smp, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(img).all()
    assert T_pk.closest_launch_count > 0 and T_pk.any_launch_count > 0
    assert T_ch.launch_count > 0 and T_ch.any_launch_count > 0
