"""The port's brute-force any-hit kernel (the second entry of
csrc/closest_hit.cu) and the scene casts routed through the brute-force
kernels, against the JAX package on the CPU.

``any_hit_reference`` is the kernel's plain version, what its wrapper runs
on a CPU tensor and what the kernel is held against on the card.  Here it
is held against the JAX package's ``intersect.any_triangle_hit`` (XLA code,
not a TPU kernel) on ray soups with a ragged ray count, more triangles than
one of the kernel's shared-memory tiles, t_max cut short, dead lanes, and
the shared-edge quad.  Then ``trace.scene_occluded`` / ``scene_intersect``
with the flags that route their brute-force casts through the kernels'
wrappers (``use_pallas`` without a BVH, ``bvh_mode="pallas"`` for the big
triangles kept out of a BVH) against the JAX package on the same rays.

Tolerance: masks identical.  The two packages run the same float32
operations in the same order; the one place where they could part (XLA's
FMA contraction of an edge function) is zero-snapped in both, and on these
ray sets no lane differs.  Hit distances of the closest casts: rtol 1e-5 +
atol 1e-6, as tests/test_torch_intersect.py states."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnxraytracer_tpu.models.integrators import path as J_path
from gnxraytracer_tpu.ops import intersect as J_int
from gnxraytracer_tpu.ops import trace as J_trace
from gnxraytracer_tpu_torch.kernels import closest_hit as T_ch
from gnxraytracer_tpu_torch.models.integrators import direct as T_direct
from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.models.integrators import whitted as T_whitted
from gnxraytracer_tpu_torch.ops import intersect as T_int
from gnxraytracer_tpu_torch.ops import samplers as T_smp
from gnxraytracer_tpu_torch.ops import trace as T_trace

from test_torch_convert import scene_pair
from test_torch_intersect import (_shared_edge_rays, cornell_mesh,
                                  random_rays, soup_mesh)

TILE = 1024  # triangles a shared-memory tile of csrc/closest_hit.cu


def _soa(verts, tris):
    return np.concatenate([verts[tris[:, k]] for k in range(3)], axis=1)


def _shared_edge():
    verts, tris, o, d = _shared_edge_rays()
    return verts, tris, o, d, np.full(len(o), 1e30, np.float32)


CASES = {
    # (mesh, rays): a ragged ray count throughout
    "cornell": lambda: (*cornell_mesh(), *random_rays(5003, 3, 2.4)),
    "soup300": lambda: (*soup_mesh(300, seed=4), *random_rays(3001, 5, 4.0)),
    # more triangles than one tile: the kernel's tiled path
    "soup_2_tiles": lambda: (*soup_mesh(TILE + 77, seed=6),
                             *random_rays(1201, 7, 4.0)),
    "shared_edge": _shared_edge,
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    verts, tris, o, d, t_max = (np.array(x) for x in CASES[request.param]())
    soa = _soa(verts, tris)
    args = [torch.from_numpy(x) for x in (o, d, t_max, soa)]
    return dict(name=request.param, verts=verts, tris=tris, o=o, d=d,
                t_max=t_max, soa=soa, args=args,
                ref=T_ch.any_hit_reference(*args).numpy())


def test_any_hit_wrapper_on_cpu_is_the_reference(case):
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; any_triangle_hit is the same function on an indexed mesh."""
    before = (T_ch.launch_count, T_ch.any_launch_count)
    got = T_ch.any_hit(*case["args"])
    assert (T_ch.launch_count, T_ch.any_launch_count) == before
    assert got.dtype == torch.bool and got.shape == (len(case["o"]),)
    np.testing.assert_array_equal(got.numpy(), case["ref"])
    mesh = T_int.any_triangle_hit(
        *case["args"][:3], torch.from_numpy(case["verts"]),
        torch.from_numpy(case["tris"]))
    np.testing.assert_array_equal(mesh.numpy(), case["ref"])


def test_any_hit_matches_jax(case):
    ref = np.asarray(J_int.any_triangle_hit(
        *(jnp.asarray(case[k]) for k in ("o", "d", "t_max", "verts",
                                         "tris"))))
    np.testing.assert_array_equal(case["ref"], ref)


def test_any_hit_lanes(case):
    """Dead lanes are never occluded; an occluded lane has a hit no farther
    than its t_max, and the closest hit finds one wherever the any hit
    does; the shared edge lets no ray through."""
    occ, t_max = case["ref"], case["t_max"]
    assert not occ[t_max <= 0].any()
    closest = T_ch.closest_hit_reference(*case["args"])
    np.testing.assert_array_equal(closest.hit.numpy(), occ)
    assert (closest.t.numpy()[occ] <= t_max[occ]).all()
    if case["name"] == "shared_edge":
        assert occ.all(), f"{int((~occ).sum())} rays leaked"
    else:
        # the sets exercise occluded lanes, unoccluded ones and short t_max
        assert 0.05 < occ.mean() < 0.95
        short = (t_max > 0) & (t_max < 10)
        assert occ[short].any() and (~occ[short]).any()


def test_any_hit_wrapper_refuses_bad_inputs():
    o, d, t = torch.zeros((4, 3)), torch.ones((4, 3)), torch.ones((4,))
    soa = torch.zeros((2, 9))
    with pytest.raises(TypeError):
        T_ch.any_hit(o, d, t.double(), soa)
    with pytest.raises(ValueError):
        T_ch.any_hit(o, d, t[:3], soa)
    with pytest.raises(ValueError):
        T_ch.any_hit(o, d, t, soa[:0])
    with pytest.raises(ValueError):
        T_ch.any_hit(o, d.T.contiguous().T, t, soa)  # not contiguous
    with pytest.raises(ValueError):
        T_ch.any_hit(o, d, t, torch.zeros((2, 8)))


# -- the scene casts, routed through the wrappers -------------------------------

@pytest.fixture(scope="module", params=["cornell", "mesh_big"])
def routed(request):
    """A scene without a BVH with use_pallas=True, and one with a BVH and
    big triangles kept out of it with bvh_mode="pallas" (a 4,232-triangle
    blob on a floor whose two triangles stay out of the tree); the JAX
    package casts the same rays with its XLA code (bvh_mode="packet")."""
    name = request.param
    js, _, ts, _ = scene_pair(name, 16, 16)
    if name == "cornell":
        jcfg = J_path.make_config(js, 16, 16, spp=1, use_pallas=False)
        tcfg = T_path.make_config(ts, 16, 16, spp=1, use_pallas=True)
    else:
        jcfg = J_path.make_config(js, 16, 16, spp=1, bvh_mode="packet")
        tcfg = T_path.make_config(ts, 16, 16, spp=1, bvh_mode="pallas")
        assert tcfg.use_bvh and tcfg.n_big == 2
    # t_max unbounded, cut short or dead (0); in the box in every direction,
    # or mostly downwards onto the blob and the floor
    o, d, t_max = random_rays(4003, 13, 0.8)
    if name == "mesh_big":
        o = (o * [3.0, 1.0, 3.0] + [0.0, 0.5, 0.0]).astype(np.float32)
        d = d - [0.0, 0.6, 0.0]
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return dict(name=name, js=js, ts=ts, jcfg=jcfg, tcfg=tcfg, o=o, d=d,
                t_max=t_max)


def test_scene_occluded_through_the_wrapper_matches_jax(routed):
    args = [routed[k] for k in ("o", "d", "t_max")]
    ours = T_trace.scene_occluded(routed["ts"], routed["tcfg"],
                                  *(torch.from_numpy(x) for x in args))
    ref = np.asarray(J_trace.scene_occluded(routed["js"], routed["jcfg"],
                                            *(jnp.asarray(x) for x in args)))
    assert 0.05 < ref.mean() < 0.95
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_scene_intersect_through_the_wrapper_matches_jax(routed):
    args = [routed[k] for k in ("o", "d", "t_max")]
    ours = T_trace.scene_intersect(routed["ts"], routed["tcfg"],
                                   *(torch.from_numpy(x) for x in args))
    ref = J_trace.scene_intersect(routed["js"], routed["jcfg"],
                                  *(jnp.asarray(x) for x in args))
    h = np.asarray(ref.hit)
    assert h.mean() > 0.3
    np.testing.assert_array_equal(ours.hit.numpy(), h)
    np.testing.assert_array_equal(ours.prim.numpy()[h], np.asarray(ref.prim)[h])
    np.testing.assert_array_equal(ours.kind.numpy(), np.asarray(ref.kind))
    np.testing.assert_allclose(ours.t.numpy()[h], np.asarray(ref.t)[h],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernels", [True, False])
def test_the_wrappers_take_the_brute_force_casts(routed, kernels,
                                                 monkeypatch):
    """With the kernels' flag every brute-force cast goes through the
    wrappers, none through the plain loops of ops/intersect.py; without it,
    the other way round.  Results are the same either way."""
    calls = dict(closest=0, any=0, plain=0)

    def counted(key, fn):
        def spy(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return spy

    monkeypatch.setattr(T_ch, "closest_hit", counted("closest", T_ch.closest_hit))
    monkeypatch.setattr(T_ch, "any_hit", counted("any", T_ch.any_hit))
    monkeypatch.setattr(T_int, "closest_triangle_hit",
                        counted("plain", T_int.closest_triangle_hit))
    monkeypatch.setattr(T_int, "any_triangle_hit",
                        counted("plain", T_int.any_triangle_hit))
    cfg = routed["tcfg"]
    if not kernels:
        cfg = (cfg._replace(bvh_mode="packet") if cfg.use_bvh
               else cfg._replace(use_pallas=False))
    o, d, t = (torch.from_numpy(routed[k]) for k in ("o", "d", "t_max"))
    occ = T_trace.scene_occluded(routed["ts"], cfg, o, d, t)
    hit = T_trace.scene_intersect(routed["ts"], cfg, o, d, t)
    want = dict(closest=1, any=1, plain=0) if kernels else \
        dict(closest=0, any=0, plain=2)
    assert calls == want
    ref = T_trace.scene_occluded(routed["ts"], routed["tcfg"], o, d, t)
    assert torch.equal(occ, ref)
    assert torch.equal(hit.hit, T_trace.scene_intersect(
        routed["ts"], routed["tcfg"], o, d, t).hit)


@pytest.mark.parametrize("integrator", ["whitted", "direct"])
def test_kernel_flag_is_the_same_render_on_cpu(integrator):
    """Whitted and direct lighting cast their shadow rays through the any-hit
    wrapper with use_pallas: on CPU tensors the same image, bit for bit."""
    _, _, ts, tc = scene_pair("cornell", 12, 12)
    mod = {"whitted": T_whitted, "direct": T_direct}[integrator]
    extra = ("all",) if integrator == "direct" else ()
    imgs = []
    for flag in (False, True):
        cfg = T_path.make_config(ts, 12, 12, spp=2, max_depth=3,
                                 use_pallas=flag)
        smp = T_smp.make_halton_sampler(2, 12, 12, device="cpu")
        imgs.append(mod.render_chunk(ts, tc, smp, cfg, 0, 2, *extra))
    assert float(imgs[0].mean()) > 0.05
    assert torch.equal(imgs[0], imgs[1])


# -- on the card only -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no "
                    "CPU mode (chip_smoke.py holds it against its plain "
                    "version on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_any_hit_kernel_matches_reference_on_card(case, cuda_device):
    """The any-hit kernel against its plain version on the same device:
    occlusion identical on every lane; every launch is counted."""
    args = [x.to(cuda_device) for x in case["args"]]
    before = T_ch.any_launch_count
    got = T_ch.any_hit(*args)
    torch.cuda.synchronize()
    assert T_ch.any_launch_count == before + 1
    assert torch.equal(got, T_ch.any_hit_reference(*args))
    np.testing.assert_array_equal(got.cpu().numpy(), case["ref"])
