"""The port's brute-force intersection against the JAX package.

``closest_hit_reference`` is the plain PyTorch version of the CUDA kernel
(which cannot run without a card) and what the kernel is held against on
the card; here it is held against the TPU kernel it replaces, run in
interpret mode as tests/test_pallas.py runs it, and against the XLA twin
``intersect.closest_triangle_hit``.

Tolerances: XLA on the CPU may contract a*b+c into an FMA where eager
PyTorch rounds twice, which can flip a lane that grazes an edge or sits at
t == delta_t, so ``hit``/``tri`` must agree on >= 99.99% of lanes (at most
one lane of these ray sets) and, on lanes that agree, t to rtol 1e-5 (plus
atol 1e-6: t is a sum of three products that cancel for a hit close to the
origin, so its error scales with the products, ~1e-7 of the scene's extent,
not with t) and the barycentrics to atol 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnxraytracer_tpu.ops import intersect as J_int
from gnxraytracer_tpu.ops import pallas_intersect as J_pi
from gnxraytracer_tpu.scene import presets as J_presets
from gnxraytracer_tpu_torch.kernels import closest_hit as T_ch
from gnxraytracer_tpu_torch.ops import intersect as T_int

N_RAYS = 20000


def cornell_mesh():
    scene, _ = J_presets.cornell_box(32, 32)
    return (np.asarray(scene.geom.vertices, np.float32),
            np.asarray(scene.geom.triangles, np.int32))


def soup_mesh(n_tris=300, seed=0):
    rs = np.random.RandomState(seed)
    tris = (rs.randn(n_tris, 1, 3) * 3
            + rs.randn(n_tris, 3, 3) * 0.5).astype(np.float32)
    return (tris.reshape(-1, 3),
            np.arange(n_tris * 3).reshape(n_tris, 3).astype(np.int32))


def random_rays(n, seed, spread=2.0):
    rs = np.random.RandomState(seed)
    o = (rs.rand(n, 3).astype(np.float32) - 0.5) * 2 * spread
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # mixed t_max: unbounded, short, and dead (0) lanes
    t_max = np.full(n, 1e30, np.float32)
    t_max[1::4] = rs.rand(len(t_max[1::4])).astype(np.float32) * 4
    t_max[2::8] = 0.0
    return o, d, t_max


MESHES = {"cornell": (cornell_mesh, 2.4), "soup300": (soup_mesh, 4.0)}


@pytest.fixture(scope="module", params=sorted(MESHES))
def case(request):
    make, spread = MESHES[request.param]
    verts, tris = make()
    o, d, t_max = random_rays(N_RAYS, 11, spread)
    soa = np.concatenate([verts[tris[:, k]] for k in range(3)], axis=1)
    ours = T_ch.closest_hit_reference(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max),
        torch.from_numpy(soa))
    return dict(verts=verts.copy(), tris=tris.copy(), o=o, d=d, t_max=t_max,
                soa=soa, ours=ours)


def _agree(ours, ref, t_max):
    h1, h2 = ours.hit.numpy(), np.asarray(ref.hit)
    tri1, tri2 = ours.tri.numpy(), np.asarray(ref.tri)
    same = (h1 == h2) & ((tri1 == tri2) | ~h1)
    assert same.mean() >= 0.9999, f"{(~same).sum()} lanes disagree"
    assert h1.sum() > len(h1) // 10  # the ray set exercises real hits
    both = same & h1
    np.testing.assert_allclose(ours.t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.b.numpy()[both], np.asarray(ref.b)[both],
                               atol=1e-5)
    # miss conventions of the kernel: t = INFINITY, tri = 0, b = 0
    miss = ~h1
    assert (ours.t.numpy()[miss] == np.finfo(np.float32).max).all()
    assert (tri1[miss] == 0).all() and (ours.b.numpy()[miss] == 0).all()
    # dead lanes (t_max = 0) are inert; hits respect t_max
    assert not h1[t_max == 0].any()
    assert (ours.t.numpy()[h1] <= t_max[h1]).all()


def test_reference_matches_tpu_kernel_interpret(case):
    ref = J_pi.pallas_closest_hit(
        jnp.asarray(case["o"]), jnp.asarray(case["d"]),
        jnp.asarray(case["t_max"]), jnp.asarray(case["soa"]), interpret=True)
    _agree(case["ours"], ref, case["t_max"])


def test_reference_matches_xla_twin(case):
    ref = J_int.closest_triangle_hit(
        jnp.asarray(case["o"]), jnp.asarray(case["d"]),
        jnp.asarray(case["t_max"]), jnp.asarray(case["verts"]),
        jnp.asarray(case["tris"]))
    _agree(case["ours"], ref, case["t_max"])


def test_wrapper_on_cpu_is_the_reference(case):
    """On CPU tensors the wrapper runs the plain version (and counts no
    launch); closest_triangle_hit is the same function on an indexed mesh."""
    before = T_ch.launch_count
    args = [torch.from_numpy(case[k]) for k in ("o", "d", "t_max", "soa")]
    got = T_ch.closest_hit(*args)
    assert T_ch.launch_count == before
    mesh = T_int.closest_triangle_hit(
        args[0], args[1], args[2], torch.from_numpy(case["verts"]),
        torch.from_numpy(case["tris"]))
    for a, b, c in zip(got, case["ours"], mesh):
        assert torch.equal(a, b) and torch.equal(a, c)
    np.testing.assert_array_equal(
        T_ch.tri_soa_from_mesh(torch.from_numpy(case["verts"]),
                               torch.from_numpy(case["tris"])).numpy(),
        case["soa"])


def test_any_hit_equal_masks(case):
    ours = T_int.any_triangle_hit(
        *(torch.from_numpy(case[k]) for k in ("o", "d", "t_max", "verts",
                                              "tris"))).numpy()
    ref = np.asarray(J_int.any_triangle_hit(
        *(jnp.asarray(case[k]) for k in ("o", "d", "t_max", "verts", "tris"))))
    assert (ours == ref).mean() >= 0.9999
    # any-hit and closest-hit agree on who is blocked
    np.testing.assert_array_equal(ours, case["ours"].hit.numpy())


def _shared_edge_rays(n=500):
    verts = np.asarray([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                        [1.0, 1.0, 0.0]], np.float32)
    tris = np.asarray([[0, 1, 2], [1, 3, 2]], np.int32)
    rs = np.random.RandomState(1)
    s = rs.rand(n).astype(np.float32)
    targets = np.stack([s, 1 - s, np.zeros_like(s)], -1)
    o = np.broadcast_to(np.asarray([0.3, 0.3, 5.0], np.float32), (n, 3)).copy()
    d = targets - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return verts, tris, o, d


def test_shared_edge_no_leak():
    """Rays aimed exactly at the shared diagonal of a two-triangle quad: none
    leaks, closest hit or any hit, and the hit set is the JAX package's."""
    verts, tris, o, d = _shared_edge_rays()
    t_max = np.full(len(o), 1e30, np.float32)
    args = [torch.from_numpy(x) for x in (o, d, t_max, verts, tris)]
    th = T_int.closest_triangle_hit(*args)
    assert bool(th.hit.all()), f"{int((~th.hit).sum())} rays leaked"
    assert bool(T_int.any_triangle_hit(*args).all())
    ref = J_int.closest_triangle_hit(*(jnp.asarray(x) for x in
                                       (o, d, t_max, verts, tris)))
    np.testing.assert_array_equal(th.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(ref.t), rtol=1e-5)


def test_first_triangle_wins_a_tie():
    """Two coincident triangles: strict t < best_t keeps the first."""
    tri = np.asarray([[-1, -1, 0, 1, -1, 0, 0, 1, 0]], np.float32)
    soa = torch.from_numpy(np.concatenate([tri, tri]))
    o = torch.tensor([[0.0, 0.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    far = T_ch.closest_hit_reference(o, d, torch.tensor([10.0]), soa)
    near = T_ch.closest_hit_reference(o, d, torch.tensor([4.0]), soa)
    assert bool(far.hit[0]) and int(far.tri[0]) == 0
    np.testing.assert_allclose(float(far.t[0]), 5.0, rtol=1e-5)
    assert not bool(near.hit[0])


def test_wrapper_refuses_bad_inputs():
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    t = torch.ones((4,))
    soa = torch.zeros((2, 9))
    with pytest.raises(TypeError):
        T_ch.closest_hit(o.double(), d, t, soa)
    with pytest.raises(ValueError):
        T_ch.closest_hit(o, d[:3], t, soa)
    with pytest.raises(ValueError):
        T_ch.closest_hit(o, d, t, soa[:0])
    with pytest.raises(ValueError):
        T_ch.closest_hit(o.T.contiguous().T, d, t, soa)  # not contiguous
    with pytest.raises(ValueError):
        T_ch.closest_hit(o, d, t, torch.zeros((2, 8)))


def test_spheres_equal_masks():
    rs = np.random.RandomState(3)
    c = (rs.randn(6, 3) * 2).astype(np.float32)
    r = (rs.rand(6) + 0.3).astype(np.float32)
    o, d, t_max = random_rays(5000, 5, 4.0)
    ours = T_int.closest_sphere_hit(*(torch.from_numpy(x)
                                      for x in (o, d, t_max, c, r)))
    ref = J_int.closest_sphere_hit(*(jnp.asarray(x)
                                     for x in (o, d, t_max, c, r)))
    h = np.asarray(ref.hit)
    # a root within rounding of the 1e-4 epsilon or of t_max may flip
    same = (ours.hit.numpy() == h) & ((ours.sph.numpy() == np.asarray(ref.sph))
                                      | ~h)
    assert same.mean() >= 0.9998
    both = same & h
    assert both.sum() > 200
    np.testing.assert_allclose(ours.t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=1e-4, atol=1e-5)
    ok_t, _ = T_int.ray_spheres(*(torch.from_numpy(x)
                                  for x in (o, d, t_max, c, r)))
    ok_j, _ = J_int.ray_spheres(*(jnp.asarray(x) for x in (o, d, t_max, c, r)))
    assert (ok_t.numpy() == np.asarray(ok_j)).mean() >= 0.9998


# -- on the card only -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no "
                    "CPU mode (chip_smoke.py holds it against its plain "
                    "version on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_reference_on_card(case, cuda_device):
    """The CUDA kernel against its plain version on the same device: hit and
    tri identical, t rtol 1e-5, b atol 1e-5; every launch is counted."""
    args = [torch.from_numpy(case[k]).to(cuda_device)
            for k in ("o", "d", "t_max", "soa")]
    before = T_ch.launch_count
    got = T_ch.closest_hit(*args)
    torch.cuda.synchronize()
    assert T_ch.launch_count == before + 1
    ref = T_ch.closest_hit_reference(*args)
    assert torch.equal(got.hit, ref.hit) and torch.equal(got.tri, ref.tri)
    np.testing.assert_allclose(got.t.cpu().numpy(), ref.t.cpu().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(got.b.cpu().numpy(), ref.b.cpu().numpy(),
                               atol=1e-5)
