"""The port's shading modules against the JAX package, module by module,
on identical inputs made from a seed with numpy: camera rays, scene casts,
surface interactions, BxDFs and materials, light sampling, light selection.

Tolerance: rtol 1e-5 + atol 1e-6 (both sides compute in float32; XLA
contracts FMAs and has its own sqrt/sin/cos, so the last digits differ but
nothing more).  Boolean outputs must agree on >= 99.9% of lanes: a value
that lands on a threshold can fall either way."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnxraytracer_tpu.models import bxdf as J_bxdf
from gnxraytracer_tpu.models import light_dist as J_ld
from gnxraytracer_tpu.models import lights as J_lights
from gnxraytracer_tpu.models import materials as J_mat
from gnxraytracer_tpu.models.integrators import path as J_path
from gnxraytracer_tpu.ops import sampling as J_sampling
from gnxraytracer_tpu.ops import trace as J_trace
from gnxraytracer_tpu.scene import camera as J_cam
from gnxraytracer_tpu_torch.models import bxdf as T_bxdf
from gnxraytracer_tpu_torch.models import light_dist as T_ld
from gnxraytracer_tpu_torch.models import lights as T_lights
from gnxraytracer_tpu_torch.models import materials as T_mat
from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.ops import sampling as T_sampling
from gnxraytracer_tpu_torch.ops import trace as T_trace
from gnxraytracer_tpu_torch.scene import camera as T_cam

from test_torch_convert import scene_pair

N = 6000
RTOL, ATOL = 1e-5, 1e-6


def tt(x):
    return torch.from_numpy(np.array(x, order="C"))  # a writable copy


def close(ours, theirs, mask=None, rtol=RTOL, atol=ATOL, what=""):
    a = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    b = np.asarray(theirs)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype == bool or b.dtype == bool:
        agree = a == b
        if mask is not None:
            agree = agree | ~mask
        assert agree.mean() >= 0.999, f"{what}: {(~agree).sum()} lanes differ"
        return
    if np.issubdtype(b.dtype, np.integer):
        if mask is not None:
            a, b = a[mask], b[mask]
        np.testing.assert_array_equal(a, b, err_msg=what)
        return
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def close_tuple(ours, theirs, mask=None, **kw):
    for f in theirs._fields:
        close(getattr(ours, f), getattr(theirs, f), mask, what=f, **kw)


def unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module", params=["cornell", "mixed"])
def world(request):
    js, jc, ts, tc = scene_pair(request.param, 40, 30)
    jcfg = J_path.make_config(js, 40, 30, spp=1)
    tcfg = T_path.make_config(ts, 40, 30, spp=1)
    assert jcfg._asdict() == tcfg._asdict()
    rs = np.random.RandomState(7)
    # rays from inside the box in all directions, plus camera rays
    o = ((rs.rand(N, 3) - 0.5) * 4.0).astype(np.float32)
    d = unit(rs.randn(N, 3))
    t_max = np.full(N, 1e30, np.float32)
    t_max[::7] = 0.0
    jhit = J_trace.scene_intersect(js, jcfg, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(t_max))
    return dict(name=request.param, js=js, jc=jc, ts=ts, tc=tc, jcfg=jcfg,
                tcfg=tcfg, o=o, d=d, t_max=t_max, jhit=jhit, rs=rs)


def _thit(jhit):
    """The JAX hit record as the port's, so both build interactions from
    identical input."""
    return T_trace.Hit(*(tt(np.asarray(x)) for x in jhit))


def test_camera_rays(world):
    rs = np.random.RandomState(1)
    p_film = (rs.rand(N, 2) * [40, 30]).astype(np.float32)
    tu = rs.rand(N).astype(np.float32)
    lens = rs.rand(N, 2).astype(np.float32)
    a = T_cam.generate_rays(world["tc"], tt(p_film), tt(tu), tt(lens))
    b = J_cam.generate_rays(world["jc"], jnp.asarray(p_film), jnp.asarray(tu),
                            jnp.asarray(lens))
    for x, y, what in zip(a, b, ("o", "d", "time")):
        close(x, y, what=what)


def test_orthographic_camera_rays():
    kw = dict(eye=(1.0, 2.0, 5.0), look=(0.0, 0.0, 0.0))
    tc = T_cam.make_orthographic_camera(20, 10, device="cpu", **kw)
    jc = J_cam.make_orthographic_camera(20, 10, **kw)
    rs = np.random.RandomState(2)
    p_film = (rs.rand(500, 2) * [20, 10]).astype(np.float32)
    z = np.zeros(500, np.float32)
    a = T_cam.generate_rays(tc, tt(p_film), tt(z), tt(np.stack([z, z], -1)))
    b = J_cam.generate_rays(jc, jnp.asarray(p_film), jnp.asarray(z),
                            jnp.zeros((500, 2)))
    for x, y in zip(a, b):
        close(x, y)


def test_scene_intersect(world):
    jhit = world["jhit"]
    th = T_trace.scene_intersect(world["ts"], world["tcfg"], tt(world["o"]),
                                 tt(world["d"]), tt(world["t_max"]))
    h = np.asarray(jhit.hit)
    assert 0.5 < h.mean() < 0.95  # t_max = 0 lanes miss, the rest mostly hit
    close(th.hit, jhit.hit, what="hit")
    both = h & th.hit.numpy()
    close(th.kind, jhit.kind, both, what="kind")
    close(th.prim, jhit.prim, both, what="prim")
    close(th.t, jhit.t, both, what="t")
    close(th.b, jhit.b, both, atol=1e-5, what="b")
    assert not th.hit.numpy()[world["t_max"] == 0].any()
    assert (th.kind.numpy()[~th.hit.numpy()] == T_trace.PRIM_NONE).all()


def test_scene_occluded(world):
    rs = np.random.RandomState(3)
    t_max = (rs.rand(N) * 6).astype(np.float32)
    t_max[::5] = 0.0
    a = T_trace.scene_occluded(world["ts"], world["tcfg"], tt(world["o"]),
                               tt(world["d"]), tt(t_max))
    b = J_trace.scene_occluded(world["js"], world["jcfg"],
                               jnp.asarray(world["o"]), jnp.asarray(world["d"]),
                               jnp.asarray(t_max))
    assert 0.1 < np.asarray(b).mean() < 0.9
    close(a, b, what="occluded")


def test_make_interaction(world):
    jhit = world["jhit"]
    h = np.asarray(jhit.hit)
    jit_ = J_trace.make_interaction(world["js"], world["jcfg"],
                                    jnp.asarray(world["o"]),
                                    jnp.asarray(world["d"]), jhit)
    tit = T_trace.make_interaction(world["ts"], world["tcfg"], tt(world["o"]),
                                   tt(world["d"]), _thit(jhit))
    close_tuple(tit, jit_, h)
    # frame helpers and ray spawning on identical interactions
    v = unit(np.random.RandomState(4).randn(N, 3))
    close(T_trace.to_local(tit, tt(v)), J_trace.to_local(jit_, jnp.asarray(v)),
          h)
    close(T_trace.to_world(tit, tt(v)), J_trace.to_world(jit_, jnp.asarray(v)),
          h)
    for x, y in zip(T_trace.spawn_ray(tit, tt(v)),
                    J_trace.spawn_ray(jit_, jnp.asarray(v))):
        close(x, y, h)
    tgt = (v * 2.0).astype(np.float32)
    inf = np.arange(N) % 3 == 0
    for x, y in zip(T_trace.shadow_ray(tit, tt(tgt), tt(inf)),
                    J_trace.shadow_ray(jit_, jnp.asarray(tgt),
                                       jnp.asarray(inf))):
        close(x, y, h)
    # the emission-only fast path agrees with the full interaction
    light, ng = T_trace.tri_light_and_ng(world["ts"], world["tcfg"],
                                         _thit(jhit))
    jl, jng = J_trace.tri_light_and_ng(world["js"], world["jcfg"], jhit)
    is_tri = h & (np.asarray(jhit.kind) == J_trace.PRIM_TRI)
    close(light, jl, is_tri, what="light")
    close(ng, jng, is_tri, what="ng")
    for x, y in zip(
            T_trace.tri_emission_attrs(world["ts"], world["tcfg"],
                                       _thit(jhit).prim * tt(is_tri)),
            J_trace.tri_emission_attrs(world["js"], world["jcfg"],
                                       jhit.prim * jnp.asarray(is_tri))):
        close(x, y)


def _local_dirs(seed):
    rs = np.random.RandomState(seed)
    wo = unit(rs.randn(N, 3))
    wi = unit(rs.randn(N, 3))
    wo[::11, 2] = np.abs(wo[::11, 2])  # keep plenty of same-hemisphere pairs
    wi[::11, 2] = np.abs(wi[::11, 2])
    return wo, wi, rs


def test_bxdf_lobes():
    wo, wi, rs = _local_dirs(5)
    kd = rs.rand(N, 3).astype(np.float32)
    sigma = (rs.rand(N) * 80).astype(np.float32)
    close(T_bxdf.lambert_f(tt(wo), tt(wi), tt(kd)),
          J_bxdf.lambert_f(jnp.asarray(wo), jnp.asarray(wi), jnp.asarray(kd)))
    close(T_bxdf.lambert_pdf(tt(wo), tt(wi)),
          J_bxdf.lambert_pdf(jnp.asarray(wo), jnp.asarray(wi)))
    close(T_bxdf.oren_nayar_f(tt(wo), tt(wi), tt(kd), tt(sigma)),
          J_bxdf.oren_nayar_f(jnp.asarray(wo), jnp.asarray(wi),
                              jnp.asarray(kd), jnp.asarray(sigma)))
    u = rs.rand(N, 2).astype(np.float32)
    # z = sqrt(1 - x^2 - y^2) loses digits as z -> 0: absolute 1e-5
    close(T_bxdf.diffuse_sample_wi(tt(wo), tt(u)),
          J_bxdf.diffuse_sample_wi(jnp.asarray(wo), jnp.asarray(u)), atol=1e-5)
    ct = (rs.rand(N) * 2 - 1).astype(np.float32)
    one = np.ones(N, np.float32)
    eta = (1.0 + rs.rand(N)).astype(np.float32)
    close(T_bxdf.fr_dielectric(tt(ct), tt(one), tt(eta)),
          J_bxdf.fr_dielectric(jnp.asarray(ct), jnp.asarray(one),
                               jnp.asarray(eta)))
    uc = rs.rand(N).astype(np.float32)
    a = T_bxdf.fresnel_specular_sample(tt(wo), tt(uc), tt(one), tt(eta))
    b = J_bxdf.fresnel_specular_sample(jnp.asarray(wo), jnp.asarray(uc),
                                       jnp.asarray(one), jnp.asarray(eta))
    same_choice = a[3].numpy() == np.asarray(b[3])
    assert same_choice.mean() >= 0.999
    ok = same_choice & (np.asarray(b[3]) | np.asarray(b[5]))  # not TIR-refract
    for x, y, what in zip(a, b, ("wi", "w_r", "w_t", "choose_r", "pdf", "ok")):
        close(x, y, ok, what=what)


def test_sampling_warps():
    rs = np.random.RandomState(6)
    u = rs.rand(N, 2).astype(np.float32)
    for name in ("uniform_sample_hemisphere", "uniform_sample_sphere",
                 "concentric_sample_disk", "cosine_sample_hemisphere",
                 "uniform_sample_triangle"):
        close(getattr(T_sampling, name)(tt(u)),
              getattr(J_sampling, name)(jnp.asarray(u)), what=name)
    close(T_sampling.uniform_sample_cone(tt(u), 0.7),
          J_sampling.uniform_sample_cone(jnp.asarray(u), 0.7))
    f, g = rs.rand(N).astype(np.float32) * 5, rs.rand(N).astype(np.float32) * 5
    for name in ("balance_heuristic", "power_heuristic"):
        close(getattr(T_sampling, name)(1.0, tt(f), 1.0, tt(g)),
              getattr(J_sampling, name)(1.0, jnp.asarray(f), 1.0,
                                        jnp.asarray(g)), what=name)


def test_distribution1d():
    rs = np.random.RandomState(8)
    func = rs.rand(37).astype(np.float32)
    func[5] = 0.0
    td = T_sampling.make_distribution1d(tt(func))
    jd = J_sampling.make_distribution1d(jnp.asarray(func))
    close_tuple(td, jd)
    u = rs.rand(N).astype(np.float32)
    # the remapped sample (u - cdf[i]) / (cdf[i+1] - cdf[i]) divides a
    # difference of O(1) numbers by a width of ~1/37: the last-ulp difference
    # of the two cumsums (the cdf itself is held to 1e-5 above) grows to
    # ~37 * 2 ulp ~ 1e-4 there, and to 1/37 of that in x
    for (x, y), atol in zip(
            zip(T_sampling.sample_continuous_1d(td, tt(u)),
                J_sampling.sample_continuous_1d(jd, jnp.asarray(u))),
            (1e-5, ATOL, ATOL)):
        close(x, y, atol=atol)
    for (x, y), atol in zip(
            zip(T_sampling.sample_discrete_1d(td, tt(u)),
                J_sampling.sample_discrete_1d(jd, jnp.asarray(u))),
            (ATOL, ATOL, 2e-4)):
        close(x, y, atol=atol)
    idx = rs.randint(0, 37, N).astype(np.int32)
    close(T_sampling.discrete_pdf_1d(td, tt(idx)),
          J_sampling.discrete_pdf_1d(jd, jnp.asarray(idx)))


def test_materials(world):
    wo, wi, rs = _local_dirs(9)
    n_mat = int(world["ts"].materials.kind.shape[0])
    mid = rs.randint(0, n_mat, N).astype(np.int32)
    tm = T_mat.gather_material_table(world["ts"].materials, tt(mid))
    jm = J_mat.gather_material_table(world["js"].materials, jnp.asarray(mid))
    close_tuple(tm, jm)
    tcfg, jcfg = world["tcfg"], world["jcfg"]
    # restrict to kinds the config dispatches on (as the integrator does:
    # a hit only ever carries a material that geometry references)
    kinds = np.asarray(jm.kind)
    live = np.isin(kinds, jcfg.mat_kinds)
    close(T_mat.has_nonspecular(tm, None, tcfg),
          J_mat.has_nonspecular(jm, None, jcfg), live)
    f, pdf = T_mat.evaluate(tm, None, tcfg, tt(wo), tt(wi))
    jf, jpdf = J_mat.evaluate(jm, None, jcfg, jnp.asarray(wo), jnp.asarray(wi))
    close(f, jf, live, what="f")
    close(pdf, jpdf, live, what="pdf")
    assert (np.asarray(jf)[live] > 0).any()
    # the indexed form (mid given) is the same function
    f2, pdf2 = T_mat.evaluate(world["ts"].materials, tt(mid), tcfg, tt(wo),
                              tt(wi))
    assert torch.equal(f, f2) and torch.equal(pdf, pdf2)
    u2 = rs.rand(N, 2).astype(np.float32)
    s = T_mat.sample(tm, None, tcfg, tt(wo), tt(u2), tt(u2[:, 0]))
    js_ = J_mat.sample(jm, None, jcfg, jnp.asarray(wo), jnp.asarray(u2),
                       jnp.asarray(u2[:, 0]))
    same = (s.valid.numpy() == np.asarray(js_.valid)) \
        & (s.transmission.numpy() == np.asarray(js_.transmission))
    assert same[live].mean() >= 0.999
    # atol 1e-5: the cosine-sampled wi.z near the horizon, as in
    # test_bxdf_lobes
    close_tuple(s, js_, live & same & np.asarray(js_.valid), atol=1e-5)


def test_lights(world):
    rs = np.random.RandomState(10)
    nl = world["jcfg"].n_lights
    lidx = rs.randint(0, nl, N).astype(np.int32)
    p = ((rs.rand(N, 3) - 0.5) * 4.0).astype(np.float32)
    u2 = rs.rand(N, 2).astype(np.float32)
    close_tuple(T_lights.light_rows(world["ts"], tt(lidx)),
                J_lights.light_rows(world["js"], jnp.asarray(lidx)))
    a = T_lights.sample_li(world["ts"], world["tcfg"], tt(lidx), tt(p), tt(u2))
    b = J_lights.sample_li(world["js"], world["jcfg"], jnp.asarray(lidx),
                           jnp.asarray(p), jnp.asarray(u2))
    # pdf = d^2 / (cos area) amplifies the rounding of cos at grazing angles
    close_tuple(a, b, rtol=1e-4, atol=1e-5)
    for k in world["jcfg"].light_kinds:  # every kind of the scene was drawn
        assert (np.asarray(world["js"].lights.kind)[lidx] == k).any()
    wi = np.asarray(b.wi)
    close(T_lights.pdf_li(world["ts"], world["tcfg"], tt(lidx), tt(p), tt(wi)),
          J_lights.pdf_li(world["js"], world["jcfg"], jnp.asarray(lidx),
                          jnp.asarray(p), jnp.asarray(wi)),
          rtol=1e-4, atol=1e-5)
    n_l = unit(rs.randn(N, 3))
    w = unit(rs.randn(N, 3))
    w[::9] = np.cross(n_l[::9], unit(rs.randn(len(w[::9]), 3)))  # d ~ 0 lanes
    area = np.flatnonzero(np.asarray(world["js"].lights.kind) == 3)
    aidx = area[rs.randint(0, len(area), N)].astype(np.int32)
    for bug in (True, False):
        close(T_lights.area_light_emitted(world["ts"], tt(aidx), tt(n_l),
                                          tt(w), bug),
              J_lights.area_light_emitted(world["js"], jnp.asarray(aidx),
                                          jnp.asarray(n_l), jnp.asarray(w),
                                          bug))
    d = unit(rs.randn(N, 3))
    close(T_lights.skybox_le(world["ts"], tt(p), tt(d)),
          J_lights.skybox_le(world["js"], jnp.asarray(p), jnp.asarray(d)))
    close(T_lights.escaped_radiance(world["ts"], world["tcfg"], tt(p), tt(d)),
          J_lights.escaped_radiance(world["js"], world["jcfg"],
                                    jnp.asarray(p), jnp.asarray(d)))
    close(T_ld.light_powers(world["ts"]), J_ld.light_powers(world["js"]))


@pytest.mark.parametrize("strategy", ["uniform", "power"])
def test_choose_light(world, strategy):
    u = np.random.RandomState(12).rand(N).astype(np.float32)
    tcfg = world["tcfg"]._replace(light_strategy=strategy)
    jcfg = world["jcfg"]._replace(light_strategy=strategy)
    ti, tp = T_path._choose_light(world["ts"], tcfg, tt(u))
    ji, jp = J_path._choose_light(world["js"], jcfg, jnp.asarray(u))
    same = ti.numpy() == np.asarray(ji)
    assert same.mean() >= 0.999  # a u on a cdf step may fall either way
    close(tp, jp, same)
