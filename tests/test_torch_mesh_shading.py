"""The shading modules that the mesh path adds to the port, against the JAX
package, module by module, on identical inputs made from a seed with numpy:
the microfacet functions and the glossy assemblies, the Disney BSDF, the
texture atlas and its three lookups, the 2D distribution, the environment
light, ray differentials, and the BVH branches of the scene casts with
big-prim separation.

Tolerance: rtol 1e-5 + atol 1e-6, as in tests/test_torch_shading.py (both
sides compute in float32; XLA contracts FMAs and has its own
sqrt/sin/cos/exp/log).  It is looser only where a formula is ill-conditioned,
and is then stated at that comparison.  Boolean outputs must agree on
>= 99.9% of lanes: a value that lands on a threshold can fall either way."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnxraytracer_tpu.models import disney as J_disney
from gnxraytracer_tpu.models import lights as J_lights
from gnxraytracer_tpu.models import materials as J_mat
from gnxraytracer_tpu.models import microfacet as J_mf
from gnxraytracer_tpu.models.integrators import path as J_path
from gnxraytracer_tpu.ops import sampling as J_sampling
from gnxraytracer_tpu.ops import texture as J_tex
from gnxraytracer_tpu.ops import trace as J_trace
from gnxraytracer_tpu.scene import camera as J_cam
from gnxraytracer_tpu.scene import scene as J_scene
from gnxraytracer_tpu.utils import image as J_image
from gnxraytracer_tpu_torch.models import disney as T_disney
from gnxraytracer_tpu_torch.models import lights as T_lights
from gnxraytracer_tpu_torch.models import materials as T_mat
from gnxraytracer_tpu_torch.models import microfacet as T_mf
from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.ops import sampling as T_sampling
from gnxraytracer_tpu_torch.ops import texture as T_tex
from gnxraytracer_tpu_torch.ops import trace as T_trace
from gnxraytracer_tpu_torch.scene import camera as T_cam
from gnxraytracer_tpu_torch.scene import scene as T_scene
from gnxraytracer_tpu_torch.utils import image as T_image

from test_torch_convert import mesh_pair
from test_torch_shading import close, close_tuple, tt, unit

N = 5000


def ja(x):
    return jnp.asarray(x)


def local_dirs(seed, n=N):
    rs = np.random.RandomState(seed)
    wo = unit(rs.randn(n, 3))
    wi = unit(rs.randn(n, 3))
    # plenty of same-hemisphere pairs away from the horizon
    wo[::2, 2] = np.abs(wo[::2, 2]) + 0.05
    wi[::2, 2] = np.abs(wi[::2, 2]) + 0.05
    return unit(wo), unit(wi), rs


# -- microfacet ---------------------------------------------------------------

def test_microfacet_distributions():
    wo, wi, rs = local_dirs(1)
    wh = unit(wo + wi)
    ax = (0.05 + rs.rand(N) * 0.8).astype(np.float32)
    ay = (0.05 + rs.rand(N) * 0.8).astype(np.float32)
    r = rs.rand(N).astype(np.float32)
    close(T_mf.roughness_to_alpha(tt(r)), J_mf.roughness_to_alpha(ja(r)))
    # D and Lambda divide by cos^4 and by alpha^2 tan^2: the relative error of
    # cos theta near the horizon is carried to the 4th power, hence rtol 1e-4
    for name in ("tr_d", "beckmann_d"):
        close(getattr(T_mf, name)(tt(wh), tt(ax), tt(ay)),
              getattr(J_mf, name)(ja(wh), ja(ax), ja(ay)), rtol=1e-4, what=name)
    for name in ("tr_lambda", "beckmann_lambda"):
        close(getattr(T_mf, name)(tt(wo), tt(ax), tt(ay)),
              getattr(J_mf, name)(ja(wo), ja(ax), ja(ay)), rtol=1e-4, what=name)
    lam_o = np.asarray(J_mf.tr_lambda(ja(wo), ja(ax), ja(ay)))
    lam_i = np.asarray(J_mf.tr_lambda(ja(wi), ja(ax), ja(ay)))
    close(T_mf.mf_g1(tt(lam_o)), J_mf.mf_g1(ja(lam_o)))
    close(T_mf.mf_g(tt(lam_o), tt(lam_i)), J_mf.mf_g(ja(lam_o), ja(lam_i)))
    d_val = np.asarray(J_mf.tr_d(ja(wh), ja(ax), ja(ay)))
    close(T_mf.mf_pdf_visible(tt(wo), tt(wh), tt(d_val), tt(lam_o)),
          J_mf.mf_pdf_visible(ja(wo), ja(wh), ja(d_val), ja(lam_o)))


@pytest.mark.parametrize("name", ["tr_sample_wh", "beckmann_sample_wh"])
def test_microfacet_sample_wh(name):
    wo, _, rs = local_dirs(2)
    u = rs.rand(N, 2).astype(np.float32)
    ax = (0.05 + rs.rand(N) * 0.8).astype(np.float32)
    ay = (0.05 + rs.rand(N) * 0.8).astype(np.float32)
    a = getattr(T_mf, name)(tt(wo), tt(u), tt(ax), tt(ay))
    b = getattr(J_mf, name)(ja(wo), ja(u), ja(ax), ja(ay))
    # visible-normal sampling stretches, samples a slope and unstretches: the
    # slope's rounding is magnified by 1/alpha (up to 20) on the way back, and
    # the Beckmann variant inverts erf by a few Newton steps; atol 2e-4 on a
    # unit vector
    close(a, b, atol=2e-4, rtol=1e-4, what=name)
    np.testing.assert_allclose(np.linalg.norm(a.numpy(), axis=-1), 1.0,
                               atol=1e-5)


def test_fresnel_blend_and_microfacet_lobes():
    wo, wi, rs = local_dirs(3)
    rd = rs.rand(N, 3).astype(np.float32)
    rsp = rs.rand(N, 3).astype(np.float32)
    ax = (0.05 + rs.rand(N) * 0.6).astype(np.float32)
    ay = (0.05 + rs.rand(N) * 0.6).astype(np.float32)
    same = (wo[:, 2] * wi[:, 2]) > 0
    # the lobes hold D(wh) and 1 / (cos_o cos_i): rtol 1e-4, see
    # test_microfacet_distributions
    kw = dict(rtol=1e-4, atol=1e-5)
    close(T_mf.fresnel_blend_f(tt(wo), tt(wi), tt(rd), tt(rsp), tt(ax), tt(ay)),
          J_mf.fresnel_blend_f(ja(wo), ja(wi), ja(rd), ja(rsp), ja(ax), ja(ay)),
          same, **kw)
    close(T_mf.fresnel_blend_pdf(tt(wo), tt(wi), tt(ax), tt(ay)),
          J_mf.fresnel_blend_pdf(ja(wo), ja(wi), ja(ax), ja(ay)), same, **kw)
    close(T_mf.microfacet_reflection_pdf(tt(wo), tt(wi), tt(ax), tt(ay)),
          J_mf.microfacet_reflection_pdf(ja(wo), ja(wi), ja(ax), ja(ay)),
          same, **kw)
    scale = rs.rand(N, 3).astype(np.float32)
    close(T_mf.microfacet_reflection_f(
              tt(wo), tt(wi), tt(ax), tt(ay),
              lambda c: torch.ones(c.shape + (3,)) * 0.5, tt(scale)),
          J_mf.microfacet_reflection_f(
              ja(wo), ja(wi), ja(ax), ja(ay),
              lambda c: jnp.ones(c.shape + (3,)) * 0.5, ja(scale)),
          same, **kw)
    one = np.ones(N, np.float32)
    eta = (1.2 + rs.rand(N) * 0.6).astype(np.float32)
    kt = rs.rand(N, 3).astype(np.float32)
    opp = ~same
    close(T_mf.microfacet_transmission_f(tt(wo), tt(wi), tt(ax), tt(ay),
                                         tt(one), tt(eta), tt(kt)),
          J_mf.microfacet_transmission_f(ja(wo), ja(wi), ja(ax), ja(ay),
                                         ja(one), ja(eta), ja(kt)), opp, **kw)
    close(T_mf.microfacet_transmission_pdf(tt(wo), tt(wi), tt(ax), tt(ay),
                                           tt(one), tt(eta)),
          J_mf.microfacet_transmission_pdf(ja(wo), ja(wi), ja(ax), ja(ay),
                                           ja(one), ja(eta)), opp, **kw)
    u2 = rs.rand(N, 2).astype(np.float32)
    uc = rs.rand(N).astype(np.float32)
    a = T_mf.fresnel_blend_sample(tt(wo), tt(u2), tt(uc), tt(rd), tt(rsp),
                                  tt(ax), tt(ay))
    b = J_mf.fresnel_blend_sample(ja(wo), ja(u2), ja(uc), ja(rd), ja(rsp),
                                  ja(ax), ja(ay))
    for x, y in zip(a, b):
        close(x, y, atol=2e-4, rtol=1e-3)  # through tr_sample_wh, see above


# -- material assemblies: metal, plastic, rough glass, Disney --------------------

def _glossy_builders():
    def fill(b, mod):
        ids = [
            b.add_material(mod.MAT_METAL, eta3=(0.2, 0.92, 1.1),
                           k3=(3.9, 2.45, 2.14), rough_u=0.05, rough_v=0.1),
            b.add_material(mod.MAT_PLASTIC, kd=(0.4, 0.2, 0.1),
                           ks=(0.6, 0.6, 0.6), rough_u=0.15, rough_v=0.15),
            b.add_glass(kr=(0.9, 1.0, 0.95), kt=(0.95, 0.9, 1.0), eta=1.45,
                        rough_u=0.2, rough_v=0.3),
            b.add_disney((0.6, 0.5, 0.45), rough_u=0.35, metallic=0.1),
            b.add_disney((0.2, 0.7, 0.3), rough_u=0.6, metallic=0.7,
                         specular_tint=0.4, anisotropic=0.5, sheen=0.6,
                         sheen_tint=0.3, clearcoat=0.8, clearcoat_gloss=0.7,
                         eta=1.6),
            b.add_disney((0.8, 0.3, 0.3), rough_u=0.25, spec_trans=0.6,
                         flatness=0.4, diff_trans=0.7, thin=1.0, eta=1.3),
            b.add_disney((0.5, 0.5, 0.9), rough_u=0.45, spec_trans=0.5,
                         eta=1.5),
            b.add_matte((0.3, 0.6, 0.9), sigma=20.0),
        ]
        for k, m in enumerate(ids):
            b.add_sphere((k * 3.0, 0.0, 0.0), 1.0, m)
        b.add_point_light((0.0, 5.0, 0.0), (10.0, 10.0, 10.0))

    jb, tb = J_scene.SceneBuilder(), T_scene.SceneBuilder()
    fill(jb, J_scene)
    fill(tb, T_scene)
    return jb.build(), tb.build(device="cpu")


@pytest.fixture(scope="module")
def glossy():
    js, ts = _glossy_builders()
    jcfg = J_path.make_config(js, 8, 8, spp=1)
    tcfg = T_path.make_config(ts, 8, 8, spp=1)
    assert jcfg._asdict() == tcfg._asdict()
    assert set(tcfg.mat_kinds) == {0, 2, 3, 4, 5}
    wo, wi, rs = local_dirs(4)
    n_mat = int(ts.materials.kind.shape[0])
    mid = rs.randint(0, n_mat, N).astype(np.int32)
    return dict(js=js, ts=ts, jcfg=jcfg, tcfg=tcfg, wo=wo, wi=wi, mid=mid,
                rs=rs,
                tm=T_mat.gather_material_table(ts.materials, tt(mid)),
                jm=J_mat.gather_material_table(js.materials, ja(mid)))


# The BSDFs below are sums of microfacet lobes (D, G and Fresnel terms, each
# with divisions by cosines): rtol 1e-4 + atol 1e-5 on f and pdf.
LOBE_TOL = dict(rtol=1e-4, atol=1e-5)


def test_materials_evaluate_glossy_kinds(glossy):
    g = glossy
    close_tuple(g["tm"], g["jm"])
    f, pdf = T_mat.evaluate(g["tm"], None, g["tcfg"], tt(g["wo"]), tt(g["wi"]))
    jf, jpdf = J_mat.evaluate(g["jm"], None, g["jcfg"], ja(g["wo"]),
                              ja(g["wi"]))
    close(f, jf, what="f", **LOBE_TOL)
    close(pdf, jpdf, what="pdf", **LOBE_TOL)
    kinds = np.asarray(g["jm"].kind)
    for k in g["tcfg"].mat_kinds:  # every kind contributes somewhere
        assert (np.asarray(jf)[kinds == k] > 0).any(), k
    close(T_mat.has_nonspecular(g["tm"], None, g["tcfg"]),
          J_mat.has_nonspecular(g["jm"], None, g["jcfg"]))
    # a base colour handed in (a texture lookup's result) replaces kd
    kd = g["rs"].rand(N, 3).astype(np.float32)
    f2, _ = T_mat.evaluate(g["tm"], None, g["tcfg"], tt(g["wo"]), tt(g["wi"]),
                           tt(kd))
    jf2, _ = J_mat.evaluate(g["jm"], None, g["jcfg"], ja(g["wo"]), ja(g["wi"]),
                            ja(kd))
    close(f2, jf2, what="f with kd_override", **LOBE_TOL)
    assert not np.allclose(np.asarray(jf2), np.asarray(jf))


def test_materials_sample_glossy_kinds(glossy):
    g = glossy
    u2 = g["rs"].rand(N, 2).astype(np.float32)
    uc = g["rs"].rand(N).astype(np.float32)
    s = T_mat.sample(g["tm"], None, g["tcfg"], tt(g["wo"]), tt(u2), tt(uc))
    js_ = J_mat.sample(g["jm"], None, g["jcfg"], ja(g["wo"]), ja(u2), ja(uc))
    # the lobe choice compares uc with cumulated lobe weights: a lane on a
    # boundary may pick the other lobe
    same = ((s.valid.numpy() == np.asarray(js_.valid))
            & (s.transmission.numpy() == np.asarray(js_.transmission))
            & (s.specular.numpy() == np.asarray(js_.specular)))
    assert same.mean() >= 0.999
    ok = same & np.asarray(js_.valid)
    assert ok.mean() > 0.5
    close(s.wi, js_.wi, ok, atol=2e-4, rtol=1e-4, what="wi")  # via sample_wh
    # weight = f |cos| / pdf at a direction known to 2e-4: rtol 2e-3
    close(s.weight, js_.weight, ok, rtol=2e-3, atol=1e-4, what="weight")
    close(s.pdf, js_.pdf, ok, rtol=2e-3, atol=1e-4, what="pdf")
    close(s.eta, js_.eta, ok, what="eta")


def test_disney_evaluate_and_sample(glossy):
    """models/disney.py alone, on lanes that carry a Disney material."""
    g = glossy
    kinds = np.asarray(g["jm"].kind)
    dis = kinds == T_scene.MAT_DISNEY
    assert dis.sum() > N // 3
    f, pdf, mask = T_disney.evaluate(g["tm"], None, g["tcfg"], tt(g["wo"]),
                                     tt(g["wi"]))
    jf, jpdf, jmask = J_disney.evaluate(g["jm"], None, g["jcfg"], ja(g["wo"]),
                                        ja(g["wi"]))
    np.testing.assert_array_equal(mask.numpy(), dis)
    np.testing.assert_array_equal(np.asarray(jmask), dis)
    close(f, jf, dis, what="f", **LOBE_TOL)
    close(pdf, jpdf, dis, what="pdf", **LOBE_TOL)
    assert (np.asarray(jf)[dis] > 0).any() and (np.asarray(jpdf)[dis] > 0).any()
    u2 = g["rs"].rand(N, 2).astype(np.float32)
    uc = g["rs"].rand(N).astype(np.float32)
    s, mask = T_disney.sample(g["tm"], None, g["tcfg"], tt(g["wo"]), tt(u2),
                              tt(uc))
    js_, _ = J_disney.sample(g["jm"], None, g["jcfg"], ja(g["wo"]), ja(u2),
                             ja(uc))
    np.testing.assert_array_equal(mask.numpy(), dis)
    same = ((s.valid.numpy() == np.asarray(js_.valid))
            & (s.transmission.numpy() == np.asarray(js_.transmission)))
    assert same[dis].mean() >= 0.999
    ok = dis & same & np.asarray(js_.valid)
    close(s.wi, js_.wi, ok, atol=2e-4, rtol=1e-4, what="wi")
    close(s.weight, js_.weight, ok, rtol=2e-3, atol=1e-4, what="weight")
    close(s.pdf, js_.pdf, ok, rtol=2e-3, atol=1e-4, what="pdf")


# -- textures -------------------------------------------------------------------

@pytest.fixture(scope="module")
def atlas():
    rs = np.random.RandomState(5)
    imgs = [rs.rand(40, 56, 3).astype(np.float32),
            rs.rand(64, 64, 3).astype(np.float32) ** 2]
    ta = T_tex.build_texture_atlas(imgs, base_size=64)
    ja_ = J_tex.build_texture_atlas(imgs, base_size=64)
    for a, b in zip(ta, ja_):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.numpy().dtype == np.asarray(b).dtype
    uv = (rs.rand(N, 2) * 3 - 1).astype(np.float32)  # Repeat wrap mode
    tid = rs.randint(0, 2, N).astype(np.int32)
    return dict(t=ta, j=ja_, uv=uv, tid=tid, rs=rs)


def test_bilinear_lookup(atlas):
    a = atlas
    close(T_tex.bilinear_lookup(*a["t"], tt(a["tid"]), tt(a["uv"])),
          J_tex.bilinear_lookup(*a["j"], ja(a["tid"]), ja(a["uv"])))
    close(T_tex.bilinear_lookup(*a["t"], tt(a["tid"]), tt(a["uv"]), 3),
          J_tex.bilinear_lookup(*a["j"], ja(a["tid"]), ja(a["uv"]), 3))
    lv = a["rs"].randint(0, 7, N).astype(np.int32)
    close(T_tex.bilinear_lookup(*a["t"], tt(a["tid"]), tt(a["uv"]), tt(lv)),
          J_tex.bilinear_lookup(*a["j"], ja(a["tid"]), ja(a["uv"]), ja(lv)))


def test_trilinear_lookup(atlas):
    a = atlas
    width = (2.0 ** (a["rs"].rand(N) * 8 - 8)).astype(np.float32)
    # the blend weight is the fraction of log2(width): ulp differences of
    # log2 move it by ~1e-6, times a texel contrast of up to 1
    close(T_tex.trilinear_lookup(*a["t"], tt(a["tid"]), tt(a["uv"]), tt(width)),
          J_tex.trilinear_lookup(*a["j"], ja(a["tid"]), ja(a["uv"]), ja(width)),
          atol=1e-5)


def test_ewa_lookup(atlas):
    a = atlas
    rs = a["rs"]
    scale = (2.0 ** (rs.rand(N, 1) * 6 - 7)).astype(np.float32)
    dst0 = (rs.randn(N, 2) * scale).astype(np.float32)
    dst1 = (rs.randn(N, 2) * scale * 0.3).astype(np.float32)
    got = T_tex.ewa_lookup(*a["t"], tt(a["tid"]), tt(a["uv"]), tt(dst0),
                           tt(dst1))
    want = np.asarray(J_tex.ewa_lookup(*a["j"], ja(a["tid"]), ja(a["uv"]),
                                       ja(dst0), ja(dst1)))
    # 64 taps weighted by exp(-2 r^2) - exp(-2) with a cut at r^2 < 1: a tap
    # on the cut may fall on either side (its weight is ~0 there), and the
    # level blend carries log2's ulp: atol 1e-4 on values in [0, 1], and 99.9%
    # of lanes (a lane whose footprint centre rounds to the other texel scans
    # a window shifted by one)
    ok = (np.abs(got.numpy() - want) <= 1e-4 + 1e-4 * np.abs(want)).all(-1)
    assert ok.mean() >= 0.999, f"{(~ok).sum()} lanes differ"
    assert np.isfinite(got.numpy()).all()


# -- the 2D distribution ----------------------------------------------------------

@pytest.fixture(scope="module")
def dist2d():
    rs = np.random.RandomState(6)
    func = rs.rand(17, 33).astype(np.float32) ** 2
    func[3, 5:9] = 0.0  # a flat run in one row's cdf
    func[:, 20] *= 30.0
    return (T_sampling.make_distribution2d(tt(func)),
            J_sampling.make_distribution2d(ja(func)),
            J_sampling.make_distribution2d(ja(func), inverse_table=False), rs)


def test_distribution2d_tables(dist2d):
    td, jd, jd_plain, _ = dist2d
    assert td.cond_inv is None and jd_plain.cond_inv is None
    for f in ("cond_func", "cond_cdf", "cond_int", "marg_cdf", "marg_int"):
        close(getattr(td, f), getattr(jd, f), what=f)
    assert tuple(td.shape) == tuple(jd.shape) == (17, 33)


def test_row_searchsorted_is_a_searchsorted_per_row(dist2d):
    """The JAX package shortens its bisection with an inverse-CDF jump table
    (a TPU device); the port's plain bisection, a torch.searchsorted on each
    lane's row, and the JAX package with and without its table all give the
    same indices."""
    td, jd, jd_plain, rs = dist2d
    rows = rs.randint(0, 17, N).astype(np.int32)
    u = rs.rand(N).astype(np.float32)
    u[::50] = 0.0
    got = T_sampling._row_searchsorted(td.cond_cdf, tt(rows), tt(u)).numpy()
    by_row = torch.searchsorted(td.cond_cdf[tt(rows).long()],
                                tt(u)[:, None], right=True)[:, 0] - 1
    np.testing.assert_array_equal(got, by_row.numpy())
    # against the JAX package on ITS cdf (a last-ulp difference of the two
    # cumsums can move a u that sits on a step)
    cdf_j = tt(np.asarray(jd.cond_cdf))
    got_j = T_sampling._row_searchsorted(cdf_j, tt(rows), tt(u)).numpy()
    assert jd.cond_inv is not None
    np.testing.assert_array_equal(got_j, np.asarray(J_sampling._row_searchsorted(
        jd.cond_cdf, ja(rows), ja(u), inv=jd.cond_inv)))
    np.testing.assert_array_equal(got_j, np.asarray(J_sampling._row_searchsorted(
        jd_plain.cond_cdf, ja(rows), ja(u))))
    assert (got == got_j).mean() >= 0.999


def test_sample_continuous_2d_and_pdf(dist2d):
    td, jd, _, rs = dist2d
    u = rs.rand(N, 2).astype(np.float32)
    p_t, iv_t, iu_t = T_sampling.sample_continuous_2d_idx(td, tt(u))
    p_j, iv_j, iu_j = J_sampling.sample_continuous_2d_idx(jd, ja(u))
    same = (iv_t.numpy() == np.asarray(iv_j)) & (iu_t.numpy() == np.asarray(iu_j))
    assert same.mean() >= 0.999  # a u on a cdf step may fall either way
    # (u - cdf[i]) / (cdf[i+1] - cdf[i]) divides by the texel's share of its
    # row, which is far below 1/33 for a dark texel: the cumsums' last-ulp
    # difference grows to ~1e-3 of a texel there, 5e-5 of [0, 1)
    close(p_t, p_j, same, atol=5e-5, what="p")
    p2, pdf = T_sampling.sample_continuous_2d(td, tt(u))
    assert torch.equal(p2, p_t)
    _, pdf_j = J_sampling.sample_continuous_2d(jd, ja(u))
    close(pdf, pdf_j, same, what="pdf")
    # one marginal-pdf formula: the pdf is func / marg_int at the sampled texel
    packed = td.cond_func.numpy() / float(td.marg_int)
    np.testing.assert_allclose(pdf.numpy(), packed[iv_t.numpy(), iu_t.numpy()],
                               rtol=1e-5, atol=1e-12)
    pts = rs.rand(N, 2).astype(np.float32)
    close(T_sampling.pdf_2d(td, tt(pts)), J_sampling.pdf_2d(jd, ja(pts)))
    close(T_sampling.pdf_2d(td, p_t), pdf, rtol=1e-5, atol=1e-12)


# -- the mesh twin: environment light, differentials, textures on a hit -----------

@pytest.fixture(scope="module")
def mesh():
    js, jc, ts, tc = mesh_pair(40, 30)
    kw = dict(spp=4, use_bvh=True)
    jcfg = J_path.make_config(js, 40, 30, bvh_mode="packet", **kw)
    tcfg = T_path.make_config(ts, 40, 30, **kw)
    assert jcfg._asdict() == tcfg._asdict()
    assert tcfg.has_env and tcfg.has_textures and not tcfg.has_skybox
    return dict(js=js, jc=jc, ts=ts, tc=tc, jcfg=jcfg, tcfg=tcfg)


def test_envmap_le_and_pdf(mesh):
    rs = np.random.RandomState(7)
    d = unit(rs.randn(N, 3))
    close(T_lights.envmap_le(mesh["ts"], tt(d)),
          J_lights.envmap_le(mesh["js"], ja(d)))
    le, pdf = T_lights.envmap_le_pdf(mesh["ts"], tt(d))
    jle, jpdf = J_lights.envmap_le_pdf(mesh["js"], ja(d))
    close(le, jle, what="le")
    # pdf = map_pdf / (2 pi^2 sin theta): 1 / sin theta near the poles carries
    # acos' rounding; rtol 1e-4
    close(pdf, jpdf, rtol=1e-4, what="pdf")
    # the fused form equals the separate path (the le_func contract)
    idx = torch.zeros((N,), dtype=torch.int32)
    assert int(mesh["ts"].lights.kind[0]) == T_scene.LIGHT_INFINITE
    close(pdf, T_lights.pdf_li(mesh["ts"], mesh["tcfg"], idx,
                               torch.zeros((N, 3)), tt(d)).numpy(),
          rtol=1e-5, atol=1e-12)
    close(le, T_lights.envmap_le(mesh["ts"], tt(d)).numpy(), rtol=1e-6)
    p = rs.randn(N, 3).astype(np.float32)
    close(T_lights.escaped_radiance(mesh["ts"], mesh["tcfg"], tt(p), tt(d)),
          J_lights.escaped_radiance(mesh["js"], mesh["jcfg"], ja(p), ja(d)))


def test_environment_light_sample_li_and_pdf_li(mesh):
    rs = np.random.RandomState(8)
    p = (rs.randn(N, 3) * 2).astype(np.float32)
    u2 = rs.rand(N, 2).astype(np.float32)
    lidx = np.zeros(N, np.int32)  # the environment light is light 0
    a = T_lights.sample_li(mesh["ts"], mesh["tcfg"], tt(lidx), tt(p), tt(u2))
    b = J_lights.sample_li(mesh["js"], mesh["jcfg"], ja(lidx), ja(p), ja(u2))
    # a u on a cdf step lands in the neighbouring texel: another radiance
    same = np.isclose(a.wi.numpy(), np.asarray(b.wi), atol=1e-4).all(-1)
    assert same.mean() >= 0.999
    assert bool(a.is_infinite.all()) and not bool(a.is_delta.any())
    # wi comes from a texel coordinate known to 1e-5 of [0, 1) (see
    # test_sample_continuous_2d_and_pdf) through sin/cos of up to 2 pi times
    # it: atol 1e-4; the pdf divides by sin theta: rtol 1e-4
    close(a.wi, b.wi, same, atol=1e-4, what="wi")
    close(a.li, b.li, same, what="li")
    close(a.pdf, b.pdf, same, rtol=1e-4, what="pdf")
    assert (np.asarray(b.pdf) > 0).mean() > 0.9
    wi = np.asarray(b.wi)
    close(T_lights.pdf_li(mesh["ts"], mesh["tcfg"], tt(lidx), tt(p), tt(wi)),
          J_lights.pdf_li(mesh["js"], mesh["jcfg"], ja(lidx), ja(p), ja(wi)),
          rtol=1e-4)


def _film_samples(n, w, h, seed):
    rs = np.random.RandomState(seed)
    return ((rs.rand(n, 2) * [w, h]).astype(np.float32),
            rs.rand(n).astype(np.float32), rs.rand(n, 2).astype(np.float32))


def test_ray_differentials(mesh):
    p_film, tu, lens = _film_samples(N, 40, 30, 9)
    a = T_cam.generate_ray_differentials(mesh["tc"], tt(p_film), tt(tu),
                                         tt(lens))
    b = J_cam.generate_ray_differentials(mesh["jc"], ja(p_film), ja(tu),
                                         ja(lens))
    for x, y, what in zip(a[:3], b[:3], ("o", "d", "time")):
        close(x, y, what=what)
    close_tuple(a[3], b[3])
    assert type(a[3]) is T_cam.RayDifferentials
    assert a[3]._fields == b[3]._fields
    sa = T_cam.scale_differentials(a[0], a[1], a[3], 0.5)
    sb = J_cam.scale_differentials(b[0], b[1], b[3], 0.5)
    close_tuple(sa, sb)
    # a thin-lens camera reuses the lens sample for the auxiliary rays
    kw = dict(eye=(0.0, 0.8, 5.0), look=(0.0, -0.3, 0.0), lens_radius=0.1,
              focal_distance=4.0)
    tc = T_cam.make_perspective_camera(40, 30, device="cpu", **kw)
    jc = J_cam.make_perspective_camera(40, 30, **kw)
    close_tuple(
        T_cam.generate_ray_differentials(tc, tt(p_film), tt(tu), tt(lens))[3],
        J_cam.generate_ray_differentials(jc, ja(p_film), ja(tu), ja(lens))[3])


def test_differentials_and_filtered_kd_on_camera_hits(mesh):
    """Camera rays onto the twin: triangle_dpduv, compute_differentials and
    resolve_kd (bilinear, trilinear, EWA) on the same hits."""
    p_film, tu, lens = _film_samples(N, 40, 30, 10)
    jo, jd_, _, jrd = J_cam.generate_ray_differentials(
        mesh["jc"], ja(p_film), ja(tu), ja(lens))
    t_inf = np.full(N, 1e30, np.float32)
    jhit = J_trace.scene_intersect(mesh["js"], mesh["jcfg"], jo, jd_,
                                   ja(t_inf))
    h = np.asarray(jhit.hit)
    assert 0.2 < h.mean() < 0.95
    o, d = np.asarray(jo), np.asarray(jd_)
    thit = T_trace.Hit(*(tt(np.asarray(x)) for x in jhit))
    trd = T_cam.RayDifferentials(*(tt(np.asarray(x)) for x in jrd))
    dpdu_t, dpdv_t = T_trace.triangle_dpduv(mesh["ts"], thit)
    dpdu_j, dpdv_j = J_trace.triangle_dpduv(mesh["js"], jhit)
    # dpdu = (duv x dp) / det(duv): the blob's uv chart has determinants of
    # ~1e-3, which magnifies the rounding of the products: rtol 1e-4
    close(dpdu_t, dpdu_j, h, rtol=1e-4, atol=1e-5, what="dpdu")
    close(dpdv_t, dpdv_j, h, rtol=1e-4, atol=1e-5, what="dpdv")
    jit_ = J_trace.make_interaction(mesh["js"], mesh["jcfg"], jo, jd_, jhit)
    tit = T_trace.make_interaction(mesh["ts"], mesh["tcfg"], tt(o), tt(d),
                                   thit)
    close_tuple(tit, jit_, h, atol=1e-5)
    # identical inputs into compute_differentials
    args = [np.asarray(x) for x in (jit_.p, jit_.ns, dpdu_j, dpdv_j)]
    got = T_trace.compute_differentials(*(tt(x) for x in args), trd,
                                        return_dp=True)
    want = J_trace.compute_differentials(*(ja(x) for x in args), jrd,
                                         return_dp=True)
    # a 2x2 solve whose determinant is |dpdu x dpdv| projected on two axes;
    # its conditioning is that of the uv chart: rtol 1e-3 + atol 1e-5
    for x, y, what in zip(got, want, ("duvdx", "duvdy", "dpdx", "dpdy")):
        close(x, y, h, rtol=1e-3, atol=1e-5, what=what)
    assert len(T_trace.compute_differentials(*(tt(x) for x in args), trd)) == 2
    duv = [np.asarray(x) for x in want[:2]]
    uv, mat = np.asarray(jit_.uv), np.asarray(jit_.mat)
    textured = h & (np.asarray(mesh["js"].materials.kd_tex)[
        np.maximum(mat, 0)] >= 0)
    assert textured.sum() > N // 10
    for filt, tol in (("bilinear", dict()), ("trilinear", dict(atol=1e-5)),
                      ("ewa", dict(atol=1e-4, rtol=1e-4))):
        tcfg = mesh["tcfg"]._replace(texture_filter=filt)
        jcfg = mesh["jcfg"]._replace(texture_filter=filt)
        kd_t = T_mat.resolve_kd(mesh["ts"], tcfg, tt(np.maximum(mat, 0)),
                                tt(uv), duv=(tt(duv[0]), tt(duv[1])))
        kd_j = np.asarray(J_mat.resolve_kd(
            mesh["js"], jcfg, ja(np.maximum(mat, 0)), ja(uv),
            duv=(ja(duv[0]), ja(duv[1]))))
        ok = (np.abs(kd_t.numpy() - kd_j)
              <= tol.get("atol", 1e-6) + tol.get("rtol", 1e-5) * np.abs(kd_j)
              ).all(-1) | ~h
        assert ok.mean() >= 0.999, (filt, int((~ok).sum()))
    # untextured lanes get the table colour
    kd_plain = T_mat.resolve_kd(mesh["ts"], mesh["tcfg"],
                                tt(np.maximum(mat, 0)), tt(uv))
    np.testing.assert_array_equal(
        kd_plain.numpy()[h & ~textured],
        mesh["ts"].materials.kd.numpy()[mat[h & ~textured]])


# -- the BVH branches of the scene casts, with big-prim separation ----------------

@pytest.fixture(scope="module")
def big():
    js, jc, ts, tc = mesh_pair(16, 16, n_seg=46)  # 4,232 + 2 triangles
    jcfg = J_path.make_config(js, 16, 16, spp=1, use_bvh=True,
                              bvh_mode="packet")
    tcfg = T_path.make_config(ts, 16, 16, spp=1, use_bvh=True)
    assert tcfg._asdict() == jcfg._asdict() and tcfg.n_big == 2
    rs = np.random.RandomState(11)
    n = 4000
    o = (rs.randn(n, 3) * [2.5, 0.8, 2.5] + [0, 0.5, 0]).astype(np.float32)
    d = unit(rs.randn(n, 3) - [0, 0.6, 0])  # mostly downwards: blob and floor
    return dict(js=js, ts=ts, jcfg=jcfg, tcfg=tcfg, o=o, d=d, rs=rs, n=n)


def test_scene_intersect_through_bvh_and_big_prims(big):
    t_max = np.full(big["n"], 1e30, np.float32)
    t_max[::9] = 0.0
    t_max[1::5] = 3.0
    jh = J_trace.scene_intersect(big["js"], big["jcfg"], ja(big["o"]),
                                 ja(big["d"]), ja(t_max))
    th = T_trace.scene_intersect(big["ts"], big["tcfg"], tt(big["o"]),
                                 tt(big["d"]), tt(t_max))
    h = np.asarray(jh.hit)
    np.testing.assert_array_equal(th.hit.numpy(), h)
    prim = np.asarray(jh.prim)
    n_tris = big["tcfg"].n_tris
    assert (prim[h] >= n_tris - 2).sum() > 200  # the floor, brute-forced
    assert (prim[h] < n_tris - 2).sum() > 200   # the blob, through the tree
    close(th.t, jh.t, h, what="t")
    # tri may differ on a tie only (a shared edge of the blob)
    same = th.prim.numpy() == prim
    assert same[h].mean() >= 0.995
    close(th.b, jh.b, h & same, atol=1e-5, what="b")
    close(th.kind, jh.kind, h, what="kind")
    assert not th.hit.numpy()[t_max <= 0].any()
    # the brute-force cast over all triangles finds the same hits
    brute = T_trace.scene_intersect(big["ts"],
                                    big["tcfg"]._replace(use_bvh=False),
                                    tt(big["o"]), tt(big["d"]), tt(t_max))
    assert torch.equal(brute.hit, th.hit)
    close(brute.t, th.t.numpy(), h, what="t vs brute force")


def test_scene_occluded_through_bvh_and_big_prims(big):
    t_max = (big["rs"].rand(big["n"]) * 6).astype(np.float32)
    t_max[::5] = 0.0
    jo = np.asarray(J_trace.scene_occluded(big["js"], big["jcfg"],
                                           ja(big["o"]), ja(big["d"]),
                                           ja(t_max)))
    to = T_trace.scene_occluded(big["ts"], big["tcfg"], tt(big["o"]),
                                tt(big["d"]), tt(t_max))
    assert 0.1 < jo.mean() < 0.9
    np.testing.assert_array_equal(to.numpy(), jo)
    assert not to.numpy()[t_max <= 0].any()
    brute = T_trace.scene_occluded(big["ts"],
                                   big["tcfg"]._replace(use_bvh=False),
                                   tt(big["o"]), tt(big["d"]), tt(t_max))
    assert torch.equal(brute, to)


def test_bvh_modes():
    """'pallas' names the kernels' wrappers (plain walk on CPU tensors),
    'packet' the plain walk; 'stack' (or bvh_stackless=False) and
    'stackless' the per-lane walks, which find the same hits."""
    _, _, ts, _ = mesh_pair(8, 8)
    cfg = T_path.make_config(ts, 8, 8, spp=1)
    assert cfg.use_bvh and cfg.bvh_mode == "packet"
    o = torch.tensor([[0.0, 0.8, 5.0]] * 4)
    d = torch.tensor(unit(np.asarray([[0.0, -0.2, -1.0]] * 4)))
    t = torch.full((4,), 1e30)
    a = T_trace.scene_intersect(ts, cfg, o, d, t)
    b = T_trace.scene_intersect(ts, cfg._replace(bvh_mode="pallas"), o, d, t)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert bool(a.hit.all())
    occ = T_trace.scene_occluded(ts, cfg, o, d, t)
    for per_lane in (cfg._replace(bvh_mode="stack"),
                     cfg._replace(bvh_mode="stackless"),
                     cfg._replace(bvh_stackless=False)):
        c = T_trace.scene_intersect(ts, per_lane, o, d, t)
        for f in ("hit", "kind", "prim"):
            assert torch.equal(getattr(c, f), getattr(a, f))
        torch.testing.assert_close(c.t, a.t, rtol=1e-5, atol=0)
        assert torch.equal(T_trace.scene_occluded(ts, per_lane, o, d, t), occ)
    with pytest.raises(ValueError):
        T_trace.scene_intersect(ts, cfg._replace(bvh_mode="nope"), o, d, t)


# -- images -----------------------------------------------------------------------

def test_load_hdr_reads_flat_rgbe(tmp_path):
    """A flat (non-RLE) Radiance file, as chip_smoke.py writes one, decodes
    to the same array in both packages."""
    rs = np.random.RandomState(12)
    h, w = 6, 10
    rgbe = rs.randint(0, 256, (h, w, 4)).astype(np.uint8)
    rgbe[0, 0, 3] = 0  # a zero exponent is black
    path = tmp_path / "x.hdr"
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    ours = T_image.load_hdr(str(path))
    np.testing.assert_array_equal(ours, J_image.load_hdr(str(path)))
    np.testing.assert_array_equal(T_image.load_image(str(path)), ours)
    assert ours.shape == (h, w, 3) and ours.dtype == np.float32
    assert (ours[0, 0] == 0).all()
    e = rgbe[1, 1, 3].astype(np.int32)
    np.testing.assert_allclose(
        ours[1, 1], rgbe[1, 1, :3].astype(np.float32) * 2.0 ** (e - 136))
