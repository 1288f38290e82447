"""The port's BSSRDF library (models/bssrdf.py) against the JAX package's on
the same seeded inputs, and the twins of tests/test_bssrdf.py run on the
port.

Tolerance against the JAX functions: the same float32 formulas (XLA
contracting FMAs, its own exp/log/sqrt), values within rtol 1e-5 + atol
1e-6 (rtol 1e-4 where a value divides by a small r or a small 1 - cos); the
beam-diffusion table is float64 numpy on the host in both packages, so its
profile is equal bit for bit and its CDFs (float32 spline integrals) agree
within rtol 1e-5.  Sampled radii go through the Newton-bisection of
tests/test_torch_interpolation.py and are held to its rule.  Gradients of
disney_sr and tabulated_sr with respect to the profile parameters (autograd
against jax.grad) within rtol 1e-4 + atol 1e-6.  The probe chain of
sample_sp_probe on the 16x16 Cornell box: found and n_found equal, the
chosen points within atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnxraytracer_tpu.models import bssrdf as J
from gnxraytracer_tpu.models.integrators import path as J_path
from gnxraytracer_tpu.ops import trace as J_trace
from gnxraytracer_tpu_torch.models import bssrdf as T
from gnxraytracer_tpu_torch.models.integrators import path as T_path
from gnxraytracer_tpu_torch.ops import trace as T_trace
from gnxraytracer_tpu_torch.ops.sampling import uniform_sample_hemisphere

from test_torch_convert import scene_pair
from test_torch_interpolation import close_solution, public_names


def t_(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, rtol=1e-5, atol=1e-6):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def tables():
    """(JAX table, the port's table, the JAX table carried into the port)."""
    jt = J.compute_beam_diffusion_table(g=0.0, eta=1.33, n_rho=32, n_radius=32)
    tt = T.compute_beam_diffusion_table(g=0.0, eta=1.33, n_rho=32, n_radius=32,
                                        device="cpu")
    carried = T.BSSRDFTable(*(t_(np.asarray(a)) for a in jt))
    return jt, tt, carried


def test_every_public_name_is_ported():
    assert public_names(J) <= public_names(T)


# -- against the JAX package --------------------------------------------------

def test_fresnel_moments_and_sw_match_jax():
    eta = np.linspace(0.5, 2.5, 81).astype(np.float32)
    close(T.fresnel_moment1(t_(eta)), J.fresnel_moment1(jnp.asarray(eta)),
          rtol=1e-5, atol=1e-5)
    close(T.fresnel_moment2(t_(eta)), J.fresnel_moment2(jnp.asarray(eta)),
          rtol=1e-5, atol=1e-4)
    u = np.random.default_rng(0).uniform(1e-4, 1 - 1e-4, (512, 2))
    w = uniform_sample_hemisphere(t_(u))
    w[::3, 2] *= -1  # both sides
    for eta in (1.33, 1.5):
        close(T.sw(w, eta), J.sw(jnp.asarray(w.numpy()), eta), rtol=1e-5)
        close(T.adapter_f(w, w, eta), J.adapter_f(None, jnp.asarray(w.numpy()),
                                                  eta), rtol=1e-5)


def test_disney_profile_matches_jax():
    rng = np.random.default_rng(1)
    r = rng.uniform(0, 3, 1024).astype(np.float32)
    big_r = rng.uniform(0.1, 0.9, (1024, 3)).astype(np.float32)
    d = rng.uniform(0.05, 0.8, (1024, 3)).astype(np.float32)
    close(T.disney_sr(t_(r), t_(big_r), t_(d)),
          J.disney_sr(jnp.asarray(r), jnp.asarray(big_r), jnp.asarray(d)),
          rtol=1e-4)
    u = rng.uniform(size=1024).astype(np.float32)
    close(T.disney_sample_sr(t_(u), 0.4), J.disney_sample_sr(jnp.asarray(u), 0.4),
          rtol=1e-5, atol=1e-6)
    close(T.disney_pdf_sr(t_(r), t_(d[:, 0])),
          J.disney_pdf_sr(jnp.asarray(r), jnp.asarray(d[:, 0])), rtol=1e-4)
    n = 256
    args = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(4)]
    args[1] /= np.linalg.norm(args[1], axis=1, keepdims=True)
    args[3] /= np.linalg.norm(args[3], axis=1, keepdims=True)
    zs = [rng.uniform(-1, 1, n).astype(np.float32) for _ in range(2)]
    sp = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    got = T.disney_s(t_(args[0]), t_(args[1]), t_(zs[0]), t_(args[2]),
                     t_(args[3]), t_(zs[1]), None, t_(sp))
    want = J.disney_s(*(jnp.asarray(a) for a in (args[0], args[1], zs[0],
                                                 args[2], args[3], zs[1])),
                      None, jnp.asarray(sp))
    close(got, want, rtol=1e-4, atol=1e-6)


def test_beam_diffusion_table_matches_jax(tables):
    jt, tt, _ = tables
    for f in ("rho_samples", "radius_samples", "profile"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)))
    close(tt.rho_eff, jt.rho_eff, rtol=1e-5, atol=1e-7)
    close(tt.profile_cdf, jt.profile_cdf, rtol=1e-5, atol=1e-7)


def test_tabulated_profile_matches_jax(tables):
    jt, _, tt = tables
    rng = np.random.default_rng(2)
    n = 512
    sigma_t = rng.uniform(0.5, 4.0, (n, 3)).astype(np.float32)
    rho = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    r = rng.uniform(0.0, 1.5, n).astype(np.float32)
    close(T.tabulated_sr(tt, t_(sigma_t), t_(rho), t_(r)),
          J.tabulated_sr(jt, jnp.asarray(sigma_t), jnp.asarray(rho),
                         jnp.asarray(r)), rtol=1e-4, atol=1e-6)
    close(T.tabulated_pdf_sr(tt, t_(sigma_t[:, 0]), t_(rho[:, 0]), t_(r)),
          J.tabulated_pdf_sr(jt, jnp.asarray(sigma_t[:, 0]),
                             jnp.asarray(rho[:, 0]), jnp.asarray(r)),
          rtol=1e-4, atol=1e-6)
    u = rng.uniform(size=n).astype(np.float32)
    got_r, got_ok = T.tabulated_sample_sr(tt, t_(sigma_t[:, 1]),
                                          t_(rho[:, 1]), t_(u))
    want_r, want_ok = J.tabulated_sample_sr(jt, jnp.asarray(sigma_t[:, 1]),
                                            jnp.asarray(rho[:, 1]),
                                            jnp.asarray(u))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    close_solution(got_r, want_r)
    eff = np.asarray(jt.rho_eff)[[3, 10, 20, 30]]
    mfp = np.asarray([0.5, 1.0, 1.25, 3.0], np.float32)
    for g, w in zip(T.subsurface_from_diffuse(tt, t_(eff), t_(mfp)),
                    J.subsurface_from_diffuse(jt, jnp.asarray(eff),
                                              jnp.asarray(mfp))):
        close_solution(g, w)


def test_projection_machinery_matches_jax():
    rng = np.random.default_rng(3)
    n = 256
    u1 = rng.uniform(size=n).astype(np.float32)
    frame = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]
    for g, w in zip(T.choose_projection_axis(t_(u1), *map(t_, frame)),
                    J.choose_projection_axis(jnp.asarray(u1),
                                             *map(jnp.asarray, frame))):
        close(g, w, rtol=0, atol=0)
    po = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    pi = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    ng = frame[2] / np.linalg.norm(frame[2], axis=1, keepdims=True)
    got = T.pdf_sp(lambda ch, r: T.disney_pdf_sr(r, 0.3 + 0.1 * ch), t_(po),
                   t_(pi), t_(ng), *map(t_, frame))
    want = J.pdf_sp(lambda ch, r: J.disney_pdf_sr(r, 0.3 + 0.1 * ch),
                    jnp.asarray(po), jnp.asarray(pi), jnp.asarray(ng),
                    *map(jnp.asarray, frame))
    close(got, want, rtol=1e-4, atol=1e-6)


def test_disney_sr_gradient_matches_jax():
    rng = np.random.default_rng(4)
    r = rng.uniform(0.01, 2, 128).astype(np.float32)
    big_r = rng.uniform(0.1, 0.9, (128, 3)).astype(np.float32)
    d = rng.uniform(0.05, 0.8, (128, 3)).astype(np.float32)
    jg = jax.grad(lambda a, b: J.disney_sr(jnp.asarray(r), a, b).sum(),
                  argnums=(0, 1))(jnp.asarray(big_r), jnp.asarray(d))
    a, b = t_(big_r).requires_grad_(), t_(d).requires_grad_()
    T.disney_sr(t_(r), a, b).sum().backward()
    close(a.grad, jg[0], rtol=1e-4)
    close(b.grad, jg[1], rtol=1e-4)


def test_tabulated_sr_gradient_matches_jax(tables):
    jt, _, tt = tables
    rng = np.random.default_rng(5)
    sigma_t = rng.uniform(0.5, 4.0, (128, 3)).astype(np.float32)
    rho = rng.uniform(0.05, 0.95, (128, 3)).astype(np.float32)
    r = rng.uniform(0.02, 0.5, 128).astype(np.float32)
    jg = jax.grad(lambda s, p: J.tabulated_sr(jt, s, p, jnp.asarray(r)).sum(),
                  argnums=(0, 1))(jnp.asarray(sigma_t), jnp.asarray(rho))
    s, p = t_(sigma_t).requires_grad_(), t_(rho).requires_grad_()
    T.tabulated_sr(tt, s, p, t_(r)).sum().backward()
    close(s.grad, jg[0], rtol=1e-4)
    close(p.grad, jg[1], rtol=1e-4)


def _floor_probe(pkg_trace, pkg_path, xp, scene, cfg_kw, n=64):
    """The JAX test's probe set-up: the floor point below the box's center
    and n probes around it, in either package (xp: jnp or a torch wrapper)."""
    cfg = pkg_path.make_config(scene, 16, 16, spp=1, **cfg_kw)
    o, dn = xp([[0.0, 0.0, 0.0]]), xp([[0.0, -1.0, 0.0]])
    h = pkg_trace.scene_intersect(scene, cfg, o, dn, xp([1e9]))
    it0 = pkg_trace.make_interaction(scene, cfg, o, dn, h)
    return cfg, it0


def test_sample_sp_probe_matches_jax():
    """sample_sp_probe on the 16x16 Cornell box floor (the JAX test's
    set-up), the same radii, angles and selections in both packages."""
    js, _, ts, _ = scene_pair("cornell", 16, 16)
    n = 64
    rng = np.random.default_rng(0)
    r = rng.uniform(0.01, 0.3, n).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    u_sel = rng.uniform(size=n).astype(np.float32)
    r_max = np.full(n, 0.5, np.float32)
    r_max[::7] = 0.005  # r >= r_max: no probe
    frame = [np.asarray(v, np.float32) for v in
             ([0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0])]
    out = {}
    for name, tr, pth, xp, scene in (
            ("jax", J_trace, J_path, lambda a: jnp.asarray(a, jnp.float32), js),
            ("torch", T_trace, T_path, t_, ts)):
        cfg, it0 = _floor_probe(tr, pth, xp, scene, {})
        lane = lambda v: xp(np.broadcast_to(np.asarray(v), (n, 3)))
        ns, ss, tsv = (lane(v) for v in frame)
        po = lane(np.asarray(it0.p[0]))
        mat = np.full(n, int(it0.mat[0]), np.int32)
        mod = J if name == "jax" else T
        found, pi, n_found = mod.sample_sp_probe(
            scene, cfg, po, lane(np.zeros(3)), ns, ss, tsv, ns, xp(r), xp(phi),
            xp(r_max), (jnp.asarray(mat) if name == "jax"
                        else torch.from_numpy(mat)), xp(u_sel))
        out[name] = (np.asarray(found), np.asarray(pi.p), np.asarray(n_found),
                     np.asarray(pi.mat), float(it0.p[0][1]))
    jf, jp, jn, jm, _ = out["jax"]
    tf, tp, tn, tm, floor_y = out["torch"]
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tn, jn)
    assert 0.8 < tf.mean() < 1.0  # the r >= r_max lanes find nothing
    np.testing.assert_allclose(tp[tf], jp[jf], atol=1e-5)
    np.testing.assert_array_equal(tm[tf], jm[jf])
    np.testing.assert_allclose(tp[tf][:, 1], floor_y, atol=1e-2)


# -- twins of tests/test_bssrdf.py ------------------------------------------------

def test_sw_integrates_to_one():
    u = t_(np.random.default_rng(0).uniform(1e-5, 1 - 1e-5, (400000, 2)))
    w = uniform_sample_hemisphere(u)
    for eta in (1.33, 1.5, 2.0):
        est = float((T.sw(w, eta) * w[:, 2]).mean()) * 2 * np.pi
        assert abs(est - 1.0) < 0.02, (eta, est)


def test_moments_continuous_at_one():
    assert abs(float(T.fresnel_moment1(0.999))
               - float(T.fresnel_moment1(1.001))) < 5e-2
    assert 0.0 <= float(T.fresnel_moment1(1 / 1.33)) <= 1.0


def test_disney_sr_normalized():
    r = np.linspace(1e-5, 20.0, 400000)
    big_r = np.asarray([0.8, 0.5, 0.3], np.float32)
    sr = T.disney_sr(t_(r), t_(big_r).expand(len(r), 3),
                     torch.full((len(r), 3), 0.4)).numpy()
    integral = np.trapezoid(sr * (2 * np.pi * r)[:, None], r, axis=0)
    np.testing.assert_allclose(integral, big_r, rtol=5e-3)


def test_disney_sample_matches_pdf():
    d_ch = 0.5
    u = t_(np.random.default_rng(1).uniform(size=400000))
    r = T.disney_sample_sr(u, d_ch).numpy()
    hist, edges = np.histogram(r, bins=40, range=(1e-4, 4.0), density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    grid = np.linspace(1e-4, 4, 2000)
    want = T.disney_pdf_sr(t_(centers), d_ch).numpy() * 2 * np.pi * centers
    want /= np.trapezoid(T.disney_pdf_sr(t_(grid), d_ch).numpy() * 2 * np.pi
                         * grid, grid)
    np.testing.assert_allclose(hist * (r <= 4.0).mean(), want, rtol=0.1,
                               atol=0.02)


def test_disney_s_finite_nonnegative():
    n = 8
    po_ns = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3)
    pi_p = t_(np.random.default_rng(2).normal(size=(n, 3)))
    s = T.disney_s(torch.zeros((n, 3)), po_ns, torch.full((n,), 0.8), pi_p,
                   po_ns, torch.full((n,), 0.7), None, torch.ones((n, 3)))
    assert torch.isfinite(s).all() and (s >= 0).all()


def test_profile_nonnegative(tables):
    assert (tables[1].profile.numpy() >= -1e-6).all()


def test_rho_eff_monotone_and_bounded(tables):
    eff = tables[1].rho_eff.numpy()
    assert (np.diff(eff) >= -1e-6).all() and eff[0] < 1e-4
    assert eff[-1] <= 1.0 + 1e-3


def test_tabulated_pdf_integrates_to_one(tables):
    tt = tables[1]
    r = np.linspace(1e-5, float(tt.radius_samples[-1]), 50000)
    pdf = T.tabulated_pdf_sr(tt, torch.tensor(1.0), torch.full((len(r),), 0.8),
                             t_(r)).numpy()
    est = np.trapezoid(pdf * 2 * np.pi * r, r)
    assert abs(est - 1.0) < 0.03, est


def test_tabulated_sample_matches_pdf(tables):
    tt = tables[1]
    n = 100000
    u = t_(np.random.default_rng(3).uniform(size=n))
    r, valid = T.tabulated_sample_sr(tt, torch.tensor(2.0),
                                     torch.full((n,), 0.8), u)
    assert bool(valid.all())
    r = r.numpy()
    assert (r >= 0).all() and np.isfinite(r).all()
    hist, edges = np.histogram(r, bins=30, range=(1e-4, 3.0), density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    pdf_c = T.tabulated_pdf_sr(tt, torch.tensor(2.0),
                               torch.full((len(centers),), 0.8),
                               t_(centers)).numpy() * 2 * np.pi * centers
    np.testing.assert_allclose(hist * (r <= 3.0).mean(), pdf_c, rtol=0.15,
                               atol=0.03)


def test_sr_pdf_proportionality(tables):
    tt = tables[1]
    r = t_([0.05, 0.1, 0.2])
    sr = T.tabulated_sr(tt, torch.full((3, 1), 1.5), torch.full((3, 1), 0.6),
                        r).numpy()[:, 0]
    pdf = T.tabulated_pdf_sr(tt, torch.tensor(1.5), torch.full((3,), 0.6),
                             r).numpy()
    ratios = sr / np.maximum(pdf, 1e-12)
    np.testing.assert_allclose(ratios, ratios[0], rtol=1e-3)


def test_subsurface_from_diffuse_roundtrip(tables):
    tt = tables[1]
    sigma_a, sigma_s = T.subsurface_from_diffuse(tt, tt.rho_eff[20],
                                                 torch.tensor(1.25))
    rho_got = float(sigma_s / (sigma_a + sigma_s))
    assert abs(rho_got - float(tt.rho_samples[20])) < 2e-2


def test_axis_choice_probabilities():
    n = 100000
    u1 = t_(np.random.default_rng(4).uniform(size=n))
    eye = torch.eye(3)
    _, _, vz, u1r = T.choose_projection_axis(u1, *(eye[i].expand(n, 3)
                                                   for i in range(3)))
    assert abs(float((vz[:, 2] == 1).float().mean()) - 0.5) < 0.01
    assert abs(float((vz[:, 0] == 1).float().mean()) - 0.25) < 0.01
    assert (u1r >= 0).all() and (u1r <= 1.0 + 1e-5).all()


def test_pdf_sp_positive_finite():
    n = 64
    pi_p = t_(np.random.default_rng(5).normal(size=(n, 3)) * 0.3)
    eye = torch.eye(3)
    pdf = T.pdf_sp(lambda ch, r: T.disney_pdf_sr(r, 0.5), torch.zeros((n, 3)),
                   pi_p, eye[2].expand(n, 3), *(eye[i].expand(n, 3)
                                                for i in range(3)))
    assert torch.isfinite(pdf).all() and (pdf > 0).all()


def test_probe_finds_wall():
    """The JAX test's probe around a floor point, on the port alone: nearly
    every probe re-finds the floor, at the sampled radius."""
    _, _, ts, _ = scene_pair("cornell", 16, 16)
    cfg, it0 = _floor_probe(T_trace, T_path, t_, ts, {})
    n = 32
    rng = np.random.default_rng(0)
    eye = torch.eye(3)
    ns, ss, tsv = eye[1].expand(n, 3), eye[0].expand(n, 3), eye[2].expand(n, 3)
    r = t_(rng.uniform(0.01, 0.2, n))
    found, pi, _ = T.sample_sp_probe(
        ts, cfg, it0.p[0].expand(n, 3), torch.zeros((n, 3)), ns, ss, tsv, ns,
        r, t_(rng.uniform(0, 2 * np.pi, n)), torch.full((n,), 0.5),
        torch.full((n,), int(it0.mat[0]), dtype=torch.int32),
        t_(rng.uniform(size=n)))
    found = found.numpy()
    assert found.mean() > 0.9
    pi_p = pi.p.numpy()[found]
    np.testing.assert_allclose(pi_p[:, 1], float(it0.p[0][1]), atol=1e-2)
    dist = np.linalg.norm(pi_p - it0.p[0].numpy(), axis=-1)
    np.testing.assert_allclose(dist, r.numpy()[found], atol=2e-2)
