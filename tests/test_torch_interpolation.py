"""The port's Catmull-Rom and Fourier interpolation (ops/interpolation.py)
against the JAX package's on the same seeded inputs, and the twins of
tests/test_interpolation.py run on the port.

Tolerance against the JAX functions: both compute the same float32 formulas
in the same order, but XLA on the CPU contracts FMAs and has its own
sin/cos; the values agree within rtol 1e-5 + atol 1e-6.  The
Newton-bisection solutions (16 fixed steps on both sides): >= 85% of the
lanes within rtol 1e-5 + atol 1e-5, all within rtol 5e-4 + atol 5e-4
(the density values with them).  The wider bound is the method's,
not the port's: a step that lands on the root exactly (value 0) moves the
upper end of the bracket onto it and the next step bisects away from it, so
such a lane ends up to 3.8e-4 from the root after 16 steps, in either
package (ROADMAP C16), and which lanes land exactly differs with the last
ulp.  Gradients (autograd against jax.grad) within rtol 1e-4 + atol 1e-6."""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnxraytracer_tpu.ops import interpolation as J
from gnxraytracer_tpu_torch.ops import interpolation as T

X = np.asarray([0.0, 0.5, 1.2, 2.0, 3.5, 5.0], np.float32)
F = np.asarray([1.0, 2.0, 1.5, 3.0, 0.5, 1.0], np.float32)
RTOL, ATOL = 1e-5, 1e-6


def t_(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got),
                               np.asarray(want), rtol=rtol, atol=atol)


def close_solution(got, want):
    """Newton-bisection solutions: see the module's docstring."""
    got, want = got.detach().numpy(), np.asarray(want)
    err = np.abs(got - want)
    assert (err <= 1e-5 + 1e-5 * np.abs(want)).mean() >= 0.85
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def public_names(module):
    tree = ast.parse(inspect.getsource(module))
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def test_every_public_name_is_ported():
    assert public_names(J) <= public_names(T)


# -- against the JAX package --------------------------------------------------

def test_weights_and_eval_match_jax():
    q = np.random.default_rng(0).uniform(-0.5, 5.5, 257).astype(np.float32)
    q[:6] = X  # the nodes themselves
    jw = J.catmull_rom_weights(jnp.asarray(X), jnp.asarray(q))
    tw = T.catmull_rom_weights(t_(X), t_(q))
    np.testing.assert_array_equal(tw[0].numpy(), np.asarray(jw[0]))
    np.testing.assert_array_equal(tw[5].numpy(), np.asarray(jw[5]))
    for a, b in zip(tw[1:5], jw[1:5]):
        close(a, b)
    close(T.catmull_rom_eval(t_(X), t_(F), t_(q)),
          J.catmull_rom_eval(jnp.asarray(X), jnp.asarray(F), jnp.asarray(q)))


def test_integrate_matches_jax():
    jc, jt = J.integrate_catmull_rom(jnp.asarray(X), jnp.asarray(F))
    tc, tt = T.integrate_catmull_rom(t_(X), t_(F))
    close(tc, jc)
    close(tt, jt)


def test_sample_matches_jax():
    u = np.random.default_rng(1).uniform(size=4096).astype(np.float32)
    jcdf, _ = J.integrate_catmull_rom(jnp.asarray(X), jnp.asarray(F))
    tcdf, _ = T.integrate_catmull_rom(t_(X), t_(F))
    got = T.sample_catmull_rom(t_(X), t_(F), tcdf, t_(u))
    want = J.sample_catmull_rom(jnp.asarray(X), jnp.asarray(F), jcdf,
                                jnp.asarray(u))
    for a, b in zip(got, want):
        close_solution(a, b)


def _table_2d():
    rho = np.asarray([0.0, 0.5, 1.0], np.float32)
    values = np.stack([F * 0.5, F, F * 2.0]).astype(np.float32)
    cdf = np.stack([np.asarray(J.integrate_catmull_rom(jnp.asarray(X),
                                                       jnp.asarray(v))[0])
                    for v in values])
    return rho, values, cdf


def test_sample_2d_matches_jax():
    rho, values, cdf = _table_2d()
    rng = np.random.default_rng(2)
    alpha = rng.uniform(-0.1, 1.1, 2048).astype(np.float32)  # some outside
    u = rng.uniform(size=2048).astype(np.float32)
    got = T.sample_catmull_rom_2d(t_(rho), t_(X), t_(values), t_(cdf),
                                  t_(alpha), t_(u))
    want = J.sample_catmull_rom_2d(*(jnp.asarray(a) for a in
                                     (rho, X, values, cdf, alpha, u)))
    for a, b in zip(got, want):
        close_solution(a, b)
    assert (got[1].numpy() == 0).any() and (got[1].numpy() > 0).any()


def test_invert_matches_jax():
    x = np.asarray([0.0, 1.0, 2.0, 3.0, 4.0], np.float32)
    vals = np.asarray([0.0, 0.3, 1.0, 2.5, 4.0], np.float32)
    u = np.random.default_rng(3).uniform(-0.5, 4.5, 1024).astype(np.float32)
    close_solution(T.invert_catmull_rom(t_(x), t_(vals), t_(u)),
                   J.invert_catmull_rom(jnp.asarray(x), jnp.asarray(vals),
                                        jnp.asarray(u)))


def test_fourier_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(-0.2, 1.0, (64, 8)).astype(np.float32)
    a[:, 0] = rng.uniform(1.5, 2.5, 64)  # a0 dominates: a density
    cos_phi = np.cos(rng.uniform(0, 2 * np.pi, 64)).astype(np.float32)
    close(T.fourier_eval(t_(a), t_(cos_phi)),
          J.fourier_eval(jnp.asarray(a), jnp.asarray(cos_phi)), atol=1e-5)
    u = rng.uniform(size=64).astype(np.float32)
    for g, w in zip(T.sample_fourier(t_(a), t_(u)),
                    J.sample_fourier(jnp.asarray(a), jnp.asarray(u))):
        close_solution(g, w)


def test_eval_gradient_matches_jax():
    """d/d(values, x) of a sum of spline values: autograd against jax.grad."""
    q = np.random.default_rng(5).uniform(0.05, 4.95, 64).astype(np.float32)
    jg = jax.grad(lambda f, x: J.catmull_rom_eval(jnp.asarray(X), f, x).sum(),
                  argnums=(0, 1))(jnp.asarray(F), jnp.asarray(q))
    f, x = t_(F).requires_grad_(), t_(q).requires_grad_()
    T.catmull_rom_eval(t_(X), f, x).sum().backward()
    close(f.grad, jg[0], rtol=1e-4)
    close(x.grad, jg[1], rtol=1e-4, atol=1e-5)


# -- twins of tests/test_interpolation.py ---------------------------------------

def test_exact_at_nodes():
    close(T.catmull_rom_eval(t_(X), t_(F), t_(X)), F, atol=1e-5)


def test_zero_outside_range():
    close(T.catmull_rom_eval(t_(X), t_(F), t_([-1.0, 6.0])), [0.0, 0.0])


def test_smooth_between_nodes():
    v = T.catmull_rom_eval(t_(X), t_(F), torch.linspace(0.0, 5.0, 101)).numpy()
    assert np.isfinite(v).all() and (np.abs(np.diff(v)) < 1.0).all()


def test_integral_matches_quadrature():
    cdf, total = T.integrate_catmull_rom(t_(X), t_(F))
    q = np.linspace(0.0, 5.0, 20001).astype(np.float32)
    v = T.catmull_rom_eval(t_(X), t_(F), t_(q)).numpy()
    np.testing.assert_allclose(float(total), np.trapezoid(v, q), rtol=1e-3)
    for i in (1, 3):
        m = q <= X[i]
        np.testing.assert_allclose(float(cdf[i]), np.trapezoid(v[m], q[m]),
                                   rtol=5e-3, atol=1e-3)


def test_sample_distribution():
    cdf, total = T.integrate_catmull_rom(t_(X), t_(F))
    u = np.random.default_rng(0).uniform(size=200000).astype(np.float32)
    xs, _, pdf = T.sample_catmull_rom(t_(X), t_(F), cdf, t_(u))
    xs = xs.numpy()
    assert (xs >= 0).all() and (xs <= 5.0).all()
    hist, edges = np.histogram(xs, bins=25, range=(0, 5), density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    want = T.catmull_rom_eval(t_(X), t_(F), t_(centers)).numpy() / float(total)
    np.testing.assert_allclose(hist, want, rtol=0.12, atol=0.01)
    want_pdf = T.catmull_rom_eval(t_(X), t_(F), t_(xs[:100])).numpy() / float(total)
    np.testing.assert_allclose(pdf.numpy()[:100], want_pdf, rtol=2e-2, atol=1e-3)


def test_sample_2d_matches_1d_at_node_row():
    rho, values, _ = _table_2d()
    cdfs = [T.integrate_catmull_rom(t_(X), t_(v))[0] for v in values]
    u = t_(np.random.default_rng(1).uniform(size=512))
    xs2, _, pdf2 = T.sample_catmull_rom_2d(t_(rho), t_(X), t_(values),
                                           torch.stack(cdfs),
                                           torch.full((512,), 0.5), u)
    xs1, _, pdf1 = T.sample_catmull_rom(t_(X), t_(F), cdfs[1], u)
    close(xs2, xs1.numpy(), rtol=0, atol=1e-3)
    close(pdf2, pdf1.numpy(), rtol=1e-2, atol=1e-4)


def test_invert_roundtrip():
    x = t_([0.0, 1.0, 2.0, 3.0, 4.0])
    vals = t_([0.0, 0.3, 1.0, 2.5, 4.0])
    q = torch.linspace(0.05, 3.95, 41)
    y = T.catmull_rom_eval(x, vals, q)
    close(T.invert_catmull_rom(x, vals, y), q.numpy(), rtol=0, atol=2e-3)


def test_invert_clamps_out_of_range():
    x = t_([0.0, 1.0, 2.0])
    close(T.invert_catmull_rom(x, x.clone(), t_([-1.0, 5.0])), [0.0, 2.0])


def test_fourier_eval_matches_direct_sum():
    rng = np.random.default_rng(2)
    a = rng.uniform(-0.2, 1.0, (8,)).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, 64)
    got = T.fourier_eval(t_(a), t_(np.cos(phi)))
    want = sum(float(a[k]) * np.cos(k * phi) for k in range(8))
    close(got, want, rtol=0, atol=1e-4)


def test_sample_fourier_histogram():
    a = np.asarray([1.0, 0.6, 0.0, 0.1], np.float32)
    n = 200000
    u = t_(np.random.default_rng(3).uniform(size=n))
    phi, _, _ = T.sample_fourier(t_(a).expand(n, 4), u)
    phi = phi.numpy()
    assert (phi >= 0).all() and (phi <= 2 * np.pi + 1e-5).all()
    hist, edges = np.histogram(phi, bins=24, range=(0, 2 * np.pi), density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    dens = sum(float(a[k]) * np.cos(k * centers) for k in range(4))
    np.testing.assert_allclose(hist, dens / (2 * np.pi * float(a[0])),
                               rtol=0.1, atol=0.01)


@pytest.mark.parametrize("fn", ["catmull_rom_eval", "invert_catmull_rom"])
def test_runs_on_the_arguments_device(fn):
    """No tensor is made on another device than the arguments' (a meta
    device stands in for the card here)."""
    x = torch.tensor([0.0, 1.0, 2.0, 3.0], device="meta")
    out = getattr(T, fn)(x, x, torch.empty(5, device="meta"))
    assert out.device.type == "meta" and out.shape == (5,)
