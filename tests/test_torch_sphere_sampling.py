"""The port's sphere sampling (models/sphere_sampling.py) against the JAX
package's on the same seeded inputs, and the twins of
tests/test_sphere_sampling.py run on the port.

Tolerance against the JAX functions: the same float32 formulas, XLA
contracting FMAs and with its own sin/cos/sqrt: points and normals within
atol 1e-5, pdfs within rtol 1e-4 (a pdf near the cone's edge divides by
1 - cos(theta_max)); gradients with respect to the center and the radius
within rtol 1e-3 + atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gnxraytracer_tpu.models import sphere_sampling as J
from gnxraytracer_tpu.utils import math as J_math
from gnxraytracer_tpu_torch.models import sphere_sampling as T
from gnxraytracer_tpu_torch.ops.sampling import uniform_sample_sphere
from gnxraytracer_tpu_torch.utils import math as T_math

from test_torch_interpolation import public_names

CENTER = np.asarray([1.0, 2.0, 3.0], np.float32)


def u2(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(1e-6, 1 - 1e-6, (n, 2)).astype(np.float32)


def t_(a):
    return torch.from_numpy(np.array(a, np.float32))


def lanes(n, ref):
    c = np.broadcast_to(CENTER, (n, 3)).astype(np.float32)
    r = np.full((n,), 0.5, np.float32)
    return c, r, np.broadcast_to(np.asarray(ref, np.float32), (n, 3)).copy()


def close(got, want, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_every_public_name_is_ported():
    assert public_names(J) <= public_names(T)


# -- against the JAX package --------------------------------------------------

def test_spherical_direction_basis_matches_jax():
    rng = np.random.default_rng(0)
    th, ph = rng.uniform(0, np.pi, 64), rng.uniform(0, 2 * np.pi, 64)
    s, c = np.sin(th).astype(np.float32), np.cos(th).astype(np.float32)
    x, y, z = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(3))
    close(T_math.spherical_direction_basis(t_(s), t_(c), t_(ph), t_(x), t_(y),
                                           t_(z)),
          J_math.spherical_direction_basis(*(jnp.asarray(a, jnp.float32)
                                             for a in (s, c, ph, x, y, z))))


def test_samples_match_jax():
    n = 4096
    rng = np.random.default_rng(1)
    # outside (some far, some close to the surface) and inside the sphere
    ref = CENTER + rng.normal(size=(n, 3)) * np.where(
        np.arange(n)[:, None] % 4 == 0, 0.2, 3.0)
    c, r, _ = lanes(n, CENTER)
    ref = ref.astype(np.float32)
    u = u2(n, 2)
    ts = T.sample_uniform(t_(c), t_(r), t_(u))
    js = J.sample_uniform(jnp.asarray(c), jnp.asarray(r), jnp.asarray(u))
    close(ts.p, js.p)
    close(ts.n, js.n)
    close(ts.pdf, js.pdf, rtol=1e-6)
    ts = T.sample_from_ref(t_(c), t_(r), t_(ref), t_(u))
    js = J.sample_from_ref(jnp.asarray(c), jnp.asarray(r), jnp.asarray(ref),
                           jnp.asarray(u))
    inside = np.sum((ref - CENTER) ** 2, -1) <= 0.25
    assert 0 < inside.sum() < n
    close(ts.p, js.p, atol=2e-5)
    close(ts.n, js.n, atol=4e-5)
    close(ts.pdf, js.pdf, rtol=1e-4)
    wi = uniform_sample_sphere(t_(u2(n, 3)))
    close(T.pdf_from_ref(t_(c), t_(r), t_(ref), wi),
          J.pdf_from_ref(jnp.asarray(c), jnp.asarray(r), jnp.asarray(ref),
                         jnp.asarray(wi.numpy())), rtol=1e-4)
    np.testing.assert_allclose(float(T.sphere_area(t_(0.5))),
                               float(J.sphere_area(jnp.float32(0.5))),
                               rtol=1e-7)


def test_gradients_match_jax():
    """d/d(center, radius) of the sampled points' sum and the pdf's sum, from
    outside the sphere.  (From inside, the JAX package's gradient is NaN:
    the cone branch's sqrt at 0 leaks through its where; the port's is
    finite there, and is checked so.)"""
    n = 256
    rng = np.random.default_rng(4)
    v = rng.normal(size=(n, 3))
    v *= rng.uniform(1.0, 6.0, (n, 1)) / np.linalg.norm(v, axis=1, keepdims=True)
    ref = (CENTER + v).astype(np.float32)
    c, r, _ = lanes(n, CENTER)
    u = u2(n, 5)

    def jloss(c, r):
        s = J.sample_from_ref(c, r, jnp.asarray(ref), jnp.asarray(u))
        return s.p.sum() + s.pdf.sum()

    jc, jr = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(c), jnp.asarray(r))
    tc, tr = t_(c).requires_grad_(), t_(r).requires_grad_()
    s = T.sample_from_ref(tc, tr, t_(ref), t_(u))
    (s.p.sum() + s.pdf.sum()).backward()
    close(tc.grad, jc, atol=1e-5, rtol=1e-3)
    close(tr.grad, jr, atol=1e-5, rtol=1e-3)
    inside = t_(CENTER + v * 0.05)
    tc, tr = t_(c).requires_grad_(), t_(r).requires_grad_()
    s = T.sample_from_ref(tc, tr, inside, t_(u))
    (s.p.sum() + s.pdf.sum()).backward()
    assert torch.isfinite(tc.grad).all() and torch.isfinite(tr.grad).all()


# -- twins of tests/test_sphere_sampling.py ---------------------------------------

def test_uniform_on_surface_uniform():
    n = 50000
    c, r, _ = lanes(n, CENTER)
    s = T.sample_uniform(t_(c), t_(r), t_(u2(n, 0)))
    p = s.p.numpy()
    np.testing.assert_allclose(np.linalg.norm(p - CENTER, axis=-1), 0.5,
                               atol=1e-5)
    np.testing.assert_allclose(p.mean(0), CENTER, atol=0.01)
    octant = ((p - CENTER) > 0).astype(int)
    counts = np.bincount(octant @ np.asarray([1, 2, 4]), minlength=8) / n
    np.testing.assert_allclose(counts, 1 / 8, atol=0.01)
    close(s.pdf, np.full(n, 1.0 / (4 * np.pi * 0.25)), atol=0, rtol=1e-6)


def test_uniform_normal_outward():
    c, r, _ = lanes(128, CENTER)
    s = T.sample_uniform(t_(c), t_(r), t_(u2(128, 1)))
    assert (torch.sum(s.n * (s.p - t_(CENTER)), -1) > 0).all()


def test_cone_points_visible_hemisphere():
    n = 20000
    c, r, ref = lanes(n, [1.0, 2.0, 6.0])
    s = T.sample_from_ref(t_(c), t_(r), t_(ref), t_(u2(n, 2)))
    p = s.p.numpy()
    np.testing.assert_allclose(np.linalg.norm(p - CENTER, axis=-1), 0.5,
                               atol=1e-4)
    assert (np.sum(s.n.numpy() * (ref - p), -1) > -1e-4).mean() > 0.999


def test_cone_pdf_constant_inside_zero_outside():
    n = 200000
    c, r, ref = lanes(n, [1.0, 2.0, 6.0])
    wi = uniform_sample_sphere(t_(u2(n, 3)))
    pdf = T.pdf_from_ref(t_(c), t_(r), t_(ref), wi).numpy()
    dc = np.linalg.norm(ref[0] - CENTER)
    cos_max = np.sqrt(1.0 - (0.5 / dc) ** 2)
    want = 1.0 / (2 * np.pi * (1.0 - cos_max))
    in_cone = wi.numpy() @ ((CENTER - ref[0]) / dc) >= cos_max
    np.testing.assert_allclose(pdf[in_cone], want, rtol=1e-4)
    np.testing.assert_allclose(pdf[~in_cone], 0.0, atol=1e-7)


def test_sample_pdf_consistent():
    n = 4096
    c, r, ref = lanes(n, [0.0, 0.0, 0.0])
    s = T.sample_from_ref(t_(c), t_(r), t_(ref), t_(u2(n, 4)))
    wi = s.p - t_(ref)
    wi = wi / torch.linalg.norm(wi, dim=-1, keepdim=True)
    close(T.pdf_from_ref(t_(c), t_(r), t_(ref), wi), s.pdf.numpy(), atol=0,
          rtol=5e-3)


def test_inside_falls_back_to_area():
    n = 50000
    c, r, ref = lanes(n, CENTER + np.asarray([0.1, 0.0, 0.0], np.float32))
    s = T.sample_from_ref(t_(c), t_(r), t_(ref), t_(u2(n, 5)))
    np.testing.assert_allclose(np.linalg.norm(s.p.numpy() - CENTER, axis=-1),
                               0.5, atol=1e-4)
    assert torch.isfinite(s.pdf).all() and (s.pdf > 0).all()
    wi = uniform_sample_sphere(t_(u2(n, 6)))
    est = float(T.pdf_from_ref(t_(c), t_(r), t_(ref), wi).mean()) * 4 * np.pi
    assert abs(est - 1.0) < 0.05, est
