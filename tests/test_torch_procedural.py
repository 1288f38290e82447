"""The port's procedural textures (ops/procedural.py: Perlin noise, FBm,
Turbulence, the mappings, the FBm / windy / marble textures) against the
JAX package's on the same seeded points, and the twins of
tests/test_procedural.py run on the port (with its float64 scalar oracle).

Tolerance against the JAX functions: the same float32 formulas, XLA
contracting FMAs: values within atol 1e-5 (noise is within [-1.5, 1.5];
FBm sums eight octaves), the permutation tables equal, gradients (autograd
against jax.grad) within rtol 1e-4 + atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnxraytracer_tpu.ops import procedural as J
from gnxraytracer_tpu_torch.ops import procedural as T

from test_procedural import _noise_scalar
from test_torch_interpolation import public_names

ATOL = 1e-5


def pts(n, lo, hi, seed):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


def t_(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_every_public_name_is_ported():
    assert public_names(J) <= public_names(T)


def test_permutation_table_is_the_jax_packages():
    np.testing.assert_array_equal(T._NOISE_PERM, np.asarray(J._NOISE_PERM))


# -- against the JAX package --------------------------------------------------

def test_noise_matches_jax():
    p = pts(4096, -60, 60, 0)
    p[:8] = np.floor(p[:8])  # lattice points, where noise is 0
    close(T.noise(t_(p)), J.noise(jnp.asarray(p)))


@pytest.mark.parametrize("fn", ["fbm", "turbulence"])
def test_octave_sums_match_jax(fn):
    p = pts(1024, -5, 5, 1)
    rng = np.random.default_rng(2)
    # footprints from under a texel to wider than the whole field: octave
    # counts from 8 down to 0, most with a partial octave
    dpdx = (rng.uniform(-1, 1, (1024, 3)) * 10.0 ** rng.uniform(-3, 1, (1024, 1))
            ).astype(np.float32)
    dpdy = np.roll(dpdx, 1, axis=1) * 0.5
    for kw in (dict(), dict(omega=0.6, max_octaves=5)):
        close(getattr(T, fn)(t_(p), **kw), getattr(J, fn)(jnp.asarray(p), **kw),
              atol=2e-5)
        close(getattr(T, fn)(t_(p), t_(dpdx), t_(dpdy), **kw),
              getattr(J, fn)(jnp.asarray(p), jnp.asarray(dpdx),
                             jnp.asarray(dpdy), **kw), atol=2e-5)


def test_mappings_match_jax():
    p = pts(256, -3, 3, 3)
    uv = p[:, :2]
    m = np.asarray([[1.0, 0.2, 0.0, 0.5], [0.0, 0.9, 0.1, -0.2],
                    [0.1, 0.0, 1.1, 0.3], [0.0, 0.0, 0.05, 1.0]], np.float32)
    close(T.uv_mapping(t_(uv), 2.0, 3.0, 0.5, -1.0),
          J.uv_mapping(jnp.asarray(uv), 2.0, 3.0, 0.5, -1.0), atol=1e-6)
    for name in ("spherical_mapping", "cylindrical_mapping",
                 "transform_mapping_3d"):
        for w2t in (None, m):
            close(getattr(T, name)(t_(p), None if w2t is None else t_(w2t)),
                  getattr(J, name)(jnp.asarray(p),
                                   None if w2t is None else jnp.asarray(w2t)),
                  atol=2e-6, rtol=1e-6)
    close(T.planar_mapping(t_(p), (0.3, 0.4, 0.5), (0.0, 1.0, -1.0), 1.0, 2.0),
          J.planar_mapping(jnp.asarray(p), (0.3, 0.4, 0.5), (0.0, 1.0, -1.0),
                           1.0, 2.0), atol=1e-6)


def test_textures_match_jax():
    p = pts(1024, -2, 2, 4)
    m = np.diag([2.0, 1.5, 1.0, 1.0]).astype(np.float32)
    close(T.fbm_texture(t_(p), omega=0.4, octaves=6, world_to_texture=t_(m)),
          J.fbm_texture(jnp.asarray(p), omega=0.4, octaves=6,
                        world_to_texture=jnp.asarray(m)), atol=2e-5)
    close(T.windy_texture(t_(p)), J.windy_texture(jnp.asarray(p)), atol=2e-5)
    close(T.marble_texture(t_(p), scale=2.0, variation=0.5),
          J.marble_texture(jnp.asarray(p), scale=2.0, variation=0.5),
          atol=2e-5)


def test_noise_gradient_matches_jax():
    p = pts(512, -10, 10, 5)
    want = jax.grad(lambda q: J.noise(q).sum())(jnp.asarray(p))
    x = t_(p).requires_grad_()
    T.noise(x).sum().backward()
    close(x.grad, want, atol=1e-5, rtol=1e-4)


def test_fbm_gradient_matches_jax():
    p = pts(256, -3, 3, 6)
    want = jax.grad(lambda q: J.fbm(q, max_octaves=4).sum())(jnp.asarray(p))
    x = t_(p).requires_grad_()
    T.fbm(x, max_octaves=4).sum().backward()
    close(x.grad, want, atol=1e-4, rtol=1e-4)


# -- twins of tests/test_procedural.py ------------------------------------------

def test_noise_matches_scalar_oracle():
    p = np.random.default_rng(7).uniform(-20, 20, (64, 3))
    close(T.noise(t_(p)), [_noise_scalar(*q) for q in p], atol=2e-4)


def test_noise_zero_at_lattice():
    close(T.noise(t_([[0, 0, 0], [1, 2, 3], [-4, 5, -6]])), [0.0] * 3,
          atol=1e-6)


def test_noise_range_bounded():
    assert float(T.noise(t_(pts(4096, -50, 50, 1))).abs().max()) <= 1.5


def test_noise_differentiable():
    x = t_([[0.3, 0.4, 0.5]]).requires_grad_()
    T.noise(x).sum().backward()
    assert torch.isfinite(x.grad).all()


def test_fbm_finite_and_multiscale():
    out = T.fbm(t_(pts(128, -5, 5, 2)), omega=0.5, max_octaves=6).numpy()
    assert np.isfinite(out).all() and out.std() > 0.05


def test_fbm_octave_clamp_by_footprint():
    wide = T.fbm(t_([[1.3, 2.2, 0.7]]), dpdx=t_([[10.0, 0, 0]]),
                 dpdy=t_([[0.0, 10, 0]]))
    assert abs(float(wide[0])) < 1e-6


def test_turbulence_positive_mean():
    out = T.turbulence(t_(pts(512, -5, 5, 3)), max_octaves=6).numpy()
    assert np.isfinite(out).all() and out.mean() > 0.1


def test_uv_mapping_scale_offset():
    close(T.uv_mapping(t_([[0.5, 0.25]]), su=2.0, sv=4.0, du=1.0, dv=-1.0),
          [[2.0, 0.0]], atol=1e-6)


def test_spherical_mapping_poles_equator():
    st = T.spherical_mapping(t_([[0, 0, 1.0], [0, 0, -1.0], [1.0, 0, 0]]))
    close(st[:, 0], [0.0, 1.0, 0.5], atol=1e-6)
    assert abs(float(st[2, 1])) < 1e-6


def test_cylindrical_mapping():
    st = T.cylindrical_mapping(t_([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]))
    close(st[0], [0.0, 0.0], atol=1e-6)
    assert abs(float(st[1, 0]) - 0.25) < 1e-6


def test_planar_mapping():
    close(T.planar_mapping(t_([[3.0, 5.0, 9.0]]), ds=1.0, dt=2.0),
          [[4.0, 7.0]], atol=1e-6)


def test_transform_mapping_identity():
    close(T.transform_mapping_3d(t_([[1.0, 2.0, 3.0]])), [[1, 2, 3]], atol=1e-6)


def test_marble_windy_finite():
    p = t_(pts(32, -2, 2, 5))
    m, w = T.marble_texture(p).numpy(), T.windy_texture(p).numpy()
    assert np.isfinite(m).all() and (m >= 0).all() and np.isfinite(w).all()
