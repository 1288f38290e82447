"""The PyTorch port's counter-based RNG, Sobol' sampler and Halton sampler
against the JAX package: bit-equal.  The port holds 32-bit words in int64 tensors (PyTorch
has no uint32 arithmetic), so every hash, shift and float conversion is
checked for exact equality, not closeness."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnxraytracer_tpu.ops import lds as J_lds
from gnxraytracer_tpu.ops import rng as J_rng
from gnxraytracer_tpu.ops import samplers as J_smp
from gnxraytracer_tpu.ops import sobol as J_sobol
from gnxraytracer_tpu_torch.ops import lds as T_lds
from gnxraytracer_tpu_torch.ops import rng as T_rng
from gnxraytracer_tpu_torch.ops import samplers as T_smp
from gnxraytracer_tpu_torch.ops import sobol as T_sobol

N = 4096


def _words(seed, n=N):
    """u32 test words incl. the edge values of the wrap-around arithmetic."""
    r = np.random.default_rng(seed)
    w = r.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    w[:6] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xFFFFFF7F]
    return w


def _t(words):
    return torch.from_numpy(words.astype(np.int64))


def _same_bits(t, j):
    """torch u32-in-int64 vs jax uint32: equal as integers."""
    t = t.numpy()
    assert t.min() >= 0 and t.max() < (1 << 32)
    np.testing.assert_array_equal(t.astype(np.uint32), np.asarray(j))


def _same_float_bits(t, j):
    a = t.numpy()
    b = np.asarray(j)
    assert a.dtype == np.float32 and b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_pcg_hash_bit_equal():
    w = _words(0)
    _same_bits(T_rng._pcg_hash(_t(w)), J_rng._pcg_hash(jnp.asarray(w)))


def test_hash_combine_negative_int32_bit_equal():
    # int32 counters (incl. negative) reinterpret as uint32 on both sides
    r = np.random.default_rng(1)
    a = r.integers(-(1 << 31), 1 << 31, size=N, dtype=np.int64).astype(np.int32)
    b = r.integers(0, 1 << 20, size=N, dtype=np.int64).astype(np.int32)
    _same_bits(T_rng.hash_combine(torch.from_numpy(a), torch.from_numpy(b), 7),
               J_rng.hash_combine(jnp.asarray(a), jnp.asarray(b), 7))


@pytest.mark.parametrize("seed", [0, 12345])
def test_uniform_float_bit_equal(seed):
    r = np.random.default_rng(2)
    pix = r.integers(0, 250000, size=N).astype(np.int32)
    smp = r.integers(0, 4096, size=N).astype(np.int32)
    for dim in (0, 5, 77):
        _same_float_bits(
            T_rng.uniform_float(torch.from_numpy(pix), torch.from_numpy(smp),
                                dim, seed),
            J_rng.uniform_float(jnp.asarray(pix), jnp.asarray(smp), dim, seed))


def test_pcg32_host_stream_equal():
    a, b = T_lds.PCG32(), J_lds.PCG32()
    assert [a.uniform_u32() for _ in range(64)] == \
        [b.uniform_u32() for _ in range(64)]


def test_reverse_bits_bit_equal():
    w = _words(3)
    _same_bits(T_lds.reverse_bits_32(_t(w)),
               J_lds.reverse_bits_32(jnp.asarray(w)))


def test_sobol_matrices_generated_equal():
    """The port's own GF(2) generator (not the shared cache file) builds the
    JAX package's matrices."""
    np.testing.assert_array_equal(T_sobol.build_matrices(64),
                                  J_sobol.sobol_matrices()[:64])


@pytest.mark.parametrize("dim", [0, 1, 13, 76])
def test_sobol_u32_bit_equal(dim):
    idx = _words(4)
    idx[6:70] = np.arange(64)
    _same_bits(T_sobol.sobol_u32_static(dim, _t(idx)),
               J_sobol.sobol_u32_static(dim, jnp.asarray(idx)))


def test_owen_scramble_bit_equal():
    v, s = _words(5), _words(6)
    _same_bits(T_sobol.owen_scramble(_t(v), _t(s)),
               J_sobol.owen_scramble(jnp.asarray(v), jnp.asarray(s)))


def test_to_unit_float_bit_equal():
    # full 32-bit values: a signed-int32 conversion would go negative, and
    # values above 2^24 need round-to-nearest
    w = _words(7)
    _same_float_bits(T_sobol.to_unit_float(_t(w)),
                     J_sobol.to_unit_float(jnp.asarray(w)))


def _lanes(w=50, h=40, spp=8):
    hw = w * h
    pix = np.tile(np.arange(hw, dtype=np.int32), spp)
    smp = np.repeat(np.arange(spp, dtype=np.int32) + 3, hw)
    return pix, smp


def _samplers(kind):
    if kind == "sobol":
        return (T_smp.make_sobol_sampler(8, seed=2, device="cpu"),
                J_smp.make_sobol_sampler(8, seed=2))
    return (T_smp.make_random_sampler(8, seed=9, device="cpu"),
            J_smp.make_random_sampler(8, seed=9))


@pytest.mark.parametrize("kind", ["sobol", "random"])
@pytest.mark.parametrize("base", [0, 5, 37])
def test_sample_bounce_dims_bit_equal(kind, base):
    pix, smp = _lanes()
    ts, js = _samplers(kind)
    a = T_smp.sample_bounce_dims(ts, torch.from_numpy(pix),
                                 torch.from_numpy(smp), base, 8, 78)
    b = J_smp.sample_bounce_dims(js, jnp.asarray(pix), jnp.asarray(smp),
                                 base, 8, 78)
    _same_float_bits(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


@pytest.mark.parametrize("kind", ["sobol", "random"])
def test_sample_all_dims_and_sample_dim_bit_equal(kind):
    pix, smp = _lanes(16, 16, 4)
    ts, js = _samplers(kind)
    tp, tsm = torch.from_numpy(pix), torch.from_numpy(smp)
    a = T_smp.sample_all_dims(ts, tp, tsm, 21)
    _same_float_bits(a, J_smp.sample_all_dims(js, jnp.asarray(pix),
                                              jnp.asarray(smp), 21))
    _same_float_bits(T_smp.sample_dim(ts, tp, tsm, 11),
                     J_smp.sample_dim(js, jnp.asarray(pix), jnp.asarray(smp), 11))
    np.testing.assert_array_equal(
        T_smp.sample_dim(ts, tp, tsm, 11).numpy(), a[:, 11].numpy())


@pytest.mark.parametrize("kind", ["sobol", "random"])
@pytest.mark.parametrize("pixel_filter", ["box", "gaussian"])
def test_camera_sample(kind, pixel_filter):
    pix, smp = _lanes()
    ts, js = _samplers(kind)
    a = T_smp.camera_sample(ts, torch.from_numpy(pix), torch.from_numpy(smp),
                            50, pixel_filter)
    b = J_smp.camera_sample(js, jnp.asarray(pix), jnp.asarray(smp), 50,
                            pixel_filter)
    for x, y in zip(a, b):
        if pixel_filter == "box":
            _same_float_bits(x, y)
        else:
            # erfinv is each library's own polynomial: close, not bit-equal,
            # and ill-conditioned in the truncated tails (|2u-1| -> 1), where
            # one f32 ulp of u moves the offset by ~1e-4 of a pixel
            err = np.abs(x.numpy() - np.asarray(y))
            assert np.mean(err <= 1e-5 + 1e-5 * np.abs(np.asarray(y))) >= 0.999
            assert err.max() < 1e-3


def test_halton_raises():
    """A Halton sampler is made now; what it still refuses, as in the JAX
    package, is dims computed inside the bounce loop (it needs a static prime
    base per dim, so integrators precompute its matrix)."""
    ts = T_smp.make_halton_sampler(4, 8, 8, device="cpu")
    assert ts.kind == "halton" and not T_smp.supports_inloop_dims(ts)
    z = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="in-loop dims"):
        T_smp.sample_bounce_dims(ts, z, z, 5, 8, 13)


# -- the Halton sampler -----------------------------------------------------------

HALTON_FILMS = [(50, 40), (500, 500), (100, 37)]


def _halton(w, h, spp=8):
    return (T_smp.make_halton_sampler(spp, w, h, device="cpu"),
            J_smp.make_halton_sampler(spp, w, h))


def _film_lanes(w, h, n=3000, spp=8, seed=11):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, w * h, n).astype(np.int32),
            rs.randint(0, spp, n).astype(np.int32))


@pytest.mark.parametrize("wh", HALTON_FILMS)
def test_halton_sampler_tables_equal(wh):
    ts, js = _halton(*wh)
    for f in ("pixel_offset", "primes", "prime_sums", "perms"):
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        np.testing.assert_array_equal(a, b, err_msg=f)
        assert a.shape == b.shape
    assert ts.primes.dtype == ts.prime_sums.dtype == ts.perms.dtype == torch.int32
    assert (ts.kind, ts.spp, ts.seed, ts.stride, ts.exp2, ts.scale3) == \
        (js.kind, js.spp, js.seed, js.stride, js.exp2, js.scale3)


@pytest.mark.parametrize("wh", HALTON_FILMS)
def test_halton_global_index_bit_equal(wh):
    ts, js = _halton(*wh)
    pix, smp = _film_lanes(*wh)
    smp[:8] = [0, 1, 2 ** 20, 2 ** 24, 7, 4095, 2 ** 22 + 5, 3]  # wraps at 2^32
    _same_bits(T_smp.global_index(ts, torch.from_numpy(pix), torch.from_numpy(smp)),
               J_smp.global_index(js, jnp.asarray(pix), jnp.asarray(smp)))


@pytest.mark.parametrize("wh", HALTON_FILMS)
def test_halton_sample_all_dims_bit_equal(wh):
    """40 dims: camera, and four bounces of the path integrator's layout."""
    ts, js = _halton(*wh)
    pix, smp = _film_lanes(*wh)
    a = T_smp.sample_all_dims(ts, torch.from_numpy(pix), torch.from_numpy(smp), 40)
    _same_float_bits(a, J_smp.sample_all_dims(js, jnp.asarray(pix),
                                              jnp.asarray(smp), 40))
    assert tuple(a.shape) == (len(pix), 40)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


def test_halton_static_dim_fn_bit_equal():
    ts, js = _halton(50, 40)
    pix, smp = _film_lanes(50, 40)
    tcol = T_smp.static_dim_fn(ts, torch.from_numpy(pix), torch.from_numpy(smp))
    jcol = J_smp.static_dim_fn(js, jnp.asarray(pix), jnp.asarray(smp))
    all_dims = T_smp.sample_all_dims(ts, torch.from_numpy(pix),
                                     torch.from_numpy(smp), 40)
    for d in range(40):
        _same_float_bits(tcol(d), jcol(d))
        assert torch.equal(tcol(d), all_dims[:, d])


@pytest.mark.parametrize("dim", [0, 1, 2, 7, 39, 999, 1500])
def test_halton_sample_dim_generic_path_bit_equal(dim):
    """sample_dim's table-driven path (bases and permutations gathered from
    the device tables); dims past the table clip to the last prime."""
    ts, js = _halton(50, 40)
    pix, smp = _film_lanes(50, 40, n=1000)
    a = T_smp.sample_dim(ts, torch.from_numpy(pix), torch.from_numpy(smp), dim)
    _same_float_bits(a, J_smp.sample_dim(js, jnp.asarray(pix),
                                         jnp.asarray(smp), dim))
    if dim < 40:  # the static path gives the same column
        col = T_smp.static_dim_fn(ts, torch.from_numpy(pix),
                                  torch.from_numpy(smp))
        assert torch.equal(a, col(dim))


@pytest.mark.parametrize("sampler", ["sobol", "random"])
def test_static_dim_fn_of_inloop_samplers(sampler):
    ts, js = _samplers(sampler)
    pix, smp = _lanes(16, 16, 2)
    tcol = T_smp.static_dim_fn(ts, torch.from_numpy(pix), torch.from_numpy(smp))
    jcol = J_smp.static_dim_fn(js, jnp.asarray(pix), jnp.asarray(smp))
    for d in (0, 4, 23):
        _same_float_bits(tcol(d), jcol(d))


@pytest.mark.parametrize("pixel_filter", ["box", "gaussian"])
def test_halton_camera_sample(pixel_filter):
    ts, js = _halton(50, 40)
    pix, smp = _lanes()
    a = T_smp.camera_sample(ts, torch.from_numpy(pix), torch.from_numpy(smp),
                            50, pixel_filter)
    b = J_smp.camera_sample(js, jnp.asarray(pix), jnp.asarray(smp), 50,
                            pixel_filter)
    for x, y in zip(a, b):
        if pixel_filter == "box":
            _same_float_bits(x, y)
        else:  # erfinv: see test_camera_sample
            err = np.abs(x.numpy() - np.asarray(y))
            assert np.mean(err <= 1e-5 + 1e-5 * np.abs(np.asarray(y))) >= 0.999
            assert err.max() < 1e-3
    # dims 0-1 of the Halton sampler place the sample in its own pixel
    px = a[0].numpy()
    if pixel_filter == "box":
        assert (np.floor(px[:, 0]) == pix % 50).all()
        assert (np.floor(px[:, 1]) == pix // 50).all()
