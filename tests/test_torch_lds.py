"""The port's low-discrepancy module (ops/lds.py) against the JAX package's:
the same numpy inputs through both.  Tables byte-equal; every radical
inverse bit-equal (atol 0): the port keeps uint32 words in int64 tensors and
the JAX package's order of float32 operations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnxraytracer_tpu.ops import lds as J_lds
from gnxraytracer_tpu_torch import native as T_native
from gnxraytracer_tpu_torch.kernels import build as T_build
from gnxraytracer_tpu_torch.ops import lds as T_lds

BASES = (3, 5, 389, 7919)


def indices():
    """uint32 sample indices up to 2^31, with the edge values."""
    rs = np.random.RandomState(0)
    return np.concatenate([
        rs.randint(0, 2 ** 31, 4000), rs.randint(0, 2 ** 12, 500),
        [0, 1, 2, 3, 2 ** 27, 2 ** 31 - 1]]).astype(np.uint32)


def tt(idx):
    return torch.from_numpy(idx.astype(np.int64))


def perm_of(base):
    i = list(J_lds.primes()).index(base)
    off = int(J_lds.prime_sums()[i])
    return off, J_lds.radical_inverse_permutations()[off:off + base]


def test_prime_tables_equal():
    np.testing.assert_array_equal(T_lds.primes(), J_lds.primes())
    np.testing.assert_array_equal(T_lds.prime_sums(), J_lds.prime_sums())
    assert T_lds.primes().dtype == J_lds.primes().dtype
    assert T_lds.prime_sums().dtype == J_lds.prime_sums().dtype
    assert T_lds.primes()[-1] == 7919 and len(T_lds.primes()) == 1000


def test_permutation_table_byte_equal():
    """The cached table (native build where g++ is there, else the Python
    shuffle), in the port's own build directory."""
    ours, theirs = (T_lds.radical_inverse_permutations(),
                    J_lds.radical_inverse_permutations())
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    assert ours.tobytes() == theirs.tobytes()
    assert len(ours) == int(T_lds.primes().astype(np.int64).sum())
    import os

    assert os.path.exists(os.path.join(T_build.BUILD_DIR,
                                       "halton_perms_v1.npy"))


def test_permutation_table_native_build():
    try:
        ours = T_native.halton_permutations(T_lds.primes())
    except (OSError, FileNotFoundError) as e:
        pytest.skip(f"no C++ compiler for the native library: {e}")
    assert ours.tobytes() == J_lds.radical_inverse_permutations().tobytes()


def test_permutation_table_python_build():
    """The path without g++, on the first 50 primes."""
    p = T_lds.primes()[:50]
    ours = T_lds.permutations_python(p)
    n = int(p.astype(np.int64).sum())
    assert ours.dtype == np.int32 and ours.shape == (n,)
    np.testing.assert_array_equal(
        ours, J_lds.radical_inverse_permutations()[:n])
    # each slice is a permutation of its digits
    off = 0
    for b in p:
        assert sorted(ours[off:off + b].tolist()) == list(range(b))
        off += b


@pytest.mark.parametrize("wh", [(64, 64), (500, 500), (100, 37)])
def test_halton_pixel_offsets_equal(wh):
    ours, meta = T_lds.halton_pixel_offsets(*wh)
    theirs, jmeta = J_lds.halton_pixel_offsets(*wh)
    assert ours.dtype == theirs.dtype == np.uint32
    assert ours.shape == (wh[1], wh[0])
    np.testing.assert_array_equal(ours, theirs)
    assert meta == jmeta


def test_mult_inverse():
    for a, n in ((128, 243), (243, 128), (64, 81), (7, 10)):
        assert T_lds._mult_inverse(a, n) == J_lds._mult_inverse(a, n)
        assert (a * T_lds._mult_inverse(a, n)) % n == 1


def test_radical_inverse_base2_bit_equal():
    idx = indices()
    ours = T_lds.radical_inverse_base2(tt(idx)).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(J_lds.radical_inverse_base2(idx)))
    assert ours.dtype == np.float32 and (ours >= 0).all() and (ours < 1).all()


@pytest.mark.parametrize("base", BASES)
def test_radical_inverse_static_bit_equal(base):
    idx = indices()
    ours = T_lds.radical_inverse_static(base, tt(idx)).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(J_lds.radical_inverse_static(base, idx)))
    assert (ours < 1).all()


@pytest.mark.parametrize("base", BASES)
def test_radical_inverse_traced_base_bit_equal(base):
    idx = indices()
    np.testing.assert_array_equal(
        T_lds.radical_inverse(base, tt(idx)).numpy(),
        np.asarray(J_lds.radical_inverse(base, idx)))


@pytest.mark.parametrize("base", BASES)
def test_scrambled_radical_inverse_static_bit_equal(base):
    idx = indices()
    _, perm = perm_of(base)
    ours = T_lds.scrambled_radical_inverse_static(base, tt(idx), perm).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(J_lds.scrambled_radical_inverse_static(base, idx, perm)))
    assert (ours < 1).all()


@pytest.mark.parametrize("base", BASES)
def test_scrambled_radical_inverse_bit_equal(base):
    idx = indices()
    off, _ = perm_of(base)
    table = J_lds.radical_inverse_permutations()
    ours = T_lds.scrambled_radical_inverse(
        base, tt(idx), torch.from_numpy(table), off).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(J_lds.scrambled_radical_inverse(
            base, idx, jnp.asarray(table), off)))


def test_scrambled_radical_inverse_per_lane_bases():
    """One base and permutation offset per lane, as the generic Halton
    dimension path uses them."""
    idx = indices()[:1024]
    rs = np.random.RandomState(5)
    dims = rs.randint(2, 1000, len(idx))
    bases = J_lds.primes()[dims]
    offs = J_lds.prime_sums()[dims].astype(np.int32)
    table = J_lds.radical_inverse_permutations()
    ours = T_lds.scrambled_radical_inverse(
        torch.from_numpy(bases), tt(idx), torch.from_numpy(table),
        torch.from_numpy(offs)).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(J_lds.scrambled_radical_inverse(
            jnp.asarray(bases), idx, jnp.asarray(table), jnp.asarray(offs))))
    np.testing.assert_array_equal(
        T_lds.radical_inverse(torch.from_numpy(bases), tt(idx)).numpy(),
        np.asarray(J_lds.radical_inverse(jnp.asarray(bases), idx)))


def test_pcg32_stream_equal():
    a, b = T_lds.PCG32(), J_lds.PCG32()
    assert [a.uniform_u32() for _ in range(64)] == \
        [b.uniform_u32() for _ in range(64)]
    assert [a.uniform_u32_bounded(7919) for _ in range(64)] == \
        [b.uniform_u32_bounded(7919) for _ in range(64)]
