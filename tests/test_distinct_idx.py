"""``distinct_from_bits`` ≡ a NumPy transcription of the shift method,
bit for bit, and its draws are distinct and in range."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bipymc_tpu.ensemble.indices import distinct_from_bits


def _numpy_reference(bits, k, n, exclude=None):
    """Sequential shift method on host ints: the t-th draw is uniform
    over n − t (less the excluded index) values, shifted past the
    already-taken values in increasing order."""
    out = np.empty((bits.shape[0], k), np.int64)
    for c, row in enumerate(np.asarray(bits, np.uint64)):
        taken = [] if exclude is None else [int(exclude[c])]
        avail = n - len(taken)
        for t in range(k):
            r = int(row[t] & 0x7FFFFFFF) % (avail - t)
            for v in sorted(taken):
                r += r >= v
            out[c, t] = r
            taken.append(r)
    return out


@pytest.mark.parametrize("n_chains,k,n", [(256, 6, 2048), (16, 3, 11),
                                          (1000, 9, 37)])
def test_matches_reference(n_chains, k, n):
    bits = jax.random.bits(jax.random.key(0), (n_chains, k), jnp.uint32)
    out = jax.vmap(lambda b: distinct_from_bits(b, k, n))(bits)
    np.testing.assert_array_equal(np.asarray(out),
                                  _numpy_reference(np.asarray(bits), k, n))


def test_matches_reference_with_exclude():
    n_chains, k, n = 64, 2, 64
    bits = jax.random.bits(jax.random.key(1), (n_chains, k), jnp.uint32)
    gid = jnp.arange(n_chains, dtype=jnp.int32)
    out = np.asarray(jax.vmap(
        lambda b, i: distinct_from_bits(b, k, n, exclude=i))(bits, gid))
    np.testing.assert_array_equal(
        out, _numpy_reference(np.asarray(bits), k, n, np.asarray(gid)))
    assert not np.any(out == np.asarray(gid)[:, None])


def test_traced_fill():
    """n (archive fill) is traced inside the scan — must stay jittable."""
    bits = jax.random.bits(jax.random.key(2), (32, 6), jnp.uint32)

    @jax.jit
    def f(n):
        return jax.vmap(lambda b: distinct_from_bits(b, 6, n))(bits)

    for n in (7, 100, 8192):
        out = np.asarray(f(n))
        np.testing.assert_array_equal(
            out, _numpy_reference(np.asarray(bits), 6, n))
        assert out.min() >= 0 and out.max() < n
        assert all(len(set(row)) == 6 for row in out)
