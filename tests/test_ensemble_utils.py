"""Distinct-index sampling and archive ring buffer (SURVEY.md §9 hard
parts: bias-free r1≠r2≠i sampling; static-shape archive with fill mask)."""

import jax
import jax.numpy as jnp
import numpy as np

from bipymc_tpu.ensemble.indices import sample_distinct
from bipymc_tpu.ensemble.archive import (
    archive_init, archive_append, archive_sample)


def test_sample_distinct_no_collisions_and_range():
    keys = jax.random.split(jax.random.key(0), 3000)
    draws = jax.vmap(lambda k: sample_distinct(k, 3, 10))(keys)
    draws = np.asarray(draws)
    assert draws.min() >= 0 and draws.max() <= 9
    for row in draws:
        assert len(set(row.tolist())) == 3


def test_sample_distinct_respects_exclude():
    keys = jax.random.split(jax.random.key(1), 3000)
    draws = jax.vmap(lambda k: sample_distinct(k, 2, 8, exclude=5))(keys)
    assert not np.any(np.asarray(draws) == 5)


def test_sample_distinct_uniform_marginals():
    """Each value must appear with equal probability (bias-free draw)."""
    n, k, trials = 7, 2, 40000
    keys = jax.random.split(jax.random.key(2), trials)
    draws = np.asarray(jax.vmap(lambda kk: sample_distinct(kk, k, n))(keys))
    counts = np.bincount(draws.ravel(), minlength=n)
    expected = trials * k / n
    # 5-sigma band for a binomial count
    sigma = np.sqrt(trials * k * (1 / n) * (1 - 1 / n))
    assert np.all(np.abs(counts - expected) < 5 * sigma)


def test_sample_distinct_traced_n():
    """fill count is traced in the archive path — must still be exact."""
    def f(n):
        return sample_distinct(jax.random.key(3), 3, n)
    out = jax.jit(f)(jnp.int32(4))
    assert len(set(np.asarray(out).tolist())) == 3
    assert np.asarray(out).max() <= 3


def test_archive_ring_buffer_wraparound():
    z0 = jnp.arange(6, dtype=jnp.float32).reshape(3, 2)
    ar = archive_init(z0, capacity=4)
    assert int(ar.fill) == 3 and int(ar.head) == 3
    ar = archive_append(ar, jnp.array([[10.0, 11.0], [12.0, 13.0]]))
    assert int(ar.fill) == 4 and int(ar.head) == 1
    # slot 3 then wrap to slot 0
    np.testing.assert_array_equal(np.asarray(ar.buf[3]), [10.0, 11.0])
    np.testing.assert_array_equal(np.asarray(ar.buf[0]), [12.0, 13.0])


def test_archive_sample_only_filled_prefix():
    z0 = jnp.arange(8, dtype=jnp.float32).reshape(4, 2)
    ar = archive_init(z0, capacity=100)  # 96 slots are zeros
    keys = jax.random.split(jax.random.key(4), 500)
    rows = jax.vmap(lambda k: archive_sample(ar, k, 2))(keys)
    # every sampled row must be one of the 4 filled rows
    rows = np.asarray(rows).reshape(-1, 2)
    valid = {tuple(r) for r in np.asarray(z0)}
    for r in rows:
        assert tuple(r) in valid


# --- sample_distinct_topk: the accelerator-native (Gumbel/top-k) variant ---

def test_topk_no_collisions_range_and_exclude():
    from bipymc_tpu.ensemble.indices import sample_distinct_topk
    keys = jax.random.split(jax.random.key(4), 3000)
    draws = np.asarray(jax.vmap(
        lambda k: sample_distinct_topk(k, 3, 10, capacity=16))(keys))
    assert draws.min() >= 0 and draws.max() <= 9
    for row in draws:
        assert len(set(row.tolist())) == 3
    draws = np.asarray(jax.vmap(
        lambda k: sample_distinct_topk(k, 2, 8, capacity=8, exclude=5))(keys))
    assert not np.any(draws == 5)


def test_topk_uniform_marginals_per_position():
    """Uniform subset AND exchangeable order: every value equally likely
    at every output position (top-k rank order of iid uniforms is a
    uniform permutation)."""
    from bipymc_tpu.ensemble.indices import sample_distinct_topk
    n, k, trials = 7, 2, 40000
    keys = jax.random.split(jax.random.key(5), trials)
    draws = np.asarray(jax.vmap(
        lambda kk: sample_distinct_topk(kk, k, n, capacity=8))(keys))
    sigma = np.sqrt(trials * (1 / n) * (1 - 1 / n))
    for pos in range(k):
        counts = np.bincount(draws[:, pos], minlength=n)
        assert np.all(np.abs(counts - trials / n) < 5 * sigma), pos


def test_topk_traced_n():
    from bipymc_tpu.ensemble.indices import sample_distinct_topk
    out = jax.jit(lambda n: sample_distinct_topk(
        jax.random.key(6), 3, n, capacity=32))(jnp.int32(4))
    out = np.asarray(out)
    assert len(set(out.tolist())) == 3 and out.max() <= 3
