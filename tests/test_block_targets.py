"""Padded block targets (models/targets.py ``*_block``) ≡ the scalar
targets, and the fused kernels run them like the scalar wrapper.

A block target takes [BC, Dp] rows zero-padded from d to Dp =
next_pow2(d) columns and returns [BC, 1]; padding must not move the
value.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bipymc_tpu.core.scan import run_scan
from bipymc_tpu.models.targets import (banana, banana_block,
                                       correlated_gaussian,
                                       correlated_gaussian_block,
                                       gaussian_mixture,
                                       gaussian_mixture_block)
from bipymc_tpu.ops.route import next_pow2


def _rows(n, d, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.normal(size=(n, d))).astype(np.float32)


def _check(lp, blk, x, rtol=1e-5, atol=1e-4):
    n, d = x.shape
    xp = np.zeros((n, next_pow2(d)), np.float32)
    xp[:, :d] = x
    got = np.asarray(blk(jnp.asarray(xp)))
    assert got.shape == (n, 1)
    want = np.asarray(jax.vmap(lp)(jnp.asarray(x)))
    np.testing.assert_allclose(got[:, 0], want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("k,weights", [(1, None), (3, None), (4, None),
                                       (3, [0.2, 0.5, 0.3])])
@pytest.mark.parametrize("d", [1, 5, 100])
def test_gaussian_mixture_block(d, k, weights):
    means = _rows(k, d, seed=d + k)
    _check(gaussian_mixture(means, sigma=1.3, weights=weights),
           gaussian_mixture_block(means, sigma=1.3, weights=weights),
           _rows(16, d, seed=7) + means[0])


@pytest.mark.parametrize("n", [4, 32])
@pytest.mark.parametrize("d", [2, 5, 16, 100])
def test_correlated_gaussian_block(d, n):
    """Both quadratic-form routes: broadcast-and-reduce below 16 rows or
    columns, one HIGHEST-precision product at or above."""
    rng = np.random.default_rng(d)
    a = rng.normal(size=(d, d))
    cov = a @ a.T / d + np.eye(d)
    mean = rng.normal(size=d)
    _check(correlated_gaussian(mean, cov),
           correlated_gaussian_block(mean, cov), _rows(n, d, seed=n),
           rtol=1e-4)


@pytest.mark.parametrize("d", [2, 3, 5])
def test_banana_block(d):
    _check(banana(d=d), banana_block(d=d), _rows(16, d, seed=d, scale=5.0))


@pytest.mark.parametrize("d", [2, 5, 100])
def test_fused_dream_with_block_target_matches_per_generation(d):
    """The DREAM kernel (interpret mode) driven by the padded block form
    follows the per-generation engine on the scalar form over a chunk:
    identical accept decisions, positions to float re-association."""
    from bipymc_tpu.samplers import dream
    from bipymc_tpu.samplers.dream_fused import make_chunk_runner
    n = 8
    means = np.zeros((2, d), np.float32)
    means[1, 0] = 4.0
    lp = gaussian_mixture(means)
    cfg = dream.DreamConfig(n_chains=n, burnin_gens=0, archive_thin=5,
                            p_snooker=0.3)
    kx, kz, kr = jax.random.split(jax.random.key(d), 3)
    state = dream.init(2.0 * jax.random.normal(kx, (n, d)), lp, cfg,
                       archive_capacity=128,
                       z0=2.0 * jax.random.normal(kz, (16, d)))
    step = dream.make_step(lp, cfg)
    _, ref = run_scan(step, state, kr, 5,
                      collect_fn=lambda s, i: {"x": s.x,
                                               "acc": i.accepted})
    runner = make_chunk_runner(lp, cfg,
                               log_prob_block=gaussian_mixture_block(means))
    _, hist = runner(state, kr, 5, 0)
    np.testing.assert_array_equal(np.asarray(hist["accepted"]),
                                  np.asarray(ref["acc"]))
    np.testing.assert_allclose(np.asarray(hist["x"]), np.asarray(ref["x"]),
                               rtol=2e-5, atol=2e-5)
