"""Affine-invariant (stretch-move) ensemble sampler."""

import numpy as np
import jax.numpy as jnp
import pytest

import bipymc_tpu as bp
from bipymc_tpu.models.targets import correlated_gaussian, banana
from bipymc_tpu.parallel.mesh import chain_mesh

MEAN = np.array([1.0, -1.0])
COV = np.array([[2.0, 0.8], [0.8, 1.0]])


def test_moments_on_correlated_gaussian():
    s = bp.EnsembleSampler(correlated_gaussian(MEAN, COV), n_chains=32,
                           seed=0)
    s.run_mcmc(3000, jnp.zeros(2), spread=1.5)
    flat = s.get_chain(discard=1000, flat=True)
    assert np.abs(flat.mean(0) - MEAN).max() < 0.2
    assert np.abs(np.cov(flat.T) - COV).max() < 0.5
    # affine invariance shows as healthy acceptance on correlated targets
    assert 0.1 < s.acceptance_fraction.mean() < 0.9


def test_banana_and_rhat_stop():
    s = bp.EnsembleSampler(banana(), n_chains=32, seed=1)
    info = s.run_mcmc_until(jnp.zeros(2), rhat_tol=1.1, chunk=200,
                            max_chunks=60, spread=3.0)
    assert info["rhat"].max() < 1.1


def test_mesh_equals_vmap():
    lp = correlated_gaussian(MEAN, COV)
    a = bp.EnsembleSampler(lp, n_chains=16, seed=3)
    a.run_mcmc(200, jnp.zeros(2), spread=1.0)
    b = bp.EnsembleSampler(lp, n_chains=16, seed=3, mesh=chain_mesh())
    b.run_mcmc(200, jnp.zeros(2), spread=1.0)
    np.testing.assert_array_equal(a.super_chain, b.super_chain)


def test_odd_walker_count_raises():
    with pytest.raises(ValueError, match="even"):
        bp.EnsembleSampler(banana(), n_chains=7).run_mcmc(10, jnp.zeros(2))


def test_walk_move_moments_on_correlated_gaussian():
    """move='walk' (emcee WalkMove, s = full complementary half):
    recovers mean/cov of a correlated Gaussian, with healthy
    acceptance (the proposal adapts to the target's anisotropy)."""
    s = bp.EnsembleSampler(correlated_gaussian(MEAN, COV), n_chains=32,
                           seed=5, move="walk")
    s.run_mcmc(3000, jnp.zeros(2), spread=1.5)
    flat = s.get_chain(discard=1000, flat=True)
    assert np.abs(flat.mean(0) - MEAN).max() < 0.2
    assert np.abs(np.cov(flat.T) - COV).max() < 0.5
    assert 0.1 < s.acceptance_fraction.mean() < 0.9


def test_walk_move_mesh_equals_vmap():
    """Walk-move RNG folds by global walker index: the mesh and vmap
    paths consume identical streams -> bit-identical trajectories."""
    lp = correlated_gaussian(MEAN, COV)
    a = bp.EnsembleSampler(lp, n_chains=16, seed=6, move="walk")
    a.run_mcmc(200, jnp.zeros(2), spread=1.0)
    b = bp.EnsembleSampler(lp, n_chains=16, seed=6, move="walk",
                           mesh=chain_mesh())
    b.run_mcmc(200, jnp.zeros(2), spread=1.0)
    np.testing.assert_array_equal(a.super_chain, b.super_chain)


def test_walk_move_rank_deficient_half_survives():
    """n/2 < d walkers: the complementary covariance is singular; the
    jittered Cholesky must keep the chain finite (degrading to a tiny
    isotropic kick), not NaN it."""
    d = 6
    lp = correlated_gaussian(np.zeros(d), np.eye(d))
    s = bp.EnsembleSampler(lp, n_chains=8, seed=7, move="walk")
    s.run_mcmc(100, jnp.zeros(d), spread=0.5)
    assert np.all(np.isfinite(s.super_chain))


def test_walk_move_rejects_fused_and_unknown_move():
    # the ensemble sampler has no fused engine (per-generation only)
    with pytest.raises(TypeError, match="fused"):
        bp.EnsembleSampler(banana(), n_chains=16, move="walk", fused=True)
    with pytest.raises(ValueError, match="unknown ensemble move"):
        bp.EnsembleSampler(banana(), n_chains=16,
                           move="kde").run_mcmc(10, jnp.zeros(2))
