"""Distributed path: shard_map over 8 fake CPU devices must reproduce the
single-device vmap path bit-for-bit (SURVEY.md §6: the accelerator
equivalent of the reference's mpiexec smoke tests; key-folding by global chain
index makes
the two paths share RNG streams)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bipymc_tpu import DeMc, DreamZs
from bipymc_tpu.models.targets import correlated_gaussian
from bipymc_tpu.parallel.mesh import chain_mesh

MEAN = jnp.array([1.0, -1.0])
COV = jnp.array([[1.0, 0.8], [0.8, 1.5]])

needs_devices = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multiple (fake) devices")


@needs_devices
def test_dream_mesh_equals_vmap():
    lp = correlated_gaussian(MEAN, COV)
    mesh = chain_mesh()
    a = DreamZs(lp, n_chains=16, seed=9, mesh=mesh).run_mcmc(
        200, MEAN, spread=2.0)
    b = DreamZs(lp, n_chains=16, seed=9).run_mcmc(200, MEAN, spread=2.0)
    np.testing.assert_array_equal(a.super_chain, b.super_chain)
    np.testing.assert_array_equal(a.acceptance_fraction,
                                  b.acceptance_fraction)


@needs_devices
def test_demc_mesh_equals_vmap():
    lp = correlated_gaussian(MEAN, COV)
    mesh = chain_mesh()
    a = DeMc(lp, n_chains=16, seed=4, mesh=mesh).run_mcmc(
        200, MEAN, spread=2.0)
    b = DeMc(lp, n_chains=16, seed=4).run_mcmc(200, MEAN, spread=2.0)
    np.testing.assert_array_equal(a.super_chain, b.super_chain)


@needs_devices
def test_dream_mesh_close_vmap_large():
    """Equivalence contract at a size where compiler rounding shows up
    (docs/design.md §3): at d=16/N=64 the shard program's fusion/FMA
    choices differ from the vmap program's by ~1 ulp per step, so exact
    equality is luck — but accept decisions and move types must agree
    exactly over hundreds of generations (a flip would swing positions
    macroscopically), and positions must stay within tight tolerance.
    Also regression-pins the gather-then-reduce rule for the burn-in CR
    statistics: psum-of-partials there diverged at O(eps*N) and fed back
    into proposals."""
    from bipymc_tpu.models.targets import (baseline_config3_means,
                                           gaussian_mixture,
                                           stratified_mode_init)
    from bipymc_tpu.parallel.pool import ChainPool
    from bipymc_tpu.samplers import dream
    from bipymc_tpu.utils.init import var_ball

    D, N, T = 16, 64, 200
    means = baseline_config3_means(D)
    lp = gaussian_mixture(means, sigma=1.0)
    th0 = stratified_mode_init(jax.random.key(1), means, N, var=4.0)
    cfg = dream.DreamConfig(n_chains=N, burnin_gens=100)
    kz, krun = jax.random.split(jax.random.key(0))
    z0 = var_ball(kz, jnp.var(th0, axis=0), N, center=jnp.mean(th0, axis=0))
    state0 = dream.init(th0, lp, cfg, archive_capacity=512, z0=z0)

    def collect(s, info):
        return {"x": s.x, "acc": info.accepted, "snk": info.snooker,
                "logp": info.logp}

    def run(mesh):
        pool = ChainPool(
            step_factory=lambda a: dream.make_step(lp, cfg, axis_name=a),
            sharded_fields=("x", "logp", "logp_sum"),
            mesh=mesh, collect_fn=collect)
        return pool.run(state0, krun, T)[1]

    hv, hm = run(None), run(chain_mesh())
    np.testing.assert_array_equal(np.asarray(hv["acc"]),
                                  np.asarray(hm["acc"]))
    np.testing.assert_array_equal(np.asarray(hv["snk"]),
                                  np.asarray(hm["snk"]))
    np.testing.assert_allclose(np.asarray(hv["x"]), np.asarray(hm["x"]),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(hv["logp"]),
                               np.asarray(hm["logp"]), atol=1e-3)


@needs_devices
def test_mesh_indivisible_chains_raises():
    lp = correlated_gaussian(MEAN, COV)
    with pytest.raises(ValueError, match="divisible"):
        DreamZs(lp, n_chains=10, seed=0, mesh=chain_mesh()).run_mcmc(
            10, MEAN)


def test_chain_count_invariance():
    """Chain i's trajectory must not depend on how many chains run
    (RNG folds by global chain index — SURVEY.md §9 design stance)."""
    lp = correlated_gaussian(MEAN, COV)
    x0 = jnp.tile(MEAN, (16, 1))
    a = DeMc(lp, n_chains=16, seed=2).run_mcmc(50, x0)
    # NOTE: DE-MC proposals mix chains, so exact invariance holds only for
    # the single-chain family; check that here instead.
    from bipymc_tpu import Metropolis
    m8 = Metropolis(lp, seed=3, n_chains=8).run_mcmc(100, x0[:8])
    m4 = Metropolis(lp, seed=3, n_chains=4).run_mcmc(100, x0[:4])
    np.testing.assert_array_equal(m8.super_chain[:4], m4.super_chain)


def test_pt_mesh_matches_vmap():
    """ParallelTempering with a chain mesh (round 3): the ladder is
    replicated per shard, chains shard (kernel@1), and trajectories must
    be bit-identical to the single-device vmap run — including the
    round-trip counter (a cross-shard psum) and swap-rate accounting."""
    from bipymc_tpu import ParallelTempering
    from bipymc_tpu.models.targets import gaussian_mixture

    lp = gaussian_mixture([[-3.0, 0.0], [3.0, 0.0]], sigma=1.0)
    kw = dict(n_temps=4, n_chains=16, beta_min=0.1, swap_interval=5,
              kind="dram", seed=3)
    a = ParallelTempering(lp, mesh=chain_mesh(), **kw)
    a.run_mcmc(400, jnp.zeros(2), cov_est=jnp.eye(2) * 0.5)
    b = ParallelTempering(lp, **kw)
    b.run_mcmc(400, jnp.zeros(2), cov_est=jnp.eye(2) * 0.5)
    np.testing.assert_array_equal(a.super_chain, b.super_chain)
    np.testing.assert_array_equal(a.swap_rates, b.swap_rates)
    assert a.round_trips == b.round_trips


def test_mesh_collect_fn_chain_reduced_leaf_rejected():
    """A chain-reduced history leaf can't be sharded, and the pool can't
    prove it replicated (collect_fn sees no mesh axis) — it must fail
    with a clear message, not a shard_map rank error (or, worse,
    silently return one shard's value)."""
    import pytest
    from bipymc_tpu.samplers import rw
    cfg = rw.RwConfig(adapt=False, delayed=False)
    lp = correlated_gaussian(jnp.zeros(2), jnp.eye(2))
    x0 = jnp.zeros((8, 2), jnp.float32)
    state = jax.vmap(lambda x: rw.init(x, lp, jnp.eye(2)))(x0)
    from bipymc_tpu.parallel.pool import ChainPool
    base = rw.make_step(lp, cfg)

    def batched(state, key, t):
        n = state.theta.shape[0]
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jnp.arange(n))
        return jax.vmap(base, in_axes=(0, 0, None))(state, keys, t)

    pool = ChainPool(step_factory=lambda axis: batched,
                     sharded_fields=("theta",), mesh=chain_mesh())
    with pytest.raises(ValueError, match="chain axis"):
        pool.run(state, jax.random.key(0), 4,
                 collect_fn=lambda s, i: {"m": jnp.mean(i.logp)})
