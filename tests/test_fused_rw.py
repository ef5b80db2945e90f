"""Fused multi-step RW engine (ops/fused_rw_chunk.py + samplers/rw_fused.py)
vs the per-step engine.

The fused engine consumes the identical bits stream (step_key on the
global t, per-chain fold on the local chain index, one [2d+2]-word block
per (step, chain) — samplers/rw.py ``_default_draws``) and replays the AM
Welford/refresh updates bit-exactly outside the kernel, so accept
decisions must agree exactly and positions to float re-association (the
stage-2 displacement is computed as (1/√κ)(L z₂) instead of ((L/√κ) z₂);
Metropolis, which has no stage 2, is bit-exact in interpret mode).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import bipymc_tpu as bp
from bipymc_tpu.core.scan import run_scan_thinned
from bipymc_tpu.models.targets import correlated_gaussian
from bipymc_tpu.samplers import rw
from bipymc_tpu.samplers.rw_fused import (check_rw_fusable,
                                          make_rw_chunk_runner)

MEAN = jnp.array([1.0, -2.0], jnp.float32)
COV = jnp.array([[2.0, 0.9], [0.9, 1.0]], jnp.float32)


@pytest.fixture(scope="module")
def lp():
    return correlated_gaussian(MEAN, COV)


def _reference_run(lp, cfg, state, key, n_steps, n_chains):
    step = rw.make_step(lp, cfg)

    def batched_step(state, key, t):
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jnp.arange(n_chains))
        return jax.vmap(step, in_axes=(0, 0, None))(state, keys, t)

    return run_scan_thinned(
        batched_step, state, key, n_steps=n_steps, thin=1,
        collect_fn=lambda s, i: {"x": s.theta, "logp": i.logp,
                                 "accepted": i.accepted}, t0=0)


@pytest.mark.parametrize("name,cfg,K", [
    ("mh", rw.metropolis_config(), 50),
    ("dr", rw.dr_metropolis_config(), 50),
    ("dram", rw.dram_config(t0=60, adapt_interval=20), 20),
])
def test_fused_rw_matches_per_step(lp, name, cfg, K):
    n, d, T = 4, 2, 200
    theta0 = jnp.asarray(
        np.random.default_rng(0).standard_normal((n, d)), jnp.float32)
    state = jax.vmap(lambda t: rw.init(t, lp, jnp.eye(d) * 0.5))(theta0)
    key = jax.random.key(3)

    ref_state, ref_hist = _reference_run(lp, cfg, state, key, T, n)
    runner = make_rw_chunk_runner(lp, cfg, n, chunk_steps=K)
    f_state, f_hist = runner(state, key, T, 0)

    # accept DECISIONS exact (same bits, same comparisons)
    np.testing.assert_array_equal(np.asarray(ref_hist["accepted"]),
                                  np.asarray(f_hist["accepted"]))
    if name == "mh":     # no stage-2 re-association → bit-exact
        np.testing.assert_array_equal(np.asarray(ref_hist["x"]),
                                      np.asarray(f_hist["x"]))
    np.testing.assert_allclose(np.asarray(ref_hist["x"]),
                               np.asarray(f_hist["x"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ref_hist["logp"]),
                               np.asarray(f_hist["logp"]),
                               rtol=1e-5, atol=1e-6)
    # AM adaptation replay: the refreshed factor matches
    np.testing.assert_allclose(np.asarray(ref_state.chol),
                               np.asarray(f_state.chol),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ref_state.m2),
                               np.asarray(f_state.m2),
                               rtol=1e-5, atol=1e-5)


def test_fused_api_run_and_continuation(lp):
    """Dram(fused=True): segment split (alignment + fused + remainder)
    over a non-multiple-of-K run, then an unaligned continuation —
    same accept decisions and matching chains throughout."""
    kw = dict(seed=0, n_chains=4, t0=60, adapt_interval=20)
    a = bp.Dram(lp, **kw)
    b = bp.Dram(lp, fused=True, **kw)
    for s in (a, b):
        s.run_mcmc(130, jnp.zeros(2), cov_est=jnp.eye(2) * 0.5)
        s.run_mcmc(130)
    np.testing.assert_array_equal(np.asarray(a.acceptance_fraction),
                                  np.asarray(b.acceptance_fraction))
    np.testing.assert_allclose(np.asarray(a.get_chain()),
                               np.asarray(b.get_chain()),
                               rtol=1e-4, atol=1e-5)


def test_fused_api_run_until_matches(lp):
    kw = dict(seed=1, n_chains=4, t0=60, adapt_interval=20)
    until_kw = dict(rhat_tol=1.1, chunk=40, max_chunks=50,
                    warmup_chunks=2)
    ra = bp.Dram(lp, **kw).run_mcmc_until(
        jnp.zeros(2), cov_est=jnp.eye(2) * 0.5, **until_kw)
    rb = bp.Dram(lp, fused=True, **kw).run_mcmc_until(
        jnp.zeros(2), cov_est=jnp.eye(2) * 0.5, **until_kw)
    assert int(ra["steps"]) == int(rb["steps"])
    np.testing.assert_allclose(ra["rhat"], rb["rhat"], rtol=1e-3)


def test_fused_rejects_rank1_mode(lp):
    with pytest.raises(ValueError, match="adapt_interval"):
        check_rw_fusable(rw.dram_config(adapt_interval=1))
    with pytest.raises(ValueError, match="adapt_interval"):
        bp.Dram(lp, fused=True, adapt_interval=1)


def test_fused_runner_validates_alignment(lp):
    cfg = rw.dram_config(adapt_interval=20)
    runner = make_rw_chunk_runner(lp, cfg, 2)
    state = jax.vmap(lambda t: rw.init(t, lp, jnp.eye(2)))(
        jnp.zeros((2, 2)))
    with pytest.raises(ValueError, match="multiple"):
        runner(state, jax.random.key(0), 30, 0)
    with pytest.raises(ValueError, match="aligned"):
        runner(state, jax.random.key(0), 20, 10)


def test_nonfinite_target_rejects_identically_both_engines():
    """A target with a +inf region: sanitizing the
    accept BIT alone left log_a1 = 0 inside the Green-Mira denominator
    so stage 2 accepted y2 almost surely. Both engines must sanitize
    LOG_A1 itself, reject every non-finite proposal, agree with each
    other, and never land a chain in the +inf region."""
    def lp(theta):
        base = -0.5 * jnp.sum(theta ** 2)
        # +inf spike over a quadrant the RW proposals regularly enter
        return jnp.where((theta[0] > 0.4) & (theta[1] > 0.4),
                         jnp.inf, base)

    kw = dict(seed=3, n_chains=4, t0=1000, adapt_interval=20)
    a = bp.Dram(lp, **kw)
    b = bp.Dram(lp, fused=True, **kw)
    for s in (a, b):
        s.run_mcmc(200, jnp.zeros(2), cov_est=jnp.eye(2) * 0.5,
                   spread=0.1)
    xa, xb = np.asarray(a.get_chain()), np.asarray(b.get_chain())
    np.testing.assert_array_equal(np.asarray(a.acceptance_fraction),
                                  np.asarray(b.acceptance_fraction))
    np.testing.assert_allclose(xa, xb, rtol=1e-4, atol=1e-5)
    # no kept position may sit inside the +inf region
    assert not np.any((xa[..., 0] > 0.4) & (xa[..., 1] > 0.4))
    assert np.all(np.isfinite(xa))
