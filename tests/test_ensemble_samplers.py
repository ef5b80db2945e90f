"""Ensemble samplers on analytic targets (SURVEY.md §6; BASELINE
configs 2–3 shrunk to test size)."""

import jax
import jax.numpy as jnp
import numpy as np

from bipymc_tpu import DeMc, DeMcZ, DreamZs
from bipymc_tpu.models.targets import (
    correlated_gaussian, banana, gaussian_mixture)
from bipymc_tpu.utils.diagnostics import gelman_rubin

MEAN = jnp.array([1.0, -1.0])
COV = jnp.array([[1.0, 0.8], [0.8, 1.5]])


def test_demc_gaussian_moments():
    log_prob = correlated_gaussian(MEAN, COV)
    s = DeMc(log_prob, n_chains=16, seed=0)
    s.run_mcmc(3000, MEAN, spread=2.0)
    flat = s.get_chain(discard=1000, flat=True)
    np.testing.assert_allclose(flat.mean(axis=0), MEAN, atol=0.2)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.4)
    af = s.acceptance_fraction
    assert np.all(af > 0.05) and np.all(af < 0.9)


def test_demcz_banana_moments():
    """BASELINE config 2 (shrunk): 8-chain DE-MC-z with snooker on the
    banana posterior."""
    log_prob = banana(b=0.03, sigma1=10.0)
    s = DeMcZ(log_prob, n_chains=8, seed=1)
    s.run_mcmc(6000, jnp.zeros(2), spread=5.0)
    flat = s.get_chain(discard=2500, flat=True)
    assert abs(flat[:, 0].mean()) < 2.5
    assert abs(flat[:, 1].mean()) < 2.5
    assert 50.0 < flat[:, 0].var() < 170.0
    # snooker moves actually fire ~10% of the time
    snk = np.asarray(s._history["snooker"])
    assert 0.03 < snk.mean() < 0.25


def test_demcz_few_chains_high_dim():
    """Archive-based proposals allow N << d (ter Braak & Vrugt 2008)."""
    d = 10
    log_prob = correlated_gaussian(jnp.zeros(d), jnp.eye(d))
    s = DeMcZ(log_prob, n_chains=4, seed=2)
    s.run_mcmc(8000, jnp.zeros(d), spread=2.0)
    flat = s.get_chain(discard=3000, flat=True)
    assert np.all(np.abs(flat.mean(axis=0)) < 0.5)
    assert np.all(np.abs(flat.var(axis=0) - 1.0) < 0.6)


def test_dream_mixture_visits_both_modes():
    """DREAM-zs on a bimodal mixture: both modes populated, R-hat sane."""
    means = jnp.array([[-3.0, -3.0, -3.0, -3.0, -3.0],
                       [3.0, 3.0, 3.0, 3.0, 3.0]])
    log_prob = gaussian_mixture(means, sigma=1.0)
    s = DreamZs(log_prob, n_chains=24, seed=3, burnin_gens=800)
    s.run_mcmc(4000, jnp.zeros(5), spread=6.0)
    flat = s.get_chain(discard=1500, flat=True)
    frac_pos = (flat[:, 0] > 0).mean()
    assert 0.15 < frac_pos < 0.85          # both modes visited
    assert np.all(np.abs(np.abs(flat.mean(axis=0))) < 1.5)


def test_dream_cr_adaptation_updates():
    log_prob = correlated_gaussian(MEAN, COV)
    s = DreamZs(log_prob, n_chains=16, seed=4, burnin_gens=500)
    s.run_mcmc(800, MEAN, spread=2.0)
    p = s.cr_probabilities
    assert p.shape == (3,)
    np.testing.assert_allclose(p.sum(), 1.0, atol=1e-5)
    assert not np.allclose(p, 1.0 / 3.0)   # adaptation actually moved them


def test_dream_outlier_reset():
    """A chain started absurdly far away must be reset during burn-in."""
    d = 2
    log_prob = correlated_gaussian(jnp.zeros(d), jnp.eye(d))
    x0 = np.tile(np.zeros(d, np.float32), (8, 1))
    x0 += np.random.default_rng(0).normal(size=x0.shape).astype(np.float32)
    x0[0] = 400.0                           # pathological outlier
    s = DreamZs(log_prob, n_chains=8, seed=5, burnin_gens=400,
                outlier_interval=10)
    s.run_mcmc(600, jnp.asarray(x0))
    # after burn-in the outlier chain has been pulled back
    assert np.all(np.abs(s.super_chain[0, -1, :]) < 20.0)


def test_ensemble_rhat_convergence():
    log_prob = correlated_gaussian(MEAN, COV)
    s = DreamZs(log_prob, n_chains=16, seed=6)
    s.run_mcmc(3000, MEAN, spread=3.0)
    rhat = gelman_rubin(jnp.asarray(s.super_chain)[:, 1000:, :])
    assert np.all(np.asarray(rhat) < 1.1)


def test_resume_continues():
    log_prob = correlated_gaussian(MEAN, COV)
    s = DreamZs(log_prob, n_chains=8, seed=7)
    s.run_mcmc(200, MEAN, spread=2.0)
    x_after_first = s.super_chain[:, -1, :].copy()
    s.run_mcmc(200, MEAN)
    assert s.super_chain.shape[1] == 400
    np.testing.assert_array_equal(s.super_chain[:, 199, :], x_after_first)


def test_population_dream_moments_and_determinism():
    """Population-DREAM (Vrugt 2009): moments on a correlated Gaussian and
    golden-style fixed-seed reproducibility; archive path untouched."""
    import numpy as np
    import jax.numpy as jnp
    import bipymc_tpu as bp
    from bipymc_tpu.models.targets import correlated_gaussian

    mean = [1.0, -1.0]
    cov = [[2.0, 0.8], [0.8, 1.0]]
    lp = correlated_gaussian(mean, cov)
    s = bp.Dream(lp, n_chains=16, seed=4)
    s.run_mcmc(2500, jnp.zeros(2), spread=1.5)
    flat = s.get_chain(discard=1000, flat=True)
    assert np.abs(flat.mean(0) - np.array(mean)).max() < 0.25
    assert np.abs(np.cov(flat.T) - np.array(cov)).max() < 0.6

    s2 = bp.Dream(lp, n_chains=16, seed=4)
    s2.run_mcmc(2500, jnp.zeros(2), spread=1.5)
    np.testing.assert_array_equal(s.super_chain, s2.super_chain)

    import pytest
    with pytest.raises(ValueError, match="n_chains"):
        bp.Dream(lp, n_chains=4)


def test_reset_reruns_identically():
    """reset() discards run state but keeps compiled runners; the same
    seed then reproduces the identical trajectory from scratch."""
    lp = correlated_gaussian(jnp.array([0.0, 0.0]), jnp.eye(2))
    s = DreamZs(lp, n_chains=8, seed=4)
    s.run_mcmc(120, jnp.zeros(2), spread=2.0)
    first = s.super_chain.copy()
    assert s.snooker_fraction >= 0.0
    s.reset()
    s.run_mcmc(120, jnp.zeros(2), spread=2.0)
    np.testing.assert_array_equal(s.super_chain, first)


def test_continuation_warns_on_ignored_args():
    """Round-2 verdict #6: a continuation run used to silently ignore
    theta_0/cov_est/spread. Now theta_0=None continues silently; passing
    start-only args warns; a fresh sampler without theta_0 raises."""
    import warnings
    import pytest

    lp = correlated_gaussian(jnp.array([0.0, 0.0]), jnp.eye(2))
    s = DreamZs(lp, n_chains=8, seed=5)
    with pytest.raises(ValueError, match="theta_0"):
        s.run_mcmc(10)                     # fresh run needs a start point
    s.run_mcmc(50, jnp.zeros(2), spread=2.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # silent continuation
        s.run_mcmc(50)
    with pytest.warns(UserWarning, match="IGNORED"):
        s.run_mcmc(50, jnp.zeros(2))       # start args on a continuation

    import bipymc_tpu as bp
    r = bp.Dram(lp, n_chains=4, seed=5)
    r.run_mcmc(50, jnp.zeros(2))
    with pytest.warns(UserWarning, match="IGNORED"):
        r.run_mcmc(50, cov_est=jnp.eye(2))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r.run_mcmc(50)


def test_stratified_population_keeps_mode_occupancy():
    """The headline-config contract at test scale: a DREAM-zs population
    initialised stratified-across-modes must HOLD its per-mode proportions
    (the round-2 failure was all 256 chains drifting into one basin from
    an origin-ball init; with stratified overdispersion the population is
    a valid stratified sampler of the equal-weight mixture)."""
    import jax
    from bipymc_tpu.models.targets import (
        gaussian_mixture, stratified_mode_init)
    from bipymc_tpu.utils.diagnostics import mode_occupancy, mode_hops

    means = 5.0 * np.asarray(
        jax.random.normal(jax.random.key(7), (4, 16)))
    lp = gaussian_mixture(means, sigma=1.0)
    x0 = stratified_mode_init(jax.random.key(0), means, 64, var=4.0)

    s = DreamZs(lp, n_chains=64, seed=0, burnin_gens=100)
    s.run_mcmc(400, x0)
    final = jnp.asarray(s.super_chain[:, -1, :])
    occ = np.asarray(mode_occupancy(final, jnp.asarray(means)))
    # at d=16 rare hops do occur (they vanish by d≈30 — the Δlogp≈−d
    # argument), so assert proportions HELD rather
    # than exact counts: every mode keeps ≥75% of its 16-chain share —
    # the round-2 failure mode was [0, 0, 64, 0]
    assert occ.min() >= 12 and occ.max() <= 20, occ
    _, rate = mode_hops(jnp.asarray(s.super_chain), jnp.asarray(means))
    assert float(rate) < 5e-3            # hops are rare even at d=16


def test_jump_full_cr_raises_hop_rate():
    """jump_full_cr=True (full-dimension crossover at γ=1 jump gens) must
    leave default trajectories untouched (goldens pin that) and raise the
    inter-mode hop rate on a separated mixture — measured 6x at d=16."""
    import jax
    from bipymc_tpu.models.targets import (gaussian_mixture,
                                           stratified_mode_init)
    from bipymc_tpu.utils.diagnostics import mode_hops

    means = 5.0 * np.asarray(jax.random.normal(jax.random.key(7), (4, 16)))
    lp = gaussian_mixture(means, sigma=1.0)
    x0 = stratified_mode_init(jax.random.key(0), means, 64, var=4.0)

    rates = {}
    for flag in (False, True):
        s = DreamZs(lp, n_chains=64, seed=0, burnin_gens=100,
                    jump_full_cr=flag)
        s.run_mcmc(1500, x0)
        _, rates[flag] = mode_hops(jnp.asarray(s.super_chain),
                                   jnp.asarray(means))
    assert float(rates[True]) > 2.0 * max(float(rates[False]), 1e-6), rates
