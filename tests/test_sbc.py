"""Simulation-based calibration harness (utils/sbc.py): rank uniformity
on a conjugate normal-normal model for the fixed-kernel RW family and
HMC, and — the money test — detection of a deliberately biased sampler
(tempered posterior) that moment checks would pass near-enough."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bipymc_tpu.utils.sbc import sbc_ranks, sbc_uniformity

D = 2
SIGMA = 1.0
N_OBS = 3
# posterior variance = 1/(1 + n/σ²) = 1/4 per dim


def prior_sample(key):
    return jax.random.normal(key, (D,))


def simulate(key, theta):
    return theta + SIGMA * jax.random.normal(key, (N_OBS, D))


def log_post(theta, y):
    return (-0.5 * jnp.sum(theta**2)
            - 0.5 * jnp.sum((y - theta) ** 2) / SIGMA**2)


def _tempered(beta):
    def lp(theta, y):
        return beta * log_post(theta, y)
    return lp


def test_dram_ranks_uniform():
    cov = (2.38**2 / D) * 0.25 * jnp.eye(D)   # posterior-scaled proposal
    ranks = sbc_ranks(prior_sample, simulate, log_post, sampler="dram",
                      n_repl=256, n_draws=127, thin=8, burn=300,
                      cov=cov, seed=0)
    assert ranks.shape == (256, D)
    r = np.asarray(ranks)
    assert r.min() >= 0 and r.max() <= 127
    stat, thresh = sbc_uniformity(ranks, n_bins=8, n_draws=127)
    assert np.all(stat < thresh), (stat, thresh)


def test_hmc_ranks_uniform():
    ranks = sbc_ranks(prior_sample, simulate, log_post, sampler="hmc",
                      n_repl=256, n_draws=127, thin=2, burn=300,
                      step_size=0.25, n_leapfrog=8, seed=1)
    stat, thresh = sbc_uniformity(ranks, n_bins=8, n_draws=127)
    assert np.all(stat < thresh), (stat, thresh)


def test_adaptive_dram_ranks_uniform():
    # the PRACTICAL headline kernel: Haario adaptation live through the
    # ranked draws, starting from a deliberately mis-scaled covariance
    # (4x the posterior's) that adaptation must fix — the
    # diminishing-adaptation chain stays calibrated
    ranks = sbc_ranks(prior_sample, simulate, log_post,
                      sampler="dram-adaptive", n_repl=256, n_draws=127,
                      thin=8, burn=400, cov=jnp.eye(D), seed=4)
    stat, thresh = sbc_uniformity(ranks, n_bins=8, n_draws=127)
    assert np.all(stat < thresh), (stat, thresh)


def test_demcz_ranks_uniform():
    # the flagship ensemble family: an 8-chain DE-MC-z population per
    # replication (adaptation off, archive growing — the PRACTICAL
    # sampler), ranks from chain 0
    ranks = sbc_ranks(prior_sample, simulate, log_post, sampler="demcz",
                      n_repl=128, n_draws=63, thin=10, burn=400,
                      n_chains=8, spread=0.5, seed=0)
    stat, thresh = sbc_uniformity(ranks, n_bins=8, n_draws=63)
    assert np.all(stat < thresh), (stat, thresh)


def test_detects_tempered_posterior():
    # sampling p(θ|y)^0.5 instead of p(θ|y): the sampled variance is 2×
    # the true posterior's (same mean!), θ̃ ranks pile in the middle,
    # and the χ² statistic explodes — exactly the class of bias a
    # moment-on-the-mean test would shrug at. Power note (measured):
    # at K=256 the statistic is ~(49, 34) for β=0.5 but only ~(17, 12)
    # for β=0.7 against the 24.5 threshold — milder biases need more
    # replications, which is what the vmapped harness makes cheap.
    cov = (2.38**2 / D) * 0.25 * jnp.eye(D)
    ranks = sbc_ranks(prior_sample, simulate, _tempered(0.5),
                      sampler="dram", n_repl=256, n_draws=127, thin=8,
                      burn=300, cov=cov, seed=2)
    stat, thresh = sbc_uniformity(ranks, n_bins=8, n_draws=127)
    assert np.all(stat > thresh), (stat, thresh)


def test_validation():
    with pytest.raises(ValueError, match="unknown sampler"):
        sbc_ranks(prior_sample, simulate, log_post, sampler="nope",
                  n_repl=4, n_draws=7, burn=10)


def test_chees_ranks_uniform():
    """The newest kernel (cross-chain trajectory adaptation) validated
    at the stationary-distribution level: ε/T/mass adapt during burn on
    an 8-chain population per replication, freeze, then 127 ranked
    draws from chain 0 must be uniform."""
    ranks = sbc_ranks(prior_sample, simulate, log_post, sampler="chees",
                      n_repl=256, n_draws=127, thin=2, burn=300,
                      step_size=0.25, seed=5)
    stat, thresh = sbc_uniformity(ranks, n_bins=8, n_draws=127)
    assert np.all(stat < thresh), (stat, thresh)


# ---------------------------------------------------------------------------
# SBC for the FlowMh/GMM COMPOSED kernel: a reduced-precision matmul in
# gmm_log_q_diag (TF32 is the GPU's default for float32 products) puts
# O(nats) of position-dependent error into the proposal density at
# headline-scale mode norms ‖μ‖≈50 — a fitted-proposal density error
# biases π while per-dim R̂ still converges. Prior-SBC: the target is
# exactly sampleable (4-mode isotropic mixture at the TRUE headline
# geometry, d=100, spread 5), a diag GMM is FITTED to exact draws, and
# chain 0's thinned draws must rank θ̃ uniformly. One sampler object is
# reused with a fresh seed per replication, so the engine compiles once.
# The run executes under default matmul precision — the production
# environment — so the test validates that every matmul on the density
# path carries its OWN explicit Precision.HIGHEST (conftest's global
# "highest" pin would otherwise mask exactly this bug class).
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_flowmh_gmm_fitted_proposal_ranks_uniform():
    import bipymc_tpu as bp
    from bipymc_tpu.models.targets import (baseline_config3_means,
                                           gaussian_mixture,
                                           gaussian_mixture_block)
    from bipymc_tpu.utils.mixtures import fit_gmm, gmm_proposal

    D, N_CH, N_REPL, M, THIN, BURN = 100, 16, 128, 63, 2, 20
    means = baseline_config3_means(D)           # ‖μ‖ ≈ 50
    means_j = jnp.asarray(means)
    k_modes = means.shape[0]
    lp = gaussian_mixture(means, sigma=1.0)

    def exact_sample(key, n):
        km, kn = jax.random.split(key)
        comp = jax.random.randint(km, (n,), 0, k_modes)
        return means_j[comp] + jax.random.normal(kn, (n, D))

    with jax.default_matmul_precision("default"):
        draws_fit = exact_sample(jax.random.key(10), 20000)
        params, _ = fit_gmm(jax.random.key(11), draws_fit, 8,
                            n_iters=100, cov_type="diag")
        prop = gmm_proposal(params, 1.05)
        s = bp.FlowMh(lp, prop, n_chains=N_CH, seed=0, local_moves=1,
                      global_every=1, rw_scale=0.2, fused=True,
                      log_prob_block=gaussian_mixture_block(means))
        prior_keys = jax.random.split(jax.random.key(999), N_REPL)
        ranks = np.zeros((N_REPL, D), np.int32)
        for k in range(N_REPL):
            kp, kx = jax.random.split(prior_keys[k])
            theta_t = exact_sample(kp, 1)[0]
            x0 = exact_sample(kx, N_CH)          # every chain ~ π exactly
            x0 = x0.at[0].set(theta_t)           # exact-π start, chain 0
            s.seed = 1000 + k
            s.reset()
            s.run_mcmc(BURN + M * THIN, x0)
            xh = jnp.concatenate([c["x"] for c in s._chunks], axis=0)
            draws = xh[BURN + THIN - 1::THIN, 0, :]       # [M, D]
            ranks[k] = np.asarray(jnp.sum(
                (draws < theta_t[None, :]).astype(jnp.int32), axis=0))
    # alpha=1e-4 per dimension: family-wise false-alarm ~1% over d=100
    stat, thresh = sbc_uniformity(jnp.asarray(ranks), n_bins=8,
                                  alpha=1e-4, n_draws=M)
    assert np.all(stat < thresh), (float(stat.max()), thresh)
