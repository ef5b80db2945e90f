"""Power-posterior evidence (utils/evidence.py): TI + stepping stone.

Validation anchor (same policy as tests/test_ns.py / test_smc.py):
evidence estimators are pinned against ANALYTIC log-normalisers —
moment checks alone cannot see an evidence bias.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bipymc_tpu.samplers import rw, tempering
from bipymc_tpu.utils.evidence import (EvidenceResult, _lse_update,
                                       power_ladder,
                                       power_posterior_evidence)

D, TAU, SIG = 3, 2.0, 1.0
Y0 = jnp.asarray([0.5, -1.0, 1.5])


def log_prior(th):
    return (-0.5 * jnp.sum(th ** 2) / TAU ** 2
            - 0.5 * D * jnp.log(2 * jnp.pi * TAU ** 2))


def log_like(th):
    return (-0.5 * jnp.sum((Y0 - th) ** 2) / SIG ** 2
            - 0.5 * D * jnp.log(2 * jnp.pi * SIG ** 2))


def true_log_z():
    # ∫ N(θ;0,τ²I)·N(y0;θ,σ²I) dθ = N(y0; 0, (τ²+σ²)I)
    v = TAU ** 2 + SIG ** 2
    return float(-0.5 * np.sum(np.asarray(Y0) ** 2) / v
                 - 0.5 * D * np.log(2 * np.pi * v))


def test_power_ladder():
    lad = power_ladder(6, c=5.0)
    assert lad[0] == 1.0 and lad[-1] == 0.0
    assert list(lad) == sorted(lad, reverse=True)
    # c>1 crowds rungs near 0: the top gap is the largest
    gaps = np.diff(np.asarray(lad))
    assert -gaps[0] > -gaps[-1]
    with pytest.raises(ValueError):
        power_ladder(1)


def test_streaming_lse_matches_direct():
    rng = np.random.default_rng(0)
    vals = jnp.asarray(rng.normal(2.0, 5.0, (7, 2, 6)), jnp.float32)
    m = jnp.full((2,), -jnp.inf, jnp.float32)
    se = jnp.zeros((2,), jnp.float32)
    for v in vals:
        m, se = _lse_update(m, se, v)
    direct = jax.scipy.special.logsumexp(
        jnp.moveaxis(vals, 1, 0).reshape(2, -1), axis=1)
    np.testing.assert_allclose(m + jnp.log(se), direct, rtol=1e-5)
    # −inf draws are dropped, not NaN-poisoning
    m2, se2 = _lse_update(m, se, jnp.full((2, 3), -jnp.inf))
    np.testing.assert_allclose(m2 + jnp.log(se2), m + jnp.log(se))


def test_conjugate_gaussian_evidence():
    """Both estimators hit the analytic log Z on the conjugate model,
    and agree with each other within Monte-Carlo error."""
    r = power_posterior_evidence(log_prior, log_like, jnp.zeros(D),
                                 n_temps=8, n_gens=4000, seed=1)
    assert isinstance(r, EvidenceResult)
    truth = true_log_z()
    assert abs(r.log_z_ti - truth) < 0.25, (r.log_z_ti, truth)
    assert abs(r.log_z_ss - truth) < 0.25, (r.log_z_ss, truth)
    assert abs(r.log_z_ti - r.log_z_ss) < 0.3
    assert r.mcse_ti < 0.2
    # the TI curve E_beta[log L] is increasing in beta (data pulls the
    # rungs toward the likelihood); betas are descending
    assert np.all(np.diff(r.mean_ell) < 0.5)  # allow MC noise
    assert r.mean_ell[0] > r.mean_ell[-1]
    # every interface actually communicates
    assert np.all(r.swap_rate > 0.1)
    # the beta=1 rung is a posterior sample: check its mean
    post_mean = np.asarray(Y0) * TAU ** 2 / (TAU ** 2 + SIG ** 2)
    theta_cold = np.asarray(tempering.positions(r.state.kernel)[0])
    np.testing.assert_allclose(theta_cold.mean(axis=0), post_mean,
                               atol=0.6)


def test_mesh_matches_vmap():
    """Gather-then-reduce contract: the mesh run's estimates are
    bit-identical to the single-device run (integer swap stats exactly,
    float accumulators too — identical full-axis reductions)."""
    from bipymc_tpu.parallel.mesh import chain_mesh
    kw = dict(n_temps=5, n_gens=600, burn=200, seed=3)
    theta0 = jnp.zeros((5, 8, D))
    a = power_posterior_evidence(log_prior, log_like, theta0, **kw)
    b = power_posterior_evidence(log_prior, log_like, theta0,
                                 mesh=chain_mesh(), **kw)
    assert a.log_z_ti == b.log_z_ti
    assert a.log_z_ss == b.log_z_ss
    np.testing.assert_array_equal(a.mean_ell, b.mean_ell)
    np.testing.assert_array_equal(a.swap_rate, b.swap_rate)


def test_validation():
    with pytest.raises(ValueError, match="descending from exactly 1"):
        power_posterior_evidence(log_prior, log_like, jnp.zeros(D),
                                 betas=(1.0, 0.5, 0.1))
    with pytest.raises(ValueError, match="RwConfig"):
        from bipymc_tpu.samplers import hmc
        power_posterior_evidence(log_prior, log_like, jnp.zeros(D),
                                 kernel=hmc.hmc_config())
    # beta=0 under plain tempering (no prior) is rejected at the engine
    with pytest.raises(ValueError, match="power-posterior"):
        tempering.make_step(log_like, tempering.PtConfig(
            betas=(1.0, 0.5, 0.0)))
    # gradient kernel + log_prior rejected at the engine
    from bipymc_tpu.samplers import hmc
    with pytest.raises(ValueError, match="RW kernel"):
        tempering.make_step(log_like, tempering.PtConfig(
            betas=(1.0, 0.0), kernel=hmc.hmc_config()),
            log_prior=log_prior)


def _post_moments():
    v_post = 1.0 / (1.0 / TAU ** 2 + 1.0 / SIG ** 2)
    mean_post = np.asarray(Y0) * v_post / SIG ** 2
    return mean_post, v_post


def test_bridge_evidence_exact_draws():
    """Bridge sampling on EXACT iid posterior draws (conjugate model →
    the posterior is Gaussian and can be drawn directly) recovers the
    analytic log Z, and re2 prices the error honestly."""
    from bipymc_tpu.utils.evidence import bridge_evidence
    mean_post, v_post = _post_moments()
    rng = np.random.default_rng(7)
    draws = rng.normal(mean_post, np.sqrt(v_post), (4000, D)).astype(
        np.float32)
    lp = lambda th: log_prior(th) + log_like(th)
    r = bridge_evidence(draws, lp, seed=1)
    truth = true_log_z()
    assert r.converged and r.n_iter < 100
    assert abs(r.log_z - truth) < 0.1, (r.log_z, truth)
    # Gaussian posterior + moment-matched Gaussian proposal = near-
    # perfect overlap: the error estimate must be tiny
    assert r.re2 < 1e-2
    assert 4 * np.sqrt(r.re2) > abs(r.log_z - truth)  # error bar honest


def test_bridge_evidence_from_mcmc_history():
    """End-to-end: bridge sampling on real (autocorrelated, thinned)
    DRAM draws — [chains, T, d] history accepted directly."""
    import bipymc_tpu as bp
    from bipymc_tpu.utils.evidence import bridge_evidence
    lp = lambda th: log_prior(th) + log_like(th)
    s = bp.Dram(lp, n_chains=8, seed=2)
    s.run_mcmc(1500, jnp.zeros(D), cov_est=jnp.eye(D))
    hist = s.super_chain[:, 500::5]             # [chains, T, d] burn+thin
    r = bridge_evidence(hist, lp, seed=3)
    assert r.converged
    assert abs(r.log_z - true_log_z()) < 0.25, (r.log_z, true_log_z())


def test_bridge_handles_out_of_support_proposal_draws():
    """A compact-support target: proposal draws landing outside get
    q = −inf and must not poison the estimate (l₂ = 0 contributes
    nothing — by construction of the bridge)."""
    from bipymc_tpu.utils.evidence import bridge_evidence
    # uniform box [0,1]² → log Z of q = 1[box] is 0
    lp = lambda th: jnp.where(jnp.all((th >= 0) & (th <= 1)), 0.0,
                              -jnp.inf)
    rng = np.random.default_rng(0)
    draws = rng.uniform(0, 1, (4000, 2)).astype(np.float32)
    r = bridge_evidence(draws, lp, seed=0)
    assert r.converged
    assert np.isfinite(r.log_z)
    assert abs(r.log_z - 0.0) < 0.1, r.log_z


def test_plain_tempering_streams_unchanged():
    """The log_prior plumbing must not perturb the existing PT path:
    same config without log_prior gives the identical trajectory as
    the round-2 engine contract (swap uses logp/beta)."""
    cfg = tempering.PtConfig(betas=(1.0, 0.5, 0.25), swap_interval=3,
                             kernel=rw.dram_config())
    step = tempering.make_step(log_like, cfg)
    th0 = jnp.zeros((3, 4, D))
    state = tempering.init(th0, log_like, cfg, jnp.eye(D))
    key = jax.random.key(0)
    for t in range(12):
        state, info = step(state, jax.random.fold_in(key, t), t)
    # smoke: finite, swaps happened, positions moved
    assert np.isfinite(np.asarray(state.kernel.logp)).all()
    assert float(jnp.abs(tempering.positions(state.kernel)).sum()) > 0
