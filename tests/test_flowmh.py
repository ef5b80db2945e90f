"""Flow global-move MCMC (samplers/flowmh.py + bp.FlowMh): exact
targeting through an imperfect flow, cross-mode re-equilibration,
sanitizer policy, mesh equivalence."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bipymc_tpu as bp
from bipymc_tpu.parallel.mesh import chain_mesh
from bipymc_tpu.utils import flows as fl

MEAN = np.array([1.0, -2.0])
COV = np.array([[1.0, 0.6], [0.6, 1.0]])


def _gauss_lp(mean, cov):
    inv = jnp.asarray(np.linalg.inv(cov), jnp.float32)
    mean = jnp.asarray(mean, jnp.float32)

    def lp(x):
        r = x - mean
        return -0.5 * jnp.sum((r @ inv) * r)
    return lp


def _biased_flow(seed=0, n_steps=400):
    """Flow fit to DELIBERATELY shifted/overdispersed draws — the MH
    correction, not the fit, must deliver the target."""
    rng = np.random.default_rng(seed)
    draws = rng.multivariate_normal(MEAN + 0.5, 1.5 * COV, size=2500)
    cfg = fl.flow_config(n_layers=4, hidden=24, n_steps=n_steps,
                         step_size=3e-3)
    params, _ = fl.fit_flow(jax.random.key(seed), jnp.asarray(draws), cfg)
    return params, cfg


def test_targets_exact_posterior_through_imperfect_flow():
    params, cfg = _biased_flow()
    s = bp.FlowMh(_gauss_lp(MEAN, COV), params, n_chains=8, seed=1,
                  flow_config=cfg)
    s.run_mcmc(1500, jnp.zeros(2), spread=1.0)
    draws = s.get_chain(discard=300, flat=True)
    np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.12)
    np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.25)
    # the imperfect flow must still be accepted often (it overlaps the
    # target); and local moves must be live too
    assert s.global_acceptance_fraction.mean() > 0.2
    assert s.local_acceptance_fraction.mean() > 0.05


def test_cross_mode_reequilibration_from_wrong_init():
    """The capability the DE family lacks: ALL chains
    start in one mode of a 0.5/0.5 mixture; flow global moves restore
    the mode weights within a few hundred generations."""
    sep = 6.0
    m0, m1 = -sep / 2, sep / 2

    def lp(x):
        a = -0.5 * jnp.sum((x - m0) ** 2)
        b = -0.5 * jnp.sum((x - m1) ** 2)
        return jax.scipy.special.logsumexp(jnp.stack([a, b]))

    rng = np.random.default_rng(3)
    which = rng.integers(0, 2, 4000)
    draws = (np.where(which[:, None], m1, m0)
             + rng.normal(0, 1.0, (4000, 4)))
    cfg = fl.flow_config(n_layers=6, hidden=32, n_steps=700,
                         step_size=3e-3)
    params, _ = fl.fit_flow(jax.random.key(4), jnp.asarray(draws), cfg)

    # every chain starts in mode 0 — occupancy [1, 0]
    theta_0 = jnp.full((32, 4), m0)
    s = bp.FlowMh(lp, params, n_chains=32, seed=5, flow_config=cfg)
    s.run_mcmc(400, theta_0, spread=0.1)
    x_late = s.super_chain[:, 200:, 0]          # [chains, gens]
    frac_mode1 = (x_late > 0).mean()
    assert 0.35 < frac_mode1 < 0.65, frac_mode1
    # and single-generation transplants actually happen at O(accept) rate
    assert s.global_acceptance_fraction.mean() > 0.1


def test_escape_accept_from_out_of_support_start():
    params, cfg = _biased_flow(seed=6, n_steps=100)

    def lp(x):
        inside = jnp.all(jnp.abs(x - jnp.asarray(MEAN, jnp.float32))
                         < 10.0)
        return jnp.where(inside, _gauss_lp(MEAN, COV)(x), -jnp.inf)

    s = bp.FlowMh(lp, params, n_chains=4, seed=7, flow_config=cfg)
    s.run_mcmc(50, jnp.full((4, 2), 50.0), spread=0.0)
    assert np.all(np.isfinite(s._history["logp"][-1]))


def test_nan_proposals_hard_reject():
    params, cfg = _biased_flow(seed=8, n_steps=100)

    def lp(x):
        good = _gauss_lp(MEAN, COV)(x)
        return jnp.where(jnp.sum(x * x) < 25.0, good, jnp.nan)

    s = bp.FlowMh(lp, params, n_chains=4, seed=9, flow_config=cfg)
    s.run_mcmc(200, jnp.asarray(np.tile(MEAN, (4, 1)), jnp.float32),
               spread=0.1)
    assert np.all(np.isfinite(s._history["logp"]))
    assert np.all(np.asarray(s.super_chain[..., 0] ** 2
                             + s.super_chain[..., 1] ** 2) < 25.0)


def test_mesh_equals_vmap():
    """Zero in-step collectives + global-index RNG folds → the sharded
    run replays the vmap run (2 chains/device keeps the local batch
    program rounding-identical, as in test_hmc)."""
    params, cfg = _biased_flow(seed=10, n_steps=100)
    lp = _gauss_lp(MEAN, COV)
    a = bp.FlowMh(lp, params, n_chains=16, seed=11, flow_config=cfg)
    a.run_mcmc(100, jnp.zeros(2), spread=1.0)
    b = bp.FlowMh(lp, params, n_chains=16, seed=11, flow_config=cfg,
                  mesh=chain_mesh())
    b.run_mcmc(100, jnp.zeros(2), spread=1.0)
    np.testing.assert_array_equal(a.super_chain, b.super_chain)


def test_pure_independence_lq_cache_consistent():
    """local_moves=0 carries log q(x) across generations — it must
    equal a fresh flow_log_q at the final positions."""
    params, cfg = _biased_flow(seed=12, n_steps=100)
    s = bp.FlowMh(_gauss_lp(MEAN, COV), params, n_chains=4, seed=13,
                  flow_config=cfg, local_moves=0)
    s.run_mcmc(60, jnp.zeros(2), spread=1.0)
    st = s.final_state
    fresh = fl.flow_log_q(params, st.x, cfg)
    np.testing.assert_allclose(np.asarray(st.lq), np.asarray(fresh),
                               rtol=2e-4, atol=2e-4)
    assert np.all(np.asarray(s._history["accepted_local"]) == 0.0)


def test_continuation_contract_and_validation():
    params, cfg = _biased_flow(seed=14, n_steps=50)
    s = bp.FlowMh(_gauss_lp(MEAN, COV), params, n_chains=4, seed=15,
                  flow_config=cfg)
    s.run_mcmc(20, jnp.zeros(2))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s.run_mcmc(20, jnp.ones(2))
    assert any("IGNORED" in str(x.message) for x in w)
    assert s.super_chain.shape[1] == 40

    with pytest.raises(ValueError, match="local_moves"):
        bp.FlowMh(_gauss_lp(MEAN, COV), params, flow_config=cfg,
                  local_moves=-1)


def test_rhat_early_stop():
    params, cfg = _biased_flow(seed=16, n_steps=200)
    s = bp.FlowMh(_gauss_lp(MEAN, COV), params, n_chains=8, seed=17,
                  flow_config=cfg)
    info = s.run_mcmc_until(jnp.zeros(2), rhat_tol=1.1, chunk=50,
                            max_chunks=40)
    assert np.max(info["rhat"]) <= 1.1
