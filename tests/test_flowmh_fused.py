"""Fused FlowMh engine (samplers/flowmh_fused.py): exact agreement with
the per-generation engine, global_every amortization semantics, R-hat
early-stop routing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bipymc_tpu as bp
from bipymc_tpu.utils.mixtures import fit_gmm, gmm_proposal

D = 6
MEANS = np.stack([np.full(D, -3.0), np.full(D, 3.0)])


def _mixture_lp():
    m = jnp.asarray(MEANS, jnp.float32)

    def lp(x):
        sq = -0.5 * jnp.sum((x[None, :] - m) ** 2, axis=-1)
        return jax.scipy.special.logsumexp(sq)
    return lp


@pytest.fixture(scope="module")
def gmm_prop():
    rng = np.random.default_rng(0)
    which = rng.integers(0, 2, 4000)
    draws = MEANS[which] + rng.standard_normal((4000, D))
    params, _ = fit_gmm(jax.random.key(1), jnp.asarray(draws, jnp.float32),
                        3, n_iters=60, cov_type="diag")
    return gmm_proposal(params)


@pytest.mark.parametrize("global_every,local_moves", [(1, 1), (2, 2),
                                                      (4, 1)])
def test_fused_matches_pergen_exactly(gmm_prop, global_every, local_moves):
    """Same seed -> identical super_chain and acceptance histories:
    the fused prep replicates the per-generation word layout and the
    kernel math matches in interpret mode."""
    lp = _mixture_lp()
    theta0 = jnp.asarray(np.tile(MEANS[0], (8, 1)), jnp.float32)
    kw = dict(n_chains=8, seed=3, local_moves=local_moves,
              global_every=global_every)
    a = bp.FlowMh(lp, gmm_prop, **kw)
    a.run_mcmc(8 * global_every, theta0, spread=0.1)
    b = bp.FlowMh(lp, gmm_prop, fused=True, **kw)
    b.run_mcmc(8 * global_every, theta0, spread=0.1)
    # identical streams and selection; positions agree to float
    # re-association (isolated 1-ULP elements from XLA fusing the
    # displacement math differently across the two program contexts)
    xa, xb = np.asarray(a.super_chain), np.asarray(b.super_chain)
    np.testing.assert_allclose(xa, xb, rtol=0, atol=2e-6)
    assert (xa == xb).mean() > 0.99
    np.testing.assert_array_equal(a._history["accepted"],
                                  b._history["accepted"])
    np.testing.assert_array_equal(a._history["accepted_local"],
                                  b._history["accepted_local"])
    # final-state lq caches agree to float re-association (the log_q
    # pass compiles in different program contexts in the two engines)
    np.testing.assert_allclose(np.asarray(a.final_state.lq),
                               np.asarray(b.final_state.lq),
                               rtol=1e-5, atol=1e-5)


def test_fused_unaligned_segments(gmm_prop):
    """n_gens not a multiple of global_every and continuation from an
    unaligned offset route through per-gen segments — the composite
    still equals the pure per-gen run."""
    lp = _mixture_lp()
    theta0 = jnp.asarray(np.tile(MEANS[0], (4, 1)), jnp.float32)
    kw = dict(n_chains=4, seed=5, local_moves=1, global_every=3)
    a = bp.FlowMh(lp, gmm_prop, **kw)
    a.run_mcmc(14, theta0, spread=0.1)
    b = bp.FlowMh(lp, gmm_prop, fused=True, **kw)
    b.run_mcmc(7, theta0, spread=0.1)     # ends unaligned (7 % 3 != 0)
    b.run_mcmc(7)                         # resumes unaligned
    np.testing.assert_allclose(np.asarray(a.super_chain),
                               np.asarray(b.super_chain),
                               rtol=0, atol=2e-6)


def test_global_every_skips_global_moves(gmm_prop):
    """Skipped generations record accepted=False; global gens fire on
    the (t+1) % global_every == 0 schedule."""
    lp = _mixture_lp()
    theta0 = jnp.asarray(np.tile(MEANS[0], (8, 1)), jnp.float32)
    # rw_scale: the proposal's marginal std spans both modes (~3.2/dim)
    # — scaled down so the width-1 basin accepts some local moves
    s = bp.FlowMh(lp, gmm_prop, n_chains=8, seed=7, local_moves=1,
                  global_every=4, rw_scale=0.1)
    s.run_mcmc(12, theta0, spread=0.1)
    acc = s._history["accepted"]          # [T, n]
    is_global = (np.arange(12) + 1) % 4 == 0
    assert not acc[~is_global].any()
    # local channel is alive on every generation
    assert s.local_acceptance_fraction.mean() > 0.0


def test_global_every_still_targets_posterior(gmm_prop):
    """Amortized global moves keep exact invariance: moments of the
    two-mode mixture recovered from a collapsed init."""
    lp = _mixture_lp()
    theta0 = jnp.asarray(np.tile(MEANS[0], (32, 1)), jnp.float32)
    s = bp.FlowMh(lp, gmm_prop, n_chains=32, seed=9, local_moves=2,
                  global_every=5, fused=True)
    s.run_mcmc(800, theta0, spread=0.1)
    draws = s.get_chain(discard=200, flat=True)
    # mode weights 0.5/0.5 -> mean ~0 in every dim, sd ~ sqrt(1+9)
    assert np.all(np.abs(draws.mean(0)) < 0.6), draws.mean(0)
    np.testing.assert_allclose(draws.std(0), np.sqrt(10.0), rtol=0.2)


def test_until_routes_fused(gmm_prop):
    lp = _mixture_lp()
    theta0 = jnp.asarray(np.tile(MEANS[0], (16, 1)), jnp.float32)
    s = bp.FlowMh(lp, gmm_prop, n_chains=16, seed=11, local_moves=1,
                  global_every=4, fused=True)
    info = s.run_mcmc_until(theta0, rhat_tol=1.2, chunk=50, max_chunks=40,
                            spread=0.1)
    assert info["steps"] % 4 == 0          # chunk rounded to global_every
    assert np.max(info["rhat"]) <= 1.2


def test_validation():
    lp = _mixture_lp()
    prop = bp.Proposal(sample_logq=lambda e, u: (e, jnp.zeros(e.shape[0])),
                       log_q=lambda x: jnp.zeros(x.shape[0]),
                       sigma=jnp.ones(D))
    with pytest.raises(ValueError, match="global_every"):
        bp.FlowMh(lp, prop, global_every=0)
    with pytest.raises(ValueError, match="local_moves"):
        bp.FlowMh(lp, prop, global_every=2, local_moves=0)
    with pytest.raises(ValueError, match="local_moves"):
        bp.FlowMh(lp, prop, local_moves=0, fused=True)


def test_fused_mesh_matches_vmap(gmm_prop):
    """FlowMh(mesh=..., fused=True) on 8 fake devices produces the
    SAME trajectories as the single-device fused run: streams fold on
    global chain ids, chains are independent, the proposal is
    replicated (SURVEY §3.2 mesh-path parity)."""
    from bipymc_tpu.parallel.mesh import chain_mesh
    lp = _mixture_lp()
    theta0 = jnp.asarray(np.tile(MEANS[0], (16, 1)), jnp.float32)
    kw = dict(n_chains=16, seed=7, local_moves=2, global_every=2)
    a = bp.FlowMh(lp, gmm_prop, fused=True, **kw)
    a.run_mcmc(8, theta0, spread=0.1)
    b = bp.FlowMh(lp, gmm_prop, fused=True, mesh=chain_mesh(), **kw)
    b.run_mcmc(8, theta0, spread=0.1)
    xa, xb = np.asarray(a.super_chain), np.asarray(b.super_chain)
    np.testing.assert_allclose(xa, xb, rtol=0, atol=2e-6)
    assert (xa == xb).mean() > 0.99
    np.testing.assert_array_equal(a._history["accepted"],
                                  b._history["accepted"])
    np.testing.assert_array_equal(a._history["accepted_local"],
                                  b._history["accepted_local"])


def test_fused_mesh_run_until(gmm_prop):
    """run_mcmc_until routes fused chunks through the pool's shard_map
    with the LOCAL runner on the mesh path and still converges."""
    from bipymc_tpu.parallel.mesh import chain_mesh
    lp = _mixture_lp()
    rng = np.random.default_rng(2)
    theta0 = jnp.asarray(MEANS[rng.integers(0, 2, 16)]
                         + rng.standard_normal((16, D)), jnp.float32)
    s = bp.FlowMh(lp, gmm_prop, fused=True, mesh=chain_mesh(),
                  n_chains=16, seed=1, local_moves=1, global_every=2)
    info = s.run_mcmc_until(theta0, rhat_tol=1.2, chunk=20,
                            max_chunks=40, warmup_chunks=2, spread=0.5)
    assert float(info["rhat"].max()) < 1.2
