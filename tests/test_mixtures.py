"""EM Gaussian mixtures (utils/mixtures.py) + the GMM global-move
proposal: fit recovery, exact density, and the d=16 regime where the
neural-flow proposal's acceptance collapses but the GMM's holds."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bipymc_tpu as bp
from bipymc_tpu.utils import mixtures as mx


def _two_mode_draws(n=8000, d=3, sep=8.0, w1=0.75, seed=0):
    rng = np.random.default_rng(seed)
    which = rng.random(n) < w1
    mu0, mu1 = np.zeros(d, np.float32), np.full(d, sep, np.float32)
    x = np.where(which[:, None], mu1, mu0) + rng.normal(
        0, 1.0, (n, d)).astype(np.float32)
    return x, (mu0, mu1), w1


def test_em_recovers_two_component_mixture():
    x, (mu0, mu1), w1 = _two_mode_draws()
    params, info = mx.fit_gmm(jax.random.key(1), jnp.asarray(x), 2,
                              n_iters=100)
    w = np.sort(np.exp(np.asarray(params.log_w)))
    np.testing.assert_allclose(w, [1 - w1, w1], atol=0.03)
    # match components to truth by nearest mean
    mus = np.asarray(params.mu)
    i1 = int(np.argmin(((mus - mu1) ** 2).sum(1)))
    np.testing.assert_allclose(mus[i1], mu1, atol=0.15)
    np.testing.assert_allclose(mus[1 - i1], mu0, atol=0.15)
    # unit covariance → Cholesky ≈ I
    np.testing.assert_allclose(np.asarray(params.chol[i1]), np.eye(3),
                               atol=0.1)
    # loglik trace is non-decreasing at the end (EM monotonicity)
    ll = np.asarray(info["loglik"])
    assert ll[-1] >= ll[0]
    assert abs(float(info["final_loglik"]) - ll[-1]) < 1e-6


def test_gmm_log_q_exact_single_gaussian():
    """K=1 must reduce to the exact MVN density."""
    rng = np.random.default_rng(2)
    a = rng.normal(0, 1, (2, 2)).astype(np.float32)
    cov = a @ a.T + 0.5 * np.eye(2, dtype=np.float32)
    mu = np.array([1.0, -2.0], np.float32)
    chol = np.linalg.cholesky(cov)
    params = mx.GmmParams(log_w=jnp.zeros((1,)),
                          mu=jnp.asarray(mu)[None],
                          chol=jnp.asarray(chol)[None])
    pts = rng.normal(0, 2, (50, 2)).astype(np.float32)
    got = np.asarray(mx.gmm_log_q(params, jnp.asarray(pts)), np.float64)
    inv = np.linalg.inv(cov)
    r = pts - mu
    want = (-0.5 * np.einsum("ni,ij,nj->n", r, inv, r)
            - 0.5 * np.log(np.linalg.det(cov.astype(np.float64)))
            - math.log(2 * math.pi))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # leading-axis broadcasting
    batched = mx.gmm_log_q(params, jnp.asarray(pts).reshape(5, 10, 2))
    np.testing.assert_allclose(np.asarray(batched).ravel(), got,
                               rtol=1e-4, atol=1e-4)


def test_gmm_sample_and_marginal_std():
    x, (mu0, mu1), w1 = _two_mode_draws(n=12000, d=2, sep=6.0, w1=0.5)
    params, _ = mx.fit_gmm(jax.random.key(3), jnp.asarray(x), 2,
                           n_iters=80)
    s = np.asarray(mx.gmm_sample(params, jax.random.key(4), 20000))
    # sample moments match the fitted mixture's analytic moments
    np.testing.assert_allclose(s.mean(0), x.mean(0), atol=0.1)
    np.testing.assert_allclose(
        s.std(0), np.asarray(mx.gmm_marginal_std(params)), rtol=0.05)
    # and both match the data
    np.testing.assert_allclose(s.std(0), x.std(0), rtol=0.05)


def test_fit_gmm_validation_and_subsample():
    x = np.random.default_rng(0).normal(0, 1, (100, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="n_components"):
        mx.fit_gmm(jax.random.key(0), x, 0)
    with pytest.raises(ValueError, match="at least"):
        mx.fit_gmm(jax.random.key(0), x[:3], 2)
    with pytest.raises(ValueError, match="non-finite"):
        bad = x.copy()
        bad[5, 1] = np.nan
        mx.fit_gmm(jax.random.key(0), bad, 2)
    with pytest.raises(ValueError, match="last axis"):
        mx.fit_gmm(jax.random.key(0), x[:, 0], 2)
    with pytest.raises(ValueError, match="n_restarts"):
        mx.fit_gmm(jax.random.key(0), x, 2, n_restarts=0)
    with pytest.raises(ValueError, match="cov_type"):
        mx.fit_gmm(jax.random.key(0), x, 2, cov_type="spherical")
    # subsampled fit still works and is close
    p, _ = mx.fit_gmm(jax.random.key(1), x, 1, n_iters=30, max_points=40)
    np.testing.assert_allclose(np.asarray(p.mu[0]), x.mean(0), atol=0.5)


def test_overspecified_k_stays_finite():
    """K far above the true component count must not blow up (dead
    components keep previous params under the house policy)."""
    x, _, _ = _two_mode_draws(n=2000, d=2)
    params, info = mx.fit_gmm(jax.random.key(5), jnp.asarray(x), 8,
                              n_iters=120, reg=1e-4)
    assert np.all(np.isfinite(np.asarray(params.log_w)))
    assert np.all(np.isfinite(np.asarray(params.mu)))
    assert np.all(np.isfinite(np.asarray(params.chol)))
    assert np.isfinite(float(info["final_loglik"]))
    np.testing.assert_allclose(
        float(jnp.sum(jnp.exp(params.log_w))), 1.0, rtol=1e-5)


def test_kmeanspp_seeding_recovers_weights_for_any_key():
    """Regression: uniform-random seeding puts two init means in one
    mode with prob 1−K!/K^K ≈ 91% at K=4, and EM then merges two modes
    into one inflated component (measured: per-dim variance ~30× true,
    weights [.13,.25,.47,.14]). k-means++ + restarts must recover
    ~equal weights for EVERY fit key, not just lucky ones."""
    D, K = 16, 4
    means = 5.0 * np.asarray(
        jax.random.normal(jax.random.key(7), (K, D)), np.float32)
    rng = np.random.default_rng(1)
    which = rng.integers(0, K, 8000)
    draws = means[which] + rng.normal(0, 1, (8000, D)).astype(np.float32)
    for seed in range(3):
        params, _ = mx.fit_gmm(jax.random.key(seed), jnp.asarray(draws),
                               K, n_iters=100)
        w = np.exp(np.asarray(params.log_w))
        assert w.min() > 0.15 and w.max() < 0.35, (seed, w)
        covdiag = np.asarray((params.chol ** 2).sum(-1))
        assert covdiag.max() < 2.0, (seed, covdiag.max())


def test_diag_cov_type():
    """cov_type='diag' must zero cross-terms and match the full fit on
    axis-aligned data."""
    rng = np.random.default_rng(4)
    x = (rng.normal(0, 1, (4000, 3)) * np.array([1.0, 2.0, 0.5])
         ).astype(np.float32)
    p, _ = mx.fit_gmm(jax.random.key(0), jnp.asarray(x), 1, n_iters=40,
                      cov_type="diag")
    chol = np.asarray(p.chol[0])
    assert np.allclose(chol, np.diag(np.diagonal(chol)), atol=1e-7)
    np.testing.assert_allclose(np.diagonal(chol), x.std(0), rtol=0.05)
    # density agrees with the full fit on the same data
    pf, _ = mx.fit_gmm(jax.random.key(0), jnp.asarray(x), 1, n_iters=40)
    pts = jnp.asarray(rng.normal(0, 1, (64, 3)).astype(np.float32))
    # full-fit off-diagonals carry sampling noise that shifts tail
    # log-densities by ~0.1; agreement of the parameterizations, not
    # exactness, is the contract here
    np.testing.assert_allclose(np.asarray(mx.gmm_log_q(p, pts)),
                               np.asarray(mx.gmm_log_q(pf, pts)),
                               atol=0.25)


def test_diag_log_q_matches_generic():
    """gmm_log_q_diag (matmul form) equals the generic triangular-solve
    path on a diag fit, and gmm_proposal auto-dispatches to it —
    sample_logq draws must match the generic coloring too."""
    rng = np.random.default_rng(9)
    x = (np.stack([rng.normal(-2, 1, (3000, 5)),
                   rng.normal(2, 0.5, (3000, 5))])
         .reshape(-1, 5).astype(np.float32))
    p, _ = mx.fit_gmm(jax.random.key(2), jnp.asarray(x), 3, n_iters=60,
                      cov_type="diag")
    pts = jnp.asarray(rng.normal(0, 2, (128, 5)).astype(np.float32))
    np.testing.assert_allclose(np.asarray(mx.gmm_log_q_diag(p, pts)),
                               np.asarray(mx.gmm_log_q(p, pts)),
                               rtol=2e-5, atol=2e-5)
    # leading-shape handling
    assert mx.gmm_log_q_diag(p, pts.reshape(4, 32, 5)).shape == (4, 32)
    # proposal dispatch: same (x*, log q) from the same raw draws
    prop = mx.gmm_proposal(p)
    eps = jnp.asarray(rng.standard_normal((64, 5)).astype(np.float32))
    u = jnp.asarray(rng.random(64).astype(np.float32))
    xs, lqs = prop.sample_logq(eps, u)
    K = p.mu.shape[0]
    cum = jnp.cumsum(jnp.exp(p.log_w))
    comp = jnp.clip(jnp.searchsorted(cum, u), 0, K - 1)
    xs_ref = p.mu[comp] + jnp.einsum("nij,nj->ni", p.chol[comp], eps)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(xs_ref),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(lqs),
                               np.asarray(mx.gmm_log_q(p, xs)),
                               rtol=2e-5, atol=2e-5)


def test_gmm_proposal_high_acceptance_at_d16():
    """The regime that motivated pluggable proposals: d=16, 4 distant
    modes. The RealNVP proposal measured ~4e-4 acceptance here (fit
    error compounds per-dimension); the moment-matched GMM is the exact
    family, so acceptance must be near 1 and a fully collapsed
    population must re-equilibrate fast."""
    D, K, N = 16, 4, 64
    means = 5.0 * np.asarray(
        jax.random.normal(jax.random.key(7), (K, D)), np.float32)
    from bipymc_tpu.models.targets import gaussian_mixture
    lp = gaussian_mixture(jnp.asarray(means), sigma=1.0)

    # iid training draws (the controlled setting)
    rng = np.random.default_rng(8)
    which = rng.integers(0, K, 6000)
    draws = means[which] + rng.normal(0, 1, (6000, D)).astype(np.float32)
    params, _ = mx.fit_gmm(jax.random.key(9), jnp.asarray(draws), K,
                           n_iters=100)

    s = bp.FlowMh(lp, mx.gmm_proposal(params), n_chains=N, seed=10)
    theta_0 = jnp.asarray(np.tile(means[0], (N, 1)))   # collapsed init
    s.run_mcmc(300, theta_0, spread=0.1)
    acc = float(s.global_acceptance_fraction.mean())
    assert acc > 0.5, acc
    final = jnp.asarray(s.super_chain[:, -1, :])
    occ = np.asarray(bp.mode_occupancy(final, jnp.asarray(means)))
    assert occ.min() >= N // K // 2, occ
    kept = jnp.asarray(s.super_chain[:, 100:, :])
    assert float(np.max(np.asarray(bp.gelman_rubin(kept)))) < 1.05


def test_gmm_proposal_mesh_equals_vmap():
    """GMM global moves keep the package bit-identity contract."""
    from bipymc_tpu.parallel.mesh import chain_mesh
    x, _, _ = _two_mode_draws(n=3000, d=4, sep=5.0)
    params, _ = mx.fit_gmm(jax.random.key(11), jnp.asarray(x), 2,
                           n_iters=60)
    prop = mx.gmm_proposal(params)
    from bipymc_tpu.models.targets import gaussian_mixture
    means = jnp.stack([jnp.zeros(4), jnp.full((4,), 5.0)])
    lp = gaussian_mixture(means, sigma=1.0)
    a = bp.FlowMh(lp, prop, n_chains=16, seed=12)
    a.run_mcmc(80, jnp.zeros(4), spread=2.0)
    b = bp.FlowMh(lp, prop, n_chains=16, seed=12, mesh=chain_mesh())
    b.run_mcmc(80, jnp.zeros(4), spread=2.0)
    np.testing.assert_array_equal(a.super_chain, b.super_chain)


def test_gmm_proposal_inflate():
    """inflate=c scales every component scale by c: log q drops by
    d·log c at the component centre, draws stretch by c around the
    selected mean, and c<=0 is rejected."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(0, 1, (2000, 3)).astype(np.float32))
    p, _ = mx.fit_gmm(jax.random.key(0), x, 1, n_iters=40, cov_type="diag")
    base = mx.gmm_proposal(p)
    infl = mx.gmm_proposal(p, inflate=2.0)
    pt = p.mu                                            # [1, 3] centre
    got = float(infl.log_q(pt)[0] - base.log_q(pt)[0])
    np.testing.assert_allclose(got, -3 * np.log(2.0), rtol=1e-5)
    eps = jnp.asarray(rng.standard_normal((8, 3)).astype(np.float32))
    u = jnp.asarray(rng.random(8).astype(np.float32))
    xb, _ = base.sample_logq(eps, u)
    xi, _ = infl.sample_logq(eps, u)
    np.testing.assert_allclose(np.asarray(xi - p.mu),
                               2.0 * np.asarray(xb - p.mu), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="inflate"):
        mx.gmm_proposal(p, inflate=0.0)


def test_fit_gmm_jitted_sanitizes_nonfinite_rows():
    """Under jit the non-finite-draws check cannot raise; fit_gmm must
    instead ZERO-WEIGHT bad rows (a single NaN draw
    silently poisoned a jitted EM fit). The jitted fit on data with
    poisoned rows must stay finite and match the eager fit on the
    clean subset to statistical tolerance."""
    rng = np.random.default_rng(11)
    clean = np.concatenate([rng.normal(-3, 1, (1500, 2)),
                            rng.normal(3, 1, (1500, 2))]).astype(np.float32)
    bad = clean.copy()
    bad[::100] = np.nan          # 30 poisoned rows
    bad[7, 0] = np.inf
    fit = lambda dd: mx.fit_gmm(jax.random.key(2), dd, 2, n_iters=60,
                                cov_type="diag")
    pj, ij = jax.jit(fit)(jnp.asarray(bad))
    assert np.all(np.isfinite(np.asarray(pj.mu)))
    assert np.all(np.isfinite(np.asarray(pj.chol)))
    assert np.isfinite(float(ij["final_loglik"]))
    mus = np.sort(np.asarray(pj.mu)[:, 0])
    np.testing.assert_allclose(mus, [-3.0, 3.0], atol=0.3)
    # eager path still raises loudly
    with pytest.raises(ValueError, match="non-finite"):
        fit(jnp.asarray(bad))


def test_gmm_proposal_diag_negative_diagonal_signed():
    """A hand-built diagonal GmmParams with NEGATIVE Cholesky diagonal
    entries must color draws with the SIGNED diagonal (a row-norm fast
    path once silently flipped draw signs). L and -L give
    the same covariance, so draws must satisfy x = mu + diag * eps
    elementwise with the signed diag."""
    d = 3
    diag = jnp.asarray([1.0, -2.0, 0.5], jnp.float32)
    params = mx.GmmParams(
        log_w=jnp.zeros((1,), jnp.float32),
        mu=jnp.zeros((1, d), jnp.float32),
        chol=jnp.diag(diag)[None, :, :])
    prop = mx.gmm_proposal(params)
    eps = jnp.asarray(np.random.default_rng(0).standard_normal(
        (16, d)).astype(np.float32))
    u = jnp.zeros((16,), jnp.float32)
    x, lq = prop.sample_logq(eps, u)
    np.testing.assert_allclose(np.asarray(x), np.asarray(diag * eps),
                               rtol=1e-6, atol=1e-6)
    # density must match the generic (einsum) path at the same points
    np.testing.assert_allclose(np.asarray(lq),
                               np.asarray(mx.gmm_log_q(params, x)),
                               rtol=1e-4, atol=1e-4)
