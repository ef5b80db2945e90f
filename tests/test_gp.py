"""GP module tests (SURVEY.md §6: predict ≈ truth on smooth functions,
log-ML finite-difference checks, Pallas-vs-XLA kernel equivalence)."""

import jax
import jax.numpy as jnp
import numpy as np

from bipymc_tpu.gp import GpRegressor, squared_exp, matern32, matern52
from bipymc_tpu.gp.regressor import default_params
from bipymc_tpu.ops.distance import (
    pairwise_sqdist, _sqdist_xla)


def _toy_1d(n=40, noise=0.05, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, size=(n, 1))).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + noise * rng.normal(size=n)).astype(np.float32)
    return jnp.asarray(x), jnp.asarray(y)


def test_predict_recovers_smooth_function():
    x, y = _toy_1d()
    gp = GpRegressor()
    params = default_params(1)
    params["log_lengthscale"] = jnp.array([-0.5])
    params["log_sigma_n"] = jnp.asarray(-3.0)
    fit = gp.fit(x, y, params)
    xs = jnp.linspace(-2.5, 2.5, 50)[:, None]
    mu, var = gp.predict(fit, xs)
    np.testing.assert_allclose(
        np.asarray(mu), np.sin(2 * np.asarray(xs[:, 0])), atol=0.15)
    assert np.all(np.asarray(var) > 0)


def test_predict_interpolates_training_points_near_noiseless():
    x, y = _toy_1d(noise=0.0)
    gp = GpRegressor()
    params = default_params(1)
    params["log_sigma_n"] = jnp.asarray(-5.0)
    params["log_lengthscale"] = jnp.array([-0.5])
    fit = gp.fit(x, y, params)
    mu, _ = gp.predict(fit, x)
    np.testing.assert_allclose(np.asarray(mu), np.asarray(y), atol=0.02)


def test_log_ml_grad_matches_finite_difference():
    x, y = _toy_1d(n=25)
    gp = GpRegressor()
    params = default_params(1)
    grad = jax.grad(lambda p: gp.log_marginal_likelihood(p, x, y))(params)
    eps = 1e-3
    for name in ["log_sigma_f", "log_sigma_n"]:
        p_hi = dict(params); p_hi[name] = params[name] + eps
        p_lo = dict(params); p_lo[name] = params[name] - eps
        fd = (gp.log_marginal_likelihood(p_hi, x, y)
              - gp.log_marginal_likelihood(p_lo, x, y)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(grad[name]), np.asarray(fd),
                                   rtol=0.05, atol=0.05)


def test_hyperopt_improves_lml_and_fits():
    x, y = _toy_1d(n=50, noise=0.1, seed=1)
    gp = GpRegressor()
    p0 = default_params(1)
    lml0 = gp.log_marginal_likelihood(p0, x, y)
    p_opt, lml_opt = gp.optimize(x, y, steps=200)
    assert float(lml_opt) > float(lml0)
    fit = gp.fit(x, y, p_opt)
    mu, _ = gp.predict(fit, x)
    resid = np.asarray(mu) - np.asarray(y)
    assert np.sqrt((resid ** 2).mean()) < 0.2


def test_kernels_psd_and_symmetric():
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(30, 3)).astype(np.float32))
    params = default_params(3)
    for kern in [squared_exp, matern32, matern52]:
        k = np.asarray(kern(params, x))
        np.testing.assert_allclose(k, k.T, atol=1e-5)
        evals = np.linalg.eigvalsh(k + 1e-4 * np.eye(30))
        assert evals.min() > 0


def test_pairwise_sqdist_matches_bruteforce():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(17, 4)).astype(np.float32)
    b = rng.normal(size=(9, 4)).astype(np.float32)
    got = np.asarray(pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)))
    want = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_sqdist_small_distances_far_from_origin():
    """Points ~50 from the origin but ~1e-2 apart: the centred
    ‖a‖²+‖b‖²−2ab form at full float32 precision keeps the small
    distances (a TF32 or bf16 cross term would not)."""
    rng = np.random.default_rng(4)
    base = 5.0 * rng.normal(size=(1, 100))
    a = (base + 1e-2 * rng.normal(size=(40, 100))).astype(np.float32)
    got = np.asarray(pairwise_sqdist(jnp.asarray(a)))
    a64 = a.astype(np.float64)
    want = ((a64[:, None, :] - a64[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-4)


def test_sqdist_grad_matches_bruteforce():
    """jax.grad through the decomposed form equals the gradient of the
    brute-force difference form — the GP's log-ML hyperopt
    differentiates this function."""
    rng = np.random.default_rng(6)
    a = jnp.asarray(rng.normal(size=(130, 4)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=(140, 4)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(130, 140)).astype(np.float32))

    def loss(a, b):
        return jnp.sum(w * _sqdist_xla(a, b))

    def loss_brute(a, b):
        return jnp.sum(w * jnp.sum((a[:, None] - b[None]) ** 2, -1))

    ga, gb = jax.grad(loss, argnums=(0, 1))(a, b)
    ga_x, gb_x = jax.grad(loss_brute, argnums=(0, 1))(a, b)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(ga_x),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(gb), np.asarray(gb_x),
                               rtol=1e-3, atol=1e-3)


def test_surrogate_log_like_runs_in_sampler():
    """BASELINE config 5 shape: GP surrogate as the MCMC likelihood."""
    from bipymc_tpu import Metropolis
    rng = np.random.default_rng(5)
    theta_train = jnp.asarray(rng.uniform(-2, 2, (60, 2)).astype(np.float32))
    # peak value 5 > the GP's zero prior mean, so the trained basin is
    # genuinely preferred over unmodelled space
    ll = 5.0 - 2.0 * jnp.sum(theta_train ** 2, axis=1)
    gp = GpRegressor()
    params = default_params(2)
    params["log_lengthscale"] = jnp.array([0.3, 0.3])
    params["log_sigma_f"] = jnp.log(5.0)
    fit = gp.fit(theta_train, ll, params)
    # documented config-5 usage: variance-penalised surrogate + a prior
    # covering the trained region (an SE surrogate reverts to its zero mean
    # outside the data, so an unbounded chain would wander off).
    surrogate = gp.surrogate_log_like(fit, kind="lcb")
    log_post = lambda th: surrogate(th) - 0.5 * jnp.sum((th / 3.0) ** 2)
    s = Metropolis(log_post, seed=0, n_chains=2)
    s.run_mcmc(2000, jnp.zeros(2), cov_est=jnp.eye(2))
    flat = s.get_chain(discard=500, flat=True)
    # true posterior ∝ exp(−0.5‖θ‖²)·prior → mean 0, std < 1
    assert np.all(np.abs(flat.mean(axis=0)) < 0.5)
    assert np.all(flat.std(axis=0) < 1.5)


def test_grad_through_public_fit_default_config():
    """jax.grad through fit() must work under vmap (the config-4 shape:
    one Gram factorisation per chain, batched by XLA) and match the
    per-example gradients."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(-2, 2, (24, 2)), jnp.float32)
    ys = jnp.asarray(np.sin(np.asarray(x).sum(1))[None]
                     + 0.1 * rng.standard_normal((3, 24)), jnp.float32)
    gp = GpRegressor()

    def loss(y_):
        fit = gp._fit_impl(default_params(2), x, y_)
        return jnp.sum(fit.alpha ** 2) + jnp.sum(fit.chol)

    g_batched = jax.vmap(jax.grad(loss))(ys)
    g_single = np.stack([np.asarray(jax.grad(loss)(y_)) for y_ in ys])
    np.testing.assert_allclose(np.asarray(g_batched), g_single,
                               rtol=1e-4, atol=1e-5)


def test_predict_variance_uses_kernel_diagonal():
    """Predictive variance must use k(x*,x*) — not hardcode sigma_f^2 —
    so plugged-in kernels with non-constant diagonals stay correct."""
    def linear_kernel(params, X, X2=None):
        X2 = X if X2 is None else X2
        sf2 = jnp.exp(2.0 * params["log_sigma_f"])
        return sf2 * (X @ X2.T + 1.0)

    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.uniform(-1, 1, (16, 1)), jnp.float32)
    y = jnp.asarray(2.0 * np.asarray(x)[:, 0] + 0.3, jnp.float32)
    gp = GpRegressor(kernel=linear_kernel, jitter=1e-4)
    fit = gp.fit(x, y)
    xs = jnp.asarray([[0.0], [10.0]], jnp.float32)
    _, var = gp.predict(fit, xs)
    # exact posterior variance k(x*,x*) − ‖L⁻¹k*‖²: with the prior
    # diagonal hardcoded to sigma_f² (the old bug), ‖w‖² ≈ 100 > 1 at
    # x*=10 and the variance clamps to 1e-12 instead
    ks = linear_kernel(fit.params, fit.x, xs)
    w = jax.scipy.linalg.solve_triangular(fit.chol, ks, lower=True)
    want = np.asarray(jnp.diagonal(linear_kernel(fit.params, xs))
                      - jnp.sum(w * w, axis=0))
    np.testing.assert_allclose(np.asarray(var), want, rtol=1e-4)
    assert float(var[1]) > 1e-3, float(var[1])


def test_optimize_all_nonfinite_raises():
    x = jnp.zeros((8, 1), jnp.float32)          # duplicated rows
    y = jnp.full((8,), jnp.nan, jnp.float32)    # NaN targets
    gp = GpRegressor()
    try:
        gp.optimize(x, y, steps=5)
    except ValueError as e:
        assert "non-finite" in str(e)
    else:
        raise AssertionError("expected ValueError")


def test_optimize_noiseless_scores_near_f32_cliff():
    """BASELINE config-5-shaped fit: n=256 clustered inputs, noiseless
    (deterministic) scores, f32. optimize() drives sigma_n toward zero
    and the Gram's smallest eigenvalues sit below f32 round-off — an
    accelerator's compiled Adam scan went NaN at the old fixed 1e-5
    jitter (the CPU build survived by one ulp of luck; the card's run
    is tests/test_gpu_kernels.py). The n-aware
    4*n*eps jitter floor + the non-finite step rejection keep the run
    finite on every backend."""
    rng = np.random.default_rng(11)
    t_grid = np.linspace(0, 1, 8)

    def fwd(th):
        return th[0] * np.exp(-2 * t_grid) + th[1] * t_grid ** 2

    y_obs = fwd(np.array([1.2, -0.7], np.float32))
    design = rng.uniform(-2, 2, (256, 2)).astype(np.float32)
    scores = np.array(
        [-0.5 * float((fwd(t) - y_obs) @ (fwd(t) - y_obs)) / 0.05 ** 2
         for t in design], dtype=np.float32)
    gp = GpRegressor(normalize_y=True)
    params, ml = gp.optimize(design, scores, steps=300, lr=0.05)
    assert np.isfinite(float(ml))
    fit = gp.fit(design, scores, params=params)
    mu = gp.predict(fit, design[:16], return_var=False)
    # near-interpolation of the training scores (they span ~1e3)
    np.testing.assert_allclose(np.asarray(mu), scores[:16], atol=25.0)
