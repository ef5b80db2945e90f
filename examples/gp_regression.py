"""GP regression + MCMC over its hyperparameters.

BASELINE config 4: "GP regression hyperparameter inference (Cholesky /
covariance solves in the likelihood)" — the GP's exact log-marginal
likelihood IS the MCMC target, so every proposal pays a kernel-matrix
build (one matmul) plus a Cholesky (SURVEY.md §5.3).

Two estimates of the hyperparameters are compared:
  1. point estimate — Adam on the exact log-ML via jax.grad;
  2. full posterior — DRAM over (log ℓ, log σ_f, log σ_n).

Run: ``python examples/gp_regression.py``.
"""

import os

import numpy as np
import jax.numpy as jnp

import bipymc_tpu as bp
from bipymc_tpu.gp.regressor import GpRegressor
from bipymc_tpu.plotting import mc_plot

OUT = os.path.join(os.path.dirname(__file__), "out")


def main():
    rng = np.random.default_rng(7)
    n = 120
    x = np.sort(rng.uniform(-4.0, 4.0, (n, 1))).astype(np.float32)
    f = np.sin(2.0 * x[:, 0]) + 0.5 * x[:, 0]
    y = (f + rng.normal(0.0, 0.2, n)).astype(np.float32)

    gp = GpRegressor()

    # 1. Point estimate: maximise exact log-ML (jax.grad + Adam).
    params, lml = gp.optimize(x, y, steps=400, lr=0.05)
    print(f"optimised log-ML = {float(lml):.2f}")
    print(f"  lengthscale = {float(jnp.exp(params['log_lengthscale'][0])):.3f}"
          f", σ_f = {float(jnp.exp(params['log_sigma_f'])):.3f}"
          f", σ_n = {float(jnp.exp(params['log_sigma_n'])):.3f} (truth 0.2)")

    # 2. Posterior over hyperparameters: DRAM on the log-ML surface.
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    def log_post(theta):
        p = {"log_lengthscale": theta[0:1], "log_sigma_f": theta[1],
             "log_sigma_n": theta[2]}
        # weak N(0, 2²) prior on the log-hyperparameters
        return gp._lml_impl(p, xj, yj) - 0.5 * jnp.sum((theta / 2.0) ** 2)

    sampler = bp.Dram(log_post, seed=0, n_chains=4)
    sampler.run_mcmc(3000, jnp.zeros(3), cov_est=jnp.eye(3) * 0.05)
    kept = sampler.get_chain(discard=1000)
    flat = np.exp(kept.reshape(-1, 3))
    rhat = np.asarray(bp.gelman_rubin(kept))
    print("posterior medians:",
          dict(zip(["ℓ", "σ_f", "σ_n"], np.round(np.median(flat, 0), 3))),
          f"R-hat={np.round(rhat, 3)}")

    # Predictive check at the point estimate.
    fit = gp.fit(x, y, params=params)
    xs = np.linspace(-4.5, 4.5, 200, dtype=np.float32)[:, None]
    mu, var = gp.predict(fit, xs)
    in_range = np.abs(xs[:, 0]) < 4.0
    err = np.asarray(mu) - (np.sin(2 * xs[:, 0]) + 0.5 * xs[:, 0])
    rmse = float(np.sqrt(np.mean(err[in_range] ** 2)))
    print(f"predictive RMSE (in-range) = {rmse:.3f}")

    os.makedirs(OUT, exist_ok=True)
    mc_plot.plot_corner(np.log(flat), labels=["log ℓ", "log σ_f", "log σ_n"],
                        path=os.path.join(OUT, "gp_hyper_corner.png"))
    print(f"plots in {OUT}/")
    assert rhat.max() < 1.2
    assert abs(float(np.median(flat[:, 2])) - 0.2) < 0.1


if __name__ == "__main__":
    main()
