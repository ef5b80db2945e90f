"""Latent-GP Poisson regression sampled with elliptical slice sampling.

The workflow `bp.EllipticalSlice` exists for: a
non-Gaussian likelihood over a latent function with a GP prior —
y_i ~ Poisson(exp(f_i + c)), f ~ N(0, K) with K the GP module's SE kernel on
the observation sites. The posterior over f is d = n-dimensional (one
latent per data point) and K's condition number on a dense grid is huge
(measured 1.2e5 here at jitter 1e-4) — the regime where every step-size-tuned
sampler collapses. ESS needs NO tuning: the Gaussian factor is sampled
exactly through the ellipse (prior Cholesky computed once, closed over
at jit time), and only the Poisson log-likelihood enters the slice test.

What this example demonstrates, asserted at the end:
  - the posterior mean latent recovers the true f far better than the
    prior mean (RMSE drops by > 2x),
  - split-R̂ < 1.1 across 8 chains on every latent dimension,
  - the conjugate sanity check: with the likelihood removed the sampler
    returns exact prior draws (marginal variances match diag(K)).

Run: ``python examples/latent_gp_eslice.py``.
"""

import numpy as np
import jax.numpy as jnp

import bipymc_tpu as bp
from bipymc_tpu.gp.kernels import squared_exp


def main():
    rng = np.random.default_rng(42)
    n = 48
    x = np.linspace(0.0, 6.0, n)[:, None]

    params = {"log_lengthscale": jnp.log(jnp.array([0.8])),
              "log_sigma_f": jnp.log(jnp.array(0.9))}
    K = np.asarray(squared_exp(params, jnp.asarray(x, jnp.float32)),
                   dtype=np.float64)
    L = np.linalg.cholesky(K + 1e-4 * np.eye(n))  # f32 kernel build: eigmin ~ -1e-5
    print(f"prior cond(K) ~ {np.linalg.cond(K + 1e-4 * np.eye(n)):.1e}")

    offset = 2.0                       # baseline log-rate: ~7 counts/site
    f_true = L @ rng.standard_normal(n)
    y = rng.poisson(np.exp(f_true + offset)).astype(np.float64)
    yj = jnp.asarray(y, jnp.float32)

    def log_like(f):
        # Poisson log-likelihood, log(y!) constant dropped
        return jnp.sum(yj * (f + offset) - jnp.exp(f + offset))

    s = bp.EllipticalSlice(
        log_like, prior_mean=jnp.zeros(n, jnp.float32),
        prior_chol=jnp.asarray(L, jnp.float32), n_chains=8, seed=0)
    s.run_mcmc(4000, theta_0=jnp.zeros(n, jnp.float32), spread=0.1)

    chains = s.get_chain(discard=1000)              # [chains, T, d]
    rhat = np.asarray(bp.gelman_rubin(chains))
    flat = chains.reshape(-1, n)
    f_mean = flat.mean(axis=0)
    rmse_post = float(np.sqrt(np.mean((f_mean - f_true) ** 2)))
    rmse_prior = float(np.sqrt(np.mean(f_true ** 2)))
    n_shrink = float(np.mean(np.asarray(s._history["n_shrink"])))
    print(f"RMSE(posterior mean f) {rmse_post:.3f}  vs prior-mean "
          f"{rmse_prior:.3f}  ({rmse_prior / rmse_post:.1f}x better)")
    print(f"max split-Rhat over {n} latents: {rhat.max():.3f}; "
          f"mean shrink iterations/gen: {n_shrink:.2f}")

    # conjugate sanity: likelihood == const -> exact prior draws
    s0 = bp.EllipticalSlice(
        lambda f: jnp.zeros(()), prior_mean=jnp.zeros(n, jnp.float32),
        prior_chol=jnp.asarray(L, jnp.float32), n_chains=8, seed=1)
    s0.run_mcmc(2000, theta_0=jnp.zeros(n, jnp.float32), spread=0.1)
    prior_flat = s0.get_chain(discard=200, flat=True)
    var_ratio = np.var(np.asarray(prior_flat), axis=0) / np.diag(K)
    print(f"prior-run marginal var / diag(K): "
          f"[{var_ratio.min():.2f}, {var_ratio.max():.2f}]")

    assert rmse_post * 2.0 < rmse_prior, (rmse_post, rmse_prior)
    assert rhat.max() < 1.1, rhat.max()
    assert 0.7 < var_ratio.min() and var_ratio.max() < 1.4, var_ratio
    print("OK")


if __name__ == "__main__":
    main()
