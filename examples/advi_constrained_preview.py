"""ADVI preview + constrained parameters: the cheap-first workflow.

The reference workflow points an MCMC sampler straight at the
log-likelihood and waits (SURVEY.md §5.1). This example shows the
cheap-first composition the variational family enables:

1. bound the physics parameters with ``bp.constrain`` (rate > 0,
   efficiency in (0, 1)) so every gradient method sees a smooth
   unconstrained target with the exact log-Jacobian folded in;
2. fit ``bp.Advi`` (seconds — one vmapped multi-restart Adam program)
   to get a variance-aware (μ, Σ) preview of the posterior;
3. hand ``advi.init_pair()`` to DRAM as ``theta_0``/``cov_est`` — the
   exact-MCMC run then starts in the typical set with a posterior-shaped
   proposal, and its moments CORRECT the variational bias.

Self-asserting: the ADVI preview lands near the truth, the warm-started
DRAM run recovers it within MC tolerance, and both honor the bounds.

Run: ``python examples/advi_constrained_preview.py`` (CPU or GPU).
"""

import numpy as np
import jax.numpy as jnp

import bipymc_tpu as bp

# toy decay model: counts_i ~ Poisson-ish Gaussian with mean
# eff * N0 * exp(-rate * t_i); infer (rate > 0, eff in (0,1))
RATE_TRUE, EFF_TRUE, N0 = 0.35, 0.8, 1000.0
T_OBS = np.linspace(0.5, 8.0, 24)


def make_log_post(t, y, sigma):
    t = jnp.asarray(t, jnp.float32)
    y = jnp.asarray(y, jnp.float32)

    def log_post(theta):
        rate, eff = theta[0], theta[1]
        mu = eff * N0 * jnp.exp(-rate * t)
        return -0.5 * jnp.sum((y - mu) ** 2) / sigma**2

    return log_post


def main():
    rng = np.random.default_rng(7)
    sigma = 8.0
    y = (EFF_TRUE * N0 * np.exp(-RATE_TRUE * T_OBS)
         + rng.normal(0.0, sigma, T_OBS.size))
    log_post = make_log_post(T_OBS, y, sigma)

    # 1. bound the support; sample/fit in unconstrained space
    t = bp.constrain(lower=[0.0, 0.0], upper=[np.inf, 1.0])
    lp_u = bp.transform_log_prob(log_post, t)

    # 2. ADVI preview (full-rank: rate and eff are strongly correlated
    #    through the product eff·exp(-rate t))
    a = bp.Advi(lp_u, n_restarts=4, seed=0, full_rank=True,
                step_size=0.05)
    info = a.run(3000, theta_0=t.inverse(jnp.array([0.2, 0.5])),
                 spread=0.5)
    preview = np.asarray(t.forward(a.mean))
    print(f"ADVI preview (elbo {info['elbo']:.1f}): "
          f"rate {preview[0]:.3f}  eff {preview[1]:.3f}")
    assert abs(preview[0] - RATE_TRUE) < 0.05
    assert abs(preview[1] - EFF_TRUE) < 0.1

    # 3. exact MCMC warm-started from the variational pair
    theta0_u, cov_u = a.init_pair()
    s = bp.Dram(lp_u, seed=1, n_chains=8)
    s.run_mcmc(6000, theta0_u, cov_est=cov_u)
    th = np.asarray(t.forward(s.get_chain(discard=2000, flat=True)))
    assert np.all(th[:, 0] > 0) and np.all((th[:, 1] > 0) & (th[:, 1] < 1))
    mean = th.mean(0)
    print(f"DRAM posterior:  rate {mean[0]:.3f} ± {th[:, 0].std():.3f}  "
          f"eff {mean[1]:.3f} ± {th[:, 1].std():.3f}  "
          f"accept {float(np.mean(s.acceptance_fraction)):.2f}")
    assert abs(mean[0] - RATE_TRUE) < 0.05
    assert abs(mean[1] - EFF_TRUE) < 0.1
    print("OK")


if __name__ == "__main__":
    main()
