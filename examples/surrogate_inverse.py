"""Inverse problem with a GP surrogate likelihood, 1024 chains, R̂ stop.

BASELINE config 5: "GP-surrogate inverse problem with 1024 sharded chains
and on-device Gelman-Rubin stopping". An "expensive" forward model is
probed at a small design; a GP fit to those scores becomes the surrogate
log-likelihood; 1024 DREAM-zs chains sample it with the streaming R̂ < 1.1
early stop running entirely on device (SURVEY.md §5.4).

On a multi-chip host, pass a chain mesh to shard the 1024 chains
(``DreamZs(..., mesh=chain_mesh())``); single chip runs them vmapped.

Run: ``python examples/surrogate_inverse.py``.
"""

import time
import numpy as np
import jax.numpy as jnp

import bipymc_tpu as bp
from bipymc_tpu.gp.regressor import GpRegressor

TRUE_THETA = np.array([1.2, -0.7], dtype=np.float32)


def forward_model(theta):
    """Stand-in for an expensive simulation: observable at 8 sensor sites."""
    t = np.linspace(0.0, 1.0, 8)
    return theta[0] * np.exp(-2.0 * t) + theta[1] * t ** 2


def main():
    rng = np.random.default_rng(11)
    sigma_obs = 0.05
    y_obs = forward_model(TRUE_THETA) + rng.normal(0, sigma_obs, 8)

    def expensive_log_like(theta):
        r = forward_model(theta) - y_obs
        return -0.5 * float(r @ r) / sigma_obs ** 2

    # --- design + GP surrogate of the log-likelihood surface -------------
    n_design = 256
    design = rng.uniform(-2.0, 2.0, (n_design, 2)).astype(np.float32)
    scores = np.array([expensive_log_like(t) for t in design],
                      dtype=np.float32)
    t0 = time.time()
    # normalize_y: the log-likelihood surface spans ~1e5, far outside the
    # SE prior's O(σ_f) amplitude assumption
    gp = GpRegressor(normalize_y=True)
    params, lml = gp.optimize(design, scores, steps=300, lr=0.05)
    fit = gp.fit(design, scores, params=params)
    print(f"surrogate fit on {n_design} runs: log-ML={float(lml):.1f} "
          f"({time.time() - t0:.1f}s)")

    surrogate = gp.surrogate_log_like(fit)

    def log_post(theta):
        # surrogate + prior keeping chains inside the trained box
        return surrogate(theta) - 0.5 * jnp.sum((theta / 2.0) ** 4)

    # --- 1024 chains, on-device streaming R-hat stop ----------------------
    sampler = bp.DreamZs(log_post, n_chains=1024, seed=0)
    t0 = time.time()
    info = sampler.run_mcmc_until(jnp.zeros(2), rhat_tol=1.1, chunk=100,
                                  max_chunks=100, spread=1.0)
    dt = time.time() - t0
    print(f"stopped after {int(info['steps'])} generations "
          f"({dt:.1f}s), R-hat = {np.round(info['rhat'], 3)}")

    post_mean = info["mean"].mean(axis=0)
    print(f"posterior mean θ = {np.round(post_mean, 3)} "
          f"(truth {TRUE_THETA})")
    assert info["rhat"].max() < 1.1
    assert np.all(np.abs(post_mean - TRUE_THETA) < 0.2)


if __name__ == "__main__":
    main()
