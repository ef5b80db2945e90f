"""Sparse-GP surrogate inverse problem — past the exact GP's O(n³) wall.

The config-5 workflow (examples/surrogate_inverse.py) with a design too
large for a full Cholesky to be the right tool: n = 4096 forward-model
probes are distilled by a Titsias-VFE sparse GP (gp/sparse.py) with
m = 64 inducing points — O(n·m²) fit, hyperparameters AND inducing
inputs trained jointly by Adam on the collapsed ELBO — and the resulting
O(m²)-per-θ surrogate drives 1024 DREAM-zs chains to an on-device
R̂ < 1.1 stop.

On a multi-chip host the ELBO itself data-parallelises
(``gp.sparse.elbo_sharded``: sufficient statistics psum'd over the chain
mesh) and the chains shard with ``DreamZs(..., mesh=chain_mesh())``.

Run: ``python examples/sparse_gp_surrogate.py``.
"""

import time
import numpy as np
import jax
import jax.numpy as jnp

import bipymc_tpu as bp
from bipymc_tpu.gp.sparse import SparseGpRegressor

TRUE_THETA = np.array([1.2, -0.7], dtype=np.float32)


def forward_model(theta):
    """Stand-in for an expensive simulation: observable at 8 sensor sites.
    Vectorised over a [n, 2] batch of parameter draws."""
    t = np.linspace(0.0, 1.0, 8)
    return (theta[:, :1] * np.exp(-2.0 * t)[None, :]
            + theta[:, 1:2] * (t ** 2)[None, :])


def main():
    rng = np.random.default_rng(11)
    sigma_obs = 0.05
    y_obs = forward_model(TRUE_THETA[None, :])[0] + rng.normal(0, sigma_obs, 8)

    # --- big design: 4096 probes of the forward model ---------------------
    n_design = 4096
    design = rng.uniform(-2.0, 2.0, (n_design, 2)).astype(np.float32)
    r = forward_model(design) - y_obs[None, :]
    scores = (-0.5 * np.sum(r * r, axis=1) / sigma_obs ** 2).astype(np.float32)

    # --- sparse fit: m = 64 inducing points, joint hyper+Z training -------
    t0 = time.time()
    gp = SparseGpRegressor(normalize_y=True)
    (params, z), elbo = gp.optimize(jnp.asarray(design), jnp.asarray(scores),
                                    m=64, steps=300, lr=0.05,
                                    key=jax.random.key(0))
    fit = gp.fit(jnp.asarray(design), jnp.asarray(scores), z, params)
    print(f"sparse fit on {n_design} runs (m=64): ELBO={elbo:.1f} "
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

    # --- PSIS correction: surrogate posterior → exact posterior ----------
    # The chains sampled the GP's approximation of the log-likelihood.
    # Importance-reweight the kept draws to the EXACT posterior; the
    # Pareto-k̂ certifies whether the surrogate was good enough.
    sampler.run_mcmc(300)          # continuation: collect a kept history
    draws = sampler.get_chain(discard=50, flat=True)[::64]    # thin
    y_obs_j = jnp.asarray(y_obs, jnp.float32)
    t_j = jnp.linspace(0.0, 1.0, 8, dtype=jnp.float32)

    def exact_log_post(theta):
        pred = theta[0] * jnp.exp(-2.0 * t_j) + theta[1] * t_j ** 2
        r = pred - y_obs_j
        return (-0.5 * jnp.sum(r * r) / sigma_obs ** 2
                - 0.5 * jnp.sum((theta / 2.0) ** 4))

    out = bp.surrogate_reweight(jnp.asarray(draws), exact_log_post,
                                log_post)
    print(f"PSIS: k-hat = {float(out['khat']):.3f} "
          f"(reliable: {bool(out['reliable'])}), "
          f"IS-ESS = {float(out['ess']):.0f} of {draws.shape[0]}, "
          f"exact-posterior mean = {np.round(np.asarray(out['mean']), 3)}")
    assert bool(out["reliable"]), float(out["khat"])
    assert np.all(np.abs(np.asarray(out["mean"]) - TRUE_THETA) < 0.2)


if __name__ == "__main__":
    main()
