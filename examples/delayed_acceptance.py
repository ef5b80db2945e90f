"""Delayed acceptance: exact posterior at a fraction of the simulator calls.

The surrogate workflow of examples/surrogate_inverse.py trades bias for
speed — the chains sample the GP's approximation. Delayed acceptance
(Christen & Fox 2005; samplers/da.py) keeps the speed AND removes the
bias: the GP pre-screens every proposal on device, the "expensive"
simulator (here a host-side NumPy function behind
``external_log_like_masked``) is only called on promoted rows, and the
resulting chain targets the exact posterior.

This example counts the simulator calls to show the saving, and checks
the posterior against the exact truth.

Run: ``python examples/delayed_acceptance.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp

import bipymc_tpu as bp
from bipymc_tpu.gp.regressor import GpRegressor

TRUE_THETA = np.array([1.2, -0.7], dtype=np.float32)
N_CHAINS, N_STEPS = 16, 3000


def main():
    rng = np.random.default_rng(11)
    sigma_obs = 0.05
    t = np.linspace(0.0, 1.0, 8)

    def forward(theta):
        return theta[0] * np.exp(-2.0 * t) + theta[1] * t ** 2

    y_obs = forward(TRUE_THETA) + rng.normal(0, sigma_obs, 8)
    calls = {"n": 0}

    def expensive_log_like(theta):
        calls["n"] += 1                       # the metered simulator
        r = forward(theta) - y_obs
        return float(-0.5 * (r @ r) / sigma_obs ** 2)

    # --- GP surrogate from a small design ---------------------------------
    design = rng.uniform(-2.0, 2.0, (256, 2)).astype(np.float32)
    scores = np.array([expensive_log_like(th) for th in design], np.float32)
    design_calls = calls["n"]
    gp = GpRegressor(normalize_y=True)
    params, _ = gp.optimize(design, scores, steps=300, lr=0.05)
    fit = gp.fit(design, scores, params=params)
    surrogate = gp.surrogate_log_like(fit)

    # --- delayed acceptance: exact via masked host callback ---------------
    exact = bp.external_log_like_masked(expensive_log_like)
    s = bp.DelayedAcceptance(exact, surrogate, seed=0, n_chains=N_CHAINS,
                             masked_exact=True)
    s.run_mcmc(N_STEPS, jnp.zeros(2), cov_est=jnp.eye(2) * 0.05)

    flat = s.get_chain(discard=1000, flat=True)
    post_mean = flat.mean(0)
    sim_calls = calls["n"] - design_calls - N_CHAINS   # minus init evals
    total_proposals = N_STEPS * N_CHAINS
    print(f"posterior mean θ = {np.round(post_mean, 3)} "
          f"(truth {TRUE_THETA})")
    print(f"simulator calls: {sim_calls} of {total_proposals} proposals "
          f"({100 * sim_calls / total_proposals:.1f}% — the GP screened "
          f"out the rest); promotion rate "
          f"{float(s.promotion_fraction.mean()):.2f}, acceptance "
          f"{float(s.acceptance_fraction.mean()):.2f}")

    assert np.all(np.abs(post_mean - TRUE_THETA) < 0.1)
    assert sim_calls < 0.6 * total_proposals
    # stage-2 survival: a good surrogate rarely overturns a promotion
    h = s._history
    survive = h["accepted"].sum() / max(h["promoted"].sum(), 1)
    print(f"stage-2 survival of promotions: {survive:.2f}")
    assert survive > 0.6


if __name__ == "__main__":
    main()
