"""8-chain DE-MC-z with snooker updates on the banana posterior.

BASELINE config 2: "Rosenbrock banana posterior, 8-chain DE-MC-z with
snooker updates" — archive-Z proposals + the snooker Jacobian on a curved,
correlated target (SURVEY.md §4.6). Haario's twisted Gaussian has known
marginal moments (E[θ]=0, Var[θ₁]=100), so convergence is checkable.

Run: ``python examples/banana_demcz.py``.
"""

import os

import numpy as np
import jax.numpy as jnp

import bipymc_tpu as bp
from bipymc_tpu.models.targets import banana
from bipymc_tpu.plotting import mc_plot

OUT = os.path.join(os.path.dirname(__file__), "out")


def main():
    log_prob = banana(b=0.03, sigma1=10.0)

    sampler = bp.DeMcZ(log_prob, n_chains=8, seed=3, p_snooker=0.1)
    sampler.run_mcmc(30000, jnp.zeros(2), spread=3.0)

    kept = sampler.get_chain(discard=10000)
    flat = kept.reshape(-1, 2)
    rhat = np.asarray(bp.gelman_rubin(kept))
    ess = float(bp.effective_sample_size(kept))
    snook = sampler.snooker_fraction
    print(f"E[θ1]   = {flat[:, 0].mean():+.2f}  (truth 0)")
    print(f"Var[θ1] = {flat[:, 0].var():.1f}   (truth 100)")
    print(f"E[θ2]   = {flat[:, 1].mean():+.2f}  (truth 0)")
    print(f"R-hat = {np.round(rhat, 3)}, ESS = {ess:,.0f}, "
          f"snooker fraction = {snook:.2f}")

    os.makedirs(OUT, exist_ok=True)
    mc_plot.plot_corner(flat, labels=["θ1", "θ2"], truths=[0.0, 0.0],
                        path=os.path.join(OUT, "banana_corner.png"))
    print(f"plots in {OUT}/")
    assert rhat.max() < 1.1
    assert abs(flat[:, 0].mean()) < 3.0
    assert 60.0 < flat[:, 0].var() < 150.0


if __name__ == "__main__":
    main()
