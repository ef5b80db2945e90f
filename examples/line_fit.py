"""Fit a line to noisy data with DRAM — the reference's canonical example.

The reference's `examples/` opens with a slope/intercept line fit
(SURVEY.md §3 "Examples": "Line-fit to noisy data"). Workflow: define
``log_like(theta)`` → construct sampler → ``run_mcmc`` → inspect chain
(SURVEY.md §2 L6).

Run: ``python examples/line_fit.py`` (CPU or GPU; plots to examples/out/).
"""

import os

import numpy as np
import jax.numpy as jnp

import bipymc_tpu as bp
from bipymc_tpu.models.targets import line_fit_log_like
from bipymc_tpu.plotting import mc_plot

OUT = os.path.join(os.path.dirname(__file__), "out")

TRUE_M, TRUE_C, SIGMA = 2.5, -1.0, 1.0


def main():
    rng = np.random.default_rng(42)
    x = np.linspace(0.0, 10.0, 60)
    y = TRUE_M * x + TRUE_C + rng.normal(0.0, SIGMA, x.size)

    log_like = line_fit_log_like(x, y, sigma=SIGMA)

    sampler = bp.Dram(log_like, seed=0, n_chains=4)
    sampler.run_mcmc(8000, jnp.array([0.0, 0.0]), cov_est=jnp.eye(2) * 0.1)

    flat = sampler.get_chain(discard=3000, flat=True)
    mean = flat.mean(axis=0)
    std = flat.std(axis=0)
    rhat = np.asarray(bp.gelman_rubin(sampler.get_chain(discard=3000)))
    print(f"slope     m = {mean[0]:+.3f} ± {std[0]:.3f}   (truth {TRUE_M})")
    print(f"intercept c = {mean[1]:+.3f} ± {std[1]:.3f}   (truth {TRUE_C})")
    print(f"R-hat = {np.round(rhat, 3)}, "
          f"acceptance = {np.round(sampler.acceptance_fraction, 2)}")

    os.makedirs(OUT, exist_ok=True)
    mc_plot.plot_corner(flat, labels=["m", "c"], truths=[TRUE_M, TRUE_C],
                        path=os.path.join(OUT, "line_fit_corner.png"))
    mc_plot.plot_trace(sampler.super_chain[:, ::10], labels=["m", "c"],
                       path=os.path.join(OUT, "line_fit_trace.png"))
    print(f"plots in {OUT}/")
    assert abs(mean[0] - TRUE_M) < 0.15 and abs(mean[1] - TRUE_C) < 0.6


if __name__ == "__main__":
    main()
