"""Golden-trajectory regression tests (SURVEY.md §6 build-side additions).

Each sampler family runs a short fixed-seed trajectory on the CPU backend;
the result is compared elementwise against a committed golden file. This
pins the exact semantics of every step function — any change to proposal
math, accept rules, adaptation schedules, or RNG key discipline shows up
as a diff here before it can silently shift posteriors.

Regenerate (after an *intentional* semantic change) with:
    python tests/test_golden.py --regen
"""

import os

if __name__ == "__main__":        # direct invocation (--regen) bypasses
    import jax                    # conftest — pin the CPU backend the same
    jax.config.update("jax_platforms", "cpu")  # way so goldens match tests

import numpy as np
import jax.numpy as jnp
import pytest

import bipymc_tpu as bp
from bipymc_tpu.models.targets import correlated_gaussian, banana

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

MEAN = np.array([0.5, -0.5])
COV = np.array([[1.0, 0.3], [0.3, 0.5]])


def _runs():
    log_g = correlated_gaussian(MEAN, COV)
    log_b = banana()
    yield ("metropolis", lambda: bp.Metropolis(log_g, seed=7, n_chains=2)
           .run_mcmc(50, jnp.zeros(2), cov_est=jnp.eye(2)))
    yield ("am", lambda: bp.AdaptiveMetropolis(log_g, seed=7, n_chains=2)
           .run_mcmc(50, jnp.zeros(2), cov_est=jnp.eye(2)))
    yield ("dr", lambda: bp.DrMetropolis(log_g, seed=7, n_chains=2)
           .run_mcmc(50, jnp.zeros(2), cov_est=jnp.eye(2)))
    yield ("dram", lambda: bp.Dram(log_g, seed=7, n_chains=2)
           .run_mcmc(50, jnp.zeros(2), cov_est=jnp.eye(2)))
    yield ("demc", lambda: bp.DeMc(log_g, n_chains=8, seed=7)
           .run_mcmc(50, jnp.zeros(2), spread=1.0))
    yield ("demcz", lambda: bp.DeMcZ(log_b, n_chains=8, seed=7,
                                     n_archive_init=16)
           .run_mcmc(50, jnp.zeros(2), spread=1.0))
    yield ("dreamzs", lambda: bp.DreamZs(log_b, n_chains=8, seed=7,
                                         n_archive_init=16)
           .run_mcmc(50, jnp.zeros(2), spread=1.0))
    # the fused Pallas engine (interpret mode here) after a 20-generation
    # per-generation burn-in, so drift in the kernel math shows up here
    yield ("dreamzs_pallas", lambda: bp.DreamZs(
        log_b, n_chains=8, seed=7, n_archive_init=16, burnin_gens=20,
        fused=True).run_mcmc(50, jnp.zeros(2), spread=1.0))


@pytest.mark.parametrize("name,run", list(_runs()),
                         ids=[n for n, _ in _runs()])
def test_golden_trajectory(name, run):
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip(f"golden file missing — run `python {__file__} --regen`")
    sampler = run()
    got = sampler.super_chain.astype(np.float32)
    want = np.load(path)["chain"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               err_msg=f"{name} trajectory drifted")


def regen():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, run in _runs():
        chain = run().super_chain.astype(np.float32)
        np.savez(os.path.join(GOLDEN_DIR, f"{name}.npz"), chain=chain)
        print(f"wrote golden/{name}.npz {chain.shape}")


if __name__ == "__main__":
    import sys
    if "--regen" in sys.argv:
        regen()
