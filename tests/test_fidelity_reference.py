"""Fidelity contract: distributional equivalence with reference semantics.

BASELINE.json:5 requires sampler trajectories to match the seeded NumPy
reference within tolerance on shared test posteriors. Exact bit-stream
match is impossible across RNGs (Mersenne-Twister vs threefry —
SURVEY.md §9 "Fidelity vs NumPy seeding"), so the contract is
distributional: the independently written reference-semantics NumPy
implementations in benchmarks/reference_numpy.py and the accelerator-native
samplers must recover the same posterior moments on shared targets,
each within its own Monte-Carlo error (SURVEY.md §6).
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest

import bipymc_tpu as bp
from bipymc_tpu.models.targets import correlated_gaussian

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "benchmarks"))
from reference_numpy import NumpyDram, NumpyDreamZs  # noqa: E402

MEAN = np.array([1.0, -1.0])
COV = np.array([[2.0, 0.8], [0.8, 1.0]])


def np_log_prob(theta):
    r = np.asarray(theta) - MEAN
    return float(-0.5 * r @ np.linalg.solve(COV, r))


@pytest.fixture(scope="module")
def jax_log_prob():
    return correlated_gaussian(MEAN, COV)


class TestDramFidelity:
    """BASELINE config 1: 2D correlated Gaussian, DRAM."""

    def test_moments_match(self, jax_log_prob):
        ref = NumpyDram(np_log_prob, seed=5)
        hist_ref = ref.run(np.zeros(2), 12000)[3000:]

        s = bp.Dram(jax_log_prob, seed=5, n_chains=1)
        s.run_mcmc(12000, jnp.zeros(2), cov_est=jnp.eye(2))
        hist_jax = s.chain[3000:]

        for hist, label in ((hist_ref, "reference"), (hist_jax, "jax")):
            err_mean = np.abs(hist.mean(0) - MEAN)
            err_cov = np.abs(np.cov(hist.T) - COV)
            assert err_mean.max() < 0.25, (label, err_mean)
            assert err_cov.max() < 0.6, (label, err_cov)

        # cross-implementation agreement (both are MC estimates)
        assert np.abs(hist_ref.mean(0) - hist_jax.mean(0)).max() < 0.35
        assert np.abs(np.cov(hist_ref.T) - np.cov(hist_jax.T)).max() < 0.8


class TestDreamZsFidelity:
    """Shared-target moment agreement for the ensemble family."""

    def test_moments_match(self, jax_log_prob):
        n_chains, n_gens, burn = 8, 2500, 1000
        rng = np.random.default_rng(2)
        x0 = MEAN + rng.standard_normal((n_chains, 2))
        z0 = MEAN + rng.standard_normal((16, 2))

        ref = NumpyDreamZs(np_log_prob, n_chains, burnin_gens=burn, seed=2)
        hist_ref = ref.run(x0, z0, n_gens)[burn:].reshape(-1, 2)

        s = bp.DreamZs(jax_log_prob, n_chains=n_chains, seed=2,
                       burnin_gens=burn, n_archive_init=16)
        s.run_mcmc(n_gens, jnp.asarray(x0, jnp.float32))
        hist_jax = s.get_chain(discard=burn, flat=True)

        for hist, label in ((hist_ref, "reference"), (hist_jax, "jax")):
            err_mean = np.abs(hist.mean(0) - MEAN)
            err_cov = np.abs(np.cov(hist.T) - COV)
            assert err_mean.max() < 0.25, (label, err_mean)
            assert err_cov.max() < 0.6, (label, err_cov)

        assert np.abs(hist_ref.mean(0) - hist_jax.mean(0)).max() < 0.35

    def test_acceptance_rates_comparable(self, jax_log_prob):
        """Same algorithm → similar acceptance behaviour on one target."""
        n_chains, n_gens = 8, 1500
        rng = np.random.default_rng(9)
        x0 = MEAN + rng.standard_normal((n_chains, 2))
        z0 = MEAN + rng.standard_normal((16, 2))

        ref = NumpyDreamZs(np_log_prob, n_chains, burnin_gens=500, seed=9)
        hist_ref = ref.run(x0, z0, n_gens)
        # acceptance proxy: fraction of moved states after burn-in
        moved_ref = np.mean(
            np.any(hist_ref[501:] != hist_ref[500:-1], axis=-1))

        s = bp.DreamZs(jax_log_prob, n_chains=n_chains, seed=9,
                       burnin_gens=500, n_archive_init=16)
        s.run_mcmc(n_gens, jnp.asarray(x0, jnp.float32))
        acc_tpu = float(np.mean(
            np.asarray(s._history["accepted"])[500:]))

        assert abs(moved_ref - acc_tpu) < 0.15, (moved_ref, acc_tpu)
