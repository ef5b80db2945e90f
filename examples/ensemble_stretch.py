"""Affine-invariant (stretch-move) ensemble sampling of a skewed target.

The Goodman-Weare stretch move is invariant to affine reparameterisation:
strongly anisotropic/correlated targets that choke a random-walk sampler
need no tuning at all. Beyond-reference extra (emcee is the design
precedent, PAPERS.md).

Run: ``python examples/ensemble_stretch.py``.
"""

import numpy as np
import jax.numpy as jnp

import bipymc_tpu as bp
from bipymc_tpu.models.targets import correlated_gaussian

# a 5-d Gaussian with condition number ~1e4 — brutal for untuned RW-MH
MEAN = np.arange(5, dtype=np.float32)
SCALES = np.array([100.0, 10.0, 1.0, 0.1, 0.01], dtype=np.float32)
COV = np.diag(SCALES ** 2)


def main():
    log_prob = correlated_gaussian(MEAN, COV)
    s = bp.EnsembleSampler(log_prob, n_chains=64, seed=0)
    info = s.run_mcmc_until(jnp.asarray(MEAN), rhat_tol=1.05, chunk=500,
                            max_chunks=100, spread=1.0)
    print(f"converged in {int(info['steps'])} generations, "
          f"R-hat = {np.round(info['rhat'], 3)}")
    s.run_mcmc(4000)
    flat = s.get_chain(discard=1000, flat=True)
    std_err = np.abs(flat.std(0) - SCALES) / SCALES
    print("posterior std relative error per dim:", np.round(std_err, 2))
    assert info["rhat"].max() < 1.05
    assert np.all(std_err < 0.25)

    # joint-convergence + stationarity checks on the kept history:
    # multivariate R-hat_p (Brooks-Gelman) bounds EVERY linear
    # combination of the 5 badly-scaled dims at once; Geweke z flags any
    # chain still drifting from its start (|z| < ~3 when stationary)
    ch = s.get_chain(discard=1000)
    r_p = float(bp.multivariate_rhat(ch))
    z_max = float(np.abs(np.asarray(bp.geweke(ch))).max())
    print(f"multivariate R-hat_p = {r_p:.3f}, max |Geweke z| = {z_max:.1f}")
    assert r_p < 1.1

    # the walk move (emcee WalkMove): same affine invariance via the
    # complementary half's sample covariance instead of 1-d stretches —
    # no `a` to tune, one d x d Cholesky per half-update
    w = bp.EnsembleSampler(log_prob, n_chains=64, seed=1, move="walk")
    w.run_mcmc(4000, jnp.asarray(MEAN), spread=1.0)
    wflat = w.get_chain(discard=1000, flat=True)
    w_err = np.abs(wflat.std(0) - SCALES) / SCALES
    print("walk-move posterior std relative error:", np.round(w_err, 2))
    print("walk-move acceptance:", float(w.acceptance_fraction.mean()))
    assert np.all(w_err < 0.3)


if __name__ == "__main__":
    main()
