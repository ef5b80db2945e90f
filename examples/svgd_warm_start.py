"""SVGD as a fast approximate posterior and an MCMC warm start.

Two roles for the deterministic particle family (samplers/svgd.py):

1. **Approximate posterior in its own right** — a few hundred
   kernel-matrix steps transport N particles onto the posterior; mean
   comes out tight, covariance right up to SVGD's documented mild
   underestimation.
2. **Warm-start population for the MCMC zoo** — the final particle
   cloud IS an overdispersed-but-in-the-typical-set [n_chains, d]
   ``theta_0`` for DREAM-zs, replacing burn-in from a prior ball. The
   MCMC run then sharpens the variational cloud into exact posterior
   samples (asserted: the warm-started run reaches R̂ < 1.05 and fixes
   SVGD's covariance bias).

Run: ``python examples/svgd_warm_start.py`` (CPU or GPU).
"""

import numpy as np
import jax.numpy as jnp

import bipymc_tpu as bp
from bipymc_tpu.models.targets import correlated_gaussian

MEAN = np.array([2.0, -1.0, 0.5, 1.5], np.float32)
A = np.array([[2.0, 0.9, 0.0, 0.2],
              [0.9, 1.0, 0.3, 0.0],
              [0.0, 0.3, 0.5, 0.1],
              [0.2, 0.0, 0.1, 0.8]], np.float32)
COV = A @ A.T  # SPD, correlated


def main():
    log_post = correlated_gaussian(jnp.asarray(MEAN), jnp.asarray(COV))

    # --- role 1: the variational cloud itself -------------------------
    sv = bp.Svgd(log_post, n_particles=128, seed=0, step_size=0.3)
    info = sv.run(600, theta_0=jnp.zeros(4), spread=2.0)
    cloud = sv.particles
    mean_err = np.abs(cloud.mean(0) - MEAN).max()
    cov_ratio = np.diag(np.cov(cloud.T)) / np.diag(COV)
    print(f"SVGD: phi_rms {info['phi_rms']:.4f}, mean err {mean_err:.3f}, "
          f"diag-cov ratio {cov_ratio.round(2)}")
    assert mean_err < 0.3
    # covariance is resolved but (documented) biased low at N=128
    assert np.all(cov_ratio > 0.4) and np.all(cov_ratio < 1.3)

    # --- role 2: warm-start DREAM-zs from the cloud --------------------
    s = bp.DreamZs(log_post, n_chains=128, seed=1)
    s.run_mcmc(3000, jnp.asarray(cloud))   # cloud IS theta_0 [n_chains, d]
    chain = s.get_chain(discard=1000)
    flat = np.asarray(s.get_chain(discard=1000, flat=True))
    rhat = float(np.max(np.asarray(bp.gelman_rubin(chain))))
    err = np.abs(flat.mean(0) - MEAN).max()
    cov_err = np.abs(np.cov(flat.T) - COV).max() / np.abs(COV).max()
    print(f"DREAM-zs warm-started: R-hat {rhat:.3f}, mean err {err:.3f}, "
          f"rel cov err {cov_err:.3f}")
    assert rhat < 1.05 and err < 0.3 and cov_err < 0.2
    print("OK")


if __name__ == "__main__":
    main()
