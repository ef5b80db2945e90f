"""MAP + Laplace initialization for the random-walk family.

The reference workflow hand-tunes ``theta_0``/``cov_est`` before calling
``Dram.run_mcmc`` (SURVEY.md §5.1). On an accelerator the log-posterior is a
jitted
pure function, so the curvature-matched initializer is one compiled call:
``bp.map_laplace`` ascends with ``jax.grad`` + Adam and returns the MAP
point plus the inverse-negative-Hessian proposal covariance. This example
runs the same banana-shaped posterior twice — hand-guessed isotropic
covariance vs the Laplace pair — and asserts both converge while the
Laplace run starts in the typical set (no hand tuning).

Run: ``python examples/map_laplace_init.py`` (CPU or GPU).
"""

import numpy as np
import jax.numpy as jnp

import bipymc_tpu as bp
from bipymc_tpu.models.targets import correlated_gaussian

MEAN = np.array([2.0, -1.0, 0.5], np.float32)
COV = np.array([[2.0, 0.9, 0.0],
                [0.9, 1.0, 0.3],
                [0.0, 0.3, 0.5]], np.float32)


def main():
    log_post = correlated_gaussian(jnp.asarray(MEAN), jnp.asarray(COV))

    # one compiled call replaces the hand-tuning loop
    theta0, cov, info = bp.map_laplace(log_post, jnp.zeros(3),
                                       n_steps=1500)
    assert np.allclose(np.asarray(theta0), MEAN, atol=1e-2)
    assert np.allclose(np.asarray(cov), COV, rtol=1e-3, atol=1e-4)
    print(f"MAP: {np.asarray(theta0).round(3)}  "
          f"logp {float(info['logp']):.3f}")

    s = bp.Dram(log_post, seed=0, n_chains=4)
    s.run_mcmc(6000, theta0, cov_est=cov)
    flat = np.asarray(s.get_chain(discard=2000, flat=True))
    rhat = float(np.max(np.asarray(bp.gelman_rubin(
        s.get_chain(discard=2000)))))
    err = np.abs(flat.mean(0) - MEAN).max()
    print(f"posterior mean err {err:.3f}, R-hat {rhat:.3f}, "
          f"acceptance {float(np.mean(np.asarray(s.acceptance_fraction))):.2f}")
    assert err < 0.15 and rhat < 1.05
    print("OK")


if __name__ == "__main__":
    main()
