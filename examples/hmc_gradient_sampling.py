"""Gradient-based sampling: HMC on a funnel, HMC over a GP surrogate.

The reference zoo is random-walk/DE-based; this framework adds a gradient
family (samplers/hmc.py) because on an accelerator the target's gradient is
free —
``jax.value_and_grad`` of the same ``log_prob`` every other sampler
consumes — and the GP surrogate likelihood (BASELINE config 5's
machinery) is differentiable end-to-end. Two demonstrations:

1. An anisotropic Gaussian with a 10^4 dynamic range in scales. A
   random-walk sampler must compromise on one step size; HMC's adapted
   diagonal mass resolves each dimension independently, and dual
   averaging lands the acceptance rate at its 0.8 target without tuning.
2. The config-5 composition with gradients: fit a GP to scored samples of
   an inverse problem, then run HMC directly on the surrogate posterior —
   the leapfrog rides ``jax.grad`` straight through the GP predict.

Run: ``python examples/hmc_gradient_sampling.py`` (CPU or GPU).
"""

import numpy as np
import jax
import jax.numpy as jnp

import bipymc_tpu as bp
from bipymc_tpu.gp import GpRegressor


def anisotropic_demo():
    var = np.array([100.0, 1.0, 0.01], np.float32)

    def log_post(th):
        return -0.5 * jnp.sum(th * th / jnp.asarray(var, th.dtype))

    s = bp.Hmc(log_post, n_chains=16, seed=0, n_leapfrog=16,
               adapt_gens=800, mass_interval=100)
    s.run_mcmc(2000, jnp.zeros(3), spread=1.0)

    flat = s.get_chain(discard=1000, flat=True)
    sample_var = flat.var(0)
    acc = float(s.acceptance_fraction.mean())
    inv_mass = np.asarray(s.final_state.inv_mass).mean(0)
    print(f"anisotropic: sample var {sample_var.round(3)} "
          f"(truth {var}), accept {acc:.2f}")
    print(f"  adapted inverse mass (mean over chains): "
          f"{inv_mass.round(3)}")
    # every scale resolved to within 2x, acceptance near the 0.8 target
    assert np.all(sample_var / var > 0.5) and np.all(sample_var / var < 2.0)
    assert 0.6 < acc < 0.95
    # the mass learned the 10^4 dynamic range
    assert inv_mass[0] / inv_mass[2] > 1e2


def gp_surrogate_demo():
    # expensive "simulator": score(theta) peaks at (0.6, -0.4)
    truth = np.array([0.6, -0.4], np.float32)
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.uniform(-2, 2, (96, 2)), jnp.float32)
    y = -jnp.sum((X - jnp.asarray(truth)) ** 2, axis=1)

    gp = GpRegressor(normalize_y=True)
    fit = gp.fit(X, y)
    surrogate = gp.surrogate_log_like(fit)
    # SE surrogate reverts to its mean outside the data: add the prior
    log_post = lambda th: 4.0 * surrogate(th) - 0.125 * jnp.sum(th * th)

    s = bp.Hmc(log_post, n_chains=8, seed=2, n_leapfrog=8,
               adapt_gens=300, step_size=0.05)
    s.run_mcmc(1000, jnp.zeros(2), spread=0.5)
    flat = s.get_chain(discard=500, flat=True)
    err = np.abs(flat.mean(0) - truth).max()
    print(f"GP-surrogate HMC: posterior mean {flat.mean(0).round(3)} "
          f"(truth {truth}), err {err:.3f}")
    assert err < 0.3


def nuts_demo():
    """NUTS removes the last knob (trajectory length L): on a target
    whose scales differ 100x per dimension, depth self-tunes — and the
    reported tree depth is the diagnostic that it neither collapsed
    (depth 0-1: step size too big) nor saturated (depth = max_depth:
    step size too small or geometry pathological)."""
    var = np.array([100.0, 1.0, 0.01], np.float32)

    def log_post(th):
        return -0.5 * jnp.sum(th * th / jnp.asarray(var, th.dtype))

    s = bp.Nuts(log_post, n_chains=16, seed=4, max_depth=8,
                adapt_gens=600, mass_interval=100)
    s.run_mcmc(1500, jnp.zeros(3), spread=1.0)
    flat = s.get_chain(discard=800, flat=True)
    sample_var = flat.var(0)
    depth = np.asarray(s._history["tree_depth"])[800:]
    nlf = np.asarray(s._history["n_leapfrog"])[800:]
    print(f"NUTS: sample var {sample_var.round(3)} (truth {var}), "
          f"mean tree depth {depth.mean():.1f}, "
          f"mean leapfrogs/gen {nlf.mean():.1f}")
    assert np.all(sample_var / var > 0.5) and np.all(sample_var / var < 2.0)
    assert 1.0 < depth.mean() < 7.5       # self-tuned, not collapsed/capped


def chees_demo():
    """ChEES-HMC tunes the trajectory length from the CHAIN POPULATION
    instead of a per-chain tree: every generation is one fixed-cost
    batched leapfrog whose (shared) step count is known before it
    starts — the accelerator-native way to get NUTS's no-knobs
    property. With mass adaptation ON, the mass whitens the scales and
    the adapted T settles near the whitened half-period O(π·ε-units),
    so the frozen leapfrog count stays small — self-tuned economy, not
    a failure to adapt (samplers/chees.py docstring)."""
    var = np.array([100.0, 1.0, 0.01], np.float32)

    def log_post(th):
        return -0.5 * jnp.sum(th * th / jnp.asarray(var, th.dtype))

    s = bp.Chees(log_post, n_chains=64, seed=6, adapt_gens=600,
                 mass_interval=100)
    s.run_mcmc(1500, jnp.zeros(3), spread=1.0)
    flat = s.get_chain(discard=800, flat=True)
    sample_var = flat.var(0)
    nlf = np.asarray(s._history["n_leapfrog"])[800:]
    print(f"ChEES: sample var {sample_var.round(3)} (truth {var}), "
          f"T {s.trajectory_length:.2f}, "
          f"mean leapfrogs/gen {nlf.mean():.1f} (shared by all chains)")
    assert np.all(sample_var / var > 0.5) and np.all(sample_var / var < 2.0)


def main():
    anisotropic_demo()
    gp_surrogate_demo()
    nuts_demo()
    chees_demo()
    print("OK")


if __name__ == "__main__":
    main()
