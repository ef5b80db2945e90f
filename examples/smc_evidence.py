"""SMC: mode weights + model evidence on a separated mixture.

The MCMC zoo cannot self-mix between modes 70σ apart on the headline
target: DREAM-zs holds whatever occupancy its init
gave it, and R̂/ESS are blind to the wrong mode *weights*. The adaptive
tempered SMC sampler (beyond-reference, samplers/smc.py) solves exactly
this: the particle population is annealed from a broad reference down to
the target, so separated modes keep their correct relative mass — and
the telescoped normalising increments give the model evidence for free.

This script builds an UNEQUAL mixture (70/30) whose modes are far too
separated for any untempered sampler, recovers the weights to a few
percent, and checks the log-evidence against the analytic value. For
comparison it runs the same target through DREAM-zs with a deliberately
*wrong* 50/50 stratified init and shows the occupancy never corrects —
the failure mode SMC exists to fix.

Run: ``python examples/smc_evidence.py``.
"""

import jax
import numpy as np
import jax.numpy as jnp

import bipymc_tpu as bp

D = 8
SEP = 6.0                                  # per-dim separation, ~17σ total
WEIGHTS = np.array([0.7, 0.3])
MEANS = np.stack([np.full(D, -SEP / 2), np.full(D, SEP / 2)]).astype(
    np.float32)


def log_mix(x):
    comp = (-0.5 * jnp.sum((x[None, :] - jnp.asarray(MEANS)) ** 2, -1)
            + jnp.log(jnp.asarray(WEIGHTS, jnp.float32)))
    return jax.scipy.special.logsumexp(comp)


def main():
    # --- SMC: anneal 4096 particles from a covering Gaussian reference.
    # The reference-to-target KL is ~15 nats here, so the evidence needs
    # a gentle schedule: CESS target 0.9 (≈35 stages instead of 9) keeps
    # the per-stage weight variance — and with it the log Ẑ Jensen bias
    # — small; 10 rejuvenation moves re-equilibrate after each resample.
    smc = bp.Smc(log_mix, n_particles=4096, seed=0,
                 ref_mean=np.zeros(D), ref_var=np.full(D, SEP ** 2),
                 ess_alpha=0.9, n_moves=10)
    info = smc.run()
    draws = smc.resample()
    frac = float((draws[:, 0] < 0).mean())
    true_logz = 0.5 * D * np.log(2 * np.pi)   # Σ w_k · (2π)^{d/2}
    print(f"SMC: {info['n_stages']} stages, "
          f"beta ladder {np.round(info['beta_ladder'], 3)}")
    print(f"mode weights: {frac:.3f} / {1 - frac:.3f}  (true 0.70 / 0.30)")
    print(f"log evidence: {info['log_evidence']:.3f}  "
          f"(analytic {true_logz:.3f})")
    assert info["reached_one"]
    assert abs(frac - WEIGHTS[0]) < 0.06, frac
    assert abs(info["log_evidence"] - true_logz) < 0.25

    # --- d=48: the regime where everything else degrades. DREAM-zs from
    # a wrong 50/50 init drifts toward the truth only on the slow
    # archive-hop timescale; SMC with the default RW
    # rejuvenation COLLAPSES here (basin-level selection noise); SMC
    # with kernel="hmc" (leapfrog rejuvenation,
    # population-variance mass, cross-stage adapted ε) nails both the
    # weights and the evidence.
    D2 = 48
    ms = jnp.stack([jnp.full((D2,), -SEP / 2), jnp.full((D2,), SEP / 2)])
    lwm = jnp.log(jnp.asarray(WEIGHTS, jnp.float32))

    def log_mix48(x):
        comp = -0.5 * jnp.sum((x[None, :] - ms) ** 2, -1) + lwm
        return jax.scipy.special.logsumexp(comp)

    smc48 = bp.Smc(log_mix48, n_particles=4096, seed=0,
                   ref_mean=np.zeros(D2), ref_var=np.full(D2, SEP ** 2),
                   ess_alpha=0.9, n_moves=5, kernel="hmc")
    info48 = smc48.run()
    frac48 = float((smc48.resample()[:, 0] < 0).mean())
    true48 = 0.5 * D2 * np.log(2 * np.pi)
    print(f"d=48 SMC(kernel='hmc'): weights {frac48:.3f} / "
          f"{1 - frac48:.3f} (true 0.70/0.30), log evidence "
          f"{info48['log_evidence']:.2f} (analytic {true48:.2f}), "
          f"{info48['n_stages']} stages, "
          f"move acceptance {info48['acceptance'].mean():.2f}")
    assert info48["reached_one"]
    assert abs(frac48 - WEIGHTS[0]) < 0.07, frac48
    assert abs(info48["log_evidence"] - true48) < 0.5

    centers = jnp.asarray(np.asarray(ms))[np.arange(64) % 2]
    x0 = centers + 0.5 * jax.random.normal(jax.random.key(1), (64, D2))
    dz = bp.DreamZs(log_mix48, n_chains=64, seed=1)
    dz.run_mcmc(3000, x0)
    frac_dz = float((dz.super_chain[:, -1, 0] < 0).mean())
    print(f"d=48 DREAM-zs, 3000 gens from a 50/50 init: {frac_dz:.3f} / "
          f"{1 - frac_dz:.3f} — still drifting toward 0.70 on the "
          "archive-hop timescale, and no evidence estimate exists")
    assert abs(frac48 - WEIGHTS[0]) < abs(frac_dz - WEIGHTS[0])
    print("OK")


if __name__ == "__main__":
    main()
