"""Bayesian model comparison: SMC evidence AND PSIS-LOO, side by side.

The capstone workflow the reference's inverse-problem stack cannot do:
two candidate forward models explain the same data; sampling each
posterior says how well each fits AT ITS BEST PARAMETERS, but the
model-selection question needs the EVIDENCE — the likelihood integrated
over the prior, which automatically charges the extra-parameter Occam
rent. `bp.Smc` prices it directly: the annealing pass from the prior to
each posterior telescopes the normalising constants, so

    log BF = log Z_A − log Z_B

drops out of the same machinery that samples the posterior. Model A
(exponential decay + quadratic — the truth, 2 parameters) and model B
(a full quadratic polynomial, 3 parameters) both track the data
visually; the Bayes factor resolves the choice and the printout
decomposes it into best-fit difference vs Occam penalty.

The second half answers the same question the other way: PSIS-LOO
(`bp.loo` / `bp.loo_compare`) estimates each model's out-of-sample
predictive density from the SAME posterior draws — no refits, no
integration over the prior. Evidence and LOO can disagree (evidence
charges prior spread, LOO only predictive skill); here they agree, and
the paired-difference SE says whether the LOO gap is statistically
real.

A caveat learned the hard way (and why this example uses the exact
likelihood): evidence through a GP SURROGATE of the log-likelihood is
fragile — the raw LL surface spans thousands of nats over a
prior-covering design, and where the GP interpolates badly it can
invent a spurious peak ABOVE the true maximum; SMC then faithfully
reports the evidence of the wrong surface (measured: a surrogate-B
"evidence" of +98 when the true best fit is −13). Surrogate-based
evidence needs posterior-region designs and hyperparameter optimisation
— use `examples/surrogate_inverse.py`'s machinery for posterior
SAMPLING, but integrate evidence on the exact model (black-box
likelihoods work too, via ``external_log_like`` with
``kernel="rw"``).

Run: ``python examples/model_comparison_smc.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp

import bipymc_tpu as bp

T_OBS = jnp.linspace(0.0, 1.0, 24)
SIGMA = 0.05
TRUE_THETA = np.array([1.0, -0.6], np.float32)
PRIOR_VAR = 1.0                          # N(0, 1) prior on every parameter


def model_a(theta):
    """Truth: amplitude·exp(−3t) + curvature·t² (2 parameters)."""
    return theta[0] * jnp.exp(-3.0 * T_OBS) + theta[1] * T_OBS ** 2


def model_b(theta):
    """Competitor: quadratic polynomial (3 parameters — one more knob,
    and no term that can reproduce the fast early decay exactly)."""
    return theta[0] + theta[1] * T_OBS + theta[2] * T_OBS ** 2


def evidence_for(forward, d, y_obs, seed):
    """SMC evidence for one model: anneal the (normalised) N(0, PRIOR_VAR)
    prior to the posterior; log Ẑ estimates log ∫ L(θ) π(θ) dθ."""

    def log_like(theta):
        r = forward(theta) - y_obs
        return -0.5 * jnp.sum(r * r) / SIGMA ** 2

    smc = bp.Smc(log_like, n_particles=4096, seed=seed,
                 ref_mean=np.zeros(d, np.float32),
                 ref_var=np.full(d, PRIOR_VAR, np.float32),
                 ess_alpha=0.9, n_moves=5, kernel="hmc")
    info = smc.run()
    assert info["reached_one"]
    draws = smc.resample()
    best = float(jax.vmap(log_like)(jnp.asarray(draws)).max())
    return info["log_evidence"], best, draws, info


def main():
    rng = np.random.default_rng(7)
    y_obs = jnp.asarray(
        np.asarray(model_a(jnp.asarray(TRUE_THETA)))
        + rng.normal(0, SIGMA, T_OBS.size).astype(np.float32))

    log_z_a, best_a, draws_a, info_a = evidence_for(model_a, 2, y_obs, 0)
    log_z_b, best_b, draws_b, info_b = evidence_for(model_b, 3, y_obs, 1)
    log_bf = log_z_a - log_z_b

    post_a = draws_a.mean(0)
    print(f"model A (truth, 2 params): log Z = {log_z_a:.2f} "
          f"({info_a['n_stages']} stages); posterior mean "
          f"{np.round(post_a, 3)} vs true {TRUE_THETA}")
    print(f"model B (quadratic, 3 params): log Z = {log_z_b:.2f} "
          f"({info_b['n_stages']} stages)")
    print(f"best-fit log-likelihoods: A {best_a:.1f}, B {best_b:.1f} "
          f"(fit difference {best_a - best_b:+.1f}); "
          f"Occam part of the BF {log_bf - (best_a - best_b):+.1f}")
    verdict = ("decisive" if log_bf > 5 else
               "positive" if log_bf > 1 else "inconclusive")
    print(f"log Bayes factor A vs B: {log_bf:.2f} ({verdict} for A)")

    # --- PSIS-LOO on the same draws: predictive-performance comparison ---
    def pointwise(forward, draws):
        def ll(theta):
            r = forward(theta) - y_obs
            return -0.5 * (r * r / SIGMA ** 2
                           + np.log(2 * np.pi * SIGMA ** 2))
        return bp.pointwise_loglik(ll, draws)

    table = bp.loo_compare({
        "A (truth)": bp.loo(pointwise(model_a, draws_a)),
        "B (quadratic)": bp.loo(pointwise(model_b, draws_b)),
    })
    for row in table:
        print(f"  {row['name']:<15} elpd_loo {row['elpd_loo']:8.2f} "
              f"± {row['se']:.2f}  p_loo {row['p_loo']:.2f}  "
              f"Δelpd {row['d_elpd']:.2f} ± {row['d_se']:.2f}  "
              f"bad k̂ {row['n_bad']}")

    assert np.abs(post_a - TRUE_THETA).max() < 0.15
    assert log_bf > 2.0, log_bf    # measured 3.5; margin for stream changes
    assert table[0]["name"].startswith("A"), table    # LOO agrees with BF
    assert all(r["n_bad"] == 0 for r in table), table # every point certified
    print("OK")


if __name__ == "__main__":
    main()
