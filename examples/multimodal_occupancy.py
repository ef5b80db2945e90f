"""Honest multimodal sampling: stratified init + occupancy diagnostics.

The headline BASELINE config (a high-dim well-separated mixture) is the
textbook case where R̂ and ESS look healthy while the sampler silently
measures the wrong thing: if the whole population drifts into one basin,
every chain agrees and no classical diagnostic objects. This example
shows the workflow that keeps the claim honest:

1. ``stratified_mode_init`` overdisperses the population ACROSS the
   posterior's support — here n/k chains per mode, the purpose
   SURVEY.md §4.10 assigns to ``var_ball``;
2. ``mode_occupancy`` verifies the per-mode chain counts HOLD (for an
   equal-weight mixture the population is then a valid stratified
   sampler even when self-mixing between modes is slow);
3. ``mode_hops`` measures the actual inter-mode mixing rate — rare at
   high d (the surviving channel is correlated archive pairs), so if
   mode *weights* are unknown a priori, compose with tempering instead
   (examples/parallel_tempering.py).

Run: ``python examples/multimodal_occupancy.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp

import bipymc_tpu as bp
from bipymc_tpu.models.targets import gaussian_mixture

D, K, N_CHAINS = 24, 4, 64


def main():
    rng_key = jax.random.key(7)
    means = 5.0 * np.asarray(jax.random.normal(rng_key, (K, D)),
                             dtype=np.float32)
    log_prob = gaussian_mixture(means, sigma=1.0)

    # 1. overdisperse across ALL modes (16 chains per mode here); a ball
    # at the origin would collapse into one basin during burn-in
    x0 = bp.stratified_mode_init(jax.random.key(0), means, N_CHAINS,
                                 var=4.0)
    s = bp.DreamZs(log_prob, n_chains=N_CHAINS, seed=0, burnin_gens=200)
    s.run_mcmc(1500, x0)

    # 2. occupancy must hold ≈ N/K per mode
    final = jnp.asarray(s.super_chain[:, -1, :])
    occ = np.asarray(bp.mode_occupancy(final, jnp.asarray(means)))
    print(f"mode occupancy (want ~{N_CHAINS // K} each): {occ.tolist()}")
    assert occ.min() >= N_CHAINS // K - 6, occ

    # 3. the measured inter-mode hop rate — rare by design at high d
    hops, rate = bp.mode_hops(jnp.asarray(s.super_chain),
                              jnp.asarray(means))
    print(f"inter-mode hops: {int(hops)} "
          f"({float(rate):.2e}/chain/generation)")

    # stratified estimate of a population expectation is unbiased: the
    # grand mean over chains ≈ the mixture mean (mean of mode centres)
    est = s.super_chain[:, 500:, :].mean(axis=(0, 1))
    truth = means.mean(axis=0)
    err = np.max(np.abs(est - truth))
    print(f"stratified posterior-mean error: {err:.2f} "
          f"(modes span ~{np.abs(means).max():.0f})")
    assert err < 1.0, err
    print("OK")


if __name__ == "__main__":
    main()
