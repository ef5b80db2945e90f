"""Parallel tempering (replica exchange) on a well-separated mixture.

A cold DRAM chain cannot hop between modes 10σ apart; a geometric
temperature ladder lets hot replicas roam and DEO swaps carry their moves
down to β=1 (beyond-reference extra, samplers/tempering.py). The script
checks the two health metrics the API exposes: per-interface swap rates
(no broken link in the ladder) and walker round trips (states genuinely
travel cold → hot → cold), then verifies the cold replica found BOTH
modes with roughly equal mass.

Run: ``python examples/parallel_tempering.py``.
"""

import numpy as np
import jax.numpy as jnp

import bipymc_tpu as bp
from bipymc_tpu.models.targets import gaussian_mixture

# two unit-width modes 10 sigma apart in 2-D: untempered RW gets stuck
MEANS = np.array([[-5.0, 0.0], [5.0, 0.0]], dtype=np.float32)


def main():
    log_prob = gaussian_mixture(MEANS, sigma=1.0)
    s = bp.ParallelTempering(log_prob, n_temps=8, n_chains=8,
                             beta_min=0.02, swap_interval=5, kind="dram",
                             seed=0)
    s.run_mcmc(20000, jnp.zeros(2), cov_est=jnp.eye(2) * 0.5, spread=1.0)

    rates = s.swap_rates
    trips = s.round_trips
    print("per-interface swap rates:", np.round(rates, 2))
    print(f"round trips completed: {trips} "
          f"(rate {s.round_trip_rate:.3f}/chain/round)")

    flat = s.get_chain(discard=5000, flat=True)     # cold replica only
    left = float(np.mean(flat[:, 0] < 0.0))
    print(f"cold-replica mass in left mode: {left:.2f} (truth 0.50)")

    assert rates.min() > 0.05, "a ladder interface never swaps"
    assert trips > 0, "no walker completed a cold-hot-cold round trip"
    assert 0.3 < left < 0.7, "cold replica failed to mix between modes"
    # mode centres recovered
    mu_l = flat[flat[:, 0] < 0].mean(0)
    mu_r = flat[flat[:, 0] > 0].mean(0)
    assert np.abs(mu_l - MEANS[0]).max() < 0.5
    assert np.abs(mu_r - MEANS[1]).max() < 0.5
    print("OK: both modes recovered with balanced mass")


if __name__ == "__main__":
    main()
