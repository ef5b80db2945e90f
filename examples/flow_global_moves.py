"""Global moves from a fitted proposal density: the cross-mode channel
the DE family lacks — and the measured flow-vs-GMM proposal choice.
The DREAM-zs inter-mode hop rate at d=100 measures 2.8e-5 per
chain-generation — mode *weights* only self-equilibrate on a
~35k-generation timescale, so a mis-initialised population stays wrong
for any practical window, and cross-mode R̂ < 1.1 is unreachable. This
example runs the flowMC composition that closes exactly that gap
(samplers/flowmh.py):

1. exploratory run: stratified DreamZs (the honest-multimodality
   workflow of examples/multimodal_occupancy.py) gives draws covering
   every mode;
2. fit a proposal density q to that history — and here the example
   demonstrates the MEASURED architecture choice the package makes
   pluggable (bp.Proposal):
   - ``bp.fit_flow`` (RealNVP): per-dimension fit error compounds —
     on this d=16 4-mode target its independence-move acceptance is
     ~1e-3 (printed below; at d=2-4 the same flow gets 0.3-0.7);
   - ``bp.fit_gmm`` (EM Gaussian mixture, k-means++ seeded, vmapped
     restarts): the exact family for Gaussian-ish basins. Covariance
     parameterization is the measured lever: ``cov_type="full"``
     (d(d+1)/2 params/component) plateaus at ~0.3 acceptance on this
     history — covariance estimation NOISE, not the family, is the
     ceiling — while ``cov_type="diag"`` (2d params) reaches 0.59.
3. ``bp.FlowMh`` composes local RW moves with independence proposals
   from q: acceptance depends on KL(π‖q), not on mode separation, so
   chains transplant between modes at the proposal acceptance rate.
   The MH correction targets the EXACT posterior for either fit.
4. the flowMC iterate: refit q on the global-move run's own
   (decorrelated) draws — measured 0.59 → 0.93 in one round with
   diag covariance (full-cov stays pinned at its estimation-noise
   ceiling: 0.32 → 0.29).

Demonstrated end to end, self-asserting:
- a population initialised ENTIRELY in one mode recovers the true
  equal mode weights within a few hundred generations (GMM proposal);
- cross-mode split-R̂ < 1.05 — structurally unreachable for the DE
  family at scale;
- the flow-vs-GMM acceptance gap at d=16, measured side by side.

Run: ``python examples/flow_global_moves.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp

import bipymc_tpu as bp
from bipymc_tpu.models.targets import (gaussian_mixture,
                                       gaussian_mixture_block)
from bipymc_tpu.utils.flows import flow_config

D, K, N_CHAINS = 16, 4, 64


def main():
    means = 5.0 * np.asarray(jax.random.normal(jax.random.key(7), (K, D)),
                             dtype=np.float32)
    log_prob = gaussian_mixture(means, sigma=1.0)

    # 1. exploratory stratified run — draws that SEE every mode
    x0 = bp.stratified_mode_init(jax.random.key(0), means, N_CHAINS,
                                 var=4.0)
    explore = bp.DreamZs(log_prob, n_chains=N_CHAINS, seed=0,
                         burnin_gens=200)
    explore.run_mcmc(1200, x0)
    draws = explore.get_chain(discard=300, flat=True)
    print(f"exploratory draws: {draws.shape}")

    # 2a. RealNVP flow fit — kept small; the point is the d-scaling of
    # its acceptance, printed next to the GMM's
    cfg = flow_config(n_layers=6, hidden=48, n_steps=1200,
                      step_size=2e-3, batch_size=2048)
    fparams, finfo = bp.fit_flow(jax.random.key(1), jnp.asarray(draws),
                                 cfg)
    print(f"flow fit: final mean -log q = "
          f"{float(finfo['final_loss']):.3f}")

    # 2b. EM Gaussian mixture fit on the same history (diag covariance:
    # the modes are isotropic, and full-cov estimation noise on an
    # n_eff-limited history caps acceptance at ~0.3 — measured)
    gparams, ginfo = bp.fit_gmm(jax.random.key(2), jnp.asarray(draws), K,
                                n_iters=120, max_points=20000,
                                cov_type="diag")
    print(f"gmm fit: final mean log lik = "
          f"{float(ginfo['final_loglik']):.3f}")

    # 3. global-move MCMC from a DELIBERATELY collapsed init: every
    # chain in mode 0 (occupancy [64, 0, 0, 0]) — the start the DE
    # family cannot recover from within a practical window
    theta_0 = jnp.asarray(np.tile(means[0], (N_CHAINS, 1)))

    s_flow = bp.FlowMh(log_prob, fparams, n_chains=N_CHAINS, seed=3,
                       flow_config=cfg)
    s_flow.run_mcmc(600, theta_0, spread=0.1)
    acc_flow = float(s_flow.global_acceptance_fraction.mean())

    s = bp.FlowMh(log_prob, bp.gmm_proposal(gparams),
                  n_chains=N_CHAINS, seed=4)
    s.run_mcmc(600, theta_0, spread=0.1)
    acc_gmm = float(s.global_acceptance_fraction.mean())

    print(f"global-move acceptance at d={D}: flow {acc_flow:.4f} vs "
          f"gmm {acc_gmm:.3f} (DE-channel hop rate at high d: ~3e-5)")
    # round-1 acceptance is bounded by the exploratory draws' EFFECTIVE
    # sample size (autocorrelated DreamZs history), not by the family —
    # measured ~0.6 here vs 0.94 for the same fit on iid draws
    assert acc_gmm > 0.4, acc_gmm
    assert acc_gmm > acc_flow, (acc_gmm, acc_flow)

    # mode weights recovered from the collapsed start within round 1
    final = jnp.asarray(s.super_chain[:, -1, :])
    occ = np.asarray(bp.mode_occupancy(final, jnp.asarray(means)))
    print(f"occupancy after 600 gens from [64,0,0,0]: {occ.tolist()} "
          f"(want ~{N_CHAINS // K} each)")
    assert occ.min() >= 6, occ

    # 4. the flowMC iterate: refit on the global-move run's OWN draws
    # (independence moves decorrelate → higher n_eff → better fit).
    # Each FlowMh kernel is exactly π-invariant (the fit is frozen
    # inside it); refitting BETWEEN runs is standard adaptive
    # independence sampling.
    gparams2, _ = bp.fit_gmm(jax.random.key(5),
                             jnp.asarray(s.get_chain(discard=150,
                                                     flat=True)),
                             K, n_iters=120, max_points=20000,
                             cov_type="diag")
    s2 = bp.FlowMh(log_prob, bp.gmm_proposal(gparams2),
                   n_chains=N_CHAINS, seed=6)
    s2.run_mcmc(600, jnp.asarray(s.final_state.x), spread=0.0)
    acc_gmm2 = float(s2.global_acceptance_fraction.mean())
    print(f"after one refit round: gmm acceptance {acc_gmm:.3f} -> "
          f"{acc_gmm2:.3f} (measured 0.59 -> 0.93)")
    assert acc_gmm2 > acc_gmm, (acc_gmm2, acc_gmm)
    assert acc_gmm2 > 0.8, acc_gmm2
    s = s2

    # cross-mode convergence: split-R̂ over the post-equilibration
    # window — the number that plateaus >1.1 forever for DREAM-zs here
    kept = jnp.asarray(s.super_chain[:, 300:, :])
    rhat = float(np.max(np.asarray(bp.gelman_rubin(kept))))
    print(f"cross-mode split-R-hat: {rhat:.3f} (want < 1.05)")
    assert rhat < 1.05, rhat

    # and the posterior mean is now the true mixture mean — no
    # stratified-init crutch needed
    est = s.super_chain[:, 300:, :].mean(axis=(0, 1))
    err = float(np.max(np.abs(est - means.mean(axis=0))))
    print(f"posterior-mean error: {err:.2f} (modes span ~"
          f"{np.abs(means).max():.0f})")
    assert err < 1.0, err

    # 5. the production engine for long runs: amortize the
    # global move — global_every=10 pays the proposal's density passes
    # a tenth as often and stays exactly π-invariant by kernel
    # composition — and run each inter-global local-RW block as ONE
    # Pallas kernel (fused=True; samplers/flowmh_fused.py; on the GPU
    # the kernel takes the target's padded block form). inflate gives
    # the ML fit the tail domination independence MH needs
    # (gmm_proposal docstring).
    s3 = bp.FlowMh(log_prob, bp.gmm_proposal(gparams2, inflate=1.05),
                   n_chains=N_CHAINS, seed=8, local_moves=2,
                   global_every=10, rw_scale=0.2, fused=True,
                   log_prob_block=gaussian_mixture_block(means, sigma=1.0))
    s3.run_mcmc(2000, jnp.asarray(s.final_state.x), spread=0.0)
    occ_t = jax.vmap(lambda xt: bp.mode_occupancy(
        xt, jnp.asarray(means)))(
        jnp.asarray(np.swapaxes(s3.super_chain, 0, 1)[500:]))
    w = np.asarray(occ_t.sum(axis=0) / occ_t.sum())
    acc3 = float(s3.global_acceptance_fraction.mean()) * 10
    print(f"amortized+fused engine: acceptance/move {acc3:.3f}, "
          f"mode weights {np.round(w, 3).tolist()} (want ~0.25 each)")
    assert np.abs(w - 0.25).max() < 0.06, w
    print("OK")


if __name__ == "__main__":
    main()
