#!/usr/bin/env python
"""North-star pipeline — BASELINE config 3, cold start → cross-mode R̂<1.1.

`BASELINE.json:2` names wall-clock to R̂<1.1 a north-star metric; on the
100-d 4-mode mixture the number only counts if the R̂ is CROSS-mode
(mode-hopping mixing), which no DE/archive kernel reaches in practice
(a DE/archive kernel essentially never hops between modes 70 apart in
d=100). The composed pipeline is ORACLE-FREE: the headline arm
discovers the modes itself instead of being told where they are.

Two arms, both written to the JSON:

``init="discovered"`` (HEADLINE — no mode knowledge anywhere in A–D):
  A discover  SMC from a unimodal reference at the ORIGIN (breadth rule
              ref_var = 10·spread²; the only prior
              knowledge is the support SCALE, not mode locations),
              annealed to π; equal-weight resampled posterior draws.
  B fit       diagonal-covariance EM GMM on the SMC draws (k-means++
              seeds × restarts, jitted end-to-end).
  C bridge    short FlowMh runs under the fit, REFIT on the
              decorrelated draws (the flowMC iterate).
  D sample    FlowMh, amortized global moves + fused local-RW engine,
              under the ON-DEVICE streaming-R̂ stop at 1.1.
  E validate  (untimed grading, mode knowledge allowed HERE only):
              cross-mode SPLIT R̂, per-mode occupancy vs ¼, mean error.

``init="oracle"`` (A/B column): phase A is a stratified 256-chain
DreamZs explore initialised AT the true mode centres; B–E identical.
Keeping it quantifies what knowing the modes buys.

Every timed phase is measured COLD (compile + run — the true cold-start
cost, ``cold_total_s``) and WARM (cached executables — the
compile-excluded frame every headline in this repo uses;
``northstar_wall_s``). The JAX persistent compilation cache is enabled
(utils/compile_cache.py): a SECOND process's "cold" pays cache-load
instead of compile — run this script twice and compare ``cold_total_s``; the
second run auto-records ``cold_total_s_warm_cache`` into the JSON when
it finds a prior result.

Writes benchmarks/northstar_config3.json (BENCH_SMOKE=1 → *_smoke.json,
tiny shapes, CPU-safe).
"""

import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

# NORTHSTAR_NO_CACHE=1 (or BENCH_NO_CACHE=1) runs without the persistent
# compilation cache, for measuring the uncached cold start
_NO_CACHE = bool(os.environ.get("NORTHSTAR_NO_CACHE")
                 or os.environ.get("BENCH_NO_CACHE"))

import bipymc_tpu as bp
from bipymc_tpu.models.targets import (baseline_config3_means,
                                       gaussian_mixture,
                                       gaussian_mixture_block,
                                       stratified_mode_init)
from bipymc_tpu.utils.compile_cache import enable_compile_cache
from bipymc_tpu.utils.diagnostics import (ess_multichain, ess_rate,
                                          mode_occupancy, nearest_mode)
from bipymc_tpu.utils.mixtures import fit_gmm, gmm_proposal

D = 100
N_CHAINS = 256
SPREAD = 5.0                     # baseline_config3_means scale (support
                                 # knowledge — NOT mode locations)
EXPLORE_GENS, EXPLORE_BURN, EXPLORE_THIN = 1500, 500, 4
# Discovery defaults: 8192 particles, ess_alpha 0.95, 5 moves — discovery
# weights within ~0.09, which the bridge/refit equilibrates to <0.01 by
# validation. Cheaper schedules (ess_alpha=0.9 or n_moves<5) skewed
# weights 0.13-0.53 at discovery. Env overrides for A/B probing.
SMC_PARTICLES = int(os.environ.get("NORTHSTAR_SMC_PARTICLES", "8192"))
SMC_MAX_STAGES, SMC_MOVES = 600, int(
    os.environ.get("NORTHSTAR_SMC_MOVES", "5"))
SMC_ALPHA = float(os.environ.get("NORTHSTAR_SMC_ALPHA", "0.95"))
SMC_REF_VAR = 10.0 * SPREAD ** 2   # breadth rule: caps the mid-β
                                   # radius imbalance so no basin goes
                                   # extinct along the geometric path
GMM_K, GMM_ITERS, GMM_MAX_PTS, GMM_RESTARTS = 8, 100, 50000, 4
LOCAL_MOVES, GLOBAL_EVERY, RW_SCALE = 2, 10, 0.2
# tail-domination safeguard for the independence proposal (see
# gmm_proposal docstring): without it, ML-fit tails are thinner than π
# and chains stick where π/q blows up — measured occupancy skew 0.18
# at d=100 with per-move acceptance 0.69 and cross-mode R̂ 1.01.
INFLATE = 1.05
# the bridge runs MORE frequent global moves (every 5 gens) over a longer
# window: its job is to hand the refit decorrelated draws, and the refit's
# acceptance is set by n_eff (diag-GMM estimation error ~ K·d/(2·n_eff) in
# the exp(−KL) exponent). TWO bridge→refit iterates for the oracle arm
# (the explore draws' mode PROPORTIONS are frozen at the stratified init,
# so the first refit inherits mis-estimated weights). The discovered
# arm's SMC draws already carry the correct weights, so one iterate
# suffices.
BRIDGE_GENS, BRIDGE_GLOBAL_EVERY = 2000, 5
BRIDGE_ITERS = {"oracle": 2, "discovered": 1}
UNTIL_KW = dict(rhat_tol=1.1, chunk=200, max_chunks=200, warmup_chunks=1)
VALIDATE_GENS = 2000
SEED = 11

# NORTHSTAR_FUSED=0: run every FlowMh stage on the per-generation engine
# (engine-bias A/B diagnostic; same streams by key discipline)
FUSED = os.environ.get("NORTHSTAR_FUSED", "1") == "1"
SMOKE = os.environ.get("BENCH_SMOKE") == "1"
if SMOKE:
    D, N_CHAINS = 8, 64
    EXPLORE_GENS, EXPLORE_BURN, EXPLORE_THIN = 300, 100, 2
    SMC_PARTICLES, SMC_MAX_STAGES, SMC_MOVES = 512, 200, 3
    GMM_K, GMM_ITERS, GMM_MAX_PTS = 6, 40, 10000
    BRIDGE_GENS, BRIDGE_GLOBAL_EVERY = 400, 5
    BRIDGE_ITERS = {"oracle": 2, "discovered": 1}
    UNTIL_KW = dict(rhat_tol=1.1, chunk=50, max_chunks=60, warmup_chunks=1)
    VALIDATE_GENS = 400


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _explore_draws(s):
    """Thinned post-burn-in explore history, flattened, DEVICE-resident."""
    xh = jnp.concatenate([c["x"] for c in s._chunks], axis=0)  # [T, n, d]
    return xh[EXPLORE_BURN // EXPLORE_THIN:].reshape(-1, xh.shape[-1])


def _phase_a_oracle(log_prob, means_j):
    """Oracle explore: stratified DreamZs AT the true mode centres."""
    x0 = stratified_mode_init(jax.random.key(SEED), means_j, N_CHAINS,
                              var=4.0)
    explore = bp.DreamZs(log_prob, n_chains=N_CHAINS, seed=SEED,
                         burnin_gens=EXPLORE_BURN, fused=True,
                         log_prob_block=gaussian_mixture_block(
                             np.asarray(means_j)))
    t0 = time.time()
    explore.run_mcmc(EXPLORE_GENS, x0, thin=EXPLORE_THIN)
    draws = jax.block_until_ready(_explore_draws(explore))
    t_cold = time.time() - t0
    theta_b = explore.final_state.x

    def warm():
        explore.reset()
        t0 = time.time()
        explore.run_mcmc(EXPLORE_GENS, x0, thin=EXPLORE_THIN)
        dw = jax.block_until_ready(_explore_draws(explore))
        return dw, time.time() - t0

    meta = {"kind": "stratified DreamZs at TRUE mode centres (oracle)",
            "gens": EXPLORE_GENS, "burn": EXPLORE_BURN,
            "thin": EXPLORE_THIN}
    return draws, theta_b, t_cold, warm, meta


def _phase_a_discovered(log_prob, means_j):
    """Oracle-FREE discovery: SMC annealed from a unimodal origin
    reference. The only prior input is the support scale (ref breadth
    10·spread² — a prior a real user has); mode locations, counts and
    weights all come out of the anneal."""
    def build(seed):
        return bp.Smc(log_prob, n_particles=SMC_PARTICLES, seed=seed,
                      ref_mean=np.zeros(D, np.float32),
                      ref_var=np.full(D, SMC_REF_VAR, np.float32),
                      ess_alpha=SMC_ALPHA, n_moves=SMC_MOVES, kernel="hmc",
                      max_stages=SMC_MAX_STAGES)

    smc = build(SEED)
    t0 = time.time()
    info = smc.run()
    draws_h = smc.resample()                        # host [N, d]
    # bridge-chain init: a permuted subset (systematic resampling
    # orders rows along the weight CDF — consecutive rows correlate)
    rng = np.random.default_rng(SEED + 7)
    theta_b = jnp.asarray(
        draws_h[rng.permutation(draws_h.shape[0])[:N_CHAINS]],
        jnp.float32)
    draws = jax.block_until_ready(jnp.asarray(draws_h, jnp.float32))
    t_cold = time.time() - t0
    log(f"  discover: {int(info['n_stages'])} stages, "
        f"logZ {float(info['log_evidence']):+.3f} (true 0)")

    def warm():
        s1 = build(SEED)
        s1._runner = smc._runner                    # compiled program
        t0 = time.time()
        s1.run()
        dh = s1.resample()
        dw = jax.block_until_ready(jnp.asarray(dh, jnp.float32))
        return dw, time.time() - t0

    meta = {"kind": "SMC anneal from unimodal origin reference "
                    "(oracle-free; support-scale prior only)",
            "particles": SMC_PARTICLES, "ref_var": SMC_REF_VAR,
            "stages": int(info["n_stages"]),
            "log_evidence": round(float(info["log_evidence"]), 4)}
    return draws, theta_b, t_cold, warm, meta


def pipeline(init_mode):
    """Run one arm's full cold+warm protocol; return the result dict."""
    means = baseline_config3_means(D, spread=SPREAD)
    means_j = jnp.asarray(means)
    log_prob = gaussian_mixture(means, sigma=1.0)
    # the fused engines' in-kernel target (models/targets.py)
    lp_block = gaussian_mixture_block(means, sigma=1.0) if FUSED else None
    n_bridge = BRIDGE_ITERS[init_mode]

    out = {"init": init_mode, "config": {
        "d": D, "n_chains": N_CHAINS,
        "gmm": {"K": GMM_K, "iters": GMM_ITERS, "max_points": GMM_MAX_PTS,
                "restarts": GMM_RESTARTS, "cov_type": "diag"},
        "flowmh": {"local_moves": LOCAL_MOVES, "global_every": GLOBAL_EVERY,
                   "rw_scale": RW_SCALE, "fused": FUSED},
        "bridge": {"gens": BRIDGE_GENS, "global_every": BRIDGE_GLOBAL_EVERY,
                   "iters": n_bridge},
        "until": UNTIL_KW, "seed": SEED,
    }}

    # ---- A: explore / discover -----------------------------------------
    phase_a = (_phase_a_oracle if init_mode == "oracle"
               else _phase_a_discovered)
    draws, theta_b, t_a_cold, warm_a, meta_a = phase_a(log_prob, means_j)
    out["config"]["phase_a"] = meta_a
    log(f"A {init_mode} cold: {t_a_cold:.2f}s, draws {draws.shape}")

    # ---- B: fit (jitted; static shapes) --------------------------------
    @jax.jit
    def _fit(k, dr):
        return fit_gmm(k, dr, GMM_K, n_iters=GMM_ITERS,
                       max_points=GMM_MAX_PTS, n_restarts=GMM_RESTARTS,
                       cov_type="diag")

    t0 = time.time()
    gparams, ginfo = jax.block_until_ready(_fit(jax.random.key(SEED + 1),
                                                draws))
    t_fit_cold = time.time() - t0
    log(f"B fit cold: {t_fit_cold:.2f}s, "
        f"loglik {float(ginfo['final_loglik']):.2f}")
    out["gmm_final_loglik"] = round(float(ginfo["final_loglik"]), 3)

    # ---- C: bridge→refit iterates --------------------------------------
    params_i = gparams
    bridges, accs_b, bridge_starts = [], [], []
    t_bridge_cold = t_refit_cold = 0.0
    for i in range(n_bridge):
        bridge_starts.append(theta_b)
        b = bp.FlowMh(log_prob, gmm_proposal(params_i, INFLATE),
                      n_chains=N_CHAINS, seed=SEED + 2 + 10 * i,
                      local_moves=LOCAL_MOVES,
                      global_every=BRIDGE_GLOBAL_EVERY,
                      rw_scale=RW_SCALE, fused=FUSED,
                      log_prob_block=lp_block)
        t0 = time.time()
        b.run_mcmc(BRIDGE_GENS, theta_b)
        xb = b._chunks[-1]["x"]                           # [T, n, d] device
        bdraws = jax.block_until_ready(
            xb[BRIDGE_GENS // 2:].reshape(-1, D))
        t_bridge_cold += time.time() - t0
        acc_i = (float(b.global_acceptance_fraction.mean())
                 * BRIDGE_GLOBAL_EVERY)
        accs_b.append(round(acc_i, 4))
        t0 = time.time()
        params_i, ginfo_i = jax.block_until_ready(
            _fit(jax.random.key(SEED + 3 + 10 * i), bdraws))
        t_refit_cold += time.time() - t0
        log(f"C bridge {i + 1}/{n_bridge} cold: acc/move {acc_i:.3f}, "
            f"refit loglik {float(ginfo_i['final_loglik']):.2f}")
        theta_b = b.final_state.x
        bridges.append(b)
    gparams2 = params_i
    log(f"C totals cold: bridge {t_bridge_cold:.2f}s, "
        f"refit {t_refit_cold:.2f}s")
    if os.environ.get("NORTHSTAR_SAVE_PARAMS"):
        np.savez(os.environ["NORTHSTAR_SAVE_PARAMS"],
                 log_w1=np.asarray(gparams.log_w),
                 mu1=np.asarray(gparams.mu),
                 chol1=np.asarray(gparams.chol),
                 log_w2=np.asarray(gparams2.log_w),
                 mu2=np.asarray(gparams2.mu),
                 chol2=np.asarray(gparams2.chol))

    # ---- D: sample until cross-mode R̂ < 1.1 ----------------------------
    s = bp.FlowMh(log_prob, gmm_proposal(gparams2, INFLATE), n_chains=N_CHAINS,
                  seed=SEED + 4, local_moves=LOCAL_MOVES,
                  global_every=GLOBAL_EVERY, rw_scale=RW_SCALE, fused=FUSED,
                  log_prob_block=lp_block)
    t0 = time.time()
    info = s.run_mcmc_until(theta_b, **UNTIL_KW)
    t_until_cold = time.time() - t0
    stop_rhat = float(np.max(info["rhat"]))
    stop_gens = int(info["steps"])
    converged = stop_rhat < UNTIL_KW["rhat_tol"]
    log(f"D sample cold: {t_until_cold:.2f}s, {stop_gens} gens, "
        f"streaming R̂ {stop_rhat:.4f} (converged={converged})")

    # ---- E: validate (untimed; TRUE means allowed here — grading) ------
    s.run_mcmc(VALIDATE_GENS)
    xh = s._chunks[-1]["x"]                               # [T, n, d] device
    occ_t = jax.vmap(lambda xt: mode_occupancy(xt, means_j))(xh)
    w = occ_t.sum(axis=0) / occ_t.sum()
    w_err = float(jnp.max(jnp.abs(w - 1.0 / means.shape[0])))
    window = jnp.swapaxes(xh, 0, 1)                       # [n, T, d]
    rhat_split = float(jnp.max(bp.gelman_rubin(window)))
    mean_err = float(jnp.max(jnp.abs(
        window.mean(axis=(0, 1)) - means_j.mean(axis=0))))
    acc_g = float(s.global_acceptance_fraction.mean()) * GLOBAL_EVERY
    log(f"E validate: split R̂ {rhat_split:.4f}, mode weights "
        f"{np.round(np.asarray(w), 3).tolist()} (err {w_err:.3f}), "
        f"mean err {mean_err:.3f}, global acc/move {acc_g:.3f}")

    # -- mixing forensics (all device-reduced; scalars fetched) ----------
    # per-chain accepted-global-move counts: a stuck-chain failure mode
    # shows as a mass of zeros here while the MEAN acceptance looks fine
    acch = s._chunks[-1]["accepted"]                      # [T, n] device
    acc_per_chain = jnp.sum(acch.astype(jnp.int32), axis=0)
    n_stuck = int(jnp.sum(acc_per_chain == 0))
    acc_q = np.asarray(jnp.percentile(
        acc_per_chain.astype(jnp.float32),
        jnp.asarray([0.0, 10.0, 50.0, 90.0])))
    # per-mode acceptance: which basin rejects its global moves
    mode_of = jax.vmap(lambda xt: jnp.argmin(jnp.sum(
        (xt[:, None, :] - means_j[None, :, :]) ** 2, axis=-1), axis=-1))(xh)
    per_mode_acc = np.asarray(jax.vmap(
        lambda m: (jnp.sum(jnp.where(mode_of == m, acch, 0))
                   / jnp.maximum(jnp.sum(jnp.where(mode_of == m,
                                                   acch * 0 + 1, 0)), 1)
                   ))(jnp.arange(means.shape[0]))) * GLOBAL_EVERY
    # the final fit's component weights and their mode assignment
    comp_mode = np.asarray(jnp.argmin(jnp.sum(
        (gparams2.mu[:, None, :] - means_j[None, :, :]) ** 2, axis=-1),
        axis=-1))
    comp_w = np.asarray(jnp.exp(gparams2.log_w))
    q_mode_w = np.zeros(means.shape[0])
    for c, m in enumerate(comp_mode):
        q_mode_w[m] += comp_w[c]
    log(f"E forensics: stuck chains (0 accepted) {n_stuck}/{N_CHAINS}; "
        f"accepted/chain pcts [min,10,50,90] {acc_q.round(1).tolist()}; "
        f"per-mode acc/move {np.round(per_mode_acc, 3).tolist()}; "
        f"q mass per mode {np.round(q_mode_w, 3).tolist()}")
    out["forensics"] = {
        "stuck_chains": n_stuck,
        "accepted_per_chain_pcts": acc_q.round(2).tolist(),
        "per_mode_acceptance_per_move": np.round(per_mode_acc, 4).tolist(),
        "q_mass_per_mode": np.round(q_mode_w, 4).tolist(),
    }

    # ---- warm pass (cached executables) --------------------------------
    draws_w, t_a_warm = warm_a()

    t0 = time.time()
    jax.block_until_ready(_fit(jax.random.key(SEED + 1), draws_w))
    t_fit_warm = time.time() - t0

    t_bridge_warm = t_refit_warm = 0.0
    for i, b in enumerate(bridges):
        b.reset()
        t0 = time.time()
        b.run_mcmc(BRIDGE_GENS, bridge_starts[i])
        bdraws_w = jax.block_until_ready(
            b._chunks[-1]["x"][BRIDGE_GENS // 2:].reshape(-1, D))
        t_bridge_warm += time.time() - t0
        t0 = time.time()
        jax.block_until_ready(
            _fit(jax.random.key(SEED + 3 + 10 * i), bdraws_w))
        t_refit_warm += time.time() - t0

    s.reset()
    t0 = time.time()
    info_w = s.run_mcmc_until(theta_b, **UNTIL_KW)
    t_until_warm = time.time() - t0
    stop_rhat_w = float(np.max(info_w["rhat"]))
    log(f"warm: A {t_a_warm:.2f}s, fit {t_fit_warm:.2f}s, "
        f"bridge {t_bridge_warm:.2f}s, refit {t_refit_warm:.2f}s, "
        f"sample {t_until_warm:.2f}s (R̂ {stop_rhat_w:.4f})")

    # ---- cross-mode ESS/s ----------------------------------------------
    # The engine that actually MIXES across modes supplies its own
    # throughput frame: a timed warm window of the fused FlowMh at the
    # headline schedule. Two numbers: parameter ESS/s (same estimator
    # and window convention as the DREAM-zs headline, ess_rate), and
    # the conservative mode-INDICATOR ESS/s — the MULTI-CHAIN
    # (Vehtari/Stan) ESS of the one-hot nearest-mode series, worst
    # mode. The multi-chain estimator is load-bearing here: within-chain ACF
    # estimators assign ρ := 0 to a chain
    # whose indicator never changes, so a fully frozen population would
    # score near-MAXIMAL within-chain ESS; ess_multichain folds the
    # between-chain variance and scores it ≈ chain count instead. This
    # is the honest "effective samples" frame for a multimodal target
    # (BASELINE.json:2).
    t0 = time.time()
    s.run_mcmc(VALIDATE_GENS)
    xh2 = s._chunks[-1]["x"]                              # [T, n, d]
    jax.block_until_ready(xh2)
    t_win = time.time() - t0
    gps_win = VALIDATE_GENS / t_win
    window2 = jnp.swapaxes(xh2, 0, 1)                     # [n, T, d]
    ess_param, eps_param = ess_rate(window2, gps_win,
                                    window=VALIDATE_GENS)
    idx2 = nearest_mode(xh2, means_j)                     # [T, n]
    ind = (idx2[..., None]
           == jnp.arange(means.shape[0])).astype(jnp.float32)
    ind_chains = jnp.swapaxes(ind, 0, 1)                  # [n, T, k]
    ess_mode = float(jnp.min(ess_multichain(ind_chains)))
    eps_mode = ess_mode * gps_win / VALIDATE_GENS
    # the same multi-chain estimator on the parameters — on a strided
    # 16-dim subset: a worst-of-16-dims sanity column is all this
    # companion needs to certify the ess_rate frame
    ess_param_mc = float(jnp.min(ess_multichain(
        window2[..., :: max(1, window2.shape[-1] // 16)])))
    hop_rate = float(jnp.mean(
        (idx2[1:] != idx2[:-1]).astype(jnp.float32)))
    log(f"crossmode ESS: {gps_win:.0f} gens/s, param ESS {ess_param:.0f} "
        f"({eps_param:.0f}/s; multichain worst-dim {ess_param_mc:.0f}), "
        f"mode-indicator multichain ESS {ess_mode:.0f} "
        f"({eps_mode:.0f}/s), hop rate {hop_rate:.4f}/chain-gen")
    out["crossmode_ess"] = {
        "window_gens": VALIDATE_GENS,
        "gens_per_sec": round(gps_win, 1),
        "ess_param": round(ess_param, 1),
        "ess_per_sec_param": round(eps_param, 1),
        "ess_param_multichain_worst_of_16dims": round(ess_param_mc, 1),
        "ess_mode_indicator": round(ess_mode, 1),
        "ess_per_sec_mode_indicator": round(eps_mode, 1),
        "ess_estimator_note": (
            "mode-indicator ESS uses ess_multichain (Vehtari/Stan "
            "between-chain-corrected) — within-chain ACF estimators "
            "score a frozen population near-maximal on indicator "
            "series; param ESS uses the repo-wide ess_rate window "
            "convention plus the multichain worst-dim companion"),
        "mode_hops_per_chain_gen": round(hop_rate, 5),
    }

    warm_total = (t_a_warm + t_fit_warm + t_bridge_warm
                  + t_refit_warm + t_until_warm)
    cold_total = (t_a_cold + t_fit_cold + t_bridge_cold
                  + t_refit_cold + t_until_cold)
    out.update({
        "cold_s": {"phase_a": round(t_a_cold, 3),
                   "fit": round(t_fit_cold, 3),
                   "bridge": round(t_bridge_cold, 3),
                   "refit": round(t_refit_cold, 3),
                   "sample_until": round(t_until_cold, 3)},
        "warm_s": {"phase_a": round(t_a_warm, 3),
                   "fit": round(t_fit_warm, 3),
                   "bridge": round(t_bridge_warm, 3),
                   "refit": round(t_refit_warm, 3),
                   "sample_until": round(t_until_warm, 3)},
        "cold_total_s": round(cold_total, 3),
        "northstar_wall_s": round(warm_total, 3),
        "stop_gens": stop_gens,
        "stop_rhat_streaming": round(stop_rhat, 4),
        "stop_rhat_streaming_warm": round(stop_rhat_w, 4),
        "converged": bool(converged),
        "bridge_global_acceptance_per_move": accs_b,
        "validate": {
            "gens": VALIDATE_GENS,
            "crossmode_split_rhat": round(rhat_split, 4),
            "mode_weights": np.round(np.asarray(w), 4).tolist(),
            "mode_weight_abs_err": round(w_err, 4),
            "posterior_mean_abs_err": round(mean_err, 4),
            "global_acceptance_per_move": round(acc_g, 4),
        },
    })
    return out


def artifact_path():
    path = os.path.join(HERE, "northstar_config3.json")
    return path.replace(".json", "_smoke.json") if SMOKE else path


def write_artifact(new_arms: dict) -> dict:
    """Merge newly measured arms into the JSON artifact.

    ONE writer for both entry points (main() here and bench.py's
    run_northstar), so both keep the top-level compilation_cache/smoke
    keys the cache-A/B detection reads. Preserves arms not
    re-measured this invocation, and records the second-process cache
    A/B fields on the headline arm when a prior result with the same
    cache setting exists.
    """
    path = artifact_path()
    prev = None
    if os.path.exists(path):
        try:
            with open(path) as f:
                prev = json.load(f)
        except Exception:
            prev = None
    merged = dict((prev or {}).get("arms", {}))
    merged.update(new_arms)
    headline = ("discovered" if "discovered" in merged
                else next(iter(merged)))
    out = {"arms": merged, "headline": headline,
           "compilation_cache": (
               "disabled" if _NO_CACHE
               else jax.config.jax_compilation_cache_dir)}
    if SMOKE:
        out["smoke"] = True
    # second-process cache A/B: if the headline arm was
    # measured FRESH this run and a prior result with the same cache
    # setting exists, this process's cold = cache-load — record both.
    if (prev is not None and not _NO_CACHE and headline in new_arms
            and prev.get("compilation_cache") == out["compilation_cache"]
            and headline in prev.get("arms", {})):
        head = out["arms"][headline]
        head["cold_total_s_first_process"] = (
            prev["arms"][headline].get(
                "cold_total_s_first_process",
                prev["arms"][headline]["cold_total_s"]))
        head["cold_total_s_warm_cache"] = head["cold_total_s"]
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def main():
    if not _NO_CACHE:
        enable_compile_cache()
    log("devices:", jax.devices())
    arms = [a.strip() for a in
            os.environ.get("NORTHSTAR_ARMS",
                           "discovered,oracle").split(",") if a.strip()]
    new_arms = {}
    for mode in arms:
        log(f"==== arm: init={mode} ====")
        new_arms[mode] = pipeline(mode)
    out = write_artifact(new_arms)
    head = out["arms"][out["headline"]]
    print(json.dumps({
        "headline_init": out["headline"],
        "northstar_wall_s": head["northstar_wall_s"],
        "cold_total_s": head["cold_total_s"],
        "stop_rhat": head["stop_rhat_streaming"],
        "crossmode_split_rhat": head["validate"]["crossmode_split_rhat"],
        "mode_weight_abs_err": head["validate"]["mode_weight_abs_err"],
        "converged": head["converged"],
    }))


if __name__ == "__main__":
    main()
