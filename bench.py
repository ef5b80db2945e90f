#!/usr/bin/env python
"""Headline benchmark — BASELINE config 3 (BASELINE.json:9).

256-chain DREAM-zs with crossover adaptation on a 100-dim multimodal
Gaussian mixture, population stratified 64-chains-per-mode at init
(overdispersed across the posterior's support; occupancy + hop-rate
diagnostics keep the "multimodal" claim honest).
Metrics (BASELINE.json:2 north stars): effective samples/sec/chip and
wall-clock to R̂<1.1 (within-basin, compile-excluded). Baseline
denominator: reference-semantics pure-NumPy DREAM-zs on the same
stratified workload (benchmarks/reference_numpy.py) scaled by an
optimistic perfect-MPI core-count factor — measured once and cached in
benchmarks/cpu_baseline.json since the reference publishes no numbers
(BASELINE.md).

Prints exactly ONE JSON line on stdout; progress goes to stderr. The
line names the device it ran on (platform, device kind, count, and the
card's name and power limit). A measurement run needs a GPU and exits
non-zero without one; ``BENCH_SMOKE=1`` runs tiny shapes on any backend
as an execution check, and its line is marked ``"smoke": true``.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

D = 100
N_CHAINS = 256
BURNIN_GENS = 500
CHUNK = 2500
TIMED_CHUNKS = 4
SEED = 0

# BENCH_SMOKE=1: tiny shapes for an execution-path check on CPU (the
# fused interpret path is per-op slow); never writes cpu_baseline.json
SMOKE = os.environ.get("BENCH_SMOKE") == "1"
if SMOKE:
    D, N_CHAINS, BURNIN_GENS, CHUNK, TIMED_CHUNKS = 8, 32, 20, 50, 2


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_means():
    from bipymc_tpu.models.targets import baseline_config3_means
    return baseline_config3_means(D)


def card_info():
    """``name, power.limit`` of the card from nvidia-smi, or None."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def device_record():
    """The device fields every printed result carries."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card_info() or "not available"}


def run_headline():
    import jax
    import jax.numpy as jnp
    from bipymc_tpu.models.targets import (
        gaussian_mixture, gaussian_mixture_block, stratified_mode_init)
    from bipymc_tpu.samplers import dream
    from bipymc_tpu.core.scan import run_scan
    from bipymc_tpu.utils.diagnostics import ess_rate

    log("devices:", jax.devices())
    means = make_means()
    log_prob = gaussian_mixture(means, sigma=1.0)
    cfg = dream.DreamConfig(n_chains=N_CHAINS, burnin_gens=BURNIN_GENS)

    key = jax.random.key(SEED)
    k_x, k_z, k_run = jax.random.split(key, 3)
    # overdispersed ACROSS the posterior's support: 64 chains per mode
    # (a std-2 ball at the origin leaves the whole population in one
    # basin; occupancy below is the guard)
    x0 = stratified_mode_init(k_x, means, N_CHAINS, var=4.0)
    z0 = stratified_mode_init(k_z, means, N_CHAINS, var=4.0)
    state = dream.init(x0, log_prob, cfg, archive_capacity=8192, z0=z0)
    step = dream.make_step(log_prob, cfg, axis_name=None)

    def chunk_run(state, key, t0_):
        return run_scan(
            lambda s, k, t: step(s, k, t0_ + t), state, key, CHUNK,
            collect_fn=lambda s, info: s.x)

    runner = jax.jit(chunk_run)
    t0 = time.time()
    # warmup chunk doubles as burn-in (CHUNK ≥ BURNIN_GENS: adaptation
    # freezes at cfg.burnin_gens inside it)
    state, _ = jax.block_until_ready(
        runner(state, jax.random.fold_in(k_run, 0), jnp.int32(0)))
    log(f"compile + {CHUNK} burn-in gens: {time.time() - t0:.1f}s")

    # timed phase runs the FUSED multi-generation engine
    # (samplers/dream_fused.py — one Pallas kernel per archive_thin
    # generations, Triton on the GPU; semantics pinned in
    # tests/test_fused_chunk.py)
    from bipymc_tpu.samplers.dream_fused import (
        make_chunk_runner, validate_fused_segment)
    validate_fused_segment(cfg, CHUNK)
    fused = make_chunk_runner(
        log_prob, cfg, log_prob_block=gaussian_mixture_block(means))
    fused_run = jax.jit(lambda s, k, t: fused(s, k, CHUNK, t))
    t0 = time.time()
    state, _ = jax.block_until_ready(
        fused_run(state, jax.random.fold_in(k_run, 99), jnp.int32(CHUNK)))
    log(f"fused engine compile + {CHUNK} warm gens: {time.time() - t0:.1f}s")

    hists = []
    t0 = time.time()
    for c in range(TIMED_CHUNKS):
        t = jnp.int32(2 * CHUNK + c * CHUNK)
        state, h = fused_run(state, jax.random.fold_in(k_run, 1 + c), t)
        hists.append(h["x"])
    jax.block_until_ready(hists)
    elapsed = time.time() - t0
    n_gens = TIMED_CHUNKS * CHUNK
    log(f"{n_gens} gens in {elapsed:.3f}s "
        f"({n_gens * N_CHAINS / elapsed:,.0f} chain-steps/s)")

    # host-side history assembly (fixed ESS window convention: last
    # ESS_WINDOW_GENS kept generations — see utils.diagnostics.ess_rate)
    chains = np.swapaxes(
        np.concatenate([np.asarray(h) for h in hists], axis=0), 0, 1)
    gens_per_sec = n_gens / elapsed
    ess, eps = ess_rate(chains, gens_per_sec)
    log(f"ESS (window) over {N_CHAINS} chains: {ess:,.0f}")

    # multimodality diagnostics (R̂/ESS are blind to occupancy):
    # chains-per-mode must stay ≈64/mode for the stratified-ensemble
    # estimate to be valid; the hop rate is expected ~3e-5/chain/gen at
    # d=100 (the correlated-archive-pair channel).
    # Pinned to the host CPU backend: the history is already in host
    # memory, and the accelerator would need the ~1GB copied back to it
    # just to argmin a distance matrix.
    from bipymc_tpu.utils.diagnostics import (host_compute, mode_hops,
                                              mode_occupancy)
    with host_compute():
        occ = np.asarray(mode_occupancy(chains[:, -1, :], means))
        _, hops_rate = mode_hops(chains, means)
        hops_rate = float(hops_rate)
    log(f"mode occupancy (final): {occ.tolist()}; "
        f"hops/chain/gen over timed window: {hops_rate:.2e}")
    if occ.min() == 0:
        log("WARNING: a mode lost all chains — stratified ESS is invalid")

    return {
        "ess": ess,
        "gens_per_sec": gens_per_sec,
        "ess_per_sec": eps,
        "chain_steps_per_sec": n_gens * N_CHAINS / elapsed,
        "engine": "fused",
        "mode_occupancy": occ.tolist(),
        "mode_hops_per_chain_gen": hops_rate,
    }


def run_wall_to_rhat():
    """Second north-star metric (BASELINE.json:2): wall-clock to R̂<1.1 on
    the headline shape — 256 DREAM-zs chains, d=100, on-device streaming
    R̂ stop. Measured WITHIN one basin (population overdispersed around a
    single mode centre): split-R̂ across chains stratified over 70σ-apart
    modes plateaus ≫1.1 by construction, so cross-mode R̂ is unreachable
    for any non-tempered sampler on this target (PT is the composition
    that fixes it). Compile excluded: identical warm
    call first, then reset() and re-time (valid since the pool.py runner-
    cache fix; a regression test pins cache-hit behaviour).
    """
    import jax
    import jax.numpy as jnp
    import bipymc_tpu as bp
    from bipymc_tpu.models.targets import (gaussian_mixture,
                                           gaussian_mixture_block)
    from bipymc_tpu.utils.init import var_ball

    means = make_means()
    log_prob = gaussian_mixture(means, sigma=1.0)
    burn = 100 if SMOKE else 1000
    theta0 = var_ball(jax.random.key(SEED + 1),
                      jnp.full((D,), 4.0, jnp.float32), N_CHAINS,
                      center=jnp.asarray(means[2]), dtype=jnp.float32)
    cs = 20 if SMOKE else 200
    until_kw = dict(rhat_tol=1.1, chunk=cs, max_chunks=150,
                    warmup_chunks=burn // cs + 1)
    # post-burn-in chunks inside the while_loop run on the fused engine
    # — same streams/stopping as fused=False
    # archive_capacity pinned to the SAME ring window the ESS phase uses
    # (8192 = 32 appends × 256 chains). Left to auto-capacity, the
    # max_chunks-based hint balloons the ring to 65536 rows the run never
    # fills — 8× the archive-gather working set for identical semantics
    # over the ~4000 generations actually executed.
    cap = 256 if SMOKE else 8192
    s = bp.DreamZs(log_prob, n_chains=N_CHAINS, seed=SEED,
                   burnin_gens=burn, fused=True, archive_capacity=cap,
                   log_prob_block=gaussian_mixture_block(means))
    t0 = time.time()
    s.run_mcmc_until(theta0, **until_kw)               # compile + warm
    log(f"rhat-stop compile+warm: {time.time() - t0:.1f}s")
    s.reset()
    t0 = time.time()
    info = s.run_mcmc_until(theta0, **until_kw)        # execution only
    wall = time.time() - t0
    log(f"wall to R-hat<1.1: {wall:.3f}s "
        f"({int(info['steps'])} gens, final R-hat "
        f"{float(np.max(info['rhat'])):.3f})")
    return wall, int(info["steps"]), float(np.max(info["rhat"]))


# PINNED perfect-MPI node size — single source of truth shared with
# benchmarks/run_all.py (the two artifacts once published contradictory
# frames when this lived only here).
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "benchmarks"))
from baseline_frame import PERFECT_MPI_CORES  # noqa: E402


def measure_cpu_baseline(path):
    """Reference-semantics NumPy DREAM-zs, single-process rate.

    One continuous run (burn-in + timed window in a single call): the
    NumPy sampler has no persistent generation counter, so restarting it
    for a 'timed segment' re-entered burn-in adaptation/outlier resets
    and reset the archive inside the measured window. Timing the whole
    run and windowing the kept history avoids that; burn-in generations
    cost the same per-generation compute, so the rate is steady-state.

    The cache stores the SINGLE-PROCESS ESS/s; the perfect-MPI frame is
    applied at report time with the pinned PERFECT_MPI_CORES. If a cache
    for the same config already exists, the STRONGER single-process rate
    wins (a weaker bench box must never weaken the denominator).
    """
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "benchmarks"))
    from reference_numpy import NumpyDreamZs, mixture_log_prob_numpy

    means = make_means()
    log_prob = mixture_log_prob_numpy(means)
    rng = np.random.default_rng(SEED)
    # same stratified-across-modes overdispersion as the device run (64
    # chains per mode, std-2 balls) so both sides sample the same
    # stratified-mixture workload
    centers = means[np.arange(N_CHAINS) % means.shape[0]]
    x0 = centers + 2.0 * rng.standard_normal((N_CHAINS, D))
    z0 = centers + 2.0 * rng.standard_normal((N_CHAINS, D))
    sampler = NumpyDreamZs(log_prob, N_CHAINS, burnin_gens=100, seed=SEED)

    burn, timed = 100, 2000
    t0 = time.time()
    hist = sampler.run(x0, z0, burn + timed)
    elapsed = time.time() - t0
    gens_per_sec = (burn + timed) / elapsed

    # ESS with the same estimator AND window as the device run (identical
    # algorithm, so per-generation statistical efficiency carries over)
    from bipymc_tpu.utils.diagnostics import ess_rate
    chains = np.swapaxes(hist[burn:], 0, 1)
    ess, eps_1proc = ess_rate(chains, gens_per_sec)

    baseline = {
        "single_process_gens_per_sec": gens_per_sec,
        "ess_window": ess,
        "single_process_ess_per_sec": eps_1proc,
        "perfect_mpi_cores": PERFECT_MPI_CORES,
        "note": "NumPy reference semantics, SINGLE-process rate; the "
                "perfect-MPI frame multiplies by the pinned "
                "perfect_mpi_cores at report time "
                "(see benchmarks/reference_numpy.py, BASELINE.md)",
        "config": {"d": D, "n_chains": N_CHAINS, "timed_gens": timed},
    }
    prev = _load_baseline(path)
    if (prev is not None
            and prev.get("config") == baseline["config"]
            and prev["single_process_ess_per_sec"]
            > baseline["single_process_ess_per_sec"]):
        log(f"fresh baseline ({eps_1proc:.1f} ESS/s/proc) is weaker than "
            f"cached ({prev['single_process_ess_per_sec']:.1f}) — this "
            "box is slower; keeping the stronger cached denominator")
        baseline = prev
    with open(path, "w") as f:
        json.dump(baseline, f, indent=1)
    return baseline


def _load_baseline(path):
    """Load + normalize the cached denominator; None if absent.

    Migrates the older schema (ess_per_sec pre-multiplied by the bench
    box's os.cpu_count()) to the pinned single-process schema."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        b = json.load(f)
    if "single_process_ess_per_sec" not in b:
        cores = b.get("cores", 1) or 1
        b["single_process_ess_per_sec"] = b["ess_per_sec"] / cores
        b["perfect_mpi_cores"] = PERFECT_MPI_CORES
    return b


def run_northstar():
    """Third phase: the
    cold-start → cross-mode R̂<1.1 pipeline on config 3 (benchmarks/
    northstar_config3.py — SMC mode DISCOVERY (oracle-free) → GMM fit →
    bridge/refit → FlowMh until-stop → validation). bench.py runs the
    headline "discovered" arm; the oracle A/B arm is produced by
    running the harness directly. Returns the arm dict and merges it
    into the JSON artifact (preserving any other recorded arms)."""
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "benchmarks"))
    import northstar_config3
    ns = northstar_config3.pipeline("discovered")
    # single shared artifact writer (a local copy here once dropped the
    # compilation_cache/smoke keys and broke the cache A/B)
    northstar_config3.write_artifact({"discovered": ns})
    return ns


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bipymc_tpu.utils.compile_cache import enable_compile_cache
    device = device_record()
    if device["platform"] != "gpu" and not SMOKE:
        log(f"bench.py: platform is {device['platform']!r}; a measurement "
            "needs a GPU (BENCH_SMOKE=1 runs the tiny-shape check)")
        sys.exit(2)
    enable_compile_cache()
    res = run_headline()
    wall_rhat, rhat_gens, rhat_final = run_wall_to_rhat()
    ns = run_northstar()

    baseline_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "benchmarks", "cpu_baseline.json")
    if SMOKE:
        baseline = {"single_process_ess_per_sec": 1.0}   # never
        log("SMOKE: skipping CPU baseline")  # (over)write the real
    else:                                    # baseline with tiny shapes
        baseline = _load_baseline(baseline_path)
        # the cache is keyed on the benchmark shape: a stale denominator
        # from a different (d, n_chains) would silently corrupt the
        # headline ratio
        cached_cfg = (baseline or {}).get("config", {})
        if (cached_cfg.get("d"), cached_cfg.get("n_chains")) != (D, N_CHAINS):
            log(f"cached CPU baseline is for {cached_cfg} != "
                f"(d={D}, n_chains={N_CHAINS}) — measuring")
            baseline = measure_cpu_baseline(baseline_path)
        log("CPU baseline, single-process ESS/s:",
            baseline["single_process_ess_per_sec"])
    eps_1 = baseline["single_process_ess_per_sec"]
    out = {
        "device": device,
        "metric": "ess_per_sec_dreamzs_256chain_100d",
        "value": round(res["ess_per_sec"], 2),
        "unit": "effective samples/sec/chip",
        "engine": res["engine"],
        # headline ratio: vs a PINNED perfect-MPI single node (no
        # os.cpu_count() dependence); the 1-core ratio is reported
        # alongside for the raw frame
        "vs_baseline": round(res["ess_per_sec"]
                             / (eps_1 * PERFECT_MPI_CORES), 2),
        "vs_1core": round(res["ess_per_sec"] / eps_1, 2),
        "baseline_frame": {
            "single_process_ess_per_sec": round(eps_1, 3),
            "perfect_mpi_cores": PERFECT_MPI_CORES,
        },
        # THE second north-star (BASELINE.json:2), now in its full
        # sense: cold-start pipeline → CROSS-MODE
        # R̂ < 1.1 on the 4-mode config-3 target, compile-excluded
        # (warm splits + cold totals in the northstar sub-dict and
        # benchmarks/northstar_config3.json). No within-basin asterisk:
        # the stop R̂ is over mode-hopping chains and the validation
        # window pins mode-weight error < 0.03.
        "wall_clock_to_crossmode_rhat_1p1_s": ns["northstar_wall_s"],
        "crossmode_split_rhat": ns["validate"]["crossmode_split_rhat"],
        "mode_weight_abs_err": ns["validate"]["mode_weight_abs_err"],
        # ESS/s from the engine that MIXES across
        # modes (fused FlowMh, timed warm window) — parameter ESS plus
        # the conservative mode-INDICATOR ESS, the frame in which a
        # within-basin sampler scores ~0 regardless of speed. The
        # DREAM-zs headline above is the within-basin frame; README
        # "Two ESS frames" explains both.
        "ess_per_sec_crossmode":
            ns["crossmode_ess"]["ess_per_sec_param"],
        "ess_per_sec_mode_indicator":
            ns["crossmode_ess"]["ess_per_sec_mode_indicator"],
        "crossmode_ess": ns["crossmode_ess"],
        "northstar": {
            "cold_total_s": ns["cold_total_s"],
            "warm_s": ns["warm_s"],
            "stop_gens": ns["stop_gens"],
            "stop_rhat_streaming": ns["stop_rhat_streaming"],
            "converged": ns["converged"],
            "posterior_mean_abs_err":
                ns["validate"]["posterior_mean_abs_err"],
            "global_acceptance_per_move":
                ns["validate"]["global_acceptance_per_move"],
        },
        # the single-kernel number, named to carry its asterisk
        # explicitly: DREAM-zs alone,
        # overdispersed WITHIN one basin (see run_wall_to_rhat)
        "wall_clock_to_rhat_1p1_within_basin_s": round(wall_rhat, 3),
        "rhat_stop_generations": rhat_gens,
        "rhat_stop_final": round(rhat_final, 4),
        "rhat_stop_converged": bool(rhat_final < 1.1),
        # multimodality honesty: chains per mode after
        # the timed window (stratified 64×4 init) + measured hop rate
        "mode_occupancy": res["mode_occupancy"],
        "mode_hops_per_chain_gen": res["mode_hops_per_chain_gen"],
    }
    if SMOKE:
        # tiny-shape execution check: mark the line so the stdout JSON
        # can never be ingested as a device measurement
        out["smoke"] = True
    print(json.dumps(out))


if __name__ == "__main__":
    main()
