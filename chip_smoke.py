#!/usr/bin/env python
"""Bring-up smoke test: the main path on one NVIDIA GPU, end to end.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --four-gpus  # the chain-mesh phase on four cards

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

1. the card's name and power limit (``nvidia-smi``), before JAX starts;
2. the tests marked ``gpu`` in a child process (``pytest -m gpu``),
   which must pass and must not be empty — the child exits before this
   process opens the card, so one JAX process holds it at a time;
3. the platform must be ``gpu``; the persistent compile cache is set;
4. each Triton kernel against its plain reference at real widths: the
   fused DREAM-zs chunk (256 chains × d=100, the config-3 mixture,
   archive_thin=10, archive capacity 8192) against the per-generation
   engine, and the fused random-walk chunk against the per-step engine
   at 1 × d=2 (DRAM) and 256 × d=100 (the FlowMh local block); the
   lowered HLO must hold the Triton custom call;
5. the main path through the public API at full width: fused DreamZs at
   256 × 100, the README's DRAM quickstart, the oracle-free north-star
   pipeline, a GP log marginal likelihood at the config-4 shape in
   float32 and float64, and the fused engines in float64;
6. timings (gens/s of the per-generation XLA scan and of each Triton
   engine, compile times, wall clock of phase 5's runs), each line with
   the card's name and power limit.

The last line of standard output is one JSON object naming the device
as JAX reports it.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# kernel vs reference: accept flags identical over the first chunk;
# positions agree to float re-association (the kernel sums over padded
# power-of-two rows in another order, and XLA contracts multiply-adds
# into FMAs where the kernel does not)
RTOL, ATOL = 2e-4, 2e-5


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi gives it."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise SystemExit("chip_smoke: nvidia-smi not found — no NVIDIA GPU")
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def last_line(devices) -> str:
    """The result line: the device as JAX reports it."""
    d0 = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}})


def run_gpu_tests() -> int:
    """Run the ``gpu``-marked tests in a child process; return the number
    that passed. Raises if the run fails or passes nothing."""
    env = dict(os.environ, BIPYMC_GPU_TESTS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", os.path.join(REPO, "tests"),
         "-m", "gpu", "-p", "no:xdist", "-p", "no:cacheprovider", "-q",
         "-rs"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=900)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    print(f"gpu tests: {tail[0]}", flush=True)
    if proc.returncode != 0:
        raise SystemExit("chip_smoke: gpu tests failed\n"
                         + proc.stdout[-6000:] + proc.stderr[-3000:])
    n_passed = count_passed(tail[0])
    if n_passed == 0:
        raise SystemExit("chip_smoke: no gpu test passed\n"
                         + proc.stdout[-3000:])
    return n_passed


def count_passed(summary: str) -> int:
    """Passes in a pytest summary line such as ``12 passed, 1 skipped``."""
    for part in summary.replace("=", " ").split(","):
        words = part.split()
        if len(words) >= 2 and words[1] == "passed":
            return int(words[0])
    return 0


def say(card, *parts):
    print(*parts, f"[{card}]", flush=True)


def timed(fn, reps):
    """Seconds per call of ``fn`` after one warm call (compile excluded)."""
    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def compile_timed(jitted, *args):
    """(compiled executable, lowered HLO text, compile seconds)."""
    t0 = time.perf_counter()
    lowered = jitted.lower(*args)
    compiled = lowered.compile()
    return compiled, lowered.as_text(), time.perf_counter() - t0


def check_close(name, ref, got, first_chunk):
    import numpy as np
    a_ref = np.asarray(ref["accepted"])
    a_got = np.asarray(got["accepted"])
    if not np.array_equal(a_ref[:first_chunk], a_got[:first_chunk]):
        raise SystemExit(f"chip_smoke: {name}: accept flags differ in the "
                         "first chunk")
    x_ref = np.asarray(ref["x"])[:first_chunk]
    x_got = np.asarray(got["x"])[:first_chunk]
    np.testing.assert_allclose(x_got, x_ref, rtol=RTOL, atol=ATOL,
                               err_msg=name)
    return float(np.max(np.abs(x_got - x_ref))), float(
        np.mean(a_ref == a_got))


# ---------------------------------------------------------------------------
# phase 4: each kernel against its plain reference
# ---------------------------------------------------------------------------

def phase_dream_kernel(card, n=256, d=100, capacity=8192, gens=1000):
    import jax
    import numpy as np
    from bipymc_tpu.core.scan import run_scan_thinned
    from bipymc_tpu.models.targets import (
        baseline_config3_means, gaussian_mixture, gaussian_mixture_block,
        stratified_mode_init)
    from bipymc_tpu.ops.route import TRITON_CALL_TARGET
    from bipymc_tpu.samplers import dream
    from bipymc_tpu.samplers.dream_fused import make_chunk_runner

    means = baseline_config3_means(d)
    lp = gaussian_mixture(means)
    cfg = dream.DreamConfig(n_chains=n, burnin_gens=0)
    k_x, k_z, k_run = jax.random.split(jax.random.key(0), 3)
    state = dream.init(stratified_mode_init(k_x, means, n), lp, cfg,
                       capacity, stratified_mode_init(k_z, means, n))
    step = dream.make_step(lp, cfg)

    def collect(s, i):
        return {"x": s.x, "logp": i.logp, "accepted": i.accepted}

    def pergen(s, k, n_gens):
        return run_scan_thinned(step, s, k, n_steps=n_gens, thin=1,
                                collect_fn=collect, t0=0)

    G = cfg.archive_thin
    with jax.default_matmul_precision("highest"):
        _, ref = jax.jit(lambda s, k: pergen(s, k, 2 * G))(state, k_run)
    runner = make_chunk_runner(lp, cfg,
                               log_prob_block=gaussian_mixture_block(means))
    fused, hlo, t_compile = compile_timed(
        jax.jit(lambda s, k: runner(s, k, 2 * G, 0)), state, k_run)
    if TRITON_CALL_TARGET not in hlo:
        raise SystemExit("chip_smoke: fused DREAM lowered without Triton")
    _, got = fused(state, k_run)
    dx, agree = check_close("fused DREAM vs per-generation", ref, got, G)
    say(card, f"kernel dream_fused_chunk {n}x{d}: accept flags identical "
        f"over the first chunk ({G} gens), {agree:.4f} of all {2 * G}; "
        f"max |dx| {dx:.3e} within rtol={RTOL} atol={ATOL}; reference "
        "under default_matmul_precision('highest')")
    say(card, f"kernel dream_fused_chunk memory: {fused.memory_analysis()}")

    pg, _, t_pg_compile = compile_timed(
        jax.jit(lambda s, k: pergen(s, k, gens)), state, k_run)
    fr, _, t_fr_compile = compile_timed(
        jax.jit(lambda s, k: runner(s, k, gens, 0)), state, k_run)
    r_pg = gens / timed(lambda: pg(state, k_run), 3)
    r_fr = gens / timed(lambda: fr(state, k_run), 3)
    say(card, f"timing dream {n}x{d}: per-generation XLA scan {r_pg:.1f} "
        f"gens/s, fused Triton engine {r_fr:.1f} gens/s "
        f"({r_fr / r_pg:.2f}x); compile s: fused chunk check "
        f"{t_compile:.2f}, per-generation {t_pg_compile:.2f}, fused "
        f"{t_fr_compile:.2f}")
    return {"pergen_gens_per_s": r_pg, "fused_gens_per_s": r_fr}


def phase_rw_kernel(card, n, d, kind, steps=100, timing_steps=2000):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bipymc_tpu.core.scan import run_scan_thinned
    from bipymc_tpu.models.targets import (
        baseline_config3_means, correlated_gaussian,
        correlated_gaussian_block, gaussian_mixture, gaussian_mixture_block,
        stratified_mode_init)
    from bipymc_tpu.ops.route import TRITON_CALL_TARGET
    from bipymc_tpu.samplers import rw
    from bipymc_tpu.samplers.rw_fused import make_rw_chunk_runner

    if kind == "dram":
        mean = np.array([0.5, -0.5], np.float32)
        cov = np.array([[1.0, 0.3], [0.3, 0.5]], np.float32)
        lp, blk = correlated_gaussian(mean, cov), correlated_gaussian_block(
            mean, cov)
        cfg = rw.dram_config(adapt_interval=steps, t0=0)
        theta0 = jnp.zeros((n, d))
        cov0 = jnp.eye(d) * 0.5
    else:
        means = baseline_config3_means(d)
        lp, blk = gaussian_mixture(means), gaussian_mixture_block(means)
        cfg = rw.metropolis_config()
        theta0 = stratified_mode_init(jax.random.key(1), means, n)
        cov0 = jnp.eye(d) * (0.2 * 2.38) ** 2 / d
    state = jax.vmap(lambda t: rw.init(t, lp, cov0))(theta0)
    step = rw.make_step(lp, cfg)
    cids = jnp.arange(n)

    def batched(s, k, t):
        ks = jax.vmap(lambda i: jax.random.fold_in(k, i))(cids)
        return jax.vmap(step, in_axes=(0, 0, None))(s, ks, t)

    def collect(s, i):
        return {"x": s.theta, "logp": i.logp, "accepted": i.accepted}

    def perstep(s, k, n_steps):
        return run_scan_thinned(batched, s, k, n_steps=n_steps, thin=1,
                                collect_fn=collect, t0=0)

    k_run = jax.random.key(7)
    with jax.default_matmul_precision("highest"):
        _, ref = jax.jit(lambda s, k: perstep(s, k, 2 * steps))(state,
                                                                k_run)
    runner = make_rw_chunk_runner(lp, cfg, n, log_prob_block=blk,
                                  chunk_steps=steps)
    fused, hlo, t_compile = compile_timed(
        jax.jit(lambda s, k: runner(s, k, 2 * steps, 0)), state, k_run)
    if TRITON_CALL_TARGET not in hlo:
        raise SystemExit("chip_smoke: fused RW lowered without Triton")
    _, got = fused(state, k_run)
    dx, agree = check_close(f"fused RW {kind} vs per-step", ref, got, steps)
    say(card, f"kernel rw_fused_chunk {kind} {n}x{d}: accept flags "
        f"identical over the first chunk ({steps} steps), {agree:.4f} of "
        f"all {2 * steps}; max |dx| {dx:.3e} within rtol={RTOL} "
        f"atol={ATOL}; reference under default_matmul_precision('highest')")
    say(card, f"kernel rw_fused_chunk {kind} memory: "
        f"{fused.memory_analysis()}")

    ps, _, t_ps_compile = compile_timed(
        jax.jit(lambda s, k: perstep(s, k, timing_steps)), state, k_run)
    fr, _, t_fr_compile = compile_timed(
        jax.jit(lambda s, k: runner(s, k, timing_steps, 0)), state, k_run)
    r_ps = timing_steps / timed(lambda: ps(state, k_run), 3)
    r_fr = timing_steps / timed(lambda: fr(state, k_run), 3)
    say(card, f"timing rw {kind} {n}x{d}: per-step XLA scan {r_ps:.1f} "
        f"steps/s, fused Triton engine {r_fr:.1f} steps/s "
        f"({r_fr / r_ps:.2f}x); compile s: fused chunk check "
        f"{t_compile:.2f}, per-step {t_ps_compile:.2f}, fused "
        f"{t_fr_compile:.2f}")
    return {"perstep_steps_per_s": r_ps, "fused_steps_per_s": r_fr}


# ---------------------------------------------------------------------------
# phase 5: the main path through the public API
# ---------------------------------------------------------------------------

def phase_dreamzs_api(card, n=256, d=100, gens=3000):
    import jax
    import numpy as np
    import bipymc_tpu as bp
    from bipymc_tpu.models.targets import (
        baseline_config3_means, gaussian_mixture, gaussian_mixture_block,
        stratified_mode_init)
    from bipymc_tpu.utils.diagnostics import mode_occupancy

    means = baseline_config3_means(d)
    s = bp.DreamZs(gaussian_mixture(means), n_chains=n, seed=0, fused=True,
                   archive_capacity=8192,
                   log_prob_block=gaussian_mixture_block(means))
    x0 = stratified_mode_init(jax.random.key(0), means, n)
    t0 = time.perf_counter()
    s.run_mcmc(gens, x0)
    wall = time.perf_counter() - t0
    logp = np.asarray(s._history["logp"])
    acc = float(np.mean(s.acceptance_fraction))
    occ = np.asarray(mode_occupancy(s.final_state.x, means))
    ok = (np.all(np.isfinite(logp)) and 0.005 < acc < 0.9
          and np.all(occ > 0))
    say(card, f"api DreamZs(fused=True) {n}x{d}, {gens} gens "
        f"({s.cfg.burnin_gens} per-generation burn-in, rest fused): "
        f"finite logp {bool(np.all(np.isfinite(logp)))}, acceptance "
        f"{acc:.4f}, mode occupancy {occ.tolist()}; wall_clock "
        f"{wall:.2f} s (compile included)")
    if not ok:
        raise SystemExit("chip_smoke: fused DreamZs failed its checks")


def phase_dram_quickstart(card):
    """The README quickstart, verbatim in substance."""
    import jax.numpy as jnp
    import numpy as np
    import bipymc_tpu as bp
    from bipymc_tpu.models import line_fit_log_like

    rng = np.random.default_rng(0)
    x = np.linspace(0, 10, 50)
    y = 2.0 * x + 1.0 + rng.normal(0, 1.0, 50)
    s = bp.Dram(line_fit_log_like(x, y, sigma=1.0), seed=0, n_chains=4)
    t0 = time.perf_counter()
    s.run_mcmc(4000, jnp.array([0.0, 0.0]), cov_est=jnp.eye(2) * 0.1)
    flat = s.get_chain(discard=1500, flat=True)
    wall = time.perf_counter() - t0
    # least-squares truth and its standard error (flat prior, σ=1)
    A = np.stack([x, np.ones_like(x)], 1)
    truth = np.linalg.lstsq(A, y, rcond=None)[0]
    se = np.sqrt(np.diag(np.linalg.inv(A.T @ A)))
    err = np.abs(flat.mean(0) - truth) / se
    say(card, f"api Dram quickstart: posterior mean {flat.mean(0).round(4)}"
        f" vs least squares {truth.round(4)} ({err.max():.3f} posterior "
        f"sd); wall_clock {wall:.2f} s (compile included)")
    if err.max() > 0.5:
        raise SystemExit("chip_smoke: DRAM quickstart posterior is off")


def phase_northstar(card):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "northstar_config3",
        os.path.join(REPO, "benchmarks", "northstar_config3.py"))
    ns = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ns)
    t0 = time.perf_counter()
    out = ns.pipeline("discovered")
    wall = time.perf_counter() - t0
    v = out["validate"]
    say(card, f"api north-star pipeline('discovered') d={ns.D}, "
        f"{ns.N_CHAINS} chains: converged {out['converged']}, stop R-hat "
        f"{out['stop_rhat_streaming']}, cross-mode split R-hat "
        f"{v['crossmode_split_rhat']}, mode weights {v['mode_weights']}, "
        f"mode_weight_abs_err {v['mode_weight_abs_err']}; warm wall "
        f"{out['northstar_wall_s']} s, cold {out['cold_total_s']} s; "
        f"wall_clock of the whole phase {wall:.2f} s")
    if not (out["converged"] and v["mode_weight_abs_err"] < 0.03):
        raise SystemExit("chip_smoke: north-star pipeline failed")


def gp_reference_lml(x, y, theta, eps):
    """GP log marginal likelihood in float64 NumPy/SciPy, one θ row of
    [log ℓ₁, log ℓ₂, log σ_f, log σ_n], with the regressor's jitter
    floor for a dtype of machine epsilon ``eps``."""
    import numpy as np
    from scipy.linalg import cho_factor, cho_solve
    n = x.shape[0]
    ls, sf2, sn2 = np.exp(theta[0:2]), np.exp(2 * theta[2]), np.exp(
        2 * theta[3])
    xs = x / ls
    r2 = ((xs[:, None, :] - xs[None, :, :]) ** 2).sum(-1)
    jitter = max(1e-5, 4.0 * n * eps)
    k = sf2 * np.exp(-0.5 * r2) + (sn2 + jitter * sf2) * np.eye(n)
    c, low = cho_factor(k, lower=True)
    alpha = cho_solve((c, low), y)
    return (-0.5 * y @ alpha - np.sum(np.log(np.diag(c)))
            - 0.5 * n * np.log(2 * np.pi))


def phase_gp(card, n=512, chains=64):
    """Config-4 shape: 64 vmapped log-ML evaluations at n=512."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bipymc_tpu.gp.regressor import GpRegressor

    rng = np.random.default_rng(7)
    x = rng.uniform(-4, 4, (n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.2, n)
    theta = np.stack([rng.normal(0, 0.3, chains), rng.normal(0, 0.3,
                      chains), rng.normal(0, 0.3, chains),
                      rng.normal(-1.6, 0.2, chains)], 1)
    gp = GpRegressor()

    def reference(dtype):
        eps = float(np.finfo(dtype).eps)
        return np.array([gp_reference_lml(x, y, t, eps) for t in theta])

    def lml(dtype):
        xj, yj = jnp.asarray(x, dtype), jnp.asarray(y, dtype)

        def one(t):
            p = {"log_lengthscale": t[0:2], "log_sigma_f": t[2],
                 "log_sigma_n": t[3]}
            return gp._lml_impl(p, xj, yj)
        f = jax.jit(jax.vmap(one))
        t0 = time.perf_counter()
        out = np.asarray(f(jnp.asarray(theta, dtype)))
        t_first = time.perf_counter() - t0
        rate = chains / timed(lambda: f(jnp.asarray(theta, dtype)), 5)
        return out, t_first, rate

    got32, t32, r32 = lml(jnp.float32)
    with jax.enable_x64(True):
        got64, t64, r64 = lml(jnp.float64)
    # float32: n·ε·cond-scaled rounding of a 512×512 factorisation;
    # float64: the same algorithm as the reference in another summation
    # order (cuSOLVER vs LAPACK), so round-off only
    ref32, ref64 = reference(np.float32), reference(np.float64)
    err32 = float(np.max(np.abs(got32 - ref32) / np.abs(ref32)))
    err64 = float(np.max(np.abs(got64 - ref64) / np.abs(ref64)))
    say(card, f"api GP log-ML n={n} x {chains} vmapped chains vs SciPy "
        f"float64: float32 max rel err {err32:.2e} (tol 1e-3), float64 "
        f"{err64:.2e} (tol 1e-8); log-ML evals/s f32 {r32:.1f}, f64 "
        f"{r64:.1f}; wall_clock first call f32 {t32:.2f} s, f64 "
        f"{t64:.2f} s")
    if not (err32 < 1e-3 and err64 < 1e-8):
        raise SystemExit("chip_smoke: GP log-ML disagrees with SciPy")


def phase_fused_f64(card):
    """The fused engines in float64 on the card, against their float64
    per-generation / per-step references."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import bipymc_tpu as bp
    from bipymc_tpu.models.targets import (
        correlated_gaussian, correlated_gaussian_block, gaussian_mixture,
        gaussian_mixture_block)

    with jax.enable_x64(True):
        means = np.zeros((2, 6))
        means[1, 0] = 4.0
        kw = dict(n_chains=32, seed=5, archive_thin=5, burnin_gens=10,
                  archive_capacity=256, dtype=jnp.float64)
        x0 = jax.random.normal(jax.random.key(1), (32, 6), jnp.float64)
        ref = bp.DreamZs(gaussian_mixture(means), **kw)
        ref.run_mcmc(60, x0)
        fus = bp.DreamZs(gaussian_mixture(means), fused=True,
                         log_prob_block=gaussian_mixture_block(means), **kw)
        fus.run_mcmc(60, x0)
        d_dream = float(np.max(np.abs(fus.super_chain - ref.super_chain)))
        same_d = np.array_equal(ref._history["accepted"],
                                fus._history["accepted"])

        mean, cov = np.array([0.5, -0.5]), np.array([[1.0, 0.3],
                                                     [0.3, 0.5]])
        rkw = dict(n_chains=4, seed=3, dtype=jnp.float64, adapt_interval=50)
        a = bp.Dram(correlated_gaussian(mean, cov), **rkw)
        a.run_mcmc(200, jnp.zeros(2, jnp.float64), cov_est=jnp.eye(2))
        b = bp.Dram(correlated_gaussian(mean, cov), fused=True,
                    log_prob_block=correlated_gaussian_block(mean, cov),
                    **rkw)
        b.run_mcmc(200, jnp.zeros(2, jnp.float64), cov_est=jnp.eye(2))
        d_rw = float(np.max(np.abs(a.super_chain - b.super_chain)))
        same_r = np.array_equal(a._history["accepted"],
                                b._history["accepted"])
        dtypes = {fus.super_chain.dtype, b.super_chain.dtype}
    say(card, f"api fused float64: DreamZs accept flags identical {same_d}, "
        f"max |dx| {d_dream:.3e}; Dram accept flags identical {same_r}, "
        f"max |dx| {d_rw:.3e}; dtypes {sorted(map(str, dtypes))}")
    if not (same_d and same_r and d_dream < 1e-9 and d_rw < 1e-9
            and dtypes == {np.dtype(np.float64)}):
        raise SystemExit("chip_smoke: fused float64 disagrees")


# ---------------------------------------------------------------------------
# --four-gpus: the chain mesh
# ---------------------------------------------------------------------------

def phase_four_gpus(card, n=1024, d=100, gens=600):
    import jax
    import numpy as np
    import bipymc_tpu as bp
    from bipymc_tpu.models.targets import (
        baseline_config3_means, gaussian_mixture, gaussian_mixture_block,
        stratified_mode_init)
    from bipymc_tpu.parallel.mesh import chain_mesh

    n_dev = len(jax.devices())
    if n_dev != 4:
        raise SystemExit(f"chip_smoke --four-gpus: found {n_dev} devices")
    means = baseline_config3_means(d)
    x0 = stratified_mode_init(jax.random.key(0), means, n)
    mesh = chain_mesh(4)
    for fused in (False, True):
        kw = dict(n_chains=n, seed=0, archive_capacity=8192,
                  burnin_gens=100, fused=fused)
        if fused:
            kw["log_prob_block"] = gaussian_mixture_block(means)
        single = bp.DreamZs(gaussian_mixture(means), **kw)
        t0 = time.perf_counter()
        single.run_mcmc(gens, x0)
        t_single = time.perf_counter() - t0
        meshed = bp.DreamZs(gaussian_mixture(means), mesh=mesh, **kw)
        t0 = time.perf_counter()
        meshed.run_mcmc(gens, x0)
        t_mesh = time.perf_counter() - t0
        devs = meshed._chunks[-1]["x"].sharding.device_set
        buf_devs = meshed.final_state.archive.buf.sharding.device_set
        a1 = np.asarray(single._history["accepted"])
        a2 = np.asarray(meshed._history["accepted"])
        x1, x2 = single.super_chain, meshed.super_chain
        dx = float(np.max(np.abs(x1 - x2)))
        same = bool(np.array_equal(a1, a2))
        say(card, f"mesh DreamZs(fused={fused}) {n}x{d} on chain_mesh(4) "
            f"vs one device, {gens} gens: accept flags identical {same} "
            f"({np.mean(a1 == a2):.4f} agree), max |dx| {dx:.3e}, history "
            f"on {len(devs)} devices, archive replicated on "
            f"{len(buf_devs)}; wall_clock single {t_single:.2f} s, mesh "
            f"{t_mesh:.2f} s (compile included)")
        if len(devs) != 4 or len(buf_devs) != 4:
            raise SystemExit("chip_smoke: mesh run did not use 4 devices")
        # the first archive_thin generations see identical inputs, so
        # they must agree to the kernel tolerance on every card
        G = single.cfg.archive_thin
        np.testing.assert_allclose(x2[:, :G], x1[:, :G], rtol=RTOL,
                                   atol=ATOL)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the chain-mesh phase on four cards")
    args = ap.parse_args(argv)

    card = card_line()
    print(f"card: {card}", flush=True)
    if not args.four_gpus:
        run_gpu_tests()

    sys.path.insert(0, REPO)
    import jax
    from bipymc_tpu.utils.compile_cache import enable_compile_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: platform is {devices[0].platform!r}"
                         ", not 'gpu'")
    print(f"compile cache: {enable_compile_cache()}", flush=True)

    if args.four_gpus:
        phase_four_gpus(card)
    else:
        phase_dream_kernel(card)
        phase_rw_kernel(card, 1, 2, "dram")
        phase_rw_kernel(card, 256, 100, "mh")
        phase_dreamzs_api(card)
        phase_dram_quickstart(card)
        phase_northstar(card)
        phase_gp(card)
        phase_fused_f64(card)
    print(last_line(devices), flush=True)


if __name__ == "__main__":
    main()
