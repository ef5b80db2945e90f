"""Marginal likelihood from power-posterior parallel tempering.

Thermodynamic integration (Lartillot & Philippe 2006; Friel & Pettitt
2008) and stepping-stone sampling (Xie, Lewis, Fan, Kuo & Chen 2011)
from ONE parallel-tempering run over the power-posterior path

    pi_beta(theta) ∝ p(theta) · L(theta)^beta,    beta ∈ [0, 1],

whose endpoints are the proper normalised prior (beta=0) and the
posterior (beta=1). With Z(beta) = ∫ p·L^beta dtheta, the evidence
Z = Z(1)/Z(0) = Z(1) follows two ways from the same rung draws:

  TI:  log Z = ∫₀¹ E_beta[log L] dbeta            (trapezoid over rungs)
  SS:  log Z = Σ_k log E_{beta_k}[ exp((beta_{k+1} − beta_k)·log L) ]

TI carries the trapezoid's discretisation bias (one-signed: E_beta[log L]
is increasing and convex-ish, so too-few rungs biases TI low near beta=0);
each SS ratio is an importance-sampling estimate that is exact in
expectation but noisier when adjacent rungs overlap poorly. Reporting
BOTH and checking agreement within the Monte-Carlo error is the standard
practice (Xie 2011 §2.4) — this harness returns both from one run.

This completes the evidence toolkit's third leg: SMC (samplers/smc.py)
anneals a population once through the same path and prices Z from the
telescoped normalising increments; nested sampling (samplers/ns.py)
integrates the likelihood over prior volume; power-posterior PT runs
STATIONARY chains at fixed rungs — the right tool when you also want
converged posterior draws (the beta=1 rung IS a posterior sample), when
rung-level diagnostics (R-hat per rung, swap rates) must certify the
estimate, or when the evidence of an already-running PT workflow is
wanted at marginal extra cost.

Accelerator shape: the whole run is one ``lax.scan`` over the stacked
[n_temps, n_chains] PT step (temps × chains double vmap —
samplers/tempering.py), with the TI/SS sufficient statistics streamed in
the carry (running sums + a running logsumexp per interface), so memory
is O(K) regardless of run length and nothing leaves the device until the
end. Under ``mesh=`` the chain axis shards exactly as ParallelTempering's
does (ladder replicated per shard, swaps local); the recorded per-chain
log L values are all_gathered and reduced with the identical full-axis
expressions the vmap path runs (design.md §3 gather-then-reduce rule),
so the estimates are bit-identical to the single-device run.

Reference anchor: the reference (wgurecky/bipymc, SURVEY.md §1) offers
no evidence estimation — beyond-reference extra, literature-anchored.
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from bipymc_tpu.parallel.collectives import psum_chains
from bipymc_tpu.parallel.mesh import CHAIN_AXIS
from bipymc_tpu.samplers import rw, tempering


class EvidenceResult(NamedTuple):
    """Both estimators + the per-rung curve they integrate.

    Arrays are host NumPy; ``betas`` is descending (ladder order,
    ``betas[0]=1``) and every per-rung field aligns with it.
    """

    log_z_ti: float            # thermodynamic-integration estimate
    log_z_ss: float            # stepping-stone estimate
    mcse_ti: float             # TI Monte-Carlo SE (independent-draws
    #                            approximation at the recording cadence —
    #                            optimistic if record_every is small)
    betas: tuple               # descending, 1 → 0
    mean_ell: np.ndarray       # [K] E_beta[log L] per rung (the TI curve)
    var_ell: np.ndarray        # [K] Var_beta[log L] per rung
    swap_rate: np.ndarray      # [K-1] measured swap acceptance/interface
    n_recorded: int            # draws per rung entering the estimates
    state: tempering.PtState   # final state (beta=1 rung = posterior draws)


def power_ladder(n_temps: int, c: float = 5.0) -> tuple:
    """Friel–Pettitt rung spacing beta_k = (k/(K−1))^c, descending 1 → 0.

    c≈5 crowds rungs near beta=0, where E_beta[log L] moves fastest
    (the prior-to-posterior transition); c=1 is uniform. Returns the
    descending tuple PtConfig expects, endpoints exactly 1 and 0.
    """
    if n_temps < 2:
        raise ValueError("power_ladder needs n_temps >= 2")
    return tuple(float(((n_temps - 1 - k) / (n_temps - 1)) ** c)
                 for k in range(n_temps))


def _lse_update(m, se, v):
    """Streaming logsumexp: fold batch ``v`` [K-1, M] into per-interface
    running (max ``m``, scaled sum ``se``). −inf-safe on both sides."""
    vm = jnp.max(v, axis=1)
    m_new = jnp.maximum(m, vm)
    # exp(−inf − −inf) would be NaN; a −inf running max means "no finite
    # value yet" and contributes 0
    old = jnp.where(jnp.isfinite(m), se * jnp.exp(m - m_new), 0.0)
    add = jnp.sum(jnp.where(jnp.isfinite(v),
                            jnp.exp(v - m_new[:, None]), 0.0), axis=1)
    return m_new, old + add


def power_posterior_evidence(
        log_prior: Callable, log_like: Callable, theta0, *,
        betas=None, n_temps: int = 8, c: float = 5.0,
        n_gens: int = 4000, burn: int = None, cov0=None,
        kernel: rw.RwConfig = None, swap_interval: int = 10,
        record_every: int = None, seed: int = 0,
        mesh=None) -> EvidenceResult:
    """Estimate log Z = log ∫ p(θ)·L(θ) dθ by TI + stepping stone.

    log_prior: log of a PROPER normalised prior density (the beta=0
        rung samples it directly — an unnormalised prior shifts log Z by
        its unknown log-normaliser).
    log_like: log-likelihood log L(θ) (NOT the joint posterior — the
        split is what defines the path).
    theta0: [d] (dispersed per chain/rung from the kernel's proposal
        scale is the caller's job — pass [n_chains, d] or
        [n_temps, n_chains, d] for explicit control; lower-rank inputs
        are tiled).
    betas: descending ladder 1 → 0 (default :func:`power_ladder`
        (n_temps, c)); must end at exactly 0 — the prior endpoint is
        what normalises the telescope.
    kernel: RW-family config per rung (default DRAM —
        ``rw.dram_config()``; adaptation is per-rung, which the
        rung-scale differences need).
    record_every: cadence (generations) at which post-burn draws enter
        the estimators; default ``swap_interval`` (thinned at the swap
        cadence). Each recorded generation costs one extra [K, M]
        ``log_like`` eval.
    mesh: 1-D chain mesh (parallel/mesh.chain_mesh) — shards the chain
        axis; estimates are bit-identical to the vmap run.

    Returns :class:`EvidenceResult`. n_chains is taken from theta0's
    shape (default 8 when theta0 is [d]).
    """
    if betas is None:
        betas = power_ladder(n_temps, c)
    betas = tuple(float(b) for b in betas)
    if (abs(betas[0] - 1.0) > 1e-9 or betas[-1] != 0.0
            or any(a <= b for a, b in zip(betas, betas[1:]))):
        raise ValueError(
            "betas must be STRICTLY descending from exactly 1 to exactly "
            "0 (the power-posterior path's endpoints; a repeated rung "
            "makes the stepping-stone increment degenerate); got %r"
            % (betas,))
    n_temps = len(betas)
    if burn is None:
        burn = n_gens // 4
    if record_every is None:
        record_every = swap_interval
    if kernel is None:
        kernel = rw.dram_config()
    if not isinstance(kernel, rw.RwConfig):
        raise ValueError("kernel must be an rw.RwConfig (the gradient "
                         "kernels don't support power posteriors — "
                         "tempering.make_step docstring)")
    n_rec = len(range(burn, n_gens, record_every))
    if n_rec == 0:
        raise ValueError("no recorded generations: need n_gens > burn")

    theta0 = jnp.asarray(theta0, jnp.float32)
    if theta0.ndim == 1:
        theta0 = jnp.tile(theta0, (8, 1))
    if theta0.ndim == 2:
        theta0 = jnp.tile(theta0, (n_temps, 1, 1))
    if theta0.shape[0] != n_temps:
        raise ValueError(f"theta0 leading axis {theta0.shape[0]} != "
                         f"n_temps {n_temps}")
    n_chains, d = theta0.shape[1], theta0.shape[2]
    if mesh is not None and n_chains % mesh.size != 0:
        raise ValueError(f"n_chains={n_chains} must divide evenly over "
                         f"the {mesh.size}-device mesh")
    if cov0 is None:
        cov0 = jnp.eye(d, dtype=theta0.dtype)

    cfg = tempering.PtConfig(betas=betas, swap_interval=int(swap_interval),
                             kernel=kernel)
    axis = CHAIN_AXIS if mesh is not None else None
    step = tempering.make_step(log_like, cfg, axis_name=axis,
                               log_prior=log_prior)
    b_col = jnp.asarray(betas, jnp.float32)[:, None]           # [K, 1]
    delta = b_col[:-1] - b_col[1:]                             # [K-1, 1] > 0
    base_key = jax.random.key(seed)
    si = int(swap_interval)

    def run(state0):
        n_global = n_chains  # recorded stats are over the GLOBAL population

        def gen(carry, t):
            state, acc = carry
            state, info = step(state, jax.random.fold_in(base_key, t), t)

            def record(a):
                theta = tempering.positions(state.kernel)      # [K, m, d]
                ell = jax.vmap(jax.vmap(log_like))(theta)      # [K, m]
                if axis is not None:
                    # gather-then-reduce (design.md §3): full-population
                    # reductions below run identically on every shard
                    ell = lax.all_gather(ell, axis, axis=1, tiled=True)
                m, se = _lse_update(a["m"], a["se"], delta * ell[1:])
                fin = jnp.isfinite(ell)
                return dict(
                    n=a["n"] + 1,
                    s0=a["s0"] + jnp.sum(fin.astype(jnp.int32), axis=1),
                    s1=a["s1"] + jnp.sum(jnp.where(fin, ell, 0.0), axis=1),
                    s2=a["s2"] + jnp.sum(
                        jnp.where(fin, ell * ell, 0.0), axis=1),
                    m=m, se=se,
                    swap_acc=a["swap_acc"], swap_att=a["swap_att"])

            rec = (t >= burn) & ((t - burn) % record_every == 0)
            acc = lax.cond(rec, record, lambda a: a, acc)

            # swap-rate accounting (integer — psum exact on the mesh)
            is_swap = (t % si) == (si - 1)
            parity = (t // si) % 2
            att = (is_swap & (jnp.arange(n_temps - 1) % 2 == parity))
            acc["swap_att"] = acc["swap_att"] + att.astype(jnp.int32) * (
                n_global)
            acc["swap_acc"] = acc["swap_acc"] + psum_chains(
                jnp.sum(info.pair_swap[:-1].astype(jnp.int32), axis=1),
                axis)
            return (state, acc), None

        acc0 = dict(
            n=jnp.zeros((), jnp.int32),
            s0=jnp.zeros((n_temps,), jnp.int32),
            s1=jnp.zeros((n_temps,), jnp.float32),
            s2=jnp.zeros((n_temps,), jnp.float32),
            m=jnp.full((n_temps - 1,), -jnp.inf, jnp.float32),
            se=jnp.zeros((n_temps - 1,), jnp.float32),
            swap_acc=jnp.zeros((n_temps - 1,), jnp.int32),
            swap_att=jnp.zeros((n_temps - 1,), jnp.int32))
        (state, acc), _ = lax.scan(
            gen, (state0, acc0), jnp.arange(n_gens, dtype=jnp.int32))
        return state, acc

    state0 = tempering.init(theta0, log_like, cfg, cov0,
                            log_prior=log_prior)
    if mesh is None:
        state, acc = jax.jit(run)(state0)
    else:
        specs = _pt_specs(state0, axis)
        acc_specs = dict(n=P(), s0=P(), s1=P(), s2=P(), m=P(), se=P(),
                         swap_acc=P(), swap_att=P())
        runner = jax.jit(jax.shard_map(
            run, mesh=mesh, in_specs=(specs,),
            out_specs=(specs, acc_specs), check_vma=False))
        state, acc = runner(state0)

    acc = jax.device_get(acc)
    # per-rung finite-draw counts (post-burn chains out of support are
    # excluded from the moments, not silently zero-averaged)
    n_fin = np.maximum(np.asarray(acc["s0"], np.float64), 1.0)
    mean_ell = acc["s1"] / n_fin
    var_ell = np.maximum(acc["s2"] / n_fin - mean_ell ** 2, 0.0)
    db = np.asarray(betas[:-1]) - np.asarray(betas[1:])        # [K-1]
    log_z_ti = float(np.sum(db * (mean_ell[:-1] + mean_ell[1:]) / 2.0))
    # SS: interface k uses the LOWER rung's draws (index k+1, smaller β);
    # the −inf guard in _lse_update drops non-finite draws from se, so
    # divide by the matching finite count
    log_z_ss = float(np.sum(
        acc["m"] + np.log(np.maximum(acc["se"], 1e-300))
        - np.log(n_fin[1:])))
    w = np.concatenate([[db[0] / 2], (db[:-1] + db[1:]) / 2, [db[-1] / 2]])
    mcse_ti = float(np.sqrt(np.sum(w ** 2 * var_ell / n_fin)))
    swap_rate = acc["swap_acc"] / np.maximum(acc["swap_att"], 1)
    return EvidenceResult(
        log_z_ti=log_z_ti, log_z_ss=log_z_ss, mcse_ti=mcse_ti,
        betas=betas, mean_ell=np.asarray(mean_ell),
        var_ell=np.asarray(var_ell), swap_rate=np.asarray(swap_rate),
        n_recorded=int(acc["n"]), state=state)


def _pt_specs(state, axis_name):
    """PartitionSpecs for a PtState: chains shard at axis 1, counters
    replicate (the same layout samplers/api.ParallelTempering uses)."""
    from bipymc_tpu.parallel.pool import _state_specs
    return _state_specs(state, ("kernel@1", "direction@1"), axis_name)


class BridgeResult(NamedTuple):
    log_z: float              # optimal-bridge log-evidence estimate
    n_iter: int               # fixed-point iterations to tolerance
    converged: bool
    re2: float                # approximate relative squared error of Ẑ
    #                           (Frühwirth-Schnatter 2004 spectral form,
    #                           computed under an independence
    #                           approximation — optimistic for
    #                           autocorrelated draws; thin first)
    log_l1: np.ndarray        # [N1] log(q/g) at the posterior draws
    log_l2: np.ndarray        # [N2] log(q/g) at the proposal draws


def bridge_evidence(samples, log_prob: Callable, *, n_proposal=None,
                    seed: int = 0, max_iter: int = 200,
                    tol: float = 1e-6) -> BridgeResult:
    """Marginal likelihood from EXISTING posterior draws (bridge sampling).

    The optimal-bridge estimator (Meng & Wong 1996; tutorial: Gronau et
    al. 2017): with q = unnormalised posterior (``log_prob`` — the same
    joint log p(θ)+log L(θ) every sampler in this package consumes), a
    NORMALISED proposal g (here: a Gaussian moment-matched to the
    draws), N₁ posterior draws and N₂ fresh proposal draws, iterate

        r ← [ (1/N₂) Σ_j l₂ⱼ/(s₁·l₂ⱼ + s₂·r) ] /
            [ (1/N₁) Σ_i   1/(s₁·l₁ᵢ + s₂·r) ],    l = q/g,

    whose fixed point is the evidence Z (s₁=N₁/(N₁+N₂), s₂=1−s₁). The
    iteration runs entirely in log space (logsumexp both sums) inside
    one ``lax.while_loop`` — jittable, −inf-safe (a proposal draw
    outside q's support contributes l₂=0, which the estimator handles
    by construction).

    Where it sits in the evidence toolkit: SMC/NS/power-posterior PT
    (above) each run their OWN annealed/tempered pass; bridge sampling
    prices Z from draws you already have — one extra vmapped
    ``log_prob`` eval over N₂ proposal points. Its failure mode is
    poor posterior↔proposal overlap (heavy tails, multimodality a
    single Gaussian can't cover): watch ``re2`` and cross-check against
    a path-based estimator when it matters. For multimodal posteriors
    feed draws from a sampler that actually visits all modes (SMC / PT
    cold rung / stratified DREAM) — the moment-matched Gaussian then
    covers the union.

    samples: [N, d] posterior draws (thin to ≈independence first: the
        re2 formula assumes independent draws) — or [chains, T, d],
        flattened internally.
    log_prob: unnormalised log posterior (prior × likelihood).
    n_proposal: N₂ (default N₁).
    """
    x = jnp.asarray(samples, jnp.float32)
    if x.ndim == 3:
        x = x.reshape(-1, x.shape[-1])
    if x.ndim != 2:
        raise ValueError(f"samples must be [N, d] or [chains, T, d]; "
                         f"got shape {samples.shape}")
    n1, d = x.shape
    n2 = int(n_proposal) if n_proposal is not None else n1

    # moment-matched Gaussian proposal (jitter floor as in gp §17)
    mu = jnp.mean(x, axis=0)
    xc = x - mu
    cov = xc.T @ xc / (n1 - 1) + 4 * n1 * np.finfo(np.float32).eps * (
        jnp.eye(d))
    chol = jnp.linalg.cholesky(cov)
    half_logdet = jnp.sum(jnp.log(jnp.diag(chol)))
    const = -0.5 * d * jnp.log(2 * jnp.pi) - half_logdet

    def log_g(th):
        z = jax.scipy.linalg.solve_triangular(chol, th - mu, lower=True)
        return const - 0.5 * jnp.sum(z ** 2)

    g_draws = mu + jax.random.normal(
        jax.random.key(seed), (n2, d), jnp.float32) @ chol.T

    lq1 = jax.vmap(log_prob)(x)
    lq2 = jax.vmap(log_prob)(g_draws)
    log_l1 = lq1 - jax.vmap(log_g)(x)         # [N1] log(q/g) @ posterior
    log_l2 = lq2 - jax.vmap(log_g)(g_draws)   # [N2] log(q/g) @ proposal
    ls1 = jnp.log(n1 / (n1 + n2))
    ls2 = jnp.log(n2 / (n1 + n2))

    def _lse(v):
        return jax.scipy.special.logsumexp(v)

    def body(carry):
        log_r, _, it = carry
        # num_j = l2_j / (s1 l2_j + s2 r);  den_i = 1 / (s1 l1_i + s2 r)
        log_num = _lse(log_l2 - jnp.logaddexp(
            ls1 + log_l2, ls2 + log_r)) - jnp.log(n2)
        log_den = _lse(-jnp.logaddexp(
            ls1 + log_l1, ls2 + log_r)) - jnp.log(n1)
        new = log_num - log_den
        return new, jnp.abs(new - log_r), it + 1

    def cond(carry):
        _, delta, it = carry
        return (delta > tol) & (it < max_iter)

    # start at the importance-sampling estimate (r₀ = mean l₂)
    r0 = _lse(log_l2) - jnp.log(n2)
    log_r, delta, n_iter = jax.jit(lambda c: lax.while_loop(
        cond, body, c))((r0, jnp.inf, jnp.int32(0)))

    # relative squared error, first-order delta method at the fixed
    # point: r̂ = num/den with num = (1/N₂)Σ aⱼ, den = (1/N₁)Σ bᵢ
    # (a, b below); treating r in a, b as fixed,
    # RE² ≈ Var(a)/(N₂·ā²) + Var(b)/(N₁·b̄²) — the iid-draws error
    # measure (cf. Frühwirth-Schnatter 2004); scale-invariant, so the
    # normalised weights below compute it exactly
    lw1 = -jnp.logaddexp(ls1 + log_l1, ls2 + log_r)      # bᵢ (up to scale)
    lw2 = log_l2 - jnp.logaddexp(ls1 + log_l2, ls2 + log_r)   # aⱼ
    w1 = jnp.exp(lw1 - _lse(lw1) + jnp.log(float(n1)))
    w2 = jnp.exp(lw2 - _lse(lw2) + jnp.log(float(n2)))
    re2 = float(jnp.var(w2) / (n2 * jnp.mean(w2) ** 2)
                + jnp.var(w1) / (n1 * jnp.mean(w1) ** 2))

    return BridgeResult(
        log_z=float(log_r), n_iter=int(n_iter),
        converged=bool(delta <= tol), re2=re2,
        log_l1=np.asarray(log_l1), log_l2=np.asarray(log_l2))
