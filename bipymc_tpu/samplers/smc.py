"""Adaptive tempered Sequential Monte Carlo (SMC) sampler.

Beyond-reference extra (the reference — SURVEY.md §3 — is MCMC-only):
an SMC sampler anneals a particle population from a tractable reference
density to the target along the geometric path

    π_β(x) ∝ ref(x)^(1−β) · target(x)^β,      β: 0 → 1,

choosing each β-increment adaptively so the *conditional* effective
sample size of the increment stays at ``ess_alpha·N`` (Del Moral,
Doucet & Jasra 2006 for the SMC-sampler framework; Zhou, Johansen &
Aston 2016 for the CESS-controlled schedule), resampling
systematically when the carried weights degenerate,
and rejuvenating with MCMC moves adapted from the weighted population
geometry (Chopin & Papaspiliopoulos 2020, ch. 17): random-walk MH with
the population covariance (``kernel="rw"``), or leapfrog HMC with
population-variance mass and a cross-stage adapted step size
(``kernel="hmc"`` — see the SmcConfig.kernel docstring for when the
gradient kernel is the difference between working and collapsing). It delivers
the two things the MCMC zoo
structurally cannot on the headline multimodal target: **self-consistent mode
weights** (the population is transported
through the annealing path, so separated modes keep their correct
relative mass — no inter-mode mixing required) and an unbiased
**log-evidence** estimate (the telescoped product of per-stage
normalising increments).

accelerator-native design:

- The whole run is ONE ``lax.while_loop`` over stages — no host
  round-trip per stage. Each stage body: (1) next-β by fixed-iteration
  bisection on the relative-ESS curve (monotone in β, 30 halvings ≈
  f32 resolution), (2) reweight + evidence increment, (3) systematic
  resample behind ``lax.cond`` (index gather, O(N) on-device
  searchsorted), (4) weighted-covariance Cholesky, (5) ``n_moves``
  vmapped MH rejuvenation steps via ``lax.scan``. All fixed shapes;
  per-stage diagnostics (β ladder, ESS, acceptance) write into
  ``[max_stages]`` buffers at the stage index.
- Particle parallelism mirrors the chain pool (SURVEY.md §3.1): under
  ``mesh=`` the MH moves run on the particle shards; every cross-
  particle float reduction follows the gather-then-reduce rule — per-particle
  scalars and positions are
  all_gathered once per stage and the *identical* full-axis math runs
  replicated on every shard (weights, bisection, resample indices,
  covariance), so mesh and vmap paths consume identical streams and
  run identical decision logic — bit-identical decisions GIVEN
  bit-identical particles. The move loop is the only sharded compute,
  and its local batch shape rounds ~1 ulp differently per move
  (compiler FMA contraction), which from stage 2 on can flip a low
  bisection bit: the cross-shape contract is equal stage counts with
  ladder/evidence at float tolerance (tests/test_smc.py).
- RNG: one ``fold_in`` tree per stage; move keys fold by GLOBAL
  particle index (mesh-invariant, like every other sampler here).

Betancourt's caveat applies: SMC's mode-weight consistency needs the
annealing path to keep basins populated — the ``ess_alpha`` knob trades
stage count against weight variance. The mixture test pins a 0.7/0.3
two-mode target recovering its weights to ±0.05 where plain DREAM-zs
measurably cannot (tests/test_smc.py).
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from bipymc_tpu.parallel.collectives import all_gather_chains, chain_offset


class SmcConfig(NamedTuple):
    """Static configuration.

    n_particles: population size N.
    ess_alpha: target relative *conditional* ESS for the adaptive
        β-increment (the bisection solves CESS(β') = ess_alpha — Zhou,
        Johansen & Aston 2016; CESS measures only the increment's
        degeneracy, so the solve never stalls on carried weights);
        0.5 is a standard compromise.
    resample_threshold: resample when the plain relative ESS drops
        below this after reweighting.
    n_moves: rejuvenation steps per stage (RW proposals or HMC
        trajectories, per ``kernel``).
    kernel: rejuvenation move type. "rw" (default): adapted random-walk
        MH, no differentiability required. "hmc": leapfrog trajectories
        on the tempered density with diagonal mass from the weighted
        population variance and a cross-stage adapted step size —
        needs ``jax.grad``-able log_ref/log_target. On hard targets
        (high d, separated modes) HMC rejuvenation is the difference
        between working and collapsing: RW moves relax a basin's shape
        in O(d) moves, and the un-relaxed group lag couples into the
        resampling as a basin-level selection noise that drives one
        basin extinct (measured at d=48 — module docstring /); HMC relaxes in
        O(1) trajectories, killing the feedback.
    bisect_iters: fixed halvings for the β' solve (30 ≈ f32 exact).
    max_stages: while_loop bound + diagnostics buffer length. The loop
        exits early at β=1; hitting max_stages is surfaced in the result.
    step_scale: RW proposal scale s: C = s²·Cov_w + eps·I. None → 2.38/√d
        (optimal-scaling default, same convention as samplers/rw.py).
    eps: proposal-covariance regularisation.
    min_delta_beta: progress floor for the β solve (guards a pathological
        flat-ESS bisection from stalling the ladder).
    n_leapfrog: leapfrog steps per HMC trajectory (kernel="hmc").
    hmc_eps0: initial leapfrog step size in mass-scaled coordinates.
    target_accept: cross-stage step-size adaptation target (Robbins-
        Monro on log ε between stages; 0.65 for HMC, 0.234 is the RW
        optimum but RW's scale is set by step_scale instead).
    """

    n_particles: int = 1024
    ess_alpha: float = 0.5
    resample_threshold: float = 0.5
    n_moves: int = 5
    kernel: str = "rw"
    bisect_iters: int = 30
    max_stages: int = 200
    step_scale: float | None = None
    eps: float = 1e-8
    min_delta_beta: float = 1e-6
    n_leapfrog: int = 10
    hmc_eps0: float = 0.3
    target_accept: float = 0.65


class SmcState(NamedTuple):
    """Carry of the stage while_loop. ``x``/``lr``/``lt``/``lw`` are the
    only leaves with a particle axis (sharded under ``mesh=``); weights
    are kept normalised (logsumexp(lw) = 0) between stages."""

    x: jax.Array           # [n(_local), d] particles
    lr: jax.Array          # [n] log ref-density at x
    lt: jax.Array          # [n] log target-density at x
    lw: jax.Array          # [n] normalised log weights
    beta: jax.Array        # [] current inverse temperature
    log_z: jax.Array       # [] accumulated log-evidence
    stage: jax.Array       # [] int32 stages completed
    key: jax.Array         # PRNG key (replicated)
    log_eps: jax.Array     # [] HMC step size (mass-scaled), adapted
                           # across stages; unused for kernel="rw"
    beta_hist: jax.Array   # [max_stages] β after each stage
    ess_hist: jax.Array    # [max_stages] relative ESS before resampling
    acc_hist: jax.Array    # [max_stages] mean MH acceptance per stage


class SmcResult(NamedTuple):
    x: jax.Array           # [n, d] final particles (global)
    lw: jax.Array          # [n] final normalised log weights
    log_evidence: jax.Array
    n_stages: jax.Array
    reached_one: jax.Array  # bool — β hit 1 before max_stages
    beta_hist: jax.Array
    ess_hist: jax.Array
    acc_hist: jax.Array


def _rel_ess(lw):
    """Relative effective sample size of normalised-or-not log weights."""
    lse = jax.scipy.special.logsumexp
    return jnp.exp(2.0 * lse(lw) - lse(2.0 * lw)) / lw.shape[0]


def _systematic_indices(w, u):
    """Systematic resampling: N strata [(i+u)/N], one draw each.

    w: [n] normalised weights; u: scalar uniform. Returns [n] int32
    ancestor indices (the inverse-CDF of each stratum point), computed
    as a vectorised searchsorted on the weight CDF — O(N log N) on
    device, no host loop. side="right" puts ancestor i on the interval
    [cdf[i-1], cdf[i]) — the matching convention for u ∈ [0, 1) (with
    side="left" a u=0 stratum point landing exactly on a CDF value
    over-counts the earlier ancestor and breaks the ⌊Nw⌋/⌈Nw⌉ bound);
    it also skips zero-weight ancestors on CDF plateaus.
    """
    n = w.shape[0]
    cdf = jnp.cumsum(w)
    pts = (jnp.arange(n, dtype=w.dtype) + u) / n
    idx = jnp.searchsorted(cdf, pts, side="right")
    return jnp.clip(idx, 0, n - 1).astype(jnp.int32)


def init(x0: jax.Array, log_ref: Callable, log_target: Callable,
         cfg: SmcConfig) -> SmcState:
    """Initial state from reference draws x0 [n_particles, d].

    x0 must be draws from the reference density (β=0 population); the
    initial weights are uniform.
    """
    n, _ = x0.shape
    dtype = x0.dtype
    # sanitizer policy: clamp NaN densities so a single poisoned particle
    # dies instead of NaN-ing the whole run — a NaN in dl = lt - lr makes
    # every CESS comparison False (beta creeps by min_delta_beta until
    # max_stages) and NaNs the evidence with only a misleading
    # max_stages warning. lt enters weights positively -> NaN/+inf
    # clamp to -inf; lr enters negatively -> NaN/-inf clamp to +inf
    # (a zero/broken reference density at one of its OWN draws is a
    # support violation; killing that particle is the conservative
    # resolution). Genuine -inf lt (out-of-support draw) stays.
    lr = jnp.nan_to_num(jax.vmap(log_ref)(x0), nan=jnp.inf,
                        neginf=jnp.inf)
    lt = jnp.nan_to_num(jax.vmap(log_target)(x0), nan=-jnp.inf,
                        posinf=-jnp.inf)
    z = jnp.zeros((cfg.max_stages,), dtype)
    return SmcState(
        x=x0, lr=lr, lt=lt,
        lw=jnp.full((n,), -jnp.log(float(n)), dtype),
        beta=jnp.zeros((), dtype), log_z=jnp.zeros((), dtype),
        stage=jnp.int32(0), key=jax.random.key(0),
        log_eps=jnp.asarray(jnp.log(cfg.hmc_eps0), dtype),
        beta_hist=z, ess_hist=z, acc_hist=z)


def make_runner(log_ref: Callable, log_target: Callable, cfg: SmcConfig,
                axis_name=None) -> Callable:
    """Build ``run(state) -> (final_state, result)`` — the full annealing
    while_loop, jittable, axis-optional (vmap path when axis_name=None,
    shard_map body otherwise)."""
    lse = jax.scipy.special.logsumexp

    def tempered(lr, lt, beta):
        # select lt outright at beta == 1: (1-1)*(-inf) is NaN, which
        # would hard-reject every final-stage move into target regions
        # outside a compact-support custom reference — biasing the
        # beta=1 rejuvenation toward the reference's support
        return jnp.where(beta >= 1.0, lt, (1.0 - beta) * lr + beta * lt)

    def stage_body(s: SmcState) -> SmcState:
        n_local, d = s.x.shape
        dtype = s.x.dtype
        k_stage = jax.random.fold_in(s.key, s.stage)
        k_res, k_move = jax.random.split(k_stage)

        # ---- gather-then-reduce: assemble the GLOBAL
        # population once; all cross-particle float math below runs
        # replicated and identically associated on every shard --------
        xg = all_gather_chains(s.x, axis_name)        # [N, d]
        lrg = all_gather_chains(s.lr, axis_name)      # [N]
        ltg = all_gather_chains(s.lt, axis_name)      # [N]
        lwg = all_gather_chains(s.lw, axis_name)      # [N]
        n_global = xg.shape[0]

        # ---- (1) adaptive β': largest b ≤ 1 with relative CESS ≥
        # ess_alpha. The conditional ESS (Zhou, Johansen & Aston 2016)
        # measures only the INCREMENT's weight degeneracy — at δβ=0 it
        # is 1 regardless of how degenerate the carried weights already
        # are, so the solve always has headroom. (Bisecting the plain
        # ESS instead stalls whenever a stage ends exactly at
        # ESS = resample_threshold without triggering a resample.)
        dl = ltg - lrg

        def cess_at(b):
            delta = (b - s.beta) * dl
            return jnp.exp(2.0 * lse(lwg + delta) - lse(lwg + 2.0 * delta))

        def bisect(_, lohi):
            lo, hi = lohi
            mid = 0.5 * (lo + hi)
            ok = cess_at(mid) >= cfg.ess_alpha
            return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

        one = jnp.ones((), dtype)
        take_one = cess_at(one) >= cfg.ess_alpha
        lo, _ = lax.fori_loop(0, cfg.bisect_iters, bisect, (s.beta, one))
        beta_new = jnp.where(take_one, one,
                             jnp.maximum(lo, s.beta + cfg.min_delta_beta))
        beta_new = jnp.minimum(beta_new, one)

        # ---- (2) reweight + evidence increment -----------------------
        lw_un = lwg + (beta_new - s.beta) * dl        # unnormalised
        inc = lse(lw_un)                              # lse(lwg) = 0
        log_z_new = s.log_z + inc
        lw_new = lw_un - inc
        ess = _rel_ess(lw_new)

        # ---- (3) systematic resample when degenerate -----------------
        u = jax.random.uniform(k_res, (), dtype)
        do_resample = ess < cfg.resample_threshold

        def resampled(_):
            idx = _systematic_indices(jnp.exp(lw_new), u)
            flat = jnp.full((n_global,), -jnp.log(float(n_global)), dtype)
            return xg[idx], lrg[idx], ltg[idx], flat

        def kept(_):
            return xg, lrg, ltg, lw_new

        xg2, lrg2, ltg2, lwg2 = lax.cond(do_resample, resampled, kept,
                                         None)

        # ---- (4) proposal geometry from the weighted population ------
        w = jnp.exp(lwg2)                             # [N], sums to 1
        mean_w = w @ xg2                              # [d]
        xc = xg2 - mean_w
        if cfg.kernel == "rw":
            cov_w = (xc * w[:, None]).T @ xc
            scale = (cfg.step_scale if cfg.step_scale is not None
                     else 2.38 / jnp.sqrt(float(d)))
            cov_p = (scale * scale) * cov_w \
                + cfg.eps * jnp.eye(d, dtype=dtype)
            chol = jnp.linalg.cholesky(cov_p)
        else:
            # diagonal inverse-mass from the weighted population
            # variance (the same geometry source as the RW covariance;
            # HMC needs only the per-dim scale)
            var_w = jnp.maximum(w @ (xc * xc), cfg.eps)
        eps_hmc = jnp.exp(s.log_eps)

        # ---- (5) slice back to the local shard; rejuvenation ---------
        offset = chain_offset(n_local, axis_name)
        x_l = lax.dynamic_slice_in_dim(xg2, offset, n_local, 0)
        lr_l = lax.dynamic_slice_in_dim(lrg2, offset, n_local, 0)
        lt_l = lax.dynamic_slice_in_dim(ltg2, offset, n_local, 0)
        lw_l = lax.dynamic_slice_in_dim(lwg2, offset, n_local, 0)
        gids = offset + jnp.arange(n_local, dtype=jnp.int32)

        def rw_particle(xi, lri, lti, k):
            k1, k2 = jax.random.split(k)
            z = jax.random.normal(k1, (d,), dtype)
            xp = xi + chol @ z
            lrp = log_ref(xp)
            ltp = log_target(xp)
            logp_old = tempered(lri, lti, beta_new)
            logp_new = tempered(lrp, ltp, beta_new)
            # non-finite proposals hard-reject (sanitizer policy)
            dlp = jnp.where(jnp.isfinite(logp_new),
                            logp_new - logp_old, -jnp.inf)
            acc = jnp.log(jax.random.uniform(k2, (), dtype)) < dlp
            return (jnp.where(acc, xp, xi),
                    jnp.where(acc, lrp, lri),
                    jnp.where(acc, ltp, lti),
                    acc)

        def tempered_vg(x):
            def tl(x_):
                return tempered(log_ref(x_), log_target(x_), beta_new)

            return jax.value_and_grad(tl)(x)

        def hmc_particle(xi, lri, lti, gi, k):
            # one leapfrog trajectory on the tempered density; diagonal
            # inverse-mass = var_w (population-scaled momenta, the same
            # convention as samplers/hmc.py). gi: carried gradient at xi
            # (recomputing it here would add one value_and_grad per
            # particle per move — ~10% extra gradient work at L=10)
            k1, k2 = jax.random.split(k)
            z = jax.random.normal(k1, (d,), dtype)
            p0 = z * lax.rsqrt(var_w)
            logp0 = tempered(lri, lti, beta_new)

            def leap(carry, _):
                x, p, g = carry
                ph = p + (0.5 * eps_hmc) * g
                xn = x + eps_hmc * (var_w * ph)
                _, gn = tempered_vg(xn)
                pn = ph + (0.5 * eps_hmc) * gn
                return (xn, pn, gn), None

            (xp, pn, gp), _ = lax.scan(leap, (xi, p0, gi), None,
                                       length=cfg.n_leapfrog)
            lrp = log_ref(xp)
            ltp = log_target(xp)
            logp1 = tempered(lrp, ltp, beta_new)
            K0 = 0.5 * jnp.sum(p0 * p0 * var_w)
            K1 = 0.5 * jnp.sum(pn * pn * var_w)
            dH = (logp1 - K1) - (logp0 - K0)
            dH = jnp.where(jnp.isfinite(dH), dH, -jnp.inf)
            acc = jnp.log(jax.random.uniform(k2, (), dtype)) < dH
            return (jnp.where(acc, xp, xi),
                    jnp.where(acc, lrp, lri),
                    jnp.where(acc, ltp, lti),
                    jnp.where(acc, gp, gi),
                    acc)

        def move_keys(m):
            return jax.vmap(lambda g: jax.random.fold_in(
                jax.random.fold_in(k_move, m), g))(gids)

        if cfg.kernel == "rw":

            def move_one(carry, m):
                x, lr_c, lt_c = carry
                x2, lr2, lt2, acc = jax.vmap(rw_particle)(
                    x, lr_c, lt_c, move_keys(m))
                return (x2, lr2, lt2), acc

            (x_f, lr_f, lt_f), accs = lax.scan(
                move_one, (x_l, lr_l, lt_l),
                jnp.arange(cfg.n_moves, dtype=jnp.int32))
        else:
            # gradient at the (possibly resampled) start points, once;
            # thereafter carried through the move scan
            _, g_l = jax.vmap(tempered_vg)(x_l)

            def move_one(carry, m):
                x, lr_c, lt_c, g_c = carry
                x2, lr2, lt2, g2, acc = jax.vmap(hmc_particle)(
                    x, lr_c, lt_c, g_c, move_keys(m))
                return (x2, lr2, lt2, g2), acc

            (x_f, lr_f, lt_f, _), accs = lax.scan(
                move_one, (x_l, lr_l, lt_l, g_l),
                jnp.arange(cfg.n_moves, dtype=jnp.int32))
        # acceptance diagnostic: gather-then-reduce for mesh==vmap value
        # (accs is [n_moves, n_local]; the particle axis must lead)
        acc_g = all_gather_chains(accs.T.astype(dtype), axis_name)
        acc_rate = jnp.mean(acc_g)

        # cross-stage Robbins-Monro on log ε toward target_accept
        # (kernel="hmc"; constant carry for "rw"). Clipped so one
        # catastrophic stage can't fling ε out of float range.
        if cfg.kernel == "hmc":
            log_eps_new = s.log_eps + jnp.clip(
                acc_rate - cfg.target_accept, -0.5, 0.5)
        else:
            log_eps_new = s.log_eps

        i = s.stage
        return SmcState(
            x=x_f, lr=lr_f, lt=lt_f, lw=lw_l,
            beta=beta_new, log_z=log_z_new, stage=i + 1, key=s.key,
            log_eps=log_eps_new,
            beta_hist=s.beta_hist.at[i].set(beta_new),
            ess_hist=s.ess_hist.at[i].set(ess),
            acc_hist=s.acc_hist.at[i].set(acc_rate))

    def cond(s: SmcState):
        return (s.beta < 1.0) & (s.stage < cfg.max_stages)

    def run(state: SmcState, key: jax.Array):
        state = state._replace(key=key)
        final = lax.while_loop(cond, stage_body, state)
        xg = all_gather_chains(final.x, axis_name)
        lwg = all_gather_chains(final.lw, axis_name)
        result = SmcResult(
            x=xg, lw=lwg, log_evidence=final.log_z,
            n_stages=final.stage,
            reached_one=final.beta >= 1.0,
            beta_hist=final.beta_hist, ess_hist=final.ess_hist,
            acc_hist=final.acc_hist)
        return final, result

    return run


# Particle-axis state fields, for ChainPool-style shard specs.
SHARDED_FIELDS = ("x", "lr", "lt", "lw")


def smc_config(**kw) -> SmcConfig:
    cfg = SmcConfig(**kw)
    if cfg.kernel not in ("rw", "hmc"):
        raise ValueError(f"kernel must be 'rw' or 'hmc', got {cfg.kernel!r}")
    return cfg
