"""Random-walk sampler family: MH → AM → DR → DRAM, one pure step.

accelerator-native redesign of the reference's ``Metropolis`` /
``AdaptiveMetropolis``
/ ``DrMetropolis`` / ``Dram`` classes (SURVEY.md §3, `bipymc/samplers.py` [U];
math contract SURVEY.md §4.1–4.4). DRAM is the general case; MH/AM/DR are
config restrictions, so the whole family is ONE pure
``step(state, key, t) -> (state, info)`` that

- lives inside ``lax.scan`` (no Python hot loop, SURVEY.md §5.1),
- vmaps over a chain axis (each chain carries its own adaptation state),
- is *branchless* in the delayed-rejection stage: both stages' proposals and
  likelihoods are computed and the result selected with ``lax.select``.
  Under ``vmap``, ``lax.cond`` lowers to ``select`` anyway, so for vectorised
  chains the branchless form is optimal (SURVEY.md §9 "Hard parts").

Algorithm contracts implemented here:
- 4.1 Metropolis: symmetric Gaussian RW, α = min{1, exp(ℓ' − ℓ)}.
- 4.2 Haario AM: C_t = s_d (Cov_t + ε I), s_d = 2.38²/d, recursive Welford
  mean/scatter update, periodic Cholesky refresh.
- 4.3 Green–Mira DR, two stages, C₂ = C₁/κ:
  α₂ = min{1, [π(y₂) q₁(y₁|y₂) (1−α₁(y₂,y₁))] / [π(x) q₁(y₁|x) (1−α₁(x,y₁))]}
  with the q₁ ratio evaluated exactly in whitened coordinates (the
  log-dets cancel; the residuals are the z draws themselves, so no
  triangular solves — see the in-step comment).
- 4.4 DRAM: DR with C₁ from AM adaptation.
"""

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from bipymc_tpu.core.rng import bits_to_uniform, uniform_to_normal
from bipymc_tpu.core.numerics import log1mexp as _log1mexp



class RwConfig(NamedTuple):
    """Static configuration for the random-walk family.

    adapt: Haario AM covariance adaptation on/off.
    delayed: second delayed-rejection stage on/off.
    t0: first step at which adapted covariance may be used (non-adaptive
        warmup period; diminishing adaptation preserves ergodicity).
    adapt_interval: Cholesky refresh period (adaptation statistics are
        updated every step regardless). ``adapt_interval=1`` switches to
        the O(d²) rank-1 Cholesky update of the scatter factor
        (ops.linalg.chol_rank1_update) instead of an O(d³) refactorisation
        per step — BASELINE.json:5 "adaptive proposal-covariance Cholesky
        updates". In that mode the ``m2`` state field carries
        chol(scatter + ε·I) rather than the raw scatter.
    eps: ε-regularisation added to the adapted covariance.
    kappa: DR stage-2 covariance shrink factor, C₂ = C₁/κ ("bold then timid").
    sd: proposal scaling; None → 2.38²/d at init time.
    """

    adapt: bool = False
    delayed: bool = False
    t0: int = 200
    adapt_interval: int = 50
    eps: float = 1e-8
    kappa: float = 5.0
    sd: float | None = None


class RwState(NamedTuple):
    theta: jax.Array        # [d] current position
    logp: jax.Array         # [] current log-posterior
    mean: jax.Array         # [d] running mean of visited states (AM)
    m2: jax.Array           # [d,d] running scatter Σ(θ−μ)(θ−μ)ᵀ (AM)
    count: jax.Array        # [] number of states folded into mean/m2
    chol: jax.Array         # [d,d] current stage-1 proposal Cholesky


class RwInfo(NamedTuple):
    accepted: jax.Array     # [] bool — did the chain move this step
    stage: jax.Array        # [] int32: 0 reject, 1 stage-1 accept, 2 stage-2
    logp: jax.Array         # [] log-posterior after the step


def init(theta0: jax.Array, log_prob: Callable, cov0: jax.Array) -> RwState:
    """Initial per-chain state. ``cov0`` is the stage-1 proposal covariance."""
    theta0 = jnp.asarray(theta0)
    d = theta0.shape[-1]
    cov0 = jnp.asarray(cov0, dtype=theta0.dtype)
    if cov0.ndim == 1:
        cov0 = jnp.diag(cov0)
    return RwState(
        theta=theta0,
        logp=log_prob(theta0),
        mean=theta0,
        m2=jnp.zeros((d, d), dtype=theta0.dtype),
        count=jnp.ones((), dtype=jnp.int32),
        chol=jnp.linalg.cholesky(cov0),
    )


_HIGHEST = jax.lax.Precision.HIGHEST


def adapt_update(cfg, sd, mean, m2, count, chol, theta_new, t):
    """Haario AM update of the per-chain (mean, scatter, count, Cholesky)
    tuple (§4.2) — the shared recursion behind the RW family's step AND
    the delayed-acceptance sampler (samplers/da.py). Returns the four
    fields updated per ``cfg``; identity when ``cfg.adapt`` is off."""
    d = theta_new.shape[-1]
    dtype = theta_new.dtype
    if cfg.adapt and cfg.adapt_interval == 1:
        # ---- every-step rank-1 Cholesky adaptation (§4.2) -----------
        # Welford scatter update m2 += (n-1)/n · δδᵀ expressed directly
        # on the factor: O(d²)/step instead of O(d³) refactorisation.
        # ``m2`` carries L_s = chol(scatter + ε·I) in this mode.
        from bipymc_tpu.ops.linalg import chol_rank1_update

        n = count + 1
        delta = theta_new - mean
        mean_new = mean + delta / n.astype(dtype)
        nf = n.astype(dtype)
        # seed the factor on first use (scatter starts at ε·I)
        L_s = jnp.where(count == 1,
                        jnp.sqrt(jnp.asarray(cfg.eps, dtype))
                        * jnp.eye(d, dtype=dtype),
                        m2)
        m2_new = chol_rank1_update(L_s, delta, alpha=(nf - 1.0) / nf)
        scale = jnp.sqrt(jnp.asarray(sd, dtype) / (nf - 1.0))
        chol_new = jnp.where(t >= cfg.t0, scale * m2_new, chol)
    elif cfg.adapt:
        # ---- Haario recursion (§4.2), Welford form ------------------
        n = count + 1
        delta = theta_new - mean
        mean_new = mean + delta / n.astype(dtype)
        delta2 = theta_new - mean_new
        m2_new = m2 + jnp.outer(delta, delta2)

        do_refresh = jnp.logical_and(
            t >= cfg.t0, (t + 1) % cfg.adapt_interval == 0
        )

        def refresh(_):
            cov = sd * (m2_new / (n - 1).astype(dtype)
                        + cfg.eps * jnp.eye(d, dtype=dtype))
            c = jnp.linalg.cholesky(cov)
            # keep the old factor if the adapted cov is not (yet) SPD
            ok = jnp.all(jnp.isfinite(c))
            return jnp.where(ok, c, chol)

        chol_new = lax.cond(do_refresh, refresh,
                            lambda _: chol, operand=None)
    else:
        return mean, m2, count, chol
    return mean_new, m2_new, n, chol_new


def make_step(log_prob: Callable, cfg: RwConfig,
              draws_fn: Callable | None = None) -> Callable:
    """Build ``step(state, key, t)`` for one chain. vmap for many chains.

    draws_fn: optional override of the step's randomness, for
    injected-stream fidelity tests (SURVEY.md §6 contract (a): identical
    results given identical proposal streams). Signature
    ``(key, t, d, dtype) -> (z1 [d], z2 [d], u1 [], u2 [])`` with z
    standard normals and u uniforms on (0,1). Default: jax.random draws
    from ``key`` (the production path).
    """

    def _default_draws(key, t, d, dtype):
        # one bits call instead of split(4) + 4 draw kernels — the
        # single-chain path is launch-latency-bound (core/rng.py);
        # word layout [z1(d) | z2(d) | u1 | u2]
        u = bits_to_uniform(
            jax.random.bits(key, (2 * d + 2,), jnp.uint32), dtype)
        return (uniform_to_normal(u[0:d]),
                uniform_to_normal(u[d:2 * d]),
                u[2 * d], u[2 * d + 1])

    draws = draws_fn or _default_draws

    def step(state: RwState, key: jax.Array, t: jax.Array):
        d = state.theta.shape[-1]
        dtype = state.theta.dtype
        sd = cfg.sd if cfg.sd is not None else 2.38 ** 2 / d
        z1, z2, uu1, uu2 = draws(key, t, d, dtype)

        # ---- stage 1: y₁ ~ N(x, C₁) -------------------------------------
        # HIGHEST: a float32 product may otherwise run in TF32 on the GPU,
        # and the fused engine (rw_fused.py) must draw the same proposal
        y1 = state.theta + jnp.matmul(state.chol, z1, precision=_HIGHEST)
        l1 = log_prob(y1)
        log_a1 = jnp.minimum(0.0, l1 - state.logp)
        # non-finite hard-reject (SURVEY §7.2 sanitizer contract; round-5
        # review): sanitizing log_a1 itself — not just the accept bit —
        # keeps the Green–Mira denominator below correct too (α₁ := 0
        # ⇒ log1mexp(log_a1) = 0), where a +inf l1 would otherwise
        # make stage 2 accept y₂ almost surely
        log_a1 = jnp.where(jnp.isfinite(l1), log_a1, -jnp.inf)
        u1 = jnp.log(uu1)
        acc1 = u1 < log_a1

        if cfg.delayed:
            # ---- stage 2: y₂ ~ N(x, C₁/κ), Green–Mira ratio (§4.3) ------
            inv_sqrt_kappa = jnp.asarray(1.0 / jnp.sqrt(cfg.kappa), dtype)
            y2 = state.theta + jnp.matmul(state.chol * inv_sqrt_kappa, z2,
                                          precision=_HIGHEST)
            l2 = log_prob(y2)
            # α₁(y₂, y₁) — reverse-path stage-1 acceptance
            log_a1_rev = jnp.minimum(0.0, l1 - l2)
            # q₁(y₁|y₂)/q₁(y₁|x): the log-dets cancel and the whitened
            # residuals are available in closed form — y₁ = x + L z₁ and
            # y₂ = x + (L/√κ) z₂ give L⁻¹(y₁−x) = z₁ and
            # L⁻¹(y₁−y₂) = z₁ − z₂/√κ exactly, so the ratio needs NO
            # triangular solves
            w = z1 - inv_sqrt_kappa * z2
            lq_diff = -0.5 * (jnp.sum(w * w) - jnp.sum(z1 * z1))
            log_num = l2 + _log1mexp(log_a1_rev)
            log_den = state.logp + _log1mexp(log_a1)
            log_a2 = jnp.minimum(0.0, log_num + lq_diff - log_den)
            log_a2 = jnp.where(jnp.isfinite(l2), log_a2, -jnp.inf)
            u2 = jnp.log(uu2)
            # NaN from an unused branch (α₁=1 ⇒ stage 1 accepted) compares
            # False, so acc2 is well-defined.
            acc2 = jnp.logical_and(jnp.logical_not(acc1), u2 < log_a2)
        else:
            y2, l2 = y1, l1
            acc2 = jnp.zeros((), dtype=bool)

        take1 = acc1
        take2 = acc2
        theta_new = jnp.where(take1, y1, jnp.where(take2, y2, state.theta))
        logp_new = jnp.where(take1, l1, jnp.where(take2, l2, state.logp))
        stage = jnp.where(take1, 1, jnp.where(take2, 2, 0)).astype(jnp.int32)

        mean_new, m2_new, n, chol_new = adapt_update(
            cfg, sd, state.mean, state.m2, state.count, state.chol,
            theta_new, t)

        new_state = RwState(theta_new, logp_new, mean_new, m2_new, n, chol_new)
        info = RwInfo(accepted=jnp.logical_or(take1, take2),
                      stage=stage, logp=logp_new)
        return new_state, info

    return step


# Named configs matching the reference sampler zoo ---------------------------

def metropolis_config(**kw) -> RwConfig:
    return RwConfig(adapt=False, delayed=False, **kw)


def adaptive_metropolis_config(**kw) -> RwConfig:
    return RwConfig(adapt=True, delayed=False, **kw)


def dr_metropolis_config(**kw) -> RwConfig:
    return RwConfig(adapt=False, delayed=True, **kw)


def dram_config(**kw) -> RwConfig:
    return RwConfig(adapt=True, delayed=True, **kw)
