"""Delayed-acceptance Metropolis (Christen & Fox 2005) — beyond-reference.

The reference's surrogate story (SURVEY.md §5.4, BASELINE config 5) is
*replace*: the GP stands in for the expensive likelihood and the chains
never see the truth again. Delayed acceptance *composes* them instead:
every proposal is pre-screened by the cheap surrogate, and only
surrogate-promoted proposals pay for an exact-likelihood evaluation —
the resulting chain targets the EXACT posterior (no surrogate bias at
all), with the exact-call rate ≈ the surrogate acceptance rate (~25-45%
for a tuned RW).

Math. Stage 1 promotes y ~ N(x, C) with the surrogate ratio
α₁ = min{1, π*(y)/π*(x)}. The effective proposal q*(y|x) = q(y|x)α₁(x,y)
is then corrected in stage 2 against the exact target:
α₂ = min{1, [π(y) q*(x|y)] / [π(x) q*(y|x)]}
   = min{1, [π(y) π*(x)] / [π(x) π*(y)]}
(the symmetric-q case; the α₁ ratio collapses to π*(x)/π*(y) in both
orderings). A good surrogate drives α₂ → 1: stage 2 is a cheap
correction, not a second rejection gauntlet.

Accelerator mapping: vmapped chains evaluate the surrogate branchlessly on
device (it is cheap by assumption — a GP predict is a couple of m-sized
contractions). The exact likelihood is where delayed acceptance pays:
with ``masked=True`` the step hands ``log_prob_exact(y, promoted)`` the
promotion mask, and :func:`bipymc_tpu.utils.external.
external_log_like_masked` evaluates ONLY the promoted rows on the host —
one batched callback per step, rows the promotion gate rejected never
reach the simulator. For a jittable exact likelihood the saving is a
``where``-select, so branchless evaluation (masked=False) is the default
there (SURVEY.md §9 "DR inside scan": under vmap, cond pays both
branches anyway).

Stage-1 covariance adapts with the shared Haario recursion
(:func:`bipymc_tpu.samplers.rw.adapt_update` — §4.2 contract), on the
EXACT chain's visited states (the chain is a π-chain; adaptation
statistics from it are the standard DA⊗AM composition, e.g. Cui,
Fox & O'Sullivan 2011).
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from bipymc_tpu.core.rng import bits_to_uniform, uniform_to_normal
from bipymc_tpu.samplers import rw


class DaConfig(NamedTuple):
    """Static configuration. Fields as :class:`~bipymc_tpu.samplers.rw.
    RwConfig` (adapt schedule applies to the stage-1 proposal)."""

    adapt: bool = True
    t0: int = 200
    adapt_interval: int = 50
    eps: float = 1e-8
    sd: float | None = None


def da_config(**kw) -> DaConfig:
    return DaConfig(**kw)


class DaState(NamedTuple):
    theta: jax.Array        # [d] current position
    logp: jax.Array         # [] exact log-posterior at theta
    logp_surr: jax.Array    # [] surrogate log-posterior at theta
    mean: jax.Array         # [d] AM running mean
    m2: jax.Array           # [d,d] AM running scatter
    count: jax.Array        # [] states folded into mean/m2
    chol: jax.Array         # [d,d] stage-1 proposal Cholesky


class DaInfo(NamedTuple):
    accepted: jax.Array     # [] bool — chain moved
    promoted: jax.Array     # [] bool — exact likelihood was consulted
    logp: jax.Array         # [] exact log-posterior after the step


def init(theta0, log_prob_exact: Callable, log_prob_surr: Callable,
         cov0, masked: bool = False) -> DaState:
    """Initial per-chain state (both log-posteriors evaluated once)."""
    theta0 = jnp.asarray(theta0)
    d = theta0.shape[-1]
    cov0 = jnp.asarray(cov0, dtype=theta0.dtype)
    if cov0.ndim == 1:
        cov0 = jnp.diag(cov0)
    if masked:
        logp = log_prob_exact(theta0, jnp.ones((), bool))
    else:
        logp = log_prob_exact(theta0)
    return DaState(
        theta=theta0,
        logp=logp,
        logp_surr=log_prob_surr(theta0),
        mean=theta0,
        m2=jnp.zeros((d, d), dtype=theta0.dtype),
        count=jnp.ones((), dtype=jnp.int32),
        chol=jnp.linalg.cholesky(cov0),
    )


def make_step(log_prob_exact: Callable, log_prob_surr: Callable,
              cfg: DaConfig, masked: bool = False) -> Callable:
    """Build ``step(state, key, t)`` for one chain; vmap for many.

    masked=True: ``log_prob_exact(theta, promoted)`` receives the
    stage-1 promotion decision so host-side likelihoods can skip
    unpromoted rows (their return value is ignored — acceptance already
    requires promotion, and NaN compares False in the accept test).
    """

    def step(state: DaState, key: jax.Array, t: jax.Array):
        d = state.theta.shape[-1]
        dtype = state.theta.dtype
        sd = cfg.sd if cfg.sd is not None else 2.38 ** 2 / d
        # one bits call: [z(d) | u1 | u2] (core/rng.py word discipline)
        u = bits_to_uniform(
            jax.random.bits(key, (d + 2,), jnp.uint32), dtype)
        z, uu1, uu2 = uniform_to_normal(u[:d]), u[d], u[d + 1]

        # ---- stage 1: surrogate promotion --------------------------------
        y = state.theta + state.chol @ z
        ls_y = log_prob_surr(y)
        log_a1 = jnp.minimum(0.0, ls_y - state.logp_surr)
        promoted = jnp.log(uu1) < log_a1

        # ---- stage 2: exact correction (only promoted rows matter) -------
        if masked:
            le_y = log_prob_exact(y, promoted)
        else:
            le_y = log_prob_exact(y)
        log_a2 = jnp.minimum(
            0.0, (le_y - state.logp) - (ls_y - state.logp_surr))
        accepted = jnp.logical_and(promoted, jnp.log(uu2) < log_a2)

        theta_new = jnp.where(accepted, y, state.theta)
        logp_new = jnp.where(accepted, le_y, state.logp)
        logp_surr_new = jnp.where(accepted, ls_y, state.logp_surr)

        mean_new, m2_new, n, chol_new = rw.adapt_update(
            cfg, sd, state.mean, state.m2, state.count, state.chol,
            theta_new, t)

        new_state = DaState(theta_new, logp_new, logp_surr_new,
                            mean_new, m2_new, n, chol_new)
        info = DaInfo(accepted=accepted, promoted=promoted, logp=logp_new)
        return new_state, info

    return step
