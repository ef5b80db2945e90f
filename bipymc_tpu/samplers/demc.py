"""DE-MC: differential-evolution MCMC over a parallel population.

ter Braak (2006) — SURVEY.md §4.5; accelerator-native replacement for the
reference's ``DeMc`` + mpi4py pool (`bipymc/demc.py` [U]). One synchronous
generation (the parallel-friendly variant the reference pool uses) is a
pure step over the whole population: per-chain proposals are built from the
*generation-start* population, all likelihoods evaluate in one ``vmap``,
and accepts are vectorised. Across devices the population is sharded on a
``"chains"`` mesh axis and the proposal pool arrives via ``all_gather``
(SURVEY.md §5.2).
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from bipymc_tpu.core.rng import bits_to_normal, bits_to_uniform
from bipymc_tpu.ensemble.indices import distinct_from_bits
from bipymc_tpu.parallel.collectives import all_gather_chains, chain_offset


class DeMcConfig(NamedTuple):
    n_chains: int
    gamma: float | None = None    # None → 2.38/√(2d)
    b: float = 1e-4               # jitter e ~ N(0, b²I)
    jump_interval: int = 10       # γ := 1 every 10th generation (mode jumping)


class DeMcState(NamedTuple):
    x: jax.Array       # [n_local, d] population positions (chain-sharded)
    logp: jax.Array    # [n_local]
    gen: jax.Array     # [] int32 generation counter


class DeMcInfo(NamedTuple):
    accepted: jax.Array   # [n_local] bool
    logp: jax.Array       # [n_local]


def init(x0: jax.Array, log_prob: Callable) -> DeMcState:
    """x0: [n_local, d] initial population (use utils.var_ball to disperse)."""
    logp = jax.vmap(log_prob)(x0)
    return DeMcState(x=x0, logp=logp, gen=jnp.zeros((), jnp.int32))


def make_step(log_prob: Callable, cfg: DeMcConfig, axis_name=None) -> Callable:
    """Build ``step(state, key, t)`` over the (possibly sharded) population."""

    def step(state: DeMcState, key: jax.Array, t: jax.Array):
        n_local, d = state.x.shape
        dtype = state.x.dtype
        x_full = all_gather_chains(state.x, axis_name)     # [N, d]
        offset = chain_offset(n_local, axis_name)

        gamma_base = cfg.gamma if cfg.gamma is not None else 2.38 / jnp.sqrt(2.0 * d)
        is_jump = (state.gen % cfg.jump_interval) == (cfg.jump_interval - 1)
        gamma = jnp.where(is_jump, 1.0, gamma_base).astype(dtype)

        # one batched bits block per generation (see samplers/dream.py);
        # per-chain word layout: [r_bits(2) | eps(d) | u_acc(1)]
        i_locals = jnp.arange(n_local, dtype=jnp.int32)
        gid = offset + i_locals
        chain_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(gid)
        blk = jax.vmap(lambda k: jax.random.bits(
            k, (3 + d,), jnp.uint32))(chain_keys)
        row_bits = blk[:, 0:2]
        eps = cfg.b * bits_to_normal(blk[:, 2:2 + d], dtype)
        log_u = jnp.log(bits_to_uniform(blk[:, 2 + d], dtype))
        r = jax.vmap(lambda b, i: distinct_from_bits(
            b, 2, cfg.n_chains, exclude=i))(row_bits, gid)
        x_star = state.x + gamma * (x_full[r[:, 0]] - x_full[r[:, 1]]) + eps
        logp_star = jax.vmap(log_prob)(x_star)             # dominant cost

        log_alpha = jnp.minimum(0.0, logp_star - state.logp)
        # guard NaN/-inf proposals (out-of-support): always reject. Without
        # this, logp = logp_star = -inf gives a NaN ratio → a chain with a
        # bad init rejects forever, silently (parity with dream.py).
        log_alpha = jnp.where(jnp.isfinite(logp_star), log_alpha, -jnp.inf)
        acc = log_u < log_alpha
        x_new = jnp.where(acc[:, None], x_star, state.x)
        logp_new = jnp.where(acc, logp_star, state.logp)

        new_state = DeMcState(x=x_new, logp=logp_new, gen=state.gen + 1)
        return new_state, DeMcInfo(accepted=acc, logp=logp_new)

    return step
