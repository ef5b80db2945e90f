"""Global-move MH: fitted-density independence moves composed with a
local random walk.

Beyond-reference extra (the flowMC pattern: Gabrié, Rotskoff &
Vanden-Eijnden PNAS 2022; Wong, Gabrié & Foreman-Mackey JOSS 2023).
The DE/archive family's measured cross-mode hop rate on the headline
config-3 target is 2.8e-5 per chain-generation —
the proposal NOISE buries the mode displacement at d=100. A density q
fit to a stratified population makes the complement kernel: an
INDEPENDENCE Metropolis-Hastings proposal x* ~ q with

    log α = [ℓ(x*) − log q(x*)] − [ℓ(x) − log q(x)],

whose acceptance is O(exp(−KL(π‖q))) — set by the FIT quality, NOT by
the mode separation — so cross-mode transplants happen at the fit's
acceptance rate instead of 2.8e-5. q is pluggable
(`utils/proposals.Proposal`): a RealNVP flow (`utils/flows.py`, the
namesake) for warped basins, or an EM Gaussian mixture
(`utils/mixtures.py`) for Gaussian-ish ones — measured on the d=16
4-mode example the flow's acceptance decays to ~4e-4 (per-dimension
fit error compounds) while the moment-matched GMM holds ~1 at any d.

Each generation composes two π-invariant kernels (composition, not
mixture — branchless, no coin):

    1. ``local_moves`` Gaussian random-walk MH moves (per-dimension
       scale ``rw_scale · 2.38/√d · σ_train`` from the flow's training
       standardization — frozen, no adaptation) — decorrelate within
       the current basin;
    2. one flow independence move — global transplants and exact mode
       re-weighting.

The flow is FROZEN inside the kernel (a fixed q keeps the kernel
exactly π-invariant; refitting between ``run_mcmc`` calls is the
standard adaptive-independence-sampler pattern and obeys diminishing
adaptation if the refit schedule does). log q is exact (coupling-flow
logdet), so the kernel targets the EXACT posterior regardless of how
rough the fit is — fit quality moves the acceptance rate, never the
stationary distribution.

Accelerator shape: a generation is d-sized matmuls (the flow's MLPs) + one
vmapped target batch — all fixed shapes, one fused program. Chains are
fully independent (the flow rides along replicated), so ``mesh=``
shards with ZERO in-step collectives, like the HMC family; per-chain
RNG folds on the global chain index, so mesh and vmap runs consume
identical streams.

Cited reference behavior: composes with the population/history
machinery exactly like `samplers/demc.py` (SURVEY.md §5.2 call stack);
there is no reference counterpart to cite for the flow itself.
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from bipymc_tpu.core.rng import bits_to_normal, bits_to_uniform
from bipymc_tpu.parallel.collectives import chain_offset
from bipymc_tpu.utils.flows import FlowConfig
from bipymc_tpu.utils.proposals import Proposal

SHARDED_FIELDS = ("x", "logp", "lq")


class FlowMhConfig(NamedTuple):
    """local_moves: RW moves per generation before the global move
        (0 = pure independence sampler).
    rw_scale: multiplies the 2.38/√d · σ_fit per-dimension RW scale
        (σ_fit from ``proposal.sigma``).
    global_every: run the independence move only on generations with
        ``(t+1) % global_every == 0`` (1 = every generation, the
        round-3 behavior). The composition of K−1 local-only kernels
        and one local+global kernel is still exactly π-invariant; the
        global move's density pass is paid 1/K as often. The per-gen
        RANDOMNESS LAYOUT is unchanged (the full word block is drawn
        every generation; skipped gens ignore the global words), so
        global_every only gates which kernel runs, not the streams.
    flow: the frozen flow's ARCHITECTURE — used only by the API layer
        to build a flow `Proposal` from bare `FlowParams` (which carry
        no static config); the kernel itself sees only the proposal.
    """

    local_moves: int = 1
    rw_scale: float = 1.0
    global_every: int = 1
    flow: FlowConfig = FlowConfig()


class FlowMhState(NamedTuple):
    x: jax.Array      # [n_local, d] positions (chain-sharded)
    logp: jax.Array   # [n_local]
    lq: jax.Array     # [n_local] log q_flow at x (cached — see step)
    gen: jax.Array    # [] int32


class FlowMhInfo(NamedTuple):
    accepted: jax.Array        # [n_local] bool — the FLOW move's accept
    accepted_local: jax.Array  # [n_local] mean local-RW accept this gen
    logp: jax.Array            # [n_local]


def init(x0: jax.Array, log_prob: Callable, proposal: Proposal,
         cfg: FlowMhConfig) -> FlowMhState:
    logp = jax.vmap(log_prob)(x0)
    lq = proposal.log_q(x0)
    return FlowMhState(x=x0, logp=logp, lq=lq,
                       gen=jnp.zeros((), jnp.int32))


def make_step(log_prob: Callable, proposal: Proposal, cfg: FlowMhConfig,
              axis_name=None) -> Callable:
    """Build ``step(state, key, t)``. ``proposal`` (the frozen q —
    flow, GMM, anything with exact sample+log_q) is closed over.
    No cross-chain collectives."""

    if cfg.local_moves < 0:
        raise ValueError("local_moves must be >= 0")
    if cfg.global_every < 1:
        raise ValueError("global_every must be >= 1")
    if cfg.global_every > 1 and cfg.local_moves == 0:
        raise ValueError("global_every > 1 with local_moves=0 would "
                         "leave skipped generations with no move at all")

    def step(state: FlowMhState, key: jax.Array, t: jax.Array):
        n_local, d = state.x.shape
        dtype = state.x.dtype
        offset = chain_offset(n_local, axis_name)
        gid = offset + jnp.arange(n_local, dtype=jnp.int32)
        chain_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(gid)
        # per-chain word layout: local_moves × [eps(d) | u(1)] then the
        # global move's [eps(d) | u_comp(1) | u(1)]
        n_words = cfg.local_moves * (d + 1) + (d + 2)
        blk = jax.vmap(lambda k: jax.random.bits(
            k, (n_words,), jnp.uint32))(chain_keys)

        scale = (cfg.rw_scale * 2.38 / jnp.sqrt(jnp.asarray(d, dtype))
                 * proposal.sigma.astype(dtype))

        x, logp = state.x, state.logp
        n_acc_local = jnp.zeros((n_local,), dtype)
        for m in range(cfg.local_moves):
            w0 = m * (d + 1)
            eps = bits_to_normal(blk[:, w0:w0 + d], dtype)
            log_u = jnp.log(bits_to_uniform(blk[:, w0 + d], dtype))
            # barrier: keep the displacement a separately-rounded value
            # (XLA would otherwise fuse mul+add into an FMA here, which
            # the fused engine — displacement precomputed as a kernel
            # operand — cannot replicate; 1-ULP drift per move breaks
            # the engines' bit-agreement, tests/test_flowmh_fused.py)
            dxy = jax.lax.optimization_barrier(scale * eps)
            x_star = x + dxy
            logp_star = jax.vmap(log_prob)(x_star)
            log_alpha = jnp.minimum(0.0, logp_star - logp)
            log_alpha = jnp.where(jnp.isfinite(logp_star), log_alpha,
                                  -jnp.inf)
            acc = log_u < log_alpha
            x = jnp.where(acc[:, None], x_star, x)
            logp = jnp.where(acc, logp_star, logp)
            n_acc_local = n_acc_local + acc.astype(dtype)

        acc_local = (n_acc_local / cfg.local_moves if cfg.local_moves
                     else jnp.zeros((n_local,), dtype))

        # independence move from the fitted proposal density (on the
        # global_every schedule; the words are drawn either way — the
        # stream layout is schedule-independent)
        w0 = cfg.local_moves * (d + 1)
        eps = bits_to_normal(blk[:, w0:w0 + d], dtype)
        u_comp = bits_to_uniform(blk[:, w0 + d], dtype)
        log_u = jnp.log(bits_to_uniform(blk[:, w0 + d + 1], dtype))

        def global_move(args):
            x, logp, lq_cached = args
            # local moves changed x → refresh the cached log q (one
            # density pass; with local_moves=0 the cache is exact)
            lq = proposal.log_q(x) if cfg.local_moves else lq_cached
            x_star, lq_star = proposal.sample_logq(eps, u_comp)
            logp_star = jax.vmap(log_prob)(x_star)
            log_alpha = jnp.minimum(0.0,
                                    (logp_star - lq_star) - (logp - lq))
            log_alpha = jnp.where(jnp.isfinite(logp_star)
                                  & jnp.isfinite(lq_star), log_alpha,
                                  -jnp.inf)
            acc = log_u < log_alpha
            return (jnp.where(acc[:, None], x_star, x),
                    jnp.where(acc, logp_star, logp),
                    jnp.where(acc, lq_star, lq), acc)

        def skip_move(args):
            x, logp, lq_cached = args
            return x, logp, lq_cached, jnp.zeros((n_local,), bool)

        if cfg.global_every == 1:
            x_new, logp_new, lq_new, acc = global_move(
                (x, logp, state.lq))
        else:
            # t is a replicated scalar, so the cond is a real branch
            # under jit/shard_map — skipped generations pay nothing
            is_global = (t + 1) % cfg.global_every == 0
            x_new, logp_new, lq_new, acc = jax.lax.cond(
                is_global, global_move, skip_move, (x, logp, state.lq))

        new_state = FlowMhState(x=x_new, logp=logp_new, lq=lq_new,
                                gen=state.gen + 1)
        return new_state, FlowMhInfo(accepted=acc,
                                     accepted_local=acc_local,
                                     logp=logp_new)

    return step
