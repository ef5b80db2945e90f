"""Fused multi-step engine for the random-walk family (MH/DR/DRAM).

Drives ops/fused_rw_chunk.py: a ``lax.scan`` over K-step chunks, each ONE
Pallas kernel, with the AM adaptation replayed OUTSIDE the kernel —
bit-exactly — from the chunk history. See ops/fused_rw_chunk.py's module
docstring for the fusability argument; the key fact is that samplers/
rw.py's trajectory depends on (theta, logp, chol) only, and chol changes
only at refresh points ``(t+1) % adapt_interval == 0``, so with
K = adapt_interval and aligned chunk starts the kernel never sees a
stale factor.

Exactness contract (tests/test_fused_rw.py): the prep replicates
samplers/rw.py's ``_default_draws`` bits stream word-for-word (one
[2d+2]-word block per (step, chain), the pool's step_key/fold_in
hierarchy), the Welford replay runs the identical update formulas in the
identical order, and the refresh applies the identical gate — so
trajectories match the per-step engine bit-for-bit in randomness and to
float re-association in math (exact in interpret mode in practice).

Reference parity: an execution strategy for the same DRAM algorithm
(SURVEY.md §4.2–4.4), not a new sampler.
"""

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from bipymc_tpu.core.rng import (bits_to_uniform, step_key,
                                 uniform_to_normal)
from bipymc_tpu.ops.fused_chunk import lp_block_cache
from bipymc_tpu.ops.fused_rw_chunk import fused_rw_chunk_pallas
from bipymc_tpu.samplers.rw import RwConfig, RwState


def check_rw_fusable(cfg: RwConfig) -> None:
    """Raise unless the config's trajectory is chunk-fusable."""
    if cfg.adapt and cfg.adapt_interval == 1:
        raise ValueError(
            "fused RW engine requires adapt_interval > 1: the rank-1 "
            "every-step Cholesky mode changes the proposal factor inside "
            "any chunk (use the per-step engine)")


def make_rw_chunk_runner(log_prob: Callable, cfg: RwConfig, n_chains: int,
                         log_prob_block: Callable | None = None,
                         chunk_steps: int | None = None) -> Callable:
    """Build ``run(state, base_key, n_steps, t0) -> (state, history)``.

    state: the BATCHED RwState (leaves with a leading [n_chains] axis —
    the same pytree ``_RwSampler`` carries). n_steps must be a multiple
    of the chunk length K (= ``adapt_interval`` when ``cfg.adapt``,
    else ``chunk_steps``, default 100); with ``cfg.adapt``, ``t0`` must
    be K-aligned so AM refresh points land exactly on chunk boundaries
    (traced ``t0`` skips the check — align at the call site). history is
    ``{"x": [n_steps, n, d], "logp": [n_steps, n], "accepted": ...}`` —
    the same leaves as ``_RwSampler.run_mcmc`` collects.
    """
    check_rw_fusable(cfg)
    K = int(cfg.adapt_interval) if cfg.adapt else int(chunk_steps or 100)
    _lp_block_for = lp_block_cache(log_prob, log_prob_block)

    def runner(state: RwState, base_key, n_steps: int, t0):
        n, d = state.theta.shape
        dtype = state.theta.dtype
        if n != n_chains:
            raise ValueError(f"state has {n} chains, runner built for "
                             f"{n_chains}")
        if n_steps % K != 0:
            raise ValueError(f"n_steps={n_steps} not a multiple of the "
                             f"chunk length K={K}")
        if cfg.adapt and isinstance(t0, int) and t0 % K != 0:
            raise ValueError(f"t0={t0} not aligned to adapt_interval={K}")
        lp_block = _lp_block_for(d)
        sd = cfg.sd if cfg.sd is not None else 2.38 ** 2 / d
        inv_sqrt_kappa = jnp.asarray(1.0 / jnp.sqrt(cfg.kappa), dtype)
        cids = jnp.arange(n_chains, dtype=jnp.int32)
        t0 = jnp.asarray(t0, jnp.int32)

        def prep(ts):
            """The exact per-step bits stream of samplers/rw.py
            ``_default_draws``: step_key on the global t, per-chain
            fold on the LOCAL chain index (the _RwSampler.batched_step
            hierarchy), ONE [2d+2]-word block per (step, chain)."""
            keys = jax.vmap(lambda t: step_key(base_key, t))(ts)
            ckeys = jax.vmap(lambda kk: jax.vmap(
                lambda i: jax.random.fold_in(kk, i))(cids))(keys)
            blk = jax.vmap(jax.vmap(
                lambda kk: jax.random.bits(kk, (2 * d + 2,), jnp.uint32)
            ))(ckeys)
            u = bits_to_uniform(blk, dtype)               # [K, n, 2d+2]
            # the z2 words are always DRAWN (the [2d+2] block is the
            # stream contract) but only transformed when DR reads them
            z1 = uniform_to_normal(u[..., 0:d])
            z2 = (uniform_to_normal(u[..., d:2 * d]) if cfg.delayed
                  else None)
            return z1, z2, u[..., 2 * d], u[..., 2 * d + 1]

        def chunk(st: RwState, ci):
            ts = t0 + ci * K + jnp.arange(K, dtype=jnp.int32)
            z1, z2, uu1, uu2 = prep(ts)
            hi = jax.lax.Precision.HIGHEST      # as samplers/rw.py step
            dy1 = jnp.einsum("nij,knj->kni", st.chol, z1, precision=hi)
            if cfg.delayed:
                dy2 = inv_sqrt_kappa * jnp.einsum(
                    "nij,knj->kni", st.chol, z2, precision=hi)
                w = z1 - inv_sqrt_kappa * z2
                scal = jnp.stack(
                    [jnp.sum(z1 * z1, -1), jnp.sum(w * w, -1),
                     jnp.log(uu1), jnp.log(uu2)], axis=-1)
            else:
                # MH/AM: no stage 2 — skip the dead K-batched einsum,
                # norms, and kernel operand (the kernel reads only the
                # log u₁ lane)
                dy2 = None
                zk = jnp.zeros(uu1.shape, dtype)
                scal = jnp.stack([zk, zk, jnp.log(uu1), zk], axis=-1)
            xh, lph, acc, _stage = fused_rw_chunk_pallas(
                st.theta, st.logp, dy1, dy2, scal, lp_block,
                delayed=cfg.delayed)

            if cfg.adapt:
                # bit-exact Welford replay of the per-step updates the
                # kernel skipped (they never feed back within a chunk)
                def one(carry, x_t):
                    mean, m2, count = carry
                    nn = count + 1
                    delta = x_t - mean
                    mean_new = mean + delta / nn.astype(dtype)[:, None]
                    delta2 = x_t - mean_new
                    m2_new = m2 + delta[:, :, None] * delta2[:, None, :]
                    return (mean_new, m2_new, nn), None

                (mean_new, m2_new, count_new), _ = lax.scan(
                    one, (st.mean, st.m2, st.count), xh)

                # AM refresh at the chunk's last step — the identical
                # gate and formula as samplers/rw.py (K = adapt_interval
                # makes (t_end+1) % interval == 0 automatic on aligned
                # chunks; the t >= cfg.t0 warmup gate remains)
                t_end = ts[-1]

                def refresh(_):
                    # (n - 1).astype(dtype) in exactly samplers/rw.py's
                    # op order (int subtract, then cast)
                    nf = (count_new - 1).astype(dtype)[:, None, None]
                    cov = sd * (m2_new / nf
                                + cfg.eps * jnp.eye(d, dtype=dtype))
                    c = jax.vmap(jnp.linalg.cholesky)(cov)
                    ok = jnp.all(jnp.isfinite(c), axis=(-2, -1),
                                 keepdims=True)
                    return jnp.where(ok, c, st.chol)

                chol_new = lax.cond(t_end >= cfg.t0, refresh,
                                    lambda _: st.chol, operand=None)
            else:
                mean_new, m2_new, count_new, chol_new = (
                    st.mean, st.m2, st.count, st.chol)

            new_st = RwState(theta=xh[-1], logp=lph[-1], mean=mean_new,
                             m2=m2_new, count=count_new, chol=chol_new)
            return new_st, (xh, lph, acc)

        n_chunks = n_steps // K
        state, (xh, lph, acc) = lax.scan(
            chunk, state, jnp.arange(n_chunks, dtype=jnp.int32))
        hist = {
            "x": xh.reshape(n_steps, n, d),
            "logp": lph.reshape(n_steps, n),
            "accepted": acc.reshape(n_steps, n),
        }
        return state, hist

    # contract attributes ChainPool.run_until validates at its entry
    # (its t0 is traced by the time this runner's own check could fire):
    # chunk lengths are K-multiples always; t0 alignment matters only
    # when AM refresh points must land on chunk boundaries; the history
    # records the theta trajectory
    runner.chunk_multiple = K
    runner.align = K if cfg.adapt else 1
    runner.position_field = "theta"
    return runner
