"""Fused multi-generation engine for the global-move (FlowMh) sampler.

A per-generation FlowMh step pays its global move's proposal density
passes every generation, plus one launch per fusion for local moves that
are plain Gaussian RW MH. Two structural fixes remove most of that:

1. **Amortize the global move** (``FlowMhConfig.global_every``): one
   independence move every K generations is still exactly π-invariant
   (composition of π-invariant kernels), and the proposal's density
   passes — the expensive part — are paid 1/K as often.
2. **Fuse the local-RW block**: the K·local_moves RW MH moves between
   global moves are exactly the MH mode of ``ops/fused_rw_chunk.py``
   (delayed=False, frozen diagonal scale), so a whole inter-global
   segment runs as ONE Pallas kernel with (x, logp) carried inside it;
   the global move executes between kernel launches in XLA
   (its per-chunk cost: one proposal log-density pass + one target
   batch + one proposal sample).

Stream discipline: the prep replicates samplers/flowmh.py's per-chain
word layout exactly — one ``local_moves·(d+1) + (d+2)``-word block per
(generation, chain) from the ``step_key``/``fold_in`` hierarchy, global
words drawn every generation but consumed only at chunk ends, exactly
as the per-generation engine's ``global_every`` schedule does — so
trajectories are bit-identical in randomness to ``fused=False`` and
match to float re-association in math (tests/test_flowmh_fused.py pins
exact equality in interpret mode).

Reference parity: an execution strategy for the same composed kernel as
samplers/flowmh.py (no reference counterpart — beyond-reference).
"""

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from bipymc_tpu.core.rng import bits_to_normal, bits_to_uniform, step_key
from bipymc_tpu.ops.fused_chunk import lp_block_cache
from bipymc_tpu.ops.fused_rw_chunk import fused_rw_chunk_pallas
from bipymc_tpu.parallel.collectives import chain_offset
from bipymc_tpu.parallel.mesh import CHAIN_AXIS
from bipymc_tpu.samplers.flowmh import FlowMhConfig, FlowMhState
from bipymc_tpu.utils.proposals import Proposal


def check_flowmh_fusable(cfg: FlowMhConfig, mesh=None,
                         n_chains: int | None = None) -> None:
    """Raise unless the config's trajectory is chunk-fusable."""
    if cfg.local_moves < 1:
        raise ValueError(
            "fused FlowMh requires local_moves >= 1 (the fused engine "
            "runs the local-RW block in-kernel; a pure independence "
            "sampler has no local block to fuse — use fused=False)")
    if cfg.global_every < 1:
        raise ValueError("global_every must be >= 1")
    if mesh is not None and n_chains is not None:
        n_dev = int(mesh.devices.size)
        if n_chains % n_dev:
            raise ValueError(
                f"n_chains={n_chains} must be divisible by the mesh's "
                f"{n_dev} devices")


def make_flowmh_chunk_runner(log_prob: Callable, proposal: Proposal,
                             cfg: FlowMhConfig, n_chains: int,
                             log_prob_block: Callable | None = None,
                             mesh=None, wrap: bool = True) -> Callable:
    """Build ``run(state, base_key, n_gens, t0) -> (state, history)``.

    state: the batched FlowMhState. ``n_gens`` must be a multiple of the
    chunk length G = ``cfg.global_every`` and ``t0`` G-aligned (so the
    global-move schedule ``(t+1) % G == 0`` lands exactly on chunk
    ends; traced ``t0`` skips the check — align at the call site).
    history: ``{"x", "logp", "accepted", "accepted_local"}`` — the same
    leaves as ``api._flowmh_collect`` per generation.

    mesh: optional 1-D chain mesh (SURVEY §3.2: "the mesh path turns on above
    one device with the same step
    function"). FlowMh chains are fully independent and the proposal is
    frozen/replicated, so the SPMD program has ZERO in-step
    collectives: each device runs the fused Pallas kernel on its chain
    shard and executes the global independence move on its local block.
    Streams fold on GLOBAL chain ids (``chain_offset``), exactly like
    the per-generation engine's sharded path, so mesh trajectories are
    bit-identical in randomness to the single-device runner for the
    same base key (tests/test_flowmh_fused.py pins vmap-vs-mesh
    equality on 8 fake devices). ``wrap=False`` with a mesh returns the
    per-shard body for embedding in a caller's own shard_map
    (ChainPool.run_until's fused chunks).
    """
    check_flowmh_fusable(cfg, mesh, n_chains)
    axis = CHAIN_AXIS if mesh is not None else None
    n_local_expect = (n_chains // int(mesh.devices.size)
                      if mesh is not None else n_chains)
    G = int(cfg.global_every)
    L = int(cfg.local_moves)
    K_loc = G * L
    _lp_block_for = lp_block_cache(log_prob, log_prob_block)

    def runner_local(state: FlowMhState, base_key, n_gens: int, t0):
        n, d = state.x.shape
        dtype = state.x.dtype
        if n != n_local_expect:
            raise ValueError(f"state has {n} chains per shard, runner "
                             f"built for {n_local_expect}")
        if n_gens % G != 0:
            raise ValueError(f"n_gens={n_gens} not a multiple of the "
                             f"chunk length global_every={G}")
        if isinstance(t0, int) and t0 % G != 0:
            raise ValueError(f"t0={t0} not aligned to global_every={G}")
        lp_block = _lp_block_for(d)
        n_words = L * (d + 1) + (d + 2)
        scale = (cfg.rw_scale * 2.38 / jnp.sqrt(jnp.asarray(d, dtype))
                 * proposal.sigma.astype(dtype))
        # GLOBAL chain ids: on the mesh path each shard folds its own
        # offset so streams — and therefore trajectories — match the
        # single-device runner bit-for-bit (same construction as
        # samplers/flowmh.py make_step and dream_fused.py)
        cids = chain_offset(n, axis) + jnp.arange(n, dtype=jnp.int32)
        t0 = jnp.asarray(t0, jnp.int32)

        def chunk(st: FlowMhState, ci):
            ts = t0 + ci * G + jnp.arange(G, dtype=jnp.int32)
            # the EXACT per-generation stream: step_key on the global t,
            # per-chain fold on the chain index, one n_words block
            keys = jax.vmap(lambda t: step_key(base_key, t))(ts)
            ckeys = jax.vmap(lambda kk: jax.vmap(
                lambda i: jax.random.fold_in(kk, i))(cids))(keys)
            blk = jax.vmap(jax.vmap(lambda kk: jax.random.bits(
                kk, (n_words,), jnp.uint32)))(ckeys)        # [G, n, W]

            # local words: per gen, L groups of [eps(d) | u(1)]
            loc = (blk[:, :, :L * (d + 1)]
                   .reshape(G, n, L, d + 1)
                   .transpose(0, 2, 1, 3))                  # [G, L, n, d+1]
            eps = bits_to_normal(
                loc[..., :d].reshape(K_loc, n, d), dtype)
            log_u = jnp.log(bits_to_uniform(
                loc[..., d].reshape(K_loc, n), dtype))
            dy1 = scale * eps
            zk = jnp.zeros((K_loc, n), dtype)
            scal = jnp.stack([zk, zk, log_u, zk], axis=-1)
            xh, lph, accl, _stage = fused_rw_chunk_pallas(
                st.x, st.logp, dy1, None, scal, lp_block,
                delayed=False)
            x_end, lp_end = xh[-1], lph[-1]

            # global independence move at the chunk's last generation —
            # the identical math as samplers/flowmh.py's global_move
            w0 = L * (d + 1)
            gblk = blk[G - 1]
            eps_g = bits_to_normal(gblk[:, w0:w0 + d], dtype)
            u_comp = bits_to_uniform(gblk[:, w0 + d], dtype)
            log_u_g = jnp.log(bits_to_uniform(gblk[:, w0 + d + 1], dtype))
            lq = proposal.log_q(x_end)
            x_star, lq_star = proposal.sample_logq(eps_g, u_comp)
            logp_star = jax.vmap(log_prob)(x_star)
            log_alpha = jnp.minimum(0.0,
                                    (logp_star - lq_star) - (lp_end - lq))
            log_alpha = jnp.where(jnp.isfinite(logp_star)
                                  & jnp.isfinite(lq_star), log_alpha,
                                  -jnp.inf)
            acc_g = log_u_g < log_alpha
            x_new = jnp.where(acc_g[:, None], x_star, x_end)
            lp_new = jnp.where(acc_g, logp_star, lp_end)
            lq_new = jnp.where(acc_g, lq_star, lq)

            # per-generation history rows (position after each gen's
            # local block; the last gen also sees the global move)
            xg = xh.reshape(G, L, n, d)[:, -1].at[G - 1].set(x_new)
            lg = lph.reshape(G, L, n)[:, -1].at[G - 1].set(lp_new)
            accepted = (jnp.zeros((G, n), bool).at[G - 1].set(acc_g))
            acc_local = accl.reshape(G, L, n).astype(dtype).mean(axis=1)

            new_st = FlowMhState(x=x_new, logp=lp_new, lq=lq_new,
                                 gen=st.gen + G)
            return new_st, (xg, lg, accepted, acc_local)

        n_chunks = n_gens // G
        state, (xg, lg, acc, accl) = lax.scan(
            chunk, state, jnp.arange(n_chunks, dtype=jnp.int32))
        hist = {
            "x": xg.reshape(n_gens, n, d),
            "logp": lg.reshape(n_gens, n),
            "accepted": acc.reshape(n_gens, n),
            "accepted_local": accl.reshape(n_gens, n),
        }
        return state, hist

    # contract attributes ChainPool.run_until validates at its entry
    runner_local.chunk_multiple = G
    runner_local.align = G
    runner_local.position_field = "x"

    if mesh is None or not wrap:
        return runner_local

    from jax.sharding import PartitionSpec as P
    from bipymc_tpu.parallel.pool import _history_spec, _state_specs
    from bipymc_tpu.samplers.flowmh import SHARDED_FIELDS

    def runner(state: FlowMhState, base_key, n_gens: int, t0):
        state_specs = _state_specs(state, SHARDED_FIELDS, axis)
        hist_specs = {"x": _history_spec(3, axis),
                      "logp": _history_spec(2, axis),
                      "accepted": _history_spec(2, axis),
                      "accepted_local": _history_spec(2, axis)}
        fn = jax.shard_map(
            lambda s, k, t: runner_local(s, k, n_gens, t),
            mesh=mesh, in_specs=(state_specs, P(), P()),
            out_specs=(state_specs, hist_specs), check_vma=False)
        return fn(state, base_key, jnp.asarray(t0, jnp.int32))

    runner.chunk_multiple = G
    runner.align = G
    runner.position_field = "x"
    return runner
