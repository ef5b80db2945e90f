"""Chunked fused-execution driver for steady-state DREAM-zs.

Drives ops/fused_chunk.py: a ``lax.scan`` over ``archive_thin``-generation
chunks where each chunk is (a) a handful of XLA ops that pregenerate the
chunk's randomness — the SAME threefry streams as the per-generation
engine (samplers/dream.py) — compute distinct archive row indices,
gather rows, and pack per-chain scalars, then (b) ONE Pallas kernel that
advances all G generations with x/logp carried inside it, then (c) the
archive ring append. See ops/fused_chunk.py's module docstring for why
chunk = ``archive_thin`` gives exactly the per-generation semantics.

Scope (checked at build time): post-burn-in only (CR adaptation and
outlier resets are burn-in-gated in the per-generation engine, so the
frozen steady state is time-homogeneous) and replicated archive.
Populations may be chain-sharded over a 1-D mesh (``mesh=``): each
device runs the fused kernel on its shard and the only cross-device
traffic is one [n, d] all_gather per chunk for the ring append. The
API layer (samplers/api.py) routes burn-in and unaligned segments
through the per-generation engine and only the aligned steady-state
remainder through here.

Key discipline: ``step_key(base_key, t)`` + per-chain ``fold_in`` on the
global chain id, identical to ChainPool.run — for the same base key the
fused and per-generation engines consume identical random streams, and
their trajectories agree up to float re-association
(tests/test_fused_chunk.py).
"""

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from bipymc_tpu.core.rng import bits_to_uniform, uniform_to_normal, step_key
from bipymc_tpu.ensemble.archive import archive_append
from bipymc_tpu.ensemble.indices import distinct_from_bits
from bipymc_tpu.ops.fused_chunk import (
    fused_chunk_pallas, lp_block_cache)
from bipymc_tpu.parallel.collectives import chain_offset
from bipymc_tpu.parallel.mesh import CHAIN_AXIS
from bipymc_tpu.samplers.dream import DreamConfig, DreamState
from bipymc_tpu.utils.streaming import rhat_init, rhat_update_block


def validate_fused_segment(cfg: DreamConfig, t0: int):
    """Check a concrete segment start is archive-aligned and post-burn-in."""
    G = cfg.archive_thin
    if t0 % G != 0:
        raise ValueError(f"t0={t0} not archive-aligned (thin={G})")
    if t0 < cfg.burnin_gens:
        raise ValueError(
            f"fused engine is post-burn-in only (t0={t0} < "
            f"burnin_gens={cfg.burnin_gens}); run the per-generation "
            "engine through burn-in first")


def proposal_scalars(cfg: DreamConfig, u_scal, cr_idx, gamma_jump, dtype):
    """Per-chain kernel scalars ``[..., 5]`` (delta, cr, gamma_s,
    is_snooker, gamma_jump as floats): the values samplers/dream.py
    ``propose_math_one`` derives inside its per-chain math, in the
    column order ops/fused_chunk.py reads. u_scal [..., 3]; cr_idx and
    gamma_jump (0/1 floats) [...]."""
    n_pairs = cfg.delta_max
    delta = 1 + jnp.floor(u_scal[..., 1] * n_pairs)
    delta = jnp.minimum(delta, float(n_pairs)).astype(dtype)
    cr = (cr_idx + 1).astype(dtype) / cfg.n_cr
    if cfg.jump_full_cr:
        cr = jnp.where(gamma_jump > 0, jnp.asarray(1.0, dtype), cr)
    gamma_s = cfg.snooker_lo + \
        (cfg.snooker_hi - cfg.snooker_lo) * u_scal[..., 2]
    is_snk = ((cfg.p_snooker > 0.0)
              & (u_scal[..., 0] < cfg.p_snooker)).astype(dtype)
    return jnp.stack([delta, cr, gamma_s, is_snk, gamma_jump], axis=-1)


def check_fusable(cfg: DreamConfig, mesh=None):
    """Raise if the fused engine cannot reproduce this configuration."""
    if not cfg.use_archive:
        raise ValueError("fused engine requires use_archive=True "
                         "(population-DREAM gathers the live population)")
    if cfg.shard_archive:
        raise ValueError("fused engine requires a replicated archive "
                         "(shard_archive=True uses the per-generation "
                         "engine's ppermute ring path)")
    if mesh is not None:
        n_dev = int(mesh.devices.size)
        if cfg.n_chains % n_dev:
            raise ValueError(
                f"n_chains={cfg.n_chains} must be divisible by the "
                f"mesh's {n_dev} devices")


def make_chunk_runner(log_prob: Callable, cfg: DreamConfig,
                      log_prob_block: Callable | None = None,
                      collect: str = "all",
                      prep_chunks: int = 8,
                      mesh=None,
                      wrap: bool = True,
                      z_update_every: int = 1) -> Callable:
    """Build ``run(state, base_key, n_gens, t0) -> (state, history)``.

    n_gens must be a multiple of ``cfg.archive_thin``; ``t0`` (a Python
    int == the state's generation counter) must be archive-aligned
    (``t0 % archive_thin == 0``) and ``>= cfg.burnin_gens``. history is
    ``{"x": [n_gens, n, d], "logp": [n_gens, n], "accepted": ...}`` —
    the same leaves as the default ChainPool collection.

    log_prob_block: optional ``[BC, Dp]-padded -> [BC, 1]`` kernel-side
    target (models/targets.py ``*_block``); default wraps ``log_prob``
    for the interpreter (ops/fused_chunk.block_logp_from_scalar).
    collect: ``"all"`` keeps per-generation positions in history;
    ``"stats"`` keeps only logp/accepted (positions cost n_gens·n·d
    floats — at 4096 chains × d=100 that is 1.6 GB per 1000
    generations, the difference between fitting in HBM or not);
    ``"rhat"`` folds per-chain Welford moments inside the runner's own
    scan and returns them as ``hist["rhat"]`` (an RhatCarry) next to the
    stats leaves — what ``ChainPool.run_until`` merges, so an R̂-stop
    loop never materializes positions at all.

    prep_chunks: batch the randomness/scalar pregeneration over this
    many chunks per outer scan step. Legal because everything
    pregenerated is independent of the archive *content*: threefry
    streams key on the absolute generation index, and the CR table is
    frozen post-burn-in. Only the fill-dependent distinct-row draw, the Z
    gather, the kernel, and the
    append remain per-chunk. Trajectories are bit-identical for every
    value; the knob only moves launch overhead.

    mesh: optional 1-D chain mesh. The runner then executes as ONE SPMD
    program under ``jax.shard_map`` — each device runs the fused kernel
    on its chain shard against the replicated archive, and the only
    cross-device traffic is ONE [n, d] ``all_gather`` per chunk for the
    ring append (the identical collective placement as the
    per-generation engine's sharded path, samplers/dream.py). Streams
    fold on GLOBAL chain ids, so trajectories are bit-identical to the
    single-device runner for the same base key
    (tests/test_fused_chunk.py::test_fused_mesh_matches_single_device).
    wrap: with a mesh, ``wrap=False`` returns the per-shard body
    (collectives on the chain axis) instead of the shard_map-wrapped
    program — for embedding inside a caller's own shard_map, e.g.
    ``ChainPool.run_until``'s fused chunks.
    z_update_every: publish archive appends every K = z_update_every
    thin-blocks instead of every block — K·archive_thin generations run
    as ONE kernel, with ONE distinct-row draw / Z gather / batched ring
    append (K thinned population snapshots, time-ordered) per super-
    block. This is ter Braak & Vrugt (2008)'s own structure — the paper
    updates Z "every K-th generation"; K·archive_thin is simply a larger
    update interval, with every intermediate thinned snapshot still
    appended at update time — so the stationary distribution is
    unchanged. Proposals inside a super-block sample a Z that is stale
    by up to K·archive_thin generations, so K > 1 trajectories are NOT
    bit-identical to the per-generation engine (K = 1 is); the random
    streams themselves still key on absolute generation indices and are
    identical for every K. Requires
    ``K · n_chains ≤ archive capacity`` (a batched append may not wrap
    onto itself). The payoff is per-generation XLA glue (distinct-idx
    draw, gather, append, kernel launch) amortized K×.
    """
    if collect not in ("all", "stats", "rhat"):
        raise ValueError(
            f"collect={collect!r}: expected 'all', 'stats' or 'rhat'")
    check_fusable(cfg, mesh)
    K = int(z_update_every)
    if K < 1:
        raise ValueError(f"z_update_every={z_update_every}: must be >= 1")
    axis = CHAIN_AXIS if mesh is not None else None
    G = cfg.archive_thin
    CG = K * G                     # generations per kernel / super-block
    n_pairs = cfg.delta_max
    n_rows = max(2 * n_pairs, 3)
    _lp_block_for = lp_block_cache(log_prob, log_prob_block)

    def runner_local(state: DreamState, base_key, n_gens: int, t0):
        """n_gens: static; t0: Python int or traced int32 scalar (traced
        skips the alignment validation — do it at the call site via
        :func:`validate_fused_segment`). On the mesh path this body runs
        per shard (n = local chains) with collectives on ``axis``."""
        if n_gens % CG != 0:
            raise ValueError(
                f"n_gens={n_gens} not a multiple of the super-block "
                f"length {CG} (archive_thin={G} x z_update_every={K})")
        if isinstance(t0, int):
            validate_fused_segment(cfg, t0)
        # archive is replicated in fused scope (check_fusable), so
        # buf.shape[0] is the global capacity on the mesh path too
        if K * cfg.n_chains > state.archive.buf.shape[0]:
            raise ValueError(
                f"z_update_every={K}: a batched append publishes "
                f"{K * cfg.n_chains} rows at once, exceeding the "
                f"archive capacity {state.archive.buf.shape[0]} — "
                "raise archive_capacity or lower z_update_every")
        n, dim = state.x.shape
        dtype = state.x.dtype
        lp_block = _lp_block_for(dim)
        nw = 5 + n_rows + 3 * dim
        gid = chain_offset(n, axis) + jnp.arange(n, dtype=jnp.int32)
        cr_cum = state.cr_cum  # frozen post-burn-in (check_fusable scope)

        def prep(ts):
            """Pregenerate everything archive-independent for the B
            generations with absolute indices ``ts`` ([B] int32).
            Identical stream construction to samplers/dream.py step:
            per-gen step key, per-chain fold on the global chain id, ONE
            bits block per (gen, chain) — keyed on the ABSOLUTE index,
            so values do not depend on how gens are grouped into
            superchunks."""
            B = ts.shape[0]
            keys = jax.vmap(lambda t: step_key(base_key, t))(ts)
            ckeys = jax.vmap(
                lambda kk: jax.vmap(
                    lambda i: jax.random.fold_in(kk, i))(gid))(keys)
            blk = jax.vmap(jax.vmap(
                lambda kk: jax.random.bits(kk, (nw,), jnp.uint32)))(ckeys)
            u_all = bits_to_uniform(blk, dtype)            # [B, n, nw]
            u_scal = u_all[..., 0:3]
            u_cr = u_all[..., 3]
            u_acc = u_all[..., 4]
            row_bits = blk[..., 5:5 + n_rows]
            off = 5 + n_rows
            u_mask = u_all[..., off:off + dim]
            u_e = u_all[..., off + dim:off + 2 * dim]
            eps_n = uniform_to_normal(u_all[..., off + 2 * dim:])

            # cr_cum is the frozen steady-state table, so this too is
            # chunk-independent
            cr_idx = jnp.minimum(
                jnp.sum(u_cr[..., None] >= cr_cum[None, None, :],
                        axis=-1),
                cfg.n_cr - 1).astype(jnp.int32)
            gj = ((ts % cfg.jump_interval) == (cfg.jump_interval - 1))
            gj = jnp.broadcast_to(gj[:, None], (B, n)).astype(dtype)
            scal = jnp.concatenate(
                [proposal_scalars(cfg, u_scal, cr_idx, gj, dtype),
                 jnp.log(u_acc)[..., None]], axis=-1)
            return row_bits, scal, (u_mask, u_e, eps_n)

        def chunk_core(carry, xs):
            """One CG-generation super-block from pregenerated inputs:
            the fill-dependent distinct-row draw, the Z gather, the
            fused kernel, and the batched ring append (K thinned
            snapshots published together — exactly the per-generation
            schedule when K == 1). collect="rhat" threads a Welford
            carry alongside the state."""
            st = carry[0] if collect == "rhat" else carry
            row_bits, scal, rng_in = xs                  # [CG, n, ...]
            # distinct archive rows — same construction as the
            # per-generation engine (identical bits → identical rows);
            # with K > 1 every generation in the super-block samples
            # the super-block-start archive (fill and contents)
            row_idx = jax.vmap(jax.vmap(
                lambda bb: distinct_from_bits(
                    bb, n_rows, st.archive.fill)))(row_bits)
            rows = st.archive.buf[row_idx]               # [CG, n, k, d]
            u_mask, u_e, eps_n = rng_in
            xh, lph, acc = fused_chunk_pallas(
                st.x, st.logp, rows, u_mask, u_e, eps_n, scal,
                lp_block, n_pairs=n_pairs, d_true=dim,
                b=cfg.b, b_star=cfg.b_star)

            x_new = xh[-1]
            logp_new = lph[-1]
            # archive append: the thinned snapshots (gen % thin ==
            # thin-1, the per-generation engine's schedule) publish as
            # ONE time-ordered batched append — identical rows and ring
            # positions to K sequential appends, and bit-identical to
            # the per-generation engine when K == 1
            snaps = xh[G - 1::G]                         # [K, n, d]
            pub = (snaps if axis is None
                   else lax.all_gather(snaps, axis, axis=1, tiled=True))
            new_st = DreamState(
                x=x_new, logp=logp_new,
                archive=archive_append(
                    st.archive, pub.reshape(-1, pub.shape[-1])),
                cr_p=st.cr_p, cr_cum=st.cr_cum,
                cr_jump=st.cr_jump, cr_count=st.cr_count,
                logp_sum=st.logp_sum + jnp.sum(lph, axis=0),
                gen=st.gen + CG)
            snk = scal[..., 3] > 0.5
            if collect == "rhat":
                # fold this G-block's positions into the carried moments
                # instead of materializing them: run_until only needs the
                # Welford carry, and the [n_gens, n, d] history is the
                # difference between O(G·n·d) and O(chunk·n·d) live bytes
                # inside the caller's while_loop
                rc = rhat_update_block(carry[1], xh)
                return (new_st, rc), (lph, acc, snk)
            ys = ((xh, lph, acc, snk) if collect == "all"
                  else (lph, acc, snk))
            return new_st, ys

        n_chunks = n_gens // CG
        # prep batching amortizes per-chunk launch overhead; a K-super-
        # block already prepares K blocks at once, so scale M down to
        # keep the live prep bytes (M*CG gens x n x nw words) flat —
        # at rng="stream" nw is 5+k+3d and M=prep_chunks with K=8 would
        # spike the prep block into hundreds of MB
        M = max(1, min(int(prep_chunks) // K, n_chunks))
        q, r = divmod(n_chunks, M)

        if collect == "rhat":
            nl, dl = state.x.shape
            carry0 = (state, rhat_init(nl, dl, state.x.dtype))
        else:
            carry0 = state

        def superchunk(carry, s):
            ts = t0 + s * (M * CG) + jnp.arange(M * CG, dtype=jnp.int32)
            pre = prep(ts)                                # [M*CG, n, ...]
            pre = jax.tree_util.tree_map(
                lambda a: a.reshape(M, CG, *a.shape[1:]), pre)
            return lax.scan(chunk_core, carry, pre)

        parts = []
        carry, ys = lax.scan(
            superchunk, carry0, jnp.arange(q, dtype=jnp.int32))
        # ys leaves are [q, M, CG, ...] → flatten the chunk axes
        parts.append(jax.tree_util.tree_map(
            lambda a: a.reshape(q * M * CG, *a.shape[3:]), ys))
        if r:
            def rem(c, k):
                ts = (t0 + (q * M + k) * CG
                      + jnp.arange(CG, dtype=jnp.int32))
                return chunk_core(c, prep(ts))
            carry, ys_r = lax.scan(
                rem, carry, jnp.arange(r, dtype=jnp.int32))
            parts.append(jax.tree_util.tree_map(
                lambda a: a.reshape(r * CG, *a.shape[2:]), ys_r))
        ys = (parts[0] if len(parts) == 1 else
              jax.tree_util.tree_map(
                  lambda a, b: jnp.concatenate([a, b], axis=0), *parts))
        if collect == "all":
            state = carry
            xh, lph, acc, snk = ys
            hist = {"x": xh, "logp": lph, "accepted": acc,
                    "snooker": snk}
        elif collect == "rhat":
            state, rc = carry
            lph, acc, snk = ys
            hist = {"rhat": rc, "logp": lph, "accepted": acc,
                    "snooker": snk}
        else:
            state = carry
            lph, acc, snk = ys
            hist = {"logp": lph, "accepted": acc, "snooker": snk}
        return state, hist

    # contract attributes ChainPool.run_until validates at its entry
    # (its t0 is traced by the time the runner's own check could fire):
    # chunk lengths must cover whole super-blocks, t0 must be
    # archive-aligned, and the history this runner records is the
    # population x
    runner_local.align = int(G)
    runner_local.chunk_multiple = int(CG)
    runner_local.position_field = "x"

    if mesh is None or not wrap:
        # wrap=False with a mesh: the LOCAL per-shard body (collectives
        # on the chain axis, no shard_map of its own) for embedding in a
        # caller's shard_map program — ChainPool.run_until's fused path.
        return runner_local

    from jax.sharding import PartitionSpec as P
    from bipymc_tpu.parallel.pool import _history_spec, _state_specs

    def runner(state: DreamState, base_key, n_gens: int, t0):
        if isinstance(t0, int):
            validate_fused_segment(cfg, t0)
        state_specs = _state_specs(
            state, ("x", "logp", "logp_sum"), axis)
        hist_ndim = {"logp": 2, "accepted": 2, "snooker": 2}
        if collect == "all":
            hist_ndim["x"] = 3
        hist_specs = {k: _history_spec(nd, axis)
                      for k, nd in hist_ndim.items()}
        if collect == "rhat":
            from bipymc_tpu.utils.streaming import RhatCarry
            hist_specs["rhat"] = RhatCarry(
                n=P(), mean=P(axis, None), m2=P(axis, None))
        fn = jax.shard_map(
            lambda s, k, t: runner_local(s, k, n_gens, t),
            mesh=mesh, in_specs=(state_specs, P(), P()),
            out_specs=(state_specs, hist_specs), check_vma=False)
        return fn(state, base_key, jnp.asarray(t0, jnp.int32))

    runner.align = int(G)
    runner.chunk_multiple = int(CG)
    runner.position_field = "x"
    return runner
