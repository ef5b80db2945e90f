"""ChainPool — the accelerator-native replacement for the reference's mpi4py
pool.

The reference farms per-chain log-likelihood evaluations over MPI ranks and
gathers/broadcasts population state every generation (SURVEY.md §3.2, §5.2).
Here the pool is a *compilation strategy*, not a communicator:

- ``mesh=None`` (default): the whole population lives on one device and the
  generation step's internal ``vmap`` evaluates all chains in lockstep —
  the common fast path for ≤ thousands of chains.
- with a ``Mesh(("chains",))``: the same step function runs under
  ``jax.shard_map`` with the population sharded over devices; the
  ``all_gather``/``psum`` calls inside the step (no-ops on the vmap path)
  become ICI collectives. The entire ``lax.scan`` over generations sits
  *inside* the shard_map, so a full run is one SPMD program with zero host
  round-trips.

Both paths fold RNG keys by *global* chain index, so they produce
identical trajectories for the same seed (tested in
tests/test_sharding.py).
"""

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bipymc_tpu.core.rng import step_key
from bipymc_tpu.core.scan import run_scan_thinned
from bipymc_tpu.parallel.mesh import CHAIN_AXIS
from bipymc_tpu.utils.streaming import (
    rhat_init, rhat_update, rhat_update_block, rhat_merge, rhat_compute)


def _parse_field(entry):
    """``"name"`` → (name, 0); ``"name@1"`` → (name, 1)."""
    name, _, dim = entry.partition("@")
    return name, int(dim) if dim else 0


def _spec_at(dim, ndim, axis_name):
    return P(*([None] * dim), axis_name, *([None] * (ndim - dim - 1)))


def _state_specs(state, sharded_fields, axis_name):
    """PartitionSpec pytree for a population state NamedTuple.

    Fields named in ``sharded_fields`` are sharded on their leading axis
    by default; a ``"@k"`` suffix shards axis ``k`` instead (e.g.
    ParallelTempering's ``"kernel@1"`` — chain axis sits behind the temp
    axis). Everything else (CR weights, counters, …) is replicated.
    Dotted names reach into nested NamedTuples (e.g. ``"archive.buf"``
    block-shards the DREAM archive ring buffer — ensemble/archive.py);
    naming a nested NamedTuple itself shards EVERY leaf under it at the
    given axis.
    """
    direct = {}
    nested = {}
    for f in sharded_fields:
        name, dim = _parse_field(f)
        if "." in name:
            head, rest = name.split(".", 1)
            nested.setdefault(head, []).append(
                rest + (f"@{dim}" if dim else ""))
        else:
            direct[name] = dim
    specs = {}
    for name in state._fields:
        leaf = getattr(state, name)
        if name in direct:
            dim = direct[name]
            specs[name] = jax.tree_util.tree_map(
                lambda l: _spec_at(dim, jnp.ndim(l), axis_name), leaf)
        elif hasattr(leaf, "_fields"):
            specs[name] = _state_specs(leaf, nested.get(name, []),
                                       axis_name)
        else:
            specs[name] = jax.tree_util.tree_map(lambda _: P(), leaf)
    return type(state)(**specs)


def _get_field(state, dotted_name):
    obj = state
    for part in dotted_name.split("."):
        obj = getattr(obj, part)
    return obj


def _default_collect(state, info):
    return {"x": state.x, "logp": info.logp, "accepted": info.accepted}


def _default_position(state):
    """Stable default position_fn for ``run_until`` (population ``x``).

    Module-level on purpose: the runner cache keys on the position_fn's
    identity, and a per-call ``lambda s: s.x`` made every ``run_mcmc_until``
    call a cache miss — re-tracing + full XLA recompilation each time. Mirrors
    ``_rw_position`` /
    ``_pt_cold_position`` in samplers/api.py.
    """
    return state.x


def _history_spec(leaf_ndim, axis_name):
    # history leaves are [T, n_chains, ...]: shard the chain axis
    if leaf_ndim < 2:
        # a chain-reduced leaf ([T] scalar per step) has no chain axis
        # to shard, and the pool cannot prove it replicated across
        # shards (collect_fn sees no mesh axis to psum over) — an
        # unsharded out_spec would silently return ONE shard's value
        raise ValueError(
            "mesh-path collect_fn leaves must keep the chain axis at "
            "dim 1 ([T, n_chains, ...]); reduce across chains on the "
            "host after run() instead")
    return P(None, axis_name, *([None] * (leaf_ndim - 2)))


class ChainPool:
    """Runs a population sampler's generation step over many chains.

    step_factory: ``axis_name -> step(state, key, t)`` (the sampler module's
        ``make_step`` partially applied with log_prob and config).
    sharded_fields: state fields carrying a leading chain axis.
    """

    def __init__(self, step_factory: Callable, sharded_fields,
                 mesh: Mesh | None = None, axis_name: str = CHAIN_AXIS,
                 collect_fn: Callable | None = None):
        self.step_factory = step_factory
        self.sharded_fields = tuple(sharded_fields)
        self.mesh = mesh
        self.axis_name = axis_name if mesh is not None else None
        self.collect_fn = collect_fn
        # jitted runners keyed by (n_steps, thin, progress_every): t0 is a
        # *traced* argument, so resumed/repeated runs never recompile
        self._runners = {}

    def shard_state(self, state):
        """device_put a replicated/host state onto the mesh layout."""
        if self.mesh is None:
            return state
        n_dev = self.mesh.devices.size
        for entry in self.sharded_fields:
            name, dim = _parse_field(entry)
            for leaf in jax.tree_util.tree_leaves(_get_field(state, name)):
                n = leaf.shape[dim]
                if n % n_dev != 0:
                    raise ValueError(
                        f"sharded field '{name}' axis-{dim} dim {n} must "
                        f"be divisible by the mesh's {n_dev} devices")
        specs = _state_specs(state, self.sharded_fields, self.axis_name)
        shardings = jax.tree_util.tree_map(
            lambda s: NamedSharding(self.mesh, s), specs,
            is_leaf=lambda x: isinstance(x, P))
        return jax.device_put(state, shardings)

    def run(self, state, base_key, n_steps: int, thin: int = 1,
            collect_fn: Callable | None = None, t0: int = 0,
            progress_every: int | None = None):
        """Scan ``n_steps`` generations; collect every ``thin``-th.

        Default collection: dict(x=positions, logp, accepted) per kept step.
        Returns (final_state, history) — history chain axis is sharded on
        the mesh path.
        """
        collect_fn = collect_fn or self.collect_fn or _default_collect
        # collect_fn is part of the key (held strongly by the dict, so its
        # identity stays valid): a second run with the same shape key but a
        # different collect_fn must not reuse the first run's compiled
        # history layout. Callers passing per-call lambdas recompile; pass
        # a stable callable (or set the constructor collect_fn) to cache.
        cache_key = (n_steps, thin, progress_every, collect_fn)
        t0 = jnp.asarray(t0, jnp.int32)

        if self.mesh is None:
            if cache_key not in self._runners:
                step = self.step_factory(None)
                self._runners[cache_key] = jax.jit(
                    lambda state, key, t0: run_scan_thinned(
                        step, state, key, n_steps=n_steps, thin=thin,
                        collect_fn=collect_fn, t0=t0,
                        progress_every=progress_every))
            return self._runners[cache_key](state, base_key, t0)

        axis = self.axis_name
        if cache_key not in self._runners:
            step = self.step_factory(axis)
            state_specs = _state_specs(state, self.sharded_fields, axis)

            def local_run(state, key, t0):
                return run_scan_thinned(
                    step, state, key, n_steps=n_steps, thin=thin,
                    collect_fn=collect_fn, t0=t0,
                    progress_every=progress_every)

            # out specs: final state like in; history [T, chains, ...]
            # leaves. Probe shapes with the axis-free step (collectives
            # are identities there); only leaf ranks are needed, and they
            # match the local run.
            step_probe = self.step_factory(None)

            def probe(state, key, t0):
                return run_scan_thinned(step_probe, state, key,
                                        n_steps=n_steps, thin=thin,
                                        collect_fn=collect_fn, t0=t0)

            hist_shape = jax.eval_shape(
                probe, state, jax.random.key(0), t0)[1]
            hist_specs = jax.tree_util.tree_map(
                lambda l: _history_spec(len(l.shape), axis), hist_shape)

            self._runners[cache_key] = jax.jit(jax.shard_map(
                local_run, mesh=self.mesh,
                in_specs=(state_specs, P(), P()),
                out_specs=(state_specs, hist_specs),
                check_vma=False,
            ))
        return self._runners[cache_key](self.shard_state(state), base_key,
                                        t0)

    def run_until(self, state, base_key, rhat_tol=1.05, chunk=100,
                  max_chunks=200, warmup_chunks=2, position_fn=None,
                  t0: int = 0, chunk_runner=None, fused_after=0):
        """Run until streaming R̂ < rhat_tol (BASELINE config 5 stopping).

        Structure: ``while_loop`` over compiled ``chunk``-step scans so
        compilation stays bounded while the trip count is dynamic
        (SURVEY.md §9 "Host-free stopping"). Moments reset after
        ``warmup_chunks`` so early transients don't poison R̂. No history
        is kept — the return carries final state, streamed posterior
        moments, steps taken, and the final R̂ vector.

        t0: global step offset for continuation runs — keys fold on the
        GLOBAL step index so a resumed run never replays randomness the
        previous phase already consumed (and schedule-dependent kernels
        like AM see the true step count). Pass the sampler's running step
        total, exactly as ``run`` does.

        chunk_runner: optional fused multi-generation runner
        ``(state, key, n_gens, t0) -> (state, hist)`` (samplers/
        dream_fused.make_chunk_runner) used for chunks starting at
        generation ≥ ``fused_after`` (the per-generation step covers
        burn-in before that). The caller must pick ``chunk`` and
        ``fused_after`` so every fused chunk start is archive-aligned
        (``% archive_thin == 0``) and post-burn-in; streams are
        identical by key discipline, so trajectories match the
        per-generation path (bit-identical with rng="stream"). Moments
        fold blockwise via :func:`rhat_update_block` (same Welford
        result up to float re-association). On the mesh path pass the
        LOCAL per-shard runner (``make_chunk_runner(..., wrap=False)``)
        — it runs inside this pool's shard_map, with its chain-axis
        collectives riding the same program.

        Returns (final_state, info dict with steps/rhat/mean/var).
        """
        if chunk_runner is not None:
            # The fused branch folds the runner's own position history
            # (hist["x"]) into R̂; on per-generation chunks the same
            # moments fold position_fn(state). Those must be the SAME
            # series, or the two chunk kinds of one run fold different
            # quantities into one RhatCarry. The runner declares which
            # state field its history records (position_field); verify
            # by object identity on the concrete entry state.
            field = getattr(chunk_runner, "position_field", "x")
            pf = position_fn or _default_position
            if pf(state) is not _get_field(state, field):
                raise ValueError(
                    "run_until(chunk_runner=...): position_fn must "
                    f"extract the runner's recorded position (state."
                    f"{field}) — fused chunks fold the runner's "
                    "hist['x'] into the R-hat moments, so a transformed "
                    "position needs the per-generation path")
            # Alignment must hold for EVERY chunk start: the runner's
            # own t0-alignment check never fires here because t0 is
            # traced by the time the runner sees it.
            mult = getattr(chunk_runner, "chunk_multiple", None)
            if mult and chunk % mult:
                raise ValueError(
                    f"chunk={chunk} must be a multiple of the fused "
                    f"runner's chunk length {mult}")
            align = getattr(chunk_runner, "align", None)
            if align and int(t0) % align:
                raise ValueError(
                    f"t0={t0} must be aligned to the fused runner's "
                    f"alignment {align}")
        if position_fn is None:
            position_fn = _default_position
        pos0 = position_fn(state)
        n_total = pos0.shape[0]
        if n_total < 2:            # state is pre-shard here: global count
            # with one chain, B/W is 0/0: R-hat is NaN, every comparison
            # against rhat_tol is False and the loop would exit right
            # after warmup looking like a converged run
            raise ValueError("R-hat early stop needs n_chains >= 2")
        d = pos0.shape[-1]
        dtype = pos0.dtype
        axis = self.axis_name
        t0 = jnp.asarray(t0, jnp.int32)

        cache_key = ("until", rhat_tol, chunk, max_chunks, warmup_chunks,
                     position_fn, n_total, d, dtype, chunk_runner,
                     fused_after)
        if cache_key in self._runners:
            runner = self._runners[cache_key]
            if self.mesh is None:
                return runner(state, base_key, t0)
            return runner(self.shard_state(state), base_key, t0)

        step = self.step_factory(axis)

        def local_until(state, key, t0):
            rc0 = rhat_init(
                position_fn(state).shape[0], d, dtype)

            def one_step(carry, t):
                s, rc = carry
                s, _ = step(s, step_key(key, t), t)
                rc = rhat_update(rc, position_fn(s))
                return (s, rc), None

            def pergen_chunk(args):
                s, rc, t_start = args
                ts = t_start + jnp.arange(chunk, dtype=jnp.int32)
                (s, rc), _ = lax.scan(one_step, (s, rc), ts)
                return s, rc

            def fused_chunk(args):
                s, rc, t_start = args
                s, hist = chunk_runner(s, key, chunk, t_start)
                if isinstance(hist, dict) and "rhat" in hist:
                    # collect="rhat" runner: moments folded inside the
                    # runner's own scan (O(G*n*d) live bytes instead of
                    # the full [chunk, n, d] history) — merge its carry
                    return s, rhat_merge(rc, hist["rhat"])
                if not (isinstance(hist, dict) and "x" in hist):
                    raise ValueError(
                        "run_until needs the fused runner's position "
                        "history (collect='all') or streamed moments "
                        "(collect='rhat') to fold R-hat — collect="
                        "'stats' provides neither")
                return s, rhat_update_block(rc, hist["x"])

            def body(loop):
                s, rc, ci, _ = loop
                # reset the monitored window when warmup ends
                rc = jax.tree_util.tree_map(
                    lambda z: jnp.where(ci == warmup_chunks,
                                        jnp.zeros_like(z), z), rc)
                t_start = t0 + ci * chunk
                if chunk_runner is None:
                    s, rc = pergen_chunk((s, rc, t_start))
                else:
                    s, rc = lax.cond(
                        t_start >= fused_after, fused_chunk,
                        pergen_chunk, (s, rc, t_start))
                # lax.cond, not jnp.where: rhat_compute all_gathers the
                # moments on the mesh path, and where() evaluates both
                # operands — warmup chunks would pay the collectives
                # just to discard the result
                rhat = lax.cond(
                    ci >= warmup_chunks,
                    lambda c: rhat_compute(c, n_total, axis),
                    lambda c: jnp.full((d,), jnp.inf, dtype), rc)
                return (s, rc, ci + 1, rhat)

            def cond(loop):
                _, _, ci, rhat = loop
                return (ci < max_chunks) & (jnp.max(rhat) >= rhat_tol)

            init = (state, rc0, jnp.zeros((), jnp.int32),
                    jnp.full((d,), jnp.inf, dtype))
            s, rc, ci, rhat = lax.while_loop(cond, body, init)
            return s, {"steps": ci * chunk, "rhat": rhat,
                       "mean": rc.mean, "var": rc.m2 /
                       jnp.maximum(rc.n - 1.0, 1.0)}

        if self.mesh is None:
            runner = jax.jit(local_until)
            self._runners[cache_key] = runner
            return runner(state, base_key, t0)

        state_specs = _state_specs(state, self.sharded_fields, axis)
        info_specs = {"steps": P(), "rhat": P(),
                      "mean": P(axis, None), "var": P(axis, None)}
        runner = jax.jit(jax.shard_map(
            local_until, mesh=self.mesh,
            in_specs=(state_specs, P(), P()),
            out_specs=(state_specs, info_specs),
            check_vma=False))
        self._runners[cache_key] = runner
        return runner(self.shard_state(state), base_key, t0)
