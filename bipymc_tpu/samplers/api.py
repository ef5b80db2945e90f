"""User-facing sampler classes with the reference's ergonomics.

The reference API is ``sampler = Sampler(log_like_fn, ...);
sampler.run_mcmc(n, theta_0)``; results via ``sampler.chain`` /
``sampler.super_chain`` (SURVEY.md §2 L3/L6). These thin wrappers keep that
shape while the real engine is the pure-functional core: ``lax.scan`` over
jitted steps, chains as a batch axis, optional device-mesh sharding.

Classes mirror the reference zoo 1:1 (SURVEY.md §3):
``Metropolis``/``AdaptiveMetropolis``/``DrMetropolis``/``Dram`` (single-chain
family, vmapped over ``n_chains``), ``DeMc`` (population DE-MC), ``DeMcZ`` /
``DreamZs`` (archive-based ensemble; pass ``mesh=`` to shard chains over
devices — the mpi4py-pool replacement) — plus two beyond-reference extras:
``Dream`` (population-DREAM, Vrugt 2009) and ``EnsembleSampler``
(Goodman-Weare affine-invariant stretch move).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np

from bipymc_tpu.core.scan import run_scan_thinned
from bipymc_tpu.ops.route import interpret_mode
from bipymc_tpu.samplers import (rw, chees, da, demc, dream, enslice,
                                 eslice, flowmh, hmc, nuts, stretch,
                                 tempering)
from bipymc_tpu.parallel.pool import ChainPool
from bipymc_tpu.utils.init import var_ball
from bipymc_tpu.utils.diagnostics import acceptance_fraction


def _rw_position(s):
    """Stable position_fn identity for the RW family's run_until cache."""
    return s.theta


def _pt_cold_position(s):
    """Cold-replica positions for ParallelTempering's run_until."""
    return tempering.positions(s.kernel)[0]


def _check_mesh_chains(mesh, n_chains):
    """Fail at CONSTRUCTION when the chain count cannot shard over the
    mesh (the pool would raise the same thing at the first run_mcmc,
    after the user already built the sampler)."""
    if mesh is not None:
        n_dev = int(mesh.devices.size)
        if int(n_chains) % n_dev != 0:
            raise ValueError(
                f"n_chains={n_chains} must be divisible by the mesh's "
                f"{n_dev} devices")


def _as_2d_theta0(theta_0, n_chains, key, spread, dtype):
    """Accept [d] (dispersed via var_ball) or [M, d] starting points."""
    theta_0 = jnp.asarray(theta_0, dtype=dtype)
    if theta_0.ndim == 1:
        if n_chains == 1:
            return theta_0[None, :]
        var = jnp.full((theta_0.shape[-1],), spread ** 2, dtype=dtype)
        return var_ball(key, var, n_chains, center=theta_0, dtype=dtype)
    if theta_0.shape[0] != n_chains:
        raise ValueError(
            f"theta_0 has {theta_0.shape[0]} rows but n_chains={n_chains}")
    return theta_0


class McmcSampler:
    """Base: history access + acceptance stats shared by all samplers."""

    def __init__(self, log_like_fn, seed=0, dtype=jnp.float32):
        self.log_like_fn = log_like_fn
        self.seed = int(seed)
        self.dtype = dtype
        # history accumulates as a list of device-resident chunks (one per
        # run_mcmc call); host concatenation is deferred to first access.
        # Eager device concatenation per run cost ~12x the sampling time on
        # a remote-device path, so the hot loop never touches history.
        self._chunks = []          # each: dict of [T, M, ...] device arrays
        self._chunk_meta = []      # per chunk: (t0, thin, n_kept)
        self._history_np = None    # host cache: dict of np arrays
        self._super_chain_np = None
        self._final_state = None
        self._steps_run = 0

    # -- results ----------------------------------------------------------
    @property
    def _history(self):
        """Full kept history as host NumPy (fetched once per run)."""
        self._require_run()
        if self._history_np is None:
            if len(self._chunks) == 1:
                self._history_np = {k: np.asarray(v)
                                    for k, v in self._chunks[0].items()}
            else:
                self._history_np = {
                    k: np.concatenate(
                        [np.asarray(c[k]) for c in self._chunks], axis=0)
                    for k in self._chunks[0]}
            # drop device buffers once the host copy exists
            self._chunks = [self._history_np]
        return self._history_np

    @property
    def chain(self):
        """History of chain 0 as host NumPy, shape [n_kept, d]."""
        return np.asarray(self._history["x"][:, 0, :])

    @property
    def super_chain(self):
        """All chains, [n_chains, n_kept, d] (host NumPy, fetched once —
        the device→host transfer is cached until the next run_mcmc)."""
        if self._super_chain_np is None:
            self._super_chain_np = np.ascontiguousarray(
                np.swapaxes(self._history["x"], 0, 1))
        return self._super_chain_np

    @property
    def flat_chain(self):
        """All chains concatenated, [n_chains * n_kept, d]."""
        sc = self.super_chain
        return sc.reshape(-1, sc.shape[-1])

    def get_chain(self, discard=0, thin=1, flat=False):
        sc = self.super_chain[:, discard::thin, :]
        return sc.reshape(-1, sc.shape[-1]) if flat else sc

    @property
    def acceptance_fraction(self):
        """Per-chain acceptance fraction over the kept history."""
        acc = np.swapaxes(self._history["accepted"], 0, 1)
        return np.asarray(acceptance_fraction(acc))

    @staticmethod
    def _host_compute():
        """Post-run diagnostics on the host CPU backend (the history is
        already host NumPy — don't round-trip it through the device
        link); no-op when no CPU backend exists."""
        from bipymc_tpu.utils.diagnostics import host_compute
        return host_compute()

    def summary(self, discard=0, as_text=False):
        """Per-dimension posterior summary of the kept history:
        mean/sd/5-50-95% quantiles/rank-normalised R̂/per-dim ESS
        (utils.diagnostics.summary, computed on the host CPU backend).
        ``as_text=True`` returns a printable table instead of the dict
        of host arrays."""
        from bipymc_tpu.utils.diagnostics import summary as _summary
        with self._host_compute():
            s = {k: np.asarray(v) for k, v in
                 _summary(
                     jnp.asarray(self.get_chain(discard=discard))).items()}
        if not as_text:
            return s
        cols = ["mean", "sd", "mcse_mean", "q05", "q50", "q95", "rhat",
                "ess", "ess_bulk", "ess_tail"]
        lines = ["dim  " + "".join(f"{c:>10}" for c in cols)]
        for i in range(s["mean"].shape[0]):
            lines.append(f"{i:<5}" + "".join(
                f"{float(s[c][i]):>10.3f}" for c in cols))
        return "\n".join(lines)

    def get_autocorr_time(self, discard=0, c=5.0):
        """Integrated autocorrelation time τ of the kept history (emcee-
        style auto-windowed estimate, SURVEY.md §4.8)."""
        from bipymc_tpu.utils.diagnostics import integrated_autocorr_time
        with self._host_compute():
            return float(integrated_autocorr_time(
                self.get_chain(discard=discard), c=c))

    @property
    def final_state(self):
        """Sampler state pytree (for checkpoint/resume). Available after
        ``run_mcmc`` OR ``run_mcmc_until`` (the latter keeps no history,
        but its final state is checkpointable)."""
        if self._final_state is None:
            raise RuntimeError("call run_mcmc or run_mcmc_until first")
        return self._final_state

    @staticmethod
    def _run_fused_segment(runner, cache, state, k_run, n, t0):
        """Shared jit-cache for fused multi-step segments: ONE compiled
        executable per segment length n, with t0 riding as a traced
        int32 so continuations at any offset reuse it. All three fused
        families (_RwSampler, DreamZs, FlowMh) route here, so the
        round-2 "fresh closure defeats the jit cache" bug class lives
        in exactly one place."""
        if n not in cache:
            cache[n] = jax.jit(lambda s, k, t, _n=n: runner(s, k, _n, t))
        return cache[n](state, k_run, jnp.asarray(t0, jnp.int32))

    def reset(self):
        """Discard run state (history, final state, step counter) while
        KEEPING compiled runners/pools — a subsequent run re-samples from
        scratch without paying compilation again (benchmark harnesses)."""
        self._chunks = []
        self._chunk_meta = []
        self._history_np = None
        self._super_chain_np = None
        self._final_state = None
        self._steps_run = 0
        return self

    def _require_run(self):
        if not self._chunks:
            raise RuntimeError("call run_mcmc first")

    def _continuing(self, theta_0, cov_est=None, spread=1.0):
        """Continuation contract: after a run, further run_mcmc* calls
        continue from ``final_state`` and IGNORE start-only arguments.
        Pass ``theta_0=None`` to continue silently; passing values warns
        (they used to be ignored with no signal — round-2 verdict #6).
        Call ``reset()`` first to start fresh from a new ``theta_0``."""
        if self._final_state is None:
            if theta_0 is None:
                raise ValueError(
                    "theta_0 is required for the first run (no state to "
                    "continue from)")
            return False
        ignored = [name for name, v in
                   (("theta_0", theta_0), ("cov_est", cov_est))
                   if v is not None]
        if spread != 1.0:
            ignored.append("spread")
        if ignored:
            warnings.warn(
                f"continuing from the previous run's state: {ignored} "
                "only affect a fresh start and are IGNORED. Pass "
                "theta_0=None to continue silently, or call reset() to "
                "restart from a new start point.", UserWarning, stacklevel=3)
        return True

    def _ensure_population(self, theta_0, spread, init_fn, step_factory,
                           sharded_fields, collect_fn=None):
        """Shared population-sampler setup: resolve the start state
        (fresh init or continuation) and lazily build the ChainPool.
        Returns (state, run_key)."""
        key = jax.random.key(self.seed)
        k_init, k_run = jax.random.split(key)
        if self._continuing(theta_0, spread=spread):
            state = self._final_state
        else:
            state = init_fn(_as_2d_theta0(theta_0, self.n_chains, k_init,
                                          spread, self.dtype))
        if getattr(self, "_pool_obj", None) is None:
            self._pool_obj = ChainPool(step_factory=step_factory,
                                       sharded_fields=sharded_fields,
                                       mesh=self.mesh,
                                       collect_fn=collect_fn)
        return state, k_run

    def _store(self, final_state, history, n_steps, thin=1):
        # (start step, thin, kept rows) per chunk — diagnostics that need
        # the GLOBAL step index of each kept row (e.g. PT swap rounds)
        # reconstruct it from this, valid for any thin / continuation mix
        self._chunk_meta.append(
            (self._steps_run, int(thin), n_steps // int(thin)))
        self._final_state = final_state
        # block once so wall-clock timing by callers is honest; the chunk
        # stays device-resident — no concatenation in the hot path
        self._chunks.append(jax.block_until_ready(history))
        self._history_np = None          # invalidate host caches
        self._super_chain_np = None
        self._steps_run += n_steps


# ===========================================================================
# Single-chain random-walk family (vmapped over chains)
# ===========================================================================

class _RwSampler(McmcSampler):
    _make_config = staticmethod(rw.metropolis_config)

    def __init__(self, log_like_fn, seed=0, n_chains=1, dtype=jnp.float32,
                 fused=False, log_prob_block=None, **config_kw):
        """``fused=True`` routes aligned steady segments through the fused
        multi-step engine (samplers/rw_fused.py: K steps per Pallas
        kernel, K = ``adapt_interval`` for the adaptive family, AM
        adaptation replayed bit-exactly outside the kernel). Same bits
        stream and accept decisions as the per-step engine; positions
        match to float re-association. On the GPU the in-kernel target
        is ``log_prob_block``, a padded block form (models/targets.py
        ``*_block``); construction raises without one."""
        super().__init__(log_like_fn, seed=seed, dtype=dtype)
        self.n_chains = int(n_chains)
        self.cfg = self._make_config(**config_kw)
        self._batched_step = None
        self._runners = {}     # (n_samples, thin, progress_every) -> jit fn
        self.fused = bool(fused)
        self._log_prob_block = log_prob_block
        self._rw_fused_runner = None
        self._rw_fused_jits = {}
        if self.fused:
            from bipymc_tpu.samplers.rw_fused import check_rw_fusable
            check_rw_fusable(self.cfg)
            _check_fused_target(log_prob_block)

    @property
    def _fused_K(self):
        return int(self.cfg.adapt_interval) if self.cfg.adapt else 100

    @staticmethod
    def _collect(state, info):
        return {"x": state.theta, "logp": info.logp,
                "accepted": info.accepted}

    def _ensure_rw_fused_runner(self):
        if self._rw_fused_runner is None:
            from bipymc_tpu.samplers.rw_fused import make_rw_chunk_runner
            self._rw_fused_runner = make_rw_chunk_runner(
                self.log_like_fn, self.cfg, self.n_chains,
                log_prob_block=self._log_prob_block,
                chunk_steps=self._fused_K)
        return self._rw_fused_runner

    def _rw_fused(self, state, k_run, n_steps, t0):
        """Jit-cached fused-engine segment (shared base-class cache)."""
        return self._run_fused_segment(
            self._ensure_rw_fused_runner(), self._rw_fused_jits,
            state, k_run, n_steps, t0)

    def _prepare(self, theta_0, cov_est, spread):
        """Resolve start state + batched step; returns (state, step, key)."""
        key = jax.random.key(self.seed)
        k_init, k_run = jax.random.split(key)
        if self._continuing(theta_0, cov_est, spread):
            state = self._final_state
        else:
            theta0 = _as_2d_theta0(theta_0, self.n_chains, k_init, spread,
                                   self.dtype)
            d = theta0.shape[-1]
            if cov_est is None:
                cov_est = jnp.eye(d, dtype=self.dtype) * spread ** 2
            cov_est = jnp.asarray(cov_est, dtype=self.dtype)
            state = jax.vmap(lambda t: rw.init(t, self.log_like_fn, cov_est)
                             )(theta0)

        if self._batched_step is None:
            step = rw.make_step(self.log_like_fn, self.cfg)

            def batched_step(state, key, t):
                keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
                    jnp.arange(self.n_chains))
                return jax.vmap(step, in_axes=(0, 0, None))(state, keys, t)

            self._batched_step = batched_step
        return state, self._batched_step, k_run

    def run_mcmc(self, n_samples, theta_0=None, cov_est=None, thin=1,
                 spread=1.0, progress_every=None):
        """Run ``n_samples`` steps from ``theta_0`` ([d] or [n_chains, d]).

        cov_est: initial proposal covariance ([d] diagonal or [d,d];
        default: identity scaled by ``spread``).
        progress_every: host progress line every k kept steps (step index +
        mean acceptance; off by default — callbacks serialise the stream).
        """
        state, batched_step, k_run = self._prepare(theta_0, cov_est, spread)
        collect = self._collect

        use_fused = (self.fused and thin == 1 and progress_every is None)
        if use_fused:
            # [per-step alignment] -> [fused K-step chunks] -> [per-step
            # remainder]; mirrors DreamZs.run_mcmc's segment split. For
            # the adaptive family chunk starts must sit on refresh
            # boundaries (t % K == 0); MH/DR are homogeneous so only the
            # chunk-length divisibility matters.
            K = self._fused_K
            t = self._steps_run
            n1 = (K - t % K) % K if self.cfg.adapt else 0
            n1 = min(n1, n_samples)
            n2 = ((n_samples - n1) // K) * K
            n3 = n_samples - n1 - n2
            segs = []
            if n1:
                segs.append(("pergen", n1))
            if n2:
                segs.append(("fused", n2))
            if n3:
                segs.append(("pergen", n3))
            for kind, n_seg in segs:
                t = self._steps_run
                if kind == "fused":
                    final_state, history = self._rw_fused(
                        state, k_run, n_seg, t)
                else:
                    cache_key = (n_seg, 1, None)
                    if cache_key not in self._runners:
                        self._runners[cache_key] = jax.jit(
                            lambda state, key, t0, _n=n_seg:
                            run_scan_thinned(
                                batched_step, state, key, n_steps=_n,
                                thin=1, collect_fn=collect, t0=t0))
                    final_state, history = self._runners[cache_key](
                        state, k_run, jnp.asarray(t, jnp.int32))
                self._store(final_state, history, n_seg, thin=1)
                state = self._final_state
            return self

        cache_key = (n_samples, thin, progress_every)
        if cache_key not in self._runners:
            self._runners[cache_key] = jax.jit(
                lambda state, key, t0: run_scan_thinned(
                    batched_step, state, key, n_steps=n_samples, thin=thin,
                    collect_fn=collect, t0=t0,
                    progress_every=progress_every))
        final_state, history = self._runners[cache_key](
            state, k_run, jnp.asarray(self._steps_run, jnp.int32))
        self._store(final_state, history, n_samples, thin=thin)
        return self

    def run_mcmc_until(self, theta_0=None, cov_est=None, rhat_tol=1.05,
                       chunk=100, max_chunks=200, warmup_chunks=2,
                       spread=1.0):
        """Run until streaming on-device R̂ across the vmapped chains drops
        below ``rhat_tol`` (same machinery as the ensemble samplers;
        requires n_chains ≥ 2). Returns info dict (steps/rhat/mean/var)."""
        if self.n_chains < 2:
            raise ValueError("R-hat early stop needs n_chains >= 2")
        state, batched_step, k_run = self._prepare(theta_0, cov_est, spread)
        chunk_runner = None
        if self.fused:
            # round the chunk UP to a multiple of K (the runner executes
            # in K-step kernels). For adaptive kernels every chunk start
            # must also sit on an AM refresh boundary, so an unaligned
            # continuation offset falls back to the per-step engine
            # (same policy as DreamZs.run_mcmc_until); non-adaptive
            # kernels (MH/DR: runner.align == 1) fuse from any offset.
            K = self._fused_K
            if chunk % K:
                chunk += K - chunk % K
            if not self.cfg.adapt or self._steps_run % K == 0:
                chunk_runner = self._ensure_rw_fused_runner()
        if getattr(self, "_until_pool", None) is None:
            self._until_pool = ChainPool(
                step_factory=lambda axis: batched_step,
                sharded_fields=("theta",), mesh=None)
        final_state, info = self._until_pool.run_until(
            state, k_run, rhat_tol=rhat_tol, chunk=chunk,
            max_chunks=max_chunks, warmup_chunks=warmup_chunks,
            position_fn=_rw_position, t0=self._steps_run,
            chunk_runner=chunk_runner, fused_after=0)
        self._final_state = jax.block_until_ready(final_state)
        self._steps_run += int(info["steps"])
        return {k: np.asarray(v) for k, v in info.items()}


class Metropolis(_RwSampler):
    """Metropolis-Hastings with Gaussian random walk (SURVEY.md §4.1)."""
    _make_config = staticmethod(rw.metropolis_config)


class AdaptiveMetropolis(_RwSampler):
    """Haario adaptive Metropolis (SURVEY.md §4.2)."""
    _make_config = staticmethod(rw.adaptive_metropolis_config)


class DrMetropolis(_RwSampler):
    """Two-stage delayed-rejection Metropolis (SURVEY.md §4.3)."""
    _make_config = staticmethod(rw.dr_metropolis_config)


class Dram(_RwSampler):
    """DRAM = delayed rejection ⊗ adaptive Metropolis (SURVEY.md §4.4)."""
    _make_config = staticmethod(rw.dram_config)


class DelayedAcceptance(_RwSampler):
    """Delayed-acceptance Metropolis (Christen & Fox 2005; samplers/da.py)
    — beyond-reference. A cheap surrogate log-likelihood pre-screens every
    proposal; only surrogate-promoted proposals evaluate the EXACT
    likelihood, and the chain targets the exact posterior (zero surrogate
    bias, unlike sampling the surrogate directly). Stage-1 proposal
    adapts with Haario AM by default (``adapt=False`` to disable).

    masked_exact=True: ``log_like_fn(theta, promoted_mask)`` — pair with
    ``utils.external.external_log_like_masked`` so a host-side simulator
    is only invoked on the promoted rows of each vmapped step.
    """
    _make_config = staticmethod(da.da_config)

    def __init__(self, log_like_fn, surrogate_log_like_fn, seed=0,
                 n_chains=1, dtype=jnp.float32, masked_exact=False,
                 **config_kw):
        super().__init__(log_like_fn, seed=seed, n_chains=n_chains,
                         dtype=dtype, **config_kw)
        self.surrogate_log_like_fn = surrogate_log_like_fn
        self.masked_exact = bool(masked_exact)

    @staticmethod
    def _collect(state, info):
        return {"x": state.theta, "logp": info.logp,
                "accepted": info.accepted, "promoted": info.promoted}

    def _prepare(self, theta_0, cov_est, spread):
        key = jax.random.key(self.seed)
        k_init, k_run = jax.random.split(key)
        if self._continuing(theta_0, cov_est, spread):
            state = self._final_state
        else:
            theta0 = _as_2d_theta0(theta_0, self.n_chains, k_init, spread,
                                   self.dtype)
            d = theta0.shape[-1]
            if cov_est is None:
                cov_est = jnp.eye(d, dtype=self.dtype) * spread ** 2
            cov_est = jnp.asarray(cov_est, dtype=self.dtype)
            state = jax.vmap(lambda t: da.init(
                t, self.log_like_fn, self.surrogate_log_like_fn, cov_est,
                masked=self.masked_exact))(theta0)

        if self._batched_step is None:
            step = da.make_step(self.log_like_fn, self.surrogate_log_like_fn,
                                self.cfg, masked=self.masked_exact)

            def batched_step(state, key, t):
                keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
                    jnp.arange(self.n_chains))
                return jax.vmap(step, in_axes=(0, 0, None))(state, keys, t)

            self._batched_step = batched_step
        return state, self._batched_step, k_run

    @property
    def promotion_fraction(self):
        """Per-chain fraction of steps whose proposal was promoted to an
        exact-likelihood evaluation (= the exact-call rate DA saves you
        down from 1.0)."""
        pro = np.swapaxes(self._history["promoted"], 0, 1)
        return np.asarray(acceptance_fraction(pro))


# ===========================================================================
# Population / ensemble samplers
# ===========================================================================

class ParallelTempering(McmcSampler):
    """Replica-exchange MCMC (beyond-reference extra,
    samplers/tempering.py): ``n_temps`` tempered replicas of ``n_chains``
    chains each, adjacent-pair swaps every ``swap_interval`` steps.
    ``kind`` picks the within-temperature kernel: the RW family
    ("mh"/"am"/"dr"/"dram") or — round 3 — the gradient family
    ("hmc"/"mala", tempered leapfrog kernels with per-replica dual
    averaging and mass adaptation; needs a differentiable target).
    History exposes the cold (β=1) replica. ``mesh=`` shards the CHAIN
    axis over devices (every shard keeps the full temperature ladder, so
    swaps stay local; trajectories are bit-identical to the vmap path
    for the RW family, and follow the gradient family's equivalence
    contract — hmc.py docstring — for "hmc"/"mala")."""

    _KINDS = {"mh": rw.metropolis_config, "am": rw.adaptive_metropolis_config,
              "dr": rw.dr_metropolis_config, "dram": rw.dram_config,
              # gradient kernels (round 3): tempered leapfrog replicas —
              # needs a jax.grad-able target; cov_est's diagonal seeds
              # the inverse mass
              "hmc": hmc.hmc_config, "mala": hmc.mala_config}

    def __init__(self, log_like_fn, n_temps=8, n_chains=4, betas=None,
                 beta_min=0.05, swap_interval=10, kind="dram", seed=0,
                 dtype=jnp.float32, mesh=None, **kernel_kw):
        super().__init__(log_like_fn, seed=seed, dtype=dtype)
        self.mesh = mesh
        _check_mesh_chains(mesh, n_chains)
        self._ctor_kw = dict(n_chains=n_chains, swap_interval=swap_interval,
                             kind=kind, dtype=dtype, mesh=mesh, **kernel_kw)
        if betas is None:
            betas = tempering.geometric_ladder(n_temps, beta_min)
        if abs(betas[0] - 1.0) > 1e-6 or list(betas) != sorted(
                betas, reverse=True):
            raise ValueError("betas must be descending with betas[0]=1")
        if betas[-1] <= 0:
            raise ValueError(
                "betas must be positive: beta=0 samples a flat (improper) "
                "density under plain tempering — use a small beta_min, or, "
                "for a prior-anchored beta=0 rung (marginal-likelihood "
                "estimation), bp.power_posterior_evidence "
                "(utils/evidence.py)")
        self.n_chains = int(n_chains)
        self.n_temps = len(betas)
        self.cfg = tempering.PtConfig(
            betas=tuple(float(b) for b in betas),
            swap_interval=int(swap_interval),
            kernel=self._KINDS[kind](**kernel_kw))

    def _pt_prepare(self, theta_0, cov_est, spread):
        """Resolve start state (fresh ladder init or continuation)."""
        key = jax.random.key(self.seed)
        k_init, k_run = jax.random.split(key)
        if self._continuing(theta_0, cov_est, spread):
            return self._final_state, k_run
        flat0 = _as_2d_theta0(theta_0, self.n_temps * self.n_chains,
                              k_init, spread, self.dtype)
        d = flat0.shape[-1]
        theta0 = flat0.reshape(self.n_temps, self.n_chains, d)
        if cov_est is None:
            cov_est = jnp.eye(d, dtype=self.dtype) * spread ** 2
        cov_est = jnp.asarray(cov_est, dtype=self.dtype)
        return (tempering.init(theta0, self.log_like_fn, self.cfg, cov_est),
                k_run)

    def _pt_pool(self):
        if getattr(self, "_pool_obj", None) is None:
            def collect(state, info):
                # cold replica history; pair_swap kept for the whole
                # ladder (the per-interface diagnostic needs every
                # temperature) — chains moved to the leading axis so the
                # pool's history sharding (chains at dim 1 of [T, ...])
                # holds for every leaf
                return {"x": tempering.positions(state.kernel)[0],
                        "logp": info.logp[0],
                        "accepted": info.accepted[0],
                        "swapped": info.swapped[0],
                        "pair_swap": jnp.swapaxes(info.pair_swap, 0, 1)}

            self._pool_obj = ChainPool(
                step_factory=lambda axis: tempering.make_step(
                    self.log_like_fn, self.cfg, axis_name=axis),
                sharded_fields=("kernel@1", "direction@1"),
                mesh=self.mesh, collect_fn=collect)
        return self._pool_obj

    def run_mcmc(self, n_samples, theta_0=None, cov_est=None, thin=1,
                 spread=1.0):
        state, k_run = self._pt_prepare(theta_0, cov_est, spread)
        final_state, history = self._pt_pool().run(
            state, k_run, n_samples, thin=thin, t0=self._steps_run)
        self._store(final_state, history, n_samples, thin=thin)
        return self

    def run_mcmc_until(self, theta_0=None, cov_est=None, rhat_tol=1.05,
                       chunk=100, max_chunks=200, warmup_chunks=2,
                       spread=1.0):
        """Run until the COLD replica's streaming R̂ < rhat_tol (same
        stopping machinery as the ensemble samplers). Returns an info
        dict (steps/rhat/mean/var over the cold replica's chains)."""
        if self.n_chains < 2:
            raise ValueError("R-hat early stop needs n_chains >= 2")
        state, k_run = self._pt_prepare(theta_0, cov_est, spread)
        final_state, info = self._pt_pool().run_until(
            state, k_run, rhat_tol=rhat_tol, chunk=chunk,
            max_chunks=max_chunks, warmup_chunks=warmup_chunks,
            position_fn=_pt_cold_position, t0=self._steps_run)
        self._final_state = jax.block_until_ready(final_state)
        self._steps_run += int(info["steps"])
        return {k: np.asarray(v) for k, v in info.items()}

    @property
    def swap_fraction(self):
        """Fraction of cold-replica steps that swapped (post-run)."""
        self._require_run()
        return float(np.mean(np.asarray(self._history["swapped"])))

    @property
    def swap_rates(self):
        """Per-interface swap acceptance, shape [n_temps-1]: entry k is
        the accepted fraction of attempted (k, k+1) swaps. The DEO
        schedule attempts pair k only on swap rounds whose parity matches
        k, so attempts are counted per pair."""
        self._require_run()
        # [T, M, K] (chains at dim 1 for pool history sharding)
        ps = np.asarray(self._history["pair_swap"])
        interval = self.cfg.swap_interval
        # GLOBAL step index of every kept history row: with thin > 1 the
        # kept rows are t0 + k·thin + (thin−1), NOT the last T integers —
        # assuming the latter silently mis-assigned swap rounds
        ts = np.concatenate([
            t0 + np.arange(n_kept) * thin + (thin - 1)
            for (t0, thin, n_kept) in self._chunk_meta])
        assert ts.shape[0] == ps.shape[0]
        is_round = (ts % interval) == interval - 1
        parity = (ts // interval) % 2
        rates = np.zeros(self.n_temps - 1)
        for k in range(self.n_temps - 1):
            attempted = is_round & (parity == k % 2)
            n_att = attempted.sum() * ps.shape[1]
            rates[k] = (ps[attempted, :, k].sum() / n_att if n_att else
                        np.nan)
        return rates

    @property
    def round_trips(self):
        """Completed cold→hot→cold walker round trips (total, all chains).
        The round-trip rate (trips per swap round per chain) is THE
        ladder-quality metric: near zero means the ladder has a choke
        point (check swap_rates for the weak interface)."""
        return int(np.asarray(self.final_state.trips))

    @property
    def round_trip_rate(self):
        """Round trips per swap round per chain slot."""
        n_rounds = max(self._steps_run // self.cfg.swap_interval, 1)
        return self.round_trips / (n_rounds * self.n_chains)

    def tune_ladder(self, theta_0, n_pilot=3000, cov_est=None, spread=1.0,
                    seed=None):
        """Pilot-run this ladder, equalise the measured rejection profile
        (tempering.tune_ladder — Syed et al. 2021 schedule tuning), and
        return a FRESH ParallelTempering on the re-spaced ladder. This
        sampler is left untouched; iterate for further rounds."""
        pilot = ParallelTempering(
            self.log_like_fn, betas=self.cfg.betas,
            seed=self.seed if seed is None else seed, **self._ctor_kw)
        pilot.run_mcmc(n_pilot, theta_0, cov_est=cov_est, spread=spread)
        rates = pilot.swap_rates
        if np.any(np.isnan(rates)):
            raise ValueError(
                "pilot run attempted no swaps at some interfaces "
                f"(swap_rates={rates}); raise n_pilot or lower "
                "swap_interval so every parity gets swap rounds")
        new_betas = tempering.tune_ladder(self.cfg.betas, rates)
        return ParallelTempering(
            self.log_like_fn, betas=new_betas, seed=self.seed,
            **self._ctor_kw)


class DeMc(McmcSampler):
    """ter Braak DE-MC over a synchronous population (SURVEY.md §4.5)."""

    def __init__(self, log_like_fn, n_chains=8, seed=0, dtype=jnp.float32,
                 mesh=None, **config_kw):
        super().__init__(log_like_fn, seed=seed, dtype=dtype)
        self.n_chains = int(n_chains)
        self.cfg = demc.DeMcConfig(n_chains=self.n_chains, **config_kw)
        self.mesh = mesh
        _check_mesh_chains(mesh, self.n_chains)

    def _ensure(self, theta_0, spread):
        return self._ensure_population(
            theta_0, spread,
            init_fn=lambda x0: demc.init(x0, self.log_like_fn),
            step_factory=lambda axis: demc.make_step(
                self.log_like_fn, self.cfg, axis_name=axis),
            sharded_fields=("x", "logp"))

    def run_mcmc(self, n_gens, theta_0=None, thin=1, spread=1.0,
                 progress_every=None):
        state, k_run = self._ensure(theta_0, spread)
        final_state, history = self._pool_obj.run(
            state, k_run, n_gens, thin=thin, t0=self._steps_run,
            progress_every=progress_every)
        self._store(final_state, history, n_gens, thin=thin)
        return self

    def run_mcmc_until(self, theta_0=None, rhat_tol=1.05, chunk=100,
                       max_chunks=200, warmup_chunks=2, spread=1.0):
        """Run until streaming on-device R̂ < rhat_tol (same machinery as
        DreamZs.run_mcmc_until)."""
        state, k_run = self._ensure(theta_0, spread)
        final_state, info = self._pool_obj.run_until(
            state, k_run, rhat_tol=rhat_tol, chunk=chunk,
            max_chunks=max_chunks, warmup_chunks=warmup_chunks,
            t0=self._steps_run)
        self._final_state = jax.block_until_ready(final_state)
        self._steps_run += int(info["steps"])
        return {k: np.asarray(v) for k, v in info.items()}


class Hmc(McmcSampler):
    """Hamiltonian Monte Carlo with dual-averaging step-size and diagonal
    mass adaptation — beyond-reference extra (samplers/hmc.py; the
    reference zoo has no gradient sampler). Needs a differentiable
    ``log_like_fn`` (``jax.grad``-able; the GP surrogate likelihood
    qualifies). Chains are fully independent, so ``mesh=`` shards with
    zero in-step collectives (sharding-equivalence contract: see the
    samplers/hmc.py module docstring)."""

    _make_config = staticmethod(hmc.hmc_config)

    def __init__(self, log_like_fn, n_chains=8, seed=0, dtype=jnp.float32,
                 mesh=None, inv_mass0=None, **config_kw):
        super().__init__(log_like_fn, seed=seed, dtype=dtype)
        self.n_chains = int(n_chains)
        self.cfg = self._make_config(**config_kw)
        self.mesh = mesh
        self.inv_mass0 = inv_mass0
        _check_mesh_chains(mesh, self.n_chains)

    def _ensure(self, theta_0, spread):
        return self._ensure_population(
            theta_0, spread,
            init_fn=lambda x0: hmc.init(x0, self.log_like_fn, self.cfg,
                                        inv_mass0=self.inv_mass0),
            step_factory=lambda axis: hmc.make_step(
                self.log_like_fn, self.cfg, axis_name=axis),
            sharded_fields=hmc.SHARDED_FIELDS)

    def run_mcmc(self, n_samples, theta_0=None, thin=1, spread=1.0,
                 progress_every=None):
        state, k_run = self._ensure(theta_0, spread)
        final_state, history = self._pool_obj.run(
            state, k_run, n_samples, thin=thin, t0=self._steps_run,
            progress_every=progress_every)
        self._store(final_state, history, n_samples, thin=thin)
        return self

    def run_mcmc_until(self, theta_0=None, rhat_tol=1.05, chunk=100,
                       max_chunks=200, warmup_chunks=2, spread=1.0):
        if self.n_chains < 2:
            raise ValueError("R-hat early stop needs n_chains >= 2")
        state, k_run = self._ensure(theta_0, spread)
        final_state, info = self._pool_obj.run_until(
            state, k_run, rhat_tol=rhat_tol, chunk=chunk,
            max_chunks=max_chunks, warmup_chunks=warmup_chunks,
            t0=self._steps_run)
        self._final_state = jax.block_until_ready(final_state)
        self._steps_run += int(info["steps"])
        return {k: np.asarray(v) for k, v in info.items()}

    @property
    def step_size(self):
        """Per-chain ε after the last run (ε̄ once warmup has frozen)."""
        s = self.final_state
        t = self._steps_run
        frozen = t >= self.cfg.adapt_gens
        return np.asarray(jnp.exp(s.log_eps_bar if frozen else s.log_eps))


class Mala(Hmc):
    """Metropolis-adjusted Langevin — HMC with one leapfrog step
    (samplers/hmc.mala_config; 0.574 optimal-scaling accept target)."""

    _make_config = staticmethod(hmc.mala_config)


def _nuts_collect(state, info):
    """NUTS history keeps the tree telemetry next to the defaults:
    ``tree_depth``/``n_leapfrog`` are the self-tuning diagnostics (depth
    0-1 = step size too large; pinned at max_depth = too small or
    pathological geometry), ``diverged`` flags energy-cliff trajectories
    (Stan's divergence diagnostic). Module-level for a stable pool-cache
    identity (see _default_position's lesson, parallel/pool.py)."""
    return {"x": state.x, "logp": info.logp, "accepted": info.accepted,
            "tree_depth": info.tree_depth, "n_leapfrog": info.n_leapfrog,
            "diverged": info.diverged}


class Nuts(Hmc):
    """No-U-Turn Sampler (multinomial NUTS, iterative checkpoint
    formulation — samplers/nuts.py). Beyond-reference extra: HMC with
    the trajectory length self-tuned by the no-U-turn criterion;
    ``max_depth`` bounds a trajectory at 2^max_depth − 1 leapfrog
    steps. Needs a differentiable ``log_like_fn``. Chains are fully
    independent, so ``mesh=`` shards with zero in-step collectives;
    per-generation cost is the max tree size across the batch (the
    while_loop frees finished chains' lanes only at the generation
    boundary)."""

    _make_config = staticmethod(nuts.nuts_config)

    def _ensure(self, theta_0, spread):
        return self._ensure_population(
            theta_0, spread,
            init_fn=lambda x0: nuts.init(x0, self.log_like_fn, self.cfg,
                                         inv_mass0=self.inv_mass0),
            step_factory=lambda axis: nuts.make_step(
                self.log_like_fn, self.cfg, axis_name=axis),
            sharded_fields=nuts.SHARDED_FIELDS,
            collect_fn=_nuts_collect)


def _chees_collect(state, info):
    """ChEES history: the shared per-generation telemetry (L_t, τ_t)
    broadcast to the chain axis so every history leaf keeps the
    [T, n_chains, ...] layout the pool's mesh sharding requires.
    Module-level for a stable pool-cache identity."""
    n = state.x.shape[0]
    return {"x": state.x, "logp": info.logp, "accepted": info.accepted,
            "n_leapfrog": jnp.broadcast_to(info.n_leapfrog, (n,)),
            "traj_length": jnp.broadcast_to(info.traj_length, (n,))}


class Chees(Hmc):
    """ChEES-HMC (Hoffman, Radul & Sountsov 2021 — samplers/chees.py).
    Beyond-reference extra: HMC whose trajectory length self-tunes from
    a CROSS-CHAIN criterion during warmup — the accelerator-native
    alternative to NUTS (fixed-cost batched leapfrog with a shared,
    pre-known step count per generation instead of a per-chain
    data-dependent tree). Wants many chains (the population is the
    tuning signal); ε, T and the diagonal mass are shared scalars/
    vectors adapted on population statistics and frozen after
    ``adapt_gens``. ``mesh=`` shards chains; the adaptation statistics
    ride §11 gather-then-reduce, so the adaptation trajectory is
    replicated-identical across shards."""

    _make_config = staticmethod(chees.chees_config)

    def _ensure(self, theta_0, spread):
        return self._ensure_population(
            theta_0, spread,
            init_fn=lambda x0: chees.init(x0, self.log_like_fn, self.cfg,
                                          inv_mass0=self.inv_mass0),
            step_factory=lambda axis: chees.make_step(
                self.log_like_fn, self.cfg, axis_name=axis),
            sharded_fields=chees.SHARDED_FIELDS,
            collect_fn=_chees_collect)

    @property
    def trajectory_length(self):
        """Adapted trajectory length T (time units; T̄ once frozen).
        Per-generation trajectories are h_t·T with h_t the Halton
        jitter, so the MEAN trajectory is T/2."""
        s = self.final_state
        frozen = self._steps_run >= self.cfg.adapt_gens
        return float(np.exp(np.asarray(
            s.log_T_bar if frozen else s.log_T)))


def _eslice_collect(state, info):
    """Elliptical-slice history: ``logp`` is the FULL log-posterior
    (likelihood + Gaussian prior); ``loglike``/``n_shrink`` are the
    family's own diagnostics (mean n_shrink ≈ ellipse difficulty).
    Module-level for a stable pool-cache identity."""
    return {"x": state.x, "logp": info.logp, "accepted": info.accepted,
            "loglike": info.loglike, "n_shrink": info.n_shrink}


class EllipticalSlice(McmcSampler):
    """Elliptical slice sampling (Murray, Adams & MacKay 2010) —
    beyond-reference extra (samplers/eslice.py) for targets factored as
    N(μ, Σ)·L(x): latent-GP models and Gaussian-prior inverse problems.

    UNLIKE every other sampler here, ``log_like_fn`` is the NON-Gaussian
    likelihood factor ONLY — the N(``prior_mean``, Σ) prior enters
    exactly through the ellipse (pass Σ's lower Cholesky as
    ``prior_chol``, a [d,d] matrix or [d]/scalar diagonal of √Σ).
    Rejection-free and tuning-free; perfect prior conditioning at any
    condition number. Chains are fully independent, so ``mesh=`` shards
    with zero in-step collectives; per-generation cost is the batch-max
    shrink count (data-dependent while_loop, like NUTS)."""

    _make_config = staticmethod(eslice.eslice_config)

    def __init__(self, log_like_fn, prior_mean, prior_chol, n_chains=8,
                 seed=0, dtype=jnp.float32, mesh=None, **config_kw):
        super().__init__(log_like_fn, seed=seed, dtype=dtype)
        self.n_chains = int(n_chains)
        self.prior_mean = prior_mean
        self.prior_chol = prior_chol
        self.cfg = self._make_config(**config_kw)
        self.mesh = mesh
        _check_mesh_chains(mesh, self.n_chains)

    def _ensure(self, theta_0, spread):
        return self._ensure_population(
            theta_0, spread,
            init_fn=lambda x0: eslice.init(x0, self.log_like_fn),
            step_factory=lambda axis: eslice.make_step(
                self.log_like_fn, self.prior_mean, self.prior_chol,
                self.cfg, axis_name=axis),
            sharded_fields=eslice.SHARDED_FIELDS,
            collect_fn=_eslice_collect)

    def run_mcmc(self, n_samples, theta_0=None, thin=1, spread=1.0,
                 progress_every=None):
        state, k_run = self._ensure(theta_0, spread)
        final_state, history = self._pool_obj.run(
            state, k_run, n_samples, thin=thin, t0=self._steps_run,
            progress_every=progress_every)
        self._store(final_state, history, n_samples, thin=thin)
        return self

    def run_mcmc_until(self, theta_0=None, rhat_tol=1.05, chunk=100,
                       max_chunks=200, warmup_chunks=2, spread=1.0):
        if self.n_chains < 2:
            raise ValueError("R-hat early stop needs n_chains >= 2")
        state, k_run = self._ensure(theta_0, spread)
        final_state, info = self._pool_obj.run_until(
            state, k_run, rhat_tol=rhat_tol, chunk=chunk,
            max_chunks=max_chunks, warmup_chunks=warmup_chunks,
            t0=self._steps_run)
        self._final_state = jax.block_until_ready(final_state)
        self._steps_run += int(info["steps"])
        return {k: np.asarray(v) for k, v in info.items()}


def _enslice_collect(state, info):
    """Ensemble-slice history: per-walker expansion/contraction counts
    (cost diagnostics) and the tuned scale μ ride alongside the default
    fields. μ is replicated onto the chain axis so the leaf shards on
    the mesh path ([T] scalars are rejected there). Module-level for a
    stable pool-cache identity."""
    return {"x": state.x, "logp": info.logp, "accepted": info.accepted,
            "n_expand": info.n_expand, "n_contract": info.n_contract,
            "mu": jnp.broadcast_to(info.mu, info.logp.shape)}


class EnsembleSlice(McmcSampler):
    """Ensemble slice sampling (Karamanis & Beutler 2021, "zeus") —
    beyond-reference extra (samplers/enslice.py).

    Slice-samples each walker exactly along a differential-evolution
    direction μ(x_l − x_m) from the complementary half (red-black
    update, like `EnsembleSampler`): rejection-free up to the shrink
    cap, and the ONE global knob μ self-tunes during the first
    ``tune_gens`` generations from the expansion/contraction balance,
    then freezes (diminishing adaptation). Cost: ~(2 + Nₑ + N꜀) target
    evals per walker per generation, batch-max under vmap (the
    stepping-out/shrinkage `lax.while_loop`s are data-dependent, like
    `Nuts`). Use n_chains ≥ 2d+2 walkers.

    History carries per-walker ``n_expand``/``n_contract`` and ``mu``;
    ``accepted`` is False only on a shrink-cap fallback. ``mesh=``
    all_gathers the population per half-update (the stretch pattern);
    the μ-update counts psum as integers, so vmap and mesh see the
    identical μ trajectory."""

    _make_config = staticmethod(enslice.enslice_config)

    def __init__(self, log_like_fn, n_chains=32, seed=0, dtype=jnp.float32,
                 mesh=None, **config_kw):
        super().__init__(log_like_fn, seed=seed, dtype=dtype)
        self.n_chains = int(n_chains)
        self.cfg = self._make_config(n_chains=self.n_chains, **config_kw)
        self.mesh = mesh
        _check_mesh_chains(mesh, self.n_chains)

    @property
    def mu(self):
        """Current (tuned) direction scale μ."""
        self._require_run()
        return float(self._final_state.mu)

    def _ensure(self, theta_0, spread):
        return self._ensure_population(
            theta_0, spread,
            init_fn=lambda x0: enslice.init(x0, self.log_like_fn, self.cfg),
            step_factory=lambda axis: enslice.make_step(
                self.log_like_fn, self.cfg, axis_name=axis),
            sharded_fields=enslice.SHARDED_FIELDS,
            collect_fn=_enslice_collect)

    def run_mcmc(self, n_gens, theta_0=None, thin=1, spread=1.0,
                 progress_every=None):
        state, k_run = self._ensure(theta_0, spread)
        final_state, history = self._pool_obj.run(
            state, k_run, n_gens, thin=thin, t0=self._steps_run,
            progress_every=progress_every)
        self._store(final_state, history, n_gens, thin=thin)
        return self

    def run_mcmc_until(self, theta_0=None, rhat_tol=1.05, chunk=100,
                       max_chunks=200, warmup_chunks=2, spread=1.0):
        state, k_run = self._ensure(theta_0, spread)
        final_state, info = self._pool_obj.run_until(
            state, k_run, rhat_tol=rhat_tol, chunk=chunk,
            max_chunks=max_chunks, warmup_chunks=warmup_chunks,
            t0=self._steps_run)
        self._final_state = jax.block_until_ready(final_state)
        self._steps_run += int(info["steps"])
        return {k: np.asarray(v) for k, v in info.items()}


def _check_fused_target(log_prob_block):
    """Fail ``fused=True`` at construction where its kernel cannot run.

    On the GPU the fused kernels compile through Pallas-Triton, which
    cannot lower the slicing and batched products a vmapped scalar
    target produces, so the in-kernel target must be a padded block
    form (``log_prob_block=``, models/targets.py ``*_block``). Raising
    here — not mid-run — keeps a sampler from stopping half-advanced
    with burn-in stored and its fused segment dead. On the CPU the
    kernels run in interpret mode and wrap the scalar target; any other
    platform raises in ops/route.py.
    """
    if log_prob_block is None and not interpret_mode():
        raise ValueError(
            "fused=True on the GPU needs log_prob_block=, a padded block "
            "form of the target (e.g. models.gaussian_mixture_block): a "
            "scalar target does not lower through Triton. Use "
            "fused=False for the per-generation engine.")


class EnsembleSampler(McmcSampler):
    """Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch
    move, emcee-style red-black parallel update) — beyond-reference extra
    (samplers/stretch.py). Use n_chains ≥ 2d+2 walkers."""

    def __init__(self, log_like_fn, n_chains=32, seed=0, dtype=jnp.float32,
                 mesh=None, **config_kw):
        super().__init__(log_like_fn, seed=seed, dtype=dtype)
        self.n_chains = int(n_chains)
        self.cfg = stretch.StretchConfig(n_chains=self.n_chains,
                                         **config_kw)
        self.mesh = mesh
        _check_mesh_chains(mesh, self.n_chains)

    def _ensure(self, theta_0, spread):
        return self._ensure_population(
            theta_0, spread,
            init_fn=lambda x0: stretch.init(x0, self.log_like_fn),
            step_factory=lambda axis: stretch.make_step(
                self.log_like_fn, self.cfg, axis_name=axis),
            sharded_fields=("x", "logp"))

    def run_mcmc(self, n_gens, theta_0=None, thin=1, spread=1.0,
                 progress_every=None):
        state, k_run = self._ensure(theta_0, spread)
        final_state, history = self._pool_obj.run(
            state, k_run, n_gens, thin=thin, t0=self._steps_run,
            progress_every=progress_every)
        self._store(final_state, history, n_gens, thin=thin)
        return self

    def run_mcmc_until(self, theta_0=None, rhat_tol=1.05, chunk=100,
                       max_chunks=200, warmup_chunks=2, spread=1.0):
        state, k_run = self._ensure(theta_0, spread)
        final_state, info = self._pool_obj.run_until(
            state, k_run, rhat_tol=rhat_tol, chunk=chunk,
            max_chunks=max_chunks, warmup_chunks=warmup_chunks,
            t0=self._steps_run)
        self._final_state = jax.block_until_ready(final_state)
        self._steps_run += int(info["steps"])
        return {k: np.asarray(v) for k, v in info.items()}


class DreamZs(McmcSampler):
    """DREAM-zs: archive-Z DE proposals + snooker + CR adaptation
    (SURVEY.md §4.6–4.7). ``mesh=`` shards chains over devices."""

    _config_builder = staticmethod(
        lambda n_chains, **kw: dream.DreamConfig(n_chains=n_chains, **kw))

    def __init__(self, log_like_fn, n_chains=8, seed=0, dtype=jnp.float32,
                 mesh=None, archive_capacity=None, n_archive_init=None,
                 fused=False, fused_z_update=1, log_prob_block=None,
                 **config_kw):
        """``fused=True`` routes post-burn-in, archive-aligned steady-state
        generations through the fused multi-generation Pallas engine
        (samplers/dream_fused.py — one kernel per ``archive_thin``
        generations; works with ``mesh=`` too, one all_gather per
        chunk). Burn-in, alignment remainders, and ``thin != 1`` /
        ``progress_every`` runs stay on the per-generation engine;
        trajectories consume the identical random streams either way.
        Requires a replicated-archive configuration. On the GPU the
        in-kernel target is ``log_prob_block``, a padded block form
        (models/targets.py ``*_block``); construction raises without
        one.

        ``fused_z_update=K`` publishes archive appends every K
        thin-blocks instead of every block, running K·archive_thin
        generations per kernel with one batched K-snapshot append —
        ter Braak & Vrugt (2008)'s own Z-update-interval structure with
        a larger interval, so the stationary distribution is unchanged;
        K > 1 trajectories are not bit-identical to ``fused=False``
        (proposals inside a super-block sample a Z stale by up to
        K·archive_thin generations). Requires K·n_chains ≤ archive
        capacity. See samplers/dream_fused.make_chunk_runner."""
        super().__init__(log_like_fn, seed=seed, dtype=dtype)
        self.n_chains = int(n_chains)
        self.cfg = self._config_builder(self.n_chains, **config_kw)
        self.mesh = mesh
        _check_mesh_chains(mesh, self.n_chains)
        self.archive_capacity = archive_capacity
        self.n_archive_init = n_archive_init
        self.fused = bool(fused)
        self.fused_z_update = int(fused_z_update)
        if self.fused_z_update < 1:
            raise ValueError(
                f"fused_z_update={fused_z_update}: must be >= 1")
        if self.fused_z_update > 1 and not self.fused:
            raise ValueError(
                "fused_z_update > 1 is a fused-engine execution knob; "
                "pass fused=True")
        self._log_prob_block = log_prob_block
        self._fused_runner = None
        self._fused_runner_local = None
        self._fused_jits = {}
        if self.fused:
            from bipymc_tpu.samplers.dream_fused import check_fusable
            check_fusable(self.cfg, mesh)
            _check_fused_target(log_prob_block)

    def _pool(self):
        if getattr(self, "_pool_obj", None) is None:
            def collect(state, info):
                return {"x": state.x, "logp": info.logp,
                        "accepted": info.accepted, "snooker": info.snooker}

            sharded = ("x", "logp", "logp_sum")
            if self.cfg.shard_archive:
                # block-shard the archive ring buffer over the mesh too
                # (ppermute sampling path — ensemble/archive.py)
                sharded += ("archive.buf",)
            self._pool_obj = ChainPool(
                step_factory=lambda axis: dream.make_step(
                    self.log_like_fn, self.cfg, axis_name=axis),
                sharded_fields=sharded, mesh=self.mesh,
                collect_fn=collect)
        return self._pool_obj

    def _ensure_state(self, theta_0, spread, n_gens_hint,
                      auto_capacity_cap=65536):
        key = jax.random.key(self.seed)
        k_init, k_z, k_run = jax.random.split(key, 3)
        if self._continuing(theta_0, spread=spread):
            return self._final_state, k_run
        x0 = _as_2d_theta0(theta_0, self.n_chains, k_init, spread, self.dtype)
        capacity = self.archive_capacity
        if capacity is None:
            appended = self.n_chains * (
                n_gens_hint // self.cfg.archive_thin + 1)
            capacity = int(min(max(256, appended), auto_capacity_cap, 65536))
        if self.cfg.shard_archive and self.mesh is not None:
            # block layout needs equal blocks per device; only round the
            # AUTO-computed capacity — silently changing an explicit one
            # would break bit-identity with a replicated run of the same
            # settings (ring wrap positions shift) and the user's memory
            # budget
            n_dev = int(self.mesh.devices.size)
            if self.archive_capacity is None:
                capacity = -(-capacity // n_dev) * n_dev
            elif capacity % n_dev != 0:
                raise ValueError(
                    f"archive_capacity={capacity} must be divisible by "
                    f"the mesh's {n_dev} devices when shard_archive=True")
        n_z0 = self.n_archive_init or max(
            max(2 * self.cfg.delta_max, 3), self.n_chains, 10)
        n_z0 = min(n_z0, capacity)
        center = jnp.mean(x0, axis=0)
        var = jnp.maximum(jnp.var(x0, axis=0), spread ** 2)
        z0 = var_ball(k_z, var, n_z0, center=center, dtype=self.dtype)
        state = dream.init(x0, self.log_like_fn, self.cfg,
                           archive_capacity=capacity, z0=z0)
        return state, k_run

    def _fused_run(self, state, k_run, n_gens, t0):
        """Jit-cached fused-engine segment (shared base-class cache)."""
        if self._fused_runner is None:
            from bipymc_tpu.samplers.dream_fused import make_chunk_runner
            self._fused_runner = make_chunk_runner(
                self.log_like_fn, self.cfg,
                log_prob_block=self._log_prob_block, mesh=self.mesh,
                z_update_every=self.fused_z_update)
        return self._run_fused_segment(
            self._fused_runner, self._fused_jits, state, k_run, n_gens, t0)

    def run_mcmc(self, n_gens, theta_0=None, thin=1, spread=1.0,
                 progress_every=None):
        state, k_run = self._ensure_state(theta_0, spread, n_gens)
        use_fused = (self.fused and thin == 1 and progress_every is None)
        if not use_fused:
            final_state, history = self._pool().run(
                state, k_run, n_gens, thin=thin,
                t0=self._steps_run, progress_every=progress_every)
            self._store(final_state, history, n_gens, thin=thin)
            return self

        # split into [per-generation: burn-in + alignment] → [fused
        # steady state] → [per-generation remainder]; each segment is
        # stored as its own history chunk with matching leaves
        G = self.cfg.archive_thin
        CG = G * self.fused_z_update      # fused super-block length
        t = self._steps_run
        n1 = max(0, self.cfg.burnin_gens - t)
        if (t + n1) % G:
            n1 += G - (t + n1) % G
        n1 = min(n1, n_gens)
        n2 = ((n_gens - n1) // CG) * CG
        n3 = n_gens - n1 - n2
        if n1:
            state, hist = self._pool().run(state, k_run, n1, thin=1, t0=t)
            self._store(state, hist, n1, thin=1)
            state, t = self._final_state, self._steps_run
        if n2:
            from bipymc_tpu.samplers.dream_fused import \
                validate_fused_segment
            validate_fused_segment(self.cfg, t)
            state, hist = self._fused_run(state, k_run, n2, t)
            self._store(state, hist, n2, thin=1)
            state, t = self._final_state, self._steps_run
        if n3:
            state, hist = self._pool().run(state, k_run, n3, thin=1, t0=t)
            self._store(state, hist, n3, thin=1)
        return self

    def run_mcmc_until(self, theta_0=None, rhat_tol=1.05, chunk=100,
                       max_chunks=200, warmup_chunks=2, spread=1.0):
        """Run until streaming on-device R̂ < rhat_tol (BASELINE config 5).

        Keeps no history; returns an info dict with ``steps`` taken,
        final ``rhat`` [d], and streamed posterior ``mean``/``var``
        ([n_chains, d], host NumPy).

        With ``fused=True``, post-burn-in chunks run on the fused
        multi-generation engine inside the same compiled while_loop
        (``chunk`` is rounded UP to a multiple of ``archive_thin`` to
        keep chunk starts archive-aligned; an unaligned continuation
        offset falls back to the per-generation engine). Streams are
        identical by key discipline, so the trajectory matches the
        fused=False run. On the mesh path the fused chunks execute
        per-shard inside the pool's shard_map program (the LOCAL
        runner, ``make_chunk_runner(wrap=False)``) — with
        rng="stream" still matching the single-device run (bit-exact
        on the pinned tests; ~1-ulp compiler-rounding equivalence in
        general — docs/design.md §3).
        """
        chunk_runner, fused_after = None, 0
        if self.fused:
            G = self.cfg.archive_thin
            CG = G * self.fused_z_update
            if chunk % CG:
                chunk += CG - chunk % CG
            if self._steps_run % G == 0:
                if self._fused_runner_local is None:
                    from bipymc_tpu.samplers.dream_fused import \
                        make_chunk_runner
                    # collect="rhat": moments fold inside the runner's
                    # own scan, so the while_loop never holds a
                    # [chunk, n, d] position history just to feed R̂
                    self._fused_runner_local = make_chunk_runner(
                        self.log_like_fn, self.cfg,
                        log_prob_block=self._log_prob_block,
                        mesh=self.mesh, wrap=False, collect="rhat",
                        z_update_every=self.fused_z_update)
                chunk_runner = self._fused_runner_local
                fused_after = self.cfg.burnin_gens
        # auto capacity for an R̂-stopped run: chunk·max_chunks is a
        # worst-case bound the typical run never approaches, and sizing
        # the ring for it balloons the while_loop's carried archive for
        # identical work. Cap the AUTO ring at 32
        # population snapshots (bench.py pins the same 8192 for 256
        # chains); archive_capacity= overrides explicitly.
        state, k_run = self._ensure_state(
            theta_0, spread, chunk * max_chunks,
            auto_capacity_cap=max(8192, 32 * self.n_chains))
        final_state, info = self._pool().run_until(
            state, k_run, rhat_tol=rhat_tol, chunk=chunk,
            max_chunks=max_chunks, warmup_chunks=warmup_chunks,
            t0=self._steps_run, chunk_runner=chunk_runner,
            fused_after=fused_after)
        self._final_state = jax.block_until_ready(final_state)
        self._steps_run += int(info["steps"])
        return {k: np.asarray(v) for k, v in info.items()}

    @property
    def cr_probabilities(self):
        return np.asarray(self.final_state.cr_p)

    @property
    def snooker_fraction(self):
        """Fraction of kept generations×chains proposed via snooker."""
        return float(np.mean(self._history["snooker"]))


class DeMcZ(DreamZs):
    """DE-MC-z (ter Braak & Vrugt 2008): DREAM-zs engine restricted to
    single-pair differences, full-dimension crossover, no CR adaptation
    (SURVEY.md §4.6)."""

    _config_builder = staticmethod(dream.demcz_config)


class Dream(DreamZs):
    """Population-DREAM (Vrugt et al. 2009, pre-zs): multi-pair difference
    vectors drawn from the current population (r₁≠r₂≠i), CR adaptation,
    outlier reset, no snooker/archive sampling (SURVEY.md §4.7). Needs
    n_chains ≥ max(2·delta_max, 3) + 1."""

    _config_builder = staticmethod(dream.dream_config)

    def __init__(self, log_like_fn, n_chains=16, **kw):
        super().__init__(log_like_fn, n_chains=n_chains, **kw)
        need = max(2 * self.cfg.delta_max, 3) + 1
        if self.n_chains < need:
            raise ValueError(
                f"population-DREAM draws max(2*delta_max, 3) distinct "
                f"chains ≠ i per proposal: need n_chains ≥ {need}, got "
                f"{self.n_chains}")


class Smc:
    """Adaptive tempered Sequential Monte Carlo (samplers/smc.py) —
    beyond-reference extra. Anneals ``n_particles`` from a reference
    density to the target along the geometric path with ESS-adaptive
    β-increments, systematic resampling, and adapted random-walk
    rejuvenation. Delivers what the MCMC zoo cannot on well-separated
    multimodal targets: correct mode *weights* and a log-evidence
    estimate (see the smc.py module docstring for the design and the
    honesty caveats). ``kernel="rw"`` (default) needs nothing beyond a
    callable target; ``kernel="hmc"`` rejuvenates with leapfrog
    trajectories (needs a differentiable target) and is the measured
    difference between working and collapsing on high-dimensional
    separated-mode targets.

    The reference density is a **normalised** diagonal Gaussian given by
    ``ref_mean``/``ref_var`` (log-evidence is then the target's true log
    normalising constant), or a custom ``(log_ref, sample_ref)`` pair —
    ``log_ref(x scalar-per-row)`` must be normalised for the evidence to
    be meaningful, and ``sample_ref(key, n) -> [n, d]`` must draw from
    it. ``mesh=`` shards the particle axis; cross-particle reductions
    follow the gather-then-reduce rule: the
    decision math (β ladder, resample, evidence) is identical on both
    paths and bit-identical GIVEN bit-identical particles, but the
    sharded move programs round ~1 ulp differently per move
    (batch-shape FMA contraction), so across shapes the contract is
    equal stage counts with ladder/evidence at float tolerance and
    positions at the ulp floor. Pinned in tests/test_smc.py.
    """

    def __init__(self, log_like_fn, n_particles=1024, seed=0,
                 dtype=jnp.float32, mesh=None, ref_mean=None, ref_var=None,
                 log_ref=None, sample_ref=None, **config_kw):
        from bipymc_tpu.samplers import smc as _smc
        from bipymc_tpu.parallel.mesh import CHAIN_AXIS
        from bipymc_tpu.parallel.pool import _state_specs

        self.log_like_fn = log_like_fn
        self.seed = int(seed)
        self.dtype = dtype
        self.mesh = mesh
        self.cfg = _smc.smc_config(n_particles=int(n_particles),
                                   **config_kw)
        _check_mesh_chains(mesh, self.cfg.n_particles)

        if (log_ref is None) != (sample_ref is None):
            raise ValueError(
                "pass log_ref and sample_ref together (a normalised "
                "density and its sampler), or neither")
        if log_ref is None:
            if ref_mean is None or ref_var is None:
                raise ValueError(
                    "Smc needs a reference density: pass ref_mean and "
                    "ref_var (diagonal Gaussian) or a custom "
                    "(log_ref, sample_ref) pair")
            m = jnp.asarray(ref_mean, dtype)
            v = jnp.asarray(ref_var, dtype)
            if m.ndim != 1 or v.shape != m.shape:
                raise ValueError("ref_mean/ref_var must be 1-D and "
                                 "matching shapes")
            log2pi = float(np.log(2.0 * np.pi))

            def log_ref(x, _m=m, _v=v):
                return -0.5 * jnp.sum((x - _m) ** 2 / _v
                                      + jnp.log(_v) + log2pi)

            def sample_ref(key, n, _m=m, _v=v):
                z = jax.random.normal(key, (n, _m.shape[0]), dtype)
                return _m + z * jnp.sqrt(_v)

        self._log_ref = log_ref
        self._sample_ref = sample_ref
        self._smc = _smc
        self._result = None

        if mesh is None:
            self._runner = jax.jit(
                _smc.make_runner(log_ref, self.log_like_fn, self.cfg,
                                 axis_name=None))
            self._shard = lambda s: s
        else:
            axis = CHAIN_AXIS
            run_local = _smc.make_runner(log_ref, self.log_like_fn,
                                         self.cfg, axis_name=axis)
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P

            def specs_of(state):
                return _state_specs(state, _smc.SHARDED_FIELDS, axis)

            def make(state):
                state_specs = specs_of(state)
                result_specs = self._smc.SmcResult(
                    x=P(), lw=P(), log_evidence=P(), n_stages=P(),
                    reached_one=P(), beta_hist=P(), ess_hist=P(),
                    acc_hist=P())
                return jax.jit(jax.shard_map(
                    run_local, mesh=mesh,
                    in_specs=(state_specs, P()),
                    out_specs=(state_specs, result_specs),
                    check_vma=False))

            self._make_sharded = make
            self._runner = None

            def shard(state):
                specs = specs_of(state)
                shardings = jax.tree_util.tree_map(
                    lambda sp: NamedSharding(mesh, sp), specs,
                    is_leaf=lambda x: isinstance(x, P))
                return jax.device_put(state, shardings)

            self._shard = shard

    def run(self, theta_0=None):
        """Run the annealing pass. theta_0: optional [n_particles, d]
        reference draws (defaults to ``sample_ref`` draws — pass your own
        only if they come from the SAME reference density, e.g. replayed
        from a previous run). Returns an info dict; particles /
        log_weights / log_evidence are exposed as properties."""
        key = jax.random.key(self.seed)
        k_init, k_run = jax.random.split(key)
        if theta_0 is None:
            x0 = self._sample_ref(k_init, self.cfg.n_particles)
        else:
            x0 = jnp.asarray(theta_0, self.dtype)
            if x0.shape[0] != self.cfg.n_particles:
                raise ValueError(
                    f"theta_0 has {x0.shape[0]} rows but "
                    f"n_particles={self.cfg.n_particles}")
        state = self._smc.init(x0, self._log_ref, self.log_like_fn,
                               self.cfg)
        state = self._shard(state)
        if self._runner is None:
            self._runner = self._make_sharded(state)
        final, result = self._runner(state, k_run)
        if not bool(result.reached_one):
            warnings.warn(
                f"SMC hit max_stages={self.cfg.max_stages} at "
                f"beta={float(final.beta):.4f} < 1 — raise max_stages or "
                "ess_alpha; results are for the tempered density, not "
                "the target", stacklevel=2)
        self._result = result
        n = int(result.n_stages)
        return {
            "n_stages": n,
            "log_evidence": float(result.log_evidence),
            "reached_one": bool(result.reached_one),
            "beta_ladder": np.asarray(result.beta_hist[:n]),
            "ess": np.asarray(result.ess_hist[:n]),
            "acceptance": np.asarray(result.acc_hist[:n]),
        }

    def _require_run(self):
        if self._result is None:
            raise RuntimeError("call run() first")

    @property
    def particles(self):
        """[n_particles, d] final particles (host NumPy). Weighted —
        pair with ``log_weights`` or use ``resample()``."""
        self._require_run()
        return np.asarray(self._result.x)

    @property
    def log_weights(self):
        self._require_run()
        return np.asarray(self._result.lw)

    @property
    def log_evidence(self):
        self._require_run()
        return float(self._result.log_evidence)

    def resample(self, n=None, seed=None):
        """Equal-weight posterior draws via systematic resampling of the
        final weighted population ([n, d] host NumPy)."""
        self._require_run()
        n = int(n) if n is not None else self.cfg.n_particles
        rng = np.random.default_rng(self.seed + 1 if seed is None
                                    else seed)
        w = np.exp(np.asarray(self._result.lw, np.float64))
        w = w / w.sum()
        cdf = np.cumsum(w)
        pts = (np.arange(n) + rng.uniform()) / n
        idx = np.clip(np.searchsorted(cdf, pts), 0, w.size - 1)
        return self.particles[idx]


class Svgd:
    """Stein variational gradient descent (samplers/svgd.py) —
    beyond-reference extra. Deterministic particle transport toward the
    posterior: one RBF kernel-matrix build plus two [N,N]×[N,d] matmul
    contractions and a batch of target gradients per step, no
    accept/reject, no RNG after init. Use it for fast approximate
    posteriors, warm-start populations for the MCMC families, or as a
    mode-finding swarm; see the svgd.py module docstring for the honesty
    notes (far-separated mode weights freeze; high-d variance
    underestimation). ``mesh=`` shards the particle axis — gradients
    evaluate shard-locally (the dominant cost for expensive targets such
    as the GP surrogate), kernel/bandwidth decision math runs replicated
    on gathered positions (gather-then-reduce).
    """

    def __init__(self, log_like_fn, n_particles=256, seed=0,
                 dtype=jnp.float32, mesh=None, **config_kw):
        from bipymc_tpu.samplers import svgd as _svgd
        from bipymc_tpu.parallel.mesh import CHAIN_AXIS
        from bipymc_tpu.parallel.pool import _state_specs

        self.log_like_fn = log_like_fn
        self.seed = int(seed)
        self.dtype = dtype
        self.mesh = mesh
        self.cfg = _svgd.svgd_config(n_particles=int(n_particles),
                                     **config_kw)
        _check_mesh_chains(mesh, self.cfg.n_particles)
        self._svgd = _svgd
        self._axis = None if mesh is None else CHAIN_AXIS
        self._state_specs = _state_specs
        self._state = None
        self._info = None
        self._runners = {}

    def _get_runner(self, n_steps, state):
        key = int(n_steps)
        if key in self._runners:
            return self._runners[key]
        run_local = self._svgd.make_runner(
            self.log_like_fn, self.cfg, n_steps, axis_name=self._axis)
        if self.mesh is None:
            runner = jax.jit(run_local)
        else:
            from jax.sharding import PartitionSpec as P
            specs = self._state_specs(state, self._svgd.SHARDED_FIELDS,
                                      self._axis)
            info_specs = self._svgd.SvgdInfo(P(), P(), P())
            runner = jax.jit(jax.shard_map(
                run_local, mesh=self.mesh, in_specs=(specs,),
                out_specs=(specs, info_specs), check_vma=False))
        self._runners[key] = runner
        return runner

    def run(self, n_steps, theta_0=None, spread=1.0):
        """Run ``n_steps`` SVGD updates. First call requires ``theta_0``
        ([n_particles, d] positions, or [d] center dispersed in a
        ``spread``-std ball); later calls continue from the current
        particles (the continuation contract — start-only args warn)."""
        n_steps = int(n_steps)
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if self._state is None:
            if theta_0 is None:
                raise ValueError("first run() needs theta_0")
            key = jax.random.key(self.seed)
            x0 = _as_2d_theta0(theta_0, self.cfg.n_particles, key,
                               spread, self.dtype)
            state = self._svgd.init(x0)
            if self.mesh is not None:
                from jax.sharding import NamedSharding
                from jax.sharding import PartitionSpec as P
                specs = self._state_specs(
                    state, self._svgd.SHARDED_FIELDS, self._axis)
                shardings = jax.tree_util.tree_map(
                    lambda sp: NamedSharding(self.mesh, sp), specs,
                    is_leaf=lambda x: isinstance(x, P))
                state = jax.device_put(state, shardings)
            self._state = state
        elif theta_0 is not None:
            warnings.warn(
                "theta_0 ignored: this Svgd continues from its current "
                "particles (construct a new Svgd or call reset() to "
                "restart)", stacklevel=2)
        runner = self._get_runner(n_steps, self._state)
        self._state, info = runner(self._state)
        self._info = info
        return {
            "steps_run": n_steps,
            "phi_rms": float(info.phi_rms[-1]),
            "bandwidth": float(info.bandwidth[-1]),
            "phi_rms_history": np.asarray(info.phi_rms),
            "bandwidth_history": np.asarray(info.bandwidth),
            "grad_rms_history": np.asarray(info.grad_rms),
        }

    def reset(self):
        """Forget the particle state (the next run() is a fresh start)."""
        self._state = None
        self._info = None

    @property
    def particles(self):
        """[n_particles, d] current particles (host NumPy; unweighted —
        SVGD particles are equal-weight by construction)."""
        if self._state is None:
            raise RuntimeError("call run() first")
        return np.asarray(self._state.x)

    @property
    def final_state(self):
        if self._state is None:
            raise RuntimeError("call run() first")
        return self._state


class Advi:
    """Automatic differentiation variational inference
    (samplers/advi.py) — beyond-reference extra. Fits a Gaussian
    q = N(μ, Σ) to the posterior by Adam ascent on the reparameterized
    ELBO (mean-field or ``full_rank=True``); ``n_restarts`` independent
    fits run as one vmapped program and the best final ELBO wins. The
    cheapest posterior approximation in the zoo — exact only for
    Gaussian posteriors; its (μ, Σ) is a variance-aware
    ``theta_0``/``cov_est`` pair for the MCMC families (``init_pair()``)
    and the restart-ELBO spread is a multimodality diagnostic. See the
    advi.py module docstring for design and honesty notes.
    """

    def __init__(self, log_like_fn, n_restarts=4, seed=0,
                 dtype=jnp.float32, **config_kw):
        from bipymc_tpu.samplers import advi as _advi

        self.log_like_fn = log_like_fn
        self.n_restarts = int(n_restarts)
        if self.n_restarts < 1:
            raise ValueError("n_restarts must be >= 1")
        self.seed = int(seed)
        self.dtype = dtype
        self.cfg = _advi.advi_config(**config_kw)
        self._advi = _advi
        self._state = None
        self._elbo_hist = []
        self._runners = {}

    def _get_runner(self, n_steps):
        key = int(n_steps)
        if key not in self._runners:
            run_one = self._advi.make_runner(self.log_like_fn, self.cfg,
                                             n_steps)
            self._runners[key] = jax.jit(jax.vmap(run_one))
        return self._runners[key]

    def run(self, n_steps=1000, theta_0=None, spread=1.0):
        """Fit for ``n_steps`` Adam steps (continuation contract: later
        calls continue; start-only args warn). ``theta_0``: [d] center
        (restart means dispersed in a ``spread``-std ball) or
        [n_restarts, d] explicit starts."""
        n_steps = int(n_steps)
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        key = jax.random.key(self.seed)
        k_init, k_run = jax.random.split(key)
        if self._state is None:
            if theta_0 is None:
                raise ValueError("first run() needs theta_0")
            mu0 = _as_2d_theta0(theta_0, self.n_restarts, k_init,
                                spread, self.dtype)
            self._state = jax.vmap(
                lambda m: self._advi.init(m, self.cfg))(mu0)
        elif theta_0 is not None:
            warnings.warn(
                "theta_0 ignored: this Advi continues from its current "
                "fit (construct a new Advi or call reset() to restart)",
                stacklevel=2)
        # distinct stream per segment: fold the step offset
        t0 = int(self._state.t.reshape(-1)[0])
        k_seg = jax.random.fold_in(k_run, t0)
        keys = jax.vmap(lambda i: jax.random.fold_in(k_seg, i))(
            jnp.arange(self.n_restarts, dtype=jnp.int32))
        self._state, info = self._get_runner(n_steps)(self._state, keys)
        elbo = np.asarray(info.elbo)               # [n_restarts, n_steps]
        self._elbo_hist.append(elbo)
        # rank restarts on the MC-noise-smoothed tail
        # f64 accumulate: the non-finite penalty (~finfo.min/4) overflows
        # an f32 sum over the window
        tail = elbo[:, -min(50, n_steps):].astype(np.float64).mean(axis=1)
        self._best = int(np.argmax(tail))
        return {
            "steps_run": n_steps,
            "elbo": float(tail[self._best]),
            "best_restart": self._best,
            "elbo_by_restart": tail,
            "elbo_history": np.concatenate(self._elbo_hist, axis=1),
        }

    def reset(self):
        self._state = None
        self._elbo_hist = []

    def _require_run(self):
        if self._state is None:
            raise RuntimeError("call run() first")

    def _best_params(self):
        self._require_run()
        mu = self._state.mu[self._best]
        omega = self._state.omega[self._best]
        C, _ = self._advi._chol_of(omega, self.cfg.full_rank)
        return mu, C

    @property
    def mean(self):
        """[d] variational mean of the best restart (host NumPy)."""
        return np.asarray(self._best_params()[0])

    @property
    def cov(self):
        """[d, d] variational covariance of the best restart."""
        mu, C = self._best_params()
        if self.cfg.full_rank:
            return np.asarray(C @ C.T)
        return np.asarray(jnp.diag(C * C))

    def sample(self, n, seed=None):
        """[n, d] draws from the best restart's q (host NumPy)."""
        mu, C = self._best_params()
        k = jax.random.key(self.seed + 1 if seed is None else int(seed))
        z = jax.random.normal(k, (int(n), mu.shape[-1]), self.dtype)
        x = mu + (z @ C.T if self.cfg.full_rank else z * C)
        return np.asarray(x)

    def init_pair(self):
        """(theta_0, cov_est) for the MCMC families — the variational
        analogue of ``bp.map_laplace``'s output pair."""
        mu, C = self._best_params()
        cov = C @ C.T if self.cfg.full_rank else jnp.diag(C * C)
        return mu, cov


class NestedSampler:
    """Nested sampling (samplers/ns.py) — beyond-reference extra.
    One run yields the log-evidence with an error bar AND weighted
    posterior samples, with natural multimodality handling (the
    likelihood floor rises through every basin simultaneously, so
    separated modes keep their correct relative mass) — the
    complementary evidence engine to ``bp.Smc`` that needs no
    annealing path or reference density.

    Contract (MultiNest/dynesty convention): ``prior_transform(u)``
    maps u ~ U[0,1]^``n_dim`` through the prior's inverse CDF to θ,
    and ``log_like_fn(θ)`` is the log-likelihood. Each iteration kills
    the ``n_batch`` worst of ``n_live`` points at once (exact
    sequential volume bookkeeping) and replaces them with batched
    constrained DE walks — see the ns.py module docstring for the
    design and its scope limits. ``mesh=`` shards the replacement
    walkers (``n_batch`` divisible by the device count); live-set
    decision math is replicated, per-walker RNG folds by global index,
    so mesh and vmap runs see identical streams (gather-then-reduce).
    """

    def __init__(self, log_like_fn, prior_transform, n_dim,
                 n_live=1024, seed=0, dtype=jnp.float32, mesh=None,
                 **config_kw):
        from bipymc_tpu.samplers import ns as _ns
        from bipymc_tpu.parallel.mesh import CHAIN_AXIS

        self.log_like_fn = log_like_fn
        self.prior_transform = prior_transform
        self.n_dim = int(n_dim)
        self.seed = int(seed)
        self.dtype = dtype
        self.mesh = mesh
        self.cfg = _ns.ns_config(n_live=int(n_live), **config_kw)
        _check_mesh_chains(mesh, self.cfg.n_batch)
        self._ns = _ns
        self._result = None

        if mesh is None:
            self._runner = jax.jit(_ns.make_runner(
                prior_transform, log_like_fn, self.cfg, axis_name=None))
        else:
            from jax.sharding import PartitionSpec as P
            run_local = _ns.make_runner(prior_transform, log_like_fn,
                                        self.cfg, axis_name=CHAIN_AXIS)
            # NS state is fully REPLICATED (the sharded axis — the
            # n_batch replacement walkers — exists only inside the
            # batch body), so every spec is P()
            state_specs = _ns.NsState(
                *(P() for _ in _ns.NsState._fields))
            result_specs = _ns.NsResult(
                *(P() for _ in _ns.NsResult._fields))
            self._runner = jax.jit(jax.shard_map(
                run_local, mesh=mesh,
                in_specs=(state_specs, P()),
                out_specs=(state_specs, result_specs),
                check_vma=False))

    def run(self):
        """Run to termination (``stop_dlogz`` or ``max_batches``).
        Returns an info dict; samples / log_weights / log_evidence are
        exposed as properties afterwards."""
        key = jax.random.key(self.seed)
        k_init, k_run = jax.random.split(key)
        state = self._ns.init(k_init, self.prior_transform,
                              self.log_like_fn, self.cfg, self.n_dim,
                              self.dtype)
        _, result = self._runner(state, k_run)
        if not bool(result.terminated):
            warnings.warn(
                f"nested sampling hit max_batches={self.cfg.max_batches} "
                f"before the stop_dlogz={self.cfg.stop_dlogz} criterion "
                "— raise max_batches; the evidence is a lower bound",
                stacklevel=2)
        self._result = result
        n = int(result.n_batches)
        ev = np.asarray(result.ev_hist[:n], np.float64)
        # per batch: n_batch walkers × n_mcmc reps × (measured mean
        # logical evals per rep — 1 for "walk", the stepping-out +
        # shrinkage count for "slice"); + the n_live prior evals at init
        n_evals = int(self.cfg.n_live + self.cfg.n_batch
                      * self.cfg.n_mcmc * ev.sum())
        return {
            "log_evidence": float(result.log_evidence),
            "log_evidence_err": float(result.log_evidence_err),
            "information": float(result.h),
            "n_batches": n,
            "n_dead": n * self.cfg.n_batch,
            "n_like_evals": n_evals,
            "evals_per_rep": float(ev.mean()) if n else 0.0,
            "terminated": bool(result.terminated),
            "acceptance": np.asarray(result.acc_hist[:n]),
        }

    def _require_run(self):
        if self._result is None:
            raise RuntimeError("call run() first")

    @property
    def log_evidence(self):
        self._require_run()
        return float(self._result.log_evidence)

    @property
    def log_evidence_err(self):
        self._require_run()
        return float(self._result.log_evidence_err)

    @property
    def samples(self):
        """[n_dead + n_live, d] θ samples (dead points then final live
        set; host NumPy). Weighted — pair with ``log_weights`` or use
        ``resample()``. Unused dead-buffer slots carry weight -inf."""
        self._require_run()
        th = jax.vmap(self.prior_transform)(self._result.u)
        return np.asarray(th)

    @property
    def log_weights(self):
        """[n_dead + n_live] normalised log posterior weights."""
        self._require_run()
        return np.asarray(self._result.logw)

    def resample(self, n=None, seed=None):
        """Equal-weight posterior draws via systematic resampling of
        the weighted dead+live set ([n, d] host NumPy)."""
        self._require_run()
        n = int(n) if n is not None else self.cfg.n_live
        rng = np.random.default_rng(self.seed + 1 if seed is None
                                    else seed)
        lw = np.asarray(self._result.logw, np.float64)
        w = np.exp(lw - lw.max())
        w = np.where(np.isfinite(w), w, 0.0)
        w = w / w.sum()
        cdf = np.cumsum(w)
        pts = (np.arange(n) + rng.uniform()) / n
        idx = np.clip(np.searchsorted(cdf, pts), 0, w.size - 1)
        return self.samples[idx]


def _flowmh_collect(state, info):
    """FlowMh history keeps both acceptance channels: ``accepted`` is
    the FLOW (global) move — the mode-transplant rate, the number this
    sampler exists for — and ``accepted_local`` the within-basin RW
    rate. Module-level for a stable pool-cache identity."""
    return {"x": state.x, "logp": info.logp, "accepted": info.accepted,
            "accepted_local": info.accepted_local}


class FlowMh(McmcSampler):
    """Global-move MCMC (samplers/flowmh.py) — beyond-reference extra,
    the flowMC composition: per generation, ``local_moves`` Gaussian RW
    moves then ONE independence MH move proposing from a density fit to
    earlier draws. The fit's log-density is exact, so the kernel
    targets the exact posterior at ANY fit quality; fit quality sets
    the global-move acceptance rate. This is the cross-mode channel the
    DE/archive family lacks at d≳20: transplants
    happen at the proposal acceptance rate, independent of mode
    separation.

    ``proposal`` is either bare `FlowParams` from ``bp.fit_flow`` (the
    namesake — ``flow_config`` must then be the SAME architecture the
    params were fitted with, since params carry weights only) or any
    `bp.Proposal` — e.g. ``bp.gmm_proposal(bp.fit_gmm(...))`` for
    Gaussian-ish basins, where a neural flow's per-dimension fit error
    compounds with d but the EM mixture holds acceptance ~1 at any d,
    or ``bp.flow_proposal`` built explicitly.

    The proposal is frozen inside the kernel (exact π-invariance). The
    standard loop is: exploratory run (stratified DreamZs, SMC, ...) →
    fit on its history → FlowMh. To refit, construct a new FlowMh
    (compile cost is per-architecture). Chains are fully independent —
    ``mesh=`` shards with zero in-step collectives.

    ``acceptance_fraction`` reports the GLOBAL (proposal) channel;
    the history key ``accepted_local`` carries the RW channel.
    """

    def __init__(self, log_like_fn, proposal, n_chains=8, seed=0,
                 dtype=jnp.float32, mesh=None, flow_config=None,
                 fused=False, log_prob_block=None, **config_kw):
        """``fused=True`` routes aligned steady segments through the
        fused engine (samplers/flowmh_fused.py): the whole
        ``global_every × local_moves`` local-RW block between global
        moves runs as ONE Pallas kernel, the global move between
        launches. Composes with ``mesh=``: each device runs
        the fused kernel on its chain shard with zero in-step
        collectives, bit-identical streams to the single-device run.
        Identical streams to ``fused=False`` (the prep
        replicates the per-generation word layout); requires
        ``local_moves >= 1`` AND ``thin == 1`` with no
        ``progress_every`` (those runs fall back to the per-generation
        engine — same trajectories, slower; run_mcmc warns when that
        happens so a benchmark can't silently measure the wrong
        engine). On the GPU the in-kernel target is ``log_prob_block``,
        a padded block form (models/targets.py ``*_block``);
        construction raises without one. ``global_every=K`` in
        ``config_kw`` amortizes the proposal-density passes 1/K.
        """
        super().__init__(log_like_fn, seed=seed, dtype=dtype)
        from bipymc_tpu.utils.flows import FlowConfig, flow_proposal
        from bipymc_tpu.utils.proposals import Proposal
        self.n_chains = int(n_chains)
        fc = flow_config if flow_config is not None else FlowConfig()
        self.cfg = flowmh.FlowMhConfig(flow=fc, **config_kw)
        if self.cfg.local_moves < 0:
            raise ValueError("local_moves must be >= 0")
        if self.cfg.global_every < 1:
            raise ValueError("global_every must be >= 1")
        if self.cfg.global_every > 1 and self.cfg.local_moves == 0:
            raise ValueError("global_every > 1 with local_moves=0 would "
                             "leave skipped generations with no move")
        if isinstance(proposal, Proposal):
            self.proposal = proposal
        else:
            self.proposal = flow_proposal(proposal, fc)
        self.mesh = mesh
        _check_mesh_chains(mesh, self.n_chains)
        self.fused = bool(fused)
        self._log_prob_block = log_prob_block
        self._fused_runner = None
        self._fused_runner_local = None
        self._fused_jits = {}
        if self.fused:
            from bipymc_tpu.samplers.flowmh_fused import (
                check_flowmh_fusable)
            check_flowmh_fusable(self.cfg, mesh, self.n_chains)
            _check_fused_target(log_prob_block)

    def _ensure_fused_runner(self):
        if self._fused_runner is None:
            from bipymc_tpu.samplers.flowmh_fused import (
                make_flowmh_chunk_runner)
            self._fused_runner = make_flowmh_chunk_runner(
                self.log_like_fn, self.proposal, self.cfg, self.n_chains,
                log_prob_block=self._log_prob_block, mesh=self.mesh)
        return self._fused_runner

    def _ensure_fused_runner_local(self):
        """The per-shard (wrap=False) runner for ChainPool.run_until,
        which embeds fused chunks inside its OWN shard_map program
        (same split as DreamZs's _fused_runner_local)."""
        if self._fused_runner_local is None:
            from bipymc_tpu.samplers.flowmh_fused import (
                make_flowmh_chunk_runner)
            self._fused_runner_local = make_flowmh_chunk_runner(
                self.log_like_fn, self.proposal, self.cfg, self.n_chains,
                log_prob_block=self._log_prob_block, mesh=self.mesh,
                wrap=False)
        return self._fused_runner_local

    def _fused_run(self, state, k_run, n_gens, t0):
        """Jit-cached fused segment (shared base-class cache)."""
        return self._run_fused_segment(
            self._ensure_fused_runner(), self._fused_jits,
            state, k_run, n_gens, t0)

    def _ensure(self, theta_0, spread):
        return self._ensure_population(
            theta_0, spread,
            init_fn=lambda x0: flowmh.init(x0, self.log_like_fn,
                                           self.proposal, self.cfg),
            step_factory=lambda axis: flowmh.make_step(
                self.log_like_fn, self.proposal, self.cfg,
                axis_name=axis),
            sharded_fields=flowmh.SHARDED_FIELDS,
            collect_fn=_flowmh_collect)

    def run_mcmc(self, n_gens, theta_0=None, thin=1, spread=1.0,
                 progress_every=None):
        state, k_run = self._ensure(theta_0, spread)
        use_fused = (self.fused and thin == 1 and progress_every is None)
        if self.fused and not use_fused:
            warnings.warn(
                "FlowMh(fused=True): thin != 1 / progress_every runs "
                "fall back to the per-generation engine (identical "
                "trajectories, slower). Use thin=1 and thin the "
                "history afterwards to keep the fused path.",
                UserWarning, stacklevel=2)
        if use_fused:
            # [per-gen alignment] -> [fused G-gen chunks] -> [per-gen
            # remainder] — the _RwSampler segment split; fused chunk
            # starts must sit on global-move boundaries
            # (t % global_every == 0)
            G = self.cfg.global_every
            t = self._steps_run
            n1 = min((G - t % G) % G, n_gens)
            n2 = ((n_gens - n1) // G) * G
            n3 = n_gens - n1 - n2
            segs = [(k, n) for k, n in (("pergen", n1), ("fused", n2),
                                        ("pergen", n3)) if n]
            for kind, n_seg in segs:
                t = self._steps_run
                if kind == "fused":
                    final_state, history = self._fused_run(
                        state, k_run, n_seg, t)
                else:
                    final_state, history = self._pool_obj.run(
                        state, k_run, n_seg, thin=1, t0=t)
                self._store(final_state, history, n_seg, thin=1)
                state = self._final_state
            return self
        final_state, history = self._pool_obj.run(
            state, k_run, n_gens, thin=thin, t0=self._steps_run,
            progress_every=progress_every)
        self._store(final_state, history, n_gens, thin=thin)
        return self

    def run_mcmc_until(self, theta_0=None, rhat_tol=1.05, chunk=100,
                       max_chunks=200, warmup_chunks=2, spread=1.0):
        state, k_run = self._ensure(theta_0, spread)
        chunk_runner = None
        if self.fused:
            # round the chunk UP to a multiple of global_every; an
            # unaligned continuation offset falls back to the
            # per-generation engine (same policy as DreamZs)
            G = self.cfg.global_every
            if chunk % G:
                chunk += G - chunk % G
            if self._steps_run % G == 0:
                chunk_runner = self._ensure_fused_runner_local()
            else:
                # same loud fallback as run_mcmc — a silent engine swap
                # is the exact bug class the round-4 A/B harness hit
                # (f308bdb); round-4 ADVICE asked for symmetry here
                warnings.warn(
                    "FlowMh(fused=True).run_mcmc_until: continuation "
                    f"offset {self._steps_run} is not aligned to "
                    f"global_every={G}; the whole run falls back to "
                    "the per-generation engine (identical "
                    "trajectories, slower). Align prior run lengths "
                    "to global_every to keep the fused path.",
                    UserWarning, stacklevel=2)
        final_state, info = self._pool_obj.run_until(
            state, k_run, rhat_tol=rhat_tol, chunk=chunk,
            max_chunks=max_chunks, warmup_chunks=warmup_chunks,
            t0=self._steps_run, chunk_runner=chunk_runner, fused_after=0)
        self._final_state = jax.block_until_ready(final_state)
        self._steps_run += int(info["steps"])
        return {k: np.asarray(v) for k, v in info.items()}

    @property
    def global_acceptance_fraction(self):
        """Per-chain global-move (proposal) acceptance over the kept
        history — the cross-mode transplant rate."""
        return self.acceptance_fraction

    @property
    def local_acceptance_fraction(self):
        """Per-chain mean local-RW acceptance over the kept history."""
        acc = np.swapaxes(self._history["accepted_local"], 0, 1)
        return np.asarray(acc.mean(axis=1))
