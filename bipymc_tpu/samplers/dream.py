"""DE-MC-z and DREAM-zs: archive-based differential-evolution MCMC.

ter Braak & Vrugt (2008) and Vrugt et al. (2009, 2011) — SURVEY.md
§4.6–4.7; accelerator-native replacement for the reference's ``DeMcZ`` /
``DreamZs`` classes and their mpi4py pool (`bipymc/dream.py` [U]).

One engine covers both samplers (DE-MC-z is DREAM-zs with δ=1, a single
CR=1 crossover value, and no CR adaptation). A generation is one pure step
over the population:

- difference vectors come from the archive Z (fixed-shape ring buffer,
  :mod:`bipymc_tpu.ensemble.archive`), so small populations work in high d;
- snooker updates with the (‖x*−z‖/‖xᵢ−z‖)^{d−1} Jacobian factor fire with
  probability ``p_snooker``;
- crossover (CR) subspace sampling with burn-in adaptation of the CR
  selection probabilities via normalised squared jumping distance;
- burn-in outlier-chain reset by the IQR rule on mean log-density;
- γ := 1 "mode-jumping" generations on a fixed schedule.

Population arrays are chain-sharded over a mesh axis; the archive and CR
state are replicated, with ``all_gather``/``psum`` replacing the
reference's MPI gather/Bcast (SURVEY.md §5.2). Burn-in-only adaptation is
gated by masks on the carried generation counter, so post-burn-in steps
are time-homogeneous and ergodicity is preserved (SURVEY.md §9).
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from bipymc_tpu.core.rng import bits_to_uniform, uniform_to_normal
from bipymc_tpu.ensemble.archive import (
    Archive, archive_append, archive_append_sharded,
    archive_gather_sharded)
from bipymc_tpu.ensemble.indices import distinct_from_bits
from bipymc_tpu.parallel.collectives import (
    all_gather_chains, chain_offset)


class DreamConfig(NamedTuple):
    """Static configuration. Defaults follow Vrugt et al. 2011 (DREAM-zs).

    Use :func:`demcz_config` for ter Braak & Vrugt 2008 DE-MC-z defaults.
    """

    n_chains: int
    delta_max: int = 3          # multi-pair differences, δ ~ U{1..δ_max}
    n_cr: int = 3               # crossover values CR_m = m/n_cr
    p_snooker: float = 0.1
    b: float = 1e-4             # e_j ~ U(−b, b), multiplicative (1+e) factor
    b_star: float = 1e-6        # ε_j ~ N(0, b*²) additive jitter
    jump_interval: int = 5      # γ := 1 every 5th generation
    archive_thin: int = 10      # append population to Z every K generations
    adapt_cr: bool = True       # CR selection-probability adaptation (burn-in)
    outlier_detect: bool = True # IQR outlier-chain reset (burn-in)
    outlier_interval: int = 10
    burnin_gens: int = 500      # adaptation window; frozen afterwards
    snooker_lo: float = 1.2     # γ_s ~ U(lo, hi)
    snooker_hi: float = 2.2
    use_archive: bool = True    # False → population-DREAM (Vrugt 2009):
                                # difference vectors from the current
                                # generation-start population, r₁≠r₂≠i
    jump_full_cr: bool = False   # force CR=1 (full-dimension crossover)
                                 # at γ=1 jump generations: a partial-dim
                                 # γ=1 move lands BETWEEN well-separated
                                 # modes and always rejects, so this
                                 # multiplies the inter-mode hop rate by
                                 # ~1/P(CR=1) on multimodal targets.
                                 # Off by default:
                                 # γ:=1 with the subspace still in effect
                                 # is the literature's letter and the
                                 # fidelity contract with the reference.
    shard_archive: bool = False  # shard Z block-wise over the chain mesh
                                 # axis and ring-pass (ppermute) blocks for
                                 # sampling — for archives too large to
                                 # replicate per device (SURVEY.md §7.7);
                                 # no-op on the single-device vmap path


def demcz_config(n_chains: int, **kw) -> DreamConfig:
    """DE-MC-z (ter Braak & Vrugt 2008): single pair, full-dim crossover,
    no CR adaptation, γ-jump every 10th generation (SURVEY.md §4.6)."""
    defaults = dict(delta_max=1, n_cr=1, adapt_cr=False,
                    outlier_detect=False, jump_interval=10)
    defaults.update(kw)
    return DreamConfig(n_chains=n_chains, **defaults)


def dream_config(n_chains: int, **kw) -> DreamConfig:
    """Population-DREAM (Vrugt et al. 2009, pre-zs): multi-pair
    differences from the *current population* (needs N ≥ 2δ_max+4 chains),
    CR adaptation, no snooker, no archive sampling (SURVEY.md §4.7)."""
    defaults = dict(use_archive=False, p_snooker=0.0)
    defaults.update(kw)
    return DreamConfig(n_chains=n_chains, **defaults)


class DreamState(NamedTuple):
    x: jax.Array          # [n_local, d] chain-sharded population
    logp: jax.Array       # [n_local]
    archive: Archive      # replicated
    cr_p: jax.Array       # [n_cr] CR selection probabilities (replicated)
    cr_cum: jax.Array     # [n_cr] normalised CDF of cr_p — carried so the
                          # per-generation inverse-CDF pick costs no cumsum
    cr_jump: jax.Array    # [n_cr] accumulated normalised sq jump dist Δ_m
    cr_count: jax.Array   # [n_cr] times CR_m was tried, L_m
    logp_sum: jax.Array   # [n_local] running Σ logp (outlier statistic)
    gen: jax.Array        # [] int32


class DreamInfo(NamedTuple):
    accepted: jax.Array   # [n_local] bool
    snooker: jax.Array    # [n_local] bool — proposal was a snooker move
    logp: jax.Array       # [n_local]


def init(x0: jax.Array, log_prob: Callable, cfg: DreamConfig,
         archive_capacity: int, z0: jax.Array) -> DreamState:
    """x0: [n_local, d] initial population; z0: [k, d] initial archive rows.

    ter Braak–Vrugt require the initial archive to hold at least
    max(2·δ_max, 3) + 1 rows; seed it with overdispersed prior draws
    (``utils.var_ball``). z0 must be identical on every shard.
    """
    logp = jax.vmap(log_prob)(x0)
    n_cr = cfg.n_cr
    cr_p = jnp.full((n_cr,), 1.0 / n_cr, dtype=x0.dtype)
    return DreamState(
        x=x0,
        logp=logp,
        archive=archive_init_checked(z0, archive_capacity, cfg),
        cr_p=cr_p,
        cr_cum=jnp.cumsum(cr_p / jnp.sum(cr_p)),
        cr_jump=jnp.zeros((n_cr,), dtype=x0.dtype),
        cr_count=jnp.zeros((n_cr,), dtype=x0.dtype),
        logp_sum=jnp.zeros_like(logp),
        gen=jnp.zeros((), jnp.int32),
    )


def archive_init_checked(z0, capacity, cfg: DreamConfig):
    from bipymc_tpu.ensemble.archive import archive_init
    # one proposal draws max(2·δ_max, 3) distinct rows (branches share)
    need = max(2 * cfg.delta_max, 3)
    if z0.shape[0] < need:
        raise ValueError(
            f"initial archive needs ≥ {need} rows for δ_max={cfg.delta_max}"
            f" / snooker draws; got {z0.shape[0]}")
    return archive_init(z0, capacity)


def propose_math_one(cfg: DreamConfig, x_i, u_scal, rows, cr_idx, u_mask,
                     u_e, eps_n, gamma_jump, dtype):
    """Deterministic DREAM-zs proposal math for ONE chain (jnp).

    The per-generation engine vmaps this over the population; the fused
    kernel's block form (ops/dream_proposal.propose_block) is held to it
    by tests/test_dream_pallas.py. rows: [max(2·δ_max, 3), d] archive
    rows. Returns (x_star [d], log_jac [], is_snooker [] bool).
    """
    n_pairs = cfg.delta_max
    d = x_i.shape[-1]
    # ---------- parallel-direction move (§4.7) -----------------------
    delta = 1 + jnp.floor(u_scal[1] * n_pairs).astype(jnp.int32)
    delta = jnp.minimum(delta, n_pairs)          # guard u == 1.0 edge
    pair_mask = (jnp.arange(n_pairs) < delta).astype(dtype)[:, None]
    z1 = rows[0:n_pairs]
    z2 = rows[n_pairs:2 * n_pairs]
    diff = jnp.sum(pair_mask * (z1 - z2), axis=0)

    cr = (cr_idx + 1).astype(dtype) / cfg.n_cr
    if cfg.jump_full_cr:
        # full-dimension crossover on γ=1 jump generations (mode-
        # transplant enhancement; see DreamConfig.jump_full_cr)
        cr = jnp.where(gamma_jump, jnp.asarray(1.0, dtype), cr)
    u = u_mask
    mask = u < cr
    # guarantee at least one crossed-over dimension
    mask = mask.at[jnp.argmin(u)].set(True)
    d_eff = jnp.sum(mask).astype(dtype)

    gamma = 2.38 / jnp.sqrt(2.0 * delta.astype(dtype) * d_eff)
    gamma = jnp.where(gamma_jump, jnp.asarray(1.0, dtype), gamma)
    e = cfg.b * (2.0 * u_e - 1.0)                # U(−b, b)
    eps = cfg.b_star * eps_n
    x_par = x_i + mask * ((1.0 + e) * gamma * diff + eps)

    # ---------- snooker move (§4.6) ----------------------------------
    z, zr1, zr2 = rows[0], rows[1], rows[2]
    u_dir = x_i - z
    # HIGHEST: no TF32 in the projections the Jacobian below depends on
    hi = jax.lax.Precision.HIGHEST
    denom = jnp.maximum(jnp.dot(u_dir, u_dir, precision=hi), 1e-30)
    proj = lambda v: z + (jnp.dot(v - z, u_dir, precision=hi) / denom) * u_dir
    gamma_s = cfg.snooker_lo + \
        (cfg.snooker_hi - cfg.snooker_lo) * u_scal[2]
    x_snk = x_i + gamma_s * (proj(zr1) - proj(zr2))
    # Jacobian factor (‖x*−z‖/‖xᵢ−z‖)^{d−1} in log space
    log_jac_snk = (d - 1) * 0.5 * (
        jnp.log(jnp.maximum(jnp.sum((x_snk - z) ** 2), 1e-30))
        - jnp.log(denom))

    is_snooker = (cfg.p_snooker > 0.0) & (u_scal[0] < cfg.p_snooker)
    x_star = jnp.where(is_snooker, x_snk, x_par)
    log_jac = jnp.where(is_snooker, log_jac_snk, 0.0)
    return x_star, log_jac, is_snooker


def make_step(log_prob: Callable, cfg: DreamConfig, axis_name=None,
              draws_fn: Callable | None = None) -> Callable:
    """Build ``step(state, key, t) -> (state, info)`` for the population.

    draws_fn: optional override of the per-proposal randomness for
    injected-stream fidelity tests (SURVEY.md §6 contract (a)). Signature
    ``(t, i_global, d, dtype) -> (u_scal [3], row_idx [n_rows] int32,
    cr_idx int32, u_ue [2, d], eps_n [d], u_acc [])`` — u_scal packs the
    [snooker coin, delta uniform, gamma_s uniform]; row_idx indexes the
    archive buffer (use_archive) or the gathered population; u_ue packs
    the crossover uniforms and the e-jitter uniforms; u_acc is the accept
    uniform. Default: jax.random draws (the production path).
    """
    n_pairs = cfg.delta_max
    if cfg.shard_archive and not cfg.use_archive:
        raise ValueError("shard_archive requires use_archive=True "
                         "(population-DREAM keeps no archive)")

    # rows drawn per proposal: the parallel move needs 2·δ_max, the
    # snooker move 3 — only ONE branch fires per step, and any subset of
    # a uniform distinct draw is itself a uniform distinct draw, so the
    # two branches can share one draw of max(2·δ_max, 3) rows.
    n_rows = max(2 * n_pairs, 3)

    def step(state: DreamState, key: jax.Array, t: jax.Array):
        n_local, d = state.x.shape
        dtype = state.x.dtype
        offset = chain_offset(n_local, axis_name)
        gamma_jump = (state.gen % cfg.jump_interval) == (cfg.jump_interval - 1)
        in_burnin = state.gen < cfg.burnin_gens

        i_locals = jnp.arange(n_local, dtype=jnp.int32)
        x_full = (all_gather_chains(state.x, axis_name)
                  if not cfg.use_archive else state.x)
        if draws_fn is None:
            # ALL per-generation randomness as one batched bits block (two
            # threefry launches: fold_in + block) — the per-draw-site
            # split+draw pattern measured at a third of the whole step.
            # Per-chain word layout: [u_scal(3) | u_cr | u_acc |
            # row_bits(n_rows) | u_ue(2d) | eps(d)]. Streams key on the
            # GLOBAL chain id, so vmap and shard_map paths stay identical.
            n_words = 5 + n_rows + 3 * d
            gid = offset + i_locals
            chain_keys = jax.vmap(
                lambda i: jax.random.fold_in(key, i))(gid)
            blk = jax.vmap(lambda k: jax.random.bits(
                k, (n_words,), jnp.uint32))(chain_keys)
            # one whole-block word→uniform pass; the slices below fuse
            # into their consumers instead of launching per-slice kernels
            u_all = bits_to_uniform(blk, dtype)
            u_scal = u_all[:, 0:3]
            u_cr = u_all[:, 3]
            u_acc = u_all[:, 4]
            row_bits = blk[:, 5:5 + n_rows]
            off_w = 5 + n_rows
            u_mask = u_all[:, off_w:off_w + d]
            u_e = u_all[:, off_w + d:off_w + 2 * d]
            eps_n = uniform_to_normal(u_all[:, off_w + 2 * d:])
            if cfg.use_archive:
                row_idx = jax.vmap(
                    lambda b: distinct_from_bits(
                        b, n_rows, state.archive.fill))(row_bits)
            else:
                # population-DREAM: r-chains from the generation-start
                # population, all distinct and ≠ i (SURVEY.md §4.5/§4.7)
                row_idx = jax.vmap(
                    lambda b, i: distinct_from_bits(
                        b, n_rows, cfg.n_chains, exclude=i))(row_bits, gid)
            # CR index by inverse CDF over the selection probabilities
            # (same law as random.choice(p=cr_p); the CDF is carried in
            # state so no per-generation cumsum kernels)
            cr_idx = jnp.minimum(
                jnp.sum(u_cr[:, None] >= state.cr_cum[None, :], axis=1),
                cfg.n_cr - 1).astype(jnp.int32)
        else:
            u_scal, row_idx, cr_idx, u_ue, eps_n, u_acc = jax.vmap(
                lambda i_l: draws_fn(t, offset + i_l, d, dtype))(i_locals)
            u_mask, u_e = u_ue[:, 0], u_ue[:, 1]
        if cfg.use_archive and cfg.shard_archive and axis_name is not None:
            rows = archive_gather_sharded(
                state.archive.buf, row_idx, axis_name)
        elif cfg.use_archive:
            rows = state.archive.buf[row_idx]              # [n_local, n_rows, d]
        else:
            rows = x_full[row_idx]
        x_star, log_jac, is_snk = jax.vmap(
            lambda xi, us, rw, ci, um, ue, ep: propose_math_one(
                cfg, xi, us, rw, ci, um, ue, ep, gamma_jump, dtype)
        )(state.x, u_scal, rows, cr_idx, u_mask, u_e, eps_n)

        logp_star = jax.vmap(log_prob)(x_star)             # dominant cost
        log_u = jnp.log(u_acc)
        log_alpha = jnp.minimum(0.0, logp_star - state.logp + log_jac)
        # guard NaN/-inf proposals (out-of-support): always reject
        log_alpha = jnp.where(jnp.isfinite(logp_star), log_alpha, -jnp.inf)
        acc = log_u < log_alpha
        x_new = jnp.where(acc[:, None], x_star, state.x)
        logp_new = jnp.where(acc, logp_star, state.logp)
        logp_sum = state.logp_sum + logp_new

        # Population-level schedule blocks below run under lax.cond — the
        # predicates are replicated (generation-counter based), so all
        # shards take the same branch and the collectives inside stay
        # congruent; unlike the vmapped proposal math (where cond lowers
        # to select anyway), cond here genuinely skips the work on the
        # ~90% of generations where it's off.

        # ---------- CR adaptation statistics (burn-in only, §4.7) --------
        if cfg.adapt_cr:
            def adapt_cr(_):
                # population std per dim from generation-start positions.
                # Cross-chain reductions go through all_gather + the SAME
                # full-axis reduce as the vmap path — NOT psum of
                # per-device partials, whose different float association
                # breaks vmap↔shard_map bit-identity once the CR
                # probabilities feed back into proposals (caught by an
                # end-to-end probe at 64 chains / d=16; the d=2 sharding
                # test had never hit a rounding divergence).
                n_total = jnp.asarray(cfg.n_chains, dtype)
                x_all = all_gather_chains(state.x, axis_name)      # [N, d]
                s1 = jnp.sum(x_all, axis=0)
                s2 = jnp.sum(x_all ** 2, axis=0)
                var = jnp.maximum(s2 / n_total - (s1 / n_total) ** 2, 1e-30)
                jump2 = jnp.sum((x_new - state.x) ** 2 / var, axis=1)
                # attribute each jump to the CR the move ACTUALLY used:
                # with jump_full_cr the γ=1 generations run CR=1
                # regardless of the drawn cr_idx, so credit the top bin
                # or low-CR bins get trained on full-dimension jump
                # distances they never produce
                cr_used = cr_idx
                if cfg.jump_full_cr:
                    cr_used = jnp.where(gamma_jump, cfg.n_cr - 1, cr_idx)
                onehot = jax.nn.one_hot(
                    all_gather_chains(cr_used, axis_name), cfg.n_cr,
                    dtype=dtype)                                   # [N, n_cr]
                jump2_all = all_gather_chains(jump2, axis_name)    # [N]
                d_jump = onehot.T @ jump2_all
                d_count = jnp.sum(onehot, axis=0)
                cr_jump = state.cr_jump + d_jump
                cr_count = state.cr_count + d_count
                rate = cr_jump / jnp.maximum(cr_count, 1.0)
                cr_p_new = rate / jnp.maximum(jnp.sum(rate), 1e-30)
                # adapt only once every CR value has some mass (and at
                # least one jump actually moved, else keep the old p)
                use_new = (jnp.min(cr_count) > 4.0) & \
                    jnp.all(jnp.isfinite(cr_p_new)) & (jnp.sum(rate) > 0)
                cr_p = jnp.where(use_new, cr_p_new, state.cr_p)
                return (cr_p, jnp.cumsum(cr_p / jnp.sum(cr_p)),
                        cr_jump, cr_count)

            cr_p, cr_cum, cr_jump, cr_count = jax.lax.cond(
                in_burnin, adapt_cr,
                lambda _: (state.cr_p, state.cr_cum, state.cr_jump,
                           state.cr_count),
                operand=None)
        else:
            cr_jump, cr_count, cr_p, cr_cum = (
                state.cr_jump, state.cr_count, state.cr_p, state.cr_cum)

        # ---------- outlier-chain reset (burn-in only, §4.7) -------------
        if cfg.outlier_detect:
            check = in_burnin & (state.gen > 0) & \
                ((state.gen % cfg.outlier_interval) ==
                 (cfg.outlier_interval - 1))

            def reset_outliers(args):
                x_new, logp_new, logp_sum = args
                mean_lp_local = logp_sum / (state.gen + 1).astype(dtype)
                mean_lp = all_gather_chains(mean_lp_local, axis_name)  # [N]
                q1 = jnp.quantile(mean_lp, 0.25)
                q3 = jnp.quantile(mean_lp, 0.75)
                lo = q1 - 2.0 * (q3 - q1)
                is_outlier = mean_lp_local < lo
                # reset outliers to the current global best chain
                lp_all = all_gather_chains(logp_new, axis_name)
                x_all = all_gather_chains(x_new, axis_name)
                best = jnp.argmax(lp_all)
                best_sum = all_gather_chains(logp_sum, axis_name)[best]
                return (jnp.where(is_outlier[:, None], x_all[best], x_new),
                        jnp.where(is_outlier, lp_all[best], logp_new),
                        jnp.where(is_outlier, best_sum, logp_sum))

            x_new, logp_new, logp_sum = jax.lax.cond(
                check, reset_outliers, lambda args: args,
                (x_new, logp_new, logp_sum))

        # ---------- archive append every K generations -------------------
        do_append = (state.gen % cfg.archive_thin) == (cfg.archive_thin - 1)
        if cfg.shard_archive and axis_name is not None:
            append_fn = lambda ar: archive_append_sharded(
                ar, all_gather_chains(x_new, axis_name), axis_name)
        else:
            append_fn = lambda ar: archive_append(
                ar, all_gather_chains(x_new, axis_name))
        archive = jax.lax.cond(
            do_append, append_fn, lambda ar: ar, state.archive)

        new_state = DreamState(
            x=x_new, logp=logp_new, archive=archive,
            cr_p=cr_p, cr_cum=cr_cum, cr_jump=cr_jump, cr_count=cr_count,
            logp_sum=logp_sum, gen=state.gen + 1)
        return new_state, DreamInfo(accepted=acc, snooker=is_snk,
                                    logp=logp_new)

    return step
