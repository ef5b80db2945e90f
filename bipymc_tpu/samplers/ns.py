"""Nested sampling: log-evidence + posterior from one run.

Beyond-reference extra (the reference — SURVEY.md §3 — is MCMC-only).
Nested sampling (Skilling 2006) integrates the evidence

    Z = ∫ L(θ) π(θ) dθ = ∫₀¹ L(X) dX

by maintaining K "live" points drawn uniformly from the prior subject
to a rising likelihood floor L*: at each step the worst live point dies
(its prior volume X shrinks by a known factor), contributes L·ΔX to Z,
and is replaced by a fresh prior draw constrained to L > L*. The dead
points, weighted by L·ΔX/Z, ARE posterior samples — so one run yields
the evidence (with an error bar), the posterior, and — because the
likelihood floor rises through every basin simultaneously — natural
multimodality handling with correct mode weights, the same two
deliverables as samplers/smc.py by a complementary mechanism (no
annealing path or reference density to choose; the prior is the
reference).

Parameterisation follows the standard unit-hypercube contract
(MultiNest/dynesty): the user supplies ``prior_transform(u) -> θ``
mapping u ~ U[0,1]^d through the prior's inverse CDF, and
``log_like(θ)``. The prior is then *uniform on the cube*, so the
constrained-replacement kernel is pure geometry: any symmetric move
accepted iff L(θ(u')) > L* leaves the constrained uniform distribution
invariant.

accelerator-native design — batched deaths, one while_loop:

- Classic NS kills ONE point per iteration: a serial, scalar-bound
  recursion. Here each iteration kills the B = ``n_batch`` worst live
  points at once and replaces all B in parallel — the likelihood is
  evaluated [B]-batched (vmap → matmul-friendly), and the volume
  bookkeeping stays exact via the sequential view: the j-th death
  (j = 0..B-1, ascending L) occurs with K−j points alive, so its log-
  volume decrement is E[log t] = 1/(K−j) and its width is
  w_j = X_{j-1} − X_j (the "dying" treatment of dynamic nested
  sampling, Higson et al. 2019; B = 1 recovers Skilling exactly).
  The B replacements then all sample the SAME constraint
  L > L* = max(dead L), which is the constrained region after all B
  deaths — survivors are uniform there by construction, so each
  replacement starts at a uniformly-chosen survivor and stays in
  distribution through the symmetric constrained walk.
- The constrained kernel (both variants build on survivor-pair DE
  directions, the move vocabulary of this package — self-scaled to
  the instantaneous constrained geometry, the reason MultiNest fits
  ellipsoids, for free):
  * ``kernel="slice"`` (default): slice sampling along each DE
    direction (PolyChord; dynesty's "rslice") — the constrained
    target is an indicator, so each rep draws EXACTLY uniformly on
    the 1-D slice {t : in-cube ∧ L > L*} by stepping-out + shrinkage
    (Neal's budget split for capped expansion, as in enslice.py).
    No scale knob, no rejected-stay clustering.
  * ``kernel="walk"``: u' = reflect(u + γ·j·(u_a − u_b)), j ~
    U(0.5, 1.5), reflection at the cube faces (symmetric), accepted
    iff the likelihood clears L*; γ Robbins–Monro-adapts across
    batches toward ``target_accept`` (frozen within a batch, so each
    batch's kernel is a fixed symmetric kernel).
  Measured: imperfect replacement decorrelation
  biases logZ HIGH (clustered replacements slow the order-statistics
  shrinkage), and the walk needs ~3–4× the likelihood evals of the
  slice kernel to push the bias under the √(H/K) error bar — slice
  at ≈ d–2d direction updates is unbiased at the error-bar level.
  Replacement starts are B DISTINCT survivors (Gumbel-top-B), which
  measurably cuts the same bias at fixed evals.
- The whole run is ONE ``lax.while_loop``: fixed-capacity dead buffers
  ([max_batches·B]) written by ``dynamic_update_slice`` at the batch
  index, streaming (logZ, H) updated by a tiny in-batch scan over the
  B dead points (Skilling's information recursion, giving the
  standard uncertainty logZ_err = √(H/K)), termination when the
  maximum possible remaining contribution L_max·X adds less than
  ``stop_dlogz`` to logZ.
- Parallelism: live-set state is replicated; the B replacement walkers
  are the sharded axis under ``mesh=`` (all cross-walker decisions —
  top_k, widths, evidence — are replicated full-population math;
  per-walker RNG folds by GLOBAL walker index, so mesh and vmap paths
  see identical streams — the gather-then-reduce rule).

Scope limits, stated plainly: the constrained DE walk assumes the live
set spans the constrained region — like every region-based replacement
kernel (MultiNest ellipsoids included) it can under-explore a mode the
live set has entirely lost (mitigate with more live points, the
standard control); and ``n_mcmc`` trades replacement independence
against cost exactly like dynesty's ``walks``. Widths use the
expectation E[log t] (Skilling's choice); the √(H/K) error bar covers
the t-scatter.
"""

import math
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from bipymc_tpu.parallel.collectives import (all_gather_chains,
                                             chain_offset)


class NsConfig(NamedTuple):
    """Static configuration.

    n_live: live-point count K — the resolution of the volume ladder;
        logZ_err ≈ √(H/K) so quadruple K to halve the error bar.
    n_batch: deaths/replacements per iteration B (the batched axis;
        must be ≤ n_live // 2 so survivors dominate the start pool).
    n_mcmc: replacement reps (dynesty's ``walks``) — constrained-walk
        steps (kernel="walk": one [B]-batched likelihood eval each) or
        slice direction-updates (kernel="slice": ~4–8 evals each,
        batch-max under vmap).
    max_batches: while_loop bound and dead-buffer capacity
        (max_batches·n_batch dead points). Hitting it is surfaced in
        the result, not silent.
    stop_dlogz: stop when log(Z + L_max·X) − log Z < stop_dlogz.
    kernel: replacement move. "slice" (default): slice sampling along
        DE directions (PolyChord / dynesty-"rslice") — each rep draws
        a survivor-pair direction and samples EXACTLY uniformly on the
        1-D slice {t : u + t·dir in-cube ∧ L > L*} by stepping-out +
        shrinkage; no scale knob, and no rejected-stay clustering, so
        the replacement-decorrelation logZ bias of a random walk is
        structurally absent (measured: the "walk" kernel needs ~4×
        the evals for the same bias level).
        "walk": γ-scaled DE random walk accepted on the constraint
        (cheaper per rep on eval-dominated targets; scale adapted).
    gamma0: initial DE step scale γ (kernel="walk"); None → 2.38/√(2d).
    target_accept: cross-batch Robbins–Monro target for the
        constrained-walk acceptance (kernel="walk"; 0.5: the move is
        pure volume probing, not a Gaussian-optimal RW).
    adapt_gamma: freeze γ at gamma0 when False (kernel="walk").
    max_expand / max_shrink: stepping-out budget (Neal's split) and
        shrinkage cap per slice rep (kernel="slice").
    """

    n_live: int = 1024
    n_batch: int = 64
    n_mcmc: int = 30
    max_batches: int = 2000
    stop_dlogz: float = 1e-3
    gamma0: float | None = None
    target_accept: float = 0.5
    adapt_gamma: bool = True
    kernel: str = "slice"
    max_expand: int = 8
    max_shrink: int = 30


class NsState(NamedTuple):
    """Carry of the batch while_loop. Everything is REPLICATED under
    ``mesh=`` (the sharded axis — the B replacement walkers — lives
    only inside the batch body)."""

    u: jax.Array          # [K, d] live points (unit cube)
    ll: jax.Array         # [K] live log-likelihoods
    logx: jax.Array       # [] current log prior volume
    logz: jax.Array       # [] accumulated log evidence
    h: jax.Array          # [] information ∫ p log(L/Z) dX (running)
    it: jax.Array         # [] int32 batches completed
    log_gamma: jax.Array  # [] adapted DE scale
    key: jax.Array
    dead_u: jax.Array     # [max_batches*B, d]
    dead_ll: jax.Array    # [max_batches*B]
    dead_logw: jax.Array  # [max_batches*B] log prior width (-inf = unused)
    acc_hist: jax.Array   # [max_batches] constrained-move acceptance
    ev_hist: jax.Array    # [max_batches] mean likelihood evals per
                          #   walker-rep (1.0 for kernel="walk"; the
                          #   stepping-out + shrinkage count for
                          #   "slice" — logical per-walker evals, the
                          #   standard NS efficiency metric; device
                          #   cost is the batch-max, as in enslice.py)


class NsResult(NamedTuple):
    u: jax.Array          # [max_batches*B + K, d] dead then live points
    logl: jax.Array       # [same] log-likelihoods
    logw: jax.Array       # [same] log posterior weights (normalised;
                          #        -inf on unused dead-buffer slots)
    log_evidence: jax.Array
    log_evidence_err: jax.Array
    h: jax.Array
    n_batches: jax.Array
    terminated: jax.Array  # bool — stop_dlogz reached before max_batches
    acc_hist: jax.Array
    ev_hist: jax.Array


def ns_config(**kw) -> NsConfig:
    cfg = NsConfig(**kw)
    if cfg.n_batch > cfg.n_live // 2:
        raise ValueError(
            f"n_batch={cfg.n_batch} must be <= n_live//2="
            f"{cfg.n_live // 2} (survivors seed the replacements)")
    if cfg.n_batch < 1 or cfg.n_live < 4:
        raise ValueError("need n_batch >= 1 and n_live >= 4")
    if cfg.kernel not in ("slice", "walk"):
        raise ValueError(
            f"kernel must be 'slice' or 'walk', got {cfg.kernel!r}")
    if cfg.max_expand < 1 or cfg.max_shrink < 1:
        raise ValueError("max_expand and max_shrink must be >= 1")
    return cfg


def _zh_update(carry, lw_ll):
    """One step of Skilling's streaming (logZ, H) recursion:
    Z' = Z + wL;  H' = (wL/Z')·logL + (Z/Z')·(H + logZ) − logZ'.
    Guards the two 0·inf corners explicitly: a zero contribution with
    logL = −inf, and the very first contribution where logZ = −inf."""
    logz, h = carry
    lw, llj = lw_ll
    lc = lw + llj
    logz2 = jnp.logaddexp(logz, lc)
    a = jnp.exp(lc - logz2)
    b = jnp.exp(logz - logz2)
    zero = jnp.zeros((), logz.dtype)
    term_a = jnp.where(a > 0.0, a * llj, zero)
    term_b = jnp.where(b > 0.0, b * (h + logz), zero)
    h2 = term_a + term_b - logz2
    # all contributions so far -inf (e.g. a dead-on-arrival model):
    # keep H at 0 rather than inf
    h2 = jnp.where(jnp.isfinite(logz2), h2, zero)
    return (logz2, h2), None


def _reflect01(u):
    """Reflect into [0,1]: symmetric (an involution composed with
    translation), so the MH ratio stays 1 for any step size."""
    r = jnp.mod(u, 2.0)
    return jnp.where(r > 1.0, 2.0 - r, r)


def init(key: jax.Array, prior_transform: Callable, log_like: Callable,
         cfg: NsConfig, n_dim: int, dtype=jnp.float32) -> NsState:
    """Draw the K initial live points from the full prior (u ~ U[0,1]^d).

    Non-finite log-likelihoods are clamped to -inf (the sanitizer
    policy used across the package): such points die first and
    contribute nothing.
    """
    u0 = jax.random.uniform(key, (cfg.n_live, n_dim), dtype)
    ll0 = jax.vmap(lambda u: log_like(prior_transform(u)))(u0)
    ll0 = jnp.nan_to_num(ll0.astype(dtype), nan=-jnp.inf, posinf=-jnp.inf)
    gamma0 = (cfg.gamma0 if cfg.gamma0 is not None
              else 2.38 / math.sqrt(2.0 * n_dim))
    cap = cfg.max_batches * cfg.n_batch
    return NsState(
        u=u0, ll=ll0,
        logx=jnp.zeros((), dtype),
        logz=jnp.asarray(-jnp.inf, dtype),
        h=jnp.zeros((), dtype),
        it=jnp.int32(0),
        log_gamma=jnp.asarray(math.log(gamma0), dtype),
        key=jax.random.key(0),
        dead_u=jnp.zeros((cap, n_dim), dtype),
        dead_ll=jnp.full((cap,), -jnp.inf, dtype),
        dead_logw=jnp.full((cap,), -jnp.inf, dtype),
        acc_hist=jnp.zeros((cfg.max_batches,), dtype),
        ev_hist=jnp.zeros((cfg.max_batches,), dtype))


def make_runner(prior_transform: Callable, log_like: Callable,
                cfg: NsConfig, axis_name=None) -> Callable:
    """Build ``run(state, key) -> (final_state, NsResult)`` — jittable,
    axis-optional (vmap path when axis_name is None, shard_map body
    otherwise; the sharded axis is the B replacement walkers)."""
    K, B, M = cfg.n_live, cfg.n_batch, cfg.n_mcmc
    # stop when ll_max + logx - logz < log(e^stop_dlogz - 1): exactly
    # log1p(exp(rem)) < stop_dlogz without ever exponentiating rem
    log_stop = math.log(math.expm1(cfg.stop_dlogz))

    def ll_of(u):
        out = log_like(prior_transform(u))
        return jnp.nan_to_num(out, nan=-jnp.inf, posinf=-jnp.inf)

    def batch_body(s: NsState) -> NsState:
        d = s.u.shape[1]
        dtype = s.u.dtype
        k_it = jax.random.fold_in(s.key, s.it)
        k_start, k_move = jax.random.split(k_it)

        # ---- deaths: the B smallest log-likelihoods, ascending -------
        neg_lld, idx_dead = lax.top_k(-s.ll, B)      # descending -ll
        ll_dead = -neg_lld                           # ascending ll
        l_star = ll_dead[B - 1]                      # constraint floor

        # ---- exact sequential volume bookkeeping ----------------------
        # j-th death happens with K-j alive: Δlog X_j = 1/(K-j)
        dec = 1.0 / (K - jnp.arange(B, dtype=dtype))         # [B]
        logx_at = s.logx - jnp.cumsum(dec)                   # X_j
        logx_prev = logx_at + dec                            # X_{j-1}
        # width w_j = X_{j-1} - X_j = X_{j-1}(1 - e^{-dec_j})
        logw = logx_prev + jnp.log(-jnp.expm1(-dec))         # [B]
        logx_new = logx_at[B - 1]

        # ---- streaming (logZ, H): Skilling's recursion over the B ----
        (logz_new, h_new), _ = lax.scan(_zh_update, (s.logz, s.h),
                                        (logw, ll_dead))

        # ---- record the dead batch ------------------------------------
        off = s.it * B
        dead_u = lax.dynamic_update_slice_in_dim(
            s.dead_u, s.u[idx_dead], off, 0)
        dead_ll = lax.dynamic_update_slice_in_dim(s.dead_ll, ll_dead,
                                                  off, 0)
        dead_logw = lax.dynamic_update_slice_in_dim(s.dead_logw, logw,
                                                    off, 0)

        # ---- replacements: B constrained DE walks ----------------------
        # survivor mask as categorical logits (dead slots excluded from
        # starts and DE pairs — they sit BELOW the new floor)
        logits = jnp.zeros((K,), dtype).at[idx_dead].set(-jnp.inf)
        gamma = jnp.exp(s.log_gamma)

        # local slice of the B walkers (sharded axis under mesh=);
        # lax.axis_size is static, so b_local is a compile-time shape
        b_local = B // (1 if axis_name is None
                        else lax.axis_size(axis_name))
        w_off = chain_offset(b_local, axis_name)
        gids = w_off + jnp.arange(b_local, dtype=jnp.int32)  # global ids

        # B DISTINCT survivor starts via Gumbel-top-B (duplicate starts
        # measurably slow replacement decorrelation — clustered walkers
        # bias the next batch's order statistics); computed replicated
        # (no per-walker fold) and sliced by global id, mesh-invariant
        gumb = jax.random.gumbel(k_start, (K,), dtype)
        _, start_idx = lax.top_k(gumb + logits, B)   # [B] distinct
        idx_l = lax.dynamic_slice_in_dim(start_idx, w_off, b_local, 0)
        u_w, ll_w = s.u[idx_l], s.ll[idx_l]          # [b_local, d], [..]

        def walk_step(carry, m):
            u_c, ll_c = carry

            def one(uw, g):
                km = jax.random.fold_in(jax.random.fold_in(k_move, m), g)
                ka, kb, kj, _ = jax.random.split(km, 4)
                ia = jax.random.categorical(ka, logits)
                ib = jax.random.categorical(kb, logits)
                jit = jax.random.uniform(kj, (), dtype, 0.5, 1.5)
                return _reflect01(uw + gamma * jit * (s.u[ia] - s.u[ib]))

            u_p = jax.vmap(one)(u_c, gids)
            ll_p = jax.vmap(ll_of)(u_p).astype(dtype)
            # accept iff above the floor (uniform constrained target;
            # a==b collisions propose a zero step whose ll_p equals
            # ll_c > l_star — counted accepted, a no-op)
            acc = ll_p > l_star
            return (jnp.where(acc[:, None], u_p, u_c),
                    jnp.where(acc, ll_p, ll_c)), \
                (acc, jnp.ones_like(ll_c))

        def slice_one(uw, llw, g, m):
            """One slice direction-update: exact uniform draw on the
            1-D slice {t : u + t·dir in-cube ∧ L(θ(u+t·dir)) > L*}.
            The constrained target is an INDICATOR, so there is no
            height draw — the slice is the constraint itself; out-of-
            cube points have prior density 0 and lie off the slice.
            Stepping-out uses Neal's budget split (required for the
            reversibility of capped expansion — same construction as
            samplers/enslice.py); shrinkage always straddles t=0, and
            the shrink-cap fallback is the current point."""
            km = jax.random.fold_in(jax.random.fold_in(k_move, m), g)
            ka, kb, kv, kj = jax.random.split(km, 4)
            ia = jax.random.categorical(ka, logits)
            ib = jax.random.categorical(kb, logits)
            dirv = s.u[ia] - s.u[ib]

            def probe(t):
                up = uw + t * dirv
                inside = jnp.all((up >= 0.0) & (up <= 1.0))
                llp = ll_of(up).astype(dtype)
                llp = jnp.where(inside, llp, -jnp.inf)
                return llp, up

            def in_slice(t):
                llp, _ = probe(t)
                return llp > l_star

            v0 = jax.random.uniform(kv, (), dtype)
            ub = jax.random.uniform(kj, (), dtype)
            j_budget = jnp.minimum(
                jnp.floor(ub * cfg.max_expand).astype(jnp.int32),
                cfg.max_expand - 1)
            k_budget = jnp.int32(cfg.max_expand - 1) - j_budget

            def expand(t0, step, budget):
                def cond_e(c):
                    t, n = c
                    return (n < budget) & in_slice(t)

                def body_e(c):
                    t, n = c
                    return t + step, n + 1

                return lax.while_loop(
                    cond_e, body_e, (t0, jnp.zeros((), jnp.int32)))

            t_lo, n_l = expand(-v0, jnp.asarray(-1.0, dtype), j_budget)
            t_hi, n_r = expand(1.0 - v0, jnp.asarray(1.0, dtype),
                               k_budget)

            k_loop = jax.random.fold_in(km, jnp.uint32(0x534C4943))

            def body_s(c):
                lo, hi, u_cur, ll_cur, it, acc = c
                r = jax.random.uniform(
                    jax.random.fold_in(k_loop, it), (), dtype)
                t = lo + r * (hi - lo)
                llp, up = probe(t)
                ok = llp > l_star
                lo_n = jnp.where(ok | (t >= 0), lo, t)
                hi_n = jnp.where(ok | (t < 0), hi, t)
                return (lo_n, hi_n,
                        jnp.where(ok, up, u_cur), jnp.where(ok, llp, ll_cur),
                        it + 1, acc | ok)

            def cond_s(c):
                _, _, _, _, it, acc = c
                return jnp.logical_not(acc) & (it < cfg.max_shrink)

            carry0 = (t_lo, t_hi, uw, llw, jnp.zeros((), jnp.int32),
                      jnp.zeros((), bool))
            (_, _, u_new, ll_new, it_s, acc) = lax.while_loop(
                cond_s, body_s, carry0)
            # logical evals: each expand cond probes once per check
            # (n+1 checks for n expansions — the & is not short-circuit,
            # so the budget-exhausted check still probes), plus one
            # probe per shrink iteration
            n_ev = n_l + n_r + it_s + 2
            return u_new, ll_new, acc, n_ev

        def slice_step(carry, m):
            u_c, ll_c = carry
            u_n, ll_n, acc, n_ev = jax.vmap(
                lambda uw, llw, g: slice_one(uw, llw, g, m))(
                    u_c, ll_c, gids)
            return (u_n, ll_n), (acc, n_ev.astype(dtype))

        step_fn = slice_step if cfg.kernel == "slice" else walk_step
        (u_w, ll_w), (accs, evs) = lax.scan(
            step_fn, (u_w, ll_w), jnp.arange(M, dtype=jnp.int32))

        # gather-then-reduce: assemble the GLOBAL B new points so the
        # live-set update and acceptance stats are replicated math
        u_new = all_gather_chains(u_w, axis_name)     # [B, d]
        ll_new = all_gather_chains(ll_w, axis_name)   # [B]
        acc_g = all_gather_chains(accs.T.astype(dtype), axis_name)
        acc_rate = jnp.mean(acc_g)
        ev_g = all_gather_chains(evs.T, axis_name)
        ev_mean = jnp.mean(ev_g)

        u2 = s.u.at[idx_dead].set(u_new)
        ll2 = s.ll.at[idx_dead].set(ll_new)

        if cfg.adapt_gamma and cfg.kernel == "walk":
            log_gamma_new = s.log_gamma + jnp.clip(
                acc_rate - cfg.target_accept, -0.3, 0.3)
        else:
            log_gamma_new = s.log_gamma

        return NsState(
            u=u2, ll=ll2, logx=logx_new, logz=logz_new, h=h_new,
            it=s.it + 1, log_gamma=log_gamma_new, key=s.key,
            dead_u=dead_u, dead_ll=dead_ll, dead_logw=dead_logw,
            acc_hist=s.acc_hist.at[s.it].set(acc_rate),
            ev_hist=s.ev_hist.at[s.it].set(ev_mean))

    def cond(s: NsState):
        rem = jnp.max(s.ll) + s.logx - s.logz        # -inf logz → +inf
        return (rem > log_stop) & (s.it < cfg.max_batches)

    def run(state: NsState, key: jax.Array):
        dtype = state.u.dtype
        state = state._replace(key=key)
        final = lax.while_loop(cond, batch_body, state)

        # ---- final live-point contribution: K equal widths X/K --------
        lw_live = jnp.full((K,), final.logx - math.log(K), dtype)
        (logz, h), _ = lax.scan(_zh_update, (final.logz, final.h),
                                (lw_live, final.ll))

        # posterior log-weights: dead (stored widths) then live
        logl = jnp.concatenate([final.dead_ll, final.ll])
        logw_all = jnp.concatenate([final.dead_logw, lw_live])
        logw_post = logw_all + logl - logz            # unused slots: -inf
        u_all = jnp.concatenate([final.dead_u, final.u], axis=0)

        result = NsResult(
            u=u_all, logl=logl, logw=logw_post,
            log_evidence=logz,
            log_evidence_err=jnp.sqrt(jnp.maximum(h, 0.0) / K),
            h=h, n_batches=final.it,
            terminated=final.it < cfg.max_batches,
            acc_hist=final.acc_hist, ev_hist=final.ev_hist)
        return final, result

    return run
