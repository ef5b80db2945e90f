"""Ensemble slice sampling (Karamanis & Beutler 2021, "zeus") —
beyond-reference extra.

The tuning-free counterpart to the affine-invariant stretch move
(samplers/stretch.py): instead of an accept/reject on a stretch factor,
each walker slice-samples EXACTLY along a line whose direction is a
differential-evolution pair from the complementary half of the ensemble,

  η = μ (x_l − x_m),   l ≠ m drawn from the other half,
  log y = log π(x_i) + log u                      (slice height)
  stepping-out (Neal 2003, Fig. 3): place a unit interval [L, R] ∋ 0
  uniformly at random in t-units along η, split a total expansion budget
  of ``max_expand`` uniformly between the two sides, and widen each side
  while log π(x_i + t η) > log y;
  shrinkage: draw t ~ U(L, R); accept x_i + t η iff log π > log y, else
  shrink the bracket toward 0 and redraw.

Every generation yields an accepted move per walker (rejection-free up
to the shrink cap); there is no proposal scale to hand-tune — the single
global scale μ is self-tuned during burn-in from the expansion /
contraction balance (the paper's Robbins-Monro recipe
μ ← μ · 2 Nₑ/(Nₑ+N꜀), whose fixed point is Nₑ = N꜀; the factor is
clamped to [0.5, 2] per generation so a pathological all-contraction
generation cannot zero μ) and FROZEN after ``tune_gens`` generations
(diminishing adaptation, same contract as DREAM's CR weights).

Parallelisation is emcee/zeus's red-black scheme exactly as
samplers/stretch.py implements it: two half-updates per generation, each
half moving simultaneously against the frozen other half — detailed
balance holds because η and the slice procedure depend only on frozen
walkers. Accelerator shape: the stepping-out and shrinkage loops are
``lax.while_loop``s per walker (data-dependent trip count — batch-max
cost under vmap with finished lanes frozen, like NUTS / elliptical
slice); one target eval per loop iteration. On ``mesh=`` the population
all_gathers once per half-update (the stretch pattern) and the μ-update
counts ride an INTEGER psum — exact, so the vmap and mesh paths see the
identical μ trajectory (the §11 gather-then-reduce concern is moot for
integers).

Why it earns a slot next to stretch and DE-MC-z: the slice move accepts
by construction and μ only controls *cost* (expansions per generation),
not correctness — the practical "no knobs" sampler for moderate-d
posteriors, and its acceptance does not decay with dimension the way
the a=2 stretch factor's does (measured 0.33 → 0.16 from d=16 → 64
while slice stays at 1.0). ESS *per generation* is 2.2–3.7× stretch's,
but under SPMD population execution the while_loops pay the BATCH-MAX
eval count per generation (~10 full-population evals vs stretch's 1;
finished lanes ride the masked batch eval), so stretch can be expected
to win wall-clock ESS/s at every target cost once the eval dominates
(device rates: not measured on the GPU yet).
An earlier draft predicted a crossover from per-walker MEAN eval
counts (3.8 vs 2); that accounting is wrong on batched hardware.
enslice's slot is therefore robustness, not throughput: acceptance
1.0 by construction, no step-size knob to mis-set, cost (not
correctness) is what adapts.

Scope limits, stated plainly: moves live in the population's affine
span and scale (the DE direction is a pair difference), so — like
stretch and DE-MC, and unlike EllipticalSlice whose ν is a fresh
full-scale prior draw — a population started entirely outside the
target's support can only escape if the support is reachable within the
|t| ≤ 1 + max_expand bracket along μ(x_l − x_m); and a population
collapsed to a point has η ≈ 0 and stalls. Overdisperse starts within
(or near) the support, as for every population sampler here.
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from bipymc_tpu.core.rng import bits_to_uniform
from bipymc_tpu.parallel.collectives import (all_gather_chains, chain_offset,
                                             psum_chains)


class EnsliceConfig(NamedTuple):
    n_chains: int               # total walkers (even; >= 2d+2 recommended)
    mu0: float = 1.0            # initial scale of the DE direction
    tune_gens: int = 500        # adapt mu while gen < tune_gens, then frozen
    max_expand: int = 16        # TOTAL stepping-out budget (split L/R)
    max_shrink: int = 64        # shrink cap; fallback = current state
    tune: bool = True           # disable to pin mu at mu0 forever


class EnsliceState(NamedTuple):
    x: jax.Array       # [n_local, d] walker positions (chain-sharded)
    logp: jax.Array    # [n_local]
    mu: jax.Array      # [] replicated direction scale
    gen: jax.Array     # [] int32


class EnsliceInfo(NamedTuple):
    accepted: jax.Array    # [n_local] False only on a shrink-cap fallback
    logp: jax.Array        # [n_local]
    n_expand: jax.Array    # [n_local] int32 stepping-out evals this gen
    n_contract: jax.Array  # [n_local] int32 rejected shrink draws this gen
    mu: jax.Array          # [] scale AFTER this generation's update


def init(x0: jax.Array, log_prob: Callable,
         cfg: EnsliceConfig) -> EnsliceState:
    x0 = jnp.asarray(x0)
    logp = jax.vmap(log_prob)(x0)
    return EnsliceState(x=x0, logp=logp,
                        mu=jnp.asarray(cfg.mu0, x0.dtype),
                        gen=jnp.zeros((), jnp.int32))


def make_step(log_prob: Callable, cfg: EnsliceConfig,
              axis_name=None) -> Callable:
    """One generation = two half-updates (red then black) + μ update."""
    n_total = cfg.n_chains
    if n_total % 2 != 0:
        raise ValueError("ensemble slice needs an even number of walkers")
    if n_total < 4:
        raise ValueError("need >= 4 walkers (2 per half for l != m)")
    if cfg.max_expand < 1 or cfg.max_shrink < 1:
        raise ValueError("max_expand and max_shrink must be >= 1")
    half = n_total // 2

    def _f(x):
        lp = log_prob(x)
        # repo sanitizer policy: NaN target is a rejection, not a
        # poisoned slice comparison
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

    def move_one(x_i, logp_i, eta, key, active):
        """Slice-sample along x_i + t·η. Returns
        (x_new, logp_new, accepted, n_expand, n_contract)."""
        dtype = x_i.dtype
        u = bits_to_uniform(jax.random.bits(key, (3,), jnp.uint32), dtype)
        # log y: at an out-of-support start (logp_i = -inf) this is -inf,
        # so the first in-support shrink draw escape-accepts (strict >)
        log_y = logp_i + jnp.log(u[0])
        L0 = -u[1]
        R0 = L0 + 1.0
        # Neal's budget split: J ~ U{0..m-1} left, m-1-J right — required
        # for reversibility of capped stepping-out
        j_budget = jnp.floor(u[2] * cfg.max_expand).astype(jnp.int32)
        j_budget = jnp.minimum(j_budget, cfg.max_expand - 1)
        k_budget = jnp.int32(cfg.max_expand - 1) - j_budget

        def expand(t0, step, budget):
            def cond(c):
                t, n = c
                return active & (n < budget) & (_f(x_i + t * eta) > log_y)

            def body(c):
                t, n = c
                return t + step, n + 1

            return lax.while_loop(
                cond, body, (t0, jnp.zeros((), jnp.int32)))

        L, n_l = expand(L0, jnp.asarray(-1.0, dtype), j_budget)
        R, n_r = expand(R0, jnp.asarray(1.0, dtype), k_budget)

        k_loop = jax.random.fold_in(key, jnp.uint32(0x5A455553))  # "ZEUS"

        def body_s(c):
            Lc, Rc, x_cur, lp_cur, it, acc, n_c = c
            u_t = bits_to_uniform(jax.random.bits(
                jax.random.fold_in(k_loop, it), (1,), jnp.uint32),
                dtype)[0]
            t = Lc + u_t * (Rc - Lc)
            x_p = x_i + t * eta
            lp_p = _f(x_p)
            ok = lp_p > log_y
            # shrink toward 0 on rejection (bracket always straddles 0)
            Lc_n = jnp.where(ok | (t >= 0), Lc, t)
            Rc_n = jnp.where(ok | (t < 0), Rc, t)
            return (Lc_n, Rc_n,
                    jnp.where(ok, x_p, x_cur), jnp.where(ok, lp_p, lp_cur),
                    it + 1, acc | ok, n_c + jnp.where(ok, 0, 1))

        def cond_s(c):
            _, _, _, _, it, acc, _ = c
            return active & jnp.logical_not(acc) & (it < cfg.max_shrink)

        carry0 = (L, R, x_i, logp_i, jnp.zeros((), jnp.int32),
                  jnp.zeros((), bool), jnp.zeros((), jnp.int32))
        (_, _, x_new, lp_new, _, acc, n_c) = lax.while_loop(
            cond_s, body_s, carry0)
        # shrink-cap fallback: the t→0 limit point IS the current state
        return x_new, lp_new, acc, n_l + n_r, n_c

    def _directions(x_full, mu, keys, update_first_half):
        """η for each active walker: μ(x_l − x_m), l ≠ m from the other
        half. One bits block per walker (core/rng launch economy)."""
        def one(key):
            b = jax.random.bits(jax.random.fold_in(
                key, jnp.uint32(1)), (2,), jnp.uint32)
            l = (b[0] & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32) % half
            m = (b[1] & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32) % (half - 1)
            m = m + (m >= l)                      # distinct pair
            l = jnp.where(update_first_half, half + l, l)
            m = jnp.where(update_first_half, half + m, m)
            return mu * (x_full[l] - x_full[m])

        return jax.vmap(one)(keys)

    def half_update(x, logp, mu, key, update_first_half):
        n_local, d = x.shape

        if axis_name is None:
            # red-black economy: only the active half's loops run
            sl = slice(0, half) if update_first_half else slice(half, n_total)
            i_global = sl.start + jnp.arange(half, dtype=jnp.int32)
            keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(i_global)
            eta = _directions(x, mu, keys, update_first_half)
            move_keys = jax.vmap(lambda k: jax.random.fold_in(
                k, jnp.uint32(2)))(keys)
            x_h, lp_h, acc_h, n_e_h, n_c_h = jax.vmap(
                move_one, in_axes=(0, 0, 0, 0, None))(
                    x[sl], logp[sl], eta, move_keys, jnp.asarray(True))
            x = x.at[sl].set(x_h)
            logp = logp.at[sl].set(lp_h)
            zeros_i = jnp.zeros((n_local,), jnp.int32)
            acc = jnp.zeros((n_local,), bool).at[sl].set(acc_h)
            n_e = zeros_i.at[sl].set(n_e_h)
            n_c = zeros_i.at[sl].set(n_c_h)
            return x, logp, acc, n_e, n_c

        # mesh path: every device holds a contiguous walker block that may
        # straddle the halves; SPMD forbids per-device control flow, so
        # all local walkers run with the inactive half masked (their
        # loops exit immediately via `active`, so no wasted batch-max
        # iterations beyond the active walkers')
        x_full = all_gather_chains(x, axis_name)
        offset = chain_offset(n_local, axis_name)
        i_global = offset + jnp.arange(n_local, dtype=jnp.int32)
        in_half = (i_global < half) == update_first_half
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(i_global)
        eta = _directions(x_full, mu, keys, update_first_half)
        move_keys = jax.vmap(lambda k: jax.random.fold_in(
            k, jnp.uint32(2)))(keys)
        x_n, lp_n, acc, n_e, n_c = jax.vmap(move_one)(
            x, logp, eta, move_keys, in_half)
        return (jnp.where(in_half[:, None], x_n, x),
                jnp.where(in_half, lp_n, logp),
                acc & in_half,
                jnp.where(in_half, n_e, 0), jnp.where(in_half, n_c, 0))

    def step(state: EnsliceState, key: jax.Array, t: jax.Array):
        k1, k2 = jax.random.split(key)
        x, logp, acc1, ne1, nc1 = half_update(
            state.x, state.logp, state.mu, k1, True)
        x, logp, acc2, ne2, nc2 = half_update(
            x, logp, state.mu, k2, False)
        n_e = ne1 + ne2
        n_c = nc1 + nc2

        # μ tuning (burn-in only): μ ← μ · 2Nₑ/(Nₑ+N꜀), factor clamped to
        # [1/2, 2]. Counts are integers, so the cross-shard psum is EXACT
        # and vmap/mesh μ trajectories are identical.
        ne_tot = psum_chains(jnp.sum(n_e), axis_name)
        nc_tot = psum_chains(jnp.sum(n_c), axis_name)
        total = ne_tot + nc_tot
        factor = jnp.where(
            total > 0,
            2.0 * ne_tot.astype(state.mu.dtype)
            / jnp.maximum(total, 1).astype(state.mu.dtype),
            jnp.ones((), state.mu.dtype))
        factor = jnp.clip(factor, 0.5, 2.0)
        tuning = jnp.asarray(cfg.tune) & (state.gen < cfg.tune_gens)
        mu_new = jnp.where(tuning, state.mu * factor, state.mu)

        new_state = EnsliceState(x=x, logp=logp, mu=mu_new,
                                 gen=state.gen + 1)
        return new_state, EnsliceInfo(
            accepted=acc1 | acc2, logp=logp, n_expand=n_e, n_contract=n_c,
            mu=mu_new)

    return step


# mu/gen replicate; walker-axis fields shard
SHARDED_FIELDS = ("x", "logp")


def enslice_config(**kw) -> EnsliceConfig:
    return EnsliceConfig(**kw)
