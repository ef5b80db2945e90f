"""No-U-Turn Sampler (multinomial NUTS) — gradient family, continued.

Beyond-reference extra (the reference zoo is random-walk/DE-based —
SURVEY.md §3 lists no gradient sampler): NUTS removes HMC's one remaining
hand-tuned knob, the trajectory length L, by growing each trajectory via
tree doubling until the path starts to double back (Hoffman & Gelman
2014). Proposal selection is the modern *multinomial* variant
(Betancourt 2017 §A.3): every visited leapfrog state is a candidate,
weighted by its joint density exp(ℓ(x) − K(p)), sampled progressively —
no slice variable, no MH accept step.

accelerator-native design notes (why this looks nothing like the recursive
reference pseudocode):

- **No recursion, no dynamic allocation.** The textbook algorithm builds
  a binary tree recursively and keeps O(2^depth) states. Here each
  generation is ONE ``lax.while_loop`` whose body takes a single
  leapfrog step — fixed-shape carry, O(max_depth) memory — using the
  iterative checkpoint scheme of Phan & Pradhan (2019, "Iterative NUTS",
  the numpyro formulation): within a subtree of 2^j leaves, leaf ``m``
  (0-based) is *stored* in checkpoint slot ``popcount(m)`` when m is
  even, and *checked* against slots ``[popcount(m+1)−1 .. popcount(m−1)]``
  when m is odd. Those slots hold exactly the left endpoints of the
  dyadic intervals that END at leaf m, so every sub-subtree U-turn test
  of the recursive algorithm is performed, each exactly once
  (``tests/test_nuts.py::test_checkpoint_index_math`` verifies the
  correspondence exhaustively).
- **Batched early exit.** Under ``vmap`` a ``lax.cond`` pays both
  branches, but a ``lax.while_loop`` runs until ALL lanes' predicates
  clear with finished lanes' carries frozen — so a 256-chain generation
  costs the *max* tree size across chains, not 2^max_depth per chain.
  This is the one sampler in the package whose per-generation cost is
  data-dependent; chains stay lockstep-synchronised at generation
  boundaries, so the pool/scan/mesh machinery is unchanged.
- U-turn criterion is the original Hoffman–Gelman position-difference
  test Δx·(M⁻¹p) < 0 at both ends (with M⁻¹ the adapted diagonal
  inverse-mass), applied to every dyadic sub-subtree (Stan's
  generalised ρ-sum criterion is a possible later upgrade).
- Backward doublings (direction v = −1) integrate with step −ε and the
  generated sequence runs *reverse* to trajectory time, so the check
  uses v·Δx (flipping both Δx and the momentum convention leaves the
  sign of Δx·p invariant; only the generation order flips).
- Step size ε is dual-averaged toward ``target_accept`` with the
  Hoffman–Gelman statistic (mean over ALL leapfrog states of
  min{1, exp(ℓ̃ − ℓ̃₀)}, rejected subtrees included, as in Stan);
  diagonal mass adaptation is the same Welford+shrinkage machinery as
  HMC — both imported from samplers/hmc.py, state layout shared
  (``HmcState``), so checkpoints and the ChainPool sharding spec carry
  over unchanged.

Divergences (Δ energy > ``max_delta_energy``, or non-finite) hard-stop
the trajectory and discard the offending subtree; the generation's
proposal falls back to the tree built so far (possibly the start point)
— the framework-wide sanitizer policy.
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from bipymc_tpu.core.rng import bits_to_uniform, uniform_to_normal
from bipymc_tpu.parallel.collectives import chain_offset
from bipymc_tpu.samplers.hmc import (
    HmcState, init as _hmc_init, apply_warmup_adaptation)

import math


class NutsConfig(NamedTuple):
    """Static configuration (see HmcConfig for the shared adaptation
    fields; ``max_depth`` replaces ``n_leapfrog`` — a trajectory visits
    at most 2^max_depth − 1 new states)."""

    max_depth: int = 8
    step_size: float = 0.1
    target_accept: float = 0.8
    adapt_gens: int = 500
    adapt_mass: bool = True
    mass_interval: int = 100
    t0_mass: int = 100
    da_gamma: float = 0.05
    da_t0: float = 10.0
    da_kappa: float = 0.75
    max_delta_energy: float = 1000.0


# NUTS carries exactly HMC's state (position/adaptation); reuse it so
# checkpoint schemas, the pool sharding spec, and the Hmc API wrapper
# machinery apply verbatim.
NutsState = HmcState


class NutsInfo(NamedTuple):
    accepted: jax.Array      # [] bool — proposal moved off the start point
    logp: jax.Array          # [] log-posterior after the step
    accept_prob: jax.Array   # [] HG accept statistic (dual-avg input)
    step_size: jax.Array     # [] ε used this generation
    n_leapfrog: jax.Array    # [] int32 — leapfrog evals this generation
    tree_depth: jax.Array    # [] int32 — completed doublings
    diverged: jax.Array      # [] bool — trajectory hit the energy cliff


def init(x0: jax.Array, log_prob: Callable, cfg: NutsConfig,
         inv_mass0: jax.Array | None = None) -> NutsState:
    """Batched initial state from [n_chains, d] starting points."""
    return _hmc_init(x0, log_prob, cfg, inv_mass0=inv_mass0)


def make_step(log_prob: Callable, cfg: NutsConfig, axis_name=None,
              draws_fn: Callable | None = None) -> Callable:
    """Build the batched ``step(state, key, t)`` (chains on axis 0).

    draws_fn: per-chain randomness override for injected-stream tests —
    ``(key, t, d, dtype) -> (z [d], u_dir [max_depth], u_merge
    [max_depth], u_leaf [2^max_depth])`` with z standard normal momentum
    draws and u uniforms on (0,1).
    """
    value_and_grad = jax.value_and_grad(log_prob)
    D_max = int(cfg.max_depth)
    if not 1 <= D_max <= 14:
        raise ValueError("max_depth must be in [1, 14]")
    n_leaf_max = 1 << D_max
    mu = math.log(10.0 * cfg.step_size)          # HG dual-averaging anchor

    def _default_draws(key, t, d, dtype):
        # one bits block per chain per generation (launch economy —
        # core/rng.py): [z(d) | u_dir(D) | u_merge(D) | u_leaf(2^D)]
        u = bits_to_uniform(
            jax.random.bits(key, (d + 2 * D_max + n_leaf_max,),
                            jnp.uint32), dtype)
        return (uniform_to_normal(u[:d]), u[d:d + D_max],
                u[d + D_max:d + 2 * D_max], u[d + 2 * D_max:])

    draws = draws_fn or _default_draws

    def step_one(s: NutsState, key: jax.Array, t: jax.Array):
        d = s.x.shape[-1]
        dtype = s.x.dtype
        neg_inf = jnp.asarray(-jnp.inf, dtype)
        z, u_dir, u_merge, u_leaf = draws(key, t, d, dtype)

        warm = t < cfg.adapt_gens
        eps = jnp.exp(jnp.where(warm, s.log_eps, s.log_eps_bar))
        inv_mass = s.inv_mass
        # one direction per doubling level, fixed up front
        dirs = jnp.where(u_dir < 0.5, -jnp.ones((), dtype),
                         jnp.ones((), dtype))

        p0 = z * lax.rsqrt(inv_mass)
        K0 = 0.5 * jnp.sum(p0 * p0 * inv_mass)
        H0 = s.logp - K0                      # joint log-density at start
        # Out-of-support start (logp = -inf): escape mode (same policy
        # as hmc.py / the RW family — the pre-support transient is not
        # part of the stationary regime, so the kernel may do anything
        # that eventually enters support). H0 gets a finite floor so an
        # in-support leaf gets a huge-but-finite weight (with H0 = -inf
        # every leaf's log_w is +inf -> flagged divergent, freezing the
        # chain at its start forever), and -inf leaves count as ZERO
        # WEIGHT rather than divergences (see div_now below) so the
        # trajectory can drift across the -inf plateau instead of
        # aborting at its first leapfrog step.
        start_bad = jnp.logical_not(jnp.isfinite(H0))
        H0 = jnp.where(start_bad,
                       jnp.asarray(-2.0 * cfg.max_delta_energy, dtype),
                       H0)

        # while_loop carry: integrator endpoint states + proposals +
        # checkpoint stack, all fixed shapes. Momenta are stored as
        # drawn (unnegated); direction enters through v·ε and v·Δx.
        carry0 = dict(
            n=jnp.int32(0),                   # leapfrog steps taken
            j=jnp.int32(0),                   # current doubling level
            m=jnp.int32(0),                   # leaves in current subtree
            x_cur=s.x, p_cur=p0, g_cur=s.glogp,
            x_l=s.x, p_l=p0, g_l=s.glogp,
            x_r=s.x, p_r=p0, g_r=s.glogp,
            x_prop=s.x, lp_prop=s.logp, g_prop=s.glogp,
            tree_lw=jnp.zeros((), dtype),     # root leaf weight: e^0
            x_sprop=s.x, lp_sprop=s.logp, g_sprop=s.glogp,
            sub_lw=neg_inf,
            ckpt_x=jnp.zeros((D_max, d), dtype),
            ckpt_p=jnp.zeros((D_max, d), dtype),
            done=jnp.asarray(False),
            diverged=jnp.asarray(False),
            moved=jnp.asarray(False),
            sum_alpha=jnp.zeros((), dtype),
            depth=jnp.int32(0))

        def cond(c):
            return jnp.logical_not(c["done"])

        def body(c):
            v = dirs[c["j"]]
            start = c["m"] == 0
            # at a doubling start, integrate from the endpoint being
            # extended; otherwise continue from the last state
            x0 = jnp.where(start, jnp.where(v > 0, c["x_r"], c["x_l"]),
                           c["x_cur"])
            pp0 = jnp.where(start, jnp.where(v > 0, c["p_r"], c["p_l"]),
                            c["p_cur"])
            g0 = jnp.where(start, jnp.where(v > 0, c["g_r"], c["g_l"]),
                           c["g_cur"])

            ve = v * eps
            ph = pp0 + (0.5 * ve) * g0
            xn = x0 + ve * (inv_mass * ph)
            ln, gn = value_and_grad(xn)
            pn = ph + (0.5 * ve) * gn
            Kn = 0.5 * jnp.sum(pn * pn * inv_mass)
            log_w = (ln - Kn) - H0
            pos_ok = jnp.all(jnp.isfinite(xn))
            finite = jnp.isfinite(log_w) & pos_ok
            log_w = jnp.where(finite, log_w, neg_inf)
            cliff = finite & (log_w < -cfg.max_delta_energy)
            # escape mode (start_bad): only non-finite POSITIONS abort;
            # -inf leaves ride along with zero weight so the tree keeps
            # extending across the plateau
            div_now = jnp.where(start_bad, jnp.logical_not(pos_ok),
                                jnp.logical_not(finite) | cliff)

            # HG accept statistic: min{1, e^{ℓ̃−ℓ̃₀}} over every leapfrog
            # state, rejected subtrees included (Stan's convention)
            sum_alpha = c["sum_alpha"] + jnp.exp(jnp.minimum(log_w, 0.0))

            # ---- progressive multinomial sampling within the subtree --
            sub_lw_new = jnp.logaddexp(c["sub_lw"], log_w)
            u_n = u_leaf[c["n"]]
            take = jnp.log(u_n) < (log_w - sub_lw_new)
            x_sprop = jnp.where(take, xn, c["x_sprop"])
            lp_sprop = jnp.where(take, ln, c["lp_sprop"])
            g_sprop = jnp.where(take, gn, c["g_sprop"])

            # ---- iterative sub-subtree U-turn checks (odd m) ----------
            m = c["m"]
            odd = (m & 1) == 1
            idx_min = lax.population_count(m + 1) - 1
            idx_max = lax.population_count(jnp.maximum(m - 1, 0))
            slots = jnp.arange(D_max, dtype=jnp.int32)
            active = odd & (slots >= idx_min) & (slots <= idx_max)
            dx = (xn[None, :] - c["ckpt_x"]) * v      # true-time Δx
            turn_k = (jnp.sum(dx * (inv_mass * c["ckpt_p"]), -1) < 0) | \
                     (jnp.sum(dx * (inv_mass * pn)[None, :], -1) < 0)
            sub_turn = jnp.any(active & turn_k)

            # ---- checkpoint store (even m, slot = popcount(m)) --------
            slot = lax.population_count(m)
            store = jnp.logical_not(odd)
            ckpt_x = jnp.where(store, c["ckpt_x"].at[slot].set(xn),
                               c["ckpt_x"])
            ckpt_p = jnp.where(store, c["ckpt_p"].at[slot].set(pn),
                               c["ckpt_p"])

            bad = div_now | sub_turn          # discard this subtree
            m_new = m + 1
            sub_size = lax.shift_left(jnp.int32(1), c["j"])
            complete = (m_new == sub_size) & jnp.logical_not(bad)

            # ---- doubling completion: extend tree, biased merge -------
            ext_l = complete & (v < 0)
            ext_r = complete & (v > 0)
            x_l = jnp.where(ext_l, xn, c["x_l"])
            p_l = jnp.where(ext_l, pn, c["p_l"])
            g_l = jnp.where(ext_l, gn, c["g_l"])
            x_r = jnp.where(ext_r, xn, c["x_r"])
            p_r = jnp.where(ext_r, pn, c["p_r"])
            g_r = jnp.where(ext_r, gn, c["g_r"])
            dxt = x_r - x_l
            turn_tree = (jnp.sum(dxt * (inv_mass * p_l)) < 0) | \
                        (jnp.sum(dxt * (inv_mass * p_r)) < 0)
            # biased progressive sampling: prefer the new subtree with
            # prob min{1, W_sub/W_tree} (Betancourt 2017)
            take_sub = complete & (
                jnp.log(u_merge[c["j"]]) < (sub_lw_new - c["tree_lw"]))
            x_prop = jnp.where(take_sub, x_sprop, c["x_prop"])
            lp_prop = jnp.where(take_sub, lp_sprop, c["lp_prop"])
            g_prop = jnp.where(take_sub, g_sprop, c["g_prop"])
            tree_lw = jnp.where(complete,
                                jnp.logaddexp(c["tree_lw"], sub_lw_new),
                                c["tree_lw"])

            j_new = jnp.where(complete, c["j"] + 1, c["j"])
            done = bad | (complete & turn_tree) | (j_new >= D_max)

            return dict(
                n=c["n"] + 1, j=j_new,
                m=jnp.where(complete, jnp.int32(0), m_new),
                x_cur=xn, p_cur=pn, g_cur=gn,
                x_l=x_l, p_l=p_l, g_l=g_l,
                x_r=x_r, p_r=p_r, g_r=g_r,
                x_prop=x_prop, lp_prop=lp_prop, g_prop=g_prop,
                tree_lw=tree_lw,
                x_sprop=x_sprop, lp_sprop=lp_sprop, g_sprop=g_sprop,
                sub_lw=jnp.where(complete, neg_inf, sub_lw_new),
                ckpt_x=ckpt_x, ckpt_p=ckpt_p,
                done=done,
                diverged=c["diverged"] | div_now,
                moved=c["moved"] | take_sub,
                sum_alpha=sum_alpha,
                depth=jnp.where(complete, j_new, c["depth"]))

        c = lax.while_loop(cond, body, carry0)

        x_new, logp_new, glogp_new = c["x_prop"], c["lp_prop"], c["g_prop"]
        n_lf = c["n"]
        alpha = c["sum_alpha"] / jnp.maximum(n_lf, 1).astype(dtype)
        return (x_new, logp_new, glogp_new, c["moved"], alpha, eps,
                n_lf, c["depth"], c["diverged"])

    def step(state: NutsState, key: jax.Array, t: jax.Array):
        n_local = state.x.shape[0]
        offset = chain_offset(n_local, axis_name)
        idx = offset + jnp.arange(n_local, dtype=jnp.int32)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(idx)
        (x_new, logp_new, glogp_new, moved, alpha, eps, n_lf, depth,
         diverged) = jax.vmap(step_one, in_axes=(0, 0, None))(
            state, keys, t)
        # batched warmup adaptation, where-gated (a real cond measured
        # SLOWER than the arithmetic it skips — see
        # hmc.apply_warmup_adaptation's docstring)
        (hbar, log_eps, log_eps_bar, mean, m2, count, inv_mass) = \
            apply_warmup_adaptation(state, x_new, alpha, t, cfg, mu)
        new_state = NutsState(
            x=x_new, logp=logp_new, glogp=glogp_new,
            log_eps=log_eps, log_eps_bar=log_eps_bar,
            hbar=hbar, mean=mean, m2=m2, count=count,
            inv_mass=inv_mass)
        info = NutsInfo(accepted=moved, logp=logp_new,
                        accept_prob=alpha, step_size=eps,
                        n_leapfrog=n_lf, tree_depth=depth,
                        diverged=diverged)
        return new_state, info

    return step


# Same sharding spec as HMC: chains fully independent, every field
# carries the leading chain axis.
SHARDED_FIELDS = ("x", "logp", "glogp", "log_eps", "log_eps_bar", "hbar",
                  "mean", "m2", "count", "inv_mass")


def nuts_config(**kw) -> NutsConfig:
    return NutsConfig(**kw)
