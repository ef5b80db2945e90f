"""Parallel tempering (replica exchange) over the random-walk family.

Beyond-reference extra: K inverse temperatures β₁=1 > β₂ > … > β_K run the
same RW/AM/DR/DRAM kernel against π^β, and adjacent replicas swap
configurations on a schedule — hot replicas cross energy barriers, the
cold (β=1) replica inherits the mode hops. Swap acceptance for the joint
target ∏_k π(x_k)^{β_k} is

  α = min{1, exp[(β_i − β_j)(ℓ(x_j) − ℓ(x_i))]}

with deterministic even/odd pair alternation (the DEO scheme) so every
swap generation is one vectorised, collective-free update.

Accelerator mapping: replicas are ANOTHER batch axis — states are stacked
pytrees
[n_temps, n_chains, ...] advanced by a temps×chains double-vmap of the
single-chain step; swaps are pure index shuffles. Everything lives in one
``lax.scan``.

Diagnostics carried in state: each temperature slot tracks the *walker*
(configuration lineage) currently occupying it plus the walker's travel
direction, so completed cold→hot→cold round trips — THE mixing metric for
PT ladders (Syed et al. 2022 non-reversible PT analysis) — count on
device with no host bookkeeping.
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from bipymc_tpu.samplers import hmc, rw


class PtConfig(NamedTuple):
    """``kernel`` selects the within-temperature move family STATICALLY
    by config type: ``rw.RwConfig`` (MH/AM/DR/DRAM — the original) or
    ``hmc.HmcConfig`` (HMC/MALA — round 3: tempered leapfrog kernels,
    marrying gradient moves with replica exchange). Swaps exchange the
    CONFIGURATION (position + tempered logp + — for gradient kernels —
    the stored gradient, rescaled by β_k/β_partner since
    ∇(β·ℓ) = β·∇ℓ); per-temperature adaptation state (AM covariance /
    dual-averaged ε / mass) stays with the SLOT, the standard PT
    convention."""

    betas: tuple               # static, descending, betas[0] == 1.0
    swap_interval: int = 10
    kernel: NamedTuple = rw.RwConfig()


def _is_gradient_kernel(cfg: "PtConfig") -> bool:
    return isinstance(cfg.kernel, hmc.HmcConfig)


def _validate_prior_mode(cfg: "PtConfig", log_prior) -> None:
    """β=0 rungs require the power-posterior mode; gradient kernels
    don't support it (see make_step docstring)."""
    if log_prior is not None and _is_gradient_kernel(cfg):
        raise ValueError(
            "log_prior (power-posterior mode) supports the RW kernel "
            "family only: the gradient kernels' swap rescales the stored "
            "gradient by a β-ratio, which is wrong once the target "
            "carries an untempered prior term. Use an rw.RwConfig kernel "
            "(utils/evidence.py does).")
    if log_prior is None and any(b <= 0.0 for b in cfg.betas):
        raise ValueError(
            "beta=0 rungs sample a flat (improper) density under plain "
            "tempering; pass log_prior= (power-posterior mode, "
            "utils/evidence.py) or keep beta_min > 0.")


def positions(kern) -> jax.Array:
    """[K, M, d] positions of a stacked kernel state, either family."""
    return kern.x if isinstance(kern, hmc.HmcState) else kern.theta


class PtState(NamedTuple):
    kernel: rw.RwState         # stacked [n_temps, n_chains, ...] pytree
    direction: jax.Array       # [n_temps, n_chains] int8: +1 → heading hot
    trips: jax.Array           # [] int32 completed cold→hot→cold trips


class PtInfo(NamedTuple):
    accepted: jax.Array        # [n_temps, n_chains] within-temp moves
    swapped: jax.Array         # [n_temps, n_chains] replica swapped up/down
    pair_swap: jax.Array       # [n_temps, n_chains] swap accepted with k+1
    logp: jax.Array            # [n_temps, n_chains] tempered log-density


def geometric_ladder(n_temps: int, beta_min: float = 0.05):
    """β_k = beta_min^(k/(K−1)) — the standard geometric spacing."""
    if n_temps == 1:
        return (1.0,)
    return tuple(float(beta_min ** (k / (n_temps - 1)))
                 for k in range(n_temps))


def tune_ladder(betas, swap_rates):
    """Re-space a ladder so swap rejection equalises across interfaces.

    Schedule-tuning step of Syed et al. (2021, non-reversible PT): the
    communication barrier Λ(β) is estimated by accumulating measured
    per-interface rejection rates, and the new ladder places the K rungs
    at equal Λ increments (round-trip rate is maximised when every
    interface rejects equally). betas: descending, betas[0]=1;
    swap_rates: [K-1] measured acceptance per interface. Returns a new
    descending tuple with the same endpoints.
    """
    betas = np.asarray(betas, np.float64)
    rej = np.clip(1.0 - np.asarray(swap_rates, np.float64), 1e-3, 1.0)
    lam = np.concatenate([[0.0], np.cumsum(rej)])     # Λ at each rung
    target = np.linspace(0.0, lam[-1], betas.size)
    new = np.interp(target, lam, betas)
    new[0], new[-1] = betas[0], betas[-1]             # pin endpoints
    return tuple(float(b) for b in new)


def make_step(log_like: Callable, cfg: PtConfig,
              axis_name=None, log_prior: Callable = None) -> Callable:
    """Build ``step(state, key, t)`` over a :class:`PtState`.

    axis_name: chain-mesh axis for a CHAIN-sharded ladder (round 3).
    Replicas (temperatures) stay intact on every shard — swaps are
    per-chain exchanges across the temp axis, so the only collective in
    the whole step is the scalar round-trip psum. Keys fold by GLOBAL
    (temp, chain) index and the swap uniforms fold per global chain, so
    mesh and vmap paths produce identical trajectories
    (tests/test_sharding.py::test_pt_mesh_matches_vmap).

    log_prior: switches the ladder from plain tempering (rung k targets
    π^{β_k}, the mode-hopping composition) to the POWER-POSTERIOR path
    (rung k targets ``p(θ)·L(θ)^{β_k}`` with ``log_like`` as log L and
    ``log_prior`` as the log of a PROPER normalised prior) — the path
    whose endpoints are the prior (β=0) and the posterior (β=1), which
    is what marginal-likelihood estimation integrates over
    (utils/evidence.py: thermodynamic integration + stepping stone).
    β=0 rungs are valid only in this mode. The swap criterion is
    unchanged in form — the prior factors of the joint target
    ∏_k p(x_k)·L(x_k)^{β_k} cancel in a configuration exchange, so
    α = exp[(β_i−β_j)(ℓ_j−ℓ_i)] with ℓ = log L only — but ℓ is now
    obtained by evaluating ``log_like`` directly at swap time (one
    [K, M] likelihood eval per swap generation) rather than dividing
    the stored logp by β, which is undefined at β=0. RW kernels only:
    the gradient kernels' swap path rescales the stored ∇(β·ℓ) by
    β-ratio, which has no power-posterior analogue without a prior
    gradient recompute.
    """
    from bipymc_tpu.parallel.collectives import (axis_size, chain_offset,
                                                 psum_chains)
    # NumPy, not jnp: closed-over device constants force trace-time
    # device->host fetches (see models/targets.py note)
    betas = np.asarray(cfg.betas, np.float32)
    n_temps = len(cfg.betas)

    grad_kernel = _is_gradient_kernel(cfg)
    _validate_prior_mode(cfg, log_prior)

    def rung_target(beta):
        if log_prior is None:
            return lambda th: beta * log_like(th)
        return lambda th: log_prior(th) + beta * log_like(th)

    def tempered_kernel(state, key, t, beta):
        step = rw.make_step(rung_target(beta), cfg.kernel)
        return step(state, key, t)

    def _gids(n_local):
        """Global chain ids of this shard ([n_local] int32)."""
        return chain_offset(n_local, axis_name) + jnp.arange(
            n_local, dtype=jnp.int32)

    # temps × chains double vmap; key folded by (temp, chain) GLOBAL index
    def advance(state, key, t):
        n_local = positions(state).shape[1]
        n_global = n_local * axis_size(axis_name)
        gids = _gids(n_local)

        if grad_kernel:
            # hmc.make_step is already batched over chains with its own
            # global-chain key folding; fold the temp index on top so
            # replicas draw distinct streams
            def per_temp(state_k, k_idx, beta):
                step = hmc.make_step(lambda th: beta * log_like(th),
                                     cfg.kernel, axis_name=axis_name)
                return step(state_k, jax.random.fold_in(key, k_idx), t)
        else:
            def per_temp(state_k, k_idx, beta):
                keys = jax.vmap(lambda g: jax.random.fold_in(
                    key, k_idx * n_global + g))(gids)
                return jax.vmap(tempered_kernel,
                                in_axes=(0, 0, None, None))(
                    state_k, keys, t, beta)

        return jax.vmap(per_temp)(state, jnp.arange(n_temps), betas)

    def swap(state: PtState, key, t):
        """DEO adjacent swaps: even pairs on even swap rounds, odd else."""
        b = jnp.asarray(betas)                    # host const -> traced view
        kern = state.kernel
        theta = positions(kern)                   # [K, M, d]
        logp = kern.logp                          # [K, M] tempered target
        if log_prior is None:
            ell = logp / b[:, None]               # logp = β_k·ℓ exactly
            lpp = None
        else:
            # power posterior: logp = log p(x) + β·ℓ(x); recover ℓ by a
            # direct eval (exact at every β incl. 0 — dividing out β
            # both fails at 0 and amplifies f32 error at small β)
            ell = jax.vmap(jax.vmap(log_like))(theta)
            lpp = jax.vmap(jax.vmap(log_prior))(theta)

        parity = (t // cfg.swap_interval) % 2
        k_idx = jnp.arange(n_temps)
        # pair k with k+1 when k ≡ parity (mod 2)
        is_lo = (k_idx % 2 == parity) & (k_idx + 1 < n_temps)
        partner = jnp.where(is_lo, k_idx + 1,
                            jnp.where((k_idx - 1 >= 0) &
                                      ((k_idx - 1) % 2 == parity),
                                      k_idx - 1, k_idx))

        d_beta = b[:, None] - b[partner][:, None]             # [K, 1]
        d_ell = ell[partner] - ell                            # [K, M]
        log_alpha = jnp.minimum(0.0, d_beta * d_ell)
        # swap uniforms fold per GLOBAL chain so chain-sharded ladders
        # draw the same stream as the vmap path (each chain's K-vector
        # is one draw; shards never share uniforms)
        u = jnp.transpose(jax.vmap(
            lambda g: jax.random.uniform(
                jax.random.fold_in(key, g), (n_temps,)))(
            _gids(logp.shape[1])))                            # [K, M]
        # decision made on the lower index of each pair, mirrored to both
        acc_lo = jnp.log(u) < log_alpha                       # [K, M]
        acc = jnp.where(is_lo[:, None], acc_lo, acc_lo[partner])
        acc = acc & (partner != k_idx)[:, None]

        theta_new = jnp.where(acc[..., None], theta[partner], theta)
        # received configuration re-tempered to this replica's β
        if log_prior is None:
            logp_new = jnp.where(acc, b[:, None] * ell[partner], logp)
        else:
            logp_new = jnp.where(
                acc, lpp[partner] + b[:, None] * ell[partner], logp)
        if grad_kernel:
            # the stored gradient is β_p·∇ℓ(x): rescale to this slot's β
            g_scale = (b / b[partner])[:, None, None]
            g_new = jnp.where(acc[..., None],
                              g_scale * kern.glogp[partner], kern.glogp)
            kern = kern._replace(x=theta_new, logp=logp_new, glogp=g_new)
        else:
            kern = kern._replace(theta=theta_new, logp=logp_new)

        # walker direction travels with the configuration; endpoints flip
        # it and the cold endpoint counts completed round trips
        direction = jnp.where(acc, state.direction[partner],
                              state.direction)
        if n_temps > 1:
            at_cold = jnp.zeros_like(direction, bool).at[0].set(True)
            at_hot = jnp.zeros_like(direction, bool).at[-1].set(True)
            completed = at_cold & (direction == -1)
            trips = state.trips + psum_chains(
                jnp.sum(completed.astype(jnp.int32)), axis_name)
            direction = jnp.where(at_cold, 1, direction)
            direction = jnp.where(at_hot, -1, direction).astype(jnp.int8)
        else:
            trips = state.trips

        pair_swap = acc & is_lo[:, None]
        new_state = PtState(kernel=kern, direction=direction, trips=trips)
        return new_state, acc, pair_swap

    def step(state: PtState, key: jax.Array, t: jax.Array):
        k_move, k_swap = jax.random.split(key)
        kern, info = advance(state.kernel, k_move, t)
        state = state._replace(kernel=kern)
        do_swap = (t % cfg.swap_interval) == (cfg.swap_interval - 1)
        no = jnp.zeros_like(kern.logp, dtype=bool)
        state, swapped, pair_swap = jax.lax.cond(
            do_swap, lambda s: swap(s, k_swap, t),
            lambda s: (s, no, no), state)
        return state, PtInfo(accepted=info.accepted, swapped=swapped,
                             pair_swap=pair_swap, logp=state.kernel.logp)

    return step


def init(theta0: jax.Array, log_like: Callable, cfg: PtConfig,
         cov0: jax.Array, log_prior: Callable = None) -> PtState:
    """theta0 [n_temps, n_chains, d] → :class:`PtState`.

    cov0: RW-family proposal covariance; for a gradient kernel its
    DIAGONAL seeds the inverse mass (both are posterior-scale
    estimates). log_prior: power-posterior mode (see make_step) — must
    match the value passed to make_step.
    """
    betas = np.asarray(cfg.betas, np.float32)
    n_temps, n_chains = theta0.shape[0], theta0.shape[1]
    _validate_prior_mode(cfg, log_prior)

    def rung_target(beta):
        if log_prior is None:
            return lambda t: beta * log_like(t)
        return lambda t: log_prior(t) + beta * log_like(t)

    if _is_gradient_kernel(cfg):
        inv_mass0 = jnp.diag(jnp.asarray(cov0))

        def init_one(th, beta):
            return hmc.init(th, rung_target(beta), cfg.kernel,
                            inv_mass0=inv_mass0)
    else:
        def init_one(th, beta):
            return jax.vmap(lambda x: rw.init(
                x, rung_target(beta), cov0))(th)

    kernel = jax.vmap(init_one)(theta0, jnp.asarray(betas))
    return PtState(
        kernel=kernel,
        direction=jnp.ones((n_temps, n_chains), jnp.int8),
        trips=jnp.zeros((), jnp.int32))
