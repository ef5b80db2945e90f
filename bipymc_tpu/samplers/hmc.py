"""Hamiltonian Monte Carlo (+ MALA as the one-step case).

Beyond-reference extra (the reference zoo is random-walk/DE-based —
SURVEY.md §3 lists no gradient sampler): on this framework the target's
gradient is free (``jax.value_and_grad`` of the same ``log_prob`` every
other sampler consumes), the GP surrogate likelihood is differentiable
end-to-end (gp/regressor.py carries custom JVPs through the batched
Cholesky), and a leapfrog trajectory is a fixed-shape ``lax.scan`` — the
textbook accelerator-native sampler. Design follows the framework spine
(SURVEY.md §9): one pure ``step(state, key, t)`` over a batched chain
axis, per-chain adaptation state carried in the pytree, RNG folded by
GLOBAL chain index so the vmap and shard_map paths consume identical
streams. Chains are fully independent — the mesh path needs NO in-step
collectives, so HMC shards with zero ICI traffic outside diagnostics.

Sharding-equivalence contract: the mesh and vmap paths consume identical
RNG streams and run identical math, and are bit-identical whenever XLA
emits the same rounding for the local program (pinned at 16 chains / 8
devices in tests/test_hmc.py). When the per-device batch shape changes
the compiled code can differ by ~1 ulp per generation (FMA/fusion
choices — the same floor as the DE family), and
unlike the RW family a Hamiltonian trajectory amplifies ulp differences
chaotically, so cross-shape runs agree bit-exactly only for the first
generations and distributionally thereafter
(tests/test_hmc.py::test_mesh_one_chain_per_device_ulp_contract).

Algorithm (Neal 2011; Hoffman & Gelman 2014 for the adaptation):

- momentum p ~ N(0, M), M diagonal; H(x, p) = −ℓ(x) + ½ pᵀ M⁻¹ p.
- leapfrog with step size ε for L_t steps (L_t ~ U{1..L} per chain per
  generation when ``jitter`` — trajectory-length jitter breaks periodic
  orbits; the scan is masked at L_max steps, branchless like the DR
  stage in samplers/rw.py).
- accept with min{1, exp(H(x,p) − H(x',p'))}; non-finite trajectories
  hard-reject (the framework-wide sanitizer policy).
- **dual averaging** of log ε toward ``target_accept`` during the first
  ``adapt_gens`` generations (Hoffman & Gelman 2014 Algorithm 5 with
  γ=0.05, t₀=10, κ=0.75, μ=log(10ε₀)); frozen to the averaged iterate
  ε̄ afterwards (diminishing adaptation → ergodicity, same argument as
  the AM/CR adaptation gates elsewhere in this package).
- **diagonal mass adaptation**: per-chain Welford variance of the
  visited states, refreshed into M⁻¹ every ``mass_interval`` generations
  during warmup with Stan-style shrinkage toward unit scale
  (n/(n+5)·var + 1e-3·5/(n+5)); frozen after ``adapt_gens``.

MALA is exactly HMC with one leapfrog step: the proposal is
N(x + (ε²/2) M⁻¹∇ℓ(x), ε² M⁻¹) and the leapfrog accept ratio reduces to
the Langevin Metropolis–Hastings ratio. ``mala_config`` pins L=1,
jitter off, and the 0.574 optimal-scaling target.
"""

import math
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from bipymc_tpu.core.rng import bits_to_uniform, uniform_to_normal
from bipymc_tpu.parallel.collectives import chain_offset


class HmcConfig(NamedTuple):
    """Static configuration.

    n_leapfrog: max leapfrog steps L per proposal (the scan length).
    step_size: initial ε (dual averaging moves it from here; with
        ``adapt_gens=0`` it is used as-is, unadapted).
    target_accept: dual-averaging acceptance target (0.8 is the HMC
        sweet spot; 0.574 for MALA).
    adapt_gens: warmup length — both ε and mass adaptation freeze at
        this generation (0 disables adaptation entirely).
    jitter: sample L_t ~ U{1..n_leapfrog} per chain per generation.
    adapt_mass: diagonal inverse-mass adaptation on/off.
    mass_interval: M⁻¹ refresh period during warmup.
    t0_mass: first generation an adapted mass may be installed (the
        early Welford variance is too noisy to trust).
    da_gamma/da_t0/da_kappa: Hoffman–Gelman dual-averaging constants.
    """

    n_leapfrog: int = 32
    step_size: float = 0.1
    target_accept: float = 0.8
    adapt_gens: int = 500
    jitter: bool = True
    adapt_mass: bool = True
    mass_interval: int = 100
    t0_mass: int = 100
    da_gamma: float = 0.05
    da_t0: float = 10.0
    da_kappa: float = 0.75


class HmcState(NamedTuple):
    x: jax.Array            # [d] position
    logp: jax.Array         # [] log-posterior at x
    glogp: jax.Array        # [d] ∇ log-posterior at x (cached — the next
                            #     trajectory starts from it, so one grad
                            #     eval per leapfrog step total)
    log_eps: jax.Array      # [] dual-averaging current log ε
    log_eps_bar: jax.Array  # [] dual-averaging averaged log ε̄
    hbar: jax.Array         # [] dual-averaging error accumulator
    mean: jax.Array         # [d] Welford running mean (mass adaptation)
    m2: jax.Array           # [d] Welford running Σ(x−μ)² (diagonal)
    count: jax.Array        # [] states folded into mean/m2
    inv_mass: jax.Array     # [d] current M⁻¹ diagonal


class HmcInfo(NamedTuple):
    accepted: jax.Array     # [] bool
    logp: jax.Array         # [] log-posterior after the step
    accept_prob: jax.Array  # [] α = min{1, exp(ΔH)} (0 on divergence)
    step_size: jax.Array    # [] ε used this generation
    n_leapfrog: jax.Array   # [] int32 L_t used this generation
    diverged: jax.Array     # [] bool — trajectory went non-finite


def init(x0: jax.Array, log_prob: Callable, cfg: HmcConfig,
         inv_mass0: jax.Array | None = None) -> HmcState:
    """Batched initial state from [n_chains, d] starting points."""
    x0 = jnp.asarray(x0)
    n, d = x0.shape
    dtype = x0.dtype
    logp, glogp = jax.vmap(jax.value_and_grad(log_prob))(x0)
    log_e0 = jnp.full((n,), math.log(cfg.step_size), dtype)
    if inv_mass0 is None:
        inv_mass = jnp.ones((n, d), dtype)
    else:
        inv_mass = jnp.broadcast_to(
            jnp.asarray(inv_mass0, dtype), (n, d))
    return HmcState(
        x=x0, logp=logp, glogp=glogp,
        log_eps=log_e0,
        # ε̄ starts at ε₀ (not HG's ε̄₀=1) so adapt_gens=0 runs the
        # user's step size unmodified
        log_eps_bar=log_e0,
        hbar=jnp.zeros((n,), dtype),
        mean=x0, m2=jnp.zeros((n, d), dtype),
        count=jnp.ones((n,), jnp.int32),
        inv_mass=inv_mass)


def apply_warmup_adaptation(state: HmcState, x_new, alpha, t, cfg, mu):
    """Batched warmup adaptation (chains on axis 0): Hoffman–Gelman
    (2014, Alg. 5) dual averaging of log ε plus the Welford/
    Stan-shrinkage diagonal inverse-mass refresh, gated on
    ``warm = t < adapt_gens`` via ``jnp.where``.

    Why ``jnp.where`` and not a batch-level ``lax.cond`` that skips the
    block after warmup: a cond boundary materialises the operand/result
    pytrees (3×[256,100] + 4×[256]) and splits the fusion graph, which
    cost more than the arithmetic it skips on the accelerator this was
    first measured on (not re-measured on the GPU). So: where-gating.
    Shared by HMC/MALA and NUTS (samplers/nuts.py). Returns the updated
    (hbar, log_eps, log_eps_bar, mean, m2, count, inv_mass); values are
    bit-identical to the earlier per-chain form.
    """
    dtype = x_new.dtype
    warm = t < cfg.adapt_gens
    m = (t + 1).astype(dtype)
    w_h = 1.0 / (m + cfg.da_t0)
    hbar_n = (1.0 - w_h) * state.hbar + w_h * (cfg.target_accept - alpha)
    log_eps_n = mu - jnp.sqrt(m) / cfg.da_gamma * hbar_n
    w_b = m ** (-cfg.da_kappa)
    log_eps_bar_n = w_b * log_eps_n + (1.0 - w_b) * state.log_eps_bar
    hbar = jnp.where(warm, hbar_n, state.hbar)
    log_eps = jnp.where(warm, log_eps_n, state.log_eps)
    log_eps_bar = jnp.where(warm, log_eps_bar_n, state.log_eps_bar)
    if not cfg.adapt_mass:
        return (hbar, log_eps, log_eps_bar, state.mean, state.m2,
                state.count, state.inv_mass)
    n = state.count + jnp.where(warm, 1, 0)
    nf = n.astype(dtype)[:, None]
    delta = x_new - state.mean
    mean_n = state.mean + delta / nf
    m2_n = state.m2 + delta * (x_new - mean_n)
    mean = jnp.where(warm, mean_n, state.mean)
    m2 = jnp.where(warm, m2_n, state.m2)
    refresh = (warm & (t >= cfg.t0_mass)
               & ((t + 1) % cfg.mass_interval == 0))
    denom = jnp.maximum(nf - 1.0, 1.0)
    var = m2 / denom
    # Stan's shrinkage toward unit scale keeps the estimate SPD and
    # bounded while n is small
    shrunk = (denom / (denom + 5.0)) * var + 1e-3 * (5.0 / (denom + 5.0))
    ok = (jnp.all(jnp.isfinite(shrunk), axis=-1, keepdims=True)
          & jnp.all(shrunk > 0, axis=-1, keepdims=True))
    inv_mass = jnp.where(refresh & ok, shrunk, state.inv_mass)
    return (hbar, log_eps, log_eps_bar, mean, m2, n, inv_mass)


def make_step(log_prob: Callable, cfg: HmcConfig, axis_name=None,
              draws_fn: Callable | None = None) -> Callable:
    """Build the batched ``step(state, key, t)`` (chains on axis 0).

    draws_fn: per-chain randomness override for injected-stream tests —
    ``(key, t, d, dtype) -> (z [d], u_accept [], u_L [])`` with z
    standard normal momentum draws and u uniforms on (0,1).
    """
    value_and_grad = jax.value_and_grad(log_prob)
    L_max = int(cfg.n_leapfrog)
    if L_max < 1:
        raise ValueError("n_leapfrog must be >= 1")
    # host-side math: make_step must not issue device calls (see
    # __graft_entry__'s device-free audit)
    mu = math.log(10.0 * cfg.step_size)         # HG dual-averaging anchor

    def _default_draws(key, t, d, dtype):
        # one bits block per chain: [z(d) | u_accept | u_L] (launch
        # economy — core/rng.py)
        u = bits_to_uniform(
            jax.random.bits(key, (d + 2,), jnp.uint32), dtype)
        return uniform_to_normal(u[:d]), u[d], u[d + 1]

    draws = draws_fn or _default_draws

    def step_one(s: HmcState, key: jax.Array, t: jax.Array):
        d = s.x.shape[-1]
        dtype = s.x.dtype
        z, u_acc, u_L = draws(key, t, d, dtype)

        warm = t < cfg.adapt_gens
        eps = jnp.exp(jnp.where(warm, s.log_eps, s.log_eps_bar))

        if cfg.jitter:
            # L_t ∈ {1..L_max}; u_L < 1 so the floor never reaches L_max
            L_t = 1 + jnp.floor(u_L * L_max).astype(jnp.int32)
        else:
            L_t = jnp.asarray(L_max, jnp.int32)

        # p ~ N(0, M): M = diag(1/inv_mass) so p = z / √(M⁻¹)
        p0 = z * lax.rsqrt(s.inv_mass)
        K0 = 0.5 * jnp.sum(p0 * p0 * s.inv_mass)

        def lf(carry, i):
            x, p, l, g = carry
            p_h = p + (0.5 * eps) * g
            x_n = x + eps * (s.inv_mass * p_h)
            l_n, g_n = value_and_grad(x_n)
            p_n = p_h + (0.5 * eps) * g_n
            # steps past L_t are identity (branchless masked scan — under
            # vmap a cond would lower to select anyway, SURVEY.md §9);
            # non-finite values propagate and hard-reject at accept time
            a = i < L_t
            return (jnp.where(a, x_n, x), jnp.where(a, p_n, p),
                    jnp.where(a, l_n, l), jnp.where(a, g_n, g)), None

        (x1, p1, l1, g1), _ = lax.scan(
            lf, (s.x, p0, s.logp, s.glogp),
            jnp.arange(L_max, dtype=jnp.int32))

        K1 = 0.5 * jnp.sum(p1 * p1 * s.inv_mass)
        # sanitize the PROPOSAL side only (repo-wide policy, matching
        # demc/stretch/dream/smc): a finite proposal from an out-of-
        # support start (s.logp = -inf) must escape-accept — guarding
        # isfinite(log_alpha) instead would treat the +inf escape ratio
        # as a divergence and freeze the chain at its start forever
        prop_ok = jnp.isfinite(l1 - K1) & jnp.all(jnp.isfinite(x1))
        log_alpha = jnp.where(prop_ok, (l1 - K1) - (s.logp - K0),
                              -jnp.inf)
        # -inf - -inf = NaN (both sides out of support): reject
        log_alpha = jnp.where(jnp.isnan(log_alpha), -jnp.inf,
                              jnp.minimum(0.0, log_alpha))
        acc = jnp.log(u_acc) < log_alpha
        alpha = jnp.exp(log_alpha)          # exact E[accept] for dual avg

        x_new = jnp.where(acc, x1, s.x)
        logp_new = jnp.where(acc, l1, s.logp)
        glogp_new = jnp.where(acc, g1, s.glogp)

        return (x_new, logp_new, glogp_new, acc, alpha, eps, L_t,
                jnp.logical_not(prop_ok))

    def step(state: HmcState, key: jax.Array, t: jax.Array):
        n_local = state.x.shape[0]
        offset = chain_offset(n_local, axis_name)
        idx = offset + jnp.arange(n_local, dtype=jnp.int32)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(idx)
        (x_new, logp_new, glogp_new, acc, alpha, eps, L_t, div) = \
            jax.vmap(step_one, in_axes=(0, 0, None))(state, keys, t)
        # batched warmup adaptation, where-gated (a real cond measured
        # SLOWER than the arithmetic it skips — docstring above)
        (hbar, log_eps, log_eps_bar, mean, m2, count, inv_mass) = \
            apply_warmup_adaptation(state, x_new, alpha, t, cfg, mu)
        new_state = HmcState(
            x=x_new, logp=logp_new, glogp=glogp_new,
            log_eps=log_eps, log_eps_bar=log_eps_bar,
            hbar=hbar, mean=mean, m2=m2, count=count,
            inv_mass=inv_mass)
        info = HmcInfo(accepted=acc, logp=logp_new, accept_prob=alpha,
                       step_size=eps, n_leapfrog=L_t, diverged=div)
        return new_state, info

    return step


# State fields carrying a leading chain axis (ChainPool sharding spec) —
# ALL of them: HMC chains are fully independent, nothing is replicated.
SHARDED_FIELDS = ("x", "logp", "glogp", "log_eps", "log_eps_bar", "hbar",
                  "mean", "m2", "count", "inv_mass")


def hmc_config(**kw) -> HmcConfig:
    return HmcConfig(**kw)


def mala_config(**kw) -> HmcConfig:
    """MALA = one-step HMC; 0.574 is the Langevin optimal-scaling target
    (Roberts & Rosenthal 1998)."""
    kw.setdefault("target_accept", 0.574)
    kw.setdefault("step_size", 0.5)
    return HmcConfig(n_leapfrog=1, jitter=False, **kw)
