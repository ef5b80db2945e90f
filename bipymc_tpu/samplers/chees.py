"""ChEES-HMC — cross-chain adaptive trajectory lengths (beyond reference).

Hoffman, Radul & Sountsov (AISTATS 2021), "An Adaptive-MCMC Scheme for
Setting Trajectory Lengths in Hamiltonian Monte Carlo". The
accelerator-native answer to NUTS: instead of a per-chain recursive
tree with a data-dependent ``while_loop`` (samplers/nuts.py), ChEES
tunes
ONE shared trajectory length T from a cross-chain statistic, so every
generation is a single fixed-cost batched leapfrog integration whose
step count is known before it starts. The chain population this
framework already treats as a batch axis (SURVEY.md §9) IS the tuning
signal — many chains make the criterion's expectation cheap and sharp,
which is exactly the regime this package runs in (hundreds-thousands of
chains). This is why the algorithm exists: NUTS's control flow is
hostile to SIMD/SPMD hardware; ChEES was designed to replace it.

Criterion: maximise the Change in the Estimator of the Expected Square,

    ChEES(T) = ¼ E[ (‖x′ − E x′‖² − ‖x − E x‖²)² ],

a proxy for the squared-jump distance of the slowest SECOND-moment
direction (plain ESJD tunes the slowest mean direction and stalls on
symmetric targets). Its τ-gradient needs only the end-of-trajectory
velocity v′ = M⁻¹p′ (d x′/dτ = v′):

    dChEES_i/dτ = (‖x′_i − μ̄′‖² − ‖x_i − μ̄‖²) · (x′_i − μ̄′)·v′_i

estimated per generation by the acceptance-probability-weighted
population mean, chain-ruled to d/d log T via dτ/d log T = τ, and fed
to Adam ascent on log T during warmup. Trajectory-length jitter
τ_t = h_t·T with h_t the base-2 van-der-Corput (Halton) point of t —
shared by ALL chains (the criterion compares chains at the SAME τ) and
quasi-random so consecutive generations stratify (0,1) (the paper's
choice; it also consumes no RNG and is trivially identical on the mesh
path). Step size ε is a single shared scalar dual-averaged toward
``target_accept`` on the population-mean acceptance (Hoffman–Gelman
2014, same constants as samplers/hmc.py); the diagonal inverse mass is
shared and estimated by Welford over ALL visited states (chains ×
generations, Chan batch merge per generation) with Stan shrinkage —
with hundreds of chains it converges in tens of generations, the
population advantage again. All adaptation freezes at ``adapt_gens``
(diminishing adaptation; frozen values are the running averages
log ε̄, log T̄).

Per-generation leapfrog count is L_t = clip(⌈τ_t/ε⌉, 1, max_leapfrog),
a TRACED SCALAR shared by the whole batch, so the integrator is a
``lax.fori_loop`` with a dynamic trip count over the batched state —
no masked-lane waste (HMC's per-chain jitter pays L_max lanes always;
NUTS pays the batch-max tree), and chains never diverge in cost.

Mesh path (§11 gather-then-reduce): the criterion/dual-averaging/mass
statistics all_gather per-chain quantities ([N,d] x, x′, v′ and [N] α)
and run the identical full-population reduction replicated on every
shard, so the adaptation trajectory (log T, log ε, M⁻¹ — all replicated
state) is bit-identical to the vmap path whenever the local leapfrog
program rounds identically (pinned at 16 chains / 8 devices in
tests/test_chees.py; the cross-shape caveat of hmc.py applies).

Adam constants default to the paper's regime (lr 0.025, β₂ 0.95); they
are config knobs and the tests pin behaviour (T grows from a tiny init
to the target's scale and freezes), not constants.
"""

import math
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from bipymc_tpu.core.rng import bits_to_uniform, uniform_to_normal
from bipymc_tpu.parallel.collectives import all_gather_chains, chain_offset


class CheesConfig(NamedTuple):
    """Static configuration.

    step_size: initial ε (shared scalar; dual averaging moves it).
    init_traj_length: initial T in TIME units (default ``None`` →
        ``step_size``, i.e. start at one leapfrog step and let Adam grow
        it — the paper's recommendation; a too-large start wastes the
        early warmup on overlong trajectories).
    max_leapfrog: hard cap on leapfrog steps per trajectory (bounds the
        dynamic fori_loop; T is also clamped so ⌈T/ε⌉ stays under it).
    target_accept: dual-averaging target for the population-mean
        acceptance (0.651 — the large-jump optimum the paper pairs
        ChEES with).
    adapt_gens: warmup length; ε/T/mass adaptation all freeze here.
    adam_lr/adam_b1/adam_b2: Adam constants for log-T ascent.
    mass_interval/t0_mass: inverse-mass refresh schedule during warmup.
    da_gamma/da_t0/da_kappa: Hoffman–Gelman dual-averaging constants.
    """

    step_size: float = 0.1
    init_traj_length: float | None = None
    max_leapfrog: int = 256
    target_accept: float = 0.651
    adapt_gens: int = 500
    adam_lr: float = 0.025
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adapt_mass: bool = True
    mass_interval: int = 20
    t0_mass: int = 20
    da_gamma: float = 0.05
    da_t0: float = 10.0
    da_kappa: float = 0.75


class CheesState(NamedTuple):
    # chain-sharded ([n, ...]):
    x: jax.Array            # [n, d] positions
    logp: jax.Array         # [n] log-posterior
    glogp: jax.Array        # [n, d] cached ∇ log-posterior
    # replicated scalars/vectors (identical across shards by the
    # gather-then-reduce construction):
    log_eps: jax.Array      # [] shared log ε (dual-averaging iterate)
    log_eps_bar: jax.Array  # [] averaged log ε̄ (the frozen value)
    hbar: jax.Array         # [] dual-averaging error accumulator
    log_T: jax.Array        # [] shared log trajectory length (time units)
    log_T_bar: jax.Array    # [] averaged log T̄ (the frozen value)
    adam_m: jax.Array       # [] Adam first moment (log-T ascent)
    adam_v: jax.Array       # [] Adam second moment
    mean: jax.Array         # [d] Welford mean over all visited states
    m2: jax.Array           # [d] Welford Σ(x−μ)² (diagonal)
    count: jax.Array        # [] states folded into mean/m2
    inv_mass: jax.Array     # [d] shared M⁻¹ diagonal


class CheesInfo(NamedTuple):
    accepted: jax.Array     # [n] bool
    logp: jax.Array         # [n]
    accept_prob: jax.Array  # [n] α (0 on divergence)
    step_size: jax.Array    # [] ε used this generation
    traj_length: jax.Array  # [] τ_t = h_t · T used this generation
    n_leapfrog: jax.Array   # [] int32 L_t (shared by the whole batch)
    diverged: jax.Array     # [n] bool


def van_der_corput(t):
    """Base-2 radical inverse of t+1 → the quasi-random jitter h_t ∈
    (0,1). Pure bit-twiddling on int32 — no RNG consumed, identical on
    every shard, and consecutive t stratify the unit interval (the
    Halton property the paper wants from its jitter)."""
    v = (t + 1).astype(jnp.uint32)
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    v = (v >> 16) | (v << 16)
    # keep the top 24 bits so the f32 conversion is exact
    return (v >> 8).astype(jnp.float32) * jnp.float32(2.0 ** -24)


def init(x0: jax.Array, log_prob: Callable, cfg: CheesConfig,
         inv_mass0: jax.Array | None = None) -> CheesState:
    """Batched initial state from [n_chains, d] starting points."""
    x0 = jnp.asarray(x0)
    n, d = x0.shape
    dtype = x0.dtype
    logp, glogp = jax.vmap(jax.value_and_grad(log_prob))(x0)
    T0 = cfg.step_size if cfg.init_traj_length is None \
        else cfg.init_traj_length
    if inv_mass0 is None:
        inv_mass = jnp.ones((d,), dtype)
    else:
        inv_mass = jnp.broadcast_to(jnp.asarray(inv_mass0, dtype), (d,))
    z = jnp.zeros((), dtype)
    log_e0 = jnp.asarray(math.log(cfg.step_size), dtype)
    log_T0 = jnp.asarray(math.log(T0), dtype)
    return CheesState(
        x=x0, logp=logp, glogp=glogp,
        log_eps=log_e0, log_eps_bar=log_e0, hbar=z,
        log_T=log_T0, log_T_bar=log_T0, adam_m=z, adam_v=z,
        mean=jnp.zeros((d,), dtype), m2=jnp.zeros((d,), dtype),
        count=jnp.zeros((), jnp.int32),
        inv_mass=inv_mass)


def make_step(log_prob: Callable, cfg: CheesConfig,
              axis_name=None) -> Callable:
    """Build the batched ``step(state, key, t)`` (chains on axis 0;
    state arrives shard-local on the mesh path)."""
    value_and_grad = jax.value_and_grad(log_prob)
    if cfg.max_leapfrog < 1:
        raise ValueError("max_leapfrog must be >= 1")
    # host-side math only here (make_step must not touch devices)
    mu_da = math.log(10.0 * cfg.step_size)      # HG anchor

    def step(s: CheesState, key: jax.Array, t: jax.Array):
        n_local, d = s.x.shape
        dtype = s.x.dtype
        offset = chain_offset(n_local, axis_name)
        idx = offset + jnp.arange(n_local, dtype=jnp.int32)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(idx)

        def draw(k):
            u = bits_to_uniform(
                jax.random.bits(k, (d + 1,), jnp.uint32), dtype)
            return uniform_to_normal(u[:d]), u[d]

        z, u_acc = jax.vmap(draw)(keys)          # [n,d], [n]

        warm = t < cfg.adapt_gens
        eps = jnp.exp(jnp.where(warm, s.log_eps, s.log_eps_bar))
        T = jnp.exp(jnp.where(warm, s.log_T, s.log_T_bar))
        h = van_der_corput(t).astype(dtype)      # shared jitter
        tau = h * T
        # clip in FLOAT space before the int cast: an early dual-
        # averaging swing can make tau/eps inf, and float->int32
        # conversion of inf is implementation-defined (INT_MIN on some
        # backends, which clip would then silently pin to 1). inf/inf
        # (both ε and the ε-clamped T overflowed) is NaN, which clip
        # passes through — pin it to one step too.
        ratio = tau / eps
        ratio = jnp.where(jnp.isnan(ratio), 1.0, ratio)
        L_t = jnp.clip(jnp.ceil(ratio), 1.0,
                       float(cfg.max_leapfrog)).astype(jnp.int32)

        inv_mass = s.inv_mass                    # [d] shared
        p0 = z * lax.rsqrt(inv_mass)             # p ~ N(0, M)
        K0 = 0.5 * jnp.sum(p0 * p0 * inv_mass, axis=-1)

        def body(_, c):
            x, p, l, g = c
            p_h = p + (0.5 * eps) * g
            x_n = x + eps * (inv_mass * p_h)
            l_n, g_n = jax.vmap(value_and_grad)(x_n)
            p_n = p_h + (0.5 * eps) * g_n
            return (x_n, p_n, l_n, g_n)

        # ONE dynamic-trip-count loop for the whole batch: L_t is a
        # traced scalar shared by every chain, so there are no masked
        # lanes to waste (contrast hmc.py's per-chain-jittered masked
        # scan and nuts.py's batch-max tree)
        x1, p1, l1, g1 = lax.fori_loop(
            0, L_t, body, (s.x, p0, s.logp, s.glogp))

        K1 = 0.5 * jnp.sum(p1 * p1 * inv_mass, axis=-1)
        # proposal-side sanitization only (repo policy — hmc.py): an
        # out-of-support start must escape-accept
        prop_ok = (jnp.isfinite(l1 - K1)
                   & jnp.all(jnp.isfinite(x1), axis=-1))
        log_alpha = jnp.where(prop_ok, (l1 - K1) - (s.logp - K0),
                              -jnp.inf)
        log_alpha = jnp.where(jnp.isnan(log_alpha), -jnp.inf,
                              jnp.minimum(0.0, log_alpha))
        acc = jnp.log(u_acc) < log_alpha
        alpha = jnp.exp(log_alpha)

        x_new = jnp.where(acc[:, None], x1, s.x)
        logp_new = jnp.where(acc, l1, s.logp)
        glogp_new = jnp.where(acc[:, None], g1, s.glogp)

        # divergent chains must not poison the POPULATION's criterion:
        # a single non-finite x1 row would NaN prop_c (0·inf) and the
        # whole-generation gradient guard would then discard every
        # finite chain's signal — on hard targets during early warmup
        # (≥1 divergence most generations) T would never move off its
        # ε-sized init. Sanitized rows carry α = 0, so they contribute
        # nothing; the finite chains keep adapting.
        x1s = jnp.where(prop_ok[:, None], x1, s.x)
        v1s = jnp.where(prop_ok[:, None], inv_mass * p1,
                        jnp.zeros_like(p1))

        def _adapt():
            """Cross-chain adaptation (gather-then-reduce, §11):
            criterion gathers + Adam on log T + shared-ε dual averaging
            + population-Welford mass. Each update is where-gated on
            ``warm`` so calling this post-freeze is a (paid-for)
            no-op — the vmap path does exactly that (measured cheaper
            than a cond for per-chain arithmetic, hmc.py); the mesh
            path wraps it in a real ``lax.cond`` instead because here
            the discarded work includes four [N,d] ICI collectives per
            generation, forever."""
            xg = all_gather_chains(s.x, axis_name)          # [N, d]
            x1g = all_gather_chains(x1s, axis_name)         # [N, d]
            v1g = all_gather_chains(v1s, axis_name)         # [N, d]
            ag = all_gather_chains(alpha, axis_name)        # [N]
            N = xg.shape[0]
            Nf = jnp.asarray(N, dtype)

            # ChEES τ-gradient, α-weighted population mean
            w_sum = jnp.maximum(jnp.sum(ag), jnp.asarray(1e-20, dtype))
            prev_c = jnp.mean(xg, axis=0)
            prop_c = jnp.sum(ag[:, None] * x1g, axis=0) / w_sum
            dprev = xg - prev_c
            dprop = x1g - prop_c
            delta = (jnp.sum(dprop * dprop, axis=-1)
                     - jnp.sum(dprev * dprev, axis=-1))     # [N]
            g_tau = jnp.sum(
                ag * delta * jnp.sum(dprop * v1g, axis=-1)) / w_sum
            # guard the PRODUCT (g_tau can be finite while g_tau·τ
            # overflows; an inf here would poison the Adam moments and
            # a NaN log_T survives every later where-gate)
            g_logT = g_tau * tau
            g_logT = jnp.where(jnp.isfinite(g_logT), g_logT, 0.0)

            # Adam ASCENT on log T (warmup only)
            mgen = (t + 1).astype(dtype)
            adam_m_n = (cfg.adam_b1 * s.adam_m
                        + (1 - cfg.adam_b1) * g_logT)
            adam_v_n = (cfg.adam_b2 * s.adam_v
                        + (1 - cfg.adam_b2) * g_logT * g_logT)
            m_hat = adam_m_n / (1 - cfg.adam_b1 ** mgen)
            v_hat = adam_v_n / (1 - cfg.adam_b2 ** mgen)
            log_T_n = s.log_T + cfg.adam_lr * m_hat / (
                jnp.sqrt(v_hat) + 1e-8)
            # keep ⌈T/ε⌉ inside the cap (and T ≥ ε: at least one
            # step) — uses the CURRENT ε so a runaway criterion cannot
            # pin every trajectory at a clipped L where the gradient
            # signal dies
            log_eps_now = jnp.where(warm, s.log_eps, s.log_eps_bar)
            log_T_n = jnp.clip(
                log_T_n, log_eps_now,
                log_eps_now + jnp.log(
                    jnp.asarray(float(cfg.max_leapfrog), dtype)))
            w_b = mgen ** (-cfg.da_kappa)
            log_T_bar_n = w_b * log_T_n + (1 - w_b) * s.log_T_bar
            log_T = jnp.where(warm, log_T_n, s.log_T)
            log_T_bar = jnp.where(warm, log_T_bar_n, s.log_T_bar)
            adam_m = jnp.where(warm, adam_m_n, s.adam_m)
            adam_v = jnp.where(warm, adam_v_n, s.adam_v)

            # shared-ε dual averaging on the population-mean acceptance
            alpha_bar = jnp.sum(ag) / Nf
            w_h = 1.0 / (mgen + cfg.da_t0)
            hbar_n = ((1.0 - w_h) * s.hbar
                      + w_h * (cfg.target_accept - alpha_bar))
            log_eps_n = mu_da - jnp.sqrt(mgen) / cfg.da_gamma * hbar_n
            log_eps_bar_n = (w_b * log_eps_n
                             + (1.0 - w_b) * s.log_eps_bar)
            hbar = jnp.where(warm, hbar_n, s.hbar)
            log_eps = jnp.where(warm, log_eps_n, s.log_eps)
            log_eps_bar = jnp.where(warm, log_eps_bar_n, s.log_eps_bar)

            # shared diagonal inverse mass: Welford over chains × time,
            # Chan merge of this generation's population batch
            if cfg.adapt_mass:
                xng = all_gather_chains(x_new, axis_name)   # [N, d]
                add = jnp.where(warm, N, 0)
                bmean = jnp.mean(xng, axis=0)
                bm2 = jnp.sum((xng - bmean) ** 2, axis=0)
                cnt_new = s.count + add
                c0 = s.count.astype(dtype)
                ctot = jnp.maximum(cnt_new.astype(dtype), 1.0)
                dmean = bmean - s.mean
                mean_n = s.mean + dmean * (Nf / ctot)
                m2_n = s.m2 + bm2 + dmean * dmean * (c0 * Nf / ctot)
                mean = jnp.where(warm, mean_n, s.mean)
                m2 = jnp.where(warm, m2_n, s.m2)
                refresh = (warm & (t >= cfg.t0_mass)
                           & ((t + 1) % cfg.mass_interval == 0))
                denom = jnp.maximum(cnt_new.astype(dtype) - 1.0, 1.0)
                var = m2 / denom
                shrunk = ((denom / (denom + 5.0)) * var
                          + 1e-3 * (5.0 / (denom + 5.0)))
                ok = jnp.all(jnp.isfinite(shrunk)) & jnp.all(shrunk > 0)
                inv_mass_new = jnp.where(refresh & ok, shrunk,
                                         s.inv_mass)
                count = cnt_new
            else:
                mean, m2, count, inv_mass_new = (
                    s.mean, s.m2, s.count, s.inv_mass)
            return (log_eps, log_eps_bar, hbar, log_T, log_T_bar,
                    adam_m, adam_v, mean, m2, count, inv_mass_new)

        def _frozen():
            return (s.log_eps, s.log_eps_bar, s.hbar, s.log_T,
                    s.log_T_bar, s.adam_m, s.adam_v, s.mean, s.m2,
                    s.count, s.inv_mass)

        # A real cond on BOTH paths, unlike hmc.py's measured
        # where-gating preference: (a) post-freeze the discarded work
        # here is four [N,d] ICI collectives per generation on the
        # mesh, not just arithmetic; (b) the cond must be on the vmap
        # path too or the two paths compile different HLO around the
        # boundary and drift apart at the FMA-rounding floor mid-warmup
        # (measured: first divergence at generation 5 with a mesh-only
        # cond, breaking the pinned bit-identity). ``warm`` is
        # replicated, so every shard takes the same branch.
        fields = lax.cond(warm, _adapt, _frozen)
        (log_eps, log_eps_bar, hbar, log_T, log_T_bar, adam_m, adam_v,
         mean, m2, count, inv_mass_new) = fields

        new_state = CheesState(
            x=x_new, logp=logp_new, glogp=glogp_new,
            log_eps=log_eps, log_eps_bar=log_eps_bar, hbar=hbar,
            log_T=log_T, log_T_bar=log_T_bar,
            adam_m=adam_m, adam_v=adam_v,
            mean=mean, m2=m2, count=count, inv_mass=inv_mass_new)
        info = CheesInfo(
            accepted=acc, logp=logp_new, accept_prob=alpha,
            step_size=eps, traj_length=tau, n_leapfrog=L_t,
            diverged=jnp.logical_not(prop_ok))
        return new_state, info

    return step


# Only the per-chain fields shard; every adaptation scalar/vector is
# replicated (kept identical across shards by gather-then-reduce).
SHARDED_FIELDS = ("x", "logp", "glogp")


def chees_config(**kw) -> CheesConfig:
    return CheesConfig(**kw)
