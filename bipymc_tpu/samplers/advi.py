"""ADVI — automatic differentiation variational inference.

Beyond-reference extra (SURVEY.md §3 lists no variational method):
fit a Gaussian q(θ) = N(μ, Σ) to the posterior by stochastic gradient
ascent on the reparameterized ELBO (Kucukelbir et al. 2017, JMLR 18).

    ELBO(λ) = E_{z~N(0,I)}[ log p(μ + C z) ] + H[q],
    H[q] = d/2·(1 + log 2π) + log|C|   (closed form — no score term),

with C = diag(σ) (``full_rank=False``, mean-field) or a lower-triangular
Cholesky factor (``full_rank=True``). σ and diag(C) ride through
softplus for unconstrained optimization. The entropy is exact, so the
only Monte-Carlo noise is the energy term: ``n_mc`` reparameterized
draws per step, averaged.

Accelerator shape: one Adam step is a [n_mc, d] batch of target evals +
`jax.grad` through them — a fixed-shape fused program; the whole fit is
one `lax.scan`, and ``n_restarts`` independent fits (different init
draws and MC streams) run as ONE vmapped program, so the restart axis
rides the batch dimension exactly like chains do everywhere else in
this package. No mesh path: the state is O(d²) per restart and the MC
batch is small — a device holds thousands of restarts before sharding
would help (and `Svgd`/`Smc` own the many-particle regime).

Where it sits in the zoo, stated plainly: ADVI is the cheapest
posterior approximation here (seconds, deterministic-ish), exact only
when the posterior is Gaussian; its μ/Σ are the natural
``theta_0``/``cov_est`` pair for the RW family (the same role as
`utils/laplace.map_laplace`, but variance-aware rather than
curvature-at-the-mode — on skewed posteriors ADVI's Σ covers the bulk
where the Laplace cov follows the peak) and a fast whitening/preview
step before committing chip time to exact MCMC. Multimodal honesty:
a Gaussian q covers ONE basin; restarts land in different basins and
``elbo`` ranks them — the spread of restart ELBOs is itself a
multimodality diagnostic (tested).
"""

import math
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class AdviConfig(NamedTuple):
    """Static configuration.

    n_mc: reparameterized draws per step for the energy term.
    step_size: Adam learning rate at t=0.
    step_decay: Robbins–Monro annealing — effective rate
        ``step_size / (1 + step_decay·t)``. With a FIXED step the
        iterates only reach a stationary band of MC-gradient-noise
        width around the optimum (measured ~0.2 abs error on the test
        Gaussian at step 0.05/n_mc 8); 1/t decay satisfies Σa=∞, Σa²<∞
        so the fit actually converges (Kucukelbir §2.3 uses the same
        decreasing-schedule requirement). 0 disables.
    full_rank: lower-triangular Cholesky factor instead of diag(σ).
    init_scale: initial σ (softplus-inverse-transformed into the
        unconstrained state).
    b1/b2/adam_eps: Adam moments/epsilon.
    """

    n_mc: int = 8
    step_size: float = 0.05
    step_decay: float = 0.003
    full_rank: bool = False
    init_scale: float = 0.1
    b1: float = 0.9
    b2: float = 0.999
    adam_eps: float = 1e-8


class AdviState(NamedTuple):
    mu: jax.Array       # [d] variational mean
    omega: jax.Array    # unconstrained scale: [d] (mean-field) or
                        # [d, d] lower-tri with softplus-diag (full-rank)
    m: jax.Array        # Adam first moment (pytree-matching (mu, omega))
    v: jax.Array        # Adam second moment
    t: jax.Array        # [] int32 step counter


class AdviInfo(NamedTuple):
    elbo: jax.Array     # [] per-step ELBO estimate (MC energy + exact H)


_SOFTPLUS_INV_1 = math.log(math.e - 1.0)


def _softplus(x):
    return jnp.logaddexp(x, 0.0)


def _softplus_inv(y):
    # inverse of log(1+e^x); y > 0
    return jnp.log(jnp.expm1(y))


def _chol_of(omega, full_rank):
    """Unconstrained omega -> (C, log|C|). C: [d] diag or [d,d] lower."""
    if full_rank:
        diag = _softplus(jnp.diagonal(omega))
        C = jnp.tril(omega, -1) + jnp.diag(diag)
        return C, jnp.sum(jnp.log(diag))
    s = _softplus(omega)
    return s, jnp.sum(jnp.log(s))


def init(mu0: jax.Array, cfg: AdviConfig) -> AdviState:
    """State from a [d] (or [n_restarts, d]) starting mean; vmap handles
    the leading restart axis transparently."""
    mu0 = jnp.asarray(mu0)
    d = mu0.shape[-1]
    dtype = mu0.dtype
    w0 = _softplus_inv(jnp.asarray(cfg.init_scale, dtype))
    if cfg.full_rank:
        omega = jnp.zeros(mu0.shape + (d,), dtype).at[
            ..., jnp.arange(d), jnp.arange(d)].set(w0)
    else:
        omega = jnp.full(mu0.shape, w0, dtype)
    zeros = (jnp.zeros_like(mu0), jnp.zeros_like(omega))
    return AdviState(mu=mu0, omega=omega, m=zeros, v=zeros,
                     t=jnp.zeros((), jnp.int32))


def make_step(log_prob: Callable, cfg: AdviConfig) -> Callable:
    """Build ``step(state, key) -> (state, AdviInfo)`` for ONE restart
    ([d] state); vmap over a leading restart axis for multi-start."""

    def elbo_fn(params, key):
        mu, omega = params
        d = mu.shape[-1]
        dtype = mu.dtype
        C, logdet = _chol_of(omega, cfg.full_rank)
        z = jax.random.normal(key, (cfg.n_mc, d), dtype)
        if cfg.full_rank:
            x = mu + z @ C.T
        else:
            x = mu + z * C
        # non-finite target draws contribute the worst finite penalty
        # instead of poisoning the Adam moments (sanitizer policy);
        # a q that overlaps out-of-support regions still feels a cliff
        lp = jax.vmap(log_prob)(x)
        lp = jnp.where(jnp.isfinite(lp), lp,
                       jnp.asarray(jnp.finfo(dtype).min / 4, dtype))
        energy = jnp.mean(lp)
        entropy = 0.5 * d * (1.0 + math.log(2.0 * math.pi)) + logdet
        return energy + entropy

    grad_fn = jax.value_and_grad(elbo_fn)

    def step(s: AdviState, key: jax.Array):
        elbo, g = grad_fn((s.mu, s.omega), key)
        # ascent: Adam on -ELBO
        tf = (s.t + 1).astype(s.mu.dtype)
        bc1 = 1.0 - cfg.b1 ** tf
        bc2 = 1.0 - cfg.b2 ** tf
        lr = cfg.step_size / (1.0 + cfg.step_decay * tf)

        def upd(p, m, v, gi):
            gi = -gi
            m_n = cfg.b1 * m + (1.0 - cfg.b1) * gi
            v_n = cfg.b2 * v + (1.0 - cfg.b2) * gi * gi
            p_n = p - lr * (m_n / bc1) / (
                jnp.sqrt(v_n / bc2) + cfg.adam_eps)
            return p_n, m_n, v_n

        mu_n, m0, v0 = upd(s.mu, s.m[0], s.v[0], g[0])
        om_n, m1, v1 = upd(s.omega, s.m[1], s.v[1], g[1])
        # reject non-finite steps outright (keep params AND moments —
        # same policy as gp.optimize)
        ok = (jnp.all(jnp.isfinite(mu_n)) & jnp.all(jnp.isfinite(om_n)))
        new = AdviState(
            mu=jnp.where(ok, mu_n, s.mu),
            omega=jnp.where(ok, om_n, s.omega),
            m=(jnp.where(ok, m0, s.m[0]), jnp.where(ok, m1, s.m[1])),
            v=(jnp.where(ok, v0, s.v[0]), jnp.where(ok, v1, s.v[1])),
            t=s.t + 1)
        return new, AdviInfo(elbo=elbo)

    return step


def make_runner(log_prob: Callable, cfg: AdviConfig,
                n_steps: int) -> Callable:
    """``runner(state, key) -> (state, AdviInfo[n_steps])`` for one
    restart; the API vmaps it over the restart axis."""
    step = make_step(log_prob, cfg)

    def runner(state: AdviState, key: jax.Array):
        def body(s, i):
            return step(s, jax.random.fold_in(key, i))
        return lax.scan(body, state,
                        jnp.arange(n_steps, dtype=jnp.int32))

    return runner


def advi_config(**kw) -> AdviConfig:
    return AdviConfig(**kw)
