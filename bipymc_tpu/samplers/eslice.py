"""Elliptical slice sampling (Murray, Adams & MacKay 2010) — beyond-reference.

The sampler for targets factored as π(x) ∝ N(x; μ, Σ) · L(x): exactly the
shape of every GP-prior model this framework's GP module produces (latent
GP regression/classification, GP-surrogate posteriors with Gaussian
priors). Rejection-free and tuning-free — there is no step size, no
proposal covariance, no acceptance target; each step draws an auxiliary
ellipse through the current state and a prior sample ν ~ N(0, Σ), then
slice-samples the angle:

  log y = log L(x) + log u,          u ~ U(0,1)
  θ ~ U(0, 2π), bracket [θ−2π, θ]
  x' = (x−μ) cos θ + ν sin θ + μ
  accept x' iff log L(x') > log y, else shrink the bracket toward 0
  (θ<0 → θ_min=θ, θ≥0 → θ_max=θ) and redraw θ ~ U(θ_min, θ_max).

Every proposal on the ellipse is a prior draw correlated with x, so the
Gaussian factor cancels exactly and only the *likelihood* enters the
slice test — the prior is sampled perfectly regardless of its condition
number (the regime where RW/HMC step sizes collapse).

Accelerator mapping: the shrinkage loop is one ``lax.while_loop`` per chain per
generation (data-dependent trip count, like NUTS — SURVEY.md §9); under
``vmap`` it runs to the batch-max iteration count with finished lanes
frozen. Murray et al. prove termination (as θ→0, x'→x whose likelihood
exceeds log y almost surely); a ``max_shrink`` cap (default 64 — by then
the bracket is 2π·2⁻⁶⁴) falls back to the θ=0 limit point, i.e. the
current state, which is exactly what unbounded shrinkage converges to.
Chains are fully independent: the ``mesh=`` path has zero in-step
collectives (same contract as samplers/hmc.py).

The ellipse draw ν = Lz needs the prior Cholesky once per step: L is a
closed-over constant (jit-time), so the per-step cost is one [d,d]×[d]
matvec plus one likelihood eval per shrink iteration — no factorisations
in the hot loop. Diagonal priors pass ``prior_chol`` as a [d] vector.
"""

import math
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from bipymc_tpu.core.rng import bits_to_uniform, uniform_to_normal
from bipymc_tpu.parallel.collectives import chain_offset


class EsliceConfig(NamedTuple):
    max_shrink: int = 64    # shrink-iteration cap (θ=0 fallback beyond)


class EsliceState(NamedTuple):
    x: jax.Array          # [d] position
    loglike: jax.Array    # [] log L(x) — the NON-Gaussian factor only


class EsliceInfo(NamedTuple):
    accepted: jax.Array   # [] bool — False only on a max_shrink fallback
    logp: jax.Array       # [] full log-posterior log L(x) + log N(x;μ,Σ)
    loglike: jax.Array    # [] log L(x)
    n_shrink: jax.Array   # [] int32 shrink iterations this generation


def _as_chol(prior_chol, d, dtype):
    c = jnp.asarray(prior_chol, dtype)
    if c.ndim == 0:
        c = jnp.full((d,), c, dtype)
    if c.ndim == 1:
        if c.shape != (d,):
            raise ValueError(f"diagonal prior_chol must be [{d}]")
    elif c.shape != (d, d):
        raise ValueError(f"prior_chol must be [{d},{d}] (or [{d}] diag)")
    return c


def init(x0: jax.Array, log_like: Callable) -> EsliceState:
    x0 = jnp.asarray(x0)
    loglike = jax.vmap(log_like)(x0)
    return EsliceState(x=x0, loglike=loglike)


def make_step(log_like: Callable, prior_mean, prior_chol,
              cfg: EsliceConfig, axis_name=None,
              draws_fn: Callable | None = None) -> Callable:
    """Build the batched ``step(state, key, t)`` (chains on axis 0).

    log_like: the non-Gaussian log-factor ONLY — the N(μ, Σ) prior is
    handled exactly by the ellipse and must not be added to it.
    prior_mean: [d] (or scalar). prior_chol: lower Cholesky of Σ, [d,d],
    or a [d]/scalar diagonal of √Σ.
    draws_fn: injected-stream override for tests —
    ``(key, t, d, dtype) -> (z [d], u_slice [], u_theta [])``.
    """
    if cfg.max_shrink < 1:
        raise ValueError("max_shrink must be >= 1")
    two_pi = 2.0 * math.pi

    def _default_draws(key, t, d, dtype):
        u = bits_to_uniform(
            jax.random.bits(key, (d + 2,), jnp.uint32), dtype)
        return uniform_to_normal(u[:d]), u[d], u[d + 1]

    draws = draws_fn or _default_draws

    def _safe_ll(x):
        ll = log_like(x)
        # repo sanitizer policy: a NaN likelihood is a rejection, not a
        # poisoned slice comparison
        return jnp.where(jnp.isnan(ll), -jnp.inf, ll)

    def step_one(s: EsliceState, key: jax.Array, t: jax.Array):
        d = s.x.shape[-1]
        dtype = s.x.dtype
        mu = jnp.broadcast_to(jnp.asarray(prior_mean, dtype), (d,))
        chol = _as_chol(prior_chol, d, dtype)

        z, u_slice, u_theta = draws(key, t, d, dtype)
        nu = chol * z if chol.ndim == 1 else chol @ z
        # log y: with s.loglike = -inf (out-of-support start) this is
        # -inf, so ANY in-support proposal escape-accepts (strict >)
        log_y = s.loglike + jnp.log(u_slice)
        theta0 = two_pi * u_theta
        xc = s.x - mu

        k_loop = jax.random.fold_in(key, jnp.uint32(0x45534C43))  # "ESLC"

        def propose(theta):
            return xc * jnp.cos(theta) + nu * jnp.sin(theta) + mu

        def body(carry):
            theta, tmin, tmax, _, _, it, _ = carry
            x_p = propose(theta)
            ll_p = _safe_ll(x_p)
            ok = ll_p > log_y
            # shrink toward 0 for the next draw (unused if ok)
            tmin_n = jnp.where(theta < 0, theta, tmin)
            tmax_n = jnp.where(theta < 0, tmax, theta)
            u = bits_to_uniform(jax.random.bits(
                jax.random.fold_in(k_loop, it), (1,), jnp.uint32),
                dtype)[0]
            theta_n = tmin_n + u * (tmax_n - tmin_n)
            return (jnp.where(ok, theta, theta_n), tmin_n, tmax_n,
                    x_p, ll_p, it + 1, ok)

        def cond(carry):
            _, _, _, _, _, it, done = carry
            return jnp.logical_not(done) & (it < cfg.max_shrink)

        carry0 = (theta0, theta0 - two_pi, theta0,
                  s.x, s.loglike, jnp.zeros((), jnp.int32),
                  jnp.zeros((), bool))
        (_, _, _, x_p, ll_p, n_it, done) = lax.while_loop(
            cond, body, carry0)

        # max_shrink fallback: the θ→0 limit point IS the current state
        x_new = jnp.where(done, x_p, s.x)
        ll_new = jnp.where(done, ll_p, s.loglike)
        return x_new, ll_new, done, n_it

    def _prior_logpdf(x, mu, chol):
        d = x.shape[-1]
        r = x - mu
        if chol.ndim == 1:
            w = r / chol
            logdet = jnp.sum(jnp.log(chol))
        else:
            w = jax.scipy.linalg.solve_triangular(chol, r, lower=True)
            logdet = jnp.sum(jnp.log(jnp.diagonal(chol)))
        return (-0.5 * jnp.sum(w * w) - logdet
                - 0.5 * d * math.log(2.0 * math.pi))

    def step(state: EsliceState, key: jax.Array, t: jax.Array):
        n_local, d = state.x.shape
        dtype = state.x.dtype
        mu = jnp.broadcast_to(jnp.asarray(prior_mean, dtype), (d,))
        chol = _as_chol(prior_chol, d, dtype)
        offset = chain_offset(n_local, axis_name)
        idx = offset + jnp.arange(n_local, dtype=jnp.int32)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(idx)
        x_new, ll_new, acc, n_it = jax.vmap(
            step_one, in_axes=(0, 0, None))(state, keys, t)
        logp = ll_new + jax.vmap(
            lambda x: _prior_logpdf(x, mu, chol))(x_new)
        new_state = EsliceState(x=x_new, loglike=ll_new)
        return new_state, EsliceInfo(accepted=acc, logp=logp,
                                     loglike=ll_new, n_shrink=n_it)

    return step


# chains fully independent — every chain-axis field shards
SHARDED_FIELDS = ("x", "loglike")


def eslice_config(**kw) -> EsliceConfig:
    return EsliceConfig(**kw)
