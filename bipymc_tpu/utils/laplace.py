"""MAP estimate + Laplace proposal covariance (beyond-reference utility).

The reference workflow hand-tunes the random-walk family's ``cov_est``
(SURVEY.md §5.1: ``Dram(...).run_mcmc(n, theta0, cov_est)``). On an accelerator
the
log-posterior is a jitted pure function, so the natural initializer is
exact: ascend ``log_prob`` with ``jax.grad`` + optax Adam to the mode and
take the inverse negative Hessian (``jax.hessian`` — d is small in the
MCMC regime) as the Laplace covariance. Feeding that into
``Dram(cov_est=...)``/``var_ball`` replaces the by-hand tuning loop with
one compiled call, and AM's s_d = 2.38²/d scaling then starts from the
curvature-matched shape instead of an isotropic guess.

Everything runs in one ``lax.scan`` under ``jit`` (SURVEY.md §9 design
stance); the Hessian inverse is clamped through an eigendecomposition so
a saddle or flat direction degrades to a bounded step scale instead of a
non-PSD proposal.
"""

import jax
import jax.numpy as jnp
from jax import lax


def map_estimate(log_prob, x0, n_steps=500, learning_rate=0.05):
    """Ascend ``log_prob`` from ``x0`` [d]; returns (theta_map [d], info).

    info carries ``logp`` at the optimum and the full ``logp_path``
    [n_steps] for convergence inspection. Adam (optax) inside one
    ``lax.scan`` — a single compiled program, no Python-loop dispatch.
    """
    import optax
    x0 = jnp.asarray(x0)
    opt = optax.adam(learning_rate)
    grad_fn = jax.value_and_grad(lambda x: -log_prob(x))

    def step(carry, _):
        x, opt_state = carry
        neg_lp, g = grad_fn(x)
        updates, opt_state = opt.update(g, opt_state, x)
        return (optax.apply_updates(x, updates), opt_state), -neg_lp

    (x_map, _), path = lax.scan(step, (x0, opt.init(x0)), None,
                                length=n_steps)
    return x_map, {"logp": log_prob(x_map), "logp_path": path}


def laplace_cov(log_prob, theta_map, min_scale=1e-8):
    """Laplace covariance at a mode: ``inv(-H)`` with PSD clamping.

    Eigenvalues of the negative Hessian below ``min_scale`` times the
    largest (flat or saddle directions) are clamped up, so the returned
    matrix is always a usable proposal covariance — degraded gracefully
    rather than failed loudly, since a proposal covariance only needs to
    be roughly right for AM/DRAM adaptation to take over.
    """
    H = jax.hessian(log_prob)(jnp.asarray(theta_map))
    w, v = jnp.linalg.eigh(-H)        # -H PSD at a proper mode
    # floor relative to the LARGEST curvature when one exists — the
    # docstring's contract: a flat/saddle direction's proposal variance
    # caps at min_scale^-1 times the sharpest direction's, whatever the
    # posterior's absolute scale. (The previous max(w, 1.0)*min_scale
    # floor was absolute for wide posteriors with max curvature < 1,
    # contradicting the doc.) With NO positive curvature at all
    # (max(w) <= 0: x is not a proper mode), there is no information —
    # degrade to unit proposal variance rather than 1/min_scale.
    w_max = jnp.max(w)
    floor = jnp.where(w_max > 0.0, w_max * min_scale, 1.0)
    w = jnp.maximum(w, floor)
    return (v / w) @ v.T              # v @ diag(1/w) @ v.T


def map_laplace(log_prob, x0, n_steps=500, learning_rate=0.05,
                min_scale=1e-8):
    """One call: (theta_map, cov, info) — drop-in producer of the
    ``theta_0``/``cov_est`` pair the random-walk samplers take."""
    theta_map, info = map_estimate(log_prob, x0, n_steps=n_steps,
                                   learning_rate=learning_rate)
    return theta_map, laplace_cov(log_prob, theta_map,
                                  min_scale=min_scale), info
