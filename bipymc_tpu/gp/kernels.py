"""GP covariance kernels.

Reference capability (SURVEY.md §4.9, `bipymc/gp/` [U], [B]): squared-
exponential kernel with ARD length-scales. Kernels here are pure functions
``k(params, X, X2) -> K`` built on one shared pairwise-squared-distance
primitive that decomposes as ‖x‖² + ‖x′‖² − 2 x·x′ᵀ — the cross term is a
matmul (:mod:`bipymc_tpu.ops.distance`).
"""

import jax.numpy as jnp

from bipymc_tpu.ops.distance import pairwise_sqdist


def _scale(X, lengthscales):
    return X / lengthscales


def _stationary_diag(params, X):
    """k(x, x) for stationary kernels: σ_f², independent of x.

    Attached as ``kernel.diag`` so the regressor's predictive variance
    uses the true prior diagonal for whatever kernel is plugged in
    (a custom kernel without ``.diag`` falls back to row-wise k(x, x)).
    """
    sf2 = jnp.exp(2.0 * params["log_sigma_f"])
    return jnp.full((X.shape[0],), 1.0, X.dtype) * sf2


def squared_exp(params, X, X2=None):
    """SE-ARD: k(x,x′) = σ_f² exp(−½ Σ_d (x_d−x′_d)²/ℓ_d²).

    params: dict with ``log_lengthscale`` [d], ``log_sigma_f`` [].
    """
    ls = jnp.exp(params["log_lengthscale"])
    sf2 = jnp.exp(2.0 * params["log_sigma_f"])
    Xs = _scale(X, ls)
    X2s = Xs if X2 is None else _scale(X2, ls)
    r2 = pairwise_sqdist(Xs, X2s)
    return sf2 * jnp.exp(-0.5 * r2)


def matern32(params, X, X2=None):
    """Matérn-3/2 with ARD length-scales (beyond-reference extra)."""
    ls = jnp.exp(params["log_lengthscale"])
    sf2 = jnp.exp(2.0 * params["log_sigma_f"])
    Xs = _scale(X, ls)
    X2s = Xs if X2 is None else _scale(X2, ls)
    r = jnp.sqrt(jnp.maximum(pairwise_sqdist(Xs, X2s), 1e-30))
    a = jnp.sqrt(3.0) * r
    return sf2 * (1.0 + a) * jnp.exp(-a)


def matern52(params, X, X2=None):
    """Matérn-5/2 with ARD length-scales (beyond-reference extra)."""
    ls = jnp.exp(params["log_lengthscale"])
    sf2 = jnp.exp(2.0 * params["log_sigma_f"])
    Xs = _scale(X, ls)
    X2s = Xs if X2 is None else _scale(X2, ls)
    r2 = jnp.maximum(pairwise_sqdist(Xs, X2s), 1e-30)
    a = jnp.sqrt(5.0 * r2)
    return sf2 * (1.0 + a + 5.0 * r2 / 3.0) * jnp.exp(-a)


squared_exp.diag = _stationary_diag
matern32.diag = _stationary_diag
matern52.diag = _stationary_diag
