"""Proposal distributions.

accelerator-native equivalent of the reference's ``McmcProposal`` /
``GaussianProposal`` classes (SURVEY.md §3, `bipymc/samplers.py` [U]):
stateless functions over a Cholesky factor instead of mutable objects, so
they vmap over chains and live inside jitted scans.
"""

import math

import jax
import jax.numpy as jnp

# Host constant: a module-level jnp op would initialise the default backend
# at import time, which breaks importing the package on a host whose default
# platform is unavailable (and forces a device fetch before any user code).
_LOG_2PI = math.log(2.0 * math.pi)


def gaussian_sample(key, mean, chol):
    """Draw x ~ N(mean, L L^T) given the Cholesky factor L (lower)."""
    z = jax.random.normal(key, mean.shape, dtype=mean.dtype)
    return mean + chol @ z


def gaussian_logpdf(x, mean, chol):
    """ln N(x; mean, L L^T) via one triangular solve.

    Matches the reference proposal's ``ln q(x'|x)`` evaluation used in the
    delayed-rejection acceptance ratio (SURVEY.md §4.3: the q1 terms do NOT
    cancel and must be evaluated).
    """
    d = x.shape[-1]
    w = jax.scipy.linalg.solve_triangular(chol, x - mean, lower=True)
    log_det = jnp.sum(jnp.log(jnp.abs(jnp.diagonal(chol, axis1=-2, axis2=-1))), axis=-1)
    return -0.5 * jnp.sum(w * w, axis=-1) - log_det - 0.5 * d * _LOG_2PI


def cov_to_chol(cov, jitter=0.0):
    """Cholesky of a covariance with optional diagonal jitter."""
    d = cov.shape[-1]
    if jitter:
        cov = cov + jitter * jnp.eye(d, dtype=cov.dtype)
    return jnp.linalg.cholesky(cov)
