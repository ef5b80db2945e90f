"""Chain initialisation helpers.

accelerator-native equivalent of the reference's ``var_ball`` utility
(SURVEY.md §4.10, `bipymc/util.py` [U]): overdisperse chain starting points
in a Gaussian ball with per-dimension scales, which Gelman-Rubin validity
requires.
"""

import jax
import jax.numpy as jnp


def var_ball(key, var_vector, n, center=None, dtype=jnp.float32):
    """Draw ``n`` points from N(center, diag(var_vector)).

    var_vector: per-dimension variances, shape [d].
    center: ball center (default 0).
    Returns [n, d].
    """
    var_vector = jnp.asarray(var_vector, dtype=dtype)
    d = var_vector.shape[-1]
    pts = jax.random.normal(key, (n, d), dtype=dtype) * jnp.sqrt(var_vector)
    if center is not None:
        pts = pts + jnp.asarray(center, dtype=dtype)
    return pts
