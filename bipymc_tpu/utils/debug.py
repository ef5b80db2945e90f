"""Likelihood validation & NaN guards (SURVEY.md §7.2 rebuild item).

The reference had no sanitisers; this rebuild's equivalents:

- samplers already treat non-finite proposal log-probs as hard rejects
  (see samplers/rw.py, samplers/dream.py), so a likelihood returning
  −inf/NaN out of support is safe;
- :func:`validate_log_prob` eagerly checks a user likelihood *before* the
  expensive jit of a full run: scalar output, finite at the start point,
  vmap compatibility, and (optionally) differentiability. Most user
  errors (wrong output shape, NumPy ops that break tracing, accidental
  float64) surface here with a readable message instead of a trace error
  inside a 1000-step scan.
"""

import jax
import jax.numpy as jnp


def validate_log_prob(log_prob, theta_example, check_grad=False):
    """Raise ValueError with a readable message if ``log_prob`` is not a
    well-formed jit/vmap-safe scalar log-density at ``theta_example``.

    Returns the (finite) log-prob value at theta_example on success.
    """
    theta = jnp.asarray(theta_example)
    if theta.ndim != 1:
        raise ValueError(
            f"theta_example must be a 1-d parameter vector, got shape "
            f"{theta.shape}")

    try:
        out = jax.jit(log_prob)(theta)
    except Exception as e:
        raise ValueError(
            "log_prob failed under jit — it must be a pure JAX-traceable "
            f"function of theta. Underlying error: {e}") from e

    if jnp.ndim(out) != 0:
        raise ValueError(
            f"log_prob must return a scalar, got shape {jnp.shape(out)}. "
            "For batched evaluation the samplers vmap it themselves.")
    val = float(out)
    if not jnp.isfinite(out):
        raise ValueError(
            f"log_prob(theta_example) = {val} is not finite; start chains "
            "inside the support (var_ball around a feasible point).")

    try:
        batch = jax.vmap(log_prob)(theta[None, :])
    except Exception as e:
        raise ValueError(
            f"log_prob failed under vmap (needed to batch chains): {e}"
        ) from e
    if batch.shape != (1,):
        raise ValueError(
            f"vmapped log_prob returned shape {batch.shape}, expected (1,)")

    if check_grad:
        try:
            g = jax.grad(log_prob)(theta)
        except Exception as e:
            raise ValueError(
                f"log_prob is not differentiable (check_grad=True): {e}"
            ) from e
        if not bool(jnp.all(jnp.isfinite(g))):
            raise ValueError("grad(log_prob) has non-finite entries at "
                             "theta_example")
    return val
