"""Shared scalar numerics used by more than one engine.

Helpers here are plain elementwise jnp — safe under jit/vmap/scan AND
inside Pallas kernel bodies (ops the Triton lowering supports).
Sharing one definition
is load-bearing for the fused engines' bit-parity contracts: the
per-step and fused RW engines must evaluate the Green–Mira acceptance
with the *same* floating-point formula, so a numerical tweak must reach
both at once (tests/test_fused_rw.py pins the agreement).
"""

import jax.numpy as jnp

# p(x) = (e^x - 1)/x - 1 = Σ_{k>=1} x^k/(k+1)!, Horner coefficients
# through x^10/11! — truncation error x^11/12! ≈ 4e-17 relative at
# |x| = 0.2, below f64 eps, so one branch point serves both dtypes.
_EXPM1_COEFS = tuple(
    1.0 / f for f in (
        2.0, 6.0, 24.0, 120.0, 720.0, 5040.0, 40320.0,
        362880.0, 3628800.0, 39916800.0))


def log1mexp(log_a):
    """log(1 − exp(log_a)) for log_a ≤ 0, numerically stable.

    Mächler (2012)'s two-branch scheme, with the near-zero branch's
    ``log(−expm1(x))`` rewritten as ``log(−x) + log1p(p(x))`` via the
    Taylor series of (e^x−1)/x, which needs no ``expm1`` (not every
    kernel lowering has one), and the naive ``log1p(−exp(x))`` loses all
    relative precision as
    x→0⁻ (1−e^x suffers cancellation against exp's own rounding).
    Branch point −0.2: the series is sub-eps there for f32 AND f64,
    and 1−e^x retains ~7 significant digits in f32 beyond it.
    """
    x = jnp.minimum(log_a, jnp.asarray(-1e-30, log_a.dtype))
    p = jnp.zeros_like(x)
    for c in reversed(_EXPM1_COEFS):
        p = x * (c + p)
    series = jnp.log(-x) + jnp.log1p(p)
    # evaluate exp only where it is used is not expressible branchlessly;
    # exp(x) for x ≤ -1e-30 is always finite, so where() is safe
    direct = jnp.log1p(-jnp.exp(x))
    return jnp.where(x > -0.2, series, direct)
