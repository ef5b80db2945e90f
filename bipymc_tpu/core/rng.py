"""RNG key discipline.

The reference seeds one NumPy ``RandomState`` per chain (SURVEY.md §2 L2
"seeded per-chain RNG"). The accelerator-native equivalent is JAX's
counter-based
PRNG with deterministic *folding*: every (step, chain) pair gets an
independent stream derived from one base key, so

- results are reproducible given the seed,
- chain ``i``'s stream does not depend on how many chains run (chain-count
  invariance — required for the vmap path and the shard_map path to agree),
- no RNG state needs to be gathered/broadcast across devices.

Hot samplers draw all their per-generation randomness as ONE batched
``random.bits`` block per population (two threefry launches per
generation: the per-chain ``fold_in`` and the block) and convert words to
uniforms/normals with :func:`bits_to_uniform` / :func:`bits_to_normal` —
the per-draw-site ``split``+draw pattern costs one latency-bound kernel
per site, which measured at a third of the DREAM generation step.
"""

import jax
import jax.numpy as jnp


def bits_to_uniform(bits, dtype=jnp.float32):
    """uint32 words → U[0, 1) floats, element-wise.

    Same construction as ``jax.random.uniform`` for float32: keep the top
    23 bits as the mantissa of a float in [1, 2), subtract 1. 2⁻²³
    resolution regardless of ``dtype`` (casting up does not add entropy —
    fine for MCMC accept/proposal noise; documented knob). For dtypes
    narrower than float32 the cast ROUNDS, which can hit exactly 1.0 and
    break the half-open contract (inf through erf⁻¹, log(u)=0 accepts) —
    clamp to the largest representable value below 1.
    """
    f = jax.lax.bitcast_convert_type(
        (bits >> jnp.uint32(9)) | jnp.uint32(0x3F800000), jnp.float32)
    u = (f - 1.0).astype(dtype)
    if jnp.finfo(dtype).nmant < 23:
        below_one = 1.0 - float(jnp.finfo(dtype).epsneg)
        u = jnp.minimum(u, jnp.asarray(below_one, dtype))
    return u


def uniform_to_normal(u, dtype=None):
    """U[0, 1) floats → standard normals via the inverse-erf map.

    Mirrors ``jax.random.normal``: n = √2·erf⁻¹(v) with v uniform on
    (−1, 1); v is clamped one machine epsilon away from −1 *in u's dtype*
    (for float32 that is −1+2⁻²³, bounding the tail at the same ≈5.7σ as
    jax's own float32 normal; a narrower dtype needs a wider clamp or the
    rounding lands on −1 exactly and erf⁻¹ returns −inf).
    """
    lo = -1.0 + float(jnp.finfo(u.dtype).eps)
    v = jnp.maximum(2.0 * u - 1.0, jnp.asarray(lo, u.dtype))
    n = jnp.sqrt(2.0).astype(u.dtype) * jax.lax.erf_inv(v)
    return n if dtype is None else n.astype(dtype)


def bits_to_normal(bits, dtype=jnp.float32):
    """uint32 words → standard normals (see :func:`uniform_to_normal`)."""
    return uniform_to_normal(bits_to_uniform(bits, jnp.float32), dtype)


def step_key(base_key, step):
    """Key for global (population-level) randomness at a given step."""
    return jax.random.fold_in(base_key, step)


def chain_key(base_key, step, chain):
    """Key for chain-local randomness at (step, chain).

    ``chain`` must be the *global* chain index (shard offset + local index)
    so the sharded and single-device paths produce identical streams.
    """
    return jax.random.fold_in(jax.random.fold_in(base_key, step), chain)
