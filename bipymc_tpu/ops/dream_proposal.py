"""DREAM-zs proposal math on one chain block, for the fused kernel.

The fused multi-generation engine (ops/fused_chunk.py) runs this inside
its kernel; the per-generation engine runs the per-chain jnp form
(samplers/dream.py ``propose_math_one``), which is the reference the
tests hold this function to. Randomness and archive row gathers stay in
XLA, so this is a pure deterministic function of them.

Layout: chains on the first axis, dims on the second, padded with zeros
to a power of two. Per-chain scalars are ``[BC, 1]`` columns. Reductions
over the dim axis stay exact under zero padding, and the crossover-mask
uniforms pad with 2.0 so padded dims never enter the mask or win its
argmin.
"""

import jax
import jax.numpy as jnp


def propose_block(x, rows, u, ue, eps, delta, cr, gamma_s, is_snk,
                  gamma_jump, n_pairs, d_true, b, b_star):
    """Value-level DREAM-zs proposal math on one chain block.

    x [BC, L] (L = padded dims, pads zero); rows: a sequence of
    ``max(2·n_pairs, 3)`` archive-row blocks, each [BC, L]; u [BC, L]
    crossover uniforms (pads hold 2.0); ue/eps [BC, L]; per-chain
    scalars [BC, 1]. Returns (x_star [BC, L], log_jac [BC, 1],
    snk [BC, 1] bool).

    Rows arrive as separate blocks because Triton cannot slice a tensor
    held in registers: the kernel loads each row block from its ref.
    First-min is an iota reduction rather than argmin, and there is no
    scatter, so the body lowers through Pallas-Triton.
    """
    # ---- parallel-direction move ------------------------------------
    diff = jnp.zeros_like(x)
    for j in range(n_pairs):
        w = (jnp.asarray(j, x.dtype) < delta).astype(x.dtype)
        diff = diff + w * (rows[j] - rows[n_pairs + j])

    mask = (u < cr).astype(x.dtype)
    # guarantee ≥1 crossed dim: mark the lane holding the min uniform.
    # FIRST minimum only — (u == umin) alone would set every tied lane,
    # diverging from the reference path's argmin on bit-equal draws
    umin = jnp.min(u, axis=1, keepdims=True)
    lane = jax.lax.broadcasted_iota(jnp.int32, u.shape, 1)
    first_min = jnp.min(
        jnp.where(u == umin, lane, u.shape[1]), axis=1, keepdims=True)
    mask = jnp.maximum(mask, (lane == first_min).astype(x.dtype))
    d_eff = jnp.sum(mask, axis=1, keepdims=True)

    gamma = 2.38 / jnp.sqrt(2.0 * delta * d_eff)
    gamma = jnp.where(gamma_jump > 0.5, 1.0, gamma)
    e = b * (2.0 * ue - 1.0)
    x_par = x + mask * ((1.0 + e) * gamma * diff + b_star * eps)

    # ---- snooker move ------------------------------------------------
    z, zr1, zr2 = rows[0], rows[1], rows[2]
    u_dir = x - z
    denom = jnp.maximum(
        jnp.sum(u_dir * u_dir, axis=1, keepdims=True), 1e-30)

    def proj(v):
        return z + (jnp.sum((v - z) * u_dir, axis=1, keepdims=True)
                    / denom) * u_dir

    # the reference's operation order (projections of both rows, then
    # their difference), so the two engines round alike
    x_snk = x + gamma_s * (proj(zr1) - proj(zr2))
    num = jnp.maximum(
        jnp.sum((x_snk - z) ** 2, axis=1, keepdims=True), 1e-30)
    log_jac_snk = (d_true - 1) * 0.5 * (jnp.log(num) - jnp.log(denom))

    snk = is_snk > 0.5
    x_star = jnp.where(snk, x_snk, x_par)
    log_jac = jnp.where(snk, log_jac_snk, 0.0)
    return x_star, log_jac, snk
