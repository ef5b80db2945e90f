"""Fused multi-generation DREAM-zs chunk: G generations in ONE kernel.

A 256-chain × d=100 DREAM generation is ~25k floats of math spread over
~25 small XLA fusions, so the per-generation engine is launch-bound on
the GPU: it pays a launch per fusion per generation. This kernel
advances ``G = archive_thin`` generations per launch. The grid runs over
chain blocks only; inside a block a ``fori_loop`` walks the G
generations with (x, logp) as loop-carried values, reading each
generation's inputs from its refs at index g.

Why G = archive_thin is the natural chunk: the archive Z is *constant*
within such a chunk by construction — the per-generation engine
(samplers/dream.py step) appends to Z only at generations
``gen % archive_thin == archive_thin-1``, i.e. the chunk's last
generation, *after* its proposal consumed Z. All row gathers for the
chunk can therefore be precomputed OUTSIDE the kernel by XLA (they
depend only on pregenerated random bits and the chunk-start archive),
and the kernel needs no dynamic gathers. Semantics are exactly the
per-generation engine's.

Division of labour per chunk (samplers/dream_fused.py drives this):

- XLA (once per chunk): threefry bits for all G generations —
  *identical streams* to the per-generation engine — uniform/normal
  conversion, distinct row indices, the Z row gather, per-chain scalars,
  and the archive append at the end.
- Pallas (this kernel): for g = 0..G-1 — crossover/snooker proposal
  math (ops/dream_proposal.propose_block), the target log-density
  (inlined ``log_prob_block``), and Metropolis accept/select.

The in-kernel target works on a padded block: ``log_prob_block(x_pad
[BC, Dp]) -> [BC, 1]`` with Dp the next power of two ≥ d and pad
columns zero. models/targets.py has padded block forms (``*_block``)
whose constants are zero-padded to powers of two, which is what Triton
can lower. :func:`block_logp_from_scalar` wraps a scalar target for the
interpreter on the CPU; on the GPU a target needs a block form
(samplers/api.py checks this at construction).
"""

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from bipymc_tpu.ops.dream_proposal import propose_block
from jax.experimental.pallas import triton as pl_triton

from bipymc_tpu.ops.route import interpret_mode, next_pow2, round_up

# per-chain scalar rows of ``scal`` ([G, 6, n] inside the wrapper)
S_DELTA, S_CR, S_GS, S_SNK, S_GJUMP, S_LOGU = range(6)
N_SCAL = 6

# chains per program and Triton launch parameters, the fastest of a sweep
# of the runner at 256 chains × d=100 on an H100 (PERF.md)
BLOCK_CHAINS = 8
NUM_WARPS = 4
NUM_STAGES = 1


def block_logp_from_scalar(log_prob, d):
    """Wrap a scalar ``log_prob(theta [d]) -> []`` as a padded-block
    target ``[BC, Dp] -> [BC, 1]``.

    Slices the true dims off the padded block and vmaps. A tensor slice
    does not lower through Triton, so this form serves the interpreter
    (CPU); on the GPU pass a padded block form (models/targets.py).
    """
    def f(x_pad):
        x = x_pad if x_pad.shape[1] == d else x_pad[:, :d]
        return jax.vmap(log_prob)(x)[:, None]
    return f


def lp_block_cache(log_prob, log_prob_block=None):
    """Per-dim cache of :func:`block_logp_from_scalar` wrappers.

    The fused drivers pass log_prob_block as a *static* (hashable) jit
    argument, so its identity must be stable across runner calls — a
    fresh closure per call would defeat the jit cache. Returns
    ``lp_block_for(dim)``; an explicit ``log_prob_block``
    short-circuits the cache. Shared by the fused DREAM / RW drivers.
    """
    blocks: dict = {}

    def lp_block_for(dim):
        if log_prob_block is not None:
            return log_prob_block
        if dim not in blocks:
            blocks[dim] = block_logp_from_scalar(log_prob, dim)
        return blocks[dim]
    return lp_block_for


def hoist_target_consts(log_prob_block, bc, d_p, dtype):
    """Trace ``log_prob_block`` on a [bc, d_p] block and pull its closure
    constants out as kernel operands.

    Pallas kernels cannot capture array constants (mode centres, data
    vectors, …), and ``closure_convert`` only extracts tracers — so
    trace to a jaxpr and lift the concrete consts explicitly. Returns
    ``(closed_fn, consts, const_specs)``: call ``closed_fn(x_block,
    *const_refs)`` inside the kernel; it loads each constant from its
    ref at the point of use. Shared by the fused DREAM and RW kernels.
    """
    closed = jax.make_jaxpr(log_prob_block)(
        jax.ShapeDtypeStruct((bc, d_p), dtype))
    consts = [jnp.asarray(c) for c in closed.consts]
    const_specs = [
        pl.BlockSpec(c.shape, lambda *_, _nd=c.ndim: (0,) * _nd)
        for c in consts]

    def closed_fn(xb, *const_refs):
        cs = [r[...] for r in const_refs]
        return jax.core.eval_jaxpr(closed.jaxpr, cs, xb)[0]

    return closed_fn, consts, const_specs


def _make_kernel(closed_fn, n_consts, n_gens, n_pairs, n_rows, d_true, b,
                 b_star):

    def kernel(x0_ref, lp0_ref, rows_ref, um_ref, ue_ref, eps_ref,
               scal_ref, *refs):
        const_refs = refs[:n_consts]
        xh_ref, lph_ref, acc_ref = refs[n_consts:]

        def generation(g, carry):
            x, lp = carry                         # [BC, Dp], [BC, 1]

            def col(c):
                return scal_ref[g, c, :][:, None]  # [BC, 1]

            x_star, log_jac, _ = propose_block(
                x, [rows_ref[g, :, j, :] for j in range(n_rows)],
                um_ref[g], ue_ref[g], eps_ref[g],
                col(S_DELTA), col(S_CR), col(S_GS), col(S_SNK),
                col(S_GJUMP), n_pairs, d_true, b, b_star)
            lps = closed_fn(x_star, *const_refs)  # [BC, 1]
            # Metropolis-with-Jacobian accept; NaN/-inf proposals always
            # reject (same guard as samplers/dream.py step)
            log_alpha = jnp.minimum(0.0, lps - lp + log_jac)
            log_alpha = jnp.where(jnp.isfinite(lps), log_alpha, -jnp.inf)
            acc = col(S_LOGU) < log_alpha
            x_new = jnp.where(acc, x_star, x)
            lp_new = jnp.where(acc, lps, lp)
            xh_ref[g] = x_new
            lph_ref[g, :] = lp_new.reshape(-1)
            acc_ref[g, :] = acc.reshape(-1).astype(jnp.int32)
            return x_new, lp_new

        lax.fori_loop(0, n_gens, generation,
                      (x0_ref[...], lp0_ref[...][:, None]))

    return kernel


@functools.partial(
    jax.jit,
    static_argnames=("log_prob_block", "n_pairs", "d_true", "b", "b_star",
                     "interpret"))
def fused_chunk_pallas(x0, logp0, rows, u_mask, u_e, eps, scal,
                       log_prob_block, n_pairs, d_true, b, b_star,
                       interpret=None):
    """Advance G generations in one kernel launch.

    x0 [n, d]; logp0 [n]; rows [G, n, k, d] pregathered archive rows;
    u_mask/u_e/eps [G, n, d]; scal [G, n, 6] per-chain scalars (delta,
    cr, gamma_s, is_snooker, gamma_jump, log_u_accept).
    log_prob_block: hashable callable, ``[BC, Dp] -> [BC, 1]`` on
    zero-padded columns. ``interpret=None`` lets ops/route.py decide
    (interpret on the CPU, Triton on the GPU). Returns (x_hist
    [G, n, d], logp_hist [G, n], accepted [G, n] bool).
    """
    G, n, k, d = rows.shape
    dtype = x0.dtype
    if interpret is None:
        interpret = interpret_mode()
    bc = min(BLOCK_CHAINS, next_pow2(n))
    n_p = round_up(n, bc)
    d_p = next_pow2(d)

    def pad_gnd(a, fill=0.0):
        return jnp.pad(a, ((0, 0), (0, n_p - n), (0, d_p - d)),
                       constant_values=fill)

    x0_p = jnp.pad(x0, ((0, n_p - n), (0, d_p - d)))
    lp0_p = jnp.pad(logp0, (0, n_p - n))
    rows_p = jnp.pad(rows, ((0, 0), (0, n_p - n), (0, 0), (0, d_p - d)))
    # per-chain scalars chain-minor, so each scalar row loads contiguously
    scal_p = jnp.pad(jnp.swapaxes(scal, 1, 2), ((0, 0), (0, 0),
                                                (0, n_p - n)))

    closed_fn, consts, const_specs = hoist_target_consts(
        log_prob_block, bc, d_p, dtype)

    gnd = pl.BlockSpec((G, bc, d_p), lambda i: (0, i, 0))
    gn = pl.BlockSpec((G, bc), lambda i: (0, i))
    in_specs = [
        pl.BlockSpec((bc, d_p), lambda i: (i, 0)),                # x0
        pl.BlockSpec((bc,), lambda i: (i,)),                      # lp0
        pl.BlockSpec((G, bc, k, d_p), lambda i: (0, i, 0, 0)),    # rows
        gnd, gnd, gnd,                                   # u_mask/u_e/eps
        pl.BlockSpec((G, N_SCAL, bc), lambda i: (0, 0, i)),       # scal
    ]
    xh, lph, acc = pl.pallas_call(
        _make_kernel(closed_fn, len(consts), G, n_pairs, k, d_true,
                     float(b), float(b_star)),
        grid=(n_p // bc,),
        in_specs=in_specs + const_specs,
        out_specs=[gnd, gn, gn],
        out_shape=[
            jax.ShapeDtypeStruct((G, n_p, d_p), dtype),
            jax.ShapeDtypeStruct((G, n_p), dtype),
            jax.ShapeDtypeStruct((G, n_p), jnp.int32),
        ],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=NUM_STAGES),
        interpret=interpret,
        name="dream_fused_chunk",
    )(x0_p, lp0_p, rows_p, pad_gnd(u_mask, fill=2.0), pad_gnd(u_e),
      pad_gnd(eps), scal_p, *consts)

    return xh[:, :n, :d], lph[:, :n], acc[:, :n] > 0
