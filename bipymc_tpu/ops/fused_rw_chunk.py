"""Fused multi-step random-walk (MH/DR/DRAM) chunk: K steps in ONE kernel.

The single-chain DRAM hot loop (SURVEY.md §5.1; reference ``Dram.run_mcmc``
Python loop) is the most launch-bound path in the framework: per step the
useful math is a few hundred flops behind a full launch round-trip, and
unlike the ensemble samplers there is no batch axis to amortise it. This
module applies the fused-chunk treatment of DREAM-zs (ops/fused_chunk.py):
one ``pallas_call`` advances K steps; the grid runs over chain blocks and
a ``fori_loop`` inside each block carries (theta, logp) from step to step.

What makes the RW family fusable — division of labour per chunk:

- The stage-1 proposal Cholesky is CONSTANT between AM refresh points
  (samplers/rw.py refreshes at ``(t+1) % adapt_interval == 0``), so with
  K = adapt_interval and chunk starts aligned to refresh boundaries the
  trajectory inside a chunk depends only on (theta, logp) and
  pregenerated randomness. The Welford mean/scatter updates do NOT feed
  back within the chunk — samplers/rw_fused.py replays them bit-exactly
  from the chunk history afterwards and applies the refresh at the
  boundary.
- XLA (once per chunk): the exact per-step bits stream of
  samplers/rw.py's ``_default_draws`` (one [2d+2]-word block per
  (step, chain)), the proposal displacements ``dy1 = L z1`` and
  ``dy2 = (L/√κ) z2`` (batched matmuls against the frozen factor), and
  the whitened norms ‖z₁‖², ‖z₁ − z₂/√κ‖² that the Green–Mira ratio
  needs (samplers/rw.py's no-triangular-solve trick — they are functions
  of the raw draws only).
- Pallas (this kernel), per step: y₁ = θ + dy₁, the target log-density
  (inlined ``log_prob_block``), and for DR the second stage y₂ = θ + dy₂
  with the exact Green–Mira acceptance; Metropolis select; history out.

Trajectories are bit-identical in randomness to the per-step engine and
match to float re-association in math (tests/test_fused_rw.py).
"""

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

# the SAME log1mexp the per-step engine uses, so a numerical tweak cannot
# desynchronise the two engines' Green–Mira acceptance
# (tests/test_fused_rw.py pins the agreement)
from bipymc_tpu.core.numerics import log1mexp as _log1mexp
from bipymc_tpu.ops.fused_chunk import hoist_target_consts
from jax.experimental.pallas import triton as pl_triton

from bipymc_tpu.ops.route import interpret_mode, next_pow2, round_up

# per-chain scalar rows of ``scal`` ([K, 4, n] inside the wrapper)
S_SZ1, S_SW, S_LU1, S_LU2 = range(4)
N_SCAL = 4

# chains per program and Triton launch parameters, the fastest of a sweep
# of the runner at 256 chains × d=100 on an H100 (PERF.md); at 1-4
# chains the choice made no measurable difference
BLOCK_CHAINS = 8
NUM_WARPS = 4
NUM_STAGES = 1


def _make_kernel(closed_fn, n_consts, n_steps, delayed):

    def kernel(*refs):
        if delayed:
            x0_ref, lp0_ref, dy1_ref, dy2_ref, scal_ref = refs[:5]
            rest = refs[5:]
        else:
            x0_ref, lp0_ref, dy1_ref, scal_ref = refs[:4]
            rest = refs[4:]
        const_refs = rest[:n_consts]
        xh_ref, lph_ref, acc_ref, stage_ref = rest[n_consts:]

        def step(s, carry):
            x, lp = carry                         # [BC, Dp], [BC, 1]

            def col(c):
                return scal_ref[s, c, :][:, None]  # [BC, 1]

            # ---- stage 1: y₁ = θ + L z₁ (displacement precomputed) ----
            y1 = x + dy1_ref[s]
            l1 = closed_fn(y1, *const_refs)       # [BC, 1]
            log_a1 = jnp.minimum(0.0, l1 - lp)
            # non-finite hard-reject, sanitizing LOG_A1 itself: guarding
            # only the accept bit would leave log_a1 = 0 in the
            # Green–Mira denominator below, and a +inf l1 would then make
            # stage 2 accept almost surely. Identical math to
            # samplers/rw.py / flowmh.py.
            log_a1 = jnp.where(jnp.isfinite(l1), log_a1,
                               jnp.full_like(log_a1, -jnp.inf))
            acc1 = col(S_LU1) < log_a1

            if delayed:
                # ---- stage 2: Green–Mira in whitened coordinates ------
                y2 = x + dy2_ref[s]
                l2 = closed_fn(y2, *const_refs)
                log_a1_rev = jnp.minimum(0.0, l1 - l2)
                lq_diff = -0.5 * (col(S_SW) - col(S_SZ1))
                log_num = l2 + _log1mexp(log_a1_rev)
                log_den = lp + _log1mexp(log_a1)
                log_a2 = jnp.minimum(0.0, log_num + lq_diff - log_den)
                log_a2 = jnp.where(jnp.isfinite(l2), log_a2,
                                   jnp.full_like(log_a2, -jnp.inf))
                acc2 = jnp.logical_and(jnp.logical_not(acc1),
                                       col(S_LU2) < log_a2)
            else:
                y2, l2 = y1, l1
                acc2 = jnp.zeros_like(acc1)

            x = jnp.where(acc1, y1, jnp.where(acc2, y2, x))
            lp = jnp.where(acc1, l1, jnp.where(acc2, l2, lp))
            stage = jnp.where(acc1, 1, jnp.where(acc2, 2, 0))

            xh_ref[s] = x
            lph_ref[s, :] = lp.reshape(-1)
            acc_ref[s, :] = jnp.logical_or(acc1, acc2).reshape(-1).astype(
                jnp.int32)
            stage_ref[s, :] = stage.reshape(-1).astype(jnp.int32)
            return x, lp

        lax.fori_loop(0, n_steps, step,
                      (x0_ref[...], lp0_ref[...][:, None]))

    return kernel


@functools.partial(
    jax.jit,
    static_argnames=("log_prob_block", "delayed", "interpret"))
def fused_rw_chunk_pallas(x0, logp0, dy1, dy2, scal, log_prob_block,
                          delayed, interpret=None):
    """Advance K random-walk steps in one kernel launch.

    x0 [n, d]; logp0 [n]; dy1/dy2 [K, n, d] precomputed stage-1/2
    proposal displacements (L z₁, (L/√κ) z₂ against the chunk's frozen
    Cholesky); scal [K, n, 4] per-chain scalars (‖z₁‖², ‖z₁ − z₂/√κ‖²,
    log u₁, log u₂). With ``delayed=False`` pass ``dy2=None``; only the
    log u₁ column is read. log_prob_block: hashable ``[BC, Dp] ->
    [BC, 1]`` on zero-padded columns (ops/fused_chunk.py).
    ``interpret=None`` lets ops/route.py decide. Returns (x_hist
    [K, n, d], logp_hist [K, n], accepted [K, n] bool, stage [K, n]
    int32).
    """
    K, n, d = dy1.shape
    dtype = x0.dtype
    if interpret is None:
        interpret = interpret_mode()
    bc = min(BLOCK_CHAINS, next_pow2(n))
    n_p = round_up(n, bc)
    d_p = next_pow2(d)

    def pad_knd(a):
        return jnp.pad(a, ((0, 0), (0, n_p - n), (0, d_p - d)))

    closed_fn, consts, const_specs = hoist_target_consts(
        log_prob_block, bc, d_p, dtype)

    knd = pl.BlockSpec((K, bc, d_p), lambda i: (0, i, 0))
    kn = pl.BlockSpec((K, bc), lambda i: (0, i))
    in_specs = [pl.BlockSpec((bc, d_p), lambda i: (i, 0)),       # x0
                pl.BlockSpec((bc,), lambda i: (i,)),             # lp0
                knd]                                             # dy1
    operands = [jnp.pad(x0, ((0, n_p - n), (0, d_p - d))),
                jnp.pad(logp0, (0, n_p - n)), pad_knd(dy1)]
    if delayed:
        in_specs.append(knd)                                     # dy2
        operands.append(pad_knd(dy2))
    in_specs.append(pl.BlockSpec((K, N_SCAL, bc), lambda i: (0, 0, i)))
    operands.append(jnp.pad(jnp.swapaxes(scal, 1, 2),
                            ((0, 0), (0, 0), (0, n_p - n))))

    xh, lph, acc, stage = pl.pallas_call(
        _make_kernel(closed_fn, len(consts), K, bool(delayed)),
        grid=(n_p // bc,),
        in_specs=in_specs + const_specs,
        out_specs=[knd, kn, kn, kn],
        out_shape=[
            jax.ShapeDtypeStruct((K, n_p, d_p), dtype),
            jax.ShapeDtypeStruct((K, n_p), dtype),
            jax.ShapeDtypeStruct((K, n_p), jnp.int32),
            jax.ShapeDtypeStruct((K, n_p), jnp.int32),
        ],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=NUM_STAGES),
        interpret=interpret,
        name="rw_fused_chunk",
    )(*operands, *consts)

    return xh[:, :n, :d], lph[:, :n], acc[:, :n] > 0, stage[:, :n]
