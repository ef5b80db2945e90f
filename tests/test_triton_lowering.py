"""Both fused kernels lower to a Pallas-Triton custom call for CUDA.

Cross-lowering (``.trace(...).lower(lowering_platforms=("cuda",))``)
runs the Triton lowering on this CPU box, so it catches what interpret
mode cannot: Triton's power-of-two rule on every loaded array, tensor
slicing it cannot express, and primitives it has no rule for. The GPU
compiler's own checks (shared memory, registers) still need the card
(tests/test_gpu_kernels.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bipymc_tpu.models.targets import (correlated_gaussian_block,
                                       gaussian_mixture,
                                       gaussian_mixture_block)
from bipymc_tpu.ops.fused_chunk import (block_logp_from_scalar,
                                        fused_chunk_pallas)
from bipymc_tpu.ops.fused_rw_chunk import fused_rw_chunk_pallas
from bipymc_tpu.ops.route import TRITON_CALL_TARGET


def _lower_cuda(fn, *args):
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()


def _dream_args(n, d, G=10, k=6):
    return (jnp.zeros((n, d)), jnp.zeros((n,)), jnp.zeros((G, n, k, d)),
            jnp.zeros((G, n, d)), jnp.zeros((G, n, d)),
            jnp.zeros((G, n, d)), jnp.zeros((G, n, 6)))


DIMS = [2, 5, 100]
CHAINS = [1, 7, 256]


@pytest.mark.parametrize("n", CHAINS)
@pytest.mark.parametrize("d", DIMS)
def test_dream_chunk_lowers_to_triton(d, n):
    blk = gaussian_mixture_block(
        np.arange(4 * d, dtype=np.float32).reshape(4, d))
    txt = _lower_cuda(
        lambda *a: fused_chunk_pallas(*a, log_prob_block=blk, n_pairs=3,
                                      d_true=d, b=1e-4, b_star=1e-6,
                                      interpret=False),
        *_dream_args(n, d))
    assert TRITON_CALL_TARGET in txt


@pytest.mark.parametrize("delayed", [False, True])
@pytest.mark.parametrize("n", CHAINS)
@pytest.mark.parametrize("d", DIMS)
def test_rw_chunk_lowers_to_triton(d, n, delayed):
    K = 20
    blk = correlated_gaussian_block(np.zeros(d, np.float32),
                                    np.eye(d, dtype=np.float32))
    dy = jnp.zeros((K, n, d))
    txt = _lower_cuda(
        lambda x, l, a, c, s: fused_rw_chunk_pallas(
            x, l, a, c, s, log_prob_block=blk, delayed=delayed,
            interpret=False),
        jnp.zeros((n, d)), jnp.zeros((n,)), dy, dy if delayed else None,
        jnp.zeros((K, n, 4)))
    assert TRITON_CALL_TARGET in txt


def test_scalar_wrapper_cannot_lower_for_odd_d():
    """Why the GPU needs a padded block form: the scalar wrapper slices
    the true dims off the padded block, which Triton cannot lower — the
    reason ``fused=True`` raises at construction on the GPU without
    ``log_prob_block=``."""
    d = 5
    lp = gaussian_mixture(np.zeros((2, d), np.float32))
    with pytest.raises(Exception):
        _lower_cuda(
            lambda *a: fused_chunk_pallas(
                *a, log_prob_block=block_logp_from_scalar(lp, d),
                n_pairs=3, d_true=d, b=1e-4, b_star=1e-6, interpret=False),
            *_dream_args(16, d))
