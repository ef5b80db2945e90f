"""Pairwise squared distances for the GP kernel-matrix builds.

The O(n²d) kernel-matrix build decomposes as ‖x‖² + ‖x′‖² − 2 x x′ᵀ
(SURVEY.md §9 step 6), putting the cross term on one matrix product
that XLA hands to cuBLAS.
"""

import jax
import jax.numpy as jnp


def _sqdist_xla(A, B):
    a_nrm = jnp.sum(A * A, axis=1, keepdims=True)
    b_nrm = jnp.sum(B * B, axis=1, keepdims=True)
    # HIGHEST: an unpinned float32 product runs in TF32 on the GPU (~3
    # decimal digits), and the ‖a‖²+‖b‖²−2ab cancellation amplifies that
    # into absolute distance errors large enough to corrupt small
    # distances — and with them a GP Gram matrix.
    cross = jnp.matmul(A, B.T, precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(a_nrm + b_nrm.T - 2.0 * cross, 0.0)


def pairwise_sqdist(X, X2=None):
    """Pairwise squared Euclidean distances, [n, m].

    Centers the inputs first (distance-invariant) to tame the f32
    cancellation in the ‖·‖² decomposition. float64 inputs keep their
    full precision; everything else is computed in float32.
    """
    X2 = X if X2 is None else X2
    mu = jnp.mean(X, axis=0)
    A = X - mu
    B = X2 - mu
    if A.dtype != jnp.float64:
        A = A.astype(jnp.float32)
        B = B.astype(jnp.float32)
    return _sqdist_xla(A, B)
