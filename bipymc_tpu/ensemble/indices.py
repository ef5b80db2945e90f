"""Vectorised sampling without replacement.

DE-MC needs r₁ ≠ r₂ ≠ i drawn uniformly from the population, and DREAM-z
needs up to 2δ+3 distinct archive rows, per chain per generation
(SURVEY.md §4.5–4.7). The reference does this with per-chain
``np.random.choice(..., replace=False)``; under ``vmap`` with a *traced*
population size (the archive's fill count) that is unavailable, so we use
the exact sequential shift method (SURVEY.md §9 "Hard parts": must be
bias-free): the t-th draw is uniform over ``n − t`` values and is shifted
past the already-chosen values in increasing order. O(k²) scalar ops per
chain for static k — negligible next to the likelihood.
"""

import jax
import jax.numpy as jnp

# Host int, not a jnp scalar: closed-over *device* arrays get embedded as
# MLIR constants at trace time, which forces a device->host fetch.
_SENTINEL = 2 ** 31 - 1


def sample_distinct_topk(key, k: int, n, capacity: int, exclude=None):
    """Draw ``k`` distinct ints uniformly from [0, n) via iid-uniform top-k.

    The accelerator-native form of sampling without replacement: give every
    slot in
    [0, capacity) an iid U(0,1) score, mask slots outside [0, n) (and the
    optional ``exclude`` index) to −1, and take the top-k scores. The top-k
    of iid uniforms is a uniformly random k-subset in uniformly random
    order (the Gumbel/top-k trick with uniform weights), so this is exact —
    and it is one wide vectorised op instead of :func:`sample_distinct`'s
    O(k²) dependent scalar chain, which is latency-bound on accelerators.

    capacity: static upper bound for n (e.g. archive buffer size,
    population size). n may be traced. Caller guarantees n ≥ k (+1 with
    exclude). Returns int32 [k].
    """
    u = jax.random.uniform(key, (capacity,))
    valid = jnp.arange(capacity) < jnp.asarray(n, jnp.int32)
    if exclude is not None:
        valid &= jnp.arange(capacity) != jnp.asarray(exclude, jnp.int32)
    _, idx = jax.lax.top_k(jnp.where(valid, u, -1.0), k)
    return idx.astype(jnp.int32)


def sample_distinct(key, k: int, n, exclude=None):
    """Draw ``k`` distinct ints uniformly from [0, n), optionally ≠ exclude.

    k: static Python int. n: scalar (may be traced — e.g. archive fill).
    exclude: optional scalar index also excluded from the draw.
    Caller must guarantee n ≥ k (+1 if exclude is given).
    Returns int32 [k].
    """
    # one batched bits draw instead of k randint kernels; r_t uniform on
    # [0, avail−t) via the masked-31-bit int32 remainder construction in
    # distinct_from_bits (bias ~avail/2³¹ — the same class as randint's
    # own remainder construction, < 2⁻¹⁵ at the largest archives)
    bits = jax.random.bits(key, (k,), jnp.uint32)
    return distinct_from_bits(bits, k, n, exclude=exclude)


def distinct_from_bits(bits, k: int, n, exclude=None):
    """:func:`sample_distinct` driven by ``k`` caller-supplied uint32 words.

    Lets samplers that draw all their per-generation randomness as one
    batched ``random.bits`` block (one threefry launch for the whole
    population instead of one per draw site) reuse the identical exact
    shift construction. ``sample_distinct(key, ...)`` ≡
    ``distinct_from_bits(random.bits(key, (k,), uint32), ...)``.

    The raw words are masked to 31 bits and the r_t draw uses *int32*
    remainder, so the construction is pure i32 arithmetic that XLA
    fuses into one loop (tests/test_distinct_idx.py holds it to a
    NumPy transcription of the same shift method). The modulo bias is avail/2³¹
    < 2⁻¹⁵ at the largest supported archives —
    the same class as randint's own remainder construction.
    """
    n = jnp.asarray(n, jnp.int32)
    m = k + (1 if exclude is not None else 0)
    taken = jnp.full((m,), _SENTINEL, dtype=jnp.int32)
    n_excl = 0
    if exclude is not None:
        taken = taken.at[0].set(jnp.asarray(exclude, jnp.int32))
        n_excl = 1
    avail = n - n_excl

    b31 = (bits & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
    idxs = jnp.arange(m, dtype=jnp.int32)
    out = []
    for t in range(k):
        r = b31[t] % (avail - t)
        # shift past taken values, processed in increasing (sorted) order
        for j in range(m):
            r = r + (r >= taken[j]).astype(jnp.int32)
        out.append(r)
        # branchless insert of r into the sorted `taken` (sentinels keep
        # the tail ordered): elementwise + one gather, so XLA fuses it —
        # unlike jnp.sort, which breaks the step into k extra kernels.
        pos = jnp.sum((taken < r).astype(jnp.int32))
        shifted = taken[jnp.maximum(idxs - 1, 0)]
        taken = jnp.where(idxs < pos, taken,
                          jnp.where(idxs == pos, r, shifted))
    return jnp.stack(out)
