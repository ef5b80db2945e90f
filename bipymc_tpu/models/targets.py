"""Analytic target posteriors and example models.

The reference exercises its samplers on analytic posteriors — 1D/2D
Gaussians, the Rosenbrock/Haario banana, multimodal mixtures, and a
line-fit likelihood (SURVEY.md §6, `examples/` [U]; BASELINE configs 1–3).
All targets here are pure jnp log-densities, jit/vmap/grad-safe.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from bipymc_tpu.ops.route import next_pow2

# NOTE: constants captured by the returned log_prob closures are built with
# NumPy, not jnp, so tracing a target never reads device memory back.
#
# Padded block forms (``*_block``) are the in-kernel targets of the fused
# engines (ops/fused_chunk.py, ops/fused_rw_chunk.py): ``f(x [BC, Dp]) ->
# [BC, 1]`` where Dp = next_pow2(d) and the pad columns of x are zero.
# Every constant is zero-padded to power-of-two sizes and the body uses
# only elementwise ops, reductions and full-size dots, so it lowers
# through Pallas-Triton. Padding never changes the value: pad columns of
# x and of the constants are zero, and pad mixture components carry a
# log-weight of -inf.


def correlated_gaussian(mean, cov):
    """2D+ correlated-Gaussian log-density (BASELINE config 1).

    Returns ``log_prob(theta)`` for N(mean, cov), dropping additive consts
    is avoided so tests can check exact values.
    """
    mean = np.asarray(mean)
    cov = np.asarray(cov)
    d = mean.shape[-1]
    chol = np.linalg.cholesky(cov)
    log_det = 2.0 * float(np.sum(np.log(np.diagonal(chol))))
    inv = np.linalg.inv(cov)

    def log_prob(theta):
        r = theta - mean
        # quadratic form as matvec + reduce, NOT (r @ inv) @ r: the
        # second @ is a vector-vector dot that vmap turns into a batched
        # dot_general, which kernel lowerings handle poorly
        q = jnp.sum((r @ inv) * r, axis=-1)
        return -0.5 * (q + log_det + d * jnp.log(2.0 * jnp.pi))

    return log_prob


def correlated_gaussian_block(mean, cov):
    """Padded block form of :func:`correlated_gaussian` (see the module
    note). The quadratic form is one [BC, Dp] × [Dp, Dp] product at full
    float32 precision (``HIGHEST``: a TF32 product would lose digits the
    cancellation-free form keeps) when both sides are at least 16 wide —
    Triton's smallest dot — and a broadcast-and-reduce otherwise."""
    mean = np.asarray(mean)
    cov = np.asarray(cov)
    d = mean.shape[-1]
    d_p = next_pow2(d)
    chol = np.linalg.cholesky(cov)
    c = (2.0 * float(np.sum(np.log(np.diagonal(chol))))
         + d * float(np.log(2.0 * np.pi)))
    mean_p = np.zeros((1, d_p), mean.dtype)
    mean_p[0, :d] = mean
    inv_p = np.zeros((d_p, d_p), mean.dtype)
    inv_p[:d, :d] = np.linalg.inv(cov)

    def log_prob_block(x):
        r = x - mean_p
        if min(x.shape[0], d_p) >= 16:
            ri = jnp.dot(r, inv_p, precision=jax.lax.Precision.HIGHEST)
        else:
            ri = jnp.sum(r[:, :, None] * inv_p[None], axis=1)
        q = jnp.sum(ri * r, axis=1, keepdims=True)
        return -0.5 * (q + c)

    return log_prob_block


def banana(b=0.03, sigma1=10.0, d=2):
    """Haario's twisted-Gaussian "banana" (BASELINE config 2 posterior).

    y₁ = θ₁, y₂ = θ₂ + b·θ₁² − 100b with y ~ N(0, diag(σ₁², 1, …, 1)).
    With σ₁=10 the marginal moments are E[θ₁]=0, Var[θ₁]=100, E[θ₂]=0 —
    useful for moment-recovery tests.
    """

    def log_prob(theta):
        y1 = theta[0]
        y2 = theta[1] + b * theta[0] ** 2 - 100.0 * b
        lp = -0.5 * (y1 ** 2 / sigma1 ** 2 + y2 ** 2)
        if d > 2:
            lp = lp - 0.5 * jnp.sum(theta[2:] ** 2)
        return lp

    return log_prob


def banana_block(b=0.03, sigma1=10.0, d=2):
    """Padded block form of :func:`banana` (see the module note). Column
    picks are one-hot reductions: a kernel cannot slice a register
    tensor."""
    d_p = next_pow2(d)
    e0 = np.zeros((1, d_p), np.float32)
    e0[0, 0] = 1.0
    e1 = np.zeros((1, d_p), np.float32)
    e1[0, 1] = 1.0
    rest = np.zeros((1, d_p), np.float32)
    rest[0, 2:d] = 1.0

    def log_prob_block(x):
        y1 = jnp.sum(x * e0, axis=1, keepdims=True)
        t1 = jnp.sum(x * e1, axis=1, keepdims=True)
        y2 = t1 + b * y1 ** 2 - 100.0 * b
        lp = -0.5 * (y1 ** 2 / sigma1 ** 2 + y2 ** 2)
        if d > 2:
            lp = lp - 0.5 * jnp.sum(x * x * rest, axis=1, keepdims=True)
        return lp

    return log_prob_block


def rosenbrock(a=1.0, b=20.0):
    """Rosenbrock-valley log-density: −[(a−θ₁)² + b(θ₂−θ₁²)²]."""

    def log_prob(theta):
        return -((a - theta[0]) ** 2 + b * (theta[1] - theta[0] ** 2) ** 2)

    return log_prob


def baseline_config3_means(d=100, n_modes=4, spread=5.0, seed=1234):
    """Canonical mode centres for BASELINE config 3 (and the dryrun's tiny
    variant). One definition shared by bench.py, benchmarks/run_all.py and
    __graft_entry__ so the three harnesses provably measure the same
    target."""
    rng = np.random.default_rng(seed)
    return (spread * rng.standard_normal((n_modes, d))).astype(np.float32)


def stratified_mode_init(key, means, n, var=4.0, dtype=jnp.float32):
    """Overdispersed start points spanning ALL modes of a mixture.

    Chain i is placed in a ``var_ball`` around mode ``i % k`` — round-robin
    so every mode gets ⌈n/k⌉±1 chains (mode *proportions* match equal
    weights, which overdispersion across the posterior's support requires
    for R-hat validity — SURVEY.md §4.10; the reference's ``var_ball`` has
    exactly this purpose). A std-``spread`` ball at the ORIGIN is not
    overdispersed when the modes sit at radius ≈ |μ|·√d: the round-2
    headline benchmark initialised that way and its whole 256-chain
    population drifted into one basin during burn-in (verdict finding #2).

    means: [k, d] mode centres; var: per-dim variance of each ball
    (default 4 = std 2, overdispersed relative to the config-3 σ=1 modes).
    Returns [n, d].
    """
    from bipymc_tpu.utils.init import var_ball
    means = jnp.asarray(means, dtype)
    k, d = means.shape
    centers = means[jnp.arange(n) % k]                       # [n, d]
    noise = var_ball(key, jnp.full((d,), var, dtype), n, dtype=dtype)
    return centers + noise


def gaussian_mixture(means, sigma=1.0, weights=None):
    """Isotropic Gaussian mixture in d dims (BASELINE config 3 posterior).

    means: [k, d] component centers; sigma: shared std; weights: [k].
    """
    means = np.asarray(means)
    if not np.issubdtype(means.dtype, np.floating):
        # integer mode centres are natural input; an int dtype would
        # truncate -log(k) to 0 below and shift log_prob by a constant
        means = means.astype(np.float32)
    k, d = means.shape
    if weights is None:
        log_w = np.full((k,), -np.log(k), dtype=means.dtype)
    else:
        w = np.asarray(weights)
        log_w = np.log(w / np.sum(w))
    norm = -0.5 * d * float(np.log(2.0 * np.pi * sigma ** 2))

    def log_prob(theta):
        sq = jnp.sum((theta[None, :] - means) ** 2, axis=-1)
        return logsumexp(log_w + norm - 0.5 * sq / sigma ** 2)

    return log_prob


def gaussian_mixture_block(means, sigma=1.0, weights=None):
    """Padded block form of :func:`gaussian_mixture` (see the module
    note): components padded to a power of two with log-weight -inf,
    and a max-shifted log-sum-exp over the component axis."""
    means = np.asarray(means)
    if not np.issubdtype(means.dtype, np.floating):
        means = means.astype(np.float32)
    k, d = means.shape
    if weights is None:
        log_w = np.full((k,), -np.log(k), dtype=means.dtype)
    else:
        w = np.asarray(weights)
        log_w = np.log(w / np.sum(w))
    norm = -0.5 * d * float(np.log(2.0 * np.pi * sigma ** 2))
    k_p, d_p = next_pow2(k), next_pow2(d)
    mu = np.zeros((1, k_p, d_p), means.dtype)
    mu[0, :k, :d] = means
    lw = np.full((1, k_p), -np.inf, means.dtype)
    lw[0, :k] = log_w + norm

    def log_prob_block(x):
        sq = jnp.sum((x[:, None, :] - mu) ** 2, axis=-1)      # [BC, k_p]
        a = lw - 0.5 * sq / sigma ** 2
        m = jnp.max(a, axis=1, keepdims=True)
        return m + jnp.log(jnp.sum(jnp.exp(a - m), axis=1, keepdims=True))

    return log_prob_block


def neal_funnel(d=10, sigma_v=3.0):
    """Neal's funnel: v ~ N(0, σ_v²), θ_i | v ~ N(0, e^v), i=1..d−1.

    Standard stress test for samplers on strongly varying scales
    (beyond-reference extra).
    """

    def log_prob(theta):
        v = theta[0]
        lp_v = -0.5 * (v / sigma_v) ** 2
        lp_x = -0.5 * jnp.sum(theta[1:] ** 2) * jnp.exp(-v) \
            - 0.5 * (d - 1) * v
        return lp_v + lp_x

    return log_prob


def eggbox(scale=5.0, extent=10.0):
    """2-D eggbox: log π = [2 + cos(θ₁/s)·cos(θ₂/s)]⁵-style multimodal grid
    (beyond-reference extra; classic mode-hopping benchmark).

    The bare eggbox is non-normalisable; a soft box of half-width
    ``extent·scale`` makes it a proper density (the classic benchmark
    restricts to a box for the same reason).
    """

    def log_prob(theta):
        box = -jnp.sum((theta / (extent * scale)) ** 8)
        return (2.0 + jnp.cos(theta[0] / scale) *
                jnp.cos(theta[1] / scale)) ** 5 / 50.0 + box

    return log_prob


def line_fit_log_like(x, y, sigma):
    """Gaussian likelihood for y = m·x + c (the reference's line-fit example).

    theta = [m, c]. Returns the log-likelihood function.
    """
    x = np.asarray(x)
    y = np.asarray(y)

    def log_like(theta):
        resid = y - (theta[0] * x + theta[1])
        return -0.5 * jnp.sum(resid ** 2) / sigma ** 2

    return log_like
