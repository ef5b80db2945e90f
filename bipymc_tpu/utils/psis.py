"""Pareto-smoothed importance sampling (PSIS) — beyond-reference.

Closes the loop the reference leaves open in its surrogate workflow
(SURVEY.md §5.4, BASELINE config 5): chains sample the *surrogate*
posterior, and nothing quantifies — let alone corrects — the surrogate's
error. Importance weights w = π_exact/π_surrogate at the sampled points
do both, but raw self-normalised IS weights have unbounded variance the
moment the surrogate is too light-tailed. PSIS (Vehtari, Simpson,
Gelman, Yao & Gabry, JMLR 2024) fits a generalised Pareto distribution
to the largest weights and replaces them with their smoothed order
statistics; the fitted shape k̂ is a *reliability certificate*:
k̂ < 0.7 → the reweighted estimate converges with useful variance,
k̂ ≥ 0.7 → the surrogate is too wrong in the tails, retrain it (or
sample the exact target directly).

Accelerator mapping: everything is static-shape sorting + reductions — the GPD
fit is the Zhang & Stephens (2009) profile posterior on a fixed grid of
m = 30+⌊√M⌋ slope candidates (no iterative optimiser), so the whole
pipeline jits and the exact-likelihood evaluation it needs (one batch
over the kept draws) vmaps/shards like any other likelihood — including
host-side ones via ``utils.external.external_log_like``.

API: :func:`gpd_fit` (Zhang-Stephens), :func:`psis` (smoothed log
weights + k̂), :func:`importance_ess`, :func:`importance_resample`,
:func:`surrogate_reweight` (the config-5 one-call workflow).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np


def gpd_fit(y, prior_bs=3.0, prior_k=10.0):
    """Generalised-Pareto (k, σ) fit to exceedances ``y`` > 0.

    Zhang & Stephens (2009): a profile posterior over a deterministic
    grid of m = 30+⌊√n⌋ candidates for θ = −k/σ, weighted by profile
    likelihood, with the weakly-informative k-prior of Vehtari et al.
    (2024) app. C stabilising small tails. Positive k = heavy tail.
    Fully jittable (static shapes, no host optimiser).
    """
    y = jnp.sort(jnp.asarray(y))
    n = y.shape[0]
    m = 30 + int(math.isqrt(n))
    dtype = y.dtype
    j = jnp.arange(1, m + 1, dtype=dtype)
    quart = y[int(n / 4 + 0.5) - 1]
    b = 1.0 - jnp.sqrt(m / (j - 0.5))
    b = b / (prior_bs * quart) + 1.0 / y[-1]            # θ grid [m]
    k_grid = jnp.mean(jnp.log1p(-b[:, None] * y[None, :]), axis=1)  # [m]
    # profile log-likelihood of each θ candidate
    logl = n * (jnp.log(-b / k_grid) - k_grid - 1.0)
    w = 1.0 / jnp.sum(jnp.exp(logl[None, :] - logl[:, None]), axis=1)
    b_post = jnp.sum(b * w) / jnp.sum(w)
    k_post = jnp.mean(jnp.log1p(-b_post * y))
    # σ from the RAW k (sign(k_raw) = −sign(b_post), so σ > 0 always);
    # regularising first can flip k's sign near 0 and poison σ — seen as
    # NaN elpd on real MCMC draws whose tail k̂ ≈ 0.
    sigma = -k_post / b_post
    # regularise k towards 0.5 (Vehtari et al. 2024): keeps k̂ usable at
    # small tail sizes where the raw MLE is noisy
    k_post = (n * k_post + prior_k * 0.5) / (n + prior_k)
    return k_post, sigma


def _gpd_quantile(p, k, sigma):
    """Inverse CDF of GPD(k, σ): σ·((1−p)^(−k) − 1)/k, k→0 limit −σ·ln(1−p)."""
    safe_k = jnp.where(jnp.abs(k) < 1e-12, 1.0, k)
    x = jnp.where(jnp.abs(k) < 1e-12,
                  -jnp.log1p(-p),
                  jnp.expm1(-safe_k * jnp.log1p(-p)) / safe_k)
    return sigma * x


def psis(logw, tail_frac=0.2):
    """Pareto-smooth a vector of log importance weights.

    logw: [n] unnormalised log weights. Returns ``(logw_smoothed, khat)``
    — same shape/order, shifted so max = 0 (self-normalisation ignores
    the shift), with the M = ⌈min(tail_frac·n, 3√n)⌉ largest weights
    replaced by the order statistics of the fitted GPD (at expectation
    plotting positions (z−½)/M) and capped at the raw maximum.

    khat interpretation (Vehtari et al. 2024): < 0.5 excellent, < 0.7
    usable, ≥ 0.7 the IS estimate is unreliable — act on it, don't
    report the reweighted numbers. Jittable at fixed n.
    """
    logw = jnp.asarray(logw)
    n = logw.shape[0]
    if n < 5:
        raise ValueError(f"psis: need ≥5 draws, got {n}")
    m_tail = int(np.ceil(min(tail_frac * n, 3.0 * np.sqrt(n))))
    m_tail = max(m_tail, 5)
    logw = logw - jnp.max(logw)
    order = jnp.argsort(logw)                       # ascending
    sorted_lw = logw[order]
    cutoff_lw = sorted_lw[n - m_tail - 1]           # largest non-tail
    cutoff = jnp.exp(cutoff_lw)
    exceed = jnp.exp(sorted_lw[n - m_tail:]) - cutoff    # [M] ascending ≥ 0
    # Degenerate tail (all weights equal — e.g. a log-lik constant in θ):
    # nothing to smooth, and gpd_fit would 1/0. Fit a dummy tail instead
    # and select the untouched weights with k̂ = −inf ("no tail at all").
    tail_span = exceed[-1]
    dummy = jnp.arange(1, m_tail + 1, dtype=logw.dtype) / m_tail
    khat, sigma = gpd_fit(jnp.where(tail_span > 0, exceed, dummy))
    p = (jnp.arange(1, m_tail + 1, dtype=logw.dtype) - 0.5) / m_tail
    smoothed = jnp.log(_gpd_quantile(p, khat, sigma) + cutoff)
    smoothed = jnp.minimum(smoothed, 0.0)           # cap at raw max (=0)
    smoothed = jnp.where(tail_span > 0, smoothed, sorted_lw[n - m_tail:])
    khat = jnp.where(tail_span > 0, khat, -jnp.inf)
    new_sorted = sorted_lw.at[n - m_tail:].set(smoothed)
    out = jnp.zeros_like(logw).at[order].set(new_sorted)
    return out, khat


def importance_ess(logw):
    """Effective sample size of self-normalised weights:
    (Σw)²/Σw² ∈ [1, n] (Kong 1992). Shift-invariant."""
    logw = jnp.asarray(logw) - jnp.max(logw)
    w = jnp.exp(logw)
    return jnp.sum(w) ** 2 / jnp.sum(w * w)


def importance_resample(key, samples, logw, n=None):
    """Draw ``n`` (default: len) indices ∝ exp(logw) with replacement —
    turns a weighted sample set back into an unweighted one
    (sampling-importance-resampling). Returns the resampled rows."""
    samples = jnp.asarray(samples)
    if n is None:
        n = samples.shape[0]
    idx = jax.random.categorical(key, jnp.asarray(logw), shape=(n,))
    return samples[idx]


def weighted_moments(samples, logw):
    """Self-normalised IS posterior mean and variance per dimension."""
    samples = jnp.atleast_2d(jnp.asarray(samples))
    w = jnp.exp(jnp.asarray(logw) - jnp.max(logw))
    w = w / jnp.sum(w)
    mean = w @ samples
    var = w @ (samples - mean) ** 2
    return mean, var


def surrogate_reweight(samples, log_prob_exact, log_prob_surrogate,
                       tail_frac=0.2):
    """Correct a surrogate-posterior sample set towards the exact posterior.

    samples: [n, d] draws from the *surrogate* posterior (e.g. flattened
    kept history of a config-5 run). log_prob_exact / log_prob_surrogate:
    per-row callables ([d] → scalar, vmapped here) — unnormalised is fine
    (self-normalisation absorbs constants); ``log_prob_exact`` may be an
    :func:`~bipymc_tpu.utils.external.external_log_like` host callback.

    Returns a dict: ``logw`` (smoothed, max 0), ``khat``, ``ess``
    (of the smoothed weights), ``mean``/``var`` (self-normalised IS
    moments under the exact posterior), ``reliable`` (khat < 0.7).
    """
    samples = jnp.atleast_2d(jnp.asarray(samples))
    lw = (jax.vmap(log_prob_exact)(samples)
          - jax.vmap(log_prob_surrogate)(samples))
    logw, khat = psis(lw, tail_frac=tail_frac)
    mean, var = weighted_moments(samples, logw)
    return {
        "logw": logw,
        "khat": khat,
        "ess": importance_ess(logw),
        "mean": mean,
        "var": var,
        "reliable": khat < 0.7,
    }
