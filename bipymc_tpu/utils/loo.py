"""PSIS-LOO cross-validation (Vehtari, Gelman & Gabry 2017) — beyond-reference.

Model comparison from ONE posterior sample set, no refits: the
leave-one-out predictive density p(y_i | y_−i) is estimated by
importance-sampling the full posterior with ratios 1/p(y_i | θ), made
usable by Pareto-smoothing each point's weights (utils/psis.py). The
per-point k̂ certifies each estimate the same way it certifies the
surrogate reweighting — the failure mode (a point so influential that
leaving it out reshapes the posterior) is *detected*, not silently
averaged over.

Complements the SMC evidence path (samplers/smc.py):
log-evidence compares models through the prior (sensitive to prior
spread); elpd_loo compares predictive performance on the data scale.

Accelerator mapping: input is a [S, n] pointwise log-likelihood matrix (S
draws,
n observations) — one ``vmap`` of the model's per-point log-density over
the kept history builds it; the per-point PSIS fits are a second vmap
over the n axis (static shapes, no host loop: the Zhang-Stephens fit is
a fixed-grid reduction).
"""

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from bipymc_tpu.utils.psis import psis


def pointwise_loglik(loglik_fn, draws):
    """Build the [S, n] matrix: ``loglik_fn(theta) -> [n]`` vmapped over
    posterior draws [S, d]."""
    return jax.vmap(loglik_fn)(jnp.atleast_2d(jnp.asarray(draws)))


def loo(loglik, tail_frac=0.2):
    """PSIS-LOO from a pointwise log-likelihood matrix ``loglik [S, n]``.

    Returns a dict:
      ``elpd_loo``   Σᵢ log p̂(yᵢ|y₋ᵢ) — higher is better
      ``se``         √(n · Var(elpdᵢ)) standard error
      ``p_loo``      effective parameter count (lpd − elpd_loo)
      ``elpd_i``     [n] per-observation contributions
      ``khat``       [n] per-observation Pareto k̂ (≥ 0.7 → that point's
                     estimate is unreliable; refit or use moment matching)
      ``n_bad``      count of khat ≥ 0.7
    """
    loglik = jnp.asarray(loglik)
    if loglik.ndim != 2:
        raise ValueError(f"loglik must be [S, n], got {loglik.shape}")
    s, n = loglik.shape

    def per_point(ll_i):
        # raw LOO ratios r_s ∝ 1/p(y_i|θ_s)
        logw, khat = psis(-ll_i, tail_frac=tail_frac)
        elpd_i = logsumexp(ll_i + logw) - logsumexp(logw)
        return elpd_i, khat

    elpd_i, khat = jax.vmap(per_point, in_axes=1)(loglik)
    lpd_i = logsumexp(loglik, axis=0) - jnp.log(s)       # in-sample lpd
    elpd = jnp.sum(elpd_i)
    se = jnp.sqrt(n * jnp.var(elpd_i, ddof=1))
    return {
        "elpd_loo": elpd,
        "se": se,
        "p_loo": jnp.sum(lpd_i - elpd_i),
        "elpd_i": elpd_i,
        "khat": khat,
        "n_bad": jnp.sum(khat >= 0.7),
    }


def waic(loglik):
    """WAIC (Watanabe 2010) from a pointwise log-likelihood matrix
    ``loglik [S, n]`` — the no-importance-sampling companion to
    :func:`loo` (Vehtari, Gelman & Gabry 2017 §2.2): the effective
    parameter count is the posterior VARIANCE of each point's
    log-density, p_waicᵢ = Var_s(log p(yᵢ|θ_s)), and
    elpd_waicᵢ = lpdᵢ − p_waicᵢ.

    Cheaper and smoother than PSIS-LOO but with a weaker reliability
    story: there is no k̂; the standard flag (Vehtari et al. 2017 §2.3)
    is p_waicᵢ > 0.4, counted here as ``n_bad``. Prefer :func:`loo` when
    any point is influential — WAIC's truncated-series bias grows
    exactly where LOO's k̂ would have warned.

    Returns the same dict shape as :func:`loo` (``elpd_waic``/``p_waic``
    keys), so :func:`loo_compare` accepts either, but do not mix the two
    estimators in one comparison.
    """
    loglik = jnp.asarray(loglik)
    if loglik.ndim != 2:
        raise ValueError(f"loglik must be [S, n], got {loglik.shape}")
    s, n = loglik.shape
    lpd_i = logsumexp(loglik, axis=0) - jnp.log(s)
    p_i = jnp.var(loglik, axis=0, ddof=1)
    elpd_i = lpd_i - p_i
    return {
        "elpd_waic": jnp.sum(elpd_i),
        "se": jnp.sqrt(n * jnp.var(elpd_i, ddof=1)),
        "p_waic": jnp.sum(p_i),
        "elpd_i": elpd_i,
        "p_waic_i": p_i,
        "n_bad": jnp.sum(p_i > 0.4),
    }


def _elpd_of(r):
    for key in ("elpd_loo", "elpd_waic"):
        if key in r:
            return key, float(r[key])
    raise ValueError("result carries neither elpd_loo nor elpd_waic")


def loo_compare(results):
    """Rank models by elpd. ``results``: dict name → :func:`loo` or
    :func:`waic` output (one estimator throughout; models must share the
    observation set so elpd_i aligns).

    Returns a list of dicts sorted best-first with ``d_elpd`` (vs the
    best) and ``d_se`` — the SE of the *paired* difference
    √(n·Var(elpdᵢᴬ − elpdᵢᴮ)), the quantity that decides whether a gap is
    real (Vehtari et al. 2017 §5.2). |d_elpd| > 2·d_se is the usual bar.
    """
    if not results:
        raise ValueError("loo_compare: empty results")
    n_set = {int(r["elpd_i"].shape[0]) for r in results.values()}
    if len(n_set) != 1:
        raise ValueError(
            f"models score different observation counts: {sorted(n_set)}")
    key_set = {_elpd_of(r)[0] for r in results.values()}
    if len(key_set) != 1:
        raise ValueError(
            "mixing loo and waic results in one comparison: "
            f"{sorted(key_set)}")
    elpd_key = key_set.pop()
    p_key = "p_loo" if elpd_key == "elpd_loo" else "p_waic"
    ranked = sorted(results.items(),
                    key=lambda kv: _elpd_of(kv[1])[1], reverse=True)
    best = ranked[0][1]
    out = []
    n = int(best["elpd_i"].shape[0])
    for name, r in ranked:
        diff = best["elpd_i"] - r["elpd_i"]
        out.append({
            "name": name,
            elpd_key: _elpd_of(r)[1],
            "se": float(r["se"]),
            p_key: float(r[p_key]),
            "d_elpd": float(jnp.sum(diff)),
            "d_se": float(jnp.sqrt(n * jnp.var(diff, ddof=1)))
            if name != ranked[0][0] else 0.0,
            "n_bad": int(r["n_bad"]),
        })
    return out
