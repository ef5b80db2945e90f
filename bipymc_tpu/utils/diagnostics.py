"""Convergence diagnostics — all computed on-device.

Reference capability (SURVEY.md §4.8, [B]): Gelman-Rubin R-hat,
autocorrelation / effective sample size, acceptance fraction. The reference
computes these post-hoc on host NumPy arrays; here they are jittable jnp
functions, so they run on-device over device-resident histories and inside
scan-carried streaming state (see :mod:`bipymc_tpu.utils.streaming` for the
R-hat early-stopping form used by BASELINE config 5).

Chain-history convention: ``chains[M, N, d]`` = M chains × N steps × d dims
(1-d histories ``[M, N]`` are promoted).
"""

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np


def _promote(chains):
    chains = jnp.asarray(chains)
    if chains.ndim == 2:
        chains = chains[..., None]
    return chains


def _acf_normalized(chains):
    """Per-chain/dim normalised ACF via zero-padded FFT: [M,N,d]→[M,N,d].

    Zero-variance chain/dim (e.g. a stuck chain) → ρ := 0, not NaN.
    """
    n = chains.shape[1]
    x = chains - jnp.mean(chains, axis=1, keepdims=True)
    nfft = 2 * n  # zero-pad to avoid circular correlation
    f = jnp.fft.rfft(x, n=nfft, axis=1)
    acf = jnp.fft.irfft(f * jnp.conj(f), n=nfft, axis=1)[:, :n, :]
    acf0 = acf[:, :1, :]
    return jnp.where(acf0 > 0.0, acf / jnp.maximum(acf0, 1e-30), 0.0)


def gelman_rubin(chains, split=True):
    """Split-R̂ (Gelman & Rubin 1992; split variant of Gelman et al. BDA3).

    chains: [M, N, d]. Returns R̂ per dimension, shape [d].
    W = mean within-chain variance, B/n = variance of chain means,
    V̂ = (n−1)/n·W + B/n, R̂ = √(V̂/W)  (SURVEY.md §4.8).
    ``split=True`` halves each chain first (detects within-chain drift).
    """
    chains = _promote(chains)
    m, n, d = chains.shape
    if split:
        half = n // 2
        chains = jnp.concatenate(
            [chains[:, :half, :], chains[:, n - half:, :]], axis=0)
        m, n = 2 * m, half
    means = jnp.mean(chains, axis=1)                        # [m, d]
    variances = jnp.var(chains, axis=1, ddof=1)             # [m, d]
    w = jnp.mean(variances, axis=0)                         # within
    b_over_n = jnp.var(means, axis=0, ddof=1)               # between / n
    v_hat = (n - 1) / n * w + b_over_n
    return jnp.sqrt(v_hat / w)


def _ranks_to_z(x):
    """Rank-normalise pooled draws [M,N,d] → standard-normal scores.

    Rank via scatter of the argsort order; Blom-style fractional ranks
    through the inverse-erf transform (Vehtari et al. 2021 eq. 14)."""
    m, n, d = x.shape
    flat = x.reshape(m * n, d)
    order = jnp.argsort(flat, axis=0)
    ranks = jnp.zeros_like(order).at[
        order, jnp.arange(d)[None, :]].set(
        jnp.arange(m * n)[:, None].astype(order.dtype) + 1)
    frac = (ranks.astype(x.dtype) - 0.375) / (m * n + 0.25)
    z = jnp.sqrt(2.0) * jax.scipy.special.erfinv(2.0 * frac - 1.0)
    return z.reshape(m, n, d)


def rank_normalized_rhat(chains):
    """Rank-normalised split-R̂ (Vehtari, Gelman, Simpson, Carpenter &
    Bürkner 2021) — beyond-reference diagnostics upgrade.

    Classical R̂ assumes roughly Gaussian marginals and is blind to
    heavy tails and variance differences between chains. This variant
    returns max(R̂ of rank-normalised draws, R̂ of rank-normalised
    FOLDED draws |x − median|): the bulk term catches location
    disagreement, the folded term scale/tail disagreement.

    chains: [M, N, d] → [d]. Jittable (rank via double argsort; normal
    quantiles via the inverse-erf transform of the fractional ranks).
    """
    chains = _promote(chains)
    bulk = gelman_rubin(_ranks_to_z(chains), split=True)
    folded = jnp.abs(chains - jnp.median(chains, axis=(0, 1)))
    tail = gelman_rubin(_ranks_to_z(folded), split=True)
    return jnp.maximum(bulk, tail)


def autocorr_fn(chains, max_lag=None):
    """Normalised autocorrelation ρ_t via FFT, averaged over chains and dims.

    chains: [M, N, d] → ρ[max_lag] with ρ_0 = 1. FFT of centered chains
    (SURVEY.md §4.8), per chain/dim, then averaged.
    """
    chains = _promote(chains)
    if max_lag is None:
        max_lag = chains.shape[1]
    return jnp.mean(_acf_normalized(chains), axis=(0, 2))[:max_lag]


def _tau_from_rho(rho, c):
    """Sokal auto-window: smallest w with w ≥ c·τ(w) (emcee [P])."""
    taus = 2.0 * jnp.cumsum(rho) - 1.0                      # τ(w) for each w
    lags = jnp.arange(rho.shape[0])
    ok = lags >= c * taus
    # first index where the window criterion holds (fallback: last lag)
    idx = jnp.argmax(ok)
    window = jnp.where(jnp.any(ok), idx, rho.shape[0] - 1)
    return jnp.maximum(taus[window], 1.0)


def integrated_autocorr_time(chains, c=5.0, per_dim=False):
    """Integrated autocorrelation time τ with emcee-style auto-windowing.

    τ = 1 + 2 Σ_{t≥1} ρ_t truncated at the smallest window w with
    w ≥ c·τ(w) (Sokal's criterion as used by emcee [P]).
    per_dim=False: scalar τ from chain/dim-averaged ρ (cheap summary).
    per_dim=True: τ per dimension, shape [d] (use max for conservative
    ESS, emcee convention).
    """
    chains = _promote(chains)
    if not per_dim:
        return _tau_from_rho(autocorr_fn(chains), c)
    rho = jnp.mean(_acf_normalized(chains), axis=0)         # [n, d]
    return jax.vmap(lambda r: _tau_from_rho(r, c), in_axes=1)(rho)


def effective_sample_size(chains, c=5.0, per_dim=False):
    """ESS = M·N / τ over all chains (SURVEY.md §4.8).

    per_dim=True returns the conservative (worst-dimension) ESS."""
    chains = _promote(chains)
    m, n, _ = chains.shape
    tau = integrated_autocorr_time(chains, c=c, per_dim=per_dim)
    if per_dim:
        tau = jnp.max(tau)
    return m * n / tau


def ess_bulk(chains, c=5.0):
    """Bulk-ESS (Vehtari et al. 2021): per-dimension ESS of the
    rank-normalised draws — a location-sensitive sampling-efficiency
    measure that is robust to heavy tails (an infinite-variance marginal
    still gets a meaningful number). chains: [M, N, d] → [d]."""
    chains = _promote(chains)
    m, n, _ = chains.shape
    tau = integrated_autocorr_time(_ranks_to_z(chains), c=c, per_dim=True)
    return m * n / tau


def ess_tail(chains, c=5.0, quantiles=(0.05, 0.95)):
    """Tail-ESS (Vehtari et al. 2021): the minimum over the two tail
    quantiles of the ESS of the indicator sequence I(x ≤ q) — how well
    the chains resolve tail probabilities, which bulk measures miss
    (a sampler mixing fast in the centre but sticky in the tails shows
    healthy ess_bulk and collapsed ess_tail). chains: [M, N, d] → [d].

    Degenerate case: if every pooled draw falls on one side of q the
    indicator has zero variance and the ACF guard yields τ=1 (ESS=MN);
    with the default 5%/95% pooled quantiles this cannot occur."""
    chains = _promote(chains)
    m, n, d = chains.shape
    flat = chains.reshape(m * n, d)
    esss = []
    for q in quantiles:
        thresh = jnp.quantile(flat, q, axis=0)               # [d]
        ind = (chains <= thresh).astype(chains.dtype)        # [M, N, d]
        tau = integrated_autocorr_time(ind, c=c, per_dim=True)
        esss.append(m * n / tau)
    return jnp.minimum(*esss)


def ess_multichain(chains):
    """Cross-chain ESS (Vehtari et al. 2021 / Stan): ρ̂_t folds the
    BETWEEN-chain variance, so chains frozen at different values score
    ESS ≈ chain count, not ≈ M·N.

    The within-chain estimators above (``effective_sample_size``,
    ``ess_bulk``) average per-chain ACFs: a chain whose series is
    CONSTANT contributes ρ := 0 (the zero-variance guard), which reads
    as perfect mixing — exactly wrong for quantities like a mode
    indicator, where "every chain stuck in its own basin" must score
    ~0, not maximal (the cross-mode ESS frame depends on it). Stan's
    estimator uses

        ρ̂_t = 1 − (W − s̄_t) / v̂ar⁺,   v̂ar⁺ = (n−1)/n·W + B/n,

    with s̄_t the chain-averaged within-chain autocovariance: frozen
    heterogeneous chains give W ≈ 0, v̂ar⁺ ≈ B/n, ρ̂_t ≈ 1 for all t →
    τ ≈ n → ESS ≈ M. Truncation: Geyer initial-monotone-positive pair
    sums. chains: [M, N, d] → [d]. A dimension with ZERO total
    variance (all chains constant AND equal) returns NaN — there is no
    information to certify, and a silent M·N would be the same lie the
    within-chain guard tells.
    """
    chains = _promote(chains)
    m, n, d = chains.shape
    x = chains - jnp.mean(chains, axis=1, keepdims=True)
    nfft = 2 * n
    f = jnp.fft.rfft(x, n=nfft, axis=1)
    # biased within-chain autocovariance (Stan convention): acov_t/n
    acov = jnp.fft.irfft(f * jnp.conj(f), n=nfft, axis=1)[:, :n, :] / n
    s_t = jnp.mean(acov, axis=0)                            # [n, d]
    w = jnp.mean(acov[:, 0, :] * n / (n - 1), axis=0)       # [d]
    b_over_n = jnp.var(jnp.mean(chains, axis=1), axis=0, ddof=1)
    var_plus = (n - 1) / n * w + b_over_n                   # [d]
    rho = 1.0 - (w[None, :] - s_t) / jnp.maximum(var_plus, 1e-30)
    # Geyer pairs P_k = ρ_{2k} + ρ_{2k+1}; truncate at the first
    # non-positive pair, enforce monotone non-increase (both via
    # cumulative scans — static shapes, jit-safe)
    n_pairs = n // 2
    pairs = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]     # [n/2, d]
    keep = lax.associative_scan(
        jnp.logical_and, pairs > 0.0, axis=0)
    mono = lax.associative_scan(jnp.minimum, pairs, axis=0)
    tau = jnp.maximum(-1.0 + 2.0 * jnp.sum(
        jnp.where(keep, jnp.maximum(mono, 0.0), 0.0), axis=0), 1.0)
    ess = m * n / tau
    return jnp.where(var_plus > 0.0, ess, jnp.nan)


def acceptance_fraction(accepted):
    """Mean acceptance per chain. accepted: [..., N] bool → [...]."""
    return jnp.mean(jnp.asarray(accepted, jnp.float32), axis=-1)


def summary(chains, c=5.0):
    """Per-dimension posterior summary over a chain history.

    chains: [M, N, d]. Returns a dict of [d] arrays: ``mean``, ``sd``,
    ``q05``/``q50``/``q95``, rank-normalised ``rhat`` (Vehtari et al.
    2021), per-dimension ``ess`` (emcee-style auto-windowed τ on the raw
    draws) plus the Vehtari-2021 ``ess_bulk``/``ess_tail`` pair. The
    one-call analogue of the reference's post-run inspection loop
    (SURVEY.md §5.5); ``McmcSampler.summary()`` wraps it on the kept
    history.
    """
    chains = _promote(chains)
    m, n, d = chains.shape
    flat = chains.reshape(m * n, d)
    tau = integrated_autocorr_time(chains, c=c, per_dim=True)
    q = jnp.percentile(flat, jnp.asarray([5.0, 50.0, 95.0]), axis=0)
    sd = jnp.std(flat, axis=0, ddof=1)
    ess = m * n / tau
    return {
        "mean": jnp.mean(flat, axis=0),
        "sd": sd,
        "q05": q[0], "q50": q[1], "q95": q[2],
        "rhat": rank_normalized_rhat(chains),
        "ess": ess,
        "ess_bulk": ess_bulk(chains, c=c),
        "ess_tail": ess_tail(chains, c=c),
        "mcse_mean": sd / jnp.sqrt(ess),
        "mcse_sd": mcse_sd(chains, c=c),
    }


def mcse_mean(chains, c=5.0):
    """Monte Carlo standard error of the posterior mean: sd/√ESS, with
    ESS from the auto-windowed τ (SURVEY.md §4.8). The number that says
    how many significant digits of ``mean`` are real — the
    Vehtari-et-al-2021 reporting convention alongside R̂/ess_bulk/
    ess_tail. chains: [M, N, d] (or [M, N]); returns [d] (or scalar).
    """
    squeeze = jnp.asarray(chains).ndim == 2
    chains = _promote(chains)
    m, n, d = chains.shape
    tau = integrated_autocorr_time(chains, c=c, per_dim=True)
    sd = jnp.std(chains.reshape(m * n, d), axis=0, ddof=1)
    out = sd / jnp.sqrt(m * n / tau)
    return out[0] if squeeze else out


def mcse_sd(chains, c=5.0):
    """Monte Carlo standard error of the posterior sd, by the delta
    method on sd = √var: mcse_sd = mcse(var̂) / (2·sd), where mcse(var̂)
    uses the ESS of the squared centred draws (their own autocorrelation
    governs how fast the variance estimate converges — raw-draw ESS
    would overstate precision whenever x² mixes slower than x).
    chains: [M, N, d] (or [M, N]); returns [d] (or scalar).
    """
    squeeze = jnp.asarray(chains).ndim == 2
    chains = _promote(chains)
    m, n, d = chains.shape
    flat = chains.reshape(m * n, d)
    sd = jnp.std(flat, axis=0, ddof=1)
    centered_sq = (chains - jnp.mean(flat, axis=0)) ** 2
    tau2 = integrated_autocorr_time(centered_sq, c=c, per_dim=True)
    ess2 = m * n / tau2
    var_of_var = jnp.var(centered_sq.reshape(m * n, d), axis=0, ddof=1)
    out = jnp.sqrt(var_of_var / ess2) / (2.0 * jnp.maximum(sd, 1e-30))
    return out[0] if squeeze else out


def _tau_per_chain(rho, c):
    """[M, n, d] per-chain normalised ACFs → per-chain/dim τ, [M, d]."""
    return jax.vmap(jax.vmap(lambda r: _tau_from_rho(r, c), in_axes=1))(rho)


def geweke(chains, first=0.1, last=0.5, c=5.0):
    """Geweke (1992) drift z-scores per chain and dimension.

    Compares the mean of the first ``first`` fraction of each chain
    against the mean of the last ``last`` fraction:
    z = (μ_a − μ_b) / √(se_a² + se_b²), with each segment's standard
    error inflated by its own auto-windowed integrated autocorrelation
    time (the FFT/Sokal machinery above — the spectral-density-at-zero
    estimate Geweke's original CODA formulation uses). |z| ≳ 2–3 flags a
    chain still drifting from its start — a *within-chain* stationarity
    check that split-R̂ (which pools chains) can dilute when only a few
    chains are still in transient.

    Complements the reference's cross-chain R̂ (SURVEY.md §4.8);
    beyond-reference. chains: [M, N, d] (or [M, N]); returns [M, d]
    (or [M]). Jittable.
    """
    squeeze = jnp.asarray(chains).ndim == 2
    chains = _promote(chains)
    n = chains.shape[1]
    na, nb = max(int(first * n), 2), max(int(last * n), 2)
    if na + nb > n:
        raise ValueError(
            f"geweke segments overlap: first={first}, last={last} give "
            f"{na}+{nb} > {n} samples — z-scores would compare "
            "overlapping windows; shrink the fractions")

    def seg_se(x):
        # x: [M, n_seg, d] → (mean [M,d], se² [M,d]) with τ-inflated se
        tau = _tau_per_chain(_acf_normalized(x), c)
        var = jnp.var(x, axis=1, ddof=1)
        return jnp.mean(x, axis=1), var * tau / x.shape[1]

    mu_a, se2_a = seg_se(chains[:, :na, :])
    mu_b, se2_b = seg_se(chains[:, n - nb:, :])
    z = (mu_a - mu_b) / jnp.sqrt(jnp.maximum(se2_a + se2_b, 1e-30))
    return z[:, 0] if squeeze else z


def multivariate_rhat(chains, split=True):
    """Brooks–Gelman (1998) multivariate potential scale reduction R̂_p.

    Scalar summary over ALL dimensions jointly:
    R̂_p = (n−1)/n + ((m+1)/m)·λ₁, where λ₁ is the largest eigenvalue of
    W⁻¹(B/n) — the per-dimension R̂'s worst case over every *linear
    combination* of parameters, so it catches cross-chain disagreement
    that lives in a rotated direction (e.g. chains agreeing marginally
    on x and y but disagreeing on x−y), which the max of univariate R̂
    misses. Solved as the symmetric generalised eigenproblem
    L⁻¹(B/n)L⁻ᵀ with W = LLᵀ (+ a trace-scaled jitter so a converged,
    near-singular W stays factorable in f32).

    Rank requirements: W pools m(n−1) within-chain degrees of freedom
    (after splitting), so it is full-rank whenever m(n−1) ≥ d — easily
    met. The binding limit is B/n, whose rank is ≤ m−1 (m split-half
    means around their grand mean): with fewer than d+1 half-chains λ₁
    is estimated in a rank-deficient between matrix; the trace-scaled
    jitter keeps the solve stable either way. chains: [M, N, d];
    returns a scalar. ``split=True`` halves chains first, as
    :func:`gelman_rubin` does. Values near 1 indicate convergence
    (same 1.1 rule of thumb). Beyond-reference; jittable.
    """
    chains = _promote(chains)
    m, n, d = chains.shape
    if split:
        half = n // 2
        chains = jnp.concatenate(
            [chains[:, :half, :], chains[:, n - half:, :]], axis=0)
        m, n = 2 * m, half
    means = jnp.mean(chains, axis=1)                        # [m, d]
    centered = chains - means[:, None, :]
    # W: mean within-chain covariance; B/n: covariance of chain means
    w = jnp.einsum("mnd,mne->de", centered, centered) / (m * (n - 1))
    gm = jnp.mean(means, axis=0)
    dm = means - gm
    b_over_n = jnp.einsum("md,me->de", dm, dm) / (m - 1)
    jitter = 1e-6 * (jnp.trace(w) / d + 1e-30)
    l = jnp.linalg.cholesky(w + jitter * jnp.eye(d, dtype=w.dtype))
    # L⁻¹ (B/n) L⁻ᵀ — same spectrum as W⁻¹(B/n), but symmetric PSD
    tmp = jax.scipy.linalg.solve_triangular(l, b_over_n, lower=True)
    sym = jax.scipy.linalg.solve_triangular(l, tmp.T, lower=True)
    lam1 = jnp.max(jnp.linalg.eigvalsh((sym + sym.T) / 2.0))
    return (n - 1.0) / n + (m + 1.0) / m * lam1


def nearest_mode(positions, means):
    """Index of the nearest mode centre for each position.

    positions: [..., d]; means: [k, d]. Returns int32 [...]. Distances via
    ‖x‖²+‖μ‖²−2xμᵀ so the [... , k] matrix comes from one matmul.
    """
    positions = jnp.asarray(positions)
    means = jnp.asarray(means, positions.dtype)
    # HIGHEST: the ‖x‖²+‖μ‖²−2xμᵀ cancellation at ‖μ‖≈50 needs full
    # float32 products (a TF32 product is ~3 decimal digits)
    sq = (jnp.sum(positions ** 2, -1)[..., None]
          + jnp.sum(means ** 2, -1)
          - 2.0 * jnp.matmul(positions, means.T,
                             precision=jax.lax.Precision.HIGHEST))
    return jnp.argmin(sq, axis=-1).astype(jnp.int32)


def mode_occupancy(positions, means):
    """Chains per nearest mode — the multimodality diagnostic R̂/ESS are
    structurally blind to (the headline 'multimodal'
    benchmark sampled a single basin, occupancy [0,0,256,0], while
    R̂=1.10 and ESS looked healthy because all chains agreed).

    positions: [M, d] current population (or [M*T, d] pooled history);
    means: [k, d]. Returns int32 counts [k]; for an equal-weight mixture a
    healthy stratified population shows ≈M/k per mode.
    """
    idx = nearest_mode(positions, means)
    return jnp.bincount(idx.reshape(-1), length=means.shape[0])


def mode_hops(history, means):
    """Count inter-mode transitions in a kept history.

    history: [M, T, d] (chains, kept generations, dims); means: [k, d].
    Returns (total_hops, hops_per_chain_per_gen). A hop is a generation
    where a chain's nearest mode changes. On well-separated high-d modes
    hops are RARE (measured 2.8e-5/chain/gen on the d=100 headline
    config): independent-pair γ=1 jumps are e^(−d)-suppressed and the
    surviving channel is correlated archive pairs (z₂ ≈ the chain's own
    recent state → an equilibrium-noise mode transplant). Reporting the rate is
    what keeps "multimodal" claims honest.
    """
    idx = nearest_mode(jnp.asarray(history), means)          # [M, T]
    hops = jnp.sum(idx[:, 1:] != idx[:, :-1])
    m, t = idx.shape
    return hops, hops / jnp.maximum(m * (t - 1), 1)


# Benchmark convention: ESS is window-dependent (the emcee auto-window τ
# grows with chain length), so throughput numbers are only comparable when
# computed over a FIXED window. All harnesses in this repo (bench.py,
# benchmarks/run_all.py) report ESS/sec as
#   ess_rate(chains, gens_per_sec) = ESS(last ESS_WINDOW_GENS) / window_time
ESS_WINDOW_GENS = 2000


def ess_rate(chains, gens_per_sec, window=ESS_WINDOW_GENS, c=5.0):
    """ESS/sec over the final ``window`` kept generations.

    chains: [M, N, d] kept history (N ≥ window recommended; shorter
    histories use all of N). Returns (ess, ess_per_sec).

    The window is sliced BEFORE any device transfer, and a host (NumPy)
    history stays on the host CPU backend: the benchmark harnesses hand
    this ~GB-scale assembled histories, and promoting them to the
    accelerator would copy the whole array to the device just to FFT a
    window of it.
    """
    n = chains.shape[1]
    w = min(int(window), n)
    chains = chains[:, n - w:, ...]
    if isinstance(chains, np.ndarray):
        with host_compute():
            ess = float(effective_sample_size(_promote(chains), c=c))
    else:
        ess = float(effective_sample_size(_promote(chains), c=c))
    return ess, ess * float(gens_per_sec) / w


def host_compute():
    """Context placing host-NumPy diagnostics on the CPU backend.

    Benchmark harnesses hand diagnostics ~GB-scale histories assembled in
    host memory; promoting them to the accelerator would copy the whole
    array to the device just to FFT/argmin a window of it. Falls back to
    a no-op when no CPU backend exists (a process that pinned
    ``jax_platforms`` to the accelerator alone)."""
    try:
        return jax.default_device(jax.local_devices(backend="cpu")[0])
    except RuntimeError:
        import contextlib
        return contextlib.nullcontext()
