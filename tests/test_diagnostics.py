"""Diagnostics vs independent NumPy formulas (SURVEY.md §4.8)."""

import jax.numpy as jnp
import numpy as np

from bipymc_tpu.utils.diagnostics import (
    gelman_rubin, autocorr_fn, integrated_autocorr_time,
    effective_sample_size, acceptance_fraction)


def _np_split_rhat(chains):
    m, n, d = chains.shape
    half = n // 2
    c = np.concatenate([chains[:, :half], chains[:, n - half:]], axis=0)
    m, n = 2 * m, half
    means = c.mean(axis=1)
    w = c.var(axis=1, ddof=1).mean(axis=0)
    b_over_n = means.var(axis=0, ddof=1)
    v = (n - 1) / n * w + b_over_n
    return np.sqrt(v / w)


def test_rhat_matches_numpy_formula():
    rng = np.random.default_rng(0)
    chains = rng.normal(size=(4, 500, 3)).astype(np.float32)
    got = np.asarray(gelman_rubin(jnp.asarray(chains)))
    want = _np_split_rhat(chains)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_rhat_detects_disagreement():
    rng = np.random.default_rng(1)
    chains = rng.normal(size=(4, 400, 1)).astype(np.float32)
    chains[0] += 5.0  # one chain stuck elsewhere
    rhat = float(gelman_rubin(jnp.asarray(chains))[0])
    assert rhat > 1.5
    good = rng.normal(size=(4, 400, 1)).astype(np.float32)
    assert float(gelman_rubin(jnp.asarray(good))[0]) < 1.05


def test_autocorr_iid_is_deltaish():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4000, 1)).astype(np.float32)
    rho = np.asarray(autocorr_fn(jnp.asarray(x), max_lag=50))
    assert abs(rho[0] - 1.0) < 1e-5
    assert np.all(np.abs(rho[1:]) < 0.1)


def test_ess_on_ar1():
    """AR(1) with coefficient φ has τ = (1+φ)/(1−φ)."""
    phi = 0.8
    rng = np.random.default_rng(3)
    n, m = 20000, 4
    x = np.zeros((m, n), dtype=np.float64)
    eps = rng.normal(size=(m, n))
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + eps[:, t]
    tau = float(integrated_autocorr_time(jnp.asarray(x, jnp.float32)))
    tau_true = (1 + phi) / (1 - phi)   # = 9.0
    assert 0.6 * tau_true < tau < 1.5 * tau_true
    ess = float(effective_sample_size(jnp.asarray(x, jnp.float32)))
    assert 0.5 * m * n / tau_true < ess < 2.0 * m * n / tau_true


def test_acceptance_fraction():
    acc = jnp.array([[True, False, True, True], [False, False, True, False]])
    np.testing.assert_allclose(
        np.asarray(acceptance_fraction(acc)), [0.75, 0.25])


def test_per_dim_tau_identifies_slow_dimension():
    """per_dim=True must expose a slow-mixing dimension that the averaged
    scalar tau smooths over."""
    import numpy as np
    import jax.numpy as jnp
    from bipymc_tpu.utils.diagnostics import (
        integrated_autocorr_time, effective_sample_size)

    rng = np.random.default_rng(0)
    m, n = 4, 4000
    fast = rng.standard_normal((m, n))
    slow = np.empty((m, n))
    slow[:, 0] = rng.standard_normal(m)
    phi = 0.95
    for t in range(1, n):
        slow[:, t] = phi * slow[:, t - 1] + \
            np.sqrt(1 - phi ** 2) * rng.standard_normal(m)
    chains = jnp.asarray(np.stack([fast, slow], axis=-1))   # [m, n, 2]

    tau = np.asarray(integrated_autocorr_time(chains, per_dim=True))
    assert tau.shape == (2,)
    assert tau[1] > 5 * tau[0]          # AR(1) phi=.95: tau ≈ 39 vs ≈ 1
    ess_cons = float(effective_sample_size(chains, per_dim=True))
    ess_mean = float(effective_sample_size(chains))
    assert ess_cons < ess_mean          # worst-dim ESS is conservative


def test_mode_occupancy_and_hops():
    """Multimodality diagnostics: occupancy counts
    chains per nearest mode; hops counts nearest-mode transitions."""
    import jax.numpy as jnp
    import numpy as np
    from bipymc_tpu.utils.diagnostics import (
        nearest_mode, mode_occupancy, mode_hops)

    means = jnp.asarray([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0]])
    pos = jnp.asarray([[0.1, -0.2], [9.8, 0.3], [10.2, -0.1], [1.0, 9.0]])
    np.testing.assert_array_equal(np.asarray(nearest_mode(pos, means)),
                                  [0, 1, 1, 2])
    np.testing.assert_array_equal(np.asarray(mode_occupancy(pos, means)),
                                  [1, 2, 1])

    # chain 0 hops 0->1 once; chain 1 stays put
    hist = jnp.asarray([[[0.0, 0.0], [0.1, 0.0], [9.9, 0.1], [10.0, 0.0]],
                        [[0.0, 9.9], [0.0, 10.1], [0.2, 9.8], [0.1, 10.0]]])
    hops, rate = mode_hops(hist, means)
    assert int(hops) == 1
    assert abs(float(rate) - 1 / 6) < 1e-6


def test_stratified_mode_init_balances_modes():
    """stratified_mode_init must give every mode ~n/k chains and stay
    overdispersed (std ~ sqrt(var)) around each centre."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bipymc_tpu.models.targets import (
        baseline_config3_means, stratified_mode_init)
    from bipymc_tpu.utils.diagnostics import mode_occupancy

    means = baseline_config3_means(100)
    x0 = stratified_mode_init(jax.random.key(0), means, 256, var=4.0)
    assert x0.shape == (256, 100)
    occ = np.asarray(mode_occupancy(x0, jnp.asarray(means)))
    np.testing.assert_array_equal(occ, [64, 64, 64, 64])
    # per-mode spread ≈ std 2
    r = np.asarray(x0[0::4]) - means[0]
    assert 1.5 < r.std() < 2.5


def test_rank_normalized_rhat():
    """Bulk term ≈ classical R̂ behaviour on Gaussian chains; the folded
    term catches a chain with inflated variance that classical split-R̂
    under-reports (Vehtari et al. 2021 motivation)."""
    import jax.numpy as jnp
    import numpy as np
    from bipymc_tpu.utils.diagnostics import (rank_normalized_rhat,
                                              gelman_rubin)

    rng = np.random.default_rng(0)
    good = rng.normal(size=(8, 600, 2)).astype(np.float32)
    r = np.asarray(rank_normalized_rhat(jnp.asarray(good)))
    assert r.shape == (2,)
    assert np.all(r < 1.05), r

    # location disagreement: flagged by both
    shifted = good.copy()
    shifted[0] += 2.0
    r2 = np.asarray(rank_normalized_rhat(jnp.asarray(shifted)))
    assert np.all(r2 > 1.1), r2

    # scale disagreement (same means): rank-R̂ flags it harder than the
    # classical statistic relative to its own well-mixed baseline
    scale = good.copy()
    scale[0] *= 6.0
    r3 = np.asarray(rank_normalized_rhat(jnp.asarray(scale)))
    c3 = np.asarray(gelman_rubin(jnp.asarray(scale)))
    assert np.all(r3 > 1.1), (r3, c3)

    # jittable
    import jax
    r4 = np.asarray(jax.jit(rank_normalized_rhat)(jnp.asarray(good)))
    np.testing.assert_allclose(r4, r, rtol=1e-5)


def test_summary_api():
    """summary() returns sane per-dim statistics and a printable table."""
    import jax.numpy as jnp
    import numpy as np
    import bipymc_tpu as bp
    from bipymc_tpu.models.targets import correlated_gaussian
    from bipymc_tpu.utils.diagnostics import summary

    mean = jnp.array([1.0, -1.0])
    cov = jnp.array([[1.0, 0.3], [0.3, 0.8]])
    s = bp.DreamZs(correlated_gaussian(mean, cov), n_chains=16, seed=0)
    s.run_mcmc(1500, mean, spread=2.0)
    out = s.summary(discard=500)
    assert set(out) == {"mean", "sd", "q05", "q50", "q95", "rhat",
                        "ess", "ess_bulk", "ess_tail",
                        "mcse_mean", "mcse_sd"}
    np.testing.assert_allclose(out["mean"], np.asarray(mean), atol=0.3)
    np.testing.assert_allclose(out["sd"], np.sqrt(np.diag(cov)), atol=0.3)
    assert np.all(out["q05"] < out["q50"]) and np.all(out["q50"] < out["q95"])
    assert np.all(out["rhat"] < 1.2)
    assert np.all(out["ess"] > 100)
    txt = s.summary(discard=500, as_text=True)
    assert "rhat" in txt and txt.count("\n") == 2

    # raw-function path on a plain array
    arr = np.random.default_rng(0).normal(size=(4, 400, 3)).astype(np.float32)
    out2 = summary(jnp.asarray(arr))
    assert out2["mean"].shape == (3,)


def test_ess_bulk_tail_iid():
    from bipymc_tpu.utils.diagnostics import ess_bulk, ess_tail
    rng = np.random.default_rng(3)
    chains = jnp.asarray(rng.standard_normal((8, 500, 2)).astype(np.float32))
    mn = 8 * 500
    eb = np.asarray(ess_bulk(chains))
    et = np.asarray(ess_tail(chains))
    assert eb.shape == (2,) and et.shape == (2,)
    assert np.all(eb > 0.5 * mn) and np.all(eb < 1.6 * mn), eb
    assert np.all(et > 0.4 * mn) and np.all(et < 1.6 * mn), et


def test_ess_bulk_monotone_invariant():
    """Ranks are invariant to monotone transforms — ess_bulk must be
    EXACTLY equal on x and exp(x) (the property raw-draw ESS lacks)."""
    from bipymc_tpu.utils.diagnostics import ess_bulk
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((4, 300, 1)).astype(np.float32))
    a = np.asarray(ess_bulk(x))
    b = np.asarray(ess_bulk(jnp.exp(x)))
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_ess_bulk_tail_ar1_discount():
    from bipymc_tpu.utils.diagnostics import ess_bulk, ess_tail
    rng = np.random.default_rng(7)
    rho, m, n = 0.9, 8, 2000
    x = np.zeros((m, n), np.float32)
    x[:, 0] = rng.standard_normal(m)
    for t in range(1, n):
        x[:, t] = rho * x[:, t - 1] + np.sqrt(1 - rho ** 2) * \
            rng.standard_normal(m)
    chains = jnp.asarray(x)
    mn = m * n
    # theoretical ESS factor (1-rho)/(1+rho) ≈ 0.0526
    eb = float(ess_bulk(chains)[0])
    et = float(ess_tail(chains)[0])
    assert 0.02 * mn < eb < 0.15 * mn, eb
    assert et < 0.3 * mn, et


def test_mcse_mean_iid_and_ar1():
    """IID: mcse_mean ~ sd/sqrt(MN) and the known mean lies within
    4*mcse. AR(1) rho=0.9 inflates mcse by ~sqrt((1+rho)/(1-rho)) ~ 4.4
    over IID — the autocorrelation discount raw-sd/sqrt(MN) misses."""
    from bipymc_tpu.utils.diagnostics import mcse_mean
    rng = np.random.default_rng(11)
    m, n = 8, 4000
    iid = jnp.asarray(rng.standard_normal((m, n)).astype(np.float32))
    e_iid = float(mcse_mean(iid))
    ref = 1.0 / np.sqrt(m * n)
    assert 0.5 * ref < e_iid < 2.0 * ref, (e_iid, ref)
    assert abs(float(jnp.mean(iid))) < 4 * e_iid

    rho = 0.9
    x = np.zeros((m, n), np.float32)
    x[:, 0] = rng.standard_normal(m)
    for t in range(1, n):
        x[:, t] = rho * x[:, t - 1] + np.sqrt(1 - rho ** 2) * \
            rng.standard_normal(m)
    e_ar = float(mcse_mean(jnp.asarray(x)))
    assert e_ar > 2.5 * e_iid, (e_ar, e_iid)


def test_mcse_sd_iid_matches_asymptotics():
    """Normal draws: Var(x^2) = 2 sigma^4, so mcse_sd ~ sigma/sqrt(2MN)
    via the delta method."""
    from bipymc_tpu.utils.diagnostics import mcse_sd
    rng = np.random.default_rng(13)
    m, n, sigma = 8, 4000, 2.0
    x = jnp.asarray((sigma * rng.standard_normal((m, n))).astype(np.float32))
    e = float(mcse_sd(x))
    ref = sigma / np.sqrt(2 * m * n)
    assert 0.5 * ref < e < 2.0 * ref, (e, ref)


def test_summary_carries_mcse():
    from bipymc_tpu.utils.diagnostics import summary
    rng = np.random.default_rng(17)
    chains = jnp.asarray(rng.standard_normal((4, 500, 3)).astype(np.float32))
    s = summary(chains)
    assert s["mcse_mean"].shape == (3,)
    assert s["mcse_sd"].shape == (3,)
    assert np.all(np.asarray(s["mcse_mean"]) > 0)
    assert np.all(np.asarray(s["mcse_mean"]) < np.asarray(s["sd"]))


def test_geweke_stationary_vs_drifting():
    """iid chains: |z| small for all chains; a chain with a mean ramp
    over its first half is flagged, and only that chain."""
    from bipymc_tpu.utils.diagnostics import geweke
    rng = np.random.default_rng(21)
    m, n, d = 6, 2000, 3
    x = rng.standard_normal((m, n, d)).astype(np.float32)
    z = np.asarray(geweke(jnp.asarray(x)))
    assert z.shape == (m, d)
    assert np.all(np.abs(z) < 4.0), z
    # chain 2 starts 8 sigma away and decays toward stationarity
    x[2] += 8.0 * np.exp(-np.arange(n) / (n / 4))[:, None]
    z2 = np.asarray(geweke(jnp.asarray(x)))
    assert np.all(np.abs(z2[2]) > 5.0), z2[2]
    mask = np.ones(m, bool)
    mask[2] = False
    assert np.all(np.abs(z2[mask]) < 4.0), z2


def test_geweke_2d_squeeze():
    from bipymc_tpu.utils.diagnostics import geweke
    rng = np.random.default_rng(22)
    z = np.asarray(geweke(jnp.asarray(
        rng.standard_normal((4, 800)).astype(np.float32))))
    assert z.shape == (4,)


def test_geweke_overlapping_segments_rejected():
    """first + last > 1 would silently compare overlapping windows
    (ADVICE round 3) — must raise instead."""
    import pytest
    from bipymc_tpu.utils.diagnostics import geweke
    rng = np.random.default_rng(24)
    x = jnp.asarray(rng.standard_normal((2, 100, 2)).astype(np.float32))
    with pytest.raises(ValueError, match="overlap"):
        geweke(x, first=0.6, last=0.5)


def test_multivariate_rhat_converged_near_one():
    from bipymc_tpu.utils.diagnostics import multivariate_rhat
    rng = np.random.default_rng(23)
    chains = jnp.asarray(
        rng.standard_normal((8, 1000, 4)).astype(np.float32))
    r = float(multivariate_rhat(chains))
    assert 0.9 < r < 1.1, r


def test_multivariate_rhat_catches_rotated_disagreement():
    """Chains agree on every MARGINAL but disagree along x0 - x1:
    half the chains sample corr=+0.9, half corr=-0.9 with a mean
    offset along the (1,-1) direction. Max univariate split-R-hat
    stays ~1 while R-hat_p flags the joint disagreement."""
    from bipymc_tpu.utils.diagnostics import (gelman_rubin,
                                              multivariate_rhat)
    rng = np.random.default_rng(24)
    m, n = 8, 1500
    chains = np.zeros((m, n, 2), np.float32)
    for i in range(m):
        sgn = 1.0 if i % 2 == 0 else -1.0
        cov = np.array([[1.0, 0.0], [0.0, 1.0]])
        x = rng.multivariate_normal([0, 0], cov, size=n)
        # offset along (1,-1)/sqrt(2), alternating sign: marginals move
        # by +-0.9/sqrt2 each (small vs sd 1), difference moves by 1.8
        off = sgn * 0.9 / np.sqrt(2.0)
        x[:, 0] += off
        x[:, 1] -= off
        chains[i] = x
    uni = float(np.max(np.asarray(gelman_rubin(jnp.asarray(chains)))))
    multi = float(multivariate_rhat(jnp.asarray(chains)))
    assert multi > uni + 0.15, (multi, uni)
    assert multi > 1.3, multi


def test_multivariate_rhat_reduces_to_univariate_in_1d():
    """d=1: R-hat_p = (n-1)/n + ((m+1)/m) B/(nW) = the classical
    (non-sqrt, m-corrected) PSRF; compare against the direct formula."""
    from bipymc_tpu.utils.diagnostics import multivariate_rhat
    rng = np.random.default_rng(25)
    chains = rng.standard_normal((6, 800, 1)).astype(np.float32)
    chains[0] += 1.5
    got = float(multivariate_rhat(jnp.asarray(chains)))
    c = np.concatenate([chains[:, :400], chains[:, 400:]], axis=0)
    m, n = 12, 400
    w = c.var(axis=1, ddof=1).mean()
    b_over_n = c.mean(axis=1).var(ddof=1)
    want = (n - 1) / n + (m + 1) / m * b_over_n / w
    np.testing.assert_allclose(got, want, rtol=2e-2)


def test_ess_multichain_known_cases():
    """Vehtari/Stan cross-chain ESS (round-5): iid ~ M*N; AR(1) phi=0.9
    matches tau=(1+phi)/(1-phi)=19; chains FROZEN at different values
    score ~chain count where the within-chain estimator reads ~M*N
    (the failure mode that motivated it); zero total variance -> NaN."""
    from bipymc_tpu.utils.diagnostics import (effective_sample_size,
                                              ess_multichain)
    rng = np.random.default_rng(0)
    iid = rng.standard_normal((8, 1000, 2)).astype(np.float32)
    e = np.asarray(ess_multichain(jnp.asarray(iid)))
    assert np.all(np.abs(e - 8000) < 2000), e

    phi = 0.9
    z = rng.standard_normal((8, 1000))
    ar = np.zeros((8, 1000), np.float32)
    for t in range(1, 1000):
        ar[:, t] = phi * ar[:, t - 1] + np.sqrt(1 - phi ** 2) * z[:, t]
    e2 = float(ess_multichain(jnp.asarray(ar[..., None]))[0])
    assert 0.35 * 8000 / 19 < e2 < 2.6 * 8000 / 19, e2

    frozen = np.repeat(rng.integers(0, 2, (8, 1, 1)).astype(np.float32),
                       1000, axis=1)
    e3 = float(ess_multichain(jnp.asarray(frozen))[0])
    e3_old = float(effective_sample_size(jnp.asarray(frozen),
                                         per_dim=True))
    assert e3 < 40, e3
    assert e3_old > 5000, e3_old    # the within-chain estimator's lie

    const = np.ones((8, 1000, 1), np.float32)
    assert np.isnan(float(ess_multichain(jnp.asarray(const))[0]))
