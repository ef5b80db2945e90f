"""Injected-stream exact fidelity: SURVEY.md §6 contract (a).

Exact NumPy bit-streams are unreachable from JAX's counter-based RNG, so
the fidelity contract splits in two: (b) distributional equivalence
(tests/test_fidelity_reference.py) and (a) *identical results given
identical proposal streams* — this file. One recorded randomness stream is
fed through both the reference-semantics NumPy implementation
(benchmarks/reference_numpy.py) and the JAX step; accept decisions and
trajectories must agree step-for-step.

Runs in float64 on both sides (jax.enable_x64) so agreement
is to solver precision, not dtype noise.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "benchmarks"))

from reference_numpy import NumpyDram, NumpyDreamZs  # noqa: E402


def _mixture_pair(d, n_modes=3, seed=99):
    """Matched (jax, numpy) log-probs for a Gaussian mixture target."""
    from bipymc_tpu.models.targets import gaussian_mixture
    from reference_numpy import mixture_log_prob_numpy
    rng = np.random.default_rng(seed)
    means = 3.0 * rng.standard_normal((n_modes, d))
    return gaussian_mixture(means, sigma=1.0), mixture_log_prob_numpy(means)


def test_dram_injected_stream_exact():
    """DRAM: same (z1, z2, u1, u2) stream → identical trajectories."""
    from bipymc_tpu.samplers import rw
    from bipymc_tpu.core.scan import run_scan

    d, T = 2, 400
    lp_jax, lp_np = _mixture_pair(d)
    rng = np.random.default_rng(42)
    Z1 = rng.standard_normal((T, d))
    Z2 = rng.standard_normal((T, d))
    U1 = rng.uniform(size=T)
    U2 = rng.uniform(size=T)
    theta0 = np.zeros(d)
    cov0 = np.eye(d) * 0.5

    ref = NumpyDram(lp_np, adapt_start=100, adapt_interval=50, seed=0)
    hist_np = ref.run(theta0, T, cov0=cov0,
                      draws=lambda t: (Z1[t], Z2[t], U1[t], U2[t]))

    with jax.enable_x64(True):
        z1j, z2j = jnp.asarray(Z1), jnp.asarray(Z2)
        u1j, u2j = jnp.asarray(U1), jnp.asarray(U2)

        def draws_fn(key, t, d_, dtype):
            return z1j[t], z2j[t], u1j[t], u2j[t]

        cfg = rw.dram_config(t0=100, adapt_interval=50)
        step = rw.make_step(lp_jax, cfg, draws_fn=draws_fn)
        state = rw.init(jnp.asarray(theta0), lp_jax, jnp.asarray(cov0))
        _, hist_jax = jax.jit(lambda s, k: run_scan(
            step, s, k, T, collect_fn=lambda s_, i: s_.theta))(
            state, jax.random.key(0))
        hist_jax = np.asarray(hist_jax)

    # identical accept decisions (movement pattern) ...
    prev_np = np.vstack([theta0[None], hist_np[:-1]])
    prev_j = np.vstack([theta0[None], hist_jax[:-1]])
    moved_np = np.any(hist_np != prev_np, axis=1)
    moved_j = np.any(hist_jax != prev_j, axis=1)
    np.testing.assert_array_equal(moved_np, moved_j)
    # ... and identical trajectories to solver precision
    np.testing.assert_allclose(hist_jax, hist_np, rtol=1e-9, atol=1e-9)


def test_dreamzs_injected_stream_exact():
    """DREAM-zs: one recorded stream (snooker coins, archive indices, CR
    draws, crossover/jitter uniforms, accept uniforms) through both the
    NumPy chain loop and the JAX population step → identical
    trajectories, including CR adaptation, outlier resets and archive
    growth."""
    from bipymc_tpu.samplers import dream
    from bipymc_tpu.core.scan import run_scan

    d, n, T = 5, 8, 120
    delta_max, n_cr = 3, 3
    n_rows = max(2 * delta_max, 3)
    lp_jax, lp_np = _mixture_pair(d, n_modes=2, seed=7)

    rng = np.random.default_rng(123)
    x0 = 2.0 * rng.standard_normal((n, d))
    z0 = 2.0 * rng.standard_normal((10, d))

    # archive length visible to gen t (appends land at the END of every
    # archive_thin-th generation)
    thin = 10
    arch_len = lambda t: len(z0) + n * (t // thin)

    U_SCAL = rng.uniform(size=(T, n, 3))
    CR_IDX = rng.integers(0, n_cr, size=(T, n))
    U_UE = rng.uniform(size=(T, n, 2, d))
    EPS = rng.standard_normal((T, n, d))
    U_ACC = rng.uniform(size=(T, n))
    ROW_IDX = np.zeros((T, n, n_rows), dtype=np.int32)
    for t in range(T):
        for i in range(n):
            ROW_IDX[t, i] = rng.choice(arch_len(t), n_rows, replace=False)

    ref = NumpyDreamZs(lp_np, n, delta_max=delta_max, n_cr=n_cr,
                       burnin_gens=60, archive_thin=thin, seed=0)
    hist_np = ref.run(x0, z0, T, draws=lambda t, i: (
        U_SCAL[t, i], ROW_IDX[t, i], CR_IDX[t, i], U_UE[t, i],
        EPS[t, i], U_ACC[t, i]))

    with jax.enable_x64(True):
        us, ri = jnp.asarray(U_SCAL), jnp.asarray(ROW_IDX)
        ci, uu = jnp.asarray(CR_IDX), jnp.asarray(U_UE)
        ep, ua = jnp.asarray(EPS), jnp.asarray(U_ACC)

        def draws_fn(t, i_global, d_, dtype):
            return (us[t, i_global], ri[t, i_global], ci[t, i_global],
                    uu[t, i_global], ep[t, i_global], ua[t, i_global])

        cfg = dream.DreamConfig(n_chains=n, delta_max=delta_max, n_cr=n_cr,
                                burnin_gens=60, archive_thin=thin)
        state = dream.init(jnp.asarray(x0), lp_jax, cfg,
                           archive_capacity=4096, z0=jnp.asarray(z0))
        step = dream.make_step(lp_jax, cfg, axis_name=None,
                               draws_fn=draws_fn)
        _, hist_jax = jax.jit(lambda s, k: run_scan(
            step, s, k, T, collect_fn=lambda s_, i: s_.x))(
            state, jax.random.key(0))
        hist_jax = np.asarray(hist_jax)

    assert hist_jax.shape == hist_np.shape
    # per-generation, per-chain identical movement decisions
    prev_np = np.concatenate([x0[None], hist_np[:-1]], axis=0)
    prev_j = np.concatenate([x0[None], hist_jax[:-1]], axis=0)
    moved_np = np.any(hist_np != prev_np, axis=-1)
    moved_j = np.any(hist_jax != prev_j, axis=-1)
    np.testing.assert_array_equal(moved_np, moved_j)
    np.testing.assert_allclose(hist_jax, hist_np, rtol=1e-9, atol=1e-9)
