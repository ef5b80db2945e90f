"""Compiled Triton kernels and GPU numerics against their plain references.

Every test here is marked ``gpu`` and skips without a CUDA device; on
the card they run through ``chip_smoke.py`` (or directly:
``BIPYMC_GPU_TESTS=1 python -m pytest tests -m gpu -p no:xdist``). They
cover what the CPU suite cannot: Triton's compile of the fused kernels
at odd shapes (padding on the device), and float32 products that run in
TF32 unless pinned. Tolerance for kernel-vs-reference positions:
rtol=2e-4, atol=2e-5 — float re-association over padded power-of-two
rows; accept decisions must match exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bipymc_tpu.core.scan import run_scan
from bipymc_tpu.models.targets import (correlated_gaussian,
                                       correlated_gaussian_block,
                                       gaussian_mixture,
                                       gaussian_mixture_block)

pytestmark = pytest.mark.gpu

MEAN = np.array([0.5, -0.5])
COV = np.array([[1.0, 0.3], [0.3, 0.5]])


@pytest.mark.parametrize("n_chains,delayed", [(1, True), (4, True),
                                              (33, False)])
def test_fused_rw_matches_per_step_on_gpu(n_chains, delayed):
    """The fused RW kernel (in-kernel block target, Green–Mira stage 2
    via the shared log1mexp) against the per-step engine."""
    from bipymc_tpu.samplers import rw
    from bipymc_tpu.samplers.rw_fused import make_rw_chunk_runner

    lp = correlated_gaussian(MEAN, COV)
    cfg = (rw.dram_config(adapt_interval=50) if delayed
           else rw.adaptive_metropolis_config(adapt_interval=50))
    n_steps = 200
    theta0 = 0.5 * jax.random.normal(jax.random.key(3), (n_chains, 2))
    state = jax.vmap(lambda t: rw.init(t, lp, jnp.eye(2) * 0.5))(theta0)
    step = rw.make_step(lp, cfg)
    cids = jnp.arange(n_chains)

    def batched(s, k, t):
        ks = jax.vmap(lambda i: jax.random.fold_in(k, i))(cids)
        return jax.vmap(step, in_axes=(0, 0, None))(s, ks, t)

    k_run = jax.random.key(7)
    _, ref = jax.jit(lambda s: run_scan(
        batched, s, k_run, n_steps,
        collect_fn=lambda st, i: {"x": st.theta, "acc": i.accepted}))(state)
    fused = make_rw_chunk_runner(lp, cfg, n_chains,
                                 log_prob_block=correlated_gaussian_block(
                                     MEAN, COV))
    _, hist = jax.jit(lambda s: fused(s, k_run, n_steps, 0))(state)
    np.testing.assert_array_equal(np.asarray(hist["accepted"]),
                                  np.asarray(ref["acc"]))
    np.testing.assert_allclose(np.asarray(hist["x"]), np.asarray(ref["x"]),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n_chains,d", [(16, 4), (24, 5), (32, 100)])
def test_fused_dream_matches_per_gen_on_gpu(n_chains, d):
    """Fused DREAM-zs chunk vs the per-generation engine over the first
    chunk, both compiled for the card."""
    from bipymc_tpu.samplers import dream
    from bipymc_tpu.samplers.dream_fused import make_chunk_runner

    means = np.zeros((2, d), np.float32)
    means[1, 0] = 4.0
    lp = gaussian_mixture(means)
    cfg = dream.DreamConfig(n_chains=n_chains, burnin_gens=0, p_snooker=0.2)
    kx, kz, kr = jax.random.split(jax.random.key(2), 3)
    x0 = 2.0 * jax.random.normal(kx, (n_chains, d))
    z0 = 2.0 * jax.random.normal(kz, (64, d))
    state = dream.init(x0, lp, cfg, archive_capacity=512, z0=z0)
    step = dream.make_step(lp, cfg, axis_name=None)
    G = cfg.archive_thin
    _, ref = jax.jit(lambda s: run_scan(
        step, s, kr, G,
        collect_fn=lambda st, i: {"x": st.x, "acc": i.accepted}))(state)
    fused = make_chunk_runner(lp, cfg,
                              log_prob_block=gaussian_mixture_block(means))
    _, hist = jax.jit(lambda s: fused(s, kr, G, 0))(state)
    np.testing.assert_array_equal(np.asarray(hist["accepted"]),
                                  np.asarray(ref["acc"]))
    np.testing.assert_allclose(np.asarray(hist["x"]), np.asarray(ref["x"]),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("d,n", [(2, 16), (5, 7), (100, 64)])
def test_block_targets_on_gpu(d, n):
    """The padded block targets, compiled inside a Triton kernel by the
    RW chunk, agree with the scalar targets (zero-length moves: the
    kernel's log-density history is the target at the start point)."""
    from bipymc_tpu.ops.fused_rw_chunk import fused_rw_chunk_pallas
    rng = np.random.default_rng(d)
    means = (3.0 * rng.normal(size=(3, d))).astype(np.float32)
    a = rng.normal(size=(d, d))
    cov = (a @ a.T / d + np.eye(d)).astype(np.float32)
    x = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
    for lp, blk in ((gaussian_mixture(means), gaussian_mixture_block(means)),
                    (correlated_gaussian(np.zeros(d), cov),
                     correlated_gaussian_block(np.zeros(d), cov))):
        want = jax.vmap(lp)(x)
        K = 2
        scal = jnp.stack([jnp.zeros((K, n))] * 2 + [jnp.full((K, n), -1.0)]
                         + [jnp.zeros((K, n))], axis=-1)
        _, lph, acc, _ = fused_rw_chunk_pallas(
            x, jnp.full((n,), -1e30), jnp.zeros((K, n, d)), None, scal, blk,
            delayed=False)
        assert bool(jnp.all(acc))
        np.testing.assert_allclose(np.asarray(lph[0]), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)


def test_gp_optimize_cliff_on_gpu():
    """Noiseless scores, n=256, σ_n → 0: the n-aware jitter floor and
    step rejection must keep the compiled Adam scan finite on the card's
    float32 Cholesky, not just on the CPU's."""
    import test_gp
    test_gp.test_optimize_noiseless_scores_near_f32_cliff()


def test_gmm_diag_logq_precision_on_gpu():
    """The diag GMM log-q expansion cancels three O(‖μ‖²) matmul terms to
    O(d). On the GPU an unpinned float32 product runs in TF32 (inputs
    ~2500 ⇒ O(nats) of position-dependent log-q noise that biases mode
    exchange in every independence-MH ratio). With Precision.HIGHEST the
    diag path must agree with the triangular-solve path to float-sum
    tolerance at headline-scale mode norms (d=100, ‖μ‖≈50), even under
    the default matmul precision."""
    from bipymc_tpu.models.targets import baseline_config3_means
    from bipymc_tpu.utils.mixtures import (GmmParams, gmm_log_q,
                                           gmm_log_q_diag)
    d = 100
    means = jnp.asarray(baseline_config3_means(d))
    k = means.shape[0]
    sd = 1.0 + 0.1 * jax.random.normal(jax.random.key(0), (k, d))
    params = GmmParams(log_w=jnp.full((k,), -np.log(k)), mu=means,
                       chol=sd[:, :, None] * jnp.eye(d)[None])
    x = (means[jnp.arange(512) % k]
         + jax.random.normal(jax.random.key(1), (512, d)))
    with jax.default_matmul_precision("default"):
        got = np.asarray(jax.jit(gmm_log_q_diag)(params, x))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(gmm_log_q)(params, x))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)
