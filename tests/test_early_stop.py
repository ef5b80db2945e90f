"""On-device streaming R-hat early stopping (BASELINE config 5 core)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bipymc_tpu import DreamZs
from bipymc_tpu.models.targets import correlated_gaussian
from bipymc_tpu.parallel.mesh import chain_mesh
from bipymc_tpu.utils.streaming import rhat_init, rhat_update, rhat_compute
from bipymc_tpu.utils.diagnostics import gelman_rubin

MEAN = jnp.array([1.0, -1.0])
COV = jnp.array([[1.0, 0.8], [0.8, 1.5]])


def test_streaming_rhat_matches_batch_formula():
    """Welford-streamed R̂ must equal the (non-split) batch formula."""
    rng = np.random.default_rng(0)
    chains = rng.normal(size=(6, 300, 3)).astype(np.float32)
    chains[1] += 0.5
    rc = rhat_init(6, 3)
    for t in range(300):
        rc = rhat_update(rc, jnp.asarray(chains[:, t, :]))
    got = np.asarray(rhat_compute(rc, 6))
    want = np.asarray(gelman_rubin(jnp.asarray(chains), split=False))
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_early_stop_converges_and_stops():
    lp = correlated_gaussian(MEAN, COV)
    s = DreamZs(lp, n_chains=16, seed=0, burnin_gens=200)
    info = s.run_mcmc_until(MEAN, rhat_tol=1.05, chunk=100, max_chunks=50,
                            warmup_chunks=2, spread=2.0)
    assert np.max(info["rhat"]) < 1.05
    assert 200 < info["steps"] < 5000       # stopped before max_chunks
    # streamed posterior moments are sane
    gmean = info["mean"].mean(axis=0)
    np.testing.assert_allclose(gmean, np.asarray(MEAN), atol=0.4)


def test_early_stop_hits_max_chunks_when_tol_unreachable():
    lp = correlated_gaussian(MEAN, COV)
    s = DreamZs(lp, n_chains=8, seed=1)
    info = s.run_mcmc_until(MEAN, rhat_tol=1.0, chunk=50, max_chunks=4,
                            warmup_chunks=1, spread=2.0)
    assert info["steps"] == 200             # 4 chunks * 50


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs fake devices")
def test_early_stop_mesh_matches_vmap():
    lp = correlated_gaussian(MEAN, COV)
    a = DreamZs(lp, n_chains=16, seed=2, mesh=chain_mesh()).run_mcmc_until(
        MEAN, rhat_tol=1.05, chunk=50, max_chunks=40, spread=2.0)
    b = DreamZs(lp, n_chains=16, seed=2).run_mcmc_until(
        MEAN, rhat_tol=1.05, chunk=50, max_chunks=40, spread=2.0)
    assert a["steps"] == b["steps"]
    np.testing.assert_allclose(a["rhat"], b["rhat"], rtol=1e-5)
    np.testing.assert_allclose(a["mean"], b["mean"], rtol=1e-5)


def test_rw_family_run_until():
    """R-hat early stop on the vmapped single-chain family (config-1
    analogue of the ensemble stopping rule)."""
    import numpy as np
    import jax.numpy as jnp
    import bipymc_tpu as bp
    from bipymc_tpu.models.targets import correlated_gaussian

    lp = correlated_gaussian([1.0, -1.0], [[2.0, 0.8], [0.8, 1.0]])
    s = bp.Dram(lp, seed=0, n_chains=8)
    info = s.run_mcmc_until(jnp.zeros(2), rhat_tol=1.05, chunk=200,
                            max_chunks=50)
    assert info["rhat"].max() < 1.05
    assert abs(info["mean"].mean(0)[0] - 1.0) < 0.4

    import pytest
    with pytest.raises(ValueError, match="n_chains"):
        bp.Dram(lp, n_chains=1).run_mcmc_until(jnp.zeros(2))


def test_run_until_t0_decorrelates_continuation():
    """run_until must fold keys on the GLOBAL step index: a continuation
    run (t0 > 0) must not replay the randomness of steps 0..t0-1."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bipymc_tpu.models.targets import correlated_gaussian
    from bipymc_tpu.parallel.pool import ChainPool
    from bipymc_tpu.samplers import demc

    lp = correlated_gaussian(jnp.array([0.0, 0.0]), jnp.eye(2))
    cfg = demc.DeMcConfig(n_chains=8)
    x0 = jax.random.normal(jax.random.key(0), (8, 2))
    state = demc.init(x0, lp)
    pool = ChainPool(
        step_factory=lambda axis: demc.make_step(lp, cfg, axis_name=axis),
        sharded_fields=("x", "logp"))
    key = jax.random.key(5)
    s_a, _ = pool.run_until(state, key, rhat_tol=0.0, chunk=20,
                            max_chunks=2, warmup_chunks=0, t0=0)
    s_b, _ = pool.run_until(state, key, rhat_tol=0.0, chunk=20,
                            max_chunks=2, warmup_chunks=0, t0=40)
    assert not np.array_equal(np.asarray(s_a.x), np.asarray(s_b.x))


def test_run_until_reuses_compiled_runner():
    """Regression: the default position_fn used to be
    a fresh per-call lambda inside run_until and was part of the runner
    cache key, so every run_mcmc_until call on DreamZs/DeMc/EnsembleSampler
    re-traced and re-ran XLA compilation. Two identical calls must share
    ONE runner entry and ONE jit cache entry."""
    lp = correlated_gaussian(MEAN, COV)
    s = DreamZs(lp, n_chains=8, seed=3)
    s.run_mcmc_until(MEAN, rhat_tol=1.0, chunk=20, max_chunks=2,
                     warmup_chunks=0, spread=2.0)
    s.run_mcmc_until(MEAN, rhat_tol=1.0, chunk=20, max_chunks=2,
                     warmup_chunks=0, spread=2.0)
    pool = s._pool()
    until_keys = [k for k in pool._runners if k[0] == "until"]
    assert len(until_keys) == 1, until_keys
    # t0 is a traced argument, so the second (continuation) call must hit
    # the SAME compiled executable — no retrace, no recompile
    assert pool._runners[until_keys[0]]._cache_size() == 1


def test_final_state_available_after_until_only():
    """Checkpointing the R-hat-stop workflow: final_state (and state-backed
    diagnostics) must work after run_mcmc_until with no run_mcmc."""
    import jax.numpy as jnp
    import numpy as np
    import pytest
    import bipymc_tpu as bp
    from bipymc_tpu.models.targets import correlated_gaussian

    lp = correlated_gaussian(jnp.array([1.0, -1.0]),
                             jnp.array([[1.0, 0.3], [0.3, 0.8]]))
    s = bp.DreamZs(lp, n_chains=8, seed=2)
    s.run_mcmc_until(jnp.zeros(2), rhat_tol=1.2, chunk=50, max_chunks=40,
                     spread=2.0)
    assert s.final_state is not None
    assert s.cr_probabilities.shape == (3,)
    with pytest.raises(RuntimeError):
        s.super_chain  # history-backed access still requires run_mcmc


def test_rhat_update_block_matches_sequential():
    """Chan blockwise moment merge == T sequential Welford updates (to
    float re-association), including merging INTO a non-empty carry and
    the fresh-carry (n==0) reduction to plain block moments."""
    from bipymc_tpu.utils.streaming import rhat_update_block
    rng = np.random.default_rng(3)
    xs = jnp.asarray(rng.standard_normal((13, 6, 3)).astype(np.float32))
    seq = rhat_init(6, 3)
    for t in range(13):
        seq = rhat_update(seq, xs[t])
    blk = rhat_update_block(rhat_init(6, 3), xs[:5])     # fresh carry
    blk = rhat_update_block(blk, xs[5:])                 # non-empty merge
    assert float(blk.n) == float(seq.n) == 13.0
    np.testing.assert_allclose(np.asarray(blk.mean), np.asarray(seq.mean),
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(np.asarray(blk.m2), np.asarray(seq.m2),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(rhat_compute(blk, 6)), np.asarray(rhat_compute(seq, 6)),
        rtol=1e-5)


def test_run_until_validates_fused_runner_contract():
    """ChainPool.run_until must reject misaligned chunk/t0 and a
    position_fn that extracts something other than what the fused
    runner's history records (the runner's own t0 check never fires
    there — t0 is traced by the time the runner sees it)."""
    from bipymc_tpu.parallel.pool import ChainPool
    from bipymc_tpu.samplers import dream
    from bipymc_tpu.samplers.dream_fused import make_chunk_runner
    from bipymc_tpu.utils.init import var_ball

    lp = correlated_gaussian(MEAN, COV)
    cfg = dream.DreamConfig(n_chains=8, burnin_gens=0, archive_thin=10)
    x0 = var_ball(jax.random.key(0), jnp.ones(2), 8, center=MEAN)
    state = dream.init(x0, lp, cfg, archive_capacity=64, z0=x0)
    runner = make_chunk_runner(lp, cfg)
    assert runner.align == 10 and runner.chunk_multiple == 10
    pool = ChainPool(
        step_factory=lambda a: dream.make_step(lp, cfg, axis_name=a),
        sharded_fields=("x", "logp", "logp_sum"))
    key = jax.random.key(1)
    with pytest.raises(ValueError, match="multiple"):
        pool.run_until(state, key, chunk=15, max_chunks=2,
                       chunk_runner=runner)
    with pytest.raises(ValueError, match="aligned"):
        pool.run_until(state, key, chunk=20, max_chunks=2, t0=5,
                       chunk_runner=runner)
    with pytest.raises(ValueError, match="position"):
        pool.run_until(state, key, chunk=20, max_chunks=2,
                       position_fn=lambda s: s.logp_sum[:, None],
                       chunk_runner=runner)
    # stats-mode runner has no position history to fold
    runner_stats = make_chunk_runner(lp, cfg, collect="stats")
    with pytest.raises(ValueError, match="collect"):
        pool.run_until(state, key, chunk=20, max_chunks=2,
                       chunk_runner=runner_stats)


def test_rhat_merge_matches_block_fold():
    """Chan-merging a block's own carry must equal folding the raw block
    (up to float tolerance) — the collect='rhat' fused path vs the
    collect='all' + rhat_update_block path."""
    from bipymc_tpu.utils.streaming import rhat_merge, rhat_update_block
    rng = np.random.default_rng(3)
    n, d = 8, 5
    a_block = jnp.asarray(rng.normal(size=(40, n, d)).astype(np.float32))
    b_block = jnp.asarray(rng.normal(size=(25, n, d)).astype(np.float32) + 0.7)
    rc_fold = rhat_update_block(
        rhat_update_block(rhat_init(n, d), a_block), b_block)
    rc_b = rhat_update_block(rhat_init(n, d), b_block)
    rc_merge = rhat_merge(rhat_update_block(rhat_init(n, d), a_block), rc_b)
    assert float(rc_fold.n) == float(rc_merge.n)
    np.testing.assert_allclose(np.asarray(rc_fold.mean),
                               np.asarray(rc_merge.mean), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(rc_fold.m2),
                               np.asarray(rc_merge.m2), rtol=1e-4)
    # merging into an EMPTY carry must reduce to the block's own moments
    rc_empty = rhat_merge(rhat_init(n, d), rc_b)
    np.testing.assert_allclose(np.asarray(rc_empty.mean),
                               np.asarray(rc_b.mean), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(rc_empty.m2),
                               np.asarray(rc_b.m2), rtol=1e-6)


def test_run_until_auto_capacity_is_capped():
    """run_mcmc_until's auto archive ring is capped at 32 population
    snapshots (max(8192, 32·n_chains) rows): the worst-case
    chunk·max_chunks hint always clamped to 65536, and carrying a 26 MB
    ring through the until-while_loop costs wall time for identical
    work. archive_capacity= still overrides."""
    lp = correlated_gaussian(MEAN, COV)
    s = DreamZs(lp, n_chains=8, seed=0, burnin_gens=4, archive_thin=2)
    s.run_mcmc_until(jnp.zeros(2), rhat_tol=3.0, chunk=4, max_chunks=50000)
    assert s.final_state.archive.buf.shape[0] == 8192
    s2 = DreamZs(lp, n_chains=8, seed=0, burnin_gens=4, archive_thin=2,
                 archive_capacity=16384)
    s2.run_mcmc_until(jnp.zeros(2), rhat_tol=3.0, chunk=4, max_chunks=8)
    assert s2.final_state.archive.buf.shape[0] == 16384


def test_single_chain_run_until_raises():
    """m=1 makes B/W = 0/0: R-hat is NaN and every tol comparison is
    False, so the loop would exit right after warmup looking converged —
    the pool rejects it centrally for every sampler family."""
    lp = correlated_gaussian(MEAN, COV)
    s = DreamZs(lp, n_chains=1, seed=0, burnin_gens=4, archive_thin=2,
                archive_capacity=64, n_archive_init=8)
    with pytest.raises(ValueError, match="n_chains >= 2"):
        s.run_mcmc_until(jnp.zeros(2), rhat_tol=1.1, chunk=4, max_chunks=4)


def test_mh_fused_until_fuses_from_any_offset():
    """Non-adaptive kernels (align=1) keep the fused engine on
    continuation offsets that are not multiples of the kernel chunk —
    and the trajectory still matches the per-step engine exactly."""
    import bipymc_tpu as bp
    lp = correlated_gaussian(MEAN, COV)
    kw = dict(rhat_tol=1.2, chunk=100, max_chunks=30, warmup_chunks=1)

    def run(fused):
        s = bp.Metropolis(lp, seed=3, n_chains=8, fused=fused)
        s.run_mcmc(50, jnp.zeros(2), cov_est=jnp.eye(2) * 0.3)  # offset 50
        return s, s.run_mcmc_until(**kw)
    sa, ia = run(False)
    sb, ib = run(True)
    # the pool compiled an until-runner WITH a fused chunk_runner (the
    # cache key carries it at index 9) despite the offset-50 start
    assert any(k[9] is not None for k in sb._until_pool._runners)
    assert int(ia["steps"]) == int(ib["steps"])
    np.testing.assert_allclose(ia["rhat"], ib["rhat"], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(sa.final_state.theta),
                               np.asarray(sb.final_state.theta),
                               rtol=1e-6, atol=1e-6)
