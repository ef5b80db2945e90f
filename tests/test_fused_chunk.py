"""Fused multi-generation DREAM-zs engine (ops/fused_chunk.py +
samplers/dream_fused.py) vs the per-generation engine.

The fused engine consumes the identical threefry streams (ChainPool key
discipline: step_key on the global t, per-chain fold on the global chain
id) and the block form of the per-generation engine's proposal math
(ops/dream_proposal.propose_block ≡ dream.propose_math_one), so its
trajectories agree to float re-association. The kernel runs in interpret
mode here. We assert exact stream/selection agreement (accept flags, row
choices via the trajectory itself) and tight numerical agreement on
positions/log-densities, plus archive-ring equality.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bipymc_tpu.core.scan import run_scan_thinned
from bipymc_tpu.models.targets import gaussian_mixture
from bipymc_tpu.samplers import dream
from bipymc_tpu.samplers.dream_fused import (
    make_chunk_runner, check_fusable, validate_fused_segment)
from bipymc_tpu.utils.init import var_ball


def _setup(d=6, n=8, thin=5, burnin=10, capacity=64, **cfg_kw):
    means = np.zeros((2, d), dtype=np.float32)
    means[1, 0] = 4.0
    log_prob = gaussian_mixture(means, sigma=1.0)
    cfg = dream.DreamConfig(n_chains=n, archive_thin=thin,
                            burnin_gens=burnin, **cfg_kw)
    key = jax.random.key(7)
    k_x, k_z, k_run = jax.random.split(key, 3)
    x0 = var_ball(k_x, np.full(d, 4.0), n)
    z0 = var_ball(k_z, np.full(d, 4.0), n)
    state = dream.init(x0, log_prob, cfg, archive_capacity=capacity, z0=z0)
    return log_prob, cfg, state, k_run


def _collect(state, info):
    return {"x": state.x, "logp": info.logp, "accepted": info.accepted}


def test_fused_matches_per_generation_engine():
    log_prob, cfg, state, k_run = _setup()
    step = dream.make_step(log_prob, cfg,
                           axis_name=None)
    # burn-in + alignment: 20 gens ≡ 0 (mod thin=5), ≥ burnin_gens=10
    state20, _ = run_scan_thinned(step, state, k_run, n_steps=20, thin=1,
                                  collect_fn=_collect, t0=0)
    ref_state, ref_hist = run_scan_thinned(
        step, state20, k_run, n_steps=20, thin=1, collect_fn=_collect,
        t0=20)

    runner = make_chunk_runner(
        log_prob, cfg)
    fus_state, fus_hist = runner(state20, k_run, 20, 20)

    # identical accept/reject decisions → identical randomness + math
    np.testing.assert_array_equal(np.asarray(ref_hist["accepted"]),
                                  np.asarray(fus_hist["accepted"]))
    np.testing.assert_allclose(np.asarray(ref_hist["x"]),
                               np.asarray(fus_hist["x"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ref_hist["logp"]),
                               np.asarray(fus_hist["logp"]),
                               rtol=1e-6, atol=1e-6)
    # final state: positions, archive ring, counters
    np.testing.assert_allclose(np.asarray(ref_state.x),
                               np.asarray(fus_state.x),
                               rtol=1e-6, atol=1e-6)
    assert int(ref_state.archive.fill) == int(fus_state.archive.fill)
    assert int(ref_state.archive.head) == int(fus_state.archive.head)
    np.testing.assert_allclose(np.asarray(ref_state.archive.buf),
                               np.asarray(fus_state.archive.buf),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ref_state.logp_sum),
                               np.asarray(fus_state.logp_sum),
                               rtol=1e-5, atol=1e-5)
    assert int(ref_state.gen) == int(fus_state.gen)


def test_fused_matches_with_jump_full_cr():
    log_prob, cfg, state, k_run = _setup(jump_full_cr=True,
                                         jump_interval=3)
    step = dream.make_step(log_prob, cfg,
                           axis_name=None)
    state20, _ = run_scan_thinned(step, state, k_run, n_steps=20, thin=1,
                                  collect_fn=_collect, t0=0)
    _, ref_hist = run_scan_thinned(
        step, state20, k_run, n_steps=10, thin=1, collect_fn=_collect,
        t0=20)
    runner = make_chunk_runner(
        log_prob, cfg)
    _, fus_hist = runner(state20, k_run, 10, 20)
    np.testing.assert_array_equal(np.asarray(ref_hist["accepted"]),
                                  np.asarray(fus_hist["accepted"]))
    np.testing.assert_allclose(np.asarray(ref_hist["x"]),
                               np.asarray(fus_hist["x"]),
                               rtol=1e-6, atol=1e-6)


def test_fused_statistics_on_gaussian():
    """2k fused generations sample a 2-d Gaussian correctly."""
    d, n = 2, 16
    log_prob = gaussian_mixture(np.zeros((1, d), np.float32), sigma=1.0)
    cfg = dream.DreamConfig(n_chains=n, archive_thin=10, burnin_gens=0,
                            p_snooker=0.1)
    key = jax.random.key(3)
    k_x, k_z, k_run = jax.random.split(key, 3)
    state = dream.init(var_ball(k_x, np.full(d, 4.0), n), log_prob, cfg,
                       archive_capacity=256,
                       z0=var_ball(k_z, np.full(d, 4.0), n))
    runner = make_chunk_runner(log_prob, cfg)
    state, hist = jax.jit(
        lambda s, k: runner(s, k, 2000, 0))(state, k_run)
    kept = np.asarray(hist["x"][500:]).reshape(-1, d)
    assert np.all(np.abs(kept.mean(0)) < 0.15), kept.mean(0)
    assert np.all(np.abs(kept.std(0) - 1.0) < 0.15), kept.std(0)
    acc = np.asarray(hist["accepted"][500:]).mean()
    assert 0.05 < acc < 0.9, acc


def test_prep_chunks_invariance():
    """Trajectories are bit-identical for every prep_chunks value: the
    batched prep only regroups launches; streams key on absolute gen
    indices. prep_chunks=3 on 4 chunks exercises the remainder scan
    (q=1 superchunk of 3 + r=1 leftover chunk)."""
    log_prob, cfg, state, k_run = _setup()
    step = dream.make_step(log_prob, cfg,
                           axis_name=None)
    state20, _ = run_scan_thinned(step, state, k_run, n_steps=20, thin=1,
                                  collect_fn=_collect, t0=0)
    outs = []
    for m in (1, 3, 8):
        runner = make_chunk_runner(
            log_prob, cfg, prep_chunks=m)
        st, hist = runner(state20, k_run, 20, 20)
        outs.append((st, hist))
    st0, h0 = outs[0]
    for st, h in outs[1:]:
        np.testing.assert_array_equal(np.asarray(h0["accepted"]),
                                      np.asarray(h["accepted"]))
        np.testing.assert_array_equal(np.asarray(h0["x"]),
                                      np.asarray(h["x"]))
        np.testing.assert_array_equal(np.asarray(st0.x), np.asarray(st.x))
        np.testing.assert_array_equal(np.asarray(st0.archive.buf),
                                      np.asarray(st.archive.buf))
        assert int(st0.gen) == int(st.gen)


def test_fused_mesh_matches_single_device():
    """Chain-sharded fused runner (shard_map over 4 fake devices, one
    all_gather per chunk for the append) is bit-identical to the
    single-device runner: streams fold on GLOBAL chain ids and the
    kernel math is per-chain."""
    from bipymc_tpu.parallel.mesh import chain_mesh
    log_prob, cfg, state, k_run = _setup()
    step = dream.make_step(log_prob, cfg,
                           axis_name=None)
    state20, _ = run_scan_thinned(step, state, k_run, n_steps=20, thin=1,
                                  collect_fn=_collect, t0=0)
    single = make_chunk_runner(
        log_prob, cfg)
    st1, h1 = single(state20, k_run, 20, 20)

    mesh = chain_mesh(4)
    sharded = make_chunk_runner(
        log_prob, cfg, mesh=mesh)
    st2, h2 = sharded(state20, k_run, 20, 20)

    np.testing.assert_array_equal(np.asarray(h1["accepted"]),
                                  np.asarray(h2["accepted"]))
    np.testing.assert_array_equal(np.asarray(h1["x"]), np.asarray(h2["x"]))
    np.testing.assert_array_equal(np.asarray(st1.x), np.asarray(st2.x))
    np.testing.assert_array_equal(np.asarray(st1.archive.buf),
                                  np.asarray(st2.archive.buf))
    assert int(st1.archive.fill) == int(st2.archive.fill)
    # the history really is chain-sharded on the mesh
    assert len(h2["x"].sharding.device_set) == 4


def test_api_fused_mesh_matches_vmap():
    """DreamZs(fused=True, mesh=...) = DreamZs(fused=True): the full
    API path (per-generation burn-in + fused steady state) crosses
    engines AND sharding modes with one stream discipline."""
    import bipymc_tpu as bp
    from bipymc_tpu.parallel.mesh import chain_mesh
    d, n = 6, 8
    means = np.zeros((2, d), dtype=np.float32)
    means[1, 0] = 4.0
    lp = gaussian_mixture(means, sigma=1.0)
    kw = dict(n_chains=n, seed=5, archive_thin=5, burnin_gens=10,
              archive_capacity=64, fused=True)
    x0 = np.asarray(var_ball(jax.random.key(1), np.full(d, 4.0), n))

    ref = bp.DreamZs(lp, **kw)
    ref.run_mcmc(30, jnp.asarray(x0))
    shr = bp.DreamZs(lp, mesh=chain_mesh(4), **kw)
    shr.run_mcmc(30, jnp.asarray(x0))

    np.testing.assert_array_equal(ref._history["accepted"],
                                  shr._history["accepted"])
    np.testing.assert_allclose(ref._history["x"], shr._history["x"],
                               rtol=1e-6, atol=1e-6)


def test_fused_run_until_matches_default():
    """run_mcmc_until with fused=True runs post-burn-in chunks on the
    fused engine inside the while_loop (blockwise moment folding):
    identical streams → same stopping point and matching states as the
    per-generation path."""
    import bipymc_tpu as bp
    d, n = 4, 16
    lp = gaussian_mixture(np.zeros((1, d), np.float32), sigma=1.0)
    kw = dict(n_chains=n, seed=9, archive_thin=5, burnin_gens=20,
              archive_capacity=256)
    x0 = np.asarray(var_ball(jax.random.key(2), np.full(d, 4.0), n))
    until_kw = dict(rhat_tol=1.2, chunk=20, max_chunks=40,
                    warmup_chunks=2)

    ref = bp.DreamZs(lp, **kw)
    r1 = ref.run_mcmc_until(jnp.asarray(x0), **until_kw)
    fus = bp.DreamZs(lp, fused=True, **kw)
    r2 = fus.run_mcmc_until(jnp.asarray(x0), **until_kw)

    assert int(r1["steps"]) == int(r2["steps"])
    np.testing.assert_allclose(r1["rhat"], r2["rhat"], rtol=1e-4)
    # the kernel's ULP-level rounding differs from XLA's compile of the
    # per-chain math (XLA contracts the jitter add into an FMA there),
    # and 80 fused generations of DE moves amplify that: the fused
    # kernels' stated tolerance (ops/route.py users, chip_smoke.py)
    np.testing.assert_allclose(
        np.asarray(ref.final_state.x), np.asarray(fus.final_state.x),
        rtol=2e-4, atol=2e-5)
    # unaligned chunk is rounded up to a multiple of archive_thin
    fus2 = bp.DreamZs(lp, fused=True, **kw)
    r3 = fus2.run_mcmc_until(jnp.asarray(x0), rhat_tol=1.2, chunk=18,
                             max_chunks=40, warmup_chunks=2)
    assert int(r3["steps"]) % 20 == 0


def test_fused_run_until_mesh_matches_single_device():
    """Fused run_mcmc_until on a chain mesh: the LOCAL fused runner
    (make_chunk_runner wrap=False) executes per shard inside the pool's
    shard_map while_loop. Streams fold on GLOBAL chain ids, so stopping
    point, R-hat, and final states are bit-identical to the
    single-device fused run."""
    import bipymc_tpu as bp
    from bipymc_tpu.parallel.mesh import chain_mesh
    d, n = 4, 16
    lp = gaussian_mixture(np.zeros((1, d), np.float32), sigma=1.0)
    kw = dict(n_chains=n, seed=9, archive_thin=5, burnin_gens=20,
              archive_capacity=256)
    x0 = np.asarray(var_ball(jax.random.key(2), np.full(d, 4.0), n))
    until_kw = dict(rhat_tol=1.2, chunk=20, max_chunks=40,
                    warmup_chunks=2)

    single = bp.DreamZs(lp, fused=True, **kw)
    r1 = single.run_mcmc_until(jnp.asarray(x0), **until_kw)
    meshed = bp.DreamZs(lp, fused=True, mesh=chain_mesh(4), **kw)
    r2 = meshed.run_mcmc_until(jnp.asarray(x0), **until_kw)

    assert int(r1["steps"]) == int(r2["steps"])
    np.testing.assert_array_equal(r1["rhat"], r2["rhat"])
    np.testing.assert_array_equal(np.asarray(single.final_state.x),
                                  np.asarray(meshed.final_state.x))
    np.testing.assert_array_equal(
        np.asarray(single.final_state.archive.buf),
        np.asarray(meshed.final_state.archive.buf))


def test_fused_validation_errors():
    log_prob, cfg, state, k_run = _setup()
    runner = make_chunk_runner(log_prob, cfg)
    with pytest.raises(ValueError, match="multiple of"):
        runner(state, k_run, 7, 20)
    with pytest.raises(ValueError, match="archive-aligned"):
        validate_fused_segment(cfg, 23)
    with pytest.raises(ValueError, match="post-burn-in"):
        validate_fused_segment(cfg, 5)
    with pytest.raises(ValueError, match="use_archive"):
        check_fusable(cfg._replace(use_archive=False))
    with pytest.raises(ValueError, match="replicated"):
        check_fusable(cfg._replace(shard_archive=True))
    make_chunk_runner(log_prob, cfg._replace(n_chains=8),
                      z_update_every=2)                  # builds fine


def test_api_fused_matches_default_engine():
    """DreamZs(fused=True) = burn-in segment on the per-generation engine
    + aligned fused steady state, same random streams as fused=False."""
    import bipymc_tpu as bp
    d, n = 6, 8
    means = np.zeros((2, d), dtype=np.float32)
    means[1, 0] = 4.0
    lp = gaussian_mixture(means, sigma=1.0)
    kw = dict(n_chains=n, seed=5, archive_thin=5, burnin_gens=10,
              archive_capacity=64)
    x0 = np.asarray(var_ball(jax.random.key(1), np.full(d, 4.0), n))

    ref = bp.DreamZs(lp, **kw)
    ref.run_mcmc(30, jnp.asarray(x0))
    fus = bp.DreamZs(lp, fused=True, **kw)
    fus.run_mcmc(30, jnp.asarray(x0))

    rh, fh = ref._history, fus._history
    assert set(rh) == set(fh)
    np.testing.assert_array_equal(rh["accepted"], fh["accepted"])
    np.testing.assert_array_equal(rh["snooker"], fh["snooker"])
    np.testing.assert_allclose(rh["x"], fh["x"], rtol=1e-6, atol=1e-6)

    # continuation stays aligned and reuses the jitted fused segment
    ref.run_mcmc(20)
    fus.run_mcmc(20)
    assert len(fus._fused_jits) == 1
    np.testing.assert_allclose(ref._history["x"], fus._history["x"],
                               rtol=1e-6, atol=1e-6)
    assert ref._history["x"].shape[0] == 50


def test_api_fused_rejects_unsupported_config():
    import bipymc_tpu as bp
    lp = gaussian_mixture(np.zeros((1, 2), np.float32))
    with pytest.raises(ValueError, match="use_archive"):
        bp.Dream(lp, n_chains=12, fused=True)
    # thin != 1 falls back to the per-generation engine, still correct
    s = bp.DreamZs(lp, n_chains=8, seed=0, burnin_gens=0, fused=True,
                   archive_capacity=64)
    s.run_mcmc(40, thin=4, theta_0=jnp.zeros((8, 2)), spread=2.0)
    assert s.get_chain().shape[1] == 10


def test_z_update_first_block_matches_exact_second_diverges():
    """z_update_every=2: the FIRST thin-block of a super-block sees the
    identical archive as the per-generation engine (bit-equal streams →
    equal trajectories), the SECOND samples a Z stale by one append and
    diverges — the documented staleness boundary."""
    log_prob, cfg, state, k_run = _setup(n=16, capacity=256)
    step = dream.make_step(log_prob, cfg,
                           axis_name=None)
    state20, _ = run_scan_thinned(step, state, k_run, n_steps=20, thin=1,
                                  collect_fn=_collect, t0=0)
    _, ref_hist = run_scan_thinned(
        step, state20, k_run, n_steps=10, thin=1, collect_fn=_collect,
        t0=20)
    runner = make_chunk_runner(
        log_prob, cfg, z_update_every=2)
    fus_state, fus_hist = runner(state20, k_run, 10, 20)
    G = cfg.archive_thin
    np.testing.assert_allclose(np.asarray(ref_hist["x"][:G]),
                               np.asarray(fus_hist["x"][:G]),
                               rtol=1e-6, atol=1e-6)
    # second block: exact engine samples fill+n rows incl. the fresh
    # append; stale-Z samples the super-block-start archive — with 120
    # row draws over a changed fill, identity would need every draw to
    # coincide (p ~ 0)
    assert not np.array_equal(np.asarray(ref_hist["x"][G:]),
                              np.asarray(fus_hist["x"][G:]))
    # both appends still published, in time order
    assert int(fus_state.gen) == 30
    assert (int(fus_state.archive.fill)
            == int(state20.archive.fill) + 2 * cfg.n_chains)


def test_z_update_batched_publish_matches_history():
    """A K=3 super-block's batched append writes exactly the K thinned
    history snapshots, time-ordered, at the sequential ring positions."""
    d, n, thin = 4, 16, 5
    log_prob = gaussian_mixture(np.zeros((1, d), np.float32), sigma=1.0)
    cfg = dream.DreamConfig(n_chains=n, archive_thin=thin, burnin_gens=0)
    key = jax.random.key(3)
    k_x, k_z, k_run = jax.random.split(key, 3)
    x0 = var_ball(k_x, np.full(d, 2.0), n)
    z0 = var_ball(k_z, np.full(d, 2.0), n)
    state = dream.init(x0, log_prob, cfg, archive_capacity=256, z0=z0)
    head0 = int(state.archive.head)
    fill0 = int(state.archive.fill)
    runner = make_chunk_runner(log_prob, cfg, z_update_every=3)
    fstate, hist = runner(state, k_run, 15, 0)
    snaps = np.asarray(hist["x"])[thin - 1::thin]       # [3, n, d]
    buf = np.asarray(fstate.archive.buf)
    np.testing.assert_array_equal(
        buf[head0:head0 + 3 * n], snaps.reshape(3 * n, d))
    assert int(fstate.archive.fill) == fill0 + 3 * n
    assert int(fstate.archive.head) == (head0 + 3 * n) % 256
    np.testing.assert_array_equal(np.asarray(fstate.x),
                                  np.asarray(hist["x"])[-1])


def test_api_fused_z_update():
    """DreamZs(fused_z_update=K): segments cover whole super-blocks,
    chunk rounding in run_mcmc_until respects the super-block length,
    and misuse raises."""
    import bipymc_tpu as bp
    d, n = 4, 16
    lp = gaussian_mixture(np.zeros((1, d), np.float32), sigma=1.0)
    x0 = np.asarray(var_ball(jax.random.key(2), np.full(d, 2.0), n))
    s = bp.DreamZs(lp, n_chains=n, seed=5, archive_thin=5,
                   burnin_gens=10, archive_capacity=256,
                   fused=True, fused_z_update=2)
    s.run_mcmc(45, jnp.asarray(x0))
    # 45 = 10 per-gen (burn-in) + 30 fused (3 super-blocks) + 5 per-gen
    assert s.super_chain.shape == (n, 45, d)
    assert int(s.final_state.gen) == 45
    # continuation keeps working across the engine boundary
    s.run_mcmc(20)
    assert s.super_chain.shape == (n, 65, d)

    s2 = bp.DreamZs(lp, n_chains=n, seed=5, archive_thin=5,
                    burnin_gens=10, archive_capacity=256,
                    fused=True, fused_z_update=2)
    info = s2.run_mcmc_until(jnp.asarray(x0), rhat_tol=1.2, chunk=15,
                             max_chunks=30, warmup_chunks=2)
    assert int(info["steps"]) % 10 == 0      # chunk rounded up to CG=10

    with pytest.raises(ValueError, match="fused=True"):
        bp.DreamZs(lp, n_chains=n, fused_z_update=2)
    with pytest.raises(ValueError, match=">= 1"):
        bp.DreamZs(lp, n_chains=n, fused=True, fused_z_update=0)
    # batched append larger than the archive: caught at the runner
    cfg = dream.DreamConfig(n_chains=n, archive_thin=5, burnin_gens=0)
    st = dream.init(jnp.asarray(x0), lp, cfg, archive_capacity=16,
                    z0=var_ball(jax.random.key(4), np.full(d, 2.0), n))
    r = make_chunk_runner(lp, cfg, z_update_every=4)
    with pytest.raises(ValueError, match="archive capacity"):
        r(st, jax.random.key(0), 20, 0)
    with pytest.raises(ValueError, match="super-block"):
        make_chunk_runner(lp, cfg, z_update_every=2)(
            st, jax.random.key(0), 15, 0)


def test_z_update_statistics_on_gaussian():
    """2k generations at z_update_every=8 (250 super-blocks) still
    sample the 2-d Gaussian correctly — the stale-Z window changes the
    execution schedule, not the stationary distribution."""
    d, n = 2, 16
    log_prob = gaussian_mixture(np.zeros((1, d), np.float32), sigma=1.0)
    cfg = dream.DreamConfig(n_chains=n, archive_thin=10, burnin_gens=0,
                            p_snooker=0.1)
    key = jax.random.key(3)
    k_x, k_z, k_run = jax.random.split(key, 3)
    state = dream.init(var_ball(k_x, np.full(d, 4.0), n), log_prob, cfg,
                       archive_capacity=256,
                       z0=var_ball(k_z, np.full(d, 4.0), n))
    runner = make_chunk_runner(log_prob, cfg, z_update_every=8)
    state, hist = jax.jit(
        lambda s, k: runner(s, k, 2000, 0))(state, k_run)
    kept = np.asarray(hist["x"][500:]).reshape(-1, d)
    assert np.all(np.abs(kept.mean(0)) < 0.15), kept.mean(0)
    assert np.all(np.abs(kept.std(0) - 1.0) < 0.15), kept.std(0)
    acc = np.asarray(hist["accepted"][500:]).mean()
    assert 0.05 < acc < 0.9, acc
