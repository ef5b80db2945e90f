"""Worker script for the 2-process jax.distributed smoke test.

Each process pins the CPU platform with 2 virtual devices, joins the
coordinator, builds the global chain mesh via
``bipymc_tpu.parallel.mesh.init_distributed`` (the mpiexec-replacement
entry point, SURVEY.md §3.2), and runs a shard_map collective over all
4 global devices. Run by tests/test_multihost.py, not by pytest directly.
"""

import os
import sys


def main():
    coord, n_proc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=2")
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bipymc_tpu.parallel.mesh import init_distributed, CHAIN_AXIS

    mesh = init_distributed(coordinator_address=coord,
                            num_processes=n_proc, process_id=pid)
    n_dev = mesh.devices.size
    assert n_dev == 2 * n_proc, f"global mesh has {n_dev} devices"
    assert jax.process_count() == n_proc

    # global array sharded over the chain axis; every process provides
    # its addressable shards (the DCN analogue of the MPI scatter)
    n_chains = 2 * n_dev
    sharding = NamedSharding(mesh, P(CHAIN_AXIS))
    global_vals = np.arange(n_chains, dtype=np.float32)
    x = jax.make_array_from_callback(
        (n_chains,), sharding, lambda idx: global_vals[idx])

    def local_sum(x):
        return jnp.broadcast_to(
            jax.lax.psum(jnp.sum(x), CHAIN_AXIS), x.shape)

    g = jax.jit(jax.shard_map(local_sum, mesh=mesh,
                              in_specs=P(CHAIN_AXIS),
                              out_specs=P(CHAIN_AXIS)))
    out = g(x)
    # every element should be the global sum over all processes' shards —
    # checking this process's addressable shards proves the cross-process
    # psum saw the remote data
    want = global_vals.sum()
    for shard in out.addressable_shards:
        got = np.asarray(shard.data)
        assert np.allclose(got, want), (got, want)
    print(f"proc {pid}: global psum OK ({want})", flush=True)

    run_dream_across_processes(mesh, pid)
    run_fused_across_processes(mesh, pid)
    jax.distributed.shutdown()


def run_dream_across_processes(mesh, pid):
    """Drive ChainPool DREAM-zs generations with the population sharded
    ACROSS OS PROCESSES and assert bit-identity with the single-process
    vmap run (a SAMPLER step, not just a psum: the mpiexec-equivalent
    contract of SURVEY.md §3.2/§6 actually executed).

    Every process builds the identical global start state host-side
    (deterministic jax.random on CPU), the pool device_puts it onto the
    2-process global mesh, and 30 generations run as ONE SPMD program —
    the in-step archive/population collectives ride the cross-process
    (DCN-analogue) transport. Keys fold by GLOBAL chain index, so the
    sharded trajectories must equal the local vmap run bit-for-bit.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bipymc_tpu.models.targets import correlated_gaussian
    from bipymc_tpu.samplers import dream
    from bipymc_tpu.parallel.pool import ChainPool

    lp = correlated_gaussian(np.array([1.0, -1.0]),
                             np.array([[1.0, 0.3], [0.3, 0.8]]))
    cfg = dream.DreamConfig(n_chains=8, burnin_gens=20)
    key = jax.random.key(42)
    k_x, k_z, k_run = jax.random.split(key, 3)
    x0 = 2.0 * jax.random.normal(k_x, (8, 2), jnp.float32)
    z0 = 2.0 * jax.random.normal(k_z, (16, 2), jnp.float32)
    state = dream.init(x0, lp, cfg, archive_capacity=64, z0=z0)

    def factory(axis):
        return dream.make_step(lp, cfg, axis_name=axis)

    n_gens = 30
    # single-process reference: plain vmap path, same seed
    local = ChainPool(step_factory=factory,
                      sharded_fields=("x", "logp", "logp_sum"))
    _, want_hist = local.run(state, k_run, n_gens)
    want_x = np.asarray(want_hist["x"])              # [T, 8, 2]

    dist = ChainPool(step_factory=factory,
                     sharded_fields=("x", "logp", "logp_sum"), mesh=mesh)
    final, hist = dist.run(state, k_run, n_gens)
    # each process checks ITS addressable shards of the global history
    # against the corresponding chain columns of the local run
    checked = 0
    for shard in hist["x"].addressable_shards:
        cols = shard.index[1]                        # chain-axis slice
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      want_x[:, cols, :])
        checked += np.asarray(shard.data).shape[1]
    assert checked >= 2                              # 2 devices × ≥1 chain
    print(f"proc {pid}: cross-process DREAM-zs run bit-identical "
          f"({checked} local chains × {n_gens} gens)", flush=True)


def run_fused_across_processes(mesh, pid):
    """Drive the FUSED multi-generation engine (samplers/dream_fused.py)
    with the population sharded across OS processes: the wrapped
    shard_map runner executes one kernel per archive_thin generations
    per shard, with the ring-append all_gather riding the cross-process
    transport. rng="stream" folds keys by global chain id, so the
    trajectories must equal the single-process vmap runner bit-for-bit
    (the same contract tests/test_fused_chunk.py pins intra-process).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bipymc_tpu.models.targets import correlated_gaussian
    from bipymc_tpu.samplers import dream
    from bipymc_tpu.samplers.dream_fused import make_chunk_runner
    from bipymc_tpu.parallel.pool import _state_specs
    from bipymc_tpu.parallel.mesh import CHAIN_AXIS

    lp = correlated_gaussian(np.array([1.0, -1.0]),
                             np.array([[1.0, 0.3], [0.3, 0.8]]))
    cfg = dream.DreamConfig(n_chains=8, burnin_gens=0, archive_thin=5)
    key = jax.random.key(7)
    k_x, k_z, k_run = jax.random.split(key, 3)
    x0 = 2.0 * jax.random.normal(k_x, (8, 2), jnp.float32)
    z0 = 2.0 * jax.random.normal(k_z, (16, 2), jnp.float32)
    state = dream.init(x0, lp, cfg, archive_capacity=64, z0=z0)
    n_gens = 20

    single = make_chunk_runner(lp, cfg)
    _, want = jax.jit(lambda s, k: single(s, k, n_gens, 0))(state, k_run)
    want_x = np.asarray(want["x"])                   # [T, 8, 2]

    dist_runner = make_chunk_runner(lp, cfg, mesh=mesh)
    specs = _state_specs(state, ("x", "logp", "logp_sum"), CHAIN_AXIS)
    shardings = jax.tree_util.tree_map(
        lambda p: NamedSharding(mesh, p), specs,
        is_leaf=lambda x: isinstance(x, P))
    gstate = jax.device_put(state, shardings)
    _, fhist = dist_runner(gstate, k_run, n_gens, 0)
    checked = 0
    for shard in fhist["x"].addressable_shards:
        cols = shard.index[1]                        # chain-axis slice
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      want_x[:, cols, :])
        checked += np.asarray(shard.data).shape[1]
    assert checked >= 2
    print(f"proc {pid}: cross-process FUSED engine bit-identical "
          f"({checked} local chains x {n_gens} gens)", flush=True)


if __name__ == "__main__":
    main()
