"""Checkpoint / exact resume of a long DREAM-zs run.

The reference has no built-in checkpointing (users np.save chain arrays,
SURVEY.md §7.4); here the sampler state is a pure pytree, so resume is
bit-exact: a run split across two processes produces the same trajectory
as one uninterrupted run. One care point: pass ``archive_capacity``
explicitly — the automatic capacity is sized from each run's length, and
the archive ring buffer's capacity changes which old rows survive.

Run: ``python examples/checkpoint_resume.py``.
"""

import os

import tempfile

import numpy as np
import jax.numpy as jnp

import bipymc_tpu as bp
from bipymc_tpu.models.targets import banana
from bipymc_tpu.utils.checkpoint import save_sampler, restore_sampler


def main():
    log_prob = banana()

    # one uninterrupted run: 2000 generations
    ref = bp.DreamZs(log_prob, n_chains=8, seed=5, n_archive_init=16,
                     archive_capacity=4096)
    ref.run_mcmc(2000, jnp.zeros(2), spread=2.0)

    # the same run split in half across a checkpoint
    first = bp.DreamZs(log_prob, n_chains=8, seed=5, n_archive_init=16,
                       archive_capacity=4096)
    first.run_mcmc(1000, jnp.zeros(2), spread=2.0)
    path = os.path.join(tempfile.mkdtemp(), "dream_ck.npz")
    save_sampler(path, first)
    print(f"checkpointed at step {first._steps_run} -> {path}")

    resumed = bp.DreamZs(log_prob, n_chains=8, seed=5, n_archive_init=16,
                         archive_capacity=4096)
    restore_sampler(path, resumed)
    resumed.run_mcmc(1000)                        # continues from step 1000

    tail_ref = ref.super_chain[:, 1000:, :]
    tail_res = resumed.super_chain
    exact = np.array_equal(tail_ref, tail_res)
    print(f"resumed tail identical to uninterrupted run: {exact}")
    assert exact


if __name__ == "__main__":
    main()
