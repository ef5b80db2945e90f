"""Block proposal math (ops/dream_proposal.propose_block, which the fused
kernel runs) ≡ the per-chain reference ``dream.propose_math_one``.

Both consume identical randomness; the block form works on zero-padded
power-of-two columns with rows passed as separate blocks, so it may
differ only by float re-association.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bipymc_tpu.ops.dream_proposal import propose_block
from bipymc_tpu.ops.route import next_pow2
from bipymc_tpu.samplers import dream
from bipymc_tpu.samplers.dream_fused import proposal_scalars


def _compare(cfg, n, d, seed, gamma_jump=False):
    dtype = jnp.float32
    n_rows = max(2 * cfg.delta_max, 3)
    ks = jax.random.split(jax.random.key(seed), 7)
    x = jax.random.normal(ks[0], (n, d), dtype)
    rows = jax.random.normal(ks[1], (n, n_rows, d), dtype) * 2.0
    u_scal = jax.random.uniform(ks[2], (n, 3), dtype)
    cr_idx = jax.random.randint(ks[3], (n,), 0, cfg.n_cr)
    u_mask = jax.random.uniform(ks[4], (n, d), dtype)
    u_e = jax.random.uniform(ks[5], (n, d), dtype)
    eps_n = jax.random.normal(ks[6], (n, d), dtype)
    gj = jnp.asarray(gamma_jump)

    ref_x, ref_lj, ref_snk = jax.vmap(
        lambda *a: dream.propose_math_one(cfg, *a, gj, dtype))(
            x, u_scal, rows, cr_idx, u_mask, u_e, eps_n)

    d_p = next_pow2(d)

    def pad(a, fill=0.0):
        return jnp.pad(a, ((0, 0), (0, d_p - d)), constant_values=fill)

    scal = proposal_scalars(cfg, u_scal, cr_idx,
                            jnp.full((n,), float(gamma_jump), dtype), dtype)
    cols = [scal[:, c:c + 1] for c in range(5)]
    x_star, log_jac, snk = propose_block(
        pad(x), [pad(rows[:, j]) for j in range(n_rows)],
        pad(u_mask, fill=2.0), pad(u_e), pad(eps_n), *cols,
        cfg.delta_max, d, cfg.b, cfg.b_star)

    np.testing.assert_array_equal(np.asarray(snk[:, 0]),
                                  np.asarray(ref_snk))
    # pad columns stay exactly zero
    np.testing.assert_array_equal(np.asarray(x_star[:, d:]), 0.0)
    np.testing.assert_allclose(np.asarray(x_star[:, :d]),
                               np.asarray(ref_x), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(log_jac[:, 0]),
                               np.asarray(ref_lj), rtol=2e-5, atol=2e-5)


def test_fused_proposal_matches_reference_path():
    _compare(dream.DreamConfig(n_chains=32, p_snooker=0.3), 32, 10, 0)


def test_fused_proposal_odd_dims_and_chains():
    """Non-power-of-two n and d exercise the padding."""
    _compare(dream.DreamConfig(n_chains=20, p_snooker=0.3), 20, 7, 3)


def test_fused_proposal_d_over_128():
    """d > 128 pads to 256 columns."""
    _compare(dream.DreamConfig(n_chains=16, p_snooker=0.3), 16, 150, 11)


def test_fused_proposal_demcz_config():
    """delta_max=1 / single-CR (DE-MC-z) reshapes the row sharing."""
    _compare(dream.demcz_config(16, p_snooker=0.3), 16, 5, 13)


@pytest.mark.parametrize("jump_full_cr", [False, True])
def test_fused_proposal_jump_generation(jump_full_cr):
    """γ = 1 jump generations, with and without full-dim crossover."""
    _compare(dream.DreamConfig(n_chains=16, p_snooker=0.3,
                               jump_full_cr=jump_full_cr),
             16, 6, 17, gamma_jump=True)
