"""The kernel route (ops/route.py) and the fused wrappers' shapes.

Interpret mode only on the CPU, Triton on the GPU, a raise anywhere
else; ``fused=True`` without a padded block target raises at
construction on the GPU; the wrappers pad n and d to powers of two and
cut the padding off again.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import bipymc_tpu as bp
from bipymc_tpu.models.targets import (correlated_gaussian,
                                       gaussian_mixture,
                                       gaussian_mixture_block)
from bipymc_tpu.ops.fused_chunk import (block_logp_from_scalar,
                                        fused_chunk_pallas, lp_block_cache)
from bipymc_tpu.ops.fused_rw_chunk import fused_rw_chunk_pallas
from bipymc_tpu.ops.route import interpret_mode, next_pow2, round_up


def test_interpret_only_on_cpu():
    assert interpret_mode("cpu") is True
    assert interpret_mode("gpu") is False
    assert interpret_mode() is True          # the test platform


@pytest.mark.parametrize("platform", ["tpu", "rocm", "metal", "cuda"])
def test_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no kernel route"):
        interpret_mode(platform)


@pytest.mark.parametrize("n,want", [(1, 1), (2, 2), (3, 4), (5, 8),
                                    (100, 128), (128, 128), (129, 256)])
def test_next_pow2(n, want):
    assert next_pow2(n) == want


def test_round_up():
    assert round_up(7, 4) == 8 and round_up(8, 4) == 8


def _on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


@pytest.mark.parametrize("cls,kw", [
    (bp.DreamZs, dict(n_chains=8)),
    (bp.Dram, dict(n_chains=2)),
])
def test_fused_without_block_target_raises_on_gpu(monkeypatch, cls, kw):
    lp = gaussian_mixture(np.zeros((2, 4), np.float32))
    _on_gpu(monkeypatch)
    with pytest.raises(ValueError, match="log_prob_block"):
        cls(lp, fused=True, **kw)
    # a padded block form is accepted; fused=False never needs one
    cls(lp, fused=True, log_prob_block=gaussian_mixture_block(
        np.zeros((2, 4), np.float32)), **kw)
    cls(lp, **kw)


def test_fused_on_unknown_platform_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pytest.raises(RuntimeError, match="no kernel route"):
        bp.DreamZs(gaussian_mixture(np.zeros((1, 2), np.float32)),
                   n_chains=8, fused=True)


def test_lp_block_cache_is_stable():
    """The fused drivers pass the block target as a static jit argument:
    the scalar wrapper must keep its identity per dim."""
    lp = correlated_gaussian(np.zeros(3), np.eye(3))
    cache = lp_block_cache(lp)
    assert cache(3) is cache(3)
    blk = gaussian_mixture_block(np.zeros((1, 3), np.float32))
    assert lp_block_cache(lp, blk)(3) is blk


@pytest.mark.parametrize("n,d", [(1, 2), (7, 5), (20, 3)])
def test_dream_wrapper_shapes(n, d):
    """Odd n and d pad to powers of two inside the wrapper; outputs come
    back at the caller's shapes."""
    G, k = 3, 6
    lp = gaussian_mixture(np.zeros((1, d), np.float32))
    key = jax.random.key(n * 10 + d)
    ks = jax.random.split(key, 4)
    scal = jnp.concatenate([jnp.ones((G, n, 2)), jnp.zeros((G, n, 3)),
                            jnp.full((G, n, 1), -1.0)], axis=-1)
    xh, lph, acc = fused_chunk_pallas(
        jax.random.normal(ks[0], (n, d)), jnp.zeros((n,)),
        jax.random.normal(ks[1], (G, n, k, d)),
        jax.random.uniform(ks[2], (G, n, d)),
        jax.random.uniform(ks[3], (G, n, d)), jnp.zeros((G, n, d)), scal,
        block_logp_from_scalar(lp, d), n_pairs=3, d_true=d, b=1e-4,
        b_star=1e-6)
    assert xh.shape == (G, n, d) and lph.shape == (G, n)
    assert acc.shape == (G, n) and acc.dtype == jnp.bool_
    assert np.all(np.isfinite(np.asarray(xh)))


@pytest.mark.parametrize("delayed", [False, True])
def test_rw_wrapper_shapes(delayed):
    K, n, d = 4, 3, 5
    lp = correlated_gaussian(np.zeros(d), np.eye(d))
    ks = jax.random.split(jax.random.key(0), 2)
    dy = 0.1 * jax.random.normal(ks[0], (K, n, d))
    scal = jnp.stack([jnp.ones((K, n)), jnp.ones((K, n)),
                      jnp.log(jax.random.uniform(ks[1], (K, n))),
                      jnp.full((K, n), -1.0)], axis=-1)
    xh, lph, acc, stage = fused_rw_chunk_pallas(
        jnp.zeros((n, d)), jnp.full((n,), float(lp(jnp.zeros(d)))), dy,
        dy if delayed else None, scal, block_logp_from_scalar(lp, d),
        delayed=delayed)
    assert xh.shape == (K, n, d) and lph.shape == (K, n)
    assert acc.shape == (K, n) and stage.shape == (K, n)
    assert set(np.unique(np.asarray(stage))) <= {0, 1, 2}
    # accepted ⇔ stage > 0
    np.testing.assert_array_equal(np.asarray(acc),
                                  np.asarray(stage) > 0)
