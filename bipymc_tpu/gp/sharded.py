"""Device-sharded GP fit/predict — the tensor-parallel stretch goal.

SURVEY.md §3.1: the reference has no tensor parallelism (nothing to
shard), but the GP's O(n²d) kernel-matrix build is the one place worth
sharding for n ≳ 10⁴ training points. Strategy:

- the Gram matrix is built in *row blocks* under ``jax.shard_map`` — each
  device computes ``kernel(params, x_local, x_full)`` for its slice of
  training rows, so build FLOPs and peak memory divide by the device
  count (and each block is one matmul on its own device);
- the O(n³) Cholesky stays replicated (XLA has no distributed Cholesky;
  for GP-scale n the factorisation fits one chip once the build is paid);
- prediction shards *test* points — embarrassingly parallel.

Numerics match the single-device path to float rounding (tested at
1e-5/1e-6 tolerances on the 8-fake-CPU mesh in tests/test_gp_sharded.py
— NOT bitwise: pairwise_sqdist centers by the mean of the rows it is
handed, so each device's block is centered slightly differently than
the dense build).
"""

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bipymc_tpu.gp.regressor import GpFit
from bipymc_tpu.parallel.mesh import CHAIN_AXIS


def _pad_rows(a, mult):
    n = a.shape[0]
    pad = (-n) % mult
    if pad:
        a = jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
    return a, n


def sharded_gram(gp, params, x, mesh: Mesh, axis: str = CHAIN_AXIS):
    """Gram matrix of ``x`` [n, d] built in row blocks over ``mesh``.

    Returns the full (replicated) [n, n] matrix including the noise/jitter
    diagonal — ready for a replicated Cholesky.
    """
    n_dev = mesh.devices.size
    xp, n = _pad_rows(x, n_dev)

    def block(x_local, x_full):
        return gp.kernel(params, x_local, x_full)       # [n_local, n_pad]

    gram_padded = jax.jit(jax.shard_map(
        block, mesh=mesh, in_specs=(P(axis, None), P()),
        out_specs=P(axis, None)))(xp, xp)
    k = gram_padded[:n, :n]
    # same noise/jitter diagonal as the dense build (gp._diag_shift)
    return k + gp._diag_shift(params, n) * jnp.eye(n, dtype=k.dtype)


def fit_sharded(gp, x, y, mesh: Mesh, params=None, axis: str = CHAIN_AXIS):
    """Sharded-build fit: same result/GpFit as ``gp.fit`` (bitwise up to
    reduction order), with the kernel build distributed over ``mesh``."""
    from bipymc_tpu.gp.regressor import default_params
    x = jnp.atleast_2d(x)
    y = jnp.asarray(y)
    if params is None:
        params = default_params(x.shape[-1], dtype=x.dtype)
    yn, y_mean, y_std = gp._normalize(y)
    kmat = sharded_gram(gp, params, x, mesh, axis)
    # the regressor's own factorise/solve helpers
    chol = gp._cholesky(kmat)
    v = gp._solve_lower(chol, yn)
    alpha = gp._solve_lower_t(chol, v)
    return GpFit(params=params, x=x, chol=chol, alpha=alpha,
                 y_mean=y_mean, y_std=y_std)


def predict_sharded(gp, fit: GpFit, xs, mesh: Mesh,
                    axis: str = CHAIN_AXIS):
    """Posterior mean/var at [m, d] test points, sharded over test rows."""
    xs = jnp.atleast_2d(xs)
    xsp, m = _pad_rows(xs, mesh.devices.size)

    def block(xs_local):
        # the regressor's own predict body: configured solve path and
        # the true prior diagonal (kernel.diag) apply here too
        return gp._predict_impl(fit, xs_local)

    mu, var = jax.jit(jax.shard_map(
        block, mesh=mesh, in_specs=P(axis, None),
        out_specs=(P(axis), P(axis))))(xsp)
    return mu[:m], var[:m]
