"""The GP's plain-XLA linear algebra against SciPy in float64.

GpRegressor factors and solves with ``jnp.linalg.cholesky`` /
``solve_triangular`` (cuSOLVER on the GPU), vmapped over chains for the
config-4 shape. Here: the factor, the solve, the log marginal
likelihood and its gradient, single and batched, in float64 against a
NumPy/SciPy reference of the same math.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.linalg import cho_factor, cho_solve

from bipymc_tpu.gp.regressor import GpRegressor

CASES = [(16, 1), (64, 1), (64, 4), (128, 3)]


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, (n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.normal(size=n)
    return x, y


def _thetas(batch, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([rng.normal(0, 0.3, batch), rng.normal(0, 0.3, batch),
                     rng.normal(0, 0.3, batch),
                     rng.normal(-1.5, 0.2, batch)], 1)


def _params(t):
    return {"log_lengthscale": t[0:2], "log_sigma_f": t[2],
            "log_sigma_n": t[3]}


def _gram_np(gp, x, t):
    ls, sf2, sn2 = np.exp(t[0:2]), np.exp(2 * t[2]), np.exp(2 * t[3])
    xs = x / ls
    r2 = ((xs[:, None] - xs[None]) ** 2).sum(-1)
    n = x.shape[0]
    jitter = max(gp.jitter, 4.0 * n * np.finfo(np.float64).eps)
    return sf2 * np.exp(-0.5 * r2) + (sn2 + jitter * sf2) * np.eye(n)


def _lml_np(gp, x, y, t):
    c, low = cho_factor(_gram_np(gp, x, t), lower=True)
    alpha = cho_solve((c, low), y)
    n = x.shape[0]
    return (-0.5 * y @ alpha - np.sum(np.log(np.diag(c)))
            - 0.5 * n * np.log(2 * np.pi))


@pytest.mark.parametrize("n,batch", CASES)
def test_cholesky_and_solve_match_scipy(n, batch):
    gp = GpRegressor()
    x, y = _data(n)
    th = _thetas(batch)
    with jax.enable_x64(True):
        xj, yj = jnp.asarray(x), jnp.asarray(y)

        def factor(t):
            k = gp._gram(_params(t), xj)
            c = gp._cholesky(k)
            return c, gp._solve_lower_t(c, gp._solve_lower(c, yj))

        chol, alpha = jax.vmap(factor)(jnp.asarray(th))
        chol, alpha = np.asarray(chol), np.asarray(alpha)
    for b in range(batch):
        k = _gram_np(gp, x, th[b])
        np.testing.assert_allclose(chol[b], np.linalg.cholesky(k),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(alpha[b], np.linalg.solve(k, y),
                                   rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("n,batch", CASES)
def test_log_ml_and_grad_match_scipy(n, batch):
    gp = GpRegressor()
    x, y = _data(n, seed=n)
    th = _thetas(batch, seed=batch)
    with jax.enable_x64(True):
        xj, yj = jnp.asarray(x), jnp.asarray(y)

        def lml(t):
            return gp._lml_impl(_params(t), xj, yj)

        val, grad = jax.vmap(jax.value_and_grad(lml))(jnp.asarray(th))
        val, grad = np.asarray(val), np.asarray(grad)
    h = 1e-6
    for b in range(batch):
        assert abs(val[b] - _lml_np(gp, x, y, th[b])) < 1e-8 * max(
            1.0, abs(val[b]))
        fd = np.array([(_lml_np(gp, x, y, th[b] + h * e)
                        - _lml_np(gp, x, y, th[b] - h * e)) / (2 * h)
                       for e in np.eye(4)])
        np.testing.assert_allclose(grad[b], fd, rtol=1e-5, atol=1e-6)
