"""SVGD (samplers/svgd.py): update math against a hand-written NumPy
reference of Liu & Wang (2016)'s algorithm, posterior-moment recovery,
deterministic continuation, mesh/vmap equivalence, and the documented
moderate-separation mixture behaviour."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bipymc_tpu as bp
from bipymc_tpu.models.targets import correlated_gaussian
from bipymc_tpu.parallel.mesh import chain_mesh
from bipymc_tpu.samplers import svgd

MEAN = jnp.array([1.0, -1.0])
COV = jnp.array([[1.0, 0.6], [0.6, 1.5]])

needs_devices = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multiple (fake) devices")


def _numpy_svgd_step(x, grads, step_size, hist, alpha, fudge, t):
    """The reference implementation's update (median-trick bandwidth,
    AdaGrad with momentum), written independently in NumPy."""
    n = x.shape[0]
    diff = x[:, None, :] - x[None, :, :]
    sqd = np.sum(diff * diff, axis=-1)
    h2 = np.median(sqd) / np.log(n + 1.0)          # = 2h²
    K = np.exp(-sqd / h2)
    attract = K @ grads
    repulse = (x * K.sum(axis=1)[:, None] - K @ x) * (2.0 / h2)
    phi = (attract + repulse) / n
    if t == 0:
        hist = phi * phi
    else:
        hist = alpha * hist + (1.0 - alpha) * phi * phi
    return x + step_size * phi / (fudge + np.sqrt(hist)), hist, h2


def test_step_matches_numpy_reference():
    lp = correlated_gaussian(MEAN, COV)
    cfg = svgd.svgd_config(n_particles=32, step_size=0.1)
    step = svgd.make_step(lp, cfg)
    key = jax.random.key(0)
    x0 = np.asarray(jax.random.normal(key, (32, 2)), np.float64)

    x_np, hist_np = x0.copy(), np.zeros_like(x0)
    state = svgd.init(jnp.asarray(x0, jnp.float32))
    for t in range(3):
        g = np.asarray(jax.vmap(jax.grad(lp))(
            jnp.asarray(x_np, jnp.float32)), np.float64)
        x_np, hist_np, h2_np = _numpy_svgd_step(
            x_np, g, cfg.step_size, hist_np, cfg.alpha, cfg.fudge, t)
        state, info = step(state)
        np.testing.assert_allclose(np.asarray(state.x), x_np,
                                   rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(float(info.bandwidth), h2_np,
                                   rtol=2e-6)


def test_gaussian_moments_recovered():
    lp = correlated_gaussian(MEAN, COV)
    s = bp.Svgd(lp, n_particles=256, seed=1, step_size=0.3)
    info = s.run(800, theta_0=jnp.array([4.0, 4.0]), spread=2.0)
    p = s.particles
    # the cloud transported ~5 units and settled: φ is small and the
    # mean is tight; covariance is right up to the documented mild
    # underestimation
    assert info["phi_rms"] < 0.2
    np.testing.assert_allclose(p.mean(0), np.asarray(MEAN), atol=0.2)
    cov = np.cov(p.T)
    np.testing.assert_allclose(cov, np.asarray(COV), rtol=0.35, atol=0.15)
    assert cov[0, 1] > 0.3  # correlation direction resolved


def test_deterministic_and_continuation():
    lp = correlated_gaussian(MEAN, COV)
    a = bp.Svgd(lp, n_particles=64, seed=7, step_size=0.2)
    a.run(50, theta_0=MEAN, spread=1.5)
    a.run(50)  # continuation
    b = bp.Svgd(lp, n_particles=64, seed=7, step_size=0.2)
    b.run(100, theta_0=MEAN, spread=1.5)
    # one 100-step run == 50 + 50 (same scan math, same state carry)
    np.testing.assert_array_equal(a.particles, b.particles)
    # and the whole thing is deterministic given the seed
    c = bp.Svgd(lp, n_particles=64, seed=7, step_size=0.2)
    c.run(100, theta_0=MEAN, spread=1.5)
    np.testing.assert_array_equal(b.particles, c.particles)


def test_continuation_warns_on_theta0():
    lp = correlated_gaussian(MEAN, COV)
    s = bp.Svgd(lp, n_particles=32, seed=0)
    s.run(5, theta_0=MEAN)
    with pytest.warns(UserWarning, match="theta_0 ignored"):
        s.run(5, theta_0=MEAN)


def test_phi_rms_decreases_toward_fixed_point():
    lp = correlated_gaussian(MEAN, COV)
    s = bp.Svgd(lp, n_particles=128, seed=3, step_size=0.2)
    info = s.run(400, theta_0=jnp.array([5.0, 5.0]), spread=1.0)
    hist = info["phi_rms_history"]
    assert hist[-1] < 0.3 * hist[:20].max()


def test_fixed_bandwidth_and_validation():
    lp = correlated_gaussian(MEAN, COV)
    s = bp.Svgd(lp, n_particles=32, seed=0, bandwidth=2.0)
    info = s.run(10, theta_0=MEAN)
    assert np.all(info["bandwidth_history"] == 2.0)
    with pytest.raises(ValueError, match="bandwidth"):
        svgd.make_step(lp, svgd.svgd_config(bandwidth=-1.0))
    with pytest.raises(ValueError, match="first run"):
        bp.Svgd(lp).run(5)
    with pytest.raises(ValueError, match="n_steps"):
        bp.Svgd(lp).run(0, theta_0=MEAN)


def test_nan_gradients_do_not_poison_the_cloud():
    # particles outside a compact support have NaN gradients; without
    # the sanitizer those rows ride through attract = K @ G as 0·NaN =
    # NaN and poison EVERY particle in one step. With it, the cloud
    # converges normally and the out-of-support rows stay finite (they
    # are kernel-decoupled at this distance — the svgd.py docstring's
    # far-separation honesty note applies to rescuing them).
    def lp(x):
        inside = jnp.all(jnp.abs(x) < 3.0)
        return jnp.where(inside, -0.5 * jnp.sum(x * x), -jnp.inf)

    rng = np.random.default_rng(0)
    x0 = rng.normal(0.0, 1.0, (32, 2)).astype(np.float32)
    x0[:4] = 6.0  # outside the box
    s = bp.Svgd(lp, n_particles=32, seed=0, step_size=0.3)
    s.run(300, theta_0=jnp.asarray(x0))
    p = s.particles
    assert np.all(np.isfinite(p))
    cloud = p[np.abs(p).max(axis=1) < 3.0]
    assert cloud.shape[0] >= 28
    np.testing.assert_allclose(cloud.mean(0), 0.0, atol=0.35)


@needs_devices
def test_mesh_close_to_vmap():
    lp = correlated_gaussian(MEAN, COV)
    kw = dict(n_particles=32, seed=5, step_size=0.2)
    a = bp.Svgd(lp, mesh=chain_mesh(), **kw)
    a.run(60, theta_0=MEAN, spread=1.5)
    b = bp.Svgd(lp, **kw)
    b.run(60, theta_0=MEAN, spread=1.5)
    # bandwidth decisions are replicated math on gathered positions →
    # identical; the φ row-block matmuls sit at the house cross-shape
    # rounding floor, so positions are allclose
    np.testing.assert_allclose(a.particles, b.particles,
                               rtol=2e-5, atol=2e-6)


@needs_devices
def test_mesh_indivisible_particles_raises():
    lp = correlated_gaussian(MEAN, COV)
    with pytest.raises(ValueError):
        bp.Svgd(lp, n_particles=30, mesh=chain_mesh())


def test_moderate_separation_mixture_keeps_both_modes():
    # two modes 4σ apart: within kernel reach, so particles settle into
    # both basins (the documented far-separation weight-freeze applies
    # to ≫ bandwidth separations, not this regime)
    mu = 2.0

    def lp(x):
        a = -0.5 * jnp.sum((x - mu) ** 2)
        b = -0.5 * jnp.sum((x + mu) ** 2)
        return jnp.logaddexp(a, b) - jnp.log(2.0)

    s = bp.Svgd(lp, n_particles=256, seed=2, step_size=0.3)
    s.run(600, theta_0=jnp.zeros(2), spread=3.0)
    p = s.particles
    frac_right = float(np.mean(p[:, 0] > 0))
    assert 0.3 < frac_right < 0.7
    # each half sits on its mode
    assert abs(p[p[:, 0] > 0, 0].mean() - mu) < 0.5
    assert abs(p[p[:, 0] < 0, 0].mean() + mu) < 0.5
