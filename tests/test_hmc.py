"""HMC / MALA (samplers/hmc.py) — gradient family, beyond-reference."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import bipymc_tpu as bp
from bipymc_tpu.samplers import hmc
from bipymc_tpu.models.targets import correlated_gaussian, banana
from bipymc_tpu.parallel.mesh import chain_mesh

MEAN = np.array([1.0, -1.0])
COV = np.array([[2.0, 0.8], [0.8, 1.0]])


def test_moments_on_correlated_gaussian():
    s = bp.Hmc(correlated_gaussian(MEAN, COV), n_chains=16, seed=0,
               n_leapfrog=16, adapt_gens=500)
    s.run_mcmc(2000, jnp.zeros(2), spread=1.5)
    flat = s.get_chain(discard=600, flat=True)
    assert np.abs(flat.mean(0) - MEAN).max() < 0.1
    assert np.abs(np.cov(flat.T) - COV).max() < 0.3


def test_dual_averaging_hits_target_accept():
    """After warmup the frozen ε̄ should hold acceptance near the 0.8
    target (HG 2014's guarantee is in expectation; band is loose)."""
    s = bp.Hmc(correlated_gaussian(MEAN, COV), n_chains=32, seed=1,
               n_leapfrog=8, adapt_gens=400)
    s.run_mcmc(1400, jnp.zeros(2), spread=1.0)
    acc = np.asarray(s._history["accepted"])[400:]   # post-freeze only
    assert 0.65 < acc.mean() < 0.95


def test_step_size_frozen_after_warmup():
    from bipymc_tpu.core.scan import run_scan
    lp = correlated_gaussian(MEAN, COV)
    cfg = hmc.hmc_config(n_leapfrog=4, adapt_gens=50)
    step = hmc.make_step(lp, cfg)
    state = hmc.init(jnp.zeros((4, 2)), lp, cfg)
    _, hist = jax.jit(lambda s: run_scan(
        step, s, jax.random.key(2), 80,
        collect_fn=lambda st, i: i.step_size))(state)
    eps = np.asarray(hist)                           # [T, n_chains]
    # every post-warmup generation used the same frozen ε̄ per chain
    assert np.all(eps[50:] == eps[50])
    # and adaptation actually moved ε during warmup
    assert not np.all(eps[:50] == eps[0])


def test_mass_adaptation_learns_scales():
    """On a strongly anisotropic Gaussian the adapted inverse mass must
    track the per-dimension variances (ratio within a factor ~3)."""
    var = np.array([100.0, 1.0, 0.01])
    lp = lambda th: -0.5 * jnp.sum(th * th / jnp.asarray(var, th.dtype))
    s = bp.Hmc(lp, n_chains=8, seed=3, n_leapfrog=16, adapt_gens=800,
               mass_interval=100, t0_mass=100)
    s.run_mcmc(900, jnp.zeros(3), spread=1.0)
    im = np.asarray(s.final_state.inv_mass)          # [n_chains, 3]
    ratio = im / var[None, :]
    # per-dim scale learned to within an order of magnitude, and the
    # 10^4 dynamic range is clearly resolved
    assert np.all(im[:, 0] / im[:, 2] > 1e2)
    assert np.all((ratio > 0.1) & (ratio < 10.0))


def test_leapfrog_reversibility():
    """Integrate L steps, flip momentum, integrate back: recover the
    start point to float tolerance (the exactness property the accept
    ratio's correctness rests on)."""
    lp = banana()
    vg = jax.value_and_grad(lp)
    eps, L = 0.05, 25
    inv_mass = jnp.array([1.0, 2.0])

    def leapfrog(x, p):
        l, g = vg(x)
        def body(c, _):
            x, p, g = c
            p = p + 0.5 * eps * g
            x = x + eps * inv_mass * p
            _, g = vg(x)
            p = p + 0.5 * eps * g
            return (x, p, g), None
        (x, p, _), _ = jax.lax.scan(body, (x, p, g), None, length=L)
        return x, p

    x0 = jnp.array([0.3, -0.2])
    p0 = jnp.array([0.7, 0.4])
    x1, p1 = leapfrog(x0, p0)
    x2, p2 = leapfrog(x1, -p1)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x0),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(-p2), np.asarray(p0),
                               rtol=0, atol=1e-4)


def test_energy_error_scales_as_eps_squared():
    """Leapfrog is a second-order integrator: halving ε must cut the
    per-trajectory energy error ~4x (band [2.5, 6])."""
    lp = correlated_gaussian(MEAN, COV)
    vg = jax.value_and_grad(lp)
    x0 = jnp.array([0.5, 0.5])
    p0 = jnp.array([1.0, -0.5])

    def energy_err(eps, L):
        l, g = vg(x0)
        def body(c, _):
            x, p, g = c
            p = p + 0.5 * eps * g
            x = x + eps * p
            ln, gn = vg(x)
            p = p + 0.5 * eps * gn
            return (x, p, gn), ln
        (x, p, _), ls = jax.lax.scan(body, (x0, p0, g), None, length=L)
        h0 = -lp(x0) + 0.5 * jnp.sum(p0 * p0)
        h1 = -ls[-1] + 0.5 * jnp.sum(p * p)
        return float(jnp.abs(h1 - h0))

    e1 = energy_err(0.2, 16)
    e2 = energy_err(0.1, 32)        # same trajectory length ε·L
    assert 2.5 < e1 / e2 < 6.0


def test_chain_count_invariance():
    """Chain i's trajectory is independent of how many chains run
    (global-index key folding — core/rng.py contract)."""
    lp = correlated_gaussian(MEAN, COV)
    x0 = jnp.tile(jnp.array([[0.5, -0.5], [1.5, 0.5]]), (4, 1))
    a = bp.Hmc(lp, n_chains=4, seed=7, n_leapfrog=8)
    a.run_mcmc(100, x0[:4])
    b = bp.Hmc(lp, n_chains=8, seed=7, n_leapfrog=8)
    b.run_mcmc(100, x0)
    np.testing.assert_array_equal(a.super_chain, b.super_chain[:4])


def test_mesh_equals_vmap():
    """No in-step collectives → identical RNG streams and math on the
    sharded path; bit-identical here because the batch-2 local program
    rounds like the batch-16 one (the general contract is
    test_mesh_one_chain_per_device_ulp_contract below)."""
    lp = correlated_gaussian(MEAN, COV)
    a = bp.Hmc(lp, n_chains=16, seed=4, n_leapfrog=8)
    a.run_mcmc(150, jnp.zeros(2), spread=1.0)
    b = bp.Hmc(lp, n_chains=16, seed=4, n_leapfrog=8, mesh=chain_mesh())
    b.run_mcmc(150, jnp.zeros(2), spread=1.0)
    np.testing.assert_array_equal(a.super_chain, b.super_chain)


def test_mesh_one_chain_per_device_ulp_contract():
    """At 1 chain/device XLA compiles a batch-1 local program whose
    FMA/fusion rounding can differ from the vmapped batch-8 program by
    ~1 ulp per generation, and Hamiltonian flow amplifies ulp
    differences chaotically (hmc.py module docstring). The honest
    cross-shape contract: early generations agree at rounding level,
    long-run moments agree statistically."""
    lp = correlated_gaussian(MEAN, COV)
    a = bp.Hmc(lp, n_chains=8, seed=4, n_leapfrog=8, adapt_gens=100)
    a.run_mcmc(400, jnp.zeros(2), spread=1.0)
    b = bp.Hmc(lp, n_chains=8, seed=4, n_leapfrog=8, adapt_gens=100,
               mesh=chain_mesh())
    b.run_mcmc(400, jnp.zeros(2), spread=1.0)
    ca, cb = a.super_chain, b.super_chain
    # same RNG streams: the first generations agree to f32 rounding
    np.testing.assert_allclose(ca[:, :2], cb[:, :2], rtol=0, atol=3e-6)
    # chaotic amplification later: distributional agreement only
    fa = ca[:, 150:].reshape(-1, 2)
    fb = cb[:, 150:].reshape(-1, 2)
    assert np.abs(fa.mean(0) - fb.mean(0)).max() < 0.25
    assert np.abs(np.cov(fa.T) - np.cov(fb.T)).max() < 0.5


def test_run_until_rhat_stop():
    s = bp.Hmc(correlated_gaussian(MEAN, COV), n_chains=16, seed=5,
               n_leapfrog=8, adapt_gens=200)
    info = s.run_mcmc_until(jnp.zeros(2), rhat_tol=1.05, chunk=100,
                            max_chunks=50, warmup_chunks=3, spread=2.0)
    assert info["rhat"].max() < 1.05
    assert info["steps"] >= 300


def test_divergence_hard_rejects():
    """A cliff target (−inf outside the box) must reject, not poison the
    chain with NaN (framework sanitizer policy)."""
    lp = lambda th: jnp.where(jnp.all(jnp.abs(th) < 1.0),
                              -0.5 * jnp.sum(th * th), -jnp.inf)
    s = bp.Hmc(lp, n_chains=4, seed=6, n_leapfrog=8, step_size=0.5,
               adapt_gens=0)
    s.run_mcmc(200, jnp.zeros(2), spread=0.1)
    assert np.all(np.isfinite(s.flat_chain))
    assert np.all(np.abs(s.flat_chain) < 1.0)


def test_mala_is_one_step_hmc_and_samples():
    s = bp.Mala(correlated_gaussian(MEAN, COV), n_chains=32, seed=8,
                adapt_gens=500)
    assert s.cfg.n_leapfrog == 1 and not s.cfg.jitter
    assert s.cfg.target_accept == pytest.approx(0.574)
    s.run_mcmc(4000, jnp.zeros(2), spread=1.0)
    flat = s.get_chain(discard=1000, flat=True)
    assert np.abs(flat.mean(0) - MEAN).max() < 0.15
    acc = np.asarray(s._history["accepted"])[500:]
    assert 0.4 < acc.mean() < 0.75        # near the 0.574 target


def test_continuation_and_checkpoint_roundtrip():
    from bipymc_tpu.utils.checkpoint import save_state, load_state
    lp = correlated_gaussian(MEAN, COV)
    a = bp.Hmc(lp, n_chains=4, seed=9, n_leapfrog=4)
    a.run_mcmc(60, jnp.zeros(2))
    a.run_mcmc(40)                        # continuation, no warning
    b = bp.Hmc(lp, n_chains=4, seed=9, n_leapfrog=4)
    b.run_mcmc(100, jnp.zeros(2))
    np.testing.assert_array_equal(a.super_chain, b.super_chain)

    import tempfile, os
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "hmc.npz")
        save_state(path, a.final_state, step=100)
        state, step = load_state(path)
        assert step == 100
        for l1, l2 in zip(jax.tree_util.tree_leaves(state),
                          jax.tree_util.tree_leaves(a.final_state)):
            np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))


def test_continuation_warns_on_ignored_args():
    s = bp.Hmc(correlated_gaussian(MEAN, COV), n_chains=4, seed=10)
    s.run_mcmc(20, jnp.zeros(2))
    with pytest.warns(UserWarning, match="IGNORED"):
        s.run_mcmc(10, jnp.ones(2))


def test_hmc_on_gp_surrogate_log_like():
    """The gradient family composes with the GP surrogate (the surrogate
    is differentiable through the batched-Cholesky fit — gp/regressor
    custom JVP): HMC recovers the surrogate posterior's mode region."""
    from bipymc_tpu.gp import GpRegressor

    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.uniform(-2, 2, (64, 2)), jnp.float32)
    y = -jnp.sum((X - 0.5) ** 2, axis=1)         # peak at (0.5, 0.5)
    gp = GpRegressor(normalize_y=True)
    fit = gp.fit(X, y)
    surrogate = gp.surrogate_log_like(fit)
    # the surrogate reverts to its (zero) mean outside the data — combine
    # with a prior covering the trained region, per its docstring
    log_post = lambda th: surrogate(th) - 0.125 * jnp.sum(th * th)

    s = bp.Hmc(log_post, n_chains=8, seed=11, n_leapfrog=8,
               adapt_gens=300, step_size=0.05)
    s.run_mcmc(800, jnp.zeros(2), spread=0.5)
    flat = s.get_chain(discard=400, flat=True)
    assert np.abs(flat.mean(0) - 0.5).max() < 0.35


def test_injected_draws_override():
    """draws_fn override drives the step deterministically (the fidelity
    hook every family exposes — SURVEY.md §6 contract (a))."""
    lp = correlated_gaussian(MEAN, COV)
    cfg = hmc.hmc_config(n_leapfrog=2, jitter=False, adapt_gens=0,
                         step_size=0.3)

    def draws(key, t, d, dtype):
        return (jnp.full((d,), 0.1, dtype),      # tiny momentum
                jnp.asarray(0.999, dtype),       # near-certain reject u
                jnp.asarray(0.0, dtype))

    step = hmc.make_step(lp, cfg, draws_fn=draws)
    x0 = jnp.zeros((1, 2))
    state = hmc.init(x0, lp, cfg)
    s1, i1 = jax.jit(step)(state, jax.random.key(0), jnp.int32(0))
    s2, i2 = jax.jit(step)(state, jax.random.key(1), jnp.int32(0))
    # the injected stream fully determines the step: different keys,
    # identical trajectories
    np.testing.assert_array_equal(np.asarray(s1.x), np.asarray(s2.x))
    # tiny momentum + small ε ⇒ |ΔH| ≈ 0 ⇒ α ≈ 1 > log(0.999) accept
    assert bool(i1.accepted[0])


def test_escape_accept_from_out_of_support_start():
    """Review finding: guarding isfinite(log_alpha) treated
    the +inf escape ratio from a logp=-inf start as a divergence and
    froze the chain forever. Policy (matching the RW/DE families):
    sanitize the PROPOSAL side only — a finite proposal escape-accepts."""
    lp = lambda th: jnp.where(jnp.all(jnp.abs(th) < 2.0),
                              -0.5 * jnp.sum(th * th), -jnp.inf)
    x0 = jnp.full((8, 2), 5.0)               # far outside support
    # adapt_gens=0: dual averaging sees alpha=0 during the transient
    # and would collapse eps before the drift escapes
    s = bp.Hmc(lp, n_chains=8, seed=0, n_leapfrog=8, step_size=0.5,
               adapt_gens=0)
    s.run_mcmc(300, x0)
    final = s.super_chain[:, -1, :]
    assert np.all(np.abs(final) < 2.0), final   # every chain escaped
