"""Adaptive tempered SMC (samplers/smc.py) — beyond-reference."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import bipymc_tpu as bp
from bipymc_tpu.samplers import smc
from bipymc_tpu.parallel.mesh import chain_mesh


def _gauss_target(m, s2):
    m = jnp.asarray(m)

    def log_tgt(x):
        return -0.5 * jnp.sum((x - m) ** 2) / s2

    return log_tgt


def test_systematic_resampling_exact_counts():
    """Systematic resampling guarantees each ancestor appears either
    ⌊N·w⌋ or ⌈N·w⌉ times — check the deterministic bound exactly."""
    w = jnp.asarray([0.5, 0.25, 0.125, 0.125])
    for u in (0.0, 0.3, 0.77, 0.999):
        idx = np.asarray(smc._systematic_indices(w, jnp.float32(u)))
        counts = np.bincount(idx, minlength=4)
        expect = 4 * np.asarray(w)
        assert np.all(counts >= np.floor(expect))
        assert np.all(counts <= np.ceil(expect))


def test_rel_ess_bounds():
    n = 64
    uniform = jnp.full((n,), -np.log(n))
    assert np.isclose(float(smc._rel_ess(uniform)), 1.0)
    degenerate = jnp.full((n,), -1e9).at[0].set(0.0)
    assert float(smc._rel_ess(degenerate)) <= 1.0 / n + 1e-6


def test_evidence_and_moments_on_conjugate_gaussian():
    """Unnormalised N(m, s²I) target: log Z = (d/2)·log(2π s²) exactly."""
    d, s2 = 4, 0.25
    m = np.array([1.0, -1.0, 0.5, 2.0])
    sampler = bp.Smc(_gauss_target(m, s2), n_particles=2048, seed=0,
                     ref_mean=np.zeros(d), ref_var=np.full(d, 9.0))
    info = sampler.run()
    assert info["reached_one"]
    true_logz = 0.5 * d * np.log(2 * np.pi * s2)
    assert abs(info["log_evidence"] - true_logz) < 0.15
    xr = sampler.resample()
    assert np.abs(xr.mean(0) - m).max() < 0.1
    assert np.abs(xr.var(0) - s2).max() < 0.08


def test_beta_ladder_monotone_and_ends_at_one():
    d = 3
    sampler = bp.Smc(_gauss_target(np.zeros(d), 0.01), n_particles=512,
                     seed=2, ref_mean=np.zeros(d), ref_var=np.ones(d))
    info = sampler.run()
    ladder = info["beta_ladder"]
    assert np.all(np.diff(ladder) > 0)
    assert ladder[-1] == 1.0
    assert info["n_stages"] == ladder.size


def test_mixture_mode_weights_recovered():
    """THE capability gap SMC closes: a 0.7/0.3
    two-mode mixture at 8σ separation — annealing transports mass, so
    mode weights come out right without any inter-mode MCMC mixing."""
    d = 4
    means = jnp.asarray([[-4.0] * d, [4.0] * d])
    lws = jnp.log(jnp.asarray([0.7, 0.3]))

    def log_mix(x):
        comp = -0.5 * jnp.sum((x[None, :] - means) ** 2, -1) + lws
        return jax.scipy.special.logsumexp(comp)

    sampler = bp.Smc(log_mix, n_particles=4096, seed=1,
                     ref_mean=np.zeros(d), ref_var=np.full(d, 36.0))
    info = sampler.run()
    xr = sampler.resample()
    frac = float((xr[:, 0] < 0).mean())
    assert abs(frac - 0.7) < 0.07
    # the mixture is normalised up to the component Gaussian constant
    true_logz = 0.5 * d * np.log(2 * np.pi)
    assert abs(info["log_evidence"] - true_logz) < 0.2


def test_mesh_decisions_bit_identical_positions_ulp():
    """Gather-then-reduce: the decision MATH is identical
    mesh vs vmap, so given bit-identical particles every decision is
    bit-identical. Particles themselves drift by ~1 ulp per move
    (batch-shape FMA contraction in the local programs), and from stage
    2 on that can flip a low bisection bit — the honest cross-shape
    contract is stage-count equality, ladder/evidence to float
    tolerance, positions at the ulp floor. (This config happens to stay
    bit-exact for the rw kernel; the hmc-kernel test below is the one
    that measurably drifts.)"""
    d = 3
    kw = dict(n_particles=512, seed=0, ref_mean=np.zeros(d),
              ref_var=np.full(d, 4.0), n_moves=3)
    tgt = _gauss_target([1.0, -1.0, 0.5], 0.25)
    a = bp.Smc(tgt, **kw)
    ia = a.run()
    b = bp.Smc(tgt, mesh=chain_mesh(), **kw)
    ib = b.run()
    assert ia["n_stages"] == ib["n_stages"]
    np.testing.assert_allclose(ia["beta_ladder"], ib["beta_ladder"],
                               rtol=3e-6, atol=0)
    np.testing.assert_allclose(ia["log_evidence"], ib["log_evidence"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(a.particles, b.particles,
                               rtol=0, atol=3e-6)


def test_same_seed_deterministic():
    d = 2
    tgt = _gauss_target([0.5, -0.5], 0.5)
    kw = dict(n_particles=256, seed=7, ref_mean=np.zeros(d),
              ref_var=np.ones(d))
    a = bp.Smc(tgt, **kw)
    a.run()
    b = bp.Smc(tgt, **kw)
    b.run()
    np.testing.assert_array_equal(a.particles, b.particles)


def test_max_stages_warns_and_reports():
    d = 2
    sampler = bp.Smc(_gauss_target(np.zeros(d), 1e-6), n_particles=128,
                     seed=3, ref_mean=np.zeros(d), ref_var=np.ones(d),
                     max_stages=2)
    with pytest.warns(UserWarning, match="max_stages"):
        info = sampler.run()
    assert not info["reached_one"]
    assert info["n_stages"] == 2


def test_nonfinite_target_hard_rejects():
    d = 2

    def cliff(x):
        return jnp.where(jnp.all(jnp.abs(x) < 3.0),
                         -0.5 * jnp.sum(x * x) / 0.25, -jnp.inf)

    sampler = bp.Smc(cliff, n_particles=512, seed=4,
                     ref_mean=np.zeros(d), ref_var=np.ones(d))
    sampler.run()
    assert np.all(np.isfinite(sampler.particles))
    assert np.all(np.abs(sampler.particles) < 3.0)


def test_constructor_validation():
    tgt = _gauss_target([0.0], 1.0)
    with pytest.raises(ValueError, match="reference density"):
        bp.Smc(tgt)
    with pytest.raises(ValueError, match="together"):
        bp.Smc(tgt, log_ref=lambda x: 0.0)
    with pytest.raises(ValueError, match="divisible"):
        bp.Smc(tgt, n_particles=100, mesh=chain_mesh(),
               ref_mean=np.zeros(1), ref_var=np.ones(1))
    s = bp.Smc(tgt, n_particles=64, ref_mean=np.zeros(1),
               ref_var=np.ones(1))
    with pytest.raises(RuntimeError, match="run"):
        _ = s.particles
    with pytest.raises(ValueError, match="rows"):
        s.run(theta_0=np.zeros((3, 1)))


def test_custom_reference_pair():
    """Custom (log_ref, sample_ref): a normalised uniform-ish logistic
    reference still recovers the evidence."""
    d = 1
    s2 = 0.5

    def log_ref(x):
        # standard normal, written by hand
        return -0.5 * jnp.sum(x * x) - 0.5 * d * np.log(2 * np.pi)

    def sample_ref(key, n):
        return jax.random.normal(key, (n, d), jnp.float32)

    sampler = bp.Smc(_gauss_target(np.zeros(d), s2), n_particles=1024,
                     seed=5, log_ref=log_ref, sample_ref=sample_ref)
    info = sampler.run()
    true_logz = 0.5 * d * np.log(2 * np.pi * s2)
    assert abs(info["log_evidence"] - true_logz) < 0.1


def test_hmc_kernel_survives_d48_mixture():
    """The measured RW-rejuvenation failure: at d=48 the
    basin-level selection noise drives one mode extinct. kernel="hmc"
    (leapfrog rejuvenation, population-variance mass, cross-stage ε
    adaptation) keeps both basins and nails the evidence."""
    d = 48
    means = jnp.stack([jnp.full((d,), -3.0), jnp.full((d,), 3.0)])
    lws = jnp.log(jnp.asarray([0.7, 0.3]))

    def log_mix(x):
        comp = -0.5 * jnp.sum((x[None, :] - means) ** 2, -1) + lws
        return jax.scipy.special.logsumexp(comp)

    sampler = bp.Smc(log_mix, n_particles=2048, seed=0,
                     ref_mean=np.zeros(d), ref_var=np.full(d, 36.0),
                     ess_alpha=0.9, n_moves=5, kernel="hmc")
    info = sampler.run()
    assert info["reached_one"]
    frac = float((sampler.resample()[:, 0] < 0).mean())
    assert abs(frac - 0.7) < 0.12, frac
    true_logz = 0.5 * d * np.log(2 * np.pi)
    assert abs(info["log_evidence"] - true_logz) < 0.7
    # cross-stage Robbins-Monro holds acceptance near the 0.65 target
    assert 0.4 < info["acceptance"][5:].mean() < 0.9


def test_hmc_kernel_mesh_decisions_match_vmap():
    """Cross-shape contract for the gradient kernel: positions drift at
    the ulp floor per move AND any threshold decision (resample fires at
    ess < threshold on ulp-different inputs) can flip, which reshuffles
    particles wholesale — so particle identity is distributional across
    shapes; the schedule and evidence stay at float tolerance."""
    d = 4
    m = np.array([1.0, -1.0, 0.5, 0.0])
    tgt = _gauss_target(m, 0.25)
    kw = dict(n_particles=512, seed=3, ref_mean=np.zeros(d),
              ref_var=np.full(d, 4.0), n_moves=3, kernel="hmc")
    a = bp.Smc(tgt, **kw)
    ia = a.run()
    b = bp.Smc(tgt, mesh=chain_mesh(), **kw)
    ib = b.run()
    assert ia["n_stages"] == ib["n_stages"]
    np.testing.assert_allclose(ia["beta_ladder"], ib["beta_ladder"],
                               rtol=3e-6, atol=0)
    np.testing.assert_allclose(ia["log_evidence"], ib["log_evidence"],
                               rtol=0, atol=2e-3)
    xa, xb = a.resample(), b.resample()
    assert np.abs(xa.mean(0) - xb.mean(0)).max() < 0.1
    assert np.abs(xa.var(0) - xb.var(0)).max() < 0.1


def test_kernel_validation():
    with pytest.raises(ValueError, match="kernel"):
        bp.Smc(_gauss_target([0.0], 1.0), ref_mean=np.zeros(1),
               ref_var=np.ones(1), kernel="nuts")


def test_nan_target_at_init_dies_cleanly():
    """Review finding: a single NaN log-target value at an
    auto-drawn reference particle must kill THAT particle, not NaN the
    β-solve/evidence and burn max_stages."""
    d = 2

    def nan_tail(x):
        # NaN outside a ball (sqrt of a negative), clean inside
        r2 = jnp.sum(x * x)
        return jnp.where(r2 < 9.0, -0.5 * r2 / 0.25,
                         jnp.sqrt(4.0 - r2))      # NaN when r2 > 9 > 4

    sampler = bp.Smc(nan_tail, n_particles=512, seed=0,
                     ref_mean=np.zeros(d), ref_var=np.full(d, 4.0))
    info = sampler.run()
    assert info["reached_one"]
    assert np.isfinite(info["log_evidence"])
    assert np.all(np.isfinite(sampler.particles))


def test_beta_one_moves_escape_compact_reference():
    """Review finding: (1-β)·(-inf) at β=1 was NaN — final-stage moves
    hard-rejected everything outside a compact reference's support,
    biasing the posterior toward the reference. With the fix, mass
    correctly concentrates where the TARGET puts it, outside the
    reference box."""
    d = 1

    def log_ref(x):
        # uniform on [-1, 1] (normalised)
        inside = jnp.all(jnp.abs(x) <= 1.0)
        return jnp.where(inside, -np.log(2.0) * d, -jnp.inf)

    def sample_ref(key, n):
        return jax.random.uniform(key, (n, d), jnp.float32, -1.0, 1.0)

    # target centred at 1.5 — most of its mass OUTSIDE the reference box
    tgt = _gauss_target([1.5], 0.04)
    sampler = bp.Smc(tgt, n_particles=1024, seed=2, log_ref=log_ref,
                     sample_ref=sample_ref, n_moves=20)
    sampler.run()
    xr = sampler.resample()
    assert float((xr[:, 0] > 1.0).mean()) > 0.5
    assert abs(float(xr[:, 0].mean()) - 1.5) < 0.15
