"""ChEES-HMC (samplers/chees.py) — cross-chain trajectory adaptation."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import bipymc_tpu as bp
from bipymc_tpu.samplers import chees
from bipymc_tpu.models.targets import correlated_gaussian
from bipymc_tpu.parallel.mesh import chain_mesh

MEAN = np.array([1.0, -1.0])
COV = np.array([[2.0, 0.8], [0.8, 1.0]])


def test_van_der_corput_stratifies():
    """First 2^k points of the base-2 radical inverse hit every dyadic
    cell of width 2^-k exactly once, and all values are in (0, 1)."""
    h = np.asarray(jax.vmap(chees.van_der_corput)(jnp.arange(64)))
    assert np.all((h > 0) & (h < 1))
    cells = np.floor(h * 64).astype(int)
    assert sorted(cells) == list(range(64))


def test_moments_on_correlated_gaussian():
    s = bp.Chees(correlated_gaussian(MEAN, COV), n_chains=64, seed=0,
                 adapt_gens=500)
    s.run_mcmc(1500, jnp.zeros(2), spread=1.5)
    flat = s.get_chain(discard=600, flat=True)
    assert np.abs(flat.mean(0) - MEAN).max() < 0.1
    assert np.abs(np.cov(flat.T) - COV).max() < 0.3


def test_trajectory_length_adapts_up_and_freezes():
    """The regime trajectory adaptation exists for: an anisotropic
    Gaussian with mass adaptation OFF, where ε is pinned by the
    smallest scale (σ=1) while useful trajectories must span the
    largest (σ=10, half-period π/2·10 ≈ 16) — ChEES must grow T from
    its ε-sized init to O(σ_max) so the frozen leapfrog count is ≫ 1,
    then freeze it after adapt_gens (diminishing adaptation). (On a
    UNIT Gaussian ε̄ ≈ 1 and T ≈ π/2, so L ∈ {1,2} is the CORRECT
    answer — measured while writing this test; anisotropy is what
    makes L grow.)"""
    d = 6
    sig = np.logspace(0, 1, d).astype(np.float32)      # 1..10
    iv = jnp.asarray(1.0 / sig ** 2)
    lp = lambda th: -0.5 * jnp.sum(th * th * iv)
    x0 = np.random.default_rng(0).normal(size=(128, d)) * sig
    s = bp.Chees(lp, n_chains=128, seed=1, step_size=0.1,
                 adapt_gens=600, adapt_mass=False)
    s.run_mcmc(700, jnp.asarray(x0, jnp.float32))
    T = s.trajectory_length
    assert T > 5.0, T                       # grew ≫ the 0.1 init
    # mean leapfrog count in the frozen window reflects τ/ε ≫ 1
    L = np.asarray(s._history["n_leapfrog"])[620:]
    assert L.mean() > 3, L.mean()
    # frozen: further generations leave every adaptation field untouched
    st0 = s.final_state
    s.run_mcmc(50)
    st1 = s.final_state
    for f in ("log_T", "log_T_bar", "log_eps", "log_eps_bar", "hbar",
              "adam_m", "adam_v", "count", "inv_mass"):
        np.testing.assert_array_equal(np.asarray(getattr(st0, f)),
                                      np.asarray(getattr(st1, f)), f)


def test_dual_averaging_hits_target_accept():
    s = bp.Chees(correlated_gaussian(MEAN, COV), n_chains=64, seed=2,
                 adapt_gens=400, target_accept=0.651)
    s.run_mcmc(1000, jnp.zeros(2), spread=1.0)
    alpha = np.asarray(s._history["accepted"])[500:]
    assert 0.45 < alpha.mean() < 0.85, alpha.mean()


def test_mass_adaptation_learns_scales():
    """Shared diagonal inverse mass from the population Welford must
    resolve a 10^4 dynamic range."""
    var = np.array([100.0, 1.0, 0.01])
    lp = lambda th: -0.5 * jnp.sum(th * th / jnp.asarray(var, th.dtype))
    s = bp.Chees(lp, n_chains=256, seed=3, adapt_gens=600,
                 mass_interval=50, t0_mass=50)
    # overdispersed start at the TRUE scales so the population variance
    # sees them immediately (the estimator under test is the refresh)
    x0 = np.random.default_rng(0).normal(size=(256, 3)) * np.sqrt(var)
    s.run_mcmc(700, jnp.asarray(x0, jnp.float32))
    im = np.asarray(s.final_state.inv_mass)            # [3] shared
    assert im[0] / im[2] > 1e2
    ratio = im / var
    assert np.all((ratio > 0.1) & (ratio < 10.0)), ratio


def test_leapfrog_cap_respected():
    """With ε pinned tiny and adaptation off, L_t must clip at
    max_leapfrog (and the clamp keeps the run finite-cost)."""
    lp = correlated_gaussian(MEAN, COV)
    cfg = chees.chees_config(step_size=1e-4, init_traj_length=10.0,
                             adapt_gens=0, max_leapfrog=8)
    step = chees.make_step(lp, cfg)
    state = chees.init(jnp.zeros((4, 2)), lp, cfg)
    _, info = jax.jit(lambda s: step(s, jax.random.key(0),
                                     jnp.int32(0)))(state)
    assert int(info.n_leapfrog) == 8


def test_escape_accept_from_out_of_support_start():
    """Repo sanitizer policy (hmc.py §22 finding #1): a finite proposal
    from a logp=-inf start escape-accepts instead of freezing."""
    lp = lambda th: jnp.where(th[0] > 0.0,
                              -0.5 * jnp.sum(th * th), -jnp.inf)
    s = bp.Chees(lp, n_chains=8, seed=4, step_size=0.3,
                 init_traj_length=1.0, adapt_gens=0, adapt_mass=False)
    x0 = -jnp.ones((8, 2))                             # out of support
    s.run_mcmc(300, x0)
    x = s.get_chain(flat=True)
    assert np.asarray(x)[-8:, 0].max() > 0.0           # escaped


def test_divergence_hard_rejects():
    """A cliff target produces non-finite trajectories; they must be
    rejected (diverged flagged, state retained finite)."""
    lp = lambda th: jnp.where(jnp.abs(th[0]) < 2.0,
                              -0.5 * jnp.sum(th * th),
                              2000.0 * th[0])          # gradient cliff
    cfg = chees.chees_config(step_size=2.0, init_traj_length=6.0,
                             adapt_gens=0, adapt_mass=False)
    step = chees.make_step(lp, cfg)
    state = chees.init(jnp.zeros((16, 2)), lp, cfg)

    def run(s):
        def body(c, k):
            s2, info = step(c, k, jnp.int32(0))
            return s2, info
        return jax.lax.scan(body, s,
                            jax.random.split(jax.random.key(5), 40))

    fs, info = jax.jit(run)(state)
    assert np.all(np.isfinite(np.asarray(fs.x)))
    assert np.all(np.isfinite(np.asarray(fs.logp)))


def test_mesh_equals_vmap():
    """Gather-then-reduce adaptation + identical RNG streams → the mesh
    run is bit-identical to the vmap run on the pinned config (16
    chains / 8 fake devices; the hmc.py cross-shape ulp caveat applies
    off this config)."""
    lp = correlated_gaussian(MEAN, COV)
    a = bp.Chees(lp, n_chains=16, seed=6, adapt_gens=100)
    a.run_mcmc(200, jnp.zeros(2), spread=1.0)
    b = bp.Chees(lp, n_chains=16, seed=6, adapt_gens=100,
                 mesh=chain_mesh())
    b.run_mcmc(200, jnp.zeros(2), spread=1.0)
    np.testing.assert_array_equal(a.super_chain, b.super_chain)
    np.testing.assert_array_equal(np.asarray(a.final_state.log_T_bar),
                                  np.asarray(b.final_state.log_T_bar))


def test_rhat_early_stop():
    s = bp.Chees(correlated_gaussian(MEAN, COV), n_chains=16, seed=7,
                 adapt_gens=200)
    info = s.run_mcmc_until(jnp.zeros(2), rhat_tol=1.1, chunk=100,
                            max_chunks=60, warmup_chunks=3)
    assert info["rhat"].max() < 1.1
    assert info["steps"] >= 300


def test_continuation_contract_warns():
    s = bp.Chees(correlated_gaussian(MEAN, COV), n_chains=8, seed=8,
                 adapt_gens=50)
    s.run_mcmc(100, jnp.zeros(2))
    with pytest.warns(UserWarning, match="IGNORED"):
        s.run_mcmc(50, jnp.zeros(2))
    assert s.get_chain().shape[1] == 150


def test_divergent_chain_does_not_poison_adaptation():
    """Regression: chain 0 starts out of support, so
    its gradient is NaN and its trajectory is non-finite EVERY warmup
    generation. Pre-fix, that one chain's gathered x1 row NaN'd the
    α-weighted proposal centre (0·NaN), the whole-population τ-gradient
    guard then zeroed every generation's signal, and T never left its
    ε-sized init. The sanitized criterion must keep adapting on the 31
    healthy chains."""
    lp = lambda th: jnp.where(th[0] > 0.0,
                              -0.5 * jnp.sum(th * th), -jnp.inf)
    x0 = np.ones((32, 3), np.float32)
    x0[0, 0] = -1.0                                    # off-support
    s = bp.Chees(lp, n_chains=32, seed=11, step_size=0.05,
                 adapt_gens=200, adapt_mass=False)
    s.run_mcmc(220, jnp.asarray(x0))
    assert s.trajectory_length > 0.2, s.trajectory_length


def test_continuation_and_checkpoint_roundtrip():
    """Split run == single run (continuation exactness), and the state
    pytree survives a checkpoint round-trip bit-exactly."""
    from bipymc_tpu.utils.checkpoint import save_state, load_state
    lp = correlated_gaussian(MEAN, COV)
    a = bp.Chees(lp, n_chains=4, seed=9, adapt_gens=50)
    a.run_mcmc(60, jnp.zeros(2))
    a.run_mcmc(40)                        # continuation, no warning
    b = bp.Chees(lp, n_chains=4, seed=9, adapt_gens=50)
    b.run_mcmc(100, jnp.zeros(2))
    np.testing.assert_array_equal(a.super_chain, b.super_chain)

    import tempfile, os
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "chees.npz")
        save_state(path, a.final_state, step=100)
        state, step = load_state(path)
        assert step == 100
        for l1, l2 in zip(jax.tree_util.tree_leaves(state),
                          jax.tree_util.tree_leaves(a.final_state)):
            np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))
