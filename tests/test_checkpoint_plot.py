"""Checkpoint/resume exactness and plotting smoke tests (SURVEY.md §7.4)."""

import typing

import jax.numpy as jnp
import numpy as np

from bipymc_tpu import DreamZs, Dram
from bipymc_tpu.models.targets import correlated_gaussian
from bipymc_tpu.utils.checkpoint import (
    save_state, load_state, save_sampler, restore_sampler)
from bipymc_tpu.plotting import (
    plot_trace, plot_hist, plot_corner, plot_acceptance)

MEAN = jnp.array([1.0, -1.0])
COV = jnp.array([[1.0, 0.8], [0.8, 1.5]])


def test_checkpoint_roundtrip_state(tmp_path):
    lp = correlated_gaussian(MEAN, COV)
    s = DreamZs(lp, n_chains=8, seed=0)
    s.run_mcmc(100, MEAN, spread=2.0)
    path = tmp_path / "ck.npz"
    save_state(path, s.final_state, step=100)
    state, step = load_state(path)
    assert step == 100
    np.testing.assert_array_equal(np.asarray(state.x),
                                  np.asarray(s.final_state.x))
    np.testing.assert_array_equal(np.asarray(state.archive.buf),
                                  np.asarray(s.final_state.archive.buf))


def test_checkpoint_resume_is_exact(tmp_path):
    """resume(ck) then 100 gens ≡ continuous 200 gens, bit-for-bit."""
    lp = correlated_gaussian(MEAN, COV)
    full = DreamZs(lp, n_chains=8, seed=3)
    full.run_mcmc(200, MEAN, spread=2.0)

    first = DreamZs(lp, n_chains=8, seed=3)
    first.run_mcmc(100, MEAN, spread=2.0)
    path = tmp_path / "ck.npz"
    save_sampler(path, first)

    resumed = restore_sampler(path, DreamZs(lp, n_chains=8, seed=3))
    resumed.run_mcmc(100)
    np.testing.assert_array_equal(
        resumed.super_chain, full.super_chain[:, 100:, :])


def test_plots_smoke(tmp_path):
    lp = correlated_gaussian(MEAN, COV)
    s = Dram(lp, seed=0, n_chains=3)
    s.run_mcmc(300, MEAN, cov_est=COV)
    sc = s.super_chain
    assert plot_trace(sc, path=tmp_path / "t.png") is not None
    assert plot_hist(sc, truths=[1.0, -1.0], path=tmp_path / "h.png") is not None
    assert plot_corner(sc, path=tmp_path / "c.png") is not None
    assert plot_acceptance(s.acceptance_fraction,
                           path=tmp_path / "a.png") is not None
    for f in ["t.png", "h.png", "c.png", "a.png"]:
        assert (tmp_path / f).stat().st_size > 1000


def test_sbc_rank_plot_smoke(tmp_path):
    from bipymc_tpu.plotting import plot_sbc_ranks
    rng = np.random.default_rng(0)
    ranks = rng.integers(0, 128, size=(256, 3))
    fig = plot_sbc_ranks(ranks, n_draws=127, path=tmp_path / "sbc.png")
    assert fig is not None
    assert (tmp_path / "sbc.png").stat().st_size > 1000


def test_orbax_checkpoint_roundtrip(tmp_path):
    import jax
    import numpy as np
    import jax.numpy as jnp
    import bipymc_tpu as bp
    from bipymc_tpu.utils.checkpoint import (
        save_state_orbax, load_state_orbax)

    s = bp.DreamZs(lambda t: -0.5 * jnp.sum(t ** 2), n_chains=8, seed=0,
                   n_archive_init=16)
    s.run_mcmc(30, jnp.zeros(2))
    save_state_orbax(str(tmp_path / "ck"), s.final_state, step=30)
    st2, step = load_state_orbax(str(tmp_path / "ck"))
    assert step == 30
    assert type(st2).__name__ == "DreamState"
    for a, b in zip(jax.tree_util.tree_leaves(s.final_state),
                    jax.tree_util.tree_leaves(st2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_legacy_dream_checkpoint_migrates(tmp_path):
    """Round-2 added DreamState.cr_cum; 10-leaf checkpoints written before
    that must still restore exactly (cr_cum is derived from cr_p)."""
    import pickle
    import numpy as np
    import jax
    import jax.numpy as jnp
    from bipymc_tpu.models.targets import correlated_gaussian
    from bipymc_tpu.samplers import dream
    from bipymc_tpu.utils.checkpoint import load_state, save_state

    lp = correlated_gaussian(jnp.zeros(2), jnp.eye(2))
    cfg = dream.DreamConfig(n_chains=8)
    x0 = jnp.asarray(np.random.default_rng(0).normal(size=(8, 2)),
                     jnp.float32)
    state = dream.init(x0, lp, cfg, archive_capacity=64, z0=x0)
    path = str(tmp_path / "legacy.npz")
    save_state(path, state, step=7)

    # rewrite the file as the OLD 10-leaf layout (drop leaf 6 == cr_cum)
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    leaves, treedef = jax.tree_util.tree_flatten(state)
    assert len(leaves) == 11
    old = {}
    j = 0
    for i in range(11):
        if i == 6:
            continue                      # cr_cum's flat position
        old[f"leaf_{j}"] = arrays[f"leaf_{i}"]
        j += 1
    old["__treedef__"] = arrays["__treedef__"]   # unflatten fails -> migrate
    old["__step__"] = arrays["__step__"]
    np.savez(path, **old)

    restored, step = load_state(path)
    assert step == 7
    np.testing.assert_array_equal(np.asarray(restored.x),
                                  np.asarray(state.x))
    np.testing.assert_allclose(np.asarray(restored.cr_cum),
                               np.asarray(state.cr_cum), rtol=1e-6)


class _NotADreamState(typing.NamedTuple):
    DreamState_lookalike: object    # field name puts the string in repr
    b: object


def test_checkpoint_schema_tag(tmp_path):
    """Checkpoints carry an explicit class:version tag; migration keys on
    it (or, for pre-tag files, the exact treedef root class) — a foreign
    10-leaf state whose repr mentions DreamState must NOT migrate."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import pytest
    from bipymc_tpu.models.targets import correlated_gaussian
    from bipymc_tpu.samplers import dream
    from bipymc_tpu.utils.checkpoint import load_state, save_state

    lp = correlated_gaussian(jnp.zeros(2), jnp.eye(2))
    state = dream.init(jnp.zeros((8, 2)), lp, dream.DreamConfig(n_chains=8),
                       archive_capacity=64, z0=jnp.zeros((8, 2)))
    path = str(tmp_path / "tagged.npz")
    save_state(path, state, step=3)
    with np.load(path, allow_pickle=False) as data:
        assert data["__schema__"].tobytes().decode() == "DreamState:v2"

    # a 10-leaf tuple state with 'DreamState' in its repr: the old
    # substring heuristic would have mis-migrated it; now it raises
    decoy = _NotADreamState(tuple(jnp.zeros(2) for _ in range(9)),
                            jnp.zeros(2))
    assert "DreamState" in str(jax.tree_util.tree_structure(decoy))
    assert len(jax.tree_util.tree_leaves(decoy)) == 10
    dpath = str(tmp_path / "decoy.npz")
    save_state(dpath, decoy, step=0)
    # strip the tag AND break the layout to force the legacy-fallback path
    with np.load(dpath, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files if k != "__schema__"}
    del arrays["leaf_9"]
    np.savez(dpath, **arrays)
    with pytest.raises((TypeError, ValueError)):
        load_state(dpath)


def test_plot_mode_occupancy(tmp_path):
    import jax
    from bipymc_tpu.plotting import plot_mode_occupancy
    means = np.asarray([[0.0, 0.0], [10.0, 0.0]], np.float32)
    hist = np.random.default_rng(0).normal(
        size=(8, 50, 2)).astype(np.float32)
    hist[4:] += means[1]
    fig = plot_mode_occupancy(hist, means, path=tmp_path / "occ.png")
    assert fig is not None
    assert (tmp_path / "occ.png").stat().st_size > 1000


def test_checkpoint_extensionless_path_roundtrip(tmp_path):
    """np.savez appends .npz to extensionless paths; load_state must
    mirror that so save_state('ckpt')/load_state('ckpt') round-trips."""
    from bipymc_tpu.utils.checkpoint import save_state, load_state
    state = {"a": jnp.arange(4.0), "b": jnp.ones((2, 2))}
    p = str(tmp_path / "ckpt")            # no .npz
    save_state(p, state, step=7)
    loaded, step = load_state(p)
    assert step == 7
    np.testing.assert_array_equal(np.asarray(loaded["a"]),
                                  np.asarray(state["a"]))


def test_plot_rank(tmp_path):
    """Rank plots: uniform for iid chains; a stuck chain's histogram
    piles into the low bins (its draws occupy the bottom of the pooled
    ranking)."""
    from bipymc_tpu.plotting import plot_rank
    rng = np.random.default_rng(0)
    good = rng.normal(0, 1, (4, 400, 2))
    fig = plot_rank(good, labels=["a", "b"], path=tmp_path / "rank.png")
    assert fig is not None and (tmp_path / "rank.png").exists()
    # stuck chain: chain 0 sits 5 sigma low in dim 0
    bad = good.copy()
    bad[0, :, 0] -= 5.0
    fig2 = plot_rank(bad)
    # chain 0 / dim 0 axis: nearly all mass in the lowest quarter of the
    # rank bins (the first 20 patches are the hist bars; the axhspan
    # band patch comes after them)
    ax = fig2.axes[0]
    n_bins = 20
    heights = [p.get_height() for p in ax.patches[:n_bins]]
    low = sum(heights[: n_bins // 4])
    assert low >= 0.9 * sum(heights)


def test_plot_geweke(tmp_path):
    from bipymc_tpu.plotting import plot_geweke
    rng = np.random.default_rng(3)
    chains = rng.normal(0, 1, (4, 600, 2))
    fig = plot_geweke(chains, labels=["a", "b"],
                      path=tmp_path / "geweke.png")
    assert fig is not None and (tmp_path / "geweke.png").exists()


def test_plot_short_labels_no_indexerror(tmp_path):
    """A labels list shorter than d must fall back to θj, not
    IndexError — in every plot kind that takes labels."""
    from bipymc_tpu.plotting import (
        plot_geweke, plot_rank, plot_sbc_ranks)
    rng = np.random.default_rng(1)
    chains = rng.normal(0, 1, (3, 200, 3))
    short = ["only-one"]
    assert plot_trace(chains, labels=short,
                      path=tmp_path / "t.png") is not None
    assert plot_hist(chains, labels=short,
                     path=tmp_path / "h.png") is not None
    assert plot_corner(chains, labels=short,
                       path=tmp_path / "c.png") is not None
    assert plot_geweke(chains, labels=short,
                       path=tmp_path / "g.png") is not None
    assert plot_rank(chains, labels=short,
                     path=tmp_path / "r.png") is not None
    ranks = rng.integers(0, 64, size=(64, 3))
    assert plot_sbc_ranks(ranks, n_draws=63, labels=short,
                          path=tmp_path / "s.png") is not None
