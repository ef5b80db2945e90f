"""Chain plotting helpers.

Reference capability (SURVEY.md §3 "Plotting", `bipymc/mc_plot.py` [U]):
trace plots, marginal histograms, pairwise/corner plots, acceptance
diagnostics. matplotlib is imported lazily (Agg backend) so headless
jobs without display never pay for it.

All functions accept ``chains`` as [M, N, d] (``sampler.super_chain``) or
[N, d] and return the matplotlib Figure.
"""

import numpy as np


def _mpl():
    try:
        import matplotlib
    except ImportError:
        raise ImportError("bipymc_tpu.plotting needs the optional "
                          "matplotlib package") from None
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _as3d(chains):
    chains = np.asarray(chains)
    if chains.ndim == 2:
        chains = chains[None, ...]
    return chains


def _lbl(labels, j, suffix=""):
    """Label for dimension j, falling back to θj when ``labels`` is
    None or shorter than j+1 (a too-short list must not IndexError —
    ADVICE round 3/4)."""
    if labels is not None and j < len(labels):
        return labels[j]
    return f"θ{j}{suffix}"


def plot_trace(chains, labels=None, path=None):
    """Per-dimension trace plots, one line per chain."""
    plt = _mpl()
    chains = _as3d(chains)
    m, n, d = chains.shape
    fig, axes = plt.subplots(d, 1, figsize=(8, 2.2 * d), squeeze=False,
                             sharex=True)
    for j in range(d):
        ax = axes[j, 0]
        for i in range(m):
            ax.plot(chains[i, :, j], lw=0.5, alpha=0.7)
        ax.set_ylabel(_lbl(labels, j))
    axes[-1, 0].set_xlabel("step")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_hist(chains, labels=None, bins=60, path=None, truths=None):
    """Marginal histograms pooled over chains."""
    plt = _mpl()
    chains = _as3d(chains)
    d = chains.shape[-1]
    flat = chains.reshape(-1, d)
    fig, axes = plt.subplots(1, d, figsize=(3.2 * d, 3.0), squeeze=False)
    for j in range(d):
        ax = axes[0, j]
        ax.hist(flat[:, j], bins=bins, density=True, alpha=0.8)
        if truths is not None:
            ax.axvline(truths[j], color="k", ls="--", lw=1)
        ax.set_xlabel(_lbl(labels, j))
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_corner(chains, labels=None, bins=50, path=None, truths=None):
    """Corner-style pairwise plot: marginals on the diagonal, 2-D
    histograms below."""
    plt = _mpl()
    chains = _as3d(chains)
    d = chains.shape[-1]
    flat = chains.reshape(-1, d)
    fig, axes = plt.subplots(d, d, figsize=(2.4 * d, 2.4 * d),
                             squeeze=False)
    for i in range(d):
        for j in range(d):
            ax = axes[i, j]
            if j > i:
                ax.axis("off")
                continue
            if i == j:
                ax.hist(flat[:, i], bins=bins, density=True, alpha=0.8)
                if truths is not None:
                    ax.axvline(truths[i], color="k", ls="--", lw=1)
            else:
                ax.hist2d(flat[:, j], flat[:, i], bins=bins, cmap="viridis")
                if truths is not None:
                    ax.plot(truths[j], truths[i], "w+", ms=10)
            if i == d - 1:
                ax.set_xlabel(_lbl(labels, j))
            if j == 0 and i > 0:
                ax.set_ylabel(_lbl(labels, i))
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_autocorr(chains, max_lag=100, path=None):
    """Autocorrelation ρ_t per dimension (averaged over chains), with the
    integrated autocorrelation time in the legend."""
    plt = _mpl()
    from bipymc_tpu.utils.diagnostics import (
        autocorr_fn, integrated_autocorr_time)
    chains = _as3d(chains)
    d = chains.shape[-1]
    tau = float(integrated_autocorr_time(chains))
    fig, ax = plt.subplots(figsize=(6, 3.5))
    for j in range(d):
        rho = np.asarray(autocorr_fn(chains[..., j:j + 1], max_lag=max_lag))
        ax.plot(rho, lw=1, label=f"θ{j}")
    ax.axhline(0.0, color="k", lw=0.5)
    ax.set_xlabel("lag")
    ax.set_ylabel("ρ")
    ax.set_title(f"integrated autocorr time τ ≈ {tau:.1f}")
    if d <= 8:
        ax.legend()
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_geweke(chains, labels=None, path=None):
    """Geweke drift z-scores per chain × dimension (utils.diagnostics.
    geweke), with ±2 reference bands — the visual within-chain
    stationarity check: a chain still in transient shows |z| ≫ 2 while
    split-R̂ over many converged chains can stay near 1."""
    plt = _mpl()
    from bipymc_tpu.utils.diagnostics import geweke
    chains = _as3d(chains)
    z = np.asarray(geweke(chains))                    # [M, d]
    m, d = z.shape
    fig, ax = plt.subplots(figsize=(6, 3.5))
    for j in range(d):
        ax.plot(np.arange(m), z[:, j], "o", ms=4, label=_lbl(labels, j))
    ax.axhspan(-2.0, 2.0, color="g", alpha=0.15, label="|z| < 2")
    ax.axhline(0.0, color="k", lw=0.5)
    ax.set_xlabel("chain")
    ax.set_ylabel("Geweke z")
    if d <= 8:
        ax.legend(ncol=2, fontsize=8)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_acceptance(accept_fractions, path=None):
    """Bar chart of per-chain acceptance fractions."""
    plt = _mpl()
    af = np.asarray(accept_fractions)
    fig, ax = plt.subplots(figsize=(6, 3))
    ax.bar(np.arange(af.size), af)
    ax.axhspan(0.1, 0.5, color="g", alpha=0.15, label="healthy RW band")
    ax.set_xlabel("chain")
    ax.set_ylabel("acceptance fraction")
    ax.legend()
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_mode_occupancy(history, means, path=None):
    """Chains-per-mode over time for a mixture run (round-3 honesty
    diagnostics): a stacked occupancy trace makes a
    population silently collapsing into one basin visible at a glance.

    history: [M, T, d] kept positions; means: [k, d] mode centres.
    """
    plt = _mpl()
    from bipymc_tpu.utils.diagnostics import nearest_mode
    import jax.numpy as jnp
    hist = np.asarray(history)
    means = np.asarray(means)
    idx = np.asarray(nearest_mode(jnp.asarray(hist), jnp.asarray(means)))
    k = means.shape[0]
    # [T, k] occupancy counts over time
    occ = np.stack([(idx == j).sum(axis=0) for j in range(k)], axis=1)
    fig, ax = plt.subplots(figsize=(6, 3.5))
    ax.stackplot(np.arange(occ.shape[0]), occ.T,
                 labels=[f"mode {j}" for j in range(k)], alpha=0.8)
    ax.axhline(hist.shape[0] / k, color="k", lw=0.8, ls="--",
               label="equal share")
    ax.set_xlabel("kept generation")
    ax.set_ylabel("chains in mode")
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_sbc_ranks(ranks, n_draws=None, n_bins=8, labels=None, path=None):
    """SBC rank histograms with a 99% uniform band (utils/sbc.py): calibrated
    kernels fill the band flat; a ∪
    shape means the sampled posterior is too narrow, a ∩ shape too wide,
    a slope means biased location.

    ranks: [K, d] from ``sbc_ranks``; pass the study's ``n_draws`` so
    the support {0..M} bins exactly.
    """
    plt = _mpl()
    ranks = np.asarray(ranks)
    K, d = ranks.shape
    m = (int(n_draws) if n_draws is not None else int(ranks.max())) + 1
    edges = np.linspace(0, m, n_bins + 1)
    expected = K / n_bins
    # pointwise 99% band for a Binomial(K, 1/n_bins) bin count (normal
    # approximation — the same envelope Talts et al. draw)
    half = 2.576 * np.sqrt(K * (1 / n_bins) * (1 - 1 / n_bins))
    fig, axes = plt.subplots(1, d, figsize=(3.0 * d, 2.8), squeeze=False)
    for j in range(d):
        ax = axes[0, j]
        ax.hist(ranks[:, j], bins=edges, color="C0", alpha=0.85)
        ax.axhspan(expected - half, expected + half, color="k", alpha=0.12,
                   label="99% band" if j == 0 else None)
        ax.axhline(expected, color="k", lw=0.8, ls="--")
        ax.set_xlabel(_lbl(labels, j, suffix=" rank"))
        if j == 0:
            ax.set_ylabel(f"count / {K} repl")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_rank(chains, labels=None, n_bins=20, max_chains=8, path=None):
    """Per-chain rank histograms (Vehtari et al. 2021 §4 "rank plots") —
    the visual companion to ``rank_normalized_rhat``/``ess_bulk``.

    Pool every chain's draws per dimension, rank them jointly, and
    histogram each chain's OWN ranks: well-mixed chains are uniform over
    the pooled ranks; a chain stuck low/high shows as a tilted or
    shifted histogram long before split-R̂ crosses a threshold. The 99%
    band is the pointwise Binomial(N, 1/n_bins) envelope, same
    convention as :func:`plot_sbc_ranks`.

    chains: [M, N, d] (``sampler.super_chain``) or [N, d]. Rows are
    chains (first ``max_chains`` shown), columns dimensions.
    """
    plt = _mpl()
    chains = _as3d(chains)
    m_all, n, d = chains.shape
    m = min(m_all, int(max_chains))
    edges = np.linspace(0, m_all * n, n_bins + 1)
    expected = n / n_bins
    half = 2.576 * np.sqrt(n * (1 / n_bins) * (1 - 1 / n_bins))
    fig, axes = plt.subplots(m, d, figsize=(3.0 * d, 1.6 * m),
                             squeeze=False, sharex=True, sharey=True)
    for j in range(d):
        flat = chains[:, :, j].reshape(-1)
        # rank of every pooled draw (continuous draws: ties negligible)
        ranks = np.empty(flat.size, dtype=np.int64)
        ranks[np.argsort(flat, kind="stable")] = np.arange(flat.size)
        ranks = ranks.reshape(m_all, n)
        for i in range(m):
            ax = axes[i, j]
            ax.hist(ranks[i], bins=edges, color=f"C{i % 10}", alpha=0.85)
            ax.axhspan(expected - half, expected + half, color="k",
                       alpha=0.12)
            ax.axhline(expected, color="k", lw=0.8, ls="--")
            if j == 0:
                ax.set_ylabel(f"chain {i}", fontsize=8)
            if i == 0:
                ax.set_title(_lbl(labels, j), fontsize=9)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig
