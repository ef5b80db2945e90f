"""Simulation-based calibration — the gold-standard sampler validator.

Beyond-reference extra (the reference validates samplers by moment
recovery on analytic targets; SURVEY.md §6). SBC (Talts, Betancourt,
Simpson, Vehtari, Gelman 2018) validates the *stationary distribution
itself*: draw θ̃ ~ prior, simulate y ~ p(y|θ̃), sample the posterior
p(θ|y) with the kernel under test, and rank θ̃ among M posterior draws.
Over K replications the rank is uniform on {0..M} **iff the sampler
targets the exact posterior** — any bias (wrong acceptance ratio, a
mis-scaled Jacobian, a broken proposal) shows up as a non-uniform rank
histogram, including biases that moment tests are blind to.

Accelerator shape: each replication is an independent (data, chain) pair, so
the whole study is ONE vmapped program — the functional core's
`make_step` closes over that replication's simulated data under the
outer vmap, and K replications × (burn + M·thin) steps run as a single
fixed-shape scan program on device. A key exactness property makes this
cheap: (θ̃, y) is a joint draw, so θ̃ | y is itself an *exact posterior
draw* — the chain starts in stationarity at θ̃ and ``burn`` only needs
to decorrelate from the start point, not find the typical set.

Kernels under test run FIXED (no adaptation: `adapt=False` for the RW
family; `adapt_gens=burn` for HMC so ε/mass freeze before the ranked
draws) — SBC validates the invariance of a fixed transition kernel,
which is the object ergodic theory speaks about.

Usage::

    ranks = sbc_ranks(prior_sample, simulate, log_post,
                      sampler="dram", cov=..., n_repl=256)
    stat, thresh = sbc_uniformity(ranks)     # chi² per dimension
    assert np.all(stat < thresh)
"""

import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from bipymc_tpu.samplers import chees as _chees
from bipymc_tpu.samplers import dream as _dream
from bipymc_tpu.samplers import hmc as _hmc
from bipymc_tpu.samplers import rw as _rw

_RW_KINDS = {
    "mh": dict(adapt=False, delayed=False),
    "dr": dict(adapt=False, delayed=True),
    # SBC runs fixed kernels — "dram" here means the DR proposal shape
    # with the user-supplied covariance (adaptation off; see module doc)
    "dram": dict(adapt=False, delayed=True),
    # the PRACTICAL headline kernel: Haario AM adaptation live through
    # the ranked draws (diminishing adaptation — same argument as the
    # demcz arm: SBC then validates the sampler users actually run)
    "dram-adaptive": dict(adapt=True, delayed=True),
}


def sbc_ranks(prior_sample: Callable, simulate: Callable,
              log_post: Callable, *, sampler: str = "dram",
              n_repl: int = 128, n_draws: int = 127, thin: int = 5,
              burn: int = 300, cov=None, step_size: float = 0.3,
              n_leapfrog: int = 8, n_chains: int = 8,
              spread: float = 1.0, seed: int = 0):
    """Rank statistics [n_repl, d] for the kernel under test.

    prior_sample: ``key -> theta [d]`` — one prior draw.
    simulate:     ``key, theta -> data`` (any pytree) — one dataset.
    log_post:     ``theta, data -> []`` — unnormalized log-posterior.
    sampler:      "mh" | "dr" | "dram" (fixed-covariance RW family),
                  "dram-adaptive" (AM covariance adaptation live —
                  validates the practical diminishing-adaptation chain),
                  "hmc" | "mala" (fixed ε after a ``burn``-long warmup),
                  or "chees" (an ``n_chains`` ChEES-HMC population per
                  replication — cross-chain ε/T/mass adaptation inside
                  ``burn``, frozen before the ranked draws; ranks from
                  chain 0, which starts exactly at θ̃),
                  or "demcz" (an ``n_chains`` DE-MC-z population per
                  replication, CR/outlier adaptation off; ranks come
                  from chain 0 so the M draws are marginally posterior
                  and thinned to near-independence — note the archive
                  still grows, so this validates the PRACTICAL
                  diminishing-adaptation sampler, which is the point).
    cov:          RW proposal covariance ([d] diag or [d,d]); default
                  2.38²/d × prior covariance estimated from 256 draws.
    n_draws:      M posterior draws per replication — ranks live on
                  {0..M}, so pick M+1 divisible by the histogram bins.
    thin:         steps between ranked draws (decorrelation; Talts §5.1).
    burn:         steps to decorrelate from the exact-posterior start θ̃.
    """
    key = jax.random.key(seed)
    k_cov, k_repl = jax.random.split(key)
    d = int(np.asarray(jax.eval_shape(
        prior_sample, jax.random.key(0)).shape)[-1])

    if sampler in _RW_KINDS:
        if cov is None:
            # prior-scaled default: s_d · Cov(prior) from a cheap draw
            th = jax.vmap(prior_sample)(
                jax.random.split(k_cov, 256))
            cov = (2.38 ** 2 / d) * jnp.cov(th.T).reshape(d, d)
        cfg = _rw.RwConfig(**_RW_KINDS[sampler])
    elif sampler in ("hmc", "mala"):
        base = _hmc.mala_config() if sampler == "mala" else \
            _hmc.hmc_config(n_leapfrog=n_leapfrog)
        cfg = base._replace(step_size=step_size, adapt_gens=burn)
    elif sampler == "demcz":
        cfg = _dream.demcz_config(n_chains)._replace(
            burnin_gens=0, adapt_cr=False, outlier_detect=False)
    elif sampler == "chees":
        # cross-chain adaptation lives inside ``burn`` and freezes
        # before the ranked draws (adapt_gens=burn, like hmc); the
        # n_chains population per replication supplies the criterion,
        # ranks come from chain 0, which STARTS exactly at theta_t
        cfg = _chees.chees_config(step_size=step_size, adapt_gens=burn)
    else:
        raise ValueError(f"unknown sampler kind {sampler!r}")

    def one_replication(k):
        k_prior, k_sim, k_run = jax.random.split(k, 3)
        theta_t = prior_sample(k_prior)
        data = simulate(k_sim, theta_t)
        lp = lambda th: log_post(th, data)

        if sampler in _RW_KINDS:
            state = _rw.init(theta_t, lp, jnp.asarray(cov, theta_t.dtype))
            step = _rw.make_step(lp, cfg)
            position = lambda s: s.theta
        elif sampler == "demcz":
            # fold index past any step index t — t stays < 2^31
            k_pop, k_arch = jax.random.split(
                jax.random.fold_in(k_run, jnp.uint32(2**32 - 1)))
            x0 = theta_t + spread * jax.random.normal(
                k_pop, (n_chains,) + theta_t.shape, theta_t.dtype)
            n_z0 = 2 * cfg.delta_max + 2
            z0 = theta_t + spread * jax.random.normal(
                k_arch, (n_z0,) + theta_t.shape, theta_t.dtype)
            capacity = n_z0 + n_chains * (
                (burn + n_draws * thin) // cfg.archive_thin + 1)
            state = _dream.init(x0, lp, cfg, capacity, z0)
            step = _dream.make_step(lp, cfg)
            position = lambda s: s.x[0]
        elif sampler == "chees":
            k_pop = jax.random.fold_in(k_run, jnp.uint32(2**32 - 1))
            x0 = theta_t + spread * jax.random.normal(
                k_pop, (n_chains,) + theta_t.shape, theta_t.dtype)
            x0 = x0.at[0].set(theta_t)      # exact-posterior start
            state = _chees.init(x0, lp, cfg)
            step = _chees.make_step(lp, cfg)
            position = lambda s: s.x[0]
        else:
            state = jax.tree_util.tree_map(
                lambda a: a[0], _hmc.init(theta_t[None], lp, cfg))
            batched = _hmc.make_step(lp, cfg)
            # the batched step takes ONE key and folds per chain itself
            step = lambda s, kk, t: jax.tree_util.tree_map(
                lambda a: a[0],
                batched(jax.tree_util.tree_map(lambda a: a[None], s),
                        kk, t))
            position = lambda s: s.x

        def advance(s, t):
            new_s, _info = step(s, jax.random.fold_in(k_run, t), t)
            return new_s, None

        s = lax.scan(advance, state, jnp.arange(burn, dtype=jnp.int32))[0]

        def draw_block(s, j):
            ts = burn + j * thin + jnp.arange(thin, dtype=jnp.int32)
            s = lax.scan(advance, s, ts)[0]
            return s, position(s) < theta_t

        _, below = lax.scan(draw_block, s,
                            jnp.arange(n_draws, dtype=jnp.int32))
        return jnp.sum(below.astype(jnp.int32), axis=0)   # [d] rank

    keys = jax.random.split(k_repl, n_repl)
    return jax.jit(jax.vmap(one_replication))(keys)


def sbc_uniformity(ranks, n_bins: int = 8, alpha: float = 1e-3,
                   n_draws: int | None = None):
    """Per-dimension χ² uniformity statistic over binned ranks.

    Returns ``(stat [d], threshold [])`` — under a calibrated sampler
    each stat ~ χ²(n_bins−1); ``threshold`` is the (1−alpha) quantile
    (Wilson–Hilferty approximation — no scipy dependency), so
    ``stat < threshold`` holds with probability 1−alpha per dimension.
    Pass the study's ``n_draws`` (M) so the rank support {0..M} bins
    exactly; pick M+1 divisible by ``n_bins`` for equal bin widths.
    """
    ranks = np.asarray(ranks)
    K, d = ranks.shape
    # ranks live on {0..M}: M+1 integer values
    m = (int(n_draws) if n_draws is not None else int(ranks.max())) + 1
    edges = np.linspace(0, m, n_bins + 1)
    stat = np.empty(d)
    expected = K / n_bins
    for j in range(d):
        counts, _ = np.histogram(ranks[:, j], bins=edges)
        stat[j] = np.sum((counts - expected) ** 2) / expected
    k = n_bins - 1
    # Wilson–Hilferty: χ²_k(1−α) ≈ k·(1 − 2/(9k) + z_{1−α}·√(2/(9k)))³
    z = math.sqrt(2.0) * _erfinv(1.0 - 2.0 * alpha)
    thresh = k * (1.0 - 2.0 / (9 * k) + z * math.sqrt(2.0 / (9 * k))) ** 3
    return stat, thresh


def _erfinv(x: float) -> float:
    return float(jax.scipy.special.erfinv(jnp.asarray(x, jnp.float64)
                                          if jax.config.jax_enable_x64
                                          else jnp.asarray(x)))
