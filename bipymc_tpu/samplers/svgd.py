"""Stein variational gradient descent (SVGD).

Beyond-reference extra (SURVEY.md §3 lists no variational/particle-flow
method): deterministic particle inference by functional gradient descent
on the KL divergence in the RKHS of an RBF kernel (Liu & Wang 2016,
"Stein Variational Gradient Descent: A General Purpose Bayesian
Inference Algorithm"). Each update transports the whole particle set

    x_i ← x_i + lr · φ(x_i),
    φ(x_i) = (1/N) Σ_j [ k(x_j, x_i) ∇_{x_j} log p(x_j)
                         + ∇_{x_j} k(x_j, x_i) ],

with the RBF kernel k(x, y) = exp(−‖x−y‖² / (2h²)) and the paper's
median-trick bandwidth 2h² = median(‖x_i−x_j‖²) / log(N+1), stepped by
the paper's AdaGrad-with-momentum rule.

Why it earns a place in this zoo, accelerator-first: the update is ONE [N,N]
kernel-matrix build (the same centered ‖·‖² decomposition the GP module
uses — ops/distance.pairwise_sqdist) plus two
[N,N]×[N,d] matmuls and a batch of target gradients (`jax.value_and_grad`
of the same ``log_prob`` every sampler here consumes — including the
differentiable GP surrogate). No acceptance step, no rejection waste, no
RNG after init: the entire run is a deterministic `lax.scan` of dense
linear algebra, which is as accelerator-native as an inference
algorithm gets.
Where MCMC prices its answer in autocorrelation, SVGD prices it in
particle count: N particles are N quadrature points of the posterior,
useful as a fast approximate posterior, a warm-start population for the
MCMC families, or a mode-finding swarm (it preserves multiple modes at
moderate separation — see the honesty note below).

Honesty notes, measured/known failure modes stated plainly:

- **Far-separated modes collapse.** The attractive term k·∇logp decays
  with the kernel; for modes ≫ bandwidth apart the particles in each
  basin feel only their own basin plus the repulsion, and the mode
  WEIGHTS freeze near their init fractions (SVGD has no between-mode
  transport mechanism — the same structural issue DE jumps have at
  d=100). On such targets use Smc (mode weights +
  evidence) or ParallelTempering; SVGD's lane is unimodal-ish targets
  and fast approximate posteriors.
- **Variance underestimation in high d** (the well-documented SVGD
  pathology): with N ≪ exp(d) the repulsive term cannot hold the
  particle cloud at full posterior width; moments tests here run at
  d ≤ 8 where N=256..1024 particles resolve the geometry.

Sharding contract (mesh=): the particle axis shards; target gradients
(the dominant cost for expensive likelihoods, e.g. the GP surrogate)
are evaluated shard-locally, positions/gradients are all_gathered once
per step, and the kernel/bandwidth DECISION math runs replicated on the
gathered arrays (the gather-then-reduce rule) — the
median bandwidth is bit-identical to the vmap run by construction. The
per-shard φ row-block matmuls may round ~1 ulp differently from the
full-batch vmap program (the house cross-shape FMA floor); pinned
tolerance in tests/test_svgd.py.
"""

import warnings
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from bipymc_tpu.ops.distance import pairwise_sqdist
from bipymc_tpu.parallel.collectives import (all_gather_chains,
                                             chain_offset)


class SvgdConfig(NamedTuple):
    """Static configuration.

    n_particles: particle count N.
    step_size: AdaGrad base learning rate (the paper's default 1e-2 is
        conservative; 0.05–0.5 works on standardized targets).
    bandwidth: RBF bandwidth parameter — the value of 2h² directly, or
        0 (default) for the median trick recomputed EVERY step
        (2h² = median sqdist / log(N+1), the adaptive form in the
        reference implementation).
    alpha: AdaGrad momentum (EMA factor on the squared-gradient
        accumulator; paper default 0.9).
    fudge: AdaGrad denominator floor (paper default 1e-6).
    """

    n_particles: int = 256
    step_size: float = 0.05
    bandwidth: float = 0.0
    alpha: float = 0.9
    fudge: float = 1e-6


class SvgdState(NamedTuple):
    x: jax.Array     # [n, d] particle positions (local rows under mesh)
    hist: jax.Array  # [n, d] AdaGrad squared-gradient accumulator
    t: jax.Array     # [] int32 step counter


class SvgdInfo(NamedTuple):
    phi_rms: jax.Array    # [] RMS of the update field φ (convergence
                          #    diagnostic: φ → 0 at the fixed point)
    bandwidth: jax.Array  # [] 2h² used this step
    grad_rms: jax.Array   # [] RMS of ∇ log p over particles


def init(x0: jax.Array) -> SvgdState:
    """Initial state from [n_particles, d] starting positions."""
    x0 = jnp.asarray(x0)
    if x0.ndim != 2:
        raise ValueError("x0 must be [n_particles, d]")
    return SvgdState(x=x0, hist=jnp.zeros_like(x0),
                     t=jnp.zeros((), jnp.int32))


def make_step(log_prob: Callable, cfg: SvgdConfig,
              axis_name=None) -> Callable:
    """Build the (deterministic) ``step(state) -> (state, info)``.

    Particle axis on axis 0; with ``axis_name`` the state holds this
    shard's rows and the step runs under ``jax.shard_map``.
    """
    grad_fn = jax.grad(log_prob)
    if cfg.bandwidth < 0:
        raise ValueError("bandwidth must be >= 0 (0 = median trick)")

    def step(s: SvgdState):
        n_local, d = s.x.shape
        dtype = s.x.dtype
        g_local = jax.vmap(grad_fn)(s.x)
        # out-of-support particles contribute no attraction (their
        # gradient is undefined); the repulsion still moves them back
        # toward the cloud — the repo-wide non-finite sanitizer policy
        g_local = jnp.where(jnp.isfinite(g_local), g_local, 0.0)

        x_all = all_gather_chains(s.x, axis_name)      # [N, d]
        g_all = all_gather_chains(g_local, axis_name)  # [N, d]
        n_total = x_all.shape[0]
        nf = jnp.asarray(n_total, dtype)

        # replicated decision math on the gathered arrays (gather-then-
        # reduce): every shard computes the SAME full sqdist + median,
        # so the bandwidth is bit-identical to the vmap run
        sqd = pairwise_sqdist(x_all).astype(dtype)     # [N, N]
        if cfg.bandwidth > 0:
            h2 = jnp.asarray(cfg.bandwidth, dtype)     # = 2h² directly
        else:
            # paper's median trick over the full squareform matrix
            # (diagonal zeros included, matching the reference code);
            # the log(N+1) scaling keeps Σ_j k(x_j,·) ≈ O(N/log N)
            h2 = jnp.median(sqd) / jnp.log(nf + 1.0)
            # degenerate cloud (all particles coincident): any positive
            # value gives k=1 rows and pure mean-gradient transport
            h2 = jnp.maximum(h2, jnp.asarray(1e-12, dtype))

        offset = chain_offset(n_local, axis_name)
        # this shard's kernel rows, sliced from the replicated matrix so
        # the values are the vmap path's exactly
        k_rows = lax.dynamic_slice_in_dim(sqd, offset, n_local, axis=0)
        k_rows = jnp.exp(-k_rows / h2)                 # [n_local, N]

        # φ rows: attraction K@G plus repulsion Σ_j ∇_{x_j}k =
        # (2/h2)·(x_i·Σ_j K_ij − K@X)
        ksum = jnp.sum(k_rows, axis=1, keepdims=True)  # [n_local, 1]
        attract = k_rows @ g_all                       # matmul
        repulse = (s.x * ksum - k_rows @ x_all) * (2.0 / h2)
        phi = (attract + repulse) / nf                 # [n_local, d]

        # AdaGrad with momentum, exactly the reference update: the first
        # step seeds the accumulator with φ² outright
        first = s.t == 0
        hist = jnp.where(first, phi * phi,
                         cfg.alpha * s.hist + (1.0 - cfg.alpha) * phi * phi)
        x_new = s.x + cfg.step_size * phi / (cfg.fudge + jnp.sqrt(hist))

        # diagnostics are GLOBAL RMS values — computed from per-shard
        # partials would differ across paths, so reduce the gathered way:
        # φ itself is shard-local, gather it (cheap: [N, d])
        phi_all = all_gather_chains(phi, axis_name)
        info = SvgdInfo(
            phi_rms=jnp.sqrt(jnp.mean(phi_all * phi_all)),
            bandwidth=h2,
            grad_rms=jnp.sqrt(jnp.mean(g_all * g_all)))
        return SvgdState(x=x_new, hist=hist, t=s.t + 1), info

    return step


def make_runner(log_prob: Callable, cfg: SvgdConfig, n_steps: int,
                axis_name=None) -> Callable:
    """``runner(state) -> (state, SvgdInfo[n_steps])`` scanning the
    deterministic step; jit (or shard_map) is applied by the caller."""
    step = make_step(log_prob, cfg, axis_name=axis_name)

    def runner(state: SvgdState):
        def body(s, _):
            return step(s)
        return lax.scan(body, state, None, length=n_steps)

    return runner


# ChainPool-style sharding spec: every field with a particle axis
SHARDED_FIELDS = ("x", "hist")


def svgd_config(**kw) -> SvgdConfig:
    return SvgdConfig(**kw)
