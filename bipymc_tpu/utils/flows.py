"""Normalizing-flow transport: RealNVP coupling flows fit to posterior
draws, for flow-preconditioned MCMC.

Beyond-reference extra (SURVEY.md §3 lists no density-model component).
Two compositions, both accelerator-native (the flow is nothing but small
matmuls + elementwise maps — exactly what an accelerator eats):

1. **NeuTra reparameterization** (Hoffman et al. 2019): ``as_transform``
   wraps the fitted flow in the package's `Transform` interface, so
   ``bp.transform_log_prob(log_prob, flow_transform(params))`` hands ANY
   sampler in the zoo a whitened target — the flow absorbs the
   geometry (funnel necks, banana curvature) that collapses RW/HMC
   step sizes.
2. **Flow global moves** (Gabrié, Rotskoff & Vanden-Eijnden 2022;
   Wong, Gabrié & Foreman-Mackey 2023 "flowMC"): ``log_q`` +
   ``sample`` give an independence MH proposal with full-space support
   — the mode-hopping channel the DE/archive family lacks at scale
   (measured 2.8e-5 hops/chain-gen at d=100;
   a flow trained on a stratified population proposes cross-mode jumps
   with O(acceptance-rate) frequency instead). See
   ``samplers/flowmh.py``.

Design — coupling layers with alternating-parity binary masks m_i.
Two coupling families (``FlowConfig.coupling``):

- ``"affine"`` (Dinh, Sohl-Dickstein & Bengio 2017): layer i maps

      y = m·x + (1−m)·(x·exp(s(m·x)) + t(m·x)),

  with (s, t) from one small MLP (zero-initialized final layer → every
  layer starts as the identity), s soft-clamped to ±``s_cap`` through
  tanh so one bad training step cannot blow the scale up irrecoverably.
  log|det| = Σ (1−m)·s, exact in both directions.
- ``"rqs"`` (round 4 — Durkan et al. 2019 "Neural Spline Flows"): each
  free dimension gets a K-bin monotonic rational-quadratic spline on
  [−B, B] (identity linear tails, C¹ at ±B), parameterized by the same
  conditioner MLP. Forward AND inverse are closed-form (the inverse's
  quadratic root gets a Newton polish for f32 accuracy); log|det| is
  analytic. Zero-init gives exactly the identity. Splines represent
  multimodal/warped CONDITIONALS directly — the structural limitation
  of affine maps.

f32 conditioning note (measured, both families): a DEEP stack's
u-domain preimage is ill-conditioned wherever a layer is flat — error
~ y-resolution/slope, amplified by later conditioners (~25×/layer with
extreme random weights; the affine family's bound is exp(s_cap)/layer).
Trained flows sit in the moderate-slope regime where round-trips hold
to ~1e-4; the proposal path never relies on the inverse for its OWN
samples (forward-priced — `flow_proposal`).

Measured global-move acceptance (d=16, 4 modes, 20k IID training
draws): affine acceptance
0.55, rqs 0.37 (0.44 at n_bins=4), EM-GMM 0.83. Acceptance is monotone
in HELD-OUT NLL across a 12-arm capacity/training sweep (Spearman
−0.944): the RQS head's ~11× parameter count overfits modest draw
counts harder, and over-training inverts the ranking (affine at 6k
steps falls to 0.23, below default rqs). For fitted independence
proposals, parameter efficiency IS acceptance — hence the GMM default
(README demotion stands; flows are the tool for warped basins and
NeuTra reparameterization, and prefer n_bins=4 at ≲10⁵ draws). A
measured "flow collapse to ~4e-4 at d=16" was dominated by
TRAINING-DATA quality (autocorrelated explore history), not the
family.

An outer fixed affine layer standardizes to the training draws'
per-dimension mean/std (computed once at fit time, NOT trained — the
coupling nets then work at unit scale regardless of the target's
units).

Conventions: the GENERATIVE direction is ``forward`` (latent u → θ),
matching `utils/transforms.Transform`; base density is N(0, I_d).
Everything broadcasts over leading batch axes and jits; training is
one `lax.scan` of full-batch (or minibatched) Adam steps with the
house non-finite-step-rejection policy (same as `gp.optimize` /
`Advi` — a NaN loss keeps params and moments instead of poisoning the
scan).

Training objective is the forward KL on draws you already have
(maximum likelihood): draws from a short exploratory run — stratified
DREAM-zs history, SMC particles, an SVGD cloud — are exactly the
"data" the flow needs, and this package exists to make such draws
cheap. No reverse-KL/ELBO option: on multimodal targets reverse KL is
mode-seeking (it would defeat the global-move use case).
"""

import math
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from bipymc_tpu.utils.proposals import Proposal
from bipymc_tpu.utils.transforms import Transform


class FlowConfig(NamedTuple):
    """Static flow architecture + training configuration.

    n_layers: coupling layers (alternating parity masks).
    hidden: MLP width for the coupling nets.
    n_hidden: number of hidden MLP layers (≥1).
    s_cap: soft clamp on the per-dimension log-scale output (affine).
    step_size: Adam learning rate.
    n_steps: Adam steps for ``fit_flow``.
    batch_size: minibatch size per step; 0 = full batch (default —
        posterior-draw sets are small and the full-batch step is one
        fused device program).
    coupling: ``"affine"`` (RealNVP — Dinh 2017) or ``"rqs"``
        (monotonic rational-quadratic splines — Durkan et al. 2019
        "Neural Spline Flows"). Round-3 measured the affine coupling's
        independence-MH acceptance collapsing to ~4e-4 at d=16 on a
        4-mode target: an affine map of a unimodal conditional stays
        unimodal, so multimodal structure must be carried entirely by
        the conditioning — K-bin splines represent multimodal
        conditionals DIRECTLY (each free dimension gets an arbitrary
        monotone piecewise-rational map), which is what modern flowMC
        practice uses on multimodal posteriors.
    n_bins: spline bins K per dimension (rqs only).
    tail_bound: the spline acts on [−B, B] in standardized units and is
        the identity outside (linear tails, C¹ at ±B) — full-space
        support, exact density everywhere (rqs only).
    """

    n_layers: int = 8
    hidden: int = 64
    n_hidden: int = 2
    s_cap: float = 4.0
    step_size: float = 1e-3
    n_steps: int = 2000
    batch_size: int = 0
    coupling: str = "affine"
    n_bins: int = 8
    tail_bound: float = 4.0


def flow_config(**kw) -> FlowConfig:
    cfg = FlowConfig(**kw)
    if cfg.n_layers < 1:
        raise ValueError("n_layers must be >= 1")
    if cfg.n_hidden < 1:
        raise ValueError("n_hidden must be >= 1")
    if cfg.s_cap <= 0:
        raise ValueError("s_cap must be > 0")
    if cfg.coupling not in ("affine", "rqs"):
        raise ValueError("coupling must be 'affine' or 'rqs'")
    if cfg.n_bins < 2:
        raise ValueError("n_bins must be >= 2")
    if cfg.tail_bound <= 0:
        raise ValueError("tail_bound must be > 0")
    return cfg


class FlowParams(NamedTuple):
    """Fitted flow. ``layers`` is the trainable pytree (tuple of
    per-layer MLP weight dicts); ``mu``/``sigma`` are the FIXED outer
    standardization affine ([d] each, from the training draws)."""

    layers: tuple
    mu: jax.Array
    sigma: jax.Array


def _mask(d: int, i: int, dtype) -> jax.Array:
    """Alternating parity mask for layer i: even layers freeze even
    dims, odd layers freeze odd dims (static — recomputed, not stored,
    so it can never ride a gradient)."""
    return jnp.asarray((np.arange(d) % 2) == (i % 2), dtype)


def _out_width(d, cfg):
    """Final MLP width: (s, t) for affine; (K widths, K heights, K−1
    interior derivatives) per dimension for rqs."""
    if cfg.coupling == "rqs":
        return d * (3 * cfg.n_bins - 1)
    return 2 * d


def _layer_init(key, d, cfg, dtype):
    widths = [d] + [cfg.hidden] * cfg.n_hidden + [_out_width(d, cfg)]
    keys = jax.random.split(key, len(widths) - 1)
    ws, bs = [], []
    for k, fan_in, fan_out in zip(keys, widths[:-1], widths[1:]):
        ws.append(jax.random.normal(k, (fan_in, fan_out), dtype)
                  / math.sqrt(fan_in))
        bs.append(jnp.zeros((fan_out,), dtype))
    # zero-init the FINAL layer: s = t = 0 → the coupling starts as the
    # identity and logdet starts at 0 (standard RealNVP practice; the
    # flow at init is exactly the outer standardization affine)
    ws[-1] = jnp.zeros_like(ws[-1])
    return {"w": tuple(ws), "b": tuple(bs)}


def flow_init(key: jax.Array, d: int, cfg: FlowConfig = FlowConfig(),
              dtype=jnp.float32) -> FlowParams:
    """Identity-initialized flow (unit standardization)."""
    keys = jax.random.split(key, cfg.n_layers)
    layers = tuple(_layer_init(k, d, cfg, dtype) for k in keys)
    return FlowParams(layers=layers, mu=jnp.zeros((d,), dtype),
                      sigma=jnp.ones((d,), dtype))


def _mlp(layer, x):
    # Precision.HIGHEST: the MLP's outputs become per-dim log-scales
    # whose SUM enters MH ratios — the same class of matmul as
    # utils/mixtures.gmm_log_q_diag (a reduced-precision default, TF32
    # on the GPU, × d accumulates to O(0.1-1) log-density noise at
    # d ≳ 50). Cost is negligible at these widths.
    hi = jax.lax.Precision.HIGHEST
    h = x
    for w, b in zip(layer["w"][:-1], layer["b"][:-1]):
        h = jnp.tanh(jnp.matmul(h, w, precision=hi) + b)
    return jnp.matmul(h, layer["w"][-1], precision=hi) + layer["b"][-1]


def _st(layer, x_masked, d, s_cap):
    out = _mlp(layer, x_masked)
    s_raw, t = out[..., :d], out[..., d:]
    s = s_cap * jnp.tanh(s_raw / s_cap)
    return s, t


# ---------------------------------------------------------------------------
# Monotonic rational-quadratic splines (Durkan, Bekasov, Murray,
# Papamakarios 2019, "Neural Spline Flows", eqs. 4-8 and appendix A).
# K bins on [−B, B]² with identity linear tails; boundary derivatives
# pinned to 1 so the map is C¹ at ±B. Everything is elementwise +
# take_along_axis over the K axis — branchless, vmap/grad-safe, and the
# zero-init MLP head gives EXACTLY the identity (equal bins, unit
# derivatives via the softplus offset).
# ---------------------------------------------------------------------------

_RQS_MIN_BIN = 1e-3          # width/height floor (softmax collapse guard)
_RQS_EPS = 1e-6
_SOFTPLUS_UNIT = float(np.log(np.e - 1.0))   # softplus(x + this)(0) = 1


def _rqs_knots(raw, n_bins, tail_bound):
    """raw [..., d, 3K−1] → knot arrays: x/y positions [..., d, K+1],
    widths/heights [..., d, K], derivatives [..., d, K+1]."""
    B = tail_bound
    tw = raw[..., :n_bins]
    th = raw[..., n_bins:2 * n_bins]
    td = raw[..., 2 * n_bins:]
    w = jax.nn.softmax(tw, axis=-1)
    w = _RQS_MIN_BIN + (1.0 - _RQS_MIN_BIN * n_bins) * w
    h = jax.nn.softmax(th, axis=-1)
    h = _RQS_MIN_BIN + (1.0 - _RQS_MIN_BIN * n_bins) * h
    w = w * (2.0 * B)
    h = h * (2.0 * B)
    pad = [(0, 0)] * (td.ndim - 1) + [(1, 1)]
    derivs = jnp.pad(jax.nn.softplus(td + _SOFTPLUS_UNIT) + _RQS_EPS,
                     pad, constant_values=1.0)            # [..., K+1]
    zero = jnp.zeros_like(w[..., :1])
    xk = -B + jnp.concatenate([zero, jnp.cumsum(w, axis=-1)], axis=-1)
    yk = -B + jnp.concatenate([zero, jnp.cumsum(h, axis=-1)], axis=-1)
    return xk, yk, w, h, derivs


def _rqs_gather(arrs, k):
    """Select each element's bin-k entry from [..., K(+1)] knot arrays.

    One-hot CONTRACTION, not ``take_along_axis``: the gather's VJP is a
    scatter, which serialises on colliding indices in the training
    pass; the one-hot multiply+reduce is elementwise work with a
    multiply VJP. k < n_bins always, so slicing [..., :nb] is exact for
    the K+1-sized arrays."""
    nb = min(a.shape[-1] for a in arrs)
    oh = jax.nn.one_hot(k, nb, dtype=arrs[0].dtype)
    return [jnp.sum(a[..., :nb] * oh, axis=-1) for a in arrs]


def _rqs_forward(raw, x, n_bins, tail_bound):
    """Elementwise spline x → (y, dlog) with identity tails; shapes
    [..., d] for x, [..., d, 3K−1] for raw."""
    B = tail_bound
    xk, yk, w, h, derivs = _rqs_knots(raw, n_bins, tail_bound)
    inside = (x > -B) & (x < B)
    xc = jnp.clip(x, -B + _RQS_EPS, B - _RQS_EPS)
    k = jnp.clip(jnp.sum((xc[..., None] >= xk[..., :-1]).astype(jnp.int32),
                         axis=-1) - 1, 0, n_bins - 1)
    x0, y0, wk, hk = _rqs_gather([xk, yk, w, h], k)
    d0, d1 = _rqs_gather([derivs[..., :-1], derivs[..., 1:]], k)
    s = hk / wk
    xi = (xc - x0) / wk
    om = 1.0 - xi
    q = xi * om
    denom = s + (d1 + d0 - 2.0 * s) * q
    y_in = y0 + hk * (s * xi * xi + d0 * q) / denom
    dlog_in = (2.0 * jnp.log(s)
               + jnp.log(d1 * xi * xi + 2.0 * s * q + d0 * om * om)
               - 2.0 * jnp.log(denom))
    y = jnp.where(inside, y_in, x)
    dlog = jnp.where(inside, dlog_in, 0.0)
    return y, dlog


def _rqs_inverse(raw, y, n_bins, tail_bound):
    """Elementwise spline inverse y → (x, dlog of the FORWARD map at x)
    — callers negate/sum as needed."""
    B = tail_bound
    xk, yk, w, h, derivs = _rqs_knots(raw, n_bins, tail_bound)
    inside = (y > -B) & (y < B)
    yc = jnp.clip(y, -B + _RQS_EPS, B - _RQS_EPS)
    k = jnp.clip(jnp.sum((yc[..., None] >= yk[..., :-1]).astype(jnp.int32),
                         axis=-1) - 1, 0, n_bins - 1)
    x0, y0, wk, hk = _rqs_gather([xk, yk, w, h], k)
    d0, d1 = _rqs_gather([derivs[..., :-1], derivs[..., 1:]], k)
    s = hk / wk
    dy = yc - y0
    t2 = d1 + d0 - 2.0 * s
    a = hk * (s - d0) + dy * t2
    b = hk * d0 - dy * t2
    c = -s * dy
    disc = jnp.maximum(b * b - 4.0 * a * c, 0.0)
    # stable quadratic root (Durkan eq. 8): xi in [0, 1]
    xi = 2.0 * c / (-b - jnp.sqrt(disc))
    xi = jnp.clip(xi, 0.0, 1.0)
    # one Newton polish: the closed-form root in f32 loses ~1e-4 on
    # steep/uneven bins, and coupling layers AMPLIFY that through the
    # stack (measured 2e-4 → 1.6 after 4 random layers); a single
    # elementwise Newton step on ξ restores full f32 round-trip
    # accuracy (measured max roundtrip err 1e-6 at 4 layers)
    for _ in range(2):
        om = 1.0 - xi
        q = xi * om
        denom = s + t2 * q
        y_xi = (s * xi * xi + d0 * q) / denom            # (y−y0)/hk
        dy_xi = (s * s * (d1 * xi * xi + 2.0 * s * q + d0 * om * om)
                 / (denom * denom)) / s                  # d[(y−y0)/hk]/dξ·...
        xi = jnp.clip(xi - (y_xi - dy / hk) / jnp.maximum(dy_xi, _RQS_EPS),
                      0.0, 1.0)
    x_in = x0 + xi * wk
    om = 1.0 - xi
    q = xi * om
    denom = s + t2 * q
    dlog_in = (2.0 * jnp.log(s)
               + jnp.log(d1 * xi * xi + 2.0 * s * q + d0 * om * om)
               - 2.0 * jnp.log(denom))
    x = jnp.where(inside, x_in, y)
    dlog = jnp.where(inside, dlog_in, 0.0)
    return x, dlog


def _rqs_raw(layer, x_masked, d, n_bins):
    out = _mlp(layer, x_masked)
    return out.reshape(out.shape[:-1] + (d, 3 * n_bins - 1))


def flow_forward(params: FlowParams, u, cfg: FlowConfig = FlowConfig()):
    """Generative pass u → θ. Returns (theta, log|det dθ/du|), both
    broadcasting over leading axes of u [..., d]."""
    d = params.mu.shape[-1]
    x = u
    logdet = jnp.zeros(u.shape[:-1], u.dtype)
    for i, layer in enumerate(params.layers):
        m = _mask(d, i, u.dtype)
        if cfg.coupling == "rqs":
            raw = _rqs_raw(layer, x * m, d, cfg.n_bins)
            y, dlog = _rqs_forward(raw, x, cfg.n_bins, cfg.tail_bound)
            x = m * x + (1.0 - m) * y
            logdet = logdet + jnp.sum((1.0 - m) * dlog, axis=-1)
        else:
            s, t = _st(layer, x * m, d, cfg.s_cap)
            x = m * x + (1.0 - m) * (x * jnp.exp(s) + t)
            logdet = logdet + jnp.sum((1.0 - m) * s, axis=-1)
    theta = params.mu + params.sigma * x
    return theta, logdet + jnp.sum(jnp.log(params.sigma))


def flow_inverse(params: FlowParams, theta,
                 cfg: FlowConfig = FlowConfig()):
    """Normalizing pass θ → u. Returns (u, log|det du/dθ|) — the
    negative of the forward logdet at the matching point."""
    d = params.mu.shape[-1]
    x = (theta - params.mu) / params.sigma
    logdet = -jnp.sum(jnp.log(params.sigma)) + jnp.zeros(
        theta.shape[:-1], theta.dtype)
    for i in reversed(range(len(params.layers))):
        m = _mask(d, i, theta.dtype)
        if cfg.coupling == "rqs":
            # the conditioner sees the MASKED half, which the coupling
            # leaves fixed — so raw is computable from the output too
            raw = _rqs_raw(params.layers[i], x * m, d, cfg.n_bins)
            xin, dlog = _rqs_inverse(raw, x, cfg.n_bins, cfg.tail_bound)
            x = m * x + (1.0 - m) * xin
            logdet = logdet - jnp.sum((1.0 - m) * dlog, axis=-1)
        else:
            s, t = _st(params.layers[i], x * m, d, cfg.s_cap)
            x = m * x + (1.0 - m) * (x - t) * jnp.exp(-s)
            logdet = logdet - jnp.sum((1.0 - m) * s, axis=-1)
    return x, logdet


def flow_log_q(params: FlowParams, theta,
               cfg: FlowConfig = FlowConfig()):
    """log q(θ): the flow's exact density (pullback of N(0, I))."""
    d = params.mu.shape[-1]
    u, logdet_inv = flow_inverse(params, theta, cfg)
    log_base = -0.5 * jnp.sum(u * u, axis=-1) \
        - 0.5 * d * math.log(2.0 * math.pi)
    return log_base + logdet_inv


def flow_sample(params: FlowParams, key: jax.Array, n: int,
                cfg: FlowConfig = FlowConfig(), dtype=jnp.float32):
    """[n, d] draws from q."""
    d = params.mu.shape[-1]
    u = jax.random.normal(key, (n, d), dtype)
    theta, _ = flow_forward(params, u, cfg)
    return theta


def fit_flow(key: jax.Array, draws, cfg: FlowConfig = FlowConfig(),
             dtype=jnp.float32, init_params: FlowParams | None = None):
    """Maximum-likelihood fit to posterior draws.

    draws: [..., d] (histories flatten internally — pass
        ``get_chain(flat=True)`` or a raw [M, T, d] super_chain).
    init_params: optional warm start — training CONTINUES from these
        layer weights (fresh Adam moments; the standardization affine
        is re-derived from ``draws``, so warm-starting across draw sets
        assumes compatible scales). Lets long fits run as several
        short scans.
    Returns (FlowParams, info) with info = {"loss": [n_steps],
    "final_loss": scalar} (loss = mean negative log q, standardized
    units).
    """
    import optax

    draws = jnp.asarray(draws, dtype)
    if draws.ndim < 2:
        raise ValueError("draws must be [..., d] with d on the last axis")
    x = draws.reshape(-1, draws.shape[-1])
    if x.shape[0] < 2:
        raise ValueError("need at least 2 draws to fit a flow")
    if not bool(jnp.all(jnp.isfinite(x))):
        raise ValueError("draws contain non-finite values — filter them "
                         "before fitting (e.g. drop pre-support burn-in)")
    d = x.shape[-1]

    mu = jnp.mean(x, axis=0)
    sigma = jnp.maximum(jnp.std(x, axis=0), 1e-6)

    k_init, k_fit = jax.random.split(key)
    if init_params is not None:
        layers0 = init_params.layers
    else:
        layers0 = flow_init(k_init, d, cfg, dtype).layers

    def neg_log_lik(layers, batch):
        p = FlowParams(layers=layers, mu=mu, sigma=sigma)
        return -jnp.mean(flow_log_q(p, batch, cfg))

    opt = optax.adam(cfg.step_size)

    def step(carry, k):
        layers, opt_state = carry
        if cfg.batch_size and cfg.batch_size < x.shape[0]:
            idx = jax.random.randint(k, (cfg.batch_size,), 0, x.shape[0])
            batch = x[idx]
        else:
            batch = x
        loss, g = jax.value_and_grad(neg_log_lik)(layers, batch)
        updates, new_opt = opt.update(g, opt_state, layers)
        new_layers = optax.apply_updates(layers, updates)
        # house policy: a non-finite step keeps params AND moments
        # (same as gp.optimize / Advi) instead of poisoning the scan
        ok = jnp.isfinite(loss) & jax.tree_util.tree_reduce(
            lambda a, leaf: a & jnp.all(jnp.isfinite(leaf)),
            new_layers, jnp.bool_(True))
        keep = lambda new, old: jax.tree_util.tree_map(
            lambda a, b: jnp.where(ok, a, b), new, old)
        return (keep(new_layers, layers), keep(new_opt, opt_state)), loss

    keys = jax.random.split(k_fit, cfg.n_steps)
    (layers, _), losses = lax.scan(step, (layers0, opt.init(layers0)),
                                   keys)
    params = FlowParams(layers=layers, mu=mu, sigma=sigma)
    return params, {"loss": losses, "final_loss": losses[-1]}


def flow_proposal(params: FlowParams,
                  cfg: FlowConfig = FlowConfig()) -> Proposal:
    """The fitted flow as a global-move `Proposal` (`bp.FlowMh`).
    ``sample_logq`` pushes the standard normals through the generative
    pass and prices them with the forward logdet directly — no inverse
    round-trip, so the cached log q is exact by construction. The
    uniform word is unused (the flow needs no component draw)."""
    d = int(params.mu.shape[-1])

    def sample_logq(eps, u):
        theta, logdet = flow_forward(params, eps, cfg)
        lq = (-0.5 * jnp.sum(eps * eps, axis=-1)
              - 0.5 * d * math.log(2.0 * math.pi) - logdet)
        return theta, lq

    return Proposal(sample_logq=sample_logq,
                    log_q=lambda x: flow_log_q(params, x, cfg),
                    sigma=params.sigma)


def flow_transform(params: FlowParams,
                   cfg: FlowConfig = FlowConfig()) -> Transform:
    """The fitted flow as a `Transform` (NeuTra composition): sample in
    u-space with ANY sampler via ``bp.transform_log_prob(log_prob, t)``,
    map histories back with ``t.forward``. ``log_det`` is
    log|det dθ/du| at u, matching `utils/transforms` conventions."""
    d = int(params.mu.shape[-1])
    return Transform(
        forward=lambda u: flow_forward(params, u, cfg)[0],
        inverse=lambda theta: flow_inverse(params, theta, cfg)[0],
        log_det=lambda u: flow_forward(params, u, cfg)[1],
        d=d)
