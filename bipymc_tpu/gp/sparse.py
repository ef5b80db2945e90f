"""Sparse variational GP regression (Titsias VFE) — beyond-reference.

The reference's GP (SURVEY.md §4.9, `bipymc/gp/` [U]) is exact: an O(n³)
Cholesky of the full Gram limits it to n ≲ 10⁴ training points even with
the row-sharded build (gp/sharded.py). This module extends the surrogate
stack past that wall with the Titsias (2009) variational free-energy
approximation: m ≪ n inducing points Z give O(n·m²) fit cost and an O(m³)
factorisation, with a collapsed evidence lower bound (ELBO) whose gap to
the exact log-ML is controlled by the trace term — so inducing points and
hyperparameters are trained jointly by ``jax.grad`` ascent on one scalar.

Accelerator mapping: every O(n·) contraction is a dense matmul with a static
shape — ``Kmn`` rides the one-matmul pairwise-distance build, ``A·Aᵀ``
([m,n]×[n,m]) and ``A·y`` are matmul contractions — and the per-datapoint
statistics are *sums over n*, so the data axis shards over a device mesh
with two ``psum``s closing the bound (:func:`elbo_sharded`,
:func:`fit_sharded`); the replicated tail is m×m. This is the classic
data-parallel sufficient-statistics pattern: ICI traffic is O(m²) per
step, independent of n.

Math (Titsias 2009; the GPflow SGPR formulation is used for numerical
stability — everything through Cholesky factors, no explicit inverses):

  L  = chol(Kmm + jitter·I)
  A  = L⁻¹ Kmn / σ_n                       [m, n]
  B  = I + A Aᵀ ;  L_B = chol(B)
  c  = L_B⁻¹ (A y) / σ_n                   [m]

  ELBO = − n/2 log 2πσ_n² − Σᵢ log (L_B)ᵢᵢ − ‖y‖²/(2σ_n²) + ‖c‖²/2
         − (tr(Knn) / σ_n² − tr(A Aᵀ)) / 2            (the VFE gap term)

  predict at x*:  w = L⁻¹ k_m* ;  u = L_B⁻¹ w
    μ* = uᵀ c ;   σ*² = k** − ‖w‖² + ‖u‖²

With Z = X (m = n) the bound equals the exact log marginal likelihood and
predictions coincide with :class:`bipymc_tpu.gp.regressor.GpRegressor`
(pinned in tests/test_gp_sparse.py).
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from bipymc_tpu.gp.kernels import squared_exp
from bipymc_tpu.parallel.mesh import CHAIN_AXIS


class SparseGpFit(NamedTuple):
    params: dict
    z: jax.Array        # [m, d] inducing inputs
    chol_m: jax.Array   # [m, m] chol(Kmm + jitter I)
    chol_b: jax.Array   # [m, m] chol(I + A Aᵀ)
    c: jax.Array        # [m]    L_B⁻¹ A y / σ_n
    y_mean: jax.Array   # [] target standardisation (identity: 0, 1)
    y_std: jax.Array    # []


def init_inducing(key, x, m):
    """m inducing inputs as a random training subset (no replacement).

    The standard initialisation for VFE — gradient ascent on the ELBO
    then moves them (k-means would need dynamic host loops; a random
    subset is within noise of it once Z is optimised)."""
    n = x.shape[0]
    if m > n:
        raise ValueError(f"init_inducing: m={m} > n={n}")
    idx = jax.random.permutation(key, n)[:m]
    return x[idx]


class SparseGpRegressor:
    """Titsias-VFE sparse GP with the same kernel/params contract as
    :class:`~bipymc_tpu.gp.regressor.GpRegressor` (SE-ARD default;
    ``log_lengthscale``/``log_sigma_f``/``log_sigma_n`` params pytree),
    plus inducing inputs ``z`` trained jointly in :meth:`optimize`."""

    def __init__(self, kernel: Callable = squared_exp, jitter: float = 1e-5,
                 normalize_y: bool = False):
        self.kernel = kernel
        self.jitter = jitter
        self.normalize_y = normalize_y
        self._fit_jit = jax.jit(self._fit_impl)
        self._predict_jit = jax.jit(self._predict_impl)
        self._elbo_jit = jax.jit(self._elbo_impl)

    # ---- pure implementations -------------------------------------------
    def _chol_m(self, params, z):
        """chol(Kmm + jitter·σ_f²·I) — the inducing Gram carries NO noise
        term (u is the latent process at Z), only the SPD-safety jitter,
        floored at 4·m·ε like the exact regressor's (_diag_shift)."""
        m = z.shape[0]
        eps = float(np.finfo(np.dtype(z.dtype)).eps)
        sf2 = jnp.exp(2.0 * params["log_sigma_f"])
        jit = max(self.jitter, 4.0 * m * eps) * sf2
        kmm = self.kernel(params, z) + jit * jnp.eye(m, dtype=z.dtype)
        return jnp.linalg.cholesky(kmm)

    def _normalize(self, y):
        if self.normalize_y:
            y_mean = jnp.mean(y)
            y_std = jnp.maximum(jnp.std(y), 1e-12)
        else:
            y_mean = jnp.zeros((), dtype=y.dtype)
            y_std = jnp.ones((), dtype=y.dtype)
        return (y - y_mean) / y_std, y_mean, y_std

    def _prior_diag(self, params, xs):
        diag_fn = getattr(self.kernel, "diag", None)
        if diag_fn is not None:
            return diag_fn(params, xs)
        return jax.vmap(
            lambda r: self.kernel(params, r[None, :])[0, 0])(xs)

    def _suffstats(self, params, z, chol_m, x, y, mask=None):
        """Per-datapoint sufficient statistics, the only O(n·) work:
        (A Aᵀ [m,m], A y/σ [m], ‖y‖²/σ² [], gap-trace [], n_eff []).

        ``mask`` (0/1 per row) zeroes padded rows so the sharded path can
        pad n to the device count without biasing any statistic — a
        padded row must contribute nothing to tr(Knn) either (its prior
        diag is σ_f², not 0)."""
        sn = jnp.exp(params["log_sigma_n"])
        kmn = self.kernel(params, z, x)                   # [m, n]
        a = jax.scipy.linalg.solve_triangular(
            chol_m, kmn, lower=True) / sn                 # [m, n]
        knn_diag = self._prior_diag(params, x)
        if mask is not None:
            a = a * mask[None, :]
            y = y * mask
            knn_diag = knn_diag * mask
            n_eff = jnp.sum(mask)
        else:
            n_eff = jnp.asarray(x.shape[0], y.dtype)
        aat = a @ a.T                                     # [m, m]
        ay = a @ y / sn                                   # [m]
        yty = jnp.sum(y * y) / sn ** 2
        # VFE gap: (tr(Knn)/σ² − tr(A Aᵀ)) — tr(Qnn)/σ² IS tr(A Aᵀ)
        gap = jnp.sum(knn_diag) / sn ** 2 - jnp.trace(aat)
        return aat, ay, yty, gap, n_eff

    def _collapse(self, params, z, chol_m, aat, ay, yty, gap, n_eff,
                  y_std):
        """m×m tail of the bound — replicated, O(m³)."""
        m = z.shape[0]
        b = aat + jnp.eye(m, dtype=aat.dtype)
        chol_b = jnp.linalg.cholesky(b)
        c = jax.scipy.linalg.solve_triangular(chol_b, ay, lower=True)
        sn = jnp.exp(params["log_sigma_n"])
        elbo = (-0.5 * n_eff * jnp.log(2.0 * jnp.pi)
                - n_eff * jnp.log(sn)
                - jnp.sum(jnp.log(jnp.diagonal(chol_b)))
                - 0.5 * yty + 0.5 * jnp.sum(c * c)
                - 0.5 * gap
                - n_eff * jnp.log(y_std))   # change of variables, cf.
        return chol_b, c, elbo              # regressor._lml_impl

    def _fit_impl(self, params, z, x, y):
        yn, y_mean, y_std = self._normalize(y)
        chol_m = self._chol_m(params, z)
        aat, ay, yty, gap, n_eff = self._suffstats(params, z, chol_m, x, yn)
        chol_b, c, _ = self._collapse(params, z, chol_m, aat, ay, yty,
                                      gap, n_eff, y_std)
        return SparseGpFit(params=params, z=z, chol_m=chol_m,
                           chol_b=chol_b, c=c, y_mean=y_mean, y_std=y_std)

    def _predict_impl(self, fit: SparseGpFit, xs):
        kzs = self.kernel(fit.params, fit.z, xs)          # [m, s]
        w = jax.scipy.linalg.solve_triangular(
            fit.chol_m, kzs, lower=True)
        u = jax.scipy.linalg.solve_triangular(
            fit.chol_b, w, lower=True)
        mu = u.T @ fit.c
        prior = self._prior_diag(fit.params, xs)
        var = jnp.maximum(
            prior - jnp.sum(w * w, axis=0) + jnp.sum(u * u, axis=0), 1e-12)
        return fit.y_mean + fit.y_std * mu, fit.y_std ** 2 * var

    def _elbo_impl(self, params, z, x, y, mask=None, axis=None):
        """Collapsed bound; ``axis`` names a mesh axis the (x, y, mask)
        rows are sharded over — the five sufficient statistics are then
        psum'd (O(m²) ICI traffic) and the m×m tail runs replicated."""
        yn, _, y_std = self._normalize(y) if axis is None else (
            y, None, jnp.ones((), y.dtype))  # sharded path normalises
        chol_m = self._chol_m(params, z)     # outside (needs global y)
        stats = self._suffstats(params, z, chol_m, x, yn, mask)
        if axis is not None:
            stats = jax.lax.psum(stats, axis)
        _, _, elbo = self._collapse(params, z, chol_m, *stats, y_std)
        return elbo

    # ---- public API ------------------------------------------------------
    def fit(self, x, y, z, params=None):
        """Collapse the optimal variational posterior at fixed (params, z)
        → SparseGpFit. O(n·m²) — one pass over the data."""
        x = jnp.atleast_2d(x)
        y = jnp.asarray(y)
        z = jnp.atleast_2d(z)
        if params is None:
            from bipymc_tpu.gp.regressor import default_params
            params = default_params(x.shape[-1], dtype=x.dtype)
        return self._fit_jit(params, z, x, y)

    def predict(self, fit: SparseGpFit, xs, return_var=True):
        xs = jnp.atleast_2d(xs)
        mu, var = self._predict_jit(fit, xs)
        return (mu, var) if return_var else mu

    def elbo(self, params, z, x, y):
        """Collapsed variational lower bound on log p(y). Equals the exact
        log-ML when Z = X; always ≤ it (pinned in tests)."""
        return self._elbo_jit(params, jnp.atleast_2d(z),
                              jnp.atleast_2d(x), jnp.asarray(y))

    def optimize(self, x, y, z=None, m=64, params=None, steps=300, lr=0.05,
                 key=None, optimize_z=True):
        """Maximise the ELBO with Adam over hyperparameters AND inducing
        inputs jointly (optimize_z=False freezes Z). Returns
        ((best_params, best_z), best_elbo).

        Same scan-safe non-finite-step rejection as
        ``GpRegressor.optimize``: an Adam overshoot
        near the σ_n→0 cliff yields NaN loss/grads for one step; keeping
        the last good iterate instead of poisoning the scan."""
        x = jnp.atleast_2d(x)
        y = jnp.asarray(y)
        if key is None:
            key = jax.random.key(0)
        if z is None:
            z = init_inducing(key, x, m)
        z = jnp.atleast_2d(z)
        if params is None:
            from bipymc_tpu.gp.regressor import default_params
            params = default_params(x.shape[-1], dtype=x.dtype)

        yn, y_mean, y_std = self._normalize(y)

        def loss_fn(pz):
            p, zz = pz
            # normalisation folded out of the traced loss (constant):
            # optimise the bound of the standardised targets
            return -self._elbo_impl(p, zz, x, yn)

        loss_grad = jax.value_and_grad(loss_fn)
        import optax          # optional: hyperparameter optimisation only
        opt = optax.adam(lr)
        pz0 = (params, z if optimize_z else jax.lax.stop_gradient(z))

        @jax.jit
        def run(pz0):
            def step(carry, _):
                pz, opt_state = carry
                loss, g = loss_grad(pz)
                if not optimize_z:
                    g = (g[0], jnp.zeros_like(g[1]))
                ok = jnp.isfinite(loss) & jnp.asarray(
                    jax.tree_util.tree_reduce(
                        lambda a, b: a & b,
                        jax.tree_util.tree_map(
                            lambda v: jnp.all(jnp.isfinite(v)), g)))
                updates, opt_state_new = opt.update(g, opt_state)
                pz_new = optax.apply_updates(pz, updates)
                keep = lambda new, old: jax.tree_util.tree_map(
                    lambda a, b: jnp.where(ok, a, b), new, old)
                return (keep(pz_new, pz),
                        keep(opt_state_new, opt_state)), loss
            (pz, _), _ = jax.lax.scan(step, (pz0, opt.init(pz0)),
                                      None, length=steps)
            return pz, -loss_fn(pz)

        (p_best, z_best), elbo_n = run(pz0)
        if not bool(jnp.isfinite(elbo_n)):
            raise ValueError(
                "SparseGpRegressor.optimize(): ELBO non-finite after "
                "optimisation — check the data for NaNs or raise jitter")
        # undo standardisation in the reported bound value
        n = x.shape[0]
        elbo = float(elbo_n) - n * float(jnp.log(y_std))
        return (p_best, z_best), elbo

    def surrogate_log_like(self, fit: SparseGpFit, kind="mean"):
        """Drop-in surrogate log-likelihood (same contract as
        GpRegressor.surrogate_log_like — BASELINE config 5 usage, with
        the n-wall removed: the closure's per-θ cost is O(m·d + m²))."""
        fit = jax.tree_util.tree_map(np.asarray, fit)

        def log_like(theta):
            mu, var = self._predict_impl(fit, theta[None, :])
            if kind == "lcb":
                return (mu - 0.5 * var)[0]
            return mu[0]
        return log_like


# ---- data-parallel ELBO/fit over a device mesh ---------------------------
def _pad_rows(a, mult):
    n = a.shape[0]
    pad = (-n) % mult
    if pad:
        a = jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
    return a, n


def elbo_sharded(gp: SparseGpRegressor, params, z, x, y, mesh: Mesh,
                 axis: str = CHAIN_AXIS):
    """Collapsed ELBO with the data axis sharded over ``mesh``.

    Each device computes the sufficient statistics of its row block
    (O(n_local·m²) FLOPs, all matmuls); two psums of m×m / m-vector
    partials close the bound. Matches the dense :meth:`.elbo` to float
    rounding (tests/test_gp_sparse.py, 8-fake-device mesh). Differentiable
    — ``jax.grad`` through the shard_map gives data-parallel ELBO ascent."""
    n_dev = mesh.devices.size
    x = jnp.atleast_2d(x)
    yn, _, y_std = gp._normalize(jnp.asarray(y))
    xp, n = _pad_rows(x, n_dev)
    yp, _ = _pad_rows(yn, n_dev)
    maskp, _ = _pad_rows(jnp.ones((n,), x.dtype), n_dev)

    def block(x_l, y_l, m_l):
        return gp._elbo_impl(params, z, x_l, y_l, mask=m_l, axis=axis)

    elbo = jax.jit(jax.shard_map(
        block, mesh=mesh, in_specs=(P(axis), P(axis), P(axis)),
        out_specs=P()))(xp, yp, maskp)
    return elbo - n * jnp.log(y_std)


def fit_sharded(gp: SparseGpRegressor, x, y, z, mesh: Mesh, params=None,
                axis: str = CHAIN_AXIS):
    """Sharded-data fit: same SparseGpFit as ``gp.fit`` (up to reduction
    order), with the O(n·m²) statistics pass distributed over ``mesh``."""
    x = jnp.atleast_2d(x)
    y = jnp.asarray(y)
    z = jnp.atleast_2d(z)
    if params is None:
        from bipymc_tpu.gp.regressor import default_params
        params = default_params(x.shape[-1], dtype=x.dtype)
    n_dev = mesh.devices.size
    yn, y_mean, y_std = gp._normalize(y)
    xp, n = _pad_rows(x, n_dev)
    yp, _ = _pad_rows(yn, n_dev)
    maskp, _ = _pad_rows(jnp.ones((n,), x.dtype), n_dev)

    def stats_block(x_l, y_l, m_l, chol_m):
        s = gp._suffstats(params, z, chol_m, x_l, y_l, m_l)
        return jax.lax.psum(s, axis)

    @jax.jit
    def run(xp, yp, maskp):
        chol_m = gp._chol_m(params, z)
        stats = jax.shard_map(
            lambda a, b, c: stats_block(a, b, c, chol_m),
            mesh=mesh, in_specs=(P(axis), P(axis), P(axis)),
            out_specs=P())(xp, yp, maskp)
        chol_b, c, _ = gp._collapse(params, z, chol_m, *stats, y_std)
        return chol_m, chol_b, c

    chol_m, chol_b, c = run(xp, yp, maskp)
    return SparseGpFit(params=params, z=z, chol_m=chol_m, chol_b=chol_b,
                       c=c, y_mean=y_mean, y_std=y_std)
