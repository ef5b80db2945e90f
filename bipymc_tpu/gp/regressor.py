"""Gaussian-process regression.

Reference capability (SURVEY.md §4.9, [B]; `bipymc/gp/` [U]): SE-ARD
kernel GP with Cholesky-based fit/predict and marginal-likelihood
hyperparameter estimation, usable as a cheap surrogate likelihood for
expensive inverse problems (BASELINE configs 4–5).

Accelerator-native redesign: fit/predict/log-ML are pure jitted functions
over a params pytree; hyperparameters are optimised by ``jax.grad`` of the
exact log marginal likelihood (the reference uses gradient-free SciPy
[U]) with Adam + multi-restart. The O(n²d) kernel build is one matrix
product (:mod:`bipymc_tpu.ops.distance`); the O(n³) factorisation is
XLA's ``cholesky`` / ``triangular_solve`` (cuSOLVER on the GPU), batched
by ``vmap`` when the likelihood is vmapped over chains (config 4).

Math (SURVEY.md §4.9):
  fit:      L = chol(K + σ_n² I);  α = Lᵀ \\ (L \\ y)
  predict:  μ* = k*ᵀ α;  σ*² = k** − ‖L \\ k*‖²
  log-ML:   −½ yᵀα − Σ log L_ii − (n/2) log 2π
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from bipymc_tpu.gp import kernels as _kernels
from bipymc_tpu.gp.kernels import squared_exp


class GpFit(NamedTuple):
    params: dict
    x: jax.Array       # [n, d] training inputs
    chol: jax.Array    # [n, n] chol(K + σ_n² I)
    alpha: jax.Array   # [n]
    y_mean: jax.Array  # [] target standardisation (identity: 0, 1)
    y_std: jax.Array   # []


def default_params(d, dtype=jnp.float32):
    return {
        "log_lengthscale": jnp.zeros((d,), dtype=dtype),
        "log_sigma_f": jnp.zeros((), dtype=dtype),
        "log_sigma_n": jnp.asarray(-2.3, dtype=dtype),   # σ_n ≈ 0.1
    }


class GpRegressor:
    """SE-ARD GP regressor (kernel pluggable; see gp.kernels).

    jitter: extra diagonal added to keep f32 Cholesky SPD
    (SURVEY.md §9: f32 GP Cholesky needs jitter ≥ ~1e-5 · trace scale).
    """

    def __init__(self, kernel: Callable = squared_exp, jitter: float = 1e-5,
                 normalize_y: bool = False):
        """normalize_y: standardise targets to zero mean / unit variance
        before fitting and undo it in predict — essential when y spans
        orders of magnitude (e.g. GP surrogates of log-likelihood surfaces,
        BASELINE config 5) since the SE prior assumes O(σ_f) amplitudes."""
        self.kernel = kernel
        self.jitter = jitter
        self.normalize_y = normalize_y
        self._fit_jit = jax.jit(self._fit_impl)
        self._predict_jit = jax.jit(self._predict_impl)
        self._lml_jit = jax.jit(self._lml_impl)

    # ---- pure implementations -------------------------------------------
    def _diag_shift(self, params, n=None):
        """Noise + jitter added to the Gram diagonal (shared with the
        row-sharded build in gp.sharded).

        The jitter is floored at ``4·n·ε(dtype)``: an SE Gram over n
        clustered points has eigenvalues below the dtype's round-off
        scale (≈ n·ε·σ_f²), so a FIXED jitter that is safe at n=64 is
        below the floor at n=256: as ``optimize`` drives σ_n → 0, an
        accelerator f32 Cholesky of K + (σ_n² + 1e-5·σ_f²)I can go
        non-finite at n=256 on rounding alone, and a 2·n·ε floor still
        tipped over inside the compiled Adam scan (different fusion
        rounding than the eager loop); 4·n·ε survives the full 300-step
        scan. LML gains below this floor fit the dtype's rounding noise,
        not data. Static (Python) arithmetic — n and dtype are
        trace-time constants."""
        sn2 = jnp.exp(2.0 * params["log_sigma_n"])
        sf2 = jnp.exp(2.0 * params["log_sigma_f"])
        jitter = self.jitter
        if n is not None:
            eps = float(np.finfo(
                np.dtype(params["log_sigma_f"].dtype)).eps)
            jitter = max(jitter, 4.0 * n * eps)
        return sn2 + jitter * sf2

    def _gram(self, params, x):
        n = x.shape[0]
        k = self.kernel(params, x)
        return k + self._diag_shift(params, n) * jnp.eye(n, dtype=k.dtype)

    def _normalize(self, y):
        if self.normalize_y:
            y_mean = jnp.mean(y)
            y_std = jnp.maximum(jnp.std(y), 1e-12)
        else:
            y_mean = jnp.zeros((), dtype=y.dtype)
            y_std = jnp.ones((), dtype=y.dtype)
        return (y - y_mean) / y_std, y_mean, y_std

    def _cholesky(self, kmat):
        return jnp.linalg.cholesky(kmat)

    def _solve_lower(self, chol, b):
        """L⁻¹ b."""
        return jax.scipy.linalg.solve_triangular(chol, b, lower=True)

    def _solve_lower_t(self, chol, b):
        """L⁻ᵀ b."""
        return jax.scipy.linalg.solve_triangular(chol.T, b, lower=False)

    def _fit_impl(self, params, x, y):
        yn, y_mean, y_std = self._normalize(y)
        kmat = self._gram(params, x)
        chol = self._cholesky(kmat)
        v = self._solve_lower(chol, yn)
        alpha = self._solve_lower_t(chol, v)
        return GpFit(params=params, x=x, chol=chol, alpha=alpha,
                     y_mean=y_mean, y_std=y_std)

    def _prior_diag(self, params, xs):
        """k(x*, x*) per test row — the prior term of the predictive
        variance. Stationary kernels publish it as ``kernel.diag``
        (= σ_f²); a plugged-in kernel without one falls back to
        row-wise evaluation so non-stationary diagonals stay correct."""
        diag_fn = getattr(self.kernel, "diag", None)
        if diag_fn is not None:
            return diag_fn(params, xs)
        return jax.vmap(
            lambda r: self.kernel(params, r[None, :])[0, 0])(xs)

    def _predict_impl(self, fit: GpFit, xs):
        ks = self.kernel(fit.params, fit.x, xs)          # [n, m]
        mu = ks.T @ fit.alpha
        w = self._solve_lower(fit.chol, ks)
        prior = self._prior_diag(fit.params, xs)
        var = jnp.maximum(prior - jnp.sum(w * w, axis=0), 1e-12)
        return fit.y_mean + fit.y_std * mu, fit.y_std ** 2 * var

    def _lml_impl(self, params, x, y):
        n = x.shape[0]
        y, _, y_std = self._normalize(y)
        kmat = self._gram(params, x)
        chol = self._cholesky(kmat)
        v = self._solve_lower(chol, y)
        # -n log(y_std): change-of-variables so the value is the LML of the
        # *original* y under normalize_y (constant in params, so hyperopt
        # is unaffected, but values stay comparable across settings)
        return (-0.5 * jnp.sum(v * v)
                - jnp.sum(jnp.log(jnp.diagonal(chol)))
                - 0.5 * n * jnp.log(2.0 * jnp.pi)
                - n * jnp.log(y_std))

    # ---- public API ------------------------------------------------------
    def fit(self, x, y, params=None):
        """Factorise at fixed hyperparameters → GpFit."""
        x = jnp.atleast_2d(x)
        y = jnp.asarray(y)
        if params is None:
            params = default_params(x.shape[-1], dtype=x.dtype)
        return self._fit_jit(params, x, y)

    def predict(self, fit: GpFit, xs, return_var=True):
        """Posterior mean (and variance) at test inputs [m, d]."""
        xs = jnp.atleast_2d(xs)
        mu, var = self._predict_jit(fit, xs)
        return (mu, var) if return_var else mu

    def log_marginal_likelihood(self, params, x, y):
        return self._lml_jit(params, jnp.atleast_2d(x), jnp.asarray(y))

    def optimize(self, x, y, params=None, steps=300, lr=0.05, key=None,
                 n_restarts=1, restart_scale=0.5):
        """Maximise the exact log-ML with Adam over log-hyperparameters.

        Multi-restart from jittered inits (restarts > 1 need ``key``).
        Returns (best_params, best_lml).
        """
        x = jnp.atleast_2d(x)
        y = jnp.asarray(y)
        if params is None:
            params = default_params(x.shape[-1], dtype=x.dtype)

        loss_grad = jax.value_and_grad(
            lambda p: -self._lml_impl(p, x, y))
        import optax          # optional: hyperparameter optimisation only
        opt = optax.adam(lr)

        @jax.jit
        def run_one(p0):
            def step(carry, _):
                p, opt_state = carry
                loss, g = loss_grad(p)
                # reject non-finite steps instead of poisoning the whole
                # scan: near the f32 Cholesky cliff (σ_n → 0 against a
                # near-singular Gram) a single Adam overshoot returns
                # NaN loss/grads, and optax would propagate NaN into the
                # params forever; the compiled scan rounds differently
                # from the eager loop and can tip over when the eager
                # loop survives. Keeping (p, opt_state) on a bad
                # step is the scan-safe analogue of a rejected line
                # search; progress resumes from the last good iterate.
                ok = jnp.isfinite(loss) & jnp.asarray(
                    jax.tree_util.tree_reduce(
                        lambda a, b: a & b,
                        jax.tree_util.tree_map(
                            lambda v: jnp.all(jnp.isfinite(v)), g)))
                updates, opt_state_new = opt.update(g, opt_state)
                p_new = optax.apply_updates(p, updates)
                keep = lambda new, old: jax.tree_util.tree_map(
                    lambda a, b: jnp.where(ok, a, b), new, old)
                return (keep(p_new, p), keep(opt_state_new, opt_state)), loss
            (p, _), losses = jax.lax.scan(
                step, (p0, opt.init(p0)), None, length=steps)
            return p, -loss_grad(p)[0]

        inits = [params]
        if n_restarts > 1:
            if key is None:
                key = jax.random.key(0)
            for i in range(n_restarts - 1):
                k = jax.random.fold_in(key, i)
                # fold by flat-leaf INDEX: every leaf gets an independent
                # perturbation, reproducibly (hashing str(shape) was both
                # salted per process and identical for same-shaped leaves)
                leaves, treedef = jax.tree_util.tree_flatten(params)
                noised = [
                    leaf + restart_scale * jax.random.normal(
                        jax.random.fold_in(k, j), jnp.shape(leaf),
                        dtype=leaf.dtype)
                    for j, leaf in enumerate(leaves)]
                inits.append(jax.tree_util.tree_unflatten(treedef, noised))

        best_p, best_l = None, -jnp.inf
        for p0 in inits:
            p, l = run_one(p0)
            if bool(jnp.isfinite(l)) and float(l) > float(best_l):
                best_p, best_l = p, l
        if best_p is None:
            # every restart diverged (NaNs in y, duplicated rows with
            # tiny jitter, ...) — fail HERE, not with an unrelated
            # TypeError when the caller feeds params=None into fit()
            raise ValueError(
                "optimize(): log marginal likelihood was non-finite for "
                "every restart — check the data for NaNs/duplicate rows "
                "or raise the jitter")
        return best_p, best_l

    def surrogate_log_like(self, fit: GpFit, kind="mean"):
        """Use the fitted GP as a surrogate log-likelihood θ → ℓ̂(θ)
        (BASELINE config 5: GP-surrogate inverse problems).

        kind="mean": plain posterior mean. kind="lcb": variance-penalised
        (mean − ½σ²), discouraging chains from exploiting regions the
        surrogate is unsure about.

        An SE-kernel surrogate reverts to its zero mean outside the training
        data, so always combine it with a prior that covers the trained
        region (log_post = surrogate(θ) + log_prior(θ)); otherwise chains
        can drift into unmodelled space where the surrogate is flat.
        """
        import numpy as np
        # Materialise the fit on host ONCE: the returned closure is traced
        # inside samplers' jits, and closed-over *device* arrays would be
        # fetched back to host at every trace (see models/targets.py).
        fit = jax.tree_util.tree_map(np.asarray, fit)

        def log_like(theta):
            mu, var = self._predict_impl(fit, theta[None, :])
            if kind == "lcb":
                return (mu - 0.5 * var)[0]
            return mu[0]
        return log_like
