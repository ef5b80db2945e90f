"""Time-axis drivers: ``lax.scan`` over pure sampler steps.

The reference's hot loop is a serial Python ``for t in range(n)`` inside
``run_mcmc`` (SURVEY.md §5.1). Here the whole loop is one compiled
``lax.scan`` over a pure ``step(state, key) -> (state, info)``, so the device
never returns to the host between steps. Thinned collection nests a scan:
the outer scan collects, the inner scan advances ``thin`` steps without
materialising history.
"""

import jax
import jax.numpy as jnp
from jax import lax

from bipymc_tpu.core.rng import step_key


def run_scan(step_fn, state, base_key, n_steps, collect_fn=None):
    """Scan ``step_fn`` for ``n_steps``, collecting ``collect_fn(state,
    info)``.

    step_fn: (state, key, t) -> (state, info). ``t`` is the global step index
    (int32 scalar), used both for RNG folding and adaptation schedules.
    collect_fn: what to stack per step (default: the info pytree).
    Returns (final_state, stacked_collect).
    """
    if collect_fn is None:
        collect_fn = lambda state, info: info

    def body(carry, t):
        state = carry
        key = step_key(base_key, t)
        state, info = step_fn(state, key, t)
        return state, collect_fn(state, info)

    ts = jnp.arange(n_steps, dtype=jnp.int32)
    return lax.scan(body, state, ts)


def _progress_print(t, frac):
    print(f"[bipymc_tpu] step {int(t) + 1}: acceptance {float(frac):.3f}")


def run_scan_thinned(step_fn, state, base_key, n_steps, thin, collect_fn=None,
                     t0=0, progress_every=None):
    """Like :func:`run_scan` but keeps only every ``thin``-th collection.

    ``n_steps`` must be a multiple of ``thin``. History has
    ``n_steps // thin`` entries; the inner ``thin``-step scan carries no
    ``ys`` so memory scales with the kept history only.
    ``t0`` offsets the global step index (for resuming / chunked runs).
    ``progress_every``: emit a host progress line (step + mean acceptance,
    via ``jax.debug.callback``) every that many *kept* steps — the
    SURVEY.md §7.5 observability hook. Default off: host callbacks
    serialise against the device stream.
    """
    if n_steps % thin != 0:
        raise ValueError(f"n_steps={n_steps} not a multiple of thin={thin}")
    if collect_fn is None:
        collect_fn = lambda state, info: info

    def inner(carry, t):
        state = carry
        key = step_key(base_key, t)
        state, info = step_fn(state, key, t)
        return state, None

    def outer(carry, k):
        state = carry
        ts = t0 + k * thin + jnp.arange(thin, dtype=jnp.int32)
        # advance thin-1 steps silently, collect on the last
        state, _ = lax.scan(inner, state, ts[:-1]) if thin > 1 else (state, None)
        key = step_key(base_key, ts[-1])
        state, info = step_fn(state, key, ts[-1])
        if progress_every is not None:
            acc = getattr(info, "accepted", None)
            frac = (jnp.mean(acc.astype(jnp.float32))
                    if acc is not None else jnp.zeros(()))
            lax.cond(
                (k + 1) % progress_every == 0,
                lambda: jax.debug.callback(_progress_print, ts[-1], frac),
                lambda: None)
        return state, collect_fn(state, info)

    ks = jnp.arange(n_steps // thin, dtype=jnp.int32)
    return lax.scan(outer, state, ks)
