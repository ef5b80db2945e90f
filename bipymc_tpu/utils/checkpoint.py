"""Checkpoint / resume for sampler state pytrees.

The reference has no built-in checkpointing — users np.save chain arrays
manually (SURVEY.md §7.4). Here the sampler state is a pure pytree
(positions, log-probs, archive Z, CR weights, counters), so exact resume is
trivial: save the leaves, restore, continue the scan at ``t0 = step count``.

Two backends: a dependency-free ``.npz`` writer (leaf arrays + a pickled
treedef) and, if available, `orbax.checkpoint` for sharded/async saves.
"""

import os
import pickle

import jax
import numpy as np

# Schema version per state class, bumped whenever a class's field layout
# changes. Written into every checkpoint so migrations key on an explicit
# (class, version) tag rather than guessing from repr/leaf-count (which
# misfired on unrelated 10-leaf states and would break silently the next
# time DreamState gains a field).
_SCHEMA_VERSIONS = {"DreamState": 2}    # v2: gained cr_cum (round 2)


def _schema_tag(state):
    name = type(state).__name__
    return f"{name}:v{_SCHEMA_VERSIONS.get(name, 1)}"


def save_state(path, state, step=0):
    """Save a sampler state pytree to ``path`` (.npz)."""
    leaves, treedef = jax.tree_util.tree_flatten(state)
    arrays = {f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        pickle.dumps(treedef), dtype=np.uint8)
    arrays["__step__"] = np.asarray(step)
    arrays["__schema__"] = np.frombuffer(
        _schema_tag(state).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_state(path):
    """Load a state saved by :func:`save_state` → (state, step).

    ``np.savez`` appends ``.npz`` to extensionless paths but ``np.load``
    does not — mirror that here so ``save_state('ckpt', ...)`` /
    ``load_state('ckpt')`` round-trips.
    """
    path = os.fspath(path)
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path += ".npz"
    with np.load(path, allow_pickle=False) as data:
        treedef = pickle.loads(data["__treedef__"].tobytes())
        n = len([k for k in data.files if k.startswith("leaf_")])
        leaves = [jax.numpy.asarray(data[f"leaf_{i}"]) for i in range(n)]
        step = int(data["__step__"])
        schema = (data["__schema__"].tobytes().decode()
                  if "__schema__" in data.files else None)
    return _unflatten_migrating(treedef, leaves, schema), step


def _migrate_dream_v1(leaves):
    """DreamState v1 → v2: derive the added ``cr_cum`` from ``cr_p``."""
    from bipymc_tpu.ensemble.archive import Archive
    from bipymc_tpu.samplers.dream import DreamState
    (x, logp, buf, fill, head, cr_p,
     cr_jump, cr_count, logp_sum, gen) = leaves
    cr_cum = jax.numpy.cumsum(cr_p / jax.numpy.sum(cr_p))
    return DreamState(x=x, logp=logp,
                      archive=Archive(buf=buf, fill=fill, head=head),
                      cr_p=cr_p, cr_cum=cr_cum, cr_jump=cr_jump,
                      cr_count=cr_count, logp_sum=logp_sum, gen=gen)


# (class name, saved version) -> leaves -> current-layout state
_MIGRATIONS = {("DreamState", 1): _migrate_dream_v1}


def _root_class_name(treedef):
    """Exact root node type of a pytree treedef (None for a bare leaf)."""
    node = treedef.node_data()
    return getattr(node[0], "__name__", None) if node is not None else None


def _unflatten_migrating(treedef, leaves, schema=None):
    """tree_unflatten with migration for state-layout changes.

    Checkpoints are positional leaves + a treedef pinned to the class *as
    it was at save time*; a field added later makes plain unflatten fail.
    Migration is keyed on the checkpoint's explicit ``__schema__`` tag
    (class name + version written at save time). Pre-tag checkpoints
    (round ≤2) fall back to the exact treedef root class: the only
    untagged layout in the wild is DreamState v1 (10 leaves).
    """
    try:
        return jax.tree_util.tree_unflatten(treedef, leaves)
    except (TypeError, ValueError):
        if schema is not None:
            name, _, ver = schema.partition(":v")
            key = (name, int(ver)) if ver.isdigit() else None
        elif _root_class_name(treedef) == "DreamState" and len(leaves) == 10:
            key = ("DreamState", 1)
        else:
            key = None
        if key in _MIGRATIONS:
            return _MIGRATIONS[key](leaves)
        raise


def _orbax():
    try:
        import orbax.checkpoint as ocp
    except ImportError:
        raise ImportError("the orbax checkpoint backend needs the optional "
                          "orbax-checkpoint package; save_state/load_state "
                          "need nothing beyond numpy") from None
    return ocp


def save_state_orbax(path, state, step=0):
    """Orbax backend: async-capable, handles sharded (mesh) state leaves
    natively. ``path`` is a directory. Treedef goes in a sidecar pickle
    (orbax restores raw containers, not NamedTuples)."""
    import os
    ocp = _orbax()

    path = os.path.abspath(path)
    leaves, treedef = jax.tree_util.tree_flatten(state)
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(os.path.join(path, "state"),
                   {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)},
                   force=True)
    with open(os.path.join(path, "meta.pkl"), "wb") as f:
        pickle.dump({"treedef": treedef, "step": int(step),
                     "schema": _schema_tag(state)}, f)


def load_state_orbax(path):
    """Load a checkpoint saved by :func:`save_state_orbax` → (state, step)."""
    import os
    ocp = _orbax()

    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.pkl"), "rb") as f:
        meta = pickle.load(f)
    with ocp.StandardCheckpointer() as ckptr:
        restored = ckptr.restore(os.path.join(path, "state"))
    n = len(restored)
    leaves = [jax.numpy.asarray(restored[f"leaf_{i}"]) for i in range(n)]
    return (_unflatten_migrating(meta["treedef"], leaves,
                                 meta.get("schema")), meta["step"])


def save_sampler(path, sampler):
    """Checkpoint an API-level sampler (state + step counter)."""
    save_state(path, sampler.final_state, step=sampler._steps_run)


def restore_sampler(path, sampler):
    """Restore a checkpoint into a freshly constructed sampler.

    The sampler must be built with the same configuration; its next
    ``run_mcmc`` continues from the restored state and step count.
    """
    state, step = load_state(path)
    n_ck = getattr(state, "x", getattr(state, "theta", None))
    if n_ck is None:  # tempered: positions live on state.kernel
        kern = getattr(state, "kernel", None)
        n_ck = getattr(kern, "theta", getattr(kern, "x", None))
    # leading axes: [n_chains, d], or [n_temps, n_chains, d] for tempered
    want = (getattr(sampler, "n_temps", None), sampler.n_chains) \
        if hasattr(sampler, "n_temps") else (sampler.n_chains,)
    if n_ck is not None and hasattr(sampler, "n_chains") and (
            n_ck.ndim != len(want) + 1
            or tuple(n_ck.shape[:len(want)]) != want):
        # too few leading axes is as wrong as a mismatched count: e.g. a
        # plain [n_chains, d] RW checkpoint restored into a tempered
        # sampler would otherwise fail later with an opaque vmap error
        raise ValueError(
            f"checkpoint position shape {tuple(n_ck.shape)} does not match "
            f"sampler layout {want} + (d,)")
    sampler._final_state = state
    sampler._steps_run = step
    return sampler
