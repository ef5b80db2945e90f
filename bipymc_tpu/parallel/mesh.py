"""Device mesh construction for chain-level data parallelism.

The reference's only parallelism strategy is chain-level data parallelism
over an mpi4py pool (SURVEY.md §3.1). Its accelerator-native equivalent: a 1-D
``jax.sharding.Mesh`` with a ``"chains"`` axis; the population's chain axis
is sharded over it and XLA lowers the step's collectives onto ICI. For
multi-host pods, call ``jax.distributed.initialize()`` before building the
mesh — the same code then spans slices (DCN between them).
"""

import jax
import numpy as np
from jax.sharding import Mesh

CHAIN_AXIS = "chains"


def chain_mesh(devices=None, axis_name: str = CHAIN_AXIS) -> Mesh:
    """1-D mesh over ``devices`` (default: all local devices).

    ``devices`` may also be an int: the first n local devices.
    """
    if devices is None:
        devices = jax.devices()
    elif isinstance(devices, int):
        avail = jax.devices()
        if devices > len(avail):
            raise ValueError(
                f"chain_mesh({devices}): only {len(avail)} devices available")
        devices = avail[:devices]
    return Mesh(np.array(devices), (axis_name,))


def init_distributed(**kw) -> Mesh:
    """Multi-host entry point: initialise jax.distributed and return the
    global chain mesh.

    Call once per host process before any device use (the reference's
    ``mpiexec`` launch becomes one ``init_distributed()`` per host;
    coordinator address etc. flow through jax.distributed.initialize
    kwargs or cluster env vars). Collectives then ride ICI within a slice
    and DCN across slices (SURVEY.md §3.2).
    """
    jax.distributed.initialize(**kw)
    return chain_mesh()
