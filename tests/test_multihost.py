"""Multi-host path: 2-process jax.distributed smoke (SURVEY.md §3.2).

The reference scales across nodes with ``mpiexec -n K``; the accelerator-native
equivalent is one ``init_distributed()`` per host joining a coordinator,
after which the same mesh/shard_map code spans processes (ICI within a
slice, DCN between slices). This launches two OS processes on this host
with 2 virtual CPU devices each and checks a global-mesh collective.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_psum():
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    # the worker is a script, so sys.path[0] is tests/ — make the package
    # importable without requiring an editable install
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, coord, "2", str(pid)],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert "global psum OK" in out, out
        # verdict #3: a SAMPLER generation (not just a psum) must cross
        # the process boundary, bit-identical to the single-process run
        assert "cross-process DREAM-zs run bit-identical" in out, out
        assert "cross-process FUSED engine bit-identical" in out, out
