"""Regression net for the driver entry points.

Round-1 failure mode: ``dryrun_multichip`` died at import time because a
module-level ``jnp.log`` initialised the default backend (the accelerator)
before the CPU pin could take effect. These tests run the entry point in a
subprocess with an accelerator-default-shaped environment (no
JAX_PLATFORMS, no XLA_FLAGS) to prove the import chain is device-free and
the dryrun pins the CPU platform by itself.
"""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean_env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    # keep the subprocess off any real accelerator plugin: simulate the
    # bench host being unreachable by not giving it a platform hint at all
    return env


def test_import_is_device_free():
    """Importing bipymc_tpu must not initialise any JAX backend."""
    code = (
        "import jax, bipymc_tpu\n"
        "import jax._src.xla_bridge as xb\n"
        "assert not xb._backends, f'backends initialised: {list(xb._backends)}'\n"
        "print('import clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=_clean_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "import clean" in r.stdout


def test_dryrun_multichip_subprocess():
    """dryrun_multichip(8) must self-pin CPU and pass with a bare env."""
    code = (
        "from __graft_entry__ import dryrun_multichip\n"
        "dryrun_multichip(8)\n"
        "import jax\n"
        "assert jax.devices()[0].platform == 'cpu'\n"
        "assert len(jax.devices()) >= 8\n"
        "print('dryrun ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=_clean_env(), capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr
    assert "dryrun ok" in r.stdout


def test_no_module_level_device_ops():
    """Static audit: no module-level jnp/jax.numpy calls in the package."""
    pkg = os.path.join(REPO, "bipymc_tpu")
    offenders = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), filename=path)
            for node in tree.body:  # module level statements only
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef, ast.Import,
                                     ast.ImportFrom)):
                    continue
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call):
                        src = ast.unparse(sub.func)
                        if src.startswith(("jnp.", "jax.numpy.",
                                           "jax.random.", "jax.jit",
                                           "jax.device")):
                            offenders.append(f"{path}: {ast.unparse(sub)}")
    assert not offenders, "\n".join(offenders)
