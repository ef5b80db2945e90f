"""float64 end-to-end: the dtype knob (SURVEY.md §9 precision policy).

x64 must be enabled before jax initialises, so the run happens in a
subprocess; it drives one single-chain (DRAM) and one ensemble (DREAM-zs)
sampler and asserts dtype propagation plus posterior recovery.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp
import bipymc_tpu as bp
from bipymc_tpu.models.targets import correlated_gaussian

MEAN = jnp.array([1.0, -1.0]); COV = jnp.array([[1.0, 0.8], [0.8, 1.5]])
lp = correlated_gaussian(MEAN, COV)

s = bp.Dram(lp, seed=0, n_chains=4, dtype=jnp.float64)
s.run_mcmc(4000, jnp.zeros(2, jnp.float64), cov_est=jnp.eye(2))
flat = s.get_chain(discard=1500, flat=True)
assert flat.dtype == np.float64, flat.dtype
assert np.abs(flat.mean(0) - np.asarray(MEAN)).max() < 0.3

z = bp.DreamZs(lp, n_chains=8, seed=1, dtype=jnp.float64)
z.run_mcmc(3000, MEAN.astype(jnp.float64), spread=2.0)
zf = z.get_chain(discard=1000, flat=True)
assert zf.dtype == np.float64, zf.dtype
assert np.abs(zf.mean(0) - np.asarray(MEAN)).max() < 0.3

# pairwise_sqdist must keep f64 precision for f64 inputs: points 1e4
# apart by 1e-3 lose the spacing entirely if squeezed through f32
from bipymc_tpu.ops.distance import pairwise_sqdist
x = jnp.asarray([[1.0e4], [1.0e4 + 1.0e-3]], jnp.float64)
r2 = pairwise_sqdist(x)
assert r2.dtype == jnp.float64, r2.dtype
assert abs(float(r2[0, 1]) - 1.0e-6) < 1.0e-12, float(r2[0, 1])
print("F64 OK")
"""


def test_float64_samplers():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "F64 OK" in r.stdout
