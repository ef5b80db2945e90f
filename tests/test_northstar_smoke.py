"""The north-star pipeline harness (benchmarks/northstar_config3.py)
stays runnable: BENCH_SMOKE subprocess must converge and satisfy the
acceptance thresholds at smoke scale. Protects the bench.py phase-3
path from bitrot; full scale runs on the GPU (chip_smoke.py)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_northstar_smoke_pipeline_converges():
    env = dict(os.environ, BENCH_SMOKE="1", JAX_PLATFORMS="cpu")
    env.pop("BIPYMC_GPU_TESTS", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks",
                                      "northstar_config3.py")],
        capture_output=True, text=True, timeout=540, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["converged"], res
    assert res["crossmode_split_rhat"] < 1.1, res
    assert res["mode_weight_abs_err"] < 0.05, res
    assert res["northstar_wall_s"] > 0


def test_write_artifact_merges_and_records_cache_ab(tmp_path, monkeypatch):
    """The shared artifact writer:
    preserves arms not re-measured, keeps the compilation_cache key,
    and records the second-process cache A/B fields only when the
    headline arm was measured fresh against a prior result."""
    import importlib.util
    import jax
    spec = importlib.util.spec_from_file_location(
        "northstar_config3",
        os.path.join(REPO, "benchmarks", "northstar_config3.py"))
    ns = importlib.util.module_from_spec(spec)
    monkeypatch.setenv("BENCH_SMOKE", "1")   # module-level SMOKE flag
    spec.loader.exec_module(ns)
    monkeypatch.setattr(ns, "HERE", str(tmp_path))
    monkeypatch.setattr(
        ns, "artifact_path",
        lambda: os.path.join(str(tmp_path), "art.json"))

    # first process: discovered only
    out1 = ns.write_artifact({"discovered": {"cold_total_s": 10.0}})
    assert out1["headline"] == "discovered"
    assert "compilation_cache" in out1

    # second process adds oracle; discovered preserved, no A/B fields
    # on discovered (it was not re-measured)
    out2 = ns.write_artifact({"oracle": {"cold_total_s": 7.0}})
    assert set(out2["arms"]) == {"discovered", "oracle"}
    assert out2["headline"] == "discovered"
    assert "cold_total_s_warm_cache" not in out2["arms"]["discovered"]

    # third process re-measures discovered -> cache A/B recorded
    out3 = ns.write_artifact({"discovered": {"cold_total_s": 4.0}})
    d = out3["arms"]["discovered"]
    assert d["cold_total_s_first_process"] == 10.0
    assert d["cold_total_s_warm_cache"] == 4.0
    assert "oracle" in out3["arms"]
