"""chip_smoke.py's host-side pieces: the result line, the pytest summary
parser, and its refusals without a GPU or without the repository."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def test_last_line_names_the_device():
    devs = [SimpleNamespace(platform="gpu",
                            device_kind="NVIDIA H100 80GB HBM3")] * 4
    line = chip_smoke.last_line(devs)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


@pytest.mark.parametrize("summary,want", [
    ("12 passed, 450 deselected in 132.46s (0:02:12)", 12),
    ("=== 3 passed, 1 skipped in 2.0s ===", 3),
    ("1 failed, 2 passed in 3.1s", 2),
    ("450 deselected in 1.2s", 0),
    ("", 0),
])
def test_count_passed(summary, want):
    assert chip_smoke.count_passed(summary) == want


def test_card_line_needs_nvidia_smi(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(SystemExit):
        chip_smoke.card_line()


def test_fails_without_gpu_and_prints_no_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO,
                                                       "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_fails_alone_in_an_empty_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
