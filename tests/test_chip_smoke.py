"""chip_smoke.py off the card: it refuses the CPU, and its four-card phases
run on four virtual CPU devices."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_without_a_gpu(tmp_path, alone):
    """Under JAX_PLATFORMS=cpu, and in a directory holding only the script,
    it exits non-zero and prints no result."""
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_sharded_ba_on_four_virtual_devices():
    from velocity_tpu.ingest.synthetic import SyntheticClip

    clip = SyntheticClip(16, width=480, height=270)
    info = chip_smoke.phase_sharded_ba(clip, jax.devices()[:4], nc=8, nt=64)
    assert float(info["max_rel_diff"]) <= 1e-4


def test_sharded_tracking_on_four_virtual_devices():
    from velocity_tpu.ingest.synthetic import SyntheticClip

    clip = SyntheticClip(2, width=640, height=360)
    info = chip_smoke.phase_sharded_tracking(clip, jax.devices()[:4], n_points=128)
    assert info["shards"] == 4 and info["stage3_tracked"] > 0
