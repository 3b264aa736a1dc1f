"""End to end on a reduced synthetic clip: 960x540 (native_scale 0.25), 8
frames, through the scan and per-frame drivers, with OpenCV unimportable (a
synthetic clip needs no decoder, and the feature-match rescue must not run)."""

import sys

import numpy as np
import pytest

from velocity_tpu.config import PipelineConfig, SolverConfig, TrackerConfig
from velocity_tpu.ingest.synthetic import SyntheticClip

N_FRAMES = 8
BAND = 0.03  # chip_smoke.SPEED_BAND


@pytest.fixture(scope="module")
def clip():
    return SyntheticClip(N_FRAMES, width=960, height=540)


@pytest.fixture(scope="module")
def cfg(clip):
    return PipelineConfig(
        solver=SolverConfig(dtype="float32"), native_scale=clip.native_scale,
        tracker=TrackerConfig(max_features=256, ransac_trials=256))


@pytest.fixture
def no_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)


def _check(res, clip):
    gt = float(clip.speed_kmh[1])
    assert abs(res.speed_kmh - gt) <= BAND * gt, res.speed_kmh
    assert res.residual_px < 1.5
    assert res.rescues == 0
    assert np.isfinite(res.S[1:, [3, 8]]).all()
    np.testing.assert_allclose(res.B[:, 12], clip.times[:N_FRAMES])
    assert res.valid.shape == (N_FRAMES, 256)


def test_scan_driver(clip, cfg, no_cv2):
    from velocity_tpu.pipeline.scan import ScanSpeedRunner

    res = ScanSpeedRunner(cfg).run(clip, annotation=clip.annotation, verbose=False,
                                   n_frames=N_FRAMES)
    _check(res, clip)


def test_per_frame_driver(clip, cfg, no_cv2):
    from velocity_tpu.pipeline.speedest import SpeedEstimator

    res = SpeedEstimator(cfg).run(clip, annotation=clip.annotation, verbose=False,
                                  n_frames=N_FRAMES)
    _check(res, clip)
