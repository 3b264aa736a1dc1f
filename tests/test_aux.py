"""Aux subsystem tests: report format, profiling, checkpoint, native loader,
CLI plumbing, robust stats on pipeline shapes."""

from pathlib import Path

import numpy as np
import pytest

from velocity_tpu.pipeline import report
from velocity_tpu.pipeline.roi import bounding_rect, inside_bbox
from velocity_tpu.utils import StageTimer, filename_split
from velocity_tpu.parallel.checkpoint import WindowState, save_state, load_state

HAVE_DATA = Path("/root/reference/data/IMG_4134.MOV").exists()


class TestReport:
    def test_header_matches_reference_layout(self):
        h = report.header()
        # two lines of 9 right-aligned 13-wide columns
        lines = [ln for ln in h.split("\n") if ln]
        assert len(lines) == 2
        assert all(len(ln) == 13 * 9 for ln in lines)
        assert "pointTracks" in lines[0] and "(km/h)" in lines[1]

    def test_row_format(self):
        r = report.row([1, 0.123, 151, 0.876, 0.033, 0.5, 0.37, 3.7, 39.9])
        assert len(r) == 13 * 9
        assert r.endswith("39.9")

    def test_summary(self):
        S = np.zeros((3, 9))
        S[1:, 8] = [40.0, 38.0]
        S[1:, 3] = [0.9, 1.1]
        s = report.summary(S)
        assert "39.00" in s and "1.000" in s

    def test_polyfit_speed_recovers_polynomial_motion(self):
        # distance d(t) = 5t + t^2 -> speed (m/s) = 5 + 2t, exactly recovered
        # by the MATLAB-parity polyfit smoothing (runExample.m:185-190)
        n = 12
        S = np.zeros((n, 9))
        t = np.arange(n) * 0.1
        S[:, 5] = t
        S[:, 7] = 5 * t + t**2
        # noisy per-frame speeds the fit should NOT depend on
        S[:, 8] = np.nan
        dist_fit, speed_fit = report.polyfit_speed(S, degree=2)
        np.testing.assert_allclose(dist_fit, S[:, 7], atol=1e-9)
        np.testing.assert_allclose(speed_fit, (5 + 2 * t) * 3.6, atol=1e-8)

    def test_polyfit_speed_short_input_passthrough(self):
        S = np.zeros((2, 9))
        S[:, 5] = [0.0, 0.1]
        S[:, 7] = [0.0, 1.0]
        S[:, 8] = [np.nan, 36.0]
        d, v = report.polyfit_speed(S, degree=3)
        np.testing.assert_allclose(d, S[:, 7])
        np.testing.assert_allclose(v, S[:, 8])


class TestROI:
    def test_bounding_rect_matches_cv2(self):
        import cv2

        rng = np.random.default_rng(0)
        for _ in range(20):
            pts = rng.uniform(10, 500, (6, 2)).astype(np.float32)
            x, y, w, h = cv2.boundingRect(pts)
            x0, x1, y0, y1 = bounding_rect(pts, (1080, 1920), border=(0, 0))
            assert (x0, y0) == (x, y)
            assert (x1, y1) == (x + w, y + h)

    def test_clamping(self):
        pts = np.array([[5.0, 3.0], [2000.0, 1100.0]], np.float32)
        x0, x1, y0, y1 = bounding_rect(pts, (1080, 1920), border=(50, 50))
        assert x0 == 1 and y0 == 1 and x1 == 1920 and y1 == 1080

    def test_inside_bbox(self):
        box = (10, 20, 10, 20)
        pts = np.array([[15, 15], [10, 15], [25, 15]])
        np.testing.assert_array_equal(inside_bbox(pts, box), [True, False, False])


class TestUtils:
    def test_filename_split(self):
        p, stem, ext, name = filename_split("/a/b/IMG_4134.MOV")
        assert (p, stem, ext, name) == ("/a/b/", "IMG_4134", ".MOV", "IMG_4134.MOV")

    def test_stage_timer(self):
        t = StageTimer()
        with t.stage("x"):
            pass
        with t.stage("x"):
            pass
        assert t.counts["x"] == 2
        assert "x" in t.report()


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        st = WindowState(
            frame_index=42,
            points=np.random.rand(8, 2).astype(np.float32),
            valid=np.array([True] * 6 + [False] * 2),
            valid_pose=np.array([True] * 4 + [False] * 4),
            p3=np.random.rand(8, 3),
            B=np.random.rand(5, 14),
            S=np.random.rand(5, 9),
            meta={"video": "IMG_4134.MOV"},
        )
        save_state(tmp_path / "w.npz", st)
        st2 = load_state(tmp_path / "w.npz")
        assert st2.frame_index == 42
        np.testing.assert_array_equal(st2.points, st.points)
        np.testing.assert_array_equal(st2.valid, st.valid)
        assert st2.meta["video"] == "IMG_4134.MOV"


@pytest.mark.skipif(not HAVE_DATA, reason="dataset not mounted")
class TestNativeLoader:
    def test_decode_matches_python_reader(self):
        from velocity_tpu.ingest.native_loader import NativeVideoStream, available

        if not available():
            pytest.skip("native loader unavailable")
        with NativeVideoStream(
            "/root/reference/data/IMG_4134.MOV", start=19, count=4
        ) as s:
            nat = list(s)
        assert [f[3] for f in nat] == [19, 20, 21, 22]
        # timestamps: frame/fps
        np.testing.assert_allclose(nat[0][2], 19 / 29.97, atol=1e-3)
        from velocity_tpu.ingest import open_video

        with open_video("/root/reference/data/IMG_4134.MOV") as vr:
            ref = list(vr.frames(start=19, count=1))[0]
        d = np.abs(ref.gray.astype(int) - nat[0][0].astype(int))
        assert d.mean() < 2.0  # codec-build rounding only
        # small image is the 1/4 decimation
        assert nat[0][1].shape == (270, 480)

    def test_throughput(self):
        import time
        from velocity_tpu.ingest.native_loader import NativeVideoStream, available

        if not available():
            pytest.skip("native loader unavailable")
        t0 = time.time()
        with NativeVideoStream(
            "/root/reference/data/IMG_4134.MOV", start=0, count=40
        ) as s:
            k = sum(1 for _ in s)
        fps = k / (time.time() - t0)
        assert k == 40 and fps > 20, fps


class TestCLI:
    def test_annotate_roundtrip(self, tmp_path):
        from velocity_tpu.cli import main
        from velocity_tpu.camera.annotations import load_annotation

        out = tmp_path / "X.MOV.npz"
        rc = main([
            "annotate", "--video", "X.MOV",
            "--corners", "10,20,30,40,50,60,70,80",
            "--start-frame", "5", "--out", str(out),
        ])
        assert rc == 0
        ann = load_annotation(out)
        assert ann.start_frame == 5
        np.testing.assert_allclose(ann.q[0], [10, 20])

    def test_help_runs(self):
        from velocity_tpu.cli import main

        with pytest.raises(SystemExit):
            main(["--help"])


if __name__ == "__main__":
    pytest.main([__file__, "-q"])


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_location(tmp_path, from_env):
    """The package keeps its compilation cache where JAX_COMPILATION_CACHE_DIR
    says, and otherwise in <checkout>/.jax_cache."""
    import os
    import subprocess
    import sys

    repo = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(repo)
    if from_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    out = subprocess.run(
        [sys.executable, "-c",
         "import velocity_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120, check=True)
    want = tmp_path / "cache" if from_env else repo / ".jax_cache"
    assert Path(out.stdout.strip().splitlines()[-1]) == want
