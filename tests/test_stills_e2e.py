"""Stills-burst pipeline: georegistration units (fast) + end-to-end run (slow).

The reference's stills path is vidExample.py:25-29,92-95 (tracking/speed) plus
the MATLAB driver's EXIF/GPS georegistration (runExample.m:49-50,156-159). GT
for the IMG_4122-4133 burst is ~40 km/h (vidExample.py:26 comment).
"""

from pathlib import Path

import numpy as np
import pytest

from velocity_tpu.pipeline.stills import georegister_track

DATA = Path("/root/reference/data")
STILLS = sorted(DATA.glob("IMG_41[2-3][0-9].JPG"))
HAVE_DATA = len(STILLS) >= 6


class TestGeoregister:
    def _make_B(self, n=5):
        B = np.zeros((n, 14))
        # synthetic SfM track: car drives +z (camera forward) at 1 m/frame
        B[:, 2] = 8.0 + np.arange(n)
        B[:, 0] = 0.5  # slight right offset
        # GPS fixes: camera walking north-ish in Santiago
        lat0, lon0, alt0 = -33.45, -70.66, 520.0
        B[:, 9] = lat0 + 1e-6 * np.arange(n)
        B[:, 10] = lon0
        B[:, 11] = alt0
        return B

    def test_zero_yaw_maps_camera_axes_to_ned(self):
        B = self._make_B()
        cam_ned, car_ned = georegister_track(B.copy(), yaw_deg=0.0)
        # camera z (forward) -> North, x (right) -> East
        got = car_ned[0]
        np.testing.assert_allclose(got, [8.0, 0.5, 0.0], atol=1e-9)

    def test_yaw_rotates_heading(self):
        B = self._make_B()
        _, car_n = georegister_track(B.copy(), yaw_deg=0.0)
        _, car_e = georegister_track(B.copy(), yaw_deg=90.0)
        # 90 deg heading turns the north component into east
        np.testing.assert_allclose(car_e[0][1], car_n[0][0], atol=1e-9)
        np.testing.assert_allclose(car_e[0][0], -car_n[0][1], atol=1e-9)

    def test_ecef_lla_roundtrip_consistency(self):
        B = self._make_B()
        georegister_track(B, yaw_deg=30.0)
        from velocity_tpu.geometry.geodesy import lla_to_ecef

        np.testing.assert_allclose(
            lla_to_ecef(B[:, 9:12]), B[:, 6:9], atol=1e-3)

    def test_cam_ned_returned_and_consistent(self):
        B = self._make_B()
        cam_ned, _ = georegister_track(B.copy(), yaw_deg=None)
        # ~1e-6 deg of latitude is ~0.111 m north per frame
        d = np.diff(cam_ned[:, 0])
        np.testing.assert_allclose(d, 0.1112, atol=2e-3)


@pytest.mark.slow
@pytest.mark.skipif(not HAVE_DATA, reason="reference stills not mounted")
class TestStillsEndToEnd:
    def test_burst_speed(self):
        from velocity_tpu.config import PipelineConfig, SolverConfig
        from velocity_tpu.pipeline.stills import StillsSpeedEstimator

        cfg = PipelineConfig(native_scale=1.0,
                             solver=SolverConfig(dtype="float32"))
        est = StillsSpeedEstimator(cfg)
        ann = DATA.parent / "matlab" / "IMG_4122.JPG.mat"
        res = est.run([str(p) for p in STILLS], annotation=str(ann),
                      verbose=False)
        # GT ~= 40 km/h (vidExample.py:26); +/-10% band. Round-5
        # measurement: 41.10 +/- 2.90 km/h, residual 0.88 px.
        assert 36.0 < res.speed_kmh < 44.0, res.speed_kmh
        # the post-MSV pose solve must run from a populated car structure
        # (the pre-round-5 pipeline decayed to 3 background-free tracks)
        assert res.S[6:, 2].min() >= 50, res.S[:, 2]
        # georegistration filled the earth-frame columns
        assert np.any(res.B[:, 6:9] != 0)


if __name__ == "__main__":
    pytest.main([__file__, "-q"])
