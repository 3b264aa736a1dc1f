"""The seeded synthetic clip: determinism, ground truth and reader interface."""

import numpy as np
import jax.numpy as jnp
import pytest

from velocity_tpu.geometry.plate import license_plate_points
from velocity_tpu.geometry.projection import world_to_image
from velocity_tpu.ingest.synthetic import FPS, SyntheticClip
from velocity_tpu.ingest.video import open_video


@pytest.fixture(scope="module")
def clip():
    return SyntheticClip(12, seed=3, width=480, height=270)


def test_seed_determinism_shape_dtype(clip):
    again = SyntheticClip(12, seed=3, width=480, height=270)
    other = SyntheticClip(12, seed=4, width=480, height=270)
    f, g, h = clip.render(5), again.render(5), other.render(5)
    assert f.shape == (270, 480) and f.dtype == np.uint8
    np.testing.assert_array_equal(f, g)
    assert np.abs(f.astype(int) - h.astype(int)).mean() > 5
    # a frame depends only on (seed, index), not on what was rendered before
    np.testing.assert_array_equal(clip.render(2), again.render(2))


def test_annotation_is_the_projected_plate(clip):
    """Frame-0 plate corners through the pipeline's own projection, with
    the intrinsics the pipeline derives, match the annotation."""
    intr = clip.info.intrinsics(scale=clip.native_scale).astype(jnp.float64)
    plate = license_plate_points("Chile", np.float64)
    want = np.asarray(world_to_image(intr, jnp.asarray(clip.rotation.T),
                                     jnp.asarray(clip.translations[0]),
                                     jnp.asarray(plate)))
    got = clip.annotation.q * clip.native_scale
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert clip.annotation.start_frame == 0
    # clockwise from top-right: TR, BR, BL, TL
    tr, br, bl, tl = got
    assert tr[0] > tl[0] and br[1] > tr[1] and bl[0] < br[0] and tl[1] < bl[1]


def test_ground_truth_speed_matches_translations(clip):
    step = np.linalg.norm(np.diff(clip.translations, axis=0), axis=1)
    np.testing.assert_allclose(clip.speed_kmh[1:], step * FPS * 3.6, rtol=1e-12)
    np.testing.assert_allclose(clip.speed_kmh[1:], 40.0, rtol=1e-9)
    assert np.isnan(clip.speed_kmh[0])
    assert clip.native_scale == 480 / 3840
    assert float(clip.info.intrinsics(scale=clip.native_scale).fx) == pytest.approx(
        3486.0 * np.hypot(4032, 3024) / np.hypot(3840, 2160) / 8)


def test_reader_indices_and_timestamps(clip):
    frames = list(clip.frames(start=3, count=4, step=2))
    assert [f.index for f in frames] == [3, 5, 7, 9]
    np.testing.assert_allclose([f.time_s for f in frames], np.array([3, 5, 7, 9]) / FPS)
    np.testing.assert_array_equal(frames[1].gray, clip.render(5))
    pre = list(clip.prefetch(start=3, count=4, step=2))
    assert [f.index for f in pre] == [3, 5, 7, 9]
    # reading stops at the end of the clip
    assert [f.index for f in clip.frames(start=10)] == [10, 11]
    with open_video(clip) as vr:
        assert vr is clip and vr.info.frame_count == 12


def test_car_recedes_over_a_static_background(clip):
    f0, f9 = clip.render(0).astype(float), clip.render(9).astype(float)
    # top-left corner: background only, the same up to sensor noise
    np.testing.assert_allclose(f0[:20, :20], f9[:20, :20], atol=15)
    corners = license_plate_points("Chile", np.float64)[:, :2]
    w0 = np.ptp(clip.project(clip.car_points(corners, 0))[:, 0])
    w9 = np.ptp(clip.project(clip.car_points(corners, 9))[:, 0])
    assert w9 / w0 == pytest.approx(clip.translations[0, 2] / clip.translations[9, 2],
                                    rel=0.02)
    assert not np.array_equal(f0, f9)


def test_video_path_without_opencv_names_the_module(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        open_video(str(tmp_path / "clip.MOV"))
