"""Lanes-last LK vs the reference-path LK and cv2 (same oracles as lk_fast)."""

import numpy as np
import cv2
import jax.numpy as jnp
import pytest

from velocity_tpu.ops.lk import lk_pyramidal, lk_forward_backward
from velocity_tpu.ops.lk_lanes import lk_pyramidal_lanes, lk_forward_backward_lanes

RNG = np.random.default_rng(21)


def _smooth_image(h=240, w=320, blur=9):
    img = RNG.uniform(0, 255, (h, w)).astype(np.float32)
    return cv2.GaussianBlur(img, (blur, blur), 0)


def _interior_points(h, w, n, margin=50):
    return np.stack(
        [RNG.uniform(margin, w - margin, n), RNG.uniform(margin, h - margin, n)],
        axis=1,
    ).astype(np.float32)


class TestLanesMatchesReference:
    def test_plain_translation(self):
        img = _smooth_image()
        M = np.float32([[1, 0, 3.4], [0, 1, -2.6]])
        img2 = cv2.warpAffine(img, M, (img.shape[1], img.shape[0]))
        pts = _interior_points(*img.shape, 50)
        kw = dict(win=15, max_level=3, iters=10, eps=0.1)
        ref = lk_pyramidal(jnp.asarray(img), jnp.asarray(img2), jnp.asarray(pts), **kw)
        fast = lk_pyramidal_lanes(jnp.asarray(img), jnp.asarray(img2), jnp.asarray(pts), **kw)
        both = np.asarray(ref.status) & np.asarray(fast.status)
        assert both.mean() > 0.9
        d = np.linalg.norm(np.asarray(ref.points)[both] - np.asarray(fast.points)[both], axis=1)
        assert np.median(d) < 0.05, np.median(d)
        assert (np.asarray(ref.status) == np.asarray(fast.status)).mean() > 0.9

    def test_large_translation_no_clamp(self):
        """Unlike lk_fast's search_radius clamp, big motions track through
        block re-anchoring (the suspected 60 km/h failure mode). Uses a
        multi-scale texture: pyramid tracking needs coarse structure (plain
        blurred noise defeats cv2 itself on a 40 px motion)."""
        h, w = 320, 480
        img = sum(
            cv2.GaussianBlur(RNG.uniform(0, 255, (h, w)).astype(np.float32),
                             (k, k), 0) * g
            for k, g in ((5, 1.0), (21, 4.0), (61, 16.0))
        )
        img = (img / img.max() * 255).astype(np.float32)
        M = np.float32([[1, 0, 34.0], [0, 1, -21.0]])
        img2 = cv2.warpAffine(img, M, (w, h))
        pts = _interior_points(h, w, 40, margin=80)
        kw = dict(win=21, max_level=3, iters=30, eps=0.01)
        fast = lk_pyramidal_lanes(jnp.asarray(img), jnp.asarray(img2), jnp.asarray(pts), **kw)
        st = np.asarray(fast.status)
        assert st.mean() >= 0.75
        err = np.linalg.norm(
            np.asarray(fast.points)[st] - (pts[st] + np.float32([34.0, -21.0])), axis=1
        )
        assert np.median(err) < 0.25, np.median(err)

    def test_affine_warp_prior(self):
        img = _smooth_image()
        M = np.float32([[1.03, 0.012, 6.0], [-0.01, 0.97, -4.0]])
        img2 = cv2.warpAffine(img, M, (img.shape[1], img.shape[0]))
        pts = _interior_points(*img.shape, 40)
        kw = dict(win=21, max_level=0, iters=30, eps=0.001)
        ref = lk_pyramidal(jnp.asarray(img), jnp.asarray(img2), jnp.asarray(pts),
                           warp_dst=jnp.asarray(M), **kw)
        fast = lk_pyramidal_lanes(jnp.asarray(img), jnp.asarray(img2), jnp.asarray(pts),
                                  warp_dst=jnp.asarray(M), **kw)
        both = np.asarray(ref.status) & np.asarray(fast.status)
        assert both.mean() > 0.85
        d = np.linalg.norm(np.asarray(ref.points)[both] - np.asarray(fast.points)[both], axis=1)
        assert np.median(d) < 0.05, np.median(d)
        err = np.linalg.norm(np.asarray(fast.points)[both] - pts[both], axis=1)
        assert np.median(err) < 0.1

    def test_identity_self_tracking_deep_pyramid(self):
        """Regression: slab-corner clamping at small pyramid levels used to
        shift content off the stencil anchor and walk points away (up to
        ~80 px at max_level=3 on a 240x320 image with zero motion)."""
        img = _smooth_image()
        pts = np.stack(
            [RNG.uniform(10, 310, 200), RNG.uniform(10, 230, 200)], axis=1
        ).astype(np.float32)
        for ml in (2, 3, 4):
            r = lk_pyramidal_lanes(
                jnp.asarray(img), jnp.asarray(img), jnp.asarray(pts),
                win=15, max_level=ml, iters=10, eps=0.1,
            )
            st = np.asarray(r.status)
            assert st.mean() > 0.95
            err = np.linalg.norm(np.asarray(r.points) - pts, axis=1)
            assert err[st].max() < 0.01, (ml, err[st].max())

    def test_forward_backward_gating(self):
        img = _smooth_image()
        img2 = img.copy()
        img2[:, 160:] = RNG.uniform(0, 255, (img.shape[0], 160))
        pts = _interior_points(*img.shape, 60)
        kw = dict(win=15, max_level=3, iters=30, eps=0.001)
        fast = lk_forward_backward_lanes(
            jnp.asarray(img), jnp.asarray(img2), jnp.asarray(pts),
            fb_threshold=0.3, **kw,
        )
        st = np.asarray(fast.status)
        assert st[pts[:, 0] < 120].mean() > 0.75
        assert st[pts[:, 0] > 200].mean() < 0.2

    def test_fb_with_warp_matches_reference_path(self):
        img = _smooth_image()
        M = np.float32([[1.02, 0.008, 5.0], [-0.006, 0.985, -3.0]])
        img2 = cv2.warpAffine(img, M, (img.shape[1], img.shape[0]))
        pts = _interior_points(*img.shape, 50)
        kw = dict(win=21, max_level=0, iters=30, eps=0.001)
        ref = lk_forward_backward(
            jnp.asarray(img), jnp.asarray(img2), jnp.asarray(pts),
            fb_threshold=0.3, warp_dst=jnp.asarray(M), **kw)
        fast = lk_forward_backward_lanes(
            jnp.asarray(img), jnp.asarray(img2), jnp.asarray(pts),
            fb_threshold=0.3, warp_dst=jnp.asarray(M), **kw)
        sref, sfast = np.asarray(ref.status), np.asarray(fast.status)
        assert (sref == sfast).mean() > 0.85, (sref.mean(), sfast.mean())
        both = sref & sfast
        d = np.linalg.norm(np.asarray(ref.points)[both] - np.asarray(fast.points)[both], axis=1)
        assert np.median(d) < 0.05

    def test_vs_cv2_on_real_frames(self):
        import pathlib
        if not pathlib.Path("/root/reference/data/IMG_4134.MOV").exists():
            pytest.skip("dataset not mounted")
        cap = cv2.VideoCapture("/root/reference/data/IMG_4134.MOV")
        cap.set(cv2.CAP_PROP_POS_FRAMES, 19)
        _, f1 = cap.read(); _, f2 = cap.read(); cap.release()
        im1 = cv2.cvtColor(f1, cv2.COLOR_BGR2GRAY)
        im2 = cv2.cvtColor(f2, cv2.COLOR_BGR2GRAY)
        pts = cv2.goodFeaturesToTrack(im1, 150, 0.01, 10, blockSize=5).squeeze(1)
        cvp, cvs, _ = cv2.calcOpticalFlowPyrLK(
            im1, im2, pts[:, None, :], None, winSize=(15, 15), maxLevel=4,
            criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 10, 0.1),
        )
        cvp, cvs = cvp.squeeze(1), cvs.squeeze(1).astype(bool)
        ours = lk_pyramidal_lanes(
            jnp.asarray(im1.astype(np.float32)), jnp.asarray(im2.astype(np.float32)),
            jnp.asarray(pts), win=15, max_level=4, iters=10, eps=0.1,
        )
        st = np.asarray(ours.status) & cvs
        assert st.mean() > 0.8
        d = np.linalg.norm(np.asarray(ours.points)[st] - cvp[st], axis=1)
        assert np.median(d) < 0.3, np.median(d)
        assert (d < 1.0).mean() > 0.85


@pytest.mark.parametrize("corners", [
    [[5, 7], [100, 40], [311, 230], [0, 0]],  # interior and the last valid corner
    [[-9, 4], [330, -3], [300, 250], [-20, 500]],  # past each border: clamped
])
def test_slab_extraction_matches_numpy_slicing(corners):
    from velocity_tpu.ops.lk_lanes import _extract_slabs

    img = RNG.uniform(0, 255, (240, 320)).astype(np.float32)
    size = 9
    slabs, cl = _extract_slabs(jnp.asarray(img), jnp.asarray(corners, jnp.int32), size)
    slabs, cl = np.asarray(slabs), np.asarray(cl)
    assert slabs.shape == (size, size, len(corners))
    for n, (x, y) in enumerate(corners):
        cx, cy = min(max(x, 0), 320 - size), min(max(y, 0), 240 - size)
        assert cl[n].tolist() == [cx, cy]
        np.testing.assert_array_equal(slabs[:, :, n], img[cy : cy + size, cx : cx + size])


def _synthetic_stage_case(width, height, n_points, stage):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from velocity_tpu.config import TrackerConfig
    from velocity_tpu.ingest.synthetic import SyntheticClip

    clip = SyntheticClip(2, width=width, height=height)
    f0, f1, pts = chip_smoke.lk_pair(clip, n_points, margin=width // 48)
    cfg = TrackerConfig()
    if stage == "coarse":
        m = chip_smoke.compare_lanes_to_oracle(f0, f1, pts, cfg.lk_coarse)
    else:
        m = chip_smoke.compare_lanes_to_oracle(f0, f1, pts, cfg.lk_fine,
                                               chip_smoke.car_affine(clip))
    chip_smoke.check_lk(m, stage)
    return m


@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_lanes_vs_oracle_on_synthetic_clip(stage):
    """The chip smoke's comparison at a CPU-sized shape: stage 1-2 (window 15
    on the pyramid) and stage 3 (window 51 through the car affine)."""
    m = _synthetic_stage_case(640, 360, 128, stage)
    assert m["tracked"] >= 100


@pytest.mark.gpu
@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_lanes_vs_oracle_at_1080p_on_gpu(stage):
    _synthetic_stage_case(1920, 1080, 1024, stage)
