"""Seeded synthetic clip: a car receding from a static hand-held camera.

The clip is rendered in numpy alone, so the pipeline has an input wherever it
runs, with exact ground truth. The scene follows the reference clips
(BASELINE.md, IMG_4134 at 39.89 km/h):

- the camera is an iPhone 6s filming 29.97 fps video; the renderer projects
  with exactly the intrinsics the pipeline derives, ``cam.intrinsics(scale)``
  (focal about 1994 px and principal point (960.5, 540.5) at 1920x1080);
- the car's rear is one textured plane, yawed about 10 degrees, carrying a
  Chile plate (dark glyphs and border on a light ground); it starts about 6 m
  away, slightly off-axis, and recedes along the optical axis at 40 km/h;
- behind it, a static low-pass-textured plane at about 25 m; with a still
  camera its depth does not change the image (the reference clips have
  blurred backgrounds with a single motion group, ``config.py``);
- Gaussian sensor noise of about 2 DN.

Each pixel is inverse-warped through the car plane's homography with bilinear
sampling of the car texture, prefiltered for the frame's range so that a
pixel integrates the texels it covers (as a sensor does) instead of aliasing
them; the car covers the background. Frames are grayscale uint8.

``SyntheticClip`` has the duck-typed interface of ``ingest.video.VideoReader``
(``info``, ``frames``, ``prefetch``, ``release``, context manager), so every
driver takes it where it takes a video path. Frame ``i`` depends only on the
seed and ``i``.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from velocity_tpu.camera.annotations import Annotation
from velocity_tpu.camera.database import CameraInfo, camera_info
from velocity_tpu.geometry.plate import PLATE_SIZES, license_plate_points
from velocity_tpu.ingest.video import Frame, prefetch_frames

FPS = 29.97
# car-texture sample spacing: a little under a pixel at 6 m and 1080p; the
# plate's sides are whole multiples of it, so its edges fall between texels
TEXEL_M = 0.0025
CAR_U = (-0.90, 0.90)  # car rear extent in plate-centred plane coordinates (m)
CAR_V = (-0.85, 0.30)  # v points down; the plate sits low on the rear


# scene geometry, in metres in the camera frame (x right, y down, z forward)
START = (0.6, 0.9, 6.0)  # plate centre in frame 0
YAW_DEG = 10.0  # car-rear plane about the camera's y axis
SPEED_KMH = 40.0  # recession along +z
NOISE_DN = 2.0  # Gaussian sensor noise


def _blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian blur by FFT (periodic borders)."""
    h, w = img.shape
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    g = np.exp(-2.0 * np.pi**2 * sigma**2 * (fy * fy + fx * fx))
    return np.fft.irfft2(np.fft.rfft2(img) * g, s=img.shape)


def _lowpass_noise(rng, shape, sigmas_weights) -> np.ndarray:
    """Sum of Gaussian-filtered white noise at several scales, normalised to
    zero mean and unit standard deviation."""
    out = np.zeros(shape)
    for sigma, weight in sigmas_weights:
        layer = _blur(rng.standard_normal(shape), sigma)
        out += weight * layer / layer.std()
    return (out - out.mean()) / out.std()


def _plate_texture(rng, nv: int, nu: int) -> np.ndarray:
    """Light plate ground with a dark border and six blocky dark glyphs."""
    tex = np.full((nv, nu), 205.0)
    b = max(1, round(nv * 0.08))
    tex[:b], tex[-b:], tex[:, :b], tex[:, -b:] = 35.0, 35.0, 35.0, 35.0
    gh, gw = round(nv * 0.55), round(nu * 0.11)
    top = (nv - gh) // 2
    for k in range(6):
        bits = rng.random((7, 5)) < 0.55
        bits[0, :] |= bits[0, :].sum() == 0
        glyph = np.kron(bits, np.ones((-(-gh // 7), -(-gw // 5))))[:gh, :gw]
        left = round(nu * (0.09 + 0.14 * k))
        tex[top : top + gh, left : left + gw][glyph > 0] = 30.0
    return tex


def _bilinear(tex: np.ndarray, r: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Sample ``tex`` at fractional (row, col), edge-clamped."""
    h, w = tex.shape
    r = np.clip(r, 0.0, h - 1.0)
    c = np.clip(c, 0.0, w - 1.0)
    r0 = np.minimum(r.astype(np.int64), h - 2)
    c0 = np.minimum(c.astype(np.int64), w - 2)
    ar, ac = r - r0, c - c0
    top = tex[r0, c0] * (1 - ac) + tex[r0, c0 + 1] * ac
    bot = tex[r0 + 1, c0] * (1 - ac) + tex[r0 + 1, c0 + 1] * ac
    return top * (1 - ar) + bot * ar


class SyntheticClip:
    """A rendered clip with exact ground truth (see module docstring).

    Attributes:
      info: ``CameraInfo`` of an iPhone 6s video at ``width`` x ``height``.
      native_scale: video width over the 4K width the annotation is given in
        (the ``PipelineConfig.native_scale`` to run this clip with).
      annotation: plate corners of frame 0 in native-4K pixels, clockwise
        from top-right, ``start_frame=0``.
      rotation: (3, 3) car-plane axes (u right, v down, normal) as columns,
        in camera coordinates.
      translations: (n, 3) plate centre in camera coordinates per frame.
      speed_kmh: (n,) ground-truth speed from consecutive translations
        (NaN at frame 0).
    """

    def __init__(self, n_frames: int = 20, seed: int = 0, width: int = 1920,
                 height: int = 1080):
        self.n_frames = n_frames
        self.seed = seed
        self.path = f"synthetic_seed{seed}_{width}x{height}.mov"
        self.info: CameraInfo = camera_info(
            self.path, "iPhone 6s", width=width, height=height, fps=FPS,
            frame_count=n_frames)
        self.native_scale = width / self.info.spec.video_size[0]
        intr = self.info.intrinsics(scale=self.native_scale)
        self._f = float(intr.fx)
        self._c = (float(intr.cx), float(intr.cy))

        yaw = np.deg2rad(YAW_DEG)
        self.rotation = np.array([[np.cos(yaw), 0.0, np.sin(yaw)],
                            [0.0, 1.0, 0.0],
                            [-np.sin(yaw), 0.0, np.cos(yaw)]])
        step = SPEED_KMH / 3.6 / FPS
        self.translations = (np.asarray(START)[None, :]
                             + np.arange(n_frames)[:, None] * np.array([0.0, 0.0, step]))
        self.times = np.arange(n_frames) / FPS
        dr = np.linalg.norm(np.diff(self.translations, axis=0), axis=1)
        self.speed_kmh = np.concatenate([[np.nan], dr / np.diff(self.times) * 3.6])

        rng = np.random.default_rng([seed, 0])
        nu = round((CAR_U[1] - CAR_U[0]) / TEXEL_M) + 1
        nv = round((CAR_V[1] - CAR_V[0]) / TEXEL_M) + 1
        car = 110.0 + 45.0 * _lowpass_noise(
            rng, (nv, nu), ((3.0, 1.0), (8.0, 0.8), (24.0, 0.8)))
        pw, ph = PLATE_SIZES["Chile"]
        # first texel centre inside the plate; its edges lie half a texel out
        pu0 = round((-pw / 2 - CAR_U[0]) / TEXEL_M + 0.5)
        pv0 = round((-ph / 2 - CAR_V[0]) / TEXEL_M + 0.5)
        pnu, pnv = round(pw / TEXEL_M), round(ph / TEXEL_M)
        car[pv0 : pv0 + pnv, pu0 : pu0 + pnu] = _plate_texture(rng, pnv, pnu)
        self._car = car
        self._background = (120.0 + 22.0 * _lowpass_noise(
            rng, (height, width), ((12.0 * width / 1920, 1.0),
                                   (40.0 * width / 1920, 1.0)))).astype(np.float32)

        q = self.project(self.car_points(license_plate_points("Chile", np.float64)[:, :2], 0))
        self.annotation = Annotation(
            q=(q / self.native_scale).astype(np.float32), fname=self.path,
            start_frame=0)

    # ---------------------------------------------------------------- geometry
    def project(self, pc: np.ndarray) -> np.ndarray:
        """Pixels (..., 2) of camera-frame points (..., 3)."""
        f, (cx, cy) = self._f, self._c
        return np.stack([f * pc[..., 0] / pc[..., 2] + cx,
                         f * pc[..., 1] / pc[..., 2] + cy], axis=-1)

    def car_points(self, uv: np.ndarray, i: int) -> np.ndarray:
        """Camera-frame points (..., 3) in frame ``i`` of car-plane
        coordinates ``uv`` (..., 2), metres from the plate centre."""
        R = self.rotation
        return uv[..., 0:1] * R[:, 0] + uv[..., 1:2] * R[:, 1] + self.translations[i]

    def render(self, i: int) -> np.ndarray:
        """Frame ``i`` as (H, W) uint8."""
        H, W = int(self.info.height), int(self.info.width)
        img = self._background.astype(np.float64)
        T = self.translations[i]
        eu, ev, n = self.rotation[:, 0], self.rotation[:, 1], self.rotation[:, 2]
        # the car rectangle's projected bounding box bounds the work
        box = self.project(self.car_points(
            np.array([[u, v] for u in CAR_U for v in CAR_V]), i))
        x0, y0 = np.maximum(np.floor(box.min(axis=0)).astype(int) - 1, 0)
        x1, y1 = np.minimum(np.ceil(box.max(axis=0)).astype(int) + 2, [W, H])
        if x1 > x0 and y1 > y0:
            f, (cx, cy) = self._f, self._c
            ys, xs = np.mgrid[y0:y1, x0:x1]
            d = np.stack([(xs - cx) / f, (ys - cy) / f, np.ones(xs.shape)], -1)
            s = (n @ T) / (d @ n)  # ray-plane intersection depth
            rel = s[..., None] * d - T
            u, v = rel @ eu, rel @ ev
            inside = (u >= CAR_U[0]) & (u <= CAR_U[1]) & (v >= CAR_V[0]) & (v <= CAR_V[1])
            # a pixel spans ``m`` texels at this range: Gaussian prefilter of
            # half a pixel, on top of a 0.7-texel optical blur
            m = T[2] / f / TEXEL_M
            car = _blur(self._car, float(np.hypot(0.7, 0.5 * m)))
            tex = _bilinear(car, (v - CAR_V[0]) / TEXEL_M, (u - CAR_U[0]) / TEXEL_M)
            sub = img[y0:y1, x0:x1]
            img[y0:y1, x0:x1] = np.where(inside, tex, sub)
        noise = np.random.default_rng([self.seed, 1, i]).standard_normal((H, W))
        img = img + NOISE_DN * noise
        return np.clip(np.rint(img), 0, 255).astype(np.uint8)

    # ------------------------------------------------------ reader interface
    def frames(self, start: int = 0, count: int | None = None,
               step: int = 1) -> Iterator[Frame]:
        """Yield ``count`` frames from ``start``, every ``step`` th."""
        i = start
        k = 0
        while i < self.n_frames and (count is None or k < count):
            yield Frame(index=i, time_s=float(self.times[i]), gray=self.render(i))
            i += step
            k += 1

    def prefetch(self, start: int = 0, count: int | None = None, step: int = 1,
                 depth: int = 4) -> Iterator[Frame]:
        """Like ``frames`` but rendered on a background thread."""
        return prefetch_frames(self.frames(start, count, step), depth)

    def release(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()

