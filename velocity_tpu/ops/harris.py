"""Harris corner detection, top-k selection, and subpixel refinement.

Parity targets:
- ``harris_response``/``good_features`` <-> cv2.goodFeaturesToTrack(useHarrisDetector=True,
  blockSize=5, qualityLevel=0.01, minDistance=0) as used at vidExample.py:110.
  Sobel-3 derivatives with OpenCV's normalization (1/(2^(ksize-1)*block*255) for
  8-bit), unnormalized box integration, R = det - k*tr^2, 3x3 dilation NMS,
  quality threshold relative to the global max, descending-response ordering.
- ``corner_subpix`` <-> cv2.cornerSubPix (vidExample.py:113): iterative
  gradient-weighted centroid solve with the Gaussian window mask.

All outputs are fixed-capacity with validity masks (static shapes).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


def _conv3(img, kx3, border="reflect"):
    """3x3 separable-free convolution by shift-and-add (kernel as 3x3 array)."""
    H, W = img.shape
    p = jnp.pad(img, 1, mode=border)
    out = jnp.zeros_like(img)
    for i in range(3):
        for j in range(3):
            k = kx3[i][j]
            if k != 0:
                out = out + k * p[i : i + H, j : j + W]
    return out


def sobel_xy(img, scale: float = 1.0):
    """Sobel-3 gradients with OpenCV kernel layout and optional scale."""
    KX = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
    KY = [[-1, -2, -1], [0, 0, 0], [1, 2, 1]]
    gx = _conv3(img, KX) * scale
    gy = _conv3(img, KY) * scale
    return gx, gy


def _box_sum(img, block: int):
    """Unnormalized block x block box sum (reflect-101 border, cv2.boxFilter)."""
    H, W = img.shape
    r = block // 2
    p = jnp.pad(img, r, mode="reflect")
    out = jnp.zeros_like(img)
    for i in range(block):
        out = out + p[i : i + H, r : r + W]
    p2 = jnp.pad(out, r, mode="reflect")
    out2 = jnp.zeros_like(img)
    for j in range(block):
        out2 = out2 + p2[r : r + H, j : j + W]
    return out2


def harris_response(img, block: int = 5, k: float = 0.04, input_8u: bool = True):
    """Harris corner response map (cv2.cornerHarris semantics, ksize=3)."""
    dtype = img.dtype if jnp.issubdtype(img.dtype, jnp.floating) else jnp.float32
    x = img.astype(dtype)
    scale = 1.0 / (4.0 * block)  # 2^(ksize-1) * block
    if input_8u:
        scale = scale / 255.0
    gx, gy = sobel_xy(x, scale)
    a = _box_sum(gx * gx, block)
    b = _box_sum(gx * gy, block)
    c = _box_sum(gy * gy, block)
    return a * c - b * b - k * (a + c) ** 2


class Corners(NamedTuple):
    points: jnp.ndarray  # (max_corners, 2) xy, padded
    response: jnp.ndarray  # (max_corners,)
    valid: jnp.ndarray  # (max_corners,) bool


@partial(jax.jit, static_argnames=("max_corners", "block", "k", "quality_level"))
def good_features(
    img,
    max_corners: int = 1024,
    quality_level: float = 0.01,
    block: int = 5,
    k: float = 0.04,
    mask=None,
) -> Corners:
    """Top-``max_corners`` Harris corners after NMS and quality thresholding.

    ``mask``: optional (H, W) bool of allowed regions (replaces the reference's
    host-side ROI crop; border effects differ only within ~3 px of the ROI edge).
    """
    R = harris_response(img, block=block, k=k)
    H, W = R.shape
    # 3x3 dilation NMS (cv2.dilate with default kernel)
    p = jnp.pad(R, 1, mode="constant", constant_values=-jnp.inf)
    neigh = jnp.stack([p[i : i + H, j : j + W] for i in range(3) for j in range(3)])
    is_peak = R >= jnp.max(neigh, axis=0)
    if mask is not None:
        allowed = mask
    else:
        allowed = jnp.ones_like(is_peak)
    Rmax = jnp.max(jnp.where(allowed, R, -jnp.inf))
    keep = is_peak & allowed & (R > quality_level * Rmax)

    flatR = jnp.where(keep, R, -jnp.inf).ravel()
    # top-k as one stable sort (ties keep the lower index, like lax.top_k):
    # XLA's GPU TopK exhausts the host's memory while compiling for a 1080p
    # response map and k = 1024
    idx = jnp.argsort(-flatR, stable=True)[:max_corners]
    vals = flatR[idx]
    ys = (idx // W).astype(R.dtype)
    xs = (idx % W).astype(R.dtype)
    return Corners(
        points=jnp.stack([xs, ys], axis=1),
        response=vals,
        valid=jnp.isfinite(vals),
    )


@partial(jax.jit, static_argnames=("half_win", "max_iters", "eps"))
def corner_subpix(img, points, half_win: int = 5, max_iters: int = 100, eps: float = 0.001):
    """Subpixel corner refinement (cv2.cornerSubPix, zeroZone=(-1,-1)).

    Per point, iterate: sample the (2*half_win+1)^2 window (bilinear), compute
    central-difference gradients, solve the gradient-weighted centroid system
    with the Gaussian mask exp(-(i^2+j^2)/half_win^2), move the corner.

    Stencil formulation: corners drift at most ``half_win + 1`` px from
    their seed (the cv2 bail-out), so one axis-aligned slab per point is
    extracted up front in the lanes-last (Q, Q, N) layout, and every
    iteration resamples it with the static-shift tap stencil of
    ops/lk_lanes.py — points on the contiguous minor axis, window dims on the
    sliceable major axes.
    """
    from velocity_tpu.ops.lk_lanes import _extract_slabs, _sample_taps

    dtype = points.dtype if jnp.issubdtype(points.dtype, jnp.floating) else jnp.float32
    pts = points.astype(dtype)
    x = img.astype(dtype)
    wsize = 2 * half_win + 1
    gsize = wsize + 2  # +1 ring for central differences
    drift_max = half_win + 1
    # slab: gsize window + drift reach each way + 1 for the bilinear tap
    Q = gsize + 2 * (drift_max + 1)
    n_taps = Q - gsize + 1

    corner = jnp.floor(pts).astype(jnp.int32) - gsize // 2 - drift_max - 1
    slabs, cl = _extract_slabs(x, corner, Q)  # (Q, Q, N) lanes-last
    cl = cl.astype(dtype)

    off = jnp.arange(wsize, dtype=dtype) - half_win
    coef = 1.0 / (half_win * half_win)
    m1d = jnp.exp(-(off * off) * coef)
    mask2d = (m1d[:, None] * m1d[None, :])[:, :, None]
    offx = off[None, :, None]
    offy = off[:, None, None]
    gh = (gsize - 1) * 0.5

    def cond(carry):
        i, q, done = carry
        return (i < max_iters) & ~jnp.all(done)

    def body(carry):
        i, q, done = carry
        ox = q[:, 0] - gh - cl[:, 0]
        oy = q[:, 1] - gh - cl[:, 1]
        patch = _sample_taps(slabs, oy, ox, gsize, n_taps)  # (gsize, gsize, N)
        gx = (patch[1:-1, 2:] - patch[1:-1, :-2]) * 0.5
        gy = (patch[2:, 1:-1] - patch[:-2, 1:-1]) * 0.5
        gxx = jnp.sum(gx * gx * mask2d, axis=(0, 1))
        gxy = jnp.sum(gx * gy * mask2d, axis=(0, 1))
        gyy = jnp.sum(gy * gy * mask2d, axis=(0, 1))
        # b = sum w * (g g^T) dot (p - q) over window offsets
        bx = jnp.sum((gx * gx * offx + gx * gy * offy) * mask2d, axis=(0, 1))
        by = jnp.sum((gx * gy * offx + gy * gy * offy) * mask2d, axis=(0, 1))
        det = gxx * gyy - gxy * gxy
        safe = jnp.abs(det) > jnp.finfo(dtype).tiny * 16
        inv = jnp.where(safe, 1.0 / det, 0.0)
        dx = (gyy * bx - gxy * by) * inv
        dy = (gxx * by - gxy * bx) * inv
        step = jnp.stack([dx, dy], axis=1)
        blocked = done | ~safe
        q_new = jnp.where(blocked[:, None], q, q + step)
        moved2 = jnp.sum(step * step, axis=1)
        done = done | (moved2 < eps * eps) | ~safe
        # cv2 bails if the point drifts out of the window
        done = done | (jnp.abs(q_new - pts) > drift_max).any(axis=1)
        return i + 1, q_new, done

    _, q, _ = jax.lax.while_loop(
        cond, body, (jnp.asarray(0), pts, jnp.zeros(pts.shape[0], bool))
    )
    return q
