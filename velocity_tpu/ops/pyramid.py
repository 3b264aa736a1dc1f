"""Image pyramids and resizing, matching OpenCV semantics where the reference
depends on them.

- ``pyr_down``: 5-tap Gaussian [1,4,6,4,1]/16 separable smoothing with
  reflect-101 borders, then 2x decimation at even indices, output size
  ((h+1)//2, (w+1)//2) — cv2.pyrDown / buildOpticalFlowPyramid semantics.
- ``resize_nearest``: cv2.resize INTER_NEAREST (used by the reference for its
  1/4-scale coarse image, KLT.py:111-113: dst(i,j) = src(floor(i/s), floor(j/s))).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_G5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _reflect101_pad(img, pad: int):
    """Reflect-101 (edge pixel not repeated) padding on both axes."""
    return jnp.pad(img, pad, mode="reflect")


def pyr_down(img):
    """One Gaussian pyramid level down (cv2.pyrDown semantics).

    Runs as two dense matmuls with banded operators (ops/resample.py)."""
    from velocity_tpu.ops.resample import pyr_down_mat

    return pyr_down_mat(img)


def build_pyramid(img, max_level: int):
    """List of ``max_level + 1`` images; level 0 is the input (as float)."""
    dtype = img.dtype if jnp.issubdtype(img.dtype, jnp.floating) else jnp.float32
    levels = [img.astype(dtype)]
    for _ in range(max_level):
        levels.append(pyr_down(levels[-1]))
    return levels


def resize_nearest(img, scale: float):
    """cv2.resize INTER_NEAREST with fx=fy=scale (scale<=1 decimation).

    Selection-matmul formulation; 0/1 selection of uint8 values is exact
    in f32, so the result is cast back to the input dtype losslessly."""
    from velocity_tpu.ops.resample import resize_nearest_mat

    out = resize_nearest_mat(img, scale)
    if not jnp.issubdtype(img.dtype, jnp.floating):
        out = out.astype(img.dtype)
    return out
