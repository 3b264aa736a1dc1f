"""Separable image resampling as dense matmuls.

Pyramid downsample / nearest resize: a 1-D resampling along an image axis
is a banded linear map, so a 2-D separable resample is ``R @ X @ C^T`` with
per-axis operator matrices — two dense matmuls, at ``Precision.HIGHEST`` in
float32. Whether this beats a 5-tap stencil with stride-2 decimation on the
GPU is not measured (ROADMAP).

The operator matrices are built on device from ``broadcasted_iota``
comparisons (banded + border rows), so no multi-MB constants are baked into
the executable.

Semantics match the reference's OpenCV usage exactly:
- ``pyr_down``: cv2.pyrDown — 5-tap [1,4,6,4,1]/16 Gaussian, reflect-101
  borders, decimation at even indices, output ((h+1)//2, (w+1)//2)
  (reference pyramid use: cv2.buildOpticalFlowPyramid inside
  calcOpticalFlowPyrLK, /root/reference/utils/KLT.py:45).
- ``resize_nearest_mat``: cv2.resize INTER_NEAREST (the reference's 1/4-scale
  coarse image, /root/reference/utils/KLT.py:111-113).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_G5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _reflect101(idx: np.ndarray, n: int) -> np.ndarray:
    idx = np.abs(idx)
    return np.where(idx >= n, 2 * n - 2 - idx, idx)


def _pyrdown_operator(n: int, dtype) -> jnp.ndarray:
    """(ceil(n/2), n) matrix: reflect-101 5-tap Gaussian + stride-2 decimation.

    Built from iota comparisons (5 banded one-hot accumulations), evaluated
    on device; XLA constant-folds the iotas into a small fused build.
    """
    m = (n + 1) // 2
    rows = jax.lax.broadcasted_iota(jnp.int32, (m, n), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (m, n), 1)
    out = jnp.zeros((m, n), dtype)
    # numpy computes the (tiny) reflected source index per (row, tap) pair;
    # the one-hot expansion against cols runs on device
    base = 2 * np.arange(m)
    for t, k in enumerate(_G5):
        src = _reflect101(base + t - 2, n)  # (m,)
        src_dev = jnp.asarray(src, jnp.int32)[:, None]
        out = out + jnp.asarray(k, dtype) * (cols == src_dev).astype(dtype)
    del rows
    return out


def _nearest_operator(n_out: int, n_in: int, scale: float, dtype) -> jnp.ndarray:
    """(n_out, n_in) 0/1 selection matrix: src = min(floor(i/scale), n_in-1)."""
    cols = jax.lax.broadcasted_iota(jnp.int32, (n_out, n_in), 1)
    src = np.minimum(np.floor(np.arange(n_out) / scale).astype(np.int64), n_in - 1)
    src_dev = jnp.asarray(src, jnp.int32)[:, None]
    return (cols == src_dev).astype(dtype)


def _mm(a, b):
    return jax.lax.dot_general(
        a, b, dimension_numbers=(((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )


def pyr_down_mat(img):
    """One Gaussian pyramid level down (cv2.pyrDown semantics) via matmuls."""
    dtype = img.dtype if jnp.issubdtype(img.dtype, jnp.floating) else jnp.float32
    x = img.astype(dtype)
    H, W = x.shape
    R = _pyrdown_operator(H, dtype)  # (h2, H)
    C = _pyrdown_operator(W, dtype)  # (w2, W)
    return _mm(_mm(R, x), C.T)


def resize_nearest_mat(img, scale: float):
    """cv2.resize INTER_NEAREST with fx=fy=scale via selection matmuls."""
    dtype = img.dtype if jnp.issubdtype(img.dtype, jnp.floating) else jnp.float32
    x = img.astype(dtype)
    H, W = x.shape
    h = int(round(H * scale))
    w = int(round(W * scale))
    R = _nearest_operator(h, H, scale, dtype)
    C = _nearest_operator(w, W, scale, dtype)
    return _mm(_mm(R, x), C.T)
