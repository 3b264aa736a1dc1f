"""Bilinear sampling and patch gathering — the common core of LK/warp/subpix.

These are the gather primitives everything image-side builds on; the LK
engines avoid per-iteration gathers by extracting one patch per point
(``extract_patches``) and resampling it with stencils or small matmuls.
"""

from __future__ import annotations

import jax.numpy as jnp


def bilinear_sample(img, x, y, border: str = "clamp"):
    """Sample ``img`` at float coordinates (x, y) with bilinear interpolation.

    Args:
      img: (H, W) array.
      x, y: broadcastable float arrays of sample coordinates (pixel units,
        origin at pixel centers — matches cv2.remap INTER_LINEAR).
      border: "clamp" replicates edges; "zero" returns 0 outside (cv2.remap
        BORDER_CONSTANT default).

    Returns:
      sampled values, float32/float64 per input dtype promotion.
    """
    H, W = img.shape
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    ax = x - x0
    ay = y - y0

    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 1)
    x1i = jnp.clip(x0i + 1, 0, W - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 1)
    y1i = jnp.clip(y0i + 1, 0, H - 1)

    v00 = img[y0i, x0i]
    v01 = img[y0i, x1i]
    v10 = img[y1i, x0i]
    v11 = img[y1i, x1i]

    out = (
        v00 * (1 - ax) * (1 - ay)
        + v01 * ax * (1 - ay)
        + v10 * (1 - ax) * ay
        + v11 * ax * ay
    )
    if border == "zero":
        inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
        out = jnp.where(inside, out, 0.0)
    return out


def _patch_offsets(size: int, dtype):
    """(size,) window offsets centered at 0: j - (size-1)/2."""
    half = (size - 1) * 0.5
    return jnp.arange(size, dtype=dtype) - half


def gather_patches(img, centers, size: int, border: str = "clamp"):
    """Gather (N, size, size) bilinear patches centered at ``centers`` (N, 2) xy."""
    dtype = centers.dtype
    off = _patch_offsets(size, dtype)
    # coords: (N, size, size)
    x = centers[:, 0, None, None] + off[None, None, :]
    y = centers[:, 1, None, None] + off[None, :, None]
    return bilinear_sample(img, x, y, border)


def affine_grid_patches(img, centers, size: int, M, border: str = "clamp"):
    """Gather patches whose sample grid is mapped through affine ``M`` (2x3).

    The window grid lives in *source* coordinates around ``centers``; each grid
    point g is sampled from ``img`` at ``M_lin @ g + M_t``. This fuses the
    reference's warp-then-track (cv2.remap + LK, KLT.py:70-83) into a single
    interpolation.
    """
    dtype = centers.dtype
    off = _patch_offsets(size, dtype)
    gx = centers[:, 0, None, None] + off[None, None, :]
    gy = centers[:, 1, None, None] + off[None, :, None]
    x = M[0, 0] * gx + M[0, 1] * gy + M[0, 2]
    y = M[1, 0] * gx + M[1, 1] * gy + M[1, 2]
    return bilinear_sample(img, x, y, border)


def extract_patches(img, corners, size: int):
    """(N, size, size) pixel patches at integer ``corners`` (N, 2) xy, clamped.

    One ``dynamic_slice`` per point: the only memory-irregular access of the
    LK engines. Images smaller than the patch are edge-padded first. Returns
    (patches, clamped_corners).
    """
    import jax

    H, W = img.shape
    if H < size or W < size:
        img = jnp.pad(
            img, ((0, max(0, size - H)), (0, max(0, size - W))), mode="edge"
        )
        H, W = img.shape
    cy = jnp.clip(corners[:, 1], 0, H - size)
    cx = jnp.clip(corners[:, 0], 0, W - size)

    def one(cyi, cxi):
        return jax.lax.dynamic_slice(img, (cyi, cxi), (size, size))

    patches = jax.vmap(one)(cy, cx)
    return patches, jnp.stack([cx, cy], axis=1)


def _sep_weights(offset, out_size: int, in_size: int, cubic: bool):
    """(..., out_size, in_size) interpolation weights for samples at
    ``j + offset`` along one axis (clamped to the patch)."""
    j = jnp.arange(out_size, dtype=offset.dtype)
    k = jnp.arange(in_size, dtype=offset.dtype)
    pos = jnp.clip(j[..., :, None] + offset[..., None, None], 0.0, in_size - 1.0)
    d = jnp.abs(k[None, :] - pos)
    if not cubic:
        return jnp.maximum(0.0, 1.0 - d)
    # Catmull-Rom (Keys a=-0.5), edge-renormalized for clipped support
    w1 = (1.5 * d - 2.5) * d * d + 1.0  # |d| < 1
    w2 = ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0  # 1 <= |d| < 2
    w = jnp.where(d < 1.0, w1, jnp.where(d < 2.0, w2, 0.0))
    return w / jnp.sum(w, axis=-1, keepdims=True)


def sample_patches(patches, dy, dx, out_size: int, cubic: bool = False):
    """Resample (N, P, P) patches at fractional offsets -> (N, out, out).

    Sampling as two small batched matmuls (``S_y @ patch @ S_x^T`` with
    interpolation-weight matrices) instead of a gather, as the matmul LK
    loop (ops/lk_fast.py) uses it. ``cubic=True`` selects
    Catmull-Rom weights; use it when ``patches`` are themselves interpolated
    (a second linear pass would compound the smoothing).
    """
    Sy = _sep_weights(dy, out_size, patches.shape[-2], cubic)
    Sx = _sep_weights(dx, out_size, patches.shape[-1], cubic)
    tmp = jnp.einsum("nwp,npq->nwq", Sy, patches)
    return jnp.einsum("nwq,nvq->nwv", tmp, Sx)
