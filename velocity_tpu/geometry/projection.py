"""Pinhole camera projection, plane backprojection, and pixel->ray conversion.

The intrinsics are carried as scalars (``Intrinsics`` NamedTuple) rather than as a
matrix; matrices only appear at the data boundary (``from_matrix_rowvec`` accepts
the reference's MATLAB-transposed K layout ``[[fx,0,0],[skew,fy,0],[cx,cy,1]]``,
see /root/reference/utils/images.py:148-151).

Projection math is numerically identical to the reference's row-vector forms
(``world2image``/``image2world``/``pixel2uvec``, /root/reference/utils/common.py:49-126)
but expressed as fused scalar ops, which XLA fuses into elementwise kernels
without tiny 3x3 matmuls.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from velocity_tpu.geometry.norms import unit_rows
from velocity_tpu.geometry.spherical import elevation_azimuth, cam_to_ned_matrix


class Intrinsics(NamedTuple):
    """Pinhole intrinsics. All entries are scalars (or scalar arrays under vmap)."""

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    skew: jnp.ndarray

    @classmethod
    def from_matrix_rowvec(cls, K):
        """Build from the reference's row-vector intrinsic matrix layout."""
        K = jnp.asarray(K)
        return cls(fx=K[0, 0], fy=K[1, 1], cx=K[2, 0], cy=K[2, 1], skew=K[1, 0])

    def matrix_rowvec(self, dtype=None):
        """Row-vector intrinsic matrix ``[[fx,0,0],[skew,fy,0],[cx,cy,1]]``."""
        fx, fy, cx, cy, skew = (jnp.asarray(v, dtype=dtype) for v in self)
        z = jnp.zeros_like(fx)
        o = jnp.ones_like(fx)
        return jnp.stack(
            [
                jnp.stack([fx, z, z]),
                jnp.stack([skew, fy, z]),
                jnp.stack([cx, cy, o]),
            ]
        )

    def scaled(self, factor):
        """Intrinsics after uniformly rescaling the image by ``factor``.

        Matches the reference's 4K->2K rule which scales fx, fy (and q) but leaves
        the principal point untouched (/root/reference/vidExample.py:35-39) when
        ``scale_principal_point=False`` semantics are desired; here we scale focal
        and skew only, mirroring ``cam['IntrinsicMatrix'][:2,:2] /= 2``.
        """
        return self._replace(
            fx=self.fx * factor, fy=self.fy * factor, skew=self.skew * factor
        )

    def astype(self, dtype):
        return Intrinsics(*(jnp.asarray(v, dtype=dtype) for v in self))


def perspective_divide(p3):
    """(..., 3) homogeneous camera points -> (..., 2) normalized image points.

    Parity: reference ``pscale`` (/root/reference/utils/common.py:145-147).
    """
    return p3[..., 0:2] / p3[..., 2:3]


def project_camera_points(intr: Intrinsics, pc):
    """Project camera-frame points (..., 3) to pixels (..., 2).

    Equivalent to the reference ``fzK(a, K) = pscale(a @ K)``
    (/root/reference/utils/NLS.py:71-78) with the row-vector K layout.
    """
    X, Y, Z = pc[..., 0], pc[..., 1], pc[..., 2]
    iz = 1.0 / Z
    u = (intr.fx * X + intr.skew * Y) * iz + intr.cx
    v = intr.fy * Y * iz + intr.cy
    return jnp.stack([u, v], axis=-1)


def world_to_image(intr: Intrinsics, C, t, pw):
    """Project world points through pose (C, t): pixels of ``pw @ C + t``.

    Parity: reference ``world2image`` (/root/reference/utils/common.py:58-64).
    """
    return project_camera_points(intr, pw @ C + t)


def image_to_world_plane(intr: Intrinsics, C, t, p):
    """Backproject pixels to the world z=0 plane (inverse plane homography).

    Parity: reference ``image2world`` (/root/reference/utils/common.py:49-55),
    which inverts ``tform = [[C rows],[t]] @ K`` directly. That matrix has
    pixel-scale entries (condition ~1e6) and loses ~centimeters in f32, so we
    factor K out analytically: normalize pixels first (exact ops), then invert
    only the O(1)-conditioned plane homography ``M = [[C0],[C1],[t]]``.

    Returns (..., 2) world xy on the plane.
    """
    dtype = p.dtype
    yn = (p[..., 1] - intr.cy) / intr.fy
    xn = (p[..., 0] - intr.cx - intr.skew * yn) / intr.fx
    ph = jnp.stack([xn, yn, jnp.ones_like(xn)], axis=-1)
    M = jnp.concatenate([C[0:2, :], t[None, :]], axis=0)
    pw = ph @ jnp.linalg.inv(M.astype(dtype))
    return pw[..., 0:2] / pw[..., 2:3]


def pixel_to_unit_ray(intr: Intrinsics, p):
    """Pixels (..., 2) -> unit rays (..., 3) in the camera frame.

    Parity: reference ``pixel2uvec`` (/root/reference/utils/common.py:122-126):
    subtract principal point, set z = fx, normalize. Note the reference uses fx for
    z regardless of fy; we preserve that.
    """
    x = p[..., 0] - intr.cx
    y = p[..., 1] - intr.cy
    z = jnp.full_like(x, intr.fx)
    return unit_rows(jnp.stack([x, y, z], axis=-1))


def pixel_to_angle(intr: Intrinsics, p):
    """Pixels (..., 2) -> NED [elevation, azimuth] angles (..., 2).

    Parity: reference ``pixel2angle`` (/root/reference/utils/common.py:115-119).
    """
    x = p[..., 0] - intr.cx
    y = p[..., 1] - intr.cy
    z = jnp.full_like(x, intr.fx)
    v_cam = jnp.stack([x, y, z], axis=-1)
    v_ned = v_cam @ cam_to_ned_matrix(v_cam.dtype).T
    return elevation_azimuth(v_ned)
