"""Batched image ops: interpolation, pyramids, LK tracking, Harris, RANSAC, robust stats.

Everything is plain JAX/XLA with static shapes, batched gathers and no
data-dependent host control flow. ``ops/lk.py`` (gather LK) is the reference
the faster LK engines (``lk_lanes``, ``lk_fast``) are tested against.
"""

from velocity_tpu.ops.interp import bilinear_sample, gather_patches, affine_grid_patches  # noqa: F401
from velocity_tpu.ops.pyramid import pyr_down, build_pyramid, resize_nearest  # noqa: F401
from velocity_tpu.ops.lk import lk_pyramidal, lk_forward_backward, scharr_derivatives  # noqa: F401
from velocity_tpu.ops.harris import harris_response, good_features, corner_subpix  # noqa: F401
from velocity_tpu.ops.ransac import estimate_affine_ransac, fit_affine_lsq  # noqa: F401
from velocity_tpu.ops.robust import sigma_rejection  # noqa: F401
from velocity_tpu.ops.warp import affine_warp  # noqa: F401
