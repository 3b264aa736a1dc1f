"""Multi-view triangulation ("MSV" multi-station vector intercept) + camera GN.

Parity targets (/root/reference/utils/MSV.py):
- ``pairwise_intercept``      <-> ``fcn2vintercept`` (MSV.py:98-142): closed-form
  two-ray nearest-point midpoints averaged over all C(nf,2) frame pairs.
- ``nray_intercept``          <-> ``fcnNvintercept`` (MSV.py:146-175): per-point
  3x3 normal equations over all N rays — the formulation that batches cleanly
  (a (N,3,3) batched solve instead of O(nf^2) pair enumeration).
- ``msv_refine_translation``  <-> ``fcnMSV1_t`` (MSV.py:8-49): Gauss-Newton over
  the newest camera's translation where the residual re-triangulates the cloud
  at every iterate (structure and pose coupled like a tiny BA). Jacobians are
  analytic (jacfwd *through the triangulation*), replacing the reference's
  forward differences.

Ray layout here is (nf, N, 3) — frames leading, points in the middle — rather
than the reference's (3, nf, N).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from velocity_tpu.config import SolverConfig
from velocity_tpu.geometry.projection import Intrinsics, project_camera_points, pixel_to_unit_ray
from velocity_tpu.solvers.lm import lm_solve, LMResult


def _pair_indices(nf: int):
    """Static upper-triangle pair index arrays (j < k) for nf frames."""
    import numpy as np

    j, k = np.triu_indices(nf, k=1)
    return jnp.asarray(j), jnp.asarray(k)


def pairwise_intercept(origins: jnp.ndarray, rays: jnp.ndarray) -> jnp.ndarray:
    """Average two-ray nearest-point midpoints over all frame pairs.

    Args:
      origins: (nf, 3) camera origins.
      rays: (nf, N, 3) unit rays per frame per point.

    Returns:
      (N, 3) triangulated points (average of per-pair midpoints).
    """
    nf = rays.shape[0]
    jdx, kdx = _pair_indices(nf)

    u = rays[jdx]  # (npair, N, 3)
    v = rays[kdx]
    dA = (origins[jdx] - origins[kdx])[:, None, :]  # (npair, 1, 3)

    d = jnp.sum(u * v, axis=-1)  # (npair, N)
    e = jnp.sum(u * dA, axis=-1)
    f = jnp.sum(v * dA, axis=-1)
    g = 1.0 - d * d
    s1 = (d * f - e) / g  # along u
    t1 = (f - d * e) / g  # along v

    # midpoint sum: (A_j + s1 u + A_k + t1 v)/2 averaged over pairs; the A terms
    # collapse to sum(origins) * (nf - 1) (each origin appears in nf-1 pairs).
    npair = jdx.shape[0]
    B = jnp.sum(origins, axis=0) * (nf - 1)  # (3,)
    uv = t1[..., None] * v + s1[..., None] * u  # (npair, N, 3)
    return (jnp.sum(uv, axis=0) + B) / (2.0 * npair)


def nray_intercept(origins: jnp.ndarray, rays: jnp.ndarray) -> jnp.ndarray:
    """Least-squares intersection of N rays per point via 3x3 normal equations.

    For each point: solve  [sum_f (I - u_f u_f^T)] x = sum_f (I - u_f u_f^T) A_f.
    This is the batched formulation (one (N,3,3) solve).

    Args:
      origins: (nf, 3); rays: (nf, N, 3) unit rays.
    Returns:
      (N, 3) intercept points.
    """
    eye = jnp.eye(3, dtype=rays.dtype)
    # P_f = I - u u^T per frame per point: (nf, N, 3, 3)
    uuT = rays[..., :, None] * rays[..., None, :]
    P = eye - uuT
    S1 = jnp.sum(P, axis=0)  # (N, 3, 3)
    S2 = jnp.einsum("fnij,fj->ni", P, origins)  # (N, 3)
    return jnp.linalg.solve(S1, S2[..., None])[..., 0]


def nray_intercept_masked_np(intr_np, track_px, tvecs, mask,
                             min_obs: int = 2, max_residual_px: float = 3.0,
                             depth_range=None):
    """Host-side masked N-ray triangulation for lanes with PARTIAL histories.

    Replenished lanes enter mid-sequence, so unlike ``nray_intercept`` each
    lane uses only the frames where it was observed. The motion model is the
    pipeline's post-frame-0 convention (R = I, p_cam = p3 + t_f, reference
    vidExample.py:120): pixel (u, v) in frame f rays along
    d = [(u-cx)/fx, (v-cy)/fy, 1] from origin -t_f.

    Acceptance gates — a lane is ``ok`` only when its triangulation carries
    usable pose information:
      * >= ``min_obs`` observations, finite solution, positive depth at every
        observed frame;
      * reprojection rms over its own history <= ``max_residual_px`` — a
        WORLD-static lane (background) has parallel-but-offset rays in the
        car frame whose least-squares point reprojects inconsistently, so
        this gate rejects the lanes that would otherwise drag the pose solve
        toward zero motion;
      * optional ``depth_range=(zmin, zmax)``: last-frame camera depth must
        be plausible (callers pass a band around the live structure's median
        depth — catches depth-ambiguous near-coincident ray bundles that
        happen to reproject consistently).

    Args:
      intr_np: (fx, fy, cx, cy) floats.
      track_px: (k, N, 2) pixels (NaN where unobserved).
      tvecs: (k, 3) per-frame camera translations t_f.
      mask: (k, N) observation validity.

    Returns:
      (p3 (N, 3), ok (N,)).
    """
    import numpy as np

    fx, fy, cx, cy = intr_np
    k, N, _ = track_px.shape
    m = mask & np.isfinite(track_px).all(axis=2)
    t = np.nan_to_num(track_px.astype(np.float64))
    rays = np.stack(
        [(t[..., 0] - cx) / fx, (t[..., 1] - cy) / fy, np.ones((k, N))],
        axis=-1,
    )
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    tvecs = np.asarray(tvecs, np.float64)
    origins = -tvecs  # (k, 3)
    eye = np.eye(3)
    P = (eye - rays[..., :, None] * rays[..., None, :]) * m[..., None, None]
    S1 = P.sum(axis=0)  # (N, 3, 3)
    S2 = np.einsum("fnij,fj->ni", P, origins)
    nobs = np.maximum(m.sum(axis=0), 1)
    p3 = np.linalg.solve(S1 + eye * 1e-9, S2[..., None])[..., 0]

    # per-lane reprojection rms over the observed frames
    pc = p3[None, :, :] + tvecs[:, None, :]  # (k, N, 3)
    z = pc[..., 2]
    z_safe = np.where(np.abs(z) > 1e-9, z, 1e-9)
    u = fx * pc[..., 0] / z_safe + cx
    v = fy * pc[..., 1] / z_safe + cy
    err2 = (u - t[..., 0]) ** 2 + (v - t[..., 1]) ** 2
    rms = np.sqrt(np.where(m, err2, 0.0).sum(axis=0) / nobs)
    depth_ok = np.where(m, z > 1e-2, True).all(axis=0)

    ok = (
        (m.sum(axis=0) >= min_obs)
        & np.isfinite(p3).all(axis=1)
        & depth_ok
        & (rms <= max_residual_px)
    )
    if depth_range is not None:
        z_last = p3[:, 2] + tvecs[-1][2]
        ok &= (z_last >= depth_range[0]) & (z_last <= depth_range[1])
    return p3, ok


class MSVResult(NamedTuple):
    t: jnp.ndarray  # (3,) refined translation of the newest camera
    points: jnp.ndarray  # (N, 3) triangulated cloud at the solution
    iterations: jnp.ndarray
    residual_rms: jnp.ndarray


@partial(jax.jit, static_argnames=("config", "use_nray"))
def msv_refine_translation(
    intr: Intrinsics,
    pixels: jnp.ndarray,  # (nf, N, 2) tracked pixels for frames 0..nf-1
    mask: jnp.ndarray,  # (N,) bool validity (tracks alive in all nf frames)
    origins: jnp.ndarray,  # (nf, 3) camera positions (camera-0 frame)
    config: SolverConfig = SolverConfig(),
    x0: jnp.ndarray | None = None,
    use_nray: bool = False,
) -> MSVResult:
    """Gauss-Newton refinement of the newest camera translation (fcnMSV1_t).

    The residual projects the re-triangulated cloud into the newest camera:
    moving x moves both that camera's origin and every intercept. Masked lanes
    are sanitized (pixels -> principal point) and excluded from the residual.
    """
    dtype = pixels.dtype
    nf = pixels.shape[0]

    # sanitize masked lanes so NaNs never enter the computation
    safe = jnp.stack(
        [jnp.full(pixels.shape[:-1], intr.cx, dtype), jnp.full(pixels.shape[:-1], intr.cy, dtype)],
        axis=-1,
    )
    m = mask[None, :, None]
    pix = jnp.where(m, pixels, safe)

    rays = pixel_to_unit_ray(intr, pix)  # (nf, N, 3)
    # camera origins relative to frame 0, negated: u0 = B0 - B_f  (MSV.py:18)
    u0 = origins[0][None, :] - origins  # (nf, 3)
    if x0 is None:
        x0 = jnp.array([0.0, 0.0, 1.0], dtype) - u0[nf - 2]

    z = pix[nf - 1]  # (N, 2) observations in the newest frame
    mz = mask[:, None]
    intercept = nray_intercept if use_nray else pairwise_intercept
    # normalized-unit residual + matched damping: identical iterates to the
    # pixel-unit reference, f32-friendly conditioning (see solvers/pose.py).
    inv_f = 1.0 / intr.fx

    def residual(x):
        A = jnp.concatenate([u0[:-1], -x[None, :]], axis=0)  # (nf, 3)
        cloud0 = intercept(A, rays)  # cloud in camera-0 translation frame
        cloud = cloud0 + x  # into newest-camera frame
        zhat = project_camera_points(intr, cloud)
        # where (not multiply): masked lanes can triangulate to inf/nan
        # (parallel sanitized rays) and 0*nan would poison the residual.
        return (jnp.where(mz, z - zhat, 0.0) * inv_f).ravel()

    res: LMResult = lm_solve(
        residual,
        jnp.asarray(x0, dtype),
        max_iters=config.max_iters_msv,
        damping=config.damping * inv_f * inv_f,
        tol=config.tol,
        use_ramp=False,
        num_residuals=2.0 * jnp.sum(mask),
    )

    A = jnp.concatenate([u0[:-1], -res.x[None, :]], axis=0)
    cloud = intercept(A, rays) + res.x
    return MSVResult(
        t=res.x, points=cloud, iterations=res.iterations, residual_rms=res.residual_rms
    )
