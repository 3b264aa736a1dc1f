"""Bundle adjustment: free-pose and constrained variants.

Parity targets:
- ``ba_dense``       <-> reference ``fcnNLS_batch``  (/root/reference/utils/NLS.py:186-250):
  params = [point xyz (nt,3); camera pos+rpy (nc-1,6)], camera 0 pinned at
  identity, damping I, step scale 0.9, <=10 iterations, conv rms(delta)<1e-7.
  The reference builds the dense Jacobian by O(nx) full re-projections per
  iteration (the scaling bottleneck, NLS.py:228-233); here it is analytic.
- ``ba_constrained`` <-> reference ``fcnNLS_batch2`` (NLS.py:253-328): the
  straight-line motion prior — one shared rpy, one el/az direction, per-camera
  ranges.
- ``ba_schur``: the accelerator formulation — block-sparse normal equations with Schur
  complement camera reduction (see solvers/schur.py), same optimum.

Observation layout is a dense (nc, nt) grid with a validity mask: in this
pipeline every surviving track is visible in all frames of a window (the
reference keeps exactly those, NLS.py:190-191), so dense batched einsums are
the natural layout; masked lanes are inert.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from velocity_tpu.config import BAConfig
from velocity_tpu.geometry.projection import Intrinsics, project_camera_points
from velocity_tpu.geometry.rotations import rpy_to_matrix
from velocity_tpu.geometry.spherical import spherical_to_cartesian, cartesian_to_spherical, cam_to_ned_matrix


class BAProblem(NamedTuple):
    intr: Intrinsics
    pixels: jnp.ndarray  # (nc, nt, 2) observations
    mask: jnp.ndarray  # (nc, nt) bool validity
    points0: jnp.ndarray  # (nt, 3) initial world points (camera-0 frame)
    cams0: jnp.ndarray  # (nc, 6) initial [pos(3), rpy(3)]; camera 0 stays fixed


class BAResult(NamedTuple):
    points: jnp.ndarray  # (nt, 3)
    cams: jnp.ndarray  # (nc, 6)
    iterations: jnp.ndarray
    residual_rms: jnp.ndarray  # masked rms reprojection error (pixels)


def _project_all(intr, points, cams):
    """(nc, nt, 2) projections of all points into all cameras (camera 0 = identity)."""
    C = rpy_to_matrix(cams[:, 3:6])  # (nc, 3, 3)
    pc = jnp.einsum("ti,cij->ctj", points, C) + cams[:, None, 0:3]
    return project_camera_points(intr, pc)


def _masked_residual_px(intr, problem, points, cams):
    zhat = _project_all(intr, points, cams)
    r = jnp.where(problem.mask[..., None], problem.pixels - zhat, 0.0)
    return r


def ba_residual_rms(problem: BAProblem, points, cams):
    r = _masked_residual_px(problem.intr, problem, points, cams)
    n = jnp.maximum(2.0 * jnp.sum(problem.mask), 1.0)
    return jnp.sqrt(jnp.sum(r * r) / n)


def ba_dense(problem: BAProblem, config: BAConfig = BAConfig()) -> BAResult:
    """Dense-Jacobian BA — the reference-parity twin (small problems/tests)."""
    intr = problem.intr
    nt = problem.points0.shape[0]
    nc = problem.cams0.shape[0]
    dtype = problem.points0.dtype
    inv_f = 1.0 / intr.fx
    nx = nt * 3 + (nc - 1) * 6

    def unpack(x):
        points = x[: nt * 3].reshape(nt, 3)
        cams_free = x[nt * 3 :].reshape(nc - 1, 6)
        cams = jnp.concatenate([jnp.zeros((1, 6), dtype), cams_free], axis=0)
        return points, cams

    def residual(x):
        points, cams = unpack(x)
        r = _masked_residual_px(intr, problem, points, cams)
        return (r * inv_f).ravel()

    x0 = jnp.concatenate(
        [problem.points0.ravel(), problem.cams0[1:].ravel()]
    ).astype(dtype)
    eye = jnp.eye(nx, dtype=dtype) * (config.damping * inv_f * inv_f)
    tol = max(config.tol, 50.0 * float(jnp.finfo(dtype).eps))

    def step(carry):
        x, i, _ = carry
        r = residual(x)
        J = jax.jacfwd(residual)(x)
        g = -(J.T @ r)
        H = J.T @ J + eye
        delta = jnp.linalg.solve(H, g) * config.step_scale
        return x + delta, i + 1, jnp.sqrt(jnp.mean(delta * delta))

    def cond(carry):
        _, i, d = carry
        return (i < config.max_iters) & (d >= tol)

    x, iters, _ = jax.lax.while_loop(
        cond, step, (x0, jnp.int32(0), jnp.asarray(jnp.inf, dtype))
    )
    points, cams = unpack(x)
    return BAResult(
        points=points, cams=cams, iterations=iters,
        residual_rms=ba_residual_rms(problem, points, cams),
    )


def ba_constrained(problem: BAProblem, config: BAConfig = BAConfig()) -> BAResult:
    """Straight-line-motion-prior BA (reference fcnNLS_batch2, NLS.py:253-328).

    Parameters: [point xyz; shared camera rpy (3); el; az; per-camera ranges
    (nc-1)] — cameras constrained to a line through camera 0 with direction
    (el, az) in NED, at per-camera ranges.
    """
    intr = problem.intr
    nt = problem.points0.shape[0]
    nc = problem.cams0.shape[0]
    dtype = problem.points0.dtype
    inv_f = 1.0 / intr.fx
    Cn = cam_to_ned_matrix(dtype)

    # init el/az/ranges from the initial camera track (NLS.py:272-274)
    d1 = (problem.cams0[1, 0:3] - problem.cams0[0, 0:3]) @ Cn.T
    sc = cartesian_to_spherical(d1)
    ranges0 = jnp.arange(1, nc, dtype=dtype) * sc[0]
    x0 = jnp.concatenate(
        [problem.points0.ravel(), jnp.zeros(3, dtype), sc[1:3], ranges0]
    )
    nx = x0.shape[0]

    def unpack(x):
        j = nt * 3
        points = x[:j].reshape(nt, 3)
        rpy = x[j : j + 3]
        el, az = x[j + 3], x[j + 4]
        ranges = x[j + 5 :]
        sph = jnp.stack(
            [ranges, jnp.full_like(ranges, el), jnp.full_like(ranges, az)], axis=1
        )
        offsets = spherical_to_cartesian(sph) @ Cn  # NED -> camera frame
        pos = jnp.concatenate([jnp.zeros((1, 3), dtype), offsets], axis=0)
        rpys = jnp.concatenate(
            [jnp.zeros((1, 3), dtype), jnp.tile(rpy, (nc - 1, 1))], axis=0
        )
        cams = jnp.concatenate([pos, rpys], axis=1)
        return points, cams

    def residual(x):
        points, cams = unpack(x)
        # reference applies the shared rotation to the points, not per-camera:
        # pc = pw @ R then offset per camera (NLS.py:278-287) — equivalent to
        # our cams carrying the same rpy per camera with camera-0 R = I except
        # the reference rotates camera 0's view too. Match the reference.
        R = rpy_to_matrix(x[nt * 3 : nt * 3 + 3])
        pr = points @ R
        pc = pr[None, :, :] + cams[:, None, 0:3]
        zhat = project_camera_points(intr, pc)
        r = jnp.where(problem.mask[..., None], problem.pixels - zhat, 0.0)
        return (r * inv_f).ravel()

    eye = jnp.eye(nx, dtype=dtype) * (config.damping * inv_f * inv_f)
    tol = max(config.tol, 50.0 * float(jnp.finfo(dtype).eps))

    def step(carry):
        x, i, _ = carry
        r = residual(x)
        J = jax.jacfwd(residual)(x)
        delta = jnp.linalg.solve(J.T @ J + eye, -(J.T @ r)) * config.step_scale
        return x + delta, i + 1, jnp.sqrt(jnp.mean(delta * delta))

    def cond(carry):
        _, i, d = carry
        return (i < config.max_iters * 2) & (d >= tol)  # reference: 20 iters

    x, iters, _ = jax.lax.while_loop(
        cond, step, (x0, jnp.int32(0), jnp.asarray(jnp.inf, dtype))
    )
    points, cams = unpack(x)
    # Fold the shared rotation into the points (rotation gauge): the model is
    # zhat_c = project(points @ R + pos_c) for EVERY camera including 0, which
    # equals the camera-0-identity convention on points' = points @ R.
    R = rpy_to_matrix(x[nt * 3 : nt * 3 + 3])
    points = points @ R
    cams = cams.at[:, 3:6].set(0.0)
    return BAResult(
        points=points, cams=cams, iterations=iters,
        residual_rms=ba_residual_rms(problem, points, cams),
    )
