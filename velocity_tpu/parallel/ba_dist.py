"""Distributed Schur-complement bundle adjustment over a device mesh.

The point/track axis shards across the mesh (tracks are independent given the
cameras — the classic BA structure). Per GN/LM iteration, each device:

  1. computes residual + Jacobian blocks for its local point shard
     (``compute_blocks``),
  2. inverts its local 3x3 point blocks and forms the point-summed camera
     contributions (``schur_camera_partials``),
  3. ``psum``s the reduced camera Hessian S and rhs over the 'point' axis
     (over the device interconnect; this is the only communication — O((6 nc)^2) floats),
  4. solves the small replicated camera system, and
  5. back-substitutes its local point updates.

Iterates are bit-identical to single-device ``ba_schur`` modulo reduction
order. The same function runs under a multi-host mesh unchanged.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from velocity_tpu.config import BAConfig
from velocity_tpu.solvers.ba import BAProblem, BAResult, ba_residual_rms
from velocity_tpu.solvers.schur import (
    compute_blocks,
    schur_point_blocks,
    schur_camera_partials,
    schur_assemble_solve,
    schur_backsub,
)


def ba_schur_sharded(
    problem: BAProblem,
    mesh: Mesh,
    axis: str = "point",
    config: BAConfig = BAConfig(),
) -> BAResult:
    """Run Schur BA with points sharded over ``mesh`` axis ``axis``.

    The track capacity must be divisible by the axis size (pad with masked
    lanes — masked tracks are inert by construction).
    """
    intr = problem.intr
    dtype = problem.points0.dtype
    nc = problem.cams0.shape[0]
    nt = problem.points0.shape[0]
    n_shard = mesh.shape[axis]
    if nt % n_shard != 0:
        raise ValueError(f"track capacity {nt} not divisible by mesh axis {n_shard}")
    inv_f = 1.0 / intr.fx
    lam = config.damping * inv_f * inv_f
    tol = max(config.tol, 50.0 * float(jnp.finfo(dtype).eps))

    # replicate everything that is not point-sharded
    pspec_obs = P(None, axis)  # (nc, nt)
    pspec_obs2 = P(None, axis, None)  # (nc, nt, 2)
    pspec_pts = P(axis, None)  # (nt, 3)
    pspec_rep = P()

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(pspec_obs2, pspec_obs, pspec_pts, pspec_rep),
        out_specs=(pspec_pts, pspec_rep, pspec_rep),
        check_vma=False,
    )
    def solve_shard(pixels, mask, points0, cams0):
        local = BAProblem(
            intr=intr, pixels=pixels, mask=mask, points0=points0, cams0=cams0
        )

        def step(carry):
            points, cams, i, _ = carry
            blocks = compute_blocks(intr, local, points, cams)
            Vinv, gp, W = schur_point_blocks(blocks, lam, dtype)
            U, SW, gc, rhs_red = schur_camera_partials(blocks, Vinv, gp, W)
            # the only communication: reduce the camera system over the mesh
            U, SW, gc, rhs_red = jax.lax.psum((U, SW, gc, rhs_red), axis)
            dc_raw = schur_assemble_solve(
                U, SW, gc, rhs_red, lam, dtype,
                cg_tol=config.cg_tol,
                cg_max_iters=(config.cg_max_iters
                              if config.camera_solver == "cg" else 0),
            )
            dp = schur_backsub(Vinv, gp, W, dc_raw) * config.step_scale
            dcams = dc_raw.reshape(nc, 6) * config.step_scale
            # convergence metric matches single-device ba_schur (global rms)
            nx_pts = jnp.asarray(nt * 3, dtype)
            sum_dp = jax.lax.psum(jnp.sum(dp * dp), axis)
            nx = nx_pts + (nc - 1) * 6
            drms = jnp.sqrt((sum_dp + jnp.sum(dcams[1:] ** 2)) / nx)
            return points + dp, cams + dcams, i + 1, drms

        def cond(carry):
            _, _, i, d = carry
            return (i < config.max_iters) & (d >= tol)

        points, cams, iters, _ = jax.lax.while_loop(
            cond, step, (points0, cams0, jnp.int32(0), jnp.asarray(jnp.inf, dtype))
        )
        return points, cams, iters

    points, cams, iters = solve_shard(
        problem.pixels, problem.mask, problem.points0, problem.cams0
    )
    return BAResult(
        points=points, cams=cams, iterations=iters,
        residual_rms=ba_residual_rms(problem, points, cams),
    )
