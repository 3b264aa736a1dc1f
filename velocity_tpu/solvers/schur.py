"""Block-sparse Gauss-Newton/LM bundle adjustment with Schur-complement camera
reduction — the accelerator BA core.

Identical iterates to ``ba_dense`` (same normal equations H = [[U,W],[W^T,V]],
same damping/step rules) but never materializes H: per-observation 2x3 point
and 2x6 camera Jacobian blocks are assembled analytically on the dense
(nc, nt) observation grid as batched einsums, the 3x3 point
blocks are inverted batched, and only the reduced (6(nc-1))^2 camera system is
solved densely.

This layout is what ``parallel/ba_dist.py`` shards: the point axis (nt)
partitions across devices; ``psum`` reduces S and the camera rhs over the mesh;
the small camera solve is replicated; back-substitution is local per shard.
Cost per iteration: O(nc*nt) small-block math + O((6nc)^3) replicated solve.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from velocity_tpu.config import BAConfig
from velocity_tpu.geometry.projection import Intrinsics
from velocity_tpu.geometry.rotations import rpy_to_matrix
from velocity_tpu.solvers.ba import BAProblem, BAResult, ba_residual_rms


class BABlocks(NamedTuple):
    """Per-iteration block quantities on the (nc, nt) observation grid."""

    r: jnp.ndarray  # (nc, nt, 2) normalized masked residuals (z - zhat)/fx
    A: jnp.ndarray  # (nc, nt, 2, 3) d zhat_n / d point
    B: jnp.ndarray  # (nc, nt, 2, 6) d zhat_n / d [pos, rpy] (zero for cam 0)


def compute_blocks(
    intr: Intrinsics, problem: BAProblem, points, cams, fix_rotations: bool = False
) -> BABlocks:
    """Analytic residual + Jacobian blocks for all observations.

    ``fix_rotations``: zero the rpy Jacobian columns — cameras optimize
    translation only (the driver's translation-only motion model; rotations
    stay at their initial values, typically identity). The damping keeps the
    reduced system non-singular and the rpy deltas exactly zero.
    """
    dtype = points.dtype
    nc = cams.shape[0]
    inv_f = (1.0 / intr.fx).astype(dtype) if hasattr(intr.fx, "astype") else 1.0 / intr.fx

    C = rpy_to_matrix(cams[:, 3:6])  # (nc, 3, 3)
    dC = jax.vmap(jax.jacfwd(rpy_to_matrix))(cams[:, 3:6])  # (nc, 3, 3, 3) [i,j,param]
    pc = jnp.einsum("tm,cmk->ctk", points, C) + cams[:, None, 0:3]  # (nc, nt, 3)

    X, Y, Z = pc[..., 0], pc[..., 1], pc[..., 2]
    iz = 1.0 / Z
    u = (intr.fx * X + intr.skew * Y) * iz + intr.cx
    v = intr.fy * Y * iz + intr.cy
    zhat = jnp.stack([u, v], axis=-1)
    m = problem.mask[..., None]
    r = jnp.where(m, problem.pixels - zhat, 0.0) * inv_f

    # L = d zhat_n / d pc : (nc, nt, 2, 3), masked
    a = intr.fx * X + intr.skew * Y
    zero = jnp.zeros_like(iz)
    L = jnp.stack(
        [
            jnp.stack([intr.fx * iz, intr.skew * iz, -a * iz * iz], axis=-1),
            jnp.stack([zero, intr.fy * iz, -intr.fy * Y * iz * iz], axis=-1),
        ],
        axis=-2,
    ) * inv_f
    L = jnp.where(m[..., None], L, 0.0)

    # A = L @ C^T  (d pc_k / d pw_m = C[m, k])
    A = jnp.einsum("ctik,cmk->ctim", L, C)  # (nc, nt, 2, 3)

    # B: position part = L; rpy part = L @ (pw @ dC)
    dpc_drpy = jnp.einsum("tm,cmkp->ctkp", points, dC)  # (nc, nt, 3, 3params)
    B_rpy = jnp.einsum("ctik,ctkp->ctip", L, dpc_drpy)  # (nc, nt, 2, 3)
    if fix_rotations:
        B_rpy = jnp.zeros_like(B_rpy)
    B = jnp.concatenate([L, B_rpy], axis=-1)  # (nc, nt, 2, 6)
    cam_free = (jnp.arange(nc) > 0)[:, None, None, None]
    B = jnp.where(cam_free, B, 0.0)
    return BABlocks(r=r, A=A, B=B)


def schur_point_blocks(blocks: BABlocks, damping: float, dtype):
    """Per-point quantities (no cross-point coupling — shard-local).

    Returns (Vinv (nt,3,3), gp (nt,3), W (nc,nt,6,3)).
    """
    r, A, B = blocks
    lam = jnp.asarray(damping, dtype)
    V = jnp.einsum("ctim,ctin->tmn", A, A) + lam * jnp.eye(3, dtype=dtype)
    W = jnp.einsum("ctia,ctim->ctam", B, A)
    gp = jnp.einsum("ctim,cti->tm", A, r)
    Vinv = jnp.linalg.inv(V)
    return Vinv, gp, W


def schur_camera_partials(blocks: BABlocks, Vinv, gp, W):
    """Point-summed camera-system contributions — the quantities that get
    ``psum``-reduced over the point-sharding mesh axis.

    Returns (U (nc,6,6), SW (nc,nc,6,6), gc (nc,6), rhs_red (nc,6)) where the
    reduced system is S = diag(U + lam I) - SW, rhs = gc - rhs_red.
    """
    r, A, B = blocks
    U = jnp.einsum("ctia,ctib->cab", B, B)
    gc = jnp.einsum("ctia,cti->ca", B, r)
    WVinv = jnp.einsum("ctam,tmn->ctan", W, Vinv)
    SW = jnp.einsum("ctan,dtbn->cdab", WVinv, W)
    rhs_red = jnp.einsum("ctan,tn->ca", WVinv, gp)
    return U, SW, gc, rhs_red


def schur_assemble_solve(U, SW, gc, rhs_red, damping: float, dtype,
                         cg_tol: float = 0.0, cg_max_iters: int = 0):
    """Assemble the reduced camera system, pin camera 0, solve for dc (nc*6,).

    ``cg_max_iters > 0`` solves by Jacobi-preconditioned conjugate gradients
    instead of the dense factorization — the reduced camera matrix is SPD
    (damped GN), and for long windows the O((6 nc)^3) dense solve overtakes
    the O(iters (6 nc)^2) CG (SURVEY.md §7.3 item 5: "CG fallback when camera
    count grows").
    """
    nc = U.shape[0]
    lam = jnp.asarray(damping, dtype)
    eye6 = jnp.eye(6, dtype=dtype)
    diag = U + lam * eye6
    S_blocks = -SW + jnp.einsum("cab,cd->cdab", diag, jnp.eye(nc, dtype=dtype))
    rhs_c = gc - rhs_red

    free = (jnp.arange(nc) > 0).astype(dtype)
    S_blocks = S_blocks * free[:, None, None, None] * free[None, :, None, None]
    S_blocks = S_blocks.at[0, 0].set(eye6)
    rhs_c = rhs_c * free[:, None]

    S = S_blocks.transpose(0, 2, 1, 3).reshape(nc * 6, nc * 6)
    b = rhs_c.reshape(nc * 6)
    if cg_max_iters > 0:
        from jax.scipy.sparse.linalg import cg

        d = jnp.diagonal(S)
        Minv = jnp.where(jnp.abs(d) > 0, 1.0 / d, 1.0)
        x, _ = cg(lambda v: S @ v, b, tol=cg_tol, maxiter=cg_max_iters,
                  M=lambda v: Minv * v)
        return x
    return jnp.linalg.solve(S, b)


def schur_reduce(blocks: BABlocks, damping: float, dtype):
    """Single-device path: form and solve pieces in one go.

    Returns (S, rhs, Vinv, gp, W) with S/rhs pre-assembly retained for tests.
    """
    Vinv, gp, W = schur_point_blocks(blocks, damping, dtype)
    U, SW, gc, rhs_red = schur_camera_partials(blocks, Vinv, gp, W)
    nc = U.shape[0]
    lam = jnp.asarray(damping, dtype)
    eye6 = jnp.eye(6, dtype=dtype)
    diag = U + lam * eye6
    S_blocks = -SW + jnp.einsum("cab,cd->cdab", diag, jnp.eye(nc, dtype=dtype))
    rhs_c = gc - rhs_red
    free = (jnp.arange(nc) > 0).astype(dtype)
    S_blocks = S_blocks * free[:, None, None, None] * free[None, :, None, None]
    S_blocks = S_blocks.at[0, 0].set(eye6)
    rhs_c = rhs_c * free[:, None]
    S = S_blocks.transpose(0, 2, 1, 3).reshape(nc * 6, nc * 6)
    rhs = rhs_c.reshape(nc * 6)
    return S, rhs, Vinv, gp, W


def schur_backsub(Vinv, gp, W, dc):
    """Point updates: dp_t = Vinv_t (gp_t - sum_c W_ct^T dc_c)."""
    nc = W.shape[0]
    dcb = dc.reshape(nc, 6)
    Wt_dc = jnp.einsum("ctam,ca->tm", W, dcb)  # (nt, 3)
    return jnp.einsum("tmn,tn->tm", Vinv, gp - Wt_dc)


def ba_schur(
    problem: BAProblem, config: BAConfig = BAConfig(), fix_rotations: bool = False
) -> BAResult:
    """Schur-complement BA; same optimum/iterates as ba_dense."""
    intr = problem.intr
    dtype = problem.points0.dtype
    nc = problem.cams0.shape[0]
    inv_f = 1.0 / intr.fx
    lam = config.damping * inv_f * inv_f  # damping matched to normalized residuals
    tol = max(config.tol, 50.0 * float(jnp.finfo(dtype).eps))

    use_cg = config.camera_solver == "cg"

    def step(carry):
        points, cams, i, _ = carry
        blocks = compute_blocks(intr, problem, points, cams, fix_rotations)
        S, rhs, Vinv, gp, W = schur_reduce(blocks, lam, dtype)
        if use_cg:
            from jax.scipy.sparse.linalg import cg

            d = jnp.diagonal(S)
            Minv = jnp.where(jnp.abs(d) > 0, 1.0 / d, 1.0)
            dc_raw, _ = cg(lambda v: S @ v, rhs, tol=config.cg_tol,
                           maxiter=config.cg_max_iters, M=lambda v: Minv * v)
        else:
            dc_raw = jnp.linalg.solve(S, rhs)
        dp = schur_backsub(Vinv, gp, W, dc_raw) * config.step_scale
        dcams = dc_raw.reshape(nc, 6) * config.step_scale
        new_points = points + dp
        new_cams = cams + dcams
        nx = dp.size + (nc - 1) * 6
        drms = jnp.sqrt(
            (jnp.sum(dp * dp) + jnp.sum(dcams[1:] ** 2)) / nx
        )
        return new_points, new_cams, i + 1, drms

    def cond(carry):
        _, _, i, d = carry
        return (i < config.max_iters) & (d >= tol)

    points, cams, iters, _ = jax.lax.while_loop(
        cond,
        step,
        (problem.points0, problem.cams0, jnp.int32(0), jnp.asarray(jnp.inf, dtype)),
    )
    return BAResult(
        points=points, cams=cams, iterations=iters,
        residual_rms=ba_residual_rms(problem, points, cams),
    )
