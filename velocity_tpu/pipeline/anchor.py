"""Scale-transfer re-anchoring of structure once baseline accumulates.

Two strategies, selected by ``PipelineConfig.anchor``:
- "msv": the reference's active path (fcnMSV1_t, vidExample.py:155-160) —
  multi-view ray-intercept triangulation + GN over the newest camera.
- "ba":  the reference's dormant path (the commented fcnNLS_batch call,
  vidExample.py:157) — windowed bundle adjustment over frames 0..i jointly
  refining structure and the camera track (Schur solver). Identity damping
  keeps the free monocular scale gauge pinned to the plate-anchored init.

Both run host-side in f64 (one-shot per video; triangulation of distant
background features is noise-amplifying).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from velocity_tpu.config import PipelineConfig, BAConfig
from velocity_tpu.solvers.triangulate import msv_refine_translation
from velocity_tpu.solvers.ba import BAProblem
from velocity_tpu.solvers.schur import ba_schur

# plate-pose candidates whose 4-corner rms exceeds the best by more than this
# (px) are not interpretations of the corners (both planar branches of a
# hand-clicked quad lie within a few px of each other)
PLATE_FIT_SLACK_PX = 5.0


def resolve_plate_pose(intr64, q, track_px, cfg: PipelineConfig):
    """Disambiguate the frame-0 planar plate pose using the early tracks.

    The 4-corner fit alone cannot pick the right branch of the planar-pose
    two-fold ambiguity when the quad is noisy (solvers/pose.py
    plate_pose_candidates); the branches predict very different multi-frame
    motion, so the track history over frames 1..k decides: for each
    candidate, backproject the frame-0 plate-box features onto its plate
    plane, re-solve the per-frame translations, and keep the branch with the
    lower mean tracked reprojection rms.

    Returns (pose0, p3_plate (N,3), t_track (k+1,3), res_track (k+1,)) for
    the winning branch — t_track[0] = 0 (frame-0 gauge), res_track[0] = the
    4-corner residual.
    """
    import jax.numpy as jnp

    from velocity_tpu.geometry.plate import license_plate_points
    from velocity_tpu.geometry.projection import image_to_world_plane
    from velocity_tpu.pipeline.roi import bounding_rect, inside_bbox
    from velocity_tpu.solvers.pose import (
        plate_pose_candidates, solve_translation_np)

    k1, N, _ = track_px.shape
    plate = jnp.asarray(license_plate_points(cfg.plate_country), jnp.float64)
    q64 = jnp.asarray(q, jnp.float64)
    cands = plate_pose_candidates(intr64, q64, plate, cfg.solver)
    # the tracks of a plane do not fix its distance, so a polish that never
    # converged onto the corners can score as well as the true pose at
    # another scale: only candidates that explain the corners compete
    best_fit = float(cands[0].residual_rms)
    cands = [c for c in cands
             if float(c.residual_rms) <= best_fit + PLATE_FIT_SLACK_PX]
    p0 =np.nan_to_num(track_px[0].astype(np.float64))
    valid0 = np.isfinite(track_px[0]).all(axis=1)
    boxa = bounding_rect(np.asarray(q), (10**9, 10**9), border=(0, 0))
    vp0 = valid0 & inside_bbox(p0, boxa)
    scfg = cfg.solver

    def _solve_frame(pix_f, p3c, m, prev):
        """Trace-free numpy twin of the device translation solve, including
        its robust second pass (solvers/pose.py estimate_world_camera_pose)."""
        t, rms = solve_translation_np(
            intr64, pix_f, p3c, prev, m, max_iters=scfg.max_iters_pose,
            damping=scfg.damping, tol=scfg.tol, ramp_rate=scfg.ramp_rate)
        if (scfg.pose_reject_sigma > 0 and scfg.pose_reject_above_px > 0
                and rms > scfg.pose_reject_above_px):
            fx, fy = float(intr64.fx), float(intr64.fy)
            cx, cy = float(intr64.cx), float(intr64.cy)
            pc = p3c + t
            u = fx * pc[:, 0] / pc[:, 2] + cx
            v = fy * pc[:, 1] / pc[:, 2] + cy
            err = np.where(m, np.hypot(pix_f[:, 0] - u, pix_f[:, 1] - v), 0.0)
            rms1 = np.sqrt((err ** 2).sum() / max(m.sum(), 1))
            m2 = m & (err <= scfg.pose_reject_sigma * rms1)
            if m2.sum() >= 8:
                t, rms = solve_translation_np(
                    intr64, pix_f, p3c, t, m2,
                    max_iters=scfg.max_iters_pose, damping=scfg.damping,
                    tol=scfg.tol, ramp_rate=scfg.ramp_rate)
        return t, rms

    best = None
    for cand in cands:
        pw2 = np.asarray(image_to_world_plane(
            intr64, cand.R, cand.t, jnp.asarray(p0, jnp.float64)))
        p3c = (np.concatenate([pw2, np.zeros((N, 1))], 1)
               @ np.asarray(cand.R) + np.asarray(cand.t))
        t_track = np.zeros((k1, 3))
        res_track = np.zeros(k1)
        res_track[0] = float(cand.residual_rms)
        prev = np.zeros(3)
        for f in range(1, k1):
            m = vp0 & np.isfinite(track_px[f]).all(axis=1)
            pix_f = np.nan_to_num(track_px[f].astype(np.float64))
            t_f, rms_f = _solve_frame(pix_f, p3c, m, prev)
            t_track[f] = t_f
            res_track[f] = rms_f
            prev = t_f
        score = float(res_track[1:].mean()) if k1 > 1 else res_track[0]
        import os

        if os.environ.get("VELOCITY_TPU_DEBUG_ANCHOR"):
            print(f"[anchor] candidate res0={float(cand.residual_rms):.3f} "
                  f"normal={np.round(np.asarray(cand.R)[2], 2)} "
                  f"score={score:.3f} "
                  f"dx={np.round(np.linalg.norm(np.diff(t_track, axis=0), axis=1), 3)}",
                  flush=True)
        if best is None or score < best[0]:
            best = (score, cand, p3c, t_track, res_track)
    _score, pose0, p3c, t_track, res_track = best
    return pose0, p3c, t_track, res_track


def reanchor(
    cfg: PipelineConfig,
    cam,
    scale: float,
    track_px: np.ndarray,  # (i+1, N, 2) pixel history, NaN where invalid
    vg: np.ndarray,  # (N,) current global validity
    B: np.ndarray,  # (i+1, 14) car rows (B[:,0:3] positions)
    t_cur: np.ndarray,  # (3,) current frame translation
    p3: np.ndarray,  # (N, 3) current structure
    q: np.ndarray | None = None,  # (4, 2) plate corners (enables the
    # frame-0 planar-pose disambiguation; None = trust the incoming B/p3)
):
    """Return (p3_new, t_new or None, res_new or None) after the
    scale-transfer refinement. ``t_new``/``res_new`` (rows 0..i) replace the
    trajectory/residual columns when the refinement re-solved them."""
    prev_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            intr64 = cam.intrinsics(scale=scale).astype(jnp.float64)
            if cfg.anchor == "ba":
                nf = track_px.shape[0]
                # observations: frames x tracks; mask = track valid (tracks
                # alive at frame i were alive in all prior frames)
                pix = np.nan_to_num(track_px.astype(np.float64), nan=0.0)
                mask = np.repeat(vg[None, :], nf, axis=0) & np.isfinite(
                    track_px[..., 0]
                )
                cams0 = np.zeros((nf, 6))
                cams0[:, 0:3] = B[:nf, 0:3] - B[0, 0:3]  # t_j relative
                prob = BAProblem(
                    intr=intr64,
                    pixels=jnp.asarray(pix),
                    mask=jnp.asarray(mask),
                    points0=jnp.asarray(
                        np.where(vg[:, None], p3, np.array([0.0, 0.0, 5.0]))
                    ),
                    cams0=jnp.asarray(cams0),
                )
                # translation-only cameras: the pipeline's motion model holds
                # R = I (vidExample.py:120); free rotations are unidentifiable
                # on these tiny baselines and corrupt the track
                res = ba_schur(prob, cfg.ba, fix_rotations=True)
                p3_new = np.array(p3)
                pts = np.asarray(res.points)
                p3_new[vg] = pts[vg]
                # refined camera track -> ABSOLUTE rows; caller updates B
                t_abs = B[0, 0:3] + np.asarray(res.cams)[:, 0:3]
                return p3_new, t_abs, None

            # default: MSV, optionally preceded by the frame-0 planar-pose
            # disambiguation (needs the plate corners q)
            t_cur64 = np.asarray(t_cur, np.float64)
            origins = np.array(B[: track_px.shape[0], 0:3], np.float64)
            p3_base = np.array(p3)
            t_abs = None
            res_new = None
            if q is not None:
                pose0, p3c, t_rel, res_track = resolve_plate_pose(
                    intr64, q, track_px, cfg)
                t0_new = np.asarray(pose0.t, np.float64)
                t_abs = t0_new[None, :] + t_rel
                origins = t_abs
                p3_base = np.where(
                    np.isfinite(track_px[0]).all(axis=1)[:, None], p3c, p3)
                t_cur64 = t_rel[-1]
                res_new = res_track
            msv = msv_refine_translation(
                intr64,
                jnp.asarray(track_px, jnp.float64),
                jnp.asarray(vg),
                jnp.asarray(origins, jnp.float64),
                config=cfg.solver,
            )
            cloud = np.asarray(msv.points) - t_cur64
            p3_new = np.array(p3_base)
            p3_new[vg] = cloud[vg]
            return p3_new, t_abs, res_new
    finally:
        jax.config.update("jax_enable_x64", prev_x64)
