"""The end-to-end speed estimation driver.

Replicates the reference pipeline (vidExample.py:13-181) with device compute:
host decodes frames (prefetch thread); tracking, pose solves and triangulation
run as jitted static-shape stages; per-frame stats mirror the reference's
9-column table.

Frame protocol (reference parity):
  frame 0: plate-ROI Harris init (+subpix), 6-DoF plate solve, plane
           backprojection of all features, R := I           (vidExample.py:105-131)
  frame i: 3-stage KLT -> mask composition -> 3-param translation solve on the
           plate-proximal subset -> speed integration        (vidExample.py:132-146)
  frame msv_frame: MSV triangulation re-anchors p3 and widens the solve to all
           features                                          (vidExample.py:155-160)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

from velocity_tpu.config import PipelineConfig
from velocity_tpu.camera.annotations import Annotation, load_annotation, find_annotation
from velocity_tpu.camera.database import CameraInfo
from velocity_tpu.geometry.plate import license_plate_points
from velocity_tpu.geometry.projection import Intrinsics, image_to_world_plane
from velocity_tpu.ingest.video import open_video
from velocity_tpu.ops.harris import good_features, corner_subpix
from velocity_tpu.pipeline import report
from velocity_tpu.pipeline.roi import bounding_rect, inside_bbox
from velocity_tpu.pipeline.tracker import (
    ThreeStageTracker,
    frame_pyramids_jit,
    fused_frame_step,
    fused_frame_step_pyr,
)
from velocity_tpu.solvers.pose import estimate_world_camera_pose
from velocity_tpu.solvers.triangulate import msv_refine_translation


@dataclass
class RunResult:
    """Everything the reference run produces, in analysis-friendly layout."""

    S: np.ndarray  # (n, 9) stats table (reference columns)
    B: np.ndarray  # (n, 14) car info [xyz, t_xyz(3:6), ecef(6:9), lla(9:12), t, frame#]
    track_px: np.ndarray  # (n, N, 2) tracked pixels (NaN where invalid)
    proj_px: np.ndarray  # (n, N, 2) reprojections (NaN where not in solve)
    valid: np.ndarray  # (n, N) track validity per frame
    plate_box: tuple
    roi_box: tuple
    camera: CameraInfo = None
    config: PipelineConfig = None
    first_gray: np.ndarray | None = None
    last_gray: np.ndarray | None = None
    timings: dict = field(default_factory=dict)
    rescues: int = 0  # frames on which the host feature-match rescue ran

    @property
    def speed_kmh(self) -> float:
        return float(self.S[1:, 8].mean())

    @property
    def speed_std(self) -> float:
        return float(self.S[1:, 8].std())

    @property
    def residual_px(self) -> float:
        return float(self.S[1:, 3].mean())

    def smoothed(self, degree: int = 3):
        """(distance_fit_m, speed_fit_kmh): polynomial-smoothed curves
        (MATLAB parity, runExample.m:185-190 — see report.polyfit_speed)."""
        from velocity_tpu.pipeline.report import polyfit_speed

        return polyfit_speed(self.S, degree)


from functools import partial


def _fit_plane(p3, valid):
    """Least-squares plane n . x = d through the valid structure points."""
    pts = p3[valid]
    c = pts.mean(axis=0)
    _u, _s, vt = np.linalg.svd(pts - c, full_matrices=False)
    n = vt[-1]
    return n, float(n @ c)


@partial(jax.jit, static_argnames=("box", "max_corners", "quality", "block", "k",
                                   "subpix_win", "subpix_iters", "subpix_eps"))
def _init_features_jit(gray, box, max_corners, quality, block, k,
                       subpix_win, subpix_iters, subpix_eps):
    """Harris-in-ROI + subpixel refine as one compiled graph: a single
    dispatch returning (refined points in image coords, validity).
    """
    x0, x1, y0, y1 = box
    roi = gray[y0:y1, x0:x1]
    corners = good_features(roi, max_corners=max_corners, quality_level=quality,
                            block=block, k=k)
    pts = corners.points + jnp.asarray([x0, y0], corners.points.dtype)
    refined = corner_subpix(gray, pts, half_win=subpix_win,
                            max_iters=subpix_iters, eps=subpix_eps)
    return refined, corners.valid


@partial(jax.jit, static_argnames=("solver_cfg",))
def _init_geometry_jit(intr, q, plate, p, solver_cfg):
    """Frame-0 plate solve + plane backprojection as one compiled graph
    (op-by-op execution of the LM solver costs ~0.4 s/run on host)."""
    pose0 = estimate_world_camera_pose(intr, q, plate, find_R=True,
                                       config=solver_cfg)
    pw2 = image_to_world_plane(intr, pose0.R, pose0.t, p)
    pw3 = jnp.concatenate([pw2, jnp.zeros((p.shape[0], 1), pw2.dtype)], axis=1)
    p3 = pw3 @ pose0.R + pose0.t
    return pose0.t, p3, pose0.residual_rms


class SpeedEstimator:
    def __init__(self, config: PipelineConfig = PipelineConfig()):
        self.config = config
        self.tracker = ThreeStageTracker(config.tracker)
        self.rescues = 0  # feature-match rescues since the last run() began

    # ------------------------------------------------------------------ init
    def _init_features_dispatch(self, gray, q: np.ndarray):
        """Enqueue the frame-0 Harris+subpix graph; returns device refs +
        boxes without fetching, so callers can overlap host work with the
        device execution (see scan.py's staged upload gates)."""
        cfg = self.config.tracker
        boxa = bounding_rect(q, gray.shape, border=(0, 0))
        boxb = bounding_rect(q, gray.shape, border=self.config.tracker.roi_border)
        refined_d, cvalid_d = _init_features_jit(
            jnp.asarray(gray), tuple(int(v) for v in boxb),
            cfg.max_features - 4, cfg.harris_quality, cfg.harris_block,
            cfg.harris_k, cfg.subpix_window, cfg.subpix_iters, cfg.subpix_eps,
        )
        return refined_d, cvalid_d, boxa, boxb

    def _init_features_finish(self, refined_d, cvalid_d, q: np.ndarray):
        """Fetch + assemble the fixed-capacity lane arrays (plate corners in
        lanes 0..3, reference vidExample.py:116)."""
        cfg = self.config.tracker
        refined = np.asarray(refined_d)
        cvalid = np.asarray(cvalid_d)
        N = cfg.max_features
        p = np.zeros((N, 2), np.float32)
        valid = np.zeros(N, bool)
        p[0:4] = q
        valid[0:4] = True
        p[4:] = refined
        valid[4:] = cvalid
        return p, valid

    def _init_features(self, gray, q: np.ndarray):
        """Frame-0 feature detection: Harris in the plate ROI + subpixel refine."""
        refined_d, cvalid_d, boxa, boxb = self._init_features_dispatch(gray, q)
        p, valid = self._init_features_finish(refined_d, cvalid_d, q)
        return p, valid, boxa, boxb

    # ------------------------------------------------------------------ init
    def _init_geometry(self, cam: CameraInfo, q: np.ndarray, p: np.ndarray,
                       valid: np.ndarray, scale: float):
        """Frame-0 geometry: 6-DoF plate solve + plane backprojection of all
        features — run on host CPU in float64.

        The plane intersection for off-plate points is intrinsically
        noise-amplifying (grazing incidence), so f32 loses ~cm here no matter
        the formulation; this is a once-per-video init, so it runs f64 on the
        host regardless of the steady-state device dtype.
        """
        cfg = self.config
        prev_x64 = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        try:
            with jax.default_device(jax.devices("cpu")[0]):
                intr64 = cam.intrinsics(scale=scale).astype(jnp.float64)
                plate = jnp.asarray(
                    license_plate_points(cfg.plate_country), jnp.float64
                )
                t0_d, p3_d, res0_d = _init_geometry_jit(
                    intr64, jnp.asarray(q, jnp.float64), plate,
                    jnp.asarray(p, jnp.float64), cfg.solver,
                )
                p3 = np.array(p3_d)
                p3[~valid] = 0.0
                t0 = np.asarray(t0_d, np.float64)
                res0 = float(res0_d)
        finally:
            jax.config.update("jax_enable_x64", prev_x64)
        return t0, p3, res0

    # ------------------------------------------------------------ replenish
    def _replenish(self, gray, q, pts, vg, p3, t_abs, intr_np,
                   min_live: int | None = None):
        """Refill dead lanes with fresh Harris corners back-projected onto the
        plane of the live structure; returns (pts, vg, p3, n_new).

        The reference never replenishes (its clips are short); long videos and
        the wide-baseline stills burst shed tracks faster than 20-frame clips,
        so dead lanes are re-seeded at window/frame boundaries. Detection runs
        around the CURRENT plate position (the tracked lanes 0..3) when the
        plate lanes are alive — the annotation ``q`` is frame-0 geometry and
        the car moves. Plate lanes themselves are never re-seeded: BA pins
        them as the metric scale anchor (pin_tracks=4).
        """
        cfg = self.config
        live = int(vg.sum())
        if min_live is None:
            min_live = cfg.tracker.max_features // 2
        if live >= min_live or live < 3:
            return pts, vg, p3, 0
        q_now = pts[0:4] if bool(vg[0:4].all()) else q
        p_new, valid_new, _boxa, _boxb = self._init_features(gray, q_now)
        n_pl, d_pl = _fit_plane(p3, vg)
        fx, fy, cx, cy = intr_np
        dead = ~vg
        cand = valid_new & dead  # only fill lanes that are both free and found
        cand[:4] = False
        # ray of each candidate pixel in the current camera
        rx = (p_new[:, 0] - cx) / fx
        ry = (p_new[:, 1] - cy) / fy
        rays = np.stack([rx, ry, np.ones_like(rx)], axis=1)
        rays /= np.linalg.norm(rays, axis=1, keepdims=True)
        # p = s*ray - t_abs on the plane n.p = d  =>  s = (d + n.t)/(n.ray)
        denom = rays @ n_pl
        s = np.where(np.abs(denom) > 1e-9, (d_pl + n_pl @ t_abs) / denom, np.nan)
        p3_cand = s[:, None] * rays - t_abs[None, :]
        ok = cand & np.isfinite(p3_cand).all(axis=1) & (s > 0)
        pts = np.where(ok[:, None], p_new, pts)
        p3 = np.where(ok[:, None], p3_cand, p3)
        vg = vg | ok
        return pts, vg, p3, int(ok.sum())

    # ------------------------------------------------------------ frame step
    def _frame_step_with_fallback(
        self, pyr_prev, spyr_prev, im_dev, pts_dev, vg_dev, vp_dev, p3,
        intr, kf, sdt, prev_gray, gray, t_prev,
    ):
        """Fused device step + host feature-match rescue on tracking collapse.

        Mirrors the reference's SURF fallback trigger (KLT.py:126-130): when
        stage 2 leaves <= min_affine_inliers survivors, a full-frame feature
        match supplies the affine prior and the fine stage + pose solve rerun.
        The pose solve warm-starts from the previous frame's translation
        (reference: /root/reference/vidExample.py:139 carries the running t).
        """
        import numpy as _np

        cfg = self.config
        out = fused_frame_step_pyr(
            pyr_prev, spyr_prev, im_dev, pts_dev, vg_dev, vp_dev,
            p3, intr, kf, cfg.tracker, cfg.solver, sdt, t_prev,
        )
        pyr_cur, spyr_cur = out[0], out[1]
        out = out[2:]
        if int(out[6]) <= cfg.tracker.min_affine_inliers:
            self.rescues += 1
            from velocity_tpu.ops.match import affine_from_feature_match
            from velocity_tpu.pipeline.tracker import _track_fine_p
            from velocity_tpu.solvers.pose import estimate_world_camera_pose

            pnp = _np.asarray(pts_dev)
            vnp = _np.asarray(vg_dev)
            if cfg.tracker.car_affine:
                # car-anchored rescue: search only around the tracked plate
                # so the match affine locks onto the car's motion group
                lo = pnp[0:4].min(axis=0)
                hi = pnp[0:4].max(axis=0)
                m = cfg.tracker.car_margin * float(_np.linalg.norm(hi - lo))
                inbox = ((pnp[:, 0] >= lo[0] - m) & (pnp[:, 0] <= hi[0] + m)
                         & (pnp[:, 1] >= lo[1] - m) & (pnp[:, 1] <= hi[1] + m))
                vm = vnp & inbox
                vnp = vm if vm.sum() >= 4 else vnp
            T23 = affine_from_feature_match(prev_gray, gray, pnp, vnp,
                                            scale=0.5)
            T23j = jnp.asarray(T23, jnp.float32)
            p_new, vg_new = _track_fine_p(
                pyr_prev, pyr_cur, pts_dev, vg_dev, T23j, cfg.tracker
            )
            vp_new = vp_dev & vg_new
            pose = estimate_world_camera_pose(
                intr, p_new.astype(sdt), p3,
                t0=(t_prev.astype(sdt) if t_prev is not None
                    else jnp.asarray([0.0, 0.0, 1.0], sdt)),
                R0=jnp.eye(3, dtype=sdt), find_R=False,
                mask=vp_new, config=cfg.solver,
            )
            packed = jnp.concatenate([
                pose.t.astype(jnp.float32),
                jnp.asarray([pose.residual_rms], jnp.float32),
                jnp.asarray([jnp.sum(vg_new)], jnp.float32),
                jnp.asarray([out[6]], jnp.float32),
            ])
            out = (
                p_new, vg_new, vp_new,
                pose.t, pose.residual_rms, pose.p_proj, out[6], T23j, packed,
            )
        return (pyr_cur, spyr_cur) + out

    # ------------------------------------------------------------------- run
    def run(
        self,
        video: str | Path,
        annotation: str | Path | Annotation | None = None,
        n_frames: int | None = None,
        start_frame: int | None = None,
        verbose: bool = True,
        collect_images: bool = True,
        lean: bool = False,
    ) -> RunResult:
        """Track ``video`` (a media path or a reader, see
        ``ingest.video.open_video``) frame by frame."""
        cfg = self.config
        # steady-state solver dtype: f64 only when both requested and available
        want64 = cfg.solver.dtype == "float64" and jax.config.jax_enable_x64
        sdt = jnp.float64 if want64 else jnp.float32
        n = n_frames if n_frames is not None else cfg.n_frames
        self.rescues = 0

        with open_video(video, cfg.platform) as vr:
            cam = vr.info
            if annotation is None:
                ann = load_annotation(
                    find_annotation(video, [Path(video).parent.parent / "matlab", Path(video).parent])
                )
            else:
                ann = load_annotation(annotation)

            scale = cfg.native_scale
            q = ann.q * scale  # native-4K annotation -> this video's resolution
            intr = cam.intrinsics(scale=scale).astype(sdt)
            start = (
                start_frame
                if start_frame is not None
                else (cfg.start_frame if cfg.start_frame is not None else ann.start_frame)
            )
            if start is None:
                raise ValueError("no start frame (annotation lacks one; pass start_frame)")

            N = cfg.tracker.max_features
            B = np.zeros((n, 14), np.float64)
            S = np.zeros((n, 9), np.float64)
            track_px = np.full((n, N, 2), np.nan, np.float32)
            proj_px = np.full((n, N, 2), np.nan, np.float32)
            valid_hist = np.zeros((n, N), bool)

            key = jax.random.PRNGKey(0)
            t_wall0 = time.time()
            if verbose:
                print(f"Starting image processing on {video} ...")
                print(report.header())

            state = {}
            frames = vr.prefetch(start=start, count=n, step=cfg.read_speed)
            first_gray = last_gray = None
            for i, fr in enumerate(frames):
                tic = time.time()
                B[i, 12] = fr.time_s
                B[i, 13] = fr.index
                gray = fr.gray
                prev_gray = last_gray
                last_gray = gray
                im_dev = jnp.asarray(gray)

                if i == 0:
                    first_gray = gray if collect_images else None
                    p, valid, boxa, boxb = self._init_features(gray, q)
                    t_np, p3_np, res0 = self._init_geometry(cam, q, p, valid, scale)
                    t = jnp.asarray(t_np, sdt)
                    p3 = jnp.asarray(p3_np, sdt)
                    residuals = res0
                    R = jnp.eye(3, dtype=sdt)
                    B[0, 0:3] = t_np
                    vg = valid.copy()
                    vp = valid & inside_bbox(p, boxa)
                    pts_dev = jnp.asarray(p, jnp.float32)
                    vg_dev = jnp.asarray(vg)
                    vp_dev = jnp.asarray(vp)
                    pyr_prev, spyr_prev = frame_pyramids_jit(im_dev, cfg.tracker)
                    dt = np.nan
                    dr = 0.0
                    dist = 0.0
                    t0_time = B[0, 12]
                    p_proj_frame = None
                    n_tracks = float(vg.sum())
                else:
                    key, kf = jax.random.split(key)
                    (
                        pyr_prev, spyr_prev,
                        pts_dev, vg_dev, vp_dev,
                        t, residuals, pproj_dev, n2, _T23, packed_dev,
                    ) = self._frame_step_with_fallback(
                        pyr_prev, spyr_prev, im_dev, pts_dev, vg_dev, vp_dev,
                        p3, intr, kf, sdt, prev_gray, gray, t,
                    )
                    if lean and i > cfg.msv_frame:
                        # transfer-lean steady state: one packed vector/frame
                        packed = np.asarray(packed_dev, np.float64)
                        tnp = packed[0:3]
                        residuals = packed[3]
                        n_tracks = packed[4]
                        vg = vp = p_proj_frame = None
                    else:
                        vg = np.asarray(vg_dev)
                        vp = np.asarray(vp_dev)
                        p_proj_frame = np.asarray(pproj_dev)
                        tnp = np.asarray(t, np.float64)
                        n_tracks = None

                    dt = B[i, 12] - B[i - 1, 12]
                    dr = float(np.linalg.norm(tnp + B[0, 0:3] - B[i - 1, 0:3]))
                    dist += dr
                    B[i, 3:6] = tnp
                    B[i, 0:3] = B[0, 0:3] + tnp

                # record history (skipped in lean steady state)
                if vg is not None:
                    pnp = np.asarray(pts_dev)
                    track_px[i, vg] = pnp[vg]
                    valid_hist[i] = vg
                    if p_proj_frame is not None:
                        proj_px[i, vp] = p_proj_frame[vp]
                    n_tracks = float(vg.sum())

                if i == cfg.msv_frame:
                    # scale transfer (once per video; host f64 — see anchor.py)
                    from velocity_tpu.pipeline.anchor import reanchor

                    p3_new, t_abs, res_new = reanchor(
                        cfg, cam, scale, track_px[: i + 1], vg, B,
                        np.asarray(t, np.float64), np.array(p3),
                        q=np.asarray(q, np.float64),
                    )
                    p3 = jnp.asarray(p3_new, sdt)
                    if t_abs is not None:  # anchor re-solved the trajectory
                        B[: i + 1, 0:3] = t_abs
                        B[: i + 1, 3:6] = t_abs - t_abs[0]
                        t = jnp.asarray(t_abs[-1] - t_abs[0], sdt)
                        # rewrite the already-recorded stats rows in the new
                        # gauge (the reference never revisits them, but its
                        # table is then inconsistent with its own B)
                        dist = 0.0
                        for r in range(i + 1):
                            drr = (float(np.linalg.norm(
                                B[r, 0:3] - B[r - 1, 0:3])) if r > 0 else 0.0)
                            dist += drr
                            S[r, 6] = drr
                            S[r, 7] = dist
                            dtr = S[r, 4]
                            S[r, 8] = (drr / dtr * 3.6
                                       if r > 0 and np.isfinite(dtr) and dtr > 0
                                       else np.nan)
                            if res_new is not None:
                                S[r, 3] = res_new[r]
                    vp = vg.copy()
                    vp_dev = jnp.asarray(vp)

                S[i, :] = (
                    i,
                    time.time() - tic,
                    n_tracks,
                    float(residuals),
                    dt,
                    B[i, 12] - t0_time,
                    dr,
                    dist,
                    dr / dt * 3.6 if np.isfinite(dt) and dt > 0 else np.nan,
                )
                if verbose:
                    print(report.row(S[i]))

            wall = time.time() - t_wall0
            if verbose:
                print(report.summary(S))
                print(f"Processed {n:g} images in {wall:.2f}s ({n / wall:.2f}fps)\n")

        return RunResult(
            S=S,
            B=B,
            track_px=track_px,
            proj_px=proj_px,
            valid=valid_hist,
            plate_box=boxa,
            roi_box=boxb,
            camera=cam,
            config=cfg,
            first_gray=first_gray,
            last_gray=last_gray if collect_images else None,
            timings={"wall_s": wall, "fps": n / wall},
            rescues=self.rescues,
        )
