"""Long-video windowed driver: full-length videos with windowed BA + resume.

The reference processes a handful of frames in one stateless pass
(/root/reference/vidExample.py:22-23 defaults n=20; the videos hold 201/146/122
frames). This driver composes the pieces SURVEY.md §5 calls for into an
end-to-end long-video path:

  1. continuous tracking through the whole video in window-sized scanned
     segments (the carry — pyramids, tracks, masks, running translation —
     crosses window boundaries, so the trajectory is globally consistent);
  2. track replenishment at window boundaries: when survivorship drops, new
     Harris corners fill dead lanes and are back-projected onto the plane
     fitted to the live structure (the frame-0 plane backprojection,
     vidExample.py:119-120, generalized to the current pose);
  3. checkpoint after every window (parallel/checkpoint.py) so a long run
     resumes at the last completed window boundary;
  4. optional per-window Schur BA refinement over a device mesh
     (parallel/windows.py windowed_ba — window axis x point axis), stitched
     back into the global trajectory gauge-aware (stitch_windows).

The MSV scale transfer runs once at the configured frame inside the first
window, exactly like the short-clip runners.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

from velocity_tpu.config import PipelineConfig
from velocity_tpu.parallel.checkpoint import WindowState, save_state, load_state
from velocity_tpu.pipeline.scan import scan_segment, _PipelinedIngest
from velocity_tpu.pipeline.tracker import frame_pyramids_jit


class LongVideoRunner:
    """Windowed long-video speed estimation (see module docstring)."""

    def __init__(self, config: PipelineConfig = PipelineConfig()):
        from velocity_tpu.pipeline.speedest import SpeedEstimator

        self.config = config
        self._est = SpeedEstimator(config)

    # -------------------------------------------------------------- helpers
    def _replenish(self, gray, q, pts, vg, p3, t_abs, intr_np):
        """Refill dead lanes (shared SpeedEstimator._replenish)."""
        return self._est._replenish(gray, q, pts, vg, p3, t_abs, intr_np)

    # ------------------------------------------------------------------ run
    def run(
        self,
        video: str | Path,
        annotation=None,
        n_frames: int | None = None,
        start_frame: int | None = None,
        window: int = 24,
        overlap: int = 3,
        checkpoint: str | Path | None = None,
        resume: bool = False,
        ba_refine: bool = True,
        mesh=None,
        verbose: bool = True,
    ):
        """Run the windowed long-video pipeline.

        ``window``: tracking-segment length; boundaries snap to an absolute
        row grid (multiples of ``window``) so resumed runs replay the exact
        boundary schedule of uninterrupted ones. ``overlap``: number of
        frames each BA refinement window shares with its predecessor (>= 3
        engages the Umeyama similarity gauge stitch; 1 = translation chain).
        """
        from velocity_tpu.camera.annotations import load_annotation, find_annotation
        from velocity_tpu.ingest.video import open_video
        from velocity_tpu.pipeline import report
        from velocity_tpu.pipeline.roi import inside_bbox
        from velocity_tpu.pipeline.speedest import RunResult

        cfg = self.config
        sdt = jnp.float32
        t_wall0 = time.time()

        with open_video(video, cfg.platform) as vr:
            cam = vr.info
            if annotation is None:
                ann = load_annotation(find_annotation(
                    video, [Path(video).parent.parent / "matlab",
                            Path(video).parent]))
            else:
                ann = load_annotation(annotation)
            scale = cfg.native_scale
            q = ann.q * scale
            intr = cam.intrinsics(scale=scale).astype(sdt)
            intr_np = (float(intr.fx), float(intr.fy), float(intr.cx), float(intr.cy))
            start = (start_frame if start_frame is not None else
                     (cfg.start_frame if cfg.start_frame is not None else
                      (ann.start_frame or 0)))
            total = int(cam.frame_count) if cam.frame_count else 10**9
            n = min(n_frames or (total - start), total - start)
            N = cfg.tracker.max_features
            msv_i = cfg.msv_frame

            B = np.zeros((n, 14), np.float64)
            S = np.zeros((n, 9), np.float64)
            track_px = np.full((n, N, 2), np.nan, np.float32)
            valid_hist = np.zeros((n, N), bool)
            key = jax.random.PRNGKey(0)
            all_keys = jax.random.split(key, n)

            # ---- resume or frame-0 init ----
            ckpt = Path(checkpoint) if checkpoint else None
            state = None
            if resume and ckpt is not None and ckpt.exists():
                state = load_state(ckpt)
            ba_meta = []  # (seg_start, seg_end, p3 snapshot) per segment
            if state is not None:
                i0 = state.frame_index  # boundary frame (absolute row index)
                p_np = state.points
                vg_np = state.valid
                vp_np = state.valid_pose
                p3_np = state.p3
                B[: i0 + 1] = state.B
                S[: i0 + 1] = state.S
                if state.track_px is not None:
                    track_px[: i0 + 1] = state.track_px
                if state.valid_hist is not None:
                    valid_hist[: i0 + 1] = state.valid_hist
                valid_hist[i0] = vg_np
                ingest = _PipelinedIngest(video, vr, start + i0, n - i0,
                                          cfg.read_speed)
                base = i0
                res0 = float(S[0, 3])
                if state.boxes is not None:
                    boxa = tuple(int(v) for v in state.boxes[0])
                    boxb = tuple(int(v) for v in state.boxes[1])
                else:
                    boxa = boxb = (0, 0, 0, 0)
                if state.ba_bounds is not None and state.ba_p3 is not None:
                    ba_meta = [
                        (int(s), int(e), state.ba_p3[w].astype(np.float64),
                         (state.ba_repl[w] if state.ba_repl is not None
                          else np.zeros(N, bool)))
                        for w, (s, e) in enumerate(state.ba_bounds)
                    ]
            else:
                ingest = _PipelinedIngest(video, vr, start, n, cfg.read_speed)
                ingest.wait(0)
                p_np, valid, boxa, boxb = self._est._init_features(
                    ingest.grays[0], q)
                t0_np, p3_np, res0 = self._est._init_geometry(
                    cam, q, p_np, valid, scale)
                vg_np = valid.copy()
                vp_np = valid & inside_bbox(p_np, boxa)
                B[0, 0:3] = t0_np
                B[0, 12] = ingest.times[0]
                B[0, 13] = ingest.indices[0]
                track_px[0, vg_np] = p_np[vg_np]
                valid_hist[0] = vg_np
                base = 0

            pyr_b, spyr_b = frame_pyramids_jit(ingest.wait(0), cfg.tracker)
            pts_dev = jnp.asarray(p_np, jnp.float32)
            vg_dev = jnp.asarray(vg_np)
            vp_dev = jnp.asarray(vp_np)
            t_dev = jnp.asarray(B[base, 0:3] - B[0, 0:3], sdt)
            p3_dev = jnp.asarray(p3_np, sdt)

            # ---- window loop (continuous carry) ----
            # ba_meta snapshots (see above) are taken AFTER the MSV re-anchor
            # but BEFORE replenishment, so each window's structure matches the
            # content its pixel rows actually tracked (replenished lanes only
            # change identity at boundaries, after the snapshot)
            i = base  # absolute row index of the carry frame
            # lanes replenished at the upcoming segment's start boundary —
            # recorded per segment so BA's overlap extension can exclude them
            # from pre-boundary rows (their pixels there belong to the lane's
            # previous identity)
            repl_at_start = (state.repl_next.astype(bool)
                             if state is not None and state.repl_next is not None
                             else np.zeros(N, bool))
            # replenished lanes awaiting N-ray triangulation before joining
            # the pose solve (plane-seeded depth is provisional; a static-
            # background corner seeded at car depth drags the solve toward
            # zero motion — same gating as the stills path)
            pending = (state.pending.astype(bool)
                       if state is not None and state.pending is not None
                       else repl_at_start.copy())
            while i < n - 1:
                # segment ends at the next boundary: the next multiple of
                # ``window`` (an ABSOLUTE row grid — a resumed run hits the
                # exact same boundaries as an uninterrupted one), the MSV
                # frame, or the video end — whichever comes first
                nexts = [(i // window + 1) * window, n - 1]
                if i < msv_i < n:
                    nexts.append(msv_i)
                j = min(x for x in nexts if x > i)

                def _run_segment():
                    frames = jnp.stack(
                        [ingest.wait(r - base) for r in range(i + 1, j + 1)])
                    carry, outs = scan_segment(
                        frames, pyr_b, spyr_b, pts_dev, vg_dev, vp_dev, t_dev,
                        p3_dev, intr, all_keys[i + 1 : j + 1],
                        cfg.tracker, cfg.solver, sdt,
                    )
                    return carry, jax.tree.map(np.asarray, outs)

                try:
                    carry, outs = _run_segment()
                except Exception as e:  # window-level fault recovery
                    # a failed segment loses only this window: every input
                    # lives on the host (decoded grays, boundary state
                    # mirrors), so rebuild the device state from the last
                    # boundary and retry once; a second failure propagates.
                    # SURVEY §5: window-level retry is the natural fault
                    # unit of this pipeline.
                    if verbose:
                        print(f"[window @{i}] segment failed "
                              f"({type(e).__name__}: {str(e)[:120]}); "
                              "rebuilding device state and retrying")
                    pyr_b, spyr_b = frame_pyramids_jit(
                        jnp.asarray(ingest.grays[i - base]), cfg.tracker)
                    pts_dev = jnp.asarray(p_np, jnp.float32)
                    vg_dev = jnp.asarray(vg_np)
                    vp_dev = jnp.asarray(vp_np)
                    t_dev = jnp.asarray(B[i, 0:3] - B[0, 0:3], sdt)
                    p3_dev = jnp.asarray(p3_np, sdt)
                    carry, outs = _run_segment()
                ptsW, vgW, vpW, tW, resW, _projW, n2W = outs
                pyr_b, spyr_b, pts_dev, vg_dev, vp_dev, t_dev = carry
                for k in range(j - i):
                    r = i + 1 + k
                    track_px[r, vgW[k]] = ptsW[k][vgW[k]]
                    valid_hist[r] = vgW[k]
                    B[r, 3:6] = tW[k]
                    B[r, 0:3] = B[0, 0:3] + tW[k]
                    S[r, 3] = resW[k]
                # timestamp/index columns fill as frames are ingested, so a
                # checkpoint written at this boundary carries complete rows
                # (resume previously restored zero timestamps -> NaN speeds)
                B[i + 1 : j + 1, 12] = ingest.times[i + 1 - base : j + 1 - base]
                B[i + 1 : j + 1, 13] = ingest.indices[i + 1 - base : j + 1 - base]
                seg_start = i
                i = j

                # ---- MSV scale transfer at the configured frame ----
                if i == msv_i and n > msv_i:
                    from velocity_tpu.pipeline.anchor import reanchor

                    vg_np = np.asarray(vg_dev)
                    p3_new, t_abs, res_new = reanchor(
                        cfg, cam, scale, track_px[: msv_i + 1], vg_np, B,
                        np.asarray(t_dev, np.float64), np.array(p3_np),
                        q=np.asarray(q, np.float64),
                    )
                    if t_abs is not None:
                        B[: msv_i + 1, 0:3] = t_abs
                        B[: msv_i + 1, 3:6] = t_abs - t_abs[0]
                        t_dev = jnp.asarray(t_abs[-1] - t_abs[0], sdt)
                    if res_new is not None:
                        S[: msv_i + 1, 3] = res_new
                        res0 = float(res_new[0])
                    p3_np = p3_new
                    p3_dev = jnp.asarray(p3_new, sdt)
                    vp_dev = vg_dev

                # ---- boundary host work: promote + snapshot + replenish
                p_np = np.asarray(pts_dev)
                vg_np = np.asarray(vg_dev)
                vp_np = np.asarray(vp_dev)
                pending &= vg_np
                if i > msv_i and pending.any():
                    # promote pending lanes whose window history triangulates
                    # self-consistently (see solvers/triangulate.py gates)
                    from velocity_tpu.solvers.triangulate import (
                        nray_intercept_masked_np)

                    lo = max(msv_i, i - 2 * window)
                    tvec_i = B[i, 0:3] - B[0, 0:3]
                    p3h = np.asarray(p3_dev, np.float64)
                    z_live = (p3h[vp_np] + tvec_i)[:, 2]
                    med = float(np.median(z_live)) if vp_np.any() else 10.0
                    p3_tri, okt = nray_intercept_masked_np(
                        intr_np, track_px[lo : i + 1],
                        B[lo : i + 1, 0:3] - B[0, 0:3],
                        valid_hist[lo : i + 1] & pending[None, :],
                        depth_range=(0.25 * med, 4.0 * med),
                    )
                    promote = pending & okt
                    if promote.any():
                        p3h[promote] = p3_tri[promote]
                        p3_np = p3h
                        p3_dev = jnp.asarray(p3h, sdt)
                        vp_np = vp_np | promote
                        vp_dev = jnp.asarray(vp_np)
                        pending &= ~promote
                        if verbose:
                            print(f"[window @{i}] promoted "
                                  f"{int(promote.sum())} replenished tracks "
                                  f"into the pose solve")
                # structure refresh: re-triangulate the solve lanes from the
                # last two windows of history. Structure anchored at the MSV
                # baseline goes stale as the car recedes (a 0.3 px track
                # error at 10x the anchor range is meters of depth error),
                # and the per-frame translation solves then amplify it into
                # tens of km/h of tail noise. Plate lanes 0..3 stay fixed:
                # they carry the metric gauge.
                if i > msv_i and i % window == 0:
                    from velocity_tpu.solvers.triangulate import (
                        nray_intercept_masked_np)

                    lo = max(msv_i, i - 2 * window)
                    p3h = np.asarray(p3_dev, np.float64)
                    tvec_i = B[i, 0:3] - B[0, 0:3]
                    zl = (p3h[vp_np] + tvec_i)[:, 2]
                    med = float(np.median(zl)) if vp_np.any() else 10.0
                    p3_tri, okt = nray_intercept_masked_np(
                        intr_np, track_px[lo : i + 1],
                        B[lo : i + 1, 0:3] - B[0, 0:3],
                        valid_hist[lo : i + 1] & vp_np[None, :],
                        min_obs=max(3, (i - lo) // 2),
                        depth_range=(0.25 * med, 4.0 * med),
                    )
                    refresh = vp_np & okt
                    refresh[:4] = False
                    if refresh.any():
                        p3h[refresh] = p3_tri[refresh]
                        p3_np = p3h
                        p3_dev = jnp.asarray(p3h, sdt)
                        if verbose:
                            print(f"[window @{i}] refreshed structure of "
                                  f"{int(refresh.sum())} lanes")
                ba_meta.append((seg_start, i, np.array(p3_dev, np.float64),
                                repl_at_start.copy()))
                repl_at_start = np.zeros(N, bool)
                # replenish only at INTERIOR grid boundaries: a run that ends
                # mid-grid (or a truncated test run) must leave the same state
                # a longer run carries through that row, or resume diverges
                if i > msv_i and i < n - 1 and i % window == 0:
                    p_r, vg_r, p3_r, n_new = self._replenish(
                        ingest.grays[i - base], q, p_np, vg_np,
                        np.asarray(p3_dev, np.float64),
                        B[i, 0:3] - B[0, 0:3], intr_np,
                    )
                    if n_new:
                        if verbose:
                            print(f"[window @{i}] replenished {n_new} tracks "
                                  f"({vg_np.sum()} -> {vg_r.sum()})")
                        repl_at_start = vg_r & ~vg_np
                        pending |= repl_at_start
                        p_np, vg_np, p3_np = p_r, vg_r, p3_r
                        pts_dev = jnp.asarray(p_np, jnp.float32)
                        vg_dev = jnp.asarray(vg_np)
                        vp_dev = jnp.asarray(vp_np)
                        p3_dev = jnp.asarray(p3_np, sdt)
                        valid_hist[i] = vg_np
                        track_px[i, vg_np] = p_np[vg_np]
                if ckpt is not None:
                    save_state(ckpt, WindowState(
                        frame_index=i, points=p_np, valid=vg_np,
                        valid_pose=vp_np, p3=np.asarray(p3_dev, np.float64),
                        B=B[: i + 1], S=S[: i + 1],
                        track_px=track_px[: i + 1],
                        valid_hist=valid_hist[: i + 1],
                        boxes=np.array([boxa, boxb], np.int64),
                        ba_bounds=np.array(
                            [(s, e) for s, e, _p, _r in ba_meta], np.int64),
                        ba_p3=np.stack([p3w for _s, _e, p3w, _r in ba_meta]),
                        ba_repl=np.stack([r for _s, _e, _p, r in ba_meta]),
                        repl_next=repl_at_start,
                        pending=pending,
                        meta={"video": str(video), "start": str(start)},
                    ))

            ingest.join()
            B[base:, 12] = ingest.times
            B[base:, 13] = ingest.indices
            first_gray = ingest.grays[0]
            last_gray = ingest.grays[n - 1 - base]

        # ---- optional per-window BA refinement + stitch ----
        ba_windows = ba_accepted = None
        if ba_refine and n > msv_i + 2 and len(ba_meta) > 0:
            ba_windows, ba_accepted = self._ba_refine(
                track_px, valid_hist, B, ba_meta, intr, mesh, verbose,
                overlap=overlap)

        # ---- stats table ----
        wall = time.time() - t_wall0
        proc = wall / n
        dist = 0.0
        S[0, 3] = res0 if state is None else S[0, 3]
        for r in range(n):
            dt = B[r, 12] - B[r - 1, 12] if r > 0 else np.nan
            dr = (float(np.linalg.norm(B[r, 0:3] - B[r - 1, 0:3]))
                  if r > 0 else 0.0)
            dist += dr
            S[r, 0] = r
            S[r, 1] = proc
            S[r, 2] = valid_hist[r].sum()
            S[r, 4] = dt
            S[r, 5] = B[r, 12] - B[0, 12]
            S[r, 6] = dr
            S[r, 7] = dist
            S[r, 8] = dr / dt * 3.6 if r > 0 and dt > 0 else np.nan
        if verbose:
            print(report.header())
            for r in range(n):
                print(report.row(S[r]))
            print(report.summary(S))
            print(f"Processed {n:g} images in {wall:.2f}s ({n / wall:.2f}fps)\n")

        from velocity_tpu.pipeline.speedest import RunResult

        res = RunResult(
            S=S, B=B, track_px=track_px, proj_px=np.full_like(track_px, np.nan),
            valid=valid_hist, plate_box=boxa, roi_box=boxb, camera=cam,
            config=cfg, first_gray=first_gray, last_gray=last_gray,
            timings={"wall_s": wall, "fps": n / wall,
                     "windows": len(ba_meta),
                     "ba_refined": bool(ba_refine and ba_windows is not None),
                     "ba_accepted": ba_accepted},
        )
        return res

    # ------------------------------------------------------ BA refinement
    def _ba_refine(self, track_px, valid_hist, B, ba_meta, intr, mesh,
                   verbose, overlap: int = 1):
        """Per-window Schur BA over the mesh, stitched back into B; returns
        (windows refined, windows whose refinement was accepted).

        Windows are the tracking segments extended backwards by up to
        ``overlap - 1`` rows, so consecutive BA windows share ``overlap``
        frames (clamped to the previous segment's span). The shared frames
        fix each window's gauge against the already-stitched trajectory:
        with >= 3 of them the full Umeyama similarity (rotation + scale +
        translation) is estimated (parallel/windows.py align_overlap), else
        the fit degenerates to the translation chain. Each window uses its
        own structure snapshot so replenished lanes never mix identities.
        """
        from velocity_tpu.config import BAConfig
        from velocity_tpu.parallel.windows import windowed_ba, align_overlap
        from velocity_tpu.solvers.ba import BAProblem  # noqa: F401 (doc link)

        n, N, _ = track_px.shape
        # window w spans rows ext_s..e; ext_s reaches back (overlap - 1) rows
        # into the previous segment so ``overlap`` frames are shared
        bounds = []
        for w, (s, e, _p3, _r) in enumerate(ba_meta):
            lo = ba_meta[w - 1][0] if w > 0 else s
            ext_s = max(s - (overlap - 1), lo) if w > 0 else s
            bounds.append((ext_s, s, e))
        nw = len(bounds)
        nc = max(e - ext_s + 1 for ext_s, _s, e in bounds)
        pix = np.zeros((nw, nc, N, 2), np.float32)
        msk = np.zeros((nw, nc, N), bool)
        pts0 = np.zeros((nw, N, 3), np.float32)
        cams0 = np.zeros((nw, nc, 6), np.float32)
        t_abs = B[:, 0:3] - B[0, 0:3]
        for w, (ext_s, s, e) in enumerate(bounds):
            p3w, repl_w = ba_meta[w][2], ba_meta[w][3]
            k = e - ext_s + 1
            m = valid_hist[ext_s : e + 1] & np.isfinite(
                track_px[ext_s : e + 1]).all(axis=2)
            # extension rows precede this segment's start boundary: lanes
            # replenished AT that boundary carried a different identity there
            ext = s - ext_s
            if ext > 0:
                m[:ext, repl_w] = False
            msk[w, :k] = m
            pix[w, :k] = np.where(m[..., None], track_px[ext_s : e + 1], 0.0)
            cams0[w, :k, 0:3] = t_abs[ext_s : e + 1] - t_abs[ext_s]
            # pad rows (short segments) repeat the final camera, masked off
            for r in range(k, nc):
                cams0[w, r] = cams0[w, k - 1]
            pts0[w] = p3w + t_abs[ext_s]
            dead = ~m.any(axis=0)
            pts0[w][dead] = np.array([0.0, 0.0, 8.0], np.float32)
        # tracks need >= 2 observations in a window to constrain anything;
        # mask the rest off entirely (damping keeps their updates at zero)
        seen = msk.sum(axis=1) < 2
        msk[np.broadcast_to(seen[:, None, :], msk.shape)] = False

        cfgba = BAConfig(max_iters=6)
        if mesh is None:
            from velocity_tpu.parallel.mesh import make_mesh

            mesh = make_mesh({"window": 1, "point": 1},
                             devices=np.array(jax.devices()[:1]).reshape(1, 1))
        ptsR, camsR, iters = windowed_ba(
            jnp.asarray(pix), jnp.asarray(msk), jnp.asarray(pts0),
            jnp.asarray(cams0), intr, mesh, config=cfgba, fix_rotations=True,
            pin_tracks=4,  # plate corners = the metric scale anchor
        )
        camsR = np.array(camsR)  # writable copies (np.asarray of a jax.Array
        ptsR = np.array(ptsR)    # is a read-only view)

        # acceptance guard: keep each window's refinement only if it reduces
        # the masked reprojection rms — refinement must be strictly
        # non-harmful to the tracked trajectory
        fx, fy = float(intr.fx), float(intr.fy)
        cx, cy = float(intr.cx), float(intr.cy)

        def _rms(w, pts_w, cams_w):
            pc = pts_w[None, :, :] + cams_w[:, None, 0:3]
            u = fx * pc[..., 0] / pc[..., 2] + cx
            v = fy * pc[..., 1] / pc[..., 2] + cy
            err = np.stack([u, v], -1) - pix[w]
            err = np.where(msk[w][..., None], err, 0.0)
            return float(np.sqrt((err ** 2).sum() / max(2 * msk[w].sum(), 1)))

        accepted = 0
        for w in range(nw):
            before = _rms(w, pts0[w], cams0[w])
            after = _rms(w, ptsR[w], camsR[w])
            # trust region: BA must not teleport any camera — a reprojection
            # improvement with a multi-step position jump means the (partly
            # wrong) structure pulled a poorly-constrained camera, not that
            # the trajectory got better
            step = np.linalg.norm(np.diff(cams0[w][:, 0:3], axis=0), axis=1)
            move = np.linalg.norm(camsR[w][:, 0:3] - cams0[w][:, 0:3], axis=1)
            limit = 2.0 * max(float(np.median(step)), 1e-3)
            if (not np.isfinite(after) or after >= before
                    or float(move.max()) > limit):
                camsR[w] = cams0[w]  # reject: keep the tracked trajectory
            else:
                accepted += 1

        # chain-stitch the (variable-length) windows. Rotations and scale are
        # pinned per window (fix_rotations + pin_tracks), but each window's BA
        # still solves in its own local gauge; the shared overlap frames map
        # it onto the already-stitched trajectory — Umeyama similarity when
        # >= 3 non-collinear shared frames exist (align_overlap), else the
        # mean translation offset.
        pos_out = np.array(t_abs)
        for w, (ext_s, s, e) in enumerate(bounds):
            k = e - ext_s + 1
            local = camsR[w][:k, 0:3]
            if w == 0:
                pos_out[s : e + 1] = pos_out[s] + local
                continue
            shared = s - ext_s + 1  # rows ext_s..s are already stitched
            R, sc, tt = align_overlap(local[:shared],
                                      pos_out[ext_s : s + 1])
            mapped = sc * (R @ local.T).T + tt
            pos_out[s + 1 : e + 1] = mapped[shared:]
        B[:, 0:3] = B[0, 0:3] + pos_out
        B[:, 3:6] = pos_out
        if verbose:
            print(f"[ba] refined {nw} windows, accepted {accepted} "
                  f"(iters {np.asarray(iters).ravel().tolist()})")
        return nw, accepted
