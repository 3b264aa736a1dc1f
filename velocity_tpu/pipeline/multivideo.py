"""Multi-video batched pipeline: videos as sharded batch lanes.

BASELINE.json config 4 — process several videos concurrently with the batch
axis laid out over the device mesh: every video's fused frame step is
shape-uniform (static feature capacity), so the whole steady-state loop is one
``vmap``-ed scan whose leading axis XLA partitions across chips. One chip
still works (lanes run batched on it); several devices shard lanes with zero code
change. Host-side init and the one-shot MSV run per-video between the two
scan segments, exactly like the single-video scan runner.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from velocity_tpu.config import PipelineConfig
from velocity_tpu.camera.annotations import load_annotation, find_annotation
from velocity_tpu.pipeline.speedest import SpeedEstimator, RunResult
from velocity_tpu.pipeline.scan import scan_segment, _decode_stack
from velocity_tpu.pipeline.roi import inside_bbox
from velocity_tpu.ingest.video import open_video
from velocity_tpu.solvers.triangulate import msv_refine_translation
from velocity_tpu.pipeline import report


def _batched_segment(cfg, sdt):
    """vmap of scan_segment over the video lane axis (p3/intr per lane)."""

    def seg(frames, pyr0, spyr0, pts0, vg0, vp0, t0, p3, intr, keys):
        return scan_segment(
            frames, pyr0, spyr0, pts0, vg0, vp0, t0, p3, intr, keys,
            cfg.tracker, cfg.solver, sdt,
        )

    return jax.vmap(seg)


def run_batch(
    videos: list[str | Path],
    annotations: list | None = None,
    n_frames: int | None = None,
    start_frames: list[int] | None = None,
    config: PipelineConfig = PipelineConfig(),
    mesh=None,
    verbose: bool = True,
) -> list[RunResult]:
    """Run the speed pipeline over multiple videos as one batched computation.

    ``mesh``: optional 1-axis mesh ('video'); lanes are laid out over it.
    """
    import time as _time

    t_wall0 = _time.time()
    cfg = config
    est = SpeedEstimator(cfg)
    want64 = cfg.solver.dtype == "float64" and jax.config.jax_enable_x64
    sdt = jnp.float64 if want64 else jnp.float32
    n = n_frames if n_frames is not None else cfg.n_frames
    V = len(videos)
    N = cfg.tracker.max_features

    # ---- per-video decode + init (host) ----
    grays_all, times_all, cams, inits = [], [], [], []
    for vi, video in enumerate(videos):
        with open_video(video, cfg.platform) as vr:
            cam = vr.info
            if annotations and annotations[vi] is not None:
                ann = load_annotation(annotations[vi])
            else:
                ann = load_annotation(find_annotation(
                    video, [Path(video).parent.parent / "matlab", Path(video).parent]))
            start = (start_frames[vi] if start_frames else ann.start_frame)
            grays, times, indices = _decode_stack(video, vr, start, n, cfg.read_speed)
        q = ann.q * cfg.native_scale
        p, valid, boxa, boxb = est._init_features(grays[0], q)
        t0, p3, res0 = est._init_geometry(cam, q, p, valid, cfg.native_scale)
        grays_all.append(grays)
        times_all.append((times, indices))
        cams.append(cam)
        inits.append(dict(q=q, p=p, valid=valid, boxa=boxa, boxb=boxb,
                          t0=t0, p3=p3, res0=res0))

    n = min(g.shape[0] for g in grays_all)
    grays = np.stack([g[:n] for g in grays_all])  # (V, n, H, W)

    # ---- batched device state ----
    pts0 = jnp.asarray(np.stack([i["p"] for i in inits]), jnp.float32)
    vg0 = jnp.asarray(np.stack([i["valid"] for i in inits]))
    vp0 = jnp.asarray(np.stack([
        i["valid"] & inside_bbox(i["p"], i["boxa"]) for i in inits
    ]))
    p3_0 = jnp.asarray(np.stack([i["p3"] for i in inits]), sdt)
    intr_stack = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[c.intrinsics(scale=cfg.native_scale).astype(sdt) for c in cams],
    )
    im0 = jnp.asarray(grays[:, 0])
    from velocity_tpu.pipeline.tracker import frame_pyramids

    pyr0, spyr0 = jax.vmap(lambda im: frame_pyramids(im, cfg.tracker))(im0)
    t0_stack = jnp.asarray(np.stack([i["t0"] for i in inits]), sdt)
    keys = jax.vmap(lambda s: jax.random.split(jax.random.PRNGKey(s), n))(
        jnp.arange(V)
    )

    if mesh is not None:
        sh = NamedSharding(mesh, P("video"))
        put = lambda x: jax.device_put(x, sh)  # noqa: E731
        grays_dev = put(jnp.asarray(grays))
        pts0, vg0, vp0, p3_0 = map(put, (pts0, vg0, vp0, p3_0))
    else:
        grays_dev = jnp.asarray(grays)

    seg = _batched_segment(cfg, sdt)
    msv_i = cfg.msv_frame
    seg_a = min(msv_i, n - 1)

    carryA, outA = seg(
        grays_dev[:, 1 : seg_a + 1], pyr0, spyr0, pts0, vg0, vp0, t0_stack,
        p3_0, intr_stack, keys[:, 1 : seg_a + 1],
    )
    ptsA, vgA, vpA, tA, resA, pprojA, n2A = jax.tree.map(np.asarray, outA)

    # ---- host MSV per video, then segment B ----
    results = []
    B_all = np.zeros((V, n, 14))
    track_all = np.full((V, n, N, 2), np.nan, np.float32)
    valid_all = np.zeros((V, n, N), bool)
    for v in range(V):
        times, indices = times_all[v]
        B_all[v, :, 12] = times[:n]
        B_all[v, :, 13] = indices[:n]
        B_all[v, 0, 0:3] = inits[v]["t0"]
        track_all[v, 0, inits[v]["valid"]] = inits[v]["p"][inits[v]["valid"]]
        valid_all[v, 0] = inits[v]["valid"]
        for j in range(seg_a):
            vgj = vgA[v, j]
            track_all[v, j + 1, vgj] = ptsA[v, j][vgj]
            valid_all[v, j + 1] = vgj
            B_all[v, j + 1, 3:6] = tA[v, j]
            B_all[v, j + 1, 0:3] = B_all[v, 0, 0:3] + tA[v, j]

    p3_B = np.asarray(p3_0).copy()
    vg_msv = vgA[:, seg_a - 1] if seg_a >= 1 else np.asarray(vg0)
    if n > msv_i:
        prev_x64 = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        try:
            with jax.default_device(jax.devices("cpu")[0]):
                for v in range(V):
                    intr64 = cams[v].intrinsics(scale=cfg.native_scale).astype(jnp.float64)
                    msv = msv_refine_translation(
                        intr64,
                        jnp.asarray(track_all[v, : msv_i + 1], jnp.float64),
                        jnp.asarray(vg_msv[v]),
                        jnp.asarray(B_all[v, : msv_i + 1, 0:3], jnp.float64),
                        config=cfg.solver,
                    )
                    cloud = np.asarray(msv.points) - tA[v, seg_a - 1].astype(np.float64)
                    p3_B[v][vg_msv[v]] = cloud[vg_msv[v]]
        finally:
            jax.config.update("jax_enable_x64", prev_x64)

        pyrM, spyrM, pts_msv, vg_msv_dev, _vp, t_msv = carryA
        carryB, outB = seg(
            grays_dev[:, msv_i + 1 :], pyrM, spyrM, pts_msv, vg_msv_dev,
            jnp.asarray(vg_msv), t_msv, jnp.asarray(p3_B, sdt), intr_stack,
            keys[:, msv_i + 1 :],
        )
        ptsB, vgB, vpB, tB, resB, _pprojB, n2B = jax.tree.map(np.asarray, outB)
        for v in range(V):
            for j in range(tB.shape[1]):
                i = msv_i + 1 + j
                vgj = vgB[v, j]
                track_all[v, i, vgj] = ptsB[v, j][vgj]
                valid_all[v, i] = vgj
                B_all[v, i, 3:6] = tB[v, j]
                B_all[v, i, 0:3] = B_all[v, 0, 0:3] + tB[v, j]
    else:
        resB = np.zeros((V, 0))
        n2B = np.zeros((V, 0))

    # ---- feature-match rescue (reference KLT.py:126-130): a lane whose
    # stage-2 survivor count collapsed anywhere gets re-run through the
    # per-frame driver, which carries the full host feature-match fallback.
    n2_all = np.concatenate([n2A.reshape(V, -1), n2B.reshape(V, -1)], axis=1)
    rescue = (n2_all <= cfg.tracker.min_affine_inliers).any(axis=1) if n2_all.size else np.zeros(V, bool)

    # ---- per-video tables ----
    # batched scan = one dispatch for all lanes; attribute wall time uniformly
    # (reference procTime contract: vidExample.py:162-165)
    proc = (_time.time() - t_wall0) / max(n * V, 1)
    for v in range(V):
        if rescue[v]:
            res_v = est.run(
                videos[v],
                annotation=(annotations[v] if annotations else None),
                n_frames=n,
                start_frame=(start_frames[v] if start_frames else None),
                verbose=False, collect_images=False,
            )
            if verbose:
                print(f"== {cams[v].filename}: rescued per-frame; "
                      f"{res_v.speed_kmh:.2f} +/- {res_v.speed_std:.2f} km/h")
            results.append(res_v)
            continue
        S = np.zeros((n, 9))
        res_all = np.concatenate([[inits[v]["res0"]], resA[v], resB[v]])
        dist = 0.0
        for i in range(n):
            dt = B_all[v, i, 12] - B_all[v, i - 1, 12] if i > 0 else np.nan
            dr = (float(np.linalg.norm(B_all[v, i, 0:3] - B_all[v, i - 1, 0:3]))
                  if i > 0 else 0.0)
            dist += dr
            S[i] = (i, proc, valid_all[v, i].sum(), res_all[i], dt,
                    B_all[v, i, 12] - B_all[v, 0, 12], dr, dist,
                    dr / dt * 3.6 if i > 0 and dt > 0 else np.nan)
        if verbose:
            print(f"== {cams[v].filename}: "
                  f"{S[1:, 8].mean():.2f} +/- {S[1:, 8].std():.2f} km/h, "
                  f"res {S[1:, 3].mean():.3f} px")
        results.append(RunResult(
            S=S, B=B_all[v], track_px=track_all[v], proj_px=np.full((n, N, 2), np.nan),
            valid=valid_all[v], plate_box=inits[v]["boxa"], roi_box=inits[v]["boxb"],
            camera=cams[v], config=cfg, first_gray=grays[v, 0], last_gray=grays[v, -1],
        ))
    return results
