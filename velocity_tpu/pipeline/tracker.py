"""Three-stage coarse-to-fine KLT tracker (the reference's KLTmain, KLT.py:99-134).

Stages, with static (capacity, mask) shapes throughout:
  1. coarse LK on 1/4-scale full frames (win 15, 4 levels) + RANSAC affine
     inlier filter -> robust inter-frame translation estimate;
  2. translation-prior coarse LK at full resolution with forward-backward
     gate 1 px (the reference's integer-crop regional retrack);
  3. RANSAC affine from stage-2 survivors (fallback hook if <= min inliers),
     then fine LK (win 51, single level) through the affine prior with
     forward-backward gate 0.3 px.

The warp-then-track of the reference (cv2.remap + LK) is fused into LK's
sampling (ops/lk.py), so each stage is one jitted call with no intermediate
warped images.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from velocity_tpu.config import TrackerConfig
from velocity_tpu.ops.lk import lk_pyramidal, lk_forward_backward
from velocity_tpu.ops.lk_fast import lk_pyramidal_fast, lk_forward_backward_fast
from velocity_tpu.ops.lk_lanes import lk_pyramidal_lanes, lk_forward_backward_lanes
from velocity_tpu.ops.pyramid import resize_nearest
from velocity_tpu.ops.ransac import estimate_affine_ransac


def _lk_impls(cfg: TrackerConfig):
    if cfg.lk_backend == "lanes":
        if cfg.shard_features > 1:
            return lk_pyramidal_lanes, _sharded_fb(cfg)
        return lk_pyramidal_lanes, lk_forward_backward_lanes
    if cfg.lk_backend == "fast":
        return lk_pyramidal_fast, lk_forward_backward_fast
    return lk_pyramidal, lk_forward_backward


def _sharded_fb(cfg: TrackerConfig):
    """Forward-backward LK with the lane axis sharded over a ``feature``
    mesh (TrackerConfig.shard_features devices) — the product hook for
    parallel/track_shard.py. The frame's prebuilt pyramids are replicated to
    every device, so results match single-device tracking bit for bit."""
    from velocity_tpu.parallel.mesh import make_mesh
    from velocity_tpu.parallel.track_shard import lk_forward_backward_sharded

    def fb(src_img, dst_img, pts_src, **kw):
        mesh = make_mesh({"feature": cfg.shard_features})
        return lk_forward_backward_sharded(
            src_img, dst_img, pts_src, mesh, "feature", **kw)

    return fb


def frame_pyramids(im, cfg: TrackerConfig, dtype=jnp.float32):
    """Per-frame pyramid set, built ONCE and threaded through the frame carry.

    Returns (full_pyr, small_pyr): float pyramids of the full-res frame and
    of its 1/4-scale INTER_NEAREST coarse image (the reference's stage-1
    image, KLT.py:111-113). Building these once per frame — instead of
    inside every LK call — removes ~8 redundant full-res pyramid builds per
    forward-backward 3-stage step.
    """
    from velocity_tpu.ops.pyramid import build_pyramid

    f = im.astype(dtype)
    full = tuple(build_pyramid(f, cfg.lk_coarse.max_level))
    small_img = resize_nearest(f, cfg.coarse_scale)
    small = tuple(build_pyramid(small_img, cfg.lk_coarse.max_level))
    return full, small


@partial(jax.jit, static_argnames=("cfg",))
def frame_pyramids_jit(im, cfg: TrackerConfig):
    """One-dispatch form of ``frame_pyramids`` for eager (non-scan) callers."""
    return frame_pyramids(im, cfg)


class TrackOutput(NamedTuple):
    points: jnp.ndarray  # (N, 2) tracked positions (valid lanes only meaningful)
    valid: jnp.ndarray  # (N,) bool: input valid & stage-3 survival
    small_cur: jnp.ndarray  # 1/4-scale current frame (for reuse next frame)
    affine: jnp.ndarray  # (2, 3) stage-3 affine prior actually used
    n_stage2: jnp.ndarray  # stage-2 survivor count (fallback trigger)


def _pyr_kw(cfg: TrackerConfig, src_pyr, dst_pyr):
    """Prebuilt-pyramid kwargs (lanes backend only; others rebuild)."""
    if cfg.lk_backend == "lanes":
        return dict(src_pyr=src_pyr, dst_pyr=dst_pyr)
    return {}


def _car_mask(pts, valid, cfg: TrackerConfig):
    """Lanes plausibly on the car: within ``car_margin`` plate diagonals of
    the tracked plate corners (lanes 0..3 by construction). Falls back to
    ``valid`` when the subset is degenerate (< 8 lanes). See
    TrackerConfig.car_affine."""
    qv = pts[0:4]
    lo = jnp.min(qv, axis=0)
    hi = jnp.max(qv, axis=0)
    m = cfg.car_margin * jnp.sqrt(jnp.sum((hi - lo) ** 2))
    inbox = (
        (pts[:, 0] >= lo[0] - m) & (pts[:, 0] <= hi[0] + m)
        & (pts[:, 1] >= lo[1] - m) & (pts[:, 1] <= hi[1] + m)
    )
    mc = valid & inbox
    return jnp.where(jnp.sum(mc) >= 8, mc, valid)


def _track_stages_p(
    pyr_prev, pyr_cur, spyr_prev, spyr_cur, pts, valid, key, cfg: TrackerConfig
):
    """Stages 1-2 + affine estimation, on prebuilt per-frame pyramids."""
    dtype = pts.dtype
    scale = cfg.coarse_scale
    lk_pyr, lk_fb = _lk_impls(cfg)

    # ---- stage 1: coarse global LK on small images + RANSAC inliers ----
    lk1 = cfg.lk_coarse
    r1 = lk_pyr(
        spyr_prev[0].astype(dtype),
        spyr_cur[0].astype(dtype),
        pts * scale,
        win=lk1.window,
        max_level=lk1.max_level,
        iters=lk1.max_iters,
        eps=lk1.eps,
        **_pyr_kw(cfg, spyr_prev, spyr_cur),
    )
    p1 = r1.points / scale
    v1 = valid & r1.status
    key, k1 = jax.random.split(key)
    m1r = _car_mask(pts, v1, cfg) if cfg.car_affine else v1
    ransac1 = estimate_affine_ransac(
        pts, p1, mask=m1r, key=k1, trials=cfg.ransac_trials, threshold=cfg.ransac_threshold
    )
    v1 = v1 & ransac1.inliers

    # ---- stage 2: translation-prior coarse LK at full resolution ----
    # The reference integer-shifts a crop of the current frame and re-tracks
    # (KLT.py:66-68); an integer-translation destination warp is exactly plain
    # LK seeded at ``pts + shift`` (solved in current-frame coordinates), which
    # skips the warped-path machinery entirely.
    m1 = v1.astype(dtype)[:, None]
    n1 = jnp.maximum(jnp.sum(v1), 1)
    mean_shift = jnp.sum((p1 - pts) * m1, axis=0) / n1
    shift_int = jnp.trunc(mean_shift)  # reference: int() truncation (KLT.py:66-67)
    lvl2 = (cfg.stage2_max_level if cfg.stage2_max_level is not None
            else lk1.max_level)
    r2 = lk_fb(
        pyr_prev[0].astype(dtype),
        pyr_cur[0].astype(dtype),
        pts,
        guess=pts + shift_int,
        fb_threshold=cfg.fb_threshold_coarse,
        win=lk1.window,
        max_level=lvl2,
        iters=lk1.max_iters,
        eps=lk1.eps,
        **_pyr_kw(cfg, pyr_prev[: lvl2 + 1], pyr_cur[: lvl2 + 1]),
    )
    p2 = r2.points  # already current-frame coordinates
    v2 = valid & r2.status
    n2 = jnp.sum(v2)

    # ---- affine for stage 3 from stage-2 survivors ----
    key, k2 = jax.random.split(key)
    m2r = _car_mask(pts, v2, cfg) if cfg.car_affine else v2
    ransac2 = estimate_affine_ransac(
        pts, p2, mask=m2r, key=k2, trials=cfg.ransac_trials, threshold=cfg.ransac_threshold
    )
    # degenerate guard: if stage 2 collapsed, fall back to stage-1 model
    use2 = n2 > cfg.min_affine_inliers
    T23 = jnp.where(use2, ransac2.M, ransac1.M)

    return T23, n2, key


def _track_fine_p(pyr_prev, pyr_cur, pts, valid, T23, cfg: TrackerConfig):
    """Stage 3 (fine, affine-warped, fb-gated) on prebuilt pyramids."""
    dtype = pts.dtype
    lk3 = cfg.lk_fine
    _, lk_fb = _lk_impls(cfg)
    r3 = lk_fb(
        pyr_prev[0].astype(dtype),
        pyr_cur[0].astype(dtype),
        pts,
        fb_threshold=cfg.fb_threshold_fine,
        warp_dst=T23,
        win=lk3.window,
        max_level=lk3.max_level,
        iters=lk3.max_iters,
        eps=lk3.eps,
        **_pyr_kw(cfg, pyr_prev[: lk3.max_level + 1], pyr_cur[: lk3.max_level + 1]),
    )
    # map solved (previous-frame) coords through the affine into current frame
    p3 = r3.points @ T23[:, :2].T + T23[:, 2]
    v3 = valid & r3.status
    return p3, v3


@partial(jax.jit, static_argnames=("cfg",))
def _track_stages(
    im_prev,
    im_cur,
    small_prev,
    pts,
    valid,
    key,
    cfg: TrackerConfig,
):
    """Image-input compatibility wrapper (rebuilds pyramids every call; the
    hot paths use the *_p pyramid-carry forms via fused_frame_step_pyr)."""
    from velocity_tpu.ops.pyramid import build_pyramid

    dtype = pts.dtype
    L = cfg.lk_coarse.max_level
    pyr_prev = tuple(build_pyramid(im_prev.astype(dtype), L))
    pyr_cur, spyr_cur = frame_pyramids(im_cur, cfg, dtype)
    spyr_prev = tuple(build_pyramid(small_prev.astype(dtype), L))
    T23, n2, key = _track_stages_p(
        pyr_prev, pyr_cur, spyr_prev, spyr_cur, pts, valid, key, cfg
    )
    return spyr_cur[0], T23, n2, key


@partial(jax.jit, static_argnames=("cfg",))
def _track_fine(im_prev, im_cur, pts, valid, T23, cfg: TrackerConfig):
    from velocity_tpu.ops.pyramid import build_pyramid

    dtype = pts.dtype
    L = cfg.lk_fine.max_level
    pyr_prev = tuple(build_pyramid(im_prev.astype(dtype), L))
    pyr_cur = tuple(build_pyramid(im_cur.astype(dtype), L))
    return _track_fine_p(pyr_prev, pyr_cur, pts, valid, T23, cfg)


def _step_core(
    pyr_prev, spyr_prev, pyr_cur, spyr_cur, pts, vg, vp, p3, intr, key,
    t0, cfg, solver_cfg, solver_dtype,
):
    """Track + mask composition + pose solve on prebuilt pyramids."""
    from velocity_tpu.solvers.pose import estimate_world_camera_pose
    from velocity_tpu.config import SolverConfig

    if solver_cfg is None:
        solver_cfg = SolverConfig()

    T23, n2, _ = _track_stages_p(
        pyr_prev, pyr_cur, spyr_prev, spyr_cur, pts, vg, key, cfg
    )
    p_new, vg_new = _track_fine_p(pyr_prev, pyr_cur, pts, vg, T23, cfg)
    vp_new = vp & vg_new

    if t0 is None:
        t0 = jnp.asarray([0.0, 0.0, 1.0], solver_dtype)
    pose = estimate_world_camera_pose(
        intr,
        p_new.astype(solver_dtype),
        p3,
        t0=t0.astype(solver_dtype),
        R0=jnp.eye(3, dtype=solver_dtype),
        find_R=False,
        mask=vp_new,
        config=solver_cfg,
    )
    # packed scalar summary: one small device->host transfer serves the whole
    # per-frame report when the caller runs transfer-lean
    packed = jnp.concatenate(
        [
            pose.t.astype(jnp.float32),
            jnp.asarray([pose.residual_rms], jnp.float32),
            jnp.asarray([jnp.sum(vg_new)], jnp.float32),
            jnp.asarray([n2], jnp.float32),
        ]
    )
    return (
        p_new, vg_new, vp_new,
        pose.t, pose.residual_rms, pose.p_proj, n2, T23, packed,
    )


@partial(jax.jit, static_argnames=("cfg", "solver_cfg", "solver_dtype"))
def fused_frame_step_pyr(
    pyr_prev,  # tuple: previous frame's full-res pyramid (the scan carry)
    spyr_prev,  # tuple: previous frame's 1/4-scale pyramid
    im_cur,  # (H, W) current frame (uint8 ok)
    pts,
    vg,
    vp,
    p3,
    intr,
    key,
    cfg: TrackerConfig,
    solver_cfg=None,
    solver_dtype=jnp.float32,
    t0=None,
):
    """One fused device step with pyramid carry — the steady-state hot path.

    Builds the current frame's pyramids ONCE and returns them for the next
    step's carry, so each frame pays exactly one full-res pyramid build
    (vs ~8 with image-input LK calls). ``t0`` optionally warm-starts the
    pose solve from the previous frame's translation (reference behavior:
    /root/reference/vidExample.py:139 passes the running translation).
    """
    pyr_cur, spyr_cur = frame_pyramids(im_cur, cfg)
    outs = _step_core(
        pyr_prev, spyr_prev, pyr_cur, spyr_cur, pts, vg, vp, p3, intr, key,
        t0, cfg, solver_cfg, solver_dtype,
    )
    return (pyr_cur, spyr_cur) + outs


@partial(jax.jit, static_argnames=("cfg", "solver_cfg", "solver_dtype"))
def fused_frame_step(
    im_prev,
    im_cur,
    small_prev,
    pts,
    vg,
    vp,
    p3,
    intr,
    key,
    cfg: TrackerConfig,
    solver_cfg=None,
    solver_dtype=jnp.float32,
):
    """Image-input fused step (compatibility form; rebuilds prev pyramids).

    Returns (pts', vg', vp', small_cur, t, residual_rms, p_proj, n_stage2,
    T23, packed) like before; steady-state drivers should prefer
    ``fused_frame_step_pyr``.
    """
    from velocity_tpu.ops.pyramid import build_pyramid

    L = cfg.lk_coarse.max_level
    pyr_prev = tuple(build_pyramid(im_prev.astype(jnp.float32), L))
    spyr_prev = tuple(build_pyramid(small_prev.astype(jnp.float32), L))
    pyr_cur, spyr_cur = frame_pyramids(im_cur, cfg)
    outs = _step_core(
        pyr_prev, spyr_prev, pyr_cur, spyr_cur, pts, vg, vp, p3, intr, key,
        None, cfg, solver_cfg, solver_dtype,
    )
    (p_new, vg_new, vp_new, t, res, pproj, n2, T23, packed) = outs
    return (
        p_new, vg_new, vp_new, spyr_cur[0],
        t, res, pproj, n2, T23, packed,
    )


class ThreeStageTracker:
    """Stateless tracker object binding a TrackerConfig (+ optional fallback).

    ``fallback_matcher(im_prev, im_cur, pts, valid) -> (2,3) affine`` replaces
    the reference's SURF full-frame rescue (KLT.py:10-33,126-130) when stage 2
    yields too few survivors; by default the stage-1 RANSAC model is used.
    """

    def __init__(self, cfg: TrackerConfig, fallback_matcher: Callable | None = None):
        self.cfg = cfg
        self.fallback_matcher = fallback_matcher

    def track(self, im_prev, im_cur, small_prev, pts, valid, key) -> TrackOutput:
        cfg = self.cfg
        small_cur, T23, n2, _ = _track_stages(
            im_prev, im_cur, small_prev, pts, valid, key, cfg
        )
        if self.fallback_matcher is not None and int(n2) <= cfg.min_affine_inliers:
            T23 = jnp.asarray(
                self.fallback_matcher(im_prev, im_cur, pts, valid), pts.dtype
            )
        p3, v3 = _track_fine(im_prev, im_cur, pts, valid, T23, cfg)
        return TrackOutput(points=p3, valid=v3, small_cur=small_cur, affine=T23, n_stage2=n2)

    def initial_small(self, im_prev):
        return resize_nearest(im_prev, self.cfg.coarse_scale)
