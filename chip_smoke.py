"""Smoke test of the speed pipeline on an NVIDIA GPU.

    python chip_smoke.py                 # one card: phases 1-5
    python chip_smoke.py --four-cards    # four cards: the sharded paths only

Input is the seeded synthetic 1080p clip (velocity_tpu/ingest/synthetic.py),
so nothing is read from outside the checkout. One card:

1. device: JAX must report a ``gpu`` device (there is no CPU fallback); the
   card's name and power limit come from ``nvidia-smi``;
2. the lanes-last LK engine (ops/lk_lanes.py) against the gather oracle
   (ops/lk.py) on 1080p frames with 1024 points, at the stage-1/2 shape
   (window 15 on the pyramid) and the stage-3 shape (window 51 through an
   affine prior);
3. the scan driver (``ScanSpeedRunner.run``) in the product configuration
   over 20 frames, cold and warm;
4. the per-frame driver (``SpeedEstimator.run``, the ``speed`` CLI path);
5. the long-video driver with Schur BA windows (``LongVideoRunner.run``).

Phases 3-5 must land in the ground-truth speed band with a residual under
1.5 px, no NaN, and no feature-match rescue (it needs OpenCV on the host);
phase 5 must accept at least one window's BA. With ``--four-cards`` only the
feature-sharded tracking and the window x point sharded BA run, each beside
its one-card twin. Every phase prints one line with its wall and compile
seconds; the last line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

N_POINTS = 1024
SCAN_FRAMES = 20
LONG_FRAMES = 48
LONG_WINDOW = 24
GT_KMH = 40.0
# Speed band around the clip's ground truth. The CPU backend gives 40.0 km/h
# on this clip (scan and per-frame drivers, 1080p, 20 frames); 3% leaves room
# for the GPU's other summation order and stays inside the 5% limit.
SPEED_BAND = 0.03
MAX_RESIDUAL_PX = 1.5
# lanes-vs-oracle LK tolerance (tests/test_lk_lanes.py)
LK_MEDIAN_PX = 0.05
LK_STATUS_AGREE = 0.9


class PhaseFailed(Exception):
    pass


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling (or fetching from
    the persistent cache) since the last ``take``."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_kw) -> None:
        if event.startswith("/jax/core/compile/"):
            self.total += duration

    def take(self) -> float:
        t, self.total = self.total, 0.0
        return t


def run_phase(name: str, fn, clock: CompileClock) -> dict:
    clock.take()
    t0 = time.perf_counter()
    info = fn()
    wall = time.perf_counter() - t0
    print(f"phase {name}: ok wall_s={wall:.3f} compile_s={clock.take():.3f} "
          + " ".join(f"{k}={v}" for k, v in info.items()), flush=True)
    return info


# ------------------------------------------------------------------ phase 2
def car_corners(clip, i: int = 0) -> np.ndarray:
    """(4, 2) pixels of the car rectangle's corners in frame ``i``."""
    from velocity_tpu.ingest.synthetic import CAR_U, CAR_V

    return clip.project(clip.car_points(np.array([[u, v] for u in CAR_U for v in CAR_V]), i))


def lk_pair(clip, n_points: int = N_POINTS, margin: int = 40):
    """Frames 0 and 1 of ``clip`` as float32 device arrays and ``n_points``
    Harris corners of frame 0 on the car, ``margin`` px inside its outline
    (the background is low-pass texture plus sensor noise, where LK is
    ill-posed and any two implementations drift apart)."""
    import jax.numpy as jnp

    from velocity_tpu.ops.harris import good_features

    f0, f1 = (jnp.asarray(f.gray, jnp.float32) for f in clip.frames(0, 2))
    (x0, y0), (x1, y1) = car_corners(clip).min(axis=0), car_corners(clip).max(axis=0)
    ys, xs = np.mgrid[: f0.shape[0], : f0.shape[1]]
    mask = ((xs > x0 + margin) & (xs < x1 - margin)
            & (ys > y0 + margin) & (ys < y1 - margin))
    corners = good_features(f0, max_corners=n_points, quality_level=1e-3,
                            mask=jnp.asarray(mask))
    if not bool(np.asarray(corners.valid).all()):
        raise PhaseFailed(f"fewer than {n_points} corners on the car")
    return f0, f1, corners.points


def car_affine(clip):
    """(2, 3) affine from frame 0 to frame 1 fitted to the car rectangle's
    corners and the plate centre: the stage-3 prior."""
    a = np.concatenate([car_corners(clip, 0), clip.project(clip.translations[0:1])])
    b = np.concatenate([car_corners(clip, 1), clip.project(clip.translations[1:2])])
    A = np.concatenate([a, np.ones((len(a), 1))], axis=1)
    M, *_ = np.linalg.lstsq(A, b, rcond=None)
    return M.T.astype(np.float32)


def compare_lanes_to_oracle(f0, f1, pts, lk, warp=None) -> dict:
    """Run the lanes engine and the gather oracle on one frame pair with the
    ``LKConfig`` ``lk`` (and destination affine ``warp``); returns their
    agreement."""
    import jax.numpy as jnp

    from velocity_tpu.ops.lk import lk_pyramidal
    from velocity_tpu.ops.lk_lanes import lk_pyramidal_lanes

    kw = dict(win=lk.window, max_level=lk.max_level, iters=lk.max_iters, eps=lk.eps,
              warp_dst=None if warp is None else jnp.asarray(warp))
    ref = lk_pyramidal(f0, f1, pts, **kw)
    lanes = lk_pyramidal_lanes(f0, f1, pts, **kw)
    rs, ls = np.asarray(ref.status), np.asarray(lanes.status)
    both = rs & ls
    d = np.linalg.norm(np.asarray(ref.points)[both] - np.asarray(lanes.points)[both],
                       axis=1)
    return {"median_px": float(np.median(d)) if d.size else float("nan"),
            "status_agree": float((rs == ls).mean()),
            "tracked": int(both.sum())}


def check_lk(metrics: dict, what: str) -> None:
    if not (metrics["median_px"] < LK_MEDIAN_PX
            and metrics["status_agree"] > LK_STATUS_AGREE
            and metrics["tracked"] > 0):
        raise PhaseFailed(f"{what}: lanes LK disagrees with the oracle {metrics}")


def phase_lk(clip, n_points: int = N_POINTS) -> dict:
    from velocity_tpu.config import TrackerConfig

    cfg = TrackerConfig()
    f0, f1, pts = lk_pair(clip, n_points)
    coarse = compare_lanes_to_oracle(f0, f1, pts, cfg.lk_coarse)
    check_lk(coarse, "window 15 pyramid")
    fine = compare_lanes_to_oracle(f0, f1, pts, cfg.lk_fine, car_affine(clip))
    check_lk(fine, "window 51 affine")
    return {"w15_median_px": f"{coarse['median_px']:.5f}",
            "w15_status_agree": f"{coarse['status_agree']:.4f}",
            "w51_median_px": f"{fine['median_px']:.5f}",
            "w51_status_agree": f"{fine['status_agree']:.4f}",
            "points": n_points}


# -------------------------------------------------------------- phases 3-5
def product_config(clip, **tracker):
    from velocity_tpu.config import PipelineConfig, SolverConfig, TrackerConfig

    return PipelineConfig(solver=SolverConfig(dtype="float32"),
                          native_scale=clip.native_scale,
                          tracker=TrackerConfig(**tracker))


def check_run(res, what: str) -> dict:
    """Speed band, residual, NaN and rescue checks shared by phases 3-5."""
    lo, hi = GT_KMH * (1 - SPEED_BAND), GT_KMH * (1 + SPEED_BAND)
    speed, resid = res.speed_kmh, res.residual_px
    if not np.isfinite(res.S[1:, [3, 8]]).all() or not np.isfinite(res.B[:, 0:6]).all():
        raise PhaseFailed(f"{what}: NaN in the speed table")
    if res.rescues:
        raise PhaseFailed(f"{what}: feature-match rescue ran on {res.rescues} frames")
    if not lo <= speed <= hi:
        raise PhaseFailed(f"{what}: {speed:.3f} km/h outside [{lo:.2f}, {hi:.2f}]")
    if not resid < MAX_RESIDUAL_PX:
        raise PhaseFailed(f"{what}: residual {resid:.3f} px")
    return {"speed_kmh": f"{speed:.4f}", "speed_std": f"{res.speed_std:.4f}",
            "residual_px": f"{resid:.4f}", "rescues": res.rescues}


def phase_scan(clip, n_frames: int = SCAN_FRAMES, **tracker) -> dict:
    from velocity_tpu.pipeline.scan import ScanSpeedRunner

    runner = ScanSpeedRunner(product_config(clip, **tracker))
    walls = []
    for _ in range(2):  # cold, then warm
        t0 = time.perf_counter()
        res = runner.run(clip, annotation=clip.annotation, n_frames=n_frames,
                         verbose=False)
        walls.append(time.perf_counter() - t0)
    info = check_run(res, "scan driver")
    return {**info, "cold_s": f"{walls[0]:.3f}", "warm_s": f"{walls[1]:.3f}",
            "warm_fps": f"{n_frames / walls[1]:.3f}", "frames": n_frames}


def phase_frames(clip, n_frames: int = SCAN_FRAMES, **tracker) -> dict:
    from velocity_tpu.pipeline.speedest import SpeedEstimator

    res = SpeedEstimator(product_config(clip, **tracker)).run(
        clip, annotation=clip.annotation, n_frames=n_frames, verbose=False)
    return {**check_run(res, "per-frame driver"),
            "fps": f"{res.timings['fps']:.3f}", "frames": n_frames}


def phase_long(clip, n_frames: int = LONG_FRAMES, window: int = LONG_WINDOW,
               **tracker) -> dict:
    from velocity_tpu.pipeline.longvideo import LongVideoRunner

    res = LongVideoRunner(product_config(clip, **tracker)).run(
        clip, annotation=clip.annotation, n_frames=n_frames, window=window,
        ba_refine=True, verbose=False)
    info = check_run(res, "long-video driver")
    accepted = res.timings["ba_accepted"]
    if not accepted:
        raise PhaseFailed(f"long-video driver: no BA window accepted ({accepted})")
    return {**info, "ba_windows": res.timings["windows"], "ba_accepted": accepted,
            "fps": f"{res.timings['fps']:.3f}", "frames": n_frames}


# ------------------------------------------------------------- four cards
def phase_sharded_tracking(clip, devices, n_points: int = N_POINTS) -> dict:
    """The tracker's forward-backward LK with the track axis sharded over
    ``devices`` (``TrackerConfig.shard_features``, parallel/track_shard.py)
    against the one-card call, at the stage-2 and stage-3 shapes on frames 0
    and 1 of the clip."""
    import jax

    from velocity_tpu.config import TrackerConfig
    from velocity_tpu.pipeline.tracker import _lk_impls, frame_pyramids_jit

    f0, f1, pts = lk_pair(clip, n_points)
    cfg = TrackerConfig()
    pyr0, _ = frame_pyramids_jit(f0, cfg)
    pyr1, _ = frame_pyramids_jit(f1, cfg)
    stages = {
        "stage2": (cfg.lk_coarse, dict(guess=pts, fb_threshold=cfg.fb_threshold_coarse)),
        "stage3": (cfg.lk_fine, dict(warp_dst=car_affine(clip),
                                     fb_threshold=cfg.fb_threshold_fine)),
    }
    info = {"shards": len(devices)}
    for name, (lk, extra) in stages.items():
        levels = lk.max_level + 1
        outs = []
        for shards in (0, len(devices)):
            _, fb = _lk_impls(TrackerConfig(shard_features=shards))
            run = jax.jit(lambda a, b, p, pa, pb, fb=fb: fb(
                a, b, p, win=lk.window, max_level=lk.max_level, iters=lk.max_iters,
                eps=lk.eps, src_pyr=pa, dst_pyr=pb, **extra))
            r = run(f0, f1, pts, pyr0[:levels], pyr1[:levels])
            outs.append((np.asarray(r.points), np.asarray(r.status)))
        (p1, v1), (pn, vn) = outs
        if not np.array_equal(v1, vn):
            raise PhaseFailed(f"sharded tracking {name}: {int((v1 != vn).sum())} "
                              "statuses differ")
        err = float(np.abs(p1[v1] - pn[v1]).max()) if v1.any() else 0.0
        if not err <= 1e-4:
            raise PhaseFailed(f"sharded tracking {name}: points differ by {err} px")
        info[f"{name}_tracked"] = int(v1.sum())
        info[f"{name}_max_diff_px"] = f"{err:.2e}"
    return info


def ba_windows(clip, nw: int = 2, nc: int = LONG_WINDOW, nt: int = N_POINTS,
               seed: int = 0):
    """``nw`` windows of ``nc`` frames of ``nt`` car-plane points projected
    along the clip's trajectory, with 0.3 px noise and perturbed starts."""
    from velocity_tpu.ingest.synthetic import CAR_U, CAR_V

    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(*CAR_U, nt), rng.uniform(*CAR_V, nt)], 1)
    pw = clip.car_points(uv, 0) - clip.translations[0]
    pix = np.zeros((nw, nc, nt, 2), np.float32)
    pts0 = np.zeros((nw, nt, 3), np.float32)
    cams0 = np.zeros((nw, nc, 6), np.float32)
    for w in range(nw):
        T = clip.translations[w * nc : (w + 1) * nc]
        pts = pw + T[0]
        pix[w] = clip.project(pts[None] + (T - T[0])[:, None]) + rng.normal(0, 0.3, (nc, nt, 2))
        pts0[w] = pts + rng.normal(0, 0.02, pts.shape)
        cams0[w, :, 0:3] = T - T[0] + rng.normal(0, 0.01, (nc, 3))
        cams0[w, 0] = 0.0
    return pix, np.ones((nw, nc, nt), bool), pts0, cams0


def phase_sharded_ba(clip, devices, nc: int = LONG_WINDOW, nt: int = N_POINTS) -> dict:
    """``windowed_ba`` over a {window: 2, point: 2} mesh against ``ba_schur``
    per window on one card."""
    import jax
    import jax.numpy as jnp

    from velocity_tpu.config import BAConfig
    from velocity_tpu.parallel.mesh import make_mesh
    from velocity_tpu.parallel.windows import windowed_ba
    from velocity_tpu.solvers.ba import BAProblem
    from velocity_tpu.solvers.schur import ba_schur

    cfg = BAConfig(max_iters=6)
    pix, msk, pts0, cams0 = ba_windows(clip, nc=nc, nt=nt)
    intr = clip.info.intrinsics(scale=clip.native_scale)
    mesh = make_mesh({"window": 2, "point": 2}, devices=devices[:4])
    pts_m, cams_m, _it = windowed_ba(jnp.asarray(pix), jnp.asarray(msk),
                                     jnp.asarray(pts0), jnp.asarray(cams0),
                                     intr, mesh, config=cfg, fix_rotations=True)
    pts_m, cams_m = np.asarray(pts_m), np.asarray(cams_m)
    worst = 0.0
    with jax.default_device(devices[0]):
        for w in range(pix.shape[0]):
            prob = BAProblem(intr=intr, pixels=jnp.asarray(pix[w]),
                             mask=jnp.asarray(msk[w]), points0=jnp.asarray(pts0[w]),
                             cams0=jnp.asarray(cams0[w]))
            r = ba_schur(prob, cfg, fix_rotations=True)
            for got, want in ((pts_m[w], np.asarray(r.points)),
                              (cams_m[w][:, 0:3], np.asarray(r.cams)[:, 0:3])):
                rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
                worst = max(worst, float(rel))
    if not worst <= 1e-4:
        raise PhaseFailed(f"sharded BA: relative difference {worst:.2e}")
    return {"mesh": "window2xpoint2", "max_rel_diff": f"{worst:.2e}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded tracking and sharded BA paths")
    args = ap.parse_args(argv)

    from velocity_tpu.ingest.synthetic import SyntheticClip
    from velocity_tpu.utils.device import card_line, device_record, require_gpu

    try:
        devices = require_gpu(4 if args.four_cards else 1)
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2

    clock = CompileClock()
    card = run_phase("1 device", lambda: {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices), "card": card_line()}, clock)["card"]
    try:
        if args.four_cards:
            clip = SyntheticClip(2 * LONG_WINDOW)
            run_phase("4a sharded-tracking", lambda: phase_sharded_tracking(clip, devices), clock)
            run_phase("4b sharded-ba", lambda: phase_sharded_ba(clip, devices), clock)
        else:
            clip = SyntheticClip(LONG_FRAMES)
            run_phase("2 lk-lanes-vs-oracle", lambda: phase_lk(clip), clock)
            scan = run_phase("3 scan-driver", lambda: phase_scan(clip), clock)
            print(f"scan driver: {scan['warm_fps']} fps warm, {scan['warm_s']} s for "
                  f"{SCAN_FRAMES} frames of 1920x1080 on {card}", flush=True)
            run_phase("4 per-frame-driver", lambda: phase_frames(clip), clock)
            run_phase("5 long-video-ba", lambda: phase_long(clip), clock)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": device_record(devices)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
