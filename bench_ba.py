"""Bundle-adjustment and pyramid timings on one GPU (SURVEY.md §6).

    python bench_ba.py

Measures, on the card:
  1. BA ms/iter on a real tracked window of the synthetic 1080p clip (dense
     vs Schur),
  2. Schur BA batched over 8 windows on one card (the ``windowed_ba`` shape
     the long-video driver runs),
  3. the 5-level 1080p Gaussian pyramid (matmul form, ops/resample.py),
and prints one JSON object with a row per metric, the device as JAX reports
it, and the card's name and power limit.

Timing method: each solver runs K_hi and K_lo forced iterations inside one
jit (tol=0 disables early exit); ms/iter = (t_hi - t_lo)/(K_hi - K_lo),
which cancels dispatch and fetch overhead.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

N_FRAMES = 20
CAPACITY = 1024


def _fetch_time(fn, *args):
    """Wall time of fn(*args) forcing a real D2H fetch of the first leaf."""
    import jax

    r = fn(*args)
    np.asarray(jax.tree.leaves(r)[0])
    ts = []
    for _ in range(3):
        t0 = time.time()
        r = fn(*args)
        np.asarray(jax.tree.leaves(r)[0])
        ts.append(time.time() - t0)
    return min(ts)


def real_problem():
    """BAProblem from a 20-frame window tracked on the synthetic 1080p clip."""
    import jax.numpy as jnp
    from velocity_tpu.config import PipelineConfig, SolverConfig
    from velocity_tpu.ingest.synthetic import SyntheticClip
    from velocity_tpu.pipeline.scan import ScanSpeedRunner
    from velocity_tpu.solvers.ba import BAProblem
    from velocity_tpu.solvers.triangulate import nray_intercept
    from velocity_tpu.geometry.projection import pixel_to_unit_ray

    clip = SyntheticClip(N_FRAMES)
    cfg = PipelineConfig(solver=SolverConfig(dtype="float32"),
                         native_scale=clip.native_scale)
    res = ScanSpeedRunner(cfg).run(
        clip, annotation=clip.annotation, n_frames=N_FRAMES, verbose=False,
        lean=False,
    )
    valid_all = res.valid.all(axis=0)  # tracks visible in every frame
    n_real = int(valid_all.sum())
    intr = res.camera.intrinsics(scale=cfg.native_scale).astype(jnp.float32)

    pix = np.zeros((N_FRAMES, CAPACITY, 2), np.float32)
    mask = np.zeros((N_FRAMES, CAPACITY), bool)
    pix[:, :, :] = 0.0
    sel = np.where(valid_all)[0]
    pix[:, : len(sel)] = res.track_px[:, sel]
    mask[:, : len(sel)] = True

    cams = np.zeros((N_FRAMES, 6), np.float32)
    cams[:, 0:3] = res.B[:, 0:3] - res.B[0, 0:3]  # camera-0-pinned translations

    # initial cloud: N-ray triangulation of each track from the real cameras
    rays = np.asarray(
        pixel_to_unit_ray(intr, jnp.asarray(pix.reshape(-1, 2)))
    ).reshape(N_FRAMES, CAPACITY, 3)
    pts0 = np.asarray(
        nray_intercept(jnp.asarray(-cams[:, 0:3]), jnp.asarray(rays))
    )
    lane_real = (np.arange(CAPACITY) < len(sel))[:, None]
    pts0 = np.where(
        np.isfinite(pts0) & (np.abs(pts0) < 1e4).all(axis=1, keepdims=True)
        & lane_real, pts0, np.array([0.0, 0.0, 8.0]),
    ).astype(np.float32)

    prob = BAProblem(
        intr=intr,
        pixels=jnp.asarray(pix),
        mask=jnp.asarray(mask),
        points0=jnp.asarray(pts0, jnp.float32),
        cams0=jnp.asarray(cams),
    )
    return prob, n_real


def bench_ba_rows(prob, n_real):
    import jax
    from functools import partial
    from velocity_tpu.config import BAConfig
    from velocity_tpu.solvers.ba import ba_dense
    from velocity_tpu.solvers.schur import ba_schur

    rows = []
    nc, nt = prob.pixels.shape[0], prob.points0.shape[0]

    for name, solver in (("dense", ba_dense), ("schur", ba_schur)):
        if name == "dense" and nt > 512:
            # dense forms the full (nt*3+6(nc-1))^2 system: ~9.4e9 f32 at
            # capacity 1024 — measure it at the real track count instead
            sel = slice(0, 256)
            p = prob._replace(
                pixels=prob.pixels[:, sel], mask=prob.mask[:, sel],
                points0=prob.points0[sel],
            )
            label_nt = 256
        else:
            p = prob
            label_nt = nt
        f_lo = jax.jit(partial(solver, config=BAConfig(max_iters=2, tol=0.0)))
        f_hi = jax.jit(partial(solver, config=BAConfig(max_iters=12, tol=0.0)))
        t_lo = _fetch_time(f_lo, p)
        t_hi = _fetch_time(f_hi, p)
        ms = (t_hi - t_lo) / 10.0 * 1000.0
        rows.append({
            "metric": f"BA ms/iter ({name}, tracked synthetic window, "
                      f"nc={nc}, nt={label_nt}, {n_real} real tracks)",
            "value": ms, "unit": "ms/iter",
        })
    return rows


def bench_batched_schur_rows(prob, n_real):
    """Schur BA batched over nw windows on ONE chip (the windowed_ba shape
    the long-video driver runs): per-iteration wall amortizes across windows,
    which is where the per-chip utilization becomes real."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    from velocity_tpu.config import BAConfig
    from velocity_tpu.parallel.mesh import make_mesh
    from velocity_tpu.parallel.windows import windowed_ba

    nw = 8
    nc, nt = prob.pixels.shape[0], prob.points0.shape[0]
    pix = jnp.broadcast_to(prob.pixels[None], (nw,) + prob.pixels.shape)
    msk = jnp.broadcast_to(prob.mask[None], (nw,) + prob.mask.shape)
    pts0 = jnp.broadcast_to(prob.points0[None], (nw,) + prob.points0.shape)
    cams0 = jnp.broadcast_to(prob.cams0[None], (nw,) + prob.cams0.shape)
    mesh = make_mesh({"window": 1, "point": 1},
                     devices=np.array(jax.devices()[:1]).reshape(1, 1))

    # Amortize dispatch and fetch: 20 full solves inside ONE jit via
    # fori_loop, each data-dependent on the last (defeats loop-invariant
    # hoisting), one fetch at the end.
    REPS = 20
    cfgw = BAConfig(max_iters=6, tol=0.0)

    def batch_loop(p0):
        def body(_i, acc):
            p = p0 + acc * 1e-12
            _pts, camsR, _it = windowed_ba(
                pix, msk, p, cams0, prob.intr, mesh, config=cfgw,
                fix_rotations=True, pin_tracks=4)
            return acc + camsR[0, 1, 0]
        return jax.lax.fori_loop(0, REPS, body, jnp.float32(0.0))

    import jax as _jax

    f = _jax.jit(batch_loop)
    t_total = _fetch_time(f, pts0)
    t_null = _fetch_time(_jax.jit(lambda p: p[0, 0, 0]), pts0)
    one = windowed_ba(pix, msk, pts0, cams0, prob.intr, mesh, config=cfgw,
                      fix_rotations=True, pin_tracks=4)
    iters_hi = int(np.asarray(one[2]).ravel()[0])
    ms = max(t_total - t_null, 1e-9) / REPS / max(iters_hi, 1) * 1000.0
    return [{
        "metric": f"batched Schur BA ms/iter ({nw} windows x nc={nc}, "
                  f"nt={nt}, one card - the windowed_ba shape)",
        "value": ms, "unit": "ms/iter (all windows)",
        "ms_per_window_iter": ms / nw,
        "iterations_per_solve": iters_hi,
        "amortized_solves": REPS,
    }]


def bench_kernel_rows():
    """Timing rows for the tracker's image pyramid."""
    import jax
    import jax.numpy as jnp
    from velocity_tpu.ops.pyramid import build_pyramid

    rows = []
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.random((1080, 1920)).astype(np.float32))

    # ---- pyramid build (matmul form) ----
    def pyr10(x):
        def body(i, acc):
            p = build_pyramid(x + acc * 1e-9, 4)
            return acc + p[4][0, 0]
        return jax.lax.fori_loop(0, 10, body, 0.0)

    f = jax.jit(pyr10)
    t = _fetch_time(f, img)
    t1 = _fetch_time(jax.jit(lambda x: x.sum()), img)  # overhead proxy
    per = max((t - t1) / 10.0, 1e-6)
    flops = 0
    H, W = 1080, 1920
    for _ in range(4):
        h2, w2 = (H + 1) // 2, (W + 1) // 2
        flops += 2 * h2 * H * W + 2 * h2 * W * w2
        H, W = h2, w2
    rows.append({
        "metric": "5-level 1080p Gaussian pyramid (matmul form, f32 HIGHEST)",
        "value": per * 1e3, "unit": "ms",
        "achieved_tflops": flops / per / 1e12,
    })
    return rows


def main():
    from velocity_tpu.utils.device import card_line, device_record, require_gpu

    devices = require_gpu()
    rows = []
    prob, n_real = real_problem()
    rows += bench_ba_rows(prob, n_real)
    rows += bench_batched_schur_rows(prob, n_real)
    rows += bench_kernel_rows()
    print(json.dumps({"suite": "velocity_tpu BA and pyramid timings", "rows": rows,
                      "device": device_record(devices), "card": card_line()},
                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
