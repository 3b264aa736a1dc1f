"""Matmul-formulated Lucas-Kanade: patch extraction once, iterations as matmuls.

The reference-path tracker (ops/lk.py) bilinear-samples the destination image
every iteration — a batched gather. This engine restructures LK so the inner
loop is pure dense math:

  1. Per level, extract one padded patch per point from each image — the only
    memory-irregular step (axis-aligned ``dynamic_slice`` per point;
    affine-warped destination patches are materialized once through a tap
    stencil, mirroring the reference's warp-once-then-track, KLT.py:70-83).
  2. Bilinear sampling at a fractional offset (dy, dx) becomes
    ``S_y(dy) @ patch @ S_x(dx)^T`` with tiny interpolation-weight matrices
    built from iota arithmetic — so every LK iteration is two small batched
    matmuls plus reductions. No gathers, no dynamic slices.

Semantics match ops/lk.py (same gradients, eps/oscillation stopping, min-eig
and bounds status) with one documented deviation: each point's search is
bounded by ``search_radius`` pixels around its initial guess per level
(samples clamp at the patch edge beyond that). With coarse-to-fine guesses
and affine priors, residual per-level motion is far below the default radius;
runaway points are exactly the ones forward-backward gating removes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from velocity_tpu.ops.interp import extract_patches, sample_patches
from velocity_tpu.ops.lk import LKResult, scharr_derivatives, _affine_for_level
from velocity_tpu.ops.pyramid import build_pyramid


# Batched separable patch sampling (S_y @ patch @ S_x^T) — shared with
# subpixel refinement; cubic=True for once-interpolated (warped) patches,
# where a second linear pass would compound the smoothing and bias converged
# LK positions by ~0.2 px — past the 0.3 px fb gate.
_sample = sample_patches


# Stencil width for warped extraction: per-pixel source positions may deviate
# from the identity grid by up to (taps/2 - 2) px before clamping kicks in.
# The warps here are one-frame affine priors (|rotation| << 1°, |scale-1|
# usually < 2e-2), so deviations across a ~70 px patch stay under 2 px;
# 12 taps covers scale factors out to ~1.05 with slack.
WARP_STENCIL_TAPS = 12


def _extract_warped(img, centers, size: int, M):
    """(N, size, size) patches sampled through affine M on a grid anchored at
    the *exact fractional* ``centers``.

    Anchoring at the fractional center (not ``floor``) makes the patch sample
    positions coincide with the LK window when the residual displacement is
    zero — so the in-loop patch resampling interpolates only the residual
    motion, and its error vanishes as LK converges.

    Stencil formulation: because M is near-identity, every sample position
    lies within a few pixels of the identity grid, so the per-pixel bilinear
    gather of this patch is really a *stencil*: one axis-aligned slab
    ``dynamic_slice`` per point, then a taps×taps weighted sum of
    statically-shifted slab slices (elementwise work, no gathers).
    Numerics are exact bilinear; positions
    further than the stencil reach (only possible for extreme warps or at
    image borders, where the slab corner clamps) clamp like a border."""
    dtype = centers.dtype
    half = (size - 1) // 2
    taps = WARP_STENCIL_TAPS
    margin = taps // 2 - 1
    Q = size + taps  # slab side: covers shifts 0..taps-1 of a size-wide slice

    corner = centers - jnp.asarray(half, dtype)  # (N, 2) fractional dest corner
    # source position of the dest-patch CENTER: anchoring the stencil at the
    # center (not the corner) halves the warp's lever arm across the patch,
    # doubling the scale/rotation range the taps can represent
    base_x = M[0, 0] * centers[:, 0] + M[0, 1] * centers[:, 1] + M[0, 2]
    base_y = M[1, 0] * centers[:, 0] + M[1, 1] * centers[:, 1] + M[1, 2]
    offc = jnp.arange(size, dtype=dtype) - jnp.asarray(half, dtype)  # centered
    Gx = M[0, 0] * offc[None, :] + M[0, 1] * offc[:, None]  # (i=row, j=col)
    Gy = M[1, 0] * offc[None, :] + M[1, 1] * offc[:, None]

    # Edge-pad so slab corners never clamp: a clamped corner would shift the
    # slab content away from the stencil's identity-grid anchor (silently
    # corrupting every border-overlapping patch), whereas edge padding
    # reproduces bilinear_sample's border-replicate semantics exactly for
    # overhangs up to `pad` px. Points further out than that are already
    # outside every status gate.
    pad = Q
    imgp = jnp.pad(img, pad, mode="edge")
    kx = jnp.floor(base_x - half).astype(jnp.int32) - margin + pad
    ky = jnp.floor(base_y - half).astype(jnp.int32) - margin + pad
    slab, K = extract_patches(imgp, jnp.stack([kx, ky], axis=1), Q)

    # sample positions in slab coords, re-expressed relative to the identity
    # grid (i, j): clip deviations to the stencil's reach
    padf = jnp.asarray(pad, dtype)
    ii = jnp.arange(size, dtype=dtype)[:, None]
    jj = jnp.arange(size, dtype=dtype)[None, :]
    ey = jnp.clip(
        (base_y + padf - K[:, 1].astype(dtype))[:, None, None] + Gy[None] - ii[None],
        0.0, taps - 2.0,
    )
    ex = jnp.clip(
        (base_x + padf - K[:, 0].astype(dtype))[:, None, None] + Gx[None] - jj[None],
        0.0, taps - 2.0,
    )

    out = jnp.zeros((centers.shape[0], size, size), slab.dtype)
    for dy in range(taps):
        wy = jnp.maximum(0.0, 1.0 - jnp.abs(ey - dy))
        for dx in range(taps):
            wx = jnp.maximum(0.0, 1.0 - jnp.abs(ex - dx))
            out = out + (wy * wx) * slab[:, dy : dy + size, dx : dx + size]
    return out, corner


def _patch_gradients(patches):
    """Scharr-smoothed central-difference gradients of (N, P, P) patches."""
    p = jnp.pad(patches, ((0, 0), (1, 1), (1, 1)), mode="edge")
    P = patches.shape[-1]
    rm, r0, rp = p[:, 0:P, 1 : 1 + P], p[:, 1 : 1 + P, 1 : 1 + P], p[:, 2 : 2 + P, 1 : 1 + P]
    sv = (3.0 * rm + 10.0 * r0 + 3.0 * rp) / 16.0
    cm, c0, cp = p[:, 1 : 1 + P, 0:P], p[:, 1 : 1 + P, 1 : 1 + P], p[:, 1 : 1 + P, 2 : 2 + P]
    sh = (3.0 * cm + 10.0 * c0 + 3.0 * cp) / 16.0
    pv = jnp.pad(sv, ((0, 0), (0, 0), (1, 1)), mode="edge")
    gx = (pv[:, :, 2 : 2 + P] - pv[:, :, 0:P]) * 0.5
    ph = jnp.pad(sh, ((0, 0), (1, 1), (0, 0)), mode="edge")
    gy = (ph[:, 2 : 2 + P, :] - ph[:, 0:P, :]) * 0.5
    return gx, gy


@partial(
    jax.jit,
    static_argnames=("win", "max_level", "iters", "eps", "min_eig_threshold",
                     "search_radius"),
)
def lk_pyramidal_fast(
    src_img,
    dst_img,
    pts_src,
    guess=None,
    *,
    win: int = 15,
    max_level: int = 4,
    iters: int = 10,
    eps: float = 0.1,
    min_eig_threshold: float = 1e-4,
    search_radius: int = 8,
    warp_dst=None,
) -> LKResult:
    """Drop-in fast equivalent of ops.lk.lk_pyramidal (see deviation note)."""
    dtype = pts_src.dtype if jnp.issubdtype(pts_src.dtype, jnp.floating) else jnp.float32
    pts_src = pts_src.astype(dtype)
    src_pyr = build_pyramid(src_img.astype(dtype), max_level)
    dst_pyr = build_pyramid(dst_img.astype(dtype), max_level)

    N = pts_src.shape[0]
    half = (win - 1) * 0.5
    R = search_radius
    P = win + 2 * R + 3  # window + search + bilinear/gradient margins
    eps2 = jnp.asarray(eps * eps, dtype)
    eig_thresh = jnp.asarray(min_eig_threshold * 1024.0, dtype)

    next_pts = (guess if guess is not None else pts_src).astype(dtype)
    next_pts = next_pts * (1.0 / (1 << max_level))
    status = jnp.ones(N, bool)

    for level in range(max_level, -1, -1):
        simg, dimg = src_pyr[level], dst_pyr[level]
        Hs, Ws = simg.shape
        Hd, Wd = dimg.shape
        scale = 1.0 / (1 << level)
        Md = _affine_for_level(warp_dst, level, dtype)
        p_l = pts_src * scale
        cx, cy = p_l[:, 0], p_l[:, 1]

        src_ok = (
            (jnp.floor(cx - half) >= -win) & (jnp.floor(cy - half) >= -win)
            & (jnp.floor(cx - half) < Ws) & (jnp.floor(cy - half) < Hs)
        )

        # ---- one-time source patch + gradients ----
        corner_f = jnp.floor(p_l).astype(jnp.int32) - (win - 1) // 2 - R - 1
        spatch, scorner = extract_patches(simg, corner_f, P)
        sgx, sgy = _patch_gradients(spatch)
        # fixed fractional source window start within the patch
        su = p_l[:, 0] - half - scorner[:, 0].astype(dtype)
        sv = p_l[:, 1] - half - scorner[:, 1].astype(dtype)
        Ip = _sample(spatch, sv, su, win)
        gxp = _sample(sgx, sv, su, win)
        gyp = _sample(sgy, sv, su, win)

        a11 = jnp.sum(gxp * gxp, axis=(1, 2))
        a12 = jnp.sum(gxp * gyp, axis=(1, 2))
        a22 = jnp.sum(gyp * gyp, axis=(1, 2))
        det = a11 * a22 - a12 * a12
        tr = a11 + a22
        min_eig = (tr - jnp.sqrt((a11 - a22) ** 2 + 4.0 * a12 * a12)) * 0.5 / (win * win)
        eig_ok = (min_eig >= eig_thresh) & (det >= jnp.finfo(dtype).tiny * 16)
        trackable = src_ok & eig_ok
        if level == 0:
            status = status & trackable
        inv_det = jnp.where(det != 0, 1.0 / det, 0.0)

        # ---- destination patches anchored at the current estimate ----
        # Warped dest patches are themselves interpolated, so resampling them
        # for the residual motion compounds interpolation error. Anchoring the
        # grid at the exact fractional estimate makes that error vanish as the
        # residual -> 0; a second extract+iterate phase after convergence
        # (one extra gather, not one per iteration) removes the first phase's
        # en-route bias. Axis-aligned patches are exact pixels (single
        # interpolation in-loop — matches the reference path), one phase.
        def make_body(anchor, dpatch, base_x, base_y, dest_cubic):
            def body(j, carry):
                npts, done, prev_delta = carry
                d = npts - anchor  # (N, 2) motion since extraction anchor
                ox = anchor[:, 0] - half + base_x + d[:, 0]
                oy = anchor[:, 1] - half + base_y + d[:, 1]
                Jp = _sample(dpatch, oy, ox, win, cubic=dest_cubic)
                diff = Jp - Ip
                b1 = jnp.sum(diff * gxp, axis=(1, 2))
                b2 = jnp.sum(diff * gyp, axis=(1, 2))
                dx_ = -(a22 * b1 - a12 * b2) * inv_det
                dy_ = -(a11 * b2 - a12 * b1) * inv_det
                delta = jnp.stack([dx_, dy_], axis=1)

                nx, ny = npts[:, 0], npts[:, 1]
                inx = jnp.floor(nx - half)
                iny = jnp.floor(ny - half)
                in_ok = (inx >= -win) & (iny >= -win) & (inx < Wd) & (iny < Hd)

                active = (~done) & trackable & in_ok
                npts = jnp.where(active[:, None], npts + delta, npts)
                small = jnp.sum(delta * delta, axis=1) <= eps2
                osc = (j > 0) & (jnp.abs(delta + prev_delta) < 0.01).all(axis=1)
                npts = jnp.where((active & osc)[:, None], npts - delta * 0.5, npts)
                done = done | small | osc | ~in_ok
                return npts, done, jnp.where(active[:, None], delta, prev_delta)

            return body

        done0 = jnp.zeros(N, bool)
        pd0 = jnp.zeros((N, 2), dtype)
        if Md is None:
            anchor = next_pts
            dcorner_i = jnp.floor(anchor).astype(jnp.int32) - (win - 1) // 2 - R - 1
            dpatch, dcorner = extract_patches(dimg, dcorner_i, P)
            body = make_body(anchor, dpatch, -dcorner[:, 0].astype(dtype),
                             -dcorner[:, 1].astype(dtype), False)
            next_pts, _, _ = jax.lax.fori_loop(0, iters, body, (next_pts, done0, pd0))
        else:
            for phase_iters in (iters, max(2, iters // 4)):
                anchor = next_pts
                dpatch, dcorner = _extract_warped(dimg, anchor, P, Md)
                body = make_body(anchor, dpatch, -dcorner[:, 0], -dcorner[:, 1], True)
                next_pts, _, _ = jax.lax.fori_loop(
                    0, phase_iters, body, (next_pts, done0, pd0)
                )

        if level == 0:
            inx = jnp.floor(next_pts[:, 0] - half)
            iny = jnp.floor(next_pts[:, 1] - half)
            status = status & (inx >= -win) & (iny >= -win) & (inx < Wd) & (iny < Hd)
        else:
            next_pts = next_pts * 2.0

    return LKResult(points=next_pts, status=status)


def lk_forward_backward_fast(
    src_img, dst_img, pts_src, *, fb_threshold=None, warp_dst=None, guess=None, **kw
) -> LKResult:
    """Fast forward + backward LK with fb gating (ops.lk.lk_forward_backward
    semantics). The backward pass swaps images (and applies the warp on the
    source side by sampling the destination through it). ``guess`` seeds only
    the forward pass; the backward pass always starts from the forward result."""
    fwd = lk_pyramidal_fast(src_img, dst_img, pts_src, guess=guess,
                            warp_dst=warp_dst, **kw)
    if fb_threshold is None:
        return fwd
    if warp_dst is None:
        bwd = lk_pyramidal_fast(dst_img, src_img, fwd.points, guess=fwd.points, **kw)
    else:
        # backward on the (warped dst, src) pair: both live in source coords,
        # so the backward "source" samples dst through the warp. Reuse the
        # forward machinery by tracking from a virtual image: this is exactly
        # lk.py's backward case (warp_src); here we emulate it by swapping
        # roles in a dedicated pass below.
        bwd = _lk_backward_warped(dst_img, src_img, fwd.points, warp_dst, **kw)
    fbe = jnp.sqrt(jnp.sum((pts_src - bwd.points) ** 2, axis=1))
    ok = fwd.status & bwd.status & (fbe < fb_threshold)
    return LKResult(points=fwd.points, status=ok)


@partial(
    jax.jit,
    static_argnames=("win", "max_level", "iters", "eps", "min_eig_threshold",
                     "search_radius"),
)
def _lk_backward_warped(
    wimg,  # destination image (sampled through the warp = backward source)
    dst_img,  # original source image (backward destination)
    pts,  # forward results (source-frame coords)
    M,  # (2,3) affine, source->wimg coords
    *,
    win: int = 15,
    max_level: int = 4,
    iters: int = 10,
    eps: float = 0.1,
    min_eig_threshold: float = 1e-4,
    search_radius: int = 8,
) -> LKResult:
    """Backward pass where the *source* patches come through the warp."""
    dtype = pts.dtype if jnp.issubdtype(pts.dtype, jnp.floating) else jnp.float32
    pts = pts.astype(dtype)
    src_pyr = build_pyramid(wimg.astype(dtype), max_level)
    dst_pyr = build_pyramid(dst_img.astype(dtype), max_level)

    N = pts.shape[0]
    half = (win - 1) * 0.5
    R = search_radius
    P = win + 2 * R + 3
    eps2 = jnp.asarray(eps * eps, dtype)
    eig_thresh = jnp.asarray(min_eig_threshold * 1024.0, dtype)

    next_pts = pts * (1.0 / (1 << max_level))
    status = jnp.ones(N, bool)

    for level in range(max_level, -1, -1):
        simg, dimg = src_pyr[level], dst_pyr[level]
        Hd, Wd = dimg.shape
        scale = 1.0 / (1 << level)
        Ml = _affine_for_level(M, level, dtype)
        p_l = pts * scale

        # warped source patch; its numeric gradients are already with respect
        # to the warped (source-frame) coordinates — exactly the reference's
        # Scharr-on-materialized-warp, no extra chain rule.
        spatch, scorner = _extract_warped(simg, p_l, P, Ml)
        gxp_full, gyp_full = _patch_gradients(spatch)
        su = p_l[:, 0] - half - scorner[:, 0]
        sv = p_l[:, 1] - half - scorner[:, 1]
        Ip = _sample(spatch, sv, su, win, cubic=True)  # spatch is warped
        gxp = _sample(gxp_full, sv, su, win, cubic=True)
        gyp = _sample(gyp_full, sv, su, win, cubic=True)

        a11 = jnp.sum(gxp * gxp, axis=(1, 2))
        a12 = jnp.sum(gxp * gyp, axis=(1, 2))
        a22 = jnp.sum(gyp * gyp, axis=(1, 2))
        det = a11 * a22 - a12 * a12
        tr = a11 + a22
        min_eig = (tr - jnp.sqrt((a11 - a22) ** 2 + 4 * a12 * a12)) * 0.5 / (win * win)
        trackable = (min_eig >= eig_thresh) & (det >= jnp.finfo(dtype).tiny * 16)
        if level == 0:
            status = status & trackable
        inv_det = jnp.where(det != 0, 1.0 / det, 0.0)

        guess_l = next_pts
        dci = jnp.floor(guess_l).astype(jnp.int32) - (win - 1) // 2 - R - 1
        dpatch, dcorner = extract_patches(dimg, dci, P)
        base_x = -dcorner[:, 0].astype(dtype)
        base_y = -dcorner[:, 1].astype(dtype)

        def body(j, carry):
            npts, done, prev_delta = carry
            ox = npts[:, 0] - half + base_x
            oy = npts[:, 1] - half + base_y
            Jp = _sample(dpatch, oy, ox, win)
            diff = Jp - Ip
            b1 = jnp.sum(diff * gxp, axis=(1, 2))
            b2 = jnp.sum(diff * gyp, axis=(1, 2))
            dx_ = -(a22 * b1 - a12 * b2) * inv_det
            dy_ = -(a11 * b2 - a12 * b1) * inv_det
            delta = jnp.stack([dx_, dy_], axis=1)
            inx = jnp.floor(npts[:, 0] - half)
            iny = jnp.floor(npts[:, 1] - half)
            in_ok = (inx >= -win) & (iny >= -win) & (inx < Wd) & (iny < Hd)
            active = (~done) & trackable & in_ok
            npts = jnp.where(active[:, None], npts + delta, npts)
            small = jnp.sum(delta * delta, axis=1) <= eps2
            osc = (j > 0) & (jnp.abs(delta + prev_delta) < 0.01).all(axis=1)
            npts = jnp.where((active & osc)[:, None], npts - delta * 0.5, npts)
            done = done | small | osc | ~in_ok
            return npts, done, jnp.where(active[:, None], delta, prev_delta)

        next_pts, _, _ = jax.lax.fori_loop(
            0, iters, body, (next_pts, jnp.zeros(N, bool), jnp.zeros((N, 2), dtype))
        )
        if level == 0:
            inx = jnp.floor(next_pts[:, 0] - half)
            iny = jnp.floor(next_pts[:, 1] - half)
            status = status & (inx >= -win) & (iny >= -win) & (inx < Wd) & (iny < Hd)
        else:
            next_pts = next_pts * 2.0

    return LKResult(points=next_pts, status=status)
