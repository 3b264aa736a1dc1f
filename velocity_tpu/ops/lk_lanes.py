"""Lanes-last Lucas-Kanade: the point axis is the minor (contiguous) axis.

The matmul-form LK (ops/lk_fast.py) stores patches as (N, P, P) and samples
them with per-point weight-matrix matmuls: batched (win x P)@(P x P)
products far too small for a matrix unit. This engine transposes the world:

  * All patch tensors are (P, P, N) with the point count N on the minor
    axis — every elementwise op and reduction runs over contiguous points,
    and P lives on the freely-sliceable major dims.
  * Bilinear/cubic sampling at per-point fractional offsets becomes a
    two-pass tap stencil: a weighted sum of statically-shifted slices with
    (1, 1, N) weight broadcasts. No gathers, no small matmuls.
  * Iterations run in unrolled blocks inside ``lax.while_loop``, which gives
    batch-level early exit: a converged batch skips the remaining blocks
    entirely.
  * Every block re-anchors: destination patches are re-extracted at the
    current estimates, so a point can travel arbitrarily far over its
    iteration budget. This removes lk_fast's documented ``search_radius``
    clamp (points moving beyond the patch margin used to stall) — OpenCV's
    gather-at-current-position semantics restored at block granularity
    (reference LK call sites: /root/reference/utils/KLT.py:45-50).

Everything else matches ops/lk.py / cv2.calcOpticalFlowPyrLK: Scharr-smoothed
central-difference gradients of the source window, eps + oscillation
stopping, min-eigenvalue and bounds status gates, and the destination-side
affine warp (the reference's warp-then-track, KLT.py:70-83) materialized per
anchor by an exact separable two-pass bilinear stencil.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from velocity_tpu.ops.interp import extract_patches
from velocity_tpu.ops.lk import LKResult, _affine_for_level
from velocity_tpu.ops.pyramid import build_pyramid

# Iterations per unrolled block, and the maximum travel (px) from the block's
# extraction anchor before in-block sampling clamps. The next block's
# re-extraction recovers any clamped motion.
BLOCK_ITERS = 5
REACH = 3
# Tap count of the warped-extraction stencil: per-pixel source positions may
# deviate +-(WARP_TAPS/2 - 1) px from the identity grid before clamping. The
# warps here are one-frame affine priors (|M - I| << 1), so deviations across
# a ~64 px patch stay well under 2 px.
WARP_TAPS = 8


def _round8(x: int) -> int:
    return (x + 7) & ~7


def _extract_slabs(img, corners, size: int):
    """(size, size, N) integer-corner patches, lanes-last: one
    ``dynamic_slice`` per point (ops/interp.py ``extract_patches``) and one
    transpose. Returns (slabs, clamped corners (N, 2) xy).

    Corners clamp into the image, and a clamped corner shifts the slab
    content relative to the stencil anchor and corrupts every sample, so
    callers edge-pad ``img`` by at least ``size`` on every side and offset
    ``corners`` by the pad: points inside the status bounds then never
    clamp."""
    slabs, cl = extract_patches(img, corners, size)
    return jnp.transpose(slabs, (1, 2, 0)), cl


def _w_linear(a):
    return jnp.maximum(0.0, 1.0 - jnp.abs(a))


def _w_cubic(a):
    """Catmull-Rom (Keys a=-0.5) kernel on |d| (matches ops/interp.py)."""
    d = jnp.abs(a)
    w1 = (1.5 * d - 2.5) * d * d + 1.0
    w2 = ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0
    return jnp.where(d < 1.0, w1, jnp.where(d < 2.0, w2, 0.0))


def _sample_taps(patch, oy, ox, win: int, n_taps: int, cubic: bool = False):
    """(win, win, N) window of (P, P, N) ``patch`` at per-point offsets.

    ``oy, ox``: (N,) fractional window-start offsets into the patch. Two-pass
    weighted sum of statically shifted slices. Offsets clip to the stencil's
    representable range (linear: [0, n_taps-1]; cubic: [1, n_taps-2], the
    4-tap support). ``cubic`` is for patches that are themselves interpolated
    — a second linear pass would compound the smoothing (see ops/lk_fast.py).
    """
    P = patch.shape[0]
    n_taps = min(n_taps, P - win + 1)
    if cubic:
        lo, hi = 1.0, float(n_taps - 2)
    else:
        lo, hi = 0.0, float(n_taps - 1)
    oy = jnp.clip(oy, lo, max(hi, lo))
    ox = jnp.clip(ox, lo, max(hi, lo))
    w_fn = _w_cubic if cubic else _w_linear

    H = None
    for dx in range(n_taps):
        wx = w_fn(ox - dx)[None, None, :]
        sl = jax.lax.slice_in_dim(patch, dx, dx + win, axis=1)
        H = wx * sl if H is None else H + wx * sl
    out = None
    for dy in range(n_taps):
        wy = w_fn(oy - dy)[None, None, :]
        sl = jax.lax.slice_in_dim(H, dy, dy + win, axis=0)
        out = wy * sl if out is None else out + wy * sl
    return out


def _grad_xy(patch):
    """Scharr-smoothed central-difference gradients of a (P, P, N) patch
    (the lanes-last twin of ops/lk_fast.py:_patch_gradients)."""
    p = jnp.pad(patch, ((1, 1), (1, 1), (0, 0)), mode="edge")
    P = patch.shape[0]
    rm, r0, rp = p[0:P, 1 : 1 + P], p[1 : 1 + P, 1 : 1 + P], p[2 : 2 + P, 1 : 1 + P]
    sv = (3.0 * rm + 10.0 * r0 + 3.0 * rp) * (1.0 / 16.0)
    cm, c0, cp = p[1 : 1 + P, 0:P], p[1 : 1 + P, 1 : 1 + P], p[1 : 1 + P, 2 : 2 + P]
    sh = (3.0 * cm + 10.0 * c0 + 3.0 * cp) * (1.0 / 16.0)
    pv = jnp.pad(sv, ((0, 0), (1, 1), (0, 0)), mode="edge")
    gx = (pv[:, 2 : 2 + P] - pv[:, 0:P]) * 0.5
    ph = jnp.pad(sh, ((1, 1), (0, 0), (0, 0)), mode="edge")
    gy = (ph[2 : 2 + P] - ph[0:P]) * 0.5
    return gx, gy


def _extract_warped_lanes(imgp, pad: int, centers, P: int, M, oo: int):
    """(P, P, N) patches of the (pre-padded) image sampled through affine M.

    The destination grid for output index (i, j) of point n is
    ``centers[:, n] + (j - oo, i - oo)`` — anchored at the *exact fractional*
    centers so in-loop resampling interpolates only residual motion.

    Stencil formulation: bilinear interpolation is separable (w = wy ⊗ wx), so
    the 2-D warp gather factors exactly into an x-resampling pass evaluated
    per *source* row followed by a y-pass — for source row y and dest col j,
    the dest row solves y = by + M10·(j-oo) + M11·(i-oo), hence
    x(y, j) = bx + M00·(j-oo) + M01·(y - by - M10·(j-oo))/M11. Both passes
    are WARP_TAPS-tap stencils over statically-shifted slices of one
    axis-aligned slab per point: elementwise work, no gathers.

    ``imgp`` must be edge-padded by ``pad`` >= slab size so clamped slab
    corners never shift content off the stencil anchor (pad once per level,
    not per block). Returns (patches, fractional window corner (2, N)).
    """
    dtype = centers.dtype
    cx, cy = centers[0], centers[1]
    base_x = M[0, 0] * cx + M[0, 1] * cy + M[0, 2]
    base_y = M[1, 0] * cx + M[1, 1] * cy + M[1, 2]
    ms = WARP_TAPS // 2 - 1
    Q = _round8(P + WARP_TAPS)

    kx = jnp.floor(base_x).astype(jnp.int32) - oo - ms + pad
    ky = jnp.floor(base_y).astype(jnp.int32) - oo - ms + pad
    slab, K = _extract_slabs(imgp, jnp.stack([kx, ky], axis=1), Q)
    padf = jnp.asarray(pad, dtype)
    bx_s = base_x + padf - K[:, 0].astype(dtype)  # slab coords of (cx, cy)'s image
    by_s = base_y + padf - K[:, 1].astype(dtype)

    idx = jnp.arange(P, dtype=dtype)
    joff = (idx - oo)[None, :, None]  # centered dest column offsets
    ioff = (idx - oo)[:, None, None]
    jj = idx[None, :, None]
    ii = idx[:, None, None]
    # Near-identity precondition: the x-pass solves the dest row through
    # M11, so |M11| must stay well away from 0 (one-frame affine priors have
    # M ~= I). Guarded reciprocal keeps a degenerate M from emitting NaNs.
    m11 = M[1, 1]
    inv_m11 = jnp.where(jnp.abs(m11) > 1e-3, 1.0 / m11, 1.0)

    # x-pass positions, relative to the identity slab column j
    yy = jnp.arange(Q, dtype=dtype)[:, None, None]
    ex = (
        bx_s[None, None, :]
        + M[0, 0] * joff
        + (M[0, 1] * inv_m11) * (yy - by_s[None, None, :] - M[1, 0] * joff)
        - jj
    )
    ex = jnp.clip(ex, 0.0, WARP_TAPS - 1.0)
    H = None
    for dx in range(WARP_TAPS):
        w = _w_linear(ex - dx)
        sl = jax.lax.slice_in_dim(slab, dx, dx + P, axis=1)
        H = w * sl if H is None else H + w * sl

    # y-pass positions, relative to the identity row i
    ey = by_s[None, None, :] + M[1, 0] * joff + M[1, 1] * ioff - ii
    ey = jnp.clip(ey, 0.0, WARP_TAPS - 1.0)
    out = None
    for dy in range(WARP_TAPS):
        w = _w_linear(ey - dy)
        sl = jax.lax.slice_in_dim(H, dy, dy + P, axis=0)
        out = w * sl if out is None else out + w * sl

    corner = jnp.stack([cx - oo, cy - oo], axis=0)
    return out, corner


def block_iters_ref(
    dpatch, Ip, gxp, gyp, a11, a12, a22, inv_det, bx, by,
    trackable, pts, done, prev_delta, it0,
    *, win: int, n_taps: int, cubic: bool, eps: float, Wd: int, Hd: int,
):
    """One BLOCK_ITERS LK update block of ``_level_loop``."""
    dtype = pts.dtype
    half = (win - 1) * 0.5
    eps2 = jnp.asarray(eps * eps, dtype)
    lo, hi = (1.0, n_taps - 2.0) if cubic else (0.0, n_taps - 1.0)
    for j in range(BLOCK_ITERS):
        ox = pts[0] - half + bx
        oy = pts[1] - half + by
        # while sampling clamps at the stencil edge, deltas are artifacts:
        # such a point must not latch done — the next block re-anchors it
        clamped = (ox < lo) | (ox > hi) | (oy < lo) | (oy > hi)
        Jp = _sample_taps(dpatch, oy, ox, win, n_taps, cubic=cubic)
        diff = Jp - Ip
        b1 = jnp.sum(diff * gxp, axis=(0, 1))
        b2 = jnp.sum(diff * gyp, axis=(0, 1))
        dx_ = -(a22 * b1 - a12 * b2) * inv_det
        dy_ = -(a11 * b2 - a12 * b1) * inv_det
        # trust region: the sampled diff is only valid within the stencil
        # reach, so larger steps walk there over iterations (re-anchoring
        # extends the walk arbitrarily far) instead of jumping blind
        delta = jnp.clip(jnp.stack([dx_, dy_], axis=0), -REACH, REACH)

        inx = jnp.floor(pts[0] - half)
        iny = jnp.floor(pts[1] - half)
        in_ok = (inx >= -win) & (iny >= -win) & (inx < Wd) & (iny < Hd)
        active = (~done) & trackable & in_ok
        pts = jnp.where(active[None, :], pts + delta, pts)
        small = jnp.sum(delta * delta, axis=0) <= eps2
        osc = (it0 + j > 0) & (jnp.abs(delta + prev_delta) < 0.01).all(axis=0)
        # clamp-affected deltas are artifacts: never latch done (or apply
        # the oscillation backoff) on them — the next block re-anchors
        pts = jnp.where((active & osc & ~clamped)[None, :], pts - delta * 0.5, pts)
        done = done | ((small | osc) & ~clamped) | ~in_ok
        prev_delta = jnp.where(active[None, :], delta, prev_delta)
    return pts, done, prev_delta


def _level_loop(
    dimg,
    pts0,  # (2, N) current estimates at this level's scale
    trackable,
    Ip,
    gxp,
    gyp,
    a11,
    a12,
    a22,
    inv_det,
    *,
    win: int,
    iters: int,
    eps: float,
    warp=None,
    dtype=jnp.float32,
):
    """Blocked LK iteration loop, shared by plain and warped destinations.

    Each while iteration (re)extracts destination patches anchored at the
    current estimates, then runs BLOCK_ITERS unrolled updates sampling within
    REACH px of the anchor. Exits early once every point is done.
    """
    N = pts0.shape[1]
    Hd, Wd = dimg.shape
    half = (win - 1) * 0.5
    eps2 = jnp.asarray(eps * eps, dtype)
    cubic = warp is not None
    if cubic:
        oo = (win - 1) // 2 + REACH + 1  # anchor offset o0 = REACH+1, range +-REACH
        P = _round8(win + 2 * REACH + 3)
        n_taps = 2 * REACH + 4
        Q = _round8(P + WARP_TAPS)
        imgp = jnp.pad(dimg, Q, mode="edge")
    else:
        margin = REACH  # o0 = REACH + frac, range ~ +-REACH
        P = _round8(win + 2 * REACH + 1)
        n_taps = 2 * REACH + 2
        # edge-pad once per level so corner clamping inside _extract_slabs can
        # never shift slab content off the stencil anchor: every point inside
        # the in_ok bound lands fully inside the padded image
        dimgp = jnp.pad(dimg, P, mode="edge")
    n_blocks = max(1, -(-iters // BLOCK_ITERS))

    def cond(carry):
        pts, done, prev_delta, blk = carry
        return (blk < n_blocks) & jnp.any(trackable & ~done)

    def body(carry):
        pts, done, prev_delta, blk = carry
        anchor = pts
        if warp is None:
            ci = jnp.floor(anchor).astype(jnp.int32)
            corners = jnp.stack([ci[0] - (win - 1) // 2 - margin + P,
                                 ci[1] - (win - 1) // 2 - margin + P], axis=1)
            dpatch, dcorner = _extract_slabs(dimgp, corners, P)
            bx = (P - dcorner[:, 0]).astype(dtype)  # image-coord corner = dcorner - P
            by = (P - dcorner[:, 1]).astype(dtype)
        else:
            dpatch, corner = _extract_warped_lanes(imgp, Q, anchor, P, warp, oo)
            bx = -corner[0]
            by = -corner[1]

        pts, done, prev_delta = block_iters_ref(
            dpatch, Ip, gxp, gyp, a11, a12, a22, inv_det, bx, by,
            trackable, pts, done, prev_delta, blk * BLOCK_ITERS,
            win=win, n_taps=n_taps, cubic=cubic, eps=eps, Wd=Wd, Hd=Hd,
        )
        return pts, done, prev_delta, blk + 1

    done0 = jnp.zeros(N, bool)
    pd0 = jnp.zeros((2, N), dtype)
    pts, _, _, _ = jax.lax.while_loop(cond, body, (pts0, done0, pd0, jnp.int32(0)))
    return pts


@partial(
    jax.jit,
    static_argnames=("win", "max_level", "iters", "eps", "min_eig_threshold"),
)
def lk_pyramidal_lanes(
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
    warp_dst=None,
    warp_src=None,
    src_pyr=None,
    dst_pyr=None,
) -> LKResult:
    """Drop-in equivalent of ops.lk.lk_pyramidal in the lanes-last engine.

    ``warp_dst`` materializes destination patches through the affine per
    block anchor (stage-3 fine tracking); ``warp_src`` warps the *source*
    side instead — the backward leg of forward-backward gating with a warp.

    ``src_pyr``/``dst_pyr``: prebuilt float pyramids (tuples of >= max_level+1
    levels, level 0 = full image). The frame pipeline builds each frame's
    pyramid ONCE and threads it through the scan carry — without this, a
    forward-backward 3-stage step rebuilds the same full-res pyramid ~8x.
    """
    dtype = pts_src.dtype if jnp.issubdtype(pts_src.dtype, jnp.floating) else jnp.float32
    pts_src = pts_src.astype(dtype)
    if src_pyr is None:
        src_pyr = build_pyramid(src_img.astype(dtype), max_level)
    if dst_pyr is None:
        dst_pyr = build_pyramid(dst_img.astype(dtype), max_level)

    N = pts_src.shape[0]
    half = (win - 1) * 0.5
    eig_thresh = jnp.asarray(min_eig_threshold * 1024.0, dtype)

    ptsT = jnp.transpose(pts_src)  # (2, N)
    cur = jnp.transpose((guess if guess is not None else pts_src).astype(dtype))
    cur = cur * (1.0 / (1 << max_level))
    status = jnp.ones(N, bool)

    src_margin = 2  # gradient + bilinear support around the source window

    for level in range(max_level, -1, -1):
        simg, dimg = src_pyr[level], dst_pyr[level]
        Hs, Ws = simg.shape
        scale = 1.0 / (1 << level)
        Md = _affine_for_level(warp_dst, level, dtype)
        Ms = _affine_for_level(warp_src, level, dtype)
        p_l = ptsT * scale
        cx, cy = p_l[0], p_l[1]

        src_ok = (
            (jnp.floor(cx - half) >= -win) & (jnp.floor(cy - half) >= -win)
            & (jnp.floor(cx - half) < Ws) & (jnp.floor(cy - half) < Hs)
        )

        # ---- source window: one extraction, fixed fractional sample ----
        if Ms is None:
            Ps = _round8(win + 2 * src_margin + 1)
            simgp = jnp.pad(simg, Ps, mode="edge")  # no-clamp guarantee (_extract_slabs)
            ci = jnp.floor(p_l).astype(jnp.int32)
            corners = jnp.stack([ci[0] - (win - 1) // 2 - src_margin + Ps,
                                 ci[1] - (win - 1) // 2 - src_margin + Ps], axis=1)
            spatch, scorner = _extract_slabs(simgp, corners, Ps)
            su = cx - half - (scorner[:, 0] - Ps).astype(dtype)
            sv = cy - half - (scorner[:, 1] - Ps).astype(dtype)
            s_taps, s_cubic = src_margin + 2, False
        else:
            oo_s = (win - 1) // 2 + REACH + 1
            Psw = _round8(win + 2 * REACH + 3)
            Qs = _round8(Psw + WARP_TAPS)
            simgp = jnp.pad(simg, Qs, mode="edge")
            spatch, scorner2 = _extract_warped_lanes(simgp, Qs, p_l, Psw, Ms, oo_s)
            su = cx - half - scorner2[0]
            sv = cy - half - scorner2[1]
            s_taps, s_cubic = REACH + 4, True  # fixed offset o0 = REACH+1
        sgx, sgy = _grad_xy(spatch)
        Ip = _sample_taps(spatch, sv, su, win, s_taps, cubic=s_cubic)
        gxp = _sample_taps(sgx, sv, su, win, s_taps, cubic=s_cubic)
        gyp = _sample_taps(sgy, sv, su, win, s_taps, cubic=s_cubic)

        a11 = jnp.sum(gxp * gxp, axis=(0, 1))
        a12 = jnp.sum(gxp * gyp, axis=(0, 1))
        a22 = jnp.sum(gyp * gyp, axis=(0, 1))
        det = a11 * a22 - a12 * a12
        tr = a11 + a22
        min_eig = (tr - jnp.sqrt((a11 - a22) ** 2 + 4.0 * a12 * a12)) * 0.5 / (win * win)
        eig_ok = (min_eig >= eig_thresh) & (det >= jnp.finfo(dtype).tiny * 16)
        trackable = src_ok & eig_ok
        if level == 0:
            status = status & trackable
        inv_det = jnp.where(det != 0, 1.0 / det, 0.0)

        cur = _level_loop(
            dimg, cur, trackable, Ip, gxp, gyp, a11, a12, a22, inv_det,
            win=win, iters=iters, eps=eps, warp=Md, dtype=dtype,
        )

        if level == 0:
            Hd, Wd = dimg.shape
            inx = jnp.floor(cur[0] - half)
            iny = jnp.floor(cur[1] - half)
            status = status & (inx >= -win) & (iny >= -win) & (inx < Wd) & (iny < Hd)
        else:
            cur = cur * 2.0

    return LKResult(points=jnp.transpose(cur), status=status)


def lk_forward_backward_lanes(
    src_img, dst_img, pts_src, *, fb_threshold=None, warp_dst=None, guess=None,
    src_pyr=None, dst_pyr=None, **kw
) -> LKResult:
    """Forward + backward LK with forward-backward gating (reference fb gate,
    /root/reference/utils/KLT.py:45-50). With a destination warp, the
    backward pass tracks from the warped destination back into the source by
    warping its *source* side — both legs live in source-frame coordinates,
    exactly like ops/lk_fast.py's _lk_backward_warped."""
    fwd = lk_pyramidal_lanes(src_img, dst_img, pts_src, guess=guess,
                             warp_dst=warp_dst, src_pyr=src_pyr,
                             dst_pyr=dst_pyr, **kw)
    if fb_threshold is None:
        return fwd
    if warp_dst is None:
        bwd = lk_pyramidal_lanes(dst_img, src_img, fwd.points, guess=fwd.points,
                                 src_pyr=dst_pyr, dst_pyr=src_pyr, **kw)
    else:
        bwd = lk_pyramidal_lanes(dst_img, src_img, fwd.points, guess=fwd.points,
                                 warp_src=warp_dst, src_pyr=dst_pyr,
                                 dst_pyr=src_pyr, **kw)
    fbe = jnp.sqrt(jnp.sum((pts_src - bwd.points) ** 2, axis=1))
    ok = fwd.status & bwd.status & (fbe < fb_threshold)
    return LKResult(points=fwd.points, status=ok)
