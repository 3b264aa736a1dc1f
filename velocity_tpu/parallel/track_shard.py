"""Feature-axis sharded tracking — the tensor-parallel analog (SURVEY §2.4).

The classic-TP analog in this framework is sharding the FEATURE axis of the
batched LK solve: every point's window solve is independent given the frame
pyramids, so the (static-capacity) track axis partitions across the mesh
while the pyramids replicate. Each device tracks its lane shard with the
unchanged lanes-last engine; there is NO communication inside LK — the only global steps in the tracker (RANSAC
affine, survivor counts) consume the all-gathered point results, exactly
like TP's row/column-parallel matmuls hand off at layer boundaries.

With images replicated this is compute parallelism over lanes; its use case
is high track capacity (N >> 1024) or splitting the fb legs' work across
chips in a window group.
"""

from __future__ import annotations

from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from velocity_tpu.ops.lk_lanes import lk_forward_backward_lanes, LKResult


def lk_forward_backward_sharded(
    src_img,
    dst_img,
    pts_src,  # (N, 2); N divisible by the mesh axis size
    mesh: Mesh,
    axis: str = "feature",
    *,
    fb_threshold=None,
    guess=None,
    warp_dst=None,
    src_pyr=None,
    dst_pyr=None,
    **kw,
) -> LKResult:
    """Forward-backward lanes LK with the point axis sharded over ``mesh``.

    Per-point math is embarrassingly parallel, so results are bit-identical
    to the single-device call given the same pyramids: prebuilt
    ``src_pyr``/``dst_pyr`` are replicated to every device (without them
    each device builds its own from the replicated images).
    """
    N = pts_src.shape[0]
    n_shard = mesh.shape[axis]
    if N % n_shard != 0:
        raise ValueError(f"track capacity {N} not divisible by {n_shard}")

    # optional operands ride along only when given: points-sharded guess,
    # replicated pyramids
    opt = {k: (v, s) for k, v, s in (("guess", guess, P(axis, None)),
                                      ("src_pyr", src_pyr, P()),
                                      ("dst_pyr", dst_pyr, P()))
           if v is not None}

    def shard_fn(src, dst, pts, *vals):
        r = lk_forward_backward_lanes(
            src, dst, pts, fb_threshold=fb_threshold, warp_dst=warp_dst,
            **dict(zip(opt, vals)), **kw,
        )
        return r.points, r.status

    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(axis, None)) + tuple(s for _v, s in opt.values()),
        out_specs=(P(axis, None), P(axis)), check_vma=False,
    )
    pts, status = fn(src_img, dst_img, pts_src, *(v for v, _s in opt.values()))
    return LKResult(points=pts, status=status)
