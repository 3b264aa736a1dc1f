"""Fixed-trial vmapped RANSAC affine estimation (cv2.estimateAffine2D analog).

The reference calls cv2.estimateAffine2D(method=RANSAC) at KLT.py:33,116,127
(threshold 3 px, adaptive trial count, LSQ refinement on inliers). The
static-shape formulation replaces data-dependent trial counts with a fixed batch
of hypotheses evaluated in parallel: sample K point-triples with a counter-based
PRNG, closed-form 2x3 affine per triple, masked inlier count, argmax, then a
weighted least-squares refit on the winning inlier set.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


def fit_affine_lsq(src, dst, weights):
    """Weighted LSQ affine M (2x3): dst ~ [src 1] @ M^T. Masked by ``weights``."""
    dtype = src.dtype
    w = weights.astype(dtype)[:, None]
    A = jnp.concatenate([src, jnp.ones((src.shape[0], 1), dtype)], axis=1)  # (N,3)
    Aw = A * w
    # normal equations (3x3), solved for both output rows at once
    G = A.T @ Aw  # (3,3)
    B = Aw.T @ dst  # (3,2)
    jitter = jnp.eye(3, dtype=dtype) * jnp.finfo(dtype).eps * jnp.trace(G)
    sol = jnp.linalg.solve(G + jitter, B)  # (3,2)
    return sol.T  # (2,3)


def _affine_from_triple(s3, d3):
    """Exact affine through 3 correspondences; (2,3) (NaN-free via det guard)."""
    dtype = s3.dtype
    A = jnp.concatenate([s3, jnp.ones((3, 1), dtype)], axis=1)  # (3,3)
    det = jnp.linalg.det(A)
    safe = jnp.abs(det) > 1e-6
    Asafe = jnp.where(safe, A, jnp.eye(3, dtype=dtype))
    sol = jnp.linalg.solve(Asafe, d3)  # (3,2)
    return sol.T, safe


class AffineRansacResult(NamedTuple):
    M: jnp.ndarray  # (2,3)
    inliers: jnp.ndarray  # (N,) bool (False on masked-out input lanes)
    n_inliers: jnp.ndarray


@partial(jax.jit, static_argnames=("trials",))
def estimate_affine_ransac(
    src,
    dst,
    mask=None,
    key=None,
    trials: int = 256,
    threshold: float = 3.0,
) -> AffineRansacResult:
    """RANSAC 2D affine from masked correspondences.

    Args:
      src, dst: (N, 2) correspondences (static capacity; masked lanes ignored).
      mask: (N,) bool validity.
      key: jax PRNG key (defaults to a fixed key — deterministic).
      trials: hypothesis count (fixed, evaluated batched).
      threshold: inlier reprojection distance in pixels.
    """
    dtype = src.dtype
    N = src.shape[0]
    if mask is None:
        mask = jnp.ones(N, bool)
    if key is None:
        key = jax.random.PRNGKey(0)

    # sample 3 distinct-ish valid indices per trial via masked Gumbel top-3
    logits = jnp.where(mask, 0.0, -jnp.inf).astype(jnp.float32)
    g = jax.random.gumbel(key, (trials, N), dtype=jnp.float32) + logits[None, :]
    _, idx3 = jax.lax.top_k(g, 3)  # (trials, 3)

    def eval_trial(idx):
        M, safe = _affine_from_triple(src[idx], dst[idx])
        pred = src @ M[:, :2].T + M[:, 2]
        d2 = jnp.sum((pred - dst) ** 2, axis=1)
        inl = mask & (d2 <= threshold * threshold) & safe
        return M, inl, jnp.sum(inl)

    Ms, inls, counts = jax.vmap(eval_trial)(idx3)
    best = jnp.argmax(counts)
    thr2 = threshold * threshold

    # Local optimization (cv2 refineIters equivalent): LSQ refit on the
    # current inlier set, recount, keep the refit ONLY if it does not lose
    # inliers. A blind refit can collapse — a near-degenerate winning triple
    # yields a skewed LSQ model whose own inlier recount is empty (observed on
    # the mixed-motion stills pairs).
    M = Ms[best]
    inliers = inls[best]
    n_in = counts[best]
    for _ in range(2):
        M_ref = fit_affine_lsq(src, dst, inliers.astype(dtype))
        pred = src @ M_ref[:, :2].T + M_ref[:, 2]
        d2 = jnp.sum((pred - dst) ** 2, axis=1)
        inl_ref = mask & (d2 <= thr2)
        n_ref = jnp.sum(inl_ref)
        better = (n_in >= 3) & (n_ref >= n_in)
        M = jnp.where(better, M_ref, M)
        inliers = jnp.where(better, inl_ref, inliers)
        n_in = jnp.where(better, n_ref, n_in)

    # guard: if every hypothesis failed, fall back to identity (finite
    # downstream) with its own inlier set
    eye = jnp.asarray([[1.0, 0, 0], [0, 1.0, 0]], dtype)
    pred_i = src @ eye[:, :2].T + eye[:, 2]
    d2_i = jnp.sum((pred_i - dst) ** 2, axis=1)
    inl_i = mask & (d2_i <= thr2)
    good = n_in >= 3
    M = jnp.where(good, M, eye)
    inliers = jnp.where(good, inliers, inl_i)
    return AffineRansacResult(M=M, inliers=inliers, n_inliers=jnp.sum(inliers))
