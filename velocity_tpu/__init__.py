"""velocity_tpu — a structure-from-motion vehicle speed estimation framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of ultralytics/velocity
(monocular vehicle speed estimation via license-plate-anchored SfM):

- ``geometry``: rotations, pinhole projection, spherical/NED coordinates, plate geometry
- ``camera``:   intrinsics database, annotation loading, EXIF/GPS ingest
- ``ingest``:   host-side video/stills decode and the synthetic clip feeding device pipelines
- ``ops``:      batched image ops (pyramids, Lucas-Kanade tracking, Harris corners,
                RANSAC, warps) as XLA programs
- ``solvers``:  Levenberg-Marquardt pose solvers, multi-view triangulation,
                bundle adjustment (dense and Schur-complement block-sparse)
- ``parallel``: device-mesh sharding of bundle adjustment and frame windows
- ``pipeline``: the end-to-end speed estimation driver
- ``viz``:      results visualization

Design stance: static shapes with validity masks, functional state threaded
through ``lax.scan``/``lax.while_loop``, analytic Jacobians via ``jacfwd``,
collectives via ``shard_map``/``psum`` over ``jax.sharding.Mesh``.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when it is set (JAX
# reads the variable itself), else one fixed directory in the checkout, so
# every process run from it finds what earlier ones compiled.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
                      ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

# SfM correctness requires true-f32 matmuls: on the GPU, XLA may run float32
# dots in TF32, which keeps 10 mantissa bits (relative error ~5e-4: several
# centimetres on points tens of metres away, pixels after projection). The
# framework's matmuls are small (Nx3 @ 3x3 geometry, 2x3/2x6 BA blocks) or
# resampling operators (ops/resample.py), so 'highest' costs little;
# precision-tolerant kernels can request lower per-op.
_jax.config.update("jax_default_matmul_precision", "highest")

from velocity_tpu import geometry  # noqa: F401
