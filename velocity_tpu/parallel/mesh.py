"""Device mesh construction helpers.

Single-host today, multi-host tomorrow: meshes are built from
``jax.devices()`` which, after ``jax.distributed.initialize``, spans all
hosts — nothing else in this package changes for multi-host, since all
communication is expressed as ``psum``/``all_gather`` over mesh axes (the
collectives XLA hands to the interconnect: NVLink within a host, the network
across hosts).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def device_counts() -> int:
    return len(jax.devices())


def make_mesh(axis_sizes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a mesh. ``axis_sizes`` maps axis name -> size; -1 = "the rest".

    Default: one 'point' axis over all devices.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = {"point": n}
    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    unknown = [i for i, s in enumerate(sizes) if s == -1]
    known = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
    if unknown:
        if len(unknown) > 1:
            raise ValueError("at most one -1 axis")
        sizes[unknown[0]] = n // known
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} devices, have {n}")
    arr = np.array(devices[:total]).reshape(sizes)
    return Mesh(arr, names)
