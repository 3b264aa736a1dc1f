"""The accelerator a measurement runs on.

Every number this repository reports as a device measurement comes from an
NVIDIA GPU; a run that finds none fails instead of measuring another
platform.
"""

from __future__ import annotations

import subprocess


def require_gpu(count: int = 1) -> list:
    """``jax.devices()`` when JAX reports at least ``count`` GPUs; raises
    ``RuntimeError`` otherwise."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX reports {devices[0].platform} devices, and nothing "
            "is measured on another platform")
    if len(devices) < count:
        raise RuntimeError(f"need {count} GPUs, JAX reports {len(devices)}")
    return devices


def card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi`` gives them
    (``--query-gpu=name,power.limit --format=csv,noheader``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_record(devices) -> dict:
    """The device fields every benchmark line carries."""
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}
