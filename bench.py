"""Benchmark: end-to-end frames/s of the scan driver on the synthetic 1080p clip.

    python bench.py

Runs in one process on one GPU and prints ONE JSON line with the rate, the
clip's speed estimate beside its ground truth, the device as JAX reports it
and the card's name and power limit. Rendering the clip's frames (the
stand-in for decode) runs on the host inside the timed region.

Method: the scan driver in transfer-lean mode (packed per-frame summaries
after the MSV frame). A warm-up run at the timed frame count compiles every
shape first, so no compilation lands in the timed runs; the rate is the
median of five runs.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

N_FRAMES = 20


def main() -> int:
    from velocity_tpu.config import PipelineConfig, SolverConfig
    from velocity_tpu.ingest.synthetic import SyntheticClip
    from velocity_tpu.pipeline.scan import ScanSpeedRunner
    from velocity_tpu.utils.device import card_line, device_record, require_gpu

    devices = require_gpu()
    clip = SyntheticClip(N_FRAMES)
    cfg = PipelineConfig(solver=SolverConfig(dtype="float32"),
                         native_scale=clip.native_scale)
    runner = ScanSpeedRunner(cfg)

    def run():
        return runner.run(clip, annotation=clip.annotation, n_frames=N_FRAMES,
                          verbose=False, lean=True)

    run()  # compile at the timed shape
    walls, res = [], None
    for _ in range(5):
        t0 = time.perf_counter()
        res = run()
        walls.append(time.perf_counter() - t0)
    fps = N_FRAMES / statistics.median(walls)

    print(json.dumps({
        "metric": "frames/s end-to-end, synthetic 1920x1080 clip (render included)",
        "value": fps,
        "unit": "fps",
        "walls_s": walls,
        "speed_kmh": res.speed_kmh,
        "speed_std": res.speed_std,
        "gt_speed_kmh": float(clip.speed_kmh[1]),
        "residual_px": res.residual_px,
        "rescues": res.rescues,
        "device": device_record(devices),
        "card": card_line(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
