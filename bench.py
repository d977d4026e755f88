"""Benchmark harness: 416px COCO inference throughput on one GPU.

Prints the card's name and power limit (`nvidia-smi`), then ONE JSON line:
  {"metric": "...", "value": N, "unit": "images/sec", "device": {...}, ...}

The metric is BASELINE.json config #1: end-to-end 416px inference --
jitted folded-BN forward + 3-scale decode + fixed-shape class-aware NMS, all
on device; only the NMS survivors are synchronized. Refuses to run on
anything but a GPU.
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from yolo_for_turbines_tpu.config import ModelConfig
from yolo_for_turbines_tpu.inference import Predictor
from yolo_for_turbines_tpu.models.yolov3 import YOLOv3
from yolo_for_turbines_tpu.utils.profiling import (
    enable_compilation_cache,
    gpu_cards,
    require_gpu,
)


def main(batch_size: int = 128, iters: int = 20, warmup: int = 3):
    devices = require_gpu()
    enable_compilation_cache()
    cards = gpu_cards()
    print(cards, flush=True)
    model = YOLOv3(ModelConfig(num_classes=80))
    params, stats = model.init(jax.random.PRNGKey(0))
    folded = model.fold(params, stats)
    predictor = Predictor(model, folded, image_size=416)

    x = jnp.asarray(
        np.random.default_rng(0).uniform(0, 1, (batch_size, 416, 416, 3)),
        jnp.bfloat16,
    )

    # compile + warmup
    for _ in range(warmup):
        kept, mask = predictor.predict_batch(x)
    jax.block_until_ready((kept, mask))

    t0 = time.perf_counter()
    for _ in range(iters):
        kept, mask = predictor.predict_batch(x)
    jax.block_until_ready((kept, mask))
    dt = time.perf_counter() - t0

    d = devices[0]
    print(
        json.dumps(
            {
                "metric": "coco_416px_inference_throughput",
                "value": batch_size * iters / dt,
                "unit": "images/sec",
                "batch": batch_size,
                "device": {
                    "platform": d.platform,
                    "kind": d.device_kind,
                    "count": len(devices),
                },
                "card": cards.splitlines()[0],
                "pallas_nms": predictor.use_pallas_nms,
            }
        )
    )


if __name__ == "__main__":
    main()
