"""int8 serving pipeline bench: B=128 416px throughput per model family.

Measures the full jitted pipeline (int8 forward -> decode -> NMS) through
the Predictor for darknet53, yolov3-tiny and CSPDarknet plans, each beside
its bf16 pipeline.

Prints one JSON line per measurement (same schema as bench_suite).
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from yolo_for_turbines_tpu.config import ModelConfig
from yolo_for_turbines_tpu import config as cfg
from yolo_for_turbines_tpu.inference import Predictor
from yolo_for_turbines_tpu.models.yolov3 import YOLOv3


def emit(metric, value, unit, extra=None):
    rec = {"metric": metric, "value": round(value, 1), "unit": unit}
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)


def run(name, model, anchors, B, iters=15):
    rng = np.random.default_rng(0)
    params, stats = model.init(jax.random.PRNGKey(0))
    folded = model.fold(params, stats)
    x = jnp.asarray(rng.uniform(0, 1, (B, 416, 416, 3)), jnp.bfloat16)
    p = Predictor(model, folded, anchors=anchors, image_size=416)
    # bf16 reference
    r = p.predict_batch(x)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(iters):
        r = p.predict_batch(x)
    jax.block_until_ready(r)
    emit(f"{name}_bf16_416_throughput", B * iters / (time.perf_counter() - t0),
         "images/sec/chip", {"batch": B})
    # int8
    p.quantize(np.asarray(x[:8], np.float32))
    r = p.predict_batch(x)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(iters):
        r = p.predict_batch(x)
    jax.block_until_ready(r)
    emit(f"{name}_int8_416_throughput", B * iters / (time.perf_counter() - t0),
         "images/sec/chip", {"batch": B})


def main():
    from yolo_for_turbines_tpu.utils.profiling import (
        enable_compilation_cache,
        gpu_cards,
        require_gpu,
    )

    require_gpu()
    enable_compilation_cache()
    print(gpu_cards(), flush=True)
    run("yolov3", YOLOv3(ModelConfig(num_classes=80)), cfg.ANCHORS, 128)
    run(
        "csp",
        YOLOv3(ModelConfig(num_classes=80, backbone="cspdarknet53")),
        cfg.ANCHORS,
        128,
    )
    run(
        "tiny",
        YOLOv3(
            ModelConfig(num_classes=80, backbone="yolov3_tiny", strides=(32, 16))
        ),
        cfg.TINY_ANCHORS,
        256,
    )


if __name__ == "__main__":
    main()
