"""Device train-step time for one backbone (fine-tune config: 416px,
2 classes, bs=32) — the per-backbone companion to bench_suite.py's
`train_step_throughput_416_bs32` (same chained-state methodology).

CSPDarknet53's step time belongs next to darknet53's; this driver
measures either on one GPU:

  python benchmarks/bench_train_step.py --backbone cspdarknet53

Methodology: the train state is threaded through the timed iterations, so
the data dependency serializes the steps ON DEVICE and one scalar sync at
the end measures device step time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backbone", default="darknet53",
                    choices=["darknet53", "cspdarknet53", "yolov3_tiny"])
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=416)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from yolo_for_turbines_tpu import config as cfg
    from yolo_for_turbines_tpu.config import ModelConfig, TrainConfig
    from yolo_for_turbines_tpu.models.yolov3 import YOLOv3
    from yolo_for_turbines_tpu.train.steps import (
        create_train_state,
        make_train_step,
    )

    size = args.image_size
    model = YOLOv3(
        ModelConfig(num_classes=2, activation="mish", backbone=args.backbone)
    )
    tc = TrainConfig(batch_size=args.batch_size, max_num_steps=100)
    state, tx, _ = create_train_state(model, tc, rng=jax.random.PRNGKey(1))
    step = make_train_step(model, tx, tc)
    bt = tc.batch_size
    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.uniform(0, 1, (bt, size, size, 3)), jnp.float32)
    targets = tuple(
        jnp.zeros((bt, 3, size // s, size // s, 6), jnp.float32)
        for s in model.strides
    )
    base = (
        cfg.TINY_ANCHORS
        if args.backbone == "yolov3_tiny"
        else cfg.TURBINE_ANCHORS
    )
    gs = np.asarray(
        cfg.grid_sizes_for(size, model.strides), np.float32
    ).reshape(-1, 1, 1)
    anchors = jnp.asarray(np.asarray(base, np.float32) * gs)

    s, m = step(state, images, targets, anchors)
    jax.block_until_ready(m["loss"])
    t0 = time.perf_counter()
    for _ in range(args.iters):
        s, m = step(s, images, targets, anchors)
    float(m["loss"])
    mean = (time.perf_counter() - t0) / args.iters
    print(json.dumps({
        "metric": f"train_step_throughput_{size}_bs{bt}",
        "backbone": args.backbone,
        "value": round(bt / mean, 3),
        "unit": "images/sec",
        "step_ms": round(mean * 1e3, 1),
    }))


if __name__ == "__main__":
    main()
