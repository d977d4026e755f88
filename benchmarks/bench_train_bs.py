"""Training-step batch-size sweep on one GPU.

Measures the fine-tune configuration (416px, 2 classes, mish — reference
code/train.py:166-172) at bs in {32, 64, 128} and prints one JSON line per
batch size: images/sec, step ms, and the step's flops from XLA's cost
analysis.

Methodology: donated jitted train step, N steps chained through the train
state (the data dependency serializes steps ON DEVICE), one scalar sync at
the end — same pattern as bench_suite's train_step_throughput.

Usage: python benchmarks/bench_train_bs.py [--sizes 32 64 128]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="*", default=[32, 64, 128])
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()

    from yolo_for_turbines_tpu import config as cfg
    from yolo_for_turbines_tpu.config import ModelConfig, TrainConfig
    from yolo_for_turbines_tpu.models.yolov3 import YOLOv3
    from yolo_for_turbines_tpu.train.steps import (
        create_train_state,
        make_train_step,
    )
    from yolo_for_turbines_tpu.utils.profiling import (
        enable_compilation_cache,
        gpu_cards,
        require_gpu,
    )

    require_gpu()
    enable_compilation_cache()
    print(gpu_cards(), flush=True)

    rng = np.random.default_rng(0)
    model = YOLOv3(ModelConfig(num_classes=2, activation="mish"))
    anchors = jnp.asarray(
        np.asarray(cfg.TURBINE_ANCHORS, np.float32)
        * np.asarray(cfg.GRID_SIZES, np.float32).reshape(3, 1, 1)
    )

    for bs in args.sizes:
        tc = TrainConfig(batch_size=bs, max_num_steps=1000)
        state, tx, _ = create_train_state(model, tc, rng=jax.random.PRNGKey(1))
        step = make_train_step(model, tx, tc)
        images = jnp.asarray(rng.uniform(0, 1, (bs, 416, 416, 3)), jnp.float32)
        targets = tuple(
            jnp.zeros((bs, 3, 416 // s, 416 // s, 6), jnp.float32)
            for s in (32, 16, 8)
        )

        # flops of ONE compiled step from XLA's cost analysis (step is
        # already the jitted fn; lowering does not consume the donated state)
        compiled = step.lower(state, images, targets, anchors).compile()
        try:
            flops = float(compiled.cost_analysis()["flops"])
        except Exception:
            flops = float("nan")

        s = state
        s, m = step(s, images, targets, anchors)
        float(m["loss"])  # warm + sync
        t0 = time.perf_counter()
        for _ in range(args.steps):
            s, m = step(s, images, targets, anchors)
        float(m["loss"])
        dt = (time.perf_counter() - t0) / args.steps

        print(json.dumps({
            "metric": "train_step_throughput_416",
            "batch": bs,
            "value": round(bs / dt, 1),
            "unit": "images/sec",
            "step_ms": round(dt * 1e3, 1),
            "flops_per_step": None if not np.isfinite(flops) else flops,
        }), flush=True)
        del s, state


if __name__ == "__main__":
    main()
