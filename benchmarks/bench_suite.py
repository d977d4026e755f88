"""Extended benchmark suite (run on a GPU; bench.py stays the one-line
headline). Prints the card's name and power limit, then one JSON object per
metric.

Covers the BASELINE.json tracked metrics beyond the headline:
- NMS p50 latency (single image, decode+NMS program)
- end-to-end batched inference throughput (the headline, re-measured)
- training-step throughput at 416px (fine-tune config #3/#4)
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from yolo_for_turbines_tpu import config as cfg
from yolo_for_turbines_tpu.config import ModelConfig, TrainConfig
from yolo_for_turbines_tpu.inference import Predictor
from yolo_for_turbines_tpu.models.yolov3 import YOLOv3
from yolo_for_turbines_tpu.ops.decode import decode_raw_all
from yolo_for_turbines_tpu.ops.nms import batched_nms
from yolo_for_turbines_tpu.train.steps import create_train_state, make_train_step
from yolo_for_turbines_tpu.utils.profiling import (
    enable_compilation_cache,
    gpu_cards,
    require_gpu,
)


def timeit(f, *a, iters=20, warmup=2):
    """Per-iteration sync — LATENCY semantics (single-image / NMS p50)."""
    for _ in range(warmup):
        r = f(*a)
    jax.block_until_ready(r)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        r = f(*a)
        jax.block_until_ready(r)
        times.append(time.perf_counter() - t0)
    return float(np.percentile(times, 50)), float(np.mean(times))


def throughput(f, *a, iters=15, warmup=3):
    """Pipelined dispatch loop, ONE sync at the end — THROUGHPUT
    semantics (matches bench.py and real serving, where dispatch
    backpressure, not a per-batch host sync, gates the stream). Returns
    mean seconds per iteration."""
    for _ in range(warmup):
        r = f(*a)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(iters):
        r = f(*a)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / iters


def emit(metric, value, unit, extra=None):
    rec = {"metric": metric, "value": round(value, 3), "unit": unit}
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)


def main():
    require_gpu()
    enable_compilation_cache()
    print(gpu_cards(), flush=True)
    rng = np.random.default_rng(0)
    model = YOLOv3(ModelConfig(num_classes=80))
    params, stats = model.init(jax.random.PRNGKey(0))
    folded = model.fold(params, stats)

    # --- headline: batched inference throughput
    B = 128
    p = Predictor(model, folded, image_size=416)
    x = jnp.asarray(rng.uniform(0, 1, (B, 416, 416, 3)), jnp.bfloat16)
    mean = throughput(lambda: p.predict_batch(x), iters=15)
    emit("coco_416_inference_throughput", B / mean, "images/sec/chip",
         {"batch": B, "mean_ms": round(mean * 1e3, 2)})

    # --- single-image end-to-end latency (demo path)
    p1 = Predictor(model, folded, image_size=416)
    x1 = jnp.asarray(rng.uniform(0, 1, (1, 416, 416, 3)), jnp.bfloat16)
    p50, mean = timeit(lambda: p1.predict_batch(x1), iters=30)
    emit("single_image_e2e_latency_p50", p50 * 1e3, "ms")

    # --- high-resolution inference (832px = 2x trained res, 26/52/104
    # grids): the single-card anchor for the spatial-partitioning story
    # (parallel/spatial.py shards rows when one card can't hold the
    # activations). B=32 matches the 416 B=128 pixel volume. Same pipeline,
    # no code path differences beyond shape.
    B_hr = 32
    x_hr = jnp.asarray(
        rng.uniform(0, 1, (B_hr, 832, 832, 3)), jnp.bfloat16
    )
    mean = throughput(lambda: p.predict_batch(x_hr), iters=10)
    emit("coco_832_inference_throughput", B_hr / mean, "images/sec/chip",
         {"batch": B_hr, "mean_ms": round(mean * 1e3, 2)})

    # --- NMS-only latency (10647 candidate boxes -> K=256 survivors), the
    # platform's choice of sweep and the XLA sweep
    boxes = jnp.asarray(rng.uniform(0, 1, (1, 10647, 6)), jnp.float32)
    for use_pallas, mname in ((p.use_pallas_nms, "nms_p50_latency"),
                              (False, "nms_p50_latency_xla")):
        nms = jax.jit(
            lambda b, u=use_pallas: batched_nms(
                b, cfg.NMS_IOU_THRESHOLD, cfg.CONF_THRESHOLD, 256, use_pallas=u
            )
        )
        p50, mean = timeit(lambda: nms(boxes), iters=30)
        emit(mname, p50 * 1e3, "ms", {"candidates": 10647, "k": 256})

    # --- int8 PTQ serving pipeline (models/quantize.py)
    p8 = Predictor(model, folded, image_size=416)
    p8.quantize(np.asarray(x[:8], np.float32))
    mean = throughput(lambda: p8.predict_batch(x), iters=15, warmup=1)
    emit("int8_ptq_416_inference_throughput", B / mean, "images/sec/chip",
         {"batch": B})

    # --- CSPDarknet-53 family, bf16 and int8 PTQ
    csp = YOLOv3(ModelConfig(num_classes=80, backbone="cspdarknet53"))
    cparams, cstats = csp.init(jax.random.PRNGKey(3))
    cfolded = csp.fold(cparams, cstats)
    pc = Predictor(csp, cfolded, image_size=416)
    mean = throughput(lambda: pc.predict_batch(x), iters=15)
    emit("csp_416_inference_throughput", B / mean, "images/sec/chip",
         {"batch": B})
    pc.quantize(np.asarray(x[:8], np.float32))
    mean = throughput(lambda: pc.predict_batch(x), iters=15)
    emit("csp_int8_ptq_416_inference_throughput", B / mean,
         "images/sec/chip", {"batch": B})

    # --- yolov3-tiny family (2-scale), bf16 and int8 PTQ
    tiny = YOLOv3(
        ModelConfig(num_classes=80, backbone="yolov3_tiny", strides=(32, 16))
    )
    tparams, tstats = tiny.init(jax.random.PRNGKey(2))
    tfolded = tiny.fold(tparams, tstats)
    Bt = 256
    xt = jnp.asarray(rng.uniform(0, 1, (Bt, 416, 416, 3)), jnp.bfloat16)
    pt = Predictor(tiny, tfolded, anchors=cfg.TINY_ANCHORS, image_size=416)
    mean = throughput(lambda: pt.predict_batch(xt), iters=15)
    emit("tiny_416_inference_throughput", Bt / mean, "images/sec/chip",
         {"batch": Bt})
    pt.quantize(np.asarray(xt[:8], np.float32))
    mean = throughput(lambda: pt.predict_batch(xt), iters=15)
    emit("tiny_int8_ptq_416_inference_throughput", Bt / mean,
         "images/sec/chip", {"batch": Bt})

    # --- training step throughput (fine-tune config: 416px, 2 classes)
    tmodel = YOLOv3(ModelConfig(num_classes=2, activation="mish"))
    tc = TrainConfig(batch_size=32, max_num_steps=100)
    state, tx, _ = create_train_state(tmodel, tc, rng=jax.random.PRNGKey(1))
    step = make_train_step(tmodel, tx, tc)
    bt = tc.batch_size
    images = jnp.asarray(rng.uniform(0, 1, (bt, 416, 416, 3)), jnp.float32)
    targets = tuple(
        jnp.zeros((bt, 3, 416 // s, 416 // s, 6), jnp.float32) for s in (32, 16, 8)
    )
    anchors = jnp.asarray(
        np.asarray(cfg.TURBINE_ANCHORS, np.float32)
        * np.asarray(cfg.GRID_SIZES, np.float32).reshape(3, 1, 1)
    )

    def one_step(s):
        s2, m = step(s, images, targets, anchors)
        return s2, m

    # chain state through timed iterations (donation-legal); the state
    # dependency serializes the steps ON DEVICE, so one sync at the end
    # measures device step time
    s = state
    s, m = one_step(s)
    jax.block_until_ready(m["loss"])
    t0 = time.perf_counter()
    for _ in range(10):
        s, m = one_step(s)
    float(m["loss"])
    mean = (time.perf_counter() - t0) / 10
    emit("train_step_throughput_416_bs32", bt / mean, "images/sec/chip",
         {"step_ms": round(mean * 1e3, 1)})


if __name__ == "__main__":
    main()
