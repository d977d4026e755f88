"""int8 PTQ quality on TRAINED weights: mAP cost of the int8 path.

The int8 export path is *mechanically* exact (survivor-set agreement vs the
live path on the same weights) — but on synthetic-init weights every logit
collapses to ~0.5 and mAP is meaningless. This driver puts a number on what int8 post-training
quantization actually costs in detection quality: it takes a CONVERGED
checkpoint from a convergence run (e.g. the composed-recipe run),
evaluates the same val split through three formulations of the same
network, and reports mAP@0.5 per path:

1. train-mode `apply` (train=False) — the trainer's own eval path, the
   number the convergence run reported;
2. folded-BN bf16 inference (`apply_folded`, raw heads) — the serving path;
3. int8 PTQ (`quantize_folded` + `apply_inference_int8`) — int8 convs
   with f32 sums, calibrated on a train batch.

All three share ONE decode + NMS + device-mAP tail
(ops/decode.decode_raw_all, ops/nms.batched_nms,
ops/map.calc_map_device_batched), so any mAP delta is attributable to the
forward formulation alone. The reference has no analogue (no quantization
anywhere); the contrast is against its fp32 AMP serving story.

Usage (on a GPU host, after a convergence run):
  python benchmarks/int8_quality.py --root /tmp/conv_composed \
      --identifier composed_r5
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def eval_map_via_predictor(predictor, loader, anchors, num_classes: int):
    """mAP@0.5 through a Predictor's compiled pipeline (folded bf16 or
    int8), with GT decoded from the loader's finest-scale targets — the
    same GT convention as train/evaluate.py (reference parity:
    code/utils.py:311-315)."""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from yolo_for_turbines_tpu import config as cfg
    from yolo_for_turbines_tpu.ops.decode import decode_scale
    from yolo_for_turbines_tpu.ops.map import calc_map_device_batched

    strides = predictor.model.strides

    @functools.partial(jax.jit, static_argnames=("image_size", "max_gt"))
    def gt_step(targets_fine, anchors_a, *, image_size, max_gt=128):
        grid_sizes = cfg.grid_sizes_for(image_size, strides)
        scaled = jnp.asarray(anchors_a, jnp.float32) * jnp.asarray(
            grid_sizes, jnp.float32
        ).reshape(-1, 1, 1)
        true = decode_scale(
            targets_fine, scaled[-1], grid_sizes[-1], is_pred=False
        )
        k = min(max_gt, true.shape[1])
        _, idx = jax.lax.top_k(true[..., 4], k)
        return jnp.take_along_axis(true, idx[..., None], axis=1)

    jmap = jax.jit(
        calc_map_device_batched, static_argnames=("iou_threshold", "num_classes")
    )

    kept_l, mask_l, true_l = [], [], []
    anchors_np = np.asarray(anchors, np.float32)
    for images, targets in loader:
        kept, mask = predictor.predict_batch(jnp.asarray(images))
        true = gt_step(
            jnp.asarray(targets[-1]), anchors_np, image_size=images.shape[1]
        )
        kept_l.append(kept)
        mask_l.append(mask)
        true_l.append(true)
    true_cat = jnp.concatenate(true_l)
    m = jmap(
        jnp.concatenate(kept_l).astype(jnp.float32),
        jnp.concatenate(mask_l),
        true_cat,
        true_cat[..., 4] > predictor.conf_threshold,
        iou_threshold=cfg.MAP_IOU_THRESHOLD,
        num_classes=num_classes,
    )
    return float(m)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="/tmp/conv_composed",
                    help="a convergence run's dataset/checkpoint root")
    ap.add_argument("--identifier", default="composed_r5")
    ap.add_argument("--backbone", default="darknet53")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=416)
    ap.add_argument("--num-workers", type=int, default=8)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from yolo_for_turbines_tpu import config as cfg
    from yolo_for_turbines_tpu.config import ModelConfig, TrainConfig
    from yolo_for_turbines_tpu.data.loader import get_loaders
    from yolo_for_turbines_tpu.inference import Predictor
    from yolo_for_turbines_tpu.models.yolov3 import YOLOv3
    from yolo_for_turbines_tpu.train.checkpoint import load_checkpoint
    from yolo_for_turbines_tpu.train.evaluate import evaluate_map_device
    from yolo_for_turbines_tpu.train.steps import create_train_state

    root = Path(args.root)
    ckpt = root / "models" / f"best_model_{args.identifier}.ckpt"
    if not ckpt.exists():
        raise SystemExit(f"no checkpoint at {ckpt} — run the convergence "
                         "driver first")
    anchors_json = root / "anchors.json"
    anchors = (
        np.asarray(json.loads(anchors_json.read_text())["anchors"], np.float32)
        if anchors_json.exists()
        else np.asarray(cfg.TURBINE_ANCHORS, np.float32)
    )

    model = YOLOv3(
        ModelConfig(num_classes=cfg.NUM_TURBINE_CLASSES, activation="mish",
                    backbone=args.backbone)
    )
    state, _, _ = create_train_state(
        model, TrainConfig(), rng=jax.random.PRNGKey(0)
    )
    state = load_checkpoint(state, ckpt)

    train_loader, val_loader, _ = get_loaders(
        root,
        batch_size=args.batch_size,
        anchors=anchors,
        train=True,
        image_folder=root / "images",
        annotation_folder=root / "labels",
        num_workers=args.num_workers,
        image_size=args.image_size,
        cache_images=True,
    )

    # 1. the trainer's own eval path (cross-check vs the run's reported mAP)
    t0 = time.time()
    map_apply = evaluate_map_device(
        val_loader, model, state, anchors, num_classes=cfg.NUM_TURBINE_CLASSES
    )
    print(json.dumps({"path": "apply_train_mode", "mAP": round(map_apply, 4),
                      "wall_s": round(time.time() - t0, 1)}), flush=True)

    # 2. folded-BN bf16 serving path
    folded = model.fold(state.params, state.batch_stats)
    pred_bf16 = Predictor(
        model, folded, anchors=anchors, image_size=args.image_size
    )
    t0 = time.time()
    map_folded = eval_map_via_predictor(
        pred_bf16, val_loader, anchors, cfg.NUM_TURBINE_CLASSES
    )
    print(json.dumps({"path": "folded_bf16", "mAP": round(map_folded, 4),
                      "wall_s": round(time.time() - t0, 1)}), flush=True)

    # 3. int8 PTQ, calibrated on one train batch
    calib, _ = next(iter(train_loader))
    pred_int8 = Predictor(
        model, folded, anchors=anchors, image_size=args.image_size
    ).quantize(jnp.asarray(calib))
    t0 = time.time()
    map_int8 = eval_map_via_predictor(
        pred_int8, val_loader, anchors, cfg.NUM_TURBINE_CLASSES
    )
    print(json.dumps({"path": "int8_ptq", "mAP": round(map_int8, 4),
                      "wall_s": round(time.time() - t0, 1)}), flush=True)

    print(json.dumps({
        "checkpoint": str(ckpt),
        "anchors_source": str(anchors_json) if anchors_json.exists()
        else "default TURBINE_ANCHORS",
        "mAP_apply": round(map_apply, 4),
        "mAP_folded_bf16": round(map_folded, 4),
        "mAP_int8_ptq": round(map_int8, 4),
        "int8_delta_vs_folded": round(map_int8 - map_folded, 4),
    }))


if __name__ == "__main__":
    main()
