"""High-resolution inference quality anchor: 416 vs 608 vs 832 eval mAP on
a SMALL-DEFECT synthetic set (the motivation is recorded in
parallel/spatial.py:5-12).

The reference's demo letterboxes every upload down to one 416px tile
(reference: code/demo.py:37-39), throwing away the resolution small surface
defects live in. This driver quantifies what that costs:

1. generate a synthetic set of 1280x960 "inspection photos" whose defects
   are 2-4.5% of the short side (19-43 px at source; ~6-14 px after a 416
   letterbox, ~12-28 px at 832) -- data/synthetic.py `box_frac`;
2. k-means++ anchors from its own labels (tools/anchors.py -- tiny boxes
   need tiny anchors, same workflow as the reference's notebook);
3. train the standard recipe on the card (multi-scale 416-608 buckets,
   warmup + cosine, early stop);
4. evaluate the SAME best checkpoint at 416 / 608 / 832 through the
   bucketed eval pipeline (one compiled program per size) and report the
   per-size val mAP@0.5.

Fully convolutional model: 832 is a shape change, not a new network. The
832 bucket is the single-card anchor for the spatial-partitioning story --
where one card can't hold the activations, parallel/spatial.py shards rows
over the mesh instead.

Usage (on a GPU host):
  python benchmarks/hires_eval.py --max-num-steps 700
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="/tmp/hires")
    ap.add_argument("--num-images", type=int, default=416)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--max-num-steps", type=int, default=700)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--identifier", default="hires_r5")
    ap.add_argument("--eval-sizes", default="416,608,832")
    ap.add_argument("--num-workers", type=int, default=8)
    ap.add_argument("--skip-train", action="store_true",
                    help="reuse an existing checkpoint, eval only")
    ap.add_argument("--finetune-size", type=int, default=0,
                    help="after (or instead of) the base train, fine-tune "
                         "the checkpoint at this FIXED resolution and eval "
                         "the fine-tuned model per size. Round-5 finding: "
                         "eval resolution only pays inside the trained "
                         "scale range (416-608 buckets: 0.567@416 -> "
                         "0.811@608 but 0.192@832); 2x extrapolation needs "
                         "the target size in training")
    ap.add_argument("--finetune-total-steps", type=int, default=2020,
                    help="max_num_steps for the fine-tune run; the restored "
                         "checkpoint resumes at its own step (~700), so the "
                         "fine-tune gets total minus that. 2020 at bs=8 on "
                         "the 354-image train split is ~30 epochs -> 3 mAP "
                         "evals (the trainer evals every 10th epoch)")
    ap.add_argument("--finetune-lr", type=float, default=1e-4)
    ap.add_argument("--finetune-batch-size", type=int, default=8,
                    help="832px at bs=8 is the same pixel volume per step "
                         "as 416px at bs=32")
    args = ap.parse_args()

    import numpy as np

    from yolo_for_turbines_tpu.config import ModelConfig, TrainConfig
    from yolo_for_turbines_tpu.data.splits import create_csv_files
    from yolo_for_turbines_tpu.data.synthetic import generate_synthetic_dataset
    from yolo_for_turbines_tpu.tools.anchors import (
        group_by_scale,
        kmeans_anchors,
        load_wh_boxes,
    )
    from yolo_for_turbines_tpu.train.trainer import train

    root = Path(args.root)
    if not (root / "train.csv").exists():
        print("generating small-defect synthetic dataset ...", flush=True)
        generate_synthetic_dataset(
            root,
            num_images=args.num_images,
            image_size=(1280, 960),
            max_objects=6,
            box_frac=(0.02, 0.045),
        )
        create_csv_files(
            root / "images", root / "labels", root,
            {"train": 0.85, "val": 0.15}, image_ext=".jpg",
        )

    whs = load_wh_boxes(root / "labels")
    centroids, mean_iou = kmeans_anchors(whs, k=9)
    anchors = np.asarray(group_by_scale(centroids), np.float32)
    print(json.dumps({
        "kmeans_mean_iou": round(mean_iou, 4),
        "num_boxes": int(len(whs)),
        "anchors": anchors.tolist(),
    }), flush=True)

    tc = TrainConfig(
        lr=args.lr,
        batch_size=args.batch_size,
        max_num_steps=args.max_num_steps,
        multi_scale=True,
        cache_images=True,
        decay_lr=True,
        warmup=0.05,
    )
    model_dir = root / "models"
    model_dir.mkdir(parents=True, exist_ok=True)
    ckpt = model_dir / f"best_model_{args.identifier}.ckpt"

    wall = 0.0
    best = None
    if not args.skip_train:
        t0 = time.time()
        best = train(
            tc,
            root,
            model_dir,
            identifier=args.identifier,
            early_stop=30,
            checkpoint_name=ckpt.name,
            image_folder=root / "images",
            annotation_folder=root / "labels",
            num_workers=args.num_workers,
            anchors=anchors,
        )
        wall = time.time() - t0
        print(json.dumps({"train_best_mAP_at_416": best,
                          "train_wall_s": round(wall, 1)}), flush=True)

    # ---- optional fixed-resolution fine-tune from the checkpoint ----
    ft_best = None
    if args.finetune_size:
        if not args.skip_train:
            # host RSS was seen to grow per train step with base-train + ft
            # in ONE process until the host ran out of memory; run the two
            # stages as two invocations: the base train first, then
            # --skip-train --finetune-size N.
            print(json.dumps({
                "warning": "base train + fine-tune in one process: host RSS "
                           "can grow per step until the host runs out of "
                           "memory; prefer a second invocation with "
                           "--skip-train"
            }), flush=True)
        tc_ft = TrainConfig(
            lr=args.finetune_lr,
            batch_size=args.finetune_batch_size,
            max_num_steps=args.finetune_total_steps,
            multi_scale=False,
            image_size=args.finetune_size,
            cache_images=True,
            load_checkpoint=True,
        )
        ft_id = f"{args.identifier}_ft{args.finetune_size}"
        t0 = time.time()
        ft_best = train(
            tc_ft,
            root,
            model_dir,
            identifier=ft_id,
            early_stop=30,
            checkpoint_name=ckpt.name,  # RESTORE source; best saved to ft_id
            image_folder=root / "images",
            annotation_folder=root / "labels",
            num_workers=args.num_workers,
            anchors=anchors,
        )
        ckpt = model_dir / f"best_model_{ft_id}.ckpt"
        print(json.dumps({
            "finetune_size": args.finetune_size,
            "finetune_best_mAP": ft_best,
            "finetune_wall_s": round(time.time() - t0, 1),
        }), flush=True)

    # ---- same checkpoint, bucketed eval at each size ----
    import jax

    from yolo_for_turbines_tpu.data.loader import get_loaders
    from yolo_for_turbines_tpu.models.yolov3 import YOLOv3
    from yolo_for_turbines_tpu.train.checkpoint import load_checkpoint
    from yolo_for_turbines_tpu.train.evaluate import evaluate_map_device
    from yolo_for_turbines_tpu.train.steps import create_train_state

    model = YOLOv3(ModelConfig(num_classes=2, activation=tc.activation))
    state, _, _ = create_train_state(model, tc, rng=jax.random.PRNGKey(0))
    state = load_checkpoint(state, ckpt)

    per_size = {}
    for size in (int(s) for s in args.eval_sizes.split(",")):
        _, val_loader, _ = get_loaders(
            root,
            batch_size=args.batch_size,
            anchors=anchors,
            train=True,
            image_folder=root / "images",
            annotation_folder=root / "labels",
            num_workers=args.num_workers,
            image_size=size,
        )
        t0 = time.time()
        m = evaluate_map_device(
            val_loader, model, state, anchors, num_classes=2
        )
        per_size[size] = round(m, 4)
        print(json.dumps({"eval_size": size, "val_mAP": per_size[size],
                          "eval_wall_s": round(time.time() - t0, 1)}),
              flush=True)

    print(json.dumps({
        "per_size_val_mAP": per_size,
        "train_best_mAP_at_416": best,
        "train_wall_s": round(wall, 1),
        "finetune_size": args.finetune_size or None,
        "finetune_best_mAP": ft_best,
        "checkpoint": str(ckpt),
        "anchors_source": "kmeans++ on run labels",
    }))


if __name__ == "__main__":
    main()
