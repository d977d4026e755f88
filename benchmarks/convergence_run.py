"""Drive the FULL trainer to a converged mAP on an accelerator.

The one reference capability never previously demonstrated on-chip
(reference: code/train.py:158-239 trained to mAP 0.45, README.md:40): this
script runs `train()` end to end — multi-scale buckets, fused C++ augmenter
+ image cache, every-10th-epoch fused device eval, 25% checkpoints, early
stop — on a synthetic shape-detection dataset
(yolo_for_turbines_tpu/data/synthetic.py) until mAP converges, and supports
a mid-run resume from the written checkpoint to prove checkpoint/resume on
hardware.

Usage (on a GPU host):
  python benchmarks/convergence_run.py --max-num-steps 1650          # run 1
  python benchmarks/convergence_run.py --max-num-steps 3300 --resume # run 2

The reference's FULL default recipe as one composition (BASELINE config #3:
k-means custom anchors + darknet backbone import + mosaic + multi-scale +
warmup, reference: code/train.py:166-197, code/config.py:34-57):
  python benchmarks/convergence_run.py --kmeans-anchors --load-weights \
      --mosaic --decay-lr --max-num-steps 700

CSPDarknet53 (the reference README's roadmap goal, reference: README.md:40):
  python benchmarks/convergence_run.py --backbone cspdarknet53 --mosaic \
      --no-multi-scale --decay-lr --max-num-steps 550

Prints the mAP trajectory parsed from the metrics JSONL at the end.
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
    ap.add_argument("--root", default="/tmp/convergence")
    ap.add_argument("--num-images", type=int, default=416)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--max-num-steps", type=int, default=3300)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--identifier", default="conv_r3")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the run's best checkpoint")
    ap.add_argument("--no-multi-scale", action="store_true")
    ap.add_argument("--warmup", type=float, default=0.05,
                    help="warmup fraction of max_num_steps (the default "
                         "TrainConfig 0.01 is ~9 steps at 900 total; "
                         "lr=1e-3 needs a few epochs of warmup from "
                         "random init)")
    ap.add_argument("--decay-lr", action="store_true",
                    help="warmup + cosine decay (stabilizes late epochs; "
                         "constant post-warmup lr=1e-3 oscillates on the "
                         "354-image overfit)")
    ap.add_argument("--mosaic", action="store_true")
    ap.add_argument("--backbone", default="darknet53",
                    choices=("darknet53", "cspdarknet53"),
                    help="cspdarknet53 is the reference README's own "
                         "roadmap goal (reference: README.md:40, 'mAP "
                         ">= 0.60 with CSPDarknet53')")
    ap.add_argument("--anchors", default=None,
                    help="path to a tools/anchors.py JSON payload; the run "
                         "then consumes CUSTOM k-means anchors for target "
                         "assignment AND loss scaling, exactly as the "
                         "reference consumes TURBINE_ANCHORS (reference: "
                         "code/config.py:53-57, code/train.py:193-197)")
    ap.add_argument("--kmeans-anchors", action="store_true",
                    help="run the k-means++ anchor generator "
                         "(tools/anchors.py) on this run's own label dir "
                         "and train with the result -- the reference's "
                         "full anchor workflow (notebook -> config -> "
                         "train) as one composition")
    ap.add_argument("--load-weights", action="store_true",
                    help="import the (synthetic) darknet53.conv.74 "
                         "backbone WITHOUT freezing (reference default "
                         "recipe builds the model with weights_path, "
                         "code/train.py:166-169)")
    ap.add_argument("--freeze-backbone", action="store_true",
                    help="the reference's PRIMARY recipe (code/train.py:"
                         "166-177): import a darknet53.conv.74 backbone "
                         "(synthetic here — zero egress) and fine-tune with "
                         "the backbone frozen; after training, asserts every "
                         "frozen leaf is BITWISE unchanged in the written "
                         "checkpoint")
    ap.add_argument("--early-stop", type=int, default=30)
    ap.add_argument("--num-workers", type=int, default=8)
    args = ap.parse_args()

    from yolo_for_turbines_tpu.config import ModelConfig, TrainConfig
    from yolo_for_turbines_tpu.data.splits import create_csv_files
    from yolo_for_turbines_tpu.data.synthetic import generate_synthetic_dataset
    from yolo_for_turbines_tpu.train.trainer import train

    root = Path(args.root)
    if not (root / "train.csv").exists():
        print("generating synthetic dataset ...", flush=True)
        generate_synthetic_dataset(root, num_images=args.num_images)
        create_csv_files(
            root / "images", root / "labels", root,
            {"train": 0.85, "val": 0.15}, image_ext=".jpg",
        )

    load_weights = args.load_weights or args.freeze_backbone
    tc = TrainConfig(
        lr=args.lr,
        batch_size=args.batch_size,
        max_num_steps=args.max_num_steps,
        multi_scale=not args.no_multi_scale,
        mosaic=args.mosaic,
        cache_images=True,
        load_checkpoint=args.resume,
        decay_lr=args.decay_lr,
        warmup=args.warmup,
        load_weights=load_weights,
        freeze_backbone=args.freeze_backbone,
    )
    model_dir = root / "models"
    model_dir.mkdir(parents=True, exist_ok=True)

    # ---- anchors: default COCO-derived TURBINE_ANCHORS, a JSON payload,
    # or freshly k-means++'d from this run's own labels ----
    import numpy as np

    from yolo_for_turbines_tpu import config as cfg
    anchors = np.asarray(cfg.TURBINE_ANCHORS, np.float32)
    anchor_meta = {"anchors_source": "default TURBINE_ANCHORS"}
    if args.kmeans_anchors:
        from yolo_for_turbines_tpu.tools.anchors import (
            group_by_scale,
            kmeans_anchors,
            load_wh_boxes,
        )

        whs = load_wh_boxes(root / "labels")
        centroids, mean_iou = kmeans_anchors(whs, k=9)
        anchors = np.asarray(group_by_scale(centroids), np.float32)
        anchor_meta = {
            "anchors_source": "kmeans++ on run labels",
            "kmeans_mean_iou": round(mean_iou, 4),
            "kmeans_num_boxes": int(len(whs)),
        }
        anchors_json = root / "anchors.json"
        anchors_json.write_text(json.dumps({"anchors": anchors.tolist()}))
    elif args.anchors:
        payload = json.loads(Path(args.anchors).read_text())
        anchors = np.asarray(payload["anchors"], np.float32)
        anchor_meta = {"anchors_source": args.anchors}
    if anchor_meta["anchors_source"] != "default TURBINE_ANCHORS":
        # prove the custom anchors actually reach target assignment (the
        # same anchors also scale the loss via Trainer.scaled_anchors_for
        # by construction): encode real boxes from this dataset and
        # independently recompute the expected best-anchor slot
        anchor_meta.update(_assert_custom_anchor_assignment(anchors, root))

    weights_path = None
    if load_weights:
        if args.backbone != "darknet53":
            raise SystemExit(
                "--load-weights/--freeze-backbone import a darknet53."
                "conv.74 backbone; the reference has no CSP weight file"
            )
        # synthetic stand-in for the official darknet53.conv.74 (egress-
        # blocked): export a deterministic init through the darknet binary
        # format; the loader parses the .conv.74 cutoff from the filename
        # exactly as for the official file (code/model.py:169-170)
        import jax

        from yolo_for_turbines_tpu.models.darknet_weights import (
            export_darknet_weights,
        )
        from yolo_for_turbines_tpu.models.yolov3 import YOLOv3

        weights_path = root / "backbone.conv.74"
        if not weights_path.exists():
            m = YOLOv3(ModelConfig(num_classes=2, activation="mish"))
            p, s = m.init(jax.random.PRNGKey(7))
            # bulk-fetch the tree in ONE device_get (async copies, one
            # barrier) — the exporter converts leaves one at a time
            p, s = jax.device_get((p, s))
            export_darknet_weights(m.plan, p, s, str(weights_path))
            print(f"exported synthetic backbone {weights_path}", flush=True)

    t0 = time.time()
    best = train(
        tc,
        root,
        model_dir,
        identifier=args.identifier,
        early_stop=args.early_stop,
        checkpoint_name=f"best_model_{args.identifier}.ckpt",
        image_folder=root / "images",
        annotation_folder=root / "labels",
        num_workers=args.num_workers,
        weights_path=weights_path,
        anchors=anchors,
        backbone=args.backbone,
    )
    wall = time.time() - t0

    frozen_ok = None
    if args.freeze_backbone:
        frozen_ok = _check_frozen_leaves(
            tc, weights_path,
            model_dir / f"best_model_{args.identifier}.ckpt",
        )

    metrics_file = (
        model_dir / f"YOLOv3_Turbine_Detection_{args.identifier}_metrics.jsonl"
    )
    traj = []
    if metrics_file.exists():
        for line in open(metrics_file):
            row = json.loads(line)
            if "mAP" in row:
                traj.append(row["mAP"])
    out = {
        "best_mAP": best,
        "mAP_trajectory": [round(m, 4) for m in traj],
        "wall_clock_s": round(wall, 1),
        "steps": args.max_num_steps,
        "resumed": args.resume,
        "mosaic": args.mosaic,
        "multi_scale": not args.no_multi_scale,
        "backbone": args.backbone,
        "load_weights": load_weights,
        "anchors": anchors.tolist(),
        **anchor_meta,
    }
    if frozen_ok is not None:
        out["frozen_leaves_bitwise_unchanged"] = frozen_ok
    print(json.dumps(out))


def _assert_custom_anchor_assignment(anchors, root) -> dict:
    """Prove custom anchors reached the target encoder, two ways:

    1. spot-check: for the FIRST box of each of the first 8 label files,
       independently recompute argmax wh-IoU over the 9 custom anchors
       (tools.anchors.iou_wh -- a different implementation than the
       dataset's) and assert assign_targets placed obj=1 in exactly that
       (scale, anchor, cell) slot (the first box always wins its best
       anchor: nothing is taken yet).
    2. divergence: assert the per-slot obj masks differ somewhere from the
       default-TURBINE_ANCHORS encoding across those files (custom anchors
       must CHANGE the assignment, or the composition proves nothing).
    """
    import numpy as np

    from yolo_for_turbines_tpu import config as cfg
    from yolo_for_turbines_tpu.data.dataset import assign_targets
    from yolo_for_turbines_tpu.tools.anchors import iou_wh

    flat = np.asarray(anchors, np.float64).reshape(-1, 2)
    flat_default = np.asarray(cfg.TURBINE_ANCHORS, np.float64).reshape(-1, 2)
    grid_sizes = (13, 26, 52)
    n_checked, diverged = 0, False
    for lbl in sorted((root / "labels").glob("*.txt"))[:8]:
        rows = np.loadtxt(lbl)
        rows = rows.reshape(1, -1) if rows.ndim == 1 else rows
        boxes = np.roll(rows, shift=4, axis=1)
        tgts = assign_targets(boxes, flat, grid_sizes)
        x, y, w, h, _ = boxes[0]
        best = int(np.argmax(iou_wh(np.asarray([[w, h]]), flat)[0]))
        sc, ai = best // 3, best % 3
        s = grid_sizes[sc]
        i, j = min(int(s * y), s - 1), min(int(s * x), s - 1)
        assert tgts[sc][ai, i, j, 4] == 1, (
            f"{lbl.name}: best custom anchor {best} (scale {sc} slot {ai} "
            f"cell {i},{j}) did not receive box 0"
        )
        n_checked += 1
        tgts_default = assign_targets(boxes, flat_default, grid_sizes)
        diverged = diverged or any(
            not np.array_equal(a[..., 4], b[..., 4])
            for a, b in zip(tgts, tgts_default)
        )
    assert n_checked > 0, "no label files to check"
    assert diverged, (
        "custom anchors produced identical assignments to the defaults on "
        "every checked file -- the composition would prove nothing"
    )
    print(
        f"custom-anchor assignment verified: {n_checked} files spot-checked, "
        "assignment diverges from default anchors", flush=True,
    )
    return {"anchor_assignment_spot_checks": n_checked,
            "anchor_assignment_diverges_from_default": True}


def _check_frozen_leaves(tc, weights_path, ckpt_path) -> bool:
    """Assert every frozen backbone leaf in the trained checkpoint is
    bitwise identical to the value loaded from the weight file."""
    import jax
    import numpy as np

    from yolo_for_turbines_tpu.config import ModelConfig
    from yolo_for_turbines_tpu.models.darknet_weights import (
        load_darknet_weights,
    )
    from yolo_for_turbines_tpu.models.yolov3 import YOLOv3
    from yolo_for_turbines_tpu.train.checkpoint import load_checkpoint
    from yolo_for_turbines_tpu.train.steps import create_train_state

    model = YOLOv3(ModelConfig(num_classes=2, activation=tc.activation))
    # a DIFFERENT init seed than any training run used: unloaded leaves
    # cannot spuriously match, loaded-and-frozen ones must
    p0, s0 = model.init(jax.random.PRNGKey(1234))
    params_ref, stats_ref, frozen, _ = load_darknet_weights(
        str(weights_path), model.plan, p0, s0, freeze=True
    )
    state, _, _ = create_train_state(
        model, tc, params=params_ref, batch_stats=stats_ref, frozen_mask=frozen
    )
    state = load_checkpoint(state, ckpt_path)

    ref_leaves = jax.tree_util.tree_leaves(params_ref)
    ckpt_leaves = jax.tree_util.tree_leaves(jax.device_get(state.params))
    mask_leaves = jax.tree_util.tree_leaves(frozen)
    assert len(ref_leaves) == len(ckpt_leaves) == len(mask_leaves)
    n_frozen = 0
    for ref, got, m in zip(ref_leaves, ckpt_leaves, mask_leaves):
        if not m:
            continue
        n_frozen += 1
        if not np.array_equal(np.asarray(ref), np.asarray(got)):
            print(f"FROZEN LEAF CHANGED: shape {np.asarray(ref).shape}",
                  flush=True)
            return False
    assert n_frozen > 0, "freeze mask is empty — nothing was frozen"
    print(f"{n_frozen} frozen leaves bitwise unchanged", flush=True)
    return True


if __name__ == "__main__":
    main()
