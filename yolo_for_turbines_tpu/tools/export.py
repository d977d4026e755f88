"""CLI: package a trained detector as a serving bundle.

The deployment counterpart of the reference's pickled-model hand-off
(reference: code/demo.py:16-28): from an official darknet weight file or an
orbax training checkpoint, write a pickle-free bundle directory (manifest +
npz weights), optionally int8-quantized and/or with hermetic StableHLO
serve modules for chosen (batch, size) buckets.

    python -m yolo_for_turbines_tpu.tools.export \
        --weights weights/yolov3.weights --num-classes 80 --out bundle/ \
        --quantize-calib-dir images/ --export-batch 8 --export-batch 32

Serve it back with `serving.load_predictor_bundle(out)` (live Predictor) or
`serving.ExportedPredictor(out)` (StableHLO module only).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", help="official darknet .weights file")
    src.add_argument("--checkpoint", help="orbax training checkpoint dir")
    ap.add_argument("--out", required=True, help="bundle output directory")
    ap.add_argument("--num-classes", type=int, default=None)
    ap.add_argument("--activation", default=None)
    ap.add_argument("--backbone", default="darknet53")
    ap.add_argument("--anchors", choices=["coco", "turbine", "tiny"], default=None)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--conf-threshold", type=float, default=None)
    ap.add_argument("--nms-iou-threshold", type=float, default=None)
    ap.add_argument(
        "--quantize-calib-dir",
        help="directory of images for int8 PTQ calibration (up to "
        "--calib-images of them, letterboxed to the serve size)",
    )
    ap.add_argument("--calib-images", type=int, default=32)
    ap.add_argument(
        "--export-batch",
        type=int,
        action="append",
        default=[],
        help="also emit a StableHLO serve module for this batch size "
        "(repeatable)",
    )
    ap.add_argument(
        "--export-platforms",
        default="cpu,cuda",
        help="comma-separated jax.export lowering platforms",
    )
    args = ap.parse_args(argv)

    from .. import config as cfg
    from ..inference import load_predictor, load_predictor_from_checkpoint
    from ..serving import add_export_to_bundle, save_predictor

    anchor_tables = {
        "coco": cfg.ANCHORS,
        "turbine": cfg.TURBINE_ANCHORS,
        "tiny": cfg.TINY_ANCHORS,
    }
    kw = {}
    if args.image_size is not None:
        kw["image_size"] = args.image_size
    if args.conf_threshold is not None:
        kw["conf_threshold"] = args.conf_threshold
    if args.nms_iou_threshold is not None:
        kw["nms_iou_threshold"] = args.nms_iou_threshold
    if args.anchors is not None:
        kw["anchors"] = anchor_tables[args.anchors]

    if args.weights:
        if args.num_classes is not None:
            kw["num_classes"] = args.num_classes
        if args.activation is not None:
            kw["activation"] = args.activation
        pred = load_predictor(args.weights, backbone=args.backbone, **kw)
    else:
        if args.num_classes is not None:
            kw["num_classes"] = args.num_classes
        if args.activation is not None:
            kw["activation"] = args.activation
        pred = load_predictor_from_checkpoint(
            args.checkpoint, backbone=args.backbone, **kw
        )

    if args.quantize_calib_dir:
        import numpy as np
        from PIL import Image

        from ..native import batch_letterbox

        paths = sorted(Path(args.quantize_calib_dir).iterdir())[: args.calib_images]
        imgs = [np.asarray(Image.open(p).convert("RGB")) for p in paths]
        if not imgs:
            raise SystemExit(f"no images in {args.quantize_calib_dir}")
        calib = batch_letterbox(imgs, pred.image_size)
        pred.quantize(calib)

    out = save_predictor(pred, args.out)
    platforms = tuple(p for p in args.export_platforms.split(",") if p)
    for b in args.export_batch:
        blob = add_export_to_bundle(out, b, platforms=platforms)
        print(f"exported {blob}")
    print(f"bundle written to {out}")
    return out


if __name__ == "__main__":
    main()
