"""Inference demo: CLI always; Streamlit app when streamlit is installed.

Reproduces the reference's Streamlit demo (reference: code/demo.py): load a
model, letterbox-preprocess an image, run the jitted
forward -> decode -> NMS pipeline, and plot class/score-labelled boxes on the
*original* image.

CLI:
    python -m yolo_for_turbines_tpu.tools.demo --weights weights/yolov3.weights \
        --image examples/Tram.jpg --out out.png
Trained-model serving (the reference demo's actual deployment: a fine-tuned
turbine model, code/demo.py:16-28 — there a pickled torch module, here an
orbax checkpoint + its k-means anchors):
    python -m yolo_for_turbines_tpu.tools.demo \
        --checkpoint models/best_model_x.ckpt --anchors anchors.json \
        --num-classes 2 --activation mish --image photo.jpg
Streamlit (optional):
    streamlit run yolo_for_turbines_tpu/tools/demo.py -- --weights ...
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
from PIL import Image

from .. import config as cfg
from ..inference import Predictor, load_predictor
from ..utils.plotting import plot_image_with_boxes
from ..utils.profiling import enable_compilation_cache


def predict(predictor: Predictor, np_image: np.ndarray, class_list):
    """One image -> (rows of (label, score), boxes in original frame)
    (reference: code/demo.py:30-66)."""
    boxes = predictor.predict_image(np_image)
    rows = [
        {"label": class_list[int(b[5])], "confidence": round(float(b[4]), 4)}
        for b in boxes
    ]
    return rows, boxes


def run_cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", help="official darknet binary")
    src.add_argument("--checkpoint",
                     help="orbax training checkpoint (trained turbine "
                          "model — the reference demo's deployment path, "
                          "code/demo.py:16-28)")
    ap.add_argument("--anchors", default=None,
                    help="anchors JSON from tools/anchors.py or a "
                         "convergence run; REQUIRED semantics for a "
                         "--checkpoint trained with custom k-means anchors "
                         "(defaults: COCO anchors for --weights, "
                         "TURBINE_ANCHORS for --checkpoint)")
    ap.add_argument("--backbone", default="darknet53",
                    choices=("darknet53", "cspdarknet53", "yolov3_tiny"))
    ap.add_argument("--image", required=True)
    ap.add_argument("--out", default="prediction.png")
    ap.add_argument("--num-classes", type=int, default=cfg.NUM_COCO_CLASSES)
    ap.add_argument("--activation", default="leaky_relu")
    ap.add_argument("--conf", type=float, default=cfg.CONF_THRESHOLD)
    ap.add_argument("--nms-iou", type=float, default=cfg.NMS_IOU_THRESHOLD)
    args = ap.parse_args(argv)

    enable_compilation_cache()
    model_path = args.weights or args.checkpoint
    for path_arg, what in ((model_path, "model"), (args.image, "image")):
        if not Path(path_arg).exists():
            print(f"error: {what} file not found: {path_arg}", file=sys.stderr)
            raise SystemExit(2)

    anchors = None
    if args.anchors:
        import json

        anchors = np.asarray(
            json.loads(Path(args.anchors).read_text())["anchors"], np.float32
        )

    class_list = (
        cfg.COCO_LABELS if args.num_classes == cfg.NUM_COCO_CLASSES
        else cfg.TURBINE_LABELS
    )
    if args.checkpoint:
        from ..inference import load_predictor_from_checkpoint

        predictor = load_predictor_from_checkpoint(
            args.checkpoint,
            num_classes=args.num_classes,
            activation=args.activation,
            anchors=anchors if anchors is not None else cfg.TURBINE_ANCHORS,
            conf_threshold=args.conf,
            nms_iou_threshold=args.nms_iou,
            backbone=args.backbone,
        )
    else:
        predictor = load_predictor(
            args.weights,
            num_classes=args.num_classes,
            activation=args.activation,
            anchors=anchors if anchors is not None else cfg.ANCHORS,
            conf_threshold=args.conf,
            nms_iou_threshold=args.nms_iou,
            backbone=args.backbone,
        )
    image = np.array(Image.open(args.image).convert("RGB"), dtype=np.uint8)
    rows, boxes = predict(predictor, image, class_list)
    for r in rows:
        print(f"{r['label']}: {r['confidence']}")
    rendered = plot_image_with_boxes(image, boxes, class_list)
    rendered.convert("RGB").save(args.out)
    print(f"Saved {args.out} ({len(boxes)} detections)")


def run_streamlit():  # pragma: no cover - requires streamlit
    import streamlit as st

    st.title("YOLOv3 Object Detection")
    weights = st.sidebar.text_input("Weights path", "weights/yolov3.weights")
    conf = st.sidebar.slider("Confidence", 0.0, 1.0, cfg.CONF_THRESHOLD)
    nms_iou = st.sidebar.slider("NMS IoU", 0.0, 1.0, cfg.NMS_IOU_THRESHOLD)

    @st.cache_resource
    def get_predictor(path, conf, nms_iou):
        return load_predictor(
            path, conf_threshold=conf, nms_iou_threshold=nms_iou
        )

    uploaded = st.file_uploader("Upload an image", type=["png", "jpg", "jpeg"])
    if uploaded is not None and Path(weights).exists():
        image = np.array(Image.open(uploaded).convert("RGB"), dtype=np.uint8)
        predictor = get_predictor(weights, conf, nms_iou)
        rows, boxes = predict(predictor, image, cfg.COCO_LABELS)
        st.image(
            plot_image_with_boxes(image, boxes, cfg.COCO_LABELS),
            caption=f"{len(boxes)} detections",
        )
        st.table(rows)


if __name__ == "__main__":
    if any("streamlit" in a for a in sys.argv[0:1]) and "--weights" not in sys.argv:
        run_streamlit()
    else:
        run_cli()
