"""Typed configuration for the YOLO-for-Turbines framework.

Mirrors the knob names and default semantics of the reference's config-as-module
(reference: code/config.py:10-58,116-201) but as frozen dataclasses so configs are
hashable, serializable, and safe to close over in jitted functions.

Design notes:
- No global mutable state: everything that affects a compiled function is carried
  in a hashable dataclass so jit caching works per-configuration.
- Anchors are plain nested tuples (hashable); convert with `anchors_array()`.
- Multi-scale training uses a fixed bucket list (reference: code/config.py:43-45)
  so there is exactly one compiled step per bucket -- no recompilation storms.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Constants matching the reference defaults
# ---------------------------------------------------------------------------

DEF_IMAGE_SIZE = 416  # reference: code/config.py:37
MIN_BOX_SIZE = 16 / DEF_IMAGE_SIZE  # reference: code/config.py:38 (kept, unused there)

MAP_IOU_THRESHOLD = 0.5  # reference: code/config.py:18
CONF_THRESHOLD = 0.5  # reference: code/config.py:19
NMS_IOU_THRESHOLD = 0.45  # reference: code/config.py:20

# reference: code/config.py:43-45
MULTI_SCALE_TRAIN_SIZES = (416, 448, 480, 512, 544, 576, 608)

# Normalized (w, h) anchors per scale, large scale (stride 32) first.
# reference: code/config.py:47-51
ANCHORS = (
    ((0.28, 0.22), (0.38, 0.48), (0.9, 0.78)),
    ((0.07, 0.15), (0.15, 0.11), (0.14, 0.29)),
    ((0.02, 0.03), (0.04, 0.07), (0.08, 0.06)),
)

# reference: code/config.py:53-57
TURBINE_ANCHORS = (
    ((0.215, 0.461), (0.992, 0.349), (0.436, 0.952)),
    ((0.06, 0.143), (0.143, 0.189), (0.408, 0.181)),
    ((0.016, 0.0349), (0.0408, 0.0598), (0.110, 0.0777)),
)

# Official yolov3-tiny anchors (pixel values / 416), 2 scales x 3 anchors,
# coarse (stride 32) scale first.
TINY_ANCHORS = (
    ((81 / 416, 82 / 416), (135 / 416, 169 / 416), (344 / 416, 319 / 416)),
    ((10 / 416, 14 / 416), (23 / 416, 27 / 416), (37 / 416, 58 / 416)),
)

GRID_SIZES = (DEF_IMAGE_SIZE // 32, DEF_IMAGE_SIZE // 16, DEF_IMAGE_SIZE // 8)

STRIDES = (32, 16, 8)

TURBINE_LABELS = ("dirt", "damage")  # reference: code/config.py:116
NUM_TURBINE_CLASSES = len(TURBINE_LABELS)

# reference: code/config.py:119-200
COCO_LABELS = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)
NUM_COCO_CLASSES = len(COCO_LABELS)


def grid_sizes_for(image_size: int, strides: Sequence[int] = STRIDES) -> tuple:
    """Grid sizes for the detection scales at a given image size."""
    return tuple(image_size // s for s in strides)


def anchors_array(anchors=ANCHORS) -> np.ndarray:
    """Anchors as a (3, 3, 2) float32 array (scale, anchor, wh), normalized."""
    return np.asarray(anchors, dtype=np.float32)


def scaled_anchors_array(anchors, image_size: int = DEF_IMAGE_SIZE) -> np.ndarray:
    """Anchors scaled by their grid size, shape (3, 3, 2).

    Matches the reference's `scaled_anchors` (reference: code/train.py:195-197):
    anchor (normalized to image) * grid_size so widths/heights are in cell units.
    """
    a = anchors_array(anchors)
    gs = np.asarray(grid_sizes_for(image_size), dtype=np.float32)
    return a * gs[:, None, None]


# ---------------------------------------------------------------------------
# Paths
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Paths:
    """Filesystem layout (reference: code/config.py:22-33)."""

    project: str = "."

    @property
    def image_folder(self) -> Path:
        return Path(self.project) / "data" / "images"

    @property
    def annotation_folder(self) -> Path:
        return Path(self.project) / "data" / "labels"

    @property
    def weights_folder(self) -> Path:
        return Path(self.project) / "weights"

    @property
    def model_folder(self) -> Path:
        return Path(self.project) / "models"

    @property
    def csv_folder(self) -> Path:
        return Path(self.project) / "data"

    @property
    def coco_weights(self) -> Path:
        return self.weights_folder / "yolov3.weights"

    @property
    def darknet_weights(self) -> Path:
        return self.weights_folder / "darknet53.conv.74"


# ---------------------------------------------------------------------------
# Model / training / eval configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture knobs (reference: code/model.py:151-170)."""

    num_classes: int = NUM_COCO_CLASSES
    in_channels: int = 3
    activation: str = "leaky_relu"  # or "mish"
    backbone: str = "darknet53"  # or "cspdarknet53"
    anchors_per_scale: int = 3
    # Output stride per detection scale, coarsest first. YOLOv3 has three
    # scales; yolov3_tiny two (32, 16).
    strides: tuple = (32, 16, 8)
    # Optional custom architecture through the same declarative layer DSL
    # (tuple of entries; overrides the backbone choice when set). Hashable so
    # the config stays jit-cache-safe.
    layer_config: Optional[tuple] = None
    # Run the TRAIN-mode stem in space-to-depth layout (models/s2d.py):
    # arithmetically identical, wider channels on the 3-64-channel entry
    # layers. Applies when the plan prefix matches and H, W are divisible by
    # 4; harmless no-op otherwise. Folded inference always keeps the plain
    # stem (see models/yolov3.py::apply_inference).
    s2d_stem: bool = True

    @property
    def channels_per_anchor(self) -> int:
        return self.num_classes + 5


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    conf_threshold: float = CONF_THRESHOLD
    nms_iou_threshold: float = NMS_IOU_THRESHOLD
    map_iou_threshold: float = MAP_IOU_THRESHOLD
    max_boxes: int = 256  # fixed NMS capacity per image (padded/masked)
    box_format: str = "center"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters; keys mirror the reference HPO config
    (reference: code/train.py:171-202,298-301)."""

    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    batch_size: int = 32
    max_num_steps: int = 10000
    warmup: float = 0.01  # fraction of max_num_steps spent in linear warmup
    activation: str = "mish"
    image_size: int = DEF_IMAGE_SIZE
    multi_scale: bool = True
    mosaic: bool = False  # reference: code/config.py:36
    # RAM-cache decoded train/val images across epochs (beyond-reference;
    # skips the dominant JPEG-decode cost on few-core hosts)
    cache_images: bool = False
    freeze_backbone: bool = False  # reference: code/config.py:35
    load_weights: bool = False  # reference: code/config.py:34
    load_checkpoint: bool = False  # reference: code/config.py:16
    warmup_enabled: bool = True  # reference: code/config.py:40 (WARMUP)
    decay_lr: bool = False  # reference: code/config.py:41
    num_batch_to_resize: int = 10  # reference: code/dataset.py:27, train.py:45
    ignore_iou_threshold: float = 0.5  # reference: code/dataset.py:51
    seed: int = 424242  # reference: code/utils.py:850
    compute_dtype: str = "bfloat16"  # bf16 mixed precision (no GradScaler)
    # mAP eval entirely on device (ops.map.calc_map_device_batched, bucketed
    # by image so memory is O(images*K*G)); host path (False) runs the same
    # semantics in numpy and is easier to debug
    device_eval: bool = True

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "TrainConfig":
        d = json.loads(s)
        fields = {f.name for f in dataclasses.fields(TrainConfig)}
        return TrainConfig(**{k: v for k, v in d.items() if k in fields})


def load_hyperparam_config(model_folder, config_name: str) -> dict:
    """Read a best_config.json produced by HPO (reference: code/train.py:286-289)."""
    with open(Path(model_folder) / config_name, "r") as f:
        payload = json.load(f)
    return payload["config"] if "config" in payload else payload
