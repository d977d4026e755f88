"""YOLO dataset: CSV-driven splits, augmentation, anchor-target assignment.

Mirrors the reference's YOLODataset (reference: code/dataset.py:19-167) with
the same assignment algorithm, as a plain host-side numpy producer (the
accelerator consumes batches via the prefetching loader):

- split CSVs hold (image_name, label_name) rows; label-less rows are
  negative images that get image-only transforms.
- labels are txt rows [class, cx, cy, w, h] rolled to [cx, cy, w, h, class]
  (reference: code/dataset.py:66-73).
- per box: rank all 9 anchors by wh-IoU descending; assign the best *free*
  anchor per scale (cell = (int(S*y), int(S*x))), storing
  [x_cell, y_cell, w*S, h*S, 1, class]; mark obj=-1 "ignore" for non-best
  anchors with IoU > 0.5 whose cell slot is free
  (reference: code/dataset.py:129-161, threshold code/dataset.py:51).
- multi-scale: `change_scale()` re-buckets image size to one of
  MULTI_SCALE_TRAIN_SIZES; the trainer calls it every N batches and jits one
  step per bucket (no recompilation storms).

Images are returned HWC float32 (NHWC layout; the reference returns CHW).
"""

from __future__ import annotations

import csv
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import config as cfg
from ..ops.iou import iou_aligned  # jnp, but works on numpy via asarray
from .augment import Transform, set_only_image_transforms, set_train_transforms
from .mosaic import mosaic_augmentation


def _iou_wh(box_wh: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """Numpy wh-IoU (center-aligned), same math as ops.iou.iou_aligned."""
    inter = np.minimum(box_wh[0], anchors[:, 0]) * np.minimum(box_wh[1], anchors[:, 1])
    union = box_wh[0] * box_wh[1] + anchors[:, 0] * anchors[:, 1] - inter
    return inter / union


def assign_targets(
    boxes: Sequence[Sequence[float]],
    anchors: np.ndarray,
    grid_sizes: Sequence[int],
    ignore_iou_threshold: float = 0.5,
) -> List[np.ndarray]:
    """Encode yolo boxes into per-scale target grids.

    Args:
        boxes: (M, 5) normalized [cx, cy, w, h, class].
        anchors: (9, 2) normalized anchors, scales concatenated
            (stride-32 anchors first, parity with reference
            code/dataset.py:38).
        grid_sizes: (S0, S1, S2).
        ignore_iou_threshold: non-best anchors above this get obj=-1.

    Returns:
        list of 3 float32 arrays (3, S, S, 6): [x_cell, y_cell, w_cell,
        h_cell, obj, class].
    """
    num_per_scale = len(anchors) // len(grid_sizes)
    targets = [np.zeros((num_per_scale, s, s, 6), np.float32) for s in grid_sizes]
    for box in boxes:
        x, y, w, h, class_label = box
        ious = _iou_wh(np.asarray([w, h], np.float64), anchors)
        anchor_indices = np.argsort(-ious, kind="stable")
        has_anchor = [False] * len(grid_sizes)
        for anchor_idx in anchor_indices:
            scale_idx = int(anchor_idx) // num_per_scale
            anchor_for_scale = int(anchor_idx) % num_per_scale
            s = grid_sizes[scale_idx]
            i, j = int(s * y), int(s * x)
            i, j = min(i, s - 1), min(j, s - 1)  # guard cx/cy == 1.0 edge
            anchor_taken = targets[scale_idx][anchor_for_scale, i, j, 4]
            if not anchor_taken and not has_anchor[scale_idx]:
                x_cell, y_cell = s * x - j, s * y - i
                targets[scale_idx][anchor_for_scale, i, j, :4] = (
                    x_cell,
                    y_cell,
                    w * s,
                    h * s,
                )
                targets[scale_idx][anchor_for_scale, i, j, 4] = 1
                targets[scale_idx][anchor_for_scale, i, j, 5] = int(class_label)
                has_anchor[scale_idx] = True
            elif not anchor_taken and ious[anchor_idx] > ignore_iou_threshold:
                targets[scale_idx][anchor_for_scale, i, j, 4] = -1
    return targets


class YOLODataset:
    """Map-style dataset over a split CSV (constructor parity with
    reference code/dataset.py:20-51)."""

    def __init__(
        self,
        csv_split_file,
        img_folder,
        annotation_folder,
        anchors,
        batch_size: int = 32,
        num_batch_to_resize: int = 10,
        image_size: int = cfg.DEF_IMAGE_SIZE,
        grid_sizes: Sequence[int] = (13, 26, 52),
        num_classes: int = 80,
        transform: Optional[Transform] = None,
        mosaic: bool = False,
        multi_scale: bool = False,
        seed: int = 0,
        cache_images: bool = False,
        cache_images_bytes: Optional[int] = 4 << 30,
    ):
        self.annotations = self._read_csv(csv_split_file)
        self.img_folder = Path(img_folder)
        self.annotation_folder = Path(annotation_folder)
        # scales concatenated: (9, 2), stride-32 anchors first
        self.anchors = np.asarray(anchors, np.float64).reshape(-1, 2)
        self.num_anchors = len(self.anchors)
        self.num_scales = len(list(grid_sizes))
        self.num_anchors_per_scale = self.num_anchors // self.num_scales
        self.strides = tuple(image_size // g for g in grid_sizes)
        self.batch_size = batch_size
        self.num_batch_to_resize = num_batch_to_resize
        self.image_size = image_size
        self.grid_sizes = list(grid_sizes)
        self.num_classes = num_classes
        self.transform = transform
        self.mosaic = mosaic
        self.multi_scale = multi_scale
        self.ignore_iou_threshold = 0.5
        # Opt-in RAM cache of decoded images: JPEG decode is a large share
        # of the __getitem__ cost on a host with few cores, and pure waste
        # after the first epoch. ~0.9 MB per 640x480 image, and multi-scale
        # caches the decode drafted to the LARGEST bucket (so up-buckets
        # never upsample a degraded draft) — worst-case sizing is therefore at
        # max(MULTI_SCALE_TRAIN_SIZES), not image_size.
        # `cache_images_bytes` bounds the footprint: once the budget is hit
        # the cache stops inserting (no eviction — every epoch touches every
        # image uniformly, so LRU would only thrash) and logs one warning;
        # already-cached images keep their speedup, the rest decode per
        # epoch. None = unbounded (explicit caller opt-out).
        self.cache_images = cache_images
        self.cache_images_bytes = cache_images_bytes
        self._image_cache: dict = {}
        self._image_cache_nbytes = 0
        self._cache_full_warned = False
        self.rng = np.random.default_rng(seed)
        # numpy Generators are not thread-safe; loader worker threads draw
        # per-item child generators under this lock (same guarantee as torch
        # DataLoader workers: seeded, but interleaving-dependent)
        self._rng_lock = threading.Lock()

    def _item_rng(self) -> np.random.Generator:
        with self._rng_lock:
            return self.rng.spawn(1)[0]

    @staticmethod
    def _read_csv(path) -> List[Tuple[str, Optional[str]]]:
        rows = []
        with open(path, newline="") as f:
            for row in csv.reader(f):
                if not row:
                    continue
                img = row[0]
                lbl = row[1] if len(row) > 1 and row[1] not in ("", "None") else None
                rows.append((img, lbl))
        return rows

    def __len__(self) -> int:
        return len(self.annotations)

    def load_image(self, idx: int) -> np.ndarray:
        if self.cache_images:
            cached = self._image_cache.get(idx)
            if cached is not None:
                return cached
        from PIL import Image

        img_path = self.img_folder / self.annotations[idx][0]
        img = Image.open(img_path)
        # JPEG fast path: let libjpeg decode at 1/2..1/8 scale when the
        # image is much larger than the train size — it gets letterboxed
        # down anyway, and DCT-domain scaling is ~linear in output pixels.
        # No-op for PNG and for images already near target size; normalized
        # box labels are resolution-independent.
        draft = (
            max(cfg.MULTI_SCALE_TRAIN_SIZES)
            if self.cache_images and self.multi_scale
            else self.image_size
        )
        img.draft("RGB", (draft, draft))
        arr = np.array(img.convert("RGB"), dtype=np.uint8)
        if self.cache_images:
            budget = self.cache_images_bytes
            if budget is None or self._image_cache_nbytes + arr.nbytes <= budget:
                # plain dict store: GIL-atomic; a racing double-decode is
                # benign (the budget check is advisory under races — the
                # overshoot is bounded by num_workers images)
                self._image_cache[idx] = arr
                self._image_cache_nbytes += arr.nbytes
            elif not self._cache_full_warned:
                self._cache_full_warned = True
                import logging

                logging.getLogger(__name__).warning(
                    "image cache budget reached (%d bytes over %d images); "
                    "further images decode per epoch "
                    "(raise cache_images_bytes to cache the whole set)",
                    self._image_cache_nbytes,
                    len(self._image_cache),
                )
        return arr

    def load_boxes(self, label_path: Path) -> np.ndarray:
        boxes = np.loadtxt(label_path, delimiter=" ")
        if boxes.ndim == 1:
            boxes = boxes.reshape(1, -1)
        # [class, x, y, w, h] -> [x, y, w, h, class] (reference: np.roll shift=4)
        return np.roll(boxes, shift=4, axis=1)

    def change_scale(self) -> None:
        """Re-bucket to a random multi-scale size
        (reference: code/dataset.py:113-117)."""
        self.image_size = int(self.rng.choice(cfg.MULTI_SCALE_TRAIN_SIZES))
        self.grid_sizes = [self.image_size // s for s in self.strides]
        self.transform = set_train_transforms(self.image_size, mosaic=self.mosaic)

    def apply_augmentations(self, img, boxes, idx, rng=None):
        rng = rng if rng is not None else self._item_rng()
        if self.mosaic:
            imgs, labels = [img], [boxes]
            for _ in range(3):
                rand_idx = int(rng.integers(len(self.annotations)))
                while rand_idx == idx:
                    rand_idx = int(rng.integers(len(self.annotations)))
                imgs.append(self.load_image(rand_idx))
                lbl = self.annotations[rand_idx][1]
                lbl_path = self.annotation_folder / lbl if lbl else None
                labels.append(
                    self.load_boxes(lbl_path)
                    if lbl_path is not None and lbl_path.exists()
                    else []
                )
            mosaic_img, mosaic_boxes = mosaic_augmentation(
                imgs, labels, self.image_size, rng=rng
            )
            if isinstance(mosaic_img, int):  # (-1, -1) sentinel: fallback
                t = set_train_transforms(self.image_size, mosaic=False)
                aug = t(image=img, bboxes=boxes, rng=rng)
            else:
                aug = self.transform(
                    image=mosaic_img, bboxes=mosaic_boxes, rng=rng
                )
        elif self.multi_scale:
            t = set_train_transforms(self.image_size, mosaic=False)
            aug = t(image=img, bboxes=boxes, rng=rng)
        else:
            aug = self.transform(image=img, bboxes=boxes, rng=rng)
        return aug["image"], aug["bboxes"]

    def __getitem__(self, idx: int):
        img = self.load_image(idx)
        lbl = self.annotations[idx][1]
        label_path = self.annotation_folder / lbl if lbl else None
        rng = self._item_rng()
        if label_path is not None and label_path.exists():
            boxes = self.load_boxes(label_path)
            img, boxes = self.apply_augmentations(img, boxes, idx, rng=rng)
            targets = assign_targets(
                boxes, self.anchors, self.grid_sizes, self.ignore_iou_threshold
            )
        else:
            t = set_only_image_transforms(image_size=self.image_size)
            img = t(image=img, rng=rng)["image"]
            targets = [
                np.zeros((self.num_anchors_per_scale, s, s, 6), np.float32)
                for s in self.grid_sizes
            ]
        return img.astype(np.float32), tuple(targets)
