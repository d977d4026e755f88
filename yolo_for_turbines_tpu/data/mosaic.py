"""Mosaic augmentation: 4 images -> 2x2 grid -> random square cutout.

Geometry matches the reference (reference: code/utils.py:503-662):
1. resize each image so its longest side is `size` (boxes renormalized /2
   because the mosaic canvas is 2*size).
2. place into a (2*size, 2*size) canvas (top-left anchored quadrants, the
   canvas itself padded with 255 where quadrant images are smaller).
3. pick the cutout's top-left uniformly in [0.2, 0.3] of the canvas (the
   reference's docstring says 40-60% but its code uses 20-30%,
   code/utils.py:599-600 -- we follow the code), up to 10 attempts to find a
   cutout intersecting at least one box; return (-1, -1) sentinel otherwise.
4. clip boxes to the cutout, rescale to cutout-normalized cxcywh.

Box math and the rng stream live entirely in this module, so labels are
bit-identical between the two pixel backends:
- native C++ (native/packer.cpp::mosaic_cutout): samples only the pixels
  inside the cutout window -- the full-canvas compose spends 3/4 of its
  resample work on pixels the cutout never sees.
- numpy/PIL fallback: the literal reference geometry (resize all 4, build
  the canvas, slice), used when no C++ toolchain is available.
Pixel work is also deferred until a cutout is FOUND, so sentinel returns
(~no-box draws) never pay for resizes on either backend.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .augment import resize_longest


def _resized_dims(h: int, w: int, size: int) -> Tuple[int, int]:
    """(nh, nw) of resize_longest -- same Python round() (half-to-even)."""
    scale = size / max(h, w)
    return max(1, round(h * scale)), max(1, round(w * scale))


def mosaic_augmentation(
    imgs: Sequence[np.ndarray],
    anns: Sequence,
    size: int,
    rng: Optional[np.random.Generator] = None,
    use_native: bool = True,
):
    """Build one mosaic sample from 4 (image, yolo-boxes) pairs.

    Args:
        imgs: 4 HWC uint8 images.
        anns: 4 box lists, each (M, 5) normalized [cx, cy, w, h, class].
        size: output cutout side length.
        rng: numpy Generator (new default_rng if None).
        use_native: route pixel composition through the C++ cutout sampler
            when the library is available (labels are identical either way).

    Returns:
        (cutout, boxes): (size, size, 3) uint8 and (M', 5) boxes normalized
        to the cutout -- or (-1, -1) if no cutout with boxes was found.
    """
    rng = rng or np.random.default_rng()
    imgs = [np.asarray(im) for im in imgs]
    anns = [
        np.asarray(a, np.float64).reshape(-1, 5) if a is not None and len(a) else
        np.zeros((0, 5))
        for a in anns
    ]

    # 1.+2. Geometry and box placement only (no pixel work yet). Box
    # centers/sizes are relative to the *resized quadrant*, which occupies
    # exactly half the canvas in each dim after top-left-anchored placement.
    offsets = [(0, 0), (0, size), (size, 0), (size, size)]  # (oy, ox)
    geoms: List[Tuple[int, int]] = []
    all_boxes = []
    for i in range(4):
        h, w = imgs[i].shape[:2]
        nh, nw = _resized_dims(h, w, size)
        geoms.append((nh, nw))
        boxes = anns[i].copy()
        if len(boxes):
            oy, ox = offsets[i]
            boxes[:, 0] = boxes[:, 0] * nw / (2 * size) + ox / (2 * size)
            boxes[:, 1] = boxes[:, 1] * nh / (2 * size) + oy / (2 * size)
            boxes[:, 2] = boxes[:, 2] * nw / (2 * size)
            boxes[:, 3] = boxes[:, 3] * nh / (2 * size)
            all_boxes.append(boxes)
    if not all_boxes:
        return -1, -1
    new_boxes = np.concatenate(all_boxes)

    # 3. Random cutout (top-left in 20-30% of the canvas), <=10 attempts.
    found = False
    x = y = 0.0
    x_pixel = y_pixel = 0
    kept = None
    for _ in range(10):
        x = rng.uniform(0.2, 0.3)
        y = rng.uniform(0.2, 0.3)
        x_pixel = int(x * 2 * size)
        y_pixel = int(y * 2 * size)

        # top-left xywh in canvas-normalized coords
        tl = new_boxes.copy()
        tl[:, 0] -= tl[:, 2] / 2
        tl[:, 1] -= tl[:, 3] / 2
        xA = np.maximum(tl[:, 0], x)
        yA = np.maximum(tl[:, 1], y)
        xB = np.minimum(tl[:, 0] + tl[:, 2], x + 0.5)
        yB = np.minimum(tl[:, 1] + tl[:, 3], y + 0.5)
        inter = np.maximum(0, xB - xA) * np.maximum(0, yB - yA)
        kept = tl[inter > 0]
        if len(kept):
            found = True
            break
    if not found:
        return -1, -1

    # Pixels, now that the window is known: native cutout-window sampler or
    # the full-canvas numpy compose.
    cutout = None
    if use_native:
        from ..native import mosaic_cutout

        cutout = mosaic_cutout(imgs, geoms, size, y_pixel, x_pixel)
    if cutout is None:
        canvas = np.full((2 * size, 2 * size, 3), 255, dtype=np.uint8)
        for im, (oy, ox) in zip(imgs, offsets):
            im = resize_longest(im, size)
            h, w = im.shape[:2]
            canvas[oy : oy + h, ox : ox + w] = im
        cutout = canvas[y_pixel : y_pixel + size, x_pixel : x_pixel + size]

    # 4. Clip kept (top-left xywh) boxes to the cutout window [x, x+.5] x [y, y+.5].
    b = kept
    mask = b[:, 0] < x
    b[mask, 2] -= x - b[mask, 0]
    b[mask, 0] = x
    mask = b[:, 1] < y
    b[mask, 3] -= y - b[mask, 1]
    b[mask, 1] = y
    b[:, 0] -= x
    b[:, 1] -= y
    w_mask = (b[:, 0] + b[:, 2]) > 0.5
    h_mask = (b[:, 1] + b[:, 3]) > 0.5
    b[w_mask, 2] = 0.5 - b[w_mask, 0]
    b[h_mask, 3] = 0.5 - b[h_mask, 1]

    # Rescale from canvas-normalized to cutout-normalized; back to cxcywh.
    b[:, :4] *= 2
    b[:, 0] += b[:, 2] / 2
    b[:, 1] += b[:, 3] / 2

    assert cutout.shape == (size, size, 3)
    return np.ascontiguousarray(cutout), b
