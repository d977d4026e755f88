"""Cells -> boxes decode, fully on device (no host round-trip).

The reference's `cells_to_boxes` (reference: code/utils.py:86-148) applies
sigmoid/exp **in place** on the caller's tensor and returns nested Python
lists via `.tolist()`, forcing a device->host transfer per batch. Here decode
is a pure jnp function returning a device array; the eval loop keeps
everything on the device until the final (tiny) NMS survivors are pulled.

Output layout parity: (B, 3*S*S, 6) with rows [cx, cy, w, h, score, class],
all coordinates normalized to the image, identical to the reference's list
rows. Anchors are passed *pre-scaled by the grid size* exactly like the
reference (reference: code/utils.py:303, code/train.py:195-197).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def decode_scale(predictions, anchors, grid_size: int, is_pred: bool = True):
    """Decode one scale's raw predictions (or encoded targets) to boxes.

    Args:
        predictions: (B, A, S, S, 5+C) raw head output when is_pred, else
            (B, A, S, S, 6) encoded targets.
        anchors: (A, 2) anchors scaled by grid size (cell units).
        grid_size: S (static).
        is_pred: raw predictions (sigmoid/exp applied) vs encoded targets.

    Returns:
        (B, 3*S*S, 6) float32 [cx, cy, w, h, score, class], normalized coords.
    """
    predictions = jnp.asarray(predictions)
    anchors = jnp.asarray(anchors, jnp.float32)
    b = predictions.shape[0]
    num_anchors = anchors.shape[0]
    s = grid_size

    if is_pred:
        xy = jax.nn.sigmoid(predictions[..., 0:2])
        wh = jnp.exp(predictions[..., 2:4]) * anchors.reshape(1, num_anchors, 1, 1, 2)
        scores = jax.nn.sigmoid(predictions[..., 4:5])
        best_class = jnp.argmax(predictions[..., 5:], axis=-1)[..., None].astype(
            predictions.dtype
        )
    else:
        xy = predictions[..., 0:2]
        wh = predictions[..., 2:4]
        scores = predictions[..., 4:5]
        best_class = predictions[..., 5:6]

    ar = jnp.arange(s, dtype=predictions.dtype)
    # Cell index j varies along axis 3 (x / width), i along axis 2 (y / height)
    # (reference: code/utils.py:119-142's repeat + permute trick).
    cx = (xy[..., 0:1] + ar[None, None, None, :, None]) / s
    cy = (xy[..., 1:2] + ar[None, None, :, None, None]) / s
    wh = wh / s

    boxes = jnp.concatenate([cx, cy, wh, scores, best_class], axis=-1)
    return boxes.reshape(b, num_anchors * s * s, 6).astype(jnp.float32)


def cells_to_boxes(predictions, anchors, grid_size: int, is_pred: bool = True):
    """Reference-shaped API: returns nested Python lists (B, 3*S*S, 6).

    Prefer `decode_scale` (device array) in pipelines; this exists for API
    parity with reference code/utils.py:86-148 and for tests.
    """
    return decode_scale(predictions, anchors, grid_size, is_pred).tolist()


def decode_raw_scale(raw, anchors, grid_size: int, num_classes: int):
    """Decode one scale's *raw NHWC head output* (B, S, S, A*(5+C)).

    Throughput path: consumes `apply_inference(..., raw_heads=True)` output
    with a free reshape instead of the (B, A, S, S, 5+C) transpose; compute
    stays in the input dtype (bf16) with an f32 result. Box ordering
    within the scale differs from `decode_scale` (cells-major instead of
    anchor-major) -- irrelevant downstream, NMS re-sorts by score.
    """
    raw = jnp.asarray(raw)
    anchors = jnp.asarray(anchors, raw.dtype)
    b, s = raw.shape[0], grid_size
    a = anchors.shape[0]
    y = raw.reshape(b, s, s, a, 5 + num_classes)

    ar = jnp.arange(s, dtype=jnp.float32)
    # Box math in f32 (only 6 of the 5+C channels); class argmax stays in the
    # input dtype where the bulk of the bytes are.
    box = y[..., 0:5].astype(jnp.float32)
    cx = (jax.nn.sigmoid(box[..., 0:1]) + ar[None, None, :, None, None]) / s
    cy = (jax.nn.sigmoid(box[..., 1:2]) + ar[None, :, None, None, None]) / s
    wh = jnp.exp(box[..., 2:4]) * anchors.astype(jnp.float32).reshape(1, 1, 1, a, 2) / s
    scores = jax.nn.sigmoid(box[..., 4:5])
    best_class = jnp.argmax(y[..., 5:], axis=-1)[..., None].astype(jnp.float32)
    boxes = jnp.concatenate([cx, cy, wh, scores, best_class], axis=-1)
    return boxes.reshape(b, s * s * a, 6)


def decode_raw_all(raw_preds, scaled_anchors, grid_sizes, num_classes: int):
    """Raw-head decode over all three scales -> (B, sum(S*S*A), 6)."""
    parts = [
        decode_raw_scale(r, scaled_anchors[i], grid_sizes[i], num_classes)
        for i, r in enumerate(raw_preds)
    ]
    return jnp.concatenate(parts, axis=1)


def decode_all_scales(predictions, scaled_anchors, grid_sizes):
    """Decode and concatenate all three scales: (B, sum(3*S*S), 6).

    Args:
        predictions: list of 3 arrays (B, A, S, S, 5+C), stride-32 scale first.
        scaled_anchors: (3, A, 2) anchors scaled per grid size.
        grid_sizes: static (S0, S1, S2).
    """
    parts = [
        decode_scale(p, scaled_anchors[i], grid_sizes[i], is_pred=True)
        for i, p in enumerate(predictions)
    ]
    return jnp.concatenate(parts, axis=1)
