"""Functional 4-term YOLOv3 loss (pure jnp, mask-based, jit/grad-safe).

Semantics derived from first principles (standard YOLOv3) with the
reference's structure and weights (reference: code/loss.py:6-81):

- no-object loss: BCE-with-logits on the objectness score where target
  objectness == 0 (the -1 "ignore" cells are in neither mask), mean over
  no-object elements. lambda = 0.5.
- object loss: MSE(sigmoid(obj_logit), IoU(pred_box, target_box)) over
  object cells, IoU stop-gradient'd. lambda = 1.
- box loss: MSE over object cells of [sigmoid(tx), sigmoid(ty), tw, th]
  against [x_cell, y_cell, log(1e-16 + w/anchor), log(1e-16 + h/anchor)].
  lambda = 5.
- class loss: softmax cross-entropy over object cells. lambda = 1.

Documented divergences from the reference (quirks, not behavior to copy --
see SURVEY.md section 2 quirk 2): the reference mutates its inputs in place,
which (a) applies sigmoid to channels [1:3] = (ty, tw) instead of (tx, ty)
in the box loss, and (b) compares the *raw* objectness logit against the
IoU target in the object loss (code/loss.py:67 uses predictions[..., 4:5]
unsigmoided). Both are widely regarded as bugs in this lineage of YOLOv3
implementations; we implement the standard form and validate via mAP parity.

Masked means are computed as sum(where(mask, v, 0)) / max(count, 1) --
boolean indexing would create dynamic shapes and break jit.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from ..ops.iou import calc_iou

LAMBDA_BOX = 5.0
LAMBDA_OBJ = 1.0
LAMBDA_NOOBJ = 0.5
LAMBDA_CLASS = 1.0


def _masked_mean(values, mask, n_extra: int = 1):
    """Mean of `values` where mask (broadcast over trailing dims) is set."""
    count = jnp.sum(mask) * n_extra
    total = jnp.sum(jnp.where(mask if values.ndim == mask.ndim else mask[..., None],
                              values, 0.0))
    return total / jnp.maximum(count, 1)


def _bce_with_logits(logits, labels):
    return jnp.maximum(logits, 0) - logits * labels + jnp.log1p(
        jnp.exp(-jnp.abs(logits))
    )


def yolo_loss(
    predictions: jnp.ndarray,
    targets: jnp.ndarray,
    anchors: jnp.ndarray,
    legacy: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Loss for a single scale.

    Args:
        predictions: (B, A, S, S, 5+C) raw head output, float.
        targets: (B, A, S, S, 6) [x_cell, y_cell, w_cell, h_cell, obj, class];
            obj is 1 (object), 0 (background) or -1 (ignore).
        anchors: (A, 2) anchors in cell units (scaled by grid size).
        legacy: replicate the reference's in-place-mutation quirks exactly
            (for behavioral-parity comparison, not recommended for training):
            box loss uses [raw tx, sigmoid(ty), sigmoid(tw), raw th] because
            code/loss.py:71 sigmoids channels [1:3], and the object loss
            compares the *raw* objectness logit to the IoU target
            (code/loss.py:67).

    Returns:
        (box_loss, object_loss, no_object_loss, class_loss), each weighted by
        its lambda (parity with reference return order, code/loss.py:78-81).
    """
    predictions = predictions.astype(jnp.float32)
    targets = targets.astype(jnp.float32)
    anchors = jnp.asarray(anchors, jnp.float32).reshape(1, -1, 1, 1, 2)

    obj_mask = targets[..., 4] == 1
    noobj_mask = targets[..., 4] == 0

    # -- no-object loss
    noobj_bce = _bce_with_logits(predictions[..., 4], targets[..., 4])
    no_object_loss = _masked_mean(noobj_bce, noobj_mask)

    # -- object loss: confidence should predict IoU with the assigned target
    pred_xy = jax.nn.sigmoid(predictions[..., 0:2])
    pred_wh = jnp.exp(predictions[..., 2:4]) * anchors
    pred_boxes = jnp.concatenate([pred_xy, pred_wh], axis=-1)
    ious = jax.lax.stop_gradient(
        calc_iou(pred_boxes, targets[..., 0:4], box_format="center")
    )
    obj_pred = (
        predictions[..., 4] if legacy else jax.nn.sigmoid(predictions[..., 4])
    )
    obj_sq = (obj_pred - ious * targets[..., 4]) ** 2
    object_loss = _masked_mean(obj_sq, obj_mask)

    # -- box loss in cell-offset space (wh as log-offsets for stability)
    target_wh = jnp.log(1e-16 + targets[..., 2:4] / anchors)
    if legacy:
        # reference quirk: sigmoid lands on channels [1:3] = (ty, tw)
        pred_box_terms = jnp.concatenate(
            [
                predictions[..., 0:1],
                jax.nn.sigmoid(predictions[..., 1:3]),
                predictions[..., 3:4],
            ],
            axis=-1,
        )
    else:
        pred_box_terms = jnp.concatenate([pred_xy, predictions[..., 2:4]], axis=-1)
    target_box_terms = jnp.concatenate([targets[..., 0:2], target_wh], axis=-1)
    box_sq = (pred_box_terms - target_box_terms) ** 2
    box_loss = _masked_mean(box_sq, obj_mask, n_extra=4)

    # -- class loss (softmax CE; targets carry integer labels).
    # one-hot contraction instead of take_along_axis: the one-hot
    # multiply-reduce stays a fused elementwise pass instead of a gather
    # over the (B, A, S, S) label grid.
    logits = predictions[..., 5:]
    labels = targets[..., 5].astype(jnp.int32)
    log_probs = jax.nn.log_softmax(logits, axis=-1)
    onehot = jax.nn.one_hot(labels, logits.shape[-1], dtype=log_probs.dtype)
    ce = -jnp.sum(log_probs * onehot, axis=-1)
    class_loss = _masked_mean(ce, obj_mask)

    return (
        LAMBDA_BOX * box_loss,
        LAMBDA_OBJ * object_loss,
        LAMBDA_NOOBJ * no_object_loss,
        LAMBDA_CLASS * class_loss,
    )


def total_yolo_loss(
    predictions: Sequence[jnp.ndarray],
    targets: Sequence[jnp.ndarray],
    scaled_anchors: jnp.ndarray,
):
    """Sum the 4 components over the 3 scales.

    Returns (total, components) where components is a dict of the per-term
    sums (matching the reference's per-epoch wandb logging granularity,
    reference: code/train.py:56-65).
    """
    box = obj = noobj = cls = 0.0
    for i in range(len(predictions)):
        b, o, n, c = yolo_loss(predictions[i], targets[i], scaled_anchors[i])
        box, obj, noobj, cls = box + b, obj + o, noobj + n, cls + c
    total = box + obj + noobj + cls
    return total, {
        "box_loss": box,
        "obj_loss": obj,
        "no_obj_loss": noobj,
        "class_loss": cls,
    }
