"""mAP@IoU computation, numerically matching the reference.

Mirrors reference code/utils.py:193-274 exactly: per class, sort detections
by score descending, greedily match each detection to its image's best-IoU
unmatched ground truth (strictly > iou_threshold), cumulative TP/FP ->
precision/recall with a prepended (recall 0, precision 1) point, trapezoidal
AP, mean over classes that have at least one ground truth.

Runs in numpy on the host. The expensive parts of eval (forward, decode,
NMS) stay on device; what reaches this function is only the per-image NMS
survivors (K boxes/image), a tiny transfer.
"""

from __future__ import annotations

import numpy as np


def _iou_center(box1, boxes2):
    """IoU of one cxcywh box against (M, 4) cxcywh boxes (+1e-6, parity)."""
    b1 = np.asarray(box1, dtype=np.float64)
    b2 = np.asarray(boxes2, dtype=np.float64)
    b1_xy = b1[:2] - b1[2:4] / 2
    b2_xy = b2[:, :2] - b2[:, 2:4] / 2
    xA = np.maximum(b1_xy[0], b2_xy[:, 0])
    yA = np.maximum(b1_xy[1], b2_xy[:, 1])
    xB = np.minimum(b1_xy[0] + b1[2], b2_xy[:, 0] + b2[:, 2])
    yB = np.minimum(b1_xy[1] + b1[3], b2_xy[:, 1] + b2[:, 3])
    inter = np.clip(xB - xA, 0, None) * np.clip(yB - yA, 0, None)
    union = b1[2] * b1[3] + b2[:, 2] * b2[:, 3] - inter
    return inter / (union + 1e-6)


def _iou_corner(box1, boxes2):
    """IoU with top-left xywh boxes (reference's 'corner' branch)."""
    b1 = np.asarray(box1, dtype=np.float64)
    b2 = np.asarray(boxes2, dtype=np.float64)
    xA = np.maximum(b1[0], b2[:, 0])
    yA = np.maximum(b1[1], b2[:, 1])
    xB = np.minimum(b1[0] + b1[2], b2[:, 0] + b2[:, 2])
    yB = np.minimum(b1[1] + b1[3], b2[:, 1] + b2[:, 3])
    inter = np.clip(xB - xA, 0, None) * np.clip(yB - yA, 0, None)
    union = b1[2] * b1[3] + b2[:, 2] * b2[:, 3] - inter
    return inter / (union + 1e-6)


def calc_map(
    pred_boxes,
    true_boxes,
    iou_threshold: float = 0.5,
    box_format: str = "center",
    num_classes: int = 20,
) -> float:
    """Mean average precision at a single IoU threshold.

    Args:
        pred_boxes: rows [image_id, cx, cy, w, h, score, class].
        true_boxes: rows [image_id, cx, cy, w, h, score, class].
        iou_threshold: match threshold (strict >, parity with
            reference code/utils.py:249).
        box_format: "center" or "corner".
        num_classes: classes to average over (classes without GT skipped).

    Returns:
        float mAP. 0.0 if no class has ground truth (the reference would
        divide by zero here; we define it as 0).
    """
    preds = np.asarray(pred_boxes, dtype=np.float64).reshape(-1, 7)
    truths = np.asarray(true_boxes, dtype=np.float64).reshape(-1, 7)
    iou_fn = _iou_center if box_format == "center" else _iou_corner

    average_precisions = []
    for c in range(num_classes):
        det = preds[preds[:, 6] == c]
        gts = truths[truths[:, 6] == c]
        total_true = len(gts)
        if total_true == 0:
            continue

        # Per-image GT pools and matched flags.
        gt_by_image = {}
        for row in gts:
            gt_by_image.setdefault(row[0], []).append(row[1:5])
        gt_by_image = {k: np.asarray(v) for k, v in gt_by_image.items()}
        matched = {k: np.zeros(len(v), dtype=bool) for k, v in gt_by_image.items()}

        # Sort detections by descending score (stable, parity with list.sort).
        order = np.argsort(-det[:, 5], kind="stable")
        det = det[order]

        tp = np.zeros(len(det))
        fp = np.zeros(len(det))
        for i, d in enumerate(det):
            img = d[0]
            img_gts = gt_by_image.get(img)
            best_iou, best_idx = 0.0, 0
            if img_gts is not None and len(img_gts):
                ious = iou_fn(d[1:5], img_gts)
                best_idx = int(np.argmax(ious))
                best_iou = float(ious[best_idx])
            if best_iou > iou_threshold:
                if not matched[img][best_idx]:
                    tp[i] = 1
                    matched[img][best_idx] = True
                else:
                    fp[i] = 1
            else:
                fp[i] = 1

        cum_tp = np.cumsum(tp)
        cum_fp = np.cumsum(fp)
        with np.errstate(invalid="ignore", divide="ignore"):
            precisions = cum_tp / (cum_tp + cum_fp)
        recalls = cum_tp / total_true
        precisions = np.concatenate(([1.0], precisions))
        recalls = np.concatenate(([0.0], recalls))
        trapezoid = getattr(np, "trapezoid", np.trapz)
        average_precisions.append(trapezoid(precisions, recalls))

    if not average_precisions:
        return 0.0
    return float(sum(average_precisions) / len(average_precisions))


def calc_map_range(
    pred_boxes,
    true_boxes,
    iou_thresholds=None,
    box_format: str = "center",
    num_classes: int = 20,
) -> dict:
    """COCO-style mAP over a threshold range (beyond-reference extension;
    the reference evaluates a single threshold, code/utils.py:193).

    Returns {"mAP@0.5": ..., "mAP@0.75": ..., "mAP@[.5:.95]": mean}.
    """
    if iou_thresholds is None:
        iou_thresholds = [0.5 + 0.05 * i for i in range(10)]
    aps = {
        t: calc_map(pred_boxes, true_boxes, t, box_format, num_classes)
        for t in iou_thresholds
    }
    out = {f"mAP@{t:g}": v for t, v in aps.items()}
    out["mAP@[.5:.95]"] = float(np.mean(list(aps.values())))
    return out


def calc_map_device_batched(
    preds,
    pred_valid,
    gts,
    gt_valid,
    iou_threshold: float = 0.5,
    num_classes: int = 20,
):
    """Scalable fully on-device mAP over per-image padded slots.

    Same semantics as `calc_map` / `calc_map_device`, but the inputs are
    image-bucketed, which caps memory at O(I*K*G) for ONE shared IoU tensor
    instead of the flat formulation's O((I*K)*(I*G)) matrix — a 1,000-image
    val set at K=256/G=128 is ~131 MB here vs ~33 TB flat. This is the
    production eval path (`train/evaluate.py::evaluate_map_device`).

    Why bucketing preserves the reference's greedy semantics
    (code/utils.py:193-274): a detection only ever competes for ground
    truths of its own image, and whether it wins depends only on
    higher-scored detections of that same image — so the global
    score-ordered greedy decomposes into independent per-image greedies
    (a lax.scan over the K score-sorted slots, vmapped over images and
    classes). Only the TP/FP *cumsum* needs the global score order, and
    that order is class-independent: one stable argsort over all I*K
    scores serves every class. Tie order matches the reference exactly:
    both are image-major stable for equal scores.

    Args:
        preds: (I, K, 6) [cx, cy, w, h, score, class] per-image NMS
            survivors, padded.
        pred_valid: (I, K) bool.
        gts: (I, G, 6) same layout (score column unused), padded.
        gt_valid: (I, G) bool.

    Returns:
        scalar jnp mAP.
    """
    import jax
    import jax.numpy as jnp

    from .iou import calc_iou

    preds = jnp.asarray(preds, jnp.float32)
    gts = jnp.asarray(gts, jnp.float32)
    pred_valid = jnp.asarray(pred_valid)
    gt_valid = jnp.asarray(gt_valid)
    n_img, k, _ = preds.shape
    g = gts.shape[1]

    # Per-image stable score-desc sort (shared across classes). Within an
    # image this is the reference's processing order; invalid slots sink.
    scores = jnp.where(pred_valid, preds[:, :, 4], -jnp.inf)
    order = jnp.argsort(-scores, axis=1, stable=True)
    preds_s = jnp.take_along_axis(preds, order[..., None], axis=1)
    valid_s = jnp.take_along_axis(pred_valid, order, axis=1)
    scores_s = jnp.take_along_axis(scores, order, axis=1)

    # One (I, K, G) IoU tensor shared by every class.
    iou = calc_iou(preds_s[:, :, None, 0:4], gts[:, None, :, 0:4], "center")
    iou_t = jnp.transpose(iou, (1, 0, 2))  # (K, I, G) for the scan

    cls_det = preds_s[:, :, 5]
    cls_gt = gts[:, :, 5]
    img_idx = jnp.arange(n_img)

    # Global stable score order (class-independent), for the TP/FP cumsum.
    flat_order = jnp.argsort(-scores_s.reshape(-1), stable=True)

    def ap_for_class(c):
        det_ok = valid_s & (cls_det == c)  # (I, K)
        gt_ok = gt_valid & (cls_gt == c)  # (I, G)
        total_true = jnp.sum(gt_ok)

        def step(matched, xs):
            # one score-rank step across ALL images at once
            iou_k, ok_k = xs  # (I, G), (I,)
            ious_i = jnp.where(gt_ok, iou_k, 0.0)
            best = jnp.argmax(ious_i, axis=1)  # (I,)
            best_iou = jnp.take_along_axis(ious_i, best[:, None], 1)[:, 0]
            already = matched[img_idx, best]
            is_tp = ok_k & (best_iou > iou_threshold) & ~already
            matched = matched.at[img_idx, best].set(already | is_tp)
            return matched, is_tp

        matched0 = jnp.zeros((n_img, g), bool)
        _, tps = jax.lax.scan(step, matched0, (iou_t, det_ok.T))  # (K, I)
        tp = tps.T.astype(jnp.float32)  # (I, K)
        fp = jnp.where(det_ok, 1.0 - tp, 0.0)

        tp_sorted = tp.reshape(-1)[flat_order]
        fp_sorted = fp.reshape(-1)[flat_order]
        cum_tp = jnp.cumsum(tp_sorted)
        cum_fp = jnp.cumsum(fp_sorted)
        # Unlike the host/flat variants, this cumsum runs over ALL I*K slots
        # (the flat order is shared across classes), so slots BEFORE the
        # first class-c detection have cum_tp+cum_fp == 0. Their precision
        # must be the prepended point's 1.0, not 0: the trapezoid into the
        # first detection uses that slot as its left height, and a 0 there
        # silently costs 1/(2*total_true) of AP whenever the class's
        # top-scored detection is a TP (found round 5 via a GT-replay
        # oracle scoring 0.977 instead of 1.0; see
        # tests/test_ops.py::test_batched_device_map_leading_other_class).
        seen = cum_tp + cum_fp
        precisions = jnp.where(seen > 0, cum_tp / jnp.maximum(seen, 1e-16), 1.0)
        recalls = cum_tp / jnp.maximum(total_true, 1e-16)
        precisions = jnp.concatenate([jnp.ones(1), precisions])
        recalls = jnp.concatenate([jnp.zeros(1), recalls])
        ap = jnp.sum(
            (recalls[1:] - recalls[:-1]) * (precisions[1:] + precisions[:-1]) / 2
        )
        return ap, total_true > 0

    aps, has_gt = jax.vmap(ap_for_class)(jnp.arange(num_classes, dtype=jnp.float32))
    n = jnp.sum(has_gt)
    return jnp.where(
        n > 0, jnp.sum(jnp.where(has_gt, aps, 0.0)) / jnp.maximum(n, 1), 0.0
    )


def calc_map_device_range(
    preds,
    pred_valid,
    gts,
    gt_valid,
    iou_thresholds=None,
    num_classes: int = 20,
):
    """Device-side COCO-style mAP over a threshold range (the on-device twin
    of `calc_map_range`). One vmap over thresholds: the comparisons are
    traced, so the (I, K, G) IoU tensor and the per-image sort are shared
    across all 10 thresholds.

    Returns a dict {"mAP@0.5": ..., ..., "mAP@[.5:.95]": mean} of floats.
    """
    import jax.numpy as jnp

    if iou_thresholds is None:
        iou_thresholds = [0.5 + 0.05 * i for i in range(10)]
    ts = jnp.asarray(iou_thresholds, jnp.float32)
    # one compiled program per (num_classes, shapes) -- never dispatch the
    # scan-over-slots eagerly (op by op)
    import numpy as _np

    aps = _np.asarray(  # ONE host transfer for all thresholds
        _jitted_map_range(num_classes)(preds, pred_valid, gts, gt_valid, ts)
    )
    out = {f"mAP@{t:g}": float(v) for t, v in zip(iou_thresholds, aps)}
    out["mAP@[.5:.95]"] = float(aps.mean())
    return out


_MAP_RANGE_JITS: dict = {}


def _jitted_map_range(num_classes: int):
    """Build-once jitted threshold-vmap of `calc_map_device_batched`
    (cached per num_classes; jit's own cache handles input shapes)."""
    import jax

    if num_classes not in _MAP_RANGE_JITS:

        def f(preds, pred_valid, gts, gt_valid, ts):
            return jax.vmap(
                lambda t: calc_map_device_batched(
                    preds, pred_valid, gts, gt_valid, t, num_classes
                )
            )(ts)

        _MAP_RANGE_JITS[num_classes] = jax.jit(f)
    return _MAP_RANGE_JITS[num_classes]


def calc_map_device(
    pred_boxes,
    pred_valid,
    true_boxes,
    true_valid,
    iou_threshold: float = 0.5,
    num_classes: int = 20,
):
    """Fully on-device mAP over flat fixed-size padded rows (jit-compatible).

    NOTE: this flat variant materializes the full (N_det, N_gt) IoU matrix —
    fine for tests and small sets, quadratic in val-set size. Production eval
    uses `calc_map_device_batched` (image-bucketed, memory O(I*K*G)).

    Device-side twin of `calc_map` with identical semantics:
    per class, detections sorted by descending score greedily match their
    image's best-IoU unmatched GT (strict > threshold), cumulative TP/FP ->
    trapezoidal AP with a prepended (0, 1) point, mean over classes with GT.

    Args:
        pred_boxes: (N, 7) [image_id, cx, cy, w, h, score, class], padded.
        pred_valid: (N,) bool.
        true_boxes: (M, 7) same layout (score column unused), padded.
        true_valid: (M,) bool.

    Returns:
        scalar jnp mAP. The greedy match is a lax.scan over detections
        (inherently sequential), each step O(M) -- fine for eval cadence.
    """
    import jax
    import jax.numpy as jnp

    from .iou import calc_iou

    preds = jnp.asarray(pred_boxes, jnp.float32)
    gts = jnp.asarray(true_boxes, jnp.float32)
    pred_valid = jnp.asarray(pred_valid)
    true_valid = jnp.asarray(true_valid)

    # IoU of every detection against every GT, gated by same-image
    iou_all = calc_iou(preds[:, None, 1:5], gts[None, :, 1:5], "center")
    same_img = preds[:, 0:1] == gts[None, :, 0]
    same_cls = preds[:, 6:7] == gts[None, :, 6]

    def ap_for_class(c):
        det_ok = pred_valid & (preds[:, 6] == c)
        gt_ok = true_valid & (gts[:, 6] == c)
        total_true = jnp.sum(gt_ok)

        order = jnp.argsort(jnp.where(det_ok, -preds[:, 5], jnp.inf), stable=True)
        det_ok_sorted = det_ok[order]
        pair_ok = (same_img & same_cls)[order] & gt_ok[None, :]
        iou_sorted = jnp.where(pair_ok, iou_all[order], 0.0)

        def step(matched, inputs):
            # parity with the host greedy (code/utils.py:234-255): best IoU
            # over ALL same-image GTs; a detection whose best GT is already
            # matched is an FP (it does not fall back to the runner-up)
            ious_i, ok_i = inputs
            best = jnp.argmax(ious_i)
            best_iou = ious_i[best]
            is_tp = ok_i & (best_iou > iou_threshold) & ~matched[best]
            matched = matched.at[best].set(matched[best] | is_tp)
            return matched, is_tp

        matched0 = jnp.zeros(gts.shape[0], bool)
        _, tps = jax.lax.scan(step, matched0, (iou_sorted, det_ok_sorted))
        tp = tps.astype(jnp.float32)
        fp = jnp.where(det_ok_sorted, 1.0 - tp, 0.0)

        cum_tp = jnp.cumsum(tp)
        cum_fp = jnp.cumsum(fp)
        precisions = cum_tp / jnp.maximum(cum_tp + cum_fp, 1e-16)
        recalls = cum_tp / jnp.maximum(total_true, 1e-16)
        precisions = jnp.concatenate([jnp.ones(1), precisions])
        recalls = jnp.concatenate([jnp.zeros(1), recalls])
        # invalid/padded rows sort last and leave both cumsums unchanged, so
        # they add zero-width trapezoids -- no masking needed in the integral
        ap = jnp.sum(
            (recalls[1:] - recalls[:-1]) * (precisions[1:] + precisions[:-1]) / 2
        )
        return ap, total_true > 0

    aps, has_gt = jax.vmap(ap_for_class)(jnp.arange(num_classes, dtype=jnp.float32))
    n = jnp.sum(has_gt)
    return jnp.where(n > 0, jnp.sum(jnp.where(has_gt, aps, 0.0)) / jnp.maximum(n, 1), 0.0)
