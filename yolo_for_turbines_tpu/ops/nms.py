"""Class-aware greedy NMS with fixed shapes, on device under jit.

The reference's NMS (reference: code/utils.py:150-191) is a host-side Python
while-loop over a list of boxes: filter score > threshold, sort descending,
pop the best, vectorized-IoU against the rest, keep different-class or
low-IoU boxes. Its greedy semantics (a box suppressed by an earlier kept box
cannot itself suppress) are preserved here, but the whole thing is a
fixed-shape jnp program:

1. top-k (k = max_boxes) candidates by masked score -- descending order,
   padded/masked, so shapes are static under jit.
2. one K x K suppression matrix: same class, IoU >= threshold, later in
   score order.
3. a sequential `lax.fori_loop` sweep that replicates the greedy pop loop:
   step i clears later boxes of the same class with IoU >= threshold iff
   box i itself is still kept. On the GPU the same sweep runs as one
   Triton kernel (ops/pallas/nms_kernel.py, chosen by `default_use_pallas_nms`).

`batched_nms` vmaps this over a batch so per-image NMS of an eval batch is a
single device computation -- no per-image host round-trips.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .iou import calc_iou


def _pairwise_iou(boxes4, box_format: str):
    """(K, 4) -> (K, K) IoU matrix."""
    return calc_iou(boxes4[:, None, :], boxes4[None, :, :], box_format)


def default_use_pallas_nms(platform: Optional[str] = None) -> bool:
    """Whether the fused NMS sweep (ops/pallas/nms_kernel.py) serves here.

    The kernel compiles through Triton for CUDA GPUs only. On the CPU the
    XLA sweep is the plain reference formulation. `platform` defaults to
    the platform of the first JAX device. This is the one place the
    program chooses a code path by platform.
    """
    if platform is None:
        platform = jax.devices()[0].platform
    return platform == "gpu"


def _top_candidates(boxes, obj_threshold: float, max_boxes: int):
    """(..., N, 6) -> top-K candidates by masked score, descending, and
    their validity (score > obj_threshold)."""
    k = min(max_boxes, boxes.shape[-2])
    scores = boxes[..., 4]
    masked_scores = jnp.where(scores > obj_threshold, scores, -jnp.inf)
    top_scores, top_idx = jax.lax.top_k(masked_scores, k)
    cand = jnp.take_along_axis(boxes, top_idx[..., None], axis=-2)
    return cand, top_scores > obj_threshold


def _suppression(cand, iou_threshold: float, box_format: str):
    """(K, 6) sorted candidates -> (K, K) bool: [i, j] is True where kept
    box i suppresses later box j (same class, IoU >= threshold)."""
    k = cand.shape[0]
    iou = _pairwise_iou(cand[:, :4], box_format)
    same_class = cand[:, 5][:, None] == cand[:, 5][None, :]
    later = jnp.arange(k)[None, :] > jnp.arange(k)[:, None]
    return same_class & (iou >= iou_threshold) & later


def nms_single(
    boxes,
    iou_threshold: float,
    obj_threshold: float,
    max_boxes: int = 256,
    box_format: str = "center",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """NMS for one image's candidate boxes.

    Args:
        boxes: (N, 6) [cx, cy, w, h, score, class].
        iou_threshold: suppress same-class boxes with IoU >= this.
        obj_threshold: pre-filter: keep score > this (strict, parity with
            reference code/utils.py:165).
        max_boxes: K, the fixed survivor capacity.
        box_format: "center" or "corner" (top-left xywh).

    Returns:
        (kept_boxes, keep_mask): (K, 6) sorted by descending score and (K,)
        bool. Rows where keep_mask is False are padding/suppressed.
    """
    boxes = jnp.asarray(boxes)
    cand, keep = _top_candidates(boxes, obj_threshold, max_boxes)
    suppress = _suppression(cand, iou_threshold, box_format)

    def body(i, keep):
        sup_i = suppress[i] & keep[i]
        return keep & ~sup_i

    keep = jax.lax.fori_loop(0, cand.shape[0], body, keep)
    return cand, keep


def batched_nms(
    boxes,
    iou_threshold: float,
    obj_threshold: float,
    max_boxes: int = 256,
    box_format: str = "center",
    use_pallas: bool = False,
    interpret: bool = False,
):
    """Batched NMS: (B, N, 6) -> ((B, K, 6), (B, K) bool).

    use_pallas runs the greedy sweep as one Triton kernel over the whole
    batch (one program per image, ops/pallas/nms_kernel.py); otherwise the
    XLA formulation is vmapped. Both read the same top-K candidates and the
    same suppression matrix, so their keep masks are identical. `interpret`
    runs the kernel in the Pallas interpreter (CPU tests).
    """
    boxes = jnp.asarray(boxes)
    if use_pallas:
        from .pallas.nms_kernel import greedy_sweep_pallas

        cand, valid = _top_candidates(boxes, obj_threshold, max_boxes)
        suppress = jax.vmap(
            functools.partial(
                _suppression, iou_threshold=iou_threshold,
                box_format=box_format,
            )
        )(cand)
        return cand, greedy_sweep_pallas(suppress, valid, interpret=interpret)

    fn = functools.partial(
        nms_single,
        iou_threshold=iou_threshold,
        obj_threshold=obj_threshold,
        max_boxes=max_boxes,
        box_format=box_format,
    )
    return jax.vmap(fn)(boxes)


def nms_to_list(kept_boxes, keep_mask):
    """(K, 6) + (K,) -> reference-style list of [x, y, w, h, score, class]."""
    import numpy as np

    kept = np.asarray(kept_boxes)
    mask = np.asarray(keep_mask)
    return [row.tolist() for row in kept[mask]]


def non_max_suppression(
    boxes, iou_threshold: float, obj_threshold: float, box_format: str = "corners"
):
    """Reference-compatible API (reference: code/utils.py:150-191).

    Takes a list of [x, y, w, h, score, class] rows, returns the surviving
    rows sorted by descending score. Runs the fixed-shape device NMS under
    the hood.

    Host-loop API, not for serving: this dispatches `nms_single` unjitted
    (op by op) and copies the survivors to the host on every call. It
    exists for reference-parity tests and host-side use; device pipelines
    use `batched_nms` inside their jit (the Predictor and eval paths do).
    """
    import numpy as np

    arr = np.asarray(boxes, dtype=np.float32)
    if arr.size == 0:
        return []
    kept, mask = nms_single(
        arr,
        iou_threshold=iou_threshold,
        obj_threshold=obj_threshold,
        max_boxes=arr.shape[0],
        box_format=box_format,
    )
    return nms_to_list(kept, mask)
