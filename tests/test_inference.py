"""End-to-end inference pipeline + eval-loop tests (CPU, small model input)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from yolo_for_turbines_tpu import config as cfg
from yolo_for_turbines_tpu.config import ModelConfig, TrainConfig
from yolo_for_turbines_tpu.inference import Predictor
from yolo_for_turbines_tpu.models.yolov3 import YOLOv3
from helpers import mini_model


@pytest.fixture(scope="module")
def folded_model():
    model = mini_model()
    params, stats = model.init(jax.random.PRNGKey(0))
    folded = model.fold(params, stats)
    return model, params, stats, folded


def test_folded_matches_unfolded(folded_model):
    model, params, stats, folded = folded_model
    x = jax.random.uniform(jax.random.PRNGKey(1), (1, 64, 64, 3))
    preds, _ = model.apply(params, stats, x, compute_dtype=jnp.float32)
    preds_f = model.apply_folded(folded, x, compute_dtype=jnp.float32)
    for a, b in zip(preds, preds_f):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-3)


def test_predictor_end_to_end(folded_model):
    model, _, _, folded = folded_model
    predictor = Predictor(
        model, folded, image_size=128, conf_threshold=0.3, max_boxes=32,
        compute_dtype=jnp.float32,
    )
    image = (np.random.default_rng(0).uniform(0, 255, (200, 300, 3))).astype(
        np.uint8
    )
    boxes = predictor.predict_image(image)
    assert isinstance(boxes, list)
    for b in boxes:
        assert len(b) == 6


def test_eval_boxes_and_map_roundtrip(tmp_path, rng):
    """Train targets -> eval loop GT path -> mAP of GT vs itself == 1."""
    from yolo_for_turbines_tpu.ops.decode import decode_scale
    from yolo_for_turbines_tpu.ops.map import calc_map

    anchors = np.asarray(cfg.ANCHORS, np.float32)
    from yolo_for_turbines_tpu.data.dataset import assign_targets

    all_true = []
    for img_id in range(3):
        boxes = [[0.3 + 0.1 * img_id, 0.5, 0.2, 0.2, img_id % 2]]
        targets = assign_targets(boxes, anchors.reshape(-1, 2), [4, 8, 16])
        dec = np.asarray(
            decode_scale(targets[2][None], anchors[2] * 16, 16, is_pred=False)
        )[0]
        for row in dec[dec[:, 4] > 0.5]:
            all_true.append([img_id] + row.tolist())
    assert len(all_true) == 3
    # predictions identical to GT -> mAP 1.0
    preds = [[r[0]] + r[1:5] + [0.99, r[6]] for r in all_true]
    got = calc_map(preds, all_true, 0.5, "center", num_classes=2)
    assert got == pytest.approx(1.0)


def test_check_model_accuracy_runs(folded_model, rng):
    from yolo_for_turbines_tpu.train.evaluate import check_model_accuracy
    from yolo_for_turbines_tpu.train.steps import create_train_state

    model, params, stats, _ = folded_model
    tc = TrainConfig(compute_dtype="float32")
    state, _, _ = create_train_state(
        model, tc, params=params, batch_stats=stats
    )
    size = 64
    images = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    targets = tuple(
        np.zeros((2, 3, size // s, size // s, 6), np.float32) for s in (32, 16, 8)
    )
    targets[0][0, 0, 1, 1] = [0.5, 0.5, 1.0, 1.0, 1.0, 1.0]
    loader = [(images, targets)]
    class_acc, noobj_acc, obj_acc = check_model_accuracy(
        loader, model, state, compute_dtype=jnp.float32
    )
    assert 0 <= class_acc <= 1 and 0 <= noobj_acc <= 1 and 0 <= obj_acc <= 1


def test_predict_images_batched_serving(folded_model):
    """Native-packed batched serving: per-image boxes in original frames."""
    model, _, _, folded = folded_model
    predictor = Predictor(
        model, folded, image_size=128, conf_threshold=0.3, max_boxes=16,
        compute_dtype=jnp.float32,
    )
    rng = np.random.default_rng(3)
    imgs = [
        rng.integers(0, 255, (100, 160, 3), dtype=np.uint8),
        rng.integers(0, 255, (200, 120, 3), dtype=np.uint8),
    ]
    results = predictor.predict_images(imgs)
    assert len(results) == 2
    for boxes in results:
        for b in boxes:
            assert len(b) == 6


def test_fused_nms_kernel_matches_xla(rng):
    """Triton-route greedy NMS sweep == XLA formulation (interpreter on CPU)."""
    from yolo_for_turbines_tpu.ops import nms as nms_mod

    boxes = np.zeros((3, 400, 6), np.float32)
    boxes[..., 0:2] = rng.uniform(0.2, 0.8, (3, 400, 2))
    boxes[..., 2:4] = rng.uniform(0.05, 0.4, (3, 400, 2))
    boxes[..., 4] = rng.uniform(0, 1, (3, 400))
    boxes[..., 5] = rng.integers(0, 3, (3, 400))

    kept_x, keep_x = nms_mod.batched_nms(boxes, 0.45, 0.3, max_boxes=128)
    kept_p, keep_p = nms_mod.batched_nms(
        boxes, 0.45, 0.3, max_boxes=128, use_pallas=True, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(keep_x), np.asarray(keep_p))
    np.testing.assert_allclose(np.asarray(kept_x), np.asarray(kept_p), rtol=1e-6)
