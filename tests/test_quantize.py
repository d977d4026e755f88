"""int8 PTQ path: numeric drift bounds vs the bf16/f32 folded path.

No real weights are available in this environment (zero egress), so the
tests bound quantization error structurally: high cosine similarity of raw
head outputs on the calibration distribution, box-level agreement of the
decoded top detections, and exact plan-walk parity (scales consumed in
calibration order, routes/upsample/maxpool handled).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helpers import mini_model
from yolo_for_turbines_tpu.config import ModelConfig
from yolo_for_turbines_tpu.models.quantize import (
    apply_inference_int8,
    calibrate,
    quantize_folded,
)
from yolo_for_turbines_tpu.models.yolov3 import YOLOv3, apply_inference


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


@pytest.fixture(scope="module")
def mini_folded():
    model = mini_model()
    params, stats = model.init(jax.random.PRNGKey(0))
    return model, model.fold(params, stats)


def _x(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def test_calibration_scale_count(mini_folded):
    model, folded = mini_folded
    scales = calibrate(model.plan, folded, _x((2, 64, 64, 3)))
    # darknet-53-mini: every conv/res-block-interior/res-out/concat tensor
    # gets exactly one scale; walking again consumes exactly all of them
    qp = quantize_folded(model.plan, folded, _x((2, 64, 64, 3)))
    assert len(qp["scales"]) == len(scales)
    out = apply_inference_int8(model.plan, qp, _x((2, 64, 64, 3)))
    assert len(out) == 3


def test_int8_outputs_close_to_f32(mini_folded):
    model, folded = mini_folded
    xc = _x((4, 64, 64, 3), 1)
    qp = quantize_folded(model.plan, folded, xc)
    x = _x((2, 64, 64, 3), 2)
    ref = apply_inference(
        model.plan, folded, x, compute_dtype=jnp.float32, raw_heads=True
    )
    got = apply_inference_int8(
        model.plan, qp, x, raw_heads=True, compute_dtype=jnp.float32
    )
    for g, r in zip(got, ref):
        assert _cos(g, r) > 0.99, _cos(g, r)


def test_int8_boxes_agree(mini_folded):
    """Decoded top-score boxes from the int8 path match the f32 path's
    within a cell (objectness sigmoids agree on where the signal is)."""
    from yolo_for_turbines_tpu import config as cfg
    from yolo_for_turbines_tpu.ops.decode import decode_raw_all

    model, folded = mini_folded
    x = _x((2, 64, 64, 3), 3)
    qp = quantize_folded(model.plan, folded, x)
    grids = (2, 4, 8)
    anchors = jnp.asarray(cfg.scaled_anchors_array(cfg.ANCHORS, 64))

    def boxes(raw):
        return decode_raw_all(raw, anchors, grids, model.cfg.num_classes)

    bf = boxes(apply_inference(model.plan, folded, x, compute_dtype=jnp.float32, raw_heads=True))
    bi = boxes(apply_inference_int8(model.plan, qp, x, raw_heads=True, compute_dtype=jnp.float32))
    # top-32 by score in the f32 path: int8 scores and centers track closely
    bf, bi = np.asarray(bf), np.asarray(bi)
    for img in range(bf.shape[0]):
        top = np.argsort(-bf[img, :, 4])[:32]
        ds = np.abs(bf[img, top, 4] - bi[img, top, 4])
        dc = np.abs(bf[img, top, 0:2] - bi[img, top, 0:2])
        assert ds.max() < 0.05, ds.max()
        assert dc.max() < 0.02, dc.max()


def test_tiny_plan_quantizes():
    model = YOLOv3(
        ModelConfig(num_classes=2, backbone="yolov3_tiny", strides=(32, 16))
    )
    params, stats = model.init(jax.random.PRNGKey(5))
    folded = model.fold(params, stats)
    x = _x((2, 64, 64, 3), 5)
    qp = quantize_folded(model.plan, folded, x)
    ref = apply_inference(
        model.plan, folded, x, compute_dtype=jnp.float32, raw_heads=True
    )
    got = apply_inference_int8(
        model.plan, qp, x, raw_heads=True, compute_dtype=jnp.float32
    )
    for g, r in zip(got, ref):
        assert _cos(g, r) > 0.99, _cos(g, r)


def test_csp_plan_quantizes():
    """CSP stages quantize with the same drift bounds as the other families:
    split/transition/fuse convs per-channel,
    partial stacks like residual blocks, shared-scale cross-stage concat."""
    from helpers import MINI_CSP_LAYERS

    model = YOLOv3(ModelConfig(num_classes=2, layer_config=MINI_CSP_LAYERS))
    params, stats = model.init(jax.random.PRNGKey(6))
    folded = model.fold(params, stats)
    x = _x((2, 64, 64, 3), 6)
    qp = quantize_folded(model.plan, folded, x)
    # every calibrated scale is consumed exactly once by the int8 walk
    ref = apply_inference(
        model.plan, folded, x, compute_dtype=jnp.float32, raw_heads=True
    )
    got = apply_inference_int8(
        model.plan, qp, x, raw_heads=True, compute_dtype=jnp.float32
    )
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert _cos(g, r) > 0.99, _cos(g, r)


def test_predictor_quantize_end_to_end(mini_folded):
    from yolo_for_turbines_tpu.inference import Predictor

    model, folded = mini_folded
    x = _x((2, 64, 64, 3), 7)
    p = Predictor(model, folded, image_size=64, compute_dtype=jnp.float32)
    k_f, m_f = p.predict_batch(x)
    p.quantize(x)
    k_q, m_q = p.predict_batch(x)
    assert np.asarray(k_q).shape == np.asarray(k_f).shape
    assert np.asarray(m_q).dtype == np.asarray(m_f).dtype


def test_quantized_sharded_predictor(mini_folded):
    """int8 params replicate through the shard_map serving path and produce
    the same results as the single-device int8 path."""
    from yolo_for_turbines_tpu.inference import Predictor
    from yolo_for_turbines_tpu.parallel.mesh import create_mesh

    model, folded = mini_folded
    x = _x((8, 64, 64, 3), 8)
    p1 = Predictor(model, folded, image_size=64, compute_dtype=jnp.float32)
    p1.quantize(x)
    k1, m1 = p1.predict_batch(x)
    p8 = Predictor(
        model, folded, image_size=64, compute_dtype=jnp.float32,
        mesh=create_mesh(),
    )
    p8._qparams = p1._qparams
    k8, m8 = p8.predict_batch(x)
    np.testing.assert_array_equal(np.asarray(m1), np.asarray(m8))
    np.testing.assert_allclose(np.asarray(k1), np.asarray(k8), rtol=1e-5, atol=1e-6)
