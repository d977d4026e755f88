"""The greedy NMS sweep as a Pallas kernel through Triton (ops/pallas/
nms_kernel.py), against the XLA formulation it replaces on the GPU.

On the CPU the kernel runs in the Pallas interpreter; the `gpu`-marked test
runs the compiled kernel on the card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yolo_for_turbines_tpu.ops import nms as nms_mod
from yolo_for_turbines_tpu.ops.iou import calc_iou
from yolo_for_turbines_tpu.ops.pallas import nms_kernel


def _candidates(rng, b, n, num_classes=3):
    boxes = np.zeros((b, n, 6), np.float32)
    boxes[..., 0:2] = rng.uniform(0.2, 0.8, (b, n, 2))
    boxes[..., 2:4] = rng.uniform(0.05, 0.4, (b, n, 2))
    boxes[..., 4] = rng.uniform(0, 1, (b, n))
    boxes[..., 5] = rng.integers(0, num_classes, (b, n))
    return boxes


def nms_single_np(boxes, iou_thr, obj_thr, k, fmt):
    """One image through the XLA reference (nms_single)."""
    kept, keep = nms_mod.nms_single(
        boxes, iou_thr, obj_thr, max_boxes=k, box_format=fmt
    )
    return np.asarray(kept), np.asarray(keep)


def _single(boxes, iou_thr, obj_thr, k, fmt):
    """nms_single per image, stacked over the batch."""
    outs = [nms_single_np(b, iou_thr, obj_thr, k, fmt) for b in boxes]
    return np.stack([o[0] for o in outs]), np.stack([o[1] for o in outs])


def _kernel(boxes, iou_thr, obj_thr, k, fmt):
    kept, keep = nms_mod.batched_nms(
        boxes, iou_thr, obj_thr, max_boxes=k, box_format=fmt,
        use_pallas=True, interpret=True,
    )
    return np.asarray(kept), np.asarray(keep)


@pytest.mark.parametrize("k", [100, 256])
@pytest.mark.parametrize("box_format", ["center", "corner"])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_kernel_matches_nms_single(b, box_format, k):
    """K=100 exercises the padding to the next power of two (128)."""
    rng = np.random.default_rng(b * 1000 + k)
    boxes = _candidates(rng, b, 600)
    want_kept, want_keep = _single(boxes, 0.45, 0.3, k, box_format)
    got_kept, got_keep = _kernel(boxes, 0.45, 0.3, k, box_format)
    assert got_keep.shape == (b, k)
    np.testing.assert_array_equal(got_keep, want_keep)
    np.testing.assert_array_equal(got_kept, want_kept)
    # the sweep really suppressed something (overlaps cross the threshold)
    assert 0 < want_keep.sum() < (want_kept[..., 4] > 0.3).sum()


def test_kernel_all_candidates_invalid():
    rng = np.random.default_rng(1)
    boxes = _candidates(rng, 2, 300)
    boxes[..., 4] = rng.uniform(0, 0.5, (2, 300))  # all at or below 0.5
    _, keep = _kernel(boxes, 0.45, 0.5, 128, "center")
    assert not keep.any()


def test_kernel_iou_exactly_at_threshold():
    """IoU == threshold suppresses (>=), in the kernel as in XLA."""
    boxes = np.zeros((1, 3, 6), np.float32)
    boxes[0, :, :4] = [[0.5, 0.5, 0.2, 0.2], [0.55, 0.5, 0.2, 0.2],
                       [0.2, 0.2, 0.1, 0.1]]
    boxes[0, :, 4] = [0.9, 0.8, 0.7]
    thr = np.float32(calc_iou(boxes[0, 0, :4], boxes[0, 1, :4]))
    above = np.nextafter(thr, np.float32(1))
    for t, second_kept in ((thr, False), (above, True)):
        want = nms_single_np(boxes[0], t, 0.5, 3, "center")[1]
        got = _kernel(boxes, t, 0.5, 3, "center")[1][0]
        np.testing.assert_array_equal(got, want)
        assert bool(got[1]) is second_kept and got[0] and got[2]


def test_kernel_one_class_against_many():
    """Identical boxes: with one class a single box survives; with a class
    per box none suppresses another."""
    boxes = np.zeros((1, 64, 6), np.float32)
    boxes[0, :, :4] = [0.5, 0.5, 0.3, 0.3]
    boxes[0, :, 4] = np.linspace(0.99, 0.6, 64)
    _, keep_one = _kernel(boxes, 0.45, 0.5, 64, "center")
    assert keep_one[0].sum() == 1 and keep_one[0, 0]
    boxes[0, :, 5] = np.arange(64)
    _, keep_many = _kernel(boxes, 0.45, 0.5, 64, "center")
    assert keep_many.all()
    np.testing.assert_array_equal(
        keep_many[0], nms_single_np(boxes[0], 0.45, 0.5, 64, "center")[1]
    )


@pytest.mark.parametrize("k,kp", [(1, 1), (100, 128), (128, 128), (256, 256)])
def test_padded_size_is_next_power_of_two(k, kp):
    assert nms_kernel.padded_size(k) == kp


@pytest.mark.parametrize("sharded", [False, True])
def test_kernel_lowers_for_cuda(sharded):
    """The kernel lowers to Triton IR for CUDA on a host without a GPU, so
    an unsupported primitive shows up here and not first on the card; also
    per shard under shard_map over 4 devices, as the sharded Predictor
    runs it."""
    from jax import shard_map
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    fn = functools.partial(nms_mod.batched_nms, iou_threshold=0.45,
                           obj_threshold=0.5, max_boxes=256, use_pallas=True)
    arg = jax.ShapeDtypeStruct((8, 10647, 6), jnp.float32)
    if sharded:
        mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
        fn = shard_map(fn, mesh=mesh, in_specs=P("data"),
                       out_specs=(P("data"), P("data")), check_vma=False)
        arg = jax.ShapeDtypeStruct(
            arg.shape, arg.dtype, sharding=NamedSharding(mesh, P("data"))
        )
    triton = "__gpu$xla.gpu.triton"
    exp = jax.export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(triton)],
    )(arg)
    text = exp.mlir_module()
    assert triton in text and 'name = "nms_greedy_sweep"' in text
    assert exp.nr_devices == (4 if sharded else 1)


@pytest.mark.parametrize("platform,want", [("gpu", True), ("cpu", False)])
def test_default_use_pallas_nms(platform, want):
    assert nms_mod.default_use_pallas_nms(platform) is want


def test_predictor_takes_the_platform_choice():
    from helpers import mini_model
    from yolo_for_turbines_tpu.inference import Predictor

    model = mini_model()
    params, stats = model.init(jax.random.PRNGKey(0))
    folded = model.fold(params, stats)
    pred = Predictor(model, folded, image_size=64)
    assert pred.use_pallas_nms is nms_mod.default_use_pallas_nms()
    assert Predictor(model, folded, use_pallas_nms=True).use_pallas_nms


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    rng = np.random.default_rng(7)
    boxes = jnp.asarray(_candidates(rng, 16, 10647, num_classes=4))
    run = {
        use: jax.jit(functools.partial(
            nms_mod.batched_nms, iou_threshold=0.45, obj_threshold=0.5,
            max_boxes=256, use_pallas=use,
        ))
        for use in (True, False)
    }
    kept_k, keep_k = run[True](boxes)
    kept_x, keep_x = run[False](boxes)
    np.testing.assert_array_equal(np.asarray(keep_k), np.asarray(keep_x))
    np.testing.assert_array_equal(np.asarray(kept_k), np.asarray(kept_x))
