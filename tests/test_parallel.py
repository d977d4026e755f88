"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from yolo_for_turbines_tpu.config import ModelConfig, TrainConfig
from yolo_for_turbines_tpu.models.yolov3 import YOLOv3
from helpers import mini_model
from yolo_for_turbines_tpu.parallel.mesh import (
    batch_sharding,
    create_mesh,
    pad_batch_to_multiple,
    shard_batch,
)
from yolo_for_turbines_tpu.train.steps import create_train_state, make_train_step


def test_mesh_has_8_devices():
    mesh = create_mesh()
    assert mesh.devices.size == 8


def test_shard_batch_places_on_data_axis():
    mesh = create_mesh()
    x = np.zeros((16, 4), np.float32)
    (sx,) = jax.tree_util.tree_leaves(shard_batch((x,), mesh))
    assert sx.sharding.is_equivalent_to(batch_sharding(mesh), ndim=2)


def test_pad_batch_to_multiple():
    x = np.ones((5, 3), np.float32)
    (padded,), n = pad_batch_to_multiple((x,), 8)
    assert padded.shape == (8, 3) and n == 5
    (same,), n2 = pad_batch_to_multiple((np.ones((8, 3), np.float32),), 8)
    assert same.shape == (8, 3) and n2 == 8


def test_sharded_train_step_matches_single_device(rng):
    """DP over 8 devices must produce the same update as 1 device (global
    batch stats + summed grads are mathematically identical)."""
    model = mini_model()
    cfg = TrainConfig(lr=1e-3, max_num_steps=10, compute_dtype="float32")

    b, size = 8, 64
    images = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    targets = tuple(
        np.zeros((b, 3, size // s, size // s, 6), np.float32) for s in (32, 16, 8)
    )
    targets[0][:, 0, 1, 1] = [0.5, 0.5, 1.0, 1.0, 1.0, 1.0]
    anchors = np.abs(rng.normal(1.0, 0.3, (3, 3, 2))).astype(np.float32)

    # single device
    state1, tx1, _ = create_train_state(model, cfg, rng=jax.random.PRNGKey(0))
    step1 = make_train_step(model, tx1, cfg)
    new1, m1 = step1(state1, jnp.asarray(images), tuple(map(jnp.asarray, targets)),
                     jnp.asarray(anchors))

    # 8-device mesh
    mesh = create_mesh()
    state8, tx8, _ = create_train_state(model, cfg, rng=jax.random.PRNGKey(0))
    step8 = make_train_step(model, tx8, cfg, mesh=mesh)
    sx, sy = shard_batch((images, targets), mesh)
    new8, m8 = step8(state8, sx, sy, jnp.asarray(anchors))

    assert float(m1["loss"]) == pytest.approx(float(m8["loss"]), rel=1e-4)
    a = jax.tree_util.tree_leaves(new1.params)
    b_ = jax.tree_util.tree_leaves(new8.params)
    for x1, x2 in zip(a, b_):
        np.testing.assert_allclose(
            np.asarray(x1), np.asarray(x2), rtol=2e-4, atol=2e-5
        )


def test_dryrun_multichip_refuses_missing_devices():
    """The dry run never swaps platforms by itself: asking for more devices
    than JAX has is an error."""
    from __graft_entry__ import dryrun_multichip

    with pytest.raises(RuntimeError, match="needs 16 devices, found 8"):
        dryrun_multichip(16)


def test_sharded_predictor_matches_single_device(rng):
    """DP serving: a mesh-sharded Predictor (shard_map over the data axis)
    must return exactly the single-device results for the same batch."""
    from yolo_for_turbines_tpu.inference import Predictor

    model = mini_model()
    params, stats = model.init(jax.random.PRNGKey(3))
    folded = model.fold(params, stats)
    x = rng.uniform(0, 1, (8, 64, 64, 3)).astype(np.float32)

    p1 = Predictor(model, folded, image_size=64, compute_dtype=jnp.float32)
    k1, m1 = p1.predict_batch(x)

    mesh = create_mesh()
    p8 = Predictor(
        model, folded, image_size=64, compute_dtype=jnp.float32, mesh=mesh
    )
    k8, m8 = p8.predict_batch(x)

    np.testing.assert_array_equal(np.asarray(m1), np.asarray(m8))
    np.testing.assert_allclose(
        np.asarray(k1), np.asarray(k8), rtol=1e-5, atol=1e-6
    )


@pytest.fixture(scope="module")
def dp_synth_data(tmp_path_factory):
    from PIL import Image

    from yolo_for_turbines_tpu.data.splits import create_csv_files

    root = tmp_path_factory.mktemp("dp_synth")
    img_dir, lbl_dir = root / "images", root / "labels"
    img_dir.mkdir()
    lbl_dir.mkdir()
    gen = np.random.default_rng(11)
    for i in range(24):
        img = gen.uniform(0, 255, (64, 64, 3)).astype(np.uint8)
        img[16:48, 16:48] = [255, 0, 0] if i % 2 == 0 else [0, 255, 0]
        Image.fromarray(img).save(img_dir / f"im{i}.png")
        np.savetxt(
            lbl_dir / f"im{i}.txt",
            np.array([[i % 2, 0.5, 0.5, 0.5, 0.5]]),
            fmt="%.6f",
        )
    create_csv_files(img_dir, lbl_dir, root, {"train": 0.75, "val": 0.25})
    return root


class _ListLoader:
    """Replays pre-materialized batches: both trainers see IDENTICAL data
    (live loaders re-draw augmentation rngs per traversal)."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


class _SinkLogger:
    def __init__(self):
        self.rows = []

    def log(self, d):
        self.rows.append(dict(d))


def test_trainer_dp_end_to_end(dp_synth_data):
    """The LAST untested seam of component #27: Trainer.train_one_epoch's
    sharded prefetch_to_device path + val epoch + device mAP under a real
    8-device mesh must match the single-device trainer. Covers: mesh-sharded host->HBM placement, DP gradient
    all-reduce through two full epochs, then the fused eval epoch."""
    from yolo_for_turbines_tpu import config as cfg_mod
    from yolo_for_turbines_tpu.data.loader import get_loaders
    from yolo_for_turbines_tpu.train.trainer import Trainer

    tc = TrainConfig(
        lr=2e-4, batch_size=8, max_num_steps=100, warmup_enabled=False,
        multi_scale=False, image_size=64, compute_dtype="float32",
    )
    model_cfg = ModelConfig(num_classes=2, layer_config=__import__("helpers").MINI_LAYERS)

    train_loader, val_loader, train_ds = get_loaders(
        dp_synth_data, batch_size=8, anchors=cfg_mod.TURBINE_ANCHORS,
        train=True, image_folder=dp_synth_data / "images",
        annotation_folder=dp_synth_data / "labels", num_workers=2,
        image_size=64,
    )
    # materialize so both trainers consume bit-identical batches
    batches = list(train_loader)
    val_batches = _ListLoader(list(val_loader))
    assert len(batches) >= 2

    t1 = Trainer(tc, model_cfg=model_cfg, mesh=create_mesh(1))
    t8 = Trainer(tc, model_cfg=model_cfg, mesh=create_mesh(8))
    # identical seeds -> identical init
    for a, b_ in zip(
        jax.tree_util.tree_leaves(t1.state.params),
        jax.tree_util.tree_leaves(t8.state.params),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))

    # epoch 1 = ONE step, so the epoch loss IS the first-step loss and must
    # match tightly (all-reduced grads + global batch stats == single
    # device; the step-level tight test above bounds this seam at ~1e-4)
    log1, log8 = _SinkLogger(), _SinkLogger()
    loss1 = t1.train_one_epoch(train_ds, _ListLoader(batches[:1]), log1)
    loss8 = t8.train_one_epoch(train_ds, _ListLoader(batches[:1]), log8)
    assert loss8 == pytest.approx(loss1, rel=1e-3)

    # epoch 2 exercises the sharded-prefetch steady state; by now the
    # single-pass-BN reassociation noise (different reduction orders in the
    # two compiled programs) has amplified chaotically on near-zero stem
    # betas, so element-wise parity is meaningless — assert GLOBAL parity:
    # the two parameter vectors stay nearly parallel. A wiring bug (dropped
    # shard, wrong axis) collapses the cosine far below this
    t1.train_one_epoch(train_ds, _ListLoader(batches[1:2]), log1)
    t8.train_one_epoch(train_ds, _ListLoader(batches[1:2]), log8)
    v1 = np.concatenate([
        np.asarray(x, np.float64).ravel()
        for x in jax.tree_util.tree_leaves(t1.state.params)
    ])
    v8 = np.concatenate([
        np.asarray(x, np.float64).ravel()
        for x in jax.tree_util.tree_leaves(t8.state.params)
    ])
    cos = v1 @ v8 / (np.linalg.norm(v1) * np.linalg.norm(v8))
    assert cos > 0.9999, cos
    assert np.linalg.norm(v1 - v8) / np.linalg.norm(v1) < 1e-2

    # eval epoch (fused pass + device mAP) on both trainers
    vloss1, map1 = t1.val_one_epoch(val_batches, epoch=9, logger=log1)
    vloss8, map8 = t8.val_one_epoch(val_batches, epoch=9, logger=log8)
    assert vloss8 == pytest.approx(vloss1, rel=2e-2)
    assert map8 == pytest.approx(map1, abs=0.15)
