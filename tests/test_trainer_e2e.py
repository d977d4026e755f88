"""End-to-end trainer test: synthetic dataset -> train() -> eval -> checkpoint."""

import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from yolo_for_turbines_tpu import config as cfg
from yolo_for_turbines_tpu.config import ModelConfig, TrainConfig
from yolo_for_turbines_tpu.data.splits import create_csv_files

from helpers import MINI_LAYERS


@pytest.fixture(scope="module")
def synth_data(tmp_path_factory):
    """12 images with one box each (class alternating), 64px."""
    root = tmp_path_factory.mktemp("synth")
    img_dir, lbl_dir = root / "images", root / "labels"
    img_dir.mkdir()
    lbl_dir.mkdir()
    rng = np.random.default_rng(7)
    for i in range(12):
        img = rng.uniform(0, 255, (64, 64, 3)).astype(np.uint8)
        # draw a bright square as the "object"
        img[20:44, 20:44] = [255, 0, 0] if i % 2 == 0 else [0, 255, 0]
        Image.fromarray(img).save(img_dir / f"im{i}.png")
        np.savetxt(
            lbl_dir / f"im{i}.txt",
            np.array([[i % 2, 0.5, 0.5, 0.375, 0.375]]),
            fmt="%.6f",
        )
    create_csv_files(img_dir, lbl_dir, root, {"train": 0.5, "val": 0.25, "test": 0.25})
    return root


def test_train_end_to_end(synth_data, tmp_path):
    from yolo_for_turbines_tpu.train.trainer import train

    tc = TrainConfig(
        lr=1e-3,
        batch_size=4,
        max_num_steps=4,
        warmup_enabled=False,
        multi_scale=False,
        image_size=64,
        compute_dtype="float32",
    )
    # patch the model to the mini architecture through the Trainer path
    import yolo_for_turbines_tpu.train.trainer as trainer_mod

    orig_init = trainer_mod.Trainer.__init__

    def patched(self, train_cfg, model_cfg=None, **kw):
        model_cfg = ModelConfig(
            num_classes=cfg.NUM_TURBINE_CLASSES,
            activation=train_cfg.activation,
            layer_config=MINI_LAYERS,
        )
        orig_init(self, train_cfg, model_cfg=model_cfg, **kw)

    trainer_mod.Trainer.__init__ = patched
    try:
        best = train(
            tc,
            synth_data,
            tmp_path,
            identifier="e2etest",
            early_stop=5,
            image_folder=synth_data / "images",
            annotation_folder=synth_data / "labels",
            num_workers=2,
        )
    finally:
        trainer_mod.Trainer.__init__ = orig_init

    # checkpoint written and loadable; metrics logged
    assert (tmp_path / "best_model_e2etest.ckpt").exists()
    metrics_file = tmp_path / "YOLOv3_Turbine_Detection_e2etest_metrics.jsonl"
    assert metrics_file.exists()
    lines = [json.loads(l) for l in open(metrics_file)]
    keys = set().union(*[set(l) for l in lines])
    assert "train_loss" in keys and "val_loss" in keys and "lr" in keys


def test_get_eval_boxes_with_loader(synth_data):
    """Eval loop over a real DataLoader produces reference-format rows."""
    import jax
    import jax.numpy as jnp

    from helpers import mini_model
    from yolo_for_turbines_tpu.data.loader import get_loaders
    from yolo_for_turbines_tpu.train.evaluate import evaluate_map, get_eval_boxes
    from yolo_for_turbines_tpu.train.steps import create_train_state

    model = mini_model()
    tc = TrainConfig(compute_dtype="float32", image_size=64)
    state, _, _ = create_train_state(model, tc, rng=jax.random.PRNGKey(0))
    loader = get_loaders(
        synth_data,
        batch_size=4,
        anchors=cfg.TURBINE_ANCHORS,
        train=False,
        image_folder=synth_data / "images",
        annotation_folder=synth_data / "labels",
        num_workers=2,
        image_size=64,
    )
    preds, trues = get_eval_boxes(
        loader, model, state, cfg.TURBINE_ANCHORS, compute_dtype=jnp.float32
    )
    assert len(trues) >= 1
    for row in trues:
        assert len(row) == 7
        assert row[5] > 0.5  # GT objectness
    mAP = evaluate_map(loader, model, state, cfg.TURBINE_ANCHORS, num_classes=2)
    assert 0.0 <= mAP <= 1.0

    # threshold threading (round 4): non-default thresholds must reach the
    # compiled NMS, not silently fall back to the config constants. With a
    # random-init mini model, scores cluster just above 0.5, so a 0.999
    # objectness gate must kill every prediction row.
    preds_hi, _ = get_eval_boxes(
        loader, model, state, cfg.TURBINE_ANCHORS,
        obj_threshold=0.999, compute_dtype=jnp.float32,
    )
    assert preds_hi == []
    for row in preds:
        assert row[5] > cfg.CONF_THRESHOLD  # default gate did apply


def test_hpo_adapter_resumes(synth_data, tmp_path):
    """ASHA adapter: epochs accumulate across rungs via resume_state."""
    import yolo_for_turbines_tpu.train.trainer as trainer_mod
    from yolo_for_turbines_tpu.train.trainer import make_hpo_train_fn

    orig_init = trainer_mod.Trainer.__init__

    def patched(self, train_cfg, model_cfg=None, **kw):
        model_cfg = ModelConfig(
            num_classes=cfg.NUM_TURBINE_CLASSES,
            activation=train_cfg.activation,
            layer_config=MINI_LAYERS,
        )
        orig_init(self, train_cfg, model_cfg=model_cfg, **kw)

    trainer_mod.Trainer.__init__ = patched
    try:
        fn = make_hpo_train_fn(
            synth_data,
            tmp_path,
            image_folder=synth_data / "images",
            annotation_folder=synth_data / "labels",
            num_workers=2,
        )
        config = dict(
            lr=1e-3, batch_size=4, max_num_steps=100, warmup_enabled=False,
            multi_scale=False, image_size=64, compute_dtype="float32",
        )
        m1, state1 = fn(config, 1, None)
        assert state1[-1] == 1  # epoch counter
        m2, state2 = fn(config, 2, state1)
        assert state2[-1] == 3
        assert 0.0 <= m1 <= 1.0 and 0.0 <= m2 <= 1.0
    finally:
        trainer_mod.Trainer.__init__ = orig_init


def test_prewarm_buckets(synth_data):
    import yolo_for_turbines_tpu.train.trainer as trainer_mod

    tc = TrainConfig(
        lr=1e-3, batch_size=2, max_num_steps=10, warmup_enabled=False,
        multi_scale=True, image_size=64, compute_dtype="float32",
    )
    model_cfg = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
    trainer = trainer_mod.Trainer(tc, model_cfg=model_cfg)
    trainer.prewarm(sizes=(64, 96))  # two buckets, no crash, state unchanged
    assert int(trainer.state.step) == 0


def test_mosaic_csp_training(synth_data, tmp_path):
    """BASELINE config #5: mosaic-augmentation training + CSPDarknet variant
    (reference README future work), end to end on the mini CSP model."""
    import yolo_for_turbines_tpu.train.trainer as trainer_mod
    from helpers import MINI_CSP_LAYERS
    from yolo_for_turbines_tpu.train.trainer import train

    orig_init = trainer_mod.Trainer.__init__

    def patched(self, train_cfg, model_cfg=None, **kw):
        model_cfg = ModelConfig(
            num_classes=cfg.NUM_TURBINE_CLASSES,
            activation=train_cfg.activation,
            layer_config=MINI_CSP_LAYERS,
        )
        orig_init(self, train_cfg, model_cfg=model_cfg, **kw)

    trainer_mod.Trainer.__init__ = patched
    try:
        tc = TrainConfig(
            lr=1e-3, batch_size=4, max_num_steps=2, warmup_enabled=False,
            multi_scale=False, mosaic=True, image_size=64,
            compute_dtype="float32",
        )
        train(
            tc, synth_data, tmp_path, identifier="mosaiccsp", early_stop=2,
            image_folder=synth_data / "images",
            annotation_folder=synth_data / "labels",
            num_workers=2,
        )
    finally:
        trainer_mod.Trainer.__init__ = orig_init
    assert (tmp_path / "best_model_mosaiccsp.ckpt").exists()


def test_device_map_matches_host_eval(synth_data):
    """evaluate_map_device == evaluate_map on a real loader."""
    import jax
    import jax.numpy as jnp

    from helpers import mini_model
    from yolo_for_turbines_tpu.data.loader import get_loaders
    from yolo_for_turbines_tpu.train.evaluate import (
        evaluate_map,
        evaluate_map_device,
    )
    from yolo_for_turbines_tpu.train.steps import create_train_state

    model = mini_model()
    tc = TrainConfig(compute_dtype="float32", image_size=64)
    state, _, _ = create_train_state(model, tc, rng=jax.random.PRNGKey(0))
    loader = get_loaders(
        synth_data, batch_size=4, anchors=cfg.TURBINE_ANCHORS, train=False,
        image_folder=synth_data / "images",
        annotation_folder=synth_data / "labels",
        num_workers=2, image_size=64,
    )
    host = evaluate_map(loader, model, state, cfg.TURBINE_ANCHORS, num_classes=2)
    dev = evaluate_map_device(
        loader, model, state, cfg.TURBINE_ANCHORS, num_classes=2,
        compute_dtype=jnp.float32,
    )
    assert dev == pytest.approx(host, abs=1e-5)


class _CountingLoader:
    """Wraps a DataLoader and counts full traversals (__iter__ calls)."""

    def __init__(self, loader):
        self.loader = loader
        self.iters = 0

    def __iter__(self):
        self.iters += 1
        return iter(self.loader)

    def __len__(self):
        return len(self.loader)


class _ListLogger:
    def __init__(self):
        self.rows = []

    def log(self, d):
        self.rows.append(dict(d))


def test_fused_eval_matches_three_pass(synth_data):
    """The fused eval epoch (one jitted program, ONE loader traversal) must
    reproduce the separate three-pass metrics exactly: per-component val
    loss, class/obj/noobj accuracies, and device mAP."""
    import jax
    import jax.numpy as jnp

    import yolo_for_turbines_tpu.train.trainer as trainer_mod
    from yolo_for_turbines_tpu.data.loader import get_loaders
    from yolo_for_turbines_tpu.train.evaluate import (
        check_model_accuracy,
        evaluate_map_device,
    )

    tc = TrainConfig(
        lr=1e-3, batch_size=4, max_num_steps=10, warmup_enabled=False,
        multi_scale=False, image_size=64, compute_dtype="float32",
    )
    model_cfg = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
    trainer = trainer_mod.Trainer(tc, model_cfg=model_cfg)
    _, val_loader, _ = get_loaders(
        synth_data, batch_size=4, anchors=trainer.anchors, train=True,
        image_folder=synth_data / "images",
        annotation_folder=synth_data / "labels",
        num_workers=2, image_size=64,
    )

    counting = _CountingLoader(val_loader)
    logger = _ListLogger()
    val_loss, mAP = trainer.val_one_epoch(counting, epoch=9, logger=logger)
    assert counting.iters == 1, "fused eval must traverse the loader once"
    logged = {}
    for row in logger.rows:
        logged.update(row)

    # three-pass reference (the pre-fusion shape)
    tots, n = {}, 0
    for x, y in val_loader:
        anchors = trainer_mod.scaled_anchors_for(
            trainer.anchors, x.shape[1], trainer.model.strides
        )
        metrics = trainer.eval_step(trainer.state, x, y, anchors)
        for k, v in metrics.items():
            tots[k] = tots.get(k, 0.0) + float(v)
        n += 1
    ref_loss = tots["loss"] / n
    class_acc, noobj_acc, obj_acc = check_model_accuracy(
        val_loader, trainer.model, trainer.state, cfg.CONF_THRESHOLD,
        compute_dtype=jnp.float32,
    )
    ref_map = evaluate_map_device(
        val_loader, trainer.model, trainer.state, trainer.anchors,
        num_classes=2, compute_dtype=jnp.float32,
    )

    assert val_loss == pytest.approx(ref_loss, rel=1e-5)
    assert logged["class_accuracy"] == pytest.approx(class_acc, abs=1e-6)
    assert logged["noobj_accuracy"] == pytest.approx(noobj_acc, abs=1e-6)
    assert logged["obj_accuracy"] == pytest.approx(obj_acc, abs=1e-6)
    assert mAP == pytest.approx(ref_map, abs=1e-5)
    # host-eval path agrees too
    trainer_host = trainer_mod.Trainer(
        TrainConfig(
            lr=1e-3, batch_size=4, max_num_steps=10, warmup_enabled=False,
            multi_scale=False, image_size=64, compute_dtype="float32",
            device_eval=False,
        ),
        model_cfg=model_cfg,
    )
    trainer_host.state = trainer.state
    counting2 = _CountingLoader(val_loader)
    _, host_map = trainer_host.val_one_epoch(counting2, epoch=9, logger=_ListLogger())
    assert counting2.iters == 1
    assert host_map == pytest.approx(ref_map, abs=1e-5)


def test_plain_val_epoch_device_accumulation(synth_data):
    """Plain (non-eval) val epochs accumulate metrics on device with ONE
    host sync at epoch end; the averages must equal the per-batch
    float()-accumulation they replaced (which waited for the device once
    per metric per batch)."""
    import yolo_for_turbines_tpu.train.trainer as trainer_mod
    from yolo_for_turbines_tpu.data.loader import get_loaders

    tc = TrainConfig(
        lr=1e-3, batch_size=4, max_num_steps=10, warmup_enabled=False,
        multi_scale=False, image_size=64, compute_dtype="float32",
    )
    trainer = trainer_mod.Trainer(
        tc, model_cfg=ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
    )
    # batch 2 over the 3-image val split: two RAGGED batches (2 + 1), so the
    # device accumulation is exercised across batches of different shapes
    _, val_loader, _ = get_loaders(
        synth_data, batch_size=2, anchors=trainer.anchors, train=True,
        image_folder=synth_data / "images",
        annotation_folder=synth_data / "labels",
        num_workers=2, image_size=64,
    )

    logger = _ListLogger()
    val_loss, mAP = trainer.val_one_epoch(val_loader, epoch=0, logger=logger)
    assert mAP is None  # plain epoch: no eval
    logged = {}
    for row in logger.rows:
        logged.update(row)

    # per-batch host accumulation (the replaced shape)
    tots, n = {}, 0
    for x, y in val_loader:
        anchors = trainer_mod.scaled_anchors_for(
            trainer.anchors, x.shape[1], trainer.model.strides
        )
        metrics = trainer.eval_step(trainer.state, x, y, anchors)
        for k, v in metrics.items():
            tots[k] = tots.get(k, 0.0) + float(v)
        n += 1
    assert n > 1
    for k, v in tots.items():
        assert logged[f"val_{k}"] == pytest.approx(v / n, rel=1e-6)
    assert val_loss == pytest.approx(tots["loss"] / n, rel=1e-6)
