"""Training orchestration: epoch loops, multi-scale buckets, early stop,
checkpoints, metrics (reference: code/train.py:34-239).

Control-flow parity with the reference's `train()`:
- model = YOLOv3(turbine classes, configured activation), darknet53.conv.74
  backbone import with optional freeze (reference: code/train.py:166-169),
- SGD(lr, momentum, weight_decay) + linear warmup from 1e-6*lr
  (reference: code/train.py:171-189),
- dataset scale change every `num_batch_to_resize` batches
  (reference: code/train.py:45-46) -- each of the 7 bucket sizes gets its own
  cached jit executable,
- val every epoch; accuracy + mAP every 10th epoch; best-mAP tracking with
  early-stop countdown (reference: code/train.py:199-227),
- checkpoints at every 25% of epochs and at the end
  (reference: code/train.py:229-237).

Documented divergence: the reference computes `scaled_anchors` once from the
416 grid sizes and uses them for every multi-scale batch
(code/train.py:195-197), so losses at 608px use 416-scaled anchors while the
targets were encoded at 608 grids. We scale anchors by the actual batch's
grid size (consistent with the target encoding); quirk noted per SURVEY.md.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import config as cfg
from ..config import ModelConfig, TrainConfig
from ..data.loader import DataLoader, get_loaders
from ..models.darknet_weights import load_darknet_weights
from ..models.yolov3 import YOLOv3
from ..parallel.mesh import create_mesh, shard_batch
from .checkpoint import load_checkpoint, save_checkpoint
from .evaluate import evaluate_map
from .metrics import MetricsLogger
from .steps import TrainState, create_train_state, make_eval_step, make_train_step


def scaled_anchors_for(anchors, image_size: int, strides=cfg.STRIDES) -> np.ndarray:
    gs = np.asarray(cfg.grid_sizes_for(image_size, strides), np.float32)
    return np.asarray(anchors, np.float32) * gs[:, None, None]


class Trainer:
    def __init__(
        self,
        train_cfg: TrainConfig,
        model_cfg: Optional[ModelConfig] = None,
        anchors=cfg.TURBINE_ANCHORS,
        weights_path=None,
        mesh=None,
        report_callback=None,
    ):
        self.cfg = train_cfg
        self.model_cfg = model_cfg or ModelConfig(
            num_classes=cfg.NUM_TURBINE_CLASSES, activation=train_cfg.activation
        )
        self.anchors = np.asarray(anchors, np.float32)
        self.model = YOLOv3(self.model_cfg)
        if mesh is None:
            # mesh size must divide the global batch; use the largest divisor
            # of batch_size that fits the local device count. On the CPU
            # backend (virtual devices), also cap at the physical core count:
            # XLA CPU collectives hard-abort (40s rendezvous timeout) when an
            # oversubscribed host can't run all participants concurrently.
            import os as _os

            import jax as _jax

            n_avail = len(_jax.devices())
            if _jax.devices()[0].platform == "cpu":
                n_avail = min(n_avail, _os.cpu_count() or 1)
            n = 1
            for d in range(1, n_avail + 1):
                if train_cfg.batch_size % d == 0:
                    n = d
            mesh = create_mesh(n)
        self.mesh = mesh
        # caller-supplied ("data", "space") mesh => spatial partitioning:
        # image rows shard over "space" (parallel/spatial.py); the batch
        # must divide the mesh's data axis, image heights its space axis
        from ..parallel.spatial import SPACE_AXIS

        self._spatial = SPACE_AXIS in mesh.axis_names
        self.report_callback = report_callback

        rng = jax.random.PRNGKey(train_cfg.seed)
        params, stats = self.model.init(rng)
        frozen = None
        if weights_path is not None and train_cfg.load_weights:
            params, stats, frozen, _ = load_darknet_weights(
                str(weights_path),
                self.model.plan,
                params,
                stats,
                freeze=train_cfg.freeze_backbone,
            )
        self.state, self.tx, self.schedule = create_train_state(
            self.model, train_cfg, params=params, batch_stats=stats,
            frozen_mask=frozen,
        )
        n_dev = self.mesh.devices.size
        mesh = self.mesh if n_dev > 1 else None
        self.train_step = make_train_step(self.model, self.tx, train_cfg, mesh)
        # eval runs unsharded: val batches may be ragged (no drop_last) and
        # exactness beats parallelism on the small val set
        self.eval_step = make_eval_step(self.model, train_cfg, mesh=None)

    # ------------------------------------------------------------------

    def prewarm(self, sizes=None):
        """Compile the train step for every multi-scale bucket up front
        (SURVEY.md section 2 #9: one executable per size in
        MULTI_SCALE_TRAIN_SIZES -- no recompilation storms mid-epoch).

        Runs one dummy step per bucket through a throwaway state (jit's
        cache keys on shapes/dtypes, not values), chaining the returned
        state so donation stays legal.
        """
        if sizes is None:
            sizes = (
                cfg.MULTI_SCALE_TRAIN_SIZES
                if self.cfg.multi_scale
                else (self.cfg.image_size,)
            )
        state, _, _ = create_train_state(
            self.model, self.cfg, rng=jax.random.PRNGKey(0)
        )
        b = self.cfg.batch_size
        a = self.model_cfg.anchors_per_scale
        for size in sizes:
            images = np.zeros((b, size, size, 3), np.float32)
            targets = tuple(
                np.zeros((b, a, size // s, size // s, 6), np.float32)
                for s in self.model.strides
            )
            anchors = scaled_anchors_for(self.anchors, size, self.model.strides)
            x, y = self._put(images, targets)
            state, _ = self.train_step(state, x, y, anchors)
        jax.block_until_ready(state.step)

    def _put(self, images, targets, shard: bool = True):
        batch = (np.asarray(images), tuple(np.asarray(t) for t in targets))
        if shard and self.mesh.devices.size > 1:
            if self._spatial:
                from ..parallel.spatial import shard_spatial_batch

                return shard_spatial_batch(batch[0], batch[1], self.mesh)
            return shard_batch(batch, self.mesh)
        return batch

    def train_one_epoch(self, train_ds, train_loader, logger):
        from ..data.loader import prefetch_to_device
        from ..parallel.mesh import batch_sharding

        tots = {}
        n = 0
        # double-buffered device placement: batch N+1's host->HBM transfer
        # (sharded over the mesh when DP) overlaps batch N's step
        if self.mesh.devices.size > 1 and self._spatial:
            from ..parallel.spatial import shard_spatial_batch

            sharding = lambda b: shard_spatial_batch(b[0], b[1], self.mesh)
        elif self.mesh.devices.size > 1:
            sharding = batch_sharding(self.mesh)
        else:
            sharding = None
        batches = prefetch_to_device(train_loader, size=2, sharding=sharding)
        # accumulate metrics ON DEVICE: a per-step float()/int() would force
        # a scalar device->host sync every step (~30% overhead at ~100ms
        # steps); only the epoch-end conversion synchronizes
        dev_tots = None
        start_step = int(self.state.step)
        for batch_idx, (x, y) in enumerate(batches):
            if (
                self.cfg.multi_scale
                and (batch_idx + 1) % self.cfg.num_batch_to_resize == 0
            ):
                train_ds.change_scale()  # next batches re-bucket
            anchors = scaled_anchors_for(
                self.anchors, x.shape[1], self.model.strides
            )
            self.state, metrics = self.train_step(self.state, x, y, anchors)
            dev_tots = (
                metrics
                if dev_tots is None
                else jax.tree_util.tree_map(jnp.add, dev_tots, metrics)
            )
            n += 1
            if start_step + n >= self.cfg.max_num_steps:
                break
        # per-step lr series logged in one pass (reference logs per step,
        # code/train.py:73; evaluating the optax schedule per step would add
        # a device sync each iteration)
        for i in range(n):
            logger.log({"lr": float(self.schedule(start_step + i))})
        if dev_tots is not None:
            tots = {k: float(v) for k, v in dev_tots.items()}
        if not np.isfinite(tots.get("loss", 0.0)):
            raise ValueError("Nan loss")
        avg = {f"train_{k}": v / max(n, 1) for k, v in tots.items()}
        logger.log(avg)
        return avg.get("train_loss", 0.0)

    @property
    def _compute_dtype(self):
        return (
            jnp.bfloat16 if self.cfg.compute_dtype == "bfloat16" else jnp.float32
        )

    def val_one_epoch(self, val_loader, epoch, logger):
        if (epoch + 1) % 10 != 0:
            # plain epochs: loss-only pass. Metrics accumulate ON DEVICE
            # and sync once at epoch end, mirroring train_one_epoch — a
            # per-batch float(v) per metric would wait for the device and
            # copy to the host 5 times per batch
            dev_tots = None
            n = 0
            for x, y in val_loader:
                anchors = scaled_anchors_for(
                    self.anchors, x.shape[1], self.model.strides
                )
                x, y = self._put(x, y, shard=False)
                metrics = self.eval_step(self.state, x, y, anchors)
                dev_tots = (
                    metrics
                    if dev_tots is None
                    else jax.tree_util.tree_map(jnp.add, dev_tots, metrics)
                )
                n += 1
            tots = (
                {k: float(v) for k, v in dev_tots.items()} if dev_tots else {}
            )
            avg = {f"val_{k}": v / max(n, 1) for k, v in tots.items()}
            logger.log(avg)
            return avg.get("val_loss", 0.0), None

        # every-10th-epoch eval: ONE fused pass over the val set. Forward
        # runs once per batch and feeds loss, accuracy counters, and
        # decode/NMS/mAP together — the previous shape traversed the loader
        # three times with three compiled programs (3x the host-side
        # decode/augment cost on a 1-core host). Eval helpers share the
        # trainer's compute dtype so train/val loss and mAP never disagree
        # in precision.
        from .evaluate import (
            _jitted_map_batched,
            make_fused_eval_step,
            rows_from_eval_step,
        )

        step = make_fused_eval_step(
            self.model, cfg.CONF_THRESHOLD, self._compute_dtype
        )
        anchors = np.asarray(self.anchors, np.float32)
        dev_tots = None
        dev_counts = None
        n = 0
        # device-eval accumulators (arrays stay on device until the final
        # scalar mAP) vs host-eval row lists (reference-exact calc_map)
        pred_rows, pred_ok, true_rows, true_ok = [], [], [], []
        host_preds, host_trues = [], []
        data_idx = 0
        for x, y in val_loader:
            x, y = self._put(x, y, shard=False)
            metrics, counts, kept, mask, true = step(
                self.state.params,
                self.state.batch_stats,
                x,
                tuple(y),
                anchors,
                image_size=x.shape[1],
            )
            dev_tots = (
                metrics
                if dev_tots is None
                else jax.tree_util.tree_map(jnp.add, dev_tots, metrics)
            )
            dev_counts = counts if dev_counts is None else dev_counts + counts
            n += 1
            if self.cfg.device_eval:
                pred_rows.append(kept)
                pred_ok.append(mask)
                true_rows.append(true)
                true_ok.append(true[..., 4] > cfg.CONF_THRESHOLD)
            else:
                p, t, data_idx = rows_from_eval_step(
                    kept, mask, true, data_idx, cfg.CONF_THRESHOLD
                )
                host_preds.extend(p)
                host_trues.extend(t)

        tots = (
            {k: float(v) for k, v in dev_tots.items()} if dev_tots else {}
        )
        avg = {f"val_{k}": v / max(n, 1) for k, v in tots.items()}
        logger.log(avg)

        counts = np.asarray(dev_counts) if dev_counts is not None else np.zeros(6)
        class_acc = float(counts[0] / (counts[1] + 1e-16))
        obj_acc = float(counts[2] / (counts[3] + 1e-16))
        noobj_acc = float(counts[4] / (counts[5] + 1e-16))

        if self.cfg.device_eval:
            mAP = float(
                _jitted_map_batched(
                    jnp.concatenate(pred_rows),
                    jnp.concatenate(pred_ok),
                    jnp.concatenate(true_rows),
                    jnp.concatenate(true_ok),
                    iou_threshold=cfg.MAP_IOU_THRESHOLD,
                    num_classes=self.model_cfg.num_classes,
                )
            )
        else:
            from ..ops.map import calc_map

            mAP = calc_map(
                host_preds,
                host_trues,
                iou_threshold=cfg.MAP_IOU_THRESHOLD,
                box_format="center",
                num_classes=self.model_cfg.num_classes,
            )
        logger.log(
            {
                "class_accuracy": class_acc,
                "noobj_accuracy": noobj_acc,
                "obj_accuracy": obj_acc,
                "mAP": mAP,
            }
        )
        if self.report_callback is not None:
            self.report_callback({"mAP": mAP})
        return avg.get("val_loss", 0.0), mAP


class HPOTrainFn:
    """Picklable adapter for the ASHA driver (train.hpo.tune_model).

    Calling trains `num_epochs` *additional* epochs, evaluating mAP at the
    end of the budget, carrying (Trainer, loaders) across rungs so promoted
    trials resume instead of restarting (matching Ray Tune's in-process
    session.report flow, reference code/train.py:153,252-270). Picklability
    is what lets `tune_model(max_concurrent>1)` ship it to spawned trial
    workers — the resume state then lives inside each worker process.
    """

    def __init__(
        self,
        csv_folder_path,
        model_folder_path,
        image_folder=None,
        annotation_folder=None,
        anchors=cfg.TURBINE_ANCHORS,
        weights_path=None,
        num_workers: int = 8,
    ):
        self.csv_folder_path = csv_folder_path
        self.model_folder_path = model_folder_path
        self.image_folder = image_folder
        self.annotation_folder = annotation_folder
        self.anchors = np.asarray(anchors, np.float32)
        self.weights_path = weights_path
        self.num_workers = num_workers

    def __call__(self, config, num_epochs, resume_state):
        tc = (
            config
            if isinstance(config, TrainConfig)
            else TrainConfig(
                **{
                    k: v
                    for k, v in config.items()
                    if k in TrainConfig.__dataclass_fields__
                }
            )
        )
        if resume_state is None:
            trainer = Trainer(
                tc, anchors=self.anchors, weights_path=self.weights_path
            )
            loaders = get_loaders(
                self.csv_folder_path,
                batch_size=tc.batch_size,
                anchors=self.anchors,
                train=True,
                image_folder=self.image_folder,
                annotation_folder=self.annotation_folder,
                num_workers=self.num_workers,
                mosaic=tc.mosaic,
                cache_images=tc.cache_images,
                image_size=tc.image_size,
            )
            import hashlib

            cfg_repr = str(
                sorted(config.items()) if isinstance(config, dict) else config
            )
            # stable across processes (unlike hash(), which is salted by
            # PYTHONHASHSEED) so trial logs keep one name under HPO resume
            trial_id = hashlib.sha1(cfg_repr.encode()).hexdigest()[:8]
            logger = MetricsLogger(
                f"hpo_trial_{trial_id}", out_dir=self.model_folder_path
            )
            epoch = 0
        else:
            trainer, loaders, logger, epoch = resume_state
        train_loader, val_loader, train_ds = loaders

        for _ in range(num_epochs):
            trainer.train_one_epoch(train_ds, train_loader, logger)
            epoch += 1
        mAP = evaluate_map(
            val_loader,
            trainer.model,
            trainer.state,
            trainer.anchors,
            num_classes=trainer.model_cfg.num_classes,
        )
        logger.log({"mAP": mAP, "epoch": epoch})
        return mAP, (trainer, loaders, logger, epoch)


def make_hpo_train_fn(
    csv_folder_path,
    model_folder_path,
    image_folder=None,
    annotation_folder=None,
    anchors=cfg.TURBINE_ANCHORS,
    weights_path=None,
    num_workers: int = 8,
):
    """Build the picklable HPOTrainFn adapter (see HPOTrainFn). mAP is
    evaluated once per ASHA rung boundary — the rung budget is the eval
    cadence, as in the reference's session.report flow."""
    return HPOTrainFn(
        csv_folder_path,
        model_folder_path,
        image_folder=image_folder,
        annotation_folder=annotation_folder,
        anchors=anchors,
        weights_path=weights_path,
        num_workers=num_workers,
    )


def train(
    hyperparam_config,
    csv_folder_path,
    model_folder_path,
    identifier: str,
    early_stop: int,
    checkpoint_name: Optional[str] = None,
    image_folder=None,
    annotation_folder=None,
    anchors=cfg.TURBINE_ANCHORS,
    weights_path=None,
    report_callback=None,
    num_workers: int = 8,
    backbone: str = "darknet53",
    num_classes: int = cfg.NUM_TURBINE_CLASSES,
) -> float:
    """Reference-parity train() entry (code/train.py:158-239). Returns best mAP."""
    if isinstance(hyperparam_config, TrainConfig):
        tc = hyperparam_config
    else:
        tc = TrainConfig(
            **{
                k: v
                for k, v in hyperparam_config.items()
                if k in TrainConfig.__dataclass_fields__
            }
        )
    # the anchors belong in the run config (the reference logs its whole
    # hyperparam dict, code/train.py:164): a custom-anchor run (BASELINE
    # config #3) must be auditable from the metrics file alone
    run_config = json.loads(tc.to_json())
    run_config["anchors"] = np.asarray(anchors, np.float32).tolist()
    run_config["backbone"] = backbone
    logger = MetricsLogger(
        f"YOLOv3_Turbine_Detection_{identifier}",
        config=run_config,
        out_dir=model_folder_path,
    )
    trainer = Trainer(
        tc,
        model_cfg=ModelConfig(
            num_classes=num_classes,
            activation=tc.activation,
            backbone=backbone,
        ),
        anchors=anchors,
        weights_path=weights_path,
        report_callback=report_callback,
    )
    if tc.load_checkpoint and checkpoint_name:
        trainer.state = load_checkpoint(
            trainer.state, Path(model_folder_path) / checkpoint_name, tc.lr
        )

    train_loader, val_loader, train_ds = get_loaders(
        csv_folder_path,
        batch_size=tc.batch_size,
        anchors=anchors,
        train=True,
        image_folder=image_folder,
        annotation_folder=annotation_folder,
        num_workers=num_workers,
        mosaic=tc.mosaic,
        cache_images=tc.cache_images,
        image_size=tc.image_size,
        strides=trainer.model.strides,
    )

    best_map = 0.0
    # host-side snapshot: the jitted step donates (and deletes) device state,
    # so the best state must be copied out, not aliased
    best_state = jax.device_get(trainer.state)
    epoch = 0
    num_epochs = max(1, tc.max_num_steps // max(len(train_loader), 1))
    early_stop_limit = early_stop
    start = time.time()
    ckpt_path = Path(model_folder_path) / f"best_model_{identifier}.ckpt"

    # the step cap also gates the epoch loop: a RESUMED state starts at its
    # checkpointed step, so without this a resume would spin through the
    # remaining epochs as empty train passes (one device sync per epoch)
    while (
        epoch < num_epochs
        and early_stop > 0
        and int(trainer.state.step) < tc.max_num_steps
    ):
        # train_one_epoch / val_one_epoch already log train_/val_ metric
        # averages; logging the scalars again here would duplicate JSONL rows
        train_loss = trainer.train_one_epoch(train_ds, train_loader, logger)
        val_loss, mAP = trainer.val_one_epoch(val_loader, epoch, logger)
        if mAP is not None:
            if mAP > best_map:
                best_map, best_state = mAP, jax.device_get(trainer.state)
                early_stop = early_stop_limit
            elif mAP < best_map:
                early_stop -= 1
        epoch += 1
        if num_epochs >= 4 and (epoch + 1) % max(1, int(0.25 * num_epochs)) == 0:
            save_checkpoint(best_state, ckpt_path)
            logger.log_model(ckpt_path, f"best_model_{identifier}")
        logger.log({"time_elapsed_in_hours": (time.time() - start) / 3600})

    save_checkpoint(best_state, ckpt_path)
    logger.log_model(ckpt_path, f"best_model_{identifier}")
    logger.finish()
    return best_map
