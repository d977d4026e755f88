"""End-to-end inference pipeline: letterbox -> jit forward -> decode -> NMS.

Reproduces the reference's demo path (reference: code/demo.py:30-66) as one
compiled device program per image size: the folded-BN forward (conv + bias +
activation only), the three-scale decode, and fixed-shape class-aware NMS all
run in a single jit call; only the K NMS survivors per image come back to the
host. Boxes are finally mapped back to the original image frame
(un-letterbox, reference: code/utils.py:475-501).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import config as cfg
from .data.augment import letterbox, unletterbox_boxes
from .models.yolov3 import YOLOv3
from .ops.decode import decode_all_scales
from .ops.nms import batched_nms, default_use_pallas_nms, nms_to_list


class Predictor:
    """Bundles a model plan + folded params with a jitted predict function.

    One compiled executable per (batch_size, image_size) bucket; compile
    cache is keyed by input shape via jit. `use_pallas_nms=None` takes the
    platform's choice (`ops.nms.default_use_pallas_nms`).
    """

    def __init__(
        self,
        model: YOLOv3,
        folded_params,
        anchors=cfg.ANCHORS,
        image_size: int = cfg.DEF_IMAGE_SIZE,
        conf_threshold: float = cfg.CONF_THRESHOLD,
        nms_iou_threshold: float = cfg.NMS_IOU_THRESHOLD,
        max_boxes: int = 256,
        compute_dtype=jnp.bfloat16,
        use_pallas_nms: Optional[bool] = None,
        mesh=None,
    ):
        self.model = model
        # keep the caller's full-precision folded tree for quantize() --
        # int8 scales/codes should not compound bf16 pre-cast rounding.
        # Held as HOST numpy (not device arrays): a second full-precision
        # device copy would roughly double weight HBM for a predictor that
        # may never quantize; jit transfers it on demand when quantize() runs
        self._folded_input = jax.device_get(folded_params)
        # pre-cast weights to the compute dtype once: halves weight HBM
        # traffic per conv and removes the per-call f32->bf16 cast pass
        self.folded_params = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, compute_dtype)
            if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)
            else x,
            folded_params,
        )
        self.anchors = np.asarray(anchors, np.float32)
        self.image_size = image_size
        self.conf_threshold = conf_threshold
        self.nms_iou_threshold = nms_iou_threshold
        self.max_boxes = max_boxes
        self.compute_dtype = compute_dtype
        if use_pallas_nms is None:
            use_pallas_nms = default_use_pallas_nms()
        self.use_pallas_nms = use_pallas_nms
        self.mesh = mesh
        from .parallel.spatial import SPACE_AXIS

        self._spatial = mesh is not None and SPACE_AXIS in mesh.axis_names
        if mesh is None:
            self._jitted = jax.jit(
                functools.partial(self._pipeline),
                static_argnames=("image_size",),
            )
        elif self._spatial:
            # Spatial partitioning (parallel/spatial.py): the image's ROWS
            # shard over the "space" axis so N chips jointly hold one
            # high-resolution activation. Plain jit with sharding
            # annotations — NOT shard_map: every conv needs the halo rows
            # of its neighbor shard, which only the GSPMD partitioner can
            # derive and exchange; a shard_map body would zero-pad the
            # shard boundary and compute wrong pixels.
            from jax.sharding import NamedSharding, PartitionSpec as P

            from .parallel.spatial import spatial_image_sharding

            # A Pallas kernel is a per-shard custom call GSPMD cannot
            # partition across the row axis; the XLA NMS partitions fine
            # and is what SP uses.
            self.use_pallas_nms = False
            repl = NamedSharding(mesh, P())
            x_sh = spatial_image_sharding(mesh)

            # pjit rejects kwargs when in_shardings is given, so bind the
            # static image_size per compiled bucket (same caching pattern
            # as the shard_map branch below)
            sp_cache = {}

            def sp_jitted(params, x, *, image_size):
                if image_size not in sp_cache:
                    sp_cache[image_size] = jax.jit(
                        functools.partial(
                            self._pipeline, image_size=image_size
                        ),
                        in_shardings=(repl, x_sh),
                        out_shardings=(repl, repl),
                    )
                return sp_cache[image_size](params, x)

            self._jitted = sp_jitted
        else:
            # Multi-chip serving: the pipeline is embarrassingly parallel
            # per image (forward + decode + NMS, zero cross-image
            # communication), so shard_map over the mesh's data axis runs
            # each device on its local batch shard with local shapes — the
            # Pallas NMS kernel works unchanged per shard (check_vma=False:
            # see nms_kernel.greedy_sweep_pallas; with no collective inside
            # there is nothing for the check to catch). Params replicate;
            # batch must divide the mesh size (see
            # parallel.mesh.pad_batch_to_multiple for ragged tails).
            from jax import shard_map
            from jax.sharding import PartitionSpec as P

            from .parallel.mesh import batch_sharding

            batch_spec = batch_sharding(mesh).spec

            def make(image_size):
                local = functools.partial(
                    self._pipeline, image_size=image_size
                )
                return jax.jit(
                    shard_map(
                        local,
                        mesh=mesh,
                        in_specs=(P(), batch_spec),
                        out_specs=(batch_spec, batch_spec),
                        check_vma=False,
                    )
                )

            cache = {}

            def jitted(params, x, *, image_size):
                if image_size not in cache:
                    cache[image_size] = make(image_size)
                return cache[image_size](params, x)

            self._jitted = jitted

    def quantize(self, calib_batch) -> "Predictor":
        """Switch this predictor to the int8 PTQ path (models/quantize.py):
        int8 convs with f32 sums, bf16 heads. `calib_batch` is a
        representative (N, S, S, 3) [0,1] batch for activation-scale
        calibration. Returns self."""
        from .models.quantize import quantize_folded

        self._qparams = quantize_folded(
            self.model.plan,
            self._folded_input,
            jnp.asarray(calib_batch, jnp.float32),
            self.model.cfg.activation,
        )
        return self

    def _pipeline(self, params, x, *, image_size: int):
        from .ops.decode import decode_raw_all

        grid_sizes = cfg.grid_sizes_for(image_size, self.model.strides)
        scaled_anchors = jnp.asarray(self.anchors) * jnp.asarray(
            grid_sizes, jnp.float32
        ).reshape(-1, 1, 1)
        # int8 params arrive through the same traced argument (structure is
        # static per trace, so this python-level branch is jit-safe)
        if isinstance(params, dict) and "scales" in params:
            from .models.quantize import apply_inference_int8

            raw = apply_inference_int8(
                self.model.plan, params, x,
                activation=self.model.cfg.activation, raw_heads=True,
                compute_dtype=self.compute_dtype,
            )
            boxes = decode_raw_all(
                raw, scaled_anchors, grid_sizes, self.model.cfg.num_classes
            )
            kept, mask = batched_nms(
                boxes,
                iou_threshold=self.nms_iou_threshold,
                obj_threshold=self.conf_threshold,
                max_boxes=self.max_boxes,
                use_pallas=self.use_pallas_nms,
            )
            return kept, mask
        # raw-head fast path: decode consumes the NHWC conv output directly,
        # skipping the (B, A, S, S, 5+C) transpose + f32 materialization
        raw = self.model.apply_folded(
            params, x, compute_dtype=self.compute_dtype, raw_heads=True
        )
        boxes = decode_raw_all(
            raw, scaled_anchors, grid_sizes, self.model.cfg.num_classes
        )
        kept, mask = batched_nms(
            boxes,
            iou_threshold=self.nms_iou_threshold,
            obj_threshold=self.conf_threshold,
            max_boxes=self.max_boxes,
            use_pallas=self.use_pallas_nms,
        )
        return kept, mask

    def predict_batch(self, x) -> Tuple[np.ndarray, np.ndarray]:
        """x: (B, S, S, 3) float in [0, 1]. Returns ((B, K, 6), (B, K)).

        With a mesh, B must be a multiple of the mesh size (pad ragged
        tails with parallel.mesh.pad_batch_to_multiple)."""
        if self.mesh is not None and self._spatial:
            from .parallel.spatial import spatial_image_sharding

            x = jax.device_put(
                jnp.asarray(x), spatial_image_sharding(self.mesh)
            )
        elif self.mesh is not None:
            from .parallel.mesh import batch_sharding

            x = jax.device_put(jnp.asarray(x), batch_sharding(self.mesh))
        params = getattr(self, "_qparams", None) or self.folded_params
        kept, mask = self._jitted(params, x, image_size=x.shape[1])
        return kept, mask

    def predict_images(
        self, np_images: List[np.ndarray], num_threads: int = 0
    ) -> List[List[List[float]]]:
        """Batched serving path: native C++ letterbox packer (threaded,
        pooled buffer) -> one jitted device program -> per-image boxes in
        each original frame."""
        from .native import batch_letterbox

        x = batch_letterbox(
            np_images, self.image_size, num_threads=num_threads,
            reuse_buffer=True,
        )
        kept, mask = self.predict_batch(x)
        kept, mask = np.asarray(kept), np.asarray(mask)
        results = []
        for i, img in enumerate(np_images):
            boxes = nms_to_list(kept[i], mask[i])
            results.append(
                unletterbox_boxes(
                    boxes, img.shape[:2], (self.image_size, self.image_size)
                )
            )
        return results

    def predict_image(self, np_image: np.ndarray) -> List[List[float]]:
        """Full demo path for one HWC uint8 image: returns NMS boxes in the
        *original* image's normalized frame [cx, cy, w, h, score, class]."""
        h0, w0 = np_image.shape[:2]
        img, _ = letterbox(np_image, None, self.image_size)
        x = (img.astype(np.float32) / 255.0)[None]
        kept, mask = self.predict_batch(x)
        boxes = nms_to_list(kept[0], mask[0])
        return unletterbox_boxes(
            boxes, (h0, w0), (self.image_size, self.image_size)
        )


def load_predictor_from_checkpoint(
    checkpoint_path: str,
    num_classes: int = cfg.NUM_TURBINE_CLASSES,
    activation: str = "mish",
    anchors=cfg.TURBINE_ANCHORS,
    image_size: int = cfg.DEF_IMAGE_SIZE,
    conf_threshold: float = cfg.CONF_THRESHOLD,
    nms_iou_threshold: float = cfg.NMS_IOU_THRESHOLD,
    seed: int = 0,
    backbone: str = "darknet53",
) -> Predictor:
    """Build a Predictor from an orbax training checkpoint (the serving
    analogue of the reference demo's pickled-model load, code/demo.py:16-28:
    trained turbine weights rather than the official binary).

    `backbone` must match the checkpoint's training backbone (darknet53 /
    cspdarknet53 / yolov3_tiny) — the checkpoint's pytree structure is
    backbone-shaped, so a mismatch fails inside orbax restore."""
    from .config import TrainConfig
    from .train.checkpoint import load_checkpoint
    from .train.steps import create_train_state

    strides = (32, 16) if backbone == "yolov3_tiny" else (32, 16, 8)
    model = YOLOv3(
        cfg.ModelConfig(
            num_classes=num_classes,
            activation=activation,
            backbone=backbone,
            strides=strides,
        )
    )
    state, _, _ = create_train_state(
        model, TrainConfig(), rng=jax.random.PRNGKey(seed)
    )
    state = load_checkpoint(state, checkpoint_path)
    folded = model.fold(state.params, state.batch_stats)
    return Predictor(
        model,
        folded,
        anchors=anchors,
        image_size=image_size,
        conf_threshold=conf_threshold,
        nms_iou_threshold=nms_iou_threshold,
    )


def load_predictor(
    weights_path: str,
    num_classes: int = cfg.NUM_COCO_CLASSES,
    activation: str = "leaky_relu",
    anchors=cfg.ANCHORS,
    image_size: int = cfg.DEF_IMAGE_SIZE,
    conf_threshold: float = cfg.CONF_THRESHOLD,
    nms_iou_threshold: float = cfg.NMS_IOU_THRESHOLD,
    seed: int = 0,
    backbone: str = "darknet53",
) -> Predictor:
    """Build a Predictor from an official darknet weight file.

    For yolov3-tiny: backbone="yolov3_tiny" + anchors=config.TINY_ANCHORS
    (strides follow the backbone automatically)."""
    from .models.darknet_weights import load_darknet_weights

    strides = (32, 16) if backbone == "yolov3_tiny" else (32, 16, 8)
    model = YOLOv3(
        cfg.ModelConfig(
            num_classes=num_classes,
            activation=activation,
            backbone=backbone,
            strides=strides,
        )
    )
    params, stats = model.init(jax.random.PRNGKey(seed))
    params, stats, _, _ = load_darknet_weights(weights_path, model.plan, params, stats)
    folded = model.fold(params, stats)
    return Predictor(
        model,
        folded,
        anchors=anchors,
        image_size=image_size,
        conf_threshold=conf_threshold,
        nms_iou_threshold=nms_iou_threshold,
    )
