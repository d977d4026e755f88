"""Smoke test of the main paths on the GPU, each checked against a reference.

    python chip_smoke.py            # one card: inference, nms, train, export
    python chip_smoke.py --cards 4  # four cards: the multi-card paths only

The script refuses to run unless JAX's first device is a GPU. It prints the
cards' names and power limits, then one JSON line of findings per phase, and
exits non-zero at the first failed check. The last line of standard output
is {"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.

Phases (one card):
- inference: the flagship 80-class Darknet-53 YOLOv3 at 416 px, built as
  bench.py builds it (folded BN, bf16), through `Predictor.predict_batch` at
  B=1 and B=128. Raw heads are compared with a float32 reference run under
  `jax.default_matmul_precision("highest")` (otherwise a float32 matmul on
  this card runs in TF32), and the card's float32 with the CPU's.
- nms: 10647 candidates -> K=256 at B=1 and B=128. The Triton sweep and the
  XLA sweep must give identical keep masks; both are timed alone and inside
  the whole Predictor program.
- train: full-width Darknet-53, 2 classes, mish, 416 px, batch 32, bf16,
  through `create_train_state` + `make_train_step` on targets from the
  repo's own assignment. Step 1's loss against a float32 "highest" step;
  five more steps on the same batch must lower the loss.
- export: a B=1 serve module exported for ("cpu", "cuda"), serialized and
  deserialized (where the flatbuffers package exists) and run on the card,
  against the live Predictor; the int8 path at B=8 against the float32
  reference, beside the CPU's int8.

With --cards 4 only the multi-card paths run, each against the same work on
one card: a data-parallel train step, the shard_map Predictor, and one
data x space (DP x SP) train step.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib.util
import json
import shutil
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from yolo_for_turbines_tpu import config as cfg
from yolo_for_turbines_tpu.config import ModelConfig, TrainConfig
from yolo_for_turbines_tpu.inference import Predictor
from yolo_for_turbines_tpu.models.blocks import BN_MOMENTUM
from yolo_for_turbines_tpu.models.yolov3 import YOLOv3
from yolo_for_turbines_tpu.ops.nms import batched_nms
from yolo_for_turbines_tpu.utils.profiling import (
    enable_compilation_cache,
    gpu_cards,
    require_gpu,
)

# The card's bf16 (or int8) error against its own float32 may be at most
# this many times the CPU's error of the same path against the CPU's
# float32, on the same weights and input: both round at the same layers.
# A random network with unit-scale activations amplifies rounding layer by
# layer, so the error itself is large (~0.1-0.3 relative at 128 px); a
# wrong kernel gives ~1.4 (uncorrelated heads of equal norm).
VS_CPU_FACTOR = 2.0
# Float32 "highest" on the card vs float32 on the CPU: the same arithmetic
# summed in another order. TF32 (10-bit mantissa) would miss this by ~10x.
F32_REL_TOL = 1e-4
# bf16 train step vs float32 "highest": the loss is a mean over every cell
# of the batch, so it inherits the heads' bf16 drift (~1e-2) at most.
TRAIN_LOSS_REL_TOL = 2e-2
# Without warmup, the default lr (1e-3) overshoots from a random init within
# a few momentum steps; the smoke asks only that the step learns.
TRAIN_LR = 1e-4
# Same f32 "highest" step on one card and sharded over four: only the order
# of the cross-card sums (BN moments, gradient all-reduce) differs.
SHARDED_LOSS_REL_TOL = 1e-4
SHARDED_UPDATE_REL_TOL = 1e-3


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of a run. The defaults are the real ones; CPU rehearsals of
    this script pass a smaller model and image."""

    image: int = 416
    batch: int = 128
    train_batch: int = 32
    layer_config: Optional[tuple] = None  # None: full Darknet-53
    nms_candidates: int = 10647
    nms_k: int = 256
    iters: int = 20


class SmokeFailure(AssertionError):
    pass


def check(cond, what: str, **detail):
    if not cond:
        raise SmokeFailure(f"{what}: {json.dumps(detail, default=str)}")


def emit(phase: str, **findings):
    print(json.dumps({"phase": phase, **findings}, default=str), flush=True)


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| over a list of arrays, in float64."""
    num = den = 0.0
    for g, w in zip(got, want):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        num += float(np.sum((g - w) ** 2))
        den += float(np.sum(w**2))
    return float(np.sqrt(num / max(den, 1e-300)))


def median_times(fns: dict, iters: int, warmup: int = 2) -> dict:
    """Median seconds per call of each fn, each call ended by
    block_until_ready; calls of the fns alternate so drift hits all alike."""
    for fn in fns.values():
        for _ in range(warmup):
            jax.block_until_ready(fn())
    samples = {k: [] for k in fns}
    for _ in range(iters):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            samples[k].append(time.perf_counter() - t0)
    return {k: float(np.median(v)) for k, v in samples.items()}


def calibrated_stats(model, params, stats, x):
    """BN running statistics set to the moments of one train-mode pass.

    With the init statistics (mean 0, var 1) a random Darknet-53's
    activations shrink layer by layer until its heads barely depend on the
    input (1e-4 relative change between two images), which would make every
    comparison below vacuous. Batch moments keep each layer at unit scale,
    as in a trained network."""
    _, new = jax.jit(
        functools.partial(model.apply, train=True, compute_dtype=jnp.float32)
    )(params, stats, x)
    m = BN_MOMENTUM
    return jax.tree_util.tree_map(lambda n, o: (n - (1 - m) * o) / m, new, stats)


def flagship(sizes: Sizes, x_calib):
    """The 80-class YOLOv3 folded as bench.py folds it, with random weights
    and calibrated BN statistics."""
    model = YOLOv3(ModelConfig(num_classes=80, layer_config=sizes.layer_config))
    params, stats = model.init(jax.random.PRNGKey(0))
    stats = calibrated_stats(model, params, stats, x_calib)
    return model, model.fold(params, stats)


def raw_heads_fn(model, dtype):
    return jax.jit(
        functools.partial(model.apply_folded, compute_dtype=dtype, raw_heads=True)
    )


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_inference(model, folded, pred, x, sizes: Sizes):
    s = sizes.image
    cells = sum(g * g for g in cfg.grid_sizes_for(s)) * model.cfg.anchors_per_scale
    k = min(pred.max_boxes, cells)
    runs = {}
    for xb in (x[:1], x):
        b = xb.shape[0]
        kept, mask = pred.predict_batch(xb)
        kept, mask = np.asarray(kept), np.asarray(mask)
        check(kept.shape == (b, k, 6) and mask.shape == (b, k), "output shape",
              kept=kept.shape, mask=mask.shape)
        check(bool(np.isfinite(kept[mask]).all()), "finite kept boxes")
        runs[f"b{b}_kept"] = int(mask.sum())
    mem = pred._jitted.lower(
        pred.folded_params, x, image_size=s
    ).compile().memory_analysis()
    memory = {
        f: getattr(mem, f, None)
        for f in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes",
        )
    }

    cpu = jax.devices("cpu")[0]
    x1 = x[:1]
    bf16, f32 = raw_heads_fn(model, jnp.bfloat16), raw_heads_fn(model, jnp.float32)
    card_bf16 = bf16(pred.folded_params, x1)
    card_bf16_batch = [h[:1] for h in bf16(pred.folded_params, x)]
    cpu_x1 = jax.device_put(x1, cpu)
    cpu_bf16 = bf16(jax.device_put(pred.folded_params, cpu), cpu_x1)
    with jax.default_matmul_precision("highest"):
        card_f32 = f32(folded, x1)
        cpu_f32 = f32(jax.device_put(folded, cpu), cpu_x1)
    e_f32 = rel_err(card_f32, cpu_f32)
    e_cpu = rel_err(cpu_bf16, cpu_f32)
    e_card = rel_err(card_bf16, card_f32)
    e_card_batch = rel_err(card_bf16_batch, card_f32)
    bar = VS_CPU_FACTOR * e_cpu
    emit(
        "inference",
        **runs,
        memory_analysis_b128=memory,
        f32_highest_card_vs_cpu=e_f32,
        f32_tolerance=F32_REL_TOL,
        bf16_vs_f32_cpu=e_cpu,
        bf16_vs_f32_card_b1=e_card,
        bf16_vs_f32_card_b128_image0=e_card_batch,
        bf16_tolerance=bar,
        precision="bf16 compute vs f32 under matmul precision 'highest'; "
        "relative L2 error over the three raw heads of image 0",
    )
    check(e_f32 <= F32_REL_TOL, "card f32 'highest' vs CPU f32", err=e_f32)
    check(e_card <= bar, "card bf16 error at B=1", err=e_card, bar=bar)
    check(e_card_batch <= bar, "card bf16 error at B=128", err=e_card_batch,
          bar=bar)
    return {"card_f32": card_f32, "cpu_f32": cpu_f32, "cpu_x1": cpu_x1}


def nms_candidates(rng, b: int, n: int) -> jnp.ndarray:
    """Random candidates whose boxes overlap across the 0.45 threshold."""
    boxes = np.zeros((b, n, 6), np.float32)
    boxes[..., 0:2] = rng.uniform(0.3, 0.7, (b, n, 2))
    boxes[..., 2:4] = rng.uniform(0.05, 0.4, (b, n, 2))
    boxes[..., 4] = rng.uniform(0, 1, (b, n))
    boxes[..., 5] = rng.integers(0, 4, (b, n))
    return jnp.asarray(boxes)


def phase_nms(model, folded, x, sizes: Sizes):
    rng = np.random.default_rng(2)
    nms = {
        name: jax.jit(
            functools.partial(
                batched_nms,
                iou_threshold=cfg.NMS_IOU_THRESHOLD,
                obj_threshold=cfg.CONF_THRESHOLD,
                max_boxes=sizes.nms_k,
                use_pallas=use,
            )
        )
        for name, use in (("kernel", True), ("xla", False))
    }
    preds = {
        name: Predictor(model, folded, image_size=sizes.image,
                        use_pallas_nms=use)
        for name, use in (("kernel", True), ("xla", False))
    }
    findings = {}
    for b in (1, sizes.batch):
        cand = nms_candidates(rng, b, sizes.nms_candidates)
        kept_k, keep_k = map(np.asarray, nms["kernel"](cand))
        kept_x, keep_x = map(np.asarray, nms["xla"](cand))
        check(np.array_equal(keep_k, keep_x), f"keep masks differ at B={b}",
              differing=int((keep_k != keep_x).sum()))
        check(np.array_equal(kept_k, kept_x), f"candidates differ at B={b}")
        alone = median_times(
            {k: functools.partial(f, cand) for k, f in nms.items()},
            sizes.iters,
        )
        xb = x[:b]
        whole = median_times(
            {k: functools.partial(p.predict_batch, xb) for k, p in preds.items()},
            sizes.iters,
        )
        findings[f"b{b}"] = {
            "kept": int(keep_k.sum()),
            "candidates_valid": int(np.asarray(cand[..., 4] > cfg.CONF_THRESHOLD).sum()),
            "nms_alone_ms": {k: v * 1e3 for k, v in alone.items()},
            "predictor_ms": {k: v * 1e3 for k, v in whole.items()},
        }
    emit(
        "nms",
        masks="identical",
        timing="median of per-call wall times ended by block_until_ready, "
        "kernel and xla calls alternating",
        **findings,
    )


def synthetic_train_batch(rng, b: int, size: int):
    """Random images plus targets built by the repo's own assignment
    (data.dataset.assign_targets) from 1-5 random boxes per image."""
    from yolo_for_turbines_tpu.data.dataset import assign_targets

    anchors = np.asarray(cfg.TURBINE_ANCHORS, np.float32)
    grids = cfg.grid_sizes_for(size)
    images = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    per_image = []
    for _ in range(b):
        n = int(rng.integers(1, 6))
        boxes = np.concatenate(
            [
                rng.uniform(0.1, 0.9, (n, 2)),
                rng.uniform(0.05, 0.5, (n, 2)),
                rng.integers(0, cfg.NUM_TURBINE_CLASSES, (n, 1)),
            ],
            axis=1,
        )
        per_image.append(assign_targets(boxes, anchors.reshape(-1, 2), grids))
    targets = tuple(
        np.stack([t[i] for t in per_image]) for i in range(len(grids))
    )
    scaled = cfg.scaled_anchors_array(cfg.TURBINE_ANCHORS, size)
    return jnp.asarray(images), tuple(map(jnp.asarray, targets)), jnp.asarray(scaled)


def train_setup(sizes: Sizes, compute_dtype: str, mesh=None):
    from yolo_for_turbines_tpu.train.steps import create_train_state, make_train_step

    model = YOLOv3(
        ModelConfig(
            num_classes=cfg.NUM_TURBINE_CLASSES, activation="mish",
            layer_config=sizes.layer_config,
        )
    )
    tc = TrainConfig(
        batch_size=sizes.train_batch, warmup_enabled=False, lr=TRAIN_LR,
        compute_dtype=compute_dtype,
    )
    state, tx, _ = create_train_state(model, tc, rng=jax.random.PRNGKey(1))
    return state, make_train_step(model, tx, tc, mesh=mesh)


def phase_train(sizes: Sizes):
    images, targets, anchors = synthetic_train_batch(
        np.random.default_rng(3), sizes.train_batch, sizes.image
    )
    state32, step32 = train_setup(sizes, "float32")
    with jax.default_matmul_precision("highest"):
        _, m32 = step32(state32, images, targets, anchors)
    loss32 = float(m32["loss"])
    del state32

    state, step = train_setup(sizes, "bfloat16")
    losses = []
    for _ in range(6):
        state, m = step(state, images, targets, anchors)
        losses.append(float(m["loss"]))
    stats = jax.devices()[0].memory_stats() or {}
    err = abs(losses[0] - loss32) / abs(loss32)
    emit(
        "train",
        loss_step1_bf16=losses[0],
        loss_step1_f32_highest=loss32,
        loss_rel_err=err,
        loss_tolerance=TRAIN_LOSS_REL_TOL,
        losses_bf16=losses,
        peak_bytes_in_use=stats.get("peak_bytes_in_use"),
        precision="bf16 compute, f32 params; reference f32 compute under "
        "matmul precision 'highest'",
    )
    check(all(np.isfinite(losses)), "finite losses", losses=losses)
    check(err <= TRAIN_LOSS_REL_TOL, "bf16 step-1 loss vs f32", err=err)
    check(losses[-1] < losses[0], "five more steps lower the loss",
          losses=losses)


def _cosine(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def phase_export(model, folded, pred, x, ref, sizes: Sizes):
    from yolo_for_turbines_tpu.models.quantize import apply_inference_int8
    from yolo_for_turbines_tpu.ops.decode import decode_raw_all
    from yolo_for_turbines_tpu.serving import export_serving

    x1 = x[:1]
    exported = export_serving(pred, batch_size=1, platforms=("cpu", "cuda"))
    # jax.export (de)serialization needs the flatbuffers package; where it
    # is missing the module is called as exported, without the round trip
    serialized = importlib.util.find_spec("flatbuffers") is not None
    if serialized:
        exported = jax.export.deserialize(exported.serialize())
    platforms = sorted(p.lower() for p in exported.platforms)
    kept_e, mask_e = map(np.asarray, exported.call(pred.folded_params, x1))
    kept_l, mask_l = map(np.asarray, pred.predict_batch(x1))
    box_diff = float(np.abs(kept_e - kept_l).max())

    # int8 at B=8: against bf16 by the measures tests/test_quantize.py uses
    # (reported), and against f32 beside the CPU's int8 (checked)
    b8 = min(8, x.shape[0])
    x8 = x[:b8]
    q = Predictor(model, folded, image_size=sizes.image)
    q.quantize(x8)
    kept_q, mask_q = map(np.asarray, q.predict_batch(x8))
    int8 = jax.jit(
        functools.partial(
            apply_inference_int8, model.plan,
            activation=model.cfg.activation, raw_heads=True,
        )
    )
    raw_q = int8(q._qparams, x8)
    raw_b = raw_heads_fn(model, jnp.bfloat16)(pred.folded_params, x8)
    cpu = ref["cpu_x1"].devices().pop()
    e_card = rel_err([h[:1] for h in raw_q], ref["card_f32"])
    e_cpu = rel_err(
        int8(jax.device_put(q._qparams, cpu), ref["cpu_x1"]), ref["cpu_f32"]
    )
    cosines = [_cosine(a, b) for a, b in zip(raw_q, raw_b)]
    grids = cfg.grid_sizes_for(sizes.image)
    anchors = jnp.asarray(cfg.scaled_anchors_array(cfg.ANCHORS, sizes.image))
    bq, bb = (
        np.asarray(decode_raw_all(r, anchors, grids, model.cfg.num_classes))
        for r in (raw_q, raw_b)
    )
    ds = dc = 0.0
    for img in range(b8):
        top = np.argsort(-bb[img, :, 4])[:32]
        ds = max(ds, float(np.abs(bb[img, top, 4] - bq[img, top, 4]).max()))
        dc = max(dc, float(np.abs(bb[img, top, 0:2] - bq[img, top, 0:2]).max()))
    emit(
        "export",
        platforms=platforms,
        serialized_round_trip=serialized,
        exported_vs_live_masks_equal=bool(np.array_equal(mask_e, mask_l)),
        exported_vs_live_max_box_diff=box_diff,
        int8_compiled=True,
        int8_kept_b8=int(mask_q.sum()),
        int8_vs_f32_card=e_card,
        int8_vs_f32_cpu=e_cpu,
        int8_tolerance=VS_CPU_FACTOR * e_cpu,
        int8_vs_bf16_head_cosine=cosines,
        int8_vs_bf16_top32_score_diff=ds,
        int8_vs_bf16_top32_center_diff=dc,
        tolerance={"masks": "identical", "boxes": 0.0},
    )
    check(platforms == ["cpu", "cuda"], "export platforms", got=platforms)
    check(np.array_equal(mask_e, mask_l), "exported vs live keep mask")
    check(box_diff == 0.0, "exported vs live boxes", diff=box_diff)
    check(kept_q.shape == (b8,) + kept_l.shape[1:], "int8 output shape")
    check(bool(np.isfinite(kept_q[mask_q]).all()), "finite int8 boxes")
    check(e_card <= VS_CPU_FACTOR * e_cpu, "int8 error vs the CPU's",
          card=e_card, cpu=e_cpu)


def phase_cards(n: int, model, folded, x, sizes: Sizes):
    """Multi-card paths against the same work on one card."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from yolo_for_turbines_tpu.ops.decode import decode_raw_all
    from yolo_for_turbines_tpu.parallel.mesh import create_mesh, shard_batch
    from yolo_for_turbines_tpu.parallel.spatial import (
        create_spatial_mesh,
        shard_spatial_batch,
    )

    devices = jax.devices()
    check(len(devices) >= n, f"needs {n} devices", found=len(devices))
    found = {}

    # data-parallel train step, f32 "highest" on both sides
    images, targets, anchors = synthetic_train_batch(
        np.random.default_rng(3), sizes.train_batch, sizes.image
    )
    mesh = create_mesh(n)
    with jax.default_matmul_precision("highest"):
        state1, step1 = train_setup(sizes, "float32")
        p0 = jax.tree_util.tree_map(np.asarray, state1.params)
        new1, m1 = step1(state1, images, targets, anchors)
        stateN, stepN = train_setup(sizes, "float32", mesh=mesh)
        host = (np.asarray(images), tuple(map(np.asarray, targets)))
        newN, mN = stepN(stateN, *shard_batch(host, mesh), anchors)
    l1, lN = float(m1["loss"]), float(mN["loss"])
    leaves = jax.tree_util.tree_leaves
    d1 = [np.asarray(a) - b for a, b in zip(leaves(new1.params), leaves(p0))]
    dN = [np.asarray(a) - b for a, b in zip(leaves(newN.params), leaves(p0))]
    found["dp_train"] = {
        "loss_1card": l1, "loss_ncards": lN,
        "loss_rel_err": abs(lN - l1) / abs(l1),
        "update_rel_err": rel_err(dN, d1),
    }
    del new1, newN, state1, stateN

    # shard_map Predictor at B=128: raw heads, then NMS on identical
    # candidates, then the whole sharded program
    heads = raw_heads_fn(model, jnp.bfloat16)
    pred1 = Predictor(model, folded, image_size=sizes.image)
    predN = Predictor(model, folded, image_size=sizes.image, mesh=mesh)
    raw1 = heads(pred1.folded_params, x)
    spec = P("data")
    sharded = jax.sharding.NamedSharding(mesh, spec)
    rawN = jax.jit(
        shard_map(heads, mesh=mesh, in_specs=(P(), spec), out_specs=spec)
    )(pred1.folded_params, jax.device_put(x, sharded))
    with jax.default_matmul_precision("highest"):
        f32_1 = raw_heads_fn(model, jnp.float32)(folded, x[:1])
    e_bf16 = rel_err([h[:1] for h in raw1], f32_1)
    grids = cfg.grid_sizes_for(sizes.image)
    scaled = jnp.asarray(cfg.scaled_anchors_array(cfg.ANCHORS, sizes.image))
    boxes = decode_raw_all(raw1, scaled, grids, model.cfg.num_classes)
    nms = functools.partial(
        batched_nms, iou_threshold=cfg.NMS_IOU_THRESHOLD,
        obj_threshold=cfg.CONF_THRESHOLD, max_boxes=pred1.max_boxes,
        use_pallas=pred1.use_pallas_nms,
    )
    _, keep1 = jax.jit(nms)(boxes)
    _, keepN = jax.jit(
        shard_map(nms, mesh=mesh, in_specs=spec, out_specs=(spec, spec),
                  check_vma=False)
    )(jax.device_put(boxes, sharded))
    kept_p, mask_p = map(np.asarray, predN.predict_batch(x))
    _, mask_1 = map(np.asarray, pred1.predict_batch(x))
    found["sharded_predictor"] = {
        "raw_heads_rel_err": rel_err(rawN, raw1),
        "raw_heads_tolerance": 2 * e_bf16,
        "bf16_vs_f32_1card": e_bf16,
        "nms_masks_identical": bool(
            np.array_equal(np.asarray(keep1), np.asarray(keepN))
        ),
        "predictor_mask_agreement": float((mask_p == mask_1).mean()),
    }

    # one DP x SP train step (2 data x 2 space) on the same batch, against
    # the same one-card step
    sp_mesh = create_spatial_mesh(n_space=2, n_data=n // 2)
    with jax.default_matmul_precision("highest"):
        ssp, stsp = train_setup(sizes, "float32", mesh=sp_mesh)
        _, msp = stsp(ssp, *shard_spatial_batch(*host, sp_mesh), anchors)
    lsp = float(msp["loss"])
    found["dpxsp_train"] = {
        "mesh": dict(sp_mesh.shape), "batch": sizes.train_batch,
        "loss_1card": l1, "loss_dpxsp": lsp,
        "loss_rel_err": abs(lsp - l1) / abs(l1),
    }
    emit(
        f"cards{n}",
        **found,
        tolerance={"loss": SHARDED_LOSS_REL_TOL, "update": SHARDED_UPDATE_REL_TOL},
        precision="train steps f32 under matmul precision 'highest'; "
        "Predictor bf16",
    )
    dp, sp, sh = found["dp_train"], found["dpxsp_train"], found["sharded_predictor"]
    check(dp["loss_rel_err"] <= SHARDED_LOSS_REL_TOL, "DP loss", **dp)
    check(dp["update_rel_err"] <= SHARDED_UPDATE_REL_TOL, "DP update", **dp)
    check(sh["raw_heads_rel_err"] <= sh["raw_heads_tolerance"],
          "sharded raw heads", **sh)
    check(sh["nms_masks_identical"], "sharded NMS masks", **sh)
    check(mask_p.shape == mask_1.shape, "sharded Predictor output shape")
    check(np.isfinite(sp["loss_dpxsp"]), "DP x SP loss finite", **sp)
    check(sp["loss_rel_err"] <= SHARDED_LOSS_REL_TOL, "DP x SP loss", **sp)


def report_environment(devices):
    print(gpu_cards(), flush=True)
    emit(
        "environment",
        jax=jax.__version__,
        devices=[d.device_kind for d in devices],
        compile_cache=enable_compilation_cache(),
        gxx=shutil.which("g++"),
        pillow=importlib.util.find_spec("PIL") is not None,
        orbax=importlib.util.find_spec("orbax") is not None,
    )


def run(cards: int = 1, sizes: Sizes = Sizes()):
    """Run the phases for `cards` cards at `sizes`; raises on the first
    failed check."""
    x = jax.random.uniform(
        jax.random.PRNGKey(1), (sizes.batch, sizes.image, sizes.image, 3)
    )
    model, folded = flagship(sizes, x[:8])
    if cards > 1:
        phase_cards(cards, model, folded, x, sizes)
        return
    pred = Predictor(model, folded, image_size=sizes.image)
    ref = phase_inference(model, folded, pred, x, sizes)
    phase_nms(model, folded, x, sizes)
    phase_train(sizes)
    phase_export(model, folded, pred, x, ref, sizes)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)
    devices = require_gpu()
    report_environment(devices)
    run(cards=args.cards)
    d = devices[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": d.platform, "kind": d.device_kind,
            "count": len(devices),
        },
    }))


if __name__ == "__main__":
    main()
