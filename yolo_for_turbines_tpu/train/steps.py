"""Compiled train/eval steps: optax SGD + warmup, donated state, DP sharding.

JAX replacements for the reference's loop internals
(reference: code/train.py:34-92):

- AMP autocast + GradScaler -> bf16 compute with f32 params/BN/loss. bf16 has
  f32's exponent range, so no loss scaling is needed.
- optimizer.zero_grad/backward/step -> one jitted `train_step` with donated
  state (params update in place in HBM, no copy).
- warmup LinearLR -> an optax schedule (linear 1e-6*lr -> lr over
  warmup*max_num_steps steps, then constant; reference code/train.py:186-189).
- backbone freezing -> optax.masked zero-updates over the importer's frozen
  mask (reference sets requires_grad=False, code/model.py:306-309).
- data parallelism -> the step is jitted with the batch sharded over the
  mesh's "data" axis and state replicated; XLA inserts the gradient
  all-reduce (no hand-written DDP analogue needed).

One compiled executable exists per image-size bucket (multi-scale training's
7 sizes, reference code/config.py:43-45) -- shapes are static per bucket.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from ..config import TrainConfig
from ..models.yolov3 import YOLOv3
from .loss import total_yolo_loss


class TrainState(NamedTuple):
    """Replicated training state (a pytree; donated through train_step).

    `hyper` carries the trial's schedule parameters as TRACED scalars
    ({lr, warmup_steps, total_steps, use_cosine}); together with the
    momentum/weight-decay values injected into `opt_state` (see
    `make_optimizer`), no trial-specific number is baked into the compiled
    step — one executable serves every same-architecture HPO trial."""

    params: Any
    batch_stats: Any
    opt_state: Any
    step: jnp.ndarray
    hyper: Any


def warmup_schedule(cfg: TrainConfig) -> optax.Schedule:
    """Linear warmup from 1e-6 * lr to lr (reference: code/train.py:186-189);
    optional cosine decay afterwards when cfg.decay_lr."""
    if not cfg.warmup_enabled:
        return optax.constant_schedule(cfg.lr)
    warmup_steps = max(1, int(cfg.max_num_steps * cfg.warmup))
    if cfg.decay_lr:
        return optax.warmup_cosine_decay_schedule(
            init_value=cfg.lr * 1e-6,
            peak_value=cfg.lr,
            warmup_steps=warmup_steps,
            decay_steps=cfg.max_num_steps,
        )
    return optax.join_schedules(
        [
            optax.linear_schedule(cfg.lr * 1e-6, cfg.lr, warmup_steps),
            optax.constant_schedule(cfg.lr),
        ],
        [warmup_steps],
    )


def _sgd_builder(learning_rate, momentum, weight_decay):
    """torch-SGD semantics: grad += wd * param BEFORE the momentum buffer
    (reference code/train.py:171-172). Called by inject_hyperparams at every
    update with the values stored in opt_state.hyperparams — so momentum and
    weight decay are TRACED, not baked into the compiled step."""
    return optax.chain(
        optax.add_decayed_weights(weight_decay),
        optax.sgd(learning_rate, momentum=momentum),
    )


@functools.lru_cache(maxsize=8)
def _cached_tx(mask_key) -> optax.GradientTransformation:
    """One shared GradientTransformation per frozen-mask pattern.

    learning_rate is pinned to 1.0 (the step scales updates by the traced
    scheduled lr afterwards — sgd(1.0) returns exactly -momentum_buffer);
    momentum/weight_decay placeholders are overwritten per trial at init
    (`_set_injected_hyperparams`). Sharing the tx OBJECT is what lets
    `make_train_step`'s cache key match across HPO trials, so trial 2
    reuses trial 1's compiled executable instead of compiling every
    bucket again."""
    tx = optax.inject_hyperparams(_sgd_builder)(
        learning_rate=1.0, momentum=0.0, weight_decay=0.0
    )
    if mask_key is not None:
        treedef, leaves = mask_key
        mask = jax.tree_util.tree_unflatten(treedef, list(leaves))
        # mask AFTER the sgd chain: zeroing only the incoming grads would
        # still let add_decayed_weights move frozen leaves by -lr*wd*p;
        # torch's requires_grad=False skips the whole update (reference
        # code/model.py:306-309), so the final update must be exactly 0
        tx = optax.chain(tx, optax.masked(optax.set_to_zero(), mask))
    return tx


def _inject_state(opt_state):
    """Find the InjectHyperparamsState inside a possibly-chained opt state."""
    if hasattr(opt_state, "hyperparams"):
        return opt_state
    for sub in opt_state:
        if hasattr(sub, "hyperparams"):
            return sub
    raise ValueError("no InjectHyperparamsState in optimizer state")


def _set_injected_hyperparams(opt_state, cfg: TrainConfig):
    """Write the trial's momentum/weight decay into opt_state.hyperparams
    (host-side, at state creation; the values ride the state pytree as
    traced scalars thereafter)."""
    hp = _inject_state(opt_state).hyperparams
    hp["momentum"] = jnp.asarray(cfg.momentum, jnp.float32)
    hp["weight_decay"] = jnp.asarray(cfg.weight_decay, jnp.float32)
    return opt_state


def make_optimizer(
    cfg: TrainConfig, frozen_mask=None
) -> Tuple[optax.GradientTransformation, optax.Schedule]:
    """SGD + momentum + coupled weight decay with optional frozen-leaf
    masking. The returned tx is hyperparameter-agnostic (shared across
    configs; see _cached_tx) — per-trial values are injected into the
    opt_state by create_train_state."""
    schedule = warmup_schedule(cfg)
    mask_key = None
    if frozen_mask is not None and any(jax.tree_util.tree_leaves(frozen_mask)):
        leaves, treedef = jax.tree_util.tree_flatten(frozen_mask)
        mask_key = (treedef, tuple(bool(x) for x in leaves))
    return _cached_tx(mask_key), schedule


def hyper_from_config(cfg: TrainConfig) -> Dict[str, jnp.ndarray]:
    """Schedule parameters as traced scalars (TrainState.hyper): the jitted
    step evaluates the warmup/cosine schedule from these + state.step, so lr
    never enters the compiled code as a constant."""
    warmup_steps = (
        max(1, int(cfg.max_num_steps * cfg.warmup)) if cfg.warmup_enabled else 0
    )
    return {
        "lr": jnp.asarray(cfg.lr, jnp.float32),
        "warmup_steps": jnp.asarray(warmup_steps, jnp.float32),
        "total_steps": jnp.asarray(cfg.max_num_steps, jnp.float32),
        # matches warmup_schedule: decay_lr only applies when warmup is on
        "use_cosine": jnp.asarray(
            1.0 if (cfg.decay_lr and cfg.warmup_enabled) else 0.0, jnp.float32
        ),
    }


def scheduled_lr(step, hyper):
    """Traced twin of `warmup_schedule`: linear warmup from 1e-6*lr to lr
    over warmup_steps, then constant or cosine decay to 0 at total_steps.
    Numerically identical to the optax schedules (tests/test_train.py)."""
    stepf = step.astype(jnp.float32)
    lr_peak = hyper["lr"]
    ws = hyper["warmup_steps"]
    frac = jnp.minimum(stepf / jnp.maximum(ws, 1.0), 1.0)
    lr_warm = lr_peak * (1e-6 + (1.0 - 1e-6) * frac)
    t = jnp.clip(
        (stepf - ws) / jnp.maximum(hyper["total_steps"] - ws, 1.0), 0.0, 1.0
    )
    lr_cos = lr_peak * 0.5 * (1.0 + jnp.cos(jnp.pi * t))
    lr_after = jnp.where(hyper["use_cosine"] > 0, lr_cos, lr_peak)
    return jnp.where(stepf < ws, lr_warm, lr_after)


def create_train_state(
    model: YOLOv3, cfg: TrainConfig, rng=None, params=None, batch_stats=None,
    frozen_mask=None,
) -> Tuple[TrainState, optax.GradientTransformation, optax.Schedule]:
    if params is None:
        params, batch_stats = model.init(rng)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    batch_stats = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x) if x is not None else None,
        batch_stats,
        is_leaf=lambda x: x is None,
    )
    tx, schedule = make_optimizer(cfg, frozen_mask)
    opt_state = _set_injected_hyperparams(tx.init(params), cfg)
    state = TrainState(
        params,
        batch_stats,
        opt_state,
        jnp.zeros((), jnp.int32),
        hyper_from_config(cfg),
    )
    return state, tx, schedule


def make_train_step(model: YOLOv3, tx, cfg: TrainConfig, mesh=None):
    """Build (or fetch) the jitted train step.

    Signature: step(state, images, targets3, scaled_anchors) ->
    (state, metrics dict). When a mesh is given, inputs are expected sharded
    on the "data" axis and the state replicated (pjit-style annotations).

    Cached on (model, tx, compute_dtype, mesh): lr/momentum/weight_decay
    live in the TRACED state (TrainState.hyper + opt_state.hyperparams), so
    two Trainers differing only in those values return the SAME jitted
    function object and share its compiled executables — a 16-trial HPO
    search compiles once, not 16 times (reference seam:
    code/train.py:241-284 runs full Ray trials that each re-warm CUDA).
    """
    return _cached_train_step(model, tx, cfg.compute_dtype, mesh)


@functools.lru_cache(maxsize=32)
def _cached_train_step(model: YOLOv3, tx, compute_dtype_name: str, mesh):
    compute_dtype = (
        jnp.bfloat16 if compute_dtype_name == "bfloat16" else jnp.float32
    )
    constrain = _row_constraint(mesh)

    # distinct __name__ so jax_log_compiles output (benchmarks/hpo_run.py's
    # compile counter) separates train from eval compiles
    def train_step(state: TrainState, images, targets, scaled_anchors):
        def loss_fn(params):
            preds, new_stats = model.apply(
                params,
                state.batch_stats,
                images,
                train=True,
                compute_dtype=compute_dtype,
                constrain=constrain,
            )
            total, comps = total_yolo_loss(preds, targets, scaled_anchors)
            return total, (new_stats, comps)

        (total, (new_stats, comps)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(state.params)
        # tx runs at lr=1.0 (updates == -momentum_buffer); scale by the
        # schedule evaluated in-trace so lr is data, not compiled constant
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        lr = scheduled_lr(state.step, state.hyper)
        updates = jax.tree_util.tree_map(lambda u: u * lr, updates)
        params = optax.apply_updates(state.params, updates)
        new_state = TrainState(
            params, new_stats, opt_state, state.step + 1, state.hyper
        )
        metrics = dict(comps)
        metrics["loss"] = total
        return new_state, metrics

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        repl = NamedSharding(mesh, P())
        img, tgt = _batch_shardings(mesh)
        return jax.jit(
            train_step,
            in_shardings=(repl, img, tgt, repl),
            out_shardings=(repl, repl),
            donate_argnums=(0,),
        )
    return jax.jit(train_step, donate_argnums=(0,))


def _row_constraint(mesh):
    """Activation sharding policy for spatial meshes; None otherwise.

    On a ("data", "space") mesh the model's intermediate activations MUST
    carry explicit row shardings in train mode — left to propagation, the
    partitioner picks a layout whose BN-moment backward is numerically
    wrong at small rows/shard (see parallel.spatial.row_constraint)."""
    if mesh is None:
        return None
    from ..parallel.spatial import row_constraint

    return row_constraint(mesh)


def _batch_shardings(mesh):
    """(image, target) input shardings for a train/eval step on `mesh`.

    A plain DP mesh shards only the batch axis. A ("data", "space") mesh
    (parallel/spatial.py) additionally shards image ROWS over "space";
    GSPMD derives the conv halo exchanges and reduces BN moments/gradients
    over both axes. Targets stay batch-sharded (see
    spatial_target_sharding for why their row axis cannot shard)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.spatial import SPACE_AXIS, spatial_target_sharding

    if SPACE_AXIS in mesh.axis_names:
        return (
            NamedSharding(mesh, P("data", SPACE_AXIS)),
            spatial_target_sharding(mesh),
        )
    data = NamedSharding(mesh, P("data"))
    return data, data


def make_eval_step(model: YOLOv3, cfg: TrainConfig, mesh=None):
    """Jitted forward + loss (no grad) for validation epochs
    (reference: code/train.py:94-156). Cached like make_train_step."""
    return _cached_eval_step(model, cfg.compute_dtype, mesh)


@functools.lru_cache(maxsize=32)
def _cached_eval_step(model: YOLOv3, compute_dtype_name: str, mesh):
    compute_dtype = (
        jnp.bfloat16 if compute_dtype_name == "bfloat16" else jnp.float32
    )

    constrain = _row_constraint(mesh)

    def eval_step(state: TrainState, images, targets, scaled_anchors):
        preds, _ = model.apply(
            state.params,
            state.batch_stats,
            images,
            train=False,
            compute_dtype=compute_dtype,
            constrain=constrain,
        )
        total, comps = total_yolo_loss(preds, targets, scaled_anchors)
        metrics = dict(comps)
        metrics["loss"] = total
        return metrics

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        repl = NamedSharding(mesh, P())
        img, tgt = _batch_shardings(mesh)
        return jax.jit(
            eval_step,
            in_shardings=(repl, img, tgt, repl),
            out_shardings=repl,
        )
    return jax.jit(eval_step)


def make_forward_eval(model: YOLOv3, cfg: TrainConfig):
    """Jitted inference forward returning raw predictions (for accuracy /
    mAP eval); batch-stats eval mode."""
    compute_dtype = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32

    @jax.jit
    def fwd(state: TrainState, images):
        preds, _ = model.apply(
            state.params,
            state.batch_stats,
            images,
            train=False,
            compute_dtype=compute_dtype,
        )
        return preds

    return fwd
