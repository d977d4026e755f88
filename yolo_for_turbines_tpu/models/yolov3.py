"""Functional YOLOv3 (Darknet-53 backbone + 3-scale heads).

The architecture is driven by the same declarative layer DSL as the reference
(reference: code/model.py:20-45): a tuple is (filters, kernel, stride) for a
same-conv, ["B", n] is a residual stack of n blocks, "S" is a scale-prediction
head, "U" is a nearest 2x upsample followed by a channel concat with a saved
route. Routes are saved at the two 8-block residual stages and consumed LIFO
after each upsample (reference: code/model.py:186-191).

Unlike the reference's nn.Module graph, the model here is a static *plan*
(tuple of frozen dataclasses) plus a parameter pytree; `apply` is a pure
function, so it jits, shards, vmaps and differentiates cleanly.

Output contract (public API parity): a list of 3 tensors of shape
(B, 3, S, S, 5 + num_classes) for S in {size/32, size/16, size/8}
(reference: code/model.py:349-351).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModelConfig
from .blocks import (
    apply_conv_block,
    fold_conv_bn,
    get_activation,
    init_conv,
    upsample2x,
)

# Same declarative architecture list as the reference (code/model.py:20-45).
LAYER_CONFIG = (
    (32, 3, 1),
    (64, 3, 2),
    ("B", 1),
    (128, 3, 2),
    ("B", 2),
    (256, 3, 2),
    ("B", 8),  # route to detection head
    (512, 3, 2),
    ("B", 8),  # route to detection head
    (1024, 3, 2),
    ("B", 4),  # end of Darknet-53
    (512, 1, 1),
    (1024, 3, 1),
    "S",
    (256, 1, 1),
    "U",
    (256, 1, 1),
    (512, 3, 1),
    "S",
    (128, 1, 1),
    "U",
    (128, 1, 1),
    (256, 3, 1),
    "S",
)


# ---------------------------------------------------------------------------
# Plan (static, hashable description of the layer sequence)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanConv:
    in_ch: int
    out_ch: int
    kernel: int
    stride: int
    bn: bool = True


@dataclasses.dataclass(frozen=True)
class PlanResidual:
    channels: int
    num_blocks: int
    use_residual: bool = True
    save_route: bool = False  # feature map feeds a later concat


@dataclasses.dataclass(frozen=True)
class PlanHead:
    """Scale prediction head: 3x3 conv (to mid_ch, default 2*in_ch) then 1x1
    (bias, no BN) to A*(5+C) channels (reference: code/model.py:133-148).
    The head is a *branch*: the trunk continues from its input."""

    in_ch: int
    num_classes: int
    anchors_per_scale: int = 3
    mid_ch: Optional[int] = None  # tiny-YOLO heads use a non-doubling mid

    @property
    def mid(self) -> int:
        return self.mid_ch if self.mid_ch is not None else 2 * self.in_ch


@dataclasses.dataclass(frozen=True)
class PlanMaxPool:
    """Max pool (darknet tiny-YOLO backbone); stride 1 = SAME padding."""

    kernel: int = 2
    stride: int = 2


@dataclasses.dataclass(frozen=True)
class PlanRoute:
    """Explicit route marker: push the current feature map for a later
    upsample-concat (tiny-YOLO has no 8-block residual to hang it on)."""


@dataclasses.dataclass(frozen=True)
class PlanUpsample:
    """Nearest 2x upsample + channel-concat with the most recent saved route."""

    in_ch: int


Plan = Tuple


def build_plan(cfg: ModelConfig, layer_config=LAYER_CONFIG) -> Plan:
    """Walk the layer DSL into a static plan (reference: code/model.py:195-225)."""
    from .cspdarknet import PlanCSP

    plan: List = []
    in_ch = cfg.in_channels
    first_csp = True
    for block in layer_config:
        if isinstance(block, tuple) and block[0] == "B":
            n = block[1]
            plan.append(
                PlanResidual(channels=in_ch, num_blocks=n, save_route=(n == 8))
            )
        elif isinstance(block, tuple) and block[0] == "C":
            n = block[1]
            plan.append(
                PlanCSP(
                    channels=in_ch,
                    num_blocks=n,
                    save_route=(n == 8),
                    first_stage=first_csp,
                )
            )
            first_csp = False
        elif isinstance(block, tuple):
            out_ch, k, s = block
            plan.append(PlanConv(in_ch, out_ch, kernel=k, stride=s))
            in_ch = out_ch
        elif block == "S":
            # Expansion matches reference: non-residual 1-block stack, 1x1
            # halve, then the prediction head; x continues from the halve conv
            # (reference: code/model.py:213-219).
            plan.append(PlanResidual(channels=in_ch, num_blocks=1, use_residual=False))
            plan.append(PlanConv(in_ch, in_ch // 2, kernel=1, stride=1))
            plan.append(
                PlanHead(in_ch // 2, cfg.num_classes, cfg.anchors_per_scale)
            )
            in_ch = in_ch // 2
        elif block == "U":
            plan.append(PlanUpsample(in_ch))
            in_ch = in_ch * 3  # concat with a route that has 2x our channels
        else:
            raise ValueError(f"Unknown layer config entry: {block!r}")
    return tuple(plan)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_entry(rng, entry, activation):
    from .cspdarknet import PlanCSP, init_csp_entry

    if isinstance(entry, PlanCSP):
        return init_csp_entry(rng, entry)
    if isinstance(entry, PlanConv):
        p, s = init_conv(rng, entry.in_ch, entry.out_ch, entry.kernel, bn=entry.bn)
        return {"conv": p}, {"conv": s}
    if isinstance(entry, PlanResidual):
        blocks_p, blocks_s = [], []
        keys = jax.random.split(rng, entry.num_blocks * 2)
        for b in range(entry.num_blocks):
            p1, s1 = init_conv(keys[2 * b], entry.channels, entry.channels // 2, 1)
            p2, s2 = init_conv(
                keys[2 * b + 1], entry.channels // 2, entry.channels, 3
            )
            blocks_p.append({"conv1": p1, "conv2": p2})
            blocks_s.append({"conv1": s1, "conv2": s2})
        return {"blocks": blocks_p}, {"blocks": blocks_s}
    if isinstance(entry, PlanHead):
        k1, k2 = jax.random.split(rng)
        out_ch = (entry.num_classes + 5) * entry.anchors_per_scale
        p1, s1 = init_conv(k1, entry.in_ch, entry.mid, 3)
        p2, s2 = init_conv(k2, entry.mid, out_ch, 1, bn=False)
        return {"conv1": p1, "conv2": p2}, {"conv1": s1, "conv2": s2}
    if isinstance(entry, (PlanUpsample, PlanMaxPool, PlanRoute)):
        return {}, {}
    raise TypeError(entry)


def init_plan(rng: jax.Array, plan: Plan, activation: str = "leaky_relu"):
    """Initialize (params, batch_stats) pytrees aligned with a plan."""
    keys = jax.random.split(rng, len(plan))
    params, stats = [], []
    act = get_activation(activation)
    for key, entry in zip(keys, plan):
        p, s = _init_entry(key, entry, act)
        params.append(p)
        stats.append(s)
    return list(params), list(stats)


def init(rng: jax.Array, cfg: ModelConfig, layer_config=LAYER_CONFIG):
    """Initialize (params, batch_stats) pytrees for a DSL layer config."""
    return init_plan(rng, build_plan(cfg, layer_config), cfg.activation)


def param_count(params) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _head_reshape(y: jnp.ndarray, num_classes: int, anchors: int) -> jnp.ndarray:
    """(B,S,S,A*(5+C)) -> (B,A,S,S,5+C), channel order [anchor, channel] with
    channel fastest -- matches the reference's reshape+permute
    (reference: code/model.py:146-148)."""
    b, h, w, _ = y.shape
    y = y.reshape(b, h, w, anchors, num_classes + 5)
    return jnp.transpose(y, (0, 3, 1, 2, 4))


def _s2d_stem_prefix(plan: Plan) -> int:
    """How many leading plan entries the space-to-depth stem can absorb.

    4 for the Darknet-53 pattern [conv 3x3/1, conv 3x3/2, residual(1),
    conv 3x3/2] (exit at 128 channels, H/4), 2 for conv+downsample only
    (CSPDarknet-53, whose third entry is a CSP stage), 0 when the prefix
    doesn't match (tiny-YOLO's maxpool stem, custom DSLs).
    """
    if len(plan) >= 2 and (
        isinstance(plan[0], PlanConv)
        and plan[0].kernel == 3
        and plan[0].stride == 1
        and plan[0].bn
        and isinstance(plan[1], PlanConv)
        and plan[1].kernel == 3
        and plan[1].stride == 2
        and plan[1].bn
        and plan[1].in_ch == plan[0].out_ch
    ):
        if (
            len(plan) >= 4
            and isinstance(plan[2], PlanResidual)
            and plan[2].num_blocks == 1
            and plan[2].use_residual
            and not plan[2].save_route
            and plan[2].channels == plan[1].out_ch
            and isinstance(plan[3], PlanConv)
            and plan[3].kernel == 3
            and plan[3].stride == 2
            and plan[3].bn
            and plan[3].in_ch == plan[2].channels
        ):
            return 4
        return 2
    return 0


def _apply_stem_s2d(
    entries, params, batch_stats, x, act, train, compute_dtype,
    constrain=lambda t: t,
):
    """Train/eval forward of the stem prefix in space-to-depth layout.

    Arithmetically identical to running the same entries through
    `apply_conv_block` (see models/s2d.py); BN statistics reduce over the
    phase axis so they equal the plain-layout statistics. Returns the plain
    (B, H/4, W/4, C) activation feeding the rest of the plan and the
    new-stats subtree for these entries.
    """
    from .blocks import bn_batch_moments, bn_scale_shift, conv2d
    from . import s2d as s2dm

    def bn_act(y, p, s, c, out_s2d):
        # BN semantics live in blocks.bn_scale_shift (shared with
        # apply_conv_block); only the moment reduction and the coefficient
        # tiling are s2d-layout-aware
        if train:
            moments = (
                s2dm.bn_batch_moments_s2d(y, c, shift=s["mean"])
                if out_s2d
                else bn_batch_moments(y, shift=s["mean"])
            )
            inv, shift, new_s = bn_scale_shift(
                p, s, moments, int(np.prod(y.shape)) // c
            )
        else:
            inv, shift, new_s = bn_scale_shift(p, s)
        if out_s2d:
            inv, shift = s2dm.tile4(inv), s2dm.tile4(shift)
        y = y * inv.astype(compute_dtype) + shift.astype(compute_dtype)
        return constrain(act(y)), new_s

    def wk(transform, p):
        return transform(p["w"].astype(compute_dtype))

    new_stats = []
    xs = constrain(s2dm.space_to_depth(x))

    # conv0: 3x3/1 in s2d space
    p, s = params[0]["conv"], batch_stats[0]["conv"]
    y = conv2d(xs, wk(s2dm.s2d_kernel_s1, p), 1, 1)
    xs, ns = bn_act(y, p, s, entries[0].out_ch, True)
    new_stats.append({"conv": ns})

    if len(entries) == 2:
        # downsample conv exits s2d space directly
        p, s = params[1]["conv"], batch_stats[1]["conv"]
        y = conv2d(xs, wk(s2dm.s2d_kernel_s2_plain, p), 1, ((1, 0), (1, 0)))
        x_out, ns = bn_act(y, p, s, entries[1].out_ch, False)
        new_stats.append({"conv": ns})
        return x_out, new_stats

    # conv1: 3x3/2, staying in s2d space (s2d grid halves)
    p, s = params[1]["conv"], batch_stats[1]["conv"]
    y = conv2d(xs, wk(s2dm.s2d_kernel_s2_s2d, p), 2, 1)
    xs, ns = bn_act(y, p, s, entries[1].out_ch, True)
    new_stats.append({"conv": ns})

    # first residual block, entirely in s2d space
    bp, bs = params[2]["blocks"][0], batch_stats[2]["blocks"][0]
    y = conv2d(xs, wk(s2dm.s2d_kernel_s1, bp["conv1"]), 1, 0)
    y, ns1 = bn_act(y, bp["conv1"], bs["conv1"], entries[2].channels // 2, True)
    y = conv2d(y, wk(s2dm.s2d_kernel_s1, bp["conv2"]), 1, 1)
    y, ns2 = bn_act(y, bp["conv2"], bs["conv2"], entries[2].channels, True)
    xs = xs + y
    new_stats.append({"blocks": [{"conv1": ns1, "conv2": ns2}]})

    # downsample conv exits s2d space (2x2 kernel, top/left-padded)
    p, s = params[3]["conv"], batch_stats[3]["conv"]
    y = conv2d(xs, wk(s2dm.s2d_kernel_s2_plain, p), 1, ((1, 0), (1, 0)))
    x_out, ns = bn_act(y, p, s, entries[3].out_ch, False)
    new_stats.append({"conv": ns})
    return x_out, new_stats


def apply(
    plan: Plan,
    params,
    batch_stats,
    x: jnp.ndarray,
    *,
    activation: str = "leaky_relu",
    train: bool = False,
    compute_dtype=jnp.bfloat16,
    s2d_stem: bool = True,
    constrain=None,
):
    """Forward pass. x is NHWC. Returns (predictions, new_batch_stats).

    predictions is a list of 3 arrays (B, 3, S, S, 5+C), float32, coarsest
    scale (stride 32) first.

    `constrain` (optional) is applied to every intermediate activation —
    used by the spatial-partitioning train/eval steps to pin each tensor's
    row sharding explicitly (parallel.spatial.row_constraint; see the
    numerics note there for why the partitioner must not choose freely).
    """
    from .cspdarknet import PlanCSP, apply_csp_entry

    act = get_activation(activation)
    if constrain is None:
        constrain = lambda t: t
    x = x.astype(compute_dtype)
    preds: List[jnp.ndarray] = []
    routes: List[jnp.ndarray] = []
    new_stats = []

    def conv(p, s, x, entry_kernel, entry_stride):
        pad = 1 if entry_kernel == 3 else 0
        y, ns = apply_conv_block(
            p,
            s,
            x,
            stride=entry_stride,
            padding=pad,
            activation=act,
            train=train,
            compute_dtype=compute_dtype,
        )
        return constrain(y), ns

    start = 0
    if s2d_stem and x.shape[1] % 4 == 0 and x.shape[2] % 4 == 0:
        start = _s2d_stem_prefix(plan)
        if start:
            x, stem_stats = _apply_stem_s2d(
                plan[:start], params[:start], batch_stats[:start], x, act,
                train, compute_dtype, constrain,
            )
            new_stats.extend(stem_stats)

    for entry, p, s in zip(plan[start:], params[start:], batch_stats[start:]):
        if isinstance(entry, PlanConv):
            x, ns = conv(p["conv"], s["conv"], x, entry.kernel, entry.stride)
            new_stats.append({"conv": ns})
        elif isinstance(entry, PlanResidual):
            ns_blocks = []
            for bp, bs in zip(p["blocks"], s["blocks"]):
                y, ns1 = conv(bp["conv1"], bs["conv1"], x, 1, 1)
                y, ns2 = conv(bp["conv2"], bs["conv2"], y, 3, 1)
                x = x + y if entry.use_residual else y
                ns_blocks.append({"conv1": ns1, "conv2": ns2})
            new_stats.append({"blocks": ns_blocks})
            if entry.save_route:
                routes.append(x)
        elif isinstance(entry, PlanCSP):
            x, ns = apply_csp_entry(entry, p, s, x, conv)
            new_stats.append(ns)
            if entry.save_route:
                routes.append(x)
        elif isinstance(entry, PlanHead):
            y, ns1 = conv(p["conv1"], s["conv1"], x, 3, 1)
            y, ns2 = conv(p["conv2"], None, y, 1, 1)
            preds.append(
                _head_reshape(
                    y.astype(jnp.float32), entry.num_classes, entry.anchors_per_scale
                )
            )
            new_stats.append({"conv1": ns1, "conv2": None})
            # x is untouched: the head is a branch (reference: code/model.py:177-179)
        elif isinstance(entry, PlanMaxPool):
            from .blocks import maxpool2d

            x = constrain(maxpool2d(x, entry.kernel, entry.stride))
            new_stats.append({})
        elif isinstance(entry, PlanRoute):
            routes.append(x)
            new_stats.append({})
        elif isinstance(entry, PlanUpsample):
            x = constrain(upsample2x(x))
            x = constrain(
                jnp.concatenate([x, routes.pop().astype(x.dtype)], axis=-1)
            )
            new_stats.append({})
        else:
            raise TypeError(entry)

    return preds, new_stats


# ---------------------------------------------------------------------------
# Folded-BN inference fast path
# ---------------------------------------------------------------------------


def fold_params(plan: Plan, params, batch_stats):
    """Fold every BN into its conv for inference (one fused conv+bias+act per
    layer on the hot path)."""

    from .cspdarknet import PlanCSP, fold_csp_entry

    def fold(p, s):
        return fold_conv_bn(p, s) if s is not None else p

    folded = []
    for entry, p, s in zip(plan, params, batch_stats):
        if isinstance(entry, PlanCSP):
            folded.append(fold_csp_entry(entry, p, s, fold))
        elif isinstance(entry, PlanConv):
            folded.append({"conv": fold(p["conv"], s["conv"])})
        elif isinstance(entry, PlanResidual):
            folded.append(
                {
                    "blocks": [
                        {
                            "conv1": fold(bp["conv1"], bs["conv1"]),
                            "conv2": fold(bp["conv2"], bs["conv2"]),
                        }
                        for bp, bs in zip(p["blocks"], s["blocks"])
                    ]
                }
            )
        elif isinstance(entry, PlanHead):
            folded.append(
                {"conv1": fold(p["conv1"], s["conv1"]), "conv2": p["conv2"]}
            )
        else:
            folded.append({})
    return folded


def apply_inference(
    plan: Plan,
    folded_params,
    x: jnp.ndarray,
    *,
    activation: str = "leaky_relu",
    compute_dtype=jnp.bfloat16,
    raw_heads: bool = False,
):
    """Inference forward over folded params: conv + bias + activation only.

    Unlike `apply`, no space-to-depth stem here: folded inference keeps the
    plain stem (models/s2d.py is a train-mode layout).

    raw_heads=True returns each head's raw NHWC conv output
    (B, S, S, A*(5+C)) in compute dtype, skipping the (B, A, S, S, 5+C)
    transpose + f32 cast. The transpose is pure layout shuffling the decode
    does not need -- `ops.decode.decode_raw` consumes this layout directly
    (the reshape to (B, S, S, A, 5+C) is free). Use for the throughput
    pipeline; the default path keeps the reference's public layout
    (code/model.py:146-148).

    Each plan entry runs under a `jax.named_scope` ("<Entry><index>", e.g.
    "PlanResidual8" for the 26x26x512 stage at 416 px), so profiler traces
    can attribute device time to backbone stages and heads.
    """
    from .blocks import conv2d, maxpool2d
    from .cspdarknet import PlanCSP, apply_csp_inference

    act = get_activation(activation)
    x = x.astype(compute_dtype)
    preds: List[jnp.ndarray] = []
    routes: List[jnp.ndarray] = []

    def conv(p, x, kernel, stride, with_act=True):
        pad = 1 if kernel == 3 else 0
        y = conv2d(x, p["w"].astype(compute_dtype), stride, pad)
        y = y + p["b"].astype(compute_dtype)
        return act(y) if with_act else y

    for idx, (entry, p) in enumerate(zip(plan, folded_params)):
        with jax.named_scope(f"{type(entry).__name__}{idx}"):
            if isinstance(entry, PlanCSP):
                x = apply_csp_inference(entry, p, x, conv)
                if entry.save_route:
                    routes.append(x)
            elif isinstance(entry, PlanConv):
                x = conv(p["conv"], x, entry.kernel, entry.stride)
            elif isinstance(entry, PlanResidual):
                for bp in p["blocks"]:
                    y = conv(bp["conv1"], x, 1, 1)
                    y = conv(bp["conv2"], y, 3, 1)
                    x = x + y if entry.use_residual else y
                if entry.save_route:
                    routes.append(x)
            elif isinstance(entry, PlanHead):
                y = conv(p["conv1"], x, 3, 1)
                y = conv(p["conv2"], y, 1, 1, with_act=False)
                if raw_heads:
                    preds.append(y)
                else:
                    preds.append(
                        _head_reshape(
                            y.astype(jnp.float32),
                            entry.num_classes,
                            entry.anchors_per_scale,
                        )
                    )
            elif isinstance(entry, PlanMaxPool):
                x = maxpool2d(x, entry.kernel, entry.stride)
            elif isinstance(entry, PlanRoute):
                routes.append(x)
            elif isinstance(entry, PlanUpsample):
                x = upsample2x(x)
                x = jnp.concatenate([x, routes.pop().astype(x.dtype)], axis=-1)
    return preds


# ---------------------------------------------------------------------------
# Convenience wrapper
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class YOLOv3:
    """Static model handle: plan + config. Parameters live outside (pytrees)."""

    cfg: ModelConfig

    @property
    def layer_config(self):
        from .cspdarknet import CSP_LAYER_CONFIG

        if self.cfg.layer_config is not None:
            return self.cfg.layer_config
        return (
            CSP_LAYER_CONFIG if self.cfg.backbone == "cspdarknet53" else LAYER_CONFIG
        )

    @property
    def plan(self) -> Plan:
        if self.cfg.backbone == "yolov3_tiny" and self.cfg.layer_config is None:
            from .yolov3_tiny import build_tiny_plan

            return build_tiny_plan(self.cfg)
        return build_plan(self.cfg, self.layer_config)

    @property
    def strides(self) -> Tuple[int, ...]:
        """Output stride per detection scale, coarsest first."""
        return self.cfg.strides

    def init(self, rng):
        return init_plan(rng, self.plan, self.cfg.activation)

    def apply(
        self, params, batch_stats, x, *, train=False,
        compute_dtype=jnp.bfloat16, constrain=None,
    ):
        return apply(
            self.plan,
            params,
            batch_stats,
            x,
            activation=self.cfg.activation,
            train=train,
            compute_dtype=compute_dtype,
            s2d_stem=self.cfg.s2d_stem,
            constrain=constrain,
        )

    def fold(self, params, batch_stats):
        return fold_params(self.plan, params, batch_stats)

    def apply_folded(self, folded, x, *, compute_dtype=jnp.bfloat16, raw_heads=False):
        return apply_inference(
            self.plan,
            folded,
            x,
            activation=self.cfg.activation,
            compute_dtype=compute_dtype,
            raw_heads=raw_heads,
        )
