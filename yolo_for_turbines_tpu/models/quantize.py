"""Post-training int8 quantization for the folded inference path.

int8 activations halve the bytes each conv moves, and int8 operands can run
on integer matrix units. This module quantizes a FOLDED parameter tree (models/blocks.fold_conv_bn)
to int8 with the standard PTQ recipe:

- weights: symmetric per-output-channel int8 (s_w[oc] = max|w[..., oc]|/127);
- activations: symmetric per-tensor int8, scales calibrated by running the
  bf16 model over a representative batch and recording each tensor's
  max-abs (`calibrate`);
- compute: int8 conv, sums in f32 (see `_conv_i8`); the epilogue
  (dequant scale, bias, activation, requant to the next tensor's scale)
  stays in f32 and fuses into the conv — inter-layer traffic is int8.

Layer policy (accuracy-first): backbone/neck convs and residual adds run
int8; detection heads (the two convs feeding each scale prediction) run
bf16 from a dequantized input — they are a tiny fraction of the FLOPs and
the most precision-sensitive outputs. leaky_relu (0.55x + 0.45|x|) and
mish are applied in f32 inside the fused epilogue, so activation
nonlinearity costs no extra precision.

The reference has no quantization; this is a beyond-reference serving
option. mAP impact must be validated on real weights (standard per-channel
PTQ on YOLOv3 typically costs <1 mAP point); this environment has no
weight/dataset egress, so tests bound the numeric drift vs the bf16 path
instead (cosine similarity + box-level agreement, tests/test_quantize.py).

Supported plan entries: PlanConv, PlanResidual, PlanHead, PlanMaxPool,
PlanRoute, PlanUpsample, PlanCSP — the darknet53, tiny AND CSPDarknet-53
families (the reference README's own future direction, README.md:40, is
not excluded from the fastest serving mode). CSP stages follow the same
per-channel recipe: split/transition/fuse convs quantize like PlanConv,
partial-stack blocks like PlanResidual.

Channel concats (upsample route merges, CSP cross-stage merges) are NOT
quantized to a shared scale: conv(concat(a, b), W) == conv(a, W_a) +
conv(b, W_b), so the consuming conv runs as two int8 convs whose partials
dequant-sum in the fused epilogue with PER-BRANCH scales (`_concat_mode`).
This removes the concat materialization + requant pass from HBM traffic
AND the shared-scale precision loss the round-2 advisor flagged. Heads
consume concats directly in bf16.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .blocks import conv2d, get_activation, maxpool2d, upsample2x
from .cspdarknet import PlanCSP
from .yolov3 import (
    PlanConv,
    PlanHead,
    PlanMaxPool,
    PlanResidual,
    PlanRoute,
    PlanUpsample,
    _head_reshape,
)

INPUT_SCALE = 1.0 / 127.0  # inputs are [0, 1]


def _wq(w) -> tuple:
    """Per-output-channel symmetric int8 weight quant: (wq, s_w[oc])."""
    w = np.asarray(w, np.float32)
    s = np.max(np.abs(w), axis=(0, 1, 2)) / 127.0
    s = np.maximum(s, 1e-12)
    wq = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return jnp.asarray(wq), jnp.asarray(s, jnp.float32)


def calibrate(plan, folded, x_calib, activation: str = "leaky_relu"):
    """Record each int8 tensor's max-abs over a representative batch, in the
    exact order `apply_inference_int8` consumes them. ONE jitted device
    program returning the stacked maxes and one host transfer.
    Returns a tuple of per-tensor scales (max/127)."""
    act = get_activation(activation)

    def walk(folded_t, x):
        maxes = []

        def rec(t):
            maxes.append(jnp.max(jnp.abs(t)).astype(jnp.float32))
            return t

        def conv(p, t, kernel, stride):
            pad = 1 if kernel == 3 else 0
            return act(conv2d(t, p["w"].astype(t.dtype), stride, pad) + p["b"])

        routes = []
        plan_t = tuple(plan)
        for i, (entry, p) in enumerate(zip(plan_t, folded_t)):
            if isinstance(entry, PlanConv):
                x = rec(conv(p["conv"], x, entry.kernel, entry.stride))
            elif isinstance(entry, PlanResidual):
                for bp in p["blocks"]:
                    y = rec(conv(bp["conv1"], x, 1, 1))
                    y = conv(bp["conv2"], y, 3, 1)
                    x = rec(x + y if entry.use_residual else y)
                if entry.save_route:
                    routes.append(x)
            elif isinstance(entry, PlanHead):
                pass  # heads run bf16; no int8 tensors
            elif isinstance(entry, PlanMaxPool):
                x = maxpool2d(x, entry.kernel, entry.stride)  # scale-preserving
            elif isinstance(entry, PlanRoute):
                routes.append(x)
            elif isinstance(entry, PlanUpsample):
                # the concat tensor only gets its own scale in "requant"
                # mode; split-conv and bf16-head consumers work from the
                # two branch tensors (whose scales are already recorded)
                cat = jnp.concatenate([upsample2x(x), routes.pop()], axis=-1)
                mode = _concat_mode(plan_t[i + 1] if i + 1 < len(plan_t) else None)
                x = rec(cat) if mode == "requant" else cat
            elif isinstance(entry, PlanCSP):
                # mirror apply_inference_int8's CSP order exactly:
                # split1, split2, per-block (conv1, post-add), transition,
                # fuse (the fuse conv consumes the concat as a split-weight
                # pair — the merged tensor itself is never quantized)
                shortcut = rec(conv(p["split1"], x, 1, 1))
                y = rec(conv(p["split2"], x, 1, 1))
                for bp in p["blocks"]:
                    h = rec(conv(bp["conv1"], y, 1, 1))
                    h = conv(bp["conv2"], h, 3, 1)
                    y = rec(y + h)
                y = rec(conv(p["transition"], y, 1, 1))
                merged = jnp.concatenate([y, shortcut], axis=-1)
                x = rec(conv(p["fuse"], merged, 1, 1))
                if entry.save_route:
                    routes.append(x)
            else:
                raise ValueError(
                    f"int8 quantization does not support {type(entry).__name__}"
                )
        return jnp.stack(maxes)

    maxes = np.asarray(
        jax.jit(walk)(folded, jnp.asarray(x_calib, jnp.float32))
    )
    return tuple(float(max(m, 1e-12)) / 127.0 for m in maxes)


def _concat_mode(next_entry) -> str:
    """How a channel-concat's consumer handles two differently-scaled int8
    branches:
    - "conv": conv(concat(a, b), W) == conv(a, W[:, :, :Ca]) + conv(b,
      W[:, :, Ca:]) — run two int8 convs and dequant-sum in the epilogue.
      No concat materialization, no requant pass, per-branch precision
      (resolves the shared-scale caveat the old path documented).
    - "head": the head runs bf16 anyway — concat the dequantized branches.
    - "requant": fallback for any other consumer — one shared calibrated
      scale, as the old path did for every concat.
    """
    if isinstance(next_entry, PlanConv):
        return "conv"
    if isinstance(next_entry, PlanHead):
        return "head"
    return "requant"


def _q_conv(p) -> dict:
    wq, sw = _wq(p["w"])
    return {"wq": wq, "sw": sw, "b": jnp.asarray(p["b"], jnp.float32)}


def _q_blocks(blocks) -> list:
    out = []
    for bp in blocks:
        w1q, s1 = _wq(bp["conv1"]["w"])
        w2q, s2 = _wq(bp["conv2"]["w"])
        out.append({
            "w1q": w1q, "s1": s1, "b1": jnp.asarray(bp["conv1"]["b"], jnp.float32),
            "w2q": w2q, "s2": s2, "b2": jnp.asarray(bp["conv2"]["b"], jnp.float32),
        })
    return out


def quantize_folded(plan, folded, x_calib, activation: str = "leaky_relu"):
    """Quantize folded params given a calibration batch.

    Returns {"layers": [...], "scales": (...)}: per-entry int8 weights +
    f32 epilogue constants, plus the calibrated activation scales.
    """
    scales = calibrate(plan, folded, x_calib, activation)
    layers = []
    for entry, p in zip(plan, folded):
        if isinstance(entry, PlanConv):
            layers.append(_q_conv(p["conv"]))
        elif isinstance(entry, PlanResidual):
            layers.append({"blocks": _q_blocks(p["blocks"])})
        elif isinstance(entry, PlanCSP):
            layers.append({
                "split1": _q_conv(p["split1"]),
                "split2": _q_conv(p["split2"]),
                "blocks": _q_blocks(p["blocks"]),
                "transition": _q_conv(p["transition"]),
                "fuse": _q_conv(p["fuse"]),
            })
        else:
            # heads & weightless entries keep full-precision params — but
            # they must live ON DEVICE: the Predictor's folded source is
            # host numpy, and a numpy leaf in the jitted arg tree is copied
            # to the device again on every call.
            layers.append(jax.tree_util.tree_map(jnp.asarray, p))
    # scales ship as ONE device array (python-float leaves would re-commit
    # ~100 tiny host scalars to the device on every jitted call)
    return {"layers": layers, "scales": jnp.asarray(scales, jnp.float32)}


def _conv_i8(xq, wq, stride, pad):
    # int8 operands, sums returned in f32: cuDNN's integer convolutions give
    # s8 or f32 results, and XLA:GPU refuses an s32 one. Exact while a sum
    # stays below 2^24 in magnitude, 6e-8 relative beyond.
    return jax.lax.conv_general_dilated(
        xq, wq, (stride, stride), ((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    )


def _requant(y_f, s_out):
    return jnp.clip(jnp.round(y_f / s_out), -127, 127).astype(jnp.int8)


def apply_inference_int8(
    plan,
    qparams,
    x,
    activation: str = "leaky_relu",
    raw_heads: bool = False,
    compute_dtype=jnp.bfloat16,
):
    """int8 twin of `yolov3.apply_inference` over `quantize_folded` output.

    x: (B, S, S, 3) float in [0, 1]. Returns the same predictions list as
    the bf16 path (heads computed in `compute_dtype`).
    """
    act = get_activation(activation)
    layers = qparams["layers"]
    scales = qparams["scales"]  # (n_tensors,) f32 device array
    si = iter(range(scales.shape[0]))

    xq = _requant(jnp.asarray(x, jnp.float32), INPUT_SCALE)
    s_x = INPUT_SCALE
    preds = []
    routes = []  # (int8 tensor, scale)
    # a channel-concat whose consumer resolves it (split-weight conv or
    # bf16 head): (branch_a_q, s_a, branch_b_q, s_b)
    pending = None

    def epilogue(y32, s_in, sw, b, s_out, residual=None, extra=None):
        # dequant + bias + activation (+ residual add) + requant: one fused
        # f32 elementwise pass in the conv epilogue. `extra` = (y32b, s_b)
        # adds a second partial conv (split-weight concat consumer) before
        # bias/activation.
        y = y32.astype(jnp.float32) * (s_in * sw)
        if extra is not None:
            y32b, s_b = extra
            y = y + y32b.astype(jnp.float32) * (s_b * sw)
        y = act(y + b)
        if residual is not None:
            rq, rs = residual
            y = y + rq.astype(jnp.float32) * rs
        return _requant(y, s_out)

    def split_conv(pair, q, stride, pad, s_out):
        aq, s_a, bq, s_b = pair
        ca = aq.shape[-1]
        y32a = _conv_i8(aq, q["wq"][:, :, :ca], stride, pad)
        y32b = _conv_i8(bq, q["wq"][:, :, ca:], stride, pad)
        return epilogue(
            y32a, s_a, q["sw"], q["b"], s_out, extra=(y32b, s_b)
        )

    plan_t = tuple(plan)
    for i, (entry, p) in enumerate(zip(plan_t, layers)):
        nxt = plan_t[i + 1] if i + 1 < len(plan_t) else None
        if isinstance(entry, PlanConv):
            pad = 1 if entry.kernel == 3 else 0
            s_out = scales[next(si)]
            if pending is not None:
                xq = split_conv(pending, p, entry.stride, pad, s_out)
                pending = None
            else:
                y32 = _conv_i8(xq, p["wq"], entry.stride, pad)
                xq = epilogue(y32, s_x, p["sw"], p["b"], s_out)
            s_x = s_out
        elif isinstance(entry, PlanResidual):
            for bp in p["blocks"]:
                s1_out = scales[next(si)]
                t1 = epilogue(
                    _conv_i8(xq, bp["w1q"], 1, 0), s_x, bp["s1"], bp["b1"],
                    s1_out,
                )
                s2_out = scales[next(si)]
                res = (xq, s_x) if entry.use_residual else None
                xq = epilogue(
                    _conv_i8(t1, bp["w2q"], 1, 1), s1_out, bp["s2"],
                    bp["b2"], s2_out, residual=res,
                )
                s_x = s2_out
            if entry.save_route:
                routes.append((xq, s_x))
        elif isinstance(entry, PlanHead):
            # bf16 head from the dequantized trunk (a pending concat is
            # resolved as a bf16 concat of the dequantized branches — the
            # head leaves int8 anyway, so no requant and no precision loss)
            if pending is not None:
                aq, s_a, bq, s_b = pending
                pending = None
                xf = jnp.concatenate(
                    [
                        (aq.astype(jnp.float32) * s_a).astype(compute_dtype),
                        (bq.astype(jnp.float32) * s_b).astype(compute_dtype),
                    ],
                    axis=-1,
                )
            else:
                xf = (xq.astype(jnp.float32) * s_x).astype(compute_dtype)
            y = act(
                conv2d(xf, p["conv1"]["w"].astype(compute_dtype), 1, 1)
                + p["conv1"]["b"].astype(compute_dtype)
            )
            y = (
                conv2d(y, p["conv2"]["w"].astype(compute_dtype), 1, 0)
                + p["conv2"]["b"].astype(compute_dtype)
            )
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
            xq = maxpool2d(xq, entry.kernel, entry.stride)
        elif isinstance(entry, PlanRoute):
            routes.append((xq, s_x))
        elif isinstance(entry, PlanUpsample):
            # nearest-2x upsample preserves the trunk's scale, so the
            # concat becomes a PENDING branch pair resolved by its consumer
            # with per-branch scales (see _concat_mode): a following conv
            # runs split-weight (no concat materialization, no requant), a
            # following head concats in bf16. Only an exotic consumer pays
            # the old shared-scale requant.
            rq, rs = routes.pop()
            mode = _concat_mode(nxt)
            if mode == "requant":
                s_out = scales[next(si)]
                up = upsample2x(xq).astype(jnp.float32) * s_x
                rf = rq.astype(jnp.float32) * rs
                xq = _requant(jnp.concatenate([up, rf], axis=-1), s_out)
                s_x = s_out
            else:
                pending = (upsample2x(xq), s_x, rq, rs)
        elif isinstance(entry, PlanCSP):
            # split convs from the shared stage input
            s_sc = scales[next(si)]
            scq = epilogue(
                _conv_i8(xq, p["split1"]["wq"], 1, 0), s_x,
                p["split1"]["sw"], p["split1"]["b"], s_sc,
            )
            s_y = scales[next(si)]
            yq = epilogue(
                _conv_i8(xq, p["split2"]["wq"], 1, 0), s_x,
                p["split2"]["sw"], p["split2"]["b"], s_y,
            )
            # partial stack: 1x1 -> 3x3 with residual add (PlanResidual recipe)
            for bp in p["blocks"]:
                s1_out = scales[next(si)]
                t1 = epilogue(
                    _conv_i8(yq, bp["w1q"], 1, 0), s_y, bp["s1"], bp["b1"],
                    s1_out,
                )
                s2_out = scales[next(si)]
                yq = epilogue(
                    _conv_i8(t1, bp["w2q"], 1, 1), s1_out, bp["s2"], bp["b2"],
                    s2_out, residual=(yq, s_y),
                )
                s_y = s2_out
            s_t = scales[next(si)]
            yq = epilogue(
                _conv_i8(yq, p["transition"]["wq"], 1, 0), s_y,
                p["transition"]["sw"], p["transition"]["b"], s_t,
            )
            # cross-stage concat: the fuse conv consumes it SPLIT-WEIGHT
            # with per-branch scales — the merged tensor is never
            # materialized or requantized
            s_out = scales[next(si)]
            xq = split_conv((yq, s_t, scq, s_sc), p["fuse"], 1, 0, s_out)
            s_x = s_out
            if entry.save_route:
                routes.append((xq, s_x))
    return preds
