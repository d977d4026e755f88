"""Functional building blocks for YOLO models.

These are pure functions over parameter pytrees -- no module objects, no mutable
state. Layout is NHWC (channels-last), the layout cuDNN runs bf16 convs in;
weights are HWIO. Mixed precision is a cast policy: parameters are stored in
float32, compute runs in bfloat16 (policy chosen by the caller), and BatchNorm
statistics stay in float32.

Functional equivalents of the reference's module classes:
- conv + BN + activation  <- CNNBlock       (reference: code/model.py:47-86)
- residual stack          <- ResidualBlock  (reference: code/model.py:88-121)
- detection head          <- ScalePredictionBlock (reference: code/model.py:123-148)
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

BN_EPS = 1e-5  # torch BatchNorm2d default, needed for darknet-weight parity
BN_MOMENTUM = 0.1  # torch default: new = (1 - m) * old + m * batch


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def leaky_relu(x):
    # algebraic form of leaky_relu(x, 0.1): 0.55x + 0.45|x|. Identical values;
    # mul/add/abs fuse into the conv epilogue like any elementwise chain.
    return 0.55 * x + 0.45 * jnp.abs(x)


def mish(x):
    return x * jnp.tanh(jax.nn.softplus(x))


ACTIVATIONS = {"leaky_relu": leaky_relu, "mish": mish}


def get_activation(name: str):
    if name not in ACTIVATIONS:
        raise ValueError(f"Unsupported activation: {name}")
    return ACTIVATIONS[name]


# ---------------------------------------------------------------------------
# Conv (+BN) parameter init
# ---------------------------------------------------------------------------


def init_conv(
    rng: jax.Array,
    in_ch: int,
    out_ch: int,
    kernel: int,
    bn: bool = True,
) -> Tuple[Dict, Optional[Dict]]:
    """Initialize one conv layer. Returns (params, batch_stats or None).

    Weight init follows torch's Conv2d default (kaiming-uniform with a=sqrt(5),
    i.e. U(-1/sqrt(fan_in), 1/sqrt(fan_in))) so from-scratch training behaves
    like the reference.
    """
    fan_in = in_ch * kernel * kernel
    bound = 1.0 / math.sqrt(fan_in)
    wkey, bkey = jax.random.split(rng)
    w = jax.random.uniform(
        wkey, (kernel, kernel, in_ch, out_ch), jnp.float32, -bound, bound
    )
    if bn:
        params = {
            "w": w,
            "scale": jnp.ones((out_ch,), jnp.float32),
            "bias": jnp.zeros((out_ch,), jnp.float32),
        }
        stats = {
            "mean": jnp.zeros((out_ch,), jnp.float32),
            "var": jnp.ones((out_ch,), jnp.float32),
        }
        return params, stats
    b = jax.random.uniform(bkey, (out_ch,), jnp.float32, -bound, bound)
    return {"w": w, "b": b}, None


# ---------------------------------------------------------------------------
# Conv (+BN + activation) apply
# ---------------------------------------------------------------------------


def conv2d(x, w, stride: int, padding):
    """NHWC conv with explicit padding (torch floor semantics).

    `padding` is an int p for symmetric ((p,p),(p,p)) padding, or an explicit
    ((top,bottom),(left,right)) pair (the space-to-depth stem's exit conv
    pads asymmetrically). Explicit padding rather than 'SAME' so stride-2
    layers align exactly with the reference's torch convs (padding=1 both
    sides, floor output size) -- 'SAME' pads asymmetrically and would shift
    features, breaking darknet-weight parity.
    """
    # f32 operands: force full-precision accumulation (XLA's DEFAULT uses
    # reduced-precision passes, TF32 on GPUs). bf16 operands accumulate in
    # f32 regardless, so leave them DEFAULT.
    precision = (
        jax.lax.Precision.HIGHEST if x.dtype == jnp.float32 else None
    )
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    return jax.lax.conv_general_dilated(
        x,
        w,
        window_strides=(stride, stride),
        padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=precision,
    )


def bn_batch_moments(
    y: jnp.ndarray, shift: Optional[jnp.ndarray] = None
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Single-pass f32 batch moments per channel (NHWC reduce over B, H, W).

    Still ONE fused read of the conv output (vs jnp.var's two dependent
    passes — profiled: the _var reductions cost 4.6 ms fwd + 4.5 ms bwd of
    the 97 ms bs=32 train step), but SHIFTED: with a per-channel `shift` m
    (the running mean — free, already in registers for the caller),

        var = E[(x - m)^2] - (E[x] - m)^2

    which is exact algebra and numerically stable whenever m tracks the
    batch mean. The unshifted E[x^2] - E[x]^2 cancels catastrophically when
    |mean| >> std, making BN gradients reassociation-noisy at %-level
    between differently-compiled programs (measured: eager-vs-jit stem beta
    grads differed 2x). The subtract fuses into the same elementwise read.
    """
    yf = y.astype(jnp.float32)
    if shift is not None:
        yf = yf - shift.astype(jnp.float32)
    dmean = jnp.mean(yf, axis=(0, 1, 2))
    dsq = jnp.mean(jnp.square(yf), axis=(0, 1, 2))
    var = jnp.maximum(dsq - jnp.square(dmean), 0.0)
    mean = dmean if shift is None else dmean + shift.astype(jnp.float32)
    return mean, var


def bn_scale_shift(
    params: Dict,
    stats: Dict,
    moments: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
    n: int = 0,
):
    """BN as an affine epilogue: returns (inv, shift, new_stats) in f32.

    Train mode passes `moments` = (batch_mean, batch_var) over `n` elements
    per channel; running stats then update with torch momentum semantics and
    the unbiased (n/(n-1)) variance. Eval mode (moments=None) normalizes
    with the running stats unchanged. Single source of truth for BN
    semantics — the plain conv path (apply_conv_block) and the
    space-to-depth stem (yolov3._apply_stem_s2d) both call this.
    """
    if moments is not None:
        mean, var = moments
        unbiased = var * (n / max(n - 1, 1))
        new_stats = {
            "mean": (1 - BN_MOMENTUM) * stats["mean"] + BN_MOMENTUM * mean,
            "var": (1 - BN_MOMENTUM) * stats["var"] + BN_MOMENTUM * unbiased,
        }
    else:
        mean, var = stats["mean"], stats["var"]
        new_stats = stats
    inv = jax.lax.rsqrt(var + BN_EPS) * params["scale"]
    shift = params["bias"] - mean * inv
    return inv, shift, new_stats


def apply_conv_block(
    params: Dict,
    stats: Optional[Dict],
    x: jnp.ndarray,
    *,
    stride: int,
    padding: int,
    activation,
    train: bool = False,
    compute_dtype=jnp.bfloat16,
):
    """Conv -> BN -> activation (or conv + bias when no BN).

    Returns (y, new_stats). No explicit cross-replica BN sync is needed (or
    provided): under data-parallel pjit the batch axis is sharded, and the
    `jnp.mean`/`jnp.sum` reductions inside `bn_batch_moments` reduce over
    the GLOBAL batch — GSPMD inserts the collective. Batch moments are
    therefore already replica-consistent by construction; a caller-side
    sync hook would be redundant machinery around a mechanism XLA owns
    (verified by the 8-device DP equivalence tests in tests/test_parallel.py).
    """
    w = params["w"].astype(compute_dtype)
    y = conv2d(x.astype(compute_dtype), w, stride, padding)

    if stats is None:
        y = y + params["b"].astype(compute_dtype)
        return y, None

    if train:
        moments = bn_batch_moments(y, shift=stats["mean"])
        n = int(np.prod([d for i, d in enumerate(y.shape) if i != 3]))
        inv, shift, new_stats = bn_scale_shift(params, stats, moments, n)
    else:
        inv, shift, new_stats = bn_scale_shift(params, stats)

    # scale/shift computed in f32, applied in the compute dtype: the
    # normalize + activation stay a bf16 elementwise pass fused into the
    # conv epilogue instead of read/writing full f32 activations
    y = y * inv.astype(compute_dtype) + shift.astype(compute_dtype)
    y = activation(y)
    return y, new_stats


def fold_conv_bn(params: Dict, stats: Dict) -> Dict:
    """Fold BN into conv weights for inference: w' = w * g/sqrt(v+eps), b' = b - m*g/sqrt(v+eps).

    This removes the BN elementwise pass entirely on the inference hot path --
    one conv + bias + activation per layer, which XLA fuses into the conv
    epilogue.
    """
    inv = params["scale"] / np.sqrt(np.asarray(stats["var"]) + BN_EPS)
    w = params["w"] * jnp.asarray(inv)[None, None, None, :]
    b = params["bias"] - stats["mean"] * inv
    return {"w": w, "b": b}


def maxpool2d(x, kernel: int, stride: int):
    """NHWC max pool. stride==1 uses SAME padding (darknet's tiny-YOLO
    maxpool 2/1 keeps the 13x13 map); otherwise VALID with stride==kernel."""
    padding = "SAME" if stride == 1 else "VALID"
    if jnp.issubdtype(x.dtype, jnp.floating):
        init = -jnp.inf
    else:
        # identity must be a CONCRETE scalar of the operand dtype (a python
        # int fails int8 type checks; a jnp array breaks autodiff tracing);
        # int8 pools feed the quantized inference path
        init = np.dtype(x.dtype).type(np.iinfo(np.dtype(x.dtype)).min)
    return jax.lax.reduce_window(
        x,
        init,
        jax.lax.max,
        (1, kernel, kernel, 1),
        (1, stride, stride, 1),
        padding,
    )


def upsample2x(x):
    """Nearest-neighbor 2x upsample, NHWC (reference: nn.Upsample, code/model.py:222)."""
    b, h, w, c = x.shape
    x = jnp.broadcast_to(x[:, :, None, :, None, :], (b, h, 2, w, 2, c))
    return x.reshape(b, h * 2, w * 2, c)
