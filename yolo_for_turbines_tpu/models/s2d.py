"""Space-to-depth stem: exact reformulation of the low-channel entry layers.

Why: the Darknet-53 stem (3->32 at 416^2, 32->64 at 208^2, the first
residual block, 64->128) runs with 3-64 channels, which fill only a small
part of a wide matrix unit and of every memory transaction. Whether the
rewrite pays on the GPU is for the train-step benchmark to decide.

Fix (the MLPerf "space-to-depth" trick): rewrite the stem to operate on
a 2x2-space-to-depth view of its tensors, where a (B, H, W, C) activation is
stored as (B, H/2, W/2, 4C) with channel index (i*2 + j)*C + c for spatial
phase (i, j). Each stem conv's kernel is re-laid-out (with structural
zeros) so the composition is ARITHMETICALLY IDENTICAL to the original
convolution -- same multiplies, same adds, reassociated -- while every
tensor touched has >=48 channels. The FLOP count rises (dense phase kernels
multiply zeros), but those FLOPs run ~8x more efficiently, a large net win.

The canonical parameter pytree is untouched: kernels are transformed inside
`apply` (36 tiny scatter-adds on weight tensors, negligible and
differentiable, so gradients land on the canonical weights). Darknet
import/export, checkpointing, folding and freeze masks all see the
standard layout.

Kernel index math: an original conv `out[y,x,o] = sum_{u,v,c}
in[s*y+u-p, s*x+v-p, c] * K[u,v,c,o]` becomes, in s2d coordinates
(y = 2P + i), a conv whose tap at s2d offset dy reads input phase iy where
`2*dy + iy = i + u - p` (stride 1) or `2*dy + iy = 2*i + u - p` (stride 2,
s2d output) or `2*dy + iy = u - p` (stride 2, plain output).

No reference counterpart (the reference runs cuDNN, which handles small
channel counts natively; reference: code/model.py:21-24 defines the same
stem layers this file re-lays-out).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp


def space_to_depth(x: jnp.ndarray) -> jnp.ndarray:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channel index (i*2+j)*C + c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    x = jnp.transpose(x, (0, 1, 3, 2, 4, 5))
    return x.reshape(b, h // 2, w // 2, 4 * c)


def s2d_kernel_s1(k: jnp.ndarray) -> jnp.ndarray:
    """Stride-1 conv, s2d input -> s2d output.

    (kh, kh, ci, co) -> (ks, ks, 4ci, 4co) with ks = 3 for kh = 3 (pad 1)
    and ks = 1 for kh = 1 (pad 0). Structural zeros elsewhere.
    """
    kh, _, ci, co = k.shape
    p = kh // 2
    ks = 3 if kh == 3 else 1
    out = jnp.zeros((ks, ks, 4 * ci, 4 * co), k.dtype)
    for i in range(2):
        for j in range(2):
            for u in range(kh):
                for v in range(kh):
                    dy, iy = divmod(i + u - p, 2)
                    dx, ix = divmod(j + v - p, 2)
                    out = out.at[
                        dy + ks // 2,
                        dx + ks // 2,
                        (iy * 2 + ix) * ci : (iy * 2 + ix + 1) * ci,
                        (i * 2 + j) * co : (i * 2 + j + 1) * co,
                    ].add(k[u, v])
    return out


def s2d_kernel_s2_s2d(k: jnp.ndarray) -> jnp.ndarray:
    """Stride-2 3x3 conv, s2d input -> s2d output (resolution drops 2x in
    s2d coordinates). (3, 3, ci, co) -> (3, 3, 4ci, 4co), stride 2, pad 1."""
    kh, _, ci, co = k.shape
    assert kh == 3
    out = jnp.zeros((3, 3, 4 * ci, 4 * co), k.dtype)
    for i in range(2):
        for j in range(2):
            for u in range(3):
                for v in range(3):
                    dy, iy = divmod(2 * i + u - 1, 2)
                    dx, ix = divmod(2 * j + v - 1, 2)
                    out = out.at[
                        dy + 1,
                        dx + 1,
                        (iy * 2 + ix) * ci : (iy * 2 + ix + 1) * ci,
                        (i * 2 + j) * co : (i * 2 + j + 1) * co,
                    ].add(k[u, v])
    return out


def s2d_kernel_s2_plain(k: jnp.ndarray) -> jnp.ndarray:
    """Stride-2 3x3 conv, s2d input -> PLAIN output (the s2d exit conv: the
    original stride-2 output grid coincides with the s2d grid).
    (3, 3, ci, co) -> (2, 2, 4ci, co), stride 1, padding ((1,0),(1,0))."""
    kh, _, ci, co = k.shape
    assert kh == 3
    out = jnp.zeros((2, 2, 4 * ci, co), k.dtype)
    for u in range(3):
        for v in range(3):
            dy, iy = divmod(u - 1, 2)
            dx, ix = divmod(v - 1, 2)
            out = out.at[
                dy + 1,
                dx + 1,
                (iy * 2 + ix) * ci : (iy * 2 + ix + 1) * ci,
                :,
            ].add(k[u, v])
    return out


def tile4(v: Optional[jnp.ndarray]) -> Optional[jnp.ndarray]:
    """Per-channel vector (C,) -> (4C,) matching the s2d channel layout
    (phase-major, channel-minor)."""
    return None if v is None else jnp.tile(v, 4)


def bn_batch_moments_s2d(
    y: jnp.ndarray, c: int, shift: Optional[jnp.ndarray] = None
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batch mean/var per ORIGINAL channel from an s2d activation
    (B, P, Q, 4c): reduce over batch, space, and the 4 phases. Same element
    set as the plain-layout reduction, so stats (and therefore training
    trajectories) are unchanged. f32 accumulation, shifted single pass
    (see blocks.bn_batch_moments for the numerics)."""
    yf = y.astype(jnp.float32).reshape(*y.shape[:3], 4, c)
    if shift is not None:
        yf = yf - shift.astype(jnp.float32)
    dmean = jnp.mean(yf, axis=(0, 1, 2, 3))
    dsq = jnp.mean(jnp.square(yf), axis=(0, 1, 2, 3))
    var = jnp.maximum(dsq - jnp.square(dmean), 0.0)
    mean = dmean if shift is None else dmean + shift.astype(jnp.float32)
    return mean, var
