"""Greedy NMS sweep as one Pallas kernel through Triton (GPU).

The XLA formulation (ops/nms.py) runs the greedy suppression as a K-step
`lax.fori_loop`; on the GPU every step is at least one kernel launch. Here
the whole sweep is one program per image (`grid=(B,)`, the programs run in
parallel across the SMs):

- step i reads row i of the image's (K, K) suppression matrix from device
  memory (K bytes; the row does not depend on the loop carry, so Triton can
  prefetch it), extracts keep[i] from the register-resident keep vector
  with a masked reduction, and clears row i's boxes if box i is still kept.

The suppression matrix itself (same class, IoU >= threshold, later in score
order) is built by the caller with the same XLA expression the fori_loop
sweep uses. Computing IoU inside the kernel would not give bit-identical
keep masks: Triton lowers f32 division to an approximate instruction and may
contract multiply-adds differently from XLA, so a pair whose IoU sits within
an ulp of the threshold could flip. The matrix costs one parallel XLA fusion
and K*K bytes per image (64 KB at K=256), which stays in L2.

Greedy semantics match the reference's pop-loop (code/utils.py:150-191): a
box cleared by an earlier kept box no longer suppresses anyone.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# one warp: the sweep is a chain of K dependent steps, and a one-warp
# reduction needs only shuffles, no shared-memory barrier
_NUM_WARPS = 1


def padded_size(k: int) -> int:
    """Triton block shapes are powers of two: K rounded up to the next one."""
    return max(1, 1 << (k - 1).bit_length())


def _sweep_kernel(sup_ref, valid_ref, keep_ref):
    k = keep_ref.shape[0]
    col = jax.lax.broadcasted_iota(jnp.int32, (k,), 0)

    def body(i, keep):
        keep_i = jnp.max(jnp.where(col == i, keep, 0))
        row = sup_ref[i, :].astype(jnp.int32)
        return jnp.where((row != 0) & (keep_i != 0), 0, keep)

    keep_ref[...] = jax.lax.fori_loop(0, k, body, valid_ref[...])


@functools.partial(jax.jit, static_argnames=("interpret",))
def greedy_sweep_pallas(suppress, valid, interpret: bool = False):
    """Greedy NMS sweep over pre-sorted candidates.

    Args:
        suppress: (B, K, K) bool; [b, i, j] is True where box i, if kept,
            suppresses box j (same class, IoU >= threshold, j after i).
        valid: (B, K) bool candidate validity (score above threshold).
        interpret: run the kernel in the Pallas interpreter (CPU tests).

    Under `shard_map` the kernel needs `check_vma=False`: the ops inside a
    Pallas kernel do not carry the mesh axes their inputs vary over.

    Returns:
        (B, K) bool keep mask.
    """
    b, k = valid.shape
    kp = padded_size(k)
    sup = jnp.pad(
        suppress.astype(jnp.int8), ((0, 0), (0, kp - k), (0, kp - k))
    )
    val = jnp.pad(valid.astype(jnp.int32), ((0, 0), (0, kp - k)))
    keep = pl.pallas_call(
        _sweep_kernel,
        out_shape=jax.ShapeDtypeStruct((b, kp), jnp.int32),
        grid=(b,),
        in_specs=[
            pl.BlockSpec((None, kp, kp), lambda i: (i, 0, 0)),
            pl.BlockSpec((None, kp), lambda i: (i, 0)),
        ],
        out_specs=pl.BlockSpec((None, kp), lambda i: (i, 0)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS, num_stages=2),
        interpret=interpret,
        name="nms_greedy_sweep",
    )(sup, val)
    return keep[:, :k] != 0
