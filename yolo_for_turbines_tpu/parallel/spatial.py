"""Spatial partitioning (SP): shard the image HEIGHT axis across devices.

Data parallelism (parallel/mesh.py) scales by batch; spatial partitioning
scales by IMAGE SIZE — the axis that matters for the reference's actual
deployment. Turbine-blade inspection photos are far larger than the 416px
training resolution, and the reference's demo simply resizes the full
upload down to one 416px tile (reference: code/demo.py:30-41,
code/utils.py:475-501), throwing away the resolution that small surface
defects live in. With SP, one high-resolution image's rows are split
across the mesh's "space" axis, so N devices jointly hold an activation
footprint no single device could, and inference at 2-4x the trained
resolution becomes a mesh-shape change instead of an OOM.

There is NO hand-written halo code here, and none is needed: the model is
jitted with the input annotated `P("data", "space")` and XLA's GSPMD
partitioner derives the halo exchange every conv/pool window needs at
shard boundaries (a collective-permute of the 1-2 boundary rows per conv
— tiny next to the activation traffic it saves). This is the idiomatic
JAX formulation: annotate shardings, let the partitioner insert
collectives. shard_map would be WRONG for SP — each shard would see a
local H and silently compute zero-padded (wrong) boundary pixels.

Annotate does NOT mean "annotate only the inputs": in train mode the
partitioner must not be left to choose intermediate layouts freely —
see `row_constraint` below for the measured failure mode and the explicit
per-activation policy the train/eval steps thread through the model.

Row counts need not divide the mesh: GSPMD masks internal padding. The
deepest 13x13 grid under 2-way SP pads one row; correctness is unaffected
(tests/test_spatial.py asserts equivalence to the unsharded model).

Composes with DP on a 2-D ("data", "space") mesh: batch shards over
"data", rows over "space", gradients all-reduce over both axes. The train
step (train/steps.py) accepts such a mesh directly — target grids shard
their row axis in lockstep with the image rows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS

SPACE_AXIS = "space"

# Rows per shard below which an activation's row axis is gathered back to
# replicated instead of staying space-sharded. Two reasons, both measured:
# (1) perf — a 3x3 conv needs a 1-row halo exchange per boundary; at <8
# rows/shard the halo is >12% of the shard while the grid carries almost
# no FLOPs, so sharding buys nothing; (2) numerics — XLA's partitioner
# produces a genuinely wrong TRAIN-mode backward for the deep residual
# stages when BN batch-moment reductions run over activations sharded to
# 1-4 rows/shard on a combined ("data", "space") mesh (gradients ~100x too
# large, isolated to the H<=8 residual stages of the 64px mini model;
# f64-referenced: unsharded f32 grads match f64 to 0.2% while the
# unconstrained sharded grads were off by 100x; with these constraints the
# sharded grads return to the f32 noise floor). Explicit per-activation
# constraints remove the partitioner's freedom to choose that regime.
MIN_ROWS_PER_SHARD = 8


def row_constraint(mesh: Mesh, min_rows: int = MIN_ROWS_PER_SHARD):
    """Explicit activation-sharding policy for spatial partitioning.

    Returns `constrain(x)` mapping an NHWC activation to itself annotated
    with `P("data", "space")` while H holds >= `min_rows` rows per space
    shard (and divides the axis), else `P("data")` (rows gathered). Returns
    None when `mesh` has no space axis to constrain — callers pass the
    result straight to models.yolov3.apply(constrain=...).
    """
    if SPACE_AXIS not in mesh.axis_names or mesh.shape[SPACE_AXIS] == 1:
        return None
    n_space = mesh.shape[SPACE_AXIS]
    sharded = NamedSharding(mesh, P(DATA_AXIS, SPACE_AXIS))
    gathered = NamedSharding(mesh, P(DATA_AXIS))

    def constrain(x):
        if x.ndim < 2:
            return x
        h = x.shape[1]
        if h % n_space == 0 and h >= min_rows * n_space:
            return jax.lax.with_sharding_constraint(x, sharded)
        return jax.lax.with_sharding_constraint(x, gathered)

    return constrain


def create_spatial_mesh(
    n_space: Optional[int] = None,
    n_data: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """2-D ("data", "space") mesh: batch over `n_data`, image rows over
    `n_space` (defaults to all remaining devices). Pure SP is n_data=1;
    pure DP should use parallel.mesh.create_mesh instead.

    When `n_space` is given explicitly and `n_data * n_space` covers only
    part of the device list, the FIRST n_data*n_space devices are used and
    the rest sit idle — deliberate for sub-meshes in tests, but warned
    about so a production caller can't silently strand chips."""
    if devices is None:
        devices = jax.devices()
    if n_space is None:
        n_space = len(devices) // n_data
    n = n_data * n_space
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    if len(devices) > n:
        import warnings

        warnings.warn(
            f"create_spatial_mesh(n_data={n_data}, n_space={n_space}) uses "
            f"only the first {n} of {len(devices)} devices; the remaining "
            f"{len(devices) - n} are idle",
            stacklevel=2,
        )
    arr = np.asarray(devices[:n]).reshape(n_data, n_space)
    return Mesh(arr, (DATA_AXIS, SPACE_AXIS))


def spatial_image_sharding(mesh: Mesh) -> NamedSharding:
    """NHWC images: batch over "data", rows (H) over "space"."""
    return NamedSharding(mesh, P(DATA_AXIS, SPACE_AXIS))


def spatial_target_sharding(mesh: Mesh) -> NamedSharding:
    """(B, A, S_row, S_col, 6) target grids: batch axis only.

    The row axis is deliberately NOT sharded: the deepest grid has
    image_size/32 rows (13 at 416px) which never divides a power-of-two
    "space" axis, and device_put/jit input shardings require divisibility
    (GSPMD pads only INTERNAL values). Targets are tiny (~4 KB/image vs
    ~2 MB of image rows), so the partitioner all-gathering them against
    the row-sharded predictions inside the loss costs nothing."""
    return NamedSharding(mesh, P(DATA_AXIS))


def shard_spatial_batch(images, targets, mesh: Mesh):
    """Place (images, per-scale target tuple) onto a ("data", "space")
    mesh with matching row shardings."""
    img_sh = spatial_image_sharding(mesh)
    tgt_sh = spatial_target_sharding(mesh)
    return (
        jax.device_put(images, img_sh),
        jax.tree_util.tree_map(lambda t: jax.device_put(t, tgt_sh), targets),
    )
