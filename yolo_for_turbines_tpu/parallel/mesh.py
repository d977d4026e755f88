"""Device mesh + sharding helpers (data parallelism).

The reference has no distributed training at all (SURVEY.md section 2 #27) --
its only parallelism is DataLoader workers and AMP. Here data parallelism is
first-class and idiomatic JAX: a 1-D `jax.sharding.Mesh` over all local
devices, batches sharded along the leading axis, parameters replicated.
Inside `jit`, XLA partitions the conv stack per-shard and inserts the
gradient `all-reduce` automatically (NCCL on GPUs) -- there is no
hand-written collective (the psum rides the mesh via the sharded batch
dimension).

A 62M-parameter convnet needs no tensor/pipeline parallelism; DP is the only
strategy that pays (SURVEY.md section 2 #27). The mesh axis is named "data"
throughout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def create_mesh(
    n_devices: Optional[int] = None, devices: Optional[Sequence] = None
) -> Mesh:
    """1-D data-parallel mesh over (the first n of) the local devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis across the data-parallel axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Fully replicated (parameters, optimizer state)."""
    return NamedSharding(mesh, P())


def shard_batch(batch, mesh: Mesh):
    """Place a host batch sharded across the mesh's data axis."""
    sharding = batch_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), batch)


def pad_batch_to_multiple(batch, multiple: int):
    """Pad the leading axis to a multiple of the mesh size (last batch of an
    epoch); returns (padded_batch, real_count)."""
    import numpy as np

    leaves = jax.tree_util.tree_leaves(batch)
    n = leaves[0].shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch, n
    return (
        jax.tree_util.tree_map(
            lambda x: np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)]),
            batch,
        ),
        n,
    )
