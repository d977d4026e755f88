"""Spatial-partitioning equivalence tests on the virtual 8-device CPU mesh.

SP (parallel/spatial.py) shards image ROWS over the mesh's "space" axis;
GSPMD derives the conv halo exchanges. Every test here asserts the sharded
program computes the same numbers as the unsharded one — the partitioner
inserts communication, never changes math.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from helpers import mini_model
from yolo_for_turbines_tpu.config import TrainConfig
from yolo_for_turbines_tpu.inference import Predictor
from yolo_for_turbines_tpu.parallel.spatial import (
    SPACE_AXIS,
    create_spatial_mesh,
    shard_spatial_batch,
    spatial_image_sharding,
)
from yolo_for_turbines_tpu.train.steps import (
    create_train_state,
    make_train_step,
)


def test_spatial_mesh_factory():
    mesh = create_spatial_mesh(n_space=4, n_data=2)
    assert mesh.axis_names == ("data", SPACE_AXIS)
    assert mesh.devices.shape == (2, 4)
    # defaults: all devices on the space axis
    pure_sp = create_spatial_mesh()
    assert pure_sp.devices.shape == (1, 8)
    with pytest.raises(ValueError):
        create_spatial_mesh(n_space=8, n_data=2)


def test_create_spatial_mesh_warns_on_idle_devices():
    """An explicit sub-mesh (n_data * n_space < len(devices)) is allowed
    for tests but must warn — production callers should not silently
    strand chips."""
    import warnings

    with pytest.warns(UserWarning, match="only the first 2 of 8"):
        mesh = create_spatial_mesh(n_space=2, n_data=1)
    assert mesh.devices.shape == (1, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # full cover: no warning
        create_spatial_mesh(n_space=4, n_data=2)


def test_spatial_predictor_pins_pure_xla(rng):
    """A spatial-partitioning Predictor must run the XLA NMS: a Pallas
    kernel is a per-shard custom call GSPMD cannot row-partition. CPU
    equivalence tests can't catch the GPU-only kernel firing, so pin the
    policy itself, even where the caller asks for the kernel."""
    model = mini_model()
    params, stats = model.init(jax.random.PRNGKey(2))
    folded = model.fold(params, stats)
    mesh = create_spatial_mesh(n_space=4, n_data=2)
    sp = Predictor(model, folded, image_size=64, mesh=mesh, use_pallas_nms=True)
    assert sp._spatial
    assert sp.use_pallas_nms is False
    # the plain predictor keeps the caller's choice
    plain = Predictor(model, folded, image_size=64, use_pallas_nms=True)
    assert plain.use_pallas_nms is True


def _spec_of(constrain, shape):
    """Row-constraint decision for an activation shape, as a trailing-None
    stripped PartitionSpec tuple."""
    out = jax.jit(constrain)(jnp.zeros(shape, jnp.float32))
    spec = tuple(out.sharding.spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def test_row_constraint_policy():
    """Pin row_constraint's shard-vs-gather decision per activation shape
    (parallel/spatial.py MIN_ROWS_PER_SHARD): H stays space-sharded only
    while it divides the space axis AND holds >= 8 rows/shard. The
    gathered regime exists because the unconstrained partitioner produced
    ~100x-too-large BN gradients at <=4 rows/shard (f64-referenced); a
    future edit that re-enters that regime must fail here."""
    from yolo_for_turbines_tpu.parallel.mesh import create_mesh
    from yolo_for_turbines_tpu.parallel.spatial import (
        MIN_ROWS_PER_SHARD,
        row_constraint,
    )

    assert MIN_ROWS_PER_SHARD == 8
    mesh = create_spatial_mesh(n_space=4, n_data=2)
    constrain = row_constraint(mesh)
    sharded, gathered = ("data", SPACE_AXIS), ("data",)
    # 416px activation ladder under 4-way SP (B, H, W, C):
    assert _spec_of(constrain, (2, 416, 416, 4)) == sharded
    assert _spec_of(constrain, (2, 104, 104, 8)) == sharded
    assert _spec_of(constrain, (2, 52, 52, 8)) == sharded
    assert _spec_of(constrain, (2, 32, 32, 8)) == sharded   # ==8 rows/shard
    assert _spec_of(constrain, (2, 26, 26, 8)) == gathered  # 26 % 4 != 0
    assert _spec_of(constrain, (2, 16, 16, 8)) == gathered  # 4 rows/shard
    assert _spec_of(constrain, (2, 13, 13, 8)) == gathered  # deepest grid
    assert _spec_of(constrain, (2, 8, 8, 8)) == gathered    # 2 rows/shard
    # rank-1 leaves pass through untouched
    v = jnp.zeros((7,), jnp.float32)
    assert constrain(v) is v
    # no space axis -> no policy to apply
    assert row_constraint(create_mesh(4)) is None
    assert row_constraint(create_spatial_mesh(n_space=1, n_data=8)) is None


def test_spatial_forward_matches_single_device(rng):
    """Folded forward with rows sharded 4-way == unsharded forward,
    including the non-divisible deepest grid (128px -> 4 rows over 4
    shards at stride 32, 8 rows at 16, 16 at 8)."""
    model = mini_model()
    params, stats = model.init(jax.random.PRNGKey(0))
    folded = model.fold(params, stats)
    x = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)

    ref = jax.jit(
        lambda p, xx: model.apply_folded(p, xx, compute_dtype=jnp.float32)
    )(folded, jnp.asarray(x))

    mesh = create_spatial_mesh(n_space=4, n_data=2)
    from jax.sharding import NamedSharding, PartitionSpec as P

    repl = NamedSharding(mesh, P())
    sp_fn = jax.jit(
        lambda p, xx: model.apply_folded(p, xx, compute_dtype=jnp.float32),
        in_shardings=(repl, spatial_image_sharding(mesh)),
        out_shardings=repl,
    )
    got = sp_fn(folded, jax.device_put(jnp.asarray(x), spatial_image_sharding(mesh)))

    for r, g in zip(ref, got):
        np.testing.assert_allclose(
            np.asarray(r), np.asarray(g), rtol=1e-5, atol=1e-5
        )


def test_spatial_predictor_matches_plain(rng):
    """Full predict_batch pipeline (forward + decode + NMS) under SP returns
    the same survivors as the plain single-device Predictor."""
    model = mini_model()
    params, stats = model.init(jax.random.PRNGKey(1))
    folded = model.fold(params, stats)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)

    plain = Predictor(model, folded, image_size=64, compute_dtype=jnp.float32)
    kept1, mask1 = plain.predict_batch(x)

    mesh = create_spatial_mesh(n_space=4, n_data=2)
    sp = Predictor(
        model, folded, image_size=64, compute_dtype=jnp.float32, mesh=mesh
    )
    assert sp._spatial and not sp.use_pallas_nms
    kept2, mask2 = sp.predict_batch(x)

    np.testing.assert_array_equal(np.asarray(mask1), np.asarray(mask2))
    np.testing.assert_allclose(
        np.asarray(kept1), np.asarray(kept2), rtol=1e-4, atol=1e-5
    )


def test_spatial_train_step_matches_single_device(rng):
    """One DP x SP train step on a (2, 4) mesh == the single-device step:
    halo exchanges + two-axis gradient reduction leave the update
    mathematically unchanged."""
    model = mini_model()
    cfg = TrainConfig(lr=1e-3, max_num_steps=10, compute_dtype="float32")

    b, size = 4, 64
    images = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    targets = tuple(
        np.zeros((b, 3, size // s, size // s, 6), np.float32)
        for s in (32, 16, 8)
    )
    targets[0][:, 0, 1, 1] = [0.5, 0.5, 1.0, 1.0, 1.0, 1.0]
    targets[2][:, 1, 3, 2] = [0.25, 0.75, 0.5, 0.5, 1.0, 0.0]
    anchors = np.abs(rng.normal(1.0, 0.3, (3, 3, 2))).astype(np.float32)

    state1, tx1, _ = create_train_state(model, cfg, rng=jax.random.PRNGKey(0))
    step1 = make_train_step(model, tx1, cfg)
    new1, m1 = step1(
        state1, jnp.asarray(images), tuple(map(jnp.asarray, targets)),
        jnp.asarray(anchors),
    )

    mesh = create_spatial_mesh(n_space=4, n_data=2)
    state2, tx2, _ = create_train_state(model, cfg, rng=jax.random.PRNGKey(0))
    step2 = make_train_step(model, tx2, cfg, mesh=mesh)
    sx, st = shard_spatial_batch(images, targets, mesh)
    new2, m2 = step2(state2, sx, st, jnp.asarray(anchors))

    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    for x1, x2 in zip(
        jax.tree_util.tree_leaves(new1.params),
        jax.tree_util.tree_leaves(new2.params),
    ):
        np.testing.assert_allclose(
            np.asarray(x1), np.asarray(x2), rtol=2e-4, atol=2e-5
        )


class _ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


class _SinkLogger:
    def log(self, d):
        pass


def test_trainer_spatial_epoch_matches_single_device(rng):
    """Trainer with a caller-supplied ("data", "space") mesh: the sharded
    prefetch placement (callable path in prefetch_to_device) + DP x SP
    train step over one epoch must match the single-device trainer."""
    from helpers import MINI_LAYERS
    from yolo_for_turbines_tpu.config import ModelConfig
    from yolo_for_turbines_tpu.parallel.mesh import create_mesh
    from yolo_for_turbines_tpu.train.trainer import Trainer

    tc = TrainConfig(
        lr=2e-4, batch_size=8, max_num_steps=100, warmup_enabled=False,
        multi_scale=False, image_size=64, compute_dtype="float32",
    )
    model_cfg = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)

    images = rng.uniform(0, 1, (8, 64, 64, 3)).astype(np.float32)
    targets = tuple(
        np.zeros((8, 3, 64 // s, 64 // s, 6), np.float32)
        for s in (32, 16, 8)
    )
    targets[0][:, 0, 1, 1] = [0.5, 0.5, 1.0, 1.0, 1.0, 1.0]
    targets[1][:, 2, 0, 3] = [0.8, 0.2, 0.4, 0.4, 1.0, 1.0]
    batches = [(images, targets)]

    t1 = Trainer(tc, model_cfg=model_cfg, mesh=create_mesh(1))
    tsp = Trainer(
        tc, model_cfg=model_cfg,
        mesh=create_spatial_mesh(n_space=2, n_data=4),
    )
    assert tsp._spatial
    loss1 = t1.train_one_epoch(None, _ListLoader(batches), _SinkLogger())
    loss2 = tsp.train_one_epoch(None, _ListLoader(batches), _SinkLogger())
    assert loss2 == pytest.approx(loss1, rel=1e-3)
    # Tolerances are the measured f32 noise floor, not a bug allowance:
    # with an f64 oracle, the UNSHARDED f32 gradient of this loss at init
    # is 0.70 (abs) from truth and the constrained sharded one 0.38 —
    # i.e. both deviate ~1.3% of gradmax from different reduction orders
    # alone, so one lr=2e-4 step moves params up to lr * |g-noise| ~ 1.5e-4
    # apart. The historical failure mode this test guards (partitioner-
    # chosen layouts breaking the BN backward, parallel.spatial.
    # row_constraint) was 100x gradmax, i.e. 4 orders above this bar.
    for a, b in zip(
        jax.tree_util.tree_leaves(t1.state.params),
        jax.tree_util.tree_leaves(tsp.state.params),
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-2, atol=5e-4
        )
