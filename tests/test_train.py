"""Training-stack tests: step mechanics, overfit sanity, checkpoint, trainer."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from yolo_for_turbines_tpu.config import ModelConfig, TrainConfig
from yolo_for_turbines_tpu.models.yolov3 import YOLOv3
from helpers import mini_model
from yolo_for_turbines_tpu.train.steps import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
    make_optimizer,
    warmup_schedule,
)


TINY = dict(num_classes=2)


def _tiny_batch(rng, b=2, size=64):
    images = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    targets = tuple(
        np.zeros((b, 3, size // s, size // s, 6), np.float32) for s in (32, 16, 8)
    )
    for i in range(b):
        targets[0][i, 0, 1, 1] = [0.5, 0.5, 1.0, 1.0, 1.0, 1.0]
        targets[2][i, 1, 3, 3] = [0.2, 0.8, 0.5, 0.5, 1.0, 0.0]
    anchors = np.abs(rng.normal(1.0, 0.3, (3, 3, 2))).astype(np.float32)
    return jnp.asarray(images), tuple(map(jnp.asarray, targets)), jnp.asarray(anchors)


@pytest.fixture
def setup():
    # function-scoped: train_step donates the state, so a shared TrainState
    # would be invalidated for later tests
    model = mini_model()
    cfg = TrainConfig(
        lr=1e-3, batch_size=2, max_num_steps=100, compute_dtype="float32"
    )
    state, tx, schedule = create_train_state(model, cfg, rng=jax.random.PRNGKey(0))
    return model, cfg, state, tx, schedule


def test_warmup_schedule_shape():
    cfg = TrainConfig(lr=0.1, max_num_steps=1000, warmup=0.01)
    sched = warmup_schedule(cfg)
    # optax computes (init-end)*(1-frac) + end in f32; cancellation leaves
    # ~4% error at the 1e-7 scale -- tolerance reflects that
    assert float(sched(0)) == pytest.approx(0.1 * 1e-6, rel=0.1)
    assert float(sched(10)) == pytest.approx(0.1, rel=1e-3)
    assert float(sched(500)) == pytest.approx(0.1, rel=1e-3)


def test_train_step_updates_params_and_stats(setup, rng):
    model, cfg, state, tx, _ = setup
    step = make_train_step(model, tx, cfg)
    x, y, anchors = _tiny_batch(rng)
    state0_param = np.asarray(
        jax.tree_util.tree_leaves(state.params)[0]
    ).copy()
    new_state, metrics = step(state, x, y, anchors)
    assert int(new_state.step) == 1
    assert np.isfinite(float(metrics["loss"]))
    assert set(metrics) == {
        "loss", "box_loss", "obj_loss", "no_obj_loss", "class_loss",
    }
    after = np.asarray(jax.tree_util.tree_leaves(new_state.params)[0])
    assert not np.allclose(state0_param, after)


def test_overfit_tiny_batch(rng):
    """Loss decreases markedly when overfitting one batch (sanity of grads,
    schedule, and optimizer wiring)."""
    model = mini_model()
    cfg = TrainConfig(
        lr=1e-3, max_num_steps=200, warmup_enabled=False,
        compute_dtype="float32", weight_decay=0.0,
    )
    state, tx, _ = create_train_state(model, cfg, rng=jax.random.PRNGKey(1))
    step = make_train_step(model, tx, cfg)
    x, y, anchors = _tiny_batch(rng)
    first = None
    for i in range(30):
        state, metrics = step(state, x, y, anchors)
        if first is None:
            first = float(metrics["loss"])
    last = float(metrics["loss"])
    assert last < first * 0.2, (first, last)


def test_frozen_mask_blocks_updates(rng):
    model = mini_model()
    cfg = TrainConfig(lr=1e-2, max_num_steps=10, compute_dtype="float32")
    params, stats = model.init(jax.random.PRNGKey(0))
    # freeze the stem conv only
    frozen = jax.tree_util.tree_map(lambda _: False, params)
    frozen[0]["conv"] = {k: True for k in params[0]["conv"]}
    state, tx, _ = create_train_state(
        model, cfg, params=params, batch_stats=stats, frozen_mask=frozen
    )
    # snapshot before the step: the step donates (and deletes) state buffers
    w0_before = np.asarray(state.params[0]["conv"]["w"]).copy()
    w1_before = np.asarray(state.params[1]["conv"]["w"]).copy()
    step = make_train_step(model, tx, cfg)
    x, y, anchors = _tiny_batch(rng)
    new_state, _ = step(state, x, y, anchors)
    np.testing.assert_array_equal(
        np.asarray(new_state.params[0]["conv"]["w"]), w0_before
    )
    assert not np.allclose(np.asarray(new_state.params[1]["conv"]["w"]), w1_before)


def test_eval_step_no_mutation(setup, rng):
    model, cfg, state, tx, _ = setup
    estep = make_eval_step(model, cfg)
    x, y, anchors = _tiny_batch(rng)
    metrics = estep(state, x, y, anchors)
    assert np.isfinite(float(metrics["loss"]))


def test_checkpoint_roundtrip(tmp_path, setup, rng):
    model, cfg, state, tx, _ = setup
    from yolo_for_turbines_tpu.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    step = make_train_step(model, tx, cfg)
    x, y, anchors = _tiny_batch(rng)
    state1, _ = step(state, x, y, anchors)
    save_checkpoint(state1, tmp_path / "ckpt")

    state2, _, _ = create_train_state(model, cfg, rng=jax.random.PRNGKey(7))
    restored = load_checkpoint(state2, tmp_path / "ckpt")
    assert int(restored.step) == int(state1.step)
    a = jax.tree_util.tree_leaves(state1.params)
    b = jax.tree_util.tree_leaves(restored.params)
    for x1, x2 in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))


def test_scheduled_lr_matches_host_schedule():
    """The traced in-step schedule (steps.scheduled_lr) must agree with the
    host-side optax schedule for every config shape: warmup+constant,
    warmup+cosine, warmup disabled."""
    from yolo_for_turbines_tpu.train.steps import hyper_from_config, scheduled_lr

    configs = [
        TrainConfig(lr=0.1, max_num_steps=1000, warmup=0.01),
        TrainConfig(lr=3e-3, max_num_steps=500, warmup=0.05, decay_lr=True),
        TrainConfig(lr=1e-2, max_num_steps=200, warmup_enabled=False),
        TrainConfig(lr=1e-2, max_num_steps=200, warmup_enabled=False, decay_lr=True),
    ]
    for cfg in configs:
        sched = warmup_schedule(cfg)
        hyper = hyper_from_config(cfg)
        for step in [0, 1, 5, 10, 50, 199, 200, 499, 999]:
            want = float(sched(step))
            got = float(scheduled_lr(jnp.asarray(step, jnp.int32), hyper))
            # abs=1e-8: optax's linear_schedule computes init+(end-init)*frac
            # with f32 cancellation (~4% error at the 1e-7 init scale);
            # scheduled_lr's formulation is exact there
            assert got == pytest.approx(want, rel=1e-4, abs=1e-8), (cfg, step)


def test_hpo_trials_share_compiled_executable(rng):
    """Two trials differing in lr/momentum/weight_decay must (a) return the
    SAME jitted train-step object and (b) trigger ZERO new compiles for
    trial 2 — the compiled executable is keyed on architecture, not
    hyperparameters."""
    model = mini_model()
    cfg_a = TrainConfig(
        lr=1e-3, momentum=0.9, weight_decay=5e-4, batch_size=2,
        max_num_steps=100, compute_dtype="float32",
    )
    cfg_b = TrainConfig(
        lr=3e-4, momentum=0.8, weight_decay=1e-4, batch_size=2,
        max_num_steps=50, warmup=0.2, decay_lr=True, compute_dtype="float32",
    )
    state_a, tx_a, _ = create_train_state(model, cfg_a, rng=jax.random.PRNGKey(0))
    state_b, tx_b, _ = create_train_state(model, cfg_b, rng=jax.random.PRNGKey(1))
    assert tx_a is tx_b, "optimizer transformation must be shared"
    step_a = make_train_step(model, tx_a, cfg_a)
    step_b = make_train_step(model, tx_b, cfg_b)
    assert step_a is step_b, "jitted step must be shared across trials"

    x, y, anchors = _tiny_batch(rng)
    state_a, _ = step_a(state_a, x, y, anchors)
    jax.block_until_ready(state_a.params)
    n_compiles = step_a._cache_size()
    state_b, metrics_b = step_b(state_b, x, y, anchors)
    jax.block_until_ready(state_b.params)
    assert step_b._cache_size() == n_compiles, "trial 2 must not recompile"
    assert np.isfinite(float(metrics_b["loss"]))


def test_injected_hyperparams_are_really_used():
    """The shared tx must honor each trial's own momentum/weight decay (read
    from opt_state.hyperparams) and the traced schedule lr: three updates on
    a toy pytree must match a hand-rolled torch-semantics SGD loop exactly
    (buf = m*buf + (g + wd*p); p -= lr*buf). Toy params keep the check exact
    — the full model's BN-variance gradients carry %-level reassociation
    noise that would mask an optimizer bug."""
    from yolo_for_turbines_tpu.train.steps import (
        _cached_tx,
        _set_injected_hyperparams,
        hyper_from_config,
        scheduled_lr,
    )

    cfg = TrainConfig(
        lr=2e-3, momentum=0.7, weight_decay=1e-3,
        max_num_steps=100, warmup_enabled=False,
    )
    tx = _cached_tx(None)
    params = {"w": jnp.asarray([1.0, -2.0, 0.5]), "b": jnp.asarray([0.0, 3.0])}
    grads = {"w": jnp.asarray([0.1, -0.2, 0.3]), "b": jnp.asarray([-1.0, 0.4])}
    opt_state = _set_injected_hyperparams(tx.init(params), cfg)
    hyper = hyper_from_config(cfg)

    ref = {k: np.asarray(v, np.float64) for k, v in params.items()}
    buf = {k: np.zeros_like(v) for k, v in ref.items()}
    import optax

    for step_i in range(3):
        lr = scheduled_lr(jnp.asarray(step_i, jnp.int32), hyper)
        updates, opt_state = tx.update(grads, opt_state, params)
        updates = jax.tree_util.tree_map(lambda u: u * lr, updates)
        params = optax.apply_updates(params, updates)
        for k in ref:
            g = np.asarray(grads[k], np.float64) + cfg.weight_decay * ref[k]
            buf[k] = cfg.momentum * buf[k] + g
            ref[k] = ref[k] - cfg.lr * buf[k]
    for k in ref:
        np.testing.assert_allclose(np.asarray(params[k]), ref[k], rtol=1e-5)

    # frozen mask: masked leaves get EXACTLY zero update (weight decay must
    # not leak into frozen leaves; torch requires_grad=False semantics)
    mask = {"w": True, "b": False}
    leaves, treedef = jax.tree_util.tree_flatten(mask)
    tx_m = _cached_tx((treedef, tuple(leaves)))
    p2 = {"w": jnp.asarray([1.0, 1.0, 1.0]), "b": jnp.asarray([2.0, 2.0])}
    st2 = _set_injected_hyperparams(tx_m.init(p2), cfg)
    up2, _ = tx_m.update(grads, st2, p2)
    np.testing.assert_array_equal(np.asarray(up2["w"]), 0.0)
    assert np.all(np.asarray(up2["b"]) != 0.0)
