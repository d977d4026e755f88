"""Serving-bundle tests: pickle-free save/load round-trips and hermetic
StableHLO exports (serving.py). The deployment analogue of the reference's
pickled-model hand-off (reference: code/demo.py:16-28), so the bar is
bit-identical round-trips, not approximate ones."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from helpers import mini_model
from yolo_for_turbines_tpu.inference import Predictor
from yolo_for_turbines_tpu.serving import (
    ExportedPredictor,
    add_export_to_bundle,
    export_serving_module,
    load_predictor_bundle,
    save_predictor,
    spec_to_tree,
    tree_to_spec,
)


@pytest.fixture(scope="module")
def mini_pred():
    model = mini_model()
    params, stats = model.init(jax.random.PRNGKey(0))
    folded = model.fold(params, stats)
    return Predictor(
        model, folded, image_size=128, conf_threshold=0.2, max_boxes=16,
        compute_dtype=jnp.float32,
    )


@pytest.fixture(scope="module")
def batch():
    return np.random.default_rng(0).uniform(0, 1, (2, 128, 128, 3)).astype(
        np.float32
    )


def test_tree_codec_roundtrip():
    tree = {
        "layers": [
            {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
             "b": np.zeros(3, np.int8), "stride": 2},
            None,
        ],
        "scales": jnp.ones((4,), jnp.float32),
        "mode": "int8",
        "nested": ({"q": np.ones((2,), np.dtype(jnp.bfloat16))}, 0.5, True),
    }
    spec, leaves = tree_to_spec(tree)
    # bf16 leaves are stored widened to f32 in the npz...
    assert all(a.dtype != np.dtype(jnp.bfloat16) for a in leaves.values())
    back = spec_to_tree(json.loads(json.dumps(spec)), leaves)
    # ...and restored to bf16 on decode
    assert back["nested"][0]["q"].dtype == np.dtype(jnp.bfloat16)
    assert isinstance(back["nested"], tuple)
    assert isinstance(back["layers"], list)
    assert back["layers"][1] is None
    assert back["layers"][0]["stride"] == 2 and back["mode"] == "int8"
    np.testing.assert_array_equal(back["layers"][0]["w"], tree["layers"][0]["w"])
    np.testing.assert_array_equal(
        np.asarray(back["scales"]), np.asarray(tree["scales"])
    )


def test_bundle_roundtrip_bitwise(tmp_path, mini_pred, batch):
    kept0, mask0 = mini_pred.predict_batch(batch)
    out = save_predictor(mini_pred, tmp_path / "bundle")
    # no pickle anywhere in the artifact
    for f in out.rglob("*"):
        assert f.suffix in (".json", ".npz"), f
    loaded = load_predictor_bundle(out, use_pallas_nms=False)
    assert loaded.image_size == mini_pred.image_size
    assert loaded.conf_threshold == mini_pred.conf_threshold
    assert loaded.max_boxes == mini_pred.max_boxes
    kept1, mask1 = loaded.predict_batch(batch)
    np.testing.assert_array_equal(np.asarray(mask0), np.asarray(mask1))
    np.testing.assert_array_equal(np.asarray(kept0), np.asarray(kept1))


def test_bundle_roundtrip_quantized(tmp_path, mini_pred, batch):
    mini_pred.quantize(batch)
    try:
        kept0, mask0 = mini_pred.predict_batch(batch)
        out = save_predictor(mini_pred, tmp_path / "qbundle")
        loaded = load_predictor_bundle(out, use_pallas_nms=False)
        assert getattr(loaded, "_qparams", None) is not None
        # every restored array leaf is already a device array (a host-numpy
        # leaf in a jitted arg tree re-uploads per call; see CLAUDE.md)
        for leaf in jax.tree_util.tree_leaves(loaded._qparams):
            assert not isinstance(leaf, np.ndarray)
        kept1, mask1 = loaded.predict_batch(batch)
        np.testing.assert_array_equal(np.asarray(mask0), np.asarray(mask1))
        np.testing.assert_array_equal(np.asarray(kept0), np.asarray(kept1))
    finally:
        del mini_pred._qparams  # module-scoped fixture: restore bf16 path


def test_bundle_with_retired_config_keys_loads(tmp_path, mini_pred, batch):
    """Bundles written before `fuse_resblocks` was removed carry it in the
    manifest's model config; loading drops keys ModelConfig no longer has
    instead of failing in ModelConfig(**m)."""
    out = save_predictor(mini_pred, tmp_path / "oldbundle")
    manifest = json.loads((out / "manifest.json").read_text())
    manifest["model"]["fuse_resblocks"] = True
    (out / "manifest.json").write_text(json.dumps(manifest))
    loaded = load_predictor_bundle(out, use_pallas_nms=False)
    assert loaded.model.cfg == mini_pred.model.cfg
    kept0, mask0 = mini_pred.predict_batch(batch)
    kept1, mask1 = loaded.predict_batch(batch)
    np.testing.assert_array_equal(np.asarray(mask0), np.asarray(mask1))
    np.testing.assert_array_equal(np.asarray(kept0), np.asarray(kept1))


def test_exported_module_matches_live(tmp_path, mini_pred, batch):
    out = save_predictor(mini_pred, tmp_path / "ebundle")
    blob_path = add_export_to_bundle(out, batch_size=2, platforms=("cpu",))
    assert blob_path.exists() and blob_path.stat().st_size > 0
    manifest = json.loads((out / "manifest.json").read_text())
    (name, meta), = manifest["exports"].items()
    assert meta["batch_size"] == 2 and meta["image_size"] == 128

    exported = ExportedPredictor(out)
    kept_e, mask_e = exported.predict_batch(batch)
    kept0, mask0 = mini_pred.predict_batch(batch)
    np.testing.assert_array_equal(np.asarray(mask0), np.asarray(mask_e))
    np.testing.assert_array_equal(np.asarray(kept0), np.asarray(kept_e))


def test_exported_quantized_matches_live_int8(tmp_path, mini_pred, batch):
    """The int8 serving pipeline through the hermetic export (round-3
    advisor: previously only the bf16 export had an A/B test): quantize ->
    bundle with both trees -> multi-platform export -> ExportedPredictor
    must reproduce the live int8 Predictor exactly, and the portable blob
    must contain no Pallas kernel."""
    from yolo_for_turbines_tpu.serving import _portable_predictor

    mini_pred.quantize(batch)
    try:
        kept0, mask0 = mini_pred.predict_batch(batch)  # live int8 path
        out = save_predictor(mini_pred, tmp_path / "qe_bundle")
        blob_path = add_export_to_bundle(
            out, batch_size=2, platforms=("cpu", "cuda")
        )
        manifest = json.loads((out / "manifest.json").read_text())
        assert manifest["exports"][blob_path.name]["quantized"] is True

        # the portable clone pins the XLA NMS regardless of the exporting
        # host's platform...
        assert _portable_predictor(mini_pred).use_pallas_nms is False
        # ...so the multi-platform module has no Pallas kernel in it
        exp = jax.export.deserialize(blob_path.read_bytes())
        assert set(p.lower() for p in exp.platforms) == {"cpu", "cuda"}
        assert "triton" not in exp.mlir_module()

        exported = ExportedPredictor(out)
        assert exported.meta["quantized"] is True
        kept_e, mask_e = exported.predict_batch(batch)
        np.testing.assert_array_equal(np.asarray(mask0), np.asarray(mask_e))
        np.testing.assert_array_equal(np.asarray(kept0), np.asarray(kept_e))
    finally:
        del mini_pred._qparams  # module-scoped fixture: restore bf16 path


def test_save_predictor_overwrite_clears_stale_exports(tmp_path, mini_pred):
    """Re-saving into an existing bundle dir resets the exports index, so
    the stale blobs (lowered from whatever weights were there before) must
    be deleted, not orphaned where a glob can pick them up."""
    out = save_predictor(mini_pred, tmp_path / "owbundle")
    blob_path = add_export_to_bundle(out, batch_size=1, platforms=("cpu",))
    assert blob_path.exists()

    out2 = save_predictor(mini_pred, tmp_path / "owbundle")
    manifest = json.loads((out2 / "manifest.json").read_text())
    assert manifest["exports"] == {}
    assert not blob_path.exists()
    assert list((out2 / "exports").rglob("*.jaxexport")) == []


def test_exported_predictor_quantized_flag_mismatch(tmp_path, mini_pred, batch):
    """An export recorded as quantized must refuse to run against a bundle
    whose int8 tree is gone (clear error instead of an opaque pytree
    flatten failure)."""
    mini_pred.quantize(batch)
    try:
        out = save_predictor(mini_pred, tmp_path / "mmbundle")
        add_export_to_bundle(out, batch_size=2, platforms=("cpu",))
    finally:
        del mini_pred._qparams
    # doctor the bundle: drop the int8 tree but keep the quantized export
    (out / "quantized.npz").unlink()
    manifest = json.loads((out / "manifest.json").read_text())
    del manifest["quantized_spec"]
    (out / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="no quantized.npz"):
        ExportedPredictor(out)


def test_export_multiplatform_lowering(mini_pred):
    """The default (cpu, cuda) export must lower from this CPU host: the
    portable pipeline may not hold a Pallas kernel, whose custom call
    jax.export refuses to serialize."""
    blob = export_serving_module(mini_pred, batch_size=1)
    exp = jax.export.deserialize(blob)
    assert set(p.lower() for p in exp.platforms) == {"cpu", "cuda"}


def test_export_cli(tmp_path, monkeypatch):
    """CLI plumbing end to end: weights arg -> predictor -> bundle with one
    exported serve bucket. The real `load_predictor` builds the 62M-param
    model (slow on CPU), so it is swapped for a mini-model builder; the
    save/export path below it is the production one."""
    import yolo_for_turbines_tpu.inference as inference
    from yolo_for_turbines_tpu.tools.export import main

    model = mini_model()
    params, stats = model.init(jax.random.PRNGKey(3))
    folded = model.fold(params, stats)
    seen = {}

    def fake_load_predictor(weights_path, **kw):
        seen.update(kw, weights_path=weights_path)
        return Predictor(model, folded, image_size=kw["image_size"],
                         compute_dtype=jnp.float32)

    monkeypatch.setattr(inference, "load_predictor", fake_load_predictor)
    out = main(
        [
            "--weights", str(tmp_path / "mini.weights"),
            "--out", str(tmp_path / "clibundle"),
            "--num-classes", "80",
            "--image-size", "128",
            "--export-batch", "1",
            "--export-platforms", "cpu",
        ]
    )
    assert seen["num_classes"] == 80 and seen["image_size"] == 128
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["format_version"] == 1
    (name, meta), = manifest["exports"].items()
    assert meta["batch_size"] == 1 and meta["platforms"] == ["cpu"]
    assert (out / "exports" / name).stat().st_size > 0
