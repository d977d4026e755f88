"""Pin the composed-recipe driver's custom-anchor assertion machinery.

benchmarks/convergence_run.py is the driver that proves BASELINE config #3
(the reference's full default recipe — k-means custom anchors + backbone
import + mosaic + multi-scale — as ONE composition, reference:
code/train.py:166-197, code/config.py:34-57). Its
`_assert_custom_anchor_assignment` is what makes the hardware run a proof
rather than a vibe: it independently recomputes the expected best-anchor
slot for real boxes and requires the encoding to diverge from the
default-anchor encoding. These tests pin that checker itself so a future
dataset/encoder change can't silently hollow the assertion out.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from yolo_for_turbines_tpu import config as cfg
from yolo_for_turbines_tpu.data.synthetic import generate_synthetic_dataset
from yolo_for_turbines_tpu.tools.anchors import (
    group_by_scale,
    kmeans_anchors,
    load_wh_boxes,
)

_DRIVER = Path(__file__).resolve().parent.parent / "benchmarks" / "convergence_run.py"


@pytest.fixture(scope="module")
def driver():
    spec = importlib.util.spec_from_file_location("convergence_run", _DRIVER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("conv_driver")
    generate_synthetic_dataset(root, num_images=24, image_size=(320, 240))
    return root


def test_kmeans_anchor_assertion_passes(driver, synth_root):
    """The full composed-run anchor flow: k-means++ the run's own labels,
    then the checker verifies assignment and divergence (what the on-chip
    composed run executes before training starts)."""
    whs = load_wh_boxes(synth_root / "labels")
    centroids, mean_iou = kmeans_anchors(whs, k=9)
    anchors = np.asarray(group_by_scale(centroids), np.float32)
    assert 0.0 < mean_iou <= 1.0
    meta = driver._assert_custom_anchor_assignment(anchors, synth_root)
    assert meta["anchor_assignment_spot_checks"] == 8
    assert meta["anchor_assignment_diverges_from_default"] is True


def test_default_anchors_fail_divergence(driver, synth_root):
    """Feeding the checker the DEFAULT anchors must trip the divergence
    assertion — identical assignments would mean the 'custom anchors
    reached training' claim proves nothing."""
    anchors = np.asarray(cfg.TURBINE_ANCHORS, np.float32)
    with pytest.raises(AssertionError, match="identical assignments"):
        driver._assert_custom_anchor_assignment(anchors, synth_root)


def test_checker_tracks_anchor_content_not_position(driver, synth_root):
    """Permuting anchors within each scale must not break the spot-check:
    the independent argmax and assign_targets must permute together,
    proving the checker compares anchor CONTENT, not slot conventions."""
    whs = load_wh_boxes(synth_root / "labels")
    centroids, _ = kmeans_anchors(whs, k=9)
    anchors = np.asarray(group_by_scale(centroids), np.float32)
    permuted = anchors[:, ::-1, :].copy()  # reverse within each scale
    meta = driver._assert_custom_anchor_assignment(permuted, synth_root)
    assert meta["anchor_assignment_diverges_from_default"] is True


def test_hires_driver_ft_surface():
    """Pin the hi-res driver's fine-tune stage: the flags of the fixed-size
    fine-tune exist, the fine-tune restores
    from the BASE checkpoint (load_checkpoint=True) at one FIXED resolution
    (multi_scale=False), and the eval stage sweeps the same checkpoint
    across sizes — so a future edit can't silently turn the '832 needs 832
    training' receipt into a fresh-init run."""
    src = (_DRIVER.parent / "hires_eval.py").read_text()
    for flag in ("--finetune-size", "--finetune-total-steps",
                 "--finetune-lr", "--finetune-batch-size",
                 "--skip-train", "--eval-sizes"):
        assert f'"{flag}"' in src, f"hires driver lost {flag}"
    assert "load_checkpoint=True" in src          # ft restores the base ckpt
    assert "multi_scale=False" in src             # ft is fixed-resolution
    assert 'checkpoint_name=ckpt.name' in src     # restore SOURCE is the base
    # the queue drives it with the ft stage off (base receipt) and the
    # round-5 follow-up ran --finetune-size 832 by hand; both must parse
    assert '"--eval-sizes", default="416,608,832"' in src


def test_driver_cli_surface(driver):
    """The composed-recipe flags exist, and the driver's usage documents
    the composed invocations with them."""
    src = _DRIVER.read_text()
    for flag in ("--kmeans-anchors", "--anchors", "--backbone",
                 "--load-weights", "--mosaic", "--freeze-backbone"):
        assert f'"{flag}"' in src, f"driver lost {flag}"
    usage = " ".join(driver.__doc__.replace("\\\n", " ").split())
    assert "--kmeans-anchors --load-weights --mosaic --decay-lr" in usage
    assert "--backbone cspdarknet53 --mosaic" in usage
