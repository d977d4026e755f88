"""chip_smoke.py: the device check, and every phase rehearsed on the CPU
at a tiny size (mini model, Triton kernel in the Pallas interpreter)."""

import pytest

import chip_smoke
from helpers import MINI_LAYERS
from yolo_for_turbines_tpu import inference
from yolo_for_turbines_tpu.ops.pallas import nms_kernel

TINY = chip_smoke.Sizes(
    image=64, batch=8, train_batch=4, layer_config=MINI_LAYERS,
    nms_candidates=400, nms_k=128, iters=1,
)


@pytest.fixture
def interpreted_kernel(monkeypatch):
    """Every Predictor takes the kernel, as on the card, and the kernel runs
    in the Pallas interpreter (inside shard_map too)."""
    sweep = nms_kernel.greedy_sweep_pallas
    monkeypatch.setattr(
        nms_kernel, "greedy_sweep_pallas",
        lambda sup, valid, interpret=False: sweep(sup, valid, interpret=True),
    )
    monkeypatch.setattr(inference, "default_use_pallas_nms", lambda: True)


def test_refuses_a_cpu_device(capsys):
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_one_card_phases_at_tiny_size(interpreted_kernel, capsys):
    chip_smoke.run(cards=1, sizes=TINY)
    phases = [line for line in capsys.readouterr().out.splitlines()
              if line.startswith('{"phase"')]
    assert [p.split('"')[3] for p in phases] == [
        "inference", "nms", "train", "export"
    ]


def test_four_card_phase_at_tiny_size(interpreted_kernel, capsys):
    chip_smoke.run(cards=4, sizes=TINY)
    out = capsys.readouterr().out
    assert '"phase": "cards4"' in out and '"nms_masks_identical": true' in out


def test_check_raises_with_detail():
    with pytest.raises(chip_smoke.SmokeFailure, match='"err": 0.5'):
        chip_smoke.check(False, "what", err=0.5)
    chip_smoke.check(True, "fine")
