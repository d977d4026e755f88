"""Plotting / profiling / debug utility tests."""

import os
from pathlib import Path

import numpy as np
import pytest

from yolo_for_turbines_tpu.utils.plotting import plot_image_with_boxes, plot_original
from yolo_for_turbines_tpu.utils.profiling import StepTimer
from yolo_for_turbines_tpu.utils.seed import seed_everything


def test_plot_image_with_boxes_smoke(rng):
    img = rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)
    boxes = [[0.5, 0.5, 0.3, 0.4, 0.9, 0], [0.2, 0.3, 0.1, 0.1, 0.7, 1]]
    out = plot_image_with_boxes(img, boxes, ["dirt", "damage"])
    assert out.size[0] > 0 and out.size[1] > 0
    # no boxes: returns the input unchanged
    out2 = plot_image_with_boxes(img, [], ["dirt", "damage"])
    assert np.asarray(out2).shape == img.shape


def test_plot_original_unletterboxes(rng):
    img = rng.integers(0, 255, (100, 300, 3), dtype=np.uint8)
    boxes = [[0.5, 0.5, 0.2, 0.1, 0.9, 0]]
    out = plot_original(img, (416, 416), boxes, ["dirt", "damage"])
    assert out.size[0] > 0


def test_step_timer():
    t = StepTimer()
    for _ in range(5):
        with t.measure():
            pass
    s = t.summary()
    assert s["steps"] == 5 and s["p50_s"] >= 0


def test_seed_everything_returns_key():
    key = seed_everything(7)
    assert key.shape in ((), (2,))  # typed or raw PRNG key


@pytest.mark.parametrize("env", [None, "/srv/jax-cache"])
def test_compilation_cache_placement(monkeypatch, env):
    """Unset: the fixed <checkout>/.jax_cache. Set: JAX reads the variable
    itself and no directory is set in code."""
    import jax

    from yolo_for_turbines_tpu.utils import profiling

    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    updates = []
    monkeypatch.setattr(
        jax.config, "update", lambda name, value: updates.append((name, value))
    )
    path = profiling.enable_compilation_cache()
    checkout = Path(profiling.__file__).resolve().parents[2]
    if env is None:
        assert path == str(checkout / ".jax_cache")
        assert updates == [("jax_compilation_cache_dir", path)]
        assert ".jax_cache/" in (checkout / ".gitignore").read_text().split()
    else:
        assert path == env
        assert updates == []


def test_require_gpu_refuses_other_platforms():
    from yolo_for_turbines_tpu.utils.profiling import require_gpu

    with pytest.raises(RuntimeError, match="needs a GPU; JAX found cpu"):
        require_gpu()


def test_main_path_imports_without_optional_packages():
    """Predictor, the train step and the serving bundle import with only
    JAX, numpy and optax: Pillow, orbax and matplotlib are blocked."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('PIL', 'orbax', 'matplotlib'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import yolo_for_turbines_tpu.inference\n"
        "import yolo_for_turbines_tpu.serving\n"
        "import yolo_for_turbines_tpu.train.steps\n"
        "import yolo_for_turbines_tpu.data\n"
    )
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr[-2000:]
