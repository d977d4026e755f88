"""ASHA HPO driver tests (no training involved: synthetic objective)."""

import json

import numpy as np
import pytest

from yolo_for_turbines_tpu.train.hpo import (
    ASHAScheduler,
    Choice,
    GridSearch,
    LogUniform,
    Trial,
    Uniform,
    load_config,
    sample_config,
    tune_model,
)


def test_search_space_sampling():
    rng = np.random.default_rng(0)
    space = {
        "lr": LogUniform(1e-4, 1e-1),
        "momentum": Uniform(0.8, 0.99),
        "activation": Choice(("mish", "leaky_relu")),
        "batch_size": 16,
    }
    cfgs = [sample_config(space, rng) for _ in range(50)]
    assert all(1e-4 <= c["lr"] <= 1e-1 for c in cfgs)
    assert all(0.8 <= c["momentum"] <= 0.99 for c in cfgs)
    assert {c["activation"] for c in cfgs} == {"mish", "leaky_relu"}
    assert all(c["batch_size"] == 16 for c in cfgs)


def test_asha_rung_budgets():
    s = ASHAScheduler(grace_period=2, reduction_factor=2, max_t=16)
    assert s.rung_budget(0, 0) == 2
    assert s.rung_budget(0, 1) == 4
    assert s.rung_budget(1, 0) == 4
    assert s.rung_budget(0, 3) == 16


def test_asha_promotes_good_kills_bad():
    s = ASHAScheduler(grace_period=2, reduction_factor=2, brackets=1, max_t=8)
    good = Trial(config={}, id=0, bracket=0)
    bad = Trial(config={}, id=1, bracket=0)
    assert s.on_result(good, 0.9)  # first at rung: promoted
    assert not s.on_result(bad, 0.1)  # below the median cutoff


def test_tune_model_finds_optimum(tmp_path):
    """Objective: mAP = 1 - |lr - 0.01| * 10, improves with epochs; ASHA must
    prefer lr near 0.01."""

    def train_fn(config, num_epochs, resume):
        epochs = (resume or 0) + num_epochs
        score = max(0.0, 1 - abs(config["lr"] - 0.01) * 10) * min(
            1.0, epochs / 8
        )
        return score, epochs

    best = tune_model(
        train_fn,
        {"lr": LogUniform(1e-4, 1e-1)},
        num_samples=16,
        model_folder_path=tmp_path,
        max_epochs=8,
        seed=0,
    )
    assert abs(best["config"]["lr"] - 0.01) < 0.05
    # best_config.json round-trips through load_config (reference parity)
    loaded = load_config(tmp_path, "best_config.json")
    assert loaded == best["config"]


def test_grid_search_expansion(tmp_path):
    seen = []

    def train_fn(config, num_epochs, resume):
        seen.append(config["warmup"])
        return config["warmup"], None

    tune_model(
        train_fn,
        {"warmup": GridSearch((0.01, 0.02, 0.03))},
        num_samples=3,
        model_folder_path=tmp_path,
        max_epochs=2,
    )
    assert set(seen) == {0.01, 0.02, 0.03}


# ---------------------------------------------------------------------------
# Concurrent (subprocess) trial execution
# ---------------------------------------------------------------------------


class _RecordingTrainFn:
    """Module-level picklable toy objective for spawn workers: records its
    pid and run interval to disk so the test can prove real multi-process
    overlap."""

    def __init__(self, out_dir, sleep_s=0.6):
        self.out_dir = str(out_dir)
        self.sleep_s = sleep_s

    def __call__(self, config, num_epochs, resume):
        import os
        import time
        from pathlib import Path

        start = time.time()
        time.sleep(self.sleep_s)
        epochs = (resume or 0) + num_epochs
        score = max(0.0, 1 - abs(config["lr"] - 0.01) * 10) * min(1.0, epochs / 4)
        stamp = f"{os.getpid()} {start:.4f} {time.time():.4f}\n"
        with open(Path(self.out_dir) / f"run_{os.getpid()}_{start:.4f}.txt", "w") as f:
            f.write(stamp)
        return score, epochs


def test_tune_model_concurrent_subprocess_trials(tmp_path):
    """max_concurrent=2 must run trials in >=2 distinct OS processes with
    overlapping run intervals (the reference runs <=2 concurrent Ray trials,
    code/train.py:258-264), and still converge like the sequential path."""
    best = tune_model(
        _RecordingTrainFn(tmp_path),
        {"lr": Choice((0.3, 0.05, 0.012, 0.001))},
        num_samples=4,
        model_folder_path=tmp_path,
        max_epochs=4,
        grace_period=1,
        seed=0,
        max_concurrent=2,
    )
    assert abs(best["config"]["lr"] - 0.012) < 1e-9

    runs = []
    for p in tmp_path.glob("run_*.txt"):
        pid, start, end = p.read_text().split()
        runs.append((int(pid), float(start), float(end)))
    pids = {r[0] for r in runs}
    assert len(pids) >= 2, f"expected >=2 worker processes, saw {pids}"
    overlap = any(
        a[0] != b[0] and a[1] < b[2] and b[1] < a[2]
        for a in runs
        for b in runs
    )
    assert overlap, "no two runs from different processes overlapped in time"


def test_hpo_train_fn_is_picklable(tmp_path):
    import pickle

    from yolo_for_turbines_tpu.train.trainer import make_hpo_train_fn

    fn = make_hpo_train_fn(tmp_path, tmp_path, num_workers=2)
    blob = pickle.dumps(fn)
    fn2 = pickle.loads(blob)
    assert fn2.num_workers == 2
    assert str(fn2.csv_folder_path) == str(tmp_path)


def test_tune_model_concurrent_survives_worker_error(tmp_path):
    """A crashing trial scores -inf and the search completes."""
    best = tune_model(
        _FailingOnBadLr(tmp_path),
        {"lr": Choice((0.5, 0.01))},
        num_samples=2,
        model_folder_path=tmp_path,
        max_epochs=2,
        grace_period=1,
        seed=0,
        max_concurrent=2,
    )
    assert best["config"]["lr"] == 0.01


class _FailingOnBadLr:
    def __init__(self, out_dir):
        self.out_dir = str(out_dir)

    def __call__(self, config, num_epochs, resume):
        if config["lr"] > 0.1:
            raise RuntimeError("diverged")
        epochs = (resume or 0) + num_epochs
        return 1.0 - abs(config["lr"] - 0.01), epochs


class _AlwaysFails:
    def __call__(self, config, num_epochs, resume):
        raise RuntimeError("boom")


def test_tune_model_concurrent_all_failed_raises(tmp_path):
    """When every subprocess trial fails, tune_model must raise with the
    trial errors instead of writing a garbage best_config.json."""
    with pytest.raises(RuntimeError, match="every HPO trial failed.*boom"):
        tune_model(
            _AlwaysFails(),
            {"lr": Choice((0.5, 0.01))},
            num_samples=2,
            model_folder_path=tmp_path,
            max_epochs=2,
            grace_period=1,
            seed=0,
            max_concurrent=2,
        )
    assert not (tmp_path / "best_config.json").exists()


class _ReportsMemFraction:
    """Scores each trial with the XLA_PYTHON_CLIENT_MEM_FRACTION its
    spawned worker process started with."""

    def __call__(self, config, num_epochs, resume):
        import os

        return float(os.environ["XLA_PYTHON_CLIENT_MEM_FRACTION"]), 0


@pytest.mark.parametrize("max_concurrent", [2, 3])
def test_concurrent_workers_share_card_memory(tmp_path, monkeypatch,
                                              max_concurrent):
    """Workers sharing one card each get 0.9 / max_concurrent of its memory
    (a JAX process otherwise reserves three quarters at start, so the
    second would fail); the parent's own environment is left as it was."""
    import os

    monkeypatch.delenv("XLA_PYTHON_CLIENT_MEM_FRACTION", raising=False)
    best = tune_model(
        _ReportsMemFraction(),
        {"lr": Choice((0.1, 0.01))},
        num_samples=2,
        model_folder_path=tmp_path,
        max_epochs=1,
        grace_period=1,
        max_concurrent=max_concurrent,
    )
    assert best["mAP"] == pytest.approx(0.9 / max_concurrent, abs=1e-4)
    assert "XLA_PYTHON_CLIENT_MEM_FRACTION" not in os.environ
