"""Run a real ASHA hyperparameter search on one accelerator.

HPO is compile-dominated when every Ray-style trial pays a fresh full-model
jit per multi-scale bucket. lr/momentum/weight_decay live in traced state (optax.inject_hyperparams +
schedule-in-state; train/steps.py::make_train_step), so same-architecture
trials share one compiled executable. This driver proves the claim on
hardware: it runs `tune_model` (the reference's tune_model seam,
reference: code/train.py:241-284) over N sampled configs on the synthetic
detection dataset and reports

  {"trials": N, "total_epochs": E, "train_step_compiles": C, ...}

where C stays at the number of distinct input SHAPES (with multi-scale
off: train_step=1 and eval_step=1, regardless of trial count), not the
number of trials. Compiles are counted with jax_log_compiles + a logging
handler — the same signal a human would read.

Usage (GPU host):
  python benchmarks/hpo_run.py --num-samples 6
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class CompileCounter(logging.Handler):
    """Counts 'Finished XLA compilation of jit(<fn>)' log records.

    A Handler (not a Filter) because records logged on child loggers
    (jax._src.dispatch etc.) propagate up to ancestor HANDLERS only.
    Only backend compiles are counted — 'tracing + transforming' lines
    are cheap retraces, not the ~90s XLA compiles the sharing
    optimization eliminates.
    """

    def __init__(self):
        super().__init__()
        self.by_fn = {}

    def emit(self, record):
        msg = record.getMessage()
        m = re.search(r"Finished XLA compilation of (?:jit\()?([\w.<>-]+)", msg)
        if m:
            fn = m.group(1)
            self.by_fn[fn] = self.by_fn.get(fn, 0) + 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="/tmp/convergence")
    ap.add_argument("--num-images", type=int, default=416)
    ap.add_argument("--num-samples", type=int, default=6)
    ap.add_argument("--max-epochs", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=416,
                    help="fixed trial resolution (multi_scale is off so the "
                         "1-compile-per-shape claim is crisp); small values "
                         "make CPU shakeouts feasible")
    ap.add_argument("--num-workers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_log_compiles", True)
    counter = CompileCounter()
    # jax emits the compile-finished line from module loggers under "jax."
    # (version-dependent which one); all propagate up to the "jax" logger.
    logging.getLogger("jax").addHandler(counter)

    from yolo_for_turbines_tpu.data.splits import create_csv_files
    from yolo_for_turbines_tpu.data.synthetic import generate_synthetic_dataset
    from yolo_for_turbines_tpu.train.hpo import LogUniform, Uniform, tune_model
    from yolo_for_turbines_tpu.train.trainer import make_hpo_train_fn

    root = Path(args.root)
    if not (root / "train.csv").exists():
        print("generating synthetic dataset ...", flush=True)
        generate_synthetic_dataset(root, num_images=args.num_images)
        create_csv_files(
            root / "images", root / "labels", root,
            {"train": 0.85, "val": 0.15}, image_ext=".jpg",
        )
    model_dir = root / "models_hpo"
    model_dir.mkdir(parents=True, exist_ok=True)

    # Reference search space shape (code/train.py:298-301): lr, momentum,
    # weight_decay. batch/arch held fixed so the executable-sharing claim
    # is exactly "N trials, 1 train-step compile per input shape".
    space = {
        "lr": LogUniform(3e-4, 3e-3),
        "momentum": Uniform(0.85, 0.95),
        "weight_decay": LogUniform(1e-5, 1e-3),
        "batch_size": args.batch_size,
        "image_size": args.image_size,
        "multi_scale": False,
        "cache_images": True,
        "warmup": 0.05,
        "decay_lr": True,
        "max_num_steps": 900,
    }
    train_fn = make_hpo_train_fn(
        root, model_dir,
        image_folder=root / "images",
        annotation_folder=root / "labels",
        num_workers=args.num_workers,
    )

    t0 = time.time()
    best = tune_model(
        train_fn,
        space,
        num_samples=args.num_samples,
        model_folder_path=model_dir,
        max_epochs=args.max_epochs,
        seed=args.seed,
    )
    wall = time.time() - t0

    total_epochs = 0
    for f in model_dir.glob("hpo_trial_*_metrics.jsonl"):
        rows = [json.loads(l) for l in open(f)]
        epochs = [r["epoch"] for r in rows if "epoch" in r]
        total_epochs += max(epochs) if epochs else 0

    step_compiles = {
        fn: n for fn, n in counter.by_fn.items() if "step" in fn.lower()
    }
    print(json.dumps({
        "best": best,
        "trials": args.num_samples,
        "total_epochs": total_epochs,
        "wall_clock_s": round(wall, 1),
        "train_step_compiles": step_compiles,
        "all_compiles": counter.by_fn,
    }))


if __name__ == "__main__":
    main()
