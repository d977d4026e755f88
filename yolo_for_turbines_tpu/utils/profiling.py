"""Profiling hooks: jax.profiler traces + per-step wall timing.

The reference has no profiling beyond tqdm + a wall-clock W&B metric
(SURVEY.md section 5). `trace_scope` captures a TensorBoard-loadable
device trace; `StepTimer` tracks host-side step latency percentiles
cheaply enough to stay on in production.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, List, Optional


@contextlib.contextmanager
def trace_scope(log_dir: str = "/tmp/jax-trace"):
    """Capture a jax.profiler trace (view with TensorBoard's profile tab)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Host wall-clock step timer with percentile summaries."""

    def __init__(self, capacity: int = 10_000):
        self.samples: List[float] = []
        self.capacity = capacity
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        if len(self.samples) < self.capacity:
            self.samples.append(dt)
        return dt

    @contextlib.contextmanager
    def measure(self):
        self.start()
        yield
        self.stop()

    def summary(self) -> Dict[str, float]:
        import numpy as np

        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "p99_s": float(np.percentile(arr, 99)),
        }


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    `JAX_COMPILATION_CACHE_DIR` when it is set: JAX reads it itself and no
    directory is set here. Otherwise the fixed `<checkout>/.jax_cache`
    (listed in .gitignore); a directory that moves between runs never hits,
    so the path never holds a temporary name, a process id or a time.
    Entry points (bench.py, chip_smoke.py, the train and demo CLIs) call
    this before their first compile."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(Path(__file__).resolve().parents[2] / ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """Return `jax.devices()` when they are GPUs.

    Measurements name the device they ran on and never fall back to the
    CPU: any other platform raises."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(f"needs a GPU; JAX found {devices[0].platform}")
    return devices


def gpu_cards() -> str:
    """The cards' names and power limits, one line per card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them. A card set below its maximum power runs slower under load, so
    every timing is reported beside this."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
