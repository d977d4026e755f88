"""Checkpointing via orbax (params + batch stats + optimizer state + step).

Replaces torch.save state_dict checkpoints (reference: code/utils.py:383-416)
with orbax's async-capable checkpoint format. The reference's
"force lr into param groups on load" semantics are preserved by the caller
rebuilding the optax schedule from its (possibly new) TrainConfig -- the
schedule is a pure function of step, so restoring `step` + a new lr is
exactly the reference's lr override.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import jax

from .steps import TrainState


def save_checkpoint(state: TrainState, filename) -> None:
    """Save a TrainState (reference: code/utils.py:383-396)."""
    import orbax.checkpoint as ocp

    path = Path(filename).absolute()
    if path.exists():
        import shutil

        shutil.rmtree(path)
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(path, jax.device_get(state._asdict()))


def load_checkpoint(
    state: TrainState, filename, lr_override: Optional[float] = None
) -> TrainState:
    """Restore into the template TrainState's structure
    (reference: code/utils.py:398-416). lr_override forces the restored
    schedule's peak lr (TrainState.hyper["lr"]) — the literal analogue of
    the reference forcing lr into the optimizer param groups on load."""
    import orbax.checkpoint as ocp

    path = Path(filename).absolute()
    with ocp.PyTreeCheckpointer() as ckptr:
        template = jax.device_get(state._asdict())
        restored = ckptr.restore(path, item=template)
    if lr_override is not None:
        restored["hyper"] = dict(
            restored["hyper"], lr=jax.numpy.asarray(lr_override, "float32")
        )
    return TrainState(**restored)
