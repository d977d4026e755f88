"""Debug-mode numerics guards (NaN detection under jit).

The reference sprinkles NaN asserts through the forward pass and training
loop (reference: code/model.py:175,183-184; code/train.py:84-85). Under jit
those would be free-standing host asserts that break tracing; the JAX-native
equivalents are:

- `debug_nans(True)`: global jax.config debug_nans flag -- every jitted
  computation re-runs op-by-op on NaN production and raises at the exact op.
- `checked_loss`: a checkify-wrapped loss for selective in-jit validation
  without the global (slow) flag.
"""

from __future__ import annotations

import contextlib


def debug_nans(enable: bool = True) -> None:
    """Toggle jax's global NaN debugging (use in debug runs only: disables
    some fusion and adds sync points)."""
    import jax

    jax.config.update("jax_debug_nans", enable)


@contextlib.contextmanager
def debug_nans_scope():
    import jax

    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def checked_loss(loss_fn):
    """Wrap a loss fn with checkify so NaN/Inf in the result raises with a
    payload when `err.throw()` is called host-side.

    Returns fn(*args) -> (err, value); call err.throw() to raise.
    """
    import jax
    from jax.experimental import checkify

    def wrapped(*args, **kwargs):
        def inner(*a, **k):
            out = loss_fn(*a, **k)
            leaf = out[0] if isinstance(out, tuple) else out
            checkify.check(
                jax.numpy.isfinite(leaf).all(), "non-finite loss detected"
            )
            return out

        return checkify.checkify(inner)(*args, **kwargs)

    return wrapped
