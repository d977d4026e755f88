"""Official darknet binary weight importer (yolov3.weights / darknet53.conv.74).

File format (parity with reference code/model.py:160-170, 227-337):
- 5 x int32 header, then a flat float32 stream.
- Per conv-with-BN layer, the stream holds **BN first, then conv**:
  beta, gamma, running_mean, running_var (each `out_ch` floats), then the
  conv weights in OIHW order. Per bias-conv (the head's final 1x1):
  bias (`out_ch`) then OIHW weights.
- Backbone-only files encode a cutoff in the filename: `darknet53.conv.74`
  -> cutoff 74. The reference counts *parameterized torch layers* -- each
  BatchNorm2d and each Conv2d increments `layer_id`, BN before its conv --
  and stops copying once `layer_id >= cutoff`, while still advancing the
  read offset (reference: code/model.py:277-291). We replicate that count
  exactly: cutoff 74 = 37 conv layers (each contributing a BN id and a conv
  id) receive pretrained weights.
- `freeze=True` marks every copied layer frozen (reference sets
  requires_grad=False only on layers it copied, code/model.py:306-309,
  330-334). Here that becomes a boolean pytree mask for `optax.masked`.

Conv weights are transposed OIHW -> HWIO for the NHWC layout.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from .yolov3 import (
    Plan,
    PlanConv,
    PlanHead,
    PlanMaxPool,
    PlanResidual,
    PlanRoute,
    PlanUpsample,
)


class _Reader:
    def __init__(self, weights: np.ndarray, cutoff: Optional[int]):
        self.weights = weights
        self.param_idx = 0
        self.layer_id = 0
        self.cutoff = cutoff

    def _take(self, n: int) -> np.ndarray:
        chunk = self.weights[self.param_idx : self.param_idx + n]
        if chunk.size != n:
            raise ValueError(
                f"Weight file exhausted: needed {n} floats at offset "
                f"{self.param_idx}, only {chunk.size} left"
            )
        self.param_idx += n
        return chunk

    def _past_cutoff(self) -> bool:
        return self.cutoff is not None and self.layer_id >= self.cutoff

    def read_bn(self, out_ch: int):
        """Returns (beta, gamma, mean, var) or None if past cutoff."""
        skip = self._past_cutoff()
        self.layer_id += 1
        if skip:
            self.param_idx += 4 * out_ch
            return None
        beta = self._take(out_ch).copy()
        gamma = self._take(out_ch).copy()
        mean = self._take(out_ch).copy()
        var = self._take(out_ch).copy()
        return beta, gamma, mean, var

    def read_conv(self, out_ch: int, in_ch: int, k: int, bias: bool):
        """Returns (w_hwio, bias or None) or None if past cutoff."""
        n_w = out_ch * in_ch * k * k
        skip = self._past_cutoff()
        self.layer_id += 1
        if skip:
            if bias:
                self.param_idx += out_ch
            self.param_idx += n_w
            return None
        b = self._take(out_ch).copy() if bias else None
        w = self._take(n_w).reshape(out_ch, in_ch, k, k).transpose(2, 3, 1, 0).copy()
        return w, b


def parse_cutoff(weights_path: str) -> Optional[int]:
    """`darknet53.conv.74` -> 74; full weight files -> None
    (reference: code/model.py:167-170)."""
    name = os.path.basename(str(weights_path))
    if ".conv" in name:
        return int(name.split(".")[-1])
    return None


def read_weights_file(weights_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (header int32[5], flat float32 weights)."""
    with open(weights_path, "rb") as f:
        header = np.fromfile(f, dtype=np.int32, count=5)
        weights = np.fromfile(f, dtype=np.float32)
    return header, weights


def _load_conv_with_bn(reader: _Reader, entry_params, entry_stats, in_ch, out_ch, k):
    """Load one BN+conv pair into (params, stats) dicts; returns loaded flag."""
    bn = reader.read_bn(out_ch)
    conv = reader.read_conv(out_ch, in_ch, k, bias=False)
    loaded = False
    if bn is not None:
        beta, gamma, mean, var = bn
        entry_params["bias"] = beta
        entry_params["scale"] = gamma
        entry_stats["mean"] = mean
        entry_stats["var"] = var
        loaded = True
    if conv is not None:
        entry_params["w"] = conv[0]
        loaded = True
    return loaded


def load_darknet_weights(
    weights_path: str,
    plan: Plan,
    params: List,
    batch_stats: List,
    freeze: bool = False,
):
    """Load a darknet binary into (params, batch_stats) pytrees.

    Returns (params, batch_stats, frozen_mask, floats_consumed). The pytrees
    are new nested structures (numpy leaves where loaded, original leaves
    elsewhere). frozen_mask matches params' structure with True at frozen
    leaves; all-False unless freeze (or nothing was loaded for a layer).
    """
    import jax

    _, weights = read_weights_file(weights_path)
    reader = _Reader(weights, parse_cutoff(weights_path))

    params = jax.tree_util.tree_map(np.asarray, params)
    batch_stats = jax.tree_util.tree_map(
        lambda x: np.asarray(x) if x is not None else None,
        batch_stats,
        is_leaf=lambda x: x is None,
    )
    loaded_flags: List = []  # parallel to params: per-conv-dict loaded bool

    for entry, p, s in zip(plan, params, batch_stats):
        if isinstance(entry, PlanConv):
            loaded = _load_conv_with_bn(
                reader, p["conv"], s["conv"], entry.in_ch, entry.out_ch, entry.kernel
            )
            loaded_flags.append({"conv": loaded})
        elif isinstance(entry, PlanResidual):
            flags = []
            c = entry.channels
            for bp, bs in zip(p["blocks"], s["blocks"]):
                l1 = _load_conv_with_bn(reader, bp["conv1"], bs["conv1"], c, c // 2, 1)
                l2 = _load_conv_with_bn(reader, bp["conv2"], bs["conv2"], c // 2, c, 3)
                flags.append({"conv1": l1, "conv2": l2})
            loaded_flags.append({"blocks": flags})
        elif isinstance(entry, PlanHead):
            c = entry.in_ch
            out_ch = (entry.num_classes + 5) * entry.anchors_per_scale
            l1 = _load_conv_with_bn(reader, p["conv1"], s["conv1"], c, entry.mid, 3)
            conv = reader.read_conv(out_ch, entry.mid, 1, bias=True)
            l2 = conv is not None
            if conv is not None:
                p["conv2"]["w"] = conv[0]
                p["conv2"]["b"] = conv[1]
            loaded_flags.append({"conv1": l1, "conv2": l2})
        elif isinstance(entry, (PlanUpsample, PlanMaxPool, PlanRoute)):
            loaded_flags.append({})
        else:
            # CSP stages have no darknet pretrained counterpart: skip.
            loaded_flags.append(
                jax.tree_util.tree_map(lambda _: False, _conv_flags_like(p))
            )

    frozen_mask = _expand_flags_to_mask(params, loaded_flags, freeze)
    return params, batch_stats, frozen_mask, reader.param_idx


def _conv_flags_like(p):
    """Shape a False-flag tree like a params entry (dict of conv dicts)."""
    import jax

    def is_conv(x):
        return isinstance(x, dict) and "w" in x

    return jax.tree_util.tree_map(
        lambda x: False, p, is_leaf=is_conv
    )


def _expand_flags_to_mask(params, loaded_flags, freeze: bool):
    """Per-conv loaded flags -> per-leaf frozen mask (True = frozen)."""
    import jax

    def expand(p, f):
        if isinstance(p, dict) and ("w" in p):
            flag = bool(f) and freeze
            return {k: flag for k in p}
        if isinstance(p, dict):
            return {k: expand(p[k], f[k]) for k in p}
        if isinstance(p, list):
            return [expand(pi, fi) for pi, fi in zip(p, f)]
        raise TypeError(type(p))

    return [expand(p, f) for p, f in zip(params, loaded_flags)]


def expected_num_floats(plan: Plan) -> int:
    """Total floats a full weight file must contain for this plan."""
    total = 0
    for entry in plan:
        if isinstance(entry, PlanConv):
            total += 4 * entry.out_ch + entry.out_ch * entry.in_ch * entry.kernel**2
        elif isinstance(entry, PlanResidual):
            c = entry.channels
            per_block = (4 * (c // 2) + (c // 2) * c) + (4 * c + c * (c // 2) * 9)
            total += entry.num_blocks * per_block
        elif isinstance(entry, PlanHead):
            c = entry.in_ch
            m = entry.mid
            out_ch = (entry.num_classes + 5) * entry.anchors_per_scale
            total += 4 * m + m * c * 9  # 3x3 conv with BN
            total += out_ch + out_ch * m  # 1x1 bias conv
    return total


def export_darknet_weights(plan: Plan, params, batch_stats, path: str):
    """Write (params, batch_stats) back out in darknet binary format.

    Round-trip tool (also used to build test fixtures): the exact inverse of
    `load_darknet_weights` with no cutoff.
    """
    chunks = [np.zeros(5, np.int32).tobytes()]

    def emit_bn_conv(p, s, k_unused=None):
        chunks.append(np.asarray(p["bias"], np.float32).tobytes())
        chunks.append(np.asarray(p["scale"], np.float32).tobytes())
        chunks.append(np.asarray(s["mean"], np.float32).tobytes())
        chunks.append(np.asarray(s["var"], np.float32).tobytes())
        w = np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)  # HWIO -> OIHW
        chunks.append(w.tobytes())

    for entry, p, s in zip(plan, params, batch_stats):
        if isinstance(entry, PlanConv):
            emit_bn_conv(p["conv"], s["conv"])
        elif isinstance(entry, PlanResidual):
            for bp, bs in zip(p["blocks"], s["blocks"]):
                emit_bn_conv(bp["conv1"], bs["conv1"])
                emit_bn_conv(bp["conv2"], bs["conv2"])
        elif isinstance(entry, PlanHead):
            emit_bn_conv(p["conv1"], s["conv1"])
            chunks.append(np.asarray(p["conv2"]["b"], np.float32).tobytes())
            w = np.asarray(p["conv2"]["w"], np.float32).transpose(3, 2, 0, 1)
            chunks.append(w.tobytes())
        elif isinstance(entry, (PlanUpsample, PlanMaxPool, PlanRoute)):
            pass  # parameterless
        else:
            # CSP stages have no darknet serialization -- refuse rather than
            # silently writing a partial file
            raise ValueError(
                f"cannot export plan entry {type(entry).__name__} to darknet format"
            )
    with open(path, "wb") as f:
        for c in chunks:
            f.write(c)
