"""Native (C++) host-pipeline components, compiled on demand via g++/ctypes.

`batch_letterbox` is the serving/eval input packer: PIL decodes, C++ does
bilinear letterbox + /255 + NHWC batch assembly with a std::thread pool,
writing one contiguous float32 buffer jax.device_put ships to the device.
Falls back to the pure-numpy path (data/augment.py) when no C++ toolchain
is available -- the framework never hard-requires the native library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "packer.cpp"
_LIB = _HERE / "libpacker.so"  # "lib" prefix: not importable as a Python module
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread",
        str(_SRC), "-o", str(_LIB),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load_library() -> Optional[ctypes.CDLL]:
    """Compile (if stale) and load the packer; None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None:
            return _lib
        if _tried:
            return None
        _tried = True
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            return None
        lib.batch_letterbox_normalize.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_float,
            ctypes.c_int,
        ]
        lib.batch_letterbox_normalize.restype = None
        lib.batch_train_augment.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.batch_train_augment.restype = None
        lib.mosaic_cutout.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.mosaic_cutout.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None


_out_pool: dict = {}


def batch_letterbox(
    images: List[np.ndarray],
    size: int,
    pad_value: float = 0.0,
    num_threads: int = 0,
    out: Optional[np.ndarray] = None,
    reuse_buffer: bool = False,
) -> np.ndarray:
    """Letterbox + /255-normalize a list of HWC uint8 images into a
    float32 (N, size, size, 3) batch. Uses the C++ packer when available,
    the numpy path otherwise.

    reuse_buffer=True returns a pooled buffer keyed by (N, size) -- fresh
    100MB+ allocations pay first-touch page-fault cost every call (measured
    5-100x jitter under THP compaction); a steady-state loader should reuse.
    The buffer is overwritten by the next reuse_buffer call, so consume (or
    device_put) it before then."""
    n = len(images)
    if out is None:
        if reuse_buffer:
            out = _out_pool.get((n, size))
            if out is None:
                out = np.empty((n, size, size, 3), np.float32)
                _out_pool[(n, size)] = out
        else:
            out = np.empty((n, size, size, 3), np.float32)
    lib = load_library()
    if lib is None:
        from ..data.augment import letterbox

        for i, img in enumerate(images):
            lb, _ = letterbox(np.ascontiguousarray(img), None, size)
            out[i] = lb.astype(np.float32) / 255.0
        return out

    contig = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    ptrs = (ctypes.c_void_p * n)(
        *[im.ctypes.data_as(ctypes.c_void_p).value for im in contig]
    )
    shs = (ctypes.c_int * n)(*[im.shape[0] for im in contig])
    sws = (ctypes.c_int * n)(*[im.shape[1] for im in contig])
    if num_threads <= 0:
        num_threads = min(n, os.cpu_count() or 1)
    lib.batch_letterbox_normalize(
        ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
        shs,
        sws,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        size,
        ctypes.c_float(pad_value),
        num_threads,
    )
    return out


def mosaic_cutout(
    images: List[np.ndarray],
    geoms: List,
    size: int,
    y_pixel: int,
    x_pixel: int,
) -> Optional[np.ndarray]:
    """Compose the (size, size, 3) uint8 mosaic cutout directly from the 4
    source images, sampling only pixels inside the cutout window (the numpy
    path resizes all 4 images and builds the full (2*size)^2 canvas first --
    3/4 of that work never reaches the output).

    Args:
        images: 4 HWC uint8 source images.
        geoms: 4 (nh, nw) resized dims (computed by the caller with the same
            rounding as data/augment.py::resize_longest so box geometry --
            which stays in Python -- is identical for both paths).
        size: cutout side; the canvas is (2*size)^2.
        y_pixel, x_pixel: cutout top-left in canvas pixels.

    Returns None when the native library is unavailable (caller falls back
    to the numpy compose). The ctypes call releases the GIL.
    """
    lib = load_library()
    if lib is None:
        return None
    contig = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    n = len(contig)
    ptrs = (ctypes.c_void_p * n)(
        *[im.ctypes.data_as(ctypes.c_void_p).value for im in contig]
    )
    shs = (ctypes.c_int * n)(*[im.shape[0] for im in contig])
    sws = (ctypes.c_int * n)(*[im.shape[1] for im in contig])
    nhs = (ctypes.c_int * n)(*[g[0] for g in geoms])
    nws = (ctypes.c_int * n)(*[g[1] for g in geoms])
    out = np.empty((size, size, 3), np.uint8)
    lib.mosaic_cutout(
        ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
        shs,
        sws,
        nhs,
        nws,
        size,
        y_pixel,
        x_pixel,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


def train_augment(
    image: np.ndarray,
    size: int,
    *,
    do_affine: bool = False,
    scale: float = 1.0,
    dx: float = 0.0,
    dy: float = 0.0,
    flip: bool = False,
    do_hsv: bool = False,
    dh: float = 0.0,
    ds: float = 0.0,
    dv: float = 0.0,
) -> Optional[np.ndarray]:
    """Fused train augmentation for ONE HWC uint8 image: letterbox +
    shift-scale + hflip in a single resample pass, then HSV jitter + /255.

    Returns float32 (size, size, 3), or None when the native library is
    unavailable (caller falls back to the numpy pipeline). The ctypes call
    releases the GIL, so the DataLoader's worker threads scale this across
    cores. Box geometry is the CALLER's job (data/augment.py applies the
    identical parameters to the labels), keeping labels exactly consistent
    between the native and fallback paths.
    """
    lib = load_library()
    if lib is None:
        return None
    img = np.ascontiguousarray(image, dtype=np.uint8)
    out = np.empty((size, size, 3), np.float32)
    params = np.asarray(
        [
            1.0 if do_affine else 0.0, scale, dx, dy,
            1.0 if flip else 0.0,
            1.0 if do_hsv else 0.0, dh, ds, dv,
        ],
        np.float32,
    )
    ptrs = (ctypes.c_void_p * 1)(img.ctypes.data_as(ctypes.c_void_p).value)
    shs = (ctypes.c_int * 1)(img.shape[0])
    sws = (ctypes.c_int * 1)(img.shape[1])
    lib.batch_train_augment(
        ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
        shs,
        sws,
        1,
        params.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        size,
        1,
    )
    return out
