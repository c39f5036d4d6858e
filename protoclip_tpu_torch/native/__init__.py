"""Native (C++) host-side image preprocess, bound with ctypes (counterpart
of ``protoclip_tpu/native``).

The card does the model math; the host's hot loop is the image
preprocess (JPEG decode -> bicubic resize -> center crop).  Three entry
points, as in the JAX package: the fused resize + center crop (what
``data.transforms.clip_preprocess`` calls), a plain bicubic resize, and a
box resize with a fused flip (RandomResizedCrop's resize, for callers that
hold arrays).  A fourth is the port's own: the fused resize + crop of a
batch of crops in one call, spread over the host's cores (what the
deployment classifier calls for a scene).
``preprocess.cpp`` (the JAX package's, plus the batch entry) computes the
resize and crop fused and pixel-exact with PIL (the arithmetic contract is
in its header).  This module compiles it at first use with ``g++ -O3 -shared``
into ``build/native/`` at the repository root, beside the CUDA kernels'
library, under a key of its own (source hash, flags and host CPU), so the
two packages never load each other's object.  There is no Python.h and no
pybind11.  If no toolchain is there or the build fails, callers fall back
to PIL.

Gate: ``$PROTOCLIP_NATIVE``: ``1`` forces it on (raise if unavailable),
``0`` forces it off, unset uses it where it builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parent / "preprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

# -ffp-contract=off: the pixel-exact contract with PIL depends on the
# coefficient doubles rounding identically; FMA contraction could perturb a
# weight sitting within 1 ulp of a quantization boundary.
_BASE_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off", "-pthread")


def _machine_tag() -> str:
    """Host identity folded into the build key: -march=native objects are
    not portable across CPUs."""
    ident = f"{platform.machine()}:{platform.processor()}"
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("model name", "Processor")):
                    ident += ":" + line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return ident


def _build() -> Optional[str]:
    """Compile preprocess.cpp into ``BUILD_DIR`` (keyed by source hash +
    flags + host CPU); returns the .so path, or None without a toolchain."""
    src = _SRC.read_bytes()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for flags in ((*_BASE_FLAGS, "-march=native"), _BASE_FLAGS):
        tag = hashlib.sha256(
            src + " ".join(flags).encode() + _machine_tag().encode()
        ).hexdigest()[:16]
        out = BUILD_DIR / f"preprocess_{tag}.so"
        if out.exists():
            return str(out)
        # mkstemp: the name is created, not just reserved, so two concurrent
        # builders never share a temp path and os.replace a torn object
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *flags, str(_SRC), "-o", tmp], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            try:  # leave no failed or timed-out object behind
                os.unlink(tmp)
            except OSError:
                pass
            continue  # e.g. toolchains without -march=native
        os.replace(tmp, out)  # atomic: concurrent builders race benignly
        return str(out)
    return None


def load() -> Optional[ctypes.CDLL]:
    """The bound library, or None (unavailable or turned off)."""
    global _lib, _tried
    if os.environ.get("PROTOCLIP_NATIVE", "") == "0":
        return None
    force_on = os.environ.get("PROTOCLIP_NATIVE") == "1"
    with _lock:
        if _tried:
            if _lib is None and force_on:
                # raise on every call: latching the failure would serve PIL
                # pixels despite the force-on gate
                raise RuntimeError(
                    "PROTOCLIP_NATIVE=1 but the native preprocess is "
                    "unavailable (g++ missing or compile/load failed)"
                )
            return _lib
        _tried = True
        lib = None
        for _attempt in range(2):
            path = _build()
            if path is None:
                break
            try:
                lib = ctypes.CDLL(path)
                break
            except OSError:
                # a stale or foreign object in the build directory: evict it
                # so the next _build() compiles afresh
                try:
                    os.unlink(path)
                except OSError:
                    pass
        if lib is None:
            if force_on:
                raise RuntimeError(
                    "PROTOCLIP_NATIVE=1 but the native preprocess could not "
                    "be built/loaded (g++ missing or compile failed)"
                )
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.resize_shorter_center_crop.restype = ctypes.c_int
        lib.resize_shorter_center_crop.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p,
                                                   ctypes.c_int, ctypes.c_int]
        vp = ctypes.c_void_p
        lib.resize_shorter_center_crop_batch.restype = ctypes.c_int
        lib.resize_shorter_center_crop_batch.argtypes = [vp, vp, vp, ctypes.c_int, vp,
                                                         ctypes.c_int, ctypes.c_int,
                                                         ctypes.c_int, vp]
        lib.resize_bicubic.restype = ctypes.c_int
        lib.resize_bicubic.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
                                       ctypes.c_int]
        lib.resize_box.restype = ctypes.c_int
        lib.resize_box.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_double, ctypes.c_double,
                                   ctypes.c_double, ctypes.c_double, ctypes.c_int]
        _lib = lib
        return _lib


def _as_u8_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def resize_shorter_center_crop(src: np.ndarray, size: int, crop: int) -> Optional[np.ndarray]:
    """Fused shorter-side bicubic resize + center crop, pixel-exact with the
    PIL path in ``data.transforms``.  ``src`` is (H, W, 3) uint8.  Returns
    None when the native path is unavailable or declines the geometry
    (e.g. an upscale whose resized image is smaller than the crop): callers
    fall back to PIL."""
    lib = load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        return None
    dst = np.empty((crop, crop, 3), np.uint8)
    rc = lib.resize_shorter_center_crop(
        _as_u8_ptr(src), src.shape[0], src.shape[1], _as_u8_ptr(dst), size, crop
    )
    return dst if rc == 0 else None


def resize_shorter_center_crop_batch(crops: Sequence[np.ndarray], size: int, crop: int,
                                     out: np.ndarray) -> Optional[np.ndarray]:
    """:func:`resize_shorter_center_crop` of every crop in one native call,
    written into ``out[i]``: ``crops`` are (H, W, 3) uint8 arrays (views
    are copied contiguous), ``out`` a C-contiguous (len(crops), crop, crop,
    3) uint8 block.  The crops are spread over one worker a core of this
    process's affinity, at most one a crop, the calling thread among them.
    Returns each crop's status, 0 where ``out[i]`` is byte for byte the
    single call's and non-zero where the native path declined the crop
    (its slot is then unspecified: serve it by PIL), or None when the
    native path is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(crops)
    if (out.dtype != np.uint8 or out.shape != (n, crop, crop, 3)
            or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writeable C-contiguous ({n}, {crop}, {crop}, 3) "
                         f"uint8 block, got {out.dtype} {out.shape}")
    srcs = [np.ascontiguousarray(c) for c in crops]  # alive across the call
    for c in srcs:
        if c.dtype != np.uint8 or c.ndim != 3 or c.shape[2] != 3:
            raise ValueError(f"crops must be (H, W, 3) uint8, got {c.dtype} {c.shape}")
    ptrs = (ctypes.c_void_p * n)(*(c.ctypes.data for c in srcs))
    in_h = np.array([c.shape[0] for c in srcs], np.intc)
    in_w = np.array([c.shape[1] for c in srcs], np.intc)
    status = np.full(n, -1, np.intc)
    workers = min(n, len(os.sched_getaffinity(0)))
    rc = lib.resize_shorter_center_crop_batch(ptrs, in_h.ctypes.data, in_w.ctypes.data, n,
                                              out.ctypes.data, size, crop, workers,
                                              status.ctypes.data)
    if rc != 0:
        raise ValueError(f"invalid batch geometry: size={size}, crop={crop}")
    return status


def resize_bicubic(src: np.ndarray, out_h: int, out_w: int) -> Optional[np.ndarray]:
    """Bicubic resize to (out_h, out_w), pixel-exact with PIL BICUBIC.
    Returns None when the native path is unavailable or declines the input."""
    lib = load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        return None
    dst = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.resize_bicubic(
        _as_u8_ptr(src), src.shape[0], src.shape[1], _as_u8_ptr(dst), out_h, out_w
    )
    return dst if rc == 0 else None


def resize_box(src: np.ndarray, out_h: int, out_w: int, box: tuple,
               flip: bool = False) -> Optional[np.ndarray]:
    """Bicubic resize of a source ``box`` (left, top, right, bottom) to
    (out_h, out_w) with an optional fused horizontal flip: pixel-exact with
    PIL ``img.resize((w, h), BICUBIC, box=box)`` (+ ``FLIP_LEFT_RIGHT``),
    the train-time RandomResizedCrop's resize.  Returns None when the native
    path is unavailable or the box is degenerate (callers fall back to
    PIL)."""
    lib = load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        return None
    left, top, right, bottom = (float(v) for v in box)
    dst = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.resize_box(
        _as_u8_ptr(src), src.shape[0], src.shape[1], _as_u8_ptr(dst),
        out_h, out_w, left, top, right, bottom, 1 if flip else 0,
    )
    return dst if rc == 0 else None
