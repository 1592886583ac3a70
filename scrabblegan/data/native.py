"""ctypes bindings to the native batch assembler (native/batcher.cpp), with an
automatic build-on-first-use and a transparent numpy fallback.

The native path does the gather + uint8 -> [-1, 1] float conversion of the batch
assembly (the reference's Python-side per-step hot path, data_utils.py:62-84) in
C++ worker threads.

The library is built on the machine that loads it, into
native/build/<host>-<source hash>/, so a copy of the tree never loads a binary
built on another host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")


def _lib_path() -> str:
    with open(os.path.join(_NATIVE_DIR, "batcher.cpp"), "rb") as f:
        source = hashlib.sha256(f.read()).hexdigest()[:12]
    host = f"{platform.node()}-{platform.machine()}"
    return os.path.join(_NATIVE_DIR, "build", f"{host}-{source}", "libbatcher.so")


_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _try_build(lib_path: str) -> bool:
    if not os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
        return False
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, f"OUT={lib_path}"], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    return os.path.exists(lib_path)


def load_library(build: bool = True) -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None:
        return _lib
    if _load_attempted:
        return _lib
    _load_attempted = True
    try:
        lib_path = _lib_path()
    except OSError:
        return None
    if not os.path.exists(lib_path) and not (build and _try_build(lib_path)):
        return None
    try:
        lib = ctypes.CDLL(lib_path)
        lib.sg_abi_version.restype = ctypes.c_int
        if lib.sg_abi_version() != 1:
            return None
        lib.sg_assemble_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        lib.sg_gather_labels.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return load_library() is not None


def assemble_batch(imgs_u8: np.ndarray, indices: np.ndarray,
                   num_threads: int = 4) -> np.ndarray:
    """imgs_u8: (N, ...) uint8 C-contiguous; indices: (B,) -> (B, ...) float32
    normalized to [-1, 1]."""
    lib = load_library()
    indices = np.ascontiguousarray(indices, np.int64)
    batch = len(indices)
    sample_shape = imgs_u8.shape[1:]
    sample_elems = int(np.prod(sample_shape))
    if lib is None:
        return (imgs_u8[indices].astype(np.float32) - 127.5) / 127.5
    imgs_u8 = np.ascontiguousarray(imgs_u8)
    out = np.empty((batch,) + sample_shape, np.float32)
    lib.sg_assemble_batch(
        imgs_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        batch, sample_elems,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_threads,
    )
    return out


def gather_labels(labels_i32: np.ndarray, indices: np.ndarray) -> np.ndarray:
    lib = load_library()
    indices = np.ascontiguousarray(indices, np.int64)
    if lib is None:
        return labels_i32[indices].copy()
    labels_i32 = np.ascontiguousarray(labels_i32, np.int32)
    out = np.empty((len(indices), labels_i32.shape[1]), np.int32)
    lib.sg_gather_labels(
        labels_i32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(indices), labels_i32.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
