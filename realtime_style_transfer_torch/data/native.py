"""ctypes bindings for the repo's native data-plane library.

Port of ``realtime_style_transfer_tpu/data/native.py``.  The same C++ sources
(``native/exr_decoder.cpp``, ``native/batch_loader.cpp``,
``native/tensorbuffer.cpp``: an EXR scanline decoder, a threaded G-buffer set
loader and the engine's raw float32 tensor-buffer reader and writer) are
compiled with ``g++`` into the port's own library,
``build/rst_torch_native/librst_native_<digest>.so``, named after a digest of
the sources and flags as the CUDA kernels are (``ops/kernels.py``).  The
library that the JAX package builds in ``native/`` is never written or read.

The build runs at first use under a file lock in the build directory, so
processes that start together (test workers) build it once; a failed build
raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

REPO = Path(__file__).resolve().parents[2]
NATIVE_SOURCES = tuple(REPO / "native" / name for name in
                       ("exr_decoder.cpp", "tensorbuffer.cpp", "batch_loader.cpp"))
BUILD_DIR = REPO / "build" / "rst_torch_native"
CXX_FLAGS = ("-O2", "-Wall", "-fPIC", "-std=c++17", "-shared")
LINK_FLAGS = ("-lz", "-lpthread")

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class ExrError(Exception):
    """Native EXR decode failure (bad magic, unsupported feature, IO, ...)."""


def lib_path() -> Path:
    """Where this tree's sources build: named after their digest and flags."""
    text = b"".join(p.read_bytes() for p in NATIVE_SOURCES)
    text += " ".join(CXX_FLAGS + LINK_FLAGS).encode()
    return BUILD_DIR / f"librst_native_{hashlib.sha1(text).hexdigest()[:12]}.so"


def _build(lib: Path) -> None:
    """Compile the sources into ``lib`` unless another process has, holding
    the build directory's lock meanwhile."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():
                return
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError("g++ not found: the native data library needs a C++ "
                                   "compiler")
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            log.info("building %s", lib)
            run = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                                  *map(str, NATIVE_SOURCES), *LINK_FLAGS],
                                 capture_output=True, text=True)
            if run.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building {lib.name} failed:\n{run.stderr}")
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the native library, with typed signatures."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        c_int_p = ctypes.POINTER(ctypes.c_int)
        c_float_p = ctypes.POINTER(ctypes.c_float)

        lib.exr_last_error.restype = ctypes.c_char_p
        lib.exr_read_info.argtypes = [ctypes.c_char_p, c_int_p, c_int_p, c_int_p,
                                      ctypes.c_char_p, ctypes.c_int]
        lib.exr_read_info.restype = ctypes.c_int
        lib.exr_read.argtypes = [ctypes.c_char_p, c_float_p]
        lib.exr_read.restype = ctypes.c_int

        lib.gbuffer_batch_last_error.restype = ctypes.c_char_p
        lib.gbuffer_batch_read.argtypes = [ctypes.POINTER(ctypes.c_char_p), c_int_p,
                                           ctypes.c_int, c_float_p, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int]
        lib.gbuffer_batch_read.restype = ctypes.c_int

        lib.tensorbuffer_last_error.restype = ctypes.c_char_p
        lib.tensorbuffer_num_elements.argtypes = [ctypes.c_char_p]
        lib.tensorbuffer_num_elements.restype = ctypes.c_long
        lib.tensorbuffer_read.argtypes = [ctypes.c_char_p, c_float_p, ctypes.c_long]
        lib.tensorbuffer_read.restype = ctypes.c_int
        lib.tensorbuffer_write.argtypes = [ctypes.c_char_p, c_float_p, ctypes.c_long]
        lib.tensorbuffer_write.restype = ctypes.c_int

        _lib = lib
        return _lib


def _floats(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# ---------------------------------------------------------------------------
# EXR
# ---------------------------------------------------------------------------


def exr_info(path) -> Tuple[int, int, List[str]]:
    """(width, height, channel names in file order) of an EXR."""
    lib = get_lib()
    w, h, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    names = ctypes.create_string_buffer(8192)
    rc = lib.exr_read_info(str(path).encode(), ctypes.byref(w), ctypes.byref(h),
                           ctypes.byref(n), names, len(names))
    if rc != 0:
        raise ExrError(f"{path}: {lib.exr_last_error().decode()}")
    name_list = names.value.decode().split("\n") if n.value else []
    return w.value, h.value, name_list


def read_exr(path) -> Dict[str, np.ndarray]:
    """Decode an EXR to ``{channel_name: (h, w) float32}``."""
    lib = get_lib()
    width, height, names = exr_info(path)
    out = np.empty((len(names), height, width), np.float32)
    if lib.exr_read(str(path).encode(), _floats(out)) != 0:
        raise ExrError(f"{path}: {lib.exr_last_error().decode()}")
    return {name: out[i] for i, name in enumerate(names)}


def read_gbuffer_planes(paths: Sequence, plane_counts: Sequence[int], height: int,
                        width: int, num_threads: int = 4) -> np.ndarray:
    """Decode a screenshot's EXR set in parallel into (total_planes, h, w).

    ``plane_counts[i]`` planes are taken from ``paths[i]`` (R, G, B when >= 3,
    else R), decoded by the library's worker threads."""
    lib = get_lib()
    if len(paths) != len(plane_counts):
        raise ValueError("paths and plane_counts must have equal length")
    out = np.empty((int(sum(plane_counts)), height, width), np.float32)
    encoded = [str(p).encode() for p in paths]
    path_array = (ctypes.c_char_p * len(encoded))(*encoded)
    count_array = (ctypes.c_int * len(plane_counts))(*map(int, plane_counts))
    rc = lib.gbuffer_batch_read(path_array, count_array, len(encoded), _floats(out),
                                int(height), int(width), int(num_threads))
    if rc != 0:
        raise ExrError(lib.gbuffer_batch_last_error().decode())
    return out


# ---------------------------------------------------------------------------
# Engine tensor buffers (raw little-endian float32 stream)
# ---------------------------------------------------------------------------


def read_tensor_buffer(path, shape: Sequence[int]) -> np.ndarray:
    """Read a raw f32 engine buffer, validating the element count."""
    lib = get_lib()
    expected = int(np.prod(shape)) if len(shape) else 1
    n = lib.tensorbuffer_num_elements(str(path).encode())
    if n < 0:
        raise ValueError(f"{path}: {lib.tensorbuffer_last_error().decode()}")
    if n != expected:
        raise ValueError(f"{path}: shape {tuple(shape)} wants {expected} float32 elements, "
                         f"file has {n}")
    out = np.empty(tuple(shape), np.float32)
    if lib.tensorbuffer_read(str(path).encode(), _floats(out), expected) != 0:
        raise ValueError(f"{path}: {lib.tensorbuffer_last_error().decode()}")
    return out


def write_tensor_buffer(path, data: np.ndarray) -> Path:
    """Write float32 data as the engine's raw little-endian stream."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lib = get_lib()
    arr = np.ascontiguousarray(data, np.float32)
    if lib.tensorbuffer_write(str(path).encode(), _floats(arr), arr.size) != 0:
        raise ValueError(f"{path}: {lib.tensorbuffer_last_error().decode()}")
    return path
