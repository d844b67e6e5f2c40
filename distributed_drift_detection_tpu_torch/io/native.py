"""ctypes binding to the native C++ CSV parser (``native/ddd_native.cc``).

The port's own copy of the JAX package's ``io/native.py``: the same
library, the same entry points and the same NumPy fallback. Only the build
differs. The port never runs ``make`` in ``native/`` and never writes
there: it compiles ``native/ddd_native.cc`` with the host C++ compiler and
``native/Makefile``'s flags into its own gitignored build directory,
``kernels/_build/libddd_native-<digest>.so`` (or the directory
``RunConfig.compile_cache_dir`` names, ``kernels._build.set_build_dir``),
keyed on a hash of the source and the flags, under a file lock (a concurrent first load waits for the
build and never opens a half-written library). A missing compiler or
source leaves the NumPy path, as a failed build does in the JAX package;
a build is tried at most once a process.

The parser is strict: a malformed field makes it refuse the whole file (or
block), and the caller's NumPy parse then raises with a useful message.
Both parse each field to the correctly rounded double and round that to
float32, so they give the same bits (``tests/test_torch_csv.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..kernels import _build

SOURCE = Path(__file__).resolve().parents[2] / "native" / "ddd_native.cc"
# native/Makefile's CXXFLAGS, and the shared-library flag of its rule
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_tried = False


def _compiler() -> str | None:
    for cand in (os.environ.get("CXX", ""), "g++", "c++", "clang++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    return None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return _build.build_dir() / f"libddd_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the parser unless its library for this source exists;
    returns the library path. Raises ``RuntimeError`` without a compiler
    or when the compiler fails, ``OSError`` without the source."""
    out = library_path()
    if out.exists():
        return out
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (CXX, g++, c++ or clang++) for the native parser")
    out.parent.mkdir(parents=True, exist_ok=True)
    import fcntl

    with open(out.parent / ".native.lock", "w") as lock_fh:
        fcntl.flock(lock_fh, fcntl.LOCK_EX)
        try:
            if out.exists():  # another process built it while this one waited
                return out
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=300, check=False)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building the native parser failed (exit "
                                   f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock_fh, fcntl.LOCK_UN)
    return out


def _load_library() -> ctypes.CDLL | None:
    global _lib, _lib_tried
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError, subprocess.SubprocessError):
            return None  # no toolchain, no source: the NumPy path
        lib.ddd_csv_open.argtypes = [ctypes.c_char_p]
        lib.ddd_csv_open.restype = ctypes.c_void_p
        for fn in (lib.ddd_csv_rows, lib.ddd_csv_cols):
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int64
        lib.ddd_csv_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.ddd_csv_read.restype = ctypes.c_int64
        lib.ddd_csv_close.argtypes = [ctypes.c_void_p]
        lib.ddd_csv_close.restype = None
        lib.ddd_parse_block.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        lib.ddd_parse_block.restype = ctypes.c_int64
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_library() is not None


def load_csv_native(path: str) -> np.ndarray | None:
    """Parse a numeric CSV (header + rows) to ``[rows, cols]`` f32, or None
    if the native library is unavailable or any field is malformed (the
    caller then falls back to the NumPy path, which raises with a message)."""
    lib = _load_library()
    if lib is None:
        return None
    handle = lib.ddd_csv_open(path.encode())
    if not handle:
        return None
    try:
        rows = lib.ddd_csv_rows(handle)
        cols = lib.ddd_csv_cols(handle)
        out = np.empty((rows, cols), np.float32)
        status = lib.ddd_csv_read(
            handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        )
        if status != 0:
            return None
        return out
    finally:
        lib.ddd_csv_close(handle)


def parse_block(block: bytes, cols: int) -> np.ndarray:
    """Parse a block of complete CSV data rows (no header) to ``[n, cols]``
    f32. Native multithreaded parser when available, NumPy fallback
    otherwise; raises ``ValueError`` on malformed data either way."""
    if not block:
        return np.empty((0, cols), np.float32)
    lib = _load_library()
    if lib is not None:
        max_rows = block.count(b"\n") + (0 if block.endswith(b"\n") else 1)
        out = np.empty((max_rows, cols), np.float32)
        n = lib.ddd_parse_block(
            block,
            len(block),
            cols,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_rows,
        )
        if n >= 0:
            return out[:n]
        # fall through: NumPy raises with a useful message
    import io as _io

    arr = np.loadtxt(_io.BytesIO(block), delimiter=",", dtype=np.float32, ndmin=2)
    if arr.shape[1] != cols:
        raise ValueError(f"expected {cols} columns, got {arr.shape[1]}")
    return arr
