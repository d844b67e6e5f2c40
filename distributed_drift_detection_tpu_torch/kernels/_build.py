"""nvcc build of the port's CUDA sources into shared libraries.

Each kernel's ``csrc/<name>.cu`` (``SOURCES`` names the exceptions)
compiles on its own into ``kernels/_build/lib<name>-<digest>.so`` (a
directory ``.gitignore`` lists) at its first use, keyed on a hash of the
source, the ``csrc/*.cuh`` headers and the flags, so a fresh checkout
builds on the first call and later calls reuse the library.
``RunConfig.compile_cache_dir`` names another directory for the libraries
(:func:`set_build_dir`, which ``api.prepare`` calls): the counterpart of
XLA's persistent compilation cache, so a second process given the same
directory loads what the first built and runs no nvcc. The
library has a plain C interface and is loaded with ``ctypes``
(``kernels/__init__.py``); no PyTorch header is compiled, which keeps a
build to seconds. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"  # the default
_build_dir = BUILD_DIR

COMMON_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# Per-kernel extra flags. K1 and the zoo kernels are held bit-identical to
# their plain versions, so nvcc must not contract a*b+c into FMAs on its
# own; K7, K5-ph, K5-hddm_w and K5-eddm (its variance's fused
# multiply-add) also flush subnormals, as XLA on the CPU does. K8, K9 and
# K11 draw threefry normals bit-identical to JAX's (csrc/threefry.cuh),
# under the same two flags, as do K6's generators;
# K11 and K12 compute the forest's projections with explicit unfused,
# unflushed PTX (csrc/forest.cuh). K13 does integer work only.
KERNELS = {
    "ddm_window": ("-fmad=false",),
    "centroid_predict_err": (),
    "centroid_fit": ("-fmad=false", "-ftz=true"),
    "ph_window": ("-fmad=false", "-ftz=true"),
    "hddm_w_window": ("-fmad=false", "-ftz=true"),
    "eddm_window": ("-fmad=false", "-ftz=true"),
    "hddm_window": ("-fmad=false",),
    "kswin_window": ("-fmad=false",),
    "stepd_window": ("-fmad=false",),
    "adwin_window": ("-fmad=false",),
    "random_normal": ("-fmad=false", "-ftz=true"),
    "mlp_fit": ("-fmad=false", "-ftz=true"),
    "mlp_predict_err": (),
    "forest_fit": ("-fmad=false", "-ftz=true"),
    "forest_predict_err": ("-fmad=false",),
    "soak_batch": ("-fmad=false", "-ftz=true"),
    "shuffle_perm": (),
}


# A kernel whose source is not named after it.
SOURCES = {"soak_batch": "soak_gen.cu"}


def source(name: str) -> Path:
    """The ``csrc/`` source of kernel ``name``."""
    return CSRC / SOURCES.get(name, f"{name}.cu")


def set_build_dir(path: str = "") -> Path:
    """Build and load the libraries in ``path`` from now on (created at the
    first build); empty restores the default, ``kernels/_build/``. Returns
    the directory. A library already loaded in this process stays loaded:
    its name carries the hash of its source, so it is the same build."""
    global _build_dir
    _build_dir = Path(path).expanduser().resolve() if path else BUILD_DIR
    return _build_dir


def build_dir() -> Path:
    """The directory libraries are built into and loaded from."""
    return _build_dir


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``
    or the one on ``PATH``."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the port's CUDA kernels need the CUDA toolkit to build"
    )


def _command(name: str, out: Path) -> list[str]:
    return [nvcc(), *COMMON_FLAGS, *KERNELS[name], "-o", str(out),
            str(source(name))]


def library_path(name: str) -> Path:
    """Where ``name``'s library lives for the current source and flags."""
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; known: {sorted(KERNELS)}")
    h = hashlib.sha256(source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join((*COMMON_FLAGS, *KERNELS[name])).encode())
    return _build_dir / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Build ``name`` unless its library for this source already exists;
    returns the library path. Raises ``RuntimeError`` if nvcc fails."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        _command(name, tmp), capture_output=True, text=True, check=False
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed building {name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def build_all(names=None) -> dict[str, float]:
    """Build the kernels ``names`` (every kernel by default), one nvcc
    process each, all started together; returns the wall seconds each
    build took (0 for a cached library)."""
    names = list(KERNELS if names is None else names)

    def timed(name):
        t0 = time.perf_counter()
        build(name)
        return name, time.perf_counter() - t0

    if not names:
        return {}
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return dict(pool.map(timed, names))
