"""ctypes bindings of the port's hand-written CUDA kernels.

Each library is built by ``kernels._build`` on first use and loaded once.
A launch function takes raw device pointers (``tensor.data_ptr()``) and
PyTorch's current stream, launches, and returns ``cudaGetLastError()``;
:func:`check` turns a nonzero code into an exception. The checked,
counted wrappers that callers use live beside their plain PyTorch versions
(``ops/ddm.py`` ``ddm_window``, ``models/classifiers.py``
``centroid_predict_err``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_SIGNATURES = {
    "ddm_window": (
        "ddm_window_launch",
        [_P, _P, _P, _P, _P, _P, _P,  # errs, live, 5 state leaves
         _I, _I, _I, _I, _I,  # p, n, w, b, min_num_instances
         _F, _F, _F, _I,  # warning, out-control, band floor, use floor
         _P, _P, _P, _P, _P, _P, _P,  # first warning/change, 5 end leaves
         _P],  # stream
    ),
    "centroid_predict_err": (
        "centroid_predict_err_launch",
        [_P, _P, _P, _I, _P, _P,  # table, labels, idx, idx bytes, cent, bias
         _I, _I, _I, _I,  # p, n, c, f
         _P, _P, _P],  # err, pred, stream
    ),
}


@functools.cache
def launcher(name: str):
    """The C launch function of kernel ``name`` (built and loaded once)."""
    from ._build import build

    lib = ctypes.CDLL(str(build(name)))
    symbol, argtypes = _SIGNATURES[name]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaGetLastError() = {code}"
        )
