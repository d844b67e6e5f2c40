"""Model interface of the port's window engine.

The JAX package's models are pure functions of one partition, vmapped over
partitions; the port's take the ``[P]`` partition axis written out. A
:class:`Model` is four functions:

* ``init(p, device, key=None) -> params`` — params with final shapes,
  leading ``[P]``;
* ``fit(X [P, B, F], y [P, B], w [P, B], key=None) -> params`` — a fresh
  fit on one microbatch per partition; ``w`` is the {0, 1} row-validity
  weight;
* ``predict(params, X [P, N, F]) -> preds [P, N] i32``;
* ``predict_err(params, T, Ty [R], idx [P, N]) -> err [P, N] f32`` —
  the error indicator ``predict(T[idx]) != Ty[idx]`` the engine feeds the
  detector, with the rows gathered from the table ``T`` through ``idx``.
  The engine passes ``T`` as :func:`pad_row_table` leaves it, ``[R,
  row_stride(F)]``; columns past F are padding.

``key`` is the partitions' threefry keys ``[P, 2]`` (``utils/threefry.py``;
uint32 words, as int32 bit patterns on the device). A family whose init and
fit consume it (``mlp``) sets ``keyed``, and the engines then draw the JAX
package's key chain for it; the others (majority, centroid, gnb, linear)
ignore ``key`` and get none.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Model(NamedTuple):
    name: str
    init: Callable[..., Any]
    fit: Callable[..., Any]
    predict: Callable[..., Any]
    predict_err: Callable[..., Any]
    keyed: bool = False  # init and fit consume the partitions' keys


class ModelSpec(NamedTuple):
    """Static problem geometry every model is built against."""

    num_features: int
    num_classes: int


def row_stride(f: int) -> int:
    """Row stride of kernel K2's row table: ``f`` rounded up to a multiple
    of 4, so every row starts on a 16-byte boundary."""
    return (int(f) + 3) & ~3


def pad_row_table(T: torch.Tensor) -> torch.Tensor:
    """The row table ``T [R, F]`` as kernel K2 gathers it: ``[R,
    row_stride(F)]``, zero past column F — ``T`` itself when it already is
    (F a multiple of 4, contiguous). The window engine builds it once per
    run."""
    r, f = T.shape
    fp = row_stride(f)
    if fp == f and T.is_contiguous():
        return T
    out = torch.zeros((r, fp), dtype=T.dtype, device=T.device)
    out[:, :f] = T
    return out
