"""Model interface of the port's window engine.

The JAX package's models are pure functions of one partition, vmapped over
partitions; the port's take the ``[P]`` partition axis written out. A
:class:`Model` is four functions:

* ``init(p, device) -> params`` — params with final shapes, leading ``[P]``;
* ``fit(X [P, B, F], y [P, B], w [P, B]) -> params`` — a fresh fit on one
  microbatch per partition; ``w`` is the {0, 1} row-validity weight;
* ``predict(params, X [P, N, F]) -> preds [P, N] i32``;
* ``predict_err(params, T [R, F], Ty [R], idx [P, N]) -> err [P, N] f32`` —
  the error indicator ``predict(T[idx]) != Ty[idx]`` the engine feeds the
  detector, with the rows gathered from the table ``T`` through ``idx``.

The ported families (majority, centroid) consume no PRNG key.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple


class Model(NamedTuple):
    name: str
    init: Callable[..., Any]
    fit: Callable[..., Any]
    predict: Callable[..., Any]
    predict_err: Callable[..., Any]


class ModelSpec(NamedTuple):
    """Static problem geometry every model is built against."""

    num_features: int
    num_classes: int
