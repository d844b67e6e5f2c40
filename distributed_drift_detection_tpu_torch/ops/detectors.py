"""Detector registry: a drift statistic as the engines consume it.

The port's twin of the JAX package's ``ops/detectors.py`` ``DetectorKernel``
and ``make_detector``. Only DDM is ported; the rest of the zoo (Page–Hinkley,
EDDM, HDDM-A/W, ADWIN, KSWIN, STEPD) is ROADMAP A8.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from ..config import DDMParams
from .ddm import ddm_init, ddm_window


class DetectorKernel(NamedTuple):
    """A drift detector with its parameters bound.

    ``init(shape, device)`` gives a fresh state; ``window(state, errs
    [P, W, B], valid [P, W, B])`` the state after the window and ``[P, W]``
    first-warning/first-change indices, state flowing across batch
    boundaries (:func:`ops.ddm.ddm_window`'s contract).
    """

    name: str
    init: Callable[..., object]
    window: Callable[..., tuple]
    params: object


def make_detector(name: str, *, ddm: DDMParams = DDMParams()) -> DetectorKernel:
    """Build a :class:`DetectorKernel` by config name (``RunConfig.detector``)."""
    if name == "ddm":
        return DetectorKernel(
            "ddm", ddm_init, lambda s, e, v: ddm_window(s, e, v, ddm), ddm
        )
    raise NotImplementedError(
        f"detector {name!r} is not ported yet (ROADMAP A8: detector zoo); "
        "the port runs detector='ddm'"
    )
