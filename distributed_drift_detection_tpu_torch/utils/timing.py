"""Phase timer: cumulative wall-clock seconds per named phase.

The port's twin of the JAX package's ``utils.timing.PhaseTimer`` without its
telemetry span tracker: ``phase(name)`` times a block, ``as_dict()`` returns
the totals in first-use order.
"""

from __future__ import annotations

import contextlib
import time


class PhaseTimer:
    def __init__(self):
        self._totals: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._totals[name] = (
                self._totals.get(name, 0.0) + time.perf_counter() - t0
            )

    def as_dict(self) -> dict[str, float]:
        return dict(self._totals)
