"""Nested wall-clock spans: the successor of ``utils.timing.PhaseTimer``.

The port's own copy of the JAX package's ``telemetry/spans.py``.

``PhaseTimer`` recorded six flat cumulative phase buckets. A span tracker
keeps that contract (:meth:`SpanTracker.as_dict` is the same ``{name:
total seconds}`` dict) and adds what the flat buckets could not express:

* **nesting** — ``span("detect")`` inside ``span("leg")`` records under
  the path ``"leg/detect"``; sibling re-entry accumulates.
* **call counts** — every path carries how many times it ran.
* **first-call split** — per path, the first call's duration is kept
  separate from the steady-state remainder: on the card the first call
  of a path absorbs its kernels' build and load, so ``first_s`` vs
  ``rest of the calls`` is the build-vs-steady-state split.

No torch imports.
"""

from __future__ import annotations

import contextlib
import time


class SpanTracker:
    SEP = "/"

    def __init__(self):
        # path -> [count, total_s, first_s, min_s, max_s]
        self._stats: dict[str, list] = {}
        self._stack: list[str] = []

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a (possibly nested) span; exceptions still record."""
        path = self.SEP.join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            s = self._stats.get(path)
            if s is None:
                self._stats[path] = [1, dt, dt, dt, dt]
            else:
                s[0] += 1
                s[1] += dt
                s[3] = min(s[3], dt)
                s[4] = max(s[4], dt)

    def as_dict(self) -> dict[str, float]:
        """Flat ``{path: total seconds}`` — the PhaseTimer contract."""
        return {path: s[1] for path, s in self._stats.items()}

    def stats(self) -> dict[str, dict]:
        """Full per-path record, including the first-call split."""
        out = {}
        for path, (count, total, first, mn, mx) in self._stats.items():
            out[path] = {
                "count": count,
                "total_s": total,
                "first_s": first,
                "min_s": mn,
                "max_s": mx,
                # Steady state = everything after the first call (the
                # kernels' build and one-time setup live in the first call).
                "steady_total_s": total - first,
                "steady_mean_s": (
                    (total - first) / (count - 1) if count > 1 else None
                ),
            }
        return out

    def compile_split(self, path: str) -> dict | None:
        """The first-call-vs-steady-state view of one span path, or ``None``
        if the path never ran."""
        full = self.stats().get(path)
        if full is None:
            return None
        return {
            "first_call_s": full["first_s"],
            "steady_mean_s": full["steady_mean_s"],
            "calls": full["count"],
        }
