"""The stall contract's one quantity, :func:`staleness_s` — the part of the
JAX package's ``telemetry/watch.py`` the sweep scheduler reads (its
per-worker ``age_s``). The ``watch`` CLI itself waits for ROADMAP A15."""

from __future__ import annotations

import os


def staleness_s(
    last_ts: "float | None", path: "str | None" = None, *, now: float
) -> float:
    """Seconds since the last sign of life — THE stall-contract quantity.

    The watch loop reads it off event timestamps (falling back to the log
    file's mtime while the log is still empty) and the ``sched/`` scheduler
    off per-worker heartbeat stamps: a worker whose staleness exceeds its
    lease TTL is dead or wedged either way. Clamped at 0 — a clock skewed
    slightly ahead must not read as negative staleness."""
    if last_ts is not None:
        return max(now - last_ts, 0.0)
    if path is not None:
        try:
            return max(now - os.path.getmtime(path), 0.0)
        except OSError:
            pass
    return 0.0
