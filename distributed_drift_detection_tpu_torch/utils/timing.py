"""Phase timer and profiler capture.

The port's twin of the JAX package's ``utils/timing.py``: ``PhaseTimer``
(without its telemetry span tracker) — ``phase(name)`` times a block,
``as_dict()`` returns the totals in first-use order — and
:func:`maybe_trace`, ``torch.profiler`` where the JAX package runs
``jax.profiler.trace``.
"""

from __future__ import annotations

import contextlib
import os
import socket
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


def _session_dir(trace_dir: str) -> str:
    """A new timestamped session directory under ``trace_dir``, laid out as
    ``jax.profiler.trace`` lays out its sessions
    (``plugins/profile/<YYYY_MM_DD_HH_MM_SS>``), with a suffix when one
    of that second already exists."""
    root = os.path.join(trace_dir, "plugins", "profile")
    stamp = time.strftime("%Y_%m_%d_%H_%M_%S")
    for n in range(10_000):
        path = os.path.join(root, stamp if n == 0 else f"{stamp}_{n}")
        try:
            os.makedirs(path)
            return path
        except FileExistsError:
            continue
    raise RuntimeError(f"no free profiler session directory under {root}")


@contextlib.contextmanager
def maybe_trace(trace_dir: "str | None", cuda: "bool | None" = None):
    """``torch.profiler`` over the block when a directory is given, else a
    no-op: CPU activity, plus CUDA activity on the card (``cuda``; default
    whether CUDA is available). On exit it writes one Chrome trace,
    ``<host>.pt.trace.json``, into a new timestamped session directory of
    ``trace_dir`` (:func:`_session_dir`); Perfetto opens it."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        session = _session_dir(trace_dir)
        prof.export_chrome_trace(
            os.path.join(session, f"{socket.gethostname()}.pt.trace.json")
        )


def trace_files(trace_dir: str) -> list:
    """The Chrome traces :func:`maybe_trace` wrote under ``trace_dir``,
    oldest session first."""
    root = os.path.join(trace_dir, "plugins", "profile")
    if not os.path.isdir(root):
        return []
    return [
        os.path.join(root, d, f)
        for d in sorted(os.listdir(root),
                        key=lambda d: (os.path.getmtime(os.path.join(root, d)), d))
        for f in sorted(os.listdir(os.path.join(root, d)))
        if f.endswith(".pt.trace.json")
    ]
