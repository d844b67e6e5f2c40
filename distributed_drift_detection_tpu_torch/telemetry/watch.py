"""Live run watcher: tail a run log (or a telemetry directory's newest
run), render progress/ETA, and fail loudly on a stall.

    python -m distributed_drift_detection_tpu_torch watch <run.jsonl | dir> \\
        [--stall-after S] [--interval S] [--once]

The run log is flushed per event precisely so a long chunked/soak run is
observable *while running*; this is the consumer. It tails the file
incrementally (re-reading only new bytes, tolerant of a torn final line —
the writer may be mid-append), folds progress events (``heartbeat`` rows
done + monotonic elapsed, ``chunk_completed``/``leg_completed``) into a
status line with throughput and — when ``run_started.config`` carries
``total_rows`` — an ETA, and exits by a **scriptable health contract**:

* ``0`` — healthy: the run completed (``run_completed`` seen), or, with
  ``--once``, is making progress within ``--stall-after``.
* ``3`` — stalled: no new event for more than ``--stall-after`` seconds
  and no ``run_completed``. CI gates and pod launchers branch on this.
* ``4`` — nothing to watch: no run log at/under the given path.
* ``2`` — usage errors (argparse).

Staleness compares the log's own event timestamps against this process's
clock, so run the watcher on the writing host or an NTP-synced peer; an
empty-so-far log falls back to its file mtime. Without ``--stall-after``
the watcher never exits nonzero on silence — it just keeps reporting.

Pure stdlib + the schema module; no jax — runs on the pod host, in CI,
or anywhere the artifact is mirrored.
"""

# The port's own copy of the JAX package's ``telemetry/watch.py``; its CLI's
# ``--help`` prints the docstring above, so that is the JAX module's, but
# for the program name.

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .events import SchemaError, validate_event
from .registry import newest_run_log

EXIT_OK = 0
EXIT_STALLED = 3
EXIT_NO_LOG = 4


class LogTail:
    """Incremental JSONL reader: each :meth:`poll` yields the complete,
    schema-valid events appended since the last poll.

    The offset only ever advances past the final newline consumed, so a
    torn trailing line (writer mid-append, crash mid-write) is simply not
    consumed yet — it is re-read on the next poll once its newline lands.
    A *complete* malformed line is a producer bug and raises
    :class:`SchemaError` (the emit path validates, so this never happens
    to a log this package wrote).
    """

    def __init__(self, path: str):
        self.path = path
        self._offset = 0

    def poll(self) -> list[dict]:
        with open(self.path, "rb") as fh:
            fh.seek(self._offset)
            blob = fh.read()
        end = blob.rfind(b"\n")
        if end < 0:
            return []
        chunk, self._offset = blob[: end + 1], self._offset + end + 1
        events = []
        for line in chunk.decode("utf-8", errors="replace").splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                events.append(validate_event(json.loads(line)))
            except json.JSONDecodeError as e:
                raise SchemaError(
                    f"{self.path}: complete line is not JSON ({e})"
                ) from None
        return events


class WatchState:
    """Folded view of the events seen so far (the watcher's data model)."""

    def __init__(self) -> None:
        self.run_id: str | None = None
        self.config: dict = {}
        self.total_rows: int | None = None
        self.rows_done: int | None = None
        self.elapsed_s: float | None = None
        # First heartbeat seen: rates come from heartbeat DELTAS, so a
        # checkpoint-resumed soak (stream-absolute rows_done, this-process
        # elapsed) cannot inflate the reported throughput.
        self._first_hb: tuple[int, float] | None = None
        self.detections = 0
        self.chunks = 0
        self.legs = 0
        # Currently firing SLO alerts (serving daemons emit `alert`
        # transitions; firing adds, resolved removes) — rendered in the
        # status line so a watched daemon's degradation is visible
        # without scraping /healthz.
        self.alerts: dict[str, dict] = {}
        self.n_events = 0
        self.last_ts: float | None = None
        self.last_type: str | None = None
        self.completed: dict | None = None

    def fold(self, events: list[dict]) -> None:
        for e in events:
            self.n_events += 1
            self.last_ts, self.last_type = float(e["ts"]), e["type"]
            t = e["type"]
            if t == "run_started":
                self.run_id = e["run_id"]
                self.config = e.get("config") or {}
                total = self.config.get("total_rows")
                if isinstance(total, (int, float)) and total > 0:
                    self.total_rows = int(total)
            elif t == "heartbeat":
                self.rows_done = int(e["rows_done"])
                self.elapsed_s = float(e["elapsed_s"])
                if self._first_hb is None:
                    self._first_hb = (self.rows_done, self.elapsed_s)
            elif t == "drift_detected":
                self.detections += 1
            elif t == "chunk_completed":
                self.chunks += 1
                self.detections += int(e["detections"] or 0)
            elif t == "leg_completed":
                self.legs += 1
                self.detections += int(e["detections"] or 0)
            elif t == "alert":
                if e["state"] == "firing":
                    self.alerts[e["rule"]] = e
                else:
                    self.alerts.pop(e["rule"], None)
            elif t == "run_completed":
                self.completed = e

    def rate(self) -> float | None:
        """Rows/s from heartbeat deltas (single-heartbeat logs fall back
        to that beat's own ratio); ``None`` until a positive rate exists."""
        if self.rows_done is None or not self.elapsed_s:
            return None
        r0, e0 = self._first_hb or (0, 0.0)
        if self.elapsed_s > e0 and self.rows_done > r0:
            return (self.rows_done - r0) / (self.elapsed_s - e0)
        if self.elapsed_s > 0 and self.rows_done > 0:
            return self.rows_done / self.elapsed_s
        return None

    def status_line(self, now: float) -> str:
        bits = [self.run_id or "<no run_started yet>"]
        if self.completed is not None:
            done = self.completed
            rate = done["rows"] / done["seconds"] if done["seconds"] else 0.0
            bits.append(
                f"completed: {done['rows']:,} rows / {done['seconds']:.3f}s "
                f"({rate:,.0f} rows/s), {done['detections']} detections"
            )
            return "  ".join(bits)
        if self.rows_done is not None:
            prog = f"rows {self.rows_done:,}"
            if self.total_rows:
                pct = 100.0 * self.rows_done / self.total_rows
                prog += f"/{self.total_rows:,} ({pct:.1f}%)"
            bits.append(prog)
            rate = self.rate()
            if rate:
                bits.append(f"{rate:,.0f} rows/s")
                if self.total_rows:
                    remaining = max(self.total_rows - self.rows_done, 0)
                    bits.append(f"eta {remaining / rate:,.0f}s")
        if self.chunks:
            bits.append(f"{self.chunks} chunks")
        if self.legs:
            bits.append(f"{self.legs} legs")
        if self.detections:
            bits.append(f"{self.detections} detections")
        if self.alerts:
            bits.append("ALERTS " + ",".join(sorted(self.alerts)))
        if self.last_ts is not None:
            bits.append(f"last {self.last_type} {now - self.last_ts:.1f}s ago")
        return "  ".join(bits)


def resolve_log(path: str) -> str | None:
    """A file is itself; a directory resolves to its newest run log (the
    registry-first resolution shared with ``report --dir``)."""
    if os.path.isdir(path):
        return newest_run_log(path)
    return path if os.path.exists(path) else None


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


def _age(state: WatchState, log_path: str, now: float) -> float:
    return staleness_s(state.last_ts, log_path, now=now)


def watch(
    path: str,
    *,
    stall_after: float | None = None,
    interval: float = 2.0,
    once: bool = False,
    clock=time.time,
    sleep=time.sleep,
    out=print,
) -> int:
    """Drive the watch loop; returns the exit code (see module contract).
    ``clock``/``sleep``/``out`` are injectable for tests."""
    log_path = resolve_log(path)
    if log_path is None:
        out(f"watch: no run log at {path}")
        return EXIT_NO_LOG
    tail = LogTail(log_path)
    state = WatchState()
    out(f"watching {log_path}")
    while True:
        events = tail.poll()
        state.fold(events)
        now = clock()
        if events or once:
            out(state.status_line(now))
        if state.completed is not None:
            return EXIT_OK
        stalled = (
            stall_after is not None and _age(state, log_path, now) > stall_after
        )
        if stalled:
            out(
                f"STALLED: no event for {_age(state, log_path, now):.1f}s "
                f"(> --stall-after {stall_after:g}s) and no run_completed"
            )
            return EXIT_STALLED
        if once:
            return EXIT_OK
        sleep(interval)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch watch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "path",
        help="a run-log *.jsonl, or a telemetry directory (newest run)",
    )
    ap.add_argument(
        "--stall-after",
        type=float,
        default=None,
        metavar="S",
        help="exit 3 when no new event lands for S seconds (and the run "
        "has not completed); default: never — report forever",
    )
    ap.add_argument(
        "--interval",
        type=float,
        default=2.0,
        metavar="S",
        help="poll interval in seconds (default 2)",
    )
    ap.add_argument(
        "--once",
        action="store_true",
        help="one health check instead of a loop: read the whole log, "
        "print the status, exit 0 healthy / 3 stalled",
    )
    args = ap.parse_args(argv)
    raise SystemExit(
        watch(
            args.path,
            stall_after=args.stall_after,
            interval=args.interval,
            once=args.once,
        )
    )


if __name__ == "__main__":
    main(sys.argv[1:])
