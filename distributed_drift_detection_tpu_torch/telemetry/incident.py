"""Incident autopsy plane: alert-triggered cross-plane evidence capture —
the port's own copy of the recorder half of the JAX package's
``telemetry/incident.py``. Its ``diagnose`` engine, readers and
``incident`` CLI are not ported yet (ROADMAP A15c); the JAX package's
read the bundles written here, which keep its schema.

The repo grew four separate evidence planes — the flight-recorder ring
(dumped only on crash), trace/forensics bundles, pipeline stage
attribution, and the durable metrics history — but when an SLO alert
fired on a live daemon nobody snapshotted any of them: the operator (or
the ROADMAP item-3 autoscaler) was left joining five CLIs by hand after
the window of evidence had rotated away. This module closes that gap:

* :class:`IncidentRecorder` — subscribed to the
  :class:`~.slo.SloEngine`'s fire/resolve transitions (the engine's
  ``observer`` hook, invoked on the SLO evaluator thread — never the
  serve loop) and to the crash path. Every ``firing`` transition
  captures a numbered, self-contained evidence bundle under
  ``<run-log stem>.incidents/incident-NNNN/``:

  =======================  ==============================================
  ``flightrec.jsonl``      the flight ring at firing time (the crash-only
                           dump, generalized)
  ``pipeline.json``        live stage attribution: busy shares, dominant
                           stage, the wedged-stage breadcrumb
  ``statusz.json``         the full ``/statusz`` snapshot
  ``history.jsonl``        a window extract from the history store around
                           the firing timestamp (when a store is
                           configured)
  ``top_tenants.json``     the per-tenant hotness ranking over the window
  ``verdicts_tail.jsonl``  the newest verdict sidecar lines
  ``quarantine_tail.jsonl`` the newest quarantine sidecar lines
  ``manifest.json``        firing rule + value + threshold + file list —
                           written LAST, atomically: its presence is the
                           bundle-complete marker
  ``resolved.json``        the resolve transition, appended when the
                           alert clears (open incidents lack it)
  =======================  ==============================================

  A daemon killed mid-capture leaves a directory without a manifest;
  :func:`read_bundle` surfaces that as a loud ``partial: true``, never a
  crash or a silently-complete-looking report. Verdict sidecars are
  bit-identical with incidents on or off (pinned by tests): capture runs
  entirely off the serve hot loop and only *reads* runner state.

No torch anywhere; stdlib + sibling telemetry modules only.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time

INCIDENTS_SUFFIX = ".incidents"
BUNDLE_PREFIX = "incident-"

MANIFEST_NAME = "manifest.json"
RESOLVED_NAME = "resolved.json"
FLIGHT_NAME = "flightrec.jsonl"
PIPELINE_NAME = "pipeline.json"
STATUSZ_NAME = "statusz.json"
HISTORY_NAME = "history.jsonl"
TENANTS_NAME = "top_tenants.json"
VERDICTS_TAIL_NAME = "verdicts_tail.jsonl"
QUARANTINE_TAIL_NAME = "quarantine_tail.jsonl"

INCIDENT_CAPTURES_METRIC = "incident_captures_total"
INCIDENT_CAPTURES_HELP = (
    "Incident bundles captured, labeled by the firing rule (or 'crash')"
)
INCIDENT_OPEN_METRIC = "incident_open"
INCIDENT_OPEN_HELP = (
    "Captured incidents whose firing alert has not resolved yet"
)

#: The fleet-index series the collector lifts from each daemon's
#: ``/incidentz`` into the history store (``instance`` labeled).
INCIDENTS_TOTAL_SERIES = "serve_incidents_total"
INCIDENT_OPEN_SERIES = "serve_incident_open"



# -- small tolerant IO helpers ------------------------------------------------


def _write_json(path: str, obj) -> bool:
    """Atomic best-effort JSON write (tmp + rename); False on failure."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as fh:
            json.dump(obj, fh, indent=1)
            fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except (OSError, TypeError, ValueError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False
    return True


def _write_lines(path: str, lines) -> bool:
    lines = list(lines)
    if not lines:
        return False
    try:
        with open(path, "w") as fh:
            for line in lines:
                fh.write(line.rstrip("\n") + "\n")
            fh.flush()
    except OSError:
        return False
    return True


def _tail_lines(path: str, n: int, max_bytes: int = 1 << 20) -> list[str]:
    """Last ``n`` complete lines of a (possibly huge) sidecar, reading at
    most ``max_bytes`` from the end — capture must stay cheap no matter
    how large the sidecar has grown."""
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(max(0, size - max_bytes))
            data = fh.read()
    except OSError:
        return []
    raw = data.split(b"\n")
    if size > max_bytes and raw:
        raw = raw[1:]  # the seek likely landed mid-line: drop the torn head
    lines = [ln.decode("utf-8", "replace") for ln in raw if ln.strip()]
    return lines[-max(int(n), 0):]


# -- capture ------------------------------------------------------------------


class IncidentRecorder:
    """Alert/crash-triggered evidence capture for one serving daemon.

    All capture callables only *read* runner state (the same contract as
    the ops handlers); bundles are written on the calling thread — the
    SLO evaluator for alerts, the dying loop thread for crashes — never
    the serve hot loop. :meth:`on_transition` is wired as
    ``SloEngine.observer``.
    """

    def __init__(
        self,
        stem: str,
        *,
        flight=None,
        statusz_fn=None,
        pipeline_fn=None,
        verdicts_path: "str | None" = None,
        store: "str | None" = None,
        window_s: float = 120.0,
        metrics=None,
        max_bundles: int = 32,
        tail_rows: int = 64,
    ):
        """``flight`` is the daemon's :class:`~.ops.FlightRecorder` (or
        ``None``); ``store`` a history-store directory for the window
        extract; ``max_bundles`` bounds captures per process lifetime
        (an alert-storm must not fill the disk — skips are counted)."""
        self.stem = stem
        self.root = stem + INCIDENTS_SUFFIX
        self._flight = flight
        self._statusz_fn = statusz_fn
        self._pipeline_fn = pipeline_fn
        self._verdicts_path = verdicts_path
        self._store = store or None
        self._window_s = float(window_s)
        self._max = max(int(max_bundles), 1)
        self._tail_rows = int(tail_rows)
        self._lock = threading.Lock()
        self._seq = 0
        self._captured = 0
        self._skipped = 0
        self._open: dict[str, str] = {}  # firing rule -> bundle name
        self._latest: "dict | None" = None
        self.last_capture_ms: "float | None" = None
        self._counter = self._gauge = None
        if metrics is not None:
            self._counter = metrics.counter(
                INCIDENT_CAPTURES_METRIC, help=INCIDENT_CAPTURES_HELP
            )
            self._gauge = metrics.gauge(
                INCIDENT_OPEN_METRIC, help=INCIDENT_OPEN_HELP
            )
            self._gauge.set(0.0)

    # - the SloEngine.observer hook (evaluator thread) -

    def on_transition(self, t: dict) -> None:
        """One successfully-emitted alert transition: ``firing`` captures
        a bundle and opens the incident, ``resolved`` closes it (writing
        the resolve transition into the bundle as ``resolved.json``)."""
        rule = str(t.get("rule") or "")
        if t.get("state") == "firing":
            name = self.capture(t)
            if name is not None:
                with self._lock:
                    self._open[rule] = name
        else:
            with self._lock:
                name = self._open.pop(rule, None)
            if name is not None:
                _write_json(os.path.join(self.root, name, RESOLVED_NAME), t)
        self._sync_gauge()

    def capture(self, reason: dict, kind: str = "alert") -> "str | None":
        """Write one evidence bundle; returns its directory name, or
        ``None`` (bundle cap reached, or the manifest could not land —
        the latter leaves a partial bundle readers flag loudly). Every
        artifact is individually best-effort: a broken snapshot source
        costs that file, never the bundle."""
        t0 = time.monotonic()
        with self._lock:
            if self._seq >= self._max:
                self._skipped += 1
                return None
            self._seq += 1
            seq = self._seq
        name = f"{BUNDLE_PREFIX}{seq:04d}"
        path = os.path.join(self.root, name)
        try:
            os.makedirs(path, exist_ok=True)
        except OSError:
            return None
        files: list[str] = []
        if self._flight is not None:
            try:
                if self._flight.dump(os.path.join(path, FLIGHT_NAME)):
                    files.append(FLIGHT_NAME)
            except Exception:
                pass
        for fname, fn in (
            (PIPELINE_NAME, self._pipeline_fn),
            (STATUSZ_NAME, self._statusz_fn),
        ):
            if fn is None:
                continue
            try:
                obj = fn()
            except Exception:
                obj = None
            if obj is not None and _write_json(
                os.path.join(path, fname), obj
            ):
                files.append(fname)
        if self._verdicts_path and _write_lines(
            os.path.join(path, VERDICTS_TAIL_NAME),
            _tail_lines(self._verdicts_path, self._tail_rows),
        ):
            files.append(VERDICTS_TAIL_NAME)
        qlines: list[str] = []
        for qpath in sorted(
            glob.glob(glob.escape(self.stem) + "*quarantine.jsonl")
        ):
            qlines.extend(_tail_lines(qpath, self._tail_rows))
        if qlines and _write_lines(
            os.path.join(path, QUARANTINE_TAIL_NAME),
            qlines[-self._tail_rows:],
        ):
            files.append(QUARANTINE_TAIL_NAME)
        if self._store:
            try:
                from .history import list_segments, read_samples, top_tenants

                if list_segments(self._store):
                    now = time.time()
                    recs = read_samples(
                        self._store,
                        start=now - self._window_s,
                        end=now + 1.0,
                    )
                    if recs and _write_lines(
                        os.path.join(path, HISTORY_NAME),
                        [json.dumps(r) for r in recs],
                    ):
                        files.append(HISTORY_NAME)
                    ranked = top_tenants(
                        self._store, window_s=self._window_s, at=now
                    )
                    if ranked and _write_json(
                        os.path.join(path, TENANTS_NAME), ranked
                    ):
                        files.append(TENANTS_NAME)
            except Exception:
                pass
        capture_ms = round((time.monotonic() - t0) * 1e3, 3)
        manifest = {
            "v": 1,
            "id": name,
            "seq": seq,
            "kind": kind,
            "ts": round(time.time(), 6),
            "mono": round(time.monotonic(), 6),
            "rule": reason.get("rule"),
            "state": reason.get("state", "firing"),
            "value": reason.get("value"),
            "threshold": reason.get("threshold"),
            **(
                {"alert_mono": reason["mono"]} if "mono" in reason else {}
            ),
            **({"error": reason["error"]} if "error" in reason else {}),
            "stem": os.path.basename(self.stem),
            "files": files,
            "capture_ms": capture_ms,
        }
        # The manifest lands LAST, atomically: its presence IS the
        # bundle-complete marker. A daemon killed before this point
        # leaves a manifest-less dir that reads as partial.
        if not _write_json(os.path.join(path, MANIFEST_NAME), manifest):
            return None
        self.last_capture_ms = capture_ms
        with self._lock:
            self._captured += 1
            self._latest = manifest
        if self._counter is not None:
            self._counter.inc(1.0, rule=str(reason.get("rule") or kind))
        return name

    def capture_crash(self, error: str) -> "str | None":
        """The crash-path generalization of the flight-recorder dump:
        a failing daemon leaves a full bundle too, rule ``crash``."""
        return self.capture(
            {"rule": "crash", "state": "firing", "error": str(error)},
            kind="crash",
        )

    def _sync_gauge(self) -> None:
        if self._gauge is not None:
            with self._lock:
                n = len(self._open)
            self._gauge.set(float(n))

    # - surfaces -

    def count(self) -> int:
        with self._lock:
            return self._captured

    def statusz_section(self) -> dict:
        """The ``/statusz`` ``incidents`` section (``backend_snapshot``
        lifts ``count`` into the fleet view)."""
        with self._lock:
            return {
                "count": self._captured,
                "open": len(self._open),
                "skipped": self._skipped,
                "dir": self.root,
            }

    def incidentz(self) -> dict:
        """The ``/incidentz`` payload: counts + the latest manifest."""
        with self._lock:
            return {
                "count": self._captured,
                "open": len(self._open),
                "skipped": self._skipped,
                "dir": self.root,
                "last_capture_ms": self.last_capture_ms,
                "latest": dict(self._latest) if self._latest else None,
            }
