"""Structured run events: typed records over an append-only JSONL sink —
the port's own copy of the JAX package's ``telemetry/events.py``, with the
same schema version, event types and file naming, so each package's
readers take the other's run logs.

One run = one ``*.jsonl`` file; one line = one event. Every event carries
the envelope ``{"v": SCHEMA_VERSION, "type": ..., "ts": <unix seconds>,
"seq": <per-log counter>}`` plus its type's required payload fields
(:data:`EVENT_SCHEMA`). Unknown types and missing required fields are
rejected at **both** ends — :meth:`EventLog.emit` refuses to write them and
:func:`read_events` refuses to parse them — so a run log that loads is a
run log the ``report`` CLI can render. Extra payload fields are allowed
(forward compatibility); required ones may be ``None`` only where the
schema note says so.

Engines never emit from inside the device loop: drift/retrain events are
extracted host-side from the already-collected flag tables
(:func:`emit_flag_events`), after the timed span closes. The types a
compiled XLA program feeds (``cost_analysis``, a ``memory_analysis``
snapshot) stay in the schema so logs of both packages validate alike; the
port emits neither (``telemetry.profile``).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time

import numpy as np

from ..resilience import faults

SCHEMA_VERSION = 1

# type -> required payload fields (beyond the v/type/ts/seq envelope).
# Nullable-by-contract: drift_detected.delay_rows is None for streams
# without planted-boundary geometry (no ground truth to measure against).
EVENT_SCHEMA: dict[str, tuple[str, ...]] = {
    # one per run log, first event: identity + the requested configuration
    "run_started": ("run_id", "config"),
    # runner construction: in the port ``cached`` = no kernel library was
    # rebuilt and ``seconds`` = the nvcc wall time of ``api.prepare``'s
    # build (the JAX package: its runner cache and its jit build time).
    "compile_completed": ("cached", "seconds"),
    # one per PhaseTimer/SpanTracker phase (prepare/upload/detect/collect)
    "phase_completed": ("phase", "seconds"),
    # one per detector change flag: where drift fired
    "drift_detected": ("partition", "global_pos", "delay_rows"),
    # one per model rotate/refit; ``forced`` = saturation-guard fallback
    # (RunConfig.retrain_error_threshold), not a detector change
    "retrain": ("partition", "batch", "forced"),
    # streaming progress: one per ChunkedDetector chunk
    "chunk_completed": ("chunk", "batches_done", "detections"),
    # soak progress: one per chained-soak leg (engine.soak.run_soak_chained)
    "leg_completed": ("leg", "rows", "detections"),
    # liveness beacon for long streaming/soak runs (the `watch` CLI's food):
    # ``rows_done`` = cumulative rows consumed so far, ``elapsed_s`` =
    # monotonic seconds since the engine started feeding — monotonic, not
    # wall-clock, so a host clock step mid-run cannot fake progress or a
    # stall. Emitted host-side between device programs (per chunk / per
    # leg), never from jitted code and never inside api.run's
    # reference-parity Final Time span (api.run emits none: a one-shot run
    # has no mid-flight to report).
    "heartbeat": ("rows_done", "elapsed_s"),
    # XLA cost analysis of a compiled runner, extracted host-side after
    # the timed span (the JAX package; the port has no compiled program
    # and emits none, telemetry.profile). ``where`` names the program (e.g.
    # "detect_runner"); flops/bytes_accessed are None where the backend's
    # cost model reports nothing — the full normalized map rides as the
    # ``analysis`` extra.
    "cost_analysis": ("where", "flops", "bytes_accessed"),
    # A memory measurement: ``source`` = "memory_analysis" (compiler-
    # reported argument/output/temp/generated-code bytes of a compiled
    # runner; the JAX package only) or "device" (the card's allocator
    # statistics, taken before/after the detect phase); ``stats`` is the
    # non-empty numeric dict. Absence of a device snapshot means the
    # device reports none (the CPU) — never a fabricated zero.
    "memory_snapshot": ("source", "stats"),
    # ingest quarantine (io.sanitize via api.run): ``rows`` stream rows
    # violated the ingest contract and were masked out under ``policy``
    # ('quarantine'/'repair'); the per-row evidence lives in the
    # quarantine.jsonl sidecar (its path rides as the ``sidecar`` extra,
    # repaired-cell count as ``repaired``). Emitted between prepare and
    # the Final Time span — outside the timed region — and only when the
    # count is nonzero: clean streams leave no trace.
    "rows_quarantined": ("rows", "policy"),
    # supervised retry (resilience.supervisor): attempt ``attempt`` of
    # ``max_attempts`` failed with ``reason`` (the classified exception,
    # as "Type: message") and will be re-run after ``backoff_s`` seconds.
    # Emitted by the supervisor between attempts — strictly outside any
    # run's Final Time span — into its own per-supervision log; the
    # failed attempt's own run log + registry record carry the evidence.
    "run_retried": ("attempt", "max_attempts", "reason", "backoff_s"),
    # SLO alert transition (telemetry.slo, serving daemon): ``rule`` (one
    # of slo.RULE_KINDS) crossed into ("firing") or out of ("resolved")
    # violation; ``value`` is the measured quantity at the transition,
    # ``threshold`` the rule's bar. Emitted by the daemon's evaluator
    # thread — the serve path only, strictly outside any api.run Final
    # Time span (purity holds by construction).
    "alert": ("rule", "state", "value", "threshold"),
    # One causal trace span (telemetry.tracing): ``trace_id`` groups every
    # span of one traced unit of work (a sampled ingress row, a batch
    # chunk), ``span_id`` names this span, ``parent_id`` its parent (None
    # for a root span). ``start_ts`` is the span's wall-clock start in
    # unix seconds (monotonic stamps are rebased host-side before emit,
    # telemetry.tracing.wall_of), ``dur_s`` its duration. Head-sampled:
    # at sample rate 0 nothing on the hot path even looks at a clock.
    # The ``timeline`` CLI merges spans (with correlate's clock
    # alignment) into a Chrome-trace/Perfetto artifact.
    "span": ("name", "trace_id", "span_id", "parent_id", "start_ts", "dur_s"),
    # A drift evidence bundle landed (telemetry.forensics, serving
    # daemon): partition/global_pos locate the firing flag exactly like
    # ``drift_detected``; ``bundle`` is the bundle file's path relative
    # to the run log's directory (under ``<run>.forensics/``). Extracted
    # host-side from the already-collected flag tables + the chunk's
    # host copy — never from jitted code.
    "drift_forensics": ("chunk", "partition", "global_pos", "bundle"),
    # A drift adaptation decision landed (adapt subsystem): tenant
    # ``tenant``'s ``policy`` (retrain|shadow) consumed the drift verdict
    # of ``trigger_chunk``, refitted on ``rows_refit`` post-drift window
    # rows, and measured champion-vs-challenger error on that window
    # (``err_before``/``err_after`` — None when the window held no valid
    # rows). ``promoted`` = the challenger now serves (always True for
    # retrain; gated on measured error for shadow; False with the
    # ``demoted`` extra when a probation window reverted a promotion).
    # Extras: ``applied_chunk``, ``rows_to_apply`` (rows from verdict to
    # application), ``pre_drift_err``, ``window_rows``. Emitted host-side
    # at verdict publication — never from jitted code, serve/chunked
    # paths only (api.run's Final Time purity holds by construction).
    "adaptation": (
        "tenant", "trigger_chunk", "policy", "rows_refit",
        "err_before", "err_after", "promoted",
    ),
    # one per run log, last event: totals over the reference's Final Time
    "run_completed": ("rows", "seconds", "detections"),
}


class SchemaError(ValueError):
    """An event violates the run-log schema (unknown type, missing field,
    wrong envelope version, or a line that is not a JSON object)."""


# The only required fields allowed to be null (see the schema notes above).
_NULLABLE = frozenset(
    {
        ("drift_detected", "delay_rows"),
        ("cost_analysis", "flops"),
        ("cost_analysis", "bytes_accessed"),
        ("span", "parent_id"),  # root spans have no parent
        # an empty/fully-masked refit window has no error to measure
        ("adaptation", "err_before"),
        ("adaptation", "err_after"),
    }
)


def validate_event(event: object) -> dict:
    """Validate one event dict against :data:`EVENT_SCHEMA`; returns it."""
    if not isinstance(event, dict):
        raise SchemaError(f"event is not a JSON object: {event!r:.80}")
    etype = event.get("type")
    if etype not in EVENT_SCHEMA:
        raise SchemaError(
            f"unknown event type {etype!r}; expected one of "
            f"{sorted(EVENT_SCHEMA)}"
        )
    if event.get("v") != SCHEMA_VERSION:
        raise SchemaError(
            f"schema version {event.get('v')!r} != {SCHEMA_VERSION} "
            f"(event {etype!r})"
        )
    for field in ("ts", "seq"):
        if field not in event:
            raise SchemaError(f"event {etype!r} missing envelope {field!r}")
    missing = [f for f in EVENT_SCHEMA[etype] if f not in event]
    if missing:
        raise SchemaError(f"event {etype!r} missing required {missing}")
    # Presence is not enough: a null where the report does arithmetic
    # (int(done["rows"]), timeline positions) would turn "a log that loads
    # is a log the report can render" into a downstream TypeError.
    null = [
        f
        for f in EVENT_SCHEMA[etype]
        if event[f] is None and (etype, f) not in _NULLABLE
    ]
    if null:
        raise SchemaError(f"event {etype!r} has null required {null}")
    return event


_RUN_COUNTER = 0
_SAFE_NAME = re.compile(r"[^A-Za-z0-9._-]+")


class EventLog:
    """Append-only JSONL event sink for one run.

    Lines are flushed as written (the log survives a crash mid-run — that
    is half its point), and every emitted event is schema-validated first,
    so a malformed emit fails the *producer* loudly instead of poisoning
    the artifact.
    """

    def __init__(self, path: str, *, clock=time.time):
        self.path = path
        self.run_id = os.path.splitext(os.path.basename(path))[0]
        self._clock = clock
        self._seq = 0
        self._fh = open(path, "a")
        # Emission is serialized: the serving daemon's SLO evaluator
        # thread emits alerts into the same log as the serve loop, and an
        # interleaved seq/write would corrupt the artifact.
        self._lock = threading.Lock()
        # Optional per-event observer (e.g. the ops plane's
        # FlightRecorder): called with each validated record after it is
        # flushed, under the same lock (ring order == log order).
        self.tap = None

    @classmethod
    def open_run(
        cls,
        telemetry_dir: str,
        name: str = "",
        process_index: "int | None" = None,
    ) -> "EventLog":
        """Create the directory and a fresh per-run log file inside it.

        ``name`` (e.g. the resolved app name — the grid harness's per-cell
        config key) is sanitized into the filename; a timestamp + pid +
        process-local counter suffix keeps concurrent and repeated runs
        from colliding. ``process_index`` (the launcher's process rank,
        see ``parallel.multihost.host_identity``) adds a ``procN`` segment:
        in a multi-host run every process writes its own log into a shared
        directory, and without the segment the N sibling logs of one run
        are indistinguishable on disk (``telemetry.correlate`` groups them
        by the ``run_started`` identity extras; the filename is for humans
        and shell globs).
        """
        global _RUN_COUNTER
        os.makedirs(telemetry_dir, exist_ok=True)
        stem = _SAFE_NAME.sub("_", name).strip("_") or "run"
        proc = "" if process_index is None else f"-proc{int(process_index)}"
        _RUN_COUNTER += 1
        fname = (
            f"{stem}-{time.strftime('%Y%m%d-%H%M%S')}{proc}"
            f"-{os.getpid()}-{_RUN_COUNTER}.jsonl"
        )
        return cls(os.path.join(telemetry_dir, fname))

    def emit(self, etype: str, **fields) -> dict:
        """Validate and append one event; returns the full record."""
        with self._lock:
            event = {
                "v": SCHEMA_VERSION,
                "type": etype,
                "ts": self._clock(),
                "seq": self._seq,
                **fields,
            }
            validate_event(event)
            payload = json.dumps(event)
            # Fault-injection site (resilience.faults, no-op unless armed):
            # kind='torn_write' appends a partial prefix of this payload with
            # no newline and raises — the exact torn-tail artifact the
            # allow_partial_tail read path and crash tests exercise.
            faults.fire(
                "telemetry.emit", fh=self._fh, payload=payload, seq=self._seq
            )
            self._fh.write(payload + "\n")
            self._fh.flush()
            self._seq += 1
            if self.tap is not None:
                self.tap(event)
        return event

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path: str, *, allow_partial_tail: bool = False) -> list[dict]:
    """Parse and schema-validate a run log; raises :class:`SchemaError` on
    any malformed line (the CI smoke gate's contract: a log that loads is a
    log the report can render).

    ``allow_partial_tail=True`` tolerates exactly one **torn trailing
    line** — the crash/live-tail read path. The sink appends
    ``json.dumps(event) + "\\n"`` per emit, so a reader racing the writer
    (or a log cut off by a crash/full volume mid-write) can see one final
    line that is an incomplete JSON prefix; that line is skipped, never a
    line before it (a malformed *interior* line is corruption either way),
    and never a line that parses as JSON but violates the schema (a
    complete-but-invalid event is a producer bug a tear cannot produce —
    no strict prefix of the serialized object form is itself valid JSON).
    The strict default is the CI smoke gate's contract.
    """
    events = []
    with open(path) as fh:
        lines = fh.readlines()
    for lineno, line in enumerate(lines, 1):
        stripped = line.strip()
        if not stripped:
            continue
        try:
            event = json.loads(stripped)
        except json.JSONDecodeError as e:
            if allow_partial_tail and lineno == len(lines):
                break  # the one torn trailing line; everything before stands
            raise SchemaError(f"{path}:{lineno}: not JSON ({e})") from None
        try:
            validate_event(event)
        except SchemaError as e:
            raise SchemaError(f"{path}:{lineno}: {e}") from None
        events.append(event)
    return events


def emit_flag_events(
    log: EventLog,
    change_global: np.ndarray,
    forced_retrain: np.ndarray,
    dist_between_changes: int = 0,
) -> int:
    """Emit drift/retrain events from a collected ``[P, NB-1]`` flag table.

    Called host-side on the already-transferred numpy flags, after the
    timed span — never from jitted code. Every detector change becomes a
    ``drift_detected`` (with its delay when the stream has planted-boundary
    geometry, else ``delay_rows=None``); every model rotation — change- or
    saturation-guard-triggered — becomes a ``retrain`` (``batch`` is the
    1-based processed-batch index, matching the flag table's column + 1).
    Returns the number of drift events emitted.
    """
    cg = np.asarray(change_global)
    fr = np.asarray(forced_retrain)
    dist = int(dist_between_changes)
    changed = cg >= 0
    # Column-major (batch-then-partition) order: the log reads as a timeline.
    for b, p in zip(*np.nonzero(changed.T)):
        pos = int(cg[p, b])
        log.emit(
            "drift_detected",
            partition=int(p),
            global_pos=pos,
            delay_rows=(pos % dist) if dist > 0 else None,
            batch=int(b) + 1,
        )
    for b, p in zip(*np.nonzero((changed | fr).T)):
        log.emit(
            "retrain",
            partition=int(p),
            batch=int(b) + 1,
            forced=bool(fr[p, b]),
        )
    return int(changed.sum())
