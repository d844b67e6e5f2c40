"""Run telemetry of the port: the run log, the run registry and the metric
exports behind ``RunConfig.telemetry_dir`` — the port's own copies of the
JAX package's ``telemetry`` modules, writing the same artifacts:

* :mod:`.events` — typed, timestamped records (``run_started``,
  ``phase_completed``, ``drift_detected``, …) appended to a JSONL run log
  with a versioned schema.
* :mod:`.registry` — the append-only ``index.jsonl`` per telemetry
  directory: run id → config digest, status running/completed/failed
  (written by ``api.run``, the supervisor, the grid, ``heal`` and the
  scheduler).
* :mod:`.metrics` — counters, gauges and histograms with JSON and
  Prometheus-text exporters.
* :mod:`.profile` — the card's memory statistics mapped onto the event
  schema and registry gauges.
* :mod:`.watch` (``staleness_s``), :mod:`.pipeline` (the serve-stage
  attribution and the fleet view) and :mod:`.ops` (the HTTP ops plane and
  the crash flight recorder) — the parts the serving daemon and the sweep
  scheduler use.
* the serving daemon's planes: :mod:`.trace` (row→verdict latency
  histograms), :mod:`.tracing` (trace contexts and ``span`` events),
  :mod:`.spans`, :mod:`.slo` (alert rules and their evaluator),
  :mod:`.forensics` (drift evidence bundles), :mod:`.incident` (alert and
  crash evidence bundles) and :mod:`.history` (the series store the
  incident plane extracts from).

Telemetry is off by default (``RunConfig.telemetry_dir=None``): every hook
runs outside the Final Time span, and with the directory unset no telemetry
code runs. Only :mod:`.profile` touches torch, and only inside its
functions; the readers (``report``, ``watch``, ``top``, ``timeline``,
``explain``, ``incident``, …) wait for ROADMAP A15c, and the JAX package's
read the port's artifacts unchanged.
"""

from .events import (
    EVENT_SCHEMA,
    SCHEMA_VERSION,
    EventLog,
    SchemaError,
    emit_flag_events,
    read_events,
    validate_event,
)
from .metrics import MetricsRegistry, parse_prometheus_text, write_exports

__all__ = [
    "EVENT_SCHEMA",
    "SCHEMA_VERSION",
    "EventLog",
    "SchemaError",
    "emit_flag_events",
    "read_events",
    "validate_event",
    "MetricsRegistry",
    "parse_prometheus_text",
    "write_exports",
]
