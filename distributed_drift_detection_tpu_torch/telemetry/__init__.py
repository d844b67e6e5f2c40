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
* the serving daemon's planes: :mod:`.pipeline` (the serve-stage
  attribution and the fleet view), :mod:`.ops` (the HTTP ops plane and
  the crash flight recorder), :mod:`.trace` (row→verdict latency
  histograms), :mod:`.tracing` (trace contexts and ``span`` events),
  :mod:`.spans`, :mod:`.slo` (alert rules and their evaluator),
  :mod:`.forensics` (drift evidence bundles), :mod:`.incident` (alert and
  crash evidence bundles) and :mod:`.history` (the durable series store
  the incident plane extracts from).
* the eleven readers, each the JAX package's output and exit code on an
  artifact of either package: :mod:`.report` (a run log's summary),
  :mod:`.perf` (bench artifacts diffed across rounds), :mod:`.watch` (a
  live run's progress and the stall contract, exit 3), :mod:`.top` (the
  fleet dashboard, ``--record``/``--replay``), :mod:`.pipeline` (the
  serve bottleneck report), :mod:`.history` (range/rate/quantile/
  top-tenants queries of a store), :mod:`.collector` (the scraper that
  builds a store, with burn-rate SLO rules), :mod:`.correlate` and
  :mod:`.timeline` (several processes' logs merged, the latter into a
  Chrome trace), ``explain`` (:mod:`.forensics`) and ``incident``
  (:mod:`.incident`: list, show, diagnose).

Telemetry is off by default (``RunConfig.telemetry_dir=None``): every hook
runs outside the Final Time span, and with the directory unset no telemetry
code runs. Only :mod:`.profile` touches torch, and only inside its
functions; the readers import neither torch nor JAX, so they run wherever
the artifacts land — the card's host included.
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
