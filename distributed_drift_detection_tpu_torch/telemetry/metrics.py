"""Metrics registry: counters, gauges, histograms with two exporters — the
port's own copy of the JAX package's ``telemetry/metrics.py`` (same file
names, same text format).

A deliberately small, dependency-free subset of the Prometheus client
model — enough to persist "how much work did this process do" next to the
event log (:mod:`.events` answers "what happened when"):

* ``counter`` — monotone totals (``detections_total{partition="3"}``,
  ``rows_processed_total``); negative increments are rejected.
* ``gauge`` — last-written value (``compile_seconds``).
* ``histogram`` — cumulative-bucket distributions (``phase_seconds``),
  Prometheus semantics: ``_bucket{le=...}`` counts are cumulative,
  ``+Inf`` equals ``_count``, plus ``_sum``.

Exporters: :meth:`MetricsRegistry.to_json` (one dict, stable ordering) and
:meth:`MetricsRegistry.to_prometheus_text` (the text exposition format,
deterministic — sorted names, sorted label sets, ``le`` rendered last —
so golden tests can pin it byte-for-byte). :func:`parse_prometheus_text`
closes the round trip for tests and ad-hoc scraping.

Pure stdlib, no torch; safe anywhere, including a producer thread (each
sample is one dict write — the GIL makes that atomic enough for the
single-producer use here).
"""

from __future__ import annotations

import json
import re

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Wall-clock-seconds buckets: sub-ms dispatch latencies up to multi-minute
# soak legs.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0,
)


def _label_key(labels: dict) -> tuple:
    for name in labels:
        if not _LABEL_RE.match(name):
            raise ValueError(f"invalid label name {name!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt(v: float) -> str:
    """Deterministic number rendering: integral values print as integers
    (Prometheus counters are conventionally integer-looking), the rest via
    repr (shortest round-trippable float)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class Counter:
    kind = "counter"

    def __init__(self, name: str, help: str):
        self.name, self.help = name, help
        self.values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name} increment must be >= 0, got {amount}"
            )
        k = _label_key(labels)
        self.values[k] = self.values.get(k, 0.0) + amount


class Gauge:
    kind = "gauge"

    def __init__(self, name: str, help: str):
        self.name, self.help = name, help
        self.values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        self.values[_label_key(labels)] = float(value)


class Histogram:
    kind = "histogram"

    def __init__(self, name: str, help: str, buckets=DEFAULT_BUCKETS):
        if list(buckets) != sorted(set(buckets)):
            raise ValueError(f"histogram buckets must be sorted/unique: {buckets}")
        self.name, self.help = name, help
        self.buckets = tuple(float(b) for b in buckets)
        # label key -> [per-bucket counts (+1 overflow slot), sum, count]
        self.values: dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        k = _label_key(labels)
        slot = self.values.get(k)
        if slot is None:
            slot = self.values[k] = [[0] * (len(self.buckets) + 1), 0.0, 0]
        counts, _, _ = slot
        for i, b in enumerate(self.buckets):
            if value <= b:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        slot[1] += float(value)
        slot[2] += 1

    def cumulative(self, key: tuple) -> list[tuple[str, int]]:
        """``(le, cumulative count)`` pairs ending with ``+Inf``."""
        counts, _, total = self.values[key]
        out, acc = [], 0
        for b, c in zip(self.buckets, counts):
            acc += c
            out.append((_fmt(b), acc))
        out.append(("+Inf", total))
        return out


class MetricsRegistry:
    """Named metrics, created on first use, re-fetched idempotently (a
    kind/bucket mismatch on re-registration fails loudly)."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kw)
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}"
            )
        elif kw.get("buckets") and tuple(kw["buckets"]) != m.buckets:
            raise ValueError(f"metric {name!r} re-registered with new buckets")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    # -- exporters -----------------------------------------------------------

    def to_json(self) -> dict:
        """Stable dict form: metric name -> kind/help/samples."""
        out = {}
        # .copy(): exporters may run on a scraping thread (the serving
        # daemon's ops plane) while producers insert first-use metrics —
        # a dict snapshot keeps iteration safe; per-sample reads are
        # GIL-atomic enough for a monitoring scrape.
        for name in sorted(self._metrics.copy()):
            m = self._metrics[name]
            samples = []
            for key in sorted(m.values.copy()):
                labels = dict(key)
                if m.kind == "histogram":
                    _, total_sum, count = m.values[key]
                    samples.append(
                        {
                            "labels": labels,
                            "count": count,
                            "sum": total_sum,
                            "buckets": {
                                le: c for le, c in m.cumulative(key)
                            },
                        }
                    )
                else:
                    samples.append(
                        {"labels": labels, "value": m.values[key]}
                    )
            out[name] = {"kind": m.kind, "help": m.help, "samples": samples}
        return out

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition format, deterministically ordered.
        Safe to call from a scraping thread (see :meth:`to_json`)."""
        lines = []
        for name in sorted(self._metrics.copy()):
            m = self._metrics[name]
            # HELP and TYPE for EVERY series (exposition-format
            # conformance: scrapers key docs off HELP presence); an empty
            # help renders as a bare `# HELP name` line, never skipped.
            lines.append(f"# HELP {name} {_escape(m.help)}".rstrip())
            lines.append(f"# TYPE {name} {m.kind}")
            for key in sorted(m.values.copy()):
                if m.kind == "histogram":
                    _, total_sum, count = m.values[key]
                    for le, c in m.cumulative(key):
                        lines.append(
                            f"{name}_bucket{_render(key, le=le)} {c}"
                        )
                    lines.append(f"{name}_sum{_render(key)} {_fmt(total_sum)}")
                    lines.append(f"{name}_count{_render(key)} {count}")
                else:
                    lines.append(f"{name}{_render(key)} {_fmt(m.values[key])}")
        return "\n".join(lines) + "\n"


def _render(key: tuple, le: str | None = None) -> str:
    pairs = [f'{k}="{_escape(v)}"' for k, v in key]
    if le is not None:
        pairs.append(f'le="{le}"')  # convention: le last
    return "{" + ",".join(pairs) + "}" if pairs else ""


_ESCAPES = {"\\": "\\", '"': '"', "n": "\n"}


def _unescape(v: str) -> str:
    # Single left-to-right pass (inverse of _escape): sequential str.replace
    # would re-scan the output of earlier replacements and corrupt values
    # like 'C:\new' (escaped 'C:\\new', where the literal backslash's escape
    # must not pair with the following 'n').
    return re.sub(
        r"\\(.)", lambda m: _ESCAPES.get(m.group(1), m.group(0)), v
    )


def parse_prometheus_text(text: str) -> dict[tuple, float]:
    """Inverse of :meth:`MetricsRegistry.to_prometheus_text` for tests and
    ad-hoc scraping: ``{(sample name, ((label, value), ...)): value}``."""
    out: dict[tuple, float] = {}
    sample_re = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)$")
    label_re = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = sample_re.match(line)
        if not m:
            raise ValueError(f"unparseable sample line: {line!r}")
        name, _, labelstr, value = m.groups()
        labels = tuple(
            (k, _unescape(v)) for k, v in label_re.findall(labelstr or "")
        )
        out[(name, labels)] = float(value)
    return out


def write_exports(registry: MetricsRegistry, base_path: str) -> tuple[str, str]:
    """Write both exporter outputs next to a run log: ``<base>.metrics.json``
    and ``<base>.prom``; returns the two paths."""
    json_path = base_path + ".metrics.json"
    prom_path = base_path + ".prom"
    with open(json_path, "w") as fh:
        json.dump(registry.to_json(), fh, indent=1)
        fh.write("\n")
    with open(prom_path, "w") as fh:
        fh.write(registry.to_prometheus_text())
    return json_path, prom_path
