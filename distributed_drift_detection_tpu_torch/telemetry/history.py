"""Durable time-series plane: the readers the serving daemon's incident
plane uses — the port's own copy of part of the JAX package's
``telemetry/history.py``. The per-tenant series names
(``serve_tenant_rows_total``, exported under ``--tenant-series``), and
the torn-tail-tolerant segment readers behind an incident bundle's
window extract (``--incident-store``): :func:`list_segments`,
:func:`read_samples` and :func:`top_tenants` (per-tenant rows rate over a
window, counter-reset tolerant, on the monotonic stamps within one writer
run). The store's writer, its other queries and the ``history`` CLI are
not ported yet (ROADMAP A15c); the store is the JAX package's format.
Stdlib only.
"""

from __future__ import annotations

import glob
import json
import os
import re
import time

SEGMENT_PREFIX = "series-"
SEGMENT_SUFFIX = ".jsonl"


_SEGMENT_RE = re.compile(
    re.escape(SEGMENT_PREFIX) + r"(\d{8})" + re.escape(SEGMENT_SUFFIX) + "$"
)


#: The per-tenant hotness series a serve daemon exports under
#: ``--tenant-series`` (telemetry/collector scrapes it into the store).
TENANT_ROWS_METRIC = "serve_tenant_rows_total"
TENANT_ROWS_HELP = (
    "Stream rows published per tenant (serve --tenant-series; "
    "cardinality-guarded — refused beyond ServeParams.tenant_series_max "
    "tenants)"
)
#: Per-tenant adaptation events already ride adaptations_total
#: (adapt.refit.ADAPT_METRIC); top_tenants folds their rate in.
TENANT_ADAPT_METRIC = "adaptations_total"


def label_key(labels: "dict | None") -> tuple:
    """Canonical series-identity tuple (sorted ``(name, value)`` pairs,
    values stringified) — the same normalization as the metrics
    registry's label keys."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def list_segments(root: str) -> list[str]:
    """Store segments in sequence order (``[]`` for a fresh/absent dir)."""
    if not os.path.isdir(root):
        return []
    paths = [
        p
        for p in glob.glob(
            os.path.join(root, SEGMENT_PREFIX + "*" + SEGMENT_SUFFIX)
        )
        if _SEGMENT_RE.search(os.path.basename(p))
    ]
    return sorted(paths)


def _segment_bounds(path: str) -> "tuple[float, float] | None":
    """(first ts, last ts) of a segment's complete records, or ``None``
    for an empty/unreadable one. The tail is read tolerantly — the last
    line may be torn."""
    first = last = None
    try:
        with open(path) as fh:
            lines = fh.readlines()
    except OSError:
        return None
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break
            raise ValueError(f"{path}:{i + 1}: corrupt history record")
        ts = float(rec["ts"])
        first = ts if first is None else first
        last = ts
    return None if first is None else (first, last)


# -- read path ---------------------------------------------------------------


def _match(rec: dict, name: "str | None", labels: "dict | None") -> bool:
    if name is not None and rec.get("name") != name:
        return False
    if labels:
        rl = rec.get("labels") or {}
        for k, v in labels.items():
            if rl.get(str(k)) != str(v):
                return False
    return True


def read_samples(
    root: str,
    *,
    name: "str | None" = None,
    labels: "dict | None" = None,
    start: "float | None" = None,
    end: "float | None" = None,
) -> list[dict]:
    """Raw matching samples across all segments, in append order.

    ``labels`` is a **subset** selector: a sample matches when every
    selector pair is present (extra sample labels are fine — selecting
    ``{"tenant": "3"}`` matches any instance). Each segment tolerates
    one torn trailing line (a crash mid-append, or the live writer mid-
    write); a malformed *interior* line is corruption and raises.
    Segments wholly outside ``[start, end]`` are skipped without
    parsing every line (bounds peek)."""
    out: list[dict] = []
    for path in list_segments(root):
        if start is not None or end is not None:
            bounds = _segment_bounds(path)
            if bounds is None:
                continue
            if start is not None and bounds[1] < start:
                continue
            if end is not None and bounds[0] > end:
                continue
        with open(path) as fh:
            lines = fh.readlines()
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break  # torn tail: skipped exactly once per segment
                raise ValueError(f"{path}:{i + 1}: corrupt history record")
            ts = float(rec["ts"])
            if start is not None and ts < start:
                continue
            if end is not None and ts > end:
                continue
            if _match(rec, name, labels):
                out.append(rec)
    return out


def series_keys(records: list[dict]) -> "dict[tuple, list[dict]]":
    """Group records by series identity ``(name, label_key(labels))``."""
    out: dict[tuple, list[dict]] = {}
    for rec in records:
        out.setdefault(
            (rec["name"], label_key(rec.get("labels"))), []
        ).append(rec)
    return out


def _elapsed(first: dict, last: dict) -> float:
    """Elapsed seconds between two samples — monotonic when both carry
    stamps from the same writer boot (a wall-clock step between scrapes
    cannot fake or hide time), wall otherwise (different boots share no
    monotonic origin)."""
    if (
        first.get("boot")
        and first.get("boot") == last.get("boot")
        and first.get("mono") is not None
        and last.get("mono") is not None
    ):
        return float(last["mono"]) - float(first["mono"])
    return float(last["ts"]) - float(first["ts"])


def rate(
    root: str,
    name: str,
    *,
    labels: "dict | None" = None,
    window_s: float = 300.0,
    at: "float | None" = None,
) -> "dict[tuple, float | None]":
    """Per-second increase of a counter series over ``[at - window_s,
    at]``, per matching series; ``None`` with fewer than two samples.

    Counter-reset tolerant: only positive deltas count (a restarted
    daemon's counter dropping to 0 contributes nothing, never a negative
    rate). Elapsed time is monotonic within one writer boot
    (:func:`_elapsed`)."""
    if at is None:
        at = time.time()
    grouped = series_keys(
        read_samples(
            root, name=name, labels=labels, start=at - window_s, end=at
        )
    )
    out: dict[tuple, float | None] = {}
    for key, recs in grouped.items():
        recs.sort(key=lambda r: float(r["ts"]))
        if len(recs) < 2:
            out[key[1]] = None
            continue
        increase = 0.0
        for prev, cur in zip(recs, recs[1:]):
            d = float(cur["value"]) - float(prev["value"])
            if d > 0:
                increase += d
        dt = _elapsed(recs[0], recs[-1])
        out[key[1]] = (increase / dt) if dt > 0 else None
    return out


def top_tenants(
    root: str,
    *,
    window_s: float = 300.0,
    at: "float | None" = None,
    metric: str = TENANT_ROWS_METRIC,
    adapt_metric: str = TENANT_ADAPT_METRIC,
    limit: "int | None" = None,
) -> list[dict]:
    """Per-tenant activity ranking over the window: rows/s (the rank
    key, summed across instances — a migrated tenant's rate follows it
    across backends) plus adaptation events/s. The input the tenant
    residency manager (ROADMAP item 2) pages by."""
    rows_rate = rate(root, metric, window_s=window_s, at=at)
    adapt_rate = rate(root, adapt_metric, window_s=window_s, at=at)

    def _fold(rates: "dict[tuple, float | None]") -> dict[str, float]:
        per: dict[str, float] = {}
        for key, r in rates.items():
            if r is None:
                continue
            tenant = dict(key).get("tenant")
            if tenant is not None:
                per[tenant] = per.get(tenant, 0.0) + r
        return per

    rows = _fold(rows_rate)
    adapts = _fold(adapt_rate)
    ranked = [
        {
            "tenant": t,
            "rows_per_sec": round(rows.get(t, 0.0), 3),
            "adaptations_per_sec": round(adapts.get(t, 0.0), 6),
        }
        for t in sorted(
            set(rows) | set(adapts),
            key=lambda t: (-rows.get(t, 0.0), t),
        )
    ]
    return ranked[:limit] if limit else ranked


# -- rendering ---------------------------------------------------------------


# -- CLI ---------------------------------------------------------------------


