"""Durable time-series plane: the fleet's memory of its own metrics — the
port's own copy of the JAX package's ``telemetry/history.py``: the same
store format, so each package's ``history`` reads a store the other's
``collector`` or ``top --record`` wrote, and the serving daemon's incident
plane extracts its window from it (``--incident-store``).

Every observability surface so far is a point-in-time scrape —
``/metrics``, ``/statusz``, ``/fleetz`` and ``top`` show the current
instant, and the SLO engine judged instantaneous threshold crossings.
Drift is a *temporal* signal, and so is fleet health: tenant-hotness
ranking, error-budget burn and rate trends all need history. This module
is that substrate — an append-only, segment-rotated on-disk series store
with the same durability idiom as every other sink in the repo (flushed
appends, atomic segment rotation, torn-tail-tolerant reads), plus the
query primitives the consumers share:

* :class:`HistoryStore` — the single writer: samples append to an active
  ``series-NNNNNNNN.jsonl`` segment (one JSON object per line, flushed
  per batch), rotation finalizes the active segment with an fsync and
  opens the next sequence number (readers only ever see whole segments
  plus at most one torn trailing line), retention drops whole finalized
  segments by age and/or total size — never the active one, never a
  partial segment.
* :func:`read_samples` / :func:`range_query` — raw and step-aligned
  reads. Downsampling is **step-aligned** (buckets are
  ``floor(ts/step)·step``) and conservative: ``agg='sum'`` over the
  buckets of a series sums to exactly the raw samples' sum (the
  property test's conservation invariant).
* :func:`rate` — per-second increase of a counter series over a window,
  counter-reset tolerant (negative deltas contribute 0, the Prometheus
  convention). Within one writer run (same ``boot`` token) elapsed time
  comes from the **monotonic** stamps, so a wall-clock step between two
  samples cannot fake or hide a rate — the correlate/timeline skew-rebase
  convention applied to scrapes.
* :func:`quantile_over_time` / :func:`avg_over_time` — windowed
  aggregates over gauge series (the burn-rate SLO food).
* :func:`top_tenants` — ranks per-tenant labeled series
  (``serve_tenant_rows_total{tenant=...}``, exported by serve daemons
  under ``--tenant-series``) by windowed rate, folding in per-tenant
  adaptation-event rates — the exact activity ranking the tenant
  residency manager (ROADMAP item 2) consumes.
* :func:`main` — the ``history`` CLI: range/rate/quantile/top-tenants
  queries with JSON or ASCII-sparkline output.

Single-writer contract: one process appends to a store directory at a
time (the collector daemon, or ``top --record``); readers are fully
concurrent — they never lock and tolerate the writer mid-append exactly
like every JSONL reader here. No torch, no jax; stdlib only.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

SEGMENT_PREFIX = "series-"
SEGMENT_SUFFIX = ".jsonl"

#: Rotation default: segments stay small enough that retention (whole
#: segments only) tracks the requested bounds closely.
DEFAULT_SEGMENT_BYTES = 1 << 20

_SEGMENT_RE = re.compile(
    re.escape(SEGMENT_PREFIX) + r"(\d{8})" + re.escape(SEGMENT_SUFFIX) + "$"
)

AGGS = ("avg", "sum", "min", "max", "last", "count")

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


def segment_path(root: str, seq: int) -> str:
    return os.path.join(root, f"{SEGMENT_PREFIX}{seq:08d}{SEGMENT_SUFFIX}")


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


class HistoryStore:
    """The single writer of one store directory.

    ``segment_bytes`` bounds the active segment (rotation is checked
    after each append batch); ``retention_s``/``retention_bytes`` bound
    the whole store by sample age / total size (``None`` = unbounded).
    ``boot`` tokens one writer process run: samples stamped with the
    same boot share a monotonic clock, which :func:`rate` prefers over
    wall time for elapsed-time math.
    """

    def __init__(
        self,
        root: str,
        *,
        segment_bytes: int = DEFAULT_SEGMENT_BYTES,
        retention_s: "float | None" = None,
        retention_bytes: "int | None" = None,
        boot: "str | None" = None,
    ):
        self.root = root
        self.segment_bytes = max(int(segment_bytes), 1)
        self.retention_s = retention_s
        self.retention_bytes = retention_bytes
        # One token per writer process run: pid + monotonic-origin hash.
        self.boot = boot or f"{os.getpid():x}-{int(time.monotonic() * 1e3):x}"
        os.makedirs(root, exist_ok=True)
        segments = list_segments(root)
        if segments:
            self._seq = int(_SEGMENT_RE.search(segments[-1]).group(1))
            # A crash mid-append leaves a torn trailing line in the
            # then-active segment. Readers skip it, but a resumed writer
            # about to APPEND must truncate it first or the next sample
            # would concatenate into a permanently corrupt interior line
            # (the serve verdict sidecar's reconcile idiom).
            self._reconcile_torn_tail(segments[-1])
        else:
            self._seq = 1
        self._fh = open(segment_path(root, self._seq), "a")

    @staticmethod
    def _reconcile_torn_tail(path: str) -> bool:
        with open(path, "rb+") as fh:
            data = fh.read()
            if not data or data.endswith(b"\n"):
                return False
            cut = data.rfind(b"\n")
            fh.truncate(cut + 1)
        return True

    # -- append path ---------------------------------------------------------

    def append(
        self,
        name: str,
        value: float,
        *,
        labels: "dict | None" = None,
        ts: "float | None" = None,
        mono: "float | None" = None,
    ) -> dict:
        """Append one sample; returns the record written."""
        return self.append_samples(
            [(name, labels or {}, value)], ts=ts, mono=mono
        )[0]

    def append_samples(
        self,
        samples,
        *,
        ts: "float | None" = None,
        mono: "float | None" = None,
    ) -> list[dict]:
        """Append a batch of ``(name, labels, value)`` samples sharing one
        timestamp pair (a scrape cycle), flushing once at the end —
        either the whole batch is on disk after the flush or (on a crash
        mid-write) a torn trailing line readers skip."""
        if ts is None:
            ts = time.time()
        if mono is None:
            mono = time.monotonic()
        records = []
        for name, labels, value in samples:
            rec = {
                "ts": round(float(ts), 6),
                "mono": round(float(mono), 6),
                "boot": self.boot,
                "name": str(name),
                "labels": {str(k): str(v) for k, v in (labels or {}).items()},
                "value": float(value),
            }
            self._fh.write(json.dumps(rec) + "\n")
            records.append(rec)
        self._fh.flush()
        if self._fh.tell() >= self.segment_bytes:
            self._rotate()
        return records

    def _rotate(self) -> None:
        """Finalize the active segment (fsync — rotation is the atomic
        durability point) and open the next sequence number."""
        os.fsync(self._fh.fileno())
        self._fh.close()
        self._seq += 1
        self._fh = open(segment_path(self.root, self._seq), "a")

    def enforce_retention(self, *, now: "float | None" = None) -> list[str]:
        """Drop the oldest finalized segments beyond the age/size bounds;
        returns the deleted paths. The active segment always survives,
        so retention can never tear the append path out from under the
        writer."""
        if now is None:
            now = time.time()
        deleted: list[str] = []
        segments = list_segments(self.root)
        active = segment_path(self.root, self._seq)
        finalized = [p for p in segments if p != active]
        if self.retention_s is not None:
            for path in list(finalized):
                bounds = _segment_bounds(path)
                if bounds is None or bounds[1] < now - self.retention_s:
                    os.remove(path)
                    finalized.remove(path)
                    deleted.append(path)
        if self.retention_bytes is not None:
            sizes = {p: os.path.getsize(p) for p in finalized}
            total = sum(sizes.values()) + (
                os.path.getsize(active) if os.path.exists(active) else 0
            )
            for path in list(finalized):  # oldest first
                if total <= self.retention_bytes:
                    break
                total -= sizes[path]
                os.remove(path)
                deleted.append(path)
        return deleted

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()

    def __enter__(self) -> "HistoryStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


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


def list_series(root: str) -> "list[tuple[str, tuple]]":
    """Every distinct series in the store (sorted) — the CLI's
    discovery surface."""
    return sorted(series_keys(read_samples(root)))


def _aggregate(values: list[float], agg: str) -> float:
    if agg == "avg":
        return sum(values) / len(values)
    if agg == "sum":
        return sum(values)
    if agg == "min":
        return min(values)
    if agg == "max":
        return max(values)
    if agg == "last":
        return values[-1]
    if agg == "count":
        return float(len(values))
    raise ValueError(f"unknown agg {agg!r}; expected one of {AGGS}")


def range_query(
    root: str,
    name: str,
    *,
    labels: "dict | None" = None,
    start: "float | None" = None,
    end: "float | None" = None,
    step: "float | None" = None,
    agg: str = "avg",
) -> "dict[tuple, list[tuple[float, float]]]":
    """``(ts, value)`` points per matching series, time-ordered.

    With ``step``, points are downsampled into **step-aligned** buckets
    (bucket timestamp = ``floor(ts/step)·step``) under ``agg``; without,
    raw points. Conservation contract: ``agg='sum'`` buckets of a series
    sum to exactly the raw samples' sum over the same range."""
    if agg not in AGGS:
        raise ValueError(f"unknown agg {agg!r}; expected one of {AGGS}")
    grouped = series_keys(
        read_samples(root, name=name, labels=labels, start=start, end=end)
    )
    out: dict[tuple, list[tuple[float, float]]] = {}
    for key, recs in grouped.items():
        recs.sort(key=lambda r: (float(r["ts"])))
        if step is None or step <= 0:
            out[key[1]] = [(float(r["ts"]), float(r["value"])) for r in recs]
            continue
        buckets: dict[float, list[float]] = {}
        for r in recs:
            b = float(r["ts"]) // step * step
            buckets.setdefault(b, []).append(float(r["value"]))
        out[key[1]] = [
            (b, _aggregate(vs, agg)) for b, vs in sorted(buckets.items())
        ]
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


def _window_values(
    root: str,
    name: str,
    labels: "dict | None",
    window_s: float,
    at: "float | None",
) -> "dict[tuple, list[float]]":
    if at is None:
        at = time.time()
    grouped = series_keys(
        read_samples(
            root, name=name, labels=labels, start=at - window_s, end=at
        )
    )
    return {
        key[1]: [
            float(r["value"])
            for r in sorted(recs, key=lambda r: float(r["ts"]))
        ]
        for key, recs in grouped.items()
    }


def quantile_over_time(
    root: str,
    name: str,
    q: float,
    *,
    labels: "dict | None" = None,
    window_s: float = 300.0,
    at: "float | None" = None,
) -> "dict[tuple, float | None]":
    """The ``q``-quantile (0..1, linear interpolation) of each matching
    series' samples over the window; ``None`` for an empty window."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    out: dict[tuple, float | None] = {}
    for key, values in _window_values(root, name, labels, window_s, at).items():
        if not values:
            out[key] = None
            continue
        vs = sorted(values)
        pos = q * (len(vs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(vs) - 1)
        out[key] = vs[lo] + (vs[hi] - vs[lo]) * (pos - lo)
    return out


def avg_over_time(
    root: str,
    name: str,
    *,
    labels: "dict | None" = None,
    window_s: float = 300.0,
    at: "float | None" = None,
) -> "dict[tuple, float | None]":
    """Windowed mean per matching series (the burn-rate SLO primitive)."""
    return {
        key: (sum(vs) / len(vs) if vs else None)
        for key, vs in _window_values(root, name, labels, window_s, at).items()
    }


def last_over_time(
    root: str,
    name: str,
    *,
    labels: "dict | None" = None,
    window_s: float = 300.0,
    at: "float | None" = None,
) -> "dict[tuple, float | None]":
    """The newest sample value per matching series over the window —
    the fleet-index primitive for monotone per-instance gauges/counters
    (``serve_incidents_total{instance=...}``: the latest scrape IS the
    current count; averaging or summing a cumulative count would lie)."""
    return {
        key: (vs[-1] if vs else None)
        for key, vs in _window_values(root, name, labels, window_s, at).items()
    }


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

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values, width: "int | None" = None) -> str:
    """ASCII(-ish) trend glyphs for a value sequence; ``None`` gaps
    render as spaces. With ``width``, the newest ``width`` points."""
    vs = list(values)
    if width is not None and len(vs) > width:
        vs = vs[-width:]
    present = [v for v in vs if v is not None]
    if not present:
        return ""
    lo, hi = min(present), max(present)
    span = hi - lo
    chars = []
    for v in vs:
        if v is None:
            chars.append(" ")
        elif span <= 0:
            chars.append(_SPARK[0])
        else:
            idx = int((v - lo) / span * (len(_SPARK) - 1))
            chars.append(_SPARK[idx])
    return "".join(chars)


def _fmt_key(key: tuple) -> str:
    return (
        "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}" if key else "{}"
    )


# -- CLI ---------------------------------------------------------------------


def _parse_labels(specs) -> dict:
    labels = {}
    for spec in specs or ():
        k, sep, v = spec.partition("=")
        if not sep:
            raise SystemExit(f"history: bad --label {spec!r} (want k=v)")
        labels[k] = v
    return labels


def main(argv=None) -> int:
    """``history``: query a time-series store from the shell."""
    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch history",
        description=(
            "Query a history store (telemetry.history): range/rate/"
            "quantile over any stored series, per-tenant hotness "
            "ranking, JSON or sparkline output."
        ),
    )
    ap.add_argument(
        "query",
        choices=("range", "rate", "quantile", "top-tenants", "series"),
    )
    ap.add_argument("store", help="history store directory")
    ap.add_argument("name", nargs="?", help="series name (not for top-tenants)")
    ap.add_argument(
        "--label",
        action="append",
        default=[],
        metavar="K=V",
        help="label selector (subset match), repeatable",
    )
    ap.add_argument(
        "--window", type=float, default=300.0, metavar="S",
        help="look-back window in seconds (default 300)",
    )
    ap.add_argument(
        "--at", type=float, default=None, metavar="TS",
        help="window end as unix seconds (default: now)",
    )
    ap.add_argument(
        "--step", type=float, default=None, metavar="S",
        help="range: step-aligned downsampling bucket width",
    )
    ap.add_argument(
        "--agg", choices=AGGS, default="avg",
        help="range downsampling aggregate (default avg)",
    )
    ap.add_argument("--q", type=float, default=0.99, help="quantile (0..1)")
    ap.add_argument("--limit", type=int, default=None, metavar="N")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if not list_segments(args.store):
        print(f"history: no store at {args.store}", file=sys.stderr)
        return 4
    if args.query in ("range", "rate", "quantile") and not args.name:
        ap.error(f"{args.query} needs a series name")
    labels = _parse_labels(args.label)
    at = args.at if args.at is not None else time.time()

    if args.query == "series":
        keys = list_series(args.store)
        if args.json:
            print(json.dumps([[n, list(k)] for n, k in keys], indent=1))
        else:
            for n, k in keys:
                print(f"{n}{_fmt_key(k)}")
        return 0

    if args.query == "top-tenants":
        ranked = top_tenants(
            args.store, window_s=args.window, at=at, limit=args.limit
        )
        if args.json:
            print(json.dumps(ranked, indent=1))
        else:
            print(f"{'TENANT':<8} {'ROWS/S':>12} {'ADAPT/S':>10}")
            for r in ranked:
                print(
                    f"{r['tenant']:<8} {r['rows_per_sec']:>12,.1f} "
                    f"{r['adaptations_per_sec']:>10.4f}"
                )
        if not ranked:
            print("history: no tenant series in window", file=sys.stderr)
            return 3
        return 0

    if args.query == "range":
        series = range_query(
            args.store,
            args.name,
            labels=labels,
            start=at - args.window,
            end=at,
            step=args.step,
            agg=args.agg,
        )
        if args.json:
            print(
                json.dumps(
                    {
                        _fmt_key(k): [[t, v] for t, v in pts]
                        for k, pts in sorted(series.items())
                    },
                    indent=1,
                )
            )
        else:
            for k, pts in sorted(series.items()):
                vals = [v for _, v in pts]
                spark = sparkline(vals, width=60)
                tail = f" last={vals[-1]:g}" if vals else ""
                print(f"{args.name}{_fmt_key(k)} [{spark}]{tail}")
        return 0 if series else 3

    if args.query == "rate":
        rates = rate(
            args.store, args.name, labels=labels, window_s=args.window, at=at
        )
    else:  # quantile
        rates = quantile_over_time(
            args.store,
            args.name,
            args.q,
            labels=labels,
            window_s=args.window,
            at=at,
        )
    if args.json:
        print(
            json.dumps(
                {_fmt_key(k): v for k, v in sorted(rates.items())}, indent=1
            )
        )
    else:
        for k, v in sorted(rates.items()):
            print(
                f"{args.name}{_fmt_key(k)} "
                f"{'-' if v is None else f'{v:,.4f}'}"
            )
    return 0 if any(v is not None for v in rates.values()) else 3


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
