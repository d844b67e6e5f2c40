"""End-to-end row tracing for the serving path.

The port's own copy of the JAX package's ``telemetry/trace.py``.

The batch pipeline measures itself with phase spans; a serving daemon
needs *per-row latency attribution* — where did the time between a row
arriving at the ingress and its verdict landing actually go? This module
is the shared vocabulary for that: one live histogram,

    ``serve_row_latency_seconds{stage=...}``

fed by the serve loop as each microbatch publishes, with the pipeline
stages as labels:

* ``admission`` — per **row**: monotonic ingest stamp (taken when the
  admission layer pushed the row into the :class:`~..serve.admission.
  MicroBatcher`) → the microbatch sealing. How long rows waited for the
  grid to fill (bounded by the linger deadline).
* ``queue`` — per chunk: sealed → handed to the device feed (queue wait
  behind the double-buffered pipeline + host→device placement dispatch).
* ``device`` — per chunk: fed → flags collected host-side (device
  compute + the d2h sync).
* ``collect`` — per chunk: collected → verdict line flushed to the
  sidecar (host flag scan + the publication write).
* ``total`` — per **row**: ingest → verdict flushed. The end-to-end
  row→verdict latency; its live p50/p99 must agree with what ``loadgen``
  derives post-hoc from the verdict sidecar (pinned by tests within
  histogram-bucket tolerance).

Per-row stages are observed **vectorized** (:func:`observe_array` — one
``searchsorted`` + ``bincount`` per microbatch, identical semantics to N
``Histogram.observe`` calls), so tracing costs O(buckets) per chunk, not
O(rows) Python work. Quantiles come back out of the cumulative buckets
via :func:`hist_quantile` (live registry object) or
:func:`prom_histogram_quantile` (a parsed ``/metrics`` scrape) — linear
interpolation inside the bucket, Prometheus ``histogram_quantile``
semantics.

No jax; numpy only (safe in the ops/evaluator threads and jax-free CLIs).
"""

from __future__ import annotations

import numpy as np

from .metrics import DEFAULT_BUCKETS, Histogram, MetricsRegistry, _label_key

LATENCY_METRIC = "serve_row_latency_seconds"
LATENCY_HELP = (
    "Row-to-verdict latency of the serving pipeline by stage "
    "(admission/queue/device/collect per-chunk or per-row; total = "
    "ingest to published verdict per row)"
)

STAGES = ("admission", "queue", "device", "collect", "total")


def latency_histogram(registry: MetricsRegistry) -> Histogram:
    """The one serving-latency histogram (idempotent fetch)."""
    return registry.histogram(
        LATENCY_METRIC, help=LATENCY_HELP, buckets=DEFAULT_BUCKETS
    )


def observe_array(hist: Histogram, values, **labels) -> None:
    """Observe a whole array into one histogram label set, bit-identical
    to calling :meth:`~.metrics.Histogram.observe` per element (``value
    <= bucket`` boundary semantics) but O(buckets) Python work."""
    values = np.asarray(values, np.float64).ravel()
    if values.size == 0:
        return
    k = _label_key(labels)
    slot = hist.values.get(k)
    if slot is None:
        slot = hist.values[k] = [[0] * (len(hist.buckets) + 1), 0.0, 0]
    # side='left': first bucket b with value <= b — the observe() rule.
    idx = np.searchsorted(np.asarray(hist.buckets), values, side="left")
    counts = np.bincount(idx, minlength=len(hist.buckets) + 1)
    for i, c in enumerate(counts):
        if c:
            slot[0][i] += int(c)
    slot[1] += float(values.sum())
    slot[2] += int(values.size)


def observe_chunk_stages(
    hist: Histogram,
    meta: dict,
    *,
    fed_mono: float,
    collected_mono: float,
    published_mono: float,
) -> None:
    """Attribute one published microbatch across the pipeline stages.

    ``meta`` is the sealed chunk's accounting dict; the admission layer
    stamps ``ingest_mono`` (per-admitted-row monotonic array) and
    ``sealed_mono`` into it, the serve loop supplies the rest. Negative
    deltas (sub-poll clock granularity) clamp to zero."""
    sealed = float(meta.get("sealed_mono", fed_mono))
    ingest = meta.get("ingest_mono")
    if ingest is not None and len(ingest):
        ingest = np.asarray(ingest, np.float64)
        observe_array(hist, np.maximum(sealed - ingest, 0.0), stage="admission")
        observe_array(
            hist, np.maximum(published_mono - ingest, 0.0), stage="total"
        )
    hist.observe(max(fed_mono - sealed, 0.0), stage="queue")
    hist.observe(max(collected_mono - fed_mono, 0.0), stage="device")
    hist.observe(max(published_mono - collected_mono, 0.0), stage="collect")


def _quantile_from_cumulative(
    pairs: list[tuple[float, float]], q: float
) -> "float | None":
    """Prometheus ``histogram_quantile`` over ``(upper_bound, cumulative
    count)`` pairs (``+Inf`` as ``math.inf``), linear interpolation inside
    the bucket; the overflow bucket reports its lower bound (nothing
    finite to interpolate toward)."""
    if not pairs:
        return None
    pairs = sorted(pairs)
    total = pairs[-1][1]
    if total <= 0:
        return None
    target = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in pairs:
        if cum >= target:
            if bound == float("inf"):
                return prev_bound
            width = bound - prev_bound
            in_bucket = cum - prev_cum
            if in_bucket <= 0 or width <= 0:
                return bound
            return prev_bound + width * (target - prev_cum) / in_bucket
        prev_bound, prev_cum = bound, cum
    return prev_bound


def hist_quantile(hist: Histogram, q: float, **labels) -> "float | None":
    """Quantile ``q`` (0..1) of one label set of a live histogram;
    ``None`` while it has no samples."""
    k = _label_key(labels)
    if k not in hist.values:
        return None
    pairs = [
        (float("inf") if le == "+Inf" else float(le), float(c))
        for le, c in hist.cumulative(k)
    ]
    return _quantile_from_cumulative(pairs, q)


def prom_histogram_quantile(
    samples: dict, name: str, q: float, **labels
) -> "float | None":
    """Quantile ``q`` from a :func:`~.metrics.parse_prometheus_text`
    sample map — the scrape-side counterpart of :func:`hist_quantile`
    (tests pin the two against each other)."""
    want = {(k, str(v)) for k, v in labels.items()}
    pairs = []
    for (sname, slabels), value in samples.items():
        if sname != name + "_bucket":
            continue
        lmap = dict(slabels)
        le = lmap.pop("le", None)
        if le is None or set(lmap.items()) != want:
            continue
        pairs.append(
            (float("inf") if le == "+Inf" else float(le), float(value))
        )
    return _quantile_from_cumulative(pairs, q)
