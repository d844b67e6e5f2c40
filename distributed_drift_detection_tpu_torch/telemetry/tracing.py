"""Causal end-to-end tracing: trace-context propagation + span events.

The port's own copy of the JAX package's ``telemetry/tracing.py``, with
the same span fields.

The ops plane (telemetry.trace) answers *how slow* in aggregate; this
module answers *why this row*: a head-sampled row entering the serving
ingress carries a **trace context** — ``(trace_id, span_id)`` — through
admission, microbatching, the kernel dispatch and verdict publication,
and every stage attaches a child ``span`` event (schema v1) to the run
log, so a sidecar verdict joins back to its originating ingress packet.
The ``timeline`` CLI (telemetry.timeline) merges one or many run logs'
spans into a single Chrome-trace/Perfetto artifact.

Design rules:

* **Head-based sampling, zero hot-path work at rate 0.** The sampling
  decision is made once, at the head of the pipeline (the load
  generator stamping the wire, or the ingress sampling unstamped rows);
  everything downstream only acts on rows that already carry a context.
  A :class:`HeadSampler` at rate 0 is *falsy*, and every call site
  guards with ``if sampler:`` — the disabled path executes no tracing
  code, allocates nothing, and reads no clock.
* **Wire format.** A ``TRACE <trace_id> <span_id>`` protocol line marks
  the **next** data row on the connection as sampled (see
  ``serve.ingress``); ids are opaque lowercase-hex tokens (W3C
  traceparent widths: 32-hex trace, 16-hex span).
* **Spans are events.** One schema-v1 ``span`` event per span, emitted
  host-side strictly outside the device loop and outside any reference-
  parity Final Time span. Monotonic pipeline stamps are rebased to
  wall-clock at emit (:func:`wall_of`), so cross-process merge uses the
  same clock-skew alignment as ``correlate``.

The serving pipeline's per-row span chain (:func:`emit_row_spans`)::

    ingress (client root, loadgen's log)
     └─ serve (daemon)
         ├─ admission   ingest stamp → microbatch sealed
         ├─ batch       sealed → handed to the device feed
         ├─ kernel      fed → flags collected host-side
         └─ verdict     collected → verdict line flushed

No jax; numpy + stdlib only (safe in ingress handler threads and
jax-free CLIs).
"""

from __future__ import annotations

import random
import threading
import time

# Wire directive marking the NEXT data row on a connection as sampled.
TRACE_DIRECTIVE = "TRACE"

# The per-row serving span chain, pipeline order (docs + tests pin this).
ROW_STAGES = ("admission", "batch", "kernel", "verdict")

_ID_ALPHABET = "0123456789abcdef"
_MAX_ID_LEN = 64  # wire-side sanity bound for untrusted client ids


def _hex_token(rng: "random.Random | None", nhex: int) -> str:
    r = rng if rng is not None else random
    return "".join(r.choice(_ID_ALPHABET) for _ in range(nhex))


def new_trace_id(rng: "random.Random | None" = None) -> str:
    """A fresh 128-bit trace id (32 lowercase hex chars)."""
    return _hex_token(rng, 32)


def new_span_id(rng: "random.Random | None" = None) -> str:
    """A fresh 64-bit span id (16 lowercase hex chars)."""
    return _hex_token(rng, 16)


def check_trace_token(token: str) -> str:
    """Validate an untrusted wire-side id token (lowercase hex, bounded
    length). Raises ``ValueError`` — the ingress turns that into an
    ``ERR`` + connection drop, exactly like a malformed TENANT id."""
    if not token or len(token) > _MAX_ID_LEN:
        raise ValueError(f"trace id token length {len(token)} not in 1..64")
    if any(c not in _ID_ALPHABET for c in token):
        raise ValueError(f"trace id token {token!r:.80} is not lowercase hex")
    return token


def wall_of(mono: float, *, anchor: "tuple[float, float] | None" = None) -> float:
    """Rebase a ``time.monotonic()`` stamp onto the wall clock.

    ``anchor`` is an optional ``(wall_now, mono_now)`` pair so one batch
    of conversions shares a single clock read (sub-ms consistency across
    the spans of one chunk)."""
    if anchor is None:
        anchor = (time.time(), time.monotonic())
    wall_now, mono_now = anchor
    return wall_now - (mono_now - mono)


class HeadSampler:
    """Seeded head-sampling decision maker.

    ``rate`` is clamped to [0, 1]. At rate 0 the instance is **falsy**
    and callers skip all tracing work (``if sampler:``) — the zero-cost
    contract. Thread-safe: ingress handler threads share one instance.
    """

    def __init__(self, rate: float, seed: "int | None" = None):
        self.rate = min(max(float(rate), 0.0), 1.0)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def __bool__(self) -> bool:
        return self.rate > 0.0

    def sample(self) -> bool:
        """One head decision."""
        if self.rate <= 0.0:
            return False
        if self.rate >= 1.0:
            return True
        with self._lock:
            return self._rng.random() < self.rate

    def sample_block(self, n: int) -> "list[int]":
        """Indices of the sampled rows in a block of ``n`` (vector form of
        :meth:`sample` — one lock acquisition per ingress block)."""
        if self.rate <= 0.0 or n <= 0:
            return []
        if self.rate >= 1.0:
            return list(range(n))
        with self._lock:
            rnd = self._rng.random
            return [i for i in range(n) if rnd() < self.rate]

    def new_context(self) -> "tuple[str, str]":
        """A fresh root ``(trace_id, span_id)`` pair (daemon-side sampling
        of unstamped rows)."""
        with self._lock:
            return new_trace_id(self._rng), new_span_id(self._rng)


def emit_span(
    log,
    *,
    name: str,
    trace_id: str,
    span_id: "str | None" = None,
    parent_id: "str | None" = None,
    start_ts: float,
    dur_s: float,
    **extra,
) -> dict:
    """Emit one schema-v1 ``span`` event; returns the record (its
    ``span_id`` is generated when not given)."""
    return log.emit(
        "span",
        name=name,
        trace_id=trace_id,
        span_id=span_id or new_span_id(),
        parent_id=parent_id,
        start_ts=float(start_ts),
        dur_s=max(float(dur_s), 0.0),
        **extra,
    )


def emit_row_spans(
    log,
    meta: dict,
    *,
    collected_mono: float,
    published_mono: float,
) -> "list[str]":
    """Emit the serving span chain for every traced row of one published
    microbatch; returns the trace ids covered (the verdict record's
    ``traces`` field and the /statusz counter both come from this).

    ``meta`` is the sealed chunk's accounting dict: the admission layer
    stamps ``traces`` (``[{"idx", "trace_id", "parent_id", "tenant"?},
    ...]`` — ``idx`` indexes the per-row ``ingest_mono`` array) and
    ``sealed_mono``; the serve loop supplies ``fed_mono`` plus the two
    publication stamps. All stamps are monotonic; one shared anchor
    rebases them to wall-clock.
    """
    traces = meta.get("traces") or ()
    if not traces:
        return []
    anchor = (time.time(), time.monotonic())
    ingest_arr = meta.get("ingest_mono")
    sealed = float(meta.get("sealed_mono", collected_mono))
    fed = float(meta.get("fed_mono", sealed))
    out = []
    for t in traces:
        idx = int(t["idx"])
        ingest = (
            float(ingest_arr[idx])
            if ingest_arr is not None and idx < len(ingest_arr)
            else sealed
        )
        common = {"chunk": meta.get("chunk"), "row": idx}
        if "tenant" in t:
            common["tenant"] = t["tenant"]
        serve_span = emit_span(
            log,
            name="serve",
            trace_id=t["trace_id"],
            parent_id=t.get("parent_id"),
            start_ts=wall_of(ingest, anchor=anchor),
            dur_s=published_mono - ingest,
            **common,
        )
        bounds = {
            "admission": (ingest, sealed),
            "batch": (sealed, fed),
            "kernel": (fed, collected_mono),
            "verdict": (collected_mono, published_mono),
        }
        for stage in ROW_STAGES:
            lo, hi = bounds[stage]
            emit_span(
                log,
                name=stage,
                trace_id=t["trace_id"],
                parent_id=serve_span["span_id"],
                start_ts=wall_of(lo, anchor=anchor),
                dur_s=hi - lo,
                **common,
            )
        out.append(t["trace_id"])
    return out


class ChunkTracer:
    """Head-sampled per-chunk span emitter for the batch/streaming
    pipeline (``io.feeder`` ingest stages + ``engine.chunked`` kernel
    feeds share one instance, so one chunk's spans share one trace).

    Each sampled chunk gets its OWN trace id — one traced unit of work
    per chunk, exactly like the serving side's one-trace-per-row — so
    the ``timeline`` CLI lays chunks out on separate lanes and the
    pipelined overlap (chunk k+1's ingest against chunk k's kernel) is
    visible instead of colliding on one thread row. The sampling
    decision is memoized per chunk index — the ingest span and the
    kernel span of chunk *k* are sampled (or not) together. A ``None``
    log or rate 0 makes the tracer falsy; every call site guards with
    ``if tracer:``.
    """

    def __init__(
        self,
        log,
        rate: float = 1.0,
        seed: "int | None" = None,
    ):
        self.log = log
        self.sampler = HeadSampler(rate, seed)
        self._rng = random.Random(seed) if seed is not None else None
        self._decisions: dict[int, bool] = {}
        self._trace_ids: dict[int, str] = {}
        self._roots: dict[int, str] = {}

    def __bool__(self) -> bool:
        return self.log is not None and bool(self.sampler)

    def sampled(self, chunk: int) -> bool:
        """Stable per-chunk head decision."""
        if not self:
            return False
        got = self._decisions.get(chunk)
        if got is None:
            got = self._decisions[chunk] = self.sampler.sample()
        return got

    def span(
        self,
        name: str,
        chunk: int,
        start_mono: float,
        end_mono: float,
        **extra,
    ) -> "str | None":
        """Emit one per-chunk stage span (sampled chunks only); the first
        span of a chunk becomes the parent of its later stages. Returns
        the emitted span id, or ``None`` when the chunk is unsampled."""
        if not self.sampled(chunk):
            return None
        trace_id = self._trace_ids.get(chunk)
        if trace_id is None:
            trace_id = self._trace_ids[chunk] = new_trace_id(self._rng)
        rec = emit_span(
            self.log,
            name=name,
            trace_id=trace_id,
            parent_id=self._roots.get(chunk),
            start_ts=wall_of(start_mono),
            dur_s=end_mono - start_mono,
            chunk=chunk,
            **extra,
        )
        self._roots.setdefault(chunk, rec["span_id"])
        return rec["span_id"]
