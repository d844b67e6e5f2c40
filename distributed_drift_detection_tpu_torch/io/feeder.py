"""Host-side chunk feeder for the streaming engine.

The port's copy of the JAX package's ``io/feeder.py``: a chunk-exact
generator (``io.synth``), an in-memory stream or a CSV on disk is cut into
fixed-shape ``[P, CB, B]`` chunks whose striping matches the batch API's
``stripe_partitions`` exactly, so chunked and one-shot runs see identical
per-partition streams. Everything here is numpy and threads: no CUDA call
is made in a producer thread — the chunked engine
(``engine.chunked.ChunkedDetector``) uploads chunk N+1 on a side stream
while chunk N runs on the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np

from ..engine.loop import Batches
from .stream import stripe_chunk


def _ingest_counters(metrics):
    """(rows, chunks) counters for a feed path; ``(None, None)`` without a
    registry — callers guard on None so the disabled path costs nothing."""
    if metrics is None:
        return None, None
    return (
        metrics.counter(
            "ingest_rows_total", help="Stream rows striped into chunks"
        ),
        metrics.counter(
            "ingest_chunks_total", help="Fixed-shape [P,CB,B] chunks emitted"
        ),
    )


def _quarantine_counter(metrics):
    """The quarantine counter, name/help shared with api.run through
    ``io.sanitize.QUARANTINE_METRIC`` (one constant, one series)."""
    from .sanitize import QUARANTINE_METRIC, QUARANTINE_METRIC_HELP

    return metrics.counter(QUARANTINE_METRIC, help=QUARANTINE_METRIC_HELP)


def chunk_stream_arrays(
    X: np.ndarray,
    y: np.ndarray,
    partitions: int,
    per_batch: int,
    chunk_batches: int,
    start_row: int = 0,
    shuffle_seed: int | None = None,
    feature_dtype=np.float32,
    metrics=None,
    row_valid: np.ndarray | None = None,
) -> Iterator[Batches]:
    """Chunk an in-memory stream; rows are global positions + start_row.

    ``feature_dtype`` is the transport dtype of the feature plane
    (``stripe_chunk``): ``"bfloat16"`` halves host→device bytes for
    transport-bound feeds, at the cost of bf16 feature rounding.
    ``metrics`` (a :class:`..telemetry.metrics.MetricsRegistry`) counts
    ``ingest_rows_total`` / ``ingest_chunks_total`` as the feed progresses.
    ``row_valid`` ([n] bool — a quarantine mask from ``io.sanitize``, or
    any caller mask) is sliced per chunk and folded into each chunk's
    validity plane (``stripe_chunk``), so the chunked engine sees masked
    rows as padding exactly like the one-shot path; the mask adds
    ``ingest_quarantined_total`` to the metric set.
    """
    n, f = X.shape
    p, b, cb = partitions, per_batch, chunk_batches
    c_rows, c_chunks = _ingest_counters(metrics)
    c_quar = None
    if metrics is not None and row_valid is not None:
        c_quar = _quarantine_counter(metrics)
    rows_per_chunk = p * b * cb
    for s in range(0, n, rows_per_chunk):
        e = min(s + rows_per_chunk, n)
        rv = None if row_valid is None else row_valid[s:e]
        if c_rows is not None:
            c_rows.inc(e - s)
            c_chunks.inc()
            if c_quar is not None:
                c_quar.inc(int((~np.asarray(rv, bool)).sum()))
        yield stripe_chunk(
            X[s:e], y[s:e], s + start_row, p, b, cb, shuffle_seed,
            feature_dtype=feature_dtype, row_valid=rv,
        )


def generator_chunks(
    chunk_fn: Callable[[int, int], tuple[np.ndarray, np.ndarray]],
    total_rows: int,
    partitions: int,
    per_batch: int,
    chunk_batches: int,
    shuffle_seed: int | None = None,
    feature_dtype=np.float32,
    metrics=None,
) -> Iterator[Batches]:
    """Chunks from a chunk-exact generator ``chunk_fn(start, stop) -> (X, y)``
    (e.g. ``functools.partial(sea_chunk, seed, drift_every=...)`` adapted to
    (start, stop)). Generates only one chunk of rows at a time — 1e9-row
    soaks never materialise the stream. ``metrics`` counts ingest progress
    (see :func:`chunk_stream_arrays`).
    """
    p, b, cb = partitions, per_batch, chunk_batches
    c_rows, c_chunks = _ingest_counters(metrics)
    rows_per_chunk = p * b * cb
    for s in range(0, total_rows, rows_per_chunk):
        e = min(s + rows_per_chunk, total_rows)
        X, y = chunk_fn(s, e)
        if c_rows is not None:
            c_rows.inc(e - s)
            c_chunks.inc()
        yield stripe_chunk(
            X, y, s, p, b, cb, shuffle_seed, feature_dtype=feature_dtype
        )


class _Stop:
    pass


def prefetch_chunks(chunks: Iterator, depth: int = 2, metrics=None) -> Iterator:
    """Run a chunk iterator in a background thread, ``depth`` chunks ahead.

    The chunked engine overlaps the card's compute with the upload of the
    next chunk — but the assembly itself (CSV parse, generator math,
    striping) would run serially with the feed loop's Python. This wrapper
    moves it to a producer thread with a bounded queue, so host
    construction of chunk N+k proceeds while the main thread is feeding
    chunk N. The producer runs numpy only; it makes no CUDA call.

    Exceptions in the producer propagate to the consumer. Abandoning the
    returned iterator (break / exception / GC) stops the producer thread
    promptly — its queue puts are timeout-guarded against a cancellation
    event that the consumer sets on close, so no chunks stay pinned.

    ``metrics`` (a :class:`..telemetry.metrics.MetricsRegistry`) records
    ``prefetch_chunks_total`` (delivered to the consumer) and the
    ``prefetch_queue_depth`` gauge sampled at each delivery — a depth
    pinned at 0 means the consumer is feed-bound, at ``depth`` means
    device-bound (the SURVEY §7 overlap question, answerable per run).
    """
    c_total = g_depth = None
    if metrics is not None:
        c_total = metrics.counter(
            "prefetch_chunks_total", help="Chunks delivered by the prefetcher"
        )
        g_depth = metrics.gauge(
            "prefetch_queue_depth", help="Prefetch queue depth at delivery"
        )
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in chunks:
                if not put(item):
                    return
            put(_Stop)
        except BaseException as e:  # propagate into the consumer
            put(e)

    threading.Thread(target=produce, daemon=True).start()

    def consume():
        try:
            while True:
                item = q.get()
                if item is _Stop:
                    return
                if isinstance(item, BaseException):
                    raise item
                if c_total is not None:
                    c_total.inc()
                    g_depth.set(q.qsize())
                yield item
        finally:
            stop.set()

    return consume()


#: Stage names of the host-ingest pipeline, in data-flow order. ``read``
#: (mmap block materialisation + page faults) and ``parse`` (native/tolerant
#: CSV → f32 matrix + contract scan) run in the worker pool; ``sanitize``
#: (policy application, sidecar writes, running repair stats) and ``stripe``
#: (span assembly → [P, CB, B] grid) run sequentially in the consumer —
#: determinism lives there; ``upload`` is accounted by the chunk engine
#: (``ChunkedDetector.run``) around its place/feed calls.
PIPELINE_STAGES = ("read", "parse", "sanitize", "stripe", "upload")

STAGE_BUSY_METRIC = "ingest_stage_busy_seconds_total"
STAGE_BUSY_HELP = (
    "Cumulative busy seconds per host-ingest pipeline stage (parallel "
    "stages sum across workers, so read/parse can exceed wall-clock)"
)


class StageClock:
    """Per-stage busy-seconds accounting for the ingest pipeline.

    Accumulates locally (``.busy``) and, when a
    metrics registry is given, mirrors into the
    ``ingest_stage_busy_seconds_total{stage=...}`` counter. Single-writer:
    workers *return* their timings and the sequential consumer folds them
    in, so the registry never sees concurrent writes.
    """

    def __init__(self, metrics=None):
        self.busy: dict[str, float] = {}
        self._c = (
            metrics.counter(STAGE_BUSY_METRIC, help=STAGE_BUSY_HELP)
            if metrics is not None
            else None
        )

    def add(self, stage: str, seconds: float) -> None:
        if seconds < 0:  # clock skew paranoia; counters reject negatives
            return
        self.busy[stage] = self.busy.get(stage, 0.0) + seconds
        if self._c is not None:
            self._c.inc(seconds, stage=stage)


def stage_breakdown(metrics, ndigits: int = 4) -> dict[str, float]:
    """The per-stage busy-seconds map a registry accumulated
    (``STAGE_BUSY_METRIC`` samples → ``{stage: seconds}``) — the ONE
    extraction the ``chunked`` CLI's summary
    reads."""
    c = metrics.counter(STAGE_BUSY_METRIC)
    return {
        dict(key)["stage"]: round(v, ndigits)
        for key, v in sorted(c.values.items())
    }


def resolve_ingest_workers(workers: int | None) -> int:
    """0/None = auto: one parse worker per core up to 4 — past that the
    native parser saturates host memory bandwidth and extra threads only
    steal cycles from the stripe/feed stages (the JAX package's
    measurement). Explicit values pass through (min 1)."""
    if workers is None or int(workers) <= 0:
        import os

        return max(1, min(4, os.cpu_count() or 1))
    return int(workers)


def csv_chunks(
    path: str,
    partitions: int,
    per_batch: int,
    chunk_batches: int,
    *,
    target_column: str = "target",
    shuffle_seed: int | None = None,
    block_bytes: int = 16 << 20,
    feature_dtype=np.float32,
    metrics=None,
    data_policy: str | None = None,
    quarantine_path: str | None = None,
    workers: int = 1,
    num_classes: int | None = None,
    tracer=None,
) -> Iterator[Batches]:
    """Stream a CSV file from disk as striped chunks, without materialising it.

    The one-shot path (``io.stream.load_csv``) parses the whole file — right
    for the reference's scale, impossible for multi-hundred-GB streams. This
    reader consumes the file as line-aligned byte blocks over an ``mmap``
    (``io.blocks.line_block_ranges`` — ONE boundary rule for every worker
    count), parses each with the native multithreaded parser
    (``io.native.parse_block``; NumPy fallback), and yields the same
    ``[P, CB, B]`` chunks as :func:`chunk_stream_arrays` — host memory stays
    O(workers · block + chunk) regardless of file size. Compose with
    :func:`prefetch_chunks` to overlap the whole assembly with device
    compute.

    ``workers`` (0 = auto, :func:`resolve_ingest_workers`) is the parse
    fan-out: blocks are submitted to a thread pool in file order and the
    results consumed **in submission order**, so any worker count yields
    bit-identical chunks, flags, and sidecar contents to ``workers=1``
    (``tests/test_torch_chunked.py``). The pipeline stages:
    read+parse+scan run per block in the pool (the native parser releases
    the GIL, so the fan-out is real parallelism); policy application
    (ordered sidecar writes, running repair statistics) and striping
    (:class:`~.stream.ChunkStriper`, pooled staging buffers) stay
    sequential in the consumer — determinism lives there; in-flight depth
    is bounded at ``workers + 2`` blocks.

    Labels are not re-indexed — for class labels outside ``0..C-1``, remap
    before modelling (the one-shot loader's re-indexing needs a full pass,
    which a stream cannot afford by design). They parse through float32
    (exact for integers up to 2^24); larger label ids raise rather than
    silently round.

    ``metrics`` counts ``ingest_rows_total`` / ``ingest_chunks_total`` /
    ``ingest_bytes_total`` plus the pipeline gauges:
    ``ingest_stage_busy_seconds_total{stage=read|parse|sanitize|stripe}``
    (busy seconds; parallel stages sum across workers),
    ``ingest_parse_queue_depth`` (parsed-but-unconsumed blocks, sampled
    per consumed block — pinned at 0 means the pool is starving the
    consumer, near ``workers + 2`` means parse outruns the
    sanitize/stripe stages), and ``ingest_workers``.

    ``data_policy`` (None = trusting parse, the exact historical
    behaviour) applies the stream contract per block (``io.sanitize``):
    ``'strict'`` raises a structured ``StreamContractError`` naming
    file/row/column on the first violation (in row order, any worker
    count); ``'quarantine'`` masks violating rows into each chunk's
    validity plane (padding-identical inside jit), appends them to the
    ``quarantine_path`` sidecar, and counts ``ingest_quarantined_total``;
    ``'repair'`` imputes non-finite feature cells from **running** column
    means over the rows admitted so far (``io.sanitize.RunningColumnStats``
    / ``repair_rows`` — the serve-admission semantics), quarantining what
    it cannot fix. Streaming repair deliberately differs from the one-shot
    loader's repair, which imputes from *whole-file* means: a single-pass
    stream only has its past, so early blocks impute from less evidence
    (before any, the canonical 0.0 fill) — same rows repaired, possibly
    different imputed values; use ``io.sanitize.load_csv_sane`` when
    whole-file means matter.

    ``num_classes`` is repair's label-domain guard (serve admission's
    clause): the one-shot loader can round a non-integral label and
    re-index afterwards, but a stream never re-indexes — so a label that
    repair would round **out of the engine's ``0..C-1`` index domain**
    must be quarantined, never admitted. Pass the model's class count
    (the ``chunked`` CLI's ``--classes`` does) to allow in-domain
    rounding; with the default ``None`` the domain is unknown and
    non-integral labels are conservatively quarantined rather than
    rounded (the only repair semantics that can never hand the engine a
    fabricated out-of-range class index). Other policies never consult
    it — labels are not re-indexed or domain-checked on the trusting/
    strict/quarantine paths, exactly as before.

    ``tracer`` (a :class:`..telemetry.tracing.ChunkTracer`) emits one
    ``ingest`` span per head-sampled chunk — the host-assembly wall
    (read/parse/sanitize/stripe) that produced it, the ingest twin of
    the engine's ``kernel`` span (share one tracer instance and the two
    stages of one chunk share a trace). Falsy tracers cost one check
    per chunk.
    """
    workers = resolve_ingest_workers(workers)
    if data_policy is not None:
        from . import sanitize as _s

        _s.check_policy(data_policy)
    return _csv_chunk_pipeline(
        path, partitions, per_batch, chunk_batches, target_column,
        shuffle_seed, block_bytes, feature_dtype, metrics, data_policy,
        quarantine_path, workers, num_classes, tracer,
    )


def _csv_chunk_pipeline(
    path, partitions, per_batch, chunk_batches, target_column, shuffle_seed,
    block_bytes, feature_dtype, metrics, data_policy, quarantine_path, workers,
    num_classes, tracer=None,
) -> Iterator[Batches]:
    """Generator body of :func:`csv_chunks` (split out so argument
    validation happens at call time, not first ``next()``)."""
    import time

    from .blocks import line_block_ranges, open_mapped
    from .native import parse_block
    from .stream import ChunkStriper

    p, b, cb = partitions, per_batch, chunk_batches
    c_rows, c_chunks = _ingest_counters(metrics)
    c_bytes = g_depth = None
    if metrics is not None:
        c_bytes = metrics.counter("ingest_bytes_total", help="CSV bytes parsed")
        g_depth = metrics.gauge(
            "ingest_parse_queue_depth",
            help="Parsed-but-unconsumed blocks at each consumed block "
            "(0 = parse-bound, near workers+2 = consumer-bound)",
        )
        metrics.gauge(
            "ingest_workers", help="Configured ingest parse workers"
        ).set(workers)
    clock = StageClock(metrics)
    c_quar = None
    sanitize = None
    writer = None
    run_stats = None
    if data_policy is not None:
        from . import sanitize

        if data_policy in ("quarantine", "repair"):
            # repair quarantines what it cannot fix, like the whole-file
            # path — both policies own a sidecar.
            writer = sanitize.QuarantineWriter(
                quarantine_path or (path + ".quarantine.jsonl"), data_policy
            )
            if metrics is not None:
                c_quar = _quarantine_counter(metrics)
    rows_per_chunk = p * b * cb

    fh, buf, data_start = open_mapped(path)
    ex = None
    try:
        header = bytes(buf[:data_start]).decode().strip().split(",")
        if sanitize is not None:
            tcol = sanitize.validate_header(header, target_column, path)
        elif target_column not in header:
            raise ValueError(
                f"{path}: target column {target_column!r} not in header; "
                f"columns found: {header}"
            )
        else:
            tcol = header.index(target_column)
        cols = len(header)
        mask = np.ones(cols, bool)
        mask[tcol] = False
        if data_policy == "repair":
            run_stats = sanitize.RunningColumnStats(cols)
        ranges = line_block_ranges(buf, data_start, block_bytes)

        def parse_job(lo: int, hi: int):
            """Worker-side stage: materialise + parse + contract-scan one
            block. Pure w.r.t. pipeline state — safe at any fan-out; all
            ordering-sensitive work stays in the consumer below."""
            t0 = time.perf_counter()
            block = buf[lo:hi]  # the read stage: copy-out + page faults
            t1 = time.perf_counter()
            if sanitize is None:
                arr, issues = parse_block(block, cols), []
            else:
                try:
                    arr, issues = parse_block(block, cols), []
                except ValueError:
                    lines = block.decode(errors="replace").splitlines()
                    arr, issues = sanitize.parse_rows(lines, cols)
                issues = issues + sanitize.scan_matrix(
                    arr, tcol, header,
                    flagged=frozenset(i.row for i in issues),
                )
            return arr, issues, (t1 - t0, time.perf_counter() - t1), hi - lo

        def results():
            """Ordered fan-out: results arrive in submission order no
            matter which worker finishes first."""
            if workers <= 1:
                for lo, hi in ranges:
                    yield parse_job(lo, hi)
                return
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            nonlocal ex
            ex = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="ddd-ingest"
            )
            depth = workers + 2  # bounded in-flight blocks
            inflight: deque = deque()
            nxt = 0
            while nxt < len(ranges) and len(inflight) < depth:
                inflight.append(ex.submit(parse_job, *ranges[nxt]))
                nxt += 1
            while inflight:
                fut = inflight.popleft()
                if nxt < len(ranges):
                    inflight.append(ex.submit(parse_job, *ranges[nxt]))
                    nxt += 1
                if g_depth is not None:
                    # READY backlog, not occupancy (occupancy is pinned at
                    # the bound by construction): parsed-but-unconsumed
                    # blocks — 0 = the pool is starving the consumer
                    # (parse-bound), near the bound = parse outruns the
                    # sanitize/stripe stages.
                    g_depth.set(sum(f.done() for f in inflight))
                yield fut.result()

        rows_parsed = 0  # absolute data-row index for sidecar records
        rows_valid = 0  # contract-passing rows seen (all-dirty guard)
        striper = ChunkStriper(p, b, cb, shuffle_seed, feature_dtype)
        parts: list[np.ndarray] = []
        ok_parts: list["np.ndarray | None"] = []
        buffered = 0
        start_row = 0
        chunk_idx = 0  # emitted chunks (the tracer's span key)
        t_chunk_mono = time.monotonic()  # assembly start of the next chunk

        def emit(start, n_take):
            data = np.concatenate(parts) if len(parts) > 1 else parts[0]
            take, rest = data[:n_take], data[n_take:]
            ok = None
            ok_rest = None
            if any(o is not None for o in ok_parts):
                ok_all = np.concatenate(
                    [
                        np.ones(len(a), bool) if o is None else o
                        for a, o in zip(parts, ok_parts)
                    ]
                )
                ok, ok_rest = ok_all[:n_take], ok_all[n_take:]
                if ok.all():
                    ok = None
                if ok_rest is not None and not len(ok_rest):
                    ok_rest = None
            labels = take[:, tcol]
            valid_labels = labels if ok is None else labels[ok]
            if valid_labels.size and np.abs(valid_labels).max() >= 2**24:
                raise ValueError(
                    "label ids at or above 2^24 are not exactly representable "
                    "on the float32 parse path; re-encode the target column"
                )
            chunk = striper.stripe(
                take[:, mask], labels.astype(np.int32), start, row_valid=ok
            )
            if c_rows is not None:
                c_rows.inc(len(take))
                c_chunks.inc()
            return chunk, rest, ok_rest

        for arr, issues, (read_s, parse_s), nbytes in results():
            clock.add("read", read_s)
            clock.add("parse", parse_s)
            if c_bytes is not None:
                c_bytes.inc(nbytes)
            t0 = time.perf_counter()
            ok = None
            if sanitize is not None:
                base = rows_parsed
                if data_policy == "repair" and issues:
                    # Streaming repair: impute from the running means over
                    # rows admitted in PRIOR blocks (serve-admission
                    # semantics — the whole-file loader uses full-column
                    # means instead; see the csv_chunks docstring). The
                    # label-domain guard runs first: rounding must never
                    # fabricate a class index outside 0..num_classes-1
                    # (or any rounded label at all when the domain is
                    # unknown) on a path that never re-indexes.
                    issues = sanitize.demote_unroundable_labels(
                        issues, arr, tcol, num_classes
                    )
                    arr, issues, _ = sanitize.repair_rows(
                        arr, issues, tcol, run_stats
                    )
                arr, ok = sanitize.apply_block_policy(
                    arr, issues, path=path, policy=data_policy,
                    base_row=base, writer=writer, header=header,
                )
                if run_stats is not None and len(arr):
                    run_stats.update(arr, ok)
                rows_parsed += len(arr)
                if ok is None:
                    rows_valid += len(arr)
                else:
                    rows_valid += int(ok.sum())
                    if c_quar is not None:
                        c_quar.inc(int((~ok).sum()))
            else:
                rows_parsed += len(arr)
            clock.add("sanitize", time.perf_counter() - t0)
            parts.append(arr)
            ok_parts.append(ok)
            buffered += len(arr)
            while buffered >= rows_per_chunk:
                t0 = time.perf_counter()
                chunk, rest, ok_rest = emit(start_row, rows_per_chunk)
                clock.add("stripe", time.perf_counter() - t0)
                if tracer:
                    tracer.span(
                        "ingest", chunk_idx, t_chunk_mono, time.monotonic(),
                        rows=rows_per_chunk,
                    )
                yield chunk
                chunk_idx += 1
                t_chunk_mono = time.monotonic()
                start_row += rows_per_chunk
                parts = [rest] if len(rest) else []
                ok_parts = [ok_rest] if len(rest) else []
                buffered = len(rest)
        if buffered:
            t0 = time.perf_counter()
            chunk, _, _ = emit(start_row, buffered)
            clock.add("stripe", time.perf_counter() - t0)
            if tracer:
                tracer.span(
                    "ingest", chunk_idx, t_chunk_mono, time.monotonic(),
                    rows=buffered,
                )
            yield chunk
        # Degenerate-stream guard, matching the whole-file path
        # (apply_policy raises the same on a fully-dirty file): a
        # run that quarantined EVERY row must not read as success.
        if sanitize is not None and rows_parsed and not rows_valid:
            raise sanitize.StreamContractError(
                path,
                reason=(
                    f"all {rows_parsed} data rows violate the stream "
                    "contract; nothing left to quarantine around"
                ),
                total=rows_parsed,
            )
    finally:
        if ex is not None:
            # Drop queued blocks, wait out the (block-bounded) running
            # ones — workers must not touch the mmap after it closes.
            ex.shutdown(wait=True, cancel_futures=True)
        if writer is not None:
            writer.close()
        close = getattr(buf, "close", None)
        if close is not None:
            close()
        fh.close()
