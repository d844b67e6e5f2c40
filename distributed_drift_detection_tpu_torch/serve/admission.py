"""Admission control for the serving daemon: sanitize → fixed-geometry
microbatches.

The port's own copy of the JAX package's ``serve/admission.py``: a
sealed chunk is byte for byte the ``io.stream.stripe_chunk`` chunk of the
same rows.

Two pieces, deliberately separate so each is testable without sockets:

* :class:`AdmissionController` — the data-plane gate. Every ingress line
  block is parsed with the tolerant row parser and contract-scanned
  (``io.sanitize.parse_rows`` / ``scan_matrix``), then resolved per the
  configured policy through the same ``io.sanitize.apply_block_policy``
  the streaming CSV reader uses — quarantined rows land in the sidecar
  and count ``ingest_quarantined_total``, exactly as in batch mode. Two
  serving-specific adaptations, both documented deviations from the
  batch loaders:

  - ``strict`` rejects the violating *rows* (dropped, counted, an error
    line back on the connection) instead of refusing the whole stream —
    a daemon that dies on one bad row is not a daemon;
  - ``repair`` imputes from **running** column means over the rows
    admitted so far (``io.sanitize.RunningColumnStats``) — full-column
    statistics do not exist on an unbounded stream.

  Admitted rows under ``quarantine``/``repair`` keep their stream
  *positions* (masked, padding-identical in the device loop), so a dirty served
  stream produces flags bit-identical to the clean-masked batch run —
  the batch ingest contract, extended to the wire.

* :class:`MicroBatcher` — the geometry gate. Admitted rows accumulate in
  arrival order; a full ``[P, CB, B]`` grid seals immediately, a partial
  one seals when its oldest row has lingered past ``linger_s``. Sealing
  runs the rows through the one shared striper (``io.stream.stripe_chunk``
  with the RunConfig's host shuffle seed), so a short flush is *literally*
  the same chunk as a full grid with the tail masked — static shapes,
  nothing recompiles, and the serving path cannot drift from the batch
  path's placement. The stream position advances by the full grid span
  per seal (grid-slot semantics): under sustained load there are no gaps,
  and a lingering flush trades position density for latency, never
  correctness.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import numpy as np

from ..io import sanitize
from ..io.stream import ChunkStriper
from ..resilience import faults


class FrameContractError(ValueError):
    """A v2 frame whose geometry disagrees with the daemon's row contract
    (feature count / shape). Connection-level protocol violation — the
    ingress validates before admission, so reaching this from the wire
    means an embedder bug."""


def _split_buffered(bufs, n_take: int, num_features: int):
    """One stream's buffered blocks → the seal's (take, rest) halves.

    ``bufs`` is the ``(X_list, y_list, ok_list, ts_list)`` quadruple a
    batcher accumulates per stream; the oldest ``n_take`` rows split off
    as ``(take_X, take_y, take_ok, take_ts)`` (``take_ok`` collapses to
    None when every taken row is valid) and the remainder is re-stashed
    in the same list form. The ONE copy of the take/rest mechanics the
    solo :class:`MicroBatcher` and per-tenant :class:`TenantMicroBatcher`
    seals share — the serve path's bit-parity contract rides on these
    exact semantics, so they must not be able to diverge. An empty
    stream yields a zero-row take (``num_features`` shapes its plane).
    """
    X_list, y_list, ok_list, ts_list = bufs
    if X_list:
        X = np.concatenate(X_list) if len(X_list) > 1 else X_list[0]
        y = np.concatenate(y_list) if len(y_list) > 1 else y_list[0]
        ts = np.concatenate(ts_list) if len(ts_list) > 1 else ts_list[0]
        ok = None
        if any(o is not None for o in ok_list):
            ok = np.concatenate(
                [
                    np.ones(len(a), bool) if o is None else o
                    for a, o in zip(X_list, ok_list)
                ]
            )
    else:
        X = np.zeros((0, num_features), np.float32)
        y = np.zeros((0,), np.int32)
        ts = np.zeros((0,), np.float64)
        ok = None
    take_X, rest_X = X[:n_take], X[n_take:]
    take_y, rest_y = y[:n_take], y[n_take:]
    take_ts, rest_ts = ts[:n_take], ts[n_take:]
    take_ok = rest_ok = None
    if ok is not None:
        take_ok, rest_ok = ok[:n_take], ok[n_take:]
        if take_ok.all():
            take_ok = None
    rest = (
        [rest_X] if len(rest_X) else [],
        [rest_y] if len(rest_X) else [],
        (
            [rest_ok]
            if len(rest_X) and rest_ok is not None
            else ([None] if len(rest_X) else [])
        ),
        [rest_ts] if len(rest_X) else [],
    )
    return (take_X, take_y, take_ok, take_ts), rest


def _take_marks(
    marks: "list[dict]", taken_before: int, n_take: int
) -> "tuple[list[dict], list[dict]]":
    """One stream's trace marks → the seal's (taken, rest) halves.

    ``marks`` hold absolute admitted positions; the seal covers
    ``[taken_before, taken_before + n_take)``. The ONE copy of the
    mark-partition mechanics the solo and tenant seals share (the same
    rule as :func:`_split_buffered` for the row planes) — taken marks
    come back position-rebased is the CALLER's job (it owns the seal's
    index base). Returns ``(taken, rest)``.
    """
    end = taken_before + n_take
    taken = [m for m in marks if m["pos"] < end]
    if not taken:
        return [], marks
    return taken, [m for m in marks if m["pos"] >= end]


class SealedChunk(NamedTuple):
    """One flushed microbatch: the striped ``[P, CB, B]`` chunk plus its
    accounting meta (``chunk`` index, ``start_row`` grid position,
    ``rows`` admitted into it, ``rows_through`` cumulative admitted rows
    up to and including it — the loadgen's latency-attribution key —
    ``short`` flag and seal wall-clock). For end-to-end row tracing
    (``telemetry.trace``) the meta also carries ``ingest_mono`` — one
    monotonic admission stamp per admitted row, in stream order — and
    ``sealed_mono``, the seal instant on the same clock; the serve loop
    turns these into the live ``serve_row_latency_seconds`` stages."""

    chunk: object  # engine.loop.Batches
    meta: dict


class MicroBatcher:
    """Thread-safe accumulation of admitted rows into fixed-geometry
    chunks with a max-linger deadline (see module docstring).

    Producers call :meth:`push` (ingress handler threads); the single
    consumer (the serve loop) calls :meth:`get`. :meth:`poison` carries a
    producer-side failure to the consumer — the daemon must die loudly,
    not serve around a broken ingress.
    """

    def __init__(
        self,
        partitions: int,
        per_batch: int,
        chunk_batches: int,
        *,
        shuffle_seed: "int | None" = None,
        linger_s: float = 0.25,
        start_row: int = 0,
        chunk_index: int = 0,
        rows_admitted: int = 0,
        max_queue: int = 64,
    ):
        self.partitions = partitions
        self.per_batch = per_batch
        self.chunk_batches = chunk_batches
        self.rows_per_chunk = partitions * per_batch * chunk_batches
        self.shuffle_seed = shuffle_seed
        # Pooled seal striper: same placement/shuffle/validity folding as
        # stripe_chunk — bit-identical, pinned by test — but the pad
        # staging buffers are reused across seals, so a sustained ingress
        # (the v2 frame path especially) seals with zero per-chunk
        # staging allocation.
        self._striper = ChunkStriper(
            partitions, per_batch, chunk_batches, shuffle_seed
        )
        self.linger_s = linger_s
        self.start_row = int(start_row)  # next chunk's grid position
        self.chunk_index = int(chunk_index)
        self.rows_admitted = int(rows_admitted)  # cumulative, incl. masked
        self.rows_sealed = 0  # cumulative rows sealed into chunks (this process)
        self._max_queue = max(1, max_queue)
        self._cv = threading.Condition()
        self._X: list[np.ndarray] = []
        self._y: list[np.ndarray] = []
        self._ok: list["np.ndarray | None"] = []
        self._ts: list[np.ndarray] = []  # per-row monotonic ingest stamps
        self._buffered = 0
        self._first_ts: "float | None" = None  # monotonic, oldest buffered row
        # Sampled-row trace marks (telemetry.tracing): [{"pos": absolute
        # admitted position, "trace_id", "parent_id"}], carried into the
        # covering seal's meta. Empty unless tracing is on — the untraced
        # path costs one falsy check per push.
        self._trace_marks: list[dict] = []
        self._queue: list[SealedChunk] = []
        self._error: "BaseException | None" = None

    def push(
        self,
        X: np.ndarray,
        y: np.ndarray,
        ok: "np.ndarray | None" = None,
        traces=None,
    ) -> None:
        """Admit a block of rows (arrival order = stream order). Blocks
        while the sealed-chunk queue is full (backpressure to ingress)."""
        X = np.ascontiguousarray(X, np.float32)
        y = np.ascontiguousarray(y, np.int32)
        if len(X) == 0:
            return
        # One ingest stamp per block (rows of one push arrived together),
        # taken BEFORE the backpressure wait below: under overload that
        # wait IS the latency a client experiences, and a post-wait stamp
        # would hide exactly the congestion the p99 SLO exists to catch.
        ingest_mono = time.monotonic()
        with self._cv:
            while len(self._queue) >= self._max_queue and self._error is None:
                self._cv.wait(0.1)
            if self._error is not None:
                raise self._error
            self._X.append(X)
            self._y.append(y)
            self._ok.append(None if ok is None else np.asarray(ok, bool))
            self._ts.append(np.full(len(X), ingest_mono, dtype=np.float64))
            if traces:
                base = self.rows_admitted
                self._trace_marks.extend(
                    {
                        "pos": base + int(i),
                        "trace_id": tid,
                        "parent_id": pid,
                    }
                    for i, tid, pid in traces
                )
            self._buffered += len(X)
            self.rows_admitted += len(X)
            if self._first_ts is None:
                self._first_ts = time.monotonic()
            while self._buffered >= self.rows_per_chunk:
                self._seal_locked(self.rows_per_chunk)
            self._cv.notify_all()

    def flush(self) -> None:
        """Seal the partial grid now (protocol ``FLUSH`` / drain)."""
        with self._cv:
            if self._buffered:
                self._seal_locked(self._buffered)
            self._cv.notify_all()

    def poison(self, exc: BaseException) -> None:
        """Fail the consumer: the next/blocked :meth:`get` raises ``exc``."""
        with self._cv:
            self._error = exc
            self._cv.notify_all()

    def empty(self) -> bool:
        with self._cv:
            return not self._queue and not self._buffered

    def poisoned(self) -> "BaseException | None":
        """The producer-side failure carried to the consumer, if any
        (ops-plane health surface; read-only)."""
        with self._cv:
            return self._error

    def depth(self) -> dict:
        """Queue occupancy for ``/statusz``: sealed chunks waiting for
        the serve loop + rows buffered toward the next seal."""
        with self._cv:
            return {
                "queued_chunks": len(self._queue),
                "buffered_rows": self._buffered,
                "rows_sealed": self.rows_sealed,
            }

    def tenant_state(self, tenant: int = 0) -> dict:
        """The stream-position accounting of slot ``tenant`` (a solo
        batcher has exactly slot 0) — what a migration checkpoint must
        carry so the landing daemon's verdicts continue this one's
        ``rows_through`` sequence without a gap."""
        if tenant != 0:
            raise ValueError(f"solo batcher has only tenant 0, not {tenant}")
        with self._cv:
            return {
                "start_row": self.start_row,
                "rows_admitted": self.rows_admitted,
                "buffered": self._buffered,
            }

    def set_tenant_state(
        self, tenant: int, start_row: int, rows_admitted: int
    ) -> None:
        """Install a shipped tenant's stream positions into slot
        ``tenant`` (the LOADTENANT landing half of a migration). Refuses
        while rows are buffered toward a seal — position surgery under a
        live buffer would mis-stripe every buffered row."""
        if tenant != 0:
            raise ValueError(f"solo batcher has only tenant 0, not {tenant}")
        with self._cv:
            if self._buffered:
                raise RuntimeError(
                    f"cannot install tenant state over {self._buffered} "
                    "buffered row(s); flush first"
                )
            self.start_row = int(start_row)
            self.rows_admitted = int(rows_admitted)

    def set_tenant_identity(
        self, tenant: int, shuffle_seed: "int | None"
    ) -> None:
        """Install a migrated tenant's stripe identity into slot
        ``tenant``: the slot stripes subsequent rows with the SHIPPED
        tenant's shuffle seed, so post-migration flags continue the
        tenant's own solo sequence bit-identically. Same empty-buffer
        guard as :meth:`set_tenant_state` — a seed swap under buffered
        rows would mis-stripe them."""
        if tenant != 0:
            raise ValueError(f"solo batcher has only tenant 0, not {tenant}")
        with self._cv:
            if self._buffered:
                raise RuntimeError(
                    f"cannot install tenant identity over {self._buffered} "
                    "buffered row(s); flush first"
                )
            self.shuffle_seed = shuffle_seed
            self._striper = ChunkStriper(
                self.partitions, self.per_batch, self.chunk_batches,
                shuffle_seed,
            )

    def get(self, timeout: float = 0.0) -> "SealedChunk | None":
        """Next sealed chunk, sealing a lingering partial when its
        deadline passed; ``None`` on timeout. Raises a poisoned error."""
        deadline = time.monotonic() + max(timeout, 0.0)
        with self._cv:
            while True:
                if self._error is not None:
                    raise self._error
                if self._queue:
                    item = self._queue.pop(0)
                    self._cv.notify_all()  # wake a backpressured producer
                    return item
                now = time.monotonic()
                if (
                    self._buffered
                    and self._first_ts is not None
                    and now - self._first_ts >= self.linger_s
                ):
                    self._seal_locked(self._buffered)
                    continue
                waits = [deadline - now]
                if self._buffered and self._first_ts is not None:
                    waits.append(self._first_ts + self.linger_s - now)
                wait = min(waits)
                if deadline - now <= 0:
                    return None
                self._cv.wait(max(wait, 0.001))

    def _seal_locked(self, n_take: int) -> None:
        take, rest = _split_buffered(
            (self._X, self._y, self._ok, self._ts),
            n_take,
            self._X[0].shape[1],  # solo seals always hold data
        )
        take_X, take_y, take_ok, take_ts = take
        chunk = self._striper.stripe(
            take_X, take_y, self.start_row, row_valid=take_ok
        )
        taken_before = self.rows_admitted - self._buffered
        meta = {
            "chunk": self.chunk_index,
            "start_row": self.start_row,
            "rows": int(n_take),
            "rows_through": int(taken_before + n_take),
            "short": n_take < self.rows_per_chunk,
            "sealed_ts": time.time(),
            # row-tracing stamps (telemetry.trace.observe_chunk_stages);
            # never serialized — _publish copies named scalars only
            "ingest_mono": take_ts,
            "sealed_mono": time.monotonic(),
        }
        if self._trace_marks:
            taken, self._trace_marks = _take_marks(
                self._trace_marks, taken_before, n_take
            )
            if taken:
                meta["traces"] = [
                    {
                        "idx": m["pos"] - taken_before,
                        "trace_id": m["trace_id"],
                        "parent_id": m["parent_id"],
                    }
                    for m in taken
                ]
        self._queue.append(SealedChunk(chunk, meta))
        self.rows_sealed += int(n_take)
        # Grid-slot semantics: the stream position always advances by the
        # full grid span, so the next seal stays aligned to P·B (the
        # stripe-time shuffle's invariance requirement) and a short flush
        # reads as a grid with a masked tail, never as a re-packed stream.
        self.start_row += self.rows_per_chunk
        self.chunk_index += 1
        self._X, self._y, self._ok, self._ts = rest
        self._buffered = len(rest[0][0]) if rest[0] else 0
        self._first_ts = time.monotonic() if self._buffered else None


class _TenantSlot:
    """The push surface one tenant's :class:`AdmissionController` sees:
    routes admitted rows into its slot of the shared
    :class:`TenantMicroBatcher` grid."""

    def __init__(self, batcher: "TenantMicroBatcher", tenant: int):
        self._batcher = batcher
        self._tenant = tenant

    def push(self, X, y, ok=None, traces=None) -> None:
        self._batcher.push(self._tenant, X, y, ok, traces)


class TenantMicroBatcher:
    """T independent per-tenant row accumulators sealing into ONE stacked
    ``[T·P, CB, B]`` grid — the serving half of the multi-tenant plane.

    Each tenant accumulates its own arrival-order stream and stripes into
    its own ``[P, CB, B]`` block with its own shuffle seed and its own
    stream position (grid-slot semantics per tenant, exactly
    :class:`MicroBatcher`'s); a seal stacks the T blocks on the leading
    axis (``engine.loop.stack_tenants``) so the serve loop feeds one
    chunk, one dispatch, for all tenants. Seal policy: a FULL grid seals
    as soon as every tenant has a full span buffered (the balanced
    sustained-load fast path — per-tenant content then equals T solo
    batchers', so served flags stay bit-identical to solo runs); a
    PARTIAL grid seals when the oldest buffered row has lingered past
    ``linger_s`` — each tenant contributes what it has, masked through
    the validity plane (ragged tenant traffic == ragged tenant lengths:
    masked rows read as padding in the device loop, static shapes, zero
    recompiles). Every seal advances EVERY tenant's stream position by
    the full span, so tenant blocks stay aligned to the stripe shuffle's
    P·B invariant.

    Liveness under skew: a tenant whose buffer crosses
    ``max_buffer_spans`` spans forces a partial seal too (idle tenants
    contribute masked blocks), so one hot tenant's buffering — and its
    row latency — stays bounded even when the balanced full seal never
    fires.

    ``meta`` carries per-tenant accounting lists (``t_rows``,
    ``t_rows_through``, ``t_start_row``) next to the pooled totals, so
    the verdict sidecar can attribute per tenant
    (``serve.runner._publish``) and the loadgen's per-tenant latency
    mapping works. Interface-compatible with :class:`MicroBatcher` where
    the serve loop touches it (get/flush/poison/poisoned/empty/depth/
    rows_admitted); producers push via :meth:`push` with a tenant index
    (the per-tenant :class:`_TenantSlot` adapters the admission
    controllers hold).
    """

    def __init__(
        self,
        tenants: int,
        partitions: int,
        per_batch: int,
        chunk_batches: int,
        *,
        num_features: int,
        shuffle_seeds=None,  # per-tenant stripe seeds (None = unshuffled)
        linger_s: float = 0.25,
        start_rows=None,
        chunk_index: int = 0,
        rows_admitted=None,
        max_queue: int = 64,
        max_buffer_spans: int = 4,
    ):
        if tenants < 1:
            raise ValueError(f"tenants must be >= 1, got {tenants}")
        if max_buffer_spans < 1:
            raise ValueError(
                f"max_buffer_spans must be >= 1, got {max_buffer_spans}"
            )
        if num_features <= 0:
            # An idle tenant's block is a zero-row stripe — its feature
            # plane's width must be configuration, not inference.
            raise ValueError(
                f"num_features must be > 0, got {num_features}"
            )
        self.num_features = int(num_features)
        self.tenants = tenants
        self.partitions = partitions
        self.per_batch = per_batch
        self.chunk_batches = chunk_batches
        # Per-TENANT span; the stacked chunk carries tenants· this.
        self.rows_per_chunk = partitions * per_batch * chunk_batches
        if shuffle_seeds is None:
            shuffle_seeds = [None] * tenants
        if len(shuffle_seeds) != tenants:
            raise ValueError(
                f"{len(shuffle_seeds)} shuffle_seeds for {tenants} tenants"
            )
        self.shuffle_seeds = list(shuffle_seeds)
        # One pooled seal striper per tenant (each has its own shuffle
        # seed and staging pool) — see MicroBatcher.
        self._stripers = [
            ChunkStriper(partitions, per_batch, chunk_batches, s)
            for s in self.shuffle_seeds
        ]
        self.linger_s = linger_s
        self.start_rows = [
            int(s) for s in (start_rows or [0] * tenants)
        ]
        if len(self.start_rows) != tenants:
            raise ValueError(
                f"{len(self.start_rows)} start_rows for {tenants} tenants"
            )
        self.chunk_index = int(chunk_index)
        per_tenant_admitted = list(rows_admitted or [0] * tenants)
        if len(per_tenant_admitted) != tenants:
            raise ValueError(
                f"{len(per_tenant_admitted)} rows_admitted for {tenants} "
                "tenants"
            )
        self.tenant_rows_admitted = [int(r) for r in per_tenant_admitted]
        self.rows_sealed = 0  # cumulative rows sealed into chunks (this process)
        self._max_buffer_spans = int(max_buffer_spans)
        self._max_queue = max(1, max_queue)
        self._cv = threading.Condition()
        self._X = [[] for _ in range(tenants)]
        self._y = [[] for _ in range(tenants)]
        self._ok = [[] for _ in range(tenants)]
        self._ts = [[] for _ in range(tenants)]
        # per-tenant trace marks (same shape as MicroBatcher's, positions
        # absolute within that tenant's admitted stream)
        self._trace_marks: list[list[dict]] = [[] for _ in range(tenants)]
        self._buffered = [0] * tenants
        self._first_ts: "float | None" = None  # oldest buffered row, any tenant
        self._queue: list[SealedChunk] = []
        self._error: "BaseException | None" = None

    # -- MicroBatcher-compatible surface -------------------------------------

    @property
    def rows_admitted(self) -> int:
        return sum(self.tenant_rows_admitted)

    def push(self, tenant: int, X, y, ok=None, traces=None) -> None:
        """Admit a block of rows into ``tenant``'s stream (arrival order =
        that tenant's stream order). Blocks while the sealed queue is full
        (backpressure to ingress), like :class:`MicroBatcher`."""
        if not 0 <= tenant < self.tenants:
            raise ValueError(
                f"tenant {tenant} out of range 0..{self.tenants - 1}"
            )
        X = np.ascontiguousarray(X, np.float32)
        y = np.ascontiguousarray(y, np.int32)
        if len(X) == 0:
            return
        ingest_mono = time.monotonic()
        with self._cv:
            while len(self._queue) >= self._max_queue and self._error is None:
                self._cv.wait(0.1)
            if self._error is not None:
                raise self._error
            self._X[tenant].append(X)
            self._y[tenant].append(y)
            self._ok[tenant].append(None if ok is None else np.asarray(ok, bool))
            self._ts[tenant].append(
                np.full(len(X), ingest_mono, dtype=np.float64)
            )
            if traces:
                base = self.tenant_rows_admitted[tenant]
                self._trace_marks[tenant].extend(
                    {
                        "pos": base + int(i),
                        "trace_id": tid,
                        "parent_id": pid,
                    }
                    for i, tid, pid in traces
                )
            self._buffered[tenant] += len(X)
            self.tenant_rows_admitted[tenant] += len(X)
            if self._first_ts is None:
                self._first_ts = time.monotonic()
            while all(b >= self.rows_per_chunk for b in self._buffered):
                self._seal_locked(full=True)
            # Skew bound: under imbalanced traffic the all-tenants-full
            # seal never fires, and without this a hot tenant's buffer
            # (and its row latency) would grow without bound between
            # linger seals. A tenant crossing max_buffer_spans spans
            # forces a partial seal — idle tenants contribute masked
            # blocks, trading their position density for the hot
            # tenant's liveness, exactly like the linger deadline.
            # Balanced sustained load never reaches it (the full seal
            # above fires first), so the solo-parity fast path is
            # untouched.
            while (
                self._buffered[tenant]
                >= self._max_buffer_spans * self.rows_per_chunk
            ):
                self._seal_locked(full=False)
            self._cv.notify_all()

    def flush(self) -> None:
        with self._cv:
            # Seal until EVERY tenant's buffer is empty: a hot tenant may
            # hold several spans (the skew bound allows up to
            # max_buffer_spans), and the FLUSH/drain contract is "seal
            # buffered rows NOW", not one-span-per-linger.
            while any(self._buffered):
                self._seal_locked(full=False)
            self._cv.notify_all()

    def poison(self, exc: BaseException) -> None:
        with self._cv:
            self._error = exc
            self._cv.notify_all()

    def empty(self) -> bool:
        with self._cv:
            return not self._queue and not any(self._buffered)

    def poisoned(self) -> "BaseException | None":
        with self._cv:
            return self._error

    def depth(self) -> dict:
        with self._cv:
            return {
                "queued_chunks": len(self._queue),
                "buffered_rows": sum(self._buffered),
                "tenant_buffered_rows": list(self._buffered),
                "rows_sealed": self.rows_sealed,
            }

    def tenant_state(self, tenant: int) -> dict:
        """Slot ``tenant``'s stream-position accounting (the migration
        checkpoint's meta — see :meth:`MicroBatcher.tenant_state`)."""
        if not 0 <= tenant < self.tenants:
            raise ValueError(
                f"tenant {tenant} out of range 0..{self.tenants - 1}"
            )
        with self._cv:
            return {
                "start_row": self.start_rows[tenant],
                "rows_admitted": self.tenant_rows_admitted[tenant],
                "buffered": self._buffered[tenant],
            }

    def set_tenant_state(
        self, tenant: int, start_row: int, rows_admitted: int
    ) -> None:
        """Install a shipped tenant's stream positions into slot
        ``tenant`` (LOADTENANT). The slot's own buffer must be empty —
        the OTHER tenants' buffers are untouched and irrelevant (their
        positions are their own)."""
        if not 0 <= tenant < self.tenants:
            raise ValueError(
                f"tenant {tenant} out of range 0..{self.tenants - 1}"
            )
        with self._cv:
            if self._buffered[tenant]:
                raise RuntimeError(
                    f"cannot install tenant {tenant} state over "
                    f"{self._buffered[tenant]} buffered row(s); flush first"
                )
            self.start_rows[tenant] = int(start_row)
            self.tenant_rows_admitted[tenant] = int(rows_admitted)

    def set_tenant_identity(
        self, tenant: int, shuffle_seed: "int | None"
    ) -> None:
        """Install a migrated tenant's stripe identity into slot
        ``tenant`` (see :meth:`MicroBatcher.set_tenant_identity`): the
        slot's striper rebuilds with the SHIPPED shuffle seed. The
        slot's own buffer must be empty; other tenants are untouched."""
        if not 0 <= tenant < self.tenants:
            raise ValueError(
                f"tenant {tenant} out of range 0..{self.tenants - 1}"
            )
        with self._cv:
            if self._buffered[tenant]:
                raise RuntimeError(
                    f"cannot install tenant {tenant} identity over "
                    f"{self._buffered[tenant]} buffered row(s); flush first"
                )
            self.shuffle_seeds[tenant] = shuffle_seed
            self._stripers[tenant] = ChunkStriper(
                self.partitions, self.per_batch, self.chunk_batches,
                shuffle_seed,
            )

    def get(self, timeout: float = 0.0) -> "SealedChunk | None":
        deadline = time.monotonic() + max(timeout, 0.0)
        with self._cv:
            while True:
                if self._error is not None:
                    raise self._error
                if self._queue:
                    item = self._queue.pop(0)
                    self._cv.notify_all()
                    return item
                now = time.monotonic()
                if (
                    any(self._buffered)
                    and self._first_ts is not None
                    and now - self._first_ts >= self.linger_s
                ):
                    self._seal_locked(full=False)
                    continue
                waits = [deadline - now]
                if any(self._buffered) and self._first_ts is not None:
                    waits.append(self._first_ts + self.linger_s - now)
                wait = min(waits)
                if deadline - now <= 0:
                    return None
                self._cv.wait(max(wait, 0.001))

    def _seal_locked(self, full: bool) -> None:
        from ..engine.loop import stack_tenants

        span = self.rows_per_chunk
        blocks, ts_parts = [], []
        t_rows, t_through, t_start = [], [], []
        traces: list[dict] = []
        seal_offset = 0  # index base into the tenant-major ingest array
        any_short = False
        for t in range(self.tenants):
            n_take = span if full else min(self._buffered[t], span)
            take, rest = _split_buffered(
                (self._X[t], self._y[t], self._ok[t], self._ts[t]),
                n_take,
                self.num_features,
            )
            take_X, take_y, take_ok, take_ts = take
            blocks.append(
                self._stripers[t].stripe(
                    take_X, take_y, self.start_rows[t], row_valid=take_ok
                )
            )
            ts_parts.append(take_ts)
            taken_before = self.tenant_rows_admitted[t] - self._buffered[t]
            if self._trace_marks[t]:
                taken, self._trace_marks[t] = _take_marks(
                    self._trace_marks[t], taken_before, n_take
                )
                traces.extend(
                    {
                        "idx": seal_offset + m["pos"] - taken_before,
                        "trace_id": m["trace_id"],
                        "parent_id": m["parent_id"],
                        "tenant": t,
                    }
                    for m in taken
                )
            seal_offset += n_take
            t_rows.append(int(n_take))
            t_through.append(int(taken_before + n_take))
            t_start.append(self.start_rows[t])
            any_short = any_short or n_take < span
            # Grid-slot semantics PER TENANT: every tenant's position
            # advances by the full span each seal, so blocks stay aligned.
            self.start_rows[t] += span
            self._X[t], self._y[t], self._ok[t], self._ts[t] = rest
            self._buffered[t] = len(rest[0][0]) if rest[0] else 0
        chunk = stack_tenants(blocks) if self.tenants > 1 else blocks[0]
        meta = {
            "chunk": self.chunk_index,
            "start_row": t_start[0],
            "rows": int(sum(t_rows)),
            "rows_through": int(sum(t_through)),
            "short": any_short,
            "sealed_ts": time.time(),
            "tenants": self.tenants,
            "t_rows": t_rows,
            "t_rows_through": t_through,
            "t_start_row": t_start,
            # row-tracing stamps: tenant-major concatenation, matching the
            # stacked grid's leading-axis order
            "ingest_mono": np.concatenate(ts_parts) if ts_parts else None,
            "sealed_mono": time.monotonic(),
        }
        if traces:
            meta["traces"] = traces
        self._queue.append(SealedChunk(chunk, meta))
        self.rows_sealed += int(sum(t_rows))
        self.chunk_index += 1
        self._first_ts = time.monotonic() if any(self._buffered) else None


def _json_field(v) -> str:
    """One JSON row value → one CSV field. Non-numeric values become a
    comma-free non-numeric token, so they reach the contract scan as a
    dirty CELL (quarantinable) instead of crashing the normalizer — a
    daemon must never die on one malformed row."""
    try:
        return repr(float(v))
    except (TypeError, ValueError):
        return str(v).replace(",", ";") or "''"


def _json_line_to_csv(line: str) -> str:
    """Normalize a JSON row (``{"x": [...], "y": l}`` or ``[f..., l]``)
    to the CSV field form the shared parser consumes; malformed JSON is
    returned as-is so it flows through the contract scan like any other
    dirty line (one parse path, one policy)."""
    import json

    try:
        obj = json.loads(line)
    except json.JSONDecodeError:
        return line
    if isinstance(obj, dict):
        fields = list(obj.get("x") or []) + [obj.get("y")]
    elif isinstance(obj, list):
        fields = obj
    else:
        return line
    return ",".join(_json_field(v) for v in fields)


class AdmissionController:
    """The per-block sanitize → push gate (see module docstring).

    ``num_features`` fixes the ingress line contract: every row carries
    exactly ``num_features + 1`` comma-separated fields with the label
    LAST (or the JSON forms, normalized to the same fields). Labels must
    already be integral and in ``0..num_classes-1`` — a daemon cannot
    re-index classes the way the one-shot loader does; out-of-range
    labels are contract violations handled by the policy.
    """

    def __init__(
        self,
        batcher: MicroBatcher,
        num_features: int,
        num_classes: int,
        *,
        policy: str = "quarantine",
        quarantine_path: "str | None" = None,
        metrics=None,
        source: str = "ingress",
    ):
        sanitize.check_policy(policy)
        self.batcher = batcher
        self.num_features = int(num_features)
        self.num_classes = int(num_classes)
        self.columns = self.num_features + 1
        self.tcol = self.num_features  # label last — the line contract
        self.policy = policy
        self.source = source
        self._stats = (
            sanitize.RunningColumnStats(self.columns)
            if policy == "repair"
            else None
        )
        self._writer = (
            sanitize.QuarantineWriter(quarantine_path, policy)
            if quarantine_path and policy != "strict"
            else None
        )
        self.rows_seen = 0  # ingress data rows consumed (admitted+rejected)
        self.rows_rejected = 0
        self.rows_quarantined = 0
        self.rows_repaired = 0
        # One admission at a time: handler threads (one per connection)
        # share this controller, and the absolute-row accounting, running
        # stats, counters and lazy sidecar writer all assume sequential
        # blocks. Admission order across connections is arbitrary anyway
        # (the network already interleaves), so serializing loses nothing.
        self._lock = threading.Lock()
        self._c_rows = self._c_quar = self._c_rej = None
        if metrics is not None:
            self._c_rows = metrics.counter(
                "ingest_rows_total", help="Stream rows admitted at ingress"
            )
            self._c_quar = metrics.counter(
                sanitize.QUARANTINE_METRIC, help=sanitize.QUARANTINE_METRIC_HELP
            )
            self._c_rej = metrics.counter(
                "serve_rejected_total",
                help="Ingress rows refused under data_policy=strict",
            )

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()

    def admit_lines(self, lines: list[str], traces=None) -> dict:
        """Sanitize + admit one block of protocol data lines; returns the
        block's accounting (``error`` is the strict-rejection message for
        the connection, None otherwise). Thread-safe (serialized).

        ``traces`` marks head-sampled rows (telemetry.tracing):
        ``[(line_index, trace_id, parent_span_id), ...]`` — indices into
        ``lines``. Marks follow their rows through the policy (a
        strict-rejected row's mark is dropped with it; quarantined rows
        keep their positions and their marks) into the batcher, which
        carries them to the covering seal's meta."""
        with self._lock:
            return self._admit_lines_locked(lines, traces)

    def _parse_block(
        self, lines: list[str]
    ) -> tuple[np.ndarray, list[sanitize.RowIssue]]:
        """Fast-path-then-fallback parse, the batch readers' shape: a
        vectorized parse serves the (overwhelmingly common) clean block;
        the tolerant parser runs only when it refuses — and that parser
        is itself tier-vectorized (``sanitize.parse_rows``: whole-block →
        per-row → per-cell), so a dirty block still parses its clean rows
        in batched ``np.asarray`` calls rather than a per-cell Python
        loop. Ingress hands whole recv-blocks here (``serve.ingress``),
        which is what makes the batching real under load. NaN/Inf parse
        fine on the fast path and are caught by the matrix scan like
        everywhere else."""
        import io as _io

        try:
            arr = np.loadtxt(
                _io.StringIO("\n".join(lines)),
                delimiter=",",
                dtype=np.float32,
                ndmin=2,
            )
            if arr.shape == (len(lines), self.columns):
                return arr, []
        except ValueError:
            pass
        return sanitize.parse_rows(lines, self.columns)

    def _admit_lines_locked(self, lines: list[str], traces=None) -> dict:
        if traces:
            # Re-anchor marks across the blank-line filter below so a
            # mark keeps pointing at ITS row (ingress never sends blanks,
            # but direct embedders may).
            kept = [i for i, ln in enumerate(lines) if ln.strip()]
            remap = {orig: new for new, orig in enumerate(kept)}
            traces = [
                (remap[i], tid, pid)
                for i, tid, pid in traces
                if i in remap
            ]
        lines = [
            _json_line_to_csv(ln) if ln.lstrip()[:1] in "{[" else ln
            for ln in lines
            if ln.strip()
        ]
        # Fault-injection site (resilience.faults; no-op unless armed):
        # corruption kinds mutate the live protocol lines — dirty traffic
        # by seeded injection; raise/timeout poison the batcher upstream
        # (the ingress handler routes the exception there).
        faults.fire(
            "serve.ingress",
            lines=lines,
            label_col=self.tcol,
            rows_seen=self.rows_seen,
        )
        if not lines:
            return {"rows": 0, "admitted": 0, "error": None}
        arr, issues = self._parse_block(lines)
        flagged = frozenset(i.row for i in issues)
        issues = issues + sanitize.scan_matrix(arr, self.tcol, flagged=flagged)
        base = self.rows_seen
        self.rows_seen += len(arr)
        return self._admit_block_locked(
            arr, issues, base, traces, rows=len(lines)
        )

    def admit_frame(self, X, y, traces=None) -> dict:
        """Admit one v2 binary frame: columnar ``[n, F]`` f32 features +
        ``[n]`` i32 labels (``serve.wire``), skipping the text parse
        entirely. The overwhelmingly common clean frame admits with two
        vectorized scans (finite cells, label domain) and **zero
        copies** — the payload views push straight into the batcher,
        which stripes them through its pooled staging buffers; a dirty
        frame assembles the combined matrix once and flows through the
        SAME ``scan_matrix`` → policy tail as text admission, so
        strict/quarantine/repair semantics (positions, sidecar records,
        counters, error text) are identical between the protocols.
        Thread-safe (serialized), like :meth:`admit_lines`."""
        with self._lock:
            return self._admit_frame_locked(
                np.asarray(X), np.asarray(y), traces
            )

    def _admit_frame_locked(self, X, y, traces=None) -> dict:
        n = len(y)
        if X.ndim != 2 or X.shape != (n, self.num_features):
            raise FrameContractError(
                f"frame shape {X.shape}/{y.shape} does not match the "
                f"daemon's contract of {self.num_features} feature(s) "
                "per row"
            )
        # Fault-injection site (resilience.faults; no-op unless armed):
        # raise/timeout poison the batcher upstream exactly like the text
        # path. The corruption kinds mutate text lines and are a no-op
        # here — seed v2 dirt client-side (loadgen --wire v2 --dirty).
        faults.fire("serve.ingress", rows_seen=self.rows_seen, frame_rows=n)
        if n == 0:
            return {"rows": 0, "admitted": 0, "error": None}
        base = self.rows_seen
        self.rows_seen += n
        # Clean fast path: labels integral by wire construction, so the
        # whole contract collapses to two vectorized checks. num_classes
        # bounds the label far below the 2^24 f32-exactness clause.
        clean = bool(
            ((y >= 0) & (y < self.num_classes)).all()
        ) and bool(np.isfinite(X).all())
        if clean:
            if self._stats is not None:
                # Running repair stats want every admitted row as
                # evidence (the one combined-matrix copy the repair
                # policy pays; quarantine/strict daemons skip it).
                arr = np.empty((n, self.columns), np.float32)
                arr[:, : self.num_features] = X
                arr[:, self.tcol] = y
                self._stats.update(arr, None)
            if self._c_rows is not None:
                self._c_rows.inc(n)
            self.batcher.push(X, y, None, traces or None)
            return {"rows": n, "admitted": n, "error": None}
        # Dirty frame (rare): assemble the combined matrix once and run
        # the one shared policy tail — bit-identical semantics to text.
        arr = np.empty((n, self.columns), np.float32)
        arr[:, : self.num_features] = X
        arr[:, self.tcol] = y
        issues = sanitize.scan_matrix(arr, self.tcol)
        return self._admit_block_locked(arr, issues, base, traces, rows=n)

    def _admit_block_locked(
        self, arr, issues, base: int, traces, *, rows: int
    ) -> dict:
        """The shared policy tail: label-domain clause + strict/
        quarantine/repair resolution + stats/counters + batcher push.
        One copy of these semantics — the v1 text and v2 frame paths must
        not be able to drift apart."""
        # Serving-only contract clause: the label domain is configuration
        # (no re-indexing pass exists on a live stream). Checked on the
        # ROUNDED label — np.round is exactly what the repair policy will
        # apply, so a label that would round out of the domain (e.g. 9.6
        # at 10 classes) is an unrepairable violation here, never an
        # out-of-range index handed to the engine.
        y = arr[:, self.tcol]
        with np.errstate(invalid="ignore"):
            y_r = np.round(y)
            in_range = np.isfinite(y) & (y_r >= 0) & (y_r < self.num_classes)
        for r in np.nonzero(~in_range)[0]:
            # Appended even when the row already carries another issue: a
            # repairable one (non-integral label) must not shadow this
            # UNREPAIRABLE violation, or repair would round the label
            # straight out of the engine's index domain.
            issues.append(
                sanitize.RowIssue(
                    int(r),
                    self.tcol,
                    f"label {float(y[r])!r} outside the configured "
                    f"class domain 0..{self.num_classes - 1}",
                )
            )
        issues.sort(key=lambda i: (i.row, -1 if i.column is None else i.column))

        error = None
        ok = None
        if self.policy == "repair" and issues:
            arr, issues, repaired = sanitize.repair_rows(
                arr, issues, self.tcol, self._stats
            )
            self.rows_repaired += repaired
        if self.policy == "strict":
            if issues:
                bad = sorted({i.row for i in issues})
                first = issues[0]
                error = (
                    f"rejected {len(bad)} row(s); first: data row "
                    f"{base + first.row}"
                    + ("" if first.column is None else f", column {first.column}")
                    + f": {first.reason}"
                )
                self.rows_rejected += len(bad)
                if self._c_rej is not None:
                    self._c_rej.inc(len(bad))
                keep = np.ones(len(arr), bool)
                keep[bad] = False
                if traces:
                    # rejected rows vanish (no stream position) — their
                    # marks go with them; survivors shift down
                    new_idx = np.cumsum(keep) - 1
                    traces = [
                        (int(new_idx[i]), tid, pid)
                        for i, tid, pid in traces
                        if keep[i]
                    ]
                arr = arr[keep]
        else:
            arr, ok = sanitize.apply_block_policy(
                arr,
                issues,
                path=self.source,
                policy=self.policy,
                base_row=base,
                writer=self._writer,
            )
            if ok is not None:
                n_bad = int((~ok).sum())
                self.rows_quarantined += n_bad
                if self._c_quar is not None:
                    self._c_quar.inc(n_bad)
        if self._stats is not None and len(arr):
            self._stats.update(arr, ok)
        admitted = len(arr)
        if admitted:
            if self._c_rows is not None:
                self._c_rows.inc(admitted)
            self.batcher.push(
                arr[:, : self.num_features],
                arr[:, self.tcol].astype(np.int32),
                ok,
                traces or None,
            )
        return {"rows": rows, "admitted": admitted, "error": error}
