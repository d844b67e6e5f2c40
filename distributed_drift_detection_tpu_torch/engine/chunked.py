"""Chunked streaming execution for unbounded streams.

The port's twin of the JAX package's ``engine/chunked.py``
(``ChunkedDetector``, :81-843). The batch API (``api.run``) puts the whole
stream on the card; this engine runs the same loop incrementally: the
stream arrives in fixed-shape ``[P, CB, B]`` chunks of microbatches, and
the loop carry (model params, detector state, ``batch_a``, retrain flag,
PRNG key) flows across chunks. The carry is also the checkpoint surface
(:meth:`ChunkedDetector.save` / :meth:`~ChunkedDetector.restore`, on
``utils/checkpoint.py``), whole or a tenant at a time.

Where the JAX package relies on asynchronous dispatch and buffer donation,
the port uploads explicitly (:meth:`ChunkedDetector.place`): each chunk is
copied into one of two pinned host staging sets and sent to the card with
``non_blocking`` copies on a side stream, ordered by an event that the
compute stream waits on — so chunk k+1's upload overlaps chunk k's detect —
and a staging set is rewritten only after the event of the copy that last
read it has completed. ``donate`` is accepted and has nothing to free.

The key layout is JAX's: tenant ``t``'s block of the carry's keys is
``split(key(seed_t), P)``, then ``key, k_init = split(k)`` a partition;
the carry always holds the key (``[T·P, 2]`` uint32 on the host), and the
engines advance it as JAX's do. ``shuffle=True`` permutes every batch in
the loop (kernel K13, ``ops/shuffle.py``).

``on_drift`` routes each drained chunk through the adaptation plane
(``adapt/refit.py`` :class:`~..adapt.refit.AdaptationController`, the
serving daemon's ``--on-drift``).

``mesh`` (a ``parallel.mesh.Mesh``, or ``device`` given as a sequence of
devices, made a mesh by ``parallel.mesh.resolve_mesh``) splits the plane
into the mesh's contiguous shards, as the JAX package's ``NamedSharding``
does: each shard's carry lives on its device (placed by
``parallel.mesh.plane_shardings``), each chunk is cut to the shards, and a
chunk's flags are joined on the mesh's first device. What names a
partition or a tenant (``SAVETENANT``/``LOADTENANT``, the ``on_drift``
refits, forensics) reads and writes only its rows of the carry
(``carry_rows``, ``set_carry_rows``); the ``carry`` attribute reads and
writes the whole carry, so a checkpoint moves between a mesh and one
device either way.
"""

from __future__ import annotations

import time
from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..config import AUTO_RETRAIN_THRESHOLD, GUARDED_MODELS, RETRAIN_AUTO, DDMParams
from ..device import is_device_sequence, resolve_device, resolve_devices, synchronize
from ..models.base import Model
from ..utils import threefry
from .loop import (
    Batches,
    FlagRows,
    LoopCarry,
    concat_keys,
    dense_table,
    device_keys,
    make_partition_step,
    resolve_detector,
    run_steps,
)


class PlacedChunk(NamedTuple):
    """A chunk on the card: its planes, and the event the upload stream
    recorded after copying them (None when the copy is already ordered).
    On a mesh ``batches`` is a tuple of the shards' planes."""

    batches: object  # Batches | tuple of Batches, one a shard
    ready: object  # torch.cuda.Event | None


# Chunks between host-side flag collections on a telemetered drain
# (ChunkedDetector.run collect_every=0), as in the JAX package.
DEFAULT_TELEMETRY_COLLECT_EVERY = 8


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a carry, with ``rest`` carries of the same
    structure (``utils/checkpoint.py``'s tree walk)."""
    from ..utils.checkpoint import _flatten, _unflatten

    leaves = zip(_flatten(tree), *(_flatten(r) for r in rest))
    return _unflatten(tree, (fn(*xs) for xs in leaves))


def _shape_sig(chunk: Batches) -> tuple:
    return tuple((tuple(leaf.shape), str(leaf.dtype)) for leaf in chunk)


def _widen(X: torch.Tensor) -> torch.Tensor:
    """A bfloat16 transport plane (uint16 bits on the host) as
    ``torch.bfloat16``; the engines cast it to float32 as they read it."""
    return X.view(torch.bfloat16) if X.dtype in (torch.int16, torch.uint16) else X


def _host_leaf(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        a = a.view(np.int16)  # bfloat16 bits; viewed as bfloat16 once placed
    return torch.from_numpy(a)


class _Staging:
    """One pinned host copy of a chunk's planes, reused chunk after chunk;
    ``event`` marks the completion of the last copy that read it."""

    def __init__(self):
        self.leaves: list | None = None
        self.event = None

    def fill(self, chunk: Batches) -> list:
        leaves = [_host_leaf(a) for a in chunk]
        if self.leaves is None or any(
            s.shape != t.shape or s.dtype != t.dtype for s, t in zip(self.leaves, leaves)
        ):
            self.leaves = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in leaves]
        elif self.event is not None:
            self.event.synchronize()  # the previous copy out of it has completed
        for dst, src in zip(self.leaves, leaves):
            dst.copy_(src)
        return self.leaves


class ChunkedDetector:
    """Stateful driver of the per-chunk engines on ``device`` (the card by
    default; ``"cpu"`` runs the plain versions).

    All chunks share the shape ``[T·P, CB, B]`` (+ features); the first
    chunk's first microbatch seeds ``batch_a``. ``window > 1`` runs each
    chunk through the speculative window engine
    (``engine.window.make_window_span``), ``window = 1`` through the
    sequential loop (``engine.loop.run_steps``); the carry crosses chunk
    boundaries either way. ``retrain_error_threshold`` RETRAIN_AUTO
    resolves per family as ``api.prepare`` resolves it. ``tenants = T``
    stacks T independent streams on the leading axis (chunks arrive
    stacked, ``engine.loop.stack_tenants``); tenant ``t``'s slice of the
    carry is exactly a solo detector's with seed ``tenant_seeds[t]``
    (default ``seed + t``), so its flags are the solo detector's.
    ``self.partitions`` is the whole leading width ``T·P``,
    ``tenant_partitions`` the P of a tenant.
    """

    def __init__(
        self,
        model: Model,
        ddm_params: DDMParams = DDMParams(),
        *,
        partitions: int,
        shuffle: bool = False,
        retrain_error_threshold: float | None = RETRAIN_AUTO,
        seed: int = 0,
        window: int = 1,
        mesh=None,
        detector=None,
        rotations: int = 1,
        validate: bool = False,
        donate: bool = True,
        tenants: int = 1,
        tenant_seeds=None,
        on_drift=None,
        device="cuda",
    ):
        if mesh is None and is_device_sequence(device):
            from ..parallel.mesh import resolve_mesh

            devices = resolve_devices(device)
            mesh = resolve_mesh(devices, partitions * tenants, model=model)
            device = devices[0]
        if retrain_error_threshold is not None and retrain_error_threshold < 0.0:
            retrain_error_threshold = (
                AUTO_RETRAIN_THRESHOLD if model.name in GUARDED_MODELS else None
            )
        self.retrain_error_threshold = retrain_error_threshold
        self.model = model
        if tenants < 1:
            raise ValueError(f"tenants must be >= 1, got {tenants}")
        if tenant_seeds is not None and len(tenant_seeds) != tenants:
            raise ValueError(f"{len(tenant_seeds)} tenant_seeds for {tenants} tenants")
        self.tenants = tenants
        self.tenant_partitions = partitions
        self.tenant_seeds = (
            tuple(int(s) for s in tenant_seeds)
            if tenant_seeds is not None
            else tuple(seed + t for t in range(tenants))
        )
        self.partitions = partitions * tenants
        self.mesh = mesh
        self._shards = None  # [(lo, hi, device)] of this process's shards
        if mesh is not None:
            from ..models.base import require_shardable
            from ..parallel.mesh import TENANT_AXIS, shard_bounds

            require_shardable(model, mesh)
            if TENANT_AXIS in mesh.axis_names:
                t_rows = mesh.devices.shape[0]
                if tenants % t_rows:
                    raise ValueError(
                        f"{tenants} tenant(s) do not split over the "
                        f"{t_rows}-row tenant mesh axis"
                    )
            self._shards = [(lo, hi, d) for _, lo, hi, d in shard_bounds(mesh, self.partitions)]
            self.device = self._shards[0][2]
        else:
            self.device = resolve_device(device)
        self.shuffle = bool(shuffle)
        self.window = int(window)
        self._detector = resolve_detector(ddm_params, detector)
        if window == 0:
            raise ValueError(
                "window=0 (auto) needs stream geometry the chunked engine "
                "does not have; pass an explicit width (config.auto_window "
                "can compute one from a known drift spacing)"
            )
        if window > 1:
            from .window import make_window_span

            self._span = make_window_span(
                model, ddm_params, window=window, shuffle=shuffle,
                retrain_error_threshold=retrain_error_threshold,
                detector=self._detector, rotations=rotations,
            )
        elif rotations != 1:
            raise ValueError("rotations only applies to the window engine (window > 1)")
        else:
            self._step = make_partition_step(
                model, ddm_params, shuffle=shuffle,
                retrain_error_threshold=retrain_error_threshold, detector=self._detector,
            )
        self.donate = donate  # accepted for the JAX signature; nothing to free
        self.validate = validate
        self._prepared: set = set()
        self._per_batch: int | None = None
        self._seed = seed
        self._carry: LoopCarry | None = None  # one device's; on a mesh a list a shard
        self.batches_done = 0
        # rows fed (padding included: a progress beacon) and a monotonic
        # feed-start stamp, for the heartbeat event
        self.rows_done = 0
        self._feed_started: float | None = None
        self._staging = (_Staging(), _Staging())
        self._next_staging = 0
        self._upload_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        # Adaptation hook (adapt/): a policy spec string, a list of specs,
        # or a ready AdaptationController; resolved on the first drained
        # chunk (the controller needs the chunk geometry). None: no
        # adaptation code runs.
        self._on_drift = on_drift
        self.adapt = None  # the resolved AdaptationController (or None)

    # -- lifecycle -----------------------------------------------------------

    @property
    def has_carry(self) -> bool:
        """Whether the detector holds state (fed, or restored)."""
        return self._carry is not None

    @property
    def carry(self) -> "LoopCarry | None":
        """The whole loop carry (on a mesh, the shards' joined on the first
        device; a copy, so write it back by assignment). A reader of a few
        rows or of one field takes :meth:`carry_rows`."""
        if self.mesh is None or self._carry is None:
            return self._carry
        from ..parallel.mesh import gather_tree

        return gather_tree(self._carry, self.mesh, self.device)

    def carry_rows(self, lo: int = 0, hi: "int | None" = None, field: "str | None" = None):
        """Rows ``[lo, hi)`` of the carry (all by default), or of its field
        ``field`` (``"params"``, ``"ddm"``, ...): views of the carry on one
        device; on a mesh only those rows of the shards that hold them,
        joined on the first device. None before any state."""
        if self._carry is None:
            return None
        hi = self.partitions if hi is None else hi
        if self.mesh is None:
            tree = self._carry if field is None else getattr(self._carry, field)
            return _tree_map(lambda x: x[lo:hi], tree)
        from ..parallel.mesh import tree_rows

        shards = self._carry if field is None else [getattr(c, field) for c in self._carry]
        return tree_rows(shards, [(a, b) for a, b, _ in self._shards], self.mesh, lo, hi,
                         self.device)

    def set_carry_rows(self, lo: int, rows: LoopCarry) -> None:
        """Set rows ``[lo, lo + n)`` of the carry to ``rows`` (a carry of
        ``n`` rows, :meth:`carry_rows`' shape): the shards that hold them
        get new leaves; the carry's own leaves are never written."""
        assert self._carry is not None, "no state yet (feed or restore first)"
        if self.mesh is None:
            def scatter(leaf, sub):
                leaf = leaf.clone() if isinstance(leaf, torch.Tensor) else np.array(leaf)
                leaf[lo:lo + sub.shape[0]] = sub
                return leaf

            self._carry = _tree_map(scatter, self._carry, rows)
            return
        from ..parallel.mesh import set_tree_rows

        self._carry = set_tree_rows(self._carry, [(a, b) for a, b, _ in self._shards],
                                    self.mesh, lo, rows)

    @carry.setter
    def carry(self, value) -> None:
        if self.mesh is None or value is None:
            self._carry = value
            return
        from ..parallel.mesh import split_tree

        self._carry = split_tree(value, self.mesh)

    def _init_carry(self, first: Batches, lo: int = 0, hi: "int | None" = None) -> LoopCarry:
        """The fresh carry of plane rows ``[lo, hi)`` (all by default) from
        the first chunk's planes of those rows."""
        p = self.tenant_partitions
        hi = self.partitions if hi is None else hi
        dev = first.y.device
        keys = concat_keys([threefry.split(threefry.key(s), p) for s in self.tenant_seeds])
        init_keys = threefry.split(keys, 2)[lo:hi]  # [rows, 2, 2]
        init_key = device_keys(init_keys[:, 1], dev) if self.model.keyed else None
        return LoopCarry(
            params=self.model.init(hi - lo, dev, key=init_key),
            ddm=self._detector.init((hi - lo,), dev),
            a_X=first.X[:, 0].float().contiguous(),  # the transport-dtype seam
            a_y=first.y[:, 0].contiguous(),
            a_w=first.valid[:, 0].float(),
            retrain=torch.ones(hi - lo, dtype=torch.bool, device=dev),
            key=init_keys[:, 0],
        )

    def _fresh(self, batches):
        """The fresh carry of a placed chunk's planes: one device's, or a
        list a shard on a mesh."""
        if self.mesh is None:
            return self._init_carry(batches)
        from ..parallel.mesh import run_shards

        return run_shards([d for _, _, d in self._shards], self._init_carry, batches,
                          [lo for lo, _, _ in self._shards], [hi for _, hi, _ in self._shards])

    def _fresh_whole(self, batches) -> LoopCarry:
        """:meth:`_fresh` as one whole carry (a template)."""
        fresh = self._fresh(batches)
        if self.mesh is None:
            return fresh
        from ..parallel.mesh import gather_tree

        return gather_tree(fresh, self.mesh, self.device)

    def place(self, chunk) -> PlacedChunk:
        """Start the upload of a host chunk (numpy ``Batches``) to the
        detector's device and return it placed; a placed chunk or one of
        tensors on the device passes through. On the card the planes are
        copied into a pinned staging set and sent with ``non_blocking``
        copies on the upload stream; :meth:`feed` orders its compute after
        the copy's event. :meth:`run` places chunk k+1 right after feeding
        chunk k, so the upload overlaps the detect."""
        if isinstance(chunk, PlacedChunk):
            return chunk
        if self.mesh is not None:
            from ..parallel.mesh import split_tree

            whole = Batches(*(
                leaf if isinstance(leaf, torch.Tensor) else _host_leaf(leaf) for leaf in chunk
            ))
            return PlacedChunk(tuple(
                b._replace(X=_widen(b.X)) for b in split_tree(whole, self.mesh)
            ), None)
        if isinstance(chunk.y, torch.Tensor):
            leaves = [leaf.to(self.device) for leaf in chunk]
            leaves[0] = _widen(leaves[0])
            return PlacedChunk(Batches(*leaves), None)
        if self.device.type == "cpu":
            leaves = [_host_leaf(a) for a in chunk]
            leaves[0] = _widen(leaves[0])
            return PlacedChunk(Batches(*leaves), None)
        staging = self._staging[self._next_staging]
        self._next_staging ^= 1
        pinned = staging.fill(chunk)
        with torch.cuda.stream(self._upload_stream):
            leaves = [t.to(self.device, non_blocking=True) for t in pinned]
            ready = torch.cuda.Event()
            ready.record(self._upload_stream)
        staging.event = ready
        leaves[0] = _widen(leaves[0])
        return PlacedChunk(Batches(*leaves), ready)

    def _ready(self, placed: PlacedChunk) -> Batches:
        """The placed planes, with the compute stream ordered after their
        upload (and the allocator told they are used there)."""
        if placed.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(placed.ready)
            for leaf in placed.batches:
                leaf.record_stream(stream)
        return placed.batches

    def _run_one(self, carry: LoopCarry, chunk: Batches):
        if self.window > 1:
            return self._span(carry, chunk)
        table, labels, idx = dense_table(chunk.X, chunk.y)
        return run_steps(self._step, self.model, carry, table, labels, idx,
                         chunk.rows, chunk.valid, shuffle=self.shuffle)

    def _run_chunk(self, carry, chunk):
        """One chunk through the engine: ``(carry, flags)``. On a mesh each
        shard runs its rows on its device and the flags are joined on the
        first."""
        if self.mesh is None:
            return self._run_one(carry, chunk)
        from ..parallel.mesh import join_flags, run_shards

        outs = run_shards([d for _, _, d in self._shards], self._run_one, carry, chunk)
        return [c for c, _ in outs], join_flags([f for _, f in outs], self.device)

    def _drop_first(self, batches):
        """The planes past each partition's first microbatch (it seeds
        ``batch_a``)."""
        if self.mesh is None:
            return Batches(*(leaf[:, 1:] for leaf in batches))
        return tuple(Batches(*(leaf[:, 1:] for leaf in b)) for b in batches)

    def feed(self, chunk) -> FlagRows:
        """Process one ``[P, CB, B]`` chunk (host, placed or on the
        device); returns its flags ``[P, CB']`` as tensors on the device.
        The first chunk loses its first microbatch to ``batch_a``."""
        from ..resilience import faults

        # Fault-injection site: "raise at chunk K", before any state advances.
        faults.fire("chunked.feed", batches_done=self.batches_done)
        if self._feed_started is None:
            self._feed_started = time.monotonic()
        batches = self._ready(self.place(chunk))
        ys = [batches.y] if self.mesh is None else [b.y for b in batches]
        self._per_batch = int(ys[0].shape[2])
        self.rows_done += sum(int(y.numel()) for y in ys)
        if self._carry is None:
            self._carry = self._fresh(batches)
            batches = self._drop_first(batches)
        self._carry, flags = self._run_chunk(self._carry, batches)
        self.batches_done += int((batches.y if self.mesh is None else batches[0].y).shape[1])
        return flags

    def prepare(self, example_chunk) -> dict:
        """Build the path's kernels and launch the path once at the chunk
        geometry of ``example_chunk`` — both shapes a fresh detector feeds
        (the first chunk, one microbatch short, and a full one; a restored
        detector only the latter) — on a copy of the carry, before any
        traffic. Returns the JAX package's keys ``{aot_seconds,
        aot_shapes, aot_failed}``; a build or launch failure raises."""
        from ..api import build_kernels, kernel_names

        t0 = time.perf_counter()
        build_kernels(kernel_names(self.model.name, self._detector.name, self.shuffle),
                      self.device)
        chunk = self._ready(self.place(example_chunk))
        fresh = self._carry is None
        template = self._fresh(chunk) if fresh else self._carry
        shapes = [self._drop_first(chunk)] if fresh else []
        shapes.append(chunk)
        done = 0
        for s in shapes:
            sig = _shape_sig(s if self.mesh is None else s[0])
            if sig in self._prepared:
                continue
            self._run_chunk(template, s)
            synchronize(self.device)
            self._prepared.add(sig)
            done += 1
        return {"aot_seconds": time.perf_counter() - t0, "aot_shapes": done,
                "aot_failed": False}

    def record_memory_gauges(self, metrics, when: str = "chunk") -> None:
        """Record the card's memory into a metrics registry
        (``device_bytes_in_use{when=...}`` and its peak,
        ``telemetry.profile``); a no-op on the CPU."""
        from ..telemetry.profile import device_memory_stats, record_device_memory_gauges

        record_device_memory_gauges(metrics, device_memory_stats(self.device), when=when)

    def emit_chunk_event(self, telemetry, chunk: int, flags: FlagRows, metrics=None):
        """Emit one chunk's ``chunk_completed`` event; returns ``(flags, the
        chunk's detection count)``. The count is reduced where the flags
        are and only the scalar reaches the host (the event waits for the
        chunk's compute); the flag table itself stays deferred."""
        detections = int((flags.change_global >= 0).sum())
        telemetry.emit(
            "chunk_completed", chunk=chunk, batches_done=self.batches_done,
            detections=detections,
        )
        if metrics is not None:
            self.record_memory_gauges(metrics)
        return flags, detections

    def emit_heartbeat(self, telemetry) -> dict:
        """Emit the liveness beacon: rows fed so far and monotonic seconds
        since the first ``feed`` (host bookkeeping only)."""
        elapsed = (
            time.monotonic() - self._feed_started if self._feed_started is not None else 0.0
        )
        return telemetry.emit(
            "heartbeat", rows_done=self.rows_done, elapsed_s=elapsed,
            batches_done=self.batches_done,
        )

    def run(self, chunks: Iterator, progress=None, telemetry=None, metrics=None,
            collect_every: int = 0, tracer=None) -> FlagRows:
        """Drain an iterator of chunks; returns the flags concatenated on
        the host (numpy leaves ``[P, Σ CB']``).

        Chunk k+1 is placed (its upload started) right after chunk k is
        fed, so upload and detect overlap. ``collect_every`` brings the
        accumulated flag tables to the host every N chunks (0: at the end,
        or every ``DEFAULT_TELEMETRY_COLLECT_EVERY`` on a telemetered
        drain); the flags are the same at any grouping. ``telemetry`` (an
        ``EventLog``) emits ``chunk_completed`` then ``heartbeat`` a chunk;
        ``metrics`` records the memory gauges and the ``upload`` stage's
        busy seconds (``io.feeder.STAGE_BUSY_METRIC``). ``validate``
        audits the flag table at the end. ``tracer`` (a
        :class:`..telemetry.tracing.ChunkTracer`, requires ``telemetry``)
        emits one ``kernel`` span per head-sampled chunk, from the feed to
        the chunk event's host read of its detection count: the chunk's
        window on the host clock (no device timestamps are taken)."""
        if not collect_every and telemetry is not None:
            collect_every = DEFAULT_TELEMETRY_COLLECT_EVERY
        start_batches = self.batches_done
        out = []
        uncollected = 0  # trailing entries of `out` still on the device
        c_stage = None
        if metrics is not None:
            from ..io.feeder import STAGE_BUSY_HELP, STAGE_BUSY_METRIC

            c_stage = metrics.counter(STAGE_BUSY_METRIC, help=STAGE_BUSY_HELP)

        def to_host(flags):
            return FlagRows(*(
                leaf.cpu().numpy() if isinstance(leaf, torch.Tensor) else leaf
                for leaf in flags
            ))

        def place_timed(chunk):
            if chunk is None:
                return None
            t0 = time.perf_counter()
            placed = self.place(chunk)
            if c_stage is not None:
                c_stage.inc(time.perf_counter() - t0, stage="upload")
            return placed

        it = iter(chunks)
        host_chunk = next(it, None)  # the host copy (adaptation window rows)
        placed = place_timed(host_chunk)
        i = 0
        while placed is not None:
            cur_host = host_chunk
            t_feed = time.perf_counter()
            t_feed_mono = time.monotonic()
            flags = self.feed(placed)
            if c_stage is not None:
                c_stage.inc(time.perf_counter() - t_feed, stage="upload")
            host_chunk = next(it, None)
            placed = place_timed(host_chunk)  # overlaps this chunk's detect
            if self._on_drift is not None:
                self._ensure_adapt(cur_host, telemetry)
            if self.adapt is not None and self.adapt.active:
                # the hook reads host flags, so this chunk's flags come to
                # the host here rather than at the group boundary
                flags = to_host(flags)
                per_tenant_rows = self.rows_done // self.tenants
                self.adapt.on_chunk(
                    {
                        "chunk": i,
                        "rows_through": self.rows_done,
                        "t_rows_through": [per_tenant_rows] * self.tenants,
                    },
                    flags,
                    cur_host,
                )
            if telemetry is not None:
                flags, _ = self.emit_chunk_event(telemetry, i, flags, metrics)
                self.emit_heartbeat(telemetry)
                if tracer:
                    # the chunk event read this chunk's detection count on
                    # the host, so "now" closes the span
                    tracer.span(
                        "kernel", i, t_feed_mono, time.monotonic(),
                        batches_done=self.batches_done,
                    )
            elif metrics is not None:
                self.record_memory_gauges(metrics)
            out.append(flags)
            uncollected += 1
            if collect_every and uncollected >= collect_every:
                for j in range(len(out) - uncollected, len(out)):
                    out[j] = to_host(out[j])
                uncollected = 0
            if progress is not None:
                progress(i, self.batches_done)
            i += 1
        host = [to_host(f) for f in out]
        if host:
            flags = FlagRows(*(np.concatenate(xs, axis=1) for xs in zip(*host)))
        else:
            empty = np.zeros((self.partitions, 0), np.int32)
            flags = FlagRows(empty, empty, empty, empty, empty.astype(bool))
        if self.validate and self._per_batch is not None:
            from ..utils.validate import validate_flag_rows

            validate_flag_rows(
                flags, self.batches_done - start_batches + 1, self._per_batch, self.rows_done
            )
        return flags

    def _ensure_adapt(self, chunk, telemetry) -> None:
        """Resolve the ``on_drift`` hook into a live controller on the
        first drained chunk (policy specs need the chunk geometry).
        Idempotent."""
        if self.adapt is not None or self._on_drift is None:
            return
        from ..adapt.refit import AdaptationController

        if isinstance(self._on_drift, AdaptationController):
            self.adapt = self._on_drift
            return
        from ..adapt.policy import resolve_policies

        specs = [self._on_drift] if isinstance(self._on_drift, str) else list(self._on_drift)
        cb, per_batch = int(chunk.y.shape[1]), int(chunk.y.shape[2])
        self.adapt = AdaptationController(
            self,
            resolve_policies(specs, self.tenants),
            per_batch=per_batch,
            num_features=int(chunk.X.shape[3]),
            rows_per_chunk=self.tenant_partitions * cb * per_batch,
            log=telemetry,
            seed=self._seed,
        )

    # -- tenant plane --------------------------------------------------------

    def tenant_flags(self, flags: FlagRows) -> "list[FlagRows]":
        """Split a stacked ``[T·P, CB']`` flag table into per-tenant ``[P,
        CB']`` views (``parallel.mesh.split_tenant_flags``)."""
        from ..parallel.mesh import split_tenant_flags

        return split_tenant_flags(flags, self.tenants)

    def _tenant_span(self, tenant: int) -> "tuple[int, int]":
        if not 0 <= tenant < self.tenants:
            raise ValueError(f"tenant {tenant} out of range (detector has {self.tenants})")
        p = self.tenant_partitions
        return tenant * p, (tenant + 1) * p

    def tenant_carry(self, tenant: int) -> LoopCarry:
        """Tenant ``t``'s slice of the carry: structurally a solo
        P-partition detector's carry."""
        assert self._carry is not None, "no state yet (feed or restore first)"
        return self.carry_rows(*self._tenant_span(tenant))

    def save_tenant(self, path: str, tenant: int, extra_meta: "dict | None" = None) -> None:
        """Checkpoint one tenant's state as a solo-shaped checkpoint, which
        a ``tenants=1`` detector can :meth:`restore` and a tenant plane can
        :meth:`restore_tenant`; ``extra_meta`` rides in the JSON meta."""
        from ..utils.checkpoint import save_checkpoint

        save_checkpoint(
            path,
            self.tenant_carry(tenant),
            meta={
                "batches_done": self.batches_done,
                "partitions": self.tenant_partitions,
                "tenant": tenant,
                **(extra_meta or {}),
            },
        )

    def restore_tenant(self, path: str, tenant: int, example_chunk=None) -> dict:
        """Load a solo-shaped checkpoint into tenant slot ``t`` of the
        carry (the inverse of :meth:`save_tenant`); the other tenants'
        states are untouched. The detector must hold a carry already, or
        be given ``example_chunk`` to build a fresh plane first.
        ``batches_done`` stays the plane's own."""
        from ..utils.checkpoint import load_checkpoint

        if self._carry is None and example_chunk is not None:
            self._carry = self._fresh(self._ready(self.place(example_chunk)))
        assert self._carry is not None, (
            "restore_tenant needs an existing carry (feed or restore the "
            "plane first, or pass example_chunk)"
        )
        lo, hi = self._tenant_span(tenant)
        loaded, meta = load_checkpoint(path, self.carry_rows(lo, hi))
        if int(meta.get("partitions", self.tenant_partitions)) != self.tenant_partitions:
            raise ValueError(
                f"checkpoint {path} holds {meta.get('partitions')} partitions; "
                f"this plane's tenants carry {self.tenant_partitions}"
            )
        self.set_carry_rows(lo, loaded)
        return meta

    # -- checkpoint / resume -------------------------------------------------

    def save(self, path: str) -> None:
        from ..utils.checkpoint import save_checkpoint

        assert self._carry is not None, "nothing to checkpoint yet"
        save_checkpoint(
            path,
            self.carry,
            meta={
                "batches_done": self.batches_done,
                "partitions": self.partitions,
                **({"tenants": self.tenants} if self.tenants != 1 else {}),
            },
        )

    def restore(self, path: str, example_chunk=None) -> dict:
        """Resume from a checkpoint. A fresh detector needs ``example_chunk``
        (any chunk of the right shapes) to rebuild the carry structure."""
        from ..utils.checkpoint import load_checkpoint

        template = self.carry
        if template is None:
            if example_chunk is None:
                raise ValueError(
                    "restore() on a fresh detector needs example_chunk to "
                    "rebuild the carry structure"
                )
            template = self._fresh_whole(self._ready(self.place(example_chunk)))
        self.carry, meta = load_checkpoint(path, template)
        self.batches_done = int(meta["batches_done"])
        return meta
