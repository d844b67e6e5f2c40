"""The always-on serving loop on the card: chunked detection over live
admitted traffic, with verdict publication, checkpointed state, and a
graceful drain — the port's twin of the JAX package's ``serve/runner.py``.

    python -m distributed_drift_detection_tpu_torch serve \\
        --features 27 --classes 10 --telemetry-dir runs/live [...]

One :class:`ServeRunner` owns the whole lifecycle:

* **prepare** — ``api.prepare_chunked`` resolves the RunConfig into a
  :class:`~..engine.chunked.ChunkedDetector` on ``device`` (the card
  unless the caller asks for the CPU) whose kernels are built and whose
  path has run once at the chunk geometry before the first row arrives,
  so the first verdict's latency carries no ``nvcc``; a checkpoint at
  ``ServeParams.checkpoint`` restores the detector carry + stream
  position — the kill-and-resume contract (the port's own checkpoint
  format, with the JAX package's meta keys).
* **serve** — sealed microbatches from the admission layer feed the
  detector through ``place()`` (pinned staging, a side-stream upload);
  the loop keeps up to two chunks in flight (one when every chunk
  checkpoints, so every checkpoint describes exactly the published
  prefix). On the card ``feed`` returns after the chunk's detect (the
  window engine reads its pointer on the host each iteration), so the
  ``feed`` stage holds the detect and ``device`` the wait for the flags'
  copy. Each chunk's **verdict** — detection count, per-partition change
  positions, stream-position accounting — is appended to a
  ``<run-log>.verdicts.jsonl`` sidecar (flushed per line, torn-tail
  tolerant), and the run log receives the same ``chunk_completed`` /
  ``heartbeat`` / ``drift_detected`` events a batch run would, in the JAX
  package's schema.
* **drain** — SIGTERM/SIGINT (or the protocol ``STOP`` line) stops the
  ingress, flushes the partial microbatch through the validity plane,
  publishes everything in flight, writes an atomic final checkpoint, and
  flips the registry record to ``completed``.
* **trace plane** (telemetry.tracing/.forensics) — head-sampled rows
  carry a trace context through admission → microbatcher → kernel →
  verdict as ``span`` events; on a drift verdict, forensics (default on,
  needs a telemetry dir) writes an evidence bundle host-side into
  ``<run-log>.forensics/`` from the detector state entering the chunk
  (a device copy taken before the feed, brought to the host at publish).
* **ops plane** (``--ops-port``, telemetry.ops/.slo/.trace) —
  ``/metrics``, ``/healthz``, ``/statusz``; the SLO evaluator, the flight
  recorder and the incident recorder. These run on their own threads and
  read host counters only: only the serve loop's thread (the thread of
  :meth:`ServeRunner.start` and :meth:`ServeRunner.serve_forever`)
  launches a kernel or reads a device tensor.

The ``serve.flush`` fault site fires at verdict publication —
``kind='raise'`` kills the daemon after a chunk's state advanced but
before its verdict/checkpoint landed; ``torn_write`` tears the verdict
sidecar's trailing line. ``--on-drift retrain|shadow`` routes each
published verdict through the adaptation plane (``adapt/refit.py``) after
forensics, on the serve loop's thread: a tenant is refit on the device
after a drift and the fit swapped into the carry at a chunk boundary.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import threading
import time

import numpy as np

from ..config import (
    RunConfig,
    ServeParams,
    host_shuffle_seed,
    replace,
    telemetry_config_payload,
)
from ..resilience import faults
from .admission import AdmissionController, MicroBatcher

VERDICT_VERSION = 1

VERDICT_SUFFIX = ".verdicts.jsonl"


def reconcile_torn_tail(path: str) -> bool:
    """Drop a torn trailing line (no final newline) from an append-only
    JSONL sidecar; returns True when something was truncated.

    A crash mid-append leaves a partial last line — tolerable to every
    reader here (``allow_partial_tail``) *as long as it stays the last
    line*. A resumed daemon about to APPEND must remove it first, or the
    next record would concatenate into a permanently corrupt interior
    line no reader tolerates."""
    if not os.path.exists(path):
        return False
    with open(path, "rb+") as fh:
        data = fh.read()
        if not data or data.endswith(b"\n"):
            return False
        cut = data.rfind(b"\n")
        fh.truncate(cut + 1)
    return True


def find_verdicts(telemetry_dir: str) -> "str | None":
    """Newest verdict sidecar in a telemetry directory (mtime order) —
    how ``loadgen`` locates a live daemon's verdict stream."""
    paths = glob.glob(os.path.join(telemetry_dir, "*" + VERDICT_SUFFIX))
    return max(paths, key=os.path.getmtime) if paths else None


def read_verdicts(path: str, *, allow_partial_tail: bool = True) -> list[dict]:
    """Parse a verdict sidecar; tolerates one torn trailing line (the
    writer flushes per line — same crash/live-tail contract as the event
    log and quarantine sidecars)."""
    records = []
    with open(path) as fh:
        lines = fh.readlines()
    for lineno, line in enumerate(lines, 1):
        stripped = line.strip()
        if not stripped:
            continue
        try:
            rec = json.loads(stripped)
        except json.JSONDecodeError:
            if allow_partial_tail and lineno == len(lines):
                break
            raise ValueError(f"{path}:{lineno}: corrupt verdict record")
        if isinstance(rec, dict) and rec.get("kind") == "verdict":
            records.append(rec)
    return records


class ServeRunner:
    """Lifecycle owner of one serving daemon (see module docstring).

    ``keep_flags=True`` additionally accumulates every published chunk's
    host flag table — the in-process embedding tests use it for
    bit-parity against ``api.run``; a production daemon leaves it off
    (unbounded memory on an unbounded stream).
    """

    def __init__(
        self,
        cfg: RunConfig,
        params: ServeParams,
        *,
        keep_flags: bool = False,
        max_chunks: "int | None" = None,
        device="cuda",
    ):
        if params.num_features <= 0 or params.num_classes <= 0:
            raise ValueError(
                "ServeParams.num_features/num_classes must be explicit "
                f"(> 0), got {params.num_features}/{params.num_classes}"
            )
        self.tenants = max(int(cfg.tenants), 1)
        self.cfg = replace(cfg, app_name=cfg.app_name or "serve")
        self.params = params
        self.device = device
        self._stop = threading.Event()
        self._keep = [] if keep_flags else None
        self._max_chunks = max_chunks
        self.det = None
        # Multi-tenant serving (RunConfig.tenants > 1): the detector is
        # the stacked [T·P, CB, B] chunk program, the batcher the
        # per-tenant TenantMicroBatcher, and `admissions` holds one
        # AdmissionController per tenant (own running stats, own
        # quarantine sidecar, shared counters) — the ingress TENANT line
        # routes a connection's rows to its slot. `admission` stays the
        # single controller on a solo daemon (tenant 0's otherwise) so
        # existing drivers keep working.
        # Global tenant identity per slot (ServeParams.tenant_ids; the
        # fleet posture): slot s serves global tenant tenant_ids[s] with
        # THAT tenant's solo seed + stripe shuffle seed; -1 = vacant
        # spare (masked, migration landing capacity). Mutable — a
        # LOADTENANT installs the shipped tenant's identity into the
        # landing slot.
        if params.tenant_ids:
            if len(params.tenant_ids) != self.tenants:
                raise ValueError(
                    f"{len(params.tenant_ids)} tenant_ids for "
                    f"{self.tenants} tenant slot(s)"
                )
            self.tenant_ids = [int(i) for i in params.tenant_ids]
            active = [i for i in self.tenant_ids if i >= 0]
            if len(set(active)) != len(active):
                raise ValueError(
                    f"duplicate global tenant ids in {self.tenant_ids}"
                )
        else:
            self.tenant_ids = list(range(self.tenants))
        self.batcher: "MicroBatcher | None" = None
        self.admission: "AdmissionController | None" = None
        self.admissions: "list[AdmissionController]" = []
        self._ingress = None
        self._log = None
        self._metrics = None
        self._lat_hist = None
        self._ops = None
        self._slo = None
        self._slo_stop = None
        self._slo_thread = None
        self._recorder = None
        self._incidents = None  # telemetry.incident.IncidentRecorder
        self._compile_info: dict = {}
        self._last_pub_mono: "float | None" = None
        self._loop_mono: "float | None" = None  # serve-loop liveness stamp
        # Wedged-stage breadcrumb: (stage name, mono stamp) set at every
        # stage boundary REUSING the boundary's existing clock read —
        # zero extra hot-loop clock calls. Mid-stall the busy counters
        # haven't been credited yet (they land when the stage *ends*),
        # so an incident capture needs this to name the stage the loop
        # is wedged IN, not the one that last finished.
        self._loop_stage: "tuple[str, float] | None" = None
        # Pipeline observatory (telemetry.pipeline): stage busy clock,
        # wall/rows gauges, per-chunk stage-span tracer. All None when
        # params.pipeline_metrics is off — every touch point guards.
        self._stage_clock = None
        self._wall_gauge = None
        self._rows_gauge = None
        # Per-tenant hotness series (params.tenant_series): rows counter
        # labeled by GLOBAL tenant id — the history plane's ranking food.
        self._tenant_rows = None
        self._chunk_tracer = None
        self._loop_start_mono: "float | None" = None
        self._inflight_n = 0
        self._verdict_fh = None
        self.verdicts_path: "str | None" = None
        self._sampler = None  # daemon-side head sampler (trace plane)
        self._rows_traced = 0  # rows whose serving span chain was emitted
        self._forensics = None  # telemetry.forensics.ForensicsExtractor
        self._adapt = None  # adapt.refit.AdaptationController
        self._flag_base = 0  # flag columns published == batches published
        self._published = 0  # chunks published this process
        self._ckpt_at = 0
        self._rows_published = 0
        self._detections = 0
        self._last_meta: "dict | None" = None
        # slot → (stream_row, rows_admitted) installed by a LOADTENANT
        # and not yet covered by a publish: _last_meta still describes
        # the PREVIOUS occupant there, so a SAVETENANT before the next
        # publish must use the restored accounting, not the stale meta
        # (else the shipped watermark under-claims and the router
        # re-feeds rows the carry already saw)
        self._restored_accounting: "dict[int, tuple[int, int]]" = {}
        self._t_start: "float | None" = None
        self.resumed_meta: "dict | None" = None
        # Tenant-migration control surface (SAVETENANT/LOADTENANT wire
        # lines, serve.router): requests queue here (admitter thread) and
        # the serve LOOP executes them once everything sealed before the
        # request has been published — carry surgery must never race a
        # feed, and a saved slot must describe exactly the published
        # prefix. Each entry carries the batcher's seal watermark at
        # request time; `_example` is the zero-row chunk restore_tenant
        # rebuilds a fresh plane from.
        self._control: "list[dict]" = []
        self._control_lock = threading.Lock()
        self._example = None
        # Pipeline depth: 2 = double-buffered (chunk k+1 uploads while k
        # computes); 1 when every chunk checkpoints, so the carry on disk
        # always describes exactly the published verdict prefix.
        self._depth = (
            1 if (params.checkpoint and params.checkpoint_every <= 1) else 2
        )

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> dict:
        """Open telemetry, restore state, prepare the detector on the
        device (kernels built, the path launched once), start the ingress;
        returns the startup banner (host/port/artifact paths)."""
        from ..api import prepare_chunked
        from ..io.stream import stripe_chunk
        from ..telemetry import trace
        from ..telemetry.metrics import MetricsRegistry
        from ..telemetry.ops import FlightRecorder
        from ..telemetry.slo import SloEngine, parse_rules, start_evaluator

        cfg, params = self.cfg, self.params
        self._t_start = time.monotonic()
        # The registry is live regardless of telemetry persistence: the
        # ops plane scrapes it over HTTP; write_exports at drain still
        # requires a telemetry dir.
        self._metrics = MetricsRegistry()
        self._lat_hist = trace.latency_histogram(self._metrics)
        if params.pipeline_metrics:
            from ..telemetry.pipeline import (
                SERVE_ROWS_HELP,
                SERVE_ROWS_METRIC,
                SERVE_WALL_HELP,
                SERVE_WALL_METRIC,
                ServeStageClock,
            )

            self._stage_clock = ServeStageClock(self._metrics)
            self._wall_gauge = self._metrics.gauge(
                SERVE_WALL_METRIC, help=SERVE_WALL_HELP
            )
            self._rows_gauge = self._metrics.gauge(
                SERVE_ROWS_METRIC, help=SERVE_ROWS_HELP
            )
        if params.flightrec_events > 0:
            self._recorder = FlightRecorder(params.flightrec_events)
        if params.tenant_series:
            # Cardinality guard: per-tenant label values multiply every
            # scrape forever — refuse loudly rather than melt the store.
            from ..telemetry.history import (
                TENANT_ROWS_HELP,
                TENANT_ROWS_METRIC,
            )

            if self.tenants > params.tenant_series_max:
                raise ValueError(
                    f"--tenant-series refused: {self.tenants} tenants "
                    f"exceed tenant_series_max={params.tenant_series_max} "
                    "(raise the cap explicitly if you mean it)"
                )
            self._tenant_rows = self._metrics.counter(
                TENANT_ROWS_METRIC, help=TENANT_ROWS_HELP
            )
            for gid in self.tenant_ids:
                # pre-register every tenant at 0 so the series (and its
                # HELP line) is scrapeable before the first publish
                self._tenant_rows.inc(0.0, tenant=str(int(gid)))
        ident = None
        if cfg.telemetry_dir:
            from ..parallel.multihost import host_identity
            from ..telemetry.events import EventLog

            ident = host_identity()
            self._log = EventLog.open_run(
                cfg.telemetry_dir,
                name=cfg.resolved_app_name(),
                process_index=ident["process_index"],
            )
            if self._recorder is not None:
                self._log.tap = self._recorder.record
        stem = (
            os.path.splitext(self._log.path)[0]
            if self._log is not None
            else "serve"
        )
        self.verdicts_path = stem + VERDICT_SUFFIX

        self.det, compile_info = prepare_chunked(
            cfg,
            params.num_features,
            params.num_classes,
            chunk_batches=params.chunk_batches,
            # Slot s's detector seed is its GLOBAL tenant's solo seed
            # (identity mapping unless ServeParams.tenant_ids says
            # otherwise); a vacant spare keeps its positional seed — its
            # state is overwritten by the LOADTENANT that fills it.
            tenant_seeds=[
                cfg.seed + (s if self.tenant_ids[s] < 0 else self.tenant_ids[s])
                for s in range(self.tenants)
            ],
            device=self.device,
        )
        self._compile_info = dict(compile_info)
        example = stripe_chunk(
            np.zeros((0, params.num_features), np.float32),
            np.zeros((0,), np.int32),
            0,
            cfg.partitions,
            cfg.per_batch,
            params.chunk_batches,
        )
        if self.tenants > 1:
            from ..engine.loop import stack_tenants

            example = stack_tenants([example] * self.tenants)
        self._example = example
        resume = None
        if params.checkpoint and os.path.exists(params.checkpoint):
            resume = self.det.restore(params.checkpoint, example_chunk=example)
            if int(resume.get("tenants", 1)) != self.tenants:
                raise ValueError(
                    f"checkpoint {params.checkpoint} holds "
                    f"{resume.get('tenants', 1)} tenant(s); this daemon "
                    f"serves {self.tenants} — tenant planes must match "
                    "(migrate slots via ChunkedDetector.save_tenant)"
                )
            self.det.rows_done = int(resume.get("rows_done", 0))
            self._flag_base = int(resume.get("flag_cols", 0))
            self._published = int(resume.get("chunk_index", 0))
            self._ckpt_at = self._published
            self._rows_published = int(resume.get("rows_admitted", 0))
            self._detections = int(resume.get("detections", 0))
            self.resumed_meta = resume
        # A FRESH daemon starts a fresh verdict stream: truncate, so a
        # reused (untelemetered) path from an earlier run cannot leave a
        # non-monotone rows_through sequence behind. A resumed daemon
        # appends — its records continue the previous accounting — after
        # dropping any torn trailing line the crash left, so the resume
        # never manufactures a corrupt interior line.
        # (Telemetered daemons get unique per-run-log stems either way.)
        if resume is not None:
            reconcile_torn_tail(self.verdicts_path)
        self._verdict_fh = open(
            self.verdicts_path, "a" if resume is not None else "w"
        )
        if params.trace_sample > 0:
            from ..telemetry.tracing import HeadSampler

            self._sampler = HeadSampler(params.trace_sample, seed=cfg.seed)
        if (
            params.pipeline_metrics
            and params.trace_sample > 0
            and self._log is not None
        ):
            # Per-chunk stage spans on the trace plane: each sampled
            # chunk's feed/device/collect/publish windows share one
            # trace, laid out next to the row-level serving spans.
            from ..telemetry.tracing import ChunkTracer

            # seed offset: the row-tracing sampler above seeds its rng
            # with cfg.seed too — the same stream would mint identical
            # trace ids, welding chunk spans onto row traces
            self._chunk_tracer = ChunkTracer(
                self._log, params.trace_sample, seed=cfg.seed + 0x5EED
            )
        if params.forensics and self._log is not None:
            from ..telemetry.forensics import (
                FORENSICS_SUFFIX,
                ForensicsExtractor,
            )

            self._forensics = ForensicsExtractor(
                stem + FORENSICS_SUFFIX,
                run_id=self._log.run_id,
                detector_params={
                    "detector": cfg.detector,
                    **getattr(cfg, cfg.detector)._asdict(),
                },
                tenants=self.tenants,
                metrics=self._metrics,
            )
        if self.tenants > 1:
            from .admission import TenantMicroBatcher, _TenantSlot

            self.batcher = TenantMicroBatcher(
                self.tenants,
                cfg.partitions,
                cfg.per_batch,
                params.chunk_batches,
                num_features=params.num_features,
                # slot s stripes with its GLOBAL tenant's solo shuffle
                # seed (seed + tenant_ids[s]; identity mapping by
                # default) — the bit-parity contract with solo
                # daemons/batch runs, fleet-placement-invariant
                shuffle_seeds=[
                    host_shuffle_seed(self._slot_identity_cfg(s))
                    for s in range(self.tenants)
                ],
                linger_s=params.linger_s,
                # Serve meta is optional, like the solo path's .get()s: a
                # detector-plane checkpoint (ChunkedDetector.save carries
                # `tenants` but no batcher accounting) resumes detector
                # state with fresh positions, not a KeyError at startup.
                start_rows=(
                    [int(s) for s in resume["stream_rows"]]
                    if resume and "stream_rows" in resume
                    else None
                ),
                chunk_index=(
                    int(resume.get("chunk_index", 0)) if resume else 0
                ),
                rows_admitted=(
                    [int(r) for r in resume["t_rows_admitted"]]
                    if resume and "t_rows_admitted" in resume
                    else None
                ),
            )
            def _tenant_qpath(t: int) -> str:
                # Per-tenant sidecar: quarantine records must stay
                # attributable to the tenant that shipped the row — an
                # explicit path gets the same .t<k> suffix the derived
                # stem does, never one interleaved file for the plane.
                if cfg.quarantine_path:
                    root, ext = os.path.splitext(cfg.quarantine_path)
                    return f"{root}.t{t}{ext or '.jsonl'}"
                return stem + f".t{t}.quarantine.jsonl"

            self.admissions = [
                AdmissionController(
                    _TenantSlot(self.batcher, t),
                    params.num_features,
                    params.num_classes,
                    policy=cfg.data_policy,
                    quarantine_path=_tenant_qpath(t),
                    metrics=self._metrics,
                    source=f"ingress[t{t}]",
                )
                for t in range(self.tenants)
            ]
            self.admission = self.admissions[0]
        else:
            self.batcher = MicroBatcher(
                cfg.partitions,
                cfg.per_batch,
                params.chunk_batches,
                # a solo daemon serving one GLOBAL fleet tenant (single-
                # slot backend, tenant_ids=(g,)) stripes with that
                # tenant's identity; the default is host_shuffle_seed(cfg)
                shuffle_seed=host_shuffle_seed(self._slot_identity_cfg(0)),
                linger_s=params.linger_s,
                start_row=int(resume.get("stream_row", 0)) if resume else 0,
                chunk_index=(
                    int(resume.get("chunk_index", 0)) if resume else 0
                ),
                rows_admitted=(
                    int(resume.get("rows_admitted", 0)) if resume else 0
                ),
            )
            self.admission = AdmissionController(
                self.batcher,
                params.num_features,
                params.num_classes,
                policy=cfg.data_policy,
                quarantine_path=(
                    cfg.quarantine_path or stem + ".quarantine.jsonl"
                ),
                metrics=self._metrics,
            )
            self.admissions = [self.admission]
        # Adaptation plane (adapt/ subsystem): consume drift verdicts per
        # the per-tenant --on-drift policy. No spec (or all alert_only)
        # builds nothing at all — the policy-free daemon is byte-identical
        # to one that never imported the package.
        from ..adapt.policy import resolve_policies

        policies = resolve_policies(params.on_drift, self.tenants)
        if any(p.active for p in policies):
            from ..adapt.refit import ADAPT_STATE_SUFFIX, AdaptationController

            self._adapt = AdaptationController(
                self.det,
                policies,
                per_batch=cfg.per_batch,
                num_features=params.num_features,
                rows_per_chunk=self.batcher.rows_per_chunk,
                log=self._log,
                metrics=self._metrics,
                seed=cfg.seed,
            )
            if params.checkpoint and resume is not None:
                # mid-adaptation state (window buffers, probation
                # champions) resumes next to the detector carry
                self._adapt.restore(params.checkpoint + ADAPT_STATE_SUFFIX)
            # run every adaptation op once before traffic (kernels built,
            # launch plans chosen outside the serve loop)
            self._adapt.prepare(params.chunk_batches)
        if self._log is not None:
            from ..telemetry import registry as run_registry

            payload = telemetry_config_payload(cfg)
            self._log.emit(
                "run_started",
                run_id=self._log.run_id,
                config=payload,
                serve={
                    "chunk_batches": params.chunk_batches,
                    "linger_s": params.linger_s,
                    "checkpoint": params.checkpoint,
                    "resumed": resume is not None,
                },
                **(ident or {}),
            )
            self._log.emit(
                "compile_completed",
                cached=compile_info.get("cached", False),
                seconds=compile_info.get("build_seconds", 0.0),
                aot_seconds=compile_info.get("aot_seconds", 0.0),
                aot_shapes=compile_info.get("aot_shapes", 0),
            )
            run_registry.record(
                cfg.telemetry_dir,
                self._log.run_id,
                "running",
                kind="serve",
                config_digest=run_registry.config_digest(payload),
                log=os.path.basename(self._log.path),
                resumed=resume is not None,
                **(ident or {}),
            )
        if params.port is not None:
            from .ingress import IngressServer

            self._ingress = IngressServer(
                params.host,
                params.port,
                self.admissions,
                self.batcher,
                self.request_stop,
                sampler=self._sampler,
                metrics=self._metrics,
                max_frame_rows=params.max_frame_rows,
                on_control=self.request_control,
            )
            self._ingress.start()
        # SLO engine + evaluator thread: the judge must not live on the
        # serve loop — the loop being wedged is what stall_s detects.
        rules = parse_rules(params.slo)
        # metrics= exports slo_alert_active{rule} gauges: a scraper (the
        # collector, top) sees live alert state, not just the log tail.
        self._slo = SloEngine(rules, metrics=self._metrics)
        # Incident autopsy plane: alert-triggered cross-plane evidence
        # capture (telemetry.incident). Rides the SLO evaluator thread
        # via the engine's observer hook — zero serve-loop work, and the
        # verdict sidecars stay bit-identical with it on or off. Needs a
        # run log (the bundle root is the run-log stem); a log-less
        # embed simply has no incident plane.
        if params.incidents and self._log is not None:
            from ..telemetry.incident import IncidentRecorder

            self._incidents = IncidentRecorder(
                stem,
                flight=self._recorder,
                statusz_fn=self._statusz,
                pipeline_fn=self.pipeline_snapshot,
                verdicts_path=self.verdicts_path,
                store=params.incident_store or None,
                window_s=params.incident_window_s,
                metrics=self._metrics,
                max_bundles=params.incident_max,
            )
            self._slo.observer = self._incidents.on_transition
        if rules:
            self._slo_thread, self._slo_stop = start_evaluator(
                self._slo,
                self._slo_snapshot,
                self._log.emit if self._log is not None else None,
                params.slo_interval_s,
            )
        if params.ops_port is not None:
            from ..telemetry.ops import OpsServer

            self._ops = OpsServer(
                params.host,
                params.ops_port,
                metrics_fn=self._metrics.to_prometheus_text,
                health_fn=self._health,
                status_fn=self._statusz,
                incidentz_fn=(
                    self._incidents.incidentz
                    if self._incidents is not None
                    else None
                ),
            )
            self._ops.start()
            if self._log is not None and cfg.telemetry_dir:
                # Second "running" record carrying the now-bound ops
                # address: registry.runs() MERGES extras per run_id, so
                # this augments (not replaces) the first record — the
                # collector's --registry discovery scrapes this field.
                from ..telemetry import registry as run_registry

                run_registry.record(
                    cfg.telemetry_dir,
                    self._log.run_id,
                    "running",
                    kind="serve",
                    ops=f"{params.host}:{self._ops.port}",
                    **({"name": params.name} if params.name else {}),
                )
        return {
            "serving": True,
            "tenants": self.tenants,
            "tenant_ids": list(self.tenant_ids),
            "name": params.name or None,
            "host": params.host,
            # both wire protocols are always live on the socket — the
            # per-connection state machine auto-detects per message
            "wire": ["v1", "v2"] if self._ingress is not None else None,
            "port": self._ingress.port if self._ingress is not None else None,
            "ops_port": self._ops.port if self._ops is not None else None,
            "pid": os.getpid(),
            "run_log": self._log.path if self._log is not None else None,
            "verdicts": self.verdicts_path,
            "checkpoint": params.checkpoint or None,
            "resumed": resume is not None,
            "on_drift": (
                [p.on_drift for p in policies]
                if self._adapt is not None
                else None
            ),
        }

    def request_stop(self) -> None:
        """Graceful drain (signal handlers and the STOP line land here).
        Thread-safe and idempotent; the serve loop performs the drain."""
        self._stop.set()

    # -- tenant-migration control surface (serve.router) ---------------------

    def _slot_identity_cfg(self, slot: int) -> RunConfig:
        """The solo config of the GLOBAL tenant slot ``slot`` serves —
        ``config.tenant_configs``' ``seed + id`` convention, so a fleet
        daemon's slot is bit-identical to that tenant's solo run wherever
        the router places it. A vacant spare keeps its positional
        identity (masked until a LOADTENANT installs a real one)."""
        from ..config import tenant_dataset

        g = self.tenant_ids[slot]
        g = slot if g < 0 else g
        return replace(
            self.cfg,
            tenants=1,
            seed=self.cfg.seed + g,
            dataset=tenant_dataset(self.cfg.dataset, g),
        )

    def request_control(self, op: str, slot: int, path: str, reply) -> None:
        """Queue a ``SAVETENANT``/``LOADTENANT`` request (the ingress
        admitter thread lands here, strictly AFTER the admissions queued
        before the control line — wire order is stream order). The serve
        loop executes it once every chunk sealed before this moment has
        been published, so a saved slot describes exactly the published
        verdict prefix; ``reply`` receives the one ``OK``/``ERR`` line."""
        with self._control_lock:
            self._control.append(
                {
                    "op": op,
                    "slot": int(slot),
                    "path": path,
                    "reply": reply,
                    # Seals so far (continues across resume, like
                    # _published): the request may run only once these
                    # are all published.
                    "watermark": self.batcher.chunk_index,
                }
            )

    def _run_controls(self) -> None:
        """Execute every queued control that has become safe (serve-loop
        thread only; FIFO, stopping at the first not-yet-due request so
        wire order is preserved).

        Safe means: every chunk sealed before the request has been
        *published* (the migrating tenant's rows were all sealed by the
        router's FLUSH, so its verdicts are complete up to the shipped
        state) and the seal queue is empty (a sealed-but-unfed chunk
        would leave the batcher's positions ahead of the carry — an
        inconsistent snapshot). Chunks *in flight* (fed, unpublished)
        are consistent — the carry and the positions both include them —
        and their verdicts still publish from this daemon afterwards.
        The router quiesces its forwarding to this backend around a
        migration, so both conditions drain within a poll interval; an
        embedder driving controls under sustained traffic must quiesce
        the same way."""
        while self._control:
            with self._control_lock:
                if not self._control:
                    return
                ctl = self._control[0]
                if (
                    self._published < ctl["watermark"]
                    or self.batcher.depth()["queued_chunks"]
                ):
                    return
                self._control.pop(0)
            line = self._handle_control(ctl["op"], ctl["slot"], ctl["path"])
            try:
                ctl["reply"](line)
            except Exception:
                pass  # requester gone; the state change stands either way

    def _handle_control(self, op: str, slot: int, path: str) -> str:
        """One SAVETENANT/LOADTENANT, pipeline already drained past the
        watermark. Failures answer ``ERR`` and leave the daemon serving —
        a router retrying a migration must not kill the backend."""
        try:
            if not 0 <= slot < self.tenants:
                raise ValueError(
                    f"slot {slot} out of range (daemon serves "
                    f"{self.tenants} tenant(s))"
                )
            buffered = self.batcher.tenant_state(slot)["buffered"]
            if buffered:
                # Checked BEFORE any state moves: a slot snapshot under
                # buffered (unsealed) rows would record rows_admitted
                # ahead of the carry, and a load would orphan them — the
                # router FLUSHes (and quiesces) before either op.
                raise RuntimeError(
                    f"slot {slot} holds {buffered} buffered row(s); "
                    "FLUSH before SAVETENANT/LOADTENANT"
                )
            if op == "SAVETENANT":
                if not self.det.has_carry:
                    raise RuntimeError(
                        "no detector state yet (slot never saw traffic)"
                    )
                rows_admitted = self._save_tenant_slot(slot, path)
                return f"OK SAVETENANT {slot} {rows_admitted}"
            if op == "LOADTENANT":
                meta = self.det.restore_tenant(
                    path, slot, example_chunk=self._example
                )
                rows_admitted = int(meta.get("rows_admitted", 0))
                # Identity, then positions: the landing slot stripes
                # subsequent rows with the SHIPPED tenant's shuffle seed
                # and answers to its global id. A checkpoint without
                # identity meta (ChunkedDetector.save_tenant outside a
                # fleet daemon) keeps the slot's own.
                if "shuffle_seed" in meta:
                    seed = meta["shuffle_seed"]
                    self.batcher.set_tenant_identity(
                        slot, None if seed is None else int(seed)
                    )
                if "tenant_id" in meta:
                    self.tenant_ids[slot] = int(meta["tenant_id"])
                self.batcher.set_tenant_state(
                    slot,
                    int(meta.get("stream_row", 0)),
                    rows_admitted,
                )
                self._restored_accounting[slot] = (
                    int(meta.get("stream_row", 0)),
                    rows_admitted,
                )
                return f"OK LOADTENANT {slot} {rows_admitted}"
            raise ValueError(f"unknown control op {op!r}")
        except Exception as e:
            return f"ERR {op} {slot} {type(e).__name__}: {e}"

    def _save_tenant_slot(self, slot: int, path: str) -> int:
        """Write slot ``slot`` as a solo-shaped checkpoint carrying its
        stream accounting (the migration currency); returns the slot's
        ``rows_admitted`` watermark.

        The accounting comes from the last PUBLISHED chunk's meta, like
        the plane checkpoint's — the carry describes exactly the
        published prefix, and a watermark ahead of it (the batcher's
        admitted-side counters run ahead whenever rows are sealed or in
        flight) would make the router re-send NOTHING for the gap and
        silently lose those rows' verdicts past the checkpoint. The
        batcher counters are only used before the first publish (a
        freshly-resumed daemon, where admitted == published by the
        resume contract)."""
        meta = self._last_meta
        span = self.batcher.rows_per_chunk
        restored = self._restored_accounting.get(slot)
        if restored is not None:
            # landed by LOADTENANT, nothing published since: _last_meta
            # still describes the slot's PREVIOUS occupant — the shipped
            # checkpoint's accounting is the restore's, verbatim
            start_row, rows_admitted = restored
        elif meta is not None:
            if self.tenants > 1:
                start_row = int(meta["t_start_row"][slot]) + span
                rows_admitted = int(meta["t_rows_through"][slot])
            else:
                start_row = int(meta["start_row"]) + span
                rows_admitted = int(meta["rows_through"])
        else:
            st = self.batcher.tenant_state(slot)
            start_row = int(st["start_row"])
            rows_admitted = int(st["rows_admitted"])
        ident = self._slot_identity_cfg(slot)
        extra = {
            "stream_row": start_row,
            "rows_admitted": rows_admitted,
            # The migration currency's identity half: the landing slot
            # must answer to this global tenant and stripe with its solo
            # shuffle seed — placement-invariant bit-parity.
            "tenant_id": int(self.tenant_ids[slot]),
            "shuffle_seed": host_shuffle_seed(ident),
        }
        if self.params.name:
            extra["daemon"] = self.params.name
        self.det.save_tenant(path, slot, extra_meta=extra)
        return rows_admitted

    # -- ops-plane surface (read-only; served from the ops/evaluator
    # -- threads, so everything here reads GIL-atomic scalars or takes the
    # -- owning structure's lock) ---------------------------------------------

    @property
    def metrics(self):
        """The live registry (ops scrape target; bench reads quantiles)."""
        return self._metrics

    def _adm_totals(self) -> dict:
        """Pooled admission accounting across the tenant plane (a solo
        daemon's list holds its one controller)."""
        out = {
            "rows_seen": 0, "rows_quarantined": 0,
            "rows_rejected": 0, "rows_repaired": 0,
        }
        for a in self.admissions:
            out["rows_seen"] += a.rows_seen
            out["rows_quarantined"] += a.rows_quarantined
            out["rows_rejected"] += a.rows_rejected
            out["rows_repaired"] += a.rows_repaired
        return out

    def _slo_snapshot(self) -> dict:
        """Rule kind → current value (None = not measurable right now)."""
        from ..telemetry.trace import hist_quantile

        now = time.monotonic()
        p99 = hist_quantile(self._lat_hist, 0.99, stage="total")
        verdict_age = None
        if self._last_pub_mono is not None and (
            self.batcher is not None
            and self.batcher.rows_admitted > self._rows_published
        ):
            # Output staleness only means anything while work is pending:
            # an idle daemon's last verdict ages by design.
            verdict_age = now - self._last_pub_mono
        quarantine_pct = None
        adm = self._adm_totals() if self.admissions else None
        if adm is not None and adm["rows_seen"] > 0:
            quarantine_pct = (
                100.0 * adm["rows_quarantined"] / adm["rows_seen"]
            )
        # Loop liveness, not event age: works without a run log too (an
        # ops-only daemon must still tell wedged from idle), and any
        # wedge — device sync, publish, emit — blocks the loop thread.
        stall = None if self._loop_mono is None else now - self._loop_mono
        return {
            "p99_ms": None if p99 is None else p99 * 1000.0,
            "verdict_age_s": verdict_age,
            "quarantine_pct": quarantine_pct,
            "stall_s": stall,
        }

    def _health(self) -> "tuple[int, dict]":
        """The ``/healthz`` contract: (HTTP status, JSON payload)."""
        alerts = self._slo.active() if self._slo is not None else []
        poisoned = (
            self.batcher.poisoned() if self.batcher is not None else None
        )
        healthy = not alerts and poisoned is None
        payload = {
            "status": (
                ("draining" if self._stop.is_set() else "serving")
                if healthy
                else "degraded"
            ),
            "run_id": self._log.run_id if self._log is not None else None,
            "alerts": alerts,
            "poisoned": None if poisoned is None else repr(poisoned),
        }
        if any(
            a.get("rule") in ("stall_s", "p99_ms")
            or str(a.get("rule", "")).startswith("burn_rate:")
            for a in alerts
        ):
            # A wedged/slow loop names its dominant stage right in the
            # health body — the one-curl diagnosis the observatory owes.
            snap = self.pipeline_snapshot()
            if snap is not None and snap.get("dominant_stage"):
                payload["bottleneck_stage"] = snap["dominant_stage"]
        return (200 if healthy else 503), payload

    def pipeline_snapshot(self) -> "dict | None":
        """The ``/statusz`` ``pipeline`` section (also bench's
        ``serve_pipeline_s`` source): per-stage busy seconds + shares
        since the loop started, serve-loop wall, coverage (busy/wall),
        and the named dominant stage. ``None`` when the observatory is
        off (``--no-pipeline-metrics``). The busy dict is copied BEFORE
        the wall stamp, so busy-sum ≤ wall holds even against the live
        loop thread."""
        if self._stage_clock is None:
            return None
        from ..telemetry.pipeline import attribute

        busy = dict(self._stage_clock.busy)
        now = time.monotonic()
        wall = (
            now - self._loop_start_mono
            if self._loop_start_mono is not None
            else 0.0
        )
        attr = attribute(busy, wall, self._rows_published)
        # The wedged-stage breadcrumb: mid-stall, busy counters lag (a
        # stage is only credited when it ENDS), so the dominant stage
        # can misname a live wedge. current_stage is where the loop is
        # right now and for how long — the incident diagnoser's primary
        # witness for a stall.
        cur = self._loop_stage
        return {
            "busy_s": {s: round(t, 4) for s, t in sorted(busy.items())},
            "wall_s": round(wall, 4),
            "shares": {
                s: c["share"] for s, c in attr["stages"].items()
            },
            "coverage": attr.get("coverage"),
            "dominant_stage": attr["dominant_stage"],
            "current_stage": (
                {"stage": cur[0], "for_s": round(now - cur[1], 4)}
                if cur is not None
                else None
            ),
        }

    def _statusz(self) -> dict:
        """The ``/statusz`` snapshot (one JSON dict, cheap to assemble)."""
        from ..telemetry.trace import hist_quantile

        now = time.monotonic()
        batcher = self.batcher
        adm = self._adm_totals()
        p50 = hist_quantile(self._lat_hist, 0.5, stage="total")
        p99 = hist_quantile(self._lat_hist, 0.99, stage="total")
        # Per-slot stream accounting: the router's rebalance signal (a
        # hot slot's rows_admitted grows fastest; a backlogged one shows
        # buffered rows) and the fleet dashboard's per-tenant view.
        tenant_detail = None
        if batcher is not None:
            tenant_detail = [
                {
                    "tenant": t,
                    "id": self.tenant_ids[t],
                    **batcher.tenant_state(t),
                }
                for t in range(self.tenants)
            ]
        return {
            "run_id": self._log.run_id if self._log is not None else None,
            "name": self.params.name or None,
            "pid": os.getpid(),
            "uptime_s": (
                round(now - self._t_start, 3)
                if self._t_start is not None
                else None
            ),
            "draining": self._stop.is_set(),
            "tenants": self.tenants,
            "tenant_detail": tenant_detail,
            "rows": {
                "ingress_seen": adm["rows_seen"],
                "admitted": (
                    batcher.rows_admitted if batcher is not None else 0
                ),
                "published": self._rows_published,
                "quarantined": adm["rows_quarantined"],
                "rejected": adm["rows_rejected"],
                "repaired": adm["rows_repaired"],
            },
            "chunks": {
                "published": self._published,
                "inflight": self._inflight_n,
                **(batcher.depth() if batcher is not None else {}),
            },
            # Per-protocol ingress accounting (frames_v1/frames_v2/
            # decode_errors/connections); None on socketless embeddings.
            "ingress": (
                self._ingress.stats() if self._ingress is not None else None
            ),
            "rows_per_sec": (
                round(self._rows_published / (now - self._t_start), 3)
                if self._t_start is not None and now > self._t_start
                else 0.0
            ),
            "pipeline": self.pipeline_snapshot(),
            "detections": self._detections,
            "last_verdict_age_s": (
                None
                if self._last_pub_mono is None
                else round(now - self._last_pub_mono, 3)
            ),
            "latency_ms": {
                "p50": None if p50 is None else round(p50 * 1000.0, 3),
                "p99": None if p99 is None else round(p99 * 1000.0, 3),
            },
            "compile": {
                **self._compile_info,
                "compile_cache_dir": self.cfg.compile_cache_dir or None,
            },
            "checkpoint": self.params.checkpoint or None,
            "resumed": self.resumed_meta is not None,
            "alerts": self._slo.active() if self._slo is not None else [],
            "tracing": {
                "sample_rate": self.params.trace_sample,
                "rows_traced": self._rows_traced,
            },
            "forensics": {
                "enabled": self._forensics is not None,
                "bundles": (
                    self._forensics.bundles_written
                    if self._forensics is not None
                    else 0
                ),
            },
            "adaptation": (
                self._adapt.snapshot() if self._adapt is not None else None
            ),
            # Incident autopsy plane: bundle count + open alerts; None
            # when the plane is off (--no-incidents or no run log). The
            # collector lifts "count" into the fleet history store.
            "incidents": (
                self._incidents.statusz_section()
                if self._incidents is not None
                else None
            ),
        }

    # -- the loop ------------------------------------------------------------

    def serve_forever(self) -> int:
        """Run until a drain completes; returns 0. Exceptions (poisoned
        ingress, armed faults, device failures) record ``failed`` in the
        registry and propagate — a crashed daemon must read as crashed."""
        params = self.params
        inflight: list[tuple] = []
        last_hb = time.monotonic()
        stop_handled = False
        try:
            while True:
                self._loop_mono = time.monotonic()  # SLO stall_s stamp
                if self._loop_start_mono is None:
                    self._loop_start_mono = self._loop_mono
                if self._stop.is_set() and not stop_handled:
                    stop_handled = True
                    if self._ingress is not None:
                        self._ingress.stop()
                    self.batcher.flush()
                wait_start = time.monotonic()
                # Wedged-stage breadcrumbs (pipeline_snapshot's
                # current_stage): each boundary reuses the clock read it
                # already takes — no extra hot-loop time calls.
                self._loop_stage = ("seal_wait", wait_start)
                item = self.batcher.get(0.0 if inflight else params.poll_s)
                if self._stage_clock is not None:
                    # seal_wait = the loop blocked for input; folding it
                    # here (not at publish) keeps an idle loop honest.
                    now = time.monotonic()
                    self._stage_clock.add("seal_wait", now - wait_start)
                    self._wall_gauge.set(now - self._loop_start_mono)
                if item is not None:
                    # Forensics: copy the detector state ENTERING this
                    # chunk before the feed advances the carry (a device
                    # copy of a few [P] scalars on the compute stream;
                    # brought to the host at publish). None when
                    # forensics is off.
                    entry = self._capture_entry()
                    feed_start = time.monotonic()
                    self._loop_stage = ("feed", feed_start)
                    flags = self.det.feed(self.det.place(item.chunk))
                    # Row-tracing stamp: the chunk entered the device
                    # pipeline (queue stage ends, device stage begins).
                    item.meta["fed_mono"] = time.monotonic()
                    if self._stage_clock is not None:
                        # feed = place()+feed(): the upload and, on the
                        # card, the chunk's detect (the window engine
                        # syncs each iteration); the flags' copy to the
                        # host is accounted at publish as `device`
                        item.meta["_feed_start_mono"] = feed_start
                        self._stage_clock.add(
                            "feed", item.meta["fed_mono"] - feed_start
                        )
                    inflight.append(
                        (
                            flags,
                            item.meta,
                            entry,
                            # the chunk's numpy-backed host copy, kept only
                            # while forensics needs its context rows or the
                            # adaptation plane its post-drift window rows
                            (
                                item.chunk
                                if self._forensics is not None
                                or self._adapt is not None
                                else None
                            ),
                        )
                    )
                self._inflight_n = len(inflight)
                if inflight and (item is None or len(inflight) >= self._depth):
                    self._publish(*inflight.pop(0))
                    self._inflight_n = len(inflight)
                    if (
                        params.checkpoint
                        and self._published - self._ckpt_at
                        >= max(params.checkpoint_every, 1)
                    ):
                        # A checkpoint must describe exactly the published
                        # prefix, and the carry always reflects the
                        # last FED chunk — so drain the pipeline first (one
                        # deliberate bubble per checkpoint_every chunks;
                        # depth 1 makes this a no-op).
                        while inflight:
                            self._publish(*inflight.pop(0))
                            self._inflight_n = len(inflight)
                        self._save_checkpoint()
                        self._ckpt_at = self._published
                if self._control and not inflight:
                    # Migration controls (SAVETENANT/LOADTENANT): run
                    # once the pipeline has published past each request's
                    # seal watermark — never mid-feed.
                    self._run_controls()
                if (
                    self._log is not None
                    and time.monotonic() - last_hb >= params.heartbeat_s
                ):
                    self.det.emit_heartbeat(self._log)
                    last_hb = time.monotonic()
                if (
                    self._max_chunks is not None
                    and self._published >= self._max_chunks
                ):
                    self._stop.set()
                if stop_handled and not inflight and self.batcher.empty():
                    break
            self._finish()
            return 0
        except BaseException:
            self._fail()
            raise

    def _capture_entry(self):
        """Device copy of the detector state entering the next chunk
        (forensics evidence): a ``clone()`` of each leaf, queued on the
        compute stream before the next feed, so no later update of the
        carry — in place or not — reaches it. ``None`` when forensics is
        off or no carry exists yet (a fresh plane's first chunk enters
        with init state — the bundle's window stats are simply absent
        there)."""
        if self._forensics is None or not self.det.has_carry:
            return None
        from ..engine.chunked import _tree_map

        return _tree_map(_clone, self.det.carry_rows(field="ddm"))

    def _publish(self, flags, meta: dict, entry=None, chunk=None) -> None:
        """Collect one chunk's flags host-side and publish its verdict
        (the row→verdict latency endpoint). The flags and the entry state
        are brought to the host once, here; every plane after this point
        reads numpy only."""
        from ..engine.chunked import _tree_map
        from ..engine.loop import FlagRows

        pub_start = time.monotonic()  # loop blocks on the device copy here
        self._loop_stage = ("device", pub_start)
        host = FlagRows(*(_to_host(leaf) for leaf in flags))
        collected_mono = time.monotonic()  # device stage ends here
        self._loop_stage = ("collect", collected_mono)
        cg = np.asarray(host.change_global)
        changed = cg >= 0
        changes = [
            [int(p), int(b), int(cg[p, b])]
            for b, p in zip(*np.nonzero(changed.T))
        ]
        record = {
            "v": VERDICT_VERSION,
            "kind": "verdict",
            "ts": time.time(),
            # Fleet identity (serve --name): the join key a router-fronted
            # fleet's sidecar readers use against the placement journal.
            **({"daemon": self.params.name} if self.params.name else {}),
            "chunk": meta["chunk"],
            "start_row": meta["start_row"],
            "rows": meta["rows"],
            "rows_through": meta["rows_through"],
            "short": meta["short"],
            "flag_base": self._flag_base,
            "cols": int(cg.shape[1]),
            "detections": int(changed.sum()),
            "changes": changes,
        }
        if self.tenants > 1 or self.params.tenant_ids:
            # Per-tenant verdict attribution: the top-level `changes` keep
            # STACKED partition indices (tenant t's partitions are rows
            # t·P..(t+1)·P−1 of the plane); each tenant entry re-indexes
            # its own changes tenant-locally and carries its own
            # rows/rows_through accounting — the loadgen's per-tenant
            # latency attribution key. A SOLO daemon in fleet posture
            # (--tenant-ids g) emits the one entry too — the fleet
            # verdict tail joins on the entries' global ids, so a
            # single-tenant backend's verdicts must carry one (its solo
            # MicroBatcher meta lacks the t_* vectors; the whole-plane
            # accounting IS that tenant's).
            p_per = cg.shape[0] // self.tenants
            t_rows = meta.get("t_rows") or [meta["rows"]]
            t_through = meta.get("t_rows_through") or [meta["rows_through"]]
            t_start = meta.get("t_start_row") or [meta["start_row"]]
            record["tenants"] = [
                {
                    "tenant": t,
                    # global tenant identity (== t off-fleet): the key a
                    # router-fronted fleet's readers join on — a migrated
                    # tenant's verdicts continue under its OWN id in the
                    # landing daemon's sidecar
                    "id": int(self.tenant_ids[t]),
                    "rows": int(t_rows[t]),
                    "rows_through": int(t_through[t]),
                    "start_row": int(t_start[t]),
                    "detections": int(
                        changed[t * p_per : (t + 1) * p_per].sum()
                    ),
                    "changes": [
                        [int(p) - t * p_per, int(b), int(cg[p, b])]
                        for p, b, _ in changes
                        if t * p_per <= p < (t + 1) * p_per
                    ],
                }
                for t in range(self.tenants)
            ]
        trace_marks = meta.get("traces") or ()
        if trace_marks:
            # the sidecar verdict joins back to its originating packets
            record["traces"] = [m["trace_id"] for m in trace_marks]
        assembled_mono = time.monotonic()  # collect stage ends here
        # Set BEFORE the faults.fire below: a planted serve.flush stall
        # must read as publish-bound in the incident bundle.
        self._loop_stage = ("publish", assembled_mono)
        # Per-chunk latency split (admission/queue/device/collect), from
        # the stamps every seal already carries — present in BOTH
        # pipeline-metrics modes, so the sidecar schema never depends on
        # the instrumentation flag (bit-parity modulo ts/lat_ms). The
        # loadgen summary joins these to split client-observed latency.
        fed_m = meta.get("fed_mono", collected_mono)
        sealed_m = meta.get("sealed_mono", fed_m)
        lat = {
            "queue": fed_m - sealed_m,
            "device": collected_mono - fed_m,
            "collect": assembled_mono - collected_mono,
        }
        ing = meta.get("ingest_mono")
        if ing is not None and len(ing):
            lat = {"admission": sealed_m - float(np.mean(ing)), **lat}
        record["lat_ms"] = {
            k: round(max(v, 0.0) * 1000.0, 3) for k, v in lat.items()
        }
        line = json.dumps(record)
        # Fault-injection site (resilience.faults; no-op unless armed):
        # raise = die after the chunk's state advanced but before its
        # verdict landed; torn_write = tear the sidecar's trailing line.
        faults.fire(
            "serve.flush",
            fh=self._verdict_fh,
            payload=line,
            chunk=meta["chunk"],
        )
        self._verdict_fh.write(line + "\n")
        self._verdict_fh.flush()
        published_mono = time.monotonic()
        if self._lat_hist is not None:
            from ..telemetry.trace import observe_chunk_stages

            observe_chunk_stages(
                self._lat_hist,
                meta,
                fed_mono=meta.get("fed_mono", collected_mono),
                collected_mono=collected_mono,
                published_mono=published_mono,
            )
        self._last_pub_mono = published_mono
        self._flag_base += int(cg.shape[1])
        self._published += 1
        self._rows_published = int(meta["rows_through"])
        if self._tenant_rows is not None:
            # labeled by GLOBAL id (tenant_ids), same join key as the
            # verdict sidecar entries — a migrated tenant's rate follows
            # it across backends under one label value
            t_rows = meta.get("t_rows") or [meta["rows"]]
            for t in range(min(self.tenants, len(t_rows))):
                if int(t_rows[t]):
                    self._tenant_rows.inc(
                        float(int(t_rows[t])),
                        tenant=str(int(self.tenant_ids[t])),
                    )
        self._detections += int(changed.sum())
        self._last_meta = meta
        # any publish postdates every applied LOADTENANT (controls run
        # only on a drained pipeline), so its per-slot accounting now
        # covers the landed tenants — the restore overrides expire
        self._restored_accounting.clear()
        if self._keep is not None:
            self._keep.append(host)
        trace_ids: list = []
        if trace_marks and self._log is not None:
            from ..telemetry.tracing import emit_row_spans

            trace_ids = emit_row_spans(
                self._log,
                meta,
                collected_mono=collected_mono,
                published_mono=published_mono,
            )
            self._rows_traced += len(trace_ids)
        hooks_start = time.monotonic()  # publish stage ends here
        self._loop_stage = ("forensics", hooks_start)
        if self._forensics is not None and chunk is not None:
            entry_host = (
                _tree_map(_to_host, entry) if entry is not None else None
            )
            self._forensics.on_publish(
                meta,
                host,
                chunk,
                entry_host,
                log=self._log,
                trace_ids=trace_ids,
            )
        forensics_done = time.monotonic()
        self._loop_stage = ("adapt", forensics_done)
        if self._adapt is not None:
            # the reaction arm: route this verdict through the per-tenant
            # policy — forensics above explains the drift, this acts on it
            self._adapt.on_chunk(meta, host, chunk)
        adapt_done = time.monotonic()
        if self._log is not None:
            from ..telemetry.events import emit_flag_events

            self.det.emit_chunk_event(
                self._log, meta["chunk"], host, self._metrics
            )
            self.det.emit_heartbeat(self._log)
            emit_flag_events(self._log, cg, np.asarray(host.forced_retrain), 0)
        if self._stage_clock is not None:
            # Fold the whole chunk's stage timings in one place, outside
            # the dispatch window: `device` is the loop BLOCKED on the
            # host sync (the pipelined overlap already subtracted —
            # busy-conservation needs loop-thread time, not device time).
            clk = self._stage_clock
            clk.add("device", collected_mono - pub_start)
            clk.add("collect", assembled_mono - collected_mono)
            clk.add("publish", hooks_start - assembled_mono)
            clk.add("forensics", forensics_done - hooks_start)
            clk.add("adapt", adapt_done - forensics_done)
            self._rows_gauge.set(self._rows_published)
            if self._loop_start_mono is not None:
                self._wall_gauge.set(
                    time.monotonic() - self._loop_start_mono
                )
        if self._chunk_tracer:
            # Stage spans ride the trace plane per sampled chunk; the
            # device span is the TRUE device window (fed→collected),
            # which overlaps the next chunk's feed at depth 2.
            ck = meta["chunk"]
            fs = meta.get("_feed_start_mono")
            fed_span = meta.get("fed_mono", pub_start)
            if fs is not None:
                self._chunk_tracer.span("serve.feed", ck, fs, fed_span)
            self._chunk_tracer.span(
                "serve.device", ck, fed_span, collected_mono
            )
            self._chunk_tracer.span(
                "serve.collect", ck, collected_mono, assembled_mono
            )
            self._chunk_tracer.span(
                "serve.publish", ck, assembled_mono, published_mono
            )

    def _save_checkpoint(self) -> None:
        if not self.det.has_carry or self._last_meta is None:
            return
        from ..utils.checkpoint import save_checkpoint

        meta = self._last_meta
        extra = {}
        if self.tenants > 1:
            span = self.batcher.rows_per_chunk  # per-tenant grid span
            extra = {
                "tenants": self.tenants,
                "stream_rows": [
                    int(s) + span for s in meta["t_start_row"]
                ],
                "t_rows_admitted": [
                    int(r) for r in meta["t_rows_through"]
                ],
            }
        if self._adapt is not None:
            from ..adapt.refit import ADAPT_STATE_SUFFIX

            # adaptation state (window buffers, probation champions)
            # rides next to the carry — the mid-adaptation resume contract
            self._adapt.save(self.params.checkpoint + ADAPT_STATE_SUFFIX)
        if self.params.tenant_checkpoints:
            # Solo-shaped per-slot checkpoints next to the plane — the
            # migration currency (ChunkedDetector.save_tenant): a router
            # failing this daemon over LOADTENANTs these into survivors.
            # Atomic each, and written at the same drained-pipeline
            # moment as the plane, so slot and plane always agree.
            # Vacant spares (id -1) are skipped: masked state nobody can
            # land from, pure serialization waste on the checkpoint path.
            for t in range(self.tenants):
                if self.tenant_ids[t] < 0:
                    continue
                self._save_tenant_slot(
                    t, f"{self.params.checkpoint}.t{t}"
                )
        save_checkpoint(
            self.params.checkpoint,
            self.det.carry,
            meta={
                # flag columns == batches consumed (the first chunk's
                # batch_a microbatch emits no flag row), so the published
                # prefix and the carry agree by construction — checkpoints
                # are only written when nothing is in flight.
                "batches_done": self._flag_base,
                "partitions": self.det.partitions,
                "stream_row": meta["start_row"] + self.batcher.rows_per_chunk,
                "chunk_index": meta["chunk"] + 1,
                "rows_admitted": meta["rows_through"],
                "flag_cols": self._flag_base,
                "rows_done": self.det.rows_done,
                "detections": self._detections,
                **extra,
            },
        )

    def _stop_ops(self) -> None:
        """Tear down the ops plane (idempotent; both exit paths)."""
        if self._slo_stop is not None:
            self._slo_stop.set()
            self._slo_stop = None
        if self._slo_thread is not None:
            # Join before the final events land: a mid-evaluate alert
            # must not serialize AFTER run_completed ("last event" is a
            # schema contract) or race the log close.
            self._slo_thread.join(timeout=5)
            self._slo_thread = None
        if self._ops is not None:
            try:
                self._ops.stop()
            except Exception:
                pass
            self._ops = None

    def _finish(self) -> None:
        self._stop_ops()
        if self.params.checkpoint and self.det.has_carry:
            self._save_checkpoint()
        elapsed = time.monotonic() - self._t_start
        if self._log is not None:
            from ..telemetry import registry as run_registry
            from ..telemetry.metrics import write_exports

            adm = self._adm_totals()
            self._log.emit(
                "run_completed",
                rows=self._rows_published,
                seconds=elapsed,
                detections=self._detections,
                chunks=self._published,
                rows_quarantined=adm["rows_quarantined"],
                rows_rejected=adm["rows_rejected"],
                **({"tenants": self.tenants} if self.tenants > 1 else {}),
            )
            run_registry.record(
                self.cfg.telemetry_dir,
                self._log.run_id,
                "completed",
                rows=self._rows_published,
                seconds=elapsed,
                detections=self._detections,
            )
            write_exports(
                self._metrics, os.path.splitext(self._log.path)[0]
            )
            self._log.close()
        self._close_files()

    def _fail(self) -> None:
        self._stop_ops()
        try:
            if self._ingress is not None:
                self._ingress.stop()
        except Exception:
            pass
        if self._log is not None:
            try:
                from ..telemetry import registry as run_registry

                run_registry.record(
                    self.cfg.telemetry_dir, self._log.run_id, "failed"
                )
            except Exception:
                pass  # best-effort crash evidence (api.run's posture)
            # Crash flight recorder: the last N events land next to the
            # log (dump() is best-effort — it must not mask the original
            # failure). A clean drain never writes this file.
            if self._recorder is not None:
                from ..telemetry.ops import FLIGHTREC_SUFFIX

                self._recorder.dump(
                    os.path.splitext(self._log.path)[0] + FLIGHTREC_SUFFIX
                )
            # Crash incident bundle: the full cross-plane autopsy (the
            # flight ring above plus pipeline/statusz/verdict-tail
            # evidence) — the crash-only dump, generalized. Best-effort:
            # it must never mask the original failure either.
            if self._incidents is not None:
                try:
                    self._incidents.capture_crash(sys.exc_info()[1])
                except Exception:
                    pass
            self._log.close()
        self._close_files()

    def _close_files(self) -> None:
        if self._verdict_fh is not None and not self._verdict_fh.closed:
            self._verdict_fh.close()
        for adm in self.admissions:
            adm.close()

    # -- test/bench surface --------------------------------------------------

    def flags(self):
        """Concatenated host flag tables of every published chunk
        (requires ``keep_flags=True``)."""
        from ..engine.loop import FlagRows

        assert self._keep is not None, "construct with keep_flags=True"
        if not self._keep:
            return None
        return FlagRows(
            *(np.concatenate(xs, axis=1) for xs in zip(*self._keep))
        )


def _clone(leaf):
    return leaf.clone() if hasattr(leaf, "clone") else np.array(leaf)


def _to_host(leaf) -> np.ndarray:
    """One leaf as a host numpy array (a device tensor is copied once)."""
    if hasattr(leaf, "detach"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def main(argv=None, device="cuda") -> None:
    """``serve``: run the online drift-serving daemon until drained, on
    ``--device`` (default ``device``: the card)."""
    import signal

    from ..config import DATA_POLICIES, DETECTOR_NAMES

    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch serve",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--features", type=int, required=True,
                    help="feature count of every ingress row (label rides last)")
    ap.add_argument("--classes", type=int, required=True,
                    help="label domain size (labels must be 0..C-1)")
    ap.add_argument("--partitions", type=int, default=4)
    ap.add_argument("--per-batch", type=int, default=50)
    ap.add_argument("--tenants", type=int, default=1,
                    help="independent tenant streams in one compiled "
                    "kernel (wire: a TENANT k line routes a connection's "
                    "rows; per-tenant verdict attribution in the sidecar)")
    ap.add_argument("--chunk-batches", type=int, default=4,
                    help="microbatches per flushed chunk ([P,CB,B] grid)")
    ap.add_argument("--window", type=int, default=1,
                    help="speculative window width (explicit; no auto on a live stream)")
    ap.add_argument("--model", default="centroid")
    ap.add_argument("--detector", default="ddm", choices=DETECTOR_NAMES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP ingress port (0 = OS-assigned, see banner)")
    ap.add_argument("--linger-s", type=float, default=0.25,
                    help="max wait before a partial microbatch flushes short")
    ap.add_argument("--max-frame-rows", type=int, default=0,
                    help="wire-v2 decoder bound: a binary frame header "
                    "declaring more rows is refused (ERR + close) before "
                    "any allocation (0 = the codec default, "
                    "serve.wire.MAX_FRAME_ROWS)")
    ap.add_argument("--heartbeat-s", type=float, default=10.0)
    ap.add_argument("--data-policy", default="quarantine",
                    choices=DATA_POLICIES,
                    help="admission policy (serve default: quarantine; "
                    "strict rejects rows per connection, repair imputes "
                    "from running column means)")
    ap.add_argument("--telemetry-dir", default=None,
                    help="run log + verdict sidecar + registry directory")
    ap.add_argument("--checkpoint", default="",
                    help="detector-state checkpoint path (enables resume)")
    ap.add_argument("--checkpoint-every", type=int, default=1)
    ap.add_argument("--tenant-checkpoints", action="store_true",
                    help="also write one solo-shaped <checkpoint>.t<slot> "
                    "per tenant at every checkpoint — the router's "
                    "failover/migration currency (needs --checkpoint)")
    ap.add_argument("--name", default="",
                    help="fleet identity of this daemon: stamped into "
                    "every verdict record ('daemon') so a router-fronted "
                    "fleet's sidecars stay attributable per backend")
    ap.add_argument("--tenant-ids", default="",
                    help="comma-separated GLOBAL tenant id per slot "
                    "(len == --tenants; -1 = vacant spare for migration "
                    "landings): slot s serves global tenant ids[s] with "
                    "that tenant's solo seed/shuffle identity — the "
                    "fleet placement posture ('' = identity 0..T-1)")
    ap.add_argument("--mesh-tenants", type=int, default=0,
                    help="tenant-axis rows of a 2-D (tenant, partition) "
                    "device mesh: shard the stacked tenant plane over "
                    "devices (must divide --tenants and the device "
                    "count; 0 = single-device/1-D, the default)")
    ap.add_argument("--compile-cache-dir", default="",
                    help="directory the kernels are built into and loaded "
                    "from (a restarted daemon runs no nvcc)")
    ap.add_argument("--no-shuffle", action="store_true",
                    help="disable the stripe-time per-microbatch shuffle")
    ap.add_argument("--max-chunks", type=int, default=None,
                    help="drain after N published microbatches (CI/tests)")
    ap.add_argument("--ops-port", type=int, default=None,
                    help="HTTP ops plane: /metrics, /healthz, /statusz "
                    "(0 = OS-assigned, see banner; omit = no ops server)")
    ap.add_argument("--slo", action="append", default=None,
                    metavar="KIND=THRESHOLD",
                    help="SLO alert rule (p99_ms|verdict_age_s|"
                    "quarantine_pct|stall_s) or a multi-window "
                    "burn_rate=SERIES:OBJECTIVE:FAST/SLOW:FACTOR pair, "
                    "repeatable; 'none' disables. Default: stall_s=60")
    ap.add_argument("--tenant-series", action="store_true",
                    help="export serve_tenant_rows_total{tenant=<global "
                    "id>} per-tenant rows counters on /metrics — the "
                    "history plane's hotness-ranking input (cardinality-"
                    "guarded by --tenant-series-max)")
    ap.add_argument("--tenant-series-max", type=int, default=512,
                    help="refuse --tenant-series beyond this many tenant "
                    "slots instead of flooding every scrape (default 512)")
    ap.add_argument("--slo-interval-s", type=float, default=1.0,
                    help="SLO evaluator cadence (its own thread)")
    ap.add_argument("--flightrec-events", type=int, default=256,
                    help="crash flight-recorder ring capacity (0 = off)")
    ap.add_argument("--no-pipeline-metrics", action="store_true",
                    help="disable the serve-pipeline observatory "
                    "(stage busy counters, /statusz pipeline section, "
                    "per-chunk stage spans); verdict sidecars are "
                    "bit-identical either way")
    ap.add_argument("--trace-sample", type=float, default=0.0,
                    help="daemon-side head-sampling rate (0..1) for rows "
                    "the client did not TRACE-stamp: sampled rows get the "
                    "full serving span chain in the run log (0 = off, "
                    "zero hot-path work; client TRACE lines always honored)")
    ap.add_argument("--no-forensics", action="store_true",
                    help="disable drift evidence bundles "
                    "(<run-log>.forensics/; on by default with a "
                    "telemetry dir)")
    ap.add_argument("--no-incidents", action="store_true",
                    help="disable the incident autopsy plane "
                    "(<run-log>.incidents/ bundles captured when an SLO "
                    "alert fires or the daemon crashes; on by default "
                    "with a telemetry dir — verdict sidecars are "
                    "bit-identical either way)")
    ap.add_argument("--incident-store", default="",
                    help="history-store directory (collector --store): "
                    "bundles also extract the recent fleet time-series "
                    "window + top-tenant ranking from it")
    ap.add_argument("--incident-window-s", type=float, default=120.0,
                    help="history window extracted into each bundle")
    ap.add_argument("--incident-max", type=int, default=32,
                    help="bundle cap per run (alert flapping must not "
                    "fill the disk; skipped captures are counted)")
    ap.add_argument("--on-drift", action="append", default=[],
                    metavar="[T=]POLICY[,k=v...]",
                    help="drift-reaction policy (adapt/ subsystem), "
                    "repeatable: alert_only (default — verdicts only "
                    "publish), retrain (refit on a post-drift window and "
                    "hot-swap at a chunk boundary), shadow "
                    "(champion/challenger: swap gated on measured "
                    "shadow-slice error). Prefix T= targets one tenant; "
                    "knobs: window_rows, cooldown_rows, margin, epsilon")
    ap.add_argument("--device", default=device, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # Validate --on-drift at argv time (torch-free policy grammar): a bad
    # spec must fail here, not after the backend initialised.
    from ..adapt.policy import resolve_policies as _resolve_policies

    try:
        _resolve_policies(args.on_drift, args.tenants)
    except ValueError as e:
        ap.error(str(e))
    if args.tenant_checkpoints and not args.checkpoint:
        ap.error("--tenant-checkpoints needs --checkpoint (the plane stem)")
    tenant_ids: tuple = ()
    if args.tenant_ids:
        try:
            tenant_ids = tuple(
                int(s) for s in args.tenant_ids.split(",") if s.strip() != ""
            )
        except ValueError:
            ap.error(f"--tenant-ids must be comma-separated integers, "
                     f"got {args.tenant_ids!r}")
        if len(tenant_ids) != args.tenants:
            ap.error(f"--tenant-ids names {len(tenant_ids)} slot(s) but "
                     f"--tenants is {args.tenants}")

    # CLI-driven fault arming (DDD_FAULTS, the grid harness's pattern):
    # inert unless the env var is set. The ops-smoke CI job wedges the
    # serve loop with a serve.flush kind=stall this way and asserts the
    # SLO stall alert + /healthz flip without writing Python.
    armed = faults.arm_from_env()
    if armed:
        print(
            json.dumps({"armed_faults": armed}), file=sys.stderr, flush=True
        )

    cfg = RunConfig(
        model=args.model,
        detector=args.detector,
        partitions=args.partitions,
        per_batch=args.per_batch,
        tenants=args.tenants,
        window=args.window,
        seed=args.seed,
        shuffle_batches=not args.no_shuffle,
        data_policy=args.data_policy,
        telemetry_dir=args.telemetry_dir,
        compile_cache_dir=args.compile_cache_dir,
        mesh_tenant_devices=args.mesh_tenants,
        results_csv="",
    )
    params = ServeParams(
        num_features=args.features,
        num_classes=args.classes,
        host=args.host,
        port=args.port,
        chunk_batches=args.chunk_batches,
        linger_s=args.linger_s,
        max_frame_rows=args.max_frame_rows,
        checkpoint=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        tenant_checkpoints=args.tenant_checkpoints,
        tenant_ids=tenant_ids,
        name=args.name,
        heartbeat_s=args.heartbeat_s,
        ops_port=args.ops_port,
        slo=tuple(args.slo) if args.slo else ServeParams._field_defaults["slo"],
        slo_interval_s=args.slo_interval_s,
        tenant_series=args.tenant_series,
        tenant_series_max=args.tenant_series_max,
        flightrec_events=args.flightrec_events,
        trace_sample=args.trace_sample,
        pipeline_metrics=not args.no_pipeline_metrics,
        forensics=not args.no_forensics,
        on_drift=tuple(args.on_drift),
        incidents=not args.no_incidents,
        incident_store=args.incident_store,
        incident_window_s=args.incident_window_s,
        incident_max=args.incident_max,
    )
    runner = ServeRunner(cfg, params, max_chunks=args.max_chunks, device=args.device)
    banner = runner.start()
    print(json.dumps(banner), flush=True)
    # SIGTERM/SIGINT drain: flush in-flight batches, final atomic
    # checkpoint, registry → completed — then exit 0 (the smoke gate's
    # contract). A second signal falls through to the default handler.
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: runner.request_stop())
    raise SystemExit(runner.serve_forever())


if __name__ == "__main__":
    main(sys.argv[1:])
