"""Top-level API of the port: configure → run → metrics.

The twin of the JAX package's ``api.prepare`` (:413-472) and ``api.run``
(:995-1191) for a ``synth:`` stream or a CSV under the stream contract
(``data_policy``, ``io/sanitize.py``), the deterministic-fit models
(majority, centroid, gnb, linear), the ``mlp`` and ``forest`` on JAX's
threefry keys (``split(key(seed), P)``, ``utils/threefry.py``) and the
reference's host RandomForest ``rf`` (scikit-learn, on the host), every
detector of the zoo, the speculative window engine over the packed indexed
stream (dense for ``mult_data < 1`` and for a stream with quarantined rows)
or the sequential ``window=1`` engine over the dense stream, and either
collect mode. The timed
span is the reference's Final Time: ``upload`` → ``detect`` (ended by a
device synchronize) → ``collect`` (flags to the host, drift vote, delay
metric).

``RunConfig.compile_cache_dir`` names the directory the hand-written
kernels and the native CSV parser are built into and loaded from
(``kernels._build.set_build_dir``; empty: ``kernels/_build/``), the
counterpart of XLA's persistent compilation cache.

``RunConfig.telemetry_dir`` (off by default) brackets the run in the run
registry and writes its JSONL run log and metric exports, as the JAX
package's ``api.run`` does (:func:`_telemetry_bracket`,
:func:`_finish_telemetry`): the log is opened before the work and written
after the Final Time span closes, so nothing touches the timed region.

``RunConfig.profile_dir`` captures the whole Final Time span and
``trace_dir`` the detect phase with ``torch.profiler``
(``utils.timing.maybe_trace``: one Chrome trace in a timestamped session
directory); the two together raise before any work. ``validate=True``
audits the stream in ``prepare`` and the flag table after the span
(``utils/validate.py``).

``device`` is one device or a sequence of devices (``device.py``
``resolve_devices``; ``"cuda"`` is every visible card). The run shards its
plane over a :class:`~.parallel.mesh.Mesh` of them by the JAX package's
rule (:func:`_resolve_mesh`): ``mesh_devices`` (0: all), at most the
devices there are, one for a host-callback model, stepped down until it
divides the partitions, with ``mesh_tenant_devices`` rows for a tenant
plane; a width of 1 runs unsharded on the first device. The flags, vote and
metrics are the unsharded run's at every width.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from .config import (
    COLLECT_MODES,
    RunConfig,
    auto_ph_threshold,
    auto_rotations,
    auto_window,
    host_shuffle_seed,
    replace,
    resolve_quarantine_path,
    resolve_retrain_threshold,
    telemetry_config_payload,
)
from .device import is_device_sequence, resolve_devices, synchronize
from .engine.loop import FlagRows
from .io.stream import (
    StreamData,
    load_stream,
    stripe_geometry,
    stripe_partitions,
    stripe_partitions_packed,
)
from .kernels import _build
from .metrics import DelayMetrics, attribution_metrics, delay_metrics, result_row
from .models import ModelSpec, build_model
from .ops.detectors import make_detector
from .parallel.mesh import (
    Mesh,
    auto_compact_capacity,
    host_flags,
    make_mesh_runner,
    resolve_mesh,
    shard_batches,
)
from .resilience import faults
from .results import append_result
from .utils import threefry
from .utils.timing import PhaseTimer, maybe_trace


class PreparedRun(NamedTuple):
    """Everything needed to execute a configured run."""

    stream: StreamData
    batches: object  # host Batches | PackedIndexedBatches, partition-major
    runner: object  # (device batches) -> MeshRunResult
    config: RunConfig  # the resolved config (auto policies applied)
    device: torch.device  # the mesh's first device
    # {"cached": no library was rebuilt, "build_seconds": nvcc wall time}
    compile_info: dict
    mesh: "Mesh | None" = None  # None: unsharded on ``device``


class RunResult(NamedTuple):
    flags: FlagRows  # numpy leaves [P, NB-1]
    drift_vote: np.ndarray  # [NB-1]
    metrics: DelayMetrics
    total_time: float  # the reference's "Final Time" span
    timings: dict  # per-phase seconds
    stream: StreamData
    config: RunConfig
    # Path of the persisted JSONL run log — None unless cfg.telemetry_dir
    # was set.
    telemetry_path: "str | None" = None


PORTED_MODELS = ("majority", "centroid", "gnb", "linear", "mlp", "forest", "rf")


def _check_slice(cfg: RunConfig) -> None:
    """Refuse, before any work, what this port does not run yet."""
    if cfg.backend == "spark":
        raise ValueError("backend='spark' is retired, as in the JAX package")
    if cfg.backend != "jax":
        raise ValueError(f"unknown backend {cfg.backend!r}; expected 'jax'")
    if cfg.collect not in COLLECT_MODES:
        raise ValueError(
            f"unknown collect mode {cfg.collect!r}; expected one of {COLLECT_MODES}"
        )
    if cfg.collect_capacity < 0:
        raise ValueError(
            f"collect_capacity must be >= 0 (0 = auto), got {cfg.collect_capacity}"
        )
    if cfg.model not in PORTED_MODELS:  # build_model's refusal, before any work
        raise ValueError(
            f"unknown model {cfg.model!r}; expected {'|'.join(PORTED_MODELS)}"
        )
    if cfg.model == "rf":
        if cfg.mesh_devices > 1:  # as the JAX package refuses it
            raise ValueError(
                f"model {cfg.model!r} uses a host callback and cannot run on "
                f"a {cfg.mesh_devices}-device mesh; set mesh_devices=0"
            )
        from .models.rf import require_sklearn

        require_sklearn()  # before any work: the card's machine has none


def _resolve_policies(cfg: RunConfig, stream: StreamData) -> RunConfig:
    """Resolve the auto policies against the stream's geometry: the retrain
    guard per model family, then the window width, then the depth, and
    Page–Hinkley's λ (``ph.threshold == 0``)."""
    cfg = replace(cfg, retrain_error_threshold=resolve_retrain_threshold(cfg))
    cfg = replace(cfg, window=auto_window(cfg, stream.dist_between_changes))
    cfg = replace(
        cfg, window_rotations=auto_rotations(cfg, stream.dist_between_changes)
    )
    if cfg.detector == "ph":  # auto_ph_threshold passes an explicit λ through
        cfg = replace(cfg, ph=cfg.ph._replace(
            threshold=auto_ph_threshold(cfg, stream.dist_between_changes)
        ))
    return cfg


# The hand-written kernel of each detector's window statistic.
DETECTOR_KERNELS = {
    "ddm": "ddm_window", "ph": "ph_window", "hddm_w": "hddm_w_window",
    "adwin": "adwin_window",
}


# The hand-written kernels of each model's fit and predict.
MODEL_KERNELS = {
    "centroid": ("centroid_fit", "centroid_predict_err"),
    "linear": ("centroid_predict_err",),
    "mlp": ("random_normal", "mlp_fit", "mlp_predict_err"),
    "forest": ("forest_fit", "forest_predict_err"),
}


def _load_stream_for(cfg: RunConfig) -> StreamData:
    """The config's stream, through the stream contract (``io.sanitize``):
    ``strict`` raises on a dirty row, ``quarantine`` masks it and writes the
    sidecar (``resolve_quarantine_path``), ``repair`` imputes what it can
    and quarantines the rest, so it writes the sidecar too."""
    return load_stream(
        cfg.dataset,
        cfg.mult_data,
        seed=cfg.seed,
        standardize=cfg.standardize,
        data_policy=cfg.data_policy,
        quarantine_path=(
            resolve_quarantine_path(cfg)
            if cfg.data_policy in ("quarantine", "repair")
            else None
        ),
    )


def kernel_names(model: str, detector: str, shuffle: bool = False) -> list:
    """The hand-written kernels a run of ``model`` with ``detector``
    launches (with the in-loop shuffle's K13 when ``shuffle``)."""
    names = [DETECTOR_KERNELS[detector]] if detector in DETECTOR_KERNELS else []
    names += MODEL_KERNELS.get(model, ())
    return names + (["shuffle_perm"] if shuffle else [])


def build_kernels(names, dev: torch.device) -> dict:
    """On the card, build the kernels ``names`` (one nvcc each, all started
    together) and load them: ``{"cached": no library was rebuilt,
    "build_seconds": nvcc wall time}``; nothing to do on the CPU."""
    if dev.type != "cuda":
        return {"cached": True, "build_seconds": 0.0}
    from . import kernels

    cached = all(_build.library_path(name).exists() for name in names)
    t0 = time.perf_counter()
    _build.build_all(names)
    info = {"cached": cached, "build_seconds": time.perf_counter() - t0}
    for name in names:
        kernels.launcher(name)
    return info


def _resolve_mesh(cfg: RunConfig, model, devices) -> "Mesh | None":
    """The mesh a resolved ``cfg`` runs on over ``devices``
    (:func:`~.parallel.mesh.resolve_mesh`, the JAX package's
    ``_build_runner`` rule)."""
    return resolve_mesh(
        devices, cfg.partitions, mesh_devices=cfg.mesh_devices,
        tenant_devices=cfg.mesh_tenant_devices, tenants=cfg.tenants, model=model,
    )


def _build_runner(cfg: RunConfig, model, nb: int, packed: bool, devices, mesh=None):
    """The runner of a resolved ``cfg`` over ``nb`` microbatches a
    partition on its mesh (:func:`_resolve_mesh`), and its kernels built
    (:func:`build_kernels`) — the one copy :func:`prepare` and
    :func:`prepare_multi` share. Returns ``(runner, compile_info, mesh)``.
    The compaction capacity is sized from the whole plane's geometry unless
    pinned; 0 (the full-plane collect) for ``collect='full'`` and for
    ``validate=True``, whose audit wants the plane the device produced, not
    a reconstruction. A given ``mesh`` (one across processes,
    ``multihost.global_mesh``) is taken as it is."""
    if mesh is None:
        mesh = _resolve_mesh(cfg, model, devices)
    else:
        from .models.base import require_shardable

        require_shardable(model, mesh)
    capacity = (
        cfg.collect_capacity or auto_compact_capacity(cfg.partitions, max(nb - 1, 1))
        if cfg.collect == "compact" and not cfg.validate
        else 0
    )
    runner = make_mesh_runner(
        model,
        cfg.ddm,
        mesh,
        retrain_error_threshold=cfg.retrain_error_threshold,
        window=cfg.window,
        packed=packed,
        detector=make_detector(
            cfg.detector, ddm=cfg.ddm, ph=cfg.ph, eddm=cfg.eddm, hddm=cfg.hddm,
            hddm_w=cfg.hddm_w, adwin=cfg.adwin, kswin=cfg.kswin, stepd=cfg.stepd,
        ),
        rotations=cfg.window_rotations,
        compact_capacity=capacity,
    )
    # K4 compacts the flags in the timed span: built here with the others
    names = kernel_names(cfg.model, cfg.detector) + (["flag_compact"] if capacity else [])
    info = build_kernels(names, devices[0])
    return runner, info, mesh


def prepare(
    cfg: RunConfig, stream: StreamData | None = None, device="cuda", mesh=None
) -> PreparedRun:
    """Load, stripe and build a run without executing it. On the card this
    also builds the hand-written kernels the run launches, so their nvcc
    time stays outside the timed span. ``mesh`` overrides the mesh the
    config and ``device`` resolve to: a multi-process run passes
    ``multihost.global_mesh()`` and places its own stripe
    (``multihost.shard_batches_global``)."""
    if cfg.tenants != 1:
        raise ValueError(
            f"prepare() is the single-stream path (tenants={cfg.tenants}); "
            "use prepare_multi/run_multi for the stacked tenant plane"
        )
    _check_slice(cfg)
    devices = mesh.local_devices() if mesh is not None else resolve_devices(device)
    dev = devices[0]
    _build.set_build_dir(cfg.compile_cache_dir)
    if stream is None:
        stream = _load_stream_for(cfg)
    if cfg.validate:
        # Host-side ingest audit: valid rows finite, labels in 0..C-1 —
        # before any device work, outside the Final Time span.
        from .utils.validate import validate_stream

        validate_stream(stream)
    cfg = _resolve_policies(cfg, stream)
    # Duplicated streams ship packed (row table + gather indices + 1-byte
    # shuffle perms) to the window engine; subsampled ones, streams with
    # quarantined rows (a row mask is data, not geometry) and every stream
    # of the window=1 engine ride the dense striper.
    packed = stream.src is not None and cfg.window > 1 and not stream.has_masked_rows
    striper = stripe_partitions_packed if packed else stripe_partitions
    batches = striper(
        stream, cfg.partitions, cfg.per_batch, shuffle_seed=host_shuffle_seed(cfg)
    )
    model = build_model(cfg.model, ModelSpec(stream.num_features, stream.num_classes), cfg)
    _, nb = stripe_geometry(stream.num_rows, cfg.partitions, cfg.per_batch)
    runner, compile_info, mesh = _build_runner(cfg, model, nb, packed, devices, mesh)
    if model.keyed:  # the partitions' keys, as the JAX package's prepare draws
        # them: the whole plane's, a shard taking its rows
        runner = functools.partial(
            runner, key=threefry.split(threefry.key(cfg.seed), cfg.partitions)
        )
    return PreparedRun(stream, batches, runner, cfg, dev, compile_info, mesh)


def upload(batches, device: "torch.device | Mesh"):
    """Host→device copy of the striped stream (the reference's upload): to
    ``device`` whole, or cut to the shards of a :class:`Mesh`, a shared row
    table copied once per distinct device (``parallel.mesh.shard_batches``)."""
    if isinstance(device, Mesh):
        return shard_batches(batches, None, device)[0]
    return shard_batches(batches, None, None, device)[0]


def _synchronize(prep) -> None:
    """Wait for the run's queued work on every device of its mesh."""
    for d in prep.mesh.local_devices() if prep.mesh is not None else [prep.device]:
        synchronize(d)


@contextlib.contextmanager
def _telemetry_bracket(cfg: RunConfig, payload: dict, kind: "str | None" = None):
    """The run-lifecycle telemetry bracket (the JAX package's
    ``api._telemetry_bracket``): with ``cfg.telemetry_dir`` set, open the
    run log, emit ``run_started`` with ``payload`` + host identity and
    write the registry's ``running`` record; yield the log (None when
    telemetry is off — no telemetry code runs at all). On an exception the
    registry gets a best-effort ``failed`` record (the run's own exception
    is the one that surfaces) and the log's descriptor is released either
    way; the partial log is the crash evidence. The ``completed`` record
    and the final events stay with the caller. ``kind`` rides in the
    registry record when given (``multi``, ``chunked``)."""
    if not cfg.telemetry_dir:
        yield None
        return
    from .parallel.multihost import host_identity
    from .telemetry import registry as run_registry
    from .telemetry.events import EventLog

    ident = host_identity()
    log = EventLog.open_run(
        cfg.telemetry_dir,
        name=cfg.resolved_app_name(),
        process_index=ident["process_index"],
    )
    try:
        log.emit("run_started", run_id=log.run_id, config=payload, **ident)
        run_registry.record(
            cfg.telemetry_dir,
            log.run_id,
            "running",
            **({"kind": kind} if kind else {}),
            config_digest=run_registry.config_digest(payload),
            log=os.path.basename(log.path),
            **ident,
        )
        yield log
    except BaseException:
        try:
            run_registry.record(cfg.telemetry_dir, log.run_id, "failed")
        except Exception:
            pass  # the run's own error must surface, not the append's
        raise
    finally:
        log.close()


def run(
    cfg: RunConfig, stream: StreamData | None = None, device="cuda"
) -> RunResult:
    """One drift-detection run on ``device`` (the card by default; raises
    when CUDA is absent — pass ``device='cpu'`` for the plain path)."""
    if cfg.tenants != 1:
        raise ValueError(
            f"run() is the single-stream path (tenants={cfg.tenants}); the "
            "multi-tenant result is per-tenant structured — use run_multi"
        )
    dev = resolve_devices(device)[0]
    timer = PhaseTimer()
    if cfg.profile_dir and cfg.trace_dir:
        raise ValueError(
            "profile_dir and trace_dir are mutually exclusive (jax rejects "
            "nested profiler sessions): profile_dir captures the whole "
            "Final Time span, trace_dir only the detect phase — pick one"
        )
    # The payload is shared with resilience.heal, which recomputes these
    # digests from a sweep spec (config.telemetry_config_payload).
    with _telemetry_bracket(cfg, telemetry_config_payload(cfg)) as log:
        if log is not None:
            from .telemetry import registry as run_registry
        # Fault-injection site (no-op unless armed): a whole-run crash
        # inside the registry bracket, so the failed record and the partial
        # log land exactly as a real crash would leave them.
        faults.fire("api.run", run_id=None if log is None else log.run_id)
        # A telemetered run gets its own quarantine sidecar named after its
        # log: the sidecar is append-only, and a shared path would
        # interleave every trial's records. An explicit path still wins.
        if (
            log is not None
            and cfg.data_policy in ("quarantine", "repair")
            and not cfg.quarantine_path
        ):
            cfg = replace(
                cfg,
                quarantine_path=os.path.splitext(log.path)[0] + ".quarantine.jsonl",
            )
        with timer.phase("prepare"):
            prep = prepare(cfg, stream, device)
        stream, cfg = prep.stream, prep.config

        # The card's memory before the span, and the quarantine evidence:
        # both between prepare and the span, outside the timed region.
        pre_mem = None
        if log is not None:
            from .telemetry.profile import device_memory_stats

            pre_mem = device_memory_stats(dev)
            q = stream.quarantine
            if q is not None and q.rows_quarantined:
                log.emit(
                    "rows_quarantined",
                    rows=q.rows_quarantined,
                    policy=q.policy,
                    sidecar=q.sidecar,
                    repaired=q.rows_repaired,
                )

        # --- the reference's Final Time span ---
        # cfg.profile_dir wraps the whole span in a torch.profiler capture
        # and cfg.trace_dir the detect phase; the session opens before
        # `start` and closes after total_time is taken, so its start/stop
        # stays outside the measured region.
        cuda = dev.type == "cuda"
        with maybe_trace(cfg.profile_dir, cuda=cuda):
            start = time.perf_counter()
            with timer.phase("upload"):
                dev_batches = upload(prep.batches, prep.mesh or dev)
            with timer.phase("detect"), maybe_trace(cfg.trace_dir, cuda=cuda):
                out = prep.runner(dev_batches)
                _synchronize(prep)
            with timer.phase("collect"):
                flags, collect_info = host_flags(out)
                changed = (flags.change_global >= 0).astype(np.float32)
                vote = changed.sum(axis=0, dtype=np.float32) / np.float32(changed.shape[0])
                m = delay_metrics(
                    flags.change_global, stream.dist_between_changes, cfg.per_batch
                )
            total_time = time.perf_counter() - start
        # --- span ends ---

        if cfg.validate:
            from .utils.validate import validate_flag_rows

            # The batch count from the stripe geometry — independent of the
            # flag table, so the audit catches a dropped or extra boundary.
            _, nb = stripe_geometry(stream.num_rows, cfg.partitions, cfg.per_batch)
            validate_flag_rows(flags, nb, cfg.per_batch, stream.num_rows)

        if cfg.results_csv:
            a = (
                attribution_metrics(
                    flags.change_global, stream.dist_between_changes, stream.num_rows
                )
                if stream.dist_between_changes > 0
                else None
            )
            append_result(
                cfg.results_csv,
                result_row(cfg, total_time, m, stream.num_rows, attribution=a),
            )

        telemetry_path = None
        if log is not None:
            telemetry_path = _finish_telemetry(
                log, prep, timer, flags, m, stream, total_time, pre_mem,
                collect_info=collect_info,
            )
            run_registry.record(
                cfg.telemetry_dir,
                log.run_id,
                "completed",
                rows=stream.num_rows,
                seconds=total_time,
                detections=m.num_detections,
            )
    return RunResult(
        flags, vote, m, total_time, timer.as_dict(), stream, cfg, telemetry_path
    )


def _finish_telemetry(
    log, prep: PreparedRun, timer, flags: FlagRows, m: DelayMetrics,
    stream: StreamData, total_time: float, pre_mem: "dict | None" = None,
    collect_info: "dict | None" = None,
) -> str:
    """Persist the run's events and metric exports, after the span (the
    JAX package's ``api._finish_telemetry``). ``compile_completed`` carries
    ``prepare``'s kernel build: ``cached`` when no library was rebuilt,
    ``seconds`` the nvcc wall time; the AOT extras stay 0/False. The port
    has no compiler analysis (``telemetry.profile.compiled_stats``), so no
    ``cost_analysis`` event and no ``xla_*`` gauge."""
    from .io.sanitize import QUARANTINE_METRIC, QUARANTINE_METRIC_HELP
    from .telemetry import profile as _profile
    from .telemetry.events import emit_flag_events
    from .telemetry.metrics import MetricsRegistry, write_exports

    cfg = prep.config
    info = prep.compile_info
    log.emit(
        "compile_completed",
        cached=info["cached"],
        seconds=info["build_seconds"],
        window=cfg.window,
        window_rotations=cfg.window_rotations,
        aot_seconds=0.0,
        aot_cached=False,
    )
    for name, secs in timer.as_dict().items():
        log.emit("phase_completed", phase=name, seconds=secs)
    stats = _profile.compiled_stats(prep.runner)
    _profile.emit_compiled_events(log, stats, where="detect_runner")
    post_mem = _profile.device_memory_stats(prep.device)
    _profile.emit_device_memory_event(log, pre_mem, when="before_detect")
    _profile.emit_device_memory_event(log, post_mem, when="after_detect")
    emit_flag_events(
        log, flags.change_global, flags.forced_retrain, stream.dist_between_changes
    )
    # Which path the collect phase shipped, and whether the compacted table
    # overflowed into the full-plane fallback.
    collect_extras = {}
    if collect_info is not None:
        collect_extras = {
            "collect_mode": collect_info.get("mode"),
            "collect_events": collect_info.get("events"),
            "collect_overflow": bool(collect_info.get("overflow", False)),
        }
    log.emit(
        "run_completed",
        rows=stream.num_rows,
        seconds=total_time,
        detections=m.num_detections,
        rows_per_sec=stream.num_rows / total_time if total_time > 0 else None,
        **collect_extras,
    )
    log.close()

    reg = MetricsRegistry()
    det = reg.counter("detections_total", help="Drift detections by stream partition")
    for q, n in enumerate(np.asarray(m.detections_per_partition)):
        if n:
            det.inc(int(n), partition=str(q))
    reg.counter(
        "rows_processed_total", help="Stream rows through the detection loop"
    ).inc(stream.num_rows)
    if stream.quarantine is not None and stream.quarantine.rows_quarantined:
        reg.counter(QUARANTINE_METRIC, help=QUARANTINE_METRIC_HELP).inc(
            stream.quarantine.rows_quarantined
        )
    reg.gauge(
        "compile_seconds", help="Runner build time (0 on runner-cache hit)"
    ).set(info["build_seconds"])
    phase_h = reg.histogram("phase_seconds", help="Wall-clock seconds by run phase")
    for name, secs in timer.as_dict().items():
        phase_h.observe(secs, phase=name)
    _profile.record_compiled_gauges(reg, stats)
    _profile.record_device_memory_gauges(reg, pre_mem, when="before_detect")
    _profile.record_device_memory_gauges(reg, post_mem, when="after_detect")
    base, _ = os.path.splitext(log.path)
    write_exports(reg, base)
    return log.path


class PreparedMulti(NamedTuple):
    """A stacked T-tenant run ready to execute (:func:`prepare_multi`):
    ``batches`` is the ``[T·P, NB_max, B]`` host plane, ``runner`` the
    runner built against it (its keys bound), ``configs`` the tenants'
    resolved solo configs, ``config`` the stacked one (``partitions =
    T·P``), ``nb_list`` each tenant's real microbatch count (its flag width
    is ``nb_t − 1``)."""

    streams: tuple
    batches: object
    runner: object
    keys: np.ndarray  # [T·P, 2] uint32, the (tenant, partition) keys
    configs: tuple
    config: RunConfig
    nb_list: tuple
    device: torch.device  # the mesh's first device
    compile_info: dict
    mesh: "Mesh | None" = None


def _kernel_identity(cfg: RunConfig) -> tuple:
    """The config fields that shape the kernels — every tenant of a stacked
    run must agree on these (streams and seeds may differ)."""
    return (
        cfg.model, cfg.fit_steps, cfg.learning_rate, cfg.mlp_hidden,
        cfg.mlp_learning_rate, cfg.forest_trees, cfg.forest_depth,
        cfg.per_batch, cfg.partitions, cfg.ddm, cfg.window,
        cfg.retrain_error_threshold, cfg.detector, cfg.ph, cfg.eddm,
        cfg.hddm, cfg.hddm_w, cfg.adwin, cfg.kswin, cfg.stepd,
        cfg.window_rotations, cfg.shuffle_batches, cfg.collect,
        cfg.collect_capacity, cfg.validate, cfg.backend,
        cfg.mesh_devices, cfg.mesh_tenant_devices,
    )


def prepare_multi(cfg: "RunConfig | list[RunConfig]", streams=None,
                  device="cuda") -> PreparedMulti:
    """Load, stripe, stack and build a T-tenant run (the JAX package's
    ``prepare_multi``, ``api.py:515``): T independent streams, each with
    its own detector and classifier state, through one runner whose
    leading axis is the ``(tenant, partition)`` plane.

    ``cfg`` is a ``tenants = T`` config (``config.tenant_configs``: tenant
    ``t`` gets ``seed + t`` and a ``{tenant}``-substituted dataset) or a
    list of solo configs, which may differ in stream identity but must
    agree on everything that shapes the kernels (:func:`_kernel_identity`).
    Each tenant loads, resolves its auto policies (the auto knobs pinned to
    tenant 0's) and stripes as its solo run does — always on the dense
    striper — then the grids stack (``engine.loop.stack_tenants``: a short
    tenant gets masked trailing batches). Tenant ``t``'s key block is its
    solo run's ``split(key(seed_t), P)``, so each tenant's flags are its
    solo run's."""
    from .config import tenant_configs
    from .engine.loop import concat_keys, stack_tenants

    if isinstance(cfg, RunConfig):
        cfgs = tenant_configs(cfg)
    else:
        cfgs = list(cfg)
        if not cfgs:
            raise ValueError("prepare_multi needs at least one tenant config")
        for i, c in enumerate(cfgs):
            if c.tenants != 1:
                raise ValueError(
                    f"tenant config {i} has tenants={c.tenants}; explicit "
                    "config lists must hold solo (tenants=1) configs"
                )
    tenants = len(cfgs)
    _check_slice(cfgs[0])
    devices = resolve_devices(device)
    dev = devices[0]
    _build.set_build_dir(cfgs[0].compile_cache_dir)
    if streams is None:
        streams = [None] * tenants
    if len(streams) != tenants:
        raise ValueError(f"{len(streams)} streams for {tenants} tenant configs")
    resolved, loaded = [], []
    for c, s in zip(cfgs, streams):
        if s is None:
            s = _load_stream_for(c)
        if c.validate:
            from .utils.validate import validate_stream

            validate_stream(s)
        if resolved:
            # One runner, one policy: the auto knobs (window 0, rotations
            # 0, PH's λ 0) are pinned to tenant 0's resolution; explicit
            # per-tenant values reach the identity check untouched.
            c0 = resolved[0]
            if not c.window:
                c = replace(c, window=c0.window)
            if not c.window_rotations:
                c = replace(c, window_rotations=c0.window_rotations)
            if c.detector == "ph" and not c.ph.threshold:
                c = replace(c, ph=c.ph._replace(threshold=c0.ph.threshold))
        resolved.append(_resolve_policies(c, s))
        loaded.append(s)
    ident0 = _kernel_identity(resolved[0])
    spec0 = (loaded[0].num_features, loaded[0].num_classes)
    for t in range(1, tenants):
        if _kernel_identity(resolved[t]) != ident0:
            raise ValueError(
                f"tenant {t}'s resolved config shapes a different kernel "
                "than tenant 0's (model/detector/geometry/window fields "
                "must agree across the stacked plane; streams and seeds "
                "may differ)"
            )
        spec_t = (loaded[t].num_features, loaded[t].num_classes)
        if spec_t != spec0:
            raise ValueError(
                f"tenant {t}'s stream geometry {spec_t} (features, classes)"
                f" disagrees with tenant 0's {spec0}; one kernel, one row "
                "contract"
            )
    cfg0 = resolved[0]
    p, b = cfg0.partitions, cfg0.per_batch
    nb_list = tuple(stripe_geometry(s.num_rows, p, b)[1] for s in loaded)
    batches = stack_tenants([
        stripe_partitions(s, p, b, shuffle_seed=host_shuffle_seed(c))
        for c, s in zip(resolved, loaded)
    ])
    total = replace(cfg0, partitions=p * tenants, tenants=tenants)
    model = build_model(total.model, ModelSpec(*spec0), total)
    runner, compile_info, mesh = _build_runner(
        total, model, int(batches.y.shape[1]), False, devices)
    keys = concat_keys([threefry.split(threefry.key(c.seed), p) for c in resolved])
    if model.keyed:
        runner = functools.partial(runner, key=keys)
    return PreparedMulti(tuple(loaded), batches, runner, keys, tuple(resolved), total,
                         nb_list, dev, compile_info, mesh)


class MultiRunResult(NamedTuple):
    """One stacked multi-tenant run: ``results[t]`` is tenant ``t``'s
    :class:`RunResult` (flags, vote and metrics its solo run's; its
    ``total_time`` the shared span), plus the aggregate."""

    results: tuple
    total_time: float  # the one stacked Final Time span
    rows: int  # rows across tenants
    agg_rows_per_sec: float
    timings: dict
    config: RunConfig  # the stacked config (partitions = T·P)
    telemetry_path: "str | None" = None


def run_multi(cfg: "RunConfig | list[RunConfig]", streams=None,
              device="cuda") -> MultiRunResult:
    """A stacked T-tenant run on ``device`` (:func:`prepare_multi`; the
    JAX package's ``run_multi``, ``api.py:677``): one upload, one runner
    call and one collect for the tenant plane; the flags split per tenant
    on the host (``parallel.mesh.split_tenant_flags``), and each tenant
    gets its own drift vote, delay metrics and results-CSV row under its
    own config. With ``telemetry_dir`` on tenant 0's config the run is
    bracketed as a solo run is (``kind="multi"``, the payload carrying
    ``tenants``)."""
    from .parallel.mesh import split_tenant_flags, tenant_drift_vote

    timer = PhaseTimer()
    if isinstance(cfg, RunConfig):
        bracket_cfg, t_count = cfg, max(int(cfg.tenants), 1)
    else:
        if not cfg:
            raise ValueError("run_multi needs at least one tenant config")
        bracket_cfg, t_count = cfg[0], len(cfg)
    if bracket_cfg.backend != "jax":
        raise ValueError(
            f"unknown backend {bracket_cfg.backend!r}; expected 'jax' "
            "(backend='spark' is retired — see api.run)"
        )
    with _telemetry_bracket(
        bracket_cfg,
        telemetry_config_payload(replace(bracket_cfg, tenants=t_count)),
        kind="multi",
    ) as log:
        with timer.phase("prepare"):
            prep = prepare_multi(cfg, streams, device)
        tenants = len(prep.configs)
        dev = prep.device
        # --- the stacked Final Time span ---
        start = time.perf_counter()
        with timer.phase("upload"):
            dev_batches = upload(prep.batches, prep.mesh or dev)
        with timer.phase("detect"):
            out = prep.runner(dev_batches)
            _synchronize(prep)
        with timer.phase("collect"):
            flags_all, collect_info = host_flags(out)
            per_tenant = split_tenant_flags(
                flags_all, tenants, flag_cols=[nb - 1 for nb in prep.nb_list]
            )
            votes = [tenant_drift_vote(f) for f in per_tenant]
            metrics = [
                delay_metrics(f.change_global, s.dist_between_changes, c.per_batch)
                for f, s, c in zip(per_tenant, prep.streams, prep.configs)
            ]
        total_time = time.perf_counter() - start
        # --- span ends ---

        rows = sum(s.num_rows for s in prep.streams)
        results = []
        for t, (f, v, m, s, c) in enumerate(
            zip(per_tenant, votes, metrics, prep.streams, prep.configs)
        ):
            if c.validate:
                from .utils.validate import validate_flag_rows

                validate_flag_rows(f, prep.nb_list[t], c.per_batch, s.num_rows)
            if c.results_csv:
                a = (
                    attribution_metrics(f.change_global, s.dist_between_changes, s.num_rows)
                    if s.dist_between_changes > 0
                    else None
                )
                append_result(
                    c.results_csv, result_row(c, total_time, m, s.num_rows, attribution=a)
                )
            results.append(RunResult(f, v, m, total_time, timer.as_dict(), s, c, None))
        telemetry_path = None
        if log is not None:
            from .telemetry import registry as run_registry

            detections = sum(m.num_detections for m in metrics)
            log.emit(
                "run_completed",
                rows=rows,
                seconds=total_time,
                detections=detections,
                rows_per_sec=rows / total_time if total_time > 0 else None,
                tenants=tenants,
                collect_mode=collect_info.get("mode"),
                collect_overflow=bool(collect_info.get("overflow", False)),
            )
            run_registry.record(
                prep.configs[0].telemetry_dir, log.run_id, "completed",
                rows=rows, seconds=total_time, detections=detections,
            )
            telemetry_path = log.path
    return MultiRunResult(
        tuple(results),
        total_time,
        rows,
        rows / total_time if total_time > 0 else 0.0,
        timer.as_dict(),
        prep.config,
        telemetry_path,
    )


def prepare_chunked(
    cfg: RunConfig,
    num_features: int,
    num_classes: int,
    *,
    chunk_batches: int = 4,
    mesh=None,
    validate: bool = False,
    tenant_seeds=None,
    device="cuda",
):
    """Streaming twin of :func:`prepare` (the JAX package's
    ``prepare_chunked``, ``api.py:811``): a RunConfig → a
    :class:`~.engine.chunked.ChunkedDetector` on ``device`` whose kernels
    are built and whose path has run once at the serving geometry
    (``ChunkedDetector.prepare`` on an all-padding chunk of ``[P,
    chunk_batches, per_batch]``; stacked ``[T·P, ...]`` for ``cfg.tenants
    > 1``) before the first row arrives. A live stream declares no drift
    geometry, so ``cfg.window`` must be explicit, and the row geometry
    (``num_features``, ``num_classes``) is configuration. ``tenant_seeds``
    overrides the tenants' seeds (default ``seed + t``). Returns
    ``(detector, info)``: ``cached`` (no kernel library was rebuilt),
    ``build_seconds``, and ``prepare``'s ``aot_seconds``, ``aot_shapes``
    and ``aot_failed``.

    ``mesh`` shards the detector's plane (``ChunkedDetector``); without
    one, ``cfg.mesh_tenant_devices > 1`` builds the 2-D tenant mesh over
    ``device``'s devices, as the JAX package does, and a sequence of
    devices shards over them — both by :func:`run`'s rule
    (:func:`~.parallel.mesh.resolve_mesh` over the plane's tenant ·
    partition rows)."""
    from .engine.chunked import ChunkedDetector
    from .engine.loop import stack_tenants
    from .io.stream import stripe_chunk

    if cfg.window == 0:
        raise ValueError(
            "window=0 (auto) needs stream geometry a serving daemon does "
            "not have; pass an explicit width (config.auto_window can "
            "compute one from a known drift spacing)"
        )
    if num_features <= 0 or num_classes <= 0:
        raise ValueError(
            f"serving geometry must be explicit: num_features="
            f"{num_features}, num_classes={num_classes} (both must be > 0)"
        )
    if chunk_batches <= 0:
        raise ValueError(f"chunk_batches must be > 0, got {chunk_batches}")
    _build.set_build_dir(cfg.compile_cache_dir)
    t0 = time.perf_counter()
    model = build_model(cfg.model, ModelSpec(num_features, num_classes), cfg)
    if mesh is None and (cfg.mesh_tenant_devices > 1 or is_device_sequence(device)):
        mesh = resolve_mesh(
            resolve_devices(device), cfg.partitions * cfg.tenants,
            mesh_devices=cfg.mesh_devices, tenant_devices=cfg.mesh_tenant_devices,
            tenants=None, model=model,
        )
    det = ChunkedDetector(
        model,
        cfg.ddm,
        partitions=cfg.partitions,
        shuffle=False,  # streams are shuffled on the host at stripe time
        retrain_error_threshold=cfg.retrain_error_threshold,
        seed=cfg.seed,
        window=cfg.window,
        detector=make_detector(
            cfg.detector, ddm=cfg.ddm, ph=cfg.ph, eddm=cfg.eddm, hddm=cfg.hddm,
            hddm_w=cfg.hddm_w, adwin=cfg.adwin, kswin=cfg.kswin, stepd=cfg.stepd,
        ),
        rotations=cfg.window_rotations or 1,
        validate=validate,
        tenants=cfg.tenants,
        tenant_seeds=tenant_seeds,
        mesh=mesh,
        device=device,
    )
    info = build_kernels(kernel_names(cfg.model, cfg.detector), det.device)
    info["build_seconds"] = time.perf_counter() - t0
    example = stripe_chunk(
        np.zeros((0, num_features), np.float32), np.zeros((0,), np.int32), 0,
        cfg.partitions, cfg.per_batch, chunk_batches,
    )
    if cfg.tenants > 1:
        example = stack_tenants([example] * cfg.tenants)
    if not model.host_callback:
        info.update(det.prepare(example))
    return det, info
