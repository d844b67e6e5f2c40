"""Top-level API of the port: configure → run → metrics.

The twin of the JAX package's ``api.prepare`` (:413-472) and ``api.run``
(:995-1191) for a ``synth:`` stream, the deterministic-fit models
(majority, centroid, gnb, linear) and the ``mlp`` on JAX's threefry keys
(``split(key(seed), P)``, ``utils/threefry.py``), every detector of the zoo, the
speculative window engine over the packed indexed stream (dense for
``mult_data < 1``) or the sequential ``window=1`` engine over the dense
stream, and either collect mode. The timed
span is the reference's Final Time: ``upload`` → ``detect`` (ended by a
device synchronize) → ``collect`` (flags to the host, drift vote, delay
metric).

Surfaces outside this slice raise ``NotImplementedError`` naming the
ROADMAP item that ports them (:func:`_check_slice`; CSV datasets in
``io.stream.load_stream``).
"""

from __future__ import annotations

import functools
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
    resolve_retrain_threshold,
)
from .device import resolve_device, synchronize
from .engine.loop import Batches, FlagRows, PackedIndexedBatches
from .io.stream import (
    StreamData,
    load_stream,
    stripe_geometry,
    stripe_partitions,
    stripe_partitions_packed,
)
from .metrics import DelayMetrics, attribution_metrics, delay_metrics, result_row
from .models import ModelSpec, build_model
from .ops.detectors import make_detector
from .parallel.mesh import auto_compact_capacity, host_flags, make_mesh_runner
from .results import append_result
from .utils import threefry
from .utils.timing import PhaseTimer


class PreparedRun(NamedTuple):
    """Everything needed to execute a configured run."""

    stream: StreamData
    batches: object  # host Batches | PackedIndexedBatches, partition-major
    runner: object  # (device batches) -> MeshRunResult
    config: RunConfig  # the resolved config (auto policies applied)
    device: torch.device


class RunResult(NamedTuple):
    flags: FlagRows  # numpy leaves [P, NB-1]
    drift_vote: np.ndarray  # [NB-1]
    metrics: DelayMetrics
    total_time: float  # the reference's "Final Time" span
    timings: dict  # per-phase seconds
    stream: StreamData
    config: RunConfig
    telemetry_path: "str | None" = None  # telemetry is not ported: always None


PORTED_MODELS = ("majority", "centroid", "gnb", "linear", "mlp")


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
    unported = [
        (cfg.model not in PORTED_MODELS,
         f"model={cfg.model!r} (ROADMAP A9b forest, A9c rf)"),
        (cfg.tenants != 1, f"tenants={cfg.tenants} (ROADMAP A11)"),
        (cfg.mesh_devices > 1 or cfg.mesh_tenant_devices > 1,
         "a multi-device mesh (ROADMAP A15)"),
        (bool(cfg.telemetry_dir), "telemetry_dir (ROADMAP A15)"),
        (bool(cfg.profile_dir or cfg.trace_dir),
         "profile_dir/trace_dir (ROADMAP A15)"),
        (cfg.validate, "validate=True (ROADMAP A15)"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(f"not ported yet: {what}")


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
}


def prepare(
    cfg: RunConfig, stream: StreamData | None = None, device="cuda"
) -> PreparedRun:
    """Load, stripe and build a run without executing it. On the card this
    also builds the hand-written kernels the run launches, so their nvcc
    time stays outside the timed span."""
    _check_slice(cfg)
    dev = resolve_device(device)
    if stream is None:
        stream = load_stream(
            cfg.dataset, cfg.mult_data, seed=cfg.seed, standardize=cfg.standardize
        )
    cfg = _resolve_policies(cfg, stream)
    # Duplicated streams ship packed (row table + gather indices + 1-byte
    # shuffle perms) to the window engine; subsampled ones, and every
    # stream of the window=1 engine, ride the dense striper.
    packed = stream.src is not None and cfg.window > 1
    striper = stripe_partitions_packed if packed else stripe_partitions
    batches = striper(
        stream, cfg.partitions, cfg.per_batch, shuffle_seed=host_shuffle_seed(cfg)
    )
    model = build_model(cfg.model, ModelSpec(stream.num_features, stream.num_classes), cfg)
    _, nb = stripe_geometry(stream.num_rows, cfg.partitions, cfg.per_batch)
    capacity = (
        cfg.collect_capacity or auto_compact_capacity(cfg.partitions, max(nb - 1, 1))
        if cfg.collect == "compact"
        else 0
    )
    runner = make_mesh_runner(
        model,
        cfg.ddm,
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
    if model.keyed:  # the partitions' keys, as the JAX package's prepare draws them
        runner = functools.partial(
            runner, key=threefry.split(threefry.key(cfg.seed), cfg.partitions)
        )
    if dev.type == "cuda":
        from . import kernels

        if cfg.detector in DETECTOR_KERNELS:
            kernels.launcher(DETECTOR_KERNELS[cfg.detector])
        for name in MODEL_KERNELS.get(cfg.model, ()):
            kernels.launcher(name)
    return PreparedRun(stream, batches, runner, cfg, dev)


def upload(batches, device: torch.device):
    """Host→device copy of the striped stream (the reference's upload)."""

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if isinstance(batches, PackedIndexedBatches):
        return PackedIndexedBatches(
            base_X=put(batches.base_X),
            base_y=put(batches.base_y),
            idx=put(batches.idx),
            perm=put(batches.perm),
            n_rows=int(batches.n_rows),
        )
    return Batches(*(put(leaf) for leaf in batches))


def run(
    cfg: RunConfig, stream: StreamData | None = None, device="cuda"
) -> RunResult:
    """One drift-detection run on ``device`` (the card by default; raises
    when CUDA is absent — pass ``device='cpu'`` for the plain path)."""
    dev = resolve_device(device)
    timer = PhaseTimer()
    with timer.phase("prepare"):
        prep = prepare(cfg, stream, dev)
    stream, cfg = prep.stream, prep.config

    # --- the reference's Final Time span ---
    start = time.perf_counter()
    with timer.phase("upload"):
        dev_batches = upload(prep.batches, dev)
    with timer.phase("detect"):
        out = prep.runner(dev_batches)
        synchronize(dev)
    with timer.phase("collect"):
        flags, _ = host_flags(out)
        changed = (flags.change_global >= 0).astype(np.float32)
        vote = changed.sum(axis=0, dtype=np.float32) / np.float32(changed.shape[0])
        m = delay_metrics(
            flags.change_global, stream.dist_between_changes, cfg.per_batch
        )
    total_time = time.perf_counter() - start
    # --- span ends ---

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
    return RunResult(flags, vote, m, total_time, timer.as_dict(), stream, cfg)
