"""Detection-delay metrics and run records — the port's own copy of
``distributed_drift_detection_tpu/metrics.py`` (reference C10/C11/L6).

The reference computes, per detected change, ``change_position %
dist_between_changes`` (``calc_change_dist``, ``DDM_Process.py:253-256``) —
valid because planted concepts are equal-length — then drops −1 sentinel rows
(``:259``) and appends the mean plus the run configuration to a results CSV
(``:265-273``). Reproduced here over the gathered flag tables, plus
throughput fields the reference lacks (records/sec, the BASELINE.json
metric).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np

# Placeholder for results-CSV cells with nothing to attribute against —
# runs without planted-boundary geometry have no ground truth for the
# Hits/Spurious/Recall quality axes (the reference's own CSV uses "-" for
# Spark knobs with no meaning in a given mode, config.py's `memory`).
NO_ATTRIBUTION = "-"


@dataclasses.dataclass(frozen=True)
class DelayMetrics:
    num_detections: int
    mean_delay_rows: float  # mean(change_global % dist_between_changes)
    mean_delay_batches: float
    detections_per_partition: np.ndarray  # [P] i32
    delays: np.ndarray  # all individual delays (rows)


def delay_metrics(
    change_global: np.ndarray, dist_between_changes: int, per_batch: int
) -> DelayMetrics:
    """Compute delay stats from a ``[P, NB-1]`` change-position table."""
    change_global = np.asarray(change_global)
    detected = change_global >= 0
    positions = change_global[detected]
    delays = positions % dist_between_changes
    mean_rows = float(delays.mean()) if len(delays) else float("nan")
    return DelayMetrics(
        num_detections=int(detected.sum()),
        mean_delay_rows=mean_rows,
        mean_delay_batches=mean_rows / per_batch if len(delays) else float("nan"),
        detections_per_partition=detected.sum(axis=-1).astype(np.int32),
        delays=delays,
    )


@dataclasses.dataclass(frozen=True)
class AttributionMetrics:
    """Detections attributed to planted concept boundaries (quality axis).

    The reference's merge contract is about *which* changes are found —
    "every device will find the same changes" (``DDM_Process.py:89-92``) —
    so a delay number alone under-constrains quality: a model that fires
    more often can look "earlier" on mean delay while actually spraying
    extra detections. Attribution closes that loophole: each detection at
    global position ``g`` attributes to the most recent planted boundary
    (``g // dist``, boundaries at ``m·dist`` for ``m ≥ 1``); per
    (partition, boundary) the earliest attributed detection is the *first
    hit* (its delay is ``g % dist``), later ones and any detection before
    the first boundary are *spurious*. This generalises the soak's exact
    accounting (``engine.soak.planted_interior_boundaries``) to the striped
    api streams, where every partition sees every global boundary.

    ``precision`` = first hits / all detections; ``recall`` = hit
    (partition, boundary) pairs / (partitions × boundaries).
    """

    num_boundaries: int  # interior planted boundaries in the global stream
    hits: int  # (partition, boundary) pairs with >= 1 attributed detection
    misses: int  # partitions * num_boundaries - hits
    spurious: int  # non-first attributed + pre-first-boundary detections
    precision: float  # hits / num_detections (nan when no detections)
    recall: float  # hits / (partitions * num_boundaries)
    mean_first_hit_delay_rows: float  # over hit pairs only (nan when none)
    first_hit_delays: np.ndarray  # [hits] i64, rows past the boundary


def attribution_metrics(
    change_global: np.ndarray, dist_between_changes: int, num_rows: int
) -> AttributionMetrics:
    """Attribute a ``[P, NB-1]`` change-position table to planted boundaries.

    ``dist_between_changes`` is the planted concept length of the *global*
    stream (``StreamData.dist_between_changes``); boundaries sit at
    ``m·dist`` for ``1 ≤ m ≤ (num_rows − 1) // dist``. Positions are global
    row ids, so the same boundary set applies to every partition's stripe.
    """
    change_global = np.asarray(change_global)
    p = change_global.shape[0]
    dist = int(dist_between_changes)
    nb = (int(num_rows) - 1) // dist if dist > 0 else 0
    detected = change_global >= 0
    num_detections = int(detected.sum())
    if nb <= 0 or num_detections == 0:
        return AttributionMetrics(
            num_boundaries=nb,
            hits=0,
            misses=p * nb,
            spurious=num_detections,
            precision=float("nan") if num_detections == 0 else 0.0,
            recall=0.0 if nb else float("nan"),
            mean_first_hit_delay_rows=float("nan"),
            first_hit_delays=np.empty(0, np.int64),
        )

    part, _ = np.nonzero(detected)
    pos = change_global[detected].astype(np.int64)
    boundary = pos // dist  # 0 = before the first boundary -> spurious
    in_range = (boundary >= 1) & (boundary <= nb)
    # First (earliest-by-position) detection per (partition, boundary):
    # sort by position, then np.unique's first occurrence per pair is the
    # earliest (flag tables are batch-ordered and already ascending, but
    # position order is the contract, not column order).
    pb = part[in_range] * np.int64(nb + 1) + boundary[in_range]
    pos_ir = pos[in_range]
    order = np.argsort(pos_ir, kind="stable")
    _, first_idx = np.unique(pb[order], return_index=True)
    hits = int(first_idx.size)
    delays = (pos_ir[order][first_idx] % dist).astype(np.int64)
    return AttributionMetrics(
        num_boundaries=nb,
        hits=hits,
        misses=p * nb - hits,
        spurious=num_detections - hits,
        precision=hits / num_detections,
        recall=hits / (p * nb),
        # hits == 0 is reachable with detections present (all spurious —
        # e.g. every fire lands before the first boundary): nan, silently.
        mean_first_hit_delay_rows=(
            float(delays.mean()) if hits else float("nan")
        ),
        first_hit_delays=delays,
    )


# Reference C11 column schema (``DDM_Process.py:272``), kept verbatim so the
# notebook-style aggregation (C13-C15) ports unchanged; extended with
# throughput columns and the boundary-attribution quality axes (Hits /
# Spurious / Recall — the merge contract "every device finds the same
# changes", ``DDM_Process.py:89-92``, as a number per run, not only in the
# delay-parity artifact). "Spark Address" carries the backend string here.
RESULT_COLUMNS = [
    "Spark App",
    "Exp Start Time",
    "Spark Address",
    "Instances",
    "Data Multiplier",
    "Memory",
    "Cores",
    "Final Time",
    "Average Distance",
    "Dataset",
    "Per Batch",
    "Rows",
    "Rows Per Sec",
    "Detections",
    "Model",
    "Detector",
    "Hits",
    "Spurious",
    "Recall",
]


def result_row(
    cfg: Any,
    total_time: float,
    metrics: DelayMetrics,
    num_rows: int,
    attribution: AttributionMetrics | None = None,
) -> list:
    """One results-CSV row. ``attribution`` is optional so callers without
    planted-boundary geometry still record the reference columns; absent, the
    quality cells carry :data:`NO_ATTRIBUTION`."""
    return [
        cfg.resolved_app_name(),
        cfg.time_string,
        cfg.url,
        cfg.partitions,
        float(cfg.mult_data),
        cfg.memory,
        cfg.cores,
        total_time,
        metrics.mean_delay_rows,
        os.path.basename(cfg.dataset),
        cfg.per_batch,
        num_rows,
        num_rows / total_time if total_time > 0 else float("nan"),
        metrics.num_detections,
        cfg.model,
        cfg.detector,
        attribution.hits if attribution else NO_ATTRIBUTION,
        attribution.spurious if attribution else NO_ATTRIBUTION,
        attribution.recall if attribution else NO_ATTRIBUTION,
    ]
