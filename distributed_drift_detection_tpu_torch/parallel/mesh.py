"""The single-device half of the JAX package's ``parallel/mesh.py``.

One card runs every partition, so the runner needs no mesh: it expands the
packed stream, runs the window engine over the ``[P]`` partition axis and
finishes with the cross-partition drift vote, the packed five-leaf flag
plane and — for ``collect='compact'`` — the device-side compaction of the
flagged slots into a small table, so the collect phase copies
O(detections) bytes to the host instead of the plane. The multi-card mesh
is ROADMAP A15.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..config import DDMParams
from ..engine.loop import FlagRows, PackedIndexedBatches, expand_packed
from ..models.base import Model


class MeshRunResult(NamedTuple):
    flags: FlagRows  # leaves [P, NB-1]
    drift_vote: torch.Tensor  # [NB-1] f32: fraction of partitions flagging change
    packed: torch.Tensor  # [5, P, NB-1] i32: the five flag leaves stacked
    # [capacity + 1, 7] i32 compacted table (None when compaction is off):
    # columns (partition, batch, warning_local, warning_global,
    # change_local, change_global, forced_retrain), −1 fill, and the TOTAL
    # flagged-slot count in the last row's first column.
    compact: "torch.Tensor | None" = None


def auto_compact_capacity(partitions: int, flag_rows: int) -> int:
    """Default compacted-table capacity for a ``[P, NBF]`` flag plane:
    ~P·NBF/8 entries (floor 64), clamped to the slot count."""
    slots = max(int(partitions) * int(flag_rows), 1)
    return min(max(64, slots // 8), slots)


def compact_flag_table(flags: FlagRows, capacity: int) -> torch.Tensor:
    """``FlagRows [P, NBF]`` → ``[capacity + 1, 7]`` i32 table of the first
    ``min(n, capacity)`` flagged slots in row-major order, −1 fill, with
    the true count ``n`` embedded in the last row. A slot is flagged when
    it holds a warning, a change or a forced retrain. Runs on the tensors'
    device with no host synchronization: a slot's rank is the running
    count of flagged slots, and flagged slots of rank below capacity are
    scattered to their rank (the rest to a dropped overflow slot)."""
    k = int(capacity)
    p, nbf = flags.change_local.shape
    dev = flags.change_local.device
    flat = (
        (flags.warning_local >= 0)
        | (flags.change_local >= 0)
        | flags.forced_retrain
    ).reshape(-1)
    n = flat.sum(dtype=torch.int32)  # true count — may exceed capacity
    rank = torch.cumsum(flat, 0) - 1
    slot = torch.where(flat & (rank < k), rank, k)
    pos = torch.full((k + 1,), -1, dtype=torch.long, device=dev)
    pos.scatter_(0, slot, torch.arange(p * nbf, device=dev))
    pos = pos[:k]
    ok = pos >= 0
    safe = pos.clamp_min(0)
    fill = torch.full_like(pos, -1)

    def take(leaf):
        return torch.where(ok, leaf.reshape(-1)[safe].long(), fill)

    entries = torch.stack(
        [
            torch.where(ok, pos // nbf, fill),
            torch.where(ok, pos % nbf, fill),
            take(flags.warning_local),
            take(flags.warning_global),
            take(flags.change_local),
            take(flags.change_global),
            take(flags.forced_retrain),
        ],
        dim=1,
    ).int()  # [K, 7]
    counter = torch.zeros((1, 7), dtype=torch.int32, device=dev)
    counter[0, 0] = n
    return torch.cat([entries, counter], 0)


def expand_flag_table(
    table: np.ndarray, partitions: int, flag_rows: int
) -> FlagRows | None:
    """Host-side inverse of :func:`compact_flag_table`: scatter the entries
    into a sentinel-initialised ``[P, NBF]`` flag plane; ``None`` when the
    embedded count exceeds the capacity (the table is partial)."""
    table = np.asarray(table)
    capacity = table.shape[0] - 1
    n_events = int(table[-1, 0])
    if n_events > capacity:
        return None
    entries = table[:capacity]
    entries = entries[entries[:, 0] >= 0]
    shape = (int(partitions), int(flag_rows))
    leaves = [np.full(shape, -1, np.int32) for _ in range(4)]
    forced = np.zeros(shape, bool)
    pq, bq = entries[:, 0], entries[:, 1]
    for col, leaf in enumerate(leaves, start=2):
        leaf[pq, bq] = entries[:, col]
    forced[pq, bq] = entries[:, 6] != 0
    return FlagRows(*leaves, forced)


def unpack_flags(packed: np.ndarray) -> FlagRows:
    """Host :class:`FlagRows` from ``MeshRunResult.packed``."""
    return FlagRows(
        *(packed[i] for i in range(4)), packed[4].astype(bool)
    )


def host_flags(result: MeshRunResult) -> tuple[FlagRows, dict]:
    """The collect phase's device→host step: host ``FlagRows`` plus a
    provenance dict (``mode``, ``events``, ``overflow``). A compacted
    table that overflowed falls back to the full plane with a
    ``RuntimeWarning`` — never a silent truncation."""
    if result.compact is not None:
        _, p, nbf = result.packed.shape
        table = result.compact.cpu().numpy()  # ONE small device→host copy
        n_events = int(table[-1, 0])
        flags = expand_flag_table(table, p, nbf)
        if flags is not None:
            return flags, {"mode": "compact", "events": n_events, "overflow": False}
        warnings.warn(
            f"compacted flag table overflowed ({n_events} flagged slots > "
            f"capacity {table.shape[0] - 1}); falling back to the full "
            "flag plane — raise RunConfig.collect_capacity or use "
            "collect='full' for this stream",
            RuntimeWarning,
            stacklevel=2,
        )
        return unpack_flags(result.packed.cpu().numpy()), {
            "mode": "full", "events": n_events, "overflow": True,
        }
    return unpack_flags(result.packed.cpu().numpy()), {
        "mode": "full", "events": None, "overflow": False,
    }


def finish_mesh_run(flags: FlagRows, compact_capacity: int = 0) -> MeshRunResult:
    """Drift vote, packed plane and (``compact_capacity > 0``) the
    compacted table of a finished run."""
    changed = (flags.change_global >= 0).float()  # [P, NB-1]
    vote = changed.sum(0) / changed.shape[0]
    packed = torch.stack([leaf.int() for leaf in flags])
    compact = (
        compact_flag_table(flags, compact_capacity) if compact_capacity else None
    )
    return MeshRunResult(flags=flags, drift_vote=vote, packed=packed, compact=compact)


def make_mesh_runner(
    model: Model,
    ddm_params: DDMParams,
    *,
    retrain_error_threshold: float | None = None,
    window: int = 16,
    packed: bool = False,
    detector=None,
    rotations: int = 1,
    compact_capacity: int = 0,
):
    """Build ``run(batches, key=None) -> MeshRunResult`` on one device;
    ``key`` is the partitions' keys ``[P, 2]`` uint32 of a keyed model.

    ``packed=True`` takes :class:`PackedIndexedBatches` and expands their
    geometry planes on the device first; otherwise ``batches`` are dense
    :class:`Batches`. ``window > 1`` is the speculative window engine,
    ``window = 1`` the sequential batch-per-step engine (dense batches
    only, ``rotations`` 1).
    """
    if window == 0:
        raise ValueError(
            "window=0 (auto) needs stream geometry and is resolved by "
            "api.prepare (config.auto_window); pass an explicit width here"
        )
    if packed and window <= 1:
        raise ValueError("indexed batches require the window engine (window > 1)")
    if window <= 1 and rotations != 1:
        raise ValueError("rotations only applies to the window engine (window > 1)")
    if window > 1:
        from ..engine.window import make_window_runner

        run_one = make_window_runner(
            model,
            ddm_params,
            window=window,
            retrain_error_threshold=retrain_error_threshold,
            detector=detector,
            rotations=rotations,
        )
    else:
        from ..engine.loop import make_partition_runner

        run_one = make_partition_runner(
            model,
            ddm_params,
            retrain_error_threshold=retrain_error_threshold,
            detector=detector,
        )

    def run(batches, key=None) -> MeshRunResult:
        if packed:
            if not isinstance(batches, PackedIndexedBatches):
                raise TypeError("packed runner expects PackedIndexedBatches")
            batches = expand_packed(batches)
        if model.keyed:
            return finish_mesh_run(run_one(batches, key), compact_capacity=compact_capacity)
        return finish_mesh_run(run_one(batches), compact_capacity=compact_capacity)

    return run
