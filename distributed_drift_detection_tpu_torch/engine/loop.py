"""Containers of the partition loop and the helpers the window engine shares.

The port's twin of the JAX package's ``engine/loop.py:44-244``. The
containers hold numpy arrays on the host (stripers) and tensors on the
device (engines), always with the leading ``[P]`` partition axis written
out: what the JAX package vmaps over partitions, the port batches.

The sequential batch-per-step engine (``make_partition_runner``) is not
ported yet (ROADMAP A5); ``api.run`` raises for ``window=1``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import DDMParams


class Batches(NamedTuple):
    """The stream striped into microbatches, partition-major."""

    X: object  # [P, NB, B, F] f32
    y: object  # [P, NB, B] i32
    rows: object  # [P, NB, B] i32 global stream positions
    valid: object  # [P, NB, B] bool (False = padding)


class IndexedBatches(NamedTuple):
    """Compressed stream: a microbatch grid of indices into a row table.

    ``X[p, s] ≡ base_X[idx[p, s]]``, ``y[p, s] ≡ base_y[idx[p, s]]``.
    """

    base_X: object  # [T, F] f32 row table
    base_y: object  # [T] i32
    idx: object  # [P, NB, B] i16/i32 row-table index
    rows: object  # [P, NB, B] i32 global stream positions
    valid: object  # [P, NB, B] bool


class PackedIndexedBatches(NamedTuple):
    """Transport form of :class:`IndexedBatches`: the ``rows``/``valid``
    planes are functions of the stripe geometry and the per-batch shuffle
    permutation, so only ``idx`` and the one-byte ``perm`` are uploaded and
    :func:`expand_packed` rebuilds the rest on the device."""

    base_X: object  # [T, F] f32
    base_y: object  # [T] i32
    idx: object  # [P, NB, B] i16/i32
    perm: object  # [P, NB, B] u8/i16 within-batch shuffle permutation
    n_rows: object  # int: stream length (pads the validity mask)


class FlagRows(NamedTuple):
    """Per-batch detection flags (−1 sentinels), leaves ``[P, NB-1]``."""

    warning_local: object  # index within the (shuffled) batch
    warning_global: object  # global stream position
    change_local: object
    change_global: object
    forced_retrain: object  # bool


class LoopCarry(NamedTuple):
    """State carried across windows, every leaf with a leading ``[P]``.

    The JAX carry's PRNG ``key`` has no counterpart: the ported fits
    (majority, centroid) consume none.
    """

    params: object
    ddm: object  # DDMState
    a_X: torch.Tensor  # [P, B, F] f32
    a_y: torch.Tensor  # [P, B] i32
    a_w: torch.Tensor  # [P, B] f32 validity weights
    retrain: torch.Tensor  # [P] bool


def expand_packed(packed: PackedIndexedBatches) -> IndexedBatches:
    """Rebuild the ``rows``/``valid`` planes on the tensors' device —
    ``gmap = (slot·B + perm)·P + part``, the host striper's formula
    (``io.stream._stripe_gmap``). ``perm`` is widened to int32 before the
    arithmetic: the uint8 plane would wrap."""
    p, nb, b = packed.idx.shape
    dev = packed.idx.device
    slot = torch.arange(nb, dtype=torch.int32, device=dev)[None, :, None]
    part = torch.arange(p, dtype=torch.int32, device=dev)[:, None, None]
    gmap = (slot * b + packed.perm.to(torch.int32)) * p + part
    return IndexedBatches(
        base_X=packed.base_X,
        base_y=packed.base_y,
        idx=packed.idx,
        rows=gmap,
        valid=gmap < int(packed.n_rows),
    )


def _select(pred: torch.Tensor, a, b):
    """Leaf-wise ``where(pred, a, b)`` over two equal NamedTuples (or
    tensors); ``pred`` is ``[P]`` and broadcasts over trailing axes."""
    if isinstance(a, tuple):
        return type(a)(*(_select(pred, x, y) for x, y in zip(a, b)))
    return torch.where(pred.view(pred.shape + (1,) * (a.dim() - 1)), a, b)


def _gather_row(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rows[..., idx]`` along the last axis with −1 passthrough:
    ``rows [..., B]``, ``idx [...]`` → ``[...]``."""
    safe = idx.clamp(0, rows.shape[-1] - 1).long()
    got = torch.gather(rows, -1, safe.unsqueeze(-1)).squeeze(-1)
    return torch.where(idx >= 0, got, torch.full_like(got, -1))


def resolve_detector(ddm_params: DDMParams, detector=None):
    """The kernel an engine runs: ``detector`` if given, else DDM built from
    ``ddm_params``."""
    if detector is not None:
        return detector
    from ..ops.detectors import make_detector

    return make_detector("ddm", ddm=ddm_params)


def _check_retrain_threshold(thr: "float | None") -> None:
    """Reject a leaked RETRAIN_AUTO sentinel (negative threshold) at the
    engine boundary: it must be resolved by ``config.resolve_retrain_threshold``
    first, or every nonempty batch would force a retrain."""
    if thr is not None and thr < 0.0:
        raise ValueError(
            f"retrain_error_threshold={thr} is negative — the RETRAIN_AUTO "
            "sentinel must be resolved before reaching an engine "
            "(config.resolve_retrain_threshold); pass None to disable or a "
            "non-negative float to pin"
        )
