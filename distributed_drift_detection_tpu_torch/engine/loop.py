"""The sequential partition loop, its containers, and the helpers the
window engine shares.

The port's twin of the JAX package's ``engine/loop.py``. The containers
hold numpy arrays on the host (stripers) and tensors on the device
(engines), always with the leading ``[P]`` partition axis written out:
what the JAX package vmaps over partitions, the port batches.
:func:`make_partition_runner` is the ``window=1`` engine — one microbatch
per step, every partition in step, a Python loop where the JAX package
has ``lax.scan``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import DDMParams
from ..utils import threefry


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

    ``key`` is the JAX carry's PRNG key as its data: ``[P, 2]`` uint32 on
    the host (``utils/threefry.py``), for a keyed model (``mlp``); None for
    the families that consume none. The engines draw the key chain from it
    on the host, once a run.
    """

    params: object
    ddm: object  # the detector's state (DDMState for DDM)
    a_X: torch.Tensor  # [P, B, F] f32
    a_y: torch.Tensor  # [P, B] i32
    a_w: torch.Tensor  # [P, B] f32 validity weights
    retrain: torch.Tensor  # [P] bool
    key: "np.ndarray | None" = None  # [P, 2] uint32, keyed models only


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


def device_keys(keys: np.ndarray, device) -> torch.Tensor:
    """Host uint32 key data ``[..., 2]`` as the int32 bit patterns the
    kernels take, on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(keys, np.uint32).view(np.int32)).to(device)


def _select(pred: torch.Tensor, a, b):
    """Leaf-wise ``where(pred, a, b)`` over two equal NamedTuples (or
    tensors); ``pred`` is ``[P]`` and broadcasts over trailing axes."""
    if isinstance(a, tuple):
        leaves = (_select(pred, x, y) for x, y in zip(a, b))
        return type(a)(*leaves) if hasattr(a, "_fields") else tuple(leaves)
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


def make_partition_step(
    model,
    ddm_params: DDMParams,
    *,
    shuffle: bool = False,
    retrain_error_threshold: float | None = None,
    detector=None,
):
    """Build the loop body ``step(carry, table, labels, idx, b_rows,
    b_valid) -> (carry, FlagRows)`` over one microbatch per partition: the
    batch's rows are ``table[idx]`` (``idx`` ``[P, B]`` into the row table
    ``[R, row_stride(F)]`` of :func:`~..models.base.pad_row_table`, labels
    ``[R]``), ``b_rows``/``b_valid`` its ``[P, B]`` planes; the flag leaves
    are ``[P]``.

    Train on demand (fit always, apply on a pending retrain), predict the
    error indicators, detect with ``detector`` (DDM from ``ddm_params``
    when None), and on change rotate ``batch_a`` to this batch, reset the
    detector and set the retrain. A keyed model fits from the step's fit
    key: ``key, k_shuf, k_fit = split(carry.key, 3)``, as the JAX loop
    splits (its window engine takes ``k_fit`` second); ``keys`` passes
    ``(key, k_fit)`` precomputed — the host's next keys and the fit keys
    on the device — else the step splits ``carry.key`` itself.
    ``shuffle=True`` (an in-loop permutation from ``k_shuf``) is not
    ported: the JAX package's ``api.run`` never asks for it, and the
    port's streams are shuffled on the host at stripe time."""
    if shuffle:
        raise NotImplementedError(
            "in-loop shuffle=True is not ported (ROADMAP A10, with the "
            "feeders): the threefry PRNG is (utils/threefry.py), but the "
            "port shuffles on the host at stripe time instead"
        )
    _check_retrain_threshold(retrain_error_threshold)
    det = resolve_detector(ddm_params, detector)

    def step(carry: LoopCarry, table, labels, idx, b_rows, b_valid, keys=None):
        p, f = carry.a_X.shape[0], carry.a_X.shape[-1]
        b_w = b_valid.float()
        nonempty = b_valid.any(1)
        next_key, k_fit = None, None
        if model.keyed:
            if keys is None:
                split = threefry.split(carry.key, 3)
                keys = (split[:, 0], device_keys(split[:, 2], b_valid.device))
            next_key, k_fit = keys
        fitted = model.fit(carry.a_X, carry.a_y, carry.a_w, key=k_fit)
        params = _select(carry.retrain & nonempty, fitted, carry.params)
        errs = model.predict_err(params, table, labels, idx)
        new_ddm, res = det.batch(carry.ddm, errs, b_valid)
        change = (res.first_change >= 0) & nonempty
        if retrain_error_threshold is not None:
            err_rate = (errs * b_w).sum(1) / b_w.sum(1).clamp_min(1.0)
            forced = nonempty & ~change & (err_rate > retrain_error_threshold)
        else:
            forced = torch.zeros_like(change)
        rotate = change | forced
        flags = FlagRows(
            res.first_warning,
            _gather_row(b_rows, res.first_warning),
            res.first_change,
            _gather_row(b_rows, res.first_change),
            forced,
        )
        i = idx.long()
        new_carry = LoopCarry(
            params=params,
            ddm=_select(rotate, det.init((p,), b_valid.device), new_ddm),
            a_X=_select(rotate, table[i, :f], carry.a_X),
            a_y=_select(rotate, labels[i], carry.a_y),
            a_w=_select(rotate, b_w, carry.a_w),
            retrain=torch.where(nonempty, rotate, carry.retrain),
            key=next_key,
        )
        return new_carry, flags

    return step


def make_partition_runner(
    model,
    ddm_params: DDMParams,
    *,
    shuffle: bool = False,
    retrain_error_threshold: float | None = None,
    detector=None,
):
    """Build ``run(batches: Batches) -> FlagRows`` (leaves ``[P, NB-1]``):
    batch 0 of each partition seeds ``batch_a``, then one
    :func:`make_partition_step` per batch. The dense planes become one row
    table with its row stride padded to 4 floats, built once. A keyed
    model takes the partitions' keys ``key [P, 2]`` uint32 (``api.prepare``:
    ``split(key(seed), P)``): ``key, k_init = split(key)`` for its init,
    then the step chain of :func:`~..utils.threefry.loop_fit_keys`, drawn on
    the host and uploaded once."""
    from ..models.base import row_stride

    det = resolve_detector(ddm_params, detector)
    step = make_partition_step(
        model, ddm_params, shuffle=shuffle,
        retrain_error_threshold=retrain_error_threshold, detector=det,
    )

    def run(batches: Batches, key=None) -> FlagRows:
        p, nb, b, f = batches.X.shape
        dev = batches.X.device
        chain = fit_keys = init_key = None
        if model.keyed:
            pair = threefry.split(np.asarray(key, np.uint32), 2)
            init_key = device_keys(pair[:, 1], dev)
            chain, fit_keys = threefry.loop_fit_keys(pair[:, 0], max(nb - 1, 0))
            fit_keys = device_keys(fit_keys, dev)
        table = torch.zeros((p * nb * b, row_stride(f)), dtype=torch.float32, device=dev)
        table[:, :f] = batches.X.reshape(-1, f)
        labels = batches.y.reshape(-1)

        def by_step(x):  # [P, NB, B] -> [NB, P, B]: each step's slice contiguous
            return x.transpose(0, 1).contiguous()

        idx = by_step(torch.arange(p * nb * b, dtype=torch.int32, device=dev).view(p, nb, b))
        b_rows, b_valid = by_step(batches.rows), by_step(batches.valid)
        carry = LoopCarry(
            params=model.init(p, dev, key=init_key),
            ddm=det.init((p,), dev),
            a_X=batches.X[:, 0].contiguous(),  # as the fit takes them
            a_y=batches.y[:, 0].contiguous(),
            a_w=batches.valid[:, 0].float(),
            retrain=torch.ones(p, dtype=torch.bool, device=dev),
            key=None if chain is None else chain[0],
        )
        rows = []
        for s in range(1, nb):
            keys = None if chain is None else (chain[s], fit_keys[s - 1])
            carry, flags = step(carry, table, labels, idx[s], b_rows[s], b_valid[s], keys)
            rows.append(flags)
        if not rows:
            empty = torch.empty((p, 0), dtype=torch.int32, device=dev)
            return FlagRows(empty, empty, empty, empty, empty.bool())
        return FlagRows(*(torch.stack(leaf, 1) for leaf in zip(*rows)))

    return run
