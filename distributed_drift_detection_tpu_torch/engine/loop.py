"""The sequential partition loop, its containers, and the helpers the
window engine shares.

The port's twin of the JAX package's ``engine/loop.py``. The containers
hold numpy arrays on the host (stripers) and tensors on the device
(engines), always with the leading ``[P]`` partition axis written out:
what the JAX package vmaps over partitions, the port batches.
:func:`make_partition_runner` is the ``window=1`` engine — one microbatch
per step, every partition in step, a Python loop where the JAX package
has ``lax.scan``. :func:`stack_tenants` and :func:`concat_keys` build the
tenant plane (T tenants' partitions stacked on the leading axis).
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
    the host (``utils/threefry.py``). A keyed model (``mlp``, ``forest``)
    and ``shuffle=True`` need it; ``api.run`` leaves it None for the other
    families, the chunked engine carries it always, as JAX's carry does.
    The engines draw the key chain from it on the host, once a span.
    """

    params: object
    ddm: object  # the detector's state (DDMState for DDM)
    a_X: torch.Tensor  # [P, B, F] f32
    a_y: torch.Tensor  # [P, B] i32
    a_w: torch.Tensor  # [P, B] f32 validity weights
    retrain: torch.Tensor  # [P] bool
    key: "np.ndarray | None" = None  # [P, 2] uint32; None: the run carries none


def expand_packed(
    packed: PackedIndexedBatches, partition_offset: int = 0, partitions: "int | None" = None
) -> IndexedBatches:
    """Rebuild the ``rows``/``valid`` planes on the tensors' device —
    ``gmap = (slot·B + perm)·P + part``, the host striper's formula
    (``io.stream._stripe_gmap``). ``perm`` is widened to int32 before the
    arithmetic: the uint8 plane would wrap. A mesh shard's planes hold the
    whole plane's rows ``partition_offset`` on, of ``partitions`` in all
    (default: the planes' own)."""
    p, nb, b = packed.idx.shape
    total = p if partitions is None else int(partitions)
    dev = packed.idx.device
    slot = torch.arange(nb, dtype=torch.int32, device=dev)[None, :, None]
    part = torch.arange(p, dtype=torch.int32, device=dev)[:, None, None] + int(partition_offset)
    gmap = (slot * b + packed.perm.to(torch.int32)) * total + part
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


def dense_table(X, y):
    """A dense ``Batches``' planes as the models gather them: the row table
    ``[P·NB·B, row_stride(F)]`` (float32: a bfloat16 transport plane is
    widened here), its labels ``[P·NB·B]`` and each slot's flat row index
    ``[P, NB, B]`` int32."""
    from ..models.base import row_stride

    p, nb, b, f = X.shape
    dev = X.device
    table = torch.zeros((p * nb * b, row_stride(f)), dtype=torch.float32, device=dev)
    table[:, :f] = X.reshape(-1, f)
    idx = torch.arange(p * nb * b, dtype=torch.int32, device=dev).view(p, nb, b)
    return table, y.reshape(-1), idx


def make_partition_step(
    model,
    ddm_params: DDMParams,
    *,
    shuffle: bool = True,
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
    detector and set the retrain. The carry's key (``[P, 2]`` uint32 on the
    host; None when the run carries none) advances as the JAX loop splits
    it: ``key, k_shuf, k_fit = split(carry.key, 3)``. ``shuffle=True`` (the
    JAX default) permutes the batch first with ``permutation(k_shuf, B)``
    (kernel K13, ``ops/shuffle.py``), so ``warning_local`` and
    ``change_local`` index the shuffled batch, as JAX's do; a keyed model
    fits from ``k_fit``. ``keys`` passes ``(key, k_fit)`` precomputed — the
    host's next keys and the fit keys on the device — by a caller that has
    also permuted the planes already (:func:`run_steps`); else the step
    splits ``carry.key`` itself. A keyed model or ``shuffle=True`` needs
    the carry's key."""
    _check_retrain_threshold(retrain_error_threshold)
    det = resolve_detector(ddm_params, detector)

    def step(carry: LoopCarry, table, labels, idx, b_rows, b_valid, keys=None):
        p, f = carry.a_X.shape[0], carry.a_X.shape[-1]
        next_key, k_fit = None, None
        if keys is not None:
            next_key, k_fit = keys
        elif carry.key is not None:
            split = threefry.split(carry.key, 3)
            next_key = split[:, 0]
            if model.keyed:
                k_fit = device_keys(split[:, 2], b_valid.device)
            if shuffle:
                from ..ops.shuffle import shuffle_planes

                sh = shuffle_planes(
                    device_keys(split[:, 1:2], b_valid.device), idx[:, None],
                    b_rows[:, None], b_valid[:, None], 1, derive=False,
                )
                idx, b_rows, b_valid = (x[:, 0] for x in sh)
        elif model.keyed or shuffle:
            raise ValueError(
                "a keyed model or shuffle=True needs the carry's key (LoopCarry.key)"
            )
        b_w = b_valid.float()
        nonempty = b_valid.any(1)
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


def run_steps(step, model, carry: LoopCarry, table, labels, idx, rows, valid,
              *, shuffle: bool):
    """``S`` steps of ``step`` (:func:`make_partition_step`) over the
    batches ``idx``/``rows``/``valid`` ``[P, S, B]`` from ``carry``: returns
    the carry after them and the flags, leaves ``[P, S]``. The key chain of
    the S steps is drawn on the host at once (``threefry.loop_fit_keys``) and, under
    ``shuffle``, every batch of the span is permuted by one K13 launch
    before the first step."""
    p, s = idx.shape[:2]
    dev = idx.device
    chain = fit_keys = None
    if carry.key is not None:
        # each step: key, k_shuf, k_fit = split(key, 3)
        chain, k_fit = threefry.loop_fit_keys(carry.key, s)
        if model.keyed:
            fit_keys = device_keys(k_fit, dev)
        if shuffle:
            from ..ops.shuffle import shuffle_planes

            k_shuf = threefry.split(chain[:-1], 3)[..., 1, :]  # [S, P, 2]
            idx, rows, valid = shuffle_planes(
                device_keys(np.swapaxes(k_shuf, 0, 1), dev), idx, rows, valid, s,
                derive=False,
            )
    elif model.keyed or shuffle:
        raise ValueError("a keyed model or shuffle=True needs the carry's key (LoopCarry.key)")

    def by_step(x):  # [P, S, B] -> [S, P, B]: each step's slice contiguous
        return x.transpose(0, 1).contiguous()

    idx, rows, valid = by_step(idx), by_step(rows), by_step(valid)
    out = []
    for t in range(s):
        keys = None
        if chain is not None:
            keys = (chain[t + 1], None if fit_keys is None else fit_keys[t])
        carry, flags = step(carry, table, labels, idx[t], rows[t], valid[t], keys)
        out.append(flags)
    if not out:
        empty = torch.empty((p, 0), dtype=torch.int32, device=dev)
        return carry, FlagRows(empty, empty, empty, empty, empty.bool())
    return carry, FlagRows(*(torch.stack(leaf, 1) for leaf in zip(*out)))


def make_partition_runner(
    model,
    ddm_params: DDMParams,
    *,
    shuffle: bool = True,
    retrain_error_threshold: float | None = None,
    detector=None,
):
    """Build ``run(batches: Batches, key=None) -> FlagRows`` (leaves ``[P,
    NB-1]``): batch 0 of each partition seeds ``batch_a``, then one
    :func:`make_partition_step` per batch (:func:`run_steps`). The dense
    planes become one row table with its row stride padded to 4 floats,
    built once. ``key [P, 2]`` uint32 is the partitions' keys (``api.prepare``:
    ``split(key(seed), P)``), needed by a keyed model and by ``shuffle=True``
    (the JAX default): ``key, k_init = split(key)``, ``k_init`` for a keyed
    model's init, then the step chain."""
    det = resolve_detector(ddm_params, detector)
    step = make_partition_step(
        model, ddm_params, shuffle=shuffle,
        retrain_error_threshold=retrain_error_threshold, detector=det,
    )

    def run(batches: Batches, key=None) -> FlagRows:
        p = batches.X.shape[0]
        dev = batches.X.device
        carry_key = init_key = None
        if model.keyed or shuffle:
            if key is None:
                raise ValueError("a keyed model or shuffle=True needs the partitions' keys")
            pair = threefry.split(np.asarray(key, np.uint32), 2)
            carry_key = pair[:, 0]
            if model.keyed:
                init_key = device_keys(pair[:, 1], dev)
        table, labels, idx = dense_table(batches.X, batches.y)
        carry = LoopCarry(
            params=model.init(p, dev, key=init_key),
            ddm=det.init((p,), dev),
            a_X=batches.X[:, 0].float().contiguous(),  # as the fit takes them
            a_y=batches.y[:, 0].contiguous(),
            a_w=batches.valid[:, 0].float(),
            retrain=torch.ones(p, dtype=torch.bool, device=dev),
            key=carry_key,
        )
        _, flags = run_steps(
            step, model, carry, table, labels, idx[:, 1:], batches.rows[:, 1:],
            batches.valid[:, 1:], shuffle=shuffle,
        )
        return flags

    return run


def concat_keys(key_arrays) -> np.ndarray:
    """The tenants' key blocks ``[P_t, 2]`` stacked into one ``[ΣP_t, 2]``
    uint32 array (the JAX package's ``concat_keys`` over key data)."""
    return np.concatenate([np.asarray(k, np.uint32) for k in key_arrays])


def stack_tenants(batches_list) -> Batches:
    """Stack T tenants' host ``[P, NB_t, B]`` grids into one ``[T·P,
    NB_max, B]`` plane, tenant-major (``q = t·P + p``), as the JAX
    package's ``stack_tenants`` does: a tenant shorter than ``NB_max`` is
    padded with fully masked batches (``valid=False``, ``rows=-1``, zero
    fill) after its real ones, which leave its flags as its solo run's."""
    if not batches_list:
        raise ValueError("stack_tenants needs at least one tenant grid")
    b0 = batches_list[0]
    p, b = b0.y.shape[0], b0.y.shape[2]
    for i, bt in enumerate(batches_list):
        if bt.y.shape[0] != p or bt.y.shape[2] != b:
            raise ValueError(
                f"tenant {i} grid {bt.y.shape} disagrees with tenant 0's "
                f"partitions/per_batch ({p}, {b}); tenants share one kernel "
                "geometry — only NB (stream length) may differ"
            )
    nb_max = max(bt.y.shape[1] for bt in batches_list)

    def pad(bt: Batches) -> Batches:
        extra = nb_max - bt.y.shape[1]
        if not extra:
            return bt
        return Batches(
            X=np.concatenate(
                [bt.X, np.zeros((p, extra, b, bt.X.shape[3]), bt.X.dtype)], axis=1
            ),
            y=np.concatenate([bt.y, np.zeros((p, extra, b), bt.y.dtype)], axis=1),
            rows=np.concatenate(
                [bt.rows, np.full((p, extra, b), -1, bt.rows.dtype)], axis=1
            ),
            valid=np.concatenate([bt.valid, np.zeros((p, extra, b), bool)], axis=1),
        )

    padded = [pad(bt) for bt in batches_list]
    return Batches(
        *(np.concatenate([getattr(bt, f) for bt in padded], axis=0)
          for f in Batches._fields)
    )
