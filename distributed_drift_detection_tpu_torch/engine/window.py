"""Speculative window execution of the per-partition microbatch loop.

The port's twin of the JAX package's ``engine/window.py``
(``make_window_span``/``make_window_runner``, :66-419), batched over a
leading ``[P]`` partition axis instead of vmapped.

Drift is rare, so between drifts the loop is parallel across batches: the
model is frozen and the DDM statistic over consecutive batches is one
prefix computation. Each iteration therefore takes a window of ``W``
microbatches per partition, predicts and detects over all of it at once,
and commits up to and including the first batch that signals a change (or
a forced retrain); the rest is replayed. ``rotations = R`` replays up to
``R − 1`` times inside the iteration: rows up to the change are masked out,
the model refits on the change batch, the detector restarts from a reset
state and the tail is re-predicted. For deterministic fits the committed
flags equal the sequential loop's at any ``W`` and ``R``.

Each partition keeps its own window pointer: the window slice is a gather
at ``ptr[:, None] + arange(W)`` into planes padded by ``W``. Lanes that
have finished freeze (``active``), and their slab writes land in the pad
region, exactly as the JAX engine's lock-step lanes do. The loop condition
``(ptr < NBF).any()`` is read on the host once per iteration.

The window never materializes its ``[P, W·B, F]`` rows: the model's
``predict_err`` gathers them from the row table through the index plane
(on the card, inside kernel K2 for the centroid model). The engine builds
that table once per run with its row stride rounded up to 4 floats
(``models.base.pad_row_table``). A dense stream (``Batches``) is addressed
the same way, through a flat row index into its padded feature plane.

A carried key (a keyed model's, ``mlp`` or ``forest``; or any model's
under ``shuffle=True``, and always in the chunked engine) follows the JAX
engine's chain: each iteration ``key, k_fit, k_shuf = split(key, 3)``, one
fit key a level (``k_fit`` itself at R = 1, else ``split(k_fit, R)``), and
only active lanes advance their key. The chain depends on the iteration
count alone, so the span draws it on the host for as many iterations as
can run and uploads it once (``utils/threefry.py`` ``window_fit_keys``); a
lane that has finished fits from later keys than JAX's frozen one, but its
fit is never committed. ``shuffle=True`` permutes window row ``i`` of each
lane with ``permutation(split(k_shuf, W)[i], B)`` as JAX does: kernel K13
(``ops/shuffle.py``) gathers the window slice at each lane's pointer and
permutes it in one launch an iteration, and the replay levels reuse the
level-0 permutations, as JAX's do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DDMParams
from ..models.base import Model, pad_row_table, row_stride
from ..ops.shuffle import shuffle_planes
from ..utils import threefry
from .loop import (
    Batches,
    FlagRows,
    IndexedBatches,
    LoopCarry,
    _check_retrain_threshold,
    _gather_row,
    _select,
    device_keys,
    resolve_detector,
)


def make_window_span(
    model: Model,
    ddm_params: DDMParams,
    *,
    window: int = 16,
    shuffle: bool = False,
    retrain_error_threshold: float | None = None,
    detector=None,
    rotations: int = 1,
):
    """Build ``span(carry: LoopCarry, batches) -> (LoopCarry, FlagRows)``:
    process every batch of ``batches`` (leaves ``[P, NBF, ...]``) from the
    caller's carry, one flag row per batch. A keyed model and
    ``shuffle=True`` need the carry's key."""
    w = int(window)
    r_levels = int(rotations)
    if w < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if r_levels < 1:
        raise ValueError(f"rotations must be >= 1, got {rotations}")
    _check_retrain_threshold(retrain_error_threshold)
    det = resolve_detector(ddm_params, detector)

    def span(carry_in: LoopCarry, batches: "Batches | IndexedBatches"):
        indexed = isinstance(batches, IndexedBatches)
        grid = batches.idx if indexed else batches.y
        p, nbf, b = grid.shape
        dev = grid.device

        def pad_tail(x, fill):
            tail = torch.full((p, w, *x.shape[2:]), fill, dtype=x.dtype, device=dev)
            return torch.cat([x, tail], 1)

        # The model gathers from `rows` (the table with its row stride
        # rounded up to 4 floats, K2's 16-byte gathers); the refits take
        # their rows from `table`, the first F columns.
        if indexed:
            table, labels = batches.base_X.float(), batches.base_y  # transport seam
            rows = pad_row_table(table)
            r_idx = pad_tail(batches.idx, 0)  # [P, NBF+W, B]
        else:
            f = batches.X.shape[-1]
            r_X = torch.zeros(  # [P, NBF+W, B, row_stride(F)], zero tail
                (p, nbf + w, b, row_stride(f)), dtype=torch.float32, device=dev
            )
            r_X[:, :nbf, :, :f] = batches.X
            rows = r_X.view(-1, r_X.shape[-1])
            table = rows[:, :f]
            labels = pad_tail(batches.y, 0).reshape(-1)
            r_idx = torch.arange(
                table.shape[0], dtype=torch.int32, device=dev
            ).view(p, nbf + w, b)
        r_rows = pad_tail(batches.rows, -1)
        r_valid = pad_tail(batches.valid, False)

        flags = FlagRows(
            *(torch.full((p, nbf + w), -1, dtype=torch.int32, device=dev)
              for _ in range(4)),
            torch.zeros((p, nbf + w), dtype=torch.bool, device=dev),
        )
        parts = torch.arange(p, device=dev)
        rows_w = torch.arange(w, device=dev)
        ptr = torch.zeros(p, dtype=torch.long, device=dev)
        params, ddm = carry_in.params, carry_in.ddm
        a_X, a_y, a_w, retrain = (
            carry_in.a_X, carry_in.a_y, carry_in.a_w, carry_in.retrain
        )
        # The key chain, drawn once on the host for as many iterations as
        # can run — each advances an active lane by at least min(R, W)
        # batches or to its end — and its fit and shuffle keys uploaded once.
        chain = fit_keys = shuf_keys = None
        if carry_in.key is not None:
            bound = -(-nbf // min(r_levels, w))
            chain, fits = threefry.window_fit_keys(carry_in.key, bound, r_levels)
            if model.keyed:
                fit_keys = device_keys(fits, dev)
            if shuffle:
                shuf_keys = device_keys(threefry.split(chain[:-1], 3)[..., 2, :], dev)
            lane_iters = torch.zeros(p, dtype=torch.long, device=dev)
        elif model.keyed or shuffle:
            raise ValueError(
                "a keyed model or shuffle=True needs the carry's key (LoopCarry.key)"
            )
        it = 0

        while bool((ptr < nbf).any()):
            active = ptr < nbf
            if shuf_keys is not None:  # the slice at each pointer, permuted (K13)
                sl_idx, sl_rows, sl_valid = shuffle_planes(
                    shuf_keys[it], r_idx, r_rows, r_valid, w, start=ptr
                )
            else:
                cols = ptr[:, None] + rows_w  # [P, W]
                sl_rows = r_rows[parts[:, None], cols]  # [P, W, B]
                sl_valid = r_valid[parts[:, None], cols]
                sl_idx = r_idx[parts[:, None], cols]
            flat_idx = sl_idx.reshape(p, w * b)
            remaining = nbf - ptr

            params_c, ddm_c = params, ddm
            a_X_c, a_y_c, a_w_c, retr_c = a_X, a_y, a_w, retrain
            start = torch.zeros(p, dtype=torch.long, device=dev)
            open_ = torch.ones(p, dtype=torch.bool, device=dev)
            slab = FlagRows(
                *(torch.full((p, w), -1, dtype=torch.int32, device=dev)
                  for _ in range(4)),
                torch.zeros((p, w), dtype=torch.bool, device=dev),
            )

            for lvl in range(r_levels):
                live = (
                    sl_valid
                    & (rows_w[None, :] >= start[:, None])[:, :, None]
                    & open_[:, None, None]
                )
                ne = live.any(2)  # [P, W] nonempty live batches
                any_ne = ne.any(1)

                # Train on demand: the model is frozen within a level, so a
                # pending retrain applies at level start.
                fitted = model.fit(
                    a_X_c, a_y_c, a_w_c,
                    key=None if fit_keys is None else fit_keys[it, lvl],
                )
                pred_params = _select(retr_c & any_ne, fitted, params_c)
                errs = model.predict_err(
                    pred_params, rows, labels, flat_idx
                ).view(p, w, b)

                new_ddm, res = det.window(ddm_c, errs, live)
                change = (res.first_change >= 0) & ne

                if retrain_error_threshold is not None:
                    bw = live.float()
                    err_rate = (errs * bw).sum(2) / bw.sum(2).clamp_min(1.0)
                    forced = ne & ~change & (err_rate > retrain_error_threshold)
                else:
                    forced = torch.zeros_like(change)
                rotate = change | forced

                # Commit rows [start, end): up to and including the first
                # rotating batch, or the whole tail if none.
                any_rot = rotate.any(1)
                first = torch.where(rotate, rows_w, w).amin(1)
                rpos = torch.where(any_rot, first, 0)
                end = torch.where(any_rot, rpos + 1, w)
                row_mask = (
                    open_[:, None]
                    & (rows_w >= start[:, None])
                    & (rows_w < end[:, None])
                )
                lvl_slab = FlagRows(
                    res.first_warning,
                    _gather_row(sl_rows, res.first_warning),
                    res.first_change,
                    _gather_row(sl_rows, res.first_change),
                    forced,
                )
                slab = FlagRows(
                    *(torch.where(row_mask, new, old)
                      for new, old in zip(lvl_slab, slab))
                )

                # Rotate from the first rotating batch; commit the fit if a
                # nonempty batch was processed with it.
                any_ne_cov = (ne & (rows_w < end[:, None])).any(1)
                take_rot = open_ & any_rot
                params_c = _select(open_ & retr_c & any_ne_cov, fitted, params_c)
                ddm_c = _select(
                    open_, _select(any_rot, det.init((p,), dev), new_ddm), ddm_c
                )
                rot_idx = sl_idx[parts, rpos].long()  # [P, B]
                a_X_c = _select(take_rot, table[rot_idx], a_X_c)
                a_y_c = _select(take_rot, labels[rot_idx], a_y_c)
                a_w_c = _select(take_rot, sl_valid[parts, rpos].float(), a_w_c)
                retr_c = torch.where(open_ & any_ne_cov, any_rot, retr_c)
                start = torch.where(open_, end, start)
                open_ = open_ & any_rot

            # Write the committed slab; rows past the commit point are
            # overwritten by the next window, and finished lanes write into
            # the pad region past NBF.
            write_at = torch.where(active, ptr, nbf)
            wcols = write_at[:, None] + rows_w
            for full, part in zip(flags, slab):
                full.scatter_(1, wcols, part)

            params = _select(active, params_c, params)
            ddm = _select(active, ddm_c, ddm)
            a_X = _select(active, a_X_c, a_X)
            a_y = _select(active, a_y_c, a_y)
            a_w = _select(active, a_w_c, a_w)
            retrain = torch.where(active, retr_c, retrain)
            ptr = ptr + torch.where(active, torch.minimum(start, remaining), 0)
            if chain is not None:
                lane_iters += active  # a lane's key advances while it is active
            it += 1

        # each lane's key after its own iterations
        key_out = None if chain is None else chain[lane_iters.cpu().numpy(), np.arange(p)]
        carry_out = LoopCarry(params, ddm, a_X, a_y, a_w, retrain, key_out)
        return carry_out, FlagRows(*(leaf[:, :nbf] for leaf in flags))

    return span


def make_window_runner(
    model: Model,
    ddm_params: DDMParams,
    *,
    window: int = 16,
    shuffle: bool = False,
    retrain_error_threshold: float | None = None,
    detector=None,
    rotations: int = 1,
):
    """Build ``run(batches, key=None) -> FlagRows`` over all partitions:
    batch 0 of each partition seeds ``batch_a``, and the flag leaves are
    ``[P, NB - 1]``. ``key [P, 2]`` uint32, the partitions' keys, is
    needed by a keyed model and by ``shuffle=True``."""
    det = resolve_detector(ddm_params, detector)
    span = make_window_span(
        model,
        ddm_params,
        window=window,
        shuffle=shuffle,
        retrain_error_threshold=retrain_error_threshold,
        detector=det,
        rotations=rotations,
    )

    def run(batches: "Batches | IndexedBatches", key=None) -> FlagRows:
        p = batches.valid.shape[0]
        dev = batches.valid.device
        init_key = None
        if model.keyed or shuffle:  # key, k_init = split(key), per partition
            if key is None:
                raise ValueError("a keyed model or shuffle=True needs the partitions' keys")
            pair = threefry.split(np.asarray(key, np.uint32), 2)
            key = pair[:, 0]
            if model.keyed:
                init_key = device_keys(pair[:, 1], dev)
        if isinstance(batches, IndexedBatches):
            i0 = batches.idx[:, 0].long()
            a_X, a_y = batches.base_X[i0].float(), batches.base_y[i0]
            rest = batches._replace(
                idx=batches.idx[:, 1:],
                rows=batches.rows[:, 1:],
                valid=batches.valid[:, 1:],
            )
        else:
            # contiguous, as the fit takes them
            a_X = batches.X[:, 0].float().contiguous()
            a_y = batches.y[:, 0].contiguous()
            rest = Batches(*(leaf[:, 1:] for leaf in batches))
        carry = LoopCarry(
            params=model.init(p, dev, key=init_key),
            ddm=det.init((p,), dev),
            a_X=a_X,
            a_y=a_y,
            a_w=batches.valid[:, 0].float(),
            retrain=torch.ones(p, dtype=torch.bool, device=dev),
            key=key if model.keyed or shuffle else None,
        )
        _, flags = span(carry, rest)
        return flags

    return run
