"""Champion/challenger shadow scoring for the adaptation plane.

The port's twin of the JAX package's ``adapt/shadow.py``. Under
``on_drift=shadow`` the stale model (the **champion**) is not swapped out on
a drift verdict: a **challenger** is refitted on the post-drift window and
both are scored on the same rows in one launch — the two per-partition
parameter trees are stacked side-major on the leading axis (``[2·P, ...]``,
side 0 the champion) and the model's fused ``predict_err`` (kernel K2, K10
or K12 on the card, as the model decides) reads the window as a row table
through an ``int32`` index ``[2·P, W]``. Promotion is gated on the measured
error (the challenger must beat the champion by more than
``AdaptPolicy.margin``); after a promotion the deposed champion is retained
on the host for one probation window, and if the challenger *regresses*
against it there the swap is reverted (demotion).

A side's error is ``Σ err·w / max(P·Σw, 1)``: the sums are of 0/1 values,
exact in float32 below 2^24, so the ratio is the JAX package's bit for bit.
"""

from __future__ import annotations

import torch

from ..engine.chunked import _tree_map
from ..models.base import pad_row_table
from ..utils.checkpoint import _flatten


def stack_sides(champion, challenger):
    """Stack two per-partition param trees side-major on the leading axis
    (``[2·P, ...]``: the champion's P partitions, then the challenger's)
    — the pair scorer's input."""
    return _tree_map(lambda a, b: torch.cat([a, b]), champion, challenger)


def window_table(X, y, device):
    """The window's rows as ``predict_err`` reads them: the padded row
    table ``[W, row_stride(F)]`` and the labels ``[W]`` on ``device``."""
    T = torch.as_tensor(X, dtype=torch.float32).to(device)
    return pad_row_table(T.contiguous()), torch.as_tensor(y, dtype=torch.int32).to(device)


def make_pair_scorer(model):
    """Build the shadow scorer: ``(stacked [2·P, ...], X [W, F], y [W],
    w [W]) -> (err [2], n [2])``, float32 tensors on the params' device.

    Every side's every partition scores the same window; a side's error is
    the validity-weighted mean mis-prediction rate pooled over its
    partitions. ``w`` masks window padding; an all-masked window gives
    errors of 0 with ``n == 0`` (:func:`pair_errors` reads that as "no
    evidence")."""

    def score(stacked, X, y, w):
        leaf = _flatten(stacked)[0]
        dev, sp = leaf.device, leaf.shape[0]
        T, Ty = window_table(X, y, dev)
        wt = torch.as_tensor(w, dtype=torch.float32).to(dev)
        n_rows = T.shape[0]
        idx = torch.arange(n_rows, dtype=torch.int32, device=dev).expand(sp, n_rows).contiguous()
        err = model.predict_err(stacked, T, Ty, idx)  # [2·P, W] of 0/1
        err_sum = (err * wt[None, :]).view(2, -1).sum(1)
        n = torch.full((2,), float(sp // 2), dtype=torch.float32, device=dev) * wt.sum()
        return err_sum / n.clamp_min(1.0), n

    return score


def pair_errors(scorer, champion, challenger, X, y, w):
    """Score a champion/challenger pair on one window; returns
    ``(err_champion, err_challenger)`` as floats, or ``(None, None)`` when
    the window carries no valid rows."""
    err, n = scorer(stack_sides(champion, challenger), X, y, w)
    err = err.cpu().numpy()
    n = n.cpu().numpy()
    if float(n[0]) <= 0.0:
        return None, None
    return float(err[0]), float(err[1])


def should_promote(
    err_champion: "float | None",
    err_challenger: "float | None",
    margin: float,
) -> bool:
    """The promotion gate: the challenger must *measurably* beat the
    champion on the shadow slice. No evidence (empty window) keeps the
    champion — a swap must never ride on zero rows."""
    if err_champion is None or err_challenger is None:
        return False
    return err_challenger < err_champion - margin


def should_demote(
    err_champion: "float | None",
    err_challenger: "float | None",
    margin: float,
) -> bool:
    """The probation gate after a promotion: demote (restore the old
    champion) only when it *measurably* beats the challenger on the
    probation window — ties and missing evidence keep the challenger."""
    if err_champion is None or err_challenger is None:
        return False
    return err_champion < err_challenger - margin
