"""Numeric-sanity validation — the port's twin of the JAX package's
``utils/validate.py``.

* :func:`checked_ddm_window` — the DDM window statistic with its contract
  checked on the device: error inputs are 0/1 indicators, the carried state
  is a coherent ``(count, err_sum)`` pair below float32's exact-count limit,
  and the post-update statistics are finite. It returns ``(err, (end,
  result))`` in checkify style; ``err`` holds the five predicates as device
  booleans, so the call itself never reads the device from the host, and
  ``err.throw()`` syncs once and raises the first violated check with the
  JAX package's message.
* :func:`validate_stream` — the host-side ingest audit ``api.prepare`` runs
  before any device work when ``RunConfig(validate=True)``.
* :func:`validate_flag_rows` — a host-side structural audit of a run's
  collected flag table (sentinel domain, index ranges, warning/change
  order), run after the Final Time span.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DDMParams
from ..ops.ddm import DDMState, ddm_window


class CheckError(ValueError):
    """A violated :func:`checked_ddm_window` contract (the JAX package's
    ``JaxRuntimeError``, also a ``ValueError``)."""


class Checks:
    """Named device predicates in program order, read on demand."""

    def __init__(self, checks: list):
        self._checks = checks  # [(bool tensor, message)]

    def get(self) -> "str | None":
        """The first violated check's message, or None (one host sync)."""
        ok = torch.stack([pred.reshape(()) for pred, _ in self._checks]).cpu().tolist()
        for good, (_, msg) in zip(ok, self._checks):
            if not good:
                return f"{msg} (`check` failed)"
        return None

    def throw(self) -> None:
        """Raise :class:`CheckError` on the first violated check."""
        msg = self.get()
        if msg is not None:
            raise CheckError(msg)


def checked_ddm_window(
    state: DDMState,
    errs: torch.Tensor,
    valid: torch.Tensor,
    params: DDMParams = DDMParams(),
):
    """:func:`..ops.ddm.ddm_window` (``state`` leaves ``[P]``, ``errs`` and
    ``valid`` ``[P, W, B]``) with its contract checked on the device.
    Returns ``(err, (end_state, result))``; ``err.throw()`` raises on the
    first violated check. A partition's window holds ``W·B`` elements, the
    JAX package's ``errs.size`` for its one partition."""
    n = errs[0].numel() if errs.dim() else 0
    count_f = state.count.float()
    checks = [
        (((errs == 0.0) | (errs == 1.0)).all(), "errs must be 0/1 error indicators"),
        ((state.count >= 0).all(), "detector count must be non-negative"),
        (((state.err_sum >= -1e-3) & (state.err_sum <= count_f + 1e-3)).all(),
         "err_sum must lie in [0, count]"),
        # f32 error sums are exact below 2**24 elements between resets
        # (ops.ddm's numerical note); past that the p statistic silently
        # loses precision, so fail loudly instead.
        ((count_f + n < 2.0**24).all(),
         "detector count near f32 exactness limit (2^24); reset overdue"),
    ]
    end, res = ddm_window(state, errs, valid, params)
    checks.append((
        (torch.isfinite(end.err_sum) & (end.count >= state.count)).all(),
        "post-update state must be finite and monotone in count",
    ))
    return Checks(checks), (end, res)


def validate_stream(stream) -> None:
    """Host-side ingest audit of a prepared ``io.stream.StreamData``: every
    *valid* row's features finite, labels in ``0..C-1``, and the quarantine
    mask (when present) shape-aligned. Masked rows are exempt — they never
    reach compute. Raises ``ValueError`` naming the first offending stream
    position."""
    # Audit the table for compressed streams (every stream row is a table
    # gather, so a finite table is a finite stream) — the dense planes
    # otherwise; the mask audited alongside is the matching one.
    if stream.src is not None:
        X, y = stream.base_X, stream.base_y
        t_ok = stream.base_ok
    else:
        X, y = stream.X, stream.y
        t_ok = stream.row_ok
    if t_ok is not None:
        t_ok = np.asarray(t_ok, bool)
        if t_ok.shape != (len(y),):
            raise ValueError(
                f"stream validation failed: row mask shape {t_ok.shape} "
                f"!= ({len(y)},)"
            )
        if not t_ok.any():
            raise ValueError(
                "stream validation failed: every row is masked"
            )
    sel_X = X if t_ok is None else X[t_ok]
    sel_y = y if t_ok is None else y[t_ok]
    if not np.isfinite(sel_X).all():
        bad = ~np.isfinite(np.asarray(X)).all(axis=1)
        if t_ok is not None:
            bad &= t_ok
        rows = np.nonzero(bad)[0]
        raise ValueError(
            "stream validation failed: non-finite feature value(s) in "
            f"valid row(s) {rows[:5].tolist()}"
        )
    if sel_y.size and (
        (sel_y < 0).any() or (sel_y >= max(stream.num_classes, 1)).any()
    ):
        bad = sel_y[(sel_y < 0) | (sel_y >= max(stream.num_classes, 1))]
        raise ValueError(
            "stream validation failed: label(s) outside 0.."
            f"{stream.num_classes - 1}: {bad[:5].tolist()}"
        )


def validate_flag_rows(
    flags, num_batches: int, per_batch: int, num_rows: int
) -> None:
    """Structural audit of a run's collected flag table (host side):
    ``flags`` is a host ``FlagRows`` with ``[P, NB-1]`` leaves
    (``api.RunResult.flags``). Raises ``ValueError`` with the first
    violation found."""
    wl = np.asarray(flags.warning_local)
    wg = np.asarray(flags.warning_global)
    cl = np.asarray(flags.change_local)
    cg = np.asarray(flags.change_global)

    def fail(msg):
        raise ValueError(f"flag-table validation failed: {msg}")

    if not (wl.shape == wg.shape == cl.shape == cg.shape):
        fail("flag planes disagree on shape")
    if wl.shape[1] != max(num_batches - 1, 0):
        # Exact, both directions: a dropped boundary (too few flag rows) is
        # as much a corruption as an extra one.
        fail(
            f"{wl.shape[1]} flag rows for {num_batches} batches "
            "(expected exactly num_batches - 1)"
        )
    for name, local in (("warning_local", wl), ("change_local", cl)):
        bad = (local < -1) | (local >= per_batch)
        if bad.any():
            fail(f"{name} outside [-1, per_batch): {local[bad][:5].tolist()}")
    for name, glob, local in (
        ("warning_global", wg, wl),
        ("change_global", cg, cl),
    ):
        if ((glob < -1) | (glob >= num_rows)).any():
            fail(f"{name} outside [-1, num_rows)")
        if ((glob >= 0) != (local >= 0)).any():
            fail(f"{name} sentinel disagrees with its local column")
    # The reference records a warning only when it precedes the change in the
    # same batch (first-warning scan stops at the change, C6 :147-152).
    both = (wl >= 0) & (cl >= 0)
    if (wl[both] > cl[both]).any():
        fail("warning recorded after the change within a batch")
