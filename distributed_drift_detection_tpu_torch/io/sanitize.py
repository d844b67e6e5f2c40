"""Ingest-time stream-contract validation — the data plane's robustness layer.

The port's own copy of the JAX package's ``io/sanitize.py``, its ``doctor``
CLI (:func:`main`, ``python -m distributed_drift_detection_tpu_torch
doctor``) included; ``api.run``'s telemetry exports ``QUARANTINE_METRIC``.

The reference assumes a pristine numeric CSV (``DDM_Process.py:33-35``): a
non-numeric cell crashes the load, a ragged row silently falls back to a
different parser, and a single NaN feature poisons the DDM error statistics
for the rest of the stream (f32 NaN propagates through ``ops/ddm.py`` so
the detector never — or always — fires). At the ROADMAP's serving scale,
malformed rows are the *dominant* failure mode, and they are not transient:
retrying a poisoned stream (the resilience layer's retries) burns the retry budget
and still yields garbage. This module gives the data plane the same
closed-loop treatment the process plane already has — detect bad rows,
quarantine them, keep the detector's statistics exactly what they would
have been on the clean stream.

The **stream contract** (what ``doctor`` and the loaders enforce):

* header: named columns, unique, containing the target column;
* every data row has exactly ``len(header)`` comma-separated fields;
* every cell parses as a finite float;
* the target column holds integral labels exact in f32 (``|y| < 2^24``).

Three **policies** decide what a violation does
(``RunConfig(data_policy=...)`` / ``--data-policy``):

=============  ==========================================================
``strict``     raise a structured :class:`StreamContractError` naming
               file / row / column / reason (the default: fail loudly,
               never compute on garbage)
``quarantine`` drop the row — append it with its reason to a
               ``quarantine.jsonl`` sidecar and carry it *positionally*
               as a masked row, so downstream striping folds it into the
               existing ``[P, NB, B]`` validity plane and inside jit it
               is indistinguishable from padding (static shapes, no
               recompiles, bit-identical flags to the clean stream with
               those rows masked — the headline acceptance)
``repair``     impute finite column means for NaN feature cells and
               clamp (round) non-integral labels; rows that cannot be
               repaired (ragged, non-finite label) are quarantined
=============  ==========================================================

Pure numpy + stdlib. The ``stream.load`` fault site (``resilience.faults``) injects
deterministic corruption (``nan_cell`` / ``bad_label`` / ``ragged_row``)
through the same loader, so this path is exercised by seeded injection,
not by hoping for dirty data.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import NamedTuple

import numpy as np

from ..resilience import faults

#: Valid ``RunConfig.data_policy`` values (mirrored in ``config.py`` for
#: jax-free CLI validation).
POLICIES = ("strict", "quarantine", "repair")

SIDECAR_VERSION = 1

#: The one name/help of the quarantine counter — registered by the
#: feeder (per-chunk masking) and api.run (per-run total); a single
#: constant so the metric can never fork into two series over a typo.
QUARANTINE_METRIC = "ingest_quarantined_total"
QUARANTINE_METRIC_HELP = "Stream rows masked out by the quarantine policy"


class StreamContractError(ValueError):
    """A stream violated the ingest contract under ``data_policy='strict'``.

    Structured: ``file`` / ``row`` (0-based data-row index, header
    excluded) / ``column`` (0-based index or None for row-level issues)
    / ``reason`` ride as attributes; the message names all of them plus
    the total violation count, so the first log line is the diagnosis.
    """

    def __init__(
        self,
        file: str,
        row: "int | None" = None,
        column: "int | None" = None,
        reason: str = "stream contract violated",
        column_name: "str | None" = None,
        total: int = 1,
    ):
        self.file = file
        self.row = row
        self.column = column
        self.column_name = column_name
        self.reason = reason
        self.total = total
        where = file
        if row is not None:
            where += f", data row {row}"
        if column is not None:
            col = f"column {column}"
            if column_name is not None:
                col += f" ({column_name!r})"
            where += f", {col}"
        more = f" (+{total - 1} more violation(s))" if total > 1 else ""
        super().__init__(f"{where}: {reason}{more}")


class RowIssue(NamedTuple):
    """One contract violation, pinned to a data row (0-based, header
    excluded) and optionally a column. ``repairable`` marks issues the
    ``repair`` policy can fix in place (NaN feature cell, non-integral
    label); ragged rows and non-finite labels are not."""

    row: int
    column: "int | None"
    reason: str
    repairable: bool = False


class QuarantineReport(NamedTuple):
    """What sanitizing one stream did — carried on ``StreamData`` and
    surfaced as the ``rows_quarantined`` telemetry event +
    ``ingest_quarantined_total`` counter."""

    policy: str
    rows_quarantined: int
    rows_repaired: int
    sidecar: "str | None"
    issues: tuple  # tuple[RowIssue, ...] (first _MAX_REPORT, for messages)


_MAX_REPORT = 32  # issues carried on the report (the sidecar has them all)


def check_policy(policy: str) -> str:
    if policy not in POLICIES:
        raise ValueError(
            f"unknown data_policy {policy!r}; expected one of {POLICIES}"
        )
    return policy


def validate_header(
    header: list[str], target_column: str, path: str
) -> int:
    """Validate the header row; returns the target column index.

    Header problems are never row-quarantinable — without a trustworthy
    header nothing downstream can be aligned — so they raise
    :class:`StreamContractError` under every policy.
    """
    names = [h.strip() for h in header]
    if any(not n for n in names):
        raise StreamContractError(
            path, reason=f"header has empty column name(s): {names}"
        )
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise StreamContractError(
            path, reason=f"header has duplicate column name(s): {dupes}"
        )
    if target_column not in names:
        raise StreamContractError(
            path,
            reason=(
                f"target column {target_column!r} not in header; "
                f"columns found: {names}"
            ),
        )
    return names.index(target_column)


def parse_rows(
    lines: list[str], num_columns: int
) -> tuple[np.ndarray, list[RowIssue]]:
    """Tolerant CSV parse: ``[n, num_columns]`` f32 + issues.

    The dirty-path complement of the fast parsers (``io.native`` /
    ``np.loadtxt``), which reject the whole file on one bad cell: here a
    ragged row becomes a row-level issue (its cells are NaN), a
    non-numeric cell becomes a cell-level issue (that cell is NaN), and
    everything parseable parses. Blank lines are skipped (matching
    ``np.loadtxt``).

    Three vectorized tiers, coarsest first, so the per-cell Python loop
    runs only over rows that actually contain a dirty cell: (1) every
    rectangular row's fields convert in ONE ``np.asarray`` call — the
    overwhelmingly common shape of a dirty *block* (a handful of bad rows
    in thousands of clean ones) when only raggedness broke the fast path;
    (2) on failure, per-row array conversion; (3) per-cell ``float`` for
    the rows tier 2 refused. All tiers parse text → float64 → f32 (the
    same correctly-rounded double parse, so a cell's value is identical
    whichever tier lands it). Serve admission batches each recv-block
    through here (``serve.admission``), so the ingress daemon rides the
    same vectorization.
    """
    rows = [ln for ln in lines if ln.strip()]
    out = np.zeros((len(rows), num_columns), np.float32)
    issues: list[RowIssue] = []
    split = [line.split(",") for line in rows]
    rect: list[int] = []  # rows with the right field count
    for r, fields in enumerate(split):
        if len(fields) != num_columns:
            issues.append(
                RowIssue(
                    r,
                    None,
                    f"ragged row: {len(fields)} field(s), expected "
                    f"{num_columns}",
                )
            )
            out[r] = np.nan
        else:
            rect.append(r)

    def _cells(r: int) -> None:
        for c, tok in enumerate(split[r]):
            try:
                out[r, c] = float(tok)
            except ValueError:
                # Cell-level: the cell is NaN after this, so the repair
                # policy can impute it (unless it is the label column —
                # apply_policy demotes unrepairable label cells there).
                issues.append(
                    RowIssue(
                        r, c, f"non-numeric cell {tok.strip()!r}",
                        repairable=True,
                    )
                )
                out[r, c] = np.nan

    if rect:
        flat = [tok for r in rect for tok in split[r]]
        try:
            out[rect] = np.asarray(flat, np.float64).reshape(
                len(rect), num_columns
            )
        except ValueError:
            for r in rect:
                try:
                    out[r] = np.asarray(split[r], np.float64)
                except ValueError:
                    _cells(r)
    issues.sort(key=lambda i: (i.row, -1 if i.column is None else i.column))
    return out, issues


def scan_matrix(
    raw: np.ndarray,
    tcol: int,
    header: "list[str] | None" = None,
    flagged: frozenset = frozenset(),
) -> list[RowIssue]:
    """Contract-scan a parsed ``[n, cols]`` matrix: non-finite feature
    cells (repairable), non-finite labels, non-integral labels
    (repairable), labels beyond f32 integer exactness. Rows already in
    ``flagged`` (text-level issues) are skipped — one issue per cause.
    """
    issues: list[RowIssue] = []
    n, cols = raw.shape
    finite = np.isfinite(raw)
    y = raw[:, tcol]
    y_ok = finite[:, tcol]
    bad_feat = ~finite
    bad_feat[:, tcol] = False
    for r in np.nonzero(bad_feat.any(axis=1))[0]:
        if int(r) in flagged:
            continue
        c = int(np.nonzero(bad_feat[r])[0][0])
        issues.append(
            RowIssue(int(r), c, "non-finite feature value", repairable=True)
        )
    for r in np.nonzero(~y_ok)[0]:
        if int(r) in flagged:
            continue
        issues.append(RowIssue(int(r), tcol, "non-finite label"))
    with np.errstate(invalid="ignore"):
        nonint = y_ok & (y != np.round(y))
        toobig = y_ok & (np.abs(y) >= 2.0**24)
    for r in np.nonzero(nonint)[0]:
        if int(r) in flagged:
            continue
        issues.append(
            RowIssue(
                int(r), tcol, f"non-integral label {float(y[r])!r}",
                repairable=True,
            )
        )
    for r in np.nonzero(toobig)[0]:
        if int(r) in flagged:
            continue
        issues.append(
            RowIssue(
                int(r),
                tcol,
                "label at or above 2^24 is not exactly representable in "
                "f32; re-encode the target column",
            )
        )
    issues.sort(key=lambda i: (i.row, -1 if i.column is None else i.column))
    return issues


def scan_csv(
    path: str, target_column: str = "target", *, jobs: int = 1
) -> tuple[list[RowIssue], int]:
    """Full jax-free contract scan of a CSV: ``(issues, data_rows)``.

    The ``doctor`` CLI's engine — header validation raises, row/cell
    violations are returned. Always uses the tolerant parser (this is a
    diagnostic pass, not the hot ingest path).

    ``jobs > 1`` splits the data region into that many line-aligned byte
    ranges (the SAME splitter the parallel ingest pipeline uses —
    ``io.blocks.line_block_ranges``) and scans them in a thread pool;
    block results are rebased to absolute data-row indices and folded in
    block order, so the returned issue list — and hence the doctor CLI's
    printed violation order — is identical to the serial scan's (pinned
    by test).
    """
    jobs = max(1, int(jobs))
    with open(path) as fh:
        header = fh.readline().rstrip("\n").rstrip("\r").split(",")
        tcol = validate_header(header, target_column, path)
        if jobs == 1:
            lines = fh.read().splitlines()

    def scan_lines(block_lines: list[str]) -> tuple[int, list[RowIssue]]:
        raw, found = parse_rows(block_lines, len(header))
        found = found + scan_matrix(
            raw, tcol, header, flagged=frozenset(i.row for i in found)
        )
        return len(raw), found

    if jobs == 1:
        scanned = [scan_lines(lines)]
    else:
        from concurrent.futures import ThreadPoolExecutor

        from .blocks import line_block_ranges, open_mapped

        fh, buf, data_start = open_mapped(path)
        try:
            span = len(buf) - data_start
            block_bytes = max(1, -(-span // jobs))
            ranges = line_block_ranges(buf, data_start, block_bytes)
            with ThreadPoolExecutor(max_workers=jobs) as ex:
                scanned = list(
                    ex.map(
                        lambda r: scan_lines(
                            buf[r[0] : r[1]].decode().splitlines()
                        ),
                        ranges,
                    )
                )
        finally:
            close = getattr(buf, "close", None)
            if close is not None:
                close()
            fh.close()

    issues: list[RowIssue] = []
    total = 0
    for n_rows, found in scanned:  # block order == file order
        issues.extend(i._replace(row=total + i.row) for i in found)
        total += n_rows
    issues.sort(key=lambda i: (i.row, -1 if i.column is None else i.column))
    return issues, total


def mask_rows(
    X: np.ndarray, y: np.ndarray, row_ok: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Canonicalize masked rows: features to 0.0, labels to the smallest
    valid label — deterministic fill, **the single normalization both
    the quarantine path and any clean-stream-with-rows-masked comparison
    share** (``io.stream.synthesize_stream`` applies it), so the two are
    bit-identical by construction. The label fill keeps masked rows at a
    stable position under the sort-by-target; their content never
    reaches compute (validity weight 0, and the striper re-zeros them to
    the padding fill on device)."""
    row_ok = np.asarray(row_ok, bool)
    if not row_ok.any():
        raise ValueError(
            "every row is masked/quarantined; no valid rows remain"
        )
    X = np.where(row_ok[:, None], X, X.dtype.type(0))
    y = np.where(row_ok, y, y[row_ok].min())
    return X, y


class QuarantineWriter:
    """Append-only ``quarantine.jsonl`` sidecar: one JSON line per
    quarantined row (``v``, ``file``, ``row``, ``column``,
    ``column_name``, ``reason``, ``policy``), opened lazily — a clean
    load leaves no artifact — and flushed per line, mirroring the
    telemetry sink's crash contract (a torn trailing line is tolerated
    by :func:`read_quarantine`, never a torn interior)."""

    def __init__(self, path: str, policy: str):
        self.path = path
        self.policy = policy
        self.rows = 0
        self._fh = None

    def append(
        self, file: str, issue: RowIssue, header: "list[str] | None" = None
    ) -> None:
        if self._fh is None:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._fh = open(self.path, "a")
        name = (
            header[issue.column]
            if header is not None and issue.column is not None
            else None
        )
        self._fh.write(
            json.dumps(
                {
                    "v": SIDECAR_VERSION,
                    "file": file,
                    "row": issue.row,
                    "column": issue.column,
                    "column_name": name,
                    "reason": issue.reason,
                    "policy": self.policy,
                }
            )
            + "\n"
        )
        self._fh.flush()
        self.rows += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def read_quarantine(
    path: str, *, allow_partial_tail: bool = False
) -> list[dict]:
    """Parse a quarantine sidecar; ``allow_partial_tail=True`` tolerates
    exactly one torn **trailing** line — the same crash/live-tail
    contract as ``telemetry.events.read_events`` (the sidecar is flushed
    per line, so a crash mid-append can tear only the last one)."""
    records = []
    with open(path) as fh:
        lines = fh.readlines()
    for lineno, line in enumerate(lines, 1):
        stripped = line.strip()
        if not stripped:
            continue
        try:
            rec = json.loads(stripped)
        except json.JSONDecodeError as e:
            if allow_partial_tail and lineno == len(lines):
                break
            raise ValueError(f"{path}:{lineno}: not JSON ({e})") from None
        if not isinstance(rec, dict) or "row" not in rec:
            raise ValueError(
                f"{path}:{lineno}: not a quarantine record: {stripped[:80]}"
            )
        records.append(rec)
    return records


class SanitizedCSV(NamedTuple):
    """``load_csv_sane``'s result: features/labels plus the row-validity
    mask (``None`` = every row clean) and the quarantine report."""

    X: np.ndarray  # [N, F] f32; quarantined rows canonicalized (mask_rows)
    y: np.ndarray  # [N] i64
    row_ok: "np.ndarray | None"  # [N] bool, None = all valid
    report: "QuarantineReport | None"


def apply_policy(
    raw: np.ndarray,
    issues: list[RowIssue],
    tcol: int,
    *,
    path: str,
    policy: str,
    quarantine_path: "str | None" = None,
    header: "list[str] | None" = None,
) -> tuple[np.ndarray, "np.ndarray | None", "QuarantineReport | None"]:
    """Resolve contract issues per policy on a parsed ``[n, cols]``
    matrix. Returns ``(matrix, row_ok | None, report | None)`` — the
    matrix is repaired in ``repair`` mode; quarantined rows are left for
    the caller to canonicalize via :func:`mask_rows`."""
    check_policy(policy)
    if not issues:
        return raw, None, None
    if policy == "strict":
        first = issues[0]
        raise StreamContractError(
            path,
            row=first.row,
            column=first.column,
            column_name=(
                header[first.column]
                if header is not None and first.column is not None
                else None
            ),
            reason=first.reason,
            total=len(issues),
        )

    repaired_rows: set[int] = set()
    drop: list[RowIssue] = []
    if policy == "repair":
        # A "repairable" issue on the *label* column is only fixable when
        # the parsed value is still finite (non-integral → round); a
        # non-numeric/NaN label has nothing to clamp — quarantine the row.
        with np.errstate(invalid="ignore"):
            label_finite = np.isfinite(raw[:, tcol])
        bad_rows = {
            i.row
            for i in issues
            if not i.repairable
            or (i.column == tcol and not label_finite[i.row])
        }
        fixable = [i for i in issues if i.repairable and i.row not in bad_rows]
        drop = [i for i in issues if i.row in bad_rows]
        if fixable:
            ok = np.ones(len(raw), bool)
            ok[sorted(bad_rows)] = False
            feat_finite = np.isfinite(raw) & ok[:, None]
            label_rows = {i.row for i in fixable if i.column == tcol}
            feat_rows = {i.row for i in fixable if i.column != tcol}
            for r in sorted(label_rows):
                raw[r, tcol] = np.round(raw[r, tcol])
            for r in sorted(feat_rows):
                # Impute EVERY non-finite feature cell of the row, not
                # just the first one scan_matrix reported — a row with
                # two NaN cells must leave repair fully finite, or the
                # survivor poisons the f32 detector statistics (the
                # exact failure this module exists to prevent).
                for c in np.nonzero(~np.isfinite(raw[r]))[0]:
                    if c == tcol:
                        continue
                    col = raw[feat_finite[:, c], c]
                    raw[r, c] = col.mean() if col.size else 0.0
            repaired_rows = label_rows | feat_rows
    else:  # quarantine
        drop = issues

    row_ok = None
    writer = None
    dropped_rows: list[int] = []
    if drop:
        row_ok = np.ones(len(raw), bool)
        seen: set[int] = set()
        if quarantine_path:
            writer = QuarantineWriter(quarantine_path, policy)
        try:
            for i in drop:
                row_ok[i.row] = False
                if writer is not None and i.row not in seen:
                    writer.append(path, i, header)
                seen.add(i.row)
        finally:
            if writer is not None:
                writer.close()
        dropped_rows = sorted(seen)
        if not row_ok.any():
            raise StreamContractError(
                path,
                reason=(
                    f"all {len(raw)} data rows violate the stream "
                    "contract; nothing left to quarantine around"
                ),
                total=len(issues),
            )
    report = QuarantineReport(
        policy=policy,
        rows_quarantined=len(dropped_rows),
        rows_repaired=len(repaired_rows),
        sidecar=writer.path if writer is not None else None,
        issues=tuple(issues[:_MAX_REPORT]),
    )
    return raw, row_ok, report


def apply_block_policy(
    arr: np.ndarray,
    issues: list[RowIssue],
    *,
    path: str,
    policy: str,
    base_row: int = 0,
    writer: "QuarantineWriter | None" = None,
    header: "list[str] | None" = None,
) -> tuple[np.ndarray, "np.ndarray | None"]:
    """Streaming (per-block) policy application — the single home of the
    strict-raise and quarantine-write semantics for block readers
    (``io.feeder.csv_chunks``), so they cannot drift from the whole-file
    :func:`apply_policy`. Issues carry block-local row indices;
    ``base_row`` rebases them to absolute data-row indices for the error
    and the sidecar. Returns ``(arr, ok | None)`` with quarantined rows
    zeroed to the padding fill. Under ``policy='repair'`` the caller runs
    :func:`repair_rows` first (streaming running-mean imputation — the
    feeder and serve admission both do) and hands the *remaining*
    unrepairable issues here, which fall through to the quarantine
    branch below exactly like the whole-file repair's drop list.
    """
    if not issues:
        return arr, None
    issues = sorted(
        issues, key=lambda i: (i.row, -1 if i.column is None else i.column)
    )
    if policy == "strict":
        first = issues[0]
        raise StreamContractError(
            path,
            row=base_row + first.row,
            column=first.column,
            column_name=(
                header[first.column]
                if header is not None and first.column is not None
                else None
            ),
            reason=first.reason,
            total=len(issues),
        )
    ok = np.ones(len(arr), bool)
    seen: set[int] = set()
    for i in issues:
        ok[i.row] = False
        if writer is not None and i.row not in seen:
            writer.append(path, i._replace(row=base_row + i.row), header)
        seen.add(i.row)
    # Padding-canonical fill (the stripe re-checks, but no NaN should
    # survive past the parser either way).
    arr = np.where(ok[:, None], arr, np.float32(0))
    return arr, ok


class RunningColumnStats:
    """Running finite-cell column means — the streaming complement of the
    whole-file ``repair`` policy's full-column statistics.

    ``apply_policy``'s repair imputes each NaN feature cell with the mean
    of its column's finite cells, which needs the whole file up front —
    exactly what a long-lived ingest daemon cannot have. This accumulator
    gives the serve admission path (``serve.admission``) the same repair
    semantics over the *rows admitted so far*: per-column running
    sum/count of finite cells, updated block by block, queried for the
    imputation means. Before any evidence a column's mean is 0.0 — the
    same canonical fill masked rows carry, so an imputed cell can never
    introduce a value the clean pipeline could not."""

    def __init__(self, num_columns: int):
        self._sum = np.zeros(num_columns, np.float64)
        self._count = np.zeros(num_columns, np.int64)

    def update(self, arr: np.ndarray, row_ok: "np.ndarray | None" = None) -> None:
        """Fold a block's finite cells in (rows with ``row_ok == False``
        are excluded — quarantined content must not steer the means)."""
        finite = np.isfinite(arr)
        if row_ok is not None:
            finite = finite & np.asarray(row_ok, bool)[:, None]
        self._sum += np.where(finite, arr, 0.0).sum(axis=0, dtype=np.float64)
        self._count += finite.sum(axis=0)

    def means(self) -> np.ndarray:
        """Per-column finite means (f32); 0.0 where no evidence yet."""
        return (self._sum / np.maximum(self._count, 1)).astype(np.float32)


def demote_unroundable_labels(
    issues: list[RowIssue],
    arr: np.ndarray,
    tcol: int,
    num_classes: "int | None",
) -> list[RowIssue]:
    """Label-domain guard for **streaming** repair (the serve-admission
    clause, ``serve.admission``): flip a label-column repairable issue
    (non-integral finite label) to unrepairable when rounding it could
    leave the engine's ``0..C-1`` index domain — checked on the ROUNDED
    value, exactly what repair would store. With ``num_classes`` None the
    domain is unknowable, so every such label demotes: the one-shot
    loader re-indexes labels after repair, a single-pass stream never
    does, and a fabricated out-of-range class index must never reach the
    engine. Feature-cell issues pass through untouched."""
    with np.errstate(invalid="ignore"):
        y_r = np.round(arr[:, tcol])
    out = []
    for i in issues:
        if i.repairable and i.column == tcol:
            in_domain = (
                num_classes is not None
                and np.isfinite(y_r[i.row])
                and 0 <= y_r[i.row] < num_classes
            )
            if not in_domain:
                out.append(i._replace(repairable=False))
                continue
        out.append(i)
    return out


def repair_rows(
    arr: np.ndarray,
    issues: list[RowIssue],
    tcol: int,
    stats: RunningColumnStats,
) -> tuple[np.ndarray, list[RowIssue], int]:
    """Streaming (per-block) repair: the running-stats twin of
    ``apply_policy``'s whole-file repair branch.

    Repairable issues are fixed in place — non-integral finite labels are
    rounded, non-finite feature cells imputed from ``stats`` (the means
    over rows admitted *so far*, not the whole stream — the documented
    semantic difference from the one-shot loader's repair) — and every
    non-finite feature cell of a fixable row is imputed, not just the
    reported one (same all-cells rule as ``apply_policy``). Rows that
    cannot be repaired (ragged, non-finite label) come back as the
    remaining issues for the caller to quarantine via
    :func:`apply_block_policy`. Returns ``(arr, remaining, repaired_rows)``.
    """
    if not issues:
        return arr, [], 0
    with np.errstate(invalid="ignore"):
        label_finite = np.isfinite(arr[:, tcol])
    bad_rows = {
        i.row
        for i in issues
        if not i.repairable or (i.column == tcol and not label_finite[i.row])
    }
    fixable = sorted(
        {i.row for i in issues if i.repairable and i.row not in bad_rows}
    )
    means = stats.means() if fixable else None
    for r in fixable:
        if label_finite[r] and arr[r, tcol] != np.round(arr[r, tcol]):
            arr[r, tcol] = np.round(arr[r, tcol])
        for c in np.nonzero(~np.isfinite(arr[r]))[0]:
            if c != tcol:
                arr[r, c] = means[c]
    remaining = [i for i in issues if i.row in bad_rows]
    return arr, remaining, len(fixable)


def _fast_parse(path: str, header: list[str]) -> "np.ndarray | None":
    """The clean-stream fast path: native multithreaded parser, NumPy
    fallback; ``None`` when the data is malformed (caller falls to the
    tolerant parser). A native/NumPy column-count disagreement with the
    header raises via ``io.stream.load_csv``'s satellite contract — here
    it simply reads as malformed and the tolerant path diagnoses it."""
    from .native import load_csv_native

    raw = load_csv_native(path)
    if raw is not None and raw.shape[1] == len(header):
        return raw
    try:
        arr = np.loadtxt(
            path, delimiter=",", skiprows=1, dtype=np.float32, ndmin=2
        )
    except ValueError:
        return None
    return arr if arr.shape[1] == len(header) else None


def load_csv_sane(
    path: str,
    target_column: str = "target",
    *,
    policy: str = "strict",
    quarantine_path: "str | None" = None,
) -> SanitizedCSV:
    """Load a CSV under the stream contract (the policy-aware twin of
    ``io.stream.load_csv``).

    Clean files ride the fast parsers and pay one finite/label scan; the
    tolerant row parser runs only when the fast path refuses the data.
    The ``stream.load`` fault site fires here (``resilience.faults`` —
    no-op unless armed): corruption kinds mutate the raw text lines
    before parsing, so injected dirt flows through exactly the machinery
    real dirt would.
    """
    check_policy(policy)
    with open(path) as fh:
        header = fh.readline().rstrip("\n").rstrip("\r").split(",")
    tcol = validate_header(header, target_column, path)

    raw = None
    issues: list[RowIssue] = []
    if faults.armed("stream.load") is not None:
        with open(path) as fh:
            fh.readline()
            lines = fh.read().splitlines()
        faults.fire("stream.load", lines=lines, label_col=tcol, path=path)
        raw, issues = parse_rows(lines, len(header))
    else:
        raw = _fast_parse(path, header)
        if raw is None:
            with open(path) as fh:
                fh.readline()
                lines = fh.read().splitlines()
            raw, issues = parse_rows(lines, len(header))
    issues = issues + scan_matrix(
        raw, tcol, header, flagged=frozenset(i.row for i in issues)
    )
    issues.sort(key=lambda i: (i.row, -1 if i.column is None else i.column))

    raw, row_ok, report = apply_policy(
        raw,
        issues,
        tcol,
        path=path,
        policy=policy,
        quarantine_path=quarantine_path,
        header=header,
    )
    fmask = np.ones(len(header), bool)
    fmask[tcol] = False
    X = raw[:, fmask]
    yf = raw[:, tcol]
    if row_ok is not None:
        X, yf = mask_rows(X, yf, row_ok)
    return SanitizedCSV(X, yf.astype(np.int64), row_ok, report)


def main(argv=None) -> None:
    """``doctor``: stream-contract check of CSV inputs, on the host.

    Exit 0 = every file satisfies the contract; 1 = violations found
    (each printed as ``file, data row R, column C (name): reason``);
    2 = usage / unreadable input. The scriptable pre-flight for sweeps:
    run it over the dataset before burning accelerator time.
    """
    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch doctor",
        description=(
            "Validate CSV stream inputs against the ingest contract "
            "(numeric cells, finite values, rectangular rows, label "
            "domain) without touching the card. Exit 0 = clean, 1 = dirty."
        ),
    )
    ap.add_argument("csv", nargs="+", help="CSV path(s) to validate")
    ap.add_argument(
        "--target-column",
        default="target",
        help="label column name (default: target)",
    )
    ap.add_argument(
        "--max-report",
        type=int,
        default=20,
        help="violations printed per file (the count is always exact)",
    )
    ap.add_argument(
        "--jobs",
        type=int,
        default=1,
        help="parallel scan blocks per file (line-aligned byte ranges, "
        "the ingest pipeline's splitter); violation output ordering is "
        "identical to the serial scan (default: 1)",
    )
    args = ap.parse_args(argv)

    dirty = False
    for path in args.csv:
        if path.startswith("synth:"):
            print(f"{path}: synthetic spec, nothing to validate")
            continue
        try:
            issues, n = scan_csv(path, args.target_column, jobs=args.jobs)
        except StreamContractError as e:
            print(f"{path}: {e}")
            dirty = True
            continue
        except OSError as e:
            # exit 2 = environment error, distinct from 1 = dirty data
            # (the docstring's contract a gating script branches on)
            print(f"doctor: cannot read {path}: {e}", file=sys.stderr)
            raise SystemExit(2)
        if not issues:
            print(f"{path}: OK ({n} data rows)")
            continue
        dirty = True
        bad_rows = len({i.row for i in issues})
        print(
            f"{path}: {len(issues)} violation(s) across {bad_rows} of "
            f"{n} data rows"
        )
        for i in issues[: args.max_report]:
            col = "" if i.column is None else f", column {i.column}"
            print(f"  data row {i.row}{col}: {i.reason}")
        if len(issues) > args.max_report:
            print(f"  ... {len(issues) - args.max_report} more")
    raise SystemExit(1 if dirty else 0)


if __name__ == "__main__":
    main(sys.argv[1:])
