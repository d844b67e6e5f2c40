"""Results persistence — the port's own copy of the JAX package's
``results.py``: ``append_result`` (reference C11, ``DDM_Process.py:263-273``)
and ``read_results``, the reader of the grid's torn-tail-tolerant resume.

Append-one-row-per-run CSV with the reference's column schema (see
``metrics.RESULT_COLUMNS``). Fixes quirk #1 of the SURVEY register: the
reference *reads* ``ddm_cluster_runs.csv`` but *writes*
``sparse_cluster_runs.csv`` (``:266`` vs ``:273``), breaking its own append
chain; here one file is both read and written.

Every append is flushed and fsynced before close, so a run recorded as
done survives the host dying a moment later; a torn trailing row left by
a killed writer is dropped before the next append.
"""

from __future__ import annotations

import csv
import os

from .metrics import RESULT_COLUMNS


def append_result(path: str, row: list) -> None:
    """Append one run row (writing the header on first use).

    Safe under concurrent writers (several grid processes sharing one
    results file — the reference's own usage pattern, where every
    ``run_experiments.sh`` invocation appends to the same CSV): an exclusive
    ``flock`` spans the header check and the row write, so rows can neither
    interleave mid-line nor race the header.
    """
    with open(path, "a+", newline="") as fh:
        try:
            import fcntl

            fcntl.flock(fh, fcntl.LOCK_EX)
        except (ImportError, OSError):  # non-POSIX / fs without flock:
            pass  # best-effort append
        # Torn-tail repair under the lock: a crashed writer can leave a
        # partial trailing row with no newline. Appending straight at
        # SEEK_END would merge this row with those bytes into one
        # overlong line that no reader tolerates — drop everything after
        # the last newline instead (the partial trial was never recorded,
        # so the idempotent resume re-runs it; a torn *header* truncates
        # to empty and is rewritten below).
        fh.seek(0, os.SEEK_END)
        if fh.tell():
            fh.seek(0)
            content = fh.read()
            if not content.endswith("\n"):
                fh.truncate(0)
                fh.write(content[: content.rfind("\n") + 1])
                fh.flush()
        # Header decision under the lock: another process may have written
        # it between our open and lock. Position is authoritative.
        fh.seek(0, os.SEEK_END)
        writer = csv.writer(fh)
        if fh.tell() == 0:
            writer.writerow(RESULT_COLUMNS)
        else:
            # The file may predate newer schema columns (the schema has
            # grown over time — Dataset…Detections, then Model/Detector).
            # Rows must match the header already in the file, or every
            # CSV consumer downstream chokes on ragged lines; project the
            # row onto the existing header, dropping columns it lacks.
            fh.seek(0)
            existing = next(csv.reader(fh), None)
            fh.seek(0, os.SEEK_END)
            if existing and existing != RESULT_COLUMNS:
                by_name = dict(zip(RESULT_COLUMNS, row))
                dropped = [c for c in RESULT_COLUMNS if c not in existing]
                if dropped:
                    import warnings

                    # Loud, not silent: projecting away e.g. the Detector
                    # column makes the aggregation layer pool rows that a
                    # fresh-schema CSV would keep apart.
                    warnings.warn(
                        f"results CSV {path!r} predates column(s) "
                        f"{dropped}; dropping "
                        f"{ {c: by_name.get(c, '-') for c in dropped} } "
                        "from this row — start a fresh CSV to keep them",
                        stacklevel=2,
                    )
                row = [by_name.get(col, "-") for col in existing]
        writer.writerow([_fmt(v) for v in row])
        # Durability before the lock releases: the grid treats a row in
        # this file as "trial done, never re-run it", so the row must
        # reach the platter before anyone can observe that promise.
        fh.flush()
        os.fsync(fh.fileno())


def read_results(path: str, *, allow_partial_tail: bool = False) -> list[dict]:
    """Read the results CSV as dict rows.

    ``allow_partial_tail=True`` tolerates exactly one **torn trailing
    row** — the crash/concurrent-append read path, mirroring
    ``telemetry.events.read_events``: a row is torn when the file does
    not end in a newline (the writer appends whole ``row + \\r\\n`` units)
    or the final row has fewer fields than the header; it is dropped,
    never a row before it. A short *interior* row is corruption and
    raises ``ValueError`` in both modes (the strict default also raises
    on a short trailing row). Overlong rows raise always — no tear can
    add fields.
    """
    with open(path, newline="") as fh:
        text = fh.read()
    rows = list(csv.reader(text.splitlines()))
    if not rows:
        return []
    header, body = rows[0], rows[1:]
    out = []
    for i, row in enumerate(body):
        last = i == len(body) - 1
        if not row and not last:
            continue  # interior blank line (csv.DictReader parity)
        if not row and text.endswith("\n"):
            continue  # trailing blank line after a complete final row
        torn = len(row) < len(header) or (last and not text.endswith("\n"))
        if len(row) > len(header) or (torn and not last):
            raise ValueError(
                f"{path}: corrupt interior row {i + 2} "
                f"({len(row)} fields, header has {len(header)})"
            )
        if torn:
            if allow_partial_tail:
                break  # the one torn trailing row; everything before stands
            raise ValueError(
                f"{path}: torn trailing row {i + 2} "
                f"({len(row)} fields, header has {len(header)}; pass "
                "allow_partial_tail=True to drop it)"
            )
        out.append(dict(zip(header, row)))
    return out


def _fmt(v):
    if isinstance(v, float):
        return repr(v)
    return v
