"""Run registry: an append-only ``index.jsonl`` per telemetry directory —
the port's own copy of the JAX package's ``telemetry/registry.py``. Both
packages write and read the same index, so a sweep started by one can be
healed or scheduled by the other (the digests are equal: ``config.py`` is a
verbatim copy).

The event logs answer "what did run X do"; the registry answers the fleet
question that comes first — **which runs exist here, what configuration
was each, and did it finish**. One telemetry directory (a grid sweep, a
pod launch, a soak farm) accumulates one ``index.jsonl``: every record is
a status transition ``{ts, run_id, status, ...}`` appended by the
producer (``api.run`` around each telemetered run; ``harness.grid``
around a sweep), so the index is a timeline of the directory's activity
and the *latest* record per ``run_id`` is its current state:

* ``running`` — carries the run's ``config_digest`` (stable SHA-256 of
  the canonical config JSON: two runs with the same digest are the same
  cell, the grid-comparison key), the log's filename, and any host
  identity extras the producer adds.
* ``completed`` / ``failed`` — terminal; ``failed`` is written by
  ``api.run``'s exception path, so a crashed run is *recorded* as
  crashed, not just absent (its partial event log is the evidence; the
  registry is the pointer to it).

Append-only JSONL, flushed per record, same crash posture as the event
sink — and the same torn-tail tolerance on read (a record lost mid-write
costs one status transition, never the index). Pure stdlib, no torch: the
readers (``watch``, ``report``, ``correlate``, ``collector``), the
scheduler and ``heal``'s plan mode read it wherever the artifacts land.
"""

from __future__ import annotations

import contextlib
import contextvars
import glob
import hashlib
import json
import os
import time

INDEX_NAME = "index.jsonl"

# Row-record sidecar suffixes that live next to a run log but are not run
# logs: quarantine sidecars (io.sanitize), the serving daemon's verdict /
# heartbeat sidecars (serve.runner), and placement journals (serve.router's
# ``router.journal.jsonl``, the scheduler's ``sched.journal.jsonl``).
# ``newest_run_log`` must never resolve one — on a *live* serving directory
# the verdict sidecar is usually the most recently appended ``*.jsonl``, and
# resolving it would hand ``report --dir`` / ``watch <dir>`` a file that
# fails event-schema validation.
SIDECAR_SUFFIXES = (
    "quarantine.jsonl",
    "verdicts.jsonl",
    "heartbeat.jsonl",
    "flightrec.jsonl",
    "journal.jsonl",
)

# The only statuses the fold recognizes; producers writing anything else
# fail loudly at append time, not at read time on another machine.
STATUSES = ("running", "completed", "failed")


def config_digest(config: dict) -> str:
    """Stable short digest of a run configuration: canonical (sorted-key)
    JSON, SHA-256, first 12 hex chars. Same config → same digest across
    processes and sessions, so a multi-host run's N per-process records
    (and a sweep's repeated trials of one cell) correlate by digest."""
    canon = json.dumps(config, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()[:12]


def index_path(telemetry_dir: str) -> str:
    return os.path.join(telemetry_dir, INDEX_NAME)


# Supervision context (resilience.supervisor): while an attempt scope is
# active, every record the producer writes carries an ``attempt`` field —
# so a supervised run's index timeline reads failed(attempt=1) →
# completed(attempt=2), not as two unexplained runs. A contextvar, not a
# parameter, because the producer (api.run) is policy-agnostic: it must
# not need to know whether something above it is retrying.
_ATTEMPT: contextvars.ContextVar["int | None"] = contextvars.ContextVar(
    "registry_attempt", default=None
)


@contextlib.contextmanager
def attempt_scope(attempt: "int | None"):
    """Bracket one supervised attempt: records written inside carry
    ``attempt`` (1-based) unless they set their own."""
    token = _ATTEMPT.set(None if attempt is None else int(attempt))
    try:
        yield
    finally:
        _ATTEMPT.reset(token)


def current_attempt() -> "int | None":
    return _ATTEMPT.get()


def _open_locked_append(path: str):
    """Open ``path`` for append with an exclusive ``flock``, re-opening
    if a compaction replaced the inode between open and lock (the
    standard flock-with-rename dance: without the re-stat, a writer that
    opened the pre-compaction file would append its record to an
    unlinked inode and silently lose it). Non-POSIX / no-flock
    filesystems degrade to the plain append the registry always did."""
    while True:
        fh = open(path, "a")
        try:
            import fcntl

            fcntl.flock(fh, fcntl.LOCK_EX)
        except (ImportError, OSError):
            return fh  # best-effort append (pre-compaction behaviour)
        try:
            if os.fstat(fh.fileno()).st_ino == os.stat(path).st_ino:
                return fh
        except OSError:
            pass  # replaced and momentarily absent: reopen
        fh.close()


def record(telemetry_dir: str, run_id: str, status: str, **extras) -> dict:
    """Append one status record; returns it. Creates the directory and
    index on first use. ``extras`` ride along verbatim (``config_digest``,
    ``log``, host identity, sweep totals, ...). Inside an
    :func:`attempt_scope` the record additionally carries ``attempt``."""
    if status not in STATUSES:
        raise ValueError(
            f"unknown registry status {status!r}; expected one of {STATUSES}"
        )
    attempt = _ATTEMPT.get()
    if attempt is not None:
        extras.setdefault("attempt", attempt)
    rec = {"ts": time.time(), "run_id": str(run_id), "status": status, **extras}
    os.makedirs(telemetry_dir, exist_ok=True)
    fh = _open_locked_append(index_path(telemetry_dir))
    with fh:
        fh.write(json.dumps(rec) + "\n")
        fh.flush()
        # fsync like the results CSV: the registry is what `heal` diffs a
        # sweep spec against, so a `completed` that evaporates in a power
        # loss would make heal re-run (duplicate) a recorded trial.
        os.fsync(fh.fileno())
    return rec


def read_index(telemetry_dir: str) -> list[dict]:
    """All records in append order; ``[]`` when no index exists yet.
    Torn-tail tolerant (a writer may be mid-append right now); an interior
    malformed line is corruption and raises."""
    path = index_path(telemetry_dir)
    if not os.path.exists(path):
        return []
    records = []
    with open(path) as fh:
        lines = fh.readlines()
    for lineno, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            if lineno == len(lines):
                break  # torn trailing record: one transition lost, not the index
            raise ValueError(f"{path}:{lineno}: corrupt registry record")
        if isinstance(rec, dict) and rec.get("run_id"):
            records.append(rec)
    return records


def runs(telemetry_dir: str) -> dict[str, dict]:
    """Fold the index into current state: ``run_id`` → latest record, with
    ``started_ts`` preserved from the run's first record (the fold's one
    derived field — 'newest run' means newest *start*, not newest status
    flip: a week-old run failing now must not outrank today's)."""
    out: dict[str, dict] = {}
    for rec in read_index(telemetry_dir):
        prev = out.get(rec["run_id"])
        folded = dict(rec)
        folded["started_ts"] = (
            prev["started_ts"] if prev is not None else rec["ts"]
        )
        if prev is not None:  # status records may omit the start's extras
            folded = {**prev, **folded}
        out[rec["run_id"]] = folded
    return out


def newest_run_log(telemetry_dir: str) -> str | None:
    """Resolve the directory's newest run log — the shared resolution
    behind ``report --dir`` and ``watch <dir>``.

    Registered runs are ranked by *start* time (the registry knows start
    order exactly; a status flip on an old run must not outrank a newer
    start). Logs the registry never heard of — producers driving
    ``EventLog.open_run`` directly (streaming examples, the multihost
    worker), or pre-registry artifacts — compete by mtime: a directory
    mixing both must resolve to whichever run is actually newest, not to
    whatever happens to be indexed. The index itself is never a
    candidate."""
    registered: set[str] = set()
    best_reg: "tuple[float, str] | None" = None  # (recency, path)
    for rec in runs(telemetry_dir).values():
        log = rec.get("log")
        if not log:
            continue
        registered.add(log)
        path = os.path.join(telemetry_dir, log)
        if not os.path.exists(path):
            continue
        # Recency = the later of start and last write: a long-lived run
        # still appending must not lose to anything that merely happened
        # after it *started*.
        recency = max(rec["started_ts"], os.path.getmtime(path))
        if best_reg is None or recency > best_reg[0]:
            best_reg = (recency, path)
    unregistered = [
        p
        for p in glob.glob(os.path.join(telemetry_dir, "*.jsonl"))
        if os.path.basename(p) != INDEX_NAME
        and os.path.basename(p) not in registered
        # sidecars (quarantine rows, serve verdicts/heartbeats) live next
        # to their run log but are row records, not event logs — never
        # "the newest run", even while being actively appended to
        and not os.path.basename(p).endswith(SIDECAR_SUFFIXES)
    ]
    best_unreg: "tuple[float, str] | None" = None
    if unregistered:
        path = max(unregistered, key=os.path.getmtime)
        best_unreg = (os.path.getmtime(path), path)
    if best_reg is not None and best_unreg is not None:
        # Both recencies are wall-clock stamps from the same host — the
        # more recently alive run wins, registered or not.
        return max(best_reg, best_unreg)[1]
    for best in (best_reg, best_unreg):
        if best is not None:
            return best[1]
    return None


# --- compaction --------------------------------------------------------------
#
# A long-lived producer (the sched/ scheduler appends a record per lease
# attempt; a serving farm appends per run) grows index.jsonl without bound,
# and every fold (`runs()`, heal's digest diff, `newest_run_log`) re-reads
# the whole timeline. Compaction rewrites the index as ONE record per
# run_id — its current folded state, stamped with its *start* time — which
# preserves every semantic the consumers rely on:
#
# * `runs()` folds the compacted index to the same current-state map
#   (extras were already merged by the fold that produced the snapshot);
# * `newest_run_log` ranks registered runs by start (ts == started_ts);
# * heal / sched audit digest-matching sees the same `completed` multiset.
#
# What it deliberately drops is the *history* (failed→completed attempt
# timelines collapse to the final state, with the latest record's fields);
# the per-run event logs remain the evidence trail.


def compact_index(telemetry_dir: str) -> "dict | None":
    """Atomically compact ``index.jsonl`` to one record per run; returns
    ``{records_before, records_after}`` (``None`` when there is nothing
    to compact).

    Crash-safe by construction: the snapshot is written to a temp file,
    fsynced, and ``os.replace``d over the index — a compaction torn at
    any point leaves either the intact old index (+ a stray ``*.tmp``
    the next compaction overwrites) or the complete new one, never a
    half-written index. Concurrent appenders are excluded by the same
    ``flock`` :func:`record` takes (and re-check the inode after locking,
    so no record can land on the unlinked pre-compaction file)."""
    path = index_path(telemetry_dir)
    if not os.path.exists(path):
        return None
    with open(path, "a") as lock_fh:
        try:
            import fcntl

            fcntl.flock(lock_fh, fcntl.LOCK_EX)
        except (ImportError, OSError):
            pass  # best-effort exclusion (same posture as record())
        before = read_index(telemetry_dir)
        if not before:
            return None
        folded = sorted(
            runs(telemetry_dir).values(), key=lambda r: r["started_ts"]
        )
        tmp = f"{path}.compact-{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            for rec in folded:
                rec = dict(rec)
                # ts = start: the fold re-derives started_ts from the
                # first (now only) record, keeping newest_run_log's
                # newest-*start* ranking exact across compaction.
                rec["ts"] = rec.pop("started_ts")
                fh.write(json.dumps(rec) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    return {"records_before": len(before), "records_after": len(folded)}


# Amortization state for maybe_compact: index path → record count right
# after its last compaction in this process (the floor the index cannot
# shrink below — one folded record per run). Without it, a directory
# whose *distinct-run* count exceeds the threshold would trigger a full
# O(n) rewrite on every subsequent append, quadratic in sweep size.
_COMPACT_FLOOR: "dict[str, int]" = {}


def maybe_compact(telemetry_dir: str, *, max_records: int) -> "dict | None":
    """Compact when the index holds more than ``max_records`` records —
    the auto-compaction hook a long-lived scheduler calls as completions
    land. Cheap when under threshold (one line count, no JSON parse),
    and amortized O(1) per append past it: once a compaction has run,
    the next one waits until the index doubles past that compaction's
    floor (compaction cannot shrink below one record per run, so
    re-compacting sooner would be a full rewrite for nothing)."""
    if max_records <= 0:
        return None
    path = index_path(telemetry_dir)
    try:
        with open(path, "rb") as fh:
            lines = sum(1 for _ in fh)
    except OSError:
        return None
    key = os.path.realpath(path)
    if lines <= max(max_records, 2 * _COMPACT_FLOOR.get(key, 0)):
        return None
    out = compact_index(telemetry_dir)
    if out is not None:
        _COMPACT_FLOOR[key] = out["records_after"]
    return out


def main(argv=None) -> None:
    """``registry`` subcommand: index maintenance without torch.

        python -m distributed_drift_detection_tpu_torch registry compact DIR \\
            [--min-records N]

    ``compact`` rewrites DIR's ``index.jsonl`` as one record per run
    (see :func:`compact_index`); with ``--min-records`` it is a no-op
    below the threshold (the cron-safe form). Exit 0 either way; the
    summary goes to stdout."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch registry",
        description=main.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("action", choices=["compact"])
    ap.add_argument("dir", help="telemetry directory (holds index.jsonl)")
    ap.add_argument(
        "--min-records", type=int, default=0, metavar="N",
        help="only compact past N records (default: always)",
    )
    args = ap.parse_args(argv)
    if args.min_records > 0:
        out = maybe_compact(args.dir, max_records=args.min_records)
    else:
        out = compact_index(args.dir)
    if out is None:
        print("registry: nothing to compact")
    else:
        print(
            f"registry: compacted {out['records_before']} → "
            f"{out['records_after']} records"
        )


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
