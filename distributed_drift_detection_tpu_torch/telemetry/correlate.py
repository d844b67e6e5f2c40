"""Cross-host trace correlation: merge one multi-host run's N per-process
event logs into a single normalized timeline, and say who straggled.

    python -m distributed_drift_detection_tpu_torch correlate <dir | run logs...>

In a ``jax.distributed`` run every process writes its **own** JSONL log
(``api.run`` opens one per process; the filename carries a ``procN``
segment and ``run_started`` carries the ``hostname`` / ``process_index``
/ ``process_count`` identity extras — ``parallel.multihost.
host_identity``). Each log is a correct single-host view; the fleet
questions — did every host run the same config, which host was slow,
where did the collective wait — need them merged.

Clock skew is absorbed by **alignment, not trust**: host wall-clocks on a
pod differ by arbitrary offsets, so absolute ``ts`` values are never
compared across logs. Every event is rebased to its own host's
``run_started`` timestamp (``t_rel = ts − t0``) — the one boundary every
process crosses at the same program point — and the merged timeline
orders on ``(t_rel, process_index, seq)``, which is deterministic for a
given set of logs regardless of argument order or filesystem iteration.
(Constant per-host offset cancels exactly; residual drift over a run is
bounded by the run's own length, which for the phase-spread diagnostics
below is the signal, not noise.)

Straggler diagnostics: per-host detect-phase spread (the embarrassingly
parallel loop should take the same time everywhere — a slow host here is
a real straggler, since the drift-vote all-reduce makes everyone wait for
it), and per-host throughput skew from the streaming progress events
(``chunk_completed`` / ``leg_completed`` pacing and ``heartbeat``
rows/elapsed). Pure stdlib + the schema module; no jax — runs wherever
the artifacts land.
"""

# The port's own copy of the JAX package's ``telemetry/correlate.py``; its CLI's
# ``--help`` prints the docstring above, so that is the JAX module's, but
# for the program name.

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from .events import read_events
from .registry import INDEX_NAME, config_digest

_TIMELINE_LIMIT = 40  # rendered merged-timeline rows (full list in the data)


class CorrelationError(ValueError):
    """The given logs cannot be correlated (no run_started, mixed configs
    with no common group, ...)."""


def _identity_of(started: dict, ordinal: int) -> dict:
    """Host identity from a run_started event (extras written by api.run;
    logs from older producers fall back to the load ordinal)."""
    return {
        "run_id": started["run_id"],
        "config": started.get("config") or {},
        "digest": config_digest(started.get("config") or {}),
        "hostname": started.get("hostname") or "?",
        "process_index": int(started.get("process_index", ordinal)),
        "process_count": int(started.get("process_count", 0)) or None,
        "t0": float(started["ts"]),
    }


def _identity(events: list[dict], ordinal: int) -> dict:
    started = next((e for e in events if e["type"] == "run_started"), None)
    if started is None:
        raise CorrelationError(
            "log has no run_started event — cannot align its clock"
        )
    return _identity_of(started, ordinal)


def _first_started(path: str) -> dict | None:
    """The log's run_started event read cheaply — first non-empty line
    only (the schema puts run_started first). ``None`` for empty,
    unparseable, or foreign files: grouping must skim a directory without
    paying a full parse per log (the chosen group is fully read and
    validated by :func:`correlate` afterwards)."""
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                if (
                    isinstance(event, dict)
                    and event.get("type") == "run_started"
                    and event.get("run_id")
                    and "ts" in event
                ):
                    return event
                return None
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None
    return None


def load_logs(paths: list[str]) -> list[tuple[dict, list[dict]]]:
    """Read + identify each log (torn-tail tolerant: a live or crashed
    sibling is still correlatable); returns ``[(identity, events), ...]``."""
    out = []
    for i, path in enumerate(sorted(paths)):
        events = read_events(path, allow_partial_tail=True)
        ident = _identity(events, ordinal=i)
        ident["path"] = path
        out.append((ident, events))
    return out


def group_run_logs(telemetry_dir: str) -> list[str]:
    """The newest multi-host run group in a telemetry directory: logs
    sharing one ``(config digest, process_count)``, newest group by its
    earliest ``run_started``. Single-process directories resolve to the
    newest single log (correlating one log is a valid degenerate case)."""
    paths = [
        p
        for p in glob.glob(os.path.join(telemetry_dir, "*.jsonl"))
        if os.path.basename(p) != INDEX_NAME
    ]
    if not paths:
        raise CorrelationError(f"no run logs in {telemetry_dir}")
    groups: dict[tuple, list[tuple[dict, str]]] = {}
    for path in paths:
        started = _first_started(path)
        if started is None:
            continue  # unreadable/empty/foreign log: not part of any group
        ident = _identity_of(started, ordinal=0)
        key = (ident["digest"], ident["process_count"])
        groups.setdefault(key, []).append((ident, path))
    if not groups:
        raise CorrelationError(f"no correlatable run logs in {telemetry_dir}")

    def group_recency(members):
        # Newest MEMBER, not earliest: a group accumulates every run of
        # one config, so its earliest t0 is pinned at that config's first
        # run ever — ranking on it would let any fresher config shadow a
        # re-run of an older one.
        return max(ident["t0"] for ident, _ in members)

    # Newest run wins; within the group keep the latest log per process
    # index (repeated runs of one config in one directory supersede).
    members = max(groups.values(), key=group_recency)
    by_proc: dict[int, tuple[dict, str]] = {}
    for ident, path in members:
        prev = by_proc.get(ident["process_index"])
        if prev is None or ident["t0"] > prev[0]["t0"]:
            by_proc[ident["process_index"]] = (ident, path)
    return [path for _, (_, path) in sorted(by_proc.items())]


def correlate(paths: list[str]) -> dict:
    """Merge per-process logs into the normalized fleet view.

    Returns ``{"hosts": [per-host summary ...], "timeline": [merged
    events ...], "stragglers": {...}}`` — the data model behind
    :func:`render_correlation`, reusable programmatically. Host order and
    the timeline are deterministic for a given set of logs (sorted on
    rebased time + process index + per-log sequence, never on load
    order)."""
    logs = load_logs(paths)
    if not logs:
        raise CorrelationError("no logs to correlate")
    digests = {ident["digest"] for ident, _ in logs}
    if len(digests) > 1:
        raise CorrelationError(
            f"logs carry {len(digests)} different config digests "
            f"({sorted(digests)}): not one run — pass one run's logs, or a "
            "directory (the newest coherent group is picked automatically)"
        )
    by_proc: dict[int, list[str]] = {}
    for ident, _ in logs:
        by_proc.setdefault(ident["process_index"], []).append(ident["run_id"])
    dupes = {k: v for k, v in by_proc.items() if len(v) > 1}
    if dupes:
        # Same config digest but a repeated process index = two runs of one
        # configuration, not one fleet — merging them would interleave
        # unrelated timelines and corrupt the straggler stats.
        raise CorrelationError(
            "multiple logs claim the same process index — these are "
            f"separate runs of one config, not one run: {dupes}; pass one "
            "run's logs, or a directory (the newest run is picked "
            "automatically)"
        )

    hosts = []
    timeline = []
    for ident, events in logs:
        h = {
            **{k: ident[k] for k in (
                "run_id", "hostname", "process_index", "process_count",
                "path", "t0",
            )},
            "phases": {},
            "rows": None,
            "seconds": None,
            "detections": 0,
            "last_t": 0.0,
            "last_type": None,
            "progress_rate": None,  # rows/s from the newest heartbeat
            "completed": False,
        }
        leg_rows, leg_t = 0, 0.0  # heartbeat-free fallback (older logs)
        first_hb = None  # (rows_done, elapsed_s): rates come from DELTAS
        for e in events:
            t_rel = float(e["ts"]) - ident["t0"]
            timeline.append(
                {"t": t_rel, "host": ident["process_index"], **e}
            )
            h["last_t"], h["last_type"] = t_rel, e["type"]
            if e["type"] == "phase_completed":
                h["phases"][e["phase"]] = (
                    h["phases"].get(e["phase"], 0.0) + e["seconds"]
                )
            elif e["type"] == "drift_detected":
                h["detections"] += 1
            elif e["type"] == "heartbeat":
                # Delta rate, same rule as watch.WatchState.rate(): a
                # checkpoint-resumed soak's rows_done is stream-absolute
                # while elapsed_s is this-process — the single-beat ratio
                # would overstate a resumed host by its resume offset and
                # invert the straggler diagnosis.
                rows, el = int(e["rows_done"]), float(e["elapsed_s"])
                if first_hb is None:
                    first_hb = (rows, el)
                r0, e0 = first_hb
                if el > e0 and rows > r0:
                    h["progress_rate"] = (rows - r0) / (el - e0)
                elif el > 0 and rows > 0:
                    h["progress_rate"] = rows / el
            elif e["type"] == "leg_completed":
                leg_rows += int(e["rows"])
                leg_t = t_rel
            elif e["type"] == "run_completed":
                h["rows"] = e["rows"]
                h["seconds"] = e["seconds"]
                h["detections"] = e["detections"]
                h["completed"] = True
        if h["rows"] is not None and h["seconds"]:
            h["progress_rate"] = h["rows"] / h["seconds"]
        elif h["progress_rate"] is None and leg_rows and leg_t > 0:
            # pre-heartbeat soak logs: pace the legs by their own rebased
            # completion times (coarser than heartbeats, same skew story)
            h["progress_rate"] = leg_rows / leg_t
        hosts.append(h)
    hosts.sort(key=lambda h: h["process_index"])
    timeline.sort(key=lambda e: (e["t"], e["host"], e["seq"]))

    return {
        "digest": next(iter(digests)),
        "config": logs[0][0]["config"],
        "hosts": hosts,
        "timeline": timeline,
        "stragglers": straggler_stats(hosts),
    }


def straggler_stats(hosts: list[dict]) -> dict:
    """Fleet-health numbers over the per-host summaries.

    ``detect``: per-host detect-phase seconds, spread (max−min) and the
    slowest host — the partitions never talk during the loop, so a wide
    spread is pure straggle the end-of-run all-reduce serializes on.
    ``throughput``: per-host rows/s (run totals, else the newest
    heartbeat) and the max/min skew factor.
    """
    out: dict = {"detect": None, "throughput": None}
    detect = {
        h["process_index"]: h["phases"]["detect"]
        for h in hosts
        if "detect" in h["phases"]
    }
    if len(detect) >= 1:
        slowest = max(detect, key=lambda k: detect[k])
        fastest = min(detect, key=lambda k: detect[k])
        out["detect"] = {
            "per_host": detect,
            "slowest": slowest,
            "fastest": fastest,
            "spread_s": detect[slowest] - detect[fastest],
            "ratio": (
                detect[slowest] / detect[fastest]
                if detect[fastest] > 0
                else None
            ),
        }
    rates = {
        h["process_index"]: h["progress_rate"]
        for h in hosts
        if h["progress_rate"]
    }
    if rates:
        slowest = min(rates, key=lambda k: rates[k])
        out["throughput"] = {
            "per_host": rates,
            "slowest": slowest,
            "skew": (
                max(rates.values()) / rates[slowest]
                if rates[slowest] > 0
                else None
            ),
        }
    return out


def render_correlation(corr: dict, timeline_limit: int = _TIMELINE_LIMIT) -> str:
    hosts = corr["hosts"]
    want = hosts[0]["process_count"]
    out = [
        f"correlated {len(hosts)} process log(s)"
        f"  (config {corr['digest']}"
        + (f", process_count={want}" if want else "")
        + ")"
    ]
    if want and want != len(hosts):
        out.append(
            f"warning    {len(hosts)}/{want} process logs present — "
            "missing hosts never wrote (or their logs were not passed)"
        )
    out.append(
        f"{'host':<24} {'detect_s':>9} {'rows/s':>12} {'detections':>10}"
        f"  last event"
    )
    for h in hosts:
        rate = f"{h['progress_rate']:,.0f}" if h["progress_rate"] else "-"
        det_s = (
            f"{h['phases']['detect']:.4f}" if "detect" in h["phases"] else "-"
        )
        last = (
            f"{h['last_type']} @ +{h['last_t']:.3f}s"
            if h["last_type"]
            else "-"
        )
        if not h["completed"]:
            last += "  (incomplete)"
        out.append(
            f"proc{h['process_index']} {h['hostname']:<18.18} {det_s:>9} "
            f"{rate:>12} {h['detections']:>10}  {last}"
        )
    st = corr["stragglers"]
    if st["detect"] and len(st["detect"]["per_host"]) > 1:
        d = st["detect"]
        pct = f"  ({(d['ratio'] - 1) * 100:+.0f}%)" if d["ratio"] else ""
        out.append(
            f"detect spread  {d['spread_s']:.4f} s — slowest "
            f"proc{d['slowest']}, fastest proc{d['fastest']}{pct}"
        )
    if st["throughput"] and len(st["throughput"]["per_host"]) > 1:
        t = st["throughput"]
        skew = f"{t['skew']:.2f}x" if t["skew"] else "?"
        out.append(
            f"throughput skew {skew} — slowest proc{t['slowest']}"
        )
    out.append(
        "merged timeline (t relative to each host's run_started — clock "
        "skew rebased)"
    )
    shown = corr["timeline"][:timeline_limit]
    for e in shown:
        detail = {
            "phase_completed": lambda e: f"{e['phase']} {e['seconds']:.4f}s",
            "chunk_completed": lambda e: (
                f"chunk {e['chunk']} ({e['batches_done']} batches, "
                f"{e['detections']} det)"
            ),
            "leg_completed": lambda e: (
                f"leg {e['leg']} ({e['rows']:,} rows, {e['detections']} det)"
            ),
            "heartbeat": lambda e: (
                f"{e['rows_done']:,} rows in {e['elapsed_s']:.2f}s"
            ),
            "drift_detected": lambda e: (
                f"partition {e['partition']} @ {e['global_pos']}"
            ),
            "run_completed": lambda e: (
                f"{e['rows']:,} rows / {e['seconds']:.4f}s"
            ),
        }.get(e["type"], lambda e: "")(e)
        out.append(
            f"  +{e['t']:9.4f}s  proc{e['host']}  {e['type']:<16} {detail}"
        )
    hidden = len(corr["timeline"]) - len(shown)
    if hidden > 0:
        out.append(f"  ... {hidden} more events")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch correlate",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "paths",
        nargs="+",
        help="one telemetry directory (newest coherent multi-host group is "
        "picked) or the run-log *.jsonl files of one run",
    )
    ap.add_argument(
        "--timeline",
        type=int,
        default=_TIMELINE_LIMIT,
        help=f"merged-timeline rows to render (default {_TIMELINE_LIMIT})",
    )
    args = ap.parse_args(argv)
    paths = args.paths
    if len(paths) == 1 and os.path.isdir(paths[0]):
        paths = group_run_logs(paths[0])
    try:
        corr = correlate(paths)
    except CorrelationError as e:
        raise SystemExit(f"correlate: {e}") from None
    print(render_correlation(corr, timeline_limit=args.timeline))


if __name__ == "__main__":
    main(sys.argv[1:])
