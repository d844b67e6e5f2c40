"""Merged run timelines as Chrome-trace/Perfetto artifacts.

    python -m distributed_drift_detection_tpu_torch timeline <dir | logs...> \\
        -o run.trace.json

Takes one or many schema-v1 run logs — a single batch run, a serving
daemon plus its load generator, or a multi-host fleet's per-process
logs — and merges them into ONE ``.trace.json`` in the Chrome trace
event format, loadable in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``. ``span`` events render as duration slices (the
causal per-row serving chains from ``telemetry.tracing``, grouped per
trace); ``phase_completed`` renders as phase slices; progress events
(``chunk_completed``, ``heartbeat``, ``leg_completed``) and findings
(``drift_detected``, ``retrain``, ``alert``, ``rows_quarantined``,
``drift_forensics``) render as instants, so the whole run reads on one
scrollable timeline.

Clock alignment reuses ``correlate``'s rule: logs that belong to ONE
multi-process run (same config digest) are each rebased to their own
``run_started`` timestamp — host wall-clocks on a pod differ by
arbitrary offsets, and ``run_started`` is the one boundary every
process crosses at the same program point, so a constant per-host skew
cancels exactly. Logs from *different* programs on one machine (a
daemon and its loadgen have different configs) are placed on the shared
wall clock instead — their relative offset is the signal, not skew.
Each log becomes one Chrome-trace ``pid`` (named after its run id /
process index); within a log, spans are laid out on per-trace ``tid``
rows and non-span events on a dedicated events row.

Pure stdlib + the schema/correlate modules; no jax — runs wherever the
artifacts land.
"""

# The port's own copy of the JAX package's ``telemetry/timeline.py``; its CLI's
# ``--help`` prints the docstring above, so that is the JAX module's, but
# for the program name, and the trace keeps that module's ``producer``
# string, so its bytes are that module's too.

from __future__ import annotations

import argparse
import json
import os
import sys

from .correlate import load_logs
from .registry import INDEX_NAME, SIDECAR_SUFFIXES

TRACE_SUFFIX = ".trace.json"

# tid layout inside one pid: 0 = phases, 1 = instants, 2+ = one row per
# span trace (assigned in first-seen order).
_TID_PHASES = 0
_TID_EVENTS = 1
_TID_TRACES = 2

# Non-span event types rendered as instants, with a short detail lambda.
_INSTANT_DETAIL = {
    "chunk_completed": lambda e: {
        "chunk": e["chunk"],
        "batches_done": e["batches_done"],
        "detections": e["detections"],
    },
    "leg_completed": lambda e: {
        "leg": e["leg"], "rows": e["rows"], "detections": e["detections"]
    },
    "heartbeat": lambda e: {
        "rows_done": e["rows_done"], "elapsed_s": e["elapsed_s"]
    },
    "drift_detected": lambda e: {
        "partition": e["partition"], "global_pos": e["global_pos"]
    },
    "retrain": lambda e: {
        "partition": e["partition"], "batch": e["batch"],
        "forced": e["forced"],
    },
    "alert": lambda e: {
        "rule": e["rule"], "state": e["state"], "value": e["value"],
        "threshold": e["threshold"],
    },
    "rows_quarantined": lambda e: {"rows": e["rows"], "policy": e["policy"]},
    "drift_forensics": lambda e: {
        "partition": e["partition"], "global_pos": e["global_pos"],
        "bundle": e["bundle"],
    },
    "run_retried": lambda e: {
        "attempt": e["attempt"], "reason": e["reason"]
    },
    "compile_completed": lambda e: {
        "cached": e["cached"], "seconds": e["seconds"]
    },
}


class TimelineError(ValueError):
    """The given logs cannot be merged into one timeline."""


def _log_offsets(logs) -> "dict[str, float]":
    """Per-log rebase offset: ``timeline_seconds = ts - offset(log)``.

    The skew rebase applies ONLY to a genuine multi-process run:
    logs sharing ``(config digest, process_count)`` with a declared
    ``process_count > 1`` and pairwise-distinct process indices — one
    process per host, correlate's grouping rule. Those members each
    rebase to their own ``t0`` (host wall-clocks on a pod differ by
    arbitrary offsets; ``run_started`` is the shared program point, so
    constant per-host skew cancels) and the group sits at its earliest
    ``t0`` on the global clock. Everything else — distinct programs
    (daemon vs loadgen), and *repeated runs of one config* (two
    identical replays share a digest but are NOT one run; overlaying
    them at a common origin would fake simultaneity) — sits directly on
    the shared wall clock, preserving real relative placement. Keys are
    log paths.
    """
    if not logs:
        raise TimelineError("no logs to merge")
    base = min(ident["t0"] for ident, _ in logs)
    groups: dict[tuple, list] = {}
    for ident, _ in logs:
        groups.setdefault(
            (ident["digest"], ident["process_count"]), []
        ).append(ident)
    offsets: dict[str, float] = {}
    for (_, process_count), members in groups.items():
        procs = [m["process_index"] for m in members]
        fleet = (
            len(members) > 1
            and (process_count or 0) > 1
            and len(set(procs)) == len(procs)
        )
        if not fleet:
            for m in members:
                offsets[m["path"]] = base
            continue
        group_t0 = min(m["t0"] for m in members)
        for m in members:
            # rebase to the member's own t0 (skew cancels), then shift
            # the whole group to where it started on the global clock
            offsets[m["path"]] = m["t0"] - (group_t0 - base)
    return offsets


def build_timeline(paths: "list[str]") -> dict:
    """Merge run logs into one Chrome-trace JSON object (the data model
    behind the CLI; reusable programmatically)."""
    logs = load_logs(paths)
    offsets = _log_offsets(logs)
    events: list[dict] = []
    for pid, (ident, log_events) in enumerate(logs):
        off = offsets[ident["path"]]
        label = f"proc{ident['process_index']} {ident['run_id']}"
        events.append(
            {
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": label},
            }
        )
        for tid, tname in ((_TID_PHASES, "phases"), (_TID_EVENTS, "events")):
            events.append(
                {
                    "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": tname},
                }
            )
        trace_tids: dict[str, int] = {}
        for e in log_events:
            t_us = (float(e["ts"]) - off) * 1e6
            etype = e["type"]
            if etype == "span":
                tid = trace_tids.get(e["trace_id"])
                if tid is None:
                    tid = _TID_TRACES + len(trace_tids)
                    trace_tids[e["trace_id"]] = tid
                    events.append(
                        {
                            "ph": "M", "name": "thread_name",
                            "pid": pid, "tid": tid,
                            "args": {"name": f"trace {e['trace_id'][:8]}"},
                        }
                    )
                args = {
                    k: v
                    for k, v in e.items()
                    if k not in ("v", "type", "ts", "seq", "name", "start_ts",
                                 "dur_s")
                }
                events.append(
                    {
                        "name": e["name"],
                        "ph": "X",
                        "ts": (float(e["start_ts"]) - off) * 1e6,
                        "dur": max(float(e["dur_s"]), 0.0) * 1e6,
                        "pid": pid,
                        "tid": tid,
                        "args": args,
                    }
                )
            elif etype == "phase_completed":
                # emitted at phase END; the slice starts dur earlier
                dur = max(float(e["seconds"]), 0.0)
                events.append(
                    {
                        "name": e["phase"],
                        "ph": "X",
                        "ts": t_us - dur * 1e6,
                        "dur": dur * 1e6,
                        "pid": pid,
                        "tid": _TID_PHASES,
                        "args": {},
                    }
                )
            elif etype in ("run_started", "run_completed"):
                events.append(
                    {
                        "name": etype, "ph": "i", "ts": t_us, "pid": pid,
                        "tid": _TID_EVENTS, "s": "p",
                        "args": (
                            {"rows": e["rows"], "seconds": e["seconds"]}
                            if etype == "run_completed"
                            else {"run_id": e["run_id"]}
                        ),
                    }
                )
            else:
                detail = _INSTANT_DETAIL.get(etype)
                if detail is None:
                    continue  # cost/memory snapshots etc: not timeline-shaped
                events.append(
                    {
                        "name": etype, "ph": "i", "ts": t_us, "pid": pid,
                        "tid": _TID_EVENTS, "s": "t", "args": detail(e),
                    }
                )
    events.sort(key=lambda ev: (ev.get("ts", -1), ev["pid"], ev["tid"]))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "distributed_drift_detection_tpu timeline",
            "logs": [ident["path"] for ident, _ in logs],
        },
    }


def validate_chrome_trace(obj: dict) -> int:
    """Structural check of a Chrome-trace JSON object (the CI smoke
    gate's contract — a trace that validates is a trace Perfetto/
    ``chrome://tracing`` loads). Returns the renderable event count;
    raises :class:`TimelineError` on any violation."""
    if not isinstance(obj, dict) or not isinstance(
        obj.get("traceEvents"), list
    ):
        raise TimelineError("not a Chrome-trace object (no traceEvents list)")
    n = 0
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict):
            raise TimelineError(f"traceEvents[{i}] is not an object")
        ph = ev.get("ph")
        if not ev.get("name") or ph not in ("X", "B", "E", "i", "I", "M", "C"):
            raise TimelineError(
                f"traceEvents[{i}]: bad name/ph {ev.get('name')!r}/{ph!r}"
            )
        if not isinstance(ev.get("pid"), int) or not isinstance(
            ev.get("tid"), int
        ):
            raise TimelineError(f"traceEvents[{i}]: pid/tid must be ints")
        if ph == "M":
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            raise TimelineError(f"traceEvents[{i}]: missing numeric ts")
        if ph == "X" and (
            not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0
        ):
            raise TimelineError(f"traceEvents[{i}]: X event needs dur >= 0")
        n += 1
    return n


def _resolve_paths(paths: "list[str]") -> "list[str]":
    """A directory resolves to EVERY run log in it (the timeline merges
    heterogeneous logs — daemon + loadgen — unlike correlate's one-run
    grouping); explicit files pass through."""
    if len(paths) == 1 and os.path.isdir(paths[0]):
        import glob

        found = sorted(
            p
            for p in glob.glob(os.path.join(paths[0], "*.jsonl"))
            if os.path.basename(p) != INDEX_NAME
            # the registry's one sidecar-suffix list: a new sidecar type
            # added there is excluded here automatically
            and not os.path.basename(p).endswith(SIDECAR_SUFFIXES)
        )
        if not found:
            raise TimelineError(f"no run logs in {paths[0]}")
        return found
    return paths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch timeline",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "paths",
        nargs="+",
        help="one telemetry directory (every run log in it merges) or "
        "run-log *.jsonl files",
    )
    ap.add_argument(
        "-o",
        "--out",
        default=None,
        help=f"output path (default: <first log stem>{TRACE_SUFFIX}; "
        "'-' writes to stdout)",
    )
    args = ap.parse_args(argv)
    try:
        paths = _resolve_paths(args.paths)
        trace = build_timeline(paths)
        n = validate_chrome_trace(trace)
    except (TimelineError, OSError) as e:
        raise SystemExit(f"timeline: {e}") from None
    out = args.out
    if out == "-":
        json.dump(trace, sys.stdout)
        sys.stdout.write("\n")
        return
    if out is None:
        out = os.path.splitext(paths[0])[0] + TRACE_SUFFIX
    with open(out, "w") as fh:
        json.dump(trace, fh)
        fh.write("\n")
    spans = sum(
        1 for ev in trace["traceEvents"] if ev["ph"] == "X"
    )
    print(
        f"timeline: {len(trace['otherData']['logs'])} log(s) -> {out} "
        f"({n} events, {spans} slices)"
    )


if __name__ == "__main__":
    main(sys.argv[1:])
