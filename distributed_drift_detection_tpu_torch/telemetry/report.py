"""Run-log report: render a persisted JSONL event log as a summary.

    python -m distributed_drift_detection_tpu_torch report <run.jsonl>
    python -m distributed_drift_detection_tpu_torch report --dir <telemetry-dir>

Answers the post-hoc questions the reference needs a re-run for: where the
time went (phase breakdown), how fast it ran (throughput), what the
compiler said the detect program costs and how close the run came to it
(cost/memory section: flops, bytes, peak temp allocation, achieved
GFLOP/s — from the ``cost_analysis``/``memory_snapshot`` events), when and
where drift fired (ascii timeline over the stream + per-partition counts),
and — for streaming/soak logs — per-chunk/per-leg progress. ``--dir``
renders a telemetry directory's newest run (the registry-first resolution
shared with the ``watch`` CLI — ``telemetry.registry.newest_run_log``),
so "how did the latest run do" needs no filename archaeology. Pure
stdlib + the schema module; no jax, so it runs anywhere the artifact
lands.
"""

# The port's own copy of the JAX package's ``telemetry/report.py``; its CLI's
# ``--help`` prints the docstring above, so that is the JAX module's, but
# for the program name.

from __future__ import annotations

import argparse
import os
import sys

from .events import read_events
from .registry import newest_run_log

_TIMELINE_BINS = 50
_TIMELINE_GLYPHS = " .:-=+*#%@"


def summarize(events: list[dict]) -> dict:
    """Fold a validated event list into one summary dict (the report's data
    model; rendered by :func:`render_report`, reusable programmatically)."""
    s: dict = {
        "run_id": None,
        "config": {},
        "phases": {},
        "compile": None,
        "drifts": [],
        "retrains": 0,
        "forced_retrains": 0,
        "chunks": [],
        "legs": [],
        "retried": [],
        "alerts": [],
        "spans": 0,
        "trace_ids": set(),
        "forensics": [],
        "quarantine": None,
        "heartbeat": None,
        "completed": None,
        "cost": None,
        "mem_analysis": None,
        "device_mem": {},
    }
    for e in events:
        t = e["type"]
        if t == "run_started":
            s["run_id"] = e["run_id"]
            s["config"] = e.get("config") or {}
        elif t == "phase_completed":
            s["phases"][e["phase"]] = (
                s["phases"].get(e["phase"], 0.0) + e["seconds"]
            )
        elif t == "compile_completed":
            s["compile"] = e
        elif t == "drift_detected":
            s["drifts"].append(e)
        elif t == "retrain":
            s["retrains"] += 1
            s["forced_retrains"] += bool(e["forced"])
        elif t == "chunk_completed":
            s["chunks"].append(e)
        elif t == "leg_completed":
            s["legs"].append(e)
        elif t == "run_retried":
            s["retried"].append(e)
        elif t == "alert":
            s["alerts"].append(e)
        elif t == "span":
            s["spans"] += 1
            s["trace_ids"].add(e["trace_id"])
        elif t == "drift_forensics":
            s["forensics"].append(e)
        elif t == "rows_quarantined":
            s["quarantine"] = e
        elif t == "heartbeat":
            s["heartbeat"] = e  # newest wins: the run's latest known pulse
        elif t == "cost_analysis":
            s["cost"] = e
        elif t == "memory_snapshot":
            if e["source"] == "memory_analysis":
                s["mem_analysis"] = e["stats"]
            else:  # device snapshots, keyed by their `when` label
                s["device_mem"][e.get("when") or f"snap{len(s['device_mem'])}"] = (
                    e["stats"]
                )
        elif t == "run_completed":
            s["completed"] = e
    return s


def _fmt_bytes(n: float) -> str:
    """Human bytes with binary units (exact ints below 1 KiB)."""
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.0f} {unit}" if unit == "B" else f"{n:.1f} {unit}"
        n /= 1024
    return f"{n:.1f} TiB"  # unreachable; keeps type-checkers calm


def _timeline(positions: list[int], rows: int, bins: int = _TIMELINE_BINS) -> str:
    """Ascii density sparkline of drift positions over the stream."""
    counts = [0] * bins
    span = max(rows, max(positions) + 1)
    for pos in positions:
        counts[min(pos * bins // span, bins - 1)] += 1
    peak = max(counts)
    if peak == 0:
        return "|" + " " * bins + "|"
    levels = len(_TIMELINE_GLYPHS) - 1
    body = "".join(
        _TIMELINE_GLYPHS[(c * levels + peak - 1) // peak] if c else " "
        for c in counts
    )
    return f"|{body}|  (peak {peak}/bin)"


def render_report(events: list[dict]) -> str:
    s = summarize(events)
    cfg = s["config"]
    out = []
    out.append(f"run        {s['run_id'] or '<no run_started event>'}")
    if cfg:
        out.append(
            f"config     dataset={cfg.get('dataset')}  model={cfg.get('model')}"
            f"  detector={cfg.get('detector')}"
        )
        out.append(
            f"           partitions={cfg.get('partitions')}"
            f"  per_batch={cfg.get('per_batch')}"
            f"  mult_data={cfg.get('mult_data')}  seed={cfg.get('seed')}"
        )

    done = s["completed"]
    rows = int(done["rows"]) if done else 0
    if s["phases"]:
        total = sum(s["phases"].values())
        out.append("phases")
        for name, secs in sorted(
            s["phases"].items(), key=lambda kv: -kv[1]
        ):
            pct = 100.0 * secs / total if total > 0 else 0.0
            out.append(f"  {name:<12} {secs:9.4f} s  {pct:5.1f}%")
    if s["compile"] is not None:
        c = s["compile"]
        out.append(
            f"compile    build {c['seconds']:.4f} s"
            f"  (runner cache {'hit' if c['cached'] else 'miss'})"
        )
    if done:
        rps = done.get("rows_per_sec") or (
            rows / done["seconds"] if done["seconds"] > 0 else float("nan")
        )
        out.append(
            f"throughput {rps:,.0f} rows/s  "
            f"({rows:,} rows / {done['seconds']:.4f} s Final Time)"
        )
    else:
        out.append("throughput <run incomplete: no run_completed event>")
        hb = s["heartbeat"]
        if hb is not None:
            # An incomplete log with heartbeats: say how far it got (the
            # live view is `watch`; this is the post-mortem of the pulse).
            out.append(
                f"progress   {int(hb['rows_done']):,} rows in "
                f"{hb['elapsed_s']:.1f} s at last heartbeat"
            )

    # Achieved vs available (telemetry.profile): what the compiler's cost
    # model says one runner execution is worth, against the detect phase's
    # wall-clock — over-firing kernels (flops per row jumps) and host-bound
    # runs (tiny achieved GFLOP/s with a healthy detect share) read
    # differently here, offline.
    cost = s["cost"] or {}
    flops = cost.get("flops")
    if s["cost"] is not None:
        where = cost.get("where") or "runner"
        parts = []
        if flops is not None:
            parts.append(f"flops {flops:.4g}")
        if cost.get("bytes_accessed") is not None:
            parts.append(f"bytes accessed {_fmt_bytes(cost['bytes_accessed'])}")
        out.append(
            "cost model "
            + ("  ".join(parts) if parts else "<backend reported none>")
            + f"  ({where}, per execution)"
        )
    if s["mem_analysis"]:
        ma = s["mem_analysis"]
        segs = [
            f"{label} {_fmt_bytes(ma[k])}"
            for k, label in (
                ("argument_bytes", "args"),
                ("output_bytes", "out"),
                ("temp_bytes", "peak temp"),
                ("generated_code_bytes", "code"),
            )
            if ma.get(k) is not None
        ]
        if segs:
            out.append("xla memory " + "  ".join(segs))
    if s["device_mem"]:
        segs = []
        # emit order, not alphabetical: before_detect must read before
        # after_detect or the across-the-span delta reads backwards
        for when, st in s["device_mem"].items():
            if st.get("bytes_in_use") is not None:
                segs.append(f"{when} {_fmt_bytes(st['bytes_in_use'])}")
        peak = max(
            (
                st.get("peak_bytes_in_use", 0) or 0
                for st in s["device_mem"].values()
            ),
            default=0,
        )
        if peak:
            segs.append(f"peak {_fmt_bytes(peak)}")
        if segs:
            out.append("device mem in use: " + "  ".join(segs))
    detect_s = s["phases"].get("detect")
    if flops and detect_s:
        line = (
            f"achieved   {flops / detect_s / 1e9:.3f} GFLOP/s over detect "
            f"{detect_s:.4f} s  (cost-model flops / detect wall-clock)"
        )
        if rows:
            line += f"  ·  {flops / rows:.1f} flops/row"
        out.append(line)

    drifts = s["drifts"]
    # Incomplete-log fallback: streaming engines report detections via
    # their chunk/leg progress events, not per-drift events — sum whatever
    # the log carries (a log has one producer, so these never overlap).
    n_det = (
        done["detections"]
        if done
        else len(drifts)
        + sum(int(c["detections"] or 0) for c in s["chunks"])
        + sum(int(leg["detections"]) for leg in s["legs"])
    )
    out.append(f"detections {n_det}")
    if drifts:
        positions = [int(d["global_pos"]) for d in drifts]
        out.append("drift timeline (stream position, left→right)")
        out.append("  " + _timeline(positions, rows))
        delays = [
            d["delay_rows"] for d in drifts if d["delay_rows"] is not None
        ]
        if delays:
            mean = sum(delays) / len(delays)
            out.append(
                f"  delay mean {mean:.1f} rows"
                f"  min {min(delays)}  max {max(delays)}"
            )
        per_part: dict[int, int] = {}
        for d in drifts:
            per_part[int(d["partition"])] = (
                per_part.get(int(d["partition"]), 0) + 1
            )
        out.append("per-partition detections")
        parts = sorted(per_part)
        for i in range(0, len(parts), 8):
            out.append(
                "  "
                + "  ".join(f"p{q}:{per_part[q]}" for q in parts[i : i + 8])
            )
    if s["quarantine"] is not None:
        q = s["quarantine"]
        line = (
            f"quarantine {int(q['rows'])} row(s) masked out "
            f"(data_policy={q['policy']})"
        )
        if q.get("repaired"):
            line += f", {int(q['repaired'])} cell-repaired row(s)"
        if q.get("sidecar"):
            line += f"  sidecar {q['sidecar']}"
        out.append(line)
    if s["retrains"]:
        out.append(
            f"retrains   {s['retrains']}  ({s['forced_retrains']} forced "
            "by the saturation guard)"
        )
    if s["alerts"]:
        # SLO alert trail (telemetry.slo, serving runs): every crossing,
        # in order, plus whatever is still firing at the log's end.
        firing: dict[str, dict] = {}
        for a in s["alerts"]:
            if a["state"] == "firing":
                firing[a["rule"]] = a
            else:
                firing.pop(a["rule"], None)
        trail = ", ".join(
            f"{a['rule']} {a['state']} at {a['value']:.4g} (>{a['threshold']:g})"
            for a in s["alerts"]
        )
        out.append(f"alerts     {len(s['alerts'])} transition(s): {trail}")
        if firing:
            out.append(
                "           STILL FIRING: " + ", ".join(sorted(firing))
            )
    if s["retried"]:
        # Supervisor retry trail (resilience.supervisor): how many
        # attempts were re-run and why the last one failed — the healed
        # run's registry records carry the matching `attempt` fields.
        last = s["retried"][-1]
        out.append(
            f"retries    {len(s['retried'])} attempt(s) re-run "
            f"(last: attempt {last['attempt']}/{last['max_attempts']} — "
            f"{last['reason']}; backoff {last['backoff_s']:.2f} s)"
        )
    if s["chunks"]:
        last = s["chunks"][-1]
        det = sum(int(c["detections"] or 0) for c in s["chunks"])
        out.append(
            f"chunks     {len(s['chunks'])} processed, "
            f"{last['batches_done']} batches, {det} detections"
        )
    if s["legs"]:
        leg_rows = sum(int(leg["rows"]) for leg in s["legs"])
        det = sum(int(leg["detections"]) for leg in s["legs"])
        out.append(
            f"legs       {len(s['legs'])} completed, {leg_rows:,} rows, "
            f"{det} detections"
        )
    if s["spans"]:
        out.append(
            f"tracing    {s['spans']} span(s) over "
            f"{len(s['trace_ids'])} trace(s)  "
            "(render: the `timeline` CLI)"
        )
    if s["forensics"]:
        newest = s["forensics"][-1]
        out.append(
            f"forensics  {len(s['forensics'])} drift evidence bundle(s)  "
            f"(newest: {newest['bundle']}; render: the `explain` CLI)"
        )
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch report",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "run_log",
        nargs="*",
        help="run-log *.jsonl path(s); a directory renders its newest run",
    )
    ap.add_argument(
        "--dir",
        default=None,
        metavar="DIR",
        help="render a telemetry directory's newest run log (registry-"
        "first resolution; falls back to newest *.jsonl by mtime)",
    )
    args = ap.parse_args(argv)

    def resolve(p: str) -> str:
        if not os.path.isdir(p):
            return p
        newest = newest_run_log(p)
        if newest is None:
            raise SystemExit(f"report: no run logs in {p}")
        return newest

    paths = [resolve(p) for p in args.run_log]
    if args.dir is not None:
        paths.append(resolve(args.dir))
    if not paths:
        ap.error("give run-log path(s) or --dir")
    for i, path in enumerate(paths):
        if i:
            print()
        # Torn-tail tolerant: a crashed or still-writing run is exactly
        # what this post-mortem must render (strict validation is the CI
        # smoke gate's separate read_events call, not this CLI).
        print(render_report(read_events(path, allow_partial_tail=True)))


if __name__ == "__main__":
    main(sys.argv[1:])
