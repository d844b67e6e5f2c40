"""Live terminal dashboard: ``top`` for drift-serving runs.

    python -m distributed_drift_detection_tpu_torch top <run.jsonl | dir>... \\
        [--statusz URL]... [--interval S] [--once]

``watch`` renders one run as a status line; ``top`` renders a fleet as a
refreshing table — throughput, latency percentiles, drift rate,
quarantine rate, and active alerts for one or many runs at once. Two
data sources, freely mixed:

* **run logs / telemetry dirs** (positional args — a directory resolves
  to its newest run log): tailed incrementally with the same
  :class:`~.watch.LogTail` the watch CLI uses, folded through
  :class:`~.watch.WatchState` plus the ops-plane extras (``alert``
  transitions, quarantine counts riding on ``run_completed``);
* **``--statusz`` URLs** (a serving daemon's ``--ops-port``): the JSON
  snapshot carries what a log cannot — live latency percentiles,
  queue depth, quarantine share — fetched fresh every frame with a
  short timeout (an unreachable daemon renders as ``down``, never
  crashes the dashboard).

Rates are deltas between frames (cumulative ÷ uptime on the first
frame / ``--once``). Pure stdlib, no jax — runs wherever the artifacts
or endpoints are reachable, same contract as ``watch``/``report``.

Three history-plane hooks (:mod:`.history`):

* ``--store DIR`` — point the dashboard at a collector's (or recorded)
  history store: every row gains a TREND sparkline of its recent rows/s
  (``top_rows_per_sec`` falling back to the collector's
  ``serve_rows_per_sec``, keyed by ``instance``);
* ``--record DIR`` — write every rendered frame's samples into a store
  in the history format (one ``append_samples`` batch per frame, one
  shared timestamp), turning any live incident into a durable artifact;
* ``--replay DIR`` — play a recorded session back frame by frame, no
  daemons required: the post-incident review runs on the artifact.
"""

# The port's own copy of the JAX package's ``telemetry/top.py``; its CLI's
# ``--help`` prints the docstring above, so that is the JAX module's, but
# for the program name.

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request

from .watch import LogTail, WatchState, resolve_log

_CLEAR = "\x1b[2J\x1b[H"


def _frame_rate(prev, now_mono, rows, fallback):
    """Rows/s from the delta against the previous frame; returns
    ``(rate, new prev)``. A computed delta of 0 means 0 — a stalled run
    must never fall back to a healthy-looking cumulative average —
    ``fallback()`` serves only the first frame / ``--once``."""
    if rows is None:
        return None, prev
    if prev is not None:
        dt = now_mono - prev[0]
        rate = (rows - prev[1]) / dt if dt > 0 and rows >= prev[1] else None
    else:
        rate = fallback()
    return rate, (now_mono, rows)


class LogSource:
    """One tailed run log folded into dashboard columns."""

    def __init__(self, path: str):
        self.path = path
        self.tail = LogTail(path)
        self.state = WatchState()  # folds alerts too (watch.py)
        self.quarantined = 0
        self._prev: "tuple[float, int] | None" = None  # (poll mono, rows)

    def poll(self, now_mono: float) -> dict:
        events = self.tail.poll()
        self.state.fold(events)
        for e in events:
            if e["type"] == "rows_quarantined":
                self.quarantined += int(e["rows"])
            elif e["type"] == "run_completed":
                self.quarantined = int(
                    e.get("rows_quarantined") or self.quarantined
                )
        s = self.state
        rows = s.rows_done
        if rows is None and s.completed is not None:
            rows = int(s.completed["rows"])
        rate, self._prev = _frame_rate(self._prev, now_mono, rows, s.rate)
        age = None if s.last_ts is None else max(time.time() - s.last_ts, 0.0)
        return {
            "run": s.run_id or os.path.basename(self.path),
            "status": "done" if s.completed is not None else "live",
            "rows": rows,
            "rows_per_sec": rate,
            "p50_ms": None,
            "p99_ms": None,
            "detections": s.detections,
            "quarantined": self.quarantined,
            "wire": None,  # per-protocol counters live on /statusz only
            "busy": None,  # pipeline shares live on /statusz only
            "alerts": sorted(s.alerts),
            "age_s": age,
        }


class StatuszSource:
    """One serving daemon's ``/statusz`` endpoint → dashboard columns."""

    def __init__(self, url: str, *, timeout: float = 2.0):
        self.url = url if "://" in url else "http://" + url
        if not self.url.rstrip("/").endswith("/statusz"):
            self.url = self.url.rstrip("/") + "/statusz"
        self.timeout = timeout
        self._prev: "tuple[float, int] | None" = None

    def poll(self, now_mono: float) -> dict:
        try:
            with urllib.request.urlopen(self.url, timeout=self.timeout) as r:
                s = json.load(r)
        except (urllib.error.URLError, OSError, ValueError) as e:
            return {
                "run": self.url,
                "status": "down",
                "rows": None,
                "rows_per_sec": None,
                "p50_ms": None,
                "p99_ms": None,
                "detections": None,
                "quarantined": None,
                "wire": None,
                "busy": None,
                "alerts": [f"unreachable: {getattr(e, 'reason', e)}"],
                "age_s": None,
            }
        if s.get("sched"):
            return self._sched_row(s, now_mono)
        rows = (s.get("rows") or {}).get("published")
        rate, self._prev = _frame_rate(
            self._prev,
            now_mono,
            rows,
            lambda: rows / s["uptime_s"] if rows and s.get("uptime_s") else None,
        )
        lat = s.get("latency_ms") or {}
        # Per-protocol ingress mix ("v1:12 v2:340[ err:2]") from the
        # /statusz ingress section (serve ingress counters); socketless
        # embeddings report None there and the column stays "-".
        ingress = s.get("ingress") or None
        wire = None
        if ingress is not None:
            wire = f"v1:{ingress.get('frames_v1', 0)} v2:{ingress.get('frames_v2', 0)}"
            if ingress.get("decode_errors"):
                wire += f" err:{ingress['decode_errors']}"
        status = "draining" if s.get("draining") else "live"
        # BUSY: the serve-pipeline observatory's dominant stage + its
        # busy share ("device:62%") from the /statusz pipeline section;
        # absent ("-") under --no-pipeline-metrics or on old daemons.
        busy = _busy_cell(s.get("pipeline") or {})
        fleet_rows: list = []
        if s.get("router"):
            # A tenant router's /statusz (serve.router): the row reads
            # like a daemon serving the whole fleet, with the fleet
            # health riding the WIRE column — backends alive, graceful
            # migrations, failovers, rows lost past replay buffers.
            status = "router" if not s.get("draining") else "draining"
            backs = s.get("backends") or []
            alive = sum(1 for b in backs if b.get("alive"))
            fleet = (
                f"be:{alive}/{len(backs)} mig:{s.get('migrations', 0)} "
                f"fo:{s.get('failovers', 0)}"
            )
            if s.get("rows_lost"):
                fleet += f" lost:{s['rows_lost']}"
            wire = f"{wire} {fleet}" if wire else fleet
            # the merged fleet view: one indented row per backend with
            # its own BUSY cell, then one fleet-aggregate row
            fleet_rows = self._fleet_rows()
        row = {
            "run": s.get("run_id") or self.url,
            "status": status,
            "rows": rows,
            "rows_per_sec": rate,
            "p50_ms": lat.get("p50"),
            "p99_ms": lat.get("p99"),
            "detections": s.get("detections"),
            "quarantined": (s.get("rows") or {}).get("quarantined"),
            # incident autopsy bundles captured this run (the /statusz
            # incidents section; "-" on pre-incident daemons)
            "incidents": (s.get("incidents") or {}).get("count"),
            "wire": wire,
            "busy": busy,
            "alerts": sorted(a["rule"] for a in s.get("alerts") or []),
            "age_s": s.get("last_verdict_age_s"),
        }
        return [row, *fleet_rows] if fleet_rows else row

    def _fleet_rows(self) -> list[dict]:
        """Per-backend + fleet-aggregate dashboard rows from an
        aggregator's ``/fleetz`` (missing endpoint = no extra rows —
        a pre-observatory router renders exactly as before)."""
        url = self.url[: -len("/statusz")] + "/fleetz"
        try:
            with urllib.request.urlopen(url, timeout=self.timeout) as r:
                fz = json.load(r)
        except (urllib.error.URLError, OSError, ValueError):
            return []
        rows = []
        for b in fz.get("backends") or []:
            share = b.get("busy_share") or {}
            dom = b.get("bottleneck")
            rows.append(
                {
                    "run": "  " + (b.get("name") or "?"),
                    "status": "live" if b.get("alive") else "down",
                    "rows": b.get("rows"),
                    "rows_per_sec": b.get("rows_per_sec"),
                    "incidents": b.get("incidents"),
                    "busy": (
                        _share_cell(dom, share.get(dom)) if dom else None
                    ),
                    "alerts": (
                        [f"{int(b['alerts'])} firing"]
                        if b.get("alerts")
                        else []
                    ),
                }
            )
        fleet = fz.get("fleet") or {}
        shares = fleet.get("stage_busy_share_max") or {}
        busy = None
        if shares:
            stage = max(sorted(shares), key=lambda k: shares[k]["share"])
            busy = _share_cell(stage, shares[stage]["share"])
        # fleet-wide live alert count (summed per-backend SLO engines,
        # pipeline.aggregate_fleet): the fleet row says "N firing"
        n_alerts = int(fleet.get("alerts") or 0)
        rows.append(
            {
                "run": (
                    f"  fleet ({fleet.get('alive', 0)}/"
                    f"{fleet.get('backends', 0)})"
                ),
                "status": "fleet",
                "rows": fleet.get("rows"),
                "rows_per_sec": fleet.get("rows_per_sec"),
                "incidents": fleet.get("incidents"),
                "busy": busy,
                "alerts": [f"{n_alerts} firing"] if n_alerts else [],
            }
        )
        return rows

    def _sched_row(self, s: dict, now_mono: float) -> dict:
        """A sweep scheduler's ``/statusz`` (sched/scheduler.py): the row
        reads like a daemon whose "rows" are the fleet's cumulative cell
        rows, with the queue/lease/worker health riding the WIRE column —
        the router row's pattern for the control plane."""
        cells = s.get("cells") or {}
        workers = s.get("workers") or []
        alive = sum(1 for w in workers if w.get("alive"))
        rows = sum(int(w.get("rows_done") or 0) for w in workers) or None
        rate, self._prev = _frame_rate(
            self._prev,
            now_mono,
            rows,
            lambda: rows / s["uptime_s"] if rows and s.get("uptime_s") else None,
        )
        fleet = (
            f"q:{cells.get('queued', 0)} l:{cells.get('leased', 0)} "
            f"c:{cells.get('completed', 0)} f:{cells.get('failed', 0)} "
            f"wk:{alive}/{len(workers)}"
        )
        if s.get("evictions"):
            fleet += f" ev:{s['evictions']}"
        alerts = []
        if cells.get("failed"):
            alerts.append("cells_failed")
        ages = [
            w.get("age_s") for w in workers
            if w.get("alive") and w.get("age_s") is not None
        ]
        return {
            "run": s.get("run_id") or self.url,
            "status": "done" if s.get("whole") else "sched",
            "rows": rows,
            "rows_per_sec": rate,
            "p50_ms": None,
            "p99_ms": None,
            "detections": None,
            "quarantined": None,
            "wire": fleet,
            "alerts": alerts,
            "age_s": min(ages) if ages else None,
        }


def _share_cell(stage: str, share) -> str:
    """"device:62%" — a stage plus its busy share, the BUSY cell."""
    if share is None:
        return stage
    return f"{stage}:{share * 100:.0f}%"


def _busy_cell(pipe: dict) -> "str | None":
    dom = pipe.get("dominant_stage")
    if not dom:
        return None
    return _share_cell(dom, (pipe.get("shares") or {}).get(dom))


_COLUMNS = (
    ("RUN", "run", 38),
    ("ST", "status", 8),
    ("ROWS", "rows", 12),
    ("ROWS/S", "rows_per_sec", 10),
    ("P50ms", "p50_ms", 10),
    ("P99ms", "p99_ms", 10),
    ("DET", "detections", 7),
    ("QUAR", "quarantined", 7),
    ("INC", "incidents", 5),
    ("WIRE", "wire", 16),
    ("BUSY", "busy", 14),
    ("TREND", "trend", 14),
    ("AGE", "age_s", 7),
    ("ALERTS", "alerts", 0),
)

#: Numeric row columns a ``--record`` store captures (as ``top_<col>``
#: series keyed by ``instance``) and ``--replay`` restores.
_RECORD_COLS = (
    "rows",
    "rows_per_sec",
    "p50_ms",
    "p99_ms",
    "detections",
    "quarantined",
    "incidents",
    "age_s",
)

#: The trend sparkline's preferred series, most-specific first: a
#: ``--record``ed store carries ``top_rows_per_sec``; a collector-built
#: store carries the scraped ``serve_rows_per_sec``.
_TREND_SERIES = ("top_rows_per_sec", "serve_rows_per_sec")


def record_frame(store, rows: list[dict], *, ts=None) -> int:
    """Append one rendered frame's samples to a history store (one
    batch, one shared timestamp — replay regroups frames by it);
    returns the sample count. Statuses ride as a label on ``top_up``
    (history values are floats), alert *counts* on
    ``top_alerts_active`` — the replayable skeleton of the frame."""
    samples: list = []
    for r in rows:
        inst = str(r.get("run") or "?").strip()
        samples.append(
            (
                "top_up",
                {"instance": inst, "status": str(r.get("status") or "?")},
                0.0 if r.get("status") == "down" else 1.0,
            )
        )
        samples.append(
            (
                "top_alerts_active",
                {"instance": inst},
                float(len(r.get("alerts") or [])),
            )
        )
        for key in _RECORD_COLS:
            v = r.get(key)
            if isinstance(v, (int, float)):
                samples.append((f"top_{key}", {"instance": inst}, float(v)))
    store.append_samples(samples, ts=ts)
    return len(samples)


def replay_frames(store_dir: str) -> "list[tuple[float, list[dict]]]":
    """Reconstruct recorded frames from a ``--record`` store: samples
    sharing one timestamp are one frame, one row per instance (insertion
    order preserved — the order the dashboard rendered them in)."""
    from .history import read_samples

    frames: dict[float, dict[str, dict]] = {}
    for rec in read_samples(store_dir):
        name = rec["name"]
        if not name.startswith("top_"):
            continue
        labels = rec.get("labels") or {}
        inst = labels.get("instance", "?")
        by_inst = frames.setdefault(float(rec["ts"]), {})
        row = by_inst.setdefault(inst, {"run": inst, "alerts": []})
        if name == "top_up":
            row["status"] = labels.get("status", "?")
        elif name == "top_alerts_active":
            n = int(rec["value"])
            row["alerts"] = [f"{n} firing"] if n else []
        elif name[len("top_"):] in _RECORD_COLS:
            key = name[len("top_"):]
            v = rec["value"]
            row[key] = int(v) if key in ("rows", "detections",
                                         "quarantined", "incidents") else v
    return [
        (ts, list(by_inst.values())) for ts, by_inst in sorted(frames.items())
    ]


class TrendSource:
    """Per-instance rows/s sparklines from a history store (``--store``):
    the dashboard's memory. Reads are torn-tail tolerant and fully
    concurrent with a live collector writing the same store."""

    def __init__(self, store_dir: str, *, window_s: float = 600.0,
                 width: int = 12):
        self.store_dir = store_dir
        self.window_s = window_s
        self.width = width

    def cell(self, run: str, now: "float | None" = None) -> "str | None":
        from .history import range_query, sparkline

        if now is None:
            now = time.time()
        inst = str(run).strip()
        for name in _TREND_SERIES:
            series = range_query(
                self.store_dir,
                name,
                labels={"instance": inst},
                start=now - self.window_s,
                end=now,
            )
            for pts in series.values():
                if pts:
                    return sparkline(
                        [v for _, v in pts], width=self.width
                    ) or None
        return None


def _cell(value) -> str:
    if value is None:
        return "-"
    if isinstance(value, list):
        return ",".join(str(v) for v in value) or "-"
    if isinstance(value, float):
        return f"{value:,.1f}"
    return f"{value:,}" if isinstance(value, int) else str(value)


def render(rows: list[dict], now: float) -> str:
    """One dashboard frame (pure function of the polled rows — tests pin
    it without a terminal)."""
    header = "".join(
        (f"{h:<{w}}" if w else h) for h, _, w in _COLUMNS
    ).rstrip()
    lines = [
        time.strftime("top  %Y-%m-%d %H:%M:%S", time.localtime(now))
        + f"  ({len(rows)} run{'s' if len(rows) != 1 else ''})",
        header,
    ]
    for r in rows:
        cells = []
        for _, key, w in _COLUMNS:
            text = _cell(r.get(key))
            cells.append(f"{text:<{w}}" if w else text)
        lines.append("".join(cells).rstrip())
    firing = sum(
        1 for r in rows if r.get("alerts") and r.get("status") != "down"
    )
    if firing:
        lines.append(f"!! {firing} run(s) with active alerts")
    return "\n".join(lines)


def top(
    targets: list[str],
    statusz: list[str],
    *,
    interval: float = 2.0,
    once: bool = False,
    out=print,
    sleep=time.sleep,
    frames: "int | None" = None,
    store: "str | None" = None,
    record: "str | None" = None,
) -> int:
    """Drive the dashboard; returns an exit code (0 ok, 4 = nothing to
    show — no resolvable log and no endpoint, the watch convention).
    ``store`` adds the TREND sparkline column from a history store;
    ``record`` appends every frame's samples to one."""
    sources: list = []
    for t in targets:
        path = resolve_log(t)
        if path is not None:
            sources.append(LogSource(path))
        else:
            out(f"top: no run log at {t}")
    sources.extend(StatuszSource(u) for u in statusz)
    if not sources:
        return 4
    trend = TrendSource(store) if store else None
    recorder = None
    if record:
        from .history import HistoryStore

        recorder = HistoryStore(record)
    try:
        n = 0
        while True:
            now_mono = time.monotonic()
            now = time.time()
            rows = []
            for src in sources:
                polled = src.poll(now_mono)
                rows.extend(polled if isinstance(polled, list) else [polled])
            if trend is not None:
                for r in rows:
                    r["trend"] = trend.cell(r.get("run") or "?", now=now)
            if recorder is not None:
                record_frame(recorder, rows, ts=now)
            frame = render(rows, now)
            out(frame if once else _CLEAR + frame)
            n += 1
            if once or (frames is not None and n >= frames):
                return 0
            sleep(interval)
    finally:
        if recorder is not None:
            recorder.close()


def replay(
    store_dir: str,
    *,
    interval: float = 0.0,
    out=print,
    sleep=time.sleep,
    clear: bool = False,
) -> int:
    """Play a ``--record``ed session back frame by frame (exit 4 when
    the store holds no frames — the nothing-to-show convention)."""
    recorded = replay_frames(store_dir)
    if not recorded:
        return 4
    for i, (ts, rows) in enumerate(recorded):
        frame = render(rows, ts)
        out(_CLEAR + frame if clear else frame)
        if interval > 0 and i < len(recorded) - 1:
            sleep(interval)
    return 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch top",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "targets",
        nargs="*",
        help="run-log *.jsonl files or telemetry directories (newest run)",
    )
    ap.add_argument(
        "--statusz",
        action="append",
        default=[],
        metavar="URL",
        help="a serving daemon's ops endpoint (host:port or full URL), "
        "repeatable — adds live latency/queue columns",
    )
    ap.add_argument("--interval", type=float, default=2.0, metavar="S")
    ap.add_argument(
        "--once", action="store_true", help="print one frame and exit"
    )
    ap.add_argument(
        "--store", default=None, metavar="DIR",
        help="history store (telemetry.history): adds the TREND "
        "rows/s sparkline column per row",
    )
    ap.add_argument(
        "--record", default=None, metavar="DIR",
        help="append every rendered frame's samples to a history store "
        "— the incident becomes a replayable artifact",
    )
    ap.add_argument(
        "--replay", default=None, metavar="DIR",
        help="play a --record'ed session back frame by frame and exit "
        "(no daemons; ignores targets/--statusz)",
    )
    args = ap.parse_args(argv)
    if args.replay:
        if args.record:
            ap.error("--replay plays an existing store; drop --record")
        raise SystemExit(
            replay(args.replay, interval=args.interval if not args.once
                   else 0.0, clear=not args.once)
        )
    if not args.targets and not args.statusz:
        ap.error("nothing to watch: give a run log/dir or --statusz URL")
    raise SystemExit(
        top(
            args.targets,
            args.statusz,
            interval=args.interval,
            once=args.once,
            store=args.store,
            record=args.record,
        )
    )


if __name__ == "__main__":
    main(sys.argv[1:])
