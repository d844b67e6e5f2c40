"""Serve-pipeline observatory: stage busy accounting + bottleneck report —
the port's own copy of the JAX package's ``telemetry/pipeline.py``.

The serving daemon publishes verdicts through a fixed sequence of host
stages — seal-wait, feed/h2d, device compute, collect, sidecar publish,
forensics, adapt — and until now nothing measured where the wall-clock
went between an admitted row and its published verdict. This module is
the jax-free measurement vocabulary and the report that reads it:

* :class:`ServeStageClock` — the serve twin of ``io.feeder.StageClock``
  (the ingest pattern): per-stage busy seconds accumulated locally
  and mirrored into ``serve_stage_busy_seconds_total{stage=...}``. The
  serve loop is single-threaded, so unlike the ingest clock the stage
  busy sum can never exceed serve-loop wall-clock — the conservation
  property tests pin.
* :func:`attribute` — the one attribution computation every renderer
  shares (``/statusz`` pipeline section, the ``pipeline`` CLI, bench's
  ``serve_pipeline_s`` rider, the router's fleet plane): per-stage busy
  share, utilization against wall, implied per-stage rows/s ceiling,
  and the named dominant stage.
* :func:`main` — the ``pipeline`` CLI: reads a ``.prom`` / run-log
  sibling / live ``/statusz`` URL and renders the bottleneck report
  ROADMAP item 1's perf work is judged against. ``--window S`` points
  it at a history store (:mod:`.history`) instead and attributes the
  busy-counter *deltas* over the last S seconds
  (:func:`load_window_report`) — where the recent wall went, not
  cumulative-since-boot.
* :func:`aggregate_fleet` — folds per-backend snapshots into the
  ``/fleetz`` envelope the router and scheduler publish (summed rows/s,
  max per-stage busy share, per-backend bottleneck).

On the card the window engine reads its pointer on the host each
iteration, so ``ChunkedDetector.feed`` returns after the chunk's detect:
the ``feed`` stage holds upload and detect, and ``device`` only the wait
for the flags' copy to the host.

No torch, no jax anywhere here; stdlib + the sibling telemetry modules
only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.parse
import urllib.request

#: Serve-loop stages in publish order. ``seal_wait`` is the loop blocking
#: in ``batcher.get`` (idle-for-input, accounted so utilization is
#: honest); ``feed`` is place()+feed() (on the card the upload and the
#: chunk's detect: the window engine syncs on the host each iteration);
#: ``device`` is the blocking host copy pulling flags back; ``collect`` is
#: host flag scan + verdict-record assembly; ``publish`` is the sidecar
#: write+flush; ``forensics``/``adapt`` are the post-publish hooks.
SERVE_STAGES = (
    "seal_wait",
    "feed",
    "device",
    "collect",
    "publish",
    "forensics",
    "adapt",
)

SERVE_STAGE_BUSY_METRIC = "serve_stage_busy_seconds_total"
SERVE_STAGE_BUSY_HELP = (
    "Cumulative busy seconds per serve-loop stage (single-threaded loop: "
    "the sum over stages never exceeds serve-loop wall-clock)"
)
#: Serve-loop wall-clock gauge: seconds since the loop's first iteration,
#: refreshed on every publish — what makes a scraped ``.prom`` file
#: self-sufficient for utilization (busy/wall) without the daemon.
SERVE_WALL_METRIC = "serve_loop_wall_seconds"
SERVE_WALL_HELP = "Serve-loop wall-clock seconds since the first iteration"
SERVE_ROWS_METRIC = "serve_rows_published"
SERVE_ROWS_HELP = "Stream rows published to the verdict sidecar"


class ServeStageClock:
    """Per-stage busy-seconds accounting for the serve publish path.

    Accumulates locally (``.busy`` — ``/statusz`` and bench read it
    directly) and, when a metrics registry is given, mirrors into the
    ``serve_stage_busy_seconds_total{stage=...}`` counter. Single-writer
    by construction: only the serve loop thread calls :meth:`add`.
    """

    def __init__(self, metrics=None):
        self.busy: dict[str, float] = {}
        self._c = (
            metrics.counter(SERVE_STAGE_BUSY_METRIC, help=SERVE_STAGE_BUSY_HELP)
            if metrics is not None
            else None
        )

    def add(self, stage: str, seconds: float) -> None:
        if seconds < 0:  # clock skew paranoia; counters reject negatives
            return
        self.busy[stage] = self.busy.get(stage, 0.0) + seconds
        if self._c is not None:
            self._c.inc(seconds, stage=stage)


def serve_stage_breakdown(metrics, ndigits: int = 4) -> dict[str, float]:
    """The per-stage busy-seconds map a registry accumulated
    (``SERVE_STAGE_BUSY_METRIC`` samples → ``{stage: seconds}``) — the
    ONE extraction bench.py's serve rider and the ``pipeline`` CLI
    share, mirroring ``io.feeder.stage_breakdown``."""
    c = metrics.counter(SERVE_STAGE_BUSY_METRIC)
    return {
        dict(key)["stage"]: round(v, ndigits)
        for key, v in sorted(c.values.items())
    }


def dominant_stage(busy: dict) -> "str | None":
    """The stage holding the most busy time, ``seal_wait`` excluded —
    seal-wait is waiting *for input*, so it names an under-driven loop,
    not a pipeline bottleneck. Only when nothing else measured any time
    at all does seal_wait get named (an idle loop's honest answer)."""
    work = {s: t for s, t in busy.items() if s != "seal_wait" and t > 0}
    if work:
        return max(sorted(work), key=lambda s: work[s])
    if busy.get("seal_wait", 0.0) > 0:
        return "seal_wait"
    return None


def attribute(
    busy: dict,
    wall_s: "float | None" = None,
    rows: "float | None" = None,
    ndigits: int = 4,
) -> dict:
    """Fold a ``{stage: busy seconds}`` map into the attribution record
    every renderer shares.

    ``share`` is each stage's fraction of total measured busy time;
    ``utilization`` is busy/wall (needs ``wall_s``); ``ceiling_rows_per_sec``
    is rows/busy — the throughput the pipeline would reach if that stage
    were the only cost (needs ``rows``). ``coverage`` (busy sum / wall)
    is the instrumentation-honesty ratio the acceptance bar pins near 1.
    """
    busy = {s: float(t) for s, t in busy.items() if float(t) >= 0}
    total = sum(busy.values())
    stages = {}
    for stage in sorted(busy, key=lambda s: (-busy[s], s)):
        t = busy[stage]
        cell = {"busy_s": round(t, ndigits)}
        cell["share"] = round(t / total, ndigits) if total > 0 else 0.0
        if wall_s and wall_s > 0:
            cell["utilization"] = round(t / wall_s, ndigits)
        if rows and t > 0:
            cell["ceiling_rows_per_sec"] = round(rows / t, 1)
        stages[stage] = cell
    out = {
        "stages": stages,
        "busy_total_s": round(total, ndigits),
        "dominant_stage": dominant_stage(busy),
    }
    if wall_s is not None:
        out["wall_s"] = round(float(wall_s), ndigits)
        if wall_s > 0:
            out["coverage"] = round(total / wall_s, ndigits)
    if rows is not None:
        out["rows"] = int(rows)
    return out


# -- report sources ----------------------------------------------------------


def _samples_from_prom(text: str) -> "tuple[dict, float | None, float | None]":
    """Extract (busy map, wall, rows) from Prometheus exposition text."""
    from .metrics import parse_prometheus_text

    samples = parse_prometheus_text(text)
    busy: dict[str, float] = {}
    wall = rows = None
    for (name, labels), value in samples.items():
        if name == SERVE_STAGE_BUSY_METRIC:
            busy[dict(labels).get("stage", "")] = value
        elif name == SERVE_WALL_METRIC:
            wall = value
        elif name == SERVE_ROWS_METRIC:
            rows = value
    busy.pop("", None)
    return busy, wall, rows


def _load_statusz(obj: dict) -> dict:
    """Attribution from a ``/statusz`` snapshot's ``pipeline`` section."""
    pipe = obj.get("pipeline") or {}
    busy = pipe.get("busy_s") or {}
    if not busy:
        raise ValueError(
            "statusz has no pipeline section (daemon started with "
            "--no-pipeline-metrics, or predates the observatory)"
        )
    rows = (obj.get("rows") or {}).get("published")
    return attribute(busy, pipe.get("wall_s"), rows)


def load_report(source: str, timeout: float = 5.0) -> dict:
    """Build the attribution record from any supported source:

    * ``http(s)://…`` — a live daemon; ``/statusz`` is fetched (the path
      is appended unless the URL already names one).
    * ``*.prom`` — a scraped/exported exposition file.
    * ``*.metrics.json`` — the JSON exporter twin.
    * a run log (``*.jsonl``) — its ``<stem>.prom`` export sibling.
    """
    if source.startswith(("http://", "https://")):
        url = source
        if not urllib.parse.urlparse(url).path.strip("/"):
            url = url.rstrip("/") + "/statusz"
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            obj = json.loads(resp.read().decode())
        report = _load_statusz(obj)
        report["source"] = url
        return report
    path = source
    if path.endswith(".jsonl"):
        sibling = os.path.splitext(path)[0] + ".prom"
        if not os.path.exists(sibling):
            raise FileNotFoundError(
                f"run log has no metrics export sibling: {sibling}"
            )
        path = sibling
    if path.endswith(".metrics.json"):
        with open(path) as fh:
            exported = json.load(fh)

        def _val(name):
            m = exported.get(name) or {}
            return {
                tuple(sorted((s.get("labels") or {}).items())): s["value"]
                for s in m.get("samples", ())
            }

        busy = {
            dict(k).get("stage", ""): v
            for k, v in _val(SERVE_STAGE_BUSY_METRIC).items()
        }
        busy.pop("", None)
        wall = next(iter(_val(SERVE_WALL_METRIC).values()), None)
        rows = next(iter(_val(SERVE_ROWS_METRIC).values()), None)
    else:
        with open(path) as fh:
            busy, wall, rows = _samples_from_prom(fh.read())
    if not busy:
        raise ValueError(
            f"{path}: no {SERVE_STAGE_BUSY_METRIC} samples — not a serve "
            "export, or the daemon ran with --no-pipeline-metrics"
        )
    report = attribute(busy, wall, rows)
    report["source"] = source
    return report


def load_window_report(
    store_dir: str,
    window_s: float,
    *,
    instance: "str | None" = None,
    at: "float | None" = None,
) -> dict:
    """Attribution over a TIME RANGE from a history store
    (``pipeline --window``): per-stage busy deltas between the window's
    edge samples of ``serve_stage_busy_seconds_total``, wall from the
    daemon's own ``serve_loop_wall_seconds`` delta (falling back to the
    scrape timestamps), rows from the ``serve_rows_published`` delta —
    "where did the last N minutes go", not cumulative-since-boot. The
    same :func:`attribute` fold as every other renderer, so live and
    windowed reports are directly comparable."""
    import time as _time

    from .history import read_samples

    if at is None:
        at = _time.time()
    labels = {"instance": instance} if instance else None
    recs = read_samples(
        store_dir,
        name=SERVE_STAGE_BUSY_METRIC,
        labels=labels,
        start=at - window_s,
        end=at,
    )
    if not recs:
        raise ValueError(
            f"{store_dir}: no {SERVE_STAGE_BUSY_METRIC} samples in the "
            f"last {window_s:g}s"
            + (f" for instance {instance!r}" if instance else "")
            + " (collector not scraping, or daemon ran with "
            "--no-pipeline-metrics)"
        )
    instances = sorted(
        {(r.get("labels") or {}).get("instance", "") for r in recs}
    )
    if instance is None and len(instances) > 1:
        raise ValueError(
            f"store holds {len(instances)} instances "
            f"({', '.join(instances)}); pick one with --instance"
        )
    # per-stage counter delta between the window's edge samples
    by_stage: dict[str, list] = {}
    for r in recs:
        stage = (r.get("labels") or {}).get("stage")
        if stage:
            by_stage.setdefault(stage, []).append(r)
    busy: dict[str, float] = {}
    edges: "tuple | None" = None
    for stage, srecs in by_stage.items():
        srecs.sort(key=lambda r: float(r["ts"]))
        first, last = srecs[0], srecs[-1]
        # counter semantics: a restarted daemon resets to 0 — a negative
        # delta means the window spans the restart; count from zero then
        d = float(last["value"]) - float(first["value"])
        busy[stage] = d if d >= 0 else float(last["value"])
        if edges is None or float(last["ts"]) - float(first["ts"]) > (
            float(edges[1]["ts"]) - float(edges[0]["ts"])
        ):
            edges = (first, last)

    def _series_delta(name: str) -> "float | None":
        srecs = read_samples(
            store_dir, name=name, labels=labels, start=at - window_s, end=at
        )
        if len(srecs) < 2:
            return None
        srecs.sort(key=lambda r: float(r["ts"]))
        d = float(srecs[-1]["value"]) - float(srecs[0]["value"])
        return d if d >= 0 else float(srecs[-1]["value"])

    wall = _series_delta(SERVE_WALL_METRIC)
    if wall is None and edges is not None:
        wall = float(edges[1]["ts"]) - float(edges[0]["ts"])
    rows = _series_delta(SERVE_ROWS_METRIC)
    report = attribute(busy, wall, rows)
    report["window_s"] = float(window_s)
    if instance:
        report["instance"] = instance
    return report


def render_report(report: dict) -> str:
    """The human table: one row per stage, busy-ordered, dominant first."""
    lines = []
    src = report.get("source", "")
    lines.append(f"serve pipeline — {src}" if src else "serve pipeline")
    wall = report.get("wall_s")
    head = f"  busy total {report.get('busy_total_s', 0.0):.3f}s"
    if wall is not None:
        head += f" / wall {wall:.3f}s"
        cov = report.get("coverage")
        if cov is not None:
            head += f" (coverage {cov * 100:.1f}%)"
    lines.append(head)
    rows = report.get("rows")
    if rows is not None:
        lines.append(f"  rows published {rows}")
    lines.append("")
    lines.append(
        f"  {'STAGE':<10} {'BUSY_S':>10} {'SHARE':>7} {'UTIL':>7} "
        f"{'CEIL_ROWS/S':>12}"
    )
    for stage, cell in report.get("stages", {}).items():
        util = cell.get("utilization")
        ceil = cell.get("ceiling_rows_per_sec")
        lines.append(
            f"  {stage:<10} {cell['busy_s']:>10.4f} "
            f"{cell['share'] * 100:>6.1f}% "
            f"{(f'{util * 100:.1f}%' if util is not None else '-'):>7} "
            f"{(f'{ceil:,.0f}' if ceil is not None else '-'):>12}"
        )
    lines.append("")
    dom = report.get("dominant_stage")
    lines.append(
        f"  dominant stage: {dom}" if dom else "  dominant stage: (no busy time)"
    )
    return "\n".join(lines)


# -- fleet aggregation -------------------------------------------------------


def backend_snapshot(
    name: str,
    statusz: "dict | None",
    metrics_text: "str | None" = None,
    ops: "str | None" = None,
) -> dict:
    """One backend's row in the ``/fleetz`` envelope, from its scraped
    ``/statusz`` (``None`` statusz = unreachable backend). When the
    statusz carries no ``pipeline`` section but a ``/metrics`` scrape is
    given, the busy map is recovered from the exposition text instead.
    ``ops`` (the backend's ``host:ops_port``) rides along verbatim — the
    history collector's ``--fleetz`` discovery resolves scrape targets
    from it."""
    if not statusz:
        return {
            "name": name,
            "alive": False,
            **({"ops": ops} if ops else {}),
        }
    pipe = statusz.get("pipeline") or {}
    busy = pipe.get("busy_s") or {}
    wall = pipe.get("wall_s")
    if not busy and metrics_text:
        busy, wall, _ = _samples_from_prom(metrics_text)
    attr = attribute(busy, wall) if busy else {}
    rows = (statusz.get("rows") or {}).get("published", 0)
    out = {
        "name": name,
        "alive": True,
        "rows": rows,
        "rows_per_sec": statusz.get("rows_per_sec", 0.0),
        # live SLO alert count from the backend's own engine — summed
        # into the fleet row so `top` can show fleet-wide alert state
        "alerts": len(statusz.get("alerts") or []),
        # captured incident bundles (statusz `incidents` section; 0 for
        # pre-incident daemons) — the fleet incident index's per-backend cell
        "incidents": int((statusz.get("incidents") or {}).get("count") or 0),
        "bottleneck": attr.get("dominant_stage"),
        "busy_share": {
            s: c["share"] for s, c in attr.get("stages", {}).items()
        },
    }
    if ops:
        out["ops"] = ops
    return out


def aggregate_fleet(backends: list[dict]) -> dict:
    """Fold per-backend snapshots (:func:`backend_snapshot` rows) into
    the merged fleet view: summed rows/s, max per-stage busy share with
    the backend holding it, per-backend bottleneck stages."""
    alive = [b for b in backends if b.get("alive")]
    share_max: dict[str, dict] = {}
    for b in alive:
        for stage, share in (b.get("busy_share") or {}).items():
            cur = share_max.get(stage)
            if cur is None or share > cur["share"]:
                share_max[stage] = {"share": share, "backend": b["name"]}
    return {
        "fleet": {
            "backends": len(backends),
            "alive": len(alive),
            "rows": sum(int(b.get("rows") or 0) for b in alive),
            "rows_per_sec": round(
                sum(float(b.get("rows_per_sec") or 0.0) for b in alive), 3
            ),
            "alerts": sum(int(b.get("alerts") or 0) for b in alive),
            "incidents": sum(int(b.get("incidents") or 0) for b in alive),
            "stage_busy_share_max": {
                s: share_max[s] for s in sorted(share_max)
            },
            "bottlenecks": {
                b["name"]: b.get("bottleneck")
                for b in alive
                if b.get("bottleneck")
            },
        },
        "backends": backends,
    }


def fleet_metrics_lines(fleetz: dict) -> list[str]:
    """Render the ``fleet_*`` Prometheus series for an aggregator's
    ``/metrics`` endpoint (router and scheduler share this; hand-rolled
    exposition lines, matching the router's ``router_*`` idiom)."""
    fleet = fleetz.get("fleet", {})
    lines = [
        "# HELP fleet_rows_per_sec Summed published rows/s across alive backends",
        "# TYPE fleet_rows_per_sec gauge",
        f"fleet_rows_per_sec {fleet.get('rows_per_sec', 0.0)}",
        "# HELP fleet_backends_alive Alive backends in the scraped fleet",
        "# TYPE fleet_backends_alive gauge",
        f"fleet_backends_alive {fleet.get('alive', 0)}",
        "# HELP fleet_incidents Captured incident bundles summed across "
        "alive backends",
        "# TYPE fleet_incidents gauge",
        f"fleet_incidents {fleet.get('incidents', 0)}",
    ]
    shares = fleet.get("stage_busy_share_max") or {}
    if shares:
        lines.append(
            "# HELP fleet_stage_busy_share_max Max per-backend busy share "
            "per serve stage"
        )
        lines.append("# TYPE fleet_stage_busy_share_max gauge")
        for stage in sorted(shares):
            lines.append(
                f'fleet_stage_busy_share_max{{stage="{stage}"}} '
                f"{shares[stage]['share']}"
            )
    bottlenecks = fleet.get("bottlenecks") or {}
    if bottlenecks:
        lines.append(
            "# HELP fleet_backend_bottleneck Dominant serve stage per "
            "backend (value is always 1)"
        )
        lines.append("# TYPE fleet_backend_bottleneck gauge")
        for name in sorted(bottlenecks):
            lines.append(
                f'fleet_backend_bottleneck{{backend="{name}",'
                f'stage="{bottlenecks[name]}"}} 1'
            )
    return lines


# -- CLI ---------------------------------------------------------------------


def main(argv=None) -> int:
    """``pipeline``: render the serve bottleneck-attribution report."""
    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch pipeline",
        description=(
            "Serve-pipeline bottleneck report: per-stage busy share, "
            "utilization, implied rows/s ceiling, dominant stage. Reads "
            "a .prom/.metrics.json export, a run log's export sibling, "
            "or a live daemon's /statusz URL."
        ),
    )
    ap.add_argument(
        "source",
        help="metrics export (.prom/.metrics.json), run log (.jsonl), "
        "http://host:ops_port of a live daemon, or — with --window — a "
        "history store directory",
    )
    ap.add_argument(
        "--json", action="store_true", help="emit the attribution record as JSON"
    )
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument(
        "--window", type=float, default=None, metavar="S",
        help="windowed mode: source is a telemetry.history store; "
        "attribute stage busy-counter DELTAS over the last S seconds "
        "(where the recent wall-clock went, not since boot)",
    )
    ap.add_argument(
        "--instance", default=None, metavar="NAME",
        help="with --window: the store instance label to attribute "
        "(required when the store holds several)",
    )
    ap.add_argument(
        "--at", type=float, default=None, metavar="TS",
        help="with --window: window end as unix seconds (default: now)",
    )
    args = ap.parse_args(argv)
    if (args.instance or args.at is not None) and args.window is None:
        ap.error("--instance/--at only apply to --window mode")
    try:
        if args.window is not None:
            report = load_window_report(
                args.source, args.window, instance=args.instance, at=args.at
            )
            report["source"] = args.source
        else:
            report = load_report(args.source, timeout=args.timeout)
    except (OSError, ValueError) as e:
        print(f"pipeline: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        print(render_report(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
