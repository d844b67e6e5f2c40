"""Serve-pipeline attribution and the merged fleet view — the parts of the
JAX package's ``telemetry/pipeline.py`` the serving daemon and the sweep
scheduler use:

* :class:`ServeStageClock` — per-stage busy seconds of the serve loop,
  mirrored into ``serve_stage_busy_seconds_total{stage=...}``;
* :func:`attribute` — the attribution record (``/statusz``'s pipeline
  section): per-stage share, utilization, rows/s ceiling, dominant stage;
* :func:`backend_snapshot`, :func:`aggregate_fleet` and
  :func:`fleet_metrics_lines` — an aggregator's (the tenant router's)
  ``/fleetz`` and its ``fleet_*`` series.

On the card the window engine reads its pointer on the host each
iteration, so ``ChunkedDetector.feed`` returns after the chunk's detect:
the ``feed`` stage holds upload and detect, and ``device`` only the wait
for the flags' copy to the host. The ``pipeline`` CLI and its report
readers wait for ROADMAP A15c. Stdlib only.
"""

from __future__ import annotations

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
    ``ops`` (the backend's ``host:ops_port``) rides along verbatim."""
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
        # live SLO alert count from the backend's own engine
        "alerts": len(statusz.get("alerts") or []),
        # captured incident bundles (statusz `incidents` section)
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
