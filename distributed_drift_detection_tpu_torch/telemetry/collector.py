"""Fleet metrics collector: the scraper that feeds the history plane — the
port's own copy of the JAX package's ``telemetry/collector.py``; its store
is the JAX package's format.

A serve daemon's ``/metrics`` is a point-in-time exposition; the history
store (:mod:`.history`) is durable time. This module is the pump between
them — a small scraper daemon that discovers ops endpoints, polls
``/metrics`` + ``/statusz`` on an interval, and appends every sample to
a :class:`~.history.HistoryStore`, from which ``history``/``top``/
``pipeline --window`` answer questions about the past and burn-rate SLO
rules judge sustained behaviour.

Discovery (any mix; targets are deduped by resolved ops address):

==================  ========================================================
``--statusz URL``   explicit ops base (``http://host:port`` or a full
                    ``/statusz`` URL), repeatable — zero-infrastructure
                    loopback use
``--fleetz URL``    a router/scheduler aggregator: its ``/fleetz`` rows now
                    carry each backend's ``ops`` address — scrape the whole
                    fleet by asking the one process that already knows it
``--registry DIR``  the telemetry run registry: every ``kind="serve"`` run
                    still ``running`` whose record carries an ``ops``
                    address (the daemon appends a second "running" record
                    with the bound port once its ops server is up)
==================  ========================================================

Each scrape cycle stamps ONE ``(wall, monotonic)`` pair shared by every
sample it lands (the correlate/timeline skew-rebase convention: the
monotonic stamp is the truth for elapsed time within one collector run,
wall time is the cross-run join key). Per-target failures mark the
target down (``up{instance=...} = 0``) and move on — a dead daemon is a
*data point*, never a collector crash. The collector meters itself
(``collector_scrape_seconds``, ``collector_targets_up``,
``collector_samples_total``, ``collector_errors_total``) into the same
store, and can evaluate ``burn_rate`` SLO rules (:mod:`.slo`) against
the store it builds, emitting ordinary schema-v1 ``alert`` events into
its own run log — fleet-level alerting without touching a daemon.

Non-perturbing by construction: the collector only ever issues GETs
against ops endpoints; the serving data path never sees it (the history
smoke proves verdict sidecars bit-identical with and without one
attached). No torch, no jax; stdlib only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request

from .history import DEFAULT_SEGMENT_BYTES, HistoryStore, avg_over_time
from .incident import INCIDENT_OPEN_SERIES, INCIDENTS_TOTAL_SERIES
from .metrics import MetricsRegistry, parse_prometheus_text

#: Self-metering series (stored with instance="collector").
SCRAPE_SECONDS_METRIC = "collector_scrape_seconds"
SCRAPE_SECONDS_HELP = "Wall seconds spent per full scrape cycle"
TARGETS_UP_METRIC = "collector_targets_up"
TARGETS_UP_HELP = "Targets answering their ops endpoints this cycle"
SAMPLES_METRIC = "collector_samples_total"
SAMPLES_HELP = "Samples appended to the history store"
ERRORS_METRIC = "collector_errors_total"
ERRORS_HELP = "Scrape failures, labeled by instance"

#: Synthetic per-target liveness series in the store.
UP_METRIC = "up"
#: /statusz fields lifted into store series (gauge semantics).
STATUSZ_SERIES = (
    ("serve_rows_per_sec", ("rows_per_sec",)),
    ("serve_last_verdict_age_s", ("last_verdict_age_s",)),
    ("serve_p99_ms", ("latency_ms", "p99")),
)


class Target:
    """One scrape target: a resolved ops base URL plus an instance name
    (the label every stored sample carries)."""

    def __init__(self, name: str, base_url: str):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.up = False

    def __repr__(self):
        return f"Target({self.name!r}, {self.base_url!r})"


def _normalize_base(url: str) -> str:
    """Accept ``host:port``, ``http://host:port`` or any full ops-path
    URL; return the bare ``http://host:port`` base."""
    if "://" not in url:
        url = "http://" + url
    for suffix in ("/statusz", "/metrics", "/healthz", "/fleetz"):
        if url.rstrip("/").endswith(suffix):
            url = url.rstrip("/")[: -len(suffix)]
            break
    return url.rstrip("/")


def _get_json(url: str, timeout: float) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def _get_text(url: str, timeout: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def discover(
    statusz_urls=(),
    fleetz_url: "str | None" = None,
    registry_dir: "str | None" = None,
    timeout: float = 5.0,
) -> list[Target]:
    """Resolve the target set from the three discovery sources; targets
    are deduped by base URL (first name wins). Discovery failures of the
    *aggregator/registry* raise — a collector pointed at a dead router
    should say so loudly at startup; per-target scrape failures later
    are down-markings, not errors."""
    targets: list[Target] = []
    seen: set[str] = set()

    def _add(name: str, base: str) -> None:
        base = _normalize_base(base)
        if base not in seen:
            seen.add(base)
            targets.append(Target(name, base))

    for url in statusz_urls or ():
        base = _normalize_base(url)
        _add(base.split("://", 1)[-1], base)
    if fleetz_url:
        base = _normalize_base(fleetz_url)
        fleetz = _get_json(base + "/fleetz", timeout)
        for b in fleetz.get("backends") or []:
            ops = b.get("ops")
            if ops:
                _add(str(b.get("name") or ops), ops)
    if registry_dir:
        from . import registry as run_registry

        for run_id, rec in sorted(run_registry.runs(registry_dir).items()):
            if (
                rec.get("kind") == "serve"
                and rec.get("status") == "running"
                and rec.get("ops")
            ):
                _add(str(rec.get("name") or run_id), rec["ops"])
    return targets


def scrape_once(
    store: HistoryStore,
    targets: list[Target],
    *,
    metrics: "MetricsRegistry | None" = None,
    timeout: float = 5.0,
) -> dict:
    """One scrape cycle: every target's ``/metrics`` + ``/statusz`` into
    the store under ONE shared ``(wall, mono)`` stamp pair; returns the
    cycle summary. A failing target is down-marked (``up{instance}=0``)
    and the cycle continues — the collector never dies of a dead
    daemon."""
    t0 = time.monotonic()
    ts, mono = time.time(), time.monotonic()
    samples: list = []
    errors = 0
    for target in targets:
        try:
            prom = parse_prometheus_text(
                _get_text(target.base_url + "/metrics", timeout)
            )
            statusz = _get_json(target.base_url + "/statusz", timeout)
        except (urllib.error.URLError, OSError, ValueError) as e:
            target.up = False
            errors += 1
            samples.append((UP_METRIC, {"instance": target.name}, 0.0))
            if metrics is not None:
                metrics.counter(ERRORS_METRIC, ERRORS_HELP).inc(
                    1.0, instance=target.name
                )
            print(
                f"collector: {target.name} down: {e}",
                file=sys.stderr,
                flush=True,
            )
            continue
        target.up = True
        samples.append((UP_METRIC, {"instance": target.name}, 1.0))
        for (name, labels), value in sorted(prom.items()):
            # histogram buckets are a cardinality explosion the store
            # gains nothing from (quantile_over_time works on the raw
            # gauge series); _sum/_count still land, so rates survive
            if name.endswith("_bucket"):
                continue
            samples.append(
                (name, {**dict(labels), "instance": target.name}, value)
            )
        for name, path in STATUSZ_SERIES:
            value = statusz
            for part in path:
                value = (value or {}).get(part) if isinstance(
                    value, dict
                ) else None
            if value is not None:
                samples.append(
                    (name, {"instance": target.name}, float(value))
                )
        alerts = statusz.get("alerts")
        if alerts is not None:
            samples.append(
                (
                    "serve_alerts_active",
                    {"instance": target.name},
                    float(len(alerts)),
                )
            )
        # Incident plane (telemetry.incident): lift /incidentz into the
        # fleet index series. Its OWN try block — a pre-incident daemon
        # 404s here (HTTPError ⊂ URLError) and must NOT be down-marked;
        # the /metrics+/statusz scrape above already proved it alive.
        try:
            inc = _get_json(target.base_url + "/incidentz", timeout)
        except (urllib.error.URLError, OSError, ValueError):
            inc = None
        if isinstance(inc, dict):
            samples.append(
                (
                    INCIDENTS_TOTAL_SERIES,
                    {"instance": target.name},
                    float(inc.get("count") or 0),
                )
            )
            samples.append(
                (
                    INCIDENT_OPEN_SERIES,
                    {"instance": target.name},
                    float(inc.get("open") or 0),
                )
            )
    up_count = sum(1 for t in targets if t.up)
    scrape_s = time.monotonic() - t0
    # self-metering rides the same store (and registry, when given)
    samples.append((SCRAPE_SECONDS_METRIC, {"instance": "collector"}, scrape_s))
    samples.append((TARGETS_UP_METRIC, {"instance": "collector"}, up_count))
    if metrics is not None:
        metrics.histogram(SCRAPE_SECONDS_METRIC, SCRAPE_SECONDS_HELP).observe(
            scrape_s
        )
        metrics.gauge(TARGETS_UP_METRIC, TARGETS_UP_HELP).set(float(up_count))
        metrics.counter(SAMPLES_METRIC, SAMPLES_HELP).inc(float(len(samples)))
    store.append_samples(samples, ts=ts, mono=mono)
    store.enforce_retention(now=ts)
    return {
        "targets": len(targets),
        "up": up_count,
        "errors": errors,
        "samples": len(samples),
        "scrape_s": round(scrape_s, 4),
    }


def run_collector(
    store_dir: str,
    *,
    statusz_urls=(),
    fleetz_url: "str | None" = None,
    registry_dir: "str | None" = None,
    interval_s: float = 5.0,
    count: "int | None" = None,
    timeout: float = 5.0,
    segment_bytes: int = DEFAULT_SEGMENT_BYTES,
    retention_s: "float | None" = None,
    retention_bytes: "int | None" = None,
    telemetry_dir: "str | None" = None,
    slo_specs=(),
    rediscover_every: int = 12,
    stop_check=None,
) -> int:
    """The collector loop: discover, scrape every ``interval_s`` into
    the store (``count`` bounds the cycles — CI mode; ``None`` = until
    killed), re-resolving discovery every ``rediscover_every`` cycles so
    restarted daemons re-appear. With ``--telemetry-dir``, the collector
    keeps its own run log + registry record and evaluates any
    ``burn_rate`` SLO rules against the store it builds."""
    from .slo import BURN_KIND, SloEngine, parse_rules

    rules = parse_rules(slo_specs)
    bad = [r for r in rules if r.kind != BURN_KIND]
    if bad:
        raise ValueError(
            "collector --slo accepts only burn_rate rules (threshold "
            "kinds judge in-process daemon state the collector does not "
            f"have); got {[r.kind for r in bad]}"
        )
    metrics = MetricsRegistry()
    log = None
    engine = None
    if telemetry_dir:
        from .events import EventLog
        from . import registry as run_registry

        log = EventLog.open_run(telemetry_dir, name="collector")
        log.emit(
            "run_started",
            run_id=log.run_id,
            config={"store": store_dir, "interval_s": interval_s},
        )
        run_registry.record(
            telemetry_dir,
            log.run_id,
            "running",
            kind="collector",
            store=store_dir,
        )
    if rules:

        def _window_avg(series: str, window_s: float) -> "float | None":
            vals = [
                v
                for v in avg_over_time(
                    store_dir, series, window_s=window_s
                ).values()
                if v is not None
            ]
            # fleet semantics: the rule judges the worst instance — one
            # burning backend must page even if the fleet mean is fine
            return max(vals) if vals else None

        engine = SloEngine(rules, window_avg_fn=_window_avg, metrics=metrics)

    targets = discover(statusz_urls, fleetz_url, registry_dir, timeout)
    print(
        json.dumps(
            {
                "collector": True,
                "store": store_dir,
                "targets": [
                    {"name": t.name, "ops": t.base_url} for t in targets
                ],
                "interval_s": interval_s,
                "slo_rules": len(rules),
            }
        ),
        flush=True,
    )
    cycles = 0
    rc = 0
    t_start = time.monotonic()
    try:
        with HistoryStore(
            store_dir,
            segment_bytes=segment_bytes,
            retention_s=retention_s,
            retention_bytes=retention_bytes,
        ) as store:
            while count is None or cycles < count:
                if stop_check is not None and stop_check():
                    break
                cycle_start = time.monotonic()
                if cycles and rediscover_every and (
                    cycles % rediscover_every == 0
                ):
                    try:
                        targets = discover(
                            statusz_urls, fleetz_url, registry_dir, timeout
                        )
                    except (urllib.error.URLError, OSError, ValueError):
                        pass  # keep the last known set; retry next round
                summary = scrape_once(
                    store, targets, metrics=metrics, timeout=timeout
                )
                if engine is not None:
                    engine.evaluate(
                        {}, log.emit if log is not None else None
                    )
                cycles += 1
                if count is not None:
                    print(json.dumps(summary), flush=True)
                if count is None or cycles < count:
                    elapsed = time.monotonic() - cycle_start
                    time.sleep(max(interval_s - elapsed, 0.0))
    except KeyboardInterrupt:
        pass
    except Exception:
        if log is not None:
            from . import registry as run_registry

            run_registry.record(telemetry_dir, log.run_id, "failed")
            log.close()
        raise
    if log is not None:
        from . import registry as run_registry

        # rows/detections are a *stream* run's totals; a collector run
        # has neither — zeros keep the schema, `cycles` rides as extra
        log.emit(
            "run_completed",
            rows=0,
            seconds=round(time.monotonic() - t_start, 3),
            detections=0,
            cycles=cycles,
        )
        run_registry.record(telemetry_dir, log.run_id, "completed")
        log.close()
    return rc


def main(argv=None) -> int:
    """``collector``: scrape a fleet's ops planes into a history store."""
    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch collector",
        description=(
            "Scraper daemon feeding the history plane: discovers ops "
            "endpoints (explicit --statusz, a router's /fleetz, or the "
            "run registry), polls /metrics + /statusz into a "
            "telemetry.history store, optionally judging burn_rate SLO "
            "rules against it. GET-only: provably non-perturbing."
        ),
    )
    ap.add_argument("--store", required=True, help="history store directory")
    ap.add_argument(
        "--statusz",
        action="append",
        default=[],
        metavar="URL",
        help="explicit ops base (host:port or URL), repeatable",
    )
    ap.add_argument(
        "--fleetz", default=None, metavar="URL",
        help="router/scheduler ops base: scrape every backend its "
        "/fleetz lists (rows carry each backend's ops address)",
    )
    ap.add_argument(
        "--registry", default=None, metavar="DIR",
        help="telemetry dir: scrape every running kind=serve run whose "
        "registry record carries an ops address",
    )
    ap.add_argument("--interval", type=float, default=5.0, metavar="S")
    ap.add_argument(
        "--count", type=int, default=None, metavar="N",
        help="stop after N cycles (CI mode; default: run until killed)",
    )
    ap.add_argument("--timeout", type=float, default=5.0, metavar="S")
    ap.add_argument(
        "--segment-bytes", type=int, default=DEFAULT_SEGMENT_BYTES,
        help="store segment rotation size",
    )
    ap.add_argument(
        "--retention-s", type=float, default=None,
        help="drop finalized segments older than this",
    )
    ap.add_argument(
        "--retention-bytes", type=int, default=None,
        help="cap total store size (oldest finalized segments drop first)",
    )
    ap.add_argument(
        "--telemetry-dir", default=None,
        help="collector's own run log + registry (required for --slo "
        "alert events)",
    )
    ap.add_argument(
        "--slo", action="append", default=[],
        metavar="burn_rate=SERIES:OBJ:FAST/SLOW:FACTOR",
        help="burn_rate rule judged against the store each cycle "
        "(worst instance across the fleet), repeatable",
    )
    args = ap.parse_args(argv)
    if not (args.statusz or args.fleetz or args.registry):
        ap.error("no targets: give --statusz, --fleetz, and/or --registry")
    if args.slo and not args.telemetry_dir:
        ap.error("--slo needs --telemetry-dir (alerts are run-log events)")
    try:
        return run_collector(
            args.store,
            statusz_urls=args.statusz,
            fleetz_url=args.fleetz,
            registry_dir=args.registry,
            interval_s=args.interval,
            count=args.count,
            timeout=args.timeout,
            segment_bytes=args.segment_bytes,
            retention_s=args.retention_s,
            retention_bytes=args.retention_bytes,
            telemetry_dir=args.telemetry_dir,
            slo_specs=args.slo,
        )
    except ValueError as e:
        print(f"collector: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
