"""The merged fleet view of an aggregator — the part of the JAX package's
``telemetry/pipeline.py`` the sweep scheduler serves (``/fleetz`` and the
``fleet_*`` series of its ``/metrics``). The serve-pipeline attribution and
its CLI wait for ROADMAP A15 (and the serving daemon, A12)."""

from __future__ import annotations


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
