"""Device introspection of a telemetered run — the port's twin of the JAX
package's ``telemetry/profile.py``.

* :func:`device_memory_stats` — the card's allocator statistics
  (``torch.cuda.memory_stats``) under the keys the JAX package's readers
  use: ``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit``;
  ``None`` on the CPU, as XLA-CPU reports nothing.
* :func:`compiled_stats` — ``{"cost": None, "memory": None}``: the port
  runs no compiled XLA program, so it has no cost or memory analysis to
  report, and the JAX contract allows both halves to be ``None`` (then
  :func:`emit_compiled_events` emits nothing). No FLOP count is invented.
* emit/record helpers, copied as they are, mapping both onto the
  schema-v1 event types (``cost_analysis``, ``memory_snapshot``) and the
  registry gauges (``xla_*``, ``device_*``).

Everything here is host-side, runs only when telemetry is on, and is
called outside the Final Time span: ``api.run`` takes the memory snapshot
before the span opens and after it closes. torch is imported inside the
functions, so importing :mod:`telemetry` loads no torch.
"""

from __future__ import annotations

__all__ = [
    "compiled_stats",
    "device_memory_stats",
    "emit_compiled_events",
    "emit_device_memory_event",
    "record_compiled_gauges",
    "record_device_memory_gauges",
]


def compiled_stats(runner=None, *args, **kwargs) -> dict:
    """The compiled program's cost and memory analysis: both ``None`` —
    the port's runner is eager PyTorch and hand-written kernels, with no
    compiler analysis to read."""
    return {"cost": None, "memory": None}


def device_memory_stats(device=None) -> dict | None:
    """The card's allocator statistics as the JAX package names them:
    ``bytes_in_use`` (``allocated_bytes.all.current``),
    ``peak_bytes_in_use`` (``allocated_bytes.all.peak``) and
    ``bytes_limit`` (the card's total memory); ``None`` on the CPU or
    when the call fails."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    try:
        stats = torch.cuda.memory_stats(dev)
        limit = torch.cuda.get_device_properties(dev).total_memory
    except (RuntimeError, AssertionError):
        return None
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(limit),
    }


# -- event emission ---------------------------------------------------------


def emit_compiled_events(log, stats: dict, where: str = "detect_runner") -> None:
    """Emit one ``cost_analysis`` (+ one ``memory_snapshot`` when the
    compiler reported memory sizes) from a :func:`compiled_stats` result.
    No-op when both halves are ``None``."""
    cost, memory = stats.get("cost"), stats.get("memory")
    if cost is None and memory is None:
        return
    cost = cost or {}
    log.emit(
        "cost_analysis",
        where=where,
        flops=cost.get("flops"),
        bytes_accessed=cost.get("bytes_accessed"),
        analysis=cost or None,
    )
    if memory:
        log.emit(
            "memory_snapshot", source="memory_analysis", stats=memory,
            where=where,
        )


def emit_device_memory_event(log, stats: dict | None, when: str) -> None:
    """Emit one device ``memory_snapshot`` (no-op when the backend gave
    nothing — absence of a snapshot means "backend doesn't report", never
    a fabricated zero)."""
    if stats:
        log.emit("memory_snapshot", source="device", stats=stats, when=when)


# -- registry gauges --------------------------------------------------------


def record_compiled_gauges(registry, stats: dict) -> None:
    """Record a :func:`compiled_stats` result as ``xla_*`` gauges."""
    cost = stats.get("cost") or {}
    for key, name in (
        ("flops", "xla_flops"),
        ("bytes_accessed", "xla_bytes_accessed"),
    ):
        if cost.get(key) is not None:
            registry.gauge(
                name, help=f"XLA cost analysis: {key} per runner execution"
            ).set(cost[key])
    for key, value in (stats.get("memory") or {}).items():
        registry.gauge(
            f"xla_{key}", help=f"XLA memory analysis: {key}"
        ).set(value)


def record_device_memory_gauges(
    registry, stats: dict | None, when: str = ""
) -> None:
    """Record a device-memory snapshot as gauges (no-op on ``None``).

    ``device_bytes_in_use{when=...}`` is last-write-wins per label (the
    engines call this per chunk/leg — the gauge tracks the latest point);
    ``device_peak_bytes_in_use`` keeps the max across every call, so a
    transient allocation spike between snapshots the backend itself peaked
    on is not lost to the last-write semantics."""
    if not stats:
        return
    in_use = stats.get("bytes_in_use")
    if in_use is not None:
        g = registry.gauge(
            "device_bytes_in_use", help="Device memory in use at snapshot"
        )
        g.set(in_use, **({"when": when} if when else {}))
    peak = stats.get("peak_bytes_in_use", in_use)
    if peak is not None:
        g = registry.gauge(
            "device_peak_bytes_in_use",
            help="Max device bytes in use across snapshots",
        )
        prior = g.values.get((), float("-inf"))
        g.set(max(float(peak), prior))
