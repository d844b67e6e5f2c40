"""Command-line entry point of the port, mirroring the reference's argv mode.

The port's twin of the JAX package's ``__main__.py``. The reference script
accepts (commented-out but documented, README.md:11) positional arguments
``URL INSTANCES MEMORY CORES TIME_STRING MULT_DATA`` (``DDM_Process.py:15-21``),
which ``run_experiments.sh`` passes. Same contract here — the Spark-only
knobs are recorded verbatim into the results CSV for table parity — plus
an optional trailing ``DATASET``:

    python -m distributed_drift_detection_tpu_torch \\
        jax://local 16 8g 4 "$(date | sed 's/ /_/g')" 512 outdoorStream.csv

With no arguments, runs the module-default config like executing the
reference script unedited. The run is on the card; it prints the JAX
package's summary line ``rows=… detections=… mean_delay_rows=…
final_time=…``. Three flags, anywhere in argv: ``--data-policy
{strict,quarantine,repair}`` selects the ingest contract policy for dirty
CSVs (``io.sanitize``), ``--compile-cache-dir DIR`` names the directory the
hand-written kernels and the native CSV parser are built into and loaded
from (a second invocation with the same directory runs no nvcc), and
``--collect {compact,full}`` pins the collect-phase transport.

``--telemetry-dir DIR`` persists the run's JSONL run log and metric
exports and registers the run in DIR's ``index.jsonl`` (the summary line
is then followed by ``telemetry=<log>``). ``--profile-dir DIR`` captures
the whole Final Time span and ``--trace-dir DIR`` the detect phase with
``torch.profiler``: a Chrome trace in a timestamped session directory
under DIR (``plugins/profile/<time>/<host>.pt.trace.json``); the two
together fail before any work.

``--tenants N`` above 1 runs N tenants' streams as one stacked run
(``api.run_multi``) and prints a summary line a tenant, then the
aggregate.

Twenty subcommands: ``chunked`` streams a CSV through the chunked engine
(``harness.chunked_cli``, on the card or with ``--device cpu``), ``serve``
runs the serving daemon (``serve.runner``, on the card or with ``--device
cpu``; ``--on-drift retrain|shadow`` adapts a tenant after a drift),
``loadgen`` replays a stream into it (``serve.loadgen``) and ``router``
fronts a fleet of daemons (``serve.router``); only ``chunked``, ``serve``,
``heal --execute`` and the workers ``sched`` spawns run experiments, and
the rest import no torch:

    python -m distributed_drift_detection_tpu_torch chunked CSV --classes C [...]
    python -m distributed_drift_detection_tpu_torch serve --features F --classes C [...]
    python -m distributed_drift_detection_tpu_torch loadgen STREAM --port PORT [...]
    python -m distributed_drift_detection_tpu_torch router --backend HOST:PORT:OPS [...]
    python -m distributed_drift_detection_tpu_torch report <run.jsonl | --dir DIR>
    python -m distributed_drift_detection_tpu_torch perf BENCH_r*.json [...]
    python -m distributed_drift_detection_tpu_torch watch <run.jsonl | DIR> [...]
    python -m distributed_drift_detection_tpu_torch top <run.jsonl | DIR>... [--statusz URL]
    python -m distributed_drift_detection_tpu_torch pipeline <.prom | run.jsonl | URL>
    python -m distributed_drift_detection_tpu_torch history <range|rate|quantile|top-tenants> STORE [...]
    python -m distributed_drift_detection_tpu_torch collector --store DIR [--statusz URL | --fleetz URL | --registry DIR]
    python -m distributed_drift_detection_tpu_torch correlate <DIR | logs...>
    python -m distributed_drift_detection_tpu_torch timeline <DIR | logs...> [-o OUT]
    python -m distributed_drift_detection_tpu_torch explain <DIR | run.jsonl | bundle>
    python -m distributed_drift_detection_tpu_torch incident <list|show|diagnose> <DIR | run.jsonl | bundle>
    python -m distributed_drift_detection_tpu_torch doctor CSV [CSV ...]
    python -m distributed_drift_detection_tpu_torch heal SPEC --telemetry-dir DIR [...]
    python -m distributed_drift_detection_tpu_torch sched [SPEC] --telemetry-dir DIR [...]
    python -m distributed_drift_detection_tpu_torch sched-worker --connect HOST:PORT [...]
    python -m distributed_drift_detection_tpu_torch registry compact DIR [...]

The eleven readers (``report`` to ``incident``, ``telemetry/``) read the
artifacts a run, a sweep or a serving daemon of either package wrote —
run logs, metric exports, history stores, forensics and incident bundles,
bench JSON — and print what the JAX package's readers print on them, with
their exit codes; they import neither torch nor JAX, so they run on the
card's host as anywhere else. ``doctor`` validates CSV inputs against the
ingest contract and exits nonzero on violations (``io.sanitize``);
``heal`` diffs a sweep spec against the registry's completed runs and
plans, ``--execute``s or pushes to a scheduler the missing trials
(``resilience.heal``; exit 0 = sweep whole); ``sched`` is the sweep
scheduler daemon that leases cells to ``sched-worker`` agents until every
cell completed exactly once (``sched``); ``registry compact`` rewrites an
``index.jsonl`` as one record per run (``telemetry.registry``).
"""

import sys

_USAGE = (
    "usage: python -m distributed_drift_detection_tpu_torch "
    "[--trace-dir DIR] [--profile-dir DIR] [--telemetry-dir DIR] "
    "[--data-policy strict|quarantine|repair] "
    "[--compile-cache-dir DIR] [--collect compact|full] "
    "[--tenants N] "
    "[URL INSTANCES MEMORY CORES TIME_STRING MULT_DATA [DATASET]]\n"
    "       python -m distributed_drift_detection_tpu_torch chunked CSV --classes C [...]\n"
    "       python -m distributed_drift_detection_tpu_torch serve --features F --classes C [...]\n"
    "       python -m distributed_drift_detection_tpu_torch loadgen STREAM --port PORT [...]\n"
    "       python -m distributed_drift_detection_tpu_torch router --backend HOST:PORT:OPS [...]\n"
    "       python -m distributed_drift_detection_tpu_torch report RUN_JSONL [...]\n"
    "       python -m distributed_drift_detection_tpu_torch perf BENCH_JSON [...]\n"
    "       python -m distributed_drift_detection_tpu_torch watch RUN_JSONL_OR_DIR\n"
    "       python -m distributed_drift_detection_tpu_torch top DIR_OR_LOGS [--statusz URL]\n"
    "       python -m distributed_drift_detection_tpu_torch pipeline PROM_OR_LOG_OR_URL [--json]\n"
    "       python -m distributed_drift_detection_tpu_torch history QUERY STORE [SERIES] [...]\n"
    "       python -m distributed_drift_detection_tpu_torch collector --store DIR [--statusz URL ...]\n"
    "       python -m distributed_drift_detection_tpu_torch correlate DIR_OR_LOGS\n"
    "       python -m distributed_drift_detection_tpu_torch timeline DIR_OR_LOGS [-o OUT]\n"
    "       python -m distributed_drift_detection_tpu_torch explain DIR_OR_LOG_OR_BUNDLE\n"
    "       python -m distributed_drift_detection_tpu_torch incident list|show|diagnose DIR_OR_LOG_OR_BUNDLE [...]\n"
    "       python -m distributed_drift_detection_tpu_torch doctor [--jobs N] CSV [CSV ...]\n"
    "       python -m distributed_drift_detection_tpu_torch heal SPEC --telemetry-dir DIR [...]\n"
    "       python -m distributed_drift_detection_tpu_torch sched [SPEC] --telemetry-dir DIR [...]\n"
    "       python -m distributed_drift_detection_tpu_torch sched-worker --connect HOST:PORT [...]\n"
    "       python -m distributed_drift_detection_tpu_torch registry compact DIR [...]"
)

# The host-side subcommands, the JAX package's twenty: module, and whether
# the ``device`` of :func:`main` is its ``--device`` default (those that run
# experiments). A subcommand whose ``main`` returns a code exits with it.
SUBCOMMANDS = {
    "chunked": (".harness.chunked_cli", True),
    "serve": (".serve.runner", True),
    "loadgen": (".serve.loadgen", False),
    "router": (".serve.router", False),
    "doctor": (".io.sanitize", False),
    "heal": (".resilience.heal", True),
    "sched": (".sched.scheduler", True),
    "sched-worker": (".sched.worker", True),
    "registry": (".telemetry.registry", False),
    "report": (".telemetry.report", False),
    "perf": (".telemetry.perf", False),
    "watch": (".telemetry.watch", False),
    "top": (".telemetry.top", False),
    "pipeline": (".telemetry.pipeline", False),
    "history": (".telemetry.history", False),
    "collector": (".telemetry.collector", False),
    "correlate": (".telemetry.correlate", False),
    "timeline": (".telemetry.timeline", False),
    "explain": (".telemetry.forensics", False),
    "incident": (".telemetry.incident", False),
}


def _pop_flag(argv: list[str], flag: str) -> str | None:
    """Extract ``--flag VALUE`` / ``--flag=VALUE`` from argv (mutating it)."""
    for i, arg in enumerate(argv):
        if arg == flag:
            if i + 1 >= len(argv):
                raise SystemExit(f"{_USAGE}\n({flag} needs a value)")
            value = argv[i + 1]
            del argv[i : i + 2]
            return value
        if arg.startswith(flag + "="):
            del argv[i]
            return arg[len(flag) + 1 :]
    return None


def _choice(argv: list[str], flag: str, choices) -> str | None:
    value = _pop_flag(argv, flag)
    if value is not None and value not in choices:
        raise SystemExit(
            f"{_USAGE}\n({flag} must be one of {'|'.join(choices)}, got {value!r})"
        )
    return value


def main(argv: list[str], device="cuda") -> None:
    """Run the CLI on ``argv``; the run mode runs on ``device`` (the card;
    the tests pass ``device='cpu'``; the run mode has no device flag), and
    ``device`` is the ``--device`` default of ``heal``, ``sched`` and
    ``sched-worker``."""
    if argv and argv[0] in SUBCOMMANDS:
        import importlib

        module, takes_device = SUBCOMMANDS[argv[0]]
        kw = {"device": device} if takes_device else {}
        rc = importlib.import_module(module, __package__).main(argv[1:], **kw)
        if rc is not None:
            raise SystemExit(rc)
        return

    from .config import COLLECT_MODES, DATA_POLICIES

    argv = list(argv)
    kw = {}
    trace_dir = _pop_flag(argv, "--trace-dir")
    if trace_dir is not None:
        kw["trace_dir"] = trace_dir
    profile_dir = _pop_flag(argv, "--profile-dir")
    if profile_dir is not None:
        kw["profile_dir"] = profile_dir
    telemetry_dir = _pop_flag(argv, "--telemetry-dir")
    if telemetry_dir is not None:
        kw["telemetry_dir"] = telemetry_dir
    data_policy = _choice(argv, "--data-policy", DATA_POLICIES)
    if data_policy is not None:
        kw["data_policy"] = data_policy
    compile_cache_dir = _pop_flag(argv, "--compile-cache-dir")
    if compile_cache_dir is not None:
        kw["compile_cache_dir"] = compile_cache_dir
    collect = _choice(argv, "--collect", COLLECT_MODES)
    if collect is not None:
        kw["collect"] = collect
    tenants = _pop_flag(argv, "--tenants")
    if tenants is not None:
        try:
            tenants = int(tenants)
        except ValueError as e:
            raise SystemExit(f"{_USAGE}\n({e})") from None
        if tenants < 1:
            raise SystemExit(f"{_USAGE}\n(--tenants must be >= 1)")
        kw["tenants"] = tenants
    if argv and len(argv) not in (6, 7):
        raise SystemExit(_USAGE)
    if argv:
        try:
            kw.update(
                url=argv[0],
                partitions=int(argv[1]),  # reference INSTANCES
                memory=argv[2],
                cores=int(argv[3]),
                time_string=argv[4],
                mult_data=float(argv[5]),
            )
        except ValueError as e:
            raise SystemExit(f"{_USAGE}\n({e})") from None
        if len(argv) == 7:
            kw["dataset"] = argv[6]

    from .config import RunConfig

    cfg = RunConfig(**kw)
    if cfg.tenants > 1:
        # the stacked tenant plane: a line a tenant (each its solo run's),
        # then the aggregate
        from .api import run_multi

        mr = run_multi(cfg, device=device)
        for t, r in enumerate(mr.results):
            m = r.metrics
            print(
                f"tenant={t} rows={r.stream.num_rows} "
                f"detections={m.num_detections} "
                f"mean_delay_rows={m.mean_delay_rows:.1f}"
            )
        print(
            f"tenants={cfg.tenants} rows={mr.rows} "
            f"final_time={mr.total_time:.3f}s "
            f"agg_rows_per_sec={mr.agg_rows_per_sec:.1f}"
        )
        if mr.telemetry_path:
            print(f"telemetry={mr.telemetry_path}")
        return

    from .api import run

    res = run(cfg, device=device)
    m = res.metrics
    print(
        f"rows={res.stream.num_rows} detections={m.num_detections} "
        f"mean_delay_rows={m.mean_delay_rows:.1f} "
        f"final_time={res.total_time:.3f}s"
    )
    if res.telemetry_path:
        print(f"telemetry={res.telemetry_path}")


if __name__ == "__main__":
    main(sys.argv[1:])
