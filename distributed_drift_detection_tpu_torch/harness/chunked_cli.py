"""``chunked`` subcommand: drive a CSV through the streaming ingest
pipeline end to end, on the card (``--device cpu`` for the plain path).

    python -m distributed_drift_detection_tpu_torch chunked stream.csv \\
        --classes 10 --partitions 8 --per-batch 100 --chunk-batches 16 \\
        --ingest-workers 4 --data-policy quarantine --telemetry-dir DIR

The port's twin of the JAX package's ``harness/chunked_cli.py``. The batch
CLI (``python -m distributed_drift_detection_tpu_torch URL ...``) loads the
whole stream through ``api.run``; this command is the streaming twin:

    mmap'd line-aligned blocks → parse worker pool (``--ingest-workers``)
    → ordered sanitize (``--data-policy``) → pooled striper →
    ``prefetch_chunks`` producer → a prepared ``ChunkedDetector``.

Labels must already be integral in ``0..classes-1`` (the streaming reader
never re-indexes — ``io.feeder.csv_chunks``); features default to the
header's column count minus the target. With ``--telemetry-dir`` the run
emits the standard chunk/heartbeat events plus the host-ingest pipeline
gauges (``ingest_stage_busy_seconds_total{stage=...}``,
``ingest_parse_queue_depth``, ``ingest_workers``) into the run log's
metric exports, and registers as ``kind="chunked"``. The final line on
stdout is one JSON object with rows/chunks/detections/rows_per_sec and
the per-stage busy breakdown; any ``--ingest-workers`` gives the same
detections. ``--compile-cache-dir`` names the directory the kernels are
built into (``RunConfig.compile_cache_dir``). ``--trace-sample RATE``
head-samples chunks for ``ingest`` and ``kernel`` spans in the run log
(``telemetry.tracing``; needs ``--telemetry-dir``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None, device="cuda") -> None:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch chunked",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("csv", help="CSV path (named header incl. the target)")
    ap.add_argument(
        "--classes", type=int, required=True,
        help="label domain 0..C-1 (the streaming reader cannot re-index)",
    )
    ap.add_argument(
        "--features", type=int, default=0,
        help="feature count (default: header columns minus the target)",
    )
    ap.add_argument("--target-column", default="target")
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--per-batch", type=int, default=100)
    ap.add_argument("--chunk-batches", type=int, default=8)
    ap.add_argument(
        "--window", type=int, default=8,
        help="speculative window width (explicit — auto needs planted "
        "geometry a raw CSV does not declare)",
    )
    ap.add_argument("--model", default="centroid")
    ap.add_argument("--detector", default="ddm")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--ingest-workers", type=int, default=0,
        help="parse worker fan-out (0 = auto; any count is bit-identical)",
    )
    ap.add_argument(
        "--block-bytes", type=int, default=16 << 20,
        help="parse block size in bytes (default 16 MiB)",
    )
    ap.add_argument(
        "--data-policy", choices=("strict", "quarantine", "repair"),
        default=None,
        help="ingest contract policy (default: trusting parse)",
    )
    ap.add_argument(
        "--quarantine-path", default="",
        help="quarantine sidecar path (default: per-run next to the run "
        "log when telemetered, <csv>.quarantine.jsonl otherwise)",
    )
    ap.add_argument("--telemetry-dir", default=None)
    ap.add_argument(
        "--compile-cache-dir", default="",
        help="directory the kernels are built into and loaded from",
    )
    ap.add_argument(
        "--trace-sample", type=float, default=0.0,
        help="head-sample chunks at this rate for ingest/kernel trace "
        "spans in the run log (telemetry.tracing; needs --telemetry-dir; "
        "0 = off, zero hot-path work)",
    )
    ap.add_argument("--device", default=device, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    with open(args.csv) as fh:
        header = fh.readline().strip().split(",")
    if args.target_column not in header:
        raise SystemExit(
            f"chunked: target column {args.target_column!r} not in header; "
            f"columns found: {header}"
        )
    features = args.features or (len(header) - 1)

    from ..api import _telemetry_bracket, prepare_chunked
    from ..config import RunConfig, telemetry_config_payload
    from ..config import host_shuffle_seed as _shuffle
    from ..io.feeder import (
        csv_chunks,
        prefetch_chunks,
        resolve_ingest_workers,
        stage_breakdown,
    )
    from ..telemetry.metrics import MetricsRegistry, write_exports

    cfg = RunConfig(
        dataset=args.csv,
        partitions=args.partitions,
        per_batch=args.per_batch,
        model=args.model,
        detector=args.detector,
        window=args.window,
        seed=args.seed,
        data_policy=args.data_policy or "strict",
        quarantine_path=args.quarantine_path,
        telemetry_dir=args.telemetry_dir,
        ingest_workers=args.ingest_workers,
        compile_cache_dir=args.compile_cache_dir,
        results_csv="",
    )
    workers = resolve_ingest_workers(cfg.ingest_workers)
    reg = MetricsRegistry()
    # ingest_workers stays OUT of the digested payload — execution knob,
    # not experiment identity (config.py's contract; any worker count is
    # bit-identical); it rides the run_completed extras + summary instead.
    payload = telemetry_config_payload(cfg)
    # cfg.data_policy has no "no policy" value; record what actually ran —
    # None = trusting parse (distinct from strict in the log AND the
    # digest; telemetry_config_payload omits the strict default).
    if args.data_policy is None:
        payload["data_policy"] = None
    with _telemetry_bracket(cfg, payload, kind="chunked") as log:
        # Prepare inside the bracket: a prepare-time crash must leave the
        # failed registry record.
        det, compile_info = prepare_chunked(
            cfg, features, args.classes, chunk_batches=args.chunk_batches,
            device=args.device,
        )
        sidecar = args.quarantine_path
        if not sidecar:
            sidecar = (
                log.path[: -len(".jsonl")] + ".quarantine.jsonl"
                if log is not None
                else args.csv + ".quarantine.jsonl"
            )
        tracer = None
        if args.trace_sample > 0 and log is not None:
            from ..telemetry.tracing import ChunkTracer

            # one tracer for both pipeline halves: the ingest span and
            # the kernel span of a chunk share one trace
            tracer = ChunkTracer(log, rate=args.trace_sample, seed=args.seed)
        chunks = prefetch_chunks(
            csv_chunks(
                args.csv,
                args.partitions,
                args.per_batch,
                args.chunk_batches,
                target_column=args.target_column,
                shuffle_seed=_shuffle(cfg),
                block_bytes=args.block_bytes,
                metrics=reg,
                data_policy=args.data_policy,
                quarantine_path=sidecar,
                workers=workers,
                num_classes=args.classes,
                tracer=tracer,
            ),
            depth=2,
            metrics=reg,
        )
        t0 = time.perf_counter()
        flags = det.run(chunks, telemetry=log, metrics=reg, tracer=tracer)
        span = time.perf_counter() - t0

        import numpy as np

        detections = int((np.asarray(flags.change_global) >= 0).sum())
        rows = int(reg.counter("ingest_rows_total").values.get((), 0))
        n_chunks = int(reg.counter("ingest_chunks_total").values.get((), 0))
        quarantined = int(
            reg.counter("ingest_quarantined_total").values.get((), 0)
        )
        pipeline_s = stage_breakdown(reg)
        if log is not None:
            from ..telemetry import registry as run_registry

            log.emit(
                "run_completed",
                rows=rows,
                seconds=span,
                detections=detections,
                rows_per_sec=rows / span if span > 0 else None,
                ingest_workers=workers,
            )
            run_registry.record(cfg.telemetry_dir, log.run_id, "completed")
            import os

            write_exports(reg, os.path.splitext(log.path)[0])
    print(
        json.dumps(
            {
                "rows": rows,
                "chunks": n_chunks,
                "detections": detections,
                "quarantined": quarantined,
                "rows_per_sec": round(rows / span, 1) if span > 0 else None,
                "time_s": round(span, 4),
                "ingest_workers": workers,
                "pipeline_s": pipeline_s,
                "aot_seconds": round(compile_info.get("aot_seconds", 0.0), 4),
                "telemetry": log.path if log is not None else None,
            }
        )
    )


if __name__ == "__main__":
    main(sys.argv[1:])
