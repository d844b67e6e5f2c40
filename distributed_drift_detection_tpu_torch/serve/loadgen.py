"""Load generator + latency SLO probe for the serving daemon.

The port's own copy of the JAX package's ``serve/loadgen.py``; it drives
the daemon of either package, or a fleet through either package's router.

    python -m distributed_drift_detection_tpu_torch loadgen synth:rialto,seed=0 \\
        --port 7007 --rows 4000 --rate 2000 --dir runs/live [...]

Replays a stream — an ``io.synth`` spec (``synth:rialto,...``) or a CSV
file — over the serve ingress at a target sustained rate, with
optional seeded dirty-row injection through the same
``resilience.faults.corrupt_lines`` helper the batch fault site uses
(``--dirty nan_cell:5:7`` corrupts 5 seeded rows), then tails the
daemon's verdict sidecar and reports **achieved rows/s plus p50/p99
row→verdict latency** as one JSON line — the SLO evidence ``bench.py
--serve`` records and the ``perf`` CLI tracks informationally.

``--wire v2`` replays the same rows as **binary columnar frames**
(``serve.wire``, ``--frame-rows`` rows each) instead of text lines —
the device-speed admission path. Latency attribution is identical
(verdict ``rows_through`` keys both protocols), ``--dirty`` corrupts
the same seeded stream positions via columnar stand-ins
(:func:`apply_dirty_frames`), and a multi-tenant replay deals the same
round-robin blocks with the tenant id carried in each frame header.

Tracing: ``--trace-sample R`` head-samples the replay at rate R — each
sampled row is preceded by a ``TRACE <trace_id> <span_id>`` wire line
(telemetry.tracing), so the daemon attaches its serving span chain to
the client's trace and the verdict record lists the trace ids. With
``--dir`` the loadgen also writes its own run log into the telemetry
directory with one root ``ingress`` span per sampled-and-covered row
(send → verdict observed), so the ``timeline`` CLI merges client and
daemon into one end-to-end trace.

Latency attribution: every verdict record carries ``rows_through`` — the
cumulative count of admitted rows up to and including its microbatch —
and rows are admitted in arrival order, so sent row *i*'s verdict is the
first record with ``rows_through > i``. Its latency is the verdict's
publication wall-clock minus the row's send wall-clock (same host for
generator and daemon in every supported deployment of this probe).
Under ``strict`` with dirty traffic rejected rows shift the mapping —
drive dirty SLO runs under ``quarantine``/``repair`` (rows keep their
positions; the loadgen default matches the daemon's).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

import numpy as np

from . import wire


def load_source(
    spec: str, target_column: str = "target"
) -> tuple[np.ndarray, np.ndarray, int]:
    """Resolve a stream source to ``(X, y, num_classes)`` with labels
    re-indexed to ``0..C-1`` (the serve ingress contract — a daemon
    cannot re-index, so the generator does)."""
    if spec.startswith("synth:"):
        from ..io.synth import parse_synth

        X, y = parse_synth(spec[len("synth:"):])
    else:
        from ..io.stream import load_csv

        X, y = load_csv(spec, target_column)
    classes, y_idx = np.unique(y, return_inverse=True)
    return (
        np.ascontiguousarray(X, np.float32),
        y_idx.astype(np.int32),
        len(classes),
    )


def format_lines(X: np.ndarray, y: np.ndarray) -> list[str]:
    """Rows → protocol CSV lines (label last). ``repr(float(v))``
    round-trips every f32 exactly through the daemon's parser, so a
    clean replay is bit-identical to feeding the arrays directly."""
    return [
        ",".join(repr(float(v)) for v in row) + f",{int(label)}"
        for row, label in zip(X, y)
    ]


def apply_dirty(
    lines: list[str], spec: str
) -> list[tuple[int, int]]:
    """Apply one ``--dirty kind[:rows[:seed]]`` spec in place via
    ``resilience.faults.corrupt_lines``; returns the corrupted
    ``(row, column)`` pairs."""
    from ..resilience.faults import corrupt_lines

    parts = spec.split(":")
    kind = parts[0]
    rows = int(parts[1]) if len(parts) > 1 else 1
    seed = int(parts[2]) if len(parts) > 2 else 0
    return corrupt_lines(lines, kind, rows=rows, seed=seed, label_col=-1)


def apply_dirty_frames(
    X: np.ndarray, y: np.ndarray, spec: str
) -> list[tuple[int, int]]:
    """The ``--wire v2`` twin of :func:`apply_dirty`: corrupt the replay
    *arrays* in place with the SAME seeded row/column selection as
    ``resilience.faults.corrupt_lines`` (the shared
    ``corrupt_row_indices``/``corrupt_cell_column`` helpers), so a v1
    and a v2 replay of one ``--dirty`` spec dirty the same stream
    positions and their quarantine masks — hence their drift verdicts —
    stay bit-identical.

    A binary columnar frame cannot express text-only dirt, so two kinds
    use **columnar stand-ins** that hit the same contract clause class:
    ``bad_label`` (v1: non-integral label) and any dirt landing on the
    label column become an out-of-domain label (``-1``; i32 labels are
    integral by construction), and ``ragged_row`` becomes a whole-row
    NaN fill + bad label (a frame is rectangular by construction). Under
    ``quarantine``/``strict`` the affected rows resolve identically to
    v1 (masked / rejected at the same positions); under ``repair`` the
    v1 kinds may repair where the stand-ins quarantine — drive dirty
    cross-protocol parity runs under ``quarantine`` (the default).
    """
    from ..resilience.faults import (
        CORRUPTION_KINDS,
        corrupt_cell_column,
        corrupt_row_indices,
    )

    parts = spec.split(":")
    kind = parts[0]
    rows = int(parts[1]) if len(parts) > 1 else 1
    seed = int(parts[2]) if len(parts) > 2 else 0
    if kind not in CORRUPTION_KINDS:
        raise ValueError(
            f"unknown corruption kind {kind!r}; expected one of "
            f"{sorted(CORRUPTION_KINDS)}"
        )
    n = len(y)
    if n == 0:
        return []
    num_fields = X.shape[1] + 1  # corrupt_lines sees F+1 CSV fields
    label_col = X.shape[1]
    out: list[tuple[int, int]] = []
    for k, r in enumerate(corrupt_row_indices(kind, n, rows, seed)):
        if kind == "ragged_row":
            X[r, :] = np.nan
            y[r] = -1
            out.append((r, -1))
        elif kind == "bad_label":
            y[r] = -1
            out.append((r, label_col))
        else:  # nan_cell
            c = corrupt_cell_column(kind, seed, k, num_fields)
            if c == label_col:
                y[r] = -1
            else:
                X[r, c] = np.nan
            out.append((r, c))
    return out


def sample_traces(
    n: int, rate: float, seed: "int | None" = 0
) -> "dict[int, tuple[str, str]]":
    """Head-sample a replay: row index → fresh ``(trace_id, span_id)``
    root context for each sampled row. Empty at rate 0 (no work)."""
    if rate <= 0.0 or n <= 0:
        return {}
    from ..telemetry.tracing import HeadSampler

    s = HeadSampler(rate, seed=seed)
    return {i: s.new_context() for i in s.sample_block(n)}


def _stamp_lines(
    lines: list[str], trace_ctx: "dict[int, tuple[str, str]]"
) -> list[str]:
    """Prefix each sampled row's wire payload with its TRACE directive
    (one list element stays one data row — pacing math is unchanged)."""
    if not trace_ctx:
        return lines
    return [
        (
            f"TRACE {trace_ctx[i][0]} {trace_ctx[i][1]}\n{ln}"
            if i in trace_ctx
            else ln
        )
        for i, ln in enumerate(lines)
    ]


def _emit_client_spans(
    trace_log,
    trace_ctx: "dict[int, tuple[str, str]]",
    send_ts: np.ndarray,
    verdict_ts: "dict[int, float]",
) -> int:
    """Root ``ingress`` spans (send → verdict observed) for every
    sampled row the verdict stream covered; returns the count."""
    if trace_log is None or not trace_ctx:
        return 0
    from ..telemetry.tracing import emit_span

    n = 0
    for i in sorted(trace_ctx):
        end = verdict_ts.get(i)
        if end is None:
            continue
        tid, sid = trace_ctx[i]
        emit_span(
            trace_log,
            name="ingress",
            trace_id=tid,
            span_id=sid,
            parent_id=None,
            start_ts=float(send_ts[i]),
            dur_s=end - float(send_ts[i]),
            row=i,
        )
        n += 1
    return n


def adapt_attribution(
    verdict_records: "list[dict]", events: "list[dict]"
) -> dict:
    """Attribute refit latency from a replay's artifacts: verdict
    records carry each chunk's publication wall-clock, ``adaptation``
    events carry the trigger chunk and their own stamp — the delta is
    the drift→adaptation latency a client experiences. Returns the
    summary-JSON fields (Nones when nothing adapted)."""
    by_chunk: dict[int, float] = {}
    for r in verdict_records:
        by_chunk.setdefault(int(r["chunk"]), float(r["ts"]))
    lat_ms, row_spans = [], []
    for e in events:
        if e.get("type") != "adaptation":
            continue
        t0 = by_chunk.get(int(e["trigger_chunk"]))
        if t0 is not None:
            lat_ms.append((float(e["ts"]) - t0) * 1000.0)
        if e.get("rows_to_apply") is not None:
            row_spans.append(int(e["rows_to_apply"]))
    n = sum(1 for e in events if e.get("type") == "adaptation")
    return {
        "adaptations": n,
        "adapt_promoted": sum(
            1
            for e in events
            if e.get("type") == "adaptation" and e.get("promoted")
        ),
        "adapt_latency_ms_p50": (
            round(float(np.percentile(lat_ms, 50)), 2) if lat_ms else None
        ),
        "adapt_rows_to_apply_p50": (
            float(np.percentile(row_spans, 50)) if row_spans else None
        ),
    }


class _FleetVerdictTail:
    """Verdict tailing over a FLEET: every ``*.verdicts.jsonl`` under
    each given telemetry directory (one per backend daemon), discovered
    live — a failover's landing daemon may open its sidecar mid-replay.
    Merged per poll; per-tenant attribution joins on each record's
    GLOBAL tenant id, so one summary covers the whole fleet (``loadgen
    --router``)."""

    def __init__(self, dirs):
        self.dirs = list(dirs)
        self._tails: "dict[str, _VerdictTail]" = {}

    def poll(self) -> list[dict]:
        import glob as _glob

        out: list[dict] = []
        for d in self.dirs:
            for path in _glob.glob(os.path.join(d, "*.verdicts.jsonl")):
                tail = self._tails.get(path)
                if tail is None:
                    tail = self._tails[path] = _VerdictTail(path)
                out.extend(tail.poll())
        return out


class _VerdictTail:
    """Incremental verdict-sidecar reader (torn-tail tolerant: the offset
    only advances past complete lines, like ``telemetry.watch.LogTail``)."""

    def __init__(self, path: str):
        self.path = path
        self._offset = 0

    def poll(self) -> list[dict]:
        if not os.path.exists(self.path):
            return []
        with open(self.path, "rb") as fh:
            fh.seek(self._offset)
            blob = fh.read()
        end = blob.rfind(b"\n")
        if end < 0:
            return []
        chunk = blob[: end + 1]
        self._offset += end + 1
        out = []
        for line in chunk.decode("utf-8", errors="replace").splitlines():
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if isinstance(rec, dict) and rec.get("kind") == "verdict":
                out.append(rec)
        return out


def _connect(host: str, port: int, timeout: float) -> socket.socket:
    deadline = time.monotonic() + timeout
    while True:
        try:
            return socket.create_connection((host, port), timeout=5)
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.05)


def _send_rows(
    sock: socket.socket,
    lines: list[str],
    rate: float,
    batch: int = 256,
    label_lag: int = 0,
) -> np.ndarray:
    """Send data lines paced to ``rate`` rows/s (0 = as fast as the
    socket takes them); returns per-row send wall-clock stamps.

    ``label_lag`` is the delayed-labels replay mode (``--delayed-labels
    K``): a labeled row can only enter the wire once its label exists,
    and the label of row *i* "arrives" with the generation of row
    ``i + K`` — so row *i* ships at row ``i + K``'s pace slot, a
    constant lag of ``K / rate`` seconds between a feature vector's
    nominal arrival and its labeled admission. Pacing-only (needs
    ``rate > 0``); stream order is unchanged, so verdict attribution and
    the positional admission contract are untouched."""
    send_ts = np.empty(len(lines), np.float64)
    start = time.monotonic()
    i = 0
    while i < len(lines):
        if rate > 0:
            due = int((time.monotonic() - start) * rate) + 1 - label_lag
            if due <= i:
                time.sleep(min(0.002, 1.0 / rate))
                continue
            j = min(len(lines), i + min(batch, due - i))
        else:
            j = min(len(lines), i + batch)
        sock.sendall(("\n".join(lines[i:j]) + "\n").encode())
        send_ts[i:j] = time.time()
        i = j
    return send_ts


def _send_frames(
    sock: socket.socket,
    X: np.ndarray,
    y: np.ndarray,
    rate: float,
    frame_rows: int = 1024,
    label_lag: int = 0,
    tenant: int = 0,
) -> np.ndarray:
    """Send the replay as v2 binary frames of up to ``frame_rows`` rows,
    paced to ``rate`` rows/s (0 = as fast as the socket takes them);
    returns per-row send wall-clock stamps. The frame-batched twin of
    :func:`_send_rows` — same pacing math, same ``label_lag`` delayed-
    labels shift, so latency attribution is identical across protocols."""
    n = len(y)
    send_ts = np.empty(n, np.float64)
    start = time.monotonic()
    i = 0
    while i < n:
        if rate > 0:
            due = int((time.monotonic() - start) * rate) + 1 - label_lag
            if due <= i:
                time.sleep(min(0.002, 1.0 / rate))
                continue
            j = min(n, i + min(frame_rows, due - i))
        else:
            j = min(n, i + frame_rows)
        sock.sendall(wire.encode_frame(X[i:j], y[i:j], tenant=tenant))
        send_ts[i:j] = time.time()
        i = j
    return send_ts


def _stage_split(covering: "list[dict]") -> "dict | None":
    """Row→verdict latency split by serve stage, joined from the
    covering verdict records' own stage stamps (``record['lat_ms']``,
    written by the serve runner for every chunk): per-component
    p50/p99 ms over the covered rows, each row weighted by its
    covering record. ``None`` when no record carries stamps (a
    pre-observatory daemon's sidecar) — the summary stays
    end-to-end-only there, exactly as before. This makes client-side
    attribution cross-checkable against the daemon's busy accounting:
    the dominant component here should name the same stage the
    ``pipeline`` report blames."""
    stages: "dict[str, list[float]]" = {}
    for r in covering:
        lm = r.get("lat_ms")
        if not lm:
            continue
        for k, v in lm.items():
            stages.setdefault(k, []).append(float(v))
    if not stages:
        return None
    return {
        k: {
            "p50": round(float(np.percentile(v, 50)), 3),
            "p99": round(float(np.percentile(v, 99)), 3),
        }
        for k, v in sorted(stages.items())
    }


def _run_loadgen_tenants(
    host: str,
    port: int,
    lines: list[str],
    tenants: int,
    *,
    rate: float = 0.0,
    verdicts: "str | None" = None,
    timeout: float = 60.0,
    flush: bool = True,
    stop: bool = False,
    connect_timeout: float = 30.0,
    expect_rows: "int | None" = None,
    interleave: int = 64,
    trace_ctx: "dict[int, tuple[str, str]] | None" = None,
    trace_log=None,
    label_lag: int = 0,
    wire_version: str = "v1",
    arrays=None,
    fleet_dirs=None,
    weights=None,
) -> dict:
    """Multi-tenant replay: the stream is dealt round-robin (blocks of
    ``interleave`` rows) across T tenant slots over ONE connection, with
    ``TENANT k`` protocol lines routing each block — the interleaved
    traffic shape a real multi-tenant ingress sees. Latency attribution
    is per tenant: a verdict record's ``tenants[k].rows_through`` maps
    tenant k's sent rows exactly as ``rows_through`` does on a solo
    daemon; the pooled per-row latencies feed one p50/p99 pair (the SLO
    covers the plane, not one tenant). ``wire_version='v2'`` ships each
    dealt block as ONE binary frame carrying its tenant id (the frame
    header routes instead of a TENANT line) — identical dealing, so
    per-tenant streams match the v1 replay row for row.

    ``fleet_dirs`` is the router posture (``loadgen --router``): the
    replay's TENANT ids are GLOBAL (the router rewrites them to backend
    slots), verdict tailing merges every sidecar under each backend's
    telemetry directory (:class:`_FleetVerdictTail`), and attribution
    joins on each record entry's global ``id`` — a migrated tenant's
    verdicts continue its ``rows_through`` sequence from the landing
    daemon's sidecar, so one summary covers the whole fleet with the
    per-tenant latency math unchanged.

    ``weights`` (len T, positive) skews the dealing: blocks go to
    tenants by smooth weighted round-robin — fully deterministic (same
    weights → same dealing, so parity runs stay reproducible), with
    tenant t receiving a ``weights[t]/sum(weights)`` share of blocks.
    The Zipf-ish traffic split the history plane's hotness ranking is
    validated against. ``None`` = the uniform round-robin of old."""
    global_ids = fleet_dirs is not None
    if weights is not None:
        if len(weights) != tenants or any(w <= 0 for w in weights):
            raise ValueError(
                f"tenant weights must be {tenants} positive numbers, "
                f"got {weights!r}"
            )

    def _key(ent) -> int:
        # fleet join key: the record entry's GLOBAL tenant id (== the
        # slot index off-fleet; vacant spares carry id -1 → filtered)
        return int(ent.get("id", ent["tenant"])) if global_ids else int(
            ent["tenant"]
        )
    n_rows = len(arrays[1]) if wire_version == "v2" else len(lines)
    # Deal rows into tenant streams (round-robin blocks) and build the
    # wire segments: (tenant, [row indices]) in send order.
    streams: list[list[int]] = [[] for _ in range(tenants)]
    segments: list[tuple[int, list[int]]] = []
    wrr = [0.0] * tenants  # smooth-WRR credit (weights mode only)
    w_total = float(sum(weights)) if weights is not None else 0.0
    for base in range(0, n_rows, interleave):
        if weights is None:
            t = (base // interleave) % tenants
        else:
            # smooth weighted round-robin (nginx's): every tenant gains
            # its weight in credit, the richest takes the block and pays
            # the total back — deterministic, maximally interleaved
            for i in range(tenants):
                wrr[i] += float(weights[i])
            t = max(range(tenants), key=lambda i: (wrr[i], -i))
            wrr[t] -= w_total
        idx = list(range(base, min(base + interleave, n_rows)))
        streams[t].extend(idx)
        segments.append((t, idx))
    tail = (
        _FleetVerdictTail(fleet_dirs)
        if fleet_dirs
        else _VerdictTail(verdicts) if verdicts else None
    )
    baselines = [0] * tenants
    if tail is not None:
        for rec in tail.poll():
            for ent in rec.get("tenants") or []:
                k = _key(ent)
                if 0 <= k < tenants:
                    baselines[k] = max(
                        baselines[k], int(ent["rows_through"])
                    )
    stamped = (
        _stamp_lines(lines, trace_ctx or {}) if wire_version == "v1" else None
    )
    sock = _connect(host, port, connect_timeout)
    send_ts = np.empty(n_rows, np.float64)
    sent_so_far = 0
    try:
        t0 = time.monotonic()
        for t, idx in segments:
            if rate > 0:
                # label_lag: same delayed-labels pace shift as _send_rows
                while sent_so_far + label_lag > (time.monotonic() - t0) * rate:
                    time.sleep(min(0.002, 1.0 / rate))
            if wire_version == "v2":
                X, y = arrays
                sock.sendall(
                    wire.encode_frame(X[idx], y[idx], tenant=t)
                )
            else:
                payload = (
                    f"TENANT {t}\n"
                    + "\n".join(stamped[i] for i in idx)
                    + "\n"
                )
                sock.sendall(payload.encode())
            send_ts[idx] = time.time()
            sent_so_far += len(idx)
        sent_span = time.monotonic() - t0
        if flush:
            sock.sendall(
                wire.encode_flush() if wire_version == "v2" else b"FLUSH\n"
            )
        if stop:
            sock.sendall(
                wire.encode_stop() if wire_version == "v2" else b"STOP\n"
            )
    finally:
        sock.close()
    sent = n_rows
    expects = [b + len(s) for b, s in zip(baselines, streams)]
    # expect_rows (same contract as the solo path): override how many
    # TOTAL rows the verdict stream must cover before the probe stops
    # waiting — e.g. a strict-policy replay whose rejected rows can never
    # be covered.
    expect_total = (
        sum(baselines) + expect_rows if expect_rows is not None else None
    )
    records: list[dict] = []
    covered = list(baselines)
    timed_out = False

    def _pending() -> bool:
        if expect_total is not None:
            return sum(covered) < expect_total
        return any(c < e for c, e in zip(covered, expects))

    if tail is not None:
        deadline = time.monotonic() + timeout
        while _pending():
            fresh = tail.poll()
            if fresh:
                records.extend(fresh)
                for rec in fresh:
                    for ent in rec.get("tenants") or []:
                        k = _key(ent)
                        if 0 <= k < tenants:
                            covered[k] = max(
                                covered[k], int(ent["rows_through"])
                            )
                continue
            if time.monotonic() >= deadline:
                timed_out = True
                break
            time.sleep(0.02)
    lat_ms: list[float] = []
    per_tenant_covered = [0] * tenants
    verdict_ts: dict[int, float] = {}
    covering: list[dict] = []  # one record per covered row (stage split)
    if records:
        for t in range(tenants):
            entries = [
                (int(e["rows_through"]), float(r["ts"]), r)
                for r in records
                for e in (r.get("tenants") or [])
                if _key(e) == t
            ]
            if not entries or not streams[t]:
                continue
            entries.sort(key=lambda x: x[:2])
            throughs = np.array([x for x, _, _ in entries])
            ts = np.array([x for _, x, _ in entries])
            pos = baselines[t] + np.arange(len(streams[t]))
            idx = np.searchsorted(throughs, pos, side="right")
            ok = idx < len(entries)
            per_tenant_covered[t] = int(ok.sum())
            row_ids = np.asarray(streams[t])[ok]
            lat_ms.extend(
                ((ts[idx[ok]] - send_ts[row_ids]) * 1000.0).tolist()
            )
            covering.extend(entries[i][2] for i in idx[ok])
            if trace_ctx:
                for rid, vts in zip(row_ids, ts[idx[ok]]):
                    if int(rid) in trace_ctx:
                        verdict_ts[int(rid)] = float(vts)
    _emit_client_spans(trace_log, trace_ctx or {}, send_ts, verdict_ts)
    return {
        "rows_traced": len(trace_ctx or {}),
        "traces_covered": len(verdict_ts),
        "rows_sent": sent,
        "rows_covered": len(lat_ms),
        "tenants": tenants,
        "tenant_rows_sent": [len(s) for s in streams],
        "tenant_rows_covered": per_tenant_covered,
        "verdicts": len(records),
        "detections": sum(int(r["detections"]) for r in records),
        "achieved_rows_per_sec": (
            round(sent / sent_span, 1) if sent_span > 0 else None
        ),
        "target_rows_per_sec": rate or None,
        "p50_ms": (
            round(float(np.percentile(lat_ms, 50)), 2) if lat_ms else None
        ),
        "p99_ms": (
            round(float(np.percentile(lat_ms, 99)), 2) if lat_ms else None
        ),
        "mean_ms": round(float(np.mean(lat_ms)), 2) if lat_ms else None,
        "stage_ms": _stage_split(covering),
        "timeout": timed_out,
    }


def run_loadgen(
    host: str,
    port: int,
    lines: list[str],
    *,
    rate: float = 0.0,
    verdicts: "str | None" = None,
    timeout: float = 60.0,
    flush: bool = True,
    stop: bool = False,
    connect_timeout: float = 30.0,
    expect_rows: "int | None" = None,
    tenants: int = 1,
    trace_sample: float = 0.0,
    trace_seed: int = 0,
    trace_log=None,
    label_lag: int = 0,
    wire_version: str = "v1",
    arrays=None,
    frame_rows: int = 1024,
    fleet_dirs=None,
    tenant_weights=None,
) -> dict:
    """Drive one replay and measure the SLO (see module docstring).
    ``expect_rows`` overrides how many admitted rows the verdict stream
    must cover before the probe stops waiting (default: all sent).
    ``tenants > 1`` deals the stream round-robin across tenant slots of a
    multi-tenant daemon (``TENANT`` protocol lines) with per-tenant
    latency attribution — see :func:`_run_loadgen_tenants`.
    ``trace_sample``/``trace_seed`` head-sample the replay (TRACE wire
    stamps, telemetry.tracing); ``trace_log`` (an ``EventLog``) receives
    one root ``ingress`` span per sampled-and-covered row.
    ``label_lag`` replays with labels arriving K rows late (see
    :func:`_send_rows`) — the realistic shape adaptation refits are
    exercised under. ``wire_version='v2'`` replays as binary columnar
    frames of ``frame_rows`` rows (``serve.wire``): ``arrays=(X, y)``
    supplies the row data (``lines`` may be None), verdict attribution
    is unchanged (``rows_through`` keys both protocols identically).
    ``fleet_dirs`` (``--router``) replays through a router endpoint:
    TENANT ids are GLOBAL, verdicts are tailed from EVERY sidecar under
    each backend's telemetry directory and attribution joins on the
    records' global tenant ids — one summary for the whole fleet."""
    if wire_version not in ("v1", "v2"):
        raise ValueError(f"wire_version must be 'v1' or 'v2', got {wire_version!r}")
    if wire_version == "v2":
        if arrays is None:
            raise ValueError("wire_version='v2' needs arrays=(X, y)")
        if trace_sample > 0:
            # TRACE stamps are text-protocol lines; the v2 trace source
            # is the daemon-side sampler (ServeParams.trace_sample).
            raise ValueError(
                "client-side trace sampling needs wire_version='v1'"
            )
    n_rows = len(arrays[1]) if wire_version == "v2" else len(lines)
    trace_ctx = sample_traces(
        n_rows if wire_version == "v1" else 0, trace_sample, trace_seed
    )
    if tenant_weights is not None and tenants <= 1:
        raise ValueError("tenant_weights needs tenants > 1")
    if tenants > 1:
        return _run_loadgen_tenants(
            host, port, lines, tenants,
            rate=rate, verdicts=verdicts, timeout=timeout, flush=flush,
            stop=stop, connect_timeout=connect_timeout,
            expect_rows=expect_rows, trace_ctx=trace_ctx,
            trace_log=trace_log, label_lag=label_lag,
            wire_version=wire_version, arrays=arrays,
            fleet_dirs=fleet_dirs, weights=tenant_weights,
        )
    tail = (
        _FleetVerdictTail(fleet_dirs)
        if fleet_dirs
        else _VerdictTail(verdicts) if verdicts else None
    )
    baseline = 0
    if tail is not None:
        # Rows already verdicted by earlier traffic (a warm daemon):
        # this replay's row i sits at admitted position baseline + i.
        for rec in tail.poll():
            baseline = max(baseline, int(rec["rows_through"]))
    sock = _connect(host, port, connect_timeout)
    try:
        t0 = time.monotonic()
        if wire_version == "v2":
            send_ts = _send_frames(
                sock, arrays[0], arrays[1], rate,
                frame_rows=frame_rows, label_lag=label_lag,
            )
        else:
            send_ts = _send_rows(
                sock, _stamp_lines(lines, trace_ctx), rate,
                label_lag=label_lag,
            )
        sent_span = time.monotonic() - t0
        if flush:
            sock.sendall(
                wire.encode_flush() if wire_version == "v2" else b"FLUSH\n"
            )
        if stop:
            sock.sendall(
                wire.encode_stop() if wire_version == "v2" else b"STOP\n"
            )
    finally:
        sock.close()
    sent = n_rows
    expect = baseline + (expect_rows if expect_rows is not None else sent)
    records: list[dict] = []
    covered = baseline
    timed_out = False
    if tail is not None:
        deadline = time.monotonic() + timeout
        while covered < expect:
            fresh = tail.poll()
            if fresh:
                records.extend(fresh)
                covered = max(covered, *(int(r["rows_through"]) for r in fresh))
                continue
            if time.monotonic() >= deadline:
                timed_out = True
                break
            time.sleep(0.02)
    lat_ms: list[float] = []
    verdict_ts: dict[int, float] = {}
    covering: list[dict] = []  # one record per covered row (stage split)
    if records:
        recs = sorted(records, key=lambda r: int(r["rows_through"]))
        throughs = np.array([int(r["rows_through"]) for r in recs])
        ts = np.array([float(r["ts"]) for r in recs])
        pos = baseline + np.arange(sent)
        idx = np.searchsorted(throughs, pos, side="right")
        ok = idx < len(recs)
        lat_ms = ((ts[idx[ok]] - send_ts[ok]) * 1000.0).tolist()
        covering = [recs[i] for i in idx[ok]]
        if trace_ctx:
            covered_rows = np.nonzero(ok)[0]
            for rid, vts in zip(covered_rows, ts[idx[ok]]):
                if int(rid) in trace_ctx:
                    verdict_ts[int(rid)] = float(vts)
    _emit_client_spans(trace_log, trace_ctx, send_ts, verdict_ts)
    report = {
        "rows_sent": sent,
        "rows_traced": len(trace_ctx),
        # traces whose verdict the probe actually observed (== rows_traced
        # on a fully-covered replay); client root spans are emitted for
        # exactly these when a trace_log is given
        "traces_covered": len(verdict_ts),
        "rows_covered": len(lat_ms),
        "verdicts": len(records),
        "detections": sum(int(r["detections"]) for r in records),
        "achieved_rows_per_sec": (
            round(sent / sent_span, 1) if sent_span > 0 else None
        ),
        "target_rows_per_sec": rate or None,
        "p50_ms": round(float(np.percentile(lat_ms, 50)), 2) if lat_ms else None,
        "p99_ms": round(float(np.percentile(lat_ms, 99)), 2) if lat_ms else None,
        "mean_ms": round(float(np.mean(lat_ms)), 2) if lat_ms else None,
        # daemon-stamped stage split of the same covered rows — the
        # end-to-end percentiles above, attributed
        "stage_ms": _stage_split(covering),
        "timeout": timed_out,
    }
    return report


def main(argv=None) -> None:
    """``loadgen``: replay a stream at a target rate and report the SLO."""
    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch loadgen",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("source", help="synth:SPEC (io.synth.parse_synth) or a CSV path")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--rows", type=int, default=None,
                    help="cap the replay at N rows (default: the whole source)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="target rows/s (0 = as fast as the socket takes them)")
    ap.add_argument("--tenants", type=int, default=1,
                    help="deal the replay round-robin across N tenant "
                    "slots of a multi-tenant daemon (TENANT wire lines, "
                    "per-tenant latency attribution)")
    ap.add_argument("--tenant-weights", default=None, metavar="W0,W1,...",
                    help="skew the multi-tenant dealing: one positive "
                    "weight per tenant (len == --tenants), blocks dealt "
                    "by deterministic smooth weighted round-robin — e.g. "
                    "a Zipf-ish 8,4,2,1 hotness split for exercising "
                    "`history top-tenants` (default: uniform)")
    ap.add_argument("--wire", choices=("v1", "v2"), default="v1",
                    help="wire protocol: v1 = text lines (default), "
                    "v2 = binary columnar frames (serve.wire) — "
                    "frame-batched replay at device-feed rates, same "
                    "latency attribution")
    ap.add_argument("--frame-rows", type=int, default=1024,
                    help="rows per v2 frame (--wire v2; multi-tenant "
                    "replays deal interleave-sized frames instead)")
    ap.add_argument("--dirty", action="append", default=[],
                    metavar="KIND[:ROWS[:SEED]]",
                    help="seeded dirty-row injection (nan_cell|bad_label|"
                    "ragged_row), repeatable; --wire v2 corrupts the same "
                    "seeded stream positions with columnar stand-ins "
                    "(NaN cells / out-of-domain labels)")
    ap.add_argument("--router", action="store_true",
                    help="the endpoint is a tenant ROUTER (fleet front "
                    "daemon): --tenants deals GLOBAL tenant ids, --dir "
                    "(repeatable, one per backend daemon) names the "
                    "fleet's telemetry directories — every verdict "
                    "sidecar under them is tailed and per-tenant "
                    "rows_through attribution joins on global ids, so "
                    "one summary JSON covers the whole fleet")
    ap.add_argument("--verdicts", default=None,
                    help="verdict sidecar path (row→verdict latency source)")
    ap.add_argument("--dir", dest="telemetry_dir", action="append",
                    default=None,
                    help="telemetry directory: resolve the newest verdict "
                    "sidecar in it (repeatable with --router — one per "
                    "backend daemon)")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="max seconds to wait for verdict coverage")
    ap.add_argument("--stop", action="store_true",
                    help="send STOP after the replay (drain the daemon)")
    ap.add_argument("--delayed-labels", type=int, default=0, metavar="K",
                    help="labels arrive K rows after features: each row "
                    "ships at row i+K's pace slot (needs --rate), so "
                    "adaptation refits are exercised under realistic "
                    "label lag; refit latency is attributed in the "
                    "summary JSON when --dir is given")
    ap.add_argument("--trace-sample", type=float, default=0.0,
                    help="head-sample the replay at this rate (0..1): "
                    "sampled rows carry TRACE wire stamps and, with "
                    "--dir, root ingress spans land in a loadgen run log "
                    "for the timeline CLI (0 = off)")
    ap.add_argument("--trace-seed", type=int, default=0,
                    help="seed for the head-sampling decisions (reproducible "
                    "trace sets)")
    ap.add_argument("--target-column", default="target")
    args = ap.parse_args(argv)

    X, y, num_classes = load_source(args.source, args.target_column)
    if args.rows is not None:
        X, y = X[: args.rows], y[: args.rows]
    dirty_rows = 0
    if args.wire == "v2":
        if args.trace_sample > 0:
            ap.error(
                "--trace-sample needs --wire v1 (TRACE stamps are text "
                "protocol lines; use the daemon's --trace-sample for v2)"
            )
        X = np.ascontiguousarray(X, np.float32)
        y = np.ascontiguousarray(y, np.int32)
        for spec in args.dirty:
            dirty_rows += len(apply_dirty_frames(X, y, spec))
        lines = None
    else:
        lines = format_lines(X, y)
        for spec in args.dirty:
            dirty_rows += len(apply_dirty(lines, spec))
    dirs = list(args.telemetry_dir or [])
    if args.router:
        if not dirs:
            ap.error("--router needs --dir (one per backend daemon)")
        if args.verdicts:
            ap.error("--router tails every sidecar under --dir; "
                     "drop --verdicts")
    elif len(dirs) > 1:
        ap.error("multiple --dir needs --router (fleet verdict tailing)")
    verdicts = args.verdicts
    if verdicts is None and dirs and not args.router:
        from .runner import find_verdicts

        verdicts = find_verdicts(dirs[0])
        if verdicts is None:
            ap.error(f"no verdict sidecar under {dirs[0]}")
    trace_log = None
    if args.trace_sample > 0 and dirs:
        from ..telemetry.events import EventLog

        trace_log = EventLog.open_run(dirs[0], name="loadgen")
        trace_log.emit(
            "run_started",
            run_id=trace_log.run_id,
            config={"kind": "loadgen", "source": args.source,
                    "trace_sample": args.trace_sample},
        )
    if args.delayed_labels and args.rate <= 0:
        ap.error("--delayed-labels is a pacing mode and needs --rate > 0")
    tenant_weights = None
    if args.tenant_weights:
        if args.tenants <= 1:
            ap.error("--tenant-weights needs --tenants > 1")
        try:
            tenant_weights = [
                float(w) for w in args.tenant_weights.split(",")
            ]
        except ValueError:
            ap.error(f"--tenant-weights must be comma-separated numbers, "
                     f"got {args.tenant_weights!r}")
        if len(tenant_weights) != args.tenants or any(
            w <= 0 for w in tenant_weights
        ):
            ap.error(f"--tenant-weights needs {args.tenants} positive "
                     f"weights, got {args.tenant_weights!r}")
    t0 = time.monotonic()
    report = run_loadgen(
        args.host,
        args.port,
        lines,
        rate=args.rate,
        verdicts=verdicts,
        timeout=args.timeout,
        stop=args.stop,
        tenants=args.tenants,
        trace_sample=args.trace_sample,
        trace_seed=args.trace_seed,
        trace_log=trace_log,
        label_lag=args.delayed_labels,
        wire_version=args.wire,
        arrays=(X, y) if args.wire == "v2" else None,
        frame_rows=args.frame_rows,
        fleet_dirs=dirs if args.router else None,
        tenant_weights=tenant_weights,
    )
    report.update(
        source=args.source,
        wire=args.wire,
        features=int(X.shape[1]),
        classes=num_classes,
        dirty_rows=dirty_rows,
    )
    if args.router:
        report["router"] = True
        report["fleet_dirs"] = dirs
    if args.delayed_labels:
        report["label_lag_rows"] = args.delayed_labels
    if dirs:
        # Refit-latency attribution (adapt subsystem): join the daemon's
        # adaptation events against the verdict stream's publication
        # stamps. Every run log in the directory is scanned (the
        # loadgen's own --trace-sample client log would otherwise shadow
        # the daemon's as the newest); best-effort — a policy-free
        # daemon yields zero counts.
        import glob as _glob

        from ..telemetry import registry as _registry
        from ..telemetry.events import SchemaError, read_events

        events = []
        for p in (
            q for d in dirs for q in _glob.glob(os.path.join(d, "*.jsonl"))
        ):
            base = os.path.basename(p)
            if base == _registry.INDEX_NAME or base.endswith(
                _registry.SIDECAR_SUFFIXES
            ):
                continue
            try:
                events.extend(
                    e
                    for e in read_events(p, allow_partial_tail=True)
                    if e["type"] == "adaptation"
                )
            except (OSError, SchemaError, ValueError):
                continue
        if verdicts and os.path.exists(verdicts):
            from .runner import read_verdicts

            report.update(
                adapt_attribution(read_verdicts(verdicts), events)
            )
    if trace_log is not None:
        trace_log.emit(
            "run_completed",
            rows=report["rows_sent"],
            seconds=time.monotonic() - t0,
            detections=report["detections"],
        )
        trace_log.close()
        report["trace_log"] = trace_log.path
    print(json.dumps(report))
    raise SystemExit(2 if report["timeout"] else 0)


if __name__ == "__main__":
    main(sys.argv[1:])
