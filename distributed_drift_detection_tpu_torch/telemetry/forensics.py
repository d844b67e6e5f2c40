"""Drift forensics: evidence bundles for every drift verdict — the
port's own copy of the extractor half of the JAX package's
``telemetry/forensics.py``. The ``explain`` reader is not ported yet
(ROADMAP A15c); the JAX package's reads the bundles written here, which
keep its schema.

A drift flag as published today is a *position*: partition p, stream row
r. It carries no evidence of what the detector saw when it fired — the
error-rate level, how close the warn/drift thresholds were, what the
rows around the firing point looked like. This module extracts that
evidence **host-side**, at verdict-publication time, from material the
serving loop already holds: the collected flag table, the sealed chunk's
host copy (features/labels/positions/validity), and a cheap per-chunk
snapshot of the detector carry taken as each chunk enters the kernel.
Nothing is added to the device loop and nothing extra crosses the
device→host link beyond a few scalars per partition per chunk.

One bundle = one JSON file under ``<run-log stem>.forensics/``:

* the firing point (chunk / batch column / partition / tenant / global
  stream position) and the same batch's first warning, if any;
* the detector's configured thresholds AND the *effective* warn/drift
  bars at the firing window (``p_min + level·s_band``, DDM semantics);
* the detector state entering the firing chunk (count, running error
  rate, ``ps_min/p_min/s_min``) — the window stats the threshold
  comparison ran against, matching the sequential oracle's internals
  exactly (pinned by test);
* the running error-rate trajectory over the last N chunk boundaries
  approaching the firing point;
* pre/post context rows around the firing position, from the chunk's
  host copy (feature vector, label, validity — quarantined/padded rows
  visible as invalid);
* the trace ids of any sampled rows in the chunk (telemetry.tracing),
  so a bundle joins back to its causal traces.

Every bundle is announced by a schema-v1 ``drift_forensics`` event and
counted in ``forensics_bundles_total`` (surfaced in ``/statusz``). The
``explain`` CLI renders bundles human-readably. No torch imports — the
snapshot capture is handed in as host (numpy) arrays by the serve loop.
"""

from __future__ import annotations

import collections
import json
import math
import os
import time

import numpy as np

FORENSICS_SUFFIX = ".forensics"
BUNDLE_VERSION = 1

#: context rows captured on each side of the firing position
DEFAULT_CONTEXT_ROWS = 8
#: chunk-boundary snapshots retained per partition for the trajectory
DEFAULT_TRAJECTORY = 16

FORENSICS_METRIC = "forensics_bundles_total"
FORENSICS_HELP = "Drift evidence bundles written by telemetry.forensics"


def _finite(v) -> "float | None":
    """JSON-safe float: non-finite (inf minima of a fresh detector)
    serialize as None, never as bare ``Infinity``."""
    f = float(v)
    return f if math.isfinite(f) else None


def state_fields(state, partition: int) -> dict:
    """One partition's detector-state scalars as a JSON-safe dict.

    Generic over detector kernels: a NamedTuple state (DDM's
    ``count/err_sum/ps_min/p_min/s_min``, or any other kernel's) maps
    field name → value at ``partition``; unknown structures fall back to
    positional ``leaf<i>`` names. A derived ``error_rate`` is added when
    ``count``/``err_sum`` exist (DDM's running p) — the quantity the
    trajectory plots."""
    if state is None:
        return {}
    if hasattr(state, "_asdict"):
        items = list(state._asdict().items())
    else:
        items = [(f"leaf{i}", leaf) for i, leaf in enumerate(state)]
    out = {}
    for name, leaf in items:
        arr = np.asarray(leaf)
        if arr.ndim >= 1 and partition < arr.shape[0]:
            out[name] = _finite(arr[partition])
        elif arr.ndim == 0:
            out[name] = _finite(arr)
    cnt = out.get("count")
    if cnt and out.get("err_sum") is not None:
        # f32 division, matching the kernel's p = err_sum / count
        out["error_rate"] = _finite(
            np.float32(out["err_sum"]) / np.float32(cnt)
        )
    elif "count" in out:
        out["error_rate"] = None
    return out


def effective_thresholds(window: dict, params: dict) -> dict:
    """The warn/drift bars the DDM comparison used at this window:
    ``p_min + level · s_band`` with the noise-floor band
    (``ops.ddm._band_s`` semantics, recomputed host-side in f32). Empty
    when the state carries no DDM-shaped minima (other kernels)."""
    p_min, s_min = window.get("p_min"), window.get("s_min")
    out_level = params.get("out_control_level")
    if p_min is None or s_min is None or not out_level:
        return {}
    s_band = np.float32(s_min)
    floor = params.get("noise_floor") or 0.0
    if floor:
        s_band = max(s_band, np.float32(floor) / np.float32(out_level))
    return {
        "warn": _finite(
            np.float32(p_min)
            + np.float32(params.get("warning_level", 0.0)) * s_band
        ),
        "drift": _finite(
            np.float32(p_min) + np.float32(out_level) * s_band
        ),
    }


def _context_rows(chunk, partition: int, pos: int, k: int) -> dict:
    """Pre/post context rows around stream position ``pos`` from one
    partition's plane of the chunk's host copy, in stream order."""
    rows = np.asarray(chunk.rows[partition]).ravel()
    X = np.asarray(chunk.X[partition]).reshape(rows.size, -1)
    y = np.asarray(chunk.y[partition]).ravel()
    valid = np.asarray(chunk.valid[partition]).ravel()
    real = rows >= 0  # padding rows carry -1 positions
    order = np.argsort(rows[real], kind="stable")
    r, x, lab, ok = (
        rows[real][order], X[real][order], y[real][order], valid[real][order]
    )

    def pack(idx):
        return [
            {
                "pos": int(r[i]),
                "x": [float(v) for v in x[i]],
                "y": int(lab[i]),
                "valid": bool(ok[i]),
            }
            for i in idx
        ]

    before = np.nonzero(r < pos)[0]
    after = np.nonzero(r >= pos)[0]
    return {"pre": pack(before[-k:]), "post": pack(after[:k])}


class ForensicsExtractor:
    """Per-daemon forensics state: snapshot ring + bundle writer.

    The serve loop calls :meth:`on_publish` once per published chunk
    with the chunk's *entry* detector state (captured before the chunk
    was fed — a few host scalars per partition), the collected host
    flag table, and the chunk's host copy. Drift-free chunks only
    advance the trajectory ring; a chunk with detections writes one
    bundle per firing flag.
    """

    def __init__(
        self,
        out_dir: str,
        *,
        run_id: "str | None" = None,
        detector_params: "dict | None" = None,
        tenants: int = 1,
        context_rows: int = DEFAULT_CONTEXT_ROWS,
        trajectory: int = DEFAULT_TRAJECTORY,
        metrics=None,
    ):
        self.out_dir = out_dir
        self.run_id = run_id
        self.detector_params = dict(detector_params or {})
        self.tenants = max(int(tenants), 1)
        self.context_rows = int(context_rows)
        self.bundles_written = 0
        self._traj: dict[int, collections.deque] = {}
        self._traj_cap = max(int(trajectory), 1)
        self._counter = (
            metrics.counter(FORENSICS_METRIC, help=FORENSICS_HELP)
            if metrics is not None
            else None
        )

    def _record_trajectory(self, meta: dict, entry_state) -> None:
        if entry_state is None:
            return
        # one ring per partition, fed from the [P]-shaped state arrays
        arrs = (
            entry_state._asdict()
            if hasattr(entry_state, "_asdict")
            else {}
        )
        cnt = arrs.get("count")
        esum = arrs.get("err_sum")
        if cnt is None:
            return
        cnt = np.asarray(cnt)
        esum = None if esum is None else np.asarray(esum)
        for p in range(cnt.shape[0] if cnt.ndim else 1):
            ring = self._traj.setdefault(
                p, collections.deque(maxlen=self._traj_cap)
            )
            c = int(cnt[p] if cnt.ndim else cnt)
            e = (
                None
                if esum is None
                else float(esum[p] if esum.ndim else esum)
            )
            ring.append(
                {
                    "chunk": int(meta["chunk"]),
                    "rows_through": int(meta.get("rows_through", 0)),
                    "count": c,
                    "error_rate": (
                        _finite(np.float32(e) / np.float32(c))
                        if e is not None and c > 0
                        else None
                    ),
                }
            )

    def on_publish(
        self,
        meta: dict,
        flags,
        chunk,
        entry_state,
        *,
        log=None,
        trace_ids=(),
    ) -> "list[str]":
        """Process one published chunk; returns the bundle paths written
        (empty for drift-free chunks). ``entry_state`` is the detector
        state entering this chunk as HOST arrays (or None when capture
        is off/unavailable); ``flags`` the collected host flag table;
        ``chunk`` the sealed chunk's host copy."""
        self._record_trajectory(meta, entry_state)
        cg = np.asarray(flags.change_global)
        changed = cg >= 0
        if not changed.any():
            return []
        os.makedirs(self.out_dir, exist_ok=True)
        wl = np.asarray(flags.warning_local)
        wg = np.asarray(flags.warning_global)
        p_per = cg.shape[0] // self.tenants
        written = []
        for b, p in zip(*np.nonzero(changed.T)):
            p, b = int(p), int(b)
            pos = int(cg[p, b])
            window = state_fields(entry_state, p)
            bundle = {
                "v": BUNDLE_VERSION,
                "kind": "drift_forensics",
                "run_id": self.run_id,
                "ts": time.time(),
                "chunk": int(meta["chunk"]),
                "batch": b,
                "partition": p,
                "tenant": p // p_per if self.tenants > 1 else None,
                "tenant_partition": p % p_per if self.tenants > 1 else None,
                "global_pos": pos,
                "warning": (
                    {"local": int(wl[p, b]), "global_pos": int(wg[p, b])}
                    if int(wl[p, b]) >= 0
                    else None
                ),
                "detector": self.detector_params,
                "window": window,
                "thresholds": effective_thresholds(
                    window, self.detector_params
                ),
                "trajectory": list(self._traj.get(p, ())),
                "context": _context_rows(
                    chunk, p, pos, self.context_rows
                ),
                "trace_ids": list(trace_ids),
                "rows_through": int(meta.get("rows_through", 0)),
            }
            path = os.path.join(
                self.out_dir, f"drift-c{meta['chunk']}-p{p}-r{pos}.json"
            )
            with open(path, "w") as fh:
                json.dump(bundle, fh, indent=1)
                fh.write("\n")
            written.append(path)
            self.bundles_written += 1
            if self._counter is not None:
                self._counter.inc()
            if log is not None:
                log.emit(
                    "drift_forensics",
                    chunk=int(meta["chunk"]),
                    partition=p,
                    global_pos=pos,
                    bundle=os.path.relpath(
                        path, os.path.dirname(self.out_dir) or "."
                    ),
                )
        return written
