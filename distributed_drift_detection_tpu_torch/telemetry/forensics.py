"""Drift forensics: evidence bundles for every drift verdict.

    python -m distributed_drift_detection_tpu_torch explain <dir | run.jsonl | bundle>

A drift flag as published today is a *position*: partition p, stream row
r. It carries no evidence of what the detector saw when it fired — the
error-rate level, how close the warn/drift thresholds were, what the
rows around the firing point looked like. This module extracts that
evidence **host-side**, at verdict-publication time, from material the
serving loop already holds: the collected flag table, the sealed chunk's
host copy (features/labels/positions/validity), and a cheap per-chunk
snapshot of the detector carry taken as each chunk enters the kernel.
Nothing is added to jitted code and nothing extra crosses the
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
``explain`` CLI renders bundles human-readably. No jax imports — the
snapshot capture is handed in as host arrays by the serve loop; the
CLI runs wherever the artifacts land.
"""

# The port's own copy of the JAX package's ``telemetry/forensics.py``; its CLI's
# ``--help`` prints the docstring above, so that is the JAX module's, but
# for the program name.

from __future__ import annotations

import argparse
import collections
import glob
import json
import math
import os
import sys
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


# -- reading + rendering (the `explain` CLI) --------------------------------


def find_bundles(path: str) -> "list[str]":
    """Resolve bundles from a path: a bundle file, a ``.forensics``
    directory, a run log (its sibling ``.forensics`` dir), or a
    telemetry directory (every ``*.forensics/`` under it)."""
    if os.path.isfile(path) and path.endswith(".json"):
        return [path]
    if os.path.isdir(path) and path.endswith(FORENSICS_SUFFIX):
        return sorted(glob.glob(os.path.join(path, "drift-*.json")))
    if os.path.isfile(path):  # a run log: its own forensics dir
        d = os.path.splitext(path)[0] + FORENSICS_SUFFIX
        return sorted(glob.glob(os.path.join(d, "drift-*.json")))
    if os.path.isdir(path):  # a telemetry dir: every run's bundles
        return sorted(
            glob.glob(
                os.path.join(path, "*" + FORENSICS_SUFFIX, "drift-*.json")
            )
        )
    return []


def adaptation_index(bundle_path: str) -> "dict[tuple, list[dict]]":
    """The ``adaptation`` events matching a bundle's run, indexed by
    ``(tenant, trigger_chunk)`` — the join key between a drift's
    *cause* (the forensics bundle) and its *reaction* (the adapt
    subsystem's event). The run log is the bundle directory's sibling
    (``X.forensics/`` ↔ ``X.jsonl``); a missing or partial log (a live
    daemon) yields what is readable, never an error — explain must
    render wherever the artifacts land."""
    d = os.path.dirname(os.path.abspath(bundle_path))
    if not d.endswith(FORENSICS_SUFFIX):
        return {}
    log = d[: -len(FORENSICS_SUFFIX)] + ".jsonl"
    if not os.path.isfile(log):
        return {}
    from .events import SchemaError, read_events

    try:
        events = read_events(log, allow_partial_tail=True)
    except SchemaError:
        return {}
    out: dict = {}
    for e in events:
        if e.get("type") != "adaptation":
            continue
        key = (int(e.get("tenant", 0)), int(e["trigger_chunk"]))
        out.setdefault(key, []).append(e)
    return out


def render_adaptation(events: "list[dict] | None") -> "list[str]":
    """The reaction lines rendered under a bundle: one per matching
    ``adaptation`` event, or the explicit "no reaction" line — one
    command shows cause AND reaction."""
    if not events:
        return ["  reaction       none recorded (on_drift=alert_only?)"]
    out = []
    for e in events:
        verdict = (
            "demoted"
            if e.get("demoted")
            else ("promoted" if e.get("promoted") else "held (champion kept)")
        )
        errs = (
            f"err {_fmt(e.get('err_before'), 3)} -> "
            f"{_fmt(e.get('err_after'), 3)}"
        )
        out.append(
            f"  reaction       policy={e['policy']}  {verdict}  {errs}  "
            f"refit on {e['rows_refit']} row(s)"
            + (
                f"  applied +{e['rows_to_apply']} rows "
                f"(chunk {e.get('applied_chunk')})"
                if e.get("rows_to_apply") is not None
                else ""
            )
        )
    return out


def read_bundle(path: str) -> dict:
    with open(path) as fh:
        bundle = json.load(fh)
    if not isinstance(bundle, dict) or bundle.get("kind") != "drift_forensics":
        raise ValueError(f"{path}: not a drift_forensics bundle")
    return bundle


def _fmt(v, nd=6) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


def render_bundle(bundle: dict, adaptation: "list[dict] | None" = None) -> str:
    """Human-readable rendering of one evidence bundle; ``adaptation``
    (the matching ``adaptation`` events, see :func:`adaptation_index`)
    appends the reaction lines so cause and reaction read together."""
    out = []
    tenant = (
        f" tenant {bundle['tenant']} (local p{bundle['tenant_partition']})"
        if bundle.get("tenant") is not None
        else ""
    )
    out.append(
        f"drift @ row {bundle['global_pos']}  — chunk {bundle['chunk']} "
        f"batch {bundle['batch']} partition {bundle['partition']}{tenant}"
    )
    if bundle.get("warning"):
        out.append(
            f"  first warning  row {bundle['warning']['global_pos']} "
            f"(batch-local {bundle['warning']['local']})"
        )
    det = bundle.get("detector") or {}
    if det:
        out.append(
            "  detector       "
            + "  ".join(f"{k}={_fmt(v)}" for k, v in sorted(det.items()))
        )
    w = bundle.get("window") or {}
    if w:
        out.append(
            "  window stats   "
            + "  ".join(f"{k}={_fmt(v)}" for k, v in sorted(w.items()))
        )
    th = bundle.get("thresholds") or {}
    if th:
        out.append(
            f"  thresholds     warn>{_fmt(th.get('warn'))}  "
            f"drift>{_fmt(th.get('drift'))}  (p+s vs p_min+level·s_band)"
        )
    traj = bundle.get("trajectory") or []
    if traj:
        rates = [
            _fmt(t.get("error_rate"), 3) for t in traj
        ]
        out.append(
            f"  error rate     {' -> '.join(rates)}   "
            f"(last {len(traj)} chunk boundaries)"
        )
    ctx = bundle.get("context") or {}
    pre, post = ctx.get("pre") or [], ctx.get("post") or []
    if pre or post:
        out.append(
            f"  context        {len(pre)} row(s) before, "
            f"{len(post)} after the firing point:"
        )
        for r in pre + post:
            marker = ">>" if r["pos"] == bundle["global_pos"] else "  "
            flag = "" if r["valid"] else "  [masked]"
            xs = " ".join(f"{v:.3g}" for v in r["x"][:6])
            more = " ..." if len(r["x"]) > 6 else ""
            out.append(
                f"   {marker} row {r['pos']:>9}  y={r['y']}  "
                f"x=[{xs}{more}]{flag}"
            )
    if bundle.get("trace_ids"):
        out.append(
            "  traces         " + " ".join(bundle["trace_ids"][:4])
            + (" ..." if len(bundle["trace_ids"]) > 4 else "")
        )
    if adaptation is not None:
        out.extend(render_adaptation(adaptation))
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch explain",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "path",
        help="a bundle .json, a <run>.forensics/ directory, a run log, or "
        "a telemetry directory",
    )
    ap.add_argument(
        "--limit", type=int, default=20,
        help="max bundles rendered (default 20; newest-position last)",
    )
    args = ap.parse_args(argv)
    bundles = find_bundles(args.path)
    if not bundles:
        raise SystemExit(f"explain: no forensics bundles under {args.path}")
    shown = bundles[: args.limit]
    adapt_cache: dict = {}  # bundle dir -> adaptation index (one log read)
    for i, p in enumerate(shown):
        if i:
            print()
        bundle = read_bundle(p)
        d = os.path.dirname(os.path.abspath(p))
        if d not in adapt_cache:
            adapt_cache[d] = adaptation_index(p)
        key = (int(bundle.get("tenant") or 0), int(bundle["chunk"]))
        print(render_bundle(bundle, adaptation=adapt_cache[d].get(key, [])))
    hidden = len(bundles) - len(shown)
    print(
        f"\n{len(bundles)} bundle(s)"
        + (f" ({hidden} not shown; --limit)" if hidden > 0 else "")
    )


if __name__ == "__main__":
    main(sys.argv[1:])
