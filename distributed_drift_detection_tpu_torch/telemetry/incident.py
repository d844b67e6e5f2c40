"""Incident autopsy plane: alert-triggered cross-plane evidence capture,
a deterministic diagnosis engine, and the fleet incident index — the
port's own copy of the JAX package's ``telemetry/incident.py``, on bundles
of either package (the schema is the same).

The repo grew four separate evidence planes — the flight-recorder ring
(dumped only on crash), trace/forensics bundles, pipeline stage
attribution, and the durable metrics history — but when an SLO alert
fired on a live daemon nobody snapshotted any of them: the operator (or
the ROADMAP item-3 autoscaler) was left joining five CLIs by hand after
the window of evidence had rotated away. This module closes that gap:

* :class:`IncidentRecorder` — subscribed to the
  :class:`~.slo.SloEngine`'s fire/resolve transitions (the engine's
  ``observer`` hook, invoked on the SLO evaluator thread — never the
  serve loop) and to the crash path. Every ``firing`` transition
  captures a numbered, self-contained evidence bundle under
  ``<run-log stem>.incidents/incident-NNNN/``:

  =======================  ==============================================
  ``flightrec.jsonl``      the flight ring at firing time (the crash-only
                           dump, generalized)
  ``pipeline.json``        live stage attribution: busy shares, dominant
                           stage, the wedged-stage breadcrumb
  ``statusz.json``         the full ``/statusz`` snapshot
  ``history.jsonl``        a window extract from the history store around
                           the firing timestamp (when a store is
                           configured)
  ``top_tenants.json``     the per-tenant hotness ranking over the window
  ``verdicts_tail.jsonl``  the newest verdict sidecar lines
  ``quarantine_tail.jsonl`` the newest quarantine sidecar lines
  ``manifest.json``        firing rule + value + threshold + file list —
                           written LAST, atomically: its presence is the
                           bundle-complete marker
  ``resolved.json``        the resolve transition, appended when the
                           alert clears (open incidents lack it)
  =======================  ==============================================

  A daemon killed mid-capture leaves a directory without a manifest;
  :func:`read_bundle` surfaces that as a loud ``partial: true``, never a
  crash or a silently-complete-looking report. Verdict sidecars are
  bit-identical with incidents on or off (pinned by tests): capture runs
  entirely off the serve hot loop and only *reads* runner state.

* :func:`diagnose` — a deterministic, stdlib-only rule engine ranking
  probable causes from the bundle alone, each verdict citing the exact
  numbers it used: ``<stage>-bound`` (wedged-stage breadcrumb under a
  ``stall_s`` firing, or dominant pipeline share), ``under-driven``
  (seal_wait dominant), ``hot-tenant-skew`` (top tenant vs. fleet
  median), ``quarantine-spike``, ``adaptation-storm`` (flight-ring
  adaptation events), ``backend-down`` (``up == 0`` in the history
  extract). The autoscaler reads a diagnosis, not a bare alert bit.

* :func:`main` — the ``incident`` CLI (``list`` / ``show`` /
  ``diagnose``), JSON or a rendered report with history sparklines, plus
  a ``--store`` fleet incident index (the collector scrapes every
  daemon's ``/incidentz`` into ``serve_incidents_total{instance=...}``).

Exit codes follow the ``watch``/``history`` convention: 0 ok, 3 empty,
4 nothing resolvable. No torch and no jax anywhere; stdlib + sibling
telemetry modules only — importable by every reader CLI.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import threading
import time

INCIDENTS_SUFFIX = ".incidents"
BUNDLE_PREFIX = "incident-"

MANIFEST_NAME = "manifest.json"
RESOLVED_NAME = "resolved.json"
FLIGHT_NAME = "flightrec.jsonl"
PIPELINE_NAME = "pipeline.json"
STATUSZ_NAME = "statusz.json"
HISTORY_NAME = "history.jsonl"
TENANTS_NAME = "top_tenants.json"
VERDICTS_TAIL_NAME = "verdicts_tail.jsonl"
QUARANTINE_TAIL_NAME = "quarantine_tail.jsonl"

INCIDENT_CAPTURES_METRIC = "incident_captures_total"
INCIDENT_CAPTURES_HELP = (
    "Incident bundles captured, labeled by the firing rule (or 'crash')"
)
INCIDENT_OPEN_METRIC = "incident_open"
INCIDENT_OPEN_HELP = (
    "Captured incidents whose firing alert has not resolved yet"
)

#: The fleet-index series the collector lifts from each daemon's
#: ``/incidentz`` into the history store (``instance`` labeled).
INCIDENTS_TOTAL_SERIES = "serve_incidents_total"
INCIDENT_OPEN_SERIES = "serve_incident_open"

_BUNDLE_RE = re.compile(re.escape(BUNDLE_PREFIX) + r"\d{4,}$")


# -- small tolerant IO helpers ------------------------------------------------


def _write_json(path: str, obj) -> bool:
    """Atomic best-effort JSON write (tmp + rename); False on failure."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as fh:
            json.dump(obj, fh, indent=1)
            fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except (OSError, TypeError, ValueError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False
    return True


def _write_lines(path: str, lines) -> bool:
    lines = list(lines)
    if not lines:
        return False
    try:
        with open(path, "w") as fh:
            for line in lines:
                fh.write(line.rstrip("\n") + "\n")
            fh.flush()
    except OSError:
        return False
    return True


def _load_json(path: str):
    """One JSON document, or ``None`` (absent/torn — evidence reading
    never raises)."""
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _load_jsonl(path: str) -> list[dict]:
    """Tolerant JSONL read: unparseable lines (a torn tail from a killed
    writer) are skipped, never raised — a partial bundle must still read."""
    out: list[dict] = []
    try:
        with open(path) as fh:
            lines = fh.readlines()
    except OSError:
        return out
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


def _tail_lines(path: str, n: int, max_bytes: int = 1 << 20) -> list[str]:
    """Last ``n`` complete lines of a (possibly huge) sidecar, reading at
    most ``max_bytes`` from the end — capture must stay cheap no matter
    how large the sidecar has grown."""
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(max(0, size - max_bytes))
            data = fh.read()
    except OSError:
        return []
    raw = data.split(b"\n")
    if size > max_bytes and raw:
        raw = raw[1:]  # the seek likely landed mid-line: drop the torn head
    lines = [ln.decode("utf-8", "replace") for ln in raw if ln.strip()]
    return lines[-max(int(n), 0):]


# -- capture ------------------------------------------------------------------


class IncidentRecorder:
    """Alert/crash-triggered evidence capture for one serving daemon.

    All capture callables only *read* runner state (the same contract as
    the ops handlers); bundles are written on the calling thread — the
    SLO evaluator for alerts, the dying loop thread for crashes — never
    the serve hot loop. :meth:`on_transition` is wired as
    ``SloEngine.observer``.
    """

    def __init__(
        self,
        stem: str,
        *,
        flight=None,
        statusz_fn=None,
        pipeline_fn=None,
        verdicts_path: "str | None" = None,
        store: "str | None" = None,
        window_s: float = 120.0,
        metrics=None,
        max_bundles: int = 32,
        tail_rows: int = 64,
    ):
        """``flight`` is the daemon's :class:`~.ops.FlightRecorder` (or
        ``None``); ``store`` a history-store directory for the window
        extract; ``max_bundles`` bounds captures per process lifetime
        (an alert-storm must not fill the disk — skips are counted)."""
        self.stem = stem
        self.root = stem + INCIDENTS_SUFFIX
        self._flight = flight
        self._statusz_fn = statusz_fn
        self._pipeline_fn = pipeline_fn
        self._verdicts_path = verdicts_path
        self._store = store or None
        self._window_s = float(window_s)
        self._max = max(int(max_bundles), 1)
        self._tail_rows = int(tail_rows)
        self._lock = threading.Lock()
        self._seq = 0
        self._captured = 0
        self._skipped = 0
        self._open: dict[str, str] = {}  # firing rule -> bundle name
        self._latest: "dict | None" = None
        self.last_capture_ms: "float | None" = None
        self._counter = self._gauge = None
        if metrics is not None:
            self._counter = metrics.counter(
                INCIDENT_CAPTURES_METRIC, help=INCIDENT_CAPTURES_HELP
            )
            self._gauge = metrics.gauge(
                INCIDENT_OPEN_METRIC, help=INCIDENT_OPEN_HELP
            )
            self._gauge.set(0.0)

    # - the SloEngine.observer hook (evaluator thread) -

    def on_transition(self, t: dict) -> None:
        """One successfully-emitted alert transition: ``firing`` captures
        a bundle and opens the incident, ``resolved`` closes it (writing
        the resolve transition into the bundle as ``resolved.json``)."""
        rule = str(t.get("rule") or "")
        if t.get("state") == "firing":
            name = self.capture(t)
            if name is not None:
                with self._lock:
                    self._open[rule] = name
        else:
            with self._lock:
                name = self._open.pop(rule, None)
            if name is not None:
                _write_json(os.path.join(self.root, name, RESOLVED_NAME), t)
        self._sync_gauge()

    def capture(self, reason: dict, kind: str = "alert") -> "str | None":
        """Write one evidence bundle; returns its directory name, or
        ``None`` (bundle cap reached, or the manifest could not land —
        the latter leaves a partial bundle readers flag loudly). Every
        artifact is individually best-effort: a broken snapshot source
        costs that file, never the bundle."""
        t0 = time.monotonic()
        with self._lock:
            if self._seq >= self._max:
                self._skipped += 1
                return None
            self._seq += 1
            seq = self._seq
        name = f"{BUNDLE_PREFIX}{seq:04d}"
        path = os.path.join(self.root, name)
        try:
            os.makedirs(path, exist_ok=True)
        except OSError:
            return None
        files: list[str] = []
        if self._flight is not None:
            try:
                if self._flight.dump(os.path.join(path, FLIGHT_NAME)):
                    files.append(FLIGHT_NAME)
            except Exception:
                pass
        for fname, fn in (
            (PIPELINE_NAME, self._pipeline_fn),
            (STATUSZ_NAME, self._statusz_fn),
        ):
            if fn is None:
                continue
            try:
                obj = fn()
            except Exception:
                obj = None
            if obj is not None and _write_json(
                os.path.join(path, fname), obj
            ):
                files.append(fname)
        if self._verdicts_path and _write_lines(
            os.path.join(path, VERDICTS_TAIL_NAME),
            _tail_lines(self._verdicts_path, self._tail_rows),
        ):
            files.append(VERDICTS_TAIL_NAME)
        qlines: list[str] = []
        for qpath in sorted(
            glob.glob(glob.escape(self.stem) + "*quarantine.jsonl")
        ):
            qlines.extend(_tail_lines(qpath, self._tail_rows))
        if qlines and _write_lines(
            os.path.join(path, QUARANTINE_TAIL_NAME),
            qlines[-self._tail_rows:],
        ):
            files.append(QUARANTINE_TAIL_NAME)
        if self._store:
            try:
                from .history import list_segments, read_samples, top_tenants

                if list_segments(self._store):
                    now = time.time()
                    recs = read_samples(
                        self._store,
                        start=now - self._window_s,
                        end=now + 1.0,
                    )
                    if recs and _write_lines(
                        os.path.join(path, HISTORY_NAME),
                        [json.dumps(r) for r in recs],
                    ):
                        files.append(HISTORY_NAME)
                    ranked = top_tenants(
                        self._store, window_s=self._window_s, at=now
                    )
                    if ranked and _write_json(
                        os.path.join(path, TENANTS_NAME), ranked
                    ):
                        files.append(TENANTS_NAME)
            except Exception:
                pass
        capture_ms = round((time.monotonic() - t0) * 1e3, 3)
        manifest = {
            "v": 1,
            "id": name,
            "seq": seq,
            "kind": kind,
            "ts": round(time.time(), 6),
            "mono": round(time.monotonic(), 6),
            "rule": reason.get("rule"),
            "state": reason.get("state", "firing"),
            "value": reason.get("value"),
            "threshold": reason.get("threshold"),
            **(
                {"alert_mono": reason["mono"]} if "mono" in reason else {}
            ),
            **({"error": reason["error"]} if "error" in reason else {}),
            "stem": os.path.basename(self.stem),
            "files": files,
            "capture_ms": capture_ms,
        }
        # The manifest lands LAST, atomically: its presence IS the
        # bundle-complete marker. A daemon killed before this point
        # leaves a manifest-less dir that reads as partial.
        if not _write_json(os.path.join(path, MANIFEST_NAME), manifest):
            return None
        self.last_capture_ms = capture_ms
        with self._lock:
            self._captured += 1
            self._latest = manifest
        if self._counter is not None:
            self._counter.inc(1.0, rule=str(reason.get("rule") or kind))
        return name

    def capture_crash(self, error: str) -> "str | None":
        """The crash-path generalization of the flight-recorder dump:
        a failing daemon leaves a full bundle too, rule ``crash``."""
        return self.capture(
            {"rule": "crash", "state": "firing", "error": str(error)},
            kind="crash",
        )

    def _sync_gauge(self) -> None:
        if self._gauge is not None:
            with self._lock:
                n = len(self._open)
            self._gauge.set(float(n))

    # - surfaces -

    def count(self) -> int:
        with self._lock:
            return self._captured

    def statusz_section(self) -> dict:
        """The ``/statusz`` ``incidents`` section (``backend_snapshot``
        lifts ``count`` into the fleet view)."""
        with self._lock:
            return {
                "count": self._captured,
                "open": len(self._open),
                "skipped": self._skipped,
                "dir": self.root,
            }

    def incidentz(self) -> dict:
        """The ``/incidentz`` payload: counts + the latest manifest."""
        with self._lock:
            return {
                "count": self._captured,
                "open": len(self._open),
                "skipped": self._skipped,
                "dir": self.root,
                "last_capture_ms": self.last_capture_ms,
                "latest": dict(self._latest) if self._latest else None,
            }


# -- reading ------------------------------------------------------------------


def list_bundles(root: str) -> list[str]:
    """Bundle directories under one ``.incidents`` root, capture order."""
    if not os.path.isdir(root):
        return []
    return sorted(
        p
        for p in glob.glob(os.path.join(root, BUNDLE_PREFIX + "*"))
        if os.path.isdir(p) and _BUNDLE_RE.search(os.path.basename(p))
    )


def resolve_incidents_dir(source: str) -> "str | None":
    """Map any supported ``source`` to an ``.incidents`` root: the root
    itself, a run log (its stem's sibling), or a telemetry dir (the
    newest ``*.incidents`` inside). ``None`` when nothing resolves."""
    if source.endswith(".jsonl"):
        root = os.path.splitext(source)[0] + INCIDENTS_SUFFIX
        return root if os.path.isdir(root) else None
    if not os.path.isdir(source):
        return None
    base = os.path.basename(os.path.normpath(source))
    if base.endswith(INCIDENTS_SUFFIX) or list_bundles(source):
        return source
    roots = [
        p
        for p in glob.glob(os.path.join(source, "*" + INCIDENTS_SUFFIX))
        if os.path.isdir(p)
    ]
    if not roots:
        return None
    return max(roots, key=os.path.getmtime)


def read_bundle(path: str) -> dict:
    """One bundle directory → the in-memory evidence dict
    :func:`diagnose` consumes. Never raises on torn evidence: a missing
    or unparseable manifest marks the bundle ``partial: true`` (the
    daemon died mid-capture), and every artifact reads tolerantly."""
    manifest = _load_json(os.path.join(path, MANIFEST_NAME))
    return {
        "path": path,
        "id": os.path.basename(os.path.normpath(path)),
        "partial": not isinstance(manifest, dict),
        "manifest": manifest if isinstance(manifest, dict) else None,
        "resolved": _load_json(os.path.join(path, RESOLVED_NAME)),
        "pipeline": _load_json(os.path.join(path, PIPELINE_NAME)),
        "statusz": _load_json(os.path.join(path, STATUSZ_NAME)),
        "top_tenants": _load_json(os.path.join(path, TENANTS_NAME)),
        "flightrec": _load_jsonl(os.path.join(path, FLIGHT_NAME)),
        "history": _load_jsonl(os.path.join(path, HISTORY_NAME)),
        "verdicts_tail": _load_jsonl(
            os.path.join(path, VERDICTS_TAIL_NAME)
        ),
        "quarantine_tail": _load_jsonl(
            os.path.join(path, QUARANTINE_TAIL_NAME)
        ),
    }


# -- diagnosis ----------------------------------------------------------------


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:g}"
    return str(v)


def diagnose(bundle: dict) -> list[dict]:
    """Rank probable causes from one bundle — deterministic, jax-free,
    bundle-only (runs identically on the daemon host or a laptop).
    Returns ``[{"cause", "score", "evidence"}, ...]`` sorted by score
    descending; every verdict cites the exact numbers it used."""
    manifest = bundle.get("manifest") or {}
    pipe = bundle.get("pipeline") or {}
    statusz = bundle.get("statusz") or {}
    shares = pipe.get("shares") or {}
    busy = pipe.get("busy_s") or {}
    wall = pipe.get("wall_s")
    rule = str(manifest.get("rule") or "")
    value = manifest.get("value")
    threshold = manifest.get("threshold")
    causes: dict[str, dict] = {}

    def add(cause: str, score: float, evidence: str) -> None:
        score = round(float(score), 4)
        cur = causes.get(cause)
        if cur is None or score > cur["score"]:
            causes[cause] = {
                "cause": cause,
                "score": score,
                "evidence": evidence,
            }

    # 1. Wedged loop: a stall_s firing plus the loop's wedged-stage
    # breadcrumb names the stage the loop is stuck INSIDE right now —
    # mid-stall, the stage's busy counter hasn't been credited yet, so
    # shares alone would misattribute.
    cur = pipe.get("current_stage") or {}
    if rule == "stall_s" and cur.get("stage") and cur["stage"] != "seal_wait":
        add(
            f"{cur['stage']}-bound",
            0.95,
            f"serve loop wedged inside stage '{cur['stage']}' for "
            f"{_fmt(cur.get('for_s'))}s at capture "
            f"(stall_s {_fmt(value)} > threshold {_fmt(threshold)})",
        )

    # 2. Stage-bound: the dominant pipeline stage holds the busy share.
    dom = pipe.get("dominant_stage")
    if dom and dom != "seal_wait":
        share = float(shares.get(dom) or 0.0)
        if share >= 0.4:
            add(
                f"{dom}-bound",
                min(share, 0.94),
                f"stage '{dom}' holds {_fmt(busy.get(dom))}s busy = "
                f"{share * 100:.1f}% of measured busy time "
                f"over {_fmt(wall)}s loop wall",
            )

    # 3. Under-driven: the loop mostly waits for input.
    seal = float(shares.get("seal_wait") or 0.0)
    if seal >= 0.5:
        add(
            "under-driven",
            min(seal * 0.9, 0.9),
            f"seal_wait holds {_fmt(busy.get('seal_wait'))}s = "
            f"{seal * 100:.1f}% of measured busy time — the loop is "
            "waiting for input, not working",
        )

    # 4. Hot-tenant skew: top tenant vs. the median of the rest.
    tenants = bundle.get("top_tenants") or []
    if len(tenants) >= 2:
        top = tenants[0]
        top_rate = float(top.get("rows_per_sec") or 0.0)
        rest = sorted(
            float(t.get("rows_per_sec") or 0.0) for t in tenants[1:]
        )
        median = rest[len(rest) // 2]
        if top_rate > 0 and top_rate >= 4.0 * max(median, 1e-9):
            ratio = top_rate / max(median, 1e-9)
            add(
                "hot-tenant-skew",
                min(0.85, ratio / (ratio + 4.0)),
                f"tenant {top.get('tenant')} at {top_rate:g} rows/s vs "
                f"fleet median {median:g} rows/s "
                f"({min(ratio, 9999.0):.1f}x) over the capture window",
            )

    # 5. Quarantine spike: dirty-traffic share at admission.
    rows = statusz.get("rows") or {}
    seen = rows.get("ingress_seen")
    quar = rows.get("quarantined")
    if seen and quar is not None:
        pct = 100.0 * float(quar) / float(seen)
        if rule == "quarantine_pct" or pct > 5.0:
            add(
                "quarantine-spike",
                0.9 if rule == "quarantine_pct" else min(0.8, 0.3 + pct / 100.0),
                f"{int(quar)} of {int(seen)} ingress rows quarantined "
                f"({pct:.2f}%)"
                + (
                    f"; quarantine_pct {_fmt(value)} > "
                    f"threshold {_fmt(threshold)}"
                    if rule == "quarantine_pct"
                    else ""
                ),
            )

    # 6. Adaptation storm: the flight ring is full of refit events.
    ring = bundle.get("flightrec") or []
    n_adapt = sum(1 for e in ring if e.get("type") == "adaptation")
    if n_adapt >= 3:
        add(
            "adaptation-storm",
            min(0.75, 0.25 + 0.05 * n_adapt),
            f"{n_adapt} adaptation events among the {len(ring)} newest "
            "flight-ring events",
        )

    # 7. Backend down: the history extract saw up==0, or the aggregator's
    # own statusz names dead backends.
    down = sorted(
        {
            (r.get("labels") or {}).get("instance", "?")
            for r in bundle.get("history") or []
            if r.get("name") == "up" and float(r.get("value") or 0.0) == 0.0
        }
    )
    dead_rules = [
        str(a.get("rule"))
        for a in statusz.get("alerts") or []
        if str(a.get("rule") or "").startswith("backend_dead")
    ]
    if down or dead_rules:
        who = down or [r.partition(":")[2] or r for r in dead_rules]
        add(
            "backend-down",
            0.9,
            f"up=0 scraped for instance(s) {', '.join(who)} in the "
            "capture window"
            if down
            else f"aggregator alert(s) {', '.join(dead_rules)} firing",
        )

    out = sorted(
        causes.values(), key=lambda c: (-c["score"], c["cause"])
    )
    if not out:
        out = [
            {
                "cause": rule or "unknown",
                "score": 0.1,
                "evidence": (
                    f"alert {rule} fired (value {_fmt(value)} > "
                    f"threshold {_fmt(threshold)}) but no corroborating "
                    "evidence was captured"
                    if rule
                    else "no manifest and no corroborating evidence "
                    "(partial bundle)"
                ),
            }
        ]
    return out


# -- rendering ----------------------------------------------------------------


def _history_sparklines(bundle: dict, limit: int = 6) -> list[str]:
    """Sparkline rows for the bundle's history extract (one per series,
    newest-biased, at most ``limit``)."""
    from .history import sparkline

    series: dict[str, list[float]] = {}
    for rec in bundle.get("history") or []:
        labels = rec.get("labels") or {}
        inst = labels.get("instance")
        key = str(rec.get("name", "?")) + (
            f"{{instance={inst}}}" if inst else ""
        )
        try:
            series.setdefault(key, []).append(float(rec.get("value")))
        except (TypeError, ValueError):
            continue
    rows = []
    for key in sorted(series):
        vals = series[key]
        if len(vals) < 2:
            continue
        rows.append(
            f"  {key:<44} [{sparkline(vals, width=40)}] last={vals[-1]:g}"
        )
    return rows[:limit]


def render_bundle(bundle: dict) -> str:
    """The human ``incident show`` report."""
    lines = []
    man = bundle.get("manifest") or {}
    head = f"incident {bundle['id']}"
    if man:
        head += (
            f" — rule {man.get('rule')} {man.get('state', 'firing')}, "
            f"value {_fmt(man.get('value'))} > "
            f"threshold {_fmt(man.get('threshold'))}"
        )
    lines.append(head)
    if bundle.get("partial"):
        lines.append(
            "  PARTIAL: true — no manifest; the daemon died mid-capture, "
            "evidence below may be incomplete"
        )
    if man:
        lines.append(
            f"  captured ts={_fmt(man.get('ts'))} "
            f"capture_ms={_fmt(man.get('capture_ms'))} "
            f"kind={man.get('kind', 'alert')}"
        )
        if man.get("error"):
            lines.append(f"  error: {man['error']}")
        lines.append(f"  files: {' '.join(man.get('files') or ()) or '-'}")
    res = bundle.get("resolved")
    lines.append(
        f"  resolved: value {_fmt(res.get('value'))} at "
        f"mono {_fmt(res.get('mono'))}"
        if res
        else "  resolved: no (incident still open at last write)"
    )
    pipe = bundle.get("pipeline") or {}
    if pipe:
        dom = pipe.get("dominant_stage")
        share = (pipe.get("shares") or {}).get(dom)
        cur = pipe.get("current_stage") or {}
        extra = (
            f", loop inside '{cur.get('stage')}' for "
            f"{_fmt(cur.get('for_s'))}s"
            if cur.get("stage")
            else ""
        )
        lines.append(
            f"  pipeline: dominant {dom} "
            f"(share {share * 100:.1f}%)" + extra
            if dom and share is not None
            else f"  pipeline: (no busy time){extra}"
        )
    tenants = bundle.get("top_tenants") or []
    if tenants:
        tops = ", ".join(
            f"{t.get('tenant')}@{float(t.get('rows_per_sec') or 0):g}r/s"
            for t in tenants[:4]
        )
        lines.append(f"  top tenants: {tops}")
    sparks = _history_sparklines(bundle)
    if sparks:
        lines.append("  history window:")
        lines.extend(sparks)
    tails = [
        (name, len(bundle.get(key) or []))
        for name, key in (
            ("flightrec", "flightrec"),
            ("verdicts", "verdicts_tail"),
            ("quarantine", "quarantine_tail"),
        )
    ]
    lines.append(
        "  tails: " + " ".join(f"{n}={c}" for n, c in tails)
    )
    return "\n".join(lines)


def render_diagnosis(bundle: dict, verdicts: list[dict]) -> str:
    man = bundle.get("manifest") or {}
    lines = [
        f"diagnosis — {bundle['id']}"
        + (
            f" (rule {man.get('rule')}, value {_fmt(man.get('value'))} > "
            f"{_fmt(man.get('threshold'))})"
            if man
            else ""
        )
    ]
    if bundle.get("partial"):
        lines.append(
            "  PARTIAL: true — no manifest (daemon died mid-capture); "
            "diagnosis runs on whatever evidence landed"
        )
    for i, v in enumerate(verdicts, 1):
        lines.append(
            f"  {i}. {v['cause']:<18} score {v['score']:.2f}  {v['evidence']}"
        )
    return "\n".join(lines)


# -- CLI ----------------------------------------------------------------------


def _pick_bundle(source: str) -> "tuple[str | None, list[str]]":
    """(bundle path or None, all bundles of the resolved root)."""
    if os.path.isdir(source) and _BUNDLE_RE.search(
        os.path.basename(os.path.normpath(source))
    ):
        return source, [source]
    root = resolve_incidents_dir(source)
    if root is None:
        return None, []
    bundles = list_bundles(root)
    return (bundles[-1] if bundles else None), bundles


def main(argv=None) -> int:
    """``incident``: list/show/diagnose captured incident bundles."""
    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch incident",
        description=(
            "Incident autopsy (telemetry.incident): list captured "
            "bundles, render one, or rank probable causes from its "
            "evidence — all offline, from the bundle alone."
        ),
    )
    ap.add_argument("cmd", choices=("list", "show", "diagnose"))
    ap.add_argument(
        "source",
        help="an incident-NNNN bundle, a <stem>.incidents dir, a run "
        "log, or a telemetry dir (newest .incidents inside)",
    )
    ap.add_argument("--json", action="store_true")
    ap.add_argument(
        "--store",
        default=None,
        metavar="DIR",
        help="history store: `list` adds the fleet incident index "
        "(latest serve_incidents_total per instance)",
    )
    ap.add_argument(
        "--window", type=float, default=600.0, metavar="S",
        help="fleet-index look-back window for --store (default 600)",
    )
    args = ap.parse_args(argv)

    bundle_path, bundles = _pick_bundle(args.source)
    if not bundles and bundle_path is None:
        if resolve_incidents_dir(args.source) is None:
            print(
                f"incident: no incidents at {args.source}", file=sys.stderr
            )
            return 4

    if args.cmd == "list":
        rows = [read_bundle(p) for p in bundles]
        fleet = None
        if args.store:
            from .history import last_over_time, list_segments

            if list_segments(args.store):
                fleet = {
                    dict(k).get("instance", "?"): v
                    for k, v in last_over_time(
                        args.store,
                        INCIDENTS_TOTAL_SERIES,
                        window_s=args.window,
                    ).items()
                    if v is not None
                }
        if args.json:
            print(
                json.dumps(
                    {
                        "bundles": [
                            {
                                "id": b["id"],
                                "partial": b["partial"],
                                "manifest": b["manifest"],
                                "resolved": b["resolved"] is not None,
                            }
                            for b in rows
                        ],
                        **(
                            {"fleet_incidents": fleet}
                            if fleet is not None
                            else {}
                        ),
                    },
                    indent=1,
                )
            )
        else:
            print(
                f"{'INCIDENT':<16} {'RULE':<22} {'STATE':<9} "
                f"{'VALUE':>10} {'THRESH':>8} FILES"
            )
            for b in rows:
                man = b["manifest"] or {}
                state = (
                    "PARTIAL"
                    if b["partial"]
                    else ("resolved" if b["resolved"] else "open")
                )
                print(
                    f"{b['id']:<16} {str(man.get('rule', '-')):<22} "
                    f"{state:<9} {_fmt(man.get('value')):>10} "
                    f"{_fmt(man.get('threshold')):>8} "
                    f"{len(man.get('files') or ())}"
                )
            if fleet is not None:
                print("fleet incidents (latest per instance):")
                for inst in sorted(fleet):
                    print(f"  {inst:<24} {int(fleet[inst])}")
        return 0 if rows else 3

    if bundle_path is None:
        print(f"incident: no bundles under {args.source}", file=sys.stderr)
        return 3
    bundle = read_bundle(bundle_path)
    if args.cmd == "show":
        if args.json:
            print(json.dumps(bundle, indent=1))
        else:
            print(render_bundle(bundle))
        return 0
    verdicts = diagnose(bundle)
    if args.json:
        print(
            json.dumps(
                {
                    "id": bundle["id"],
                    "partial": bundle["partial"],
                    "causes": verdicts,
                },
                indent=1,
            )
        )
    else:
        print(render_diagnosis(bundle, verdicts))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
