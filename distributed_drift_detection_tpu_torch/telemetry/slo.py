"""Declarative SLO rules + the serving daemon's alerting engine.

The port's own copy of the JAX package's ``telemetry/slo.py``.

A run log records what happened; nothing so far ever *judged* it. This
module closes that gap for the online path: a small set of declarative
rules is evaluated on a cadence against a live snapshot of the daemon,
and every threshold crossing emits a schema-v1 ``alert`` event
(``state="firing"`` / ``"resolved"``) into the run log — so alerts are
ordinary, durable, torn-tail-tolerant telemetry that ``report``/``top``
render and the ops plane's ``/healthz`` surfaces as a status code.

Rule kinds (one rule per kind; the snapshot supplies the value under the
same key, ``None`` = not currently measurable, rule skipped):

=====================  ====================================================
``p99_ms``             live p99 of ``serve_row_latency_seconds{stage=
                       "total"}`` (``telemetry.trace.hist_quantile``), ms
``verdict_age_s``      seconds since the last verdict was published —
                       staleness of the daemon's *output*
``quarantine_pct``     100 · quarantined / ingress rows seen — dirty-
                       traffic share at admission
``stall_s``            seconds since the serve loop last completed an
                       iteration (its in-process liveness stamp — works
                       with or without a run log; heartbeat events are
                       the durable trace of the same signal) — the
                       in-process twin of ``watch --stall-after``: a
                       firing means the loop itself is wedged
=====================  ====================================================

Beyond single-sample thresholds, ``kind=burn_rate`` rules judge a series
*over time* — the SRE multi-window error-budget pattern. The grammar is
``burn_rate=SERIES:OBJECTIVE:FAST/SLOW:FACTOR`` (e.g.
``burn_rate=p99_ms:250:30/300:1.0``): the rule computes the windowed
average of SERIES over a FAST and a SLOW window (seconds), divides each
by OBJECTIVE to get a burn rate, and fires only while **both** exceed
FACTOR — the fast window gives detection latency, the slow window
vetoes one-sample blips, so a transient spike never pages but a
sustained burn does. Series values come either from the snapshot dict
(in-process serve mode: the engine keeps its own ring of recent samples,
one per evaluator tick) or from a ``window_avg_fn`` the caller injects
(collector mode: ``history.avg_over_time`` over the fleet store). Burn
alerts are named ``burn_rate:SERIES`` and ride the same schema-v1
``alert`` events, so ``report``/``top``/``/healthz`` need no new
plumbing; multiple burn rules may coexist as long as their series
differ.

When constructed with a :class:`~.metrics.MetricsRegistry`, the engine
also exports live alert state as ``slo_alert_active{rule}`` gauges —
1 while firing, 0 otherwise, pre-registered at 0 for every rule so the
series (and its HELP line) exists on ``/metrics`` before anything ever
fires. Gauges are re-synced from the firing set *after* emit-failure
rollback, so the scraped state never diverges from the log.

The evaluator runs on its own daemon thread (:func:`start_evaluator`):
the serve loop's blocking points (device sync, an injected
``serve.flush`` stall) are exactly what ``stall_s`` must detect, so the
judge cannot live on the thread being judged. ``EventLog.emit`` is
thread-safe (internal lock), and the evaluator only ever *reads* runner
state — it owns no locks of its own. Alerts are emitted strictly outside
any ``api.run`` Final Time span (the evaluator exists only in the serve
daemon; the purity tests are untouched by construction).

No jax, stdlib only — importable by the jax-free CLIs.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, NamedTuple

RULE_KINDS = ("p99_ms", "verdict_age_s", "quarantine_pct", "stall_s")

#: The multi-window burn-rate kind (its value part has its own grammar,
#: see the module docstring; not a snapshot key itself — ``series`` is).
BURN_KIND = "burn_rate"

#: Live alert state on /metrics: 1 while the labeled rule fires.
ALERT_ACTIVE_METRIC = "slo_alert_active"
ALERT_ACTIVE_HELP = (
    "1 while the SLO rule named by the 'rule' label is firing, 0 "
    "otherwise (pre-registered at 0 for every configured rule)"
)


class SloRule(NamedTuple):
    """One declarative rule: fire while ``value > threshold``. For
    ``kind=burn_rate`` the threshold is the burn FACTOR and the extra
    fields describe the series and window pair (zero/empty otherwise)."""

    kind: str
    threshold: float
    series: str = ""
    objective: float = 0.0
    fast_s: float = 0.0
    slow_s: float = 0.0


def rule_name(rule: SloRule) -> str:
    """The alert/gauge identity of a rule: the kind for threshold rules,
    ``burn_rate:SERIES`` for burn rules (several may coexist)."""
    return f"{rule.kind}:{rule.series}" if rule.kind == BURN_KIND else rule.kind


def _parse_burn(spec: str, value: str) -> SloRule:
    """``SERIES:OBJECTIVE:FAST/SLOW:FACTOR`` → a burn-rate rule."""
    parts = value.split(":")
    bad = ValueError(
        f"bad burn_rate rule {spec!r}; expected "
        "burn_rate=SERIES:OBJECTIVE:FAST/SLOW:FACTOR "
        "(e.g. burn_rate=p99_ms:250:30/300:1.0)"
    )
    if len(parts) != 4 or not parts[0].strip():
        raise bad
    series = parts[0].strip()
    fast_str, sep, slow_str = parts[2].partition("/")
    if not sep:
        raise bad
    try:
        objective = float(parts[1])
        fast_s = float(fast_str)
        slow_s = float(slow_str)
        factor = float(parts[3])
    except ValueError:
        raise bad from None
    if objective <= 0 or factor <= 0:
        raise ValueError(
            f"burn_rate rule {spec!r}: objective and factor must be > 0"
        )
    if not 0 < fast_s < slow_s:
        raise ValueError(
            f"burn_rate rule {spec!r}: need 0 < FAST < SLOW "
            f"(got {fast_s:g}/{slow_s:g}) — the slow window is the veto"
        )
    return SloRule(BURN_KIND, factor, series, objective, fast_s, slow_s)


def parse_rules(specs) -> tuple[SloRule, ...]:
    """Parse ``kind=threshold`` strings (the ``--slo`` CLI grammar) into
    rules; unknown kinds and unparseable thresholds fail loudly. The
    single spec ``none`` (or ``off``) disables alerting entirely."""
    rules: list[SloRule] = []
    specs = list(specs)
    if [s.strip().lower() for s in specs] in (["none"], ["off"]):
        return ()
    for spec in specs:
        kind, sep, value = spec.partition("=")
        kind = kind.strip()
        if sep and kind == BURN_KIND:
            rule = _parse_burn(spec, value)
            if any(rule_name(r) == rule_name(rule) for r in rules):
                raise ValueError(
                    f"duplicate burn_rate rule for series {rule.series!r}"
                )
            rules.append(rule)
            continue
        if not sep or kind not in RULE_KINDS:
            raise ValueError(
                f"bad SLO rule {spec!r}; expected kind=threshold with kind "
                f"one of {RULE_KINDS + (BURN_KIND,)} (or the single spec "
                "'none')"
            )
        try:
            threshold = float(value)
        except ValueError:
            raise ValueError(
                f"bad SLO threshold in {spec!r}: {value!r} is not a number"
            ) from None
        if any(r.kind == kind for r in rules):
            # One rule per kind is the engine's state-machine contract:
            # two thresholds on one kind would fire/resolve against each
            # other every evaluator tick, flooding the log with alerts.
            raise ValueError(f"duplicate SLO rule kind {kind!r}")
        rules.append(SloRule(kind, threshold))
    return tuple(rules)


class SloEngine:
    """Threshold-crossing state machine over the rule set.

    :meth:`evaluate` is called with a snapshot dict (rule kind → current
    value or ``None``); each crossing INTO violation emits one
    ``firing`` transition, each crossing back OUT one ``resolved`` —
    never a re-fire per cadence tick. :meth:`active` lists the currently
    firing alerts (the ``/healthz`` and ``/statusz`` surface).
    """

    def __init__(
        self,
        rules: "tuple[SloRule, ...]",
        *,
        window_avg_fn=None,
        metrics=None,
        now_fn: Callable[[], float] = time.monotonic,
    ):
        """``window_avg_fn(series, window_s) -> float | None`` supplies
        windowed averages for burn rules from an external store (the
        collector injects ``history.avg_over_time`` over the fleet
        store); without it, the engine rings up its own samples from the
        snapshot, one per tick. ``metrics`` (a MetricsRegistry) enables
        the ``slo_alert_active{rule}`` gauges."""
        self.rules = tuple(rules)
        self._firing: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._window_avg_fn = window_avg_fn
        self._now_fn = now_fn
        #: Optional transition observer, called once per *successfully
        #: emitted* transition dict, on the evaluator thread — the
        #: incident recorder's capture hook. Rolled-back transitions are
        #: never observed (they re-fire next tick), so an observer sees
        #: exactly the transitions the log recorded. Failures are
        #: swallowed: evidence capture must never kill the judge.
        self.observer = None
        # rule name -> ring of (mono_ts, value) bounded by the slow window
        self._history: dict[str, deque] = {}
        self._gauge = None
        if metrics is not None:
            self._gauge = metrics.gauge(ALERT_ACTIVE_METRIC, ALERT_ACTIVE_HELP)
            for rule in self.rules:
                self._gauge.set(0.0, rule=rule_name(rule))

    def _burn_value(self, rule: SloRule, snapshot: dict) -> "float | None":
        """Current burn of a burn-rate rule: the *limiting* (smaller) of
        the fast/slow window burns — above the factor iff BOTH windows
        burn, which folds the multi-window AND into one scalar the
        generic threshold state machine can judge. ``None`` while either
        window is empty."""
        if self._window_avg_fn is not None:
            fast = self._window_avg_fn(rule.series, rule.fast_s)
            slow = self._window_avg_fn(rule.series, rule.slow_s)
        else:
            v = snapshot.get(rule.series)
            ring = self._history.setdefault(rule_name(rule), deque())
            now = self._now_fn()
            if v is not None:
                ring.append((now, float(v)))
            while ring and ring[0][0] < now - rule.slow_s:
                ring.popleft()
            fast_vals = [x for t, x in ring if t >= now - rule.fast_s]
            slow_vals = [x for _, x in ring]
            fast = sum(fast_vals) / len(fast_vals) if fast_vals else None
            slow = sum(slow_vals) / len(slow_vals) if slow_vals else None
        if fast is None or slow is None:
            return None
        # min(): the rule fires iff BOTH burns exceed the factor, i.e.
        # iff the smaller one does — so the generic `value > threshold`
        # state machine below needs no special casing.
        return min(fast / rule.objective, slow / rule.objective)

    def evaluate(self, snapshot: dict, emit=None) -> list[dict]:
        """One cadence tick; returns the transitions (also handed, one by
        one, to ``emit(etype, **fields)`` — an ``EventLog.emit``-shaped
        callable — when given)."""
        transitions: list[dict] = []
        with self._lock:
            for rule in self.rules:
                if rule.kind == BURN_KIND:
                    value = self._burn_value(rule, snapshot)
                else:
                    value = snapshot.get(rule.kind)
                if value is None:
                    continue
                value = float(value)
                name = rule_name(rule)
                firing = value > rule.threshold
                was = name in self._firing
                if firing and not was:
                    rec = {
                        "rule": name,
                        "state": "firing",
                        "value": value,
                        "threshold": rule.threshold,
                        # monotonic stamp as a schema-legal extra, so
                        # incident/history timelines rebase alert
                        # transitions across restarts exactly like
                        # heartbeats (events.py carries extras verbatim)
                        "mono": self._now_fn(),
                    }
                    self._firing[name] = rec
                    transitions.append(rec)
                elif firing and was:
                    # keep the surfaced value current for /statusz
                    self._firing[name]["value"] = value
                elif not firing and was:
                    del self._firing[name]
                    transitions.append(
                        {
                            "rule": name,
                            "state": "resolved",
                            "value": value,
                            "threshold": rule.threshold,
                            "mono": self._now_fn(),
                        }
                    )
        emitted = transitions
        if emit is not None:
            for i, t in enumerate(transitions):
                try:
                    emit("alert", **t)
                except Exception:
                    # The log refused the event (full disk, closed file):
                    # roll back this AND every not-yet-emitted transition
                    # of the tick, so surfaced state never diverges from
                    # the log and the next tick re-attempts the same
                    # crossings instead of losing them.
                    with self._lock:
                        for u in transitions[i:]:
                            if u["state"] == "firing":
                                self._firing.pop(u["rule"], None)
                            else:
                                self._firing[u["rule"]] = {
                                    **u, "state": "firing"
                                }
                    emitted = transitions[:i]
                    break
        self._sync_gauges()
        if self.observer is not None:
            for t in emitted:
                try:
                    self.observer(dict(t))
                except Exception:
                    pass  # capture failure must never kill the evaluator
        return emitted

    def _sync_gauges(self) -> None:
        """Re-derive every ``slo_alert_active`` gauge from the firing set
        — called after emit handling so rollback is reflected too."""
        if self._gauge is None:
            return
        with self._lock:
            firing = set(self._firing)
        for rule in self.rules:
            name = rule_name(rule)
            self._gauge.set(1.0 if name in firing else 0.0, rule=name)

    def active(self) -> list[dict]:
        """Currently firing alerts (copies, newest values)."""
        with self._lock:
            return [dict(v) for v in self._firing.values()]


def start_evaluator(
    engine: SloEngine,
    snapshot_fn: Callable[[], dict],
    emit,
    interval_s: float,
) -> "tuple[threading.Thread, threading.Event]":
    """Run the engine on a daemon thread every ``interval_s`` seconds
    until the returned stop event is set. A snapshot failure skips the
    tick and retries next cadence (emit failures are already rolled
    back inside :meth:`SloEngine.evaluate`): a transient error must not
    permanently kill the judge — a dead evaluator would freeze
    ``/healthz`` at whatever state it last surfaced."""
    stop = threading.Event()

    def loop() -> None:
        while not stop.is_set():
            try:
                engine.evaluate(snapshot_fn(), emit)
            except Exception:
                pass  # transient; the wait below bounds the retry rate
            stop.wait(max(interval_s, 0.01))

    thread = threading.Thread(target=loop, name="serve-slo", daemon=True)
    thread.start()
    return thread, stop
