"""Supervised execution: retry a run under a :class:`RetryPolicy`.

The port's twin of the JAX package's ``resilience/supervisor.py``. The
reference re-runs crashed work by hand (regenerate ``missing_exps.sh``,
re-submit). :func:`supervise` closes that loop in-process: it runs a
callable under a policy, classifies each failure transient-vs-fatal, backs
off deterministically, and re-raises the original exception with a note of
the attempt count — the same attempts, backoffs and notes as the JAX
package's. Every attempt is observable:

* each attempt runs inside ``telemetry.registry.attempt_scope(n)``, so the
  ``running``/``completed``/``failed`` records it writes into
  ``index.jsonl`` carry an ``attempt`` field (a healed run reads as
  ``failed(attempt=1) → completed(attempt=2)``);
* with ``telemetry_dir`` set, each retry emits a schema-v1 ``run_retried``
  event into a supervisor log of its own in that directory (opened at the
  first retry — a run that never retries leaves no extra artifact).

Nothing here touches the reference-parity Final Time span: the supervisor
wraps ``api.run`` from the outside, and its telemetry lands between
attempts.

The per-attempt wall-clock timeout runs the attempt on a worker thread and
abandons it on expiry (Python cannot kill a thread): the supervisor, and
its caller's schedule, moves on. :class:`AttemptTimeout` is transient by
construction. What an abandoned attempt can still hold on the card: its
thread goes on to the end of its ``api.run`` — it keeps launching kernels
on PyTorch's current stream of the device, which the retry shares, so the
two attempts' launches interleave on one stream (each run's own tensors
are its own, so neither changes the other's results, but the retry's
timings include the abandoned attempt's work), and it keeps its device
tensors (the uploaded stream, the flag planes, the model's parameters)
allocated until it returns. An abandoned attempt that later finishes still
writes its side effects, such as its results-CSV row, concurrently with
the retry, so a timed-out-then-completed trial can leave a duplicate row
for that one trial (trial keys are unique per trial, so the resume
over-counts that trial rather than skipping another). Prefer budgets
comfortably above the expected attempt time — the timeout is a hung-run
escape hatch, not a scheduler.

Pure stdlib and the torch-free telemetry core; :func:`supervised_run`
imports ``api`` (and so torch) lazily.
"""

from __future__ import annotations

import contextvars
import threading
import time

from ..telemetry import registry as run_registry
from .policy import AttemptTimeout, RetryPolicy


def _call_with_timeout(fn, timeout_s: float | None):
    """Run ``fn()`` with a wall-clock budget; raise :class:`AttemptTimeout`
    on expiry (the worker thread is abandoned — see module docstring)."""
    if not timeout_s:
        return fn()
    box: dict = {}
    # the attempt runs under the supervising thread's context (a fresh
    # thread starts with an empty one)
    ctx = contextvars.copy_context()

    def target():
        try:
            box["value"] = ctx.run(fn)
        except BaseException as e:  # re-raised on the supervising thread
            box["error"] = e

    t = threading.Thread(target=target, daemon=True, name="supervised-attempt")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise AttemptTimeout(
            f"attempt exceeded its {timeout_s} s wall-clock budget "
            "(worker thread abandoned)"
        )
    if "error" in box:
        raise box["error"]
    return box["value"]


def supervise(
    fn,
    policy: RetryPolicy = RetryPolicy(),
    *,
    telemetry_dir: str = "",
    name: str = "",
    sleep=time.sleep,
    on_retry=None,
):
    """Run ``fn()`` under ``policy``; returns its result.

    Retries transient failures up to ``policy.max_attempts`` total attempts
    with deterministic seeded backoff (``policy.backoff_s``); fatal
    failures and the final exhausted attempt re-raise the *original*
    exception (annotated with the attempt count), so callers keep their
    exception types. ``telemetry_dir`` enables the retry log described in
    the module docstring; ``name`` labels it. ``sleep`` is injectable for
    tests; ``on_retry(attempt, exc, backoff_s)`` is an optional observer
    fired before each backoff.
    """
    policy.validate()
    log = None
    try:
        for attempt in range(1, policy.max_attempts + 1):
            with run_registry.attempt_scope(attempt):
                try:
                    return _call_with_timeout(fn, policy.timeout_s)
                except Exception as exc:
                    kind = policy.classify(exc)
                    if kind == "fatal" or attempt >= policy.max_attempts:
                        exc.add_note(
                            f"supervisor: attempt {attempt}/{policy.max_attempts} "
                            + (
                                "failed fatally (not retried)"
                                if kind == "fatal"
                                else "exhausted the retry budget"
                            )
                        )
                        raise
                    backoff = policy.backoff_s(attempt)
                    if telemetry_dir:
                        if log is None:
                            from ..telemetry.events import EventLog

                            log = EventLog.open_run(
                                telemetry_dir, name=(name or "supervised") + "-retries"
                            )
                        log.emit(
                            "run_retried",
                            attempt=attempt,
                            max_attempts=policy.max_attempts,
                            reason=f"{type(exc).__name__}: {exc}",
                            backoff_s=backoff,
                            classification=kind,
                        )
                    if on_retry is not None:
                        on_retry(attempt, exc, backoff)
                    sleep(backoff)
    finally:
        if log is not None:
            log.close()
    raise AssertionError("unreachable: the loop returns or raises")


def supervised_run(
    cfg,
    policy: RetryPolicy = RetryPolicy(),
    *,
    stream=None,
    device="cuda",
    sleep=time.sleep,
    on_retry=None,
):
    """``api.run(cfg, stream, device)`` under a retry policy — the
    resilience wrapper for one configured run; returns its ``RunResult``.
    With ``cfg.telemetry_dir`` set, every attempt registers itself in the
    directory's ``index.jsonl`` with its ``attempt`` number (``api.run``'s
    own registry bracket inside :func:`attempt_scope
    <..telemetry.registry.attempt_scope>`), and each retry emits a
    ``run_retried`` event. A stream the caller passed in is not reloaded per attempt — pass
    ``stream=None`` (the default) if the failure under retry may include a
    corrupted in-memory stream."""
    from ..api import run

    return supervise(
        lambda: run(cfg, stream, device),
        policy,
        telemetry_dir=cfg.telemetry_dir or "",
        name=cfg.resolved_app_name(),
        sleep=sleep,
        on_retry=on_retry,
    )
