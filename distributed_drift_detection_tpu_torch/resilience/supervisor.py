"""Supervised execution: retry a run under a :class:`RetryPolicy`.

The port's twin of the JAX package's ``resilience/supervisor.py``. The
reference re-runs crashed work by hand (regenerate ``missing_exps.sh``,
re-submit). :func:`supervise` closes that loop in-process: it runs a
callable under a policy, classifies each failure transient-vs-fatal, backs
off deterministically, and re-raises the original exception with a note of
the attempt count — the same attempts, backoffs and notes as the JAX
package's. Its observability — each attempt inside the run registry's
``attempt_scope`` and a ``run_retried`` event a retry — is telemetry, which
the port does not run yet: with ``telemetry_dir`` set, :func:`supervise`
raises ``NotImplementedError`` naming ROADMAP A15.

Nothing here touches the reference-parity Final Time span: the supervisor
wraps ``api.run`` from the outside.

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

Pure stdlib; :func:`supervised_run` imports ``api`` (and so torch) lazily.
"""

from __future__ import annotations

import contextvars
import threading
import time

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
    sleep=time.sleep,
    on_retry=None,
):
    """Run ``fn()`` under ``policy``; returns its result.

    Retries transient failures up to ``policy.max_attempts`` total attempts
    with deterministic seeded backoff (``policy.backoff_s``); fatal
    failures and the final exhausted attempt re-raise the *original*
    exception (annotated with the attempt count), so callers keep their
    exception types. ``sleep`` is injectable for tests;
    ``on_retry(attempt, exc, backoff_s)`` is an optional observer fired
    before each backoff. ``telemetry_dir`` (the JAX package's retry log,
    labelled by its ``name``) is not ported (ROADMAP A15) and raises.
    """
    policy.validate()
    if telemetry_dir:
        raise NotImplementedError(
            "not ported yet: the supervisor's telemetry_dir (the run "
            "registry's attempt records and run_retried events, ROADMAP A15)"
        )
    for attempt in range(1, policy.max_attempts + 1):
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
            if on_retry is not None:
                on_retry(attempt, exc, backoff)
            sleep(backoff)
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
    A stream the caller passed in is not reloaded per attempt — pass
    ``stream=None`` (the default) if the failure under retry may include a
    corrupted in-memory stream."""
    from ..api import run

    return supervise(
        lambda: run(cfg, stream, device),
        policy,
        telemetry_dir=cfg.telemetry_dir or "",
        sleep=sleep,
        on_retry=on_retry,
    )
