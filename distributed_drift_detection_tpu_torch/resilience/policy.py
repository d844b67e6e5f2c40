"""Retry policy: how many attempts, how long to wait, what is worth retrying.

The reference's fault-tolerance is out-of-band re-execution — a notebook
cell counts configs with missing trials and regenerates a
``missing_exps.sh`` "in the case of a cluster crash" (SURVEY.md C14). A
:class:`RetryPolicy` is the in-band half of replacing that dance: it
decides, per failed attempt, whether the failure is *transient* (a crashed
worker, a full disk, a timeout — re-running may heal it) or *fatal* (a bad
configuration — re-running reproduces it), and how long to back off before
the next attempt.

Everything here is deterministic under a fixed ``seed``: the jitter on the
exponential backoff is derived by hashing ``(seed, attempt)`` — no global
RNG, no wall-clock — so a supervised run's retry schedule is replayable
(pinned by tests) and two hosts retrying the same policy do not thundering-
herd each other when their seeds differ.

The port's own copy of the JAX package's ``resilience/policy.py``. Pure
stdlib: policies are consulted by the supervisor (:mod:`.supervisor`)
wherever it runs.
"""

from __future__ import annotations

import hashlib
import struct
from typing import NamedTuple


class TransientError(RuntimeError):
    """Base class for failures that are transient *by construction* —
    raising (or subclassing) this is an explicit promise to the policy
    that a retry is meaningful. ``AttemptTimeout`` and the injected
    faults (``resilience.faults``) derive from it."""


class AttemptTimeout(TransientError):
    """A supervised attempt exceeded its per-attempt wall-clock budget
    (:attr:`RetryPolicy.timeout_s`). Always classified transient: a
    timeout is the canonical maybe-the-cluster-hiccuped failure."""


# Default fatal types: failures that re-running reproduces byte-for-byte.
# Configuration/programming errors (ValueError/TypeError/KeyError/
# AttributeError — a bad detector name, a shape mismatch), broken
# invariants (AssertionError), and resource exhaustion that backoff cannot
# return (MemoryError). Everything else — OSError, RuntimeError (XLA wraps
# device-side failures in RuntimeErrors), TransientError — defaults to
# transient: the supervisor exists for crashes whose exact type nobody
# predicted. KeyboardInterrupt/SystemExit never reach classification (the
# supervisor only catches ``Exception``).
FATAL_TYPES: tuple[type, ...] = (
    ValueError,
    TypeError,
    KeyError,
    AttributeError,
    AssertionError,
    MemoryError,
    NotImplementedError,
)


def _unit_interval(seed: int, *parts: object) -> float:
    """Deterministic uniform in [0, 1) from a seed and context parts:
    SHA-256 of the canonical tuple string, top 8 bytes as a fraction.
    Shared with ``resilience.faults`` for seeded Bernoulli sites."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    (n,) = struct.unpack(">Q", h[:8])
    return n / 2**64


class RetryPolicy(NamedTuple):
    """Retry/backoff policy for supervised execution.

    ``max_attempts`` counts the first try: 3 means one run plus up to two
    retries; 1 disables retrying (the supervisor then only adds the
    timeout bracket and the registry ``attempt`` field). ``timeout_s``
    (None = unlimited) is the per-attempt wall-clock budget — exceeding it
    raises :class:`AttemptTimeout`, which is transient.

    Backoff before retry ``n`` (1-based failed-attempt index) is
    ``min(backoff_base_s · backoff_factor^(n-1), backoff_max_s)``,
    stretched by a seeded jitter of up to ``±jitter`` (a fraction):
    deterministic under a fixed ``seed``, different across seeds — two
    workers with distinct seeds never resynchronize their retries.

    ``transient_types`` / ``fatal_types`` drive :meth:`classify`; fatal
    wins on overlap, unlisted exception types default to transient (see
    :data:`FATAL_TYPES` for the rationale).
    """

    max_attempts: int = 3
    backoff_base_s: float = 0.5
    backoff_factor: float = 2.0
    backoff_max_s: float = 30.0
    jitter: float = 0.1
    seed: int = 0
    timeout_s: float | None = None
    transient_types: tuple[type, ...] = (TransientError,)
    fatal_types: tuple[type, ...] = FATAL_TYPES

    def validate(self) -> "RetryPolicy":
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {self.timeout_s}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff seconds must be >= 0")
        return self

    def classify(self, exc: BaseException) -> str:
        """``'transient'`` (retry may heal it) or ``'fatal'`` (it won't).

        Explicit ``transient_types`` outrank the fatal defaults — a caller
        who lists a ``ValueError`` subclass as transient has said so on
        purpose — but the stock ``TransientError`` base never shadows a
        genuine fatal type (no fatal type derives from it).
        """
        if isinstance(exc, self.transient_types):
            return "transient"
        if isinstance(exc, self.fatal_types):
            return "fatal"
        return "transient"

    def backoff_s(self, attempt: int) -> float:
        """Seconds to wait after failed attempt ``attempt`` (1-based).

        Deterministic: same (policy, attempt) → same float, always.
        """
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        delay = min(
            self.backoff_base_s * self.backoff_factor ** (attempt - 1),
            self.backoff_max_s,
        )
        if self.jitter:
            u = _unit_interval(self.seed, "backoff", attempt)
            delay *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return float(delay)


# The no-retry policy: one attempt, no timeout. The supervisor with this
# policy is a plain call plus the registry ``attempt`` bracket — what the
# grid harness uses when ``retries=0`` so the wiring has one shape.
NO_RETRY = RetryPolicy(max_attempts=1)
