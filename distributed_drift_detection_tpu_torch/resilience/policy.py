"""What :mod:`.faults` needs of the JAX package's ``resilience/policy.py``:
the transient-failure base class and the seeded unit interval. The retry
policy itself waits for the supervisor (ROADMAP A16).

Pure stdlib.
"""

from __future__ import annotations

import hashlib
import struct


class TransientError(RuntimeError):
    """Base class for failures that are transient *by construction* —
    raising (or subclassing) this is an explicit promise to a retry policy
    that a retry is meaningful. The injected faults (:mod:`.faults`)
    derive from it."""


def _unit_interval(seed: int, *parts: object) -> float:
    """Deterministic uniform in [0, 1) from a seed and context parts:
    SHA-256 of the canonical tuple string, top 8 bytes as a fraction.
    Shared with :mod:`.faults` for seeded Bernoulli sites."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    (n,) = struct.unpack(">Q", h[:8])
    return n / 2**64
