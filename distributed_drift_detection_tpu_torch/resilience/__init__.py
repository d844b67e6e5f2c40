"""Resilience of the port: supervised execution and deterministic, seeded
fault injection — the port's own copies of the JAX package's
``resilience/policy.py``, ``supervisor.py`` and ``faults.py``.

* :mod:`.policy` — :class:`RetryPolicy`: attempts, deterministic seeded
  exponential backoff, per-attempt wall-clock timeout, transient-vs-fatal
  exception classification.
* :mod:`.supervisor` — :func:`supervise` / :func:`supervised_run`: run a
  callable / ``api.run`` under a policy, outside the Final Time span.
* :mod:`.faults` — seeded fault injection at named sites, fired so far at
  ``stream.load`` (``io.sanitize``) and ``grid.cell`` (``harness.grid``).

``heal`` and the supervisor's registry records wait for the run registry
(ROADMAP A15, then A16b). Importing this package loads no torch.
"""

from .faults import InjectedFault, InjectedTimeout
from .policy import NO_RETRY, AttemptTimeout, RetryPolicy, TransientError
from .supervisor import supervise, supervised_run

__all__ = [
    "AttemptTimeout",
    "InjectedFault",
    "InjectedTimeout",
    "NO_RETRY",
    "RetryPolicy",
    "TransientError",
    "supervise",
    "supervised_run",
]
