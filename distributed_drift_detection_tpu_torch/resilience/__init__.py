"""Resilience of the port: supervised execution, sweep healing and
deterministic, seeded fault injection — the port's own copies of the JAX
package's ``resilience/policy.py``, ``supervisor.py``, ``heal.py`` and
``faults.py``.

* :mod:`.policy` — :class:`RetryPolicy`: attempts, deterministic seeded
  exponential backoff, per-attempt wall-clock timeout, transient-vs-fatal
  exception classification.
* :mod:`.supervisor` — :func:`supervise` / :func:`supervised_run`: run a
  callable / ``api.run`` under a policy, outside the Final Time span.
* :mod:`.heal` — diff a sweep spec against the run registry and re-run
  (or plan, or push to the scheduler) exactly the missing trials.
* :mod:`.faults` — seeded fault injection at named sites, fired at
  ``stream.load`` (``io.sanitize``), ``grid.cell`` (``harness.grid``),
  ``api.run``, ``telemetry.emit``, ``sched.lease`` and ``sched.worker``.

Importing this package loads no torch.
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
