"""Resilience helpers of the port: deterministic, seeded fault injection.

The port's own copies of the JAX package's jax-free ``resilience/policy.py``
(as far as :mod:`.faults` needs it) and ``resilience/faults.py``. The one
site the port fires so far is ``stream.load``, in ``io.sanitize``'s
``load_csv_sane``; the supervisor, the retry policy and ``heal`` are not
ported yet (ROADMAP A16).
"""

from .faults import InjectedFault, InjectedTimeout
from .policy import TransientError

__all__ = ["InjectedFault", "InjectedTimeout", "TransientError"]
