"""Adaptation plane — the port holds its policy grammar
(:mod:`.policy`, the JAX package's ``adapt/policy.py``): the serving
daemon resolves ``--on-drift`` on every start, and the default
``alert_only`` builds nothing. The reaction arm (refit, shadow scoring)
is not ported yet (ROADMAP A13); an active policy is refused by name.
"""

from __future__ import annotations

from .policy import POLICY_KINDS, AdaptPolicy, parse_policy, resolve_policies

__all__ = ["AdaptPolicy", "POLICY_KINDS", "parse_policy", "resolve_policies"]
