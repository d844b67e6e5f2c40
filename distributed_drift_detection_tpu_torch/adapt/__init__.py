"""Adaptation plane: drift-triggered live retraining with
champion/challenger serving — the port's twin of the JAX package's
``adapt/``.

The serving daemon publishes drift verdicts; this package *consumes*
them. Per-tenant policy (:mod:`.policy`, torch-free), the post-drift
window refit on the detector's device with paper-exact detector reset
(:mod:`.refit`), and champion/challenger shadow scoring with measured
promotion/demotion (:mod:`.shadow`). Every adaptation is a data update
on the detector carry at a chunk boundary.

Lazy exports (PEP 562): importing the package pulls no torch — the
``serve`` CLI validates ``--on-drift`` specs before any backend work.
"""

from __future__ import annotations

_EXPORTS = {
    "AdaptPolicy": ".policy",
    "POLICY_KINDS": ".policy",
    "parse_policy": ".policy",
    "resolve_policies": ".policy",
    "AdaptationController": ".refit",
    "WindowBuffer": ".refit",
    "extract_tenant_rows": ".refit",
    "ADAPT_STATE_SUFFIX": ".refit",
    "make_pair_scorer": ".shadow",
    "stack_sides": ".shadow",
    "should_promote": ".shadow",
    "should_demote": ".shadow",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(_EXPORTS[name], __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
