"""Per-tenant adaptation policy: what a drift verdict *does*.

The port's own copy of the JAX package's ``adapt/policy.py``.

The reference's algorithmic contract is react-to-drift — train on batch
*a*, predict *b*, and on a DDM signal set *a ← b*, reset the detector
and retrain (``DDM_Process.py:75-92``, steps 2-3). The compiled kernel
already performs that reaction *per microbatch* inside the scan
(``engine.loop.make_partition_step``: rotate + reset + refit-on-*b*).
This module is the **policy layer above it**: what the serving plane (or
the offline chunked loop) does with a published drift *verdict* —
nothing (``alert_only``, today's behaviour, bit-exact), a host-side
refit of that tenant's classifier on a post-drift window of real rows
(``retrain``), or a champion/challenger shadow evaluation gating the
swap on measured error (``shadow``).

jax-free by design, like the rest of the config layer: the ``serve``
CLI validates ``--on-drift`` specs without a backend, and the policy
grammar is shared with :class:`~.refit.AdaptationController`.

Spec grammar (one string per ``--on-drift`` flag, repeatable)::

    retrain                          # every tenant
    shadow,window_rows=800           # every tenant, explicit window
    2=retrain,cooldown_rows=1600     # tenant 2 only (overrides a default)

Later specs override earlier ones; a bare policy name applies
plane-wide, a ``T=`` prefix targets one tenant. Knobs:

``window_rows``
    post-drift rows to accumulate before the refit (0 = auto: one chunk
    span — the smallest window that is already striped and scored).
``cooldown_rows``
    rows after an applied adaptation during which new verdicts for that
    tenant only alert (0 = auto: 2 × window_rows). Without it a noisy
    detector would thrash refits back to back.
``margin``
    shadow promotion/demotion gate: the challenger must beat the
    champion's shadow-slice error by more than this to be promoted, and
    the champion must beat the challenger by more than this to demote
    it back.
``epsilon``
    recovery band: post-drift chunk error is "recovered" once it drops
    back within ``epsilon`` of the pre-drift running error (feeds the
    ``serve_adapt_recovery_rows`` bench cell; never gates a swap).
"""

from __future__ import annotations

from typing import NamedTuple

POLICY_KINDS = ("alert_only", "retrain", "shadow")


class AdaptPolicy(NamedTuple):
    """One tenant's resolved drift-reaction policy (see module docstring)."""

    on_drift: str = "alert_only"
    window_rows: int = 0  # 0 = auto: one chunk span
    cooldown_rows: int = 0  # 0 = auto: 2 x window_rows
    margin: float = 0.02
    epsilon: float = 0.1

    @property
    def active(self) -> bool:
        """Whether this policy ever touches the serving plane —
        ``alert_only`` tenants pay zero adaptation work (the bit-parity
        contract with a policy-free daemon)."""
        return self.on_drift != "alert_only"


def parse_policy(spec: str) -> "tuple[int | None, AdaptPolicy]":
    """Parse one ``--on-drift`` spec → ``(tenant | None, policy)``.

    ``None`` means plane-wide. Unknown kinds/knobs fail loudly here, at
    argv time, never downstream in the serve loop.
    """
    spec = spec.strip()
    if not spec:
        raise ValueError("empty on_drift policy spec")
    head, _, rest = spec.partition(",")
    tenant: "int | None" = None
    if "=" in head:
        t_str, _, kind = head.partition("=")
        try:
            tenant = int(t_str)
        except ValueError:
            raise ValueError(
                f"bad on_drift tenant prefix {t_str!r} in {spec!r}; "
                "expected T=POLICY"
            ) from None
        if tenant < 0:
            raise ValueError(f"on_drift tenant must be >= 0, got {tenant}")
    else:
        kind = head
    kind = kind.strip()
    if kind not in POLICY_KINDS:
        raise ValueError(
            f"unknown on_drift policy {kind!r}; expected one of "
            f"{POLICY_KINDS}"
        )
    kw: dict = {}
    if rest:
        for item in rest.split(","):
            if not item.strip():
                continue
            k, sep, v = item.partition("=")
            k = k.strip()
            if not sep or k not in AdaptPolicy._fields or k == "on_drift":
                knobs = [f for f in AdaptPolicy._fields if f != "on_drift"]
                raise ValueError(
                    f"bad on_drift knob {item!r} in {spec!r}; expected "
                    f"key=value with key in {knobs}"
                )
            try:
                kw[k] = (
                    float(v) if k in ("margin", "epsilon") else int(v)
                )
            except ValueError:
                raise ValueError(
                    f"bad on_drift value {item!r}; must be numeric"
                ) from None
    policy = AdaptPolicy(on_drift=kind, **kw)
    if policy.window_rows < 0 or policy.cooldown_rows < 0:
        raise ValueError(
            f"on_drift window_rows/cooldown_rows must be >= 0 in {spec!r}"
        )
    return tenant, policy


def resolve_policies(
    specs, tenants: int
) -> "list[AdaptPolicy]":
    """Expand ``--on-drift`` specs into one policy per tenant.

    Plane-wide specs set every tenant; ``T=`` specs override one slot
    (later specs win either way — CLI order is precedence). No specs at
    all means ``alert_only`` everywhere: the policy-free daemon,
    byte-identical to one that never imported this module.
    """
    out = [AdaptPolicy() for _ in range(tenants)]
    for spec in specs or ():
        tenant, policy = parse_policy(spec)
        if tenant is None:
            out = [policy for _ in range(tenants)]
        else:
            if tenant >= tenants:
                raise ValueError(
                    f"on_drift spec {spec!r} targets tenant {tenant}; the "
                    f"plane serves {tenants} tenant(s)"
                )
            out[tenant] = policy
    return out


def resolve_window_rows(policy: AdaptPolicy, rows_per_chunk: int) -> int:
    """The concrete post-drift window for a tenant (0 = auto: one chunk
    span — the per-tenant grid span of the serving plane)."""
    return int(policy.window_rows) or int(rows_per_chunk)


def resolve_cooldown_rows(policy: AdaptPolicy, window_rows: int) -> int:
    """The concrete post-apply cooldown (0 = auto: 2 × the window)."""
    return int(policy.cooldown_rows) or 2 * int(window_rows)
