"""Lease/queue state machine + the exactly-once registry audit — the port's
own copy of the JAX package's ``sched/leases.py``.

Pure data structures, no sockets, no torch: the scheduler daemon drives
this under its one lock, and the unit tests drive it directly with a
fake clock. A **cell** is one expected trial (heal's plan unit — app
name, config digest, wire config); its lifecycle is

    queued ──grant──▶ leased ──complete──▶ completed
      ▲                 │ │
      │◀──── revoke ────┘ └──fail──▶ queued (attempts left) | failed

**Exactly-once contract**: execution is
at-least-once — a revoked worker may have died anywhere in its cell —
but *recorded completion* is at-most-once per expected trial: a lease is
granted to one worker, a ``complete``/``fail`` is accepted only from the
worker currently holding the live lease, and a revoked lease's late
completion is discarded (``accepted=False``). The registry is the
ground truth the final :func:`audit_exactly_once` checks: every expected
digest completed exactly as many times as the sweep expects it, no more.
The one hole — a *wedged* (not dead) worker that unwedges after its
lease was revoked and still writes its registry record — is the same
documented caveat as ``resilience.supervisor``'s abandoned-attempt
timeout, and the worker narrows it by aborting a cell the moment a
heartbeat reply says ``revoked``.
"""

from __future__ import annotations

from collections import Counter

# Terminal cell states; everything else is in flight.
QUEUED, LEASED, COMPLETED, FAILED = "queued", "leased", "completed", "failed"


class Cell:
    """One expected trial: identity + wire config + lifecycle state."""

    __slots__ = (
        "app_name", "digest", "wire", "geometry", "state", "attempts",
        "worker",
    )

    def __init__(self, wire: dict):
        self.app_name = str(wire["app_name"])
        self.digest = str(wire["digest"])
        self.wire = wire
        # Static geometry = the payload minus the per-trial seed: trials
        # of one sweep config share a worker's warm state (its loaded
        # kernel libraries, its CUDA context's first-touch setup), so the
        # grant path prefers handing a worker geometries it has run.
        payload = wire.get("payload") or {}
        self.geometry = tuple(
            sorted((k, str(v)) for k, v in payload.items() if k != "seed")
        )
        self.state = QUEUED
        self.attempts = 0  # leases granted (≠ the supervisor's retries)
        self.worker: "str | None" = None  # current/last holder

    def snapshot(self) -> dict:
        return {
            "app_name": self.app_name,
            "digest": self.digest,
            "state": self.state,
            "attempts": self.attempts,
            "worker": self.worker,
        }


class Lease:
    """One live grant: (cell, worker, monotonic expiry). The expiry is
    heartbeat-refreshed — the lease TTL *is* the stall budget, the
    ``watch --stall-after`` contract applied to the worker's beats."""

    __slots__ = ("lease_id", "cell", "worker", "expires_mono")

    def __init__(self, lease_id: str, cell: Cell, worker: str, expires: float):
        self.lease_id = lease_id
        self.cell = cell
        self.worker = worker
        self.expires_mono = expires


class CellQueue:
    """The scheduler's work ledger. NOT thread-safe — the daemon owns
    one lock around every call (and the tests need none)."""

    def __init__(self, *, lease_s: float, max_attempts: int = 3):
        if lease_s <= 0:
            raise ValueError(f"lease_s must be > 0, got {lease_s}")
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.lease_s = float(lease_s)
        self.max_attempts = int(max_attempts)
        self.cells: "dict[str, Cell]" = {}  # app_name → cell (sweep order)
        self.leases: "dict[str, Lease]" = {}
        self._lease_seq = 0
        # Geometry affinity (see Cell.geometry): worker → geometries it
        # has held leases for. Never evicted — a dead worker's entry is
        # just never matched again.
        self._seen: "dict[str, set]" = {}

    # -- intake --------------------------------------------------------------

    def add(self, wires: "list[dict]") -> "tuple[int, int]":
        """Enqueue wire cells; returns ``(queued, duplicates)``. A cell
        already known (by app name — the per-trial-unique key) is a
        duplicate and is NOT re-queued: submissions are idempotent, the
        same contract as heal's generated script."""
        queued = dups = 0
        for wire in wires:
            cell = Cell(wire)
            if cell.app_name in self.cells:
                dups += 1
                continue
            self.cells[cell.app_name] = cell
            queued += 1
        return queued, dups

    def mark_completed(self, app_names: "set[str]") -> int:
        """Pre-complete cells the registry already shows done (resume
        semantics — the scheduler never re-runs recorded work)."""
        n = 0
        for name in app_names:
            cell = self.cells.get(name)
            if cell is not None and cell.state == QUEUED:
                cell.state = COMPLETED
                n += 1
        return n

    # -- lease lifecycle -----------------------------------------------------

    def grant(self, worker: str, now: float) -> "Lease | None":
        """Lease the next queued cell to ``worker``; ``None`` when
        nothing is grantable right now.

        **Geometry-affinity placement**: among queued cells, one whose
        static geometry this worker has already held wins (its state is
        warm in that worker); otherwise a geometry *no* worker has held yet
        (spread the cold starts across the fleet); otherwise plain sweep
        order."""
        seen = self._seen.get(worker, set())
        taken = set()
        for group in self._seen.values():
            taken |= group
        first = affine = fresh = None
        for cell in self.cells.values():
            if cell.state != QUEUED:
                continue
            if first is None:
                first = cell
            if affine is None and cell.geometry in seen:
                affine = cell
                break  # best class; sweep order within it
            if fresh is None and cell.geometry not in taken:
                fresh = cell
        cell = affine or fresh or first
        if cell is None:
            return None
        self._lease_seq += 1
        lease = Lease(
            f"L{self._lease_seq}", cell, worker, now + self.lease_s
        )
        cell.state = LEASED
        cell.attempts += 1
        cell.worker = worker
        self.leases[lease.lease_id] = lease
        self._seen.setdefault(worker, set()).add(cell.geometry)
        return lease

    def heartbeat(self, lease_id: str, now: float) -> bool:
        """Refresh a live lease's TTL; False = the lease is gone (the
        worker must abandon the cell)."""
        lease = self.leases.get(lease_id)
        if lease is None:
            return False
        lease.expires_mono = now + self.lease_s
        return True

    def complete(self, lease_id: str, worker: str) -> "Cell | None":
        """Accept a completion from the live lease holder; ``None`` =
        discarded (revoked/unknown lease, or another worker's — the
        at-most-once-recorded half of the contract)."""
        lease = self.leases.get(lease_id)
        if lease is None or lease.worker != worker:
            return None
        del self.leases[lease_id]
        lease.cell.state = COMPLETED
        return lease.cell

    def fail(self, lease_id: str, worker: str) -> "tuple[Cell, bool] | None":
        """A reported attempt failure: requeue while lease-attempts
        remain, else mark the cell failed. Returns ``(cell, requeued)``;
        ``None`` = stale lease, report discarded."""
        lease = self.leases.get(lease_id)
        if lease is None or lease.worker != worker:
            return None
        del self.leases[lease_id]
        cell = lease.cell
        requeued = cell.attempts < self.max_attempts
        cell.state = QUEUED if requeued else FAILED
        return cell, requeued

    def revoke_expired(self, now: float) -> "list[Lease]":
        """Revoke every lease past its (heartbeat-refreshed) expiry — the
        stall contract: a worker silent longer than ``lease_s`` is dead
        or wedged either way. Revoked cells requeue (or fail past the
        attempt budget)."""
        expired = [
            lease for lease in self.leases.values()
            if now >= lease.expires_mono
        ]
        for lease in expired:
            self._revoke(lease)
        return expired

    def revoke_worker(self, worker: str) -> "list[Lease]":
        """Revoke every lease a (disconnected) worker holds."""
        held = [
            lease for lease in self.leases.values() if lease.worker == worker
        ]
        for lease in held:
            self._revoke(lease)
        return held

    def _revoke(self, lease: Lease) -> None:
        del self.leases[lease.lease_id]
        cell = lease.cell
        cell.state = (
            QUEUED if cell.attempts < self.max_attempts else FAILED
        )

    # -- views ---------------------------------------------------------------

    def counts(self) -> dict:
        c = Counter(cell.state for cell in self.cells.values())
        return {
            "total": len(self.cells),
            "queued": c[QUEUED],
            "leased": c[LEASED],
            "completed": c[COMPLETED],
            "failed": c[FAILED],
        }

    def whole(self) -> bool:
        """Every cell terminal (completed or failed) and no lease live —
        the scheduler's exit condition. An empty ledger is NOT whole:
        a scheduler started bare waits for its first submission."""
        return bool(self.cells) and not self.leases and all(
            cell.state in (COMPLETED, FAILED)
            for cell in self.cells.values()
        )

    def expected_digests(self) -> Counter:
        """Digest multiset of every cell the sweep expects — the audit's
        left-hand side (trials of one config digest distinctly, so the
        multiset degenerates to a set in practice but never assumes it)."""
        return Counter(cell.digest for cell in self.cells.values())


def audit_exactly_once(telemetry_dir: str, expected: Counter) -> dict:
    """The registry-ground-truth audit: did every expected trial complete
    **exactly once**? Diffs ``expected`` (digest multiset) against the
    registry's current ``completed`` records (``heal.completed_digests``
    — same fold ``watch``/``report`` read). Returns ``{ok, missing,
    duplicates}`` where ``missing``/``duplicates`` map digest → count;
    a duplicate means two completed records landed for one expected
    trial — the exactly-once violation the scheduler exists to prevent.
    No torch."""
    from ..resilience.heal import completed_digests

    done = completed_digests(telemetry_dir)
    missing = {
        d: n - done.get(d, 0) for d, n in expected.items()
        if done.get(d, 0) < n
    }
    duplicates = {
        d: done[d] - expected.get(d, 0) for d in done
        if d in expected and done[d] > expected[d]
    }
    return {
        "ok": not missing and not duplicates,
        "missing": missing,
        "duplicates": duplicates,
    }
