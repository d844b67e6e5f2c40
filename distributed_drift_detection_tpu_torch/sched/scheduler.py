"""The scheduler daemon: a lease-based work queue over the run registry —
the port's own copy of the JAX package's ``sched/scheduler.py``.

    python -m distributed_drift_detection_tpu_torch sched [SPEC] \\
        --telemetry-dir DIR [--port P] [--ops-port P] [--workers N] \\
        [--lease-s S] [--max-attempts N] [--compact-at N] [--json] \\
        [--compile-cache-dir DIR] [--device cuda|cpu]

Inverts ``heal`` from pull to push. At startup the sweep-spec JSON is
expanded into cells through the exact machinery heal diffs with
(``heal.load_spec``/``spec_configs`` → ``telemetry_config_payload`` →
``config_digest``), cells the registry already shows ``completed`` are
pre-completed (resume semantics — recorded work is never re-run), and
the rest become the queue. Worker agents (:mod:`.worker`) connect over
the control protocol (:mod:`.protocol`) and pull leases; the
daemon:

* grants **heartbeat-refreshed leases** (TTL ``--lease-s``): a worker
  silent longer than the TTL is dead or wedged either way — the
  ``watch --stall-after`` contract (``telemetry.watch.staleness_s``)
  applied to control-plane heartbeats — and its cells re-lease;
* revokes **immediately on disconnect** (a killed worker's socket EOF),
  so crash recovery costs one select tick, not a stall budget;
* accepts each cell's completion **at most once** (the live lease
  holder's report; late/revoked completions are discarded) and audits
  the registry at exit (:func:`..sched.leases.audit_exactly_once`);
* journals every placement decision to ``sched.journal.jsonl`` and
  brackets the whole sweep with a ``kind="sched"`` registry record;
* serves its own ops plane (``--ops-port``): ``/metrics`` ``sched_*``
  counters/gauges, ``/healthz`` (503 once any cell fails terminally),
  ``/statusz`` (queue depths, leases, per-worker rates — the JAX
  package's ``top`` dashboard renders its scheduler row);
* optionally **auto-compacts** the registry (``--compact-at N``): a
  long-lived scheduler appends a record per attempt, and
  ``telemetry.registry.compact_index`` keeps ``index.jsonl`` bounded
  without breaking ``newest_run_log``/heal digest matching.

``--workers N`` spawns N local worker agents of this package
(``python -m distributed_drift_detection_tpu_torch sched-worker``) pointed
at the daemon, each a process with its own CUDA context on the card
(``--device cpu`` is forwarded to them for the plain path;
``--compile-cache-dir`` gives them one shared kernel build directory). The
scheduler exits 0 only when every cell completed and the registry audit is
clean — the scriptable wholeness contract, same as ``heal``.

Nothing here imports torch (stdlib + the torch-free telemetry/heal
modules): the scheduler runs on a head node, in CI, anywhere
``index.jsonl`` lands. Fault site ``sched.lease`` fires per grant
(``DDD_FAULTS="sched.lease:at=2"`` makes the 2nd grant fail: the reply
is an ``error``, the cell stays queued, the daemon survives — armed by
the CI job to prove grant failures are not crashes).
"""

from __future__ import annotations

import argparse
import json
import os
import selectors
import socket
import subprocess
import sys
import threading
import time

from ..resilience import faults
from ..telemetry import registry as run_registry
from ..telemetry.watch import staleness_s
from . import protocol
from .leases import CellQueue, audit_exactly_once

JOURNAL_NAME = "sched.journal.jsonl"


class _Conn:
    __slots__ = ("sock", "buf", "worker")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = b""
        self.worker: "str | None" = None  # set by hello


class _WorkerState:
    __slots__ = (
        "worker", "pid", "hostname", "joined_mono", "last_mono",
        "cells_done", "cells_failed", "rows_done", "alive",
    )

    def __init__(self, worker: str, now: float, pid=None, hostname=None):
        self.worker = worker
        self.pid = pid
        self.hostname = hostname
        self.joined_mono = now
        self.last_mono = now
        self.cells_done = 0
        self.cells_failed = 0
        self.rows_done = 0
        self.alive = True


class Scheduler:
    """The daemon object (embeddable: tests and ``chip_smoke.py`` drive
    it in-process; the CLI wraps it). ``start()`` binds, brackets the
    registry, and spins the select loop on a daemon thread; ``stop()``
    finalizes the bracket with the audit verdict."""

    def __init__(
        self,
        telemetry_dir: str,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        lease_s: float = protocol.DEFAULT_LEASE_S,
        heartbeat_s: float = protocol.DEFAULT_HEARTBEAT_S,
        poll_s: float = protocol.DEFAULT_POLL_S,
        max_attempts: int = 3,
        ops_port: "int | None" = None,
        compact_at: int = 0,
        clock=time.monotonic,
    ):
        self.telemetry_dir = telemetry_dir
        self.queue = CellQueue(lease_s=lease_s, max_attempts=max_attempts)
        self.heartbeat_s = float(heartbeat_s)
        self.poll_s = float(poll_s)
        self.compact_at = int(compact_at)
        self._clock = clock
        self.sched_id = (
            f"sched-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
        )
        self.workers: "dict[str, _WorkerState]" = {}
        # Accounting the ops plane renders (GIL-atomic ints, mutated
        # under the lock anyway).
        self.leases_granted = 0
        self.leases_revoked = 0
        self.lease_errors = 0
        self.evictions = 0
        self.submissions = 0
        self.pre_completed = 0
        self._lock = threading.Lock()
        self._whole_evt = threading.Event()
        self._stop_evt = threading.Event()
        self._t0_mono: "float | None" = None
        # The journal opens with the object, not with start(): the CLI
        # enqueues its spec before starting the loop, and that
        # spec_added record is exactly the forensics the journal exists
        # to keep.
        os.makedirs(telemetry_dir, exist_ok=True)
        self._journal_fh = open(
            os.path.join(telemetry_dir, JOURNAL_NAME), "a"
        )
        self._host = host
        self._ops = None
        self._ops_port_req = ops_port
        self._metrics = None
        self._thread: "threading.Thread | None" = None
        self._sel = selectors.DefaultSelector()
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((host, port))
        self._listen.listen(64)
        self._listen.setblocking(False)
        self._conns: "dict[socket.socket, _Conn]" = {}

    # -- intake ----------------------------------------------------------

    def add_spec(self, spec: dict) -> dict:
        """Expand a (loaded) sweep spec into cells and enqueue whatever
        the registry does not already show completed. Returns the heal
        plan shape ``{cells_total, completed, queued}``."""
        from ..resilience.heal import completed_digests, spec_configs

        wires = [protocol.cell_to_wire(cfg) for cfg in spec_configs(spec)]
        done = completed_digests(self.telemetry_dir)
        pre: "set[str]" = set()
        for wire in wires:
            if done[wire["digest"]] > 0:
                done[wire["digest"]] -= 1
                pre.add(wire["app_name"])
        with self._lock:
            queued, dups = self.queue.add(wires)
            n_pre = self.queue.mark_completed(pre)
            self.pre_completed += n_pre
            self._check_whole()
        self._journal(
            "spec_added", cells=queued, duplicates=dups, pre_completed=n_pre
        )
        return {
            "cells_total": len(wires),
            "completed": n_pre,
            "queued": queued - n_pre,
        }

    def submit(self, wires: "list[dict]") -> "tuple[int, int]":
        """Enqueue extra cells (the ``heal --scheduler`` path)."""
        with self._lock:
            queued, dups = self.queue.add(wires)
            self.submissions += 1
            if queued:
                self._whole_evt.clear()
        self._journal("submit", cells=queued, duplicates=dups)
        return queued, dups

    # -- lifecycle -------------------------------------------------------

    @property
    def port(self) -> int:
        return self._listen.getsockname()[1]

    @property
    def ops_port(self) -> "int | None":
        return self._ops.port if self._ops is not None else None

    def start(self) -> dict:
        """Bind the ops plane, bracket the registry, start the loop;
        returns the startup banner."""
        self._t0_mono = self._clock()
        counts = self.queue.counts()
        run_registry.record(
            self.telemetry_dir, self.sched_id, "running", kind="sched",
            cells_total=counts["total"], cells_to_run=counts["queued"],
        )
        self._journal(
            "scheduler_started", port=self.port, pid=os.getpid(), **counts
        )
        if self._ops_port_req is not None:
            from ..telemetry.metrics import MetricsRegistry
            from ..telemetry.ops import OpsServer

            self._metrics = MetricsRegistry()
            self._c_granted = self._metrics.counter(
                "sched_leases_granted_total",
                help="Cell leases granted to workers",
            )
            self._c_revoked = self._metrics.counter(
                "sched_leases_revoked_total",
                help="Leases revoked (worker dead or stalled), by reason",
            )
            self._c_completed = self._metrics.counter(
                "sched_cells_completed_total",
                help="Cells whose completion was accepted exactly once",
            )
            self._c_failed = self._metrics.counter(
                "sched_cells_failed_total",
                help="Cells terminally failed (lease-attempt budget spent)",
            )
            self._c_evicted = self._metrics.counter(
                "sched_workers_evicted_total",
                help="Workers evicted (disconnect or stall contract)",
            )
            self._g_queued = self._metrics.gauge(
                "sched_cells_queued", help="Cells waiting for a lease"
            )
            self._g_leased = self._metrics.gauge(
                "sched_cells_leased", help="Cells currently leased out"
            )
            self._g_workers = self._metrics.gauge(
                "sched_workers_connected", help="Live worker agents"
            )
            self._g_rate = self._metrics.gauge(
                "sched_cells_per_sec",
                help="Accepted completions per second of scheduler uptime",
            )
            self._ops = OpsServer(
                self._host, self._ops_port_req,
                metrics_fn=self._metrics_text,
                health_fn=self._health,
                status_fn=self.status,
                fleetz_fn=self.fleetz,
            )
            self._ops.start()
        self._sel.register(self._listen, selectors.EVENT_READ, None)
        self._thread = threading.Thread(
            target=self._run, name="sched-loop", daemon=True
        )
        self._thread.start()
        return {
            "scheduler": self.sched_id,
            "host": self._listen.getsockname()[0],
            "port": self.port,
            "ops_port": self.ops_port,
            "telemetry_dir": self.telemetry_dir,
            **counts,
        }

    def stop(self) -> dict:
        """Stop the loop and finalize: registry bracket status from the
        queue + the exactly-once audit; returns the summary."""
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self._ops is not None:
            self._ops.stop()
        with self._lock:
            counts = self.queue.counts()
            expected = self.queue.expected_digests()
        audit = audit_exactly_once(self.telemetry_dir, expected)
        whole = (
            counts["total"] > 0
            and counts["completed"] == counts["total"]
            and audit["ok"]
        )
        status = "completed" if whole else "failed"
        summary = {
            "scheduler": self.sched_id,
            "whole": whole,
            "audit": audit,
            "evictions": self.evictions,
            "leases_granted": self.leases_granted,
            "leases_revoked": self.leases_revoked,
            **counts,
        }
        self._journal("scheduler_stopped", **summary)
        try:
            run_registry.record(
                self.telemetry_dir, self.sched_id, status, kind="sched",
                cells_completed=counts["completed"],
                cells_failed=counts["failed"],
                evictions=self.evictions,
                audit_ok=audit["ok"],
            )
        except Exception:
            pass  # best-effort: the summary must surface either way
        if self._journal_fh is not None:
            self._journal_fh.close()
            self._journal_fh = None
        self._listen.close()
        self._sel.close()
        return summary

    def wait_whole(self, timeout: "float | None" = None) -> bool:
        """Block until every cell is terminal (or ``timeout``)."""
        return self._whole_evt.wait(timeout)

    def spawn_workers(
        self, n: int, *, start_index: int = 0,
        extra_args: "list[str] | None" = None, env=None,
    ) -> "list[subprocess.Popen]":
        """Launch ``n`` local worker agents of this package pointed at this
        daemon — the ``--workers N`` zero-to-sweep path (``extra_args``
        carries ``--device cpu`` for the plain path, ``--compile-cache-dir``
        for a shared build directory). Each gets ``--index i`` so
        Bernoulli-armed ``sched.worker`` faults de-correlate across the
        fleet (same ``DDD_FAULTS``, different hit sequences); respawned
        replacements get fresh indices for the same reason."""
        procs = []
        for i in range(start_index, start_index + n):
            cmd = [
                sys.executable, "-m", "distributed_drift_detection_tpu_torch",
                "sched-worker",
                "--connect", f"127.0.0.1:{self.port}",
                "--index", str(i),
                *(extra_args or []),
            ]
            procs.append(
                subprocess.Popen(cmd, env=env)
            )
        return procs

    # -- ops plane -------------------------------------------------------

    def _metrics_text(self) -> "str | None":
        from ..telemetry.pipeline import fleet_metrics_lines

        with self._lock:
            counts = self.queue.counts()
            # Under the lock: the select-loop thread mutates self.workers
            # (a hello inserting a respawned replacement) concurrently
            # with this ops-thread scrape.
            alive = sum(1 for w in self.workers.values() if w.alive)
        self._g_queued.set(counts["queued"])
        self._g_leased.set(counts["leased"])
        self._g_workers.set(alive)
        self._g_rate.set(self.cells_per_sec() or 0.0)
        # the fleet_* series ride the scheduler's scrape too, so one
        # Prometheus target covers queue state AND per-worker load
        fleet = "\n".join(fleet_metrics_lines(self.fleetz())) + "\n"
        return self._metrics.to_prometheus_text() + fleet

    def fleetz(self) -> dict:
        """The merged fleet view (``/fleetz``), shaped like the tenant
        router's. Workers expose no ops endpoints — the scheduler IS
        their state plane — so each snapshot comes from the lease
        registry's worker accounting: cumulative rows and the average
        rows/s since the worker joined."""
        from ..telemetry.pipeline import aggregate_fleet

        now = self._clock()
        with self._lock:
            snaps = [
                {
                    "name": w.worker,
                    "alive": w.alive,
                    "rows": w.rows_done,
                    "rows_per_sec": round(
                        w.rows_done / max(now - w.joined_mono, 1e-9), 3
                    ),
                    # workers have no incident plane (no ops endpoint to
                    # capture from); the fleet INC column reads 0 here
                    "incidents": 0,
                }
                for w in self.workers.values()
            ]
        return aggregate_fleet(snaps)

    def _health(self) -> "tuple[int, dict]":
        with self._lock:
            counts = self.queue.counts()
        reasons = []
        if counts["failed"]:
            reasons.append(f"{counts['failed']} cell(s) terminally failed")
        return (503 if reasons else 200), {
            "healthy": not reasons,
            "reasons": reasons,
            **counts,
        }

    def cells_per_sec(self) -> "float | None":
        """Accepted completions per second of uptime (pre-completed
        resume cells excluded — they cost no work this run)."""
        if self._t0_mono is None:
            return None
        up = self._clock() - self._t0_mono
        with self._lock:
            done = self.queue.counts()["completed"] - self.pre_completed
        return round(done / up, 4) if up > 0 and done >= 0 else None

    def status(self) -> dict:
        """The ``/statusz`` snapshot (also the ``status`` protocol
        reply) — the fields the ``top`` dashboard's scheduler row
        renders."""
        now = self._clock()
        with self._lock:
            counts = self.queue.counts()
            leases = [
                {
                    "lease_id": lease.lease_id,
                    "cell": lease.cell.app_name,
                    "worker": lease.worker,
                    "expires_in_s": round(lease.expires_mono - now, 2),
                }
                for lease in self.queue.leases.values()
            ]
            workers = [
                {
                    "worker": w.worker,
                    "alive": w.alive,
                    "pid": w.pid,
                    "hostname": w.hostname,
                    "cells_done": w.cells_done,
                    "cells_failed": w.cells_failed,
                    "rows_done": w.rows_done,
                    "age_s": round(staleness_s(w.last_mono, now=now), 2),
                }
                for w in self.workers.values()
            ]
        return {
            "sched": True,
            "run_id": self.sched_id,
            "pid": os.getpid(),
            "uptime_s": (
                round(now - self._t0_mono, 3)
                if self._t0_mono is not None
                else None
            ),
            "cells": counts,
            "workers": workers,
            "leases": leases,
            "leases_granted": self.leases_granted,
            "leases_revoked": self.leases_revoked,
            "lease_errors": self.lease_errors,
            "evictions": self.evictions,
            "submissions": self.submissions,
            "cells_per_sec": self.cells_per_sec(),
            "whole": self._whole_evt.is_set(),
        }

    # -- journal ---------------------------------------------------------

    def _journal(self, event: str, **fields) -> None:
        if self._journal_fh is None:
            return
        rec = {"ts": time.time(), "event": event, **fields}
        try:
            self._journal_fh.write(json.dumps(rec) + "\n")
            self._journal_fh.flush()
        except (OSError, ValueError):
            pass  # the journal is evidence, never a failure mode

    # -- the select loop -------------------------------------------------

    def _run(self) -> None:
        tick = min(self.queue.lease_s / 4, 0.25)
        while not self._stop_evt.is_set():
            for key, _ in self._sel.select(timeout=tick):
                if key.data is None:
                    self._accept()
                else:
                    self._service(key.data)
            self._sweep_stalls()
        for conn in list(self._conns.values()):
            self._close(conn)
        try:
            self._sel.unregister(self._listen)
        except (KeyError, ValueError):
            pass

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._listen.accept()
            except (BlockingIOError, InterruptedError, OSError):
                return
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(sock)
            self._conns[sock] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)

    def _close(self, conn: _Conn) -> None:
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        self._conns.pop(conn.sock, None)
        try:
            conn.sock.close()
        except OSError:
            pass

    def _eof(self, conn: _Conn) -> None:
        """Worker connection died: revoke everything it held, NOW — a
        killed worker must not cost a stall budget."""
        worker = conn.worker
        self._close(conn)
        if worker is None:
            return
        with self._lock:
            held = self.queue.revoke_worker(worker)
            self.leases_revoked += len(held)
            state = self.workers.get(worker)
            if state is not None:
                state.alive = False
            if held:
                self.evictions += 1
            self._check_whole()
        if self._metrics is not None and held:
            self._c_revoked.inc(len(held), reason="disconnect")
            self._c_evicted.inc()
        for lease in held:
            self._journal(
                "lease_revoked", lease=lease.lease_id, worker=worker,
                cell=lease.cell.app_name, reason="disconnect",
                requeued=lease.cell.state == "queued",
            )
        if held:
            self._journal("worker_evicted", worker=worker, reason="disconnect")

    def _service(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._eof(conn)
            return
        if not data:
            self._eof(conn)
            return
        conn.buf += data
        while True:
            nl = conn.buf.find(b"\n")
            if nl < 0:
                if len(conn.buf) > protocol.MAX_LINE_BYTES:
                    self._reply(conn, protocol.error_reply("oversized line"))
                    self._eof(conn)
                return
            line, conn.buf = conn.buf[:nl], conn.buf[nl + 1 :]
            if not line.strip():
                continue
            try:
                msg = protocol.decode_line(line)
            except protocol.ProtocolError as e:
                self._reply(conn, protocol.error_reply(e))
                continue
            try:
                reply = self._handle(conn, msg)
            except Exception as e:
                # A handler failure (including an armed `sched.lease`
                # fault) rejects THIS request; the daemon survives.
                self.lease_errors += 1
                reply = protocol.error_reply(e)
            self._reply(conn, reply)

    def _reply(self, conn: _Conn, msg: dict) -> None:
        try:
            conn.sock.sendall(protocol.encode(msg))
        except (BlockingIOError, InterruptedError, OSError):
            self._eof(conn)

    def _sweep_stalls(self) -> None:
        """The stall contract: revoke leases whose heartbeat-refreshed
        TTL expired (``staleness_s`` past the lease budget — the `watch
        --stall-after` semantics on the control plane)."""
        now = self._clock()
        with self._lock:
            expired = self.queue.revoke_expired(now)
            self.leases_revoked += len(expired)
            stalled_workers = {lease.worker for lease in expired}
            for worker in stalled_workers:
                state = self.workers.get(worker)
                if state is not None:
                    state.alive = False
                self.evictions += 1
            if expired:
                self._check_whole()
        if self._metrics is not None and expired:
            self._c_revoked.inc(len(expired), reason="stall")
            self._c_evicted.inc(len(stalled_workers))
        for lease in expired:
            self._journal(
                "lease_revoked", lease=lease.lease_id, worker=lease.worker,
                cell=lease.cell.app_name, reason="stall",
                requeued=lease.cell.state == "queued",
            )
        for worker in sorted(stalled_workers) if expired else ():
            self._journal("worker_evicted", worker=worker, reason="stall")

    def _check_whole(self) -> None:
        # Caller holds the lock.
        if self.queue.whole():
            self._whole_evt.set()

    # -- request handlers ------------------------------------------------

    def _handle(self, conn: _Conn, msg: dict) -> dict:
        op = msg["op"]
        now = self._clock()
        worker = msg.get("worker")
        if worker is not None:
            with self._lock:
                state = self.workers.get(worker)
                if state is not None:
                    state.last_mono = now
                    state.alive = True
        if op == "hello":
            if not worker:
                return protocol.error_reply("hello needs a worker id")
            conn.worker = worker
            with self._lock:
                self.workers[worker] = _WorkerState(
                    worker, now,
                    pid=msg.get("pid"), hostname=msg.get("hostname"),
                )
            self._journal(
                "worker_joined", worker=worker, pid=msg.get("pid"),
                hostname=msg.get("hostname"),
            )
            return {
                "op": "welcome",
                "scheduler": self.sched_id,
                "telemetry_dir": self.telemetry_dir,
                "lease_s": self.queue.lease_s,
                "heartbeat_s": self.heartbeat_s,
                "poll_s": self.poll_s,
            }
        if op == "lease":
            if not worker:
                return protocol.error_reply("lease needs a worker id")
            conn.worker = conn.worker or worker
            # Fault site: a grant that raises rejects THIS request (the
            # worker retries after poll_s); the cell stays queued.
            faults.fire("sched.lease", worker=worker)
            with self._lock:
                if self._whole_evt.is_set():
                    return {"op": "drain"}
                lease = self.queue.grant(worker, now)
                if lease is not None:
                    self.leases_granted += 1
            if lease is None:
                return {"op": "wait", "poll_s": self.poll_s}
            if self._metrics is not None:
                self._c_granted.inc()
            self._journal(
                "lease_granted", lease=lease.lease_id, worker=worker,
                cell=lease.cell.app_name, digest=lease.cell.digest,
                attempt=lease.cell.attempts,
            )
            return {
                "op": "lease",
                "lease_id": lease.lease_id,
                "cell": lease.cell.wire,
                "lease_s": self.queue.lease_s,
                "heartbeat_s": self.heartbeat_s,
                "attempt": lease.cell.attempts,
            }
        if op == "heartbeat":
            lease_id = msg.get("lease_id")
            rows = msg.get("rows_done")
            if worker and rows is not None:
                with self._lock:
                    state = self.workers.get(worker)
                    if state is not None:
                        state.rows_done = int(rows)
            if lease_id is None:
                return {"op": "ack"}
            with self._lock:
                live = self.queue.heartbeat(lease_id, now)
            if not live:
                return {"op": "revoked", "lease_id": lease_id}
            return {"op": "ack"}
        if op == "done":
            lease_id = msg.get("lease_id", "")
            with self._lock:
                cell = self.queue.complete(lease_id, worker or "")
                if cell is not None:
                    state = self.workers.get(worker or "")
                    if state is not None:
                        state.cells_done += 1
                    self._check_whole()
            if cell is None:
                self._journal(
                    "completion_discarded", lease=lease_id, worker=worker,
                )
                return {"op": "ack", "accepted": False}
            if self._metrics is not None:
                self._c_completed.inc()
            self._journal(
                "cell_completed", lease=lease_id, worker=worker,
                cell=cell.app_name, digest=cell.digest,
                result=msg.get("result"),
            )
            self._maybe_compact()
            return {"op": "ack", "accepted": True}
        if op == "fail":
            lease_id = msg.get("lease_id", "")
            with self._lock:
                out = self.queue.fail(lease_id, worker or "")
                if out is not None:
                    state = self.workers.get(worker or "")
                    if state is not None:
                        state.cells_failed += 1
                    self._check_whole()
            if out is None:
                return {"op": "ack", "accepted": False}
            cell, requeued = out
            if self._metrics is not None and not requeued:
                self._c_failed.inc()
            self._journal(
                "cell_failed", lease=lease_id, worker=worker,
                cell=cell.app_name, error=str(msg.get("error", ""))[:300],
                requeued=requeued,
            )
            return {"op": "ack", "accepted": True, "requeued": requeued}
        if op == "submit":
            cells = msg.get("cells")
            if not isinstance(cells, list) or not all(
                isinstance(c, dict)
                and c.get("app_name") and c.get("digest")
                and isinstance(c.get("payload"), dict)
                for c in cells
            ):
                return protocol.error_reply(
                    "submit needs cells: [wire cells] "
                    "(app_name/digest/payload)"
                )
            queued, dups = self.submit(cells)
            return {"op": "ack", "queued": queued, "duplicates": dups}
        if op == "status":
            return {"op": "status", **self.status()}
        if op == "bye":
            if worker:
                with self._lock:
                    state = self.workers.get(worker)
                    if state is not None:
                        state.alive = False
                self._journal("worker_left", worker=worker)
            return {"op": "ack"}
        return protocol.error_reply(f"unknown op {op!r}")

    def _maybe_compact(self) -> None:
        if self.compact_at <= 0:
            return
        try:
            compacted = run_registry.maybe_compact(
                self.telemetry_dir, max_records=self.compact_at
            )
        except (OSError, ValueError):
            return  # compaction is an optimization, never a failure mode
        if compacted:
            self._journal("registry_compacted", **compacted)


def main(argv=None, device: str = "cuda") -> None:
    """The ``sched`` subcommand; ``device`` is ``--device``'s default."""
    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch sched",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "spec", nargs="?", default=None,
        help="sweep-spec JSON (the grid as data; omit to start empty and "
        "wait for `heal --scheduler` submissions)",
    )
    ap.add_argument(
        "--telemetry-dir", required=True, metavar="DIR",
        help="telemetry directory whose registry is the work ledger",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument(
        "--port", type=int, default=0,
        help="control-protocol port (0 = OS-assigned, see banner)",
    )
    ap.add_argument(
        "--ops-port", type=int, default=None, metavar="P",
        help="ops plane (/metrics /healthz /statusz; 0 = OS-assigned, "
        "omit = no ops server)",
    )
    ap.add_argument(
        "--workers", type=int, default=0, metavar="N",
        help="spawn N local worker agents pointed at this daemon",
    )
    ap.add_argument(
        "--lease-s", type=float, default=protocol.DEFAULT_LEASE_S,
        help="heartbeat-refreshed lease TTL = the worker stall budget "
        f"(default {protocol.DEFAULT_LEASE_S:g})",
    )
    ap.add_argument(
        "--heartbeat-s", type=float, default=protocol.DEFAULT_HEARTBEAT_S,
        help="heartbeat period workers are told to honor "
        f"(default {protocol.DEFAULT_HEARTBEAT_S:g})",
    )
    ap.add_argument(
        "--max-attempts", type=int, default=3,
        help="lease attempts per cell before it is terminally failed "
        "(default 3)",
    )
    ap.add_argument(
        "--compact-at", type=int, default=0, metavar="N",
        help="auto-compact the registry when index.jsonl exceeds N "
        "records (0 = never; telemetry.registry.compact_index)",
    )
    ap.add_argument(
        "--retries", type=int, default=2,
        help="supervised in-worker retries per cell attempt (default 2)",
    )
    ap.add_argument(
        "--compile-cache-dir", default="", metavar="DIR",
        help="forwarded to spawned workers: one shared kernel build "
        "directory for the fleet (RunConfig.compile_cache_dir)",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default=device,
        help="forwarded to spawned workers: where they run their cells "
        f"(default {device}; cuda is the card)",
    )
    ap.add_argument(
        "--timeout", type=float, default=0.0, metavar="S",
        help="give up if the sweep is not whole after S seconds "
        "(0 = wait forever)",
    )
    ap.add_argument(
        "--json", action="store_true",
        help="print the final summary as one JSON line",
    )
    args = ap.parse_args(argv)

    armed = faults.arm_from_env()
    sched = Scheduler(
        args.telemetry_dir,
        host=args.host,
        port=args.port,
        lease_s=args.lease_s,
        heartbeat_s=args.heartbeat_s,
        max_attempts=args.max_attempts,
        ops_port=args.ops_port,
        compact_at=args.compact_at,
    )
    if args.spec:
        from ..resilience.heal import load_spec

        plan = sched.add_spec(load_spec(args.spec))
        print(
            f"sched: {plan['cells_total']} cells, {plan['completed']} "
            f"already completed, {plan['queued']} to run",
            file=sys.stderr,
        )
    banner = sched.start()
    print(json.dumps(banner), flush=True)
    if armed:
        print(f"sched: fault site(s) armed: {armed}", file=sys.stderr)
    worker_args = ["--retries", str(args.retries)]
    if args.compile_cache_dir:
        worker_args += ["--compile-cache-dir", args.compile_cache_dir]
    if args.device != "cuda":
        worker_args += ["--device", args.device]
    procs = []
    if args.workers:
        procs = sched.spawn_workers(args.workers, extra_args=worker_args)
    next_index = args.workers
    # Respawn budget: an **elastic** fleet replaces crashed workers (the
    # whole point of injected preemption is that the sweep still
    # converges), but a deterministic crash-at-hello loop must not fork
    # forever — past the budget the remaining cells exhaust their lease
    # attempts and fail terminally, which is the loud outcome.
    respawns_left = 10 * max(args.workers, 1)
    deadline = (
        time.monotonic() + args.timeout if args.timeout else None
    )
    try:
        timed_out = False
        while not sched.wait_whole(timeout=0.5):
            if deadline is not None and time.monotonic() > deadline:
                print(
                    f"sched: sweep not whole after {args.timeout:g}s",
                    file=sys.stderr,
                )
                timed_out = True
                break
            for i, proc in enumerate(procs):
                if proc.poll() is None or proc.returncode == 0:
                    continue  # alive, or drained cleanly
                if respawns_left <= 0:
                    continue
                respawns_left -= 1
                print(
                    f"sched: worker exited rc={proc.returncode} — "
                    f"respawning as index {next_index}",
                    file=sys.stderr,
                )
                procs[i] = sched.spawn_workers(
                    1, start_index=next_index, extra_args=worker_args
                )[0]
                next_index += 1
        # Give spawned workers their drain replies, then a bounded join —
        # but only when the sweep actually closed: after a timeout no
        # drain will ever arrive, so waiting 30s per worker just delays
        # the exit (the finally kills them immediately instead).
        if not timed_out:
            for proc in procs:
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        summary = sched.stop()
    if args.json:
        print(json.dumps(summary), flush=True)
    else:
        print(
            f"sched: {summary['completed']}/{summary['total']} completed, "
            f"{summary['failed']} failed, {summary['evictions']} "
            f"eviction(s); audit "
            + ("clean" if summary["audit"]["ok"] else
               f"VIOLATED {summary['audit']}")
        )
    raise SystemExit(0 if summary["whole"] else 1)


if __name__ == "__main__":
    main(sys.argv[1:])
