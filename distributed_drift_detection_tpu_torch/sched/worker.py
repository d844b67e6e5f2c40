"""The worker agent: lease cells, run them, heartbeat, repeat — the port's
own copy of the JAX package's ``sched/worker.py``.

    python -m distributed_drift_detection_tpu_torch sched-worker \\
        --connect HOST:PORT [--worker-id ID] [--index I] [--retries N] \\
        [--compile-cache-dir DIR] [--device cuda|cpu]

One agent = one process = one cell at a time (cells are whole device
programs; parallelism comes from running more agents, not threads). Each
agent is a process with its own CUDA context on the card (``--device
cuda``, the default; ``--device cpu`` is how a caller asks for the plain
path across the process boundary — nothing falls back to the CPU on its
own). The loop:

1. ``hello`` → the scheduler's ``welcome`` carries the knobs the agent
   must honor (``telemetry_dir``, ``lease_s``, ``heartbeat_s``,
   ``poll_s``) — workers are configured by the control plane, not by
   flags, so a fleet can never disagree with its scheduler.
2. ``lease`` → a wire cell. The agent rebuilds the ``RunConfig``
   (:func:`..sched.protocol.cell_from_wire` — refusing digest drift)
   and runs it under ``resilience.supervisor.supervised_run`` with the
   scheduler's telemetry directory, so the cell gets the standard
   telemetry bracketing: per-attempt registry records, a per-cell run
   log, ``run_retried`` events — ``report``/``watch``/``correlate``/
   ``top`` work unchanged on a scheduler-run sweep.
3. While the cell runs, a **heartbeat thread** refreshes the lease every
   ``heartbeat_s``. A ``revoked`` reply means the scheduler already
   re-leased the cell (this agent was presumed dead): the agent abandons
   the cell's result — no ``done`` report — and moves on. (Work already
   recorded by ``api.run`` mid-flight is the narrow documented hole; see
   ``leases.py``.)
4. ``done``/``fail`` close the lease; ``wait`` backs off ``poll_s``;
   ``drain`` exits 0 — the sweep is whole.

Fault site ``sched.worker`` fires once per leased cell at execution
start, *outside* the per-cell error handling: an armed ``raise`` kills
the whole agent process — the deterministic stand-in for a preempted VM
or an OOM-killed worker the acceptance test and CI job inject via
``DDD_FAULTS``. Bernoulli arming de-correlates across a spawned fleet:
the agent re-seeds the armed spec with its ``--index`` so three workers
sharing one ``DDD_FAULTS`` string die at *different* cells.

Cell execution is the only part that needs torch (and it is lazy):
``run_cell=`` is injectable, so the protocol/lease tests drive agents
with a stub executor.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
import time

from ..parallel.multihost import fleet_worker_identity
from ..resilience import faults
from . import protocol


def default_run_cell(
    cell: dict, telemetry_dir: str, *, retries: int = 2,
    compile_cache_dir: str = "", device: str = "cuda",
):
    """The production executor: rebuild the cell's ``RunConfig`` (digest
    round trip verified) and run it under the supervisor on ``device``
    with the scheduler's telemetry directory. ``compile_cache_dir`` points
    the fleet at one shared kernel build directory (bookkeeping, outside
    the digest — one worker builds, the others load). Returns the result
    summary the ``done`` report carries. Lazy torch (via ``api.run``)."""
    from ..resilience.policy import RetryPolicy
    from ..resilience.supervisor import supervised_run

    cfg = protocol.cell_from_wire(
        cell,
        telemetry_dir=telemetry_dir,
        compile_cache_dir=compile_cache_dir,
    )
    res = supervised_run(
        cfg, RetryPolicy(max_attempts=max(retries, 0) + 1), device=device
    )
    return {
        "rows": int(res.stream.num_rows),
        "total_time": float(res.total_time),
        "detections": int(res.metrics.num_detections),
    }


class Worker:
    """One agent. ``run()`` drives the loop until drain (returns 0),
    ``--max-cells`` (returns 0), or a fatal control-plane error
    (raises). Injectables (``run_cell``, ``sleep``) keep tests fast and
    torch-free."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        worker_id: "str | None" = None,
        index: int = 0,
        retries: int = 2,
        max_cells: int = 0,
        compile_cache_dir: str = "",
        device: str = "cuda",
        run_cell=None,
        sleep=time.sleep,
        progress=lambda msg: print(msg, file=sys.stderr),
    ):
        self.client = protocol.ControlClient(host, port)
        self.worker_id = worker_id or f"w{index}-{socket.gethostname()}-{os.getpid()}"
        self.index = int(index)
        self.retries = int(retries)
        self.max_cells = int(max_cells)
        self.compile_cache_dir = compile_cache_dir
        self.device = device
        if run_cell is None:
            run_cell = lambda cell, tele, retries=2: default_run_cell(  # noqa: E731
                cell, tele, retries=retries,
                compile_cache_dir=compile_cache_dir, device=device,
            )
        self.run_cell = run_cell
        self.sleep = sleep
        self.progress = progress
        self.telemetry_dir = ""
        self.heartbeat_s = protocol.DEFAULT_HEARTBEAT_S
        self.poll_s = protocol.DEFAULT_POLL_S
        self.cells_done = 0
        self.rows_done = 0
        # One lock serializes the heartbeat thread and the main loop on
        # the shared control connection (strict request/reply protocol).
        self._io_lock = threading.Lock()

    def _request(self, msg: dict) -> dict:
        with self._io_lock:
            return self.client.request(msg)

    def hello(self) -> dict:
        welcome = self._request(
            {"op": "hello", "worker": self.worker_id, **fleet_worker_identity()}
        )
        self.telemetry_dir = welcome.get("telemetry_dir", "") or ""
        self.heartbeat_s = float(
            welcome.get("heartbeat_s", self.heartbeat_s)
        )
        self.poll_s = float(welcome.get("poll_s", self.poll_s))
        return welcome

    def _beat(self, lease_id: str, revoked: threading.Event,
              stop: threading.Event) -> None:
        while not stop.wait(self.heartbeat_s):
            try:
                reply = self._request(
                    {
                        "op": "heartbeat",
                        "worker": self.worker_id,
                        "lease_id": lease_id,
                        "rows_done": self.rows_done,
                    }
                )
            except (OSError, protocol.ProtocolError):
                return  # control plane gone; the main loop finds out next
            if reply.get("op") == "revoked":
                revoked.set()
                return

    def run_one(self, lease: dict) -> None:
        """Execute one leased cell with heartbeats, then report."""
        lease_id = lease["lease_id"]
        cell = lease["cell"]
        revoked, stop = threading.Event(), threading.Event()
        beat = threading.Thread(
            target=self._beat, args=(lease_id, revoked, stop),
            name="sched-heartbeat", daemon=True,
        )
        beat.start()
        try:
            result = self.run_cell(
                cell, self.telemetry_dir, retries=self.retries
            )
        except Exception as e:
            stop.set()
            beat.join(timeout=5)
            if revoked.is_set():
                return  # already re-leased elsewhere; nothing to report
            self._request(
                {
                    "op": "fail",
                    "worker": self.worker_id,
                    "lease_id": lease_id,
                    "error": f"{type(e).__name__}: {e}"[:300],
                }
            )
            self.progress(
                f"sched-worker {self.worker_id}: cell "
                f"{cell.get('app_name')!r} FAILED ({type(e).__name__}: {e})"
            )
            return
        finally:
            stop.set()
        beat.join(timeout=5)
        if revoked.is_set():
            # The scheduler presumed us dead and re-leased the cell: the
            # completion must NOT be reported (at-most-once-recorded).
            self.progress(
                f"sched-worker {self.worker_id}: lease {lease_id} revoked "
                f"mid-cell — abandoning {cell.get('app_name')!r}"
            )
            return
        self.rows_done += int(result.get("rows", 0) or 0)
        reply = self._request(
            {
                "op": "done",
                "worker": self.worker_id,
                "lease_id": lease_id,
                "result": result,
            }
        )
        if reply.get("accepted"):
            self.cells_done += 1
        self.progress(
            f"sched-worker {self.worker_id}: {cell.get('app_name')} "
            f"done ({result.get('detections')} detections, "
            f"accepted={bool(reply.get('accepted'))})"
        )

    def run(self) -> int:
        self.hello()
        while True:
            try:
                reply = self._request(
                    {"op": "lease", "worker": self.worker_id}
                )
            except protocol.ProtocolError as e:
                # A rejected grant (e.g. an armed `sched.lease` fault) is
                # the scheduler's problem, not ours: back off and retry —
                # the cell stayed queued.
                self.progress(
                    f"sched-worker {self.worker_id}: lease rejected "
                    f"({e}) — retrying"
                )
                self.sleep(self.poll_s)
                continue
            op = reply.get("op")
            if op == "drain":
                try:
                    self._request({"op": "bye", "worker": self.worker_id})
                except (OSError, protocol.ProtocolError):
                    pass
                return 0
            if op == "wait":
                self.sleep(float(reply.get("poll_s", self.poll_s)))
                continue
            if op != "lease":
                raise protocol.ProtocolError(
                    f"unexpected reply {op!r} to a lease request"
                )
            # The preemption fault site: OUTSIDE the per-cell handling,
            # so an armed raise kills the whole agent — the injected
            # worker death the exactly-once contract is tested against.
            faults.fire(
                "sched.worker",
                worker=self.worker_id,
                cell=reply["cell"].get("app_name"),
            )
            self.run_one(reply)
            if self.max_cells and self.cells_done >= self.max_cells:
                try:
                    self._request({"op": "bye", "worker": self.worker_id})
                except (OSError, protocol.ProtocolError):
                    pass
                return 0


def main(argv=None, device: str = "cuda") -> None:
    """The ``sched-worker`` subcommand; ``device`` is ``--device``'s default."""
    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch sched-worker",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "--connect", required=True, metavar="HOST:PORT",
        help="the scheduler's control endpoint (its banner's host/port)",
    )
    ap.add_argument(
        "--worker-id", default=None,
        help="stable identity (default: w<index>-<host>-<pid>)",
    )
    ap.add_argument(
        "--index", type=int, default=0,
        help="fleet ordinal (de-correlates Bernoulli-armed sched.worker "
        "faults across a spawned fleet)",
    )
    ap.add_argument(
        "--retries", type=int, default=2,
        help="supervised retries per cell attempt (default 2)",
    )
    ap.add_argument(
        "--max-cells", type=int, default=0,
        help="exit 0 after N accepted completions (0 = until drain)",
    )
    ap.add_argument(
        "--compile-cache-dir", default="", metavar="DIR",
        help="shared kernel build directory for this fleet "
        "(RunConfig.compile_cache_dir): one worker builds, the others load",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default=device,
        help=f"where this agent runs its cells (default {device}; cuda is "
        "the card, cpu the plain path)",
    )
    args = ap.parse_args(argv)

    armed = faults.arm_from_env()
    spec = faults.armed("sched.worker")
    if spec is not None and spec.rate > 0.0 and args.index:
        # Same DDD_FAULTS string across a spawned fleet, different death
        # schedule per worker: the Bernoulli decision hashes the seed.
        faults.arm(
            "sched.worker", rate=spec.rate, seed=spec.seed + args.index,
            times=spec.times, kind=spec.kind, seconds=spec.seconds,
        )
    if armed:
        print(f"sched-worker: fault site(s) armed: {armed}", file=sys.stderr)
    host, port = protocol.parse_addr(args.connect)
    worker = Worker(
        host, port,
        worker_id=args.worker_id,
        index=args.index,
        retries=args.retries,
        max_cells=args.max_cells,
        compile_cache_dir=args.compile_cache_dir,
        device=args.device,
    )
    raise SystemExit(worker.run())


if __name__ == "__main__":
    main(sys.argv[1:])
