"""Tenant router: one front daemon placing tenants across N serving
daemons, with live migration — the port's own copy of the JAX package's
``serve/router.py``: the same placement, rewritten bytes, journal and
``/statusz``, so either package's router fronts either package's daemons.

    python -m distributed_drift_detection_tpu_torch router --port 0 \\
        --backend 127.0.0.1:7007:7008 --backend 127.0.0.1:7017:7018 \\
        --telemetry-dir runs/fleet [...]

One tenant plane caps at one process on one host's
devices; a fleet is N such daemons behind this router. Clients speak the
existing v1/v2 wire protocols with **global** tenant ids; the router
owns the ``global tenant → (backend, slot)`` placement and rewrites each
message's tenant routing (the ``TENANT`` line, or 4 header bytes of a v2
frame) on the way through — backends see only their own slot indices and
stay bit-identical to solo daemons.

**Placement** is consistent hashing (:class:`HashRing`): stable under
fleet growth, and a dead backend's tenants re-place WITHOUT disturbing
anyone else's placement. :func:`plan_fleet` computes the initial
assignment the operator starts each backend with (``serve --tenant-ids
g0,g1,...,-1`` — trailing ``-1`` slots are vacant spares, the landing
capacity migrations need; slot counts are fixed in each backend's
carry and chunk shapes, so failover capacity is provisioned up front, not
grown).

**Liveness**: a health thread polls each backend's ops-plane
``/healthz`` (the ops plane's stall contract — 200 *or* 503 mean alive; only a
dead socket means dead) and any data-path send/EOF failure reports the
same way. After ``health_fails`` consecutive misses the backend is
declared dead and its tenants fail over.

**Migration** (drain → ship → resume; flags bit-identical across the
move) uses the serve daemons' SAVETENANT/LOADTENANT control surface and
the solo-shaped per-tenant checkpoints:

* *graceful* (``migrate_tenant``, rebalance): quiesce the tenant (the
  event loop buffers its rows instead of forwarding), FLUSH the source
  and wait until the slot's admitted rows match the router's forwarded
  count, ``SAVETENANT`` → ship the checkpoint (shared filesystem) →
  ``LOADTENANT`` into a vacant slot elsewhere, re-send any delta from
  the per-tenant replay buffer, resume. The vacated slot becomes new
  landing capacity.
* *failover* (dead backend): each orphaned tenant re-places from its
  LAST checkpoint (``<checkpoint>.t<slot>``, written by ``serve
  --tenant-checkpoints``); the landing reply reports the checkpoint's
  ``rows_admitted`` watermark and the router re-sends every buffered row
  past it — no verdict is lost past the checkpoint, and rows in the gap
  (buffer overrun) are counted loudly in the journal, never silently.

**Rebalance**: ``--rebalance-every`` polls the backends' ``/statusz``
per-tenant stream accounting (the ops plane's own rebalance signal) and
migrates the hottest tenant off the hottest backend when the
max/min row-rate ratio exceeds ``--rebalance-ratio`` (and somewhere has
a vacant slot). Off by default — placement changes are journaled either
way (``router.journal.jsonl``).

The router is torch-free (stdlib + numpy): it moves bytes and 4-byte
header rewrites, never rows through a kernel. Its own ops plane
(``--ops-port``) serves ``/healthz``, ``/metrics`` and a ``/statusz``
the ``top`` dashboard renders next to the backends'.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import selectors
import socket
import struct
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import deque

from . import wire

JOURNAL_NAME = "router.journal.jsonl"

#: Default per-tenant replay-buffer cap (rows). The buffer must cover
#: the worst-case gap between a backend's last per-tenant checkpoint and
#: its death — checkpoint_every chunks of the serving grid, plus
#: whatever was in flight.
REPLAY_BUFFER_ROWS = 1 << 16


# ---------------------------------------------------------------------------
# consistent-hash placement
# ---------------------------------------------------------------------------


class HashRing:
    """Consistent hashing over backend names (md5 ring, ``vnodes``
    virtual points per backend): ``place(key)`` is stable under fleet
    growth, and excluding a dead backend moves ONLY its keys."""

    def __init__(self, names, vnodes: int = 64):
        names = list(names)
        if not names:
            raise ValueError("a hash ring needs at least one backend")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate backend names: {names}")
        self.names = names
        self._ring: list[tuple[int, str]] = sorted(
            (self._point(f"{name}#{v}"), name)
            for name in names
            for v in range(vnodes)
        )

    @staticmethod
    def _point(key: str) -> int:
        return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")

    def place(self, key, exclude=()) -> str:
        """The backend owning ``key`` (first ring point clockwise of the
        key's hash), skipping ``exclude``\\ d (dead) backends."""
        excluded = set(exclude)
        alive = [n for n in self.names if n not in excluded]
        if not alive:
            raise RuntimeError("no live backend to place on")
        h = self._point(str(key))
        # bisect over the precomputed ring; walk past excluded points
        lo, hi = 0, len(self._ring)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._ring[mid][0] < h:
                lo = mid + 1
            else:
                hi = mid
        for k in range(len(self._ring)):
            point, name = self._ring[(lo + k) % len(self._ring)]
            if name not in excluded:
                return name
        raise RuntimeError("unreachable: ring exhausted")  # pragma: no cover


def plan_fleet(
    tenants: int, backends, spares: int = 1
) -> "dict[str, list[int]]":
    """Initial placement: global tenants ``0..tenants-1`` dealt over
    ``backends`` by the ring, each backend padded with ``spares`` vacant
    ``-1`` slots (migration landing capacity). The result is each
    daemon's ``--tenant-ids`` list — and every backend gets at least one
    slot even when the ring assigns it no tenants (a tenant plane needs T >= 1).
    """
    names = list(backends)
    ring = HashRing(names)
    assign: dict[str, list[int]] = {n: [] for n in names}
    for g in range(tenants):
        assign[ring.place(g)].append(g)
    return {
        n: ids + [-1] * max(spares, 1 if not ids else spares)
        for n, ids in assign.items()
    }


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


class BackendSpec:
    """``host:port:ops_port`` (a ``serve`` daemon's data + ops ports)."""

    def __init__(self, spec: str):
        parts = spec.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"backend spec {spec!r} must be host:port:ops_port"
            )
        self.host = parts[0]
        self.port = int(parts[1])
        self.ops_port = int(parts[2])

    def __repr__(self):
        return f"{self.host}:{self.port}:{self.ops_port}"


class _Backend:
    """One serving daemon as the router sees it: identity + slot table
    discovered from its ``/statusz``, a persistent data connection, a
    lazy control connection, and liveness accounting."""

    def __init__(self, spec: BackendSpec):
        self.spec = spec
        self.name = ""  # discovered (serve --name, or host:port)
        self.slot_ids: list[int] = []  # global id per slot; -1 = vacant
        self.checkpoint = ""  # the daemon's plane-checkpoint stem
        self.tenant_checkpoints = False
        self.alive = True
        self.health_fails = 0
        self.rows_forwarded = 0
        self.sock: "socket.socket | None" = None
        self.send_lock = threading.Lock()
        self._ctrl: "socket.socket | None" = None
        self._ctrl_buf = b""
        self._ctrl_lock = threading.Lock()

    # -- discovery -----------------------------------------------------------

    def statusz(self, timeout: float = 5.0) -> dict:
        url = f"http://{self.spec.host}:{self.spec.ops_port}/statusz"
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.load(r)

    def metrics_text(self, timeout: float = 5.0) -> str:
        url = f"http://{self.spec.host}:{self.spec.ops_port}/metrics"
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.read().decode()

    def healthz(self, timeout: float = 2.0) -> bool:
        """True while the daemon ANSWERS — 200 and 503 both mean alive
        (503 is an SLO alert, the daemon's own problem); only a dead
        socket means dead."""
        url = f"http://{self.spec.host}:{self.spec.ops_port}/healthz"
        try:
            with urllib.request.urlopen(url, timeout=timeout):
                return True
        except urllib.error.HTTPError:
            return True  # it answered; 503 = alerting, not dead
        except (urllib.error.URLError, OSError):
            return False

    def discover(self, connect_timeout: float = 30.0) -> None:
        """Resolve identity + slot table from the live daemon (retries
        until ``connect_timeout`` — the fleet may still be compiling)."""
        deadline = time.monotonic() + connect_timeout
        last: "Exception | None" = None
        while time.monotonic() < deadline:
            try:
                s = self.statusz()
                break
            except (urllib.error.URLError, OSError, ValueError) as e:
                last = e
                time.sleep(0.2)
        else:
            raise RuntimeError(
                f"backend {self.spec} unreachable: {last}"
            )
        self.name = s.get("name") or f"{self.spec.host}:{self.spec.port}"
        detail = s.get("tenant_detail") or []
        ids = [int(t["id"]) for t in detail]
        if not ids:
            # a solo daemon's slot table is its one (global) tenant
            ids = [0] if s.get("tenants", 1) == 1 else list(
                range(int(s["tenants"]))
            )
        self.slot_ids = ids
        self.checkpoint = s.get("checkpoint") or ""
        self.sock = socket.create_connection(
            (self.spec.host, self.spec.port), timeout=10
        )
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.setblocking(False)

    # -- data path -----------------------------------------------------------

    def send(self, payload: bytes) -> None:
        """One whole wire message to the daemon (thread-safe; the event
        loop and the migration thread both land here). Raises OSError on
        a dead peer — the caller reports the death."""
        with self.send_lock:
            sock = self.sock
            if sock is None:
                raise OSError(f"backend {self.name} has no data connection")
            # sendall on a non-blocking socket raises on a FULL buffer,
            # not just a dead peer — spin the short waits out.
            view = memoryview(payload)
            while view:
                try:
                    n = sock.send(view)
                    view = view[n:]
                except (BlockingIOError, InterruptedError):
                    time.sleep(0.001)

    # -- control path (SAVETENANT / LOADTENANT / FLUSH acks) -----------------

    def control(self, line: str, timeout: float = 120.0) -> str:
        """One control request → its ``OK``/``ERR`` reply line, over a
        dedicated connection (data-path ERR chatter must never
        interleave with a migration's replies). Any failure mid-exchange
        tears the connection down — a reply still in flight after a
        timeout must never be read as the NEXT request's answer (an
        off-by-one reply stream would mis-attribute every migration ack
        after it)."""
        with self._ctrl_lock:
            try:
                if self._ctrl is None:
                    self._ctrl = socket.create_connection(
                        (self.spec.host, self.spec.port), timeout=10
                    )
                    self._ctrl.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                    )
                self._ctrl.settimeout(timeout)
                self._ctrl.sendall((line + "\n").encode())
                while b"\n" not in self._ctrl_buf:
                    chunk = self._ctrl.recv(4096)
                    if not chunk:
                        raise OSError(
                            f"backend {self.name} closed the control "
                            "connection"
                        )
                    self._ctrl_buf += chunk
                reply, _, self._ctrl_buf = self._ctrl_buf.partition(b"\n")
                return reply.decode(errors="replace").strip()
            except OSError:
                if self._ctrl is not None:
                    try:
                        self._ctrl.close()
                    except OSError:
                        pass
                    self._ctrl = None
                self._ctrl_buf = b""
                raise

    def close(self) -> None:
        for attr in ("sock", "_ctrl"):
            s = getattr(self, attr)
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
                setattr(self, attr, None)


# ---------------------------------------------------------------------------
# rebalance planning (pure — the auto thread and the tests share it)
# ---------------------------------------------------------------------------


def plan_rebalance(
    backend_rates: "dict[str, float]",
    tenant_rates: "dict[str, dict[int, float]]",
    vacancies: "dict[str, int]",
    ratio: float = 2.0,
) -> "tuple[int, str, str] | None":
    """``(tenant, src, dst)`` when the fleet is imbalanced, else None.

    ``backend_rates`` maps backend → recent rows/s, ``tenant_rates``
    backend → {global tenant: recent rows/s}, ``vacancies`` backend →
    vacant slot count. Imbalanced means the hottest backend's rate
    exceeds the coolest's by ``ratio`` (a cold fleet never rebalances),
    the hottest backend serves more than one tenant (moving its only
    tenant moves the imbalance), and the coolest has a vacant slot."""
    rated = {n: r for n, r in backend_rates.items() if r is not None}
    if len(rated) < 2:
        return None
    hot = max(rated, key=rated.get)
    cold = min(rated, key=rated.get)
    if hot == cold or rated[hot] < ratio * max(rated[cold], 1e-9):
        return None
    movable = tenant_rates.get(hot) or {}
    if len(movable) < 2 or not vacancies.get(cold):
        return None
    return max(movable, key=movable.get), hot, cold


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


class TenantRouter:
    """Lifecycle owner of one router daemon (see module docstring).

    In-process embedding (tests, ``bench --fleet``)::

        router = TenantRouter([BackendSpec("127.0.0.1:7007:7008"), ...])
        banner = router.start()        # discovers backends, binds the port
        ...                            # clients connect to banner["port"]
        router.migrate_tenant(3, "b2") # graceful drain → ship → resume
        router.stop()
    """

    def __init__(
        self,
        backends,
        *,
        host: str = "127.0.0.1",
        port: "int | None" = 0,
        ops_port: "int | None" = None,
        telemetry_dir: "str | None" = None,
        name: str = "router",
        health_interval_s: float = 1.0,
        health_fails: int = 3,
        failover: bool = True,
        replay_rows: int = REPLAY_BUFFER_ROWS,
        rebalance_every_s: float = 0.0,
        rebalance_ratio: float = 2.0,
        connect_timeout: float = 60.0,
        max_frame_rows: int = wire.MAX_FRAME_ROWS,
    ):
        self.backends = [
            _Backend(b if isinstance(b, BackendSpec) else BackendSpec(b))
            for b in backends
        ]
        if not self.backends:
            raise ValueError("a router needs at least one backend")
        self.host = host
        self.port = port
        self.ops_port = ops_port
        self.name = name
        self.telemetry_dir = telemetry_dir
        self.health_interval_s = health_interval_s
        self.health_fails = max(int(health_fails), 1)
        self.failover = failover
        self.replay_rows = int(replay_rows)
        self.rebalance_every_s = rebalance_every_s
        self.rebalance_ratio = rebalance_ratio
        self.connect_timeout = connect_timeout
        # reject oversized client frames at the ROUTER's edge: a frame
        # the backends would refuse must not reach the shared persistent
        # data connection (the backend answers a protocol reject by
        # closing it, which reads as a dead backend → failover churn);
        # set this to the MINIMUM of the backends' --max-frame-rows
        self.max_frame_rows = int(max_frame_rows)

        # Routing state — one lock guards the placement table, tenant
        # quiesce states, replay buffers and counters. Data-socket sends
        # happen OUTSIDE it (per-backend send locks order the bytes).
        self._lock = threading.RLock()
        self.place: "dict[int, tuple[_Backend, int]]" = {}
        self._state: "dict[int, str]" = {}  # active | quiesced | orphaned
        self._buffer: "dict[int, deque]" = {}  # replay entries
        self._buffered_rows: "dict[int, int]" = {}
        self._pending: "dict[int, list]" = {}  # held while quiesced
        self._pending_rows: "dict[int, int]" = {}
        self._pending_overflowed: "set[int]" = set()
        self.rows_forwarded: "dict[int, int]" = {}
        self.frames_v1 = 0  # v1 text blocks forwarded
        self.frames_v2 = 0  # v2 frames forwarded
        self.decode_errors = 0
        self.backend_errors = 0  # ERR lines backends sent on the data path
        self.migrations = 0
        self.failovers = 0
        self.rows_lost = 0  # failover gaps past the replay buffer

        self._sel: "selectors.DefaultSelector | None" = None
        self._lsock: "socket.socket | None" = None
        self._stop = threading.Event()
        self._draining = False
        self._dead_q: "deque[_Backend]" = deque()
        self._threads: list[threading.Thread] = []
        self._journal_fh = None
        self._journal_lock = threading.Lock()
        self._ops = None
        self._t_start: "float | None" = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> dict:
        """Discover the fleet, bind the client port, start the event
        loop + health (+ rebalance) threads; returns the banner dict."""
        for b in self.backends:
            b.discover(self.connect_timeout)
        names = [b.name for b in self.backends]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate backend names: {names}")
        self.ring = HashRing(names)
        self._by_name = {b.name: b for b in self.backends}
        with self._lock:
            for b in self.backends:
                for slot, g in enumerate(b.slot_ids):
                    if g < 0:
                        continue
                    if g in self.place:
                        other = self.place[g][0].name
                        raise ValueError(
                            f"global tenant {g} served by both "
                            f"{other} and {b.name}"
                        )
                    self.place[g] = (b, slot)
                    self._state[g] = "active"
                    self._buffer[g] = deque()
                    self._buffered_rows[g] = 0
                    self._pending[g] = []
                    self._pending_rows[g] = 0
                    self.rows_forwarded[g] = 0
        if self.telemetry_dir:
            os.makedirs(self.telemetry_dir, exist_ok=True)
            self._journal_fh = open(
                os.path.join(self.telemetry_dir, JOURNAL_NAME), "a"
            )
        self._journal(
            "fleet_started",
            backends=[
                {"name": b.name, "spec": repr(b.spec), "slots": b.slot_ids}
                for b in self.backends
            ],
            placements={
                str(g): [b.name, s] for g, (b, s) in self.place.items()
            },
        )
        self._lsock = socket.create_server(
            (self.host, self.port or 0), backlog=128
        )
        self._lsock.setblocking(False)
        self.port = self._lsock.getsockname()[1]
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._lsock, selectors.EVENT_READ, ("accept",))
        for b in self.backends:
            self._sel.register(b.sock, selectors.EVENT_READ, ("backend", b))
        self._t_start = time.monotonic()
        loop = threading.Thread(
            target=self._run_loop, name="router-loop", daemon=True
        )
        health = threading.Thread(
            target=self._run_health, name="router-health", daemon=True
        )
        self._threads = [loop, health]
        if self.rebalance_every_s > 0:
            self._threads.append(
                threading.Thread(
                    target=self._run_rebalance,
                    name="router-rebalance",
                    daemon=True,
                )
            )
        for t in self._threads:
            t.start()
        if self.ops_port is not None:
            self._ops = self._start_ops()
        return {
            "router": True,
            "name": self.name,
            "host": self.host,
            "port": self.port,
            "ops_port": self._ops.port if self._ops is not None else None,
            "backends": {
                b.name: {
                    "spec": repr(b.spec),
                    "slots": list(b.slot_ids),
                }
                for b in self.backends
            },
            "tenants": sorted(self.place),
            "journal": (
                os.path.join(self.telemetry_dir, JOURNAL_NAME)
                if self.telemetry_dir
                else None
            ),
        }

    def stop(self) -> None:
        """Tear the router down (backends are NOT stopped — they drain
        via the wire STOP broadcast or their own SIGTERM)."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)
        if self._ops is not None:
            self._ops.stop()
        if self._sel is not None:
            self._sel.close()
        if self._lsock is not None:
            self._lsock.close()
        for b in self.backends:
            b.close()
        if self._journal_fh is not None:
            self._journal_fh.close()
            self._journal_fh = None

    # -- journal -------------------------------------------------------------

    def _journal(self, event: str, **fields) -> None:
        rec = {"ts": time.time(), "event": event, **fields}
        with self._journal_lock:
            if self._journal_fh is not None:
                self._journal_fh.write(json.dumps(rec) + "\n")
                self._journal_fh.flush()

    # -- the event loop ------------------------------------------------------

    def _run_loop(self) -> None:
        while not self._stop.is_set():
            events = self._sel.select(timeout=0.1)
            for key, _ in events:
                kind = key.data[0]
                if kind == "accept":
                    self._accept()
                elif kind == "backend":
                    self._read_backend(key.data[1])
                else:
                    self._read_client(key)

    def _accept(self) -> None:
        try:
            sock, _ = self._lsock.accept()
        except OSError:
            return
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        state = {
            "sock": sock,
            "buf": bytearray(),
            "tenant": None,  # current v1 global tenant
            "trace": None,  # pending TRACE line for the next data row
        }
        self._sel.register(sock, selectors.EVENT_READ, ("client", state))

    def _close_client(self, state) -> None:
        try:
            self._sel.unregister(state["sock"])
        except (KeyError, ValueError):
            pass
        try:
            state["sock"].close()
        except OSError:
            pass

    def _read_backend(self, b: _Backend) -> None:
        """Drain a backend's data-path replies (ERR chatter — counted,
        journaled once, never forwarded: the client/backend row mapping
        is gone by the time an async ERR surfaces). EOF off-drain means
        the backend died."""
        try:
            chunk = b.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            chunk = b""
        if not chunk:
            try:
                self._sel.unregister(b.sock)
            except (KeyError, ValueError):
                pass
            if not self._draining and b.alive:
                self._report_dead(b, "data connection EOF")
            return
        errs = chunk.count(b"ERR")
        if errs:
            self.backend_errors += errs
            self._journal(
                "backend_err",
                backend=b.name,
                sample=chunk[:200].decode(errors="replace"),
            )

    def _read_client(self, key) -> None:
        state = key.data[1]
        try:
            chunk = state["sock"].recv(1 << 20)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            chunk = b""
        if not chunk:
            self._close_client(state)
            return
        state["buf"] += chunk
        try:
            self._drain_client(state)
        except _Reject as e:
            self.decode_errors += 1
            try:
                state["sock"].sendall(f"ERR {e}\n".encode())
            except OSError:
                pass
            self._close_client(state)

    def _drain_client(self, state) -> None:
        """Consume every complete message in the client buffer, routing
        each to its tenant's backend. Consecutive v1 data rows for one
        tenant coalesce into ONE replay entry (one ``TENANT`` prefix,
        one lock pass, one backend send) — per-row dispatch made the
        router the v1 bottleneck. The batch never outlives this drain
        pass (flushed on tenant switch, frame/control boundary, reject,
        and return), so wire order is preserved exactly."""
        buf = state["buf"]
        batch: "list[str]" = []
        batch_g: "int | None" = None

        def flush() -> None:
            nonlocal batch, batch_g
            if batch:
                self._route_rows(batch_g, batch)
                batch = []
            batch_g = None

        try:
            while buf:
                if buf[0] == wire.MAGIC_BYTE:
                    if len(buf) < wire.HEADER_SIZE:
                        return  # incomplete header
                    try:
                        # Header only, decoded from an immutable copy: the
                        # router never builds payload views over the live
                        # buffer (an exported view would make the
                        # `del buf[:consumed]` resize below a BufferError),
                        # and it never needs the columns — it forwards the
                        # frame bytes whole, rewriting 4 header bytes.
                        header = wire.decode_header(
                            bytes(buf[: wire.HEADER_SIZE]),
                            max_rows=self.max_frame_rows,
                        )
                    except wire.WireError as e:
                        raise _Reject(f"WireError: {e}") from e
                    consumed = header.frame_nbytes
                    if len(buf) < consumed:
                        return  # incomplete frame
                    flush()
                    frame = bytes(buf[:consumed])
                    del buf[:consumed]
                    if header.is_control:
                        self._broadcast_control(header.flags)
                    else:
                        self._route_frame(header.tenant, frame, header.rows)
                    continue
                nl = buf.find(b"\n")
                if nl < 0:
                    if len(buf) > (1 << 20):
                        raise _Reject("unterminated text line > 1 MiB")
                    return
                line = bytes(buf[:nl]).decode(errors="replace").strip()
                del buf[: nl + 1]
                if not line:
                    continue
                if line.startswith("TENANT"):
                    try:
                        g = int(line[6:].strip())
                    except ValueError as e:
                        raise _Reject(
                            f"malformed TENANT line {line!r}"
                        ) from e
                    if g not in self.place:
                        raise _Reject(f"unknown global tenant {g}")
                    if batch_g is not None and g != batch_g:
                        flush()
                    state["tenant"] = g
                elif line.startswith("TRACE"):
                    state["trace"] = line  # rides with its next data row
                elif line == "FLUSH":
                    flush()
                    self._broadcast_control(wire.FLAG_FLUSH)
                elif line == "STOP":
                    flush()
                    self._broadcast_control(wire.FLAG_STOP)
                elif line.startswith(("SAVETENANT", "LOADTENANT")):
                    # migration is the ROUTER's job — a client must not
                    # reach around the placement table
                    raise _Reject("tenant control lines are router-internal")
                else:
                    g = state["tenant"]
                    if g is None:
                        # solo convention: an un-TENANTed client speaks to
                        # the fleet's lowest global tenant (one-tenant
                        # fleets feel like one daemon)
                        g = min(self.place, default=None)
                        if g is None:
                            raise _Reject("fleet serves no tenants")
                        state["tenant"] = g
                    if batch_g is not None and g != batch_g:
                        flush()
                    batch_g = g
                    if state["trace"] is not None:
                        batch.append(state["trace"])
                        state["trace"] = None
                    batch.append(line)
        finally:
            flush()

    # -- routing + the replay buffer -----------------------------------------

    def _route_rows(self, g: int, lines: "list[str]") -> None:
        """Route a block of v1 text lines (data rows + TRACE stamps) for
        global tenant ``g``."""
        rows = sum(1 for ln in lines if not ln.startswith("TRACE"))
        self._dispatch(g, ("v1", lines, rows))

    def _route_frame(self, g: int, frame: bytes, rows: int) -> None:
        if g not in self.place:
            raise _Reject(f"unknown global tenant {g}")
        self._dispatch(g, ("v2", frame, rows))

    def _dispatch(self, g: int, entry) -> None:
        """Forward one replay entry when the tenant is active; hold it
        while quiesced/orphaned (the resume flushes holds in order).
        Bookkeeping — the replay buffer and the forwarded counters —
        happens at FORWARD time only, so the buffer's tail always ends
        exactly at ``rows_forwarded`` (the invariant the failover
        re-send indexes by)."""
        with self._lock:
            if self._state[g] != "active":
                self._pending[g].append(entry)
                self._pending_rows[g] = self._pending_rows.get(g, 0) + entry[2]
                # a quiesce is transient (bounded by the drain timeout),
                # but an ORPHANED tenant may never resume — cap its hold
                # at the replay-buffer bound like _buffer_entry, counting
                # every dropped row in rows_lost (loud, never silent)
                held = self._pending[g]
                if self._state[g] == "orphaned":
                    dropped = 0
                    while (
                        len(held) > 1
                        and self._pending_rows[g] - held[0][2]
                        >= self.replay_rows
                    ):
                        n = held.pop(0)[2]
                        self._pending_rows[g] -= n
                        dropped += n
                    if dropped:
                        self.rows_lost += dropped
                        if g not in self._pending_overflowed:
                            self._pending_overflowed.add(g)
                            self._journal(
                                "pending_overflow", tenant=g,
                                dropped_rows=dropped,
                            )
                return
            b, slot = self.place[g]
            self._account(g, b, entry)
        self._send_entry(b, slot, entry)

    def _account(self, g: int, b: _Backend, entry) -> None:
        """Forward-time bookkeeping (call under the lock)."""
        self._buffer_entry(g, entry)
        self.rows_forwarded[g] += entry[2]
        b.rows_forwarded += entry[2]
        if entry[0] == "v1":
            self.frames_v1 += 1
        else:
            self.frames_v2 += 1

    def _buffer_entry(self, g: int, entry) -> None:
        """Append to the replay buffer, trimming the oldest WHOLE entries
        past the cap (call under the lock)."""
        buf = self._buffer[g]
        buf.append(entry)
        self._buffered_rows[g] += entry[2]
        while (
            len(buf) > 1
            and self._buffered_rows[g] - buf[0][2] >= self.replay_rows
        ):
            self._buffered_rows[g] -= buf.popleft()[2]

    def _send_entry(self, b: _Backend, slot: int, entry) -> None:
        """One buffered entry → the backend's wire (slot rewrite +
        send). Send failures report the backend dead; the row is already
        buffered, so the failover re-sends it."""
        kind, payload, rows = entry
        try:
            if kind == "v1":
                b.send(
                    (f"TENANT {slot}\n" + "\n".join(payload) + "\n").encode()
                )
            else:
                out = bytearray(payload)
                struct.pack_into("<I", out, 4, slot)
                b.send(bytes(out))
        except OSError as e:
            self._report_dead(b, f"send failed: {e}")

    def _broadcast_control(self, flags: int) -> None:
        if flags & wire.FLAG_STOP:
            # a STOP must not overtake rows held for quiesced tenants —
            # the backends would drain and exit before the resume
            # flushes the holds. Wait (bounded) for in-flight
            # migrations/failovers to resume, then count anything still
            # held (orphans never resume) LOUDLY as lost.
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                with self._lock:
                    busy = any(
                        st == "quiesced" for st in self._state.values()
                    )
                if not busy:
                    break
                time.sleep(0.05)
            with self._lock:
                dropped = 0
                for g, held in self._pending.items():
                    if held:
                        dropped += self._pending_rows.get(g, 0)
                        self._pending[g] = []
                        self._pending_rows[g] = 0
                if dropped:
                    self.rows_lost += dropped
                    self._journal("stop_dropped_pending", rows=dropped)
            self._draining = True
            self._journal("fleet_stop")
        line = b""
        if flags & wire.FLAG_FLUSH:
            line += b"FLUSH\n"
        if flags & wire.FLAG_STOP:
            line += b"STOP\n"
        for b in self.backends:
            if not b.alive:
                continue
            try:
                b.send(line)
            except OSError as e:
                self._report_dead(b, f"send failed: {e}")

    # -- liveness + failover -------------------------------------------------

    def _report_dead(self, b: _Backend, why: str) -> None:
        """Mark a backend dead (any thread) and queue its failover for
        the health thread — the event loop must keep moving the other
        tenants' bytes while orphans re-place."""
        with self._lock:
            if not b.alive:
                return
            b.alive = False
        self._journal("backend_dead", backend=b.name, why=why)
        self._dead_q.append(b)

    def _run_health(self) -> None:
        while not self._stop.is_set():
            while self._dead_q:
                dead = self._dead_q.popleft()
                if self.failover:
                    self._failover(dead)
                else:
                    self._orphan_all(dead)
            for b in self.backends:
                if not b.alive or self._draining:
                    continue
                if b.healthz(timeout=max(self.health_interval_s, 1.0)):
                    b.health_fails = 0
                else:
                    b.health_fails += 1
                    if b.health_fails >= self.health_fails:
                        self._report_dead(
                            b,
                            f"healthz missed {b.health_fails} polls",
                        )
            self._stop.wait(self.health_interval_s)

    def _orphan_all(self, dead: _Backend) -> None:
        with self._lock:
            for g, (b, _) in list(self.place.items()):
                if b is dead:
                    self._state[g] = "orphaned"
                    self._journal("orphaned", tenant=g, backend=dead.name)

    def _failover(self, dead: _Backend) -> None:
        """Re-place every tenant of a dead backend from its last
        per-tenant checkpoint, re-sending buffered rows past each
        checkpoint's watermark. Tenants that cannot land (no checkpoint,
        no vacancy) stay ``orphaned`` — loudly, in the journal and
        /statusz — while everyone else keeps serving."""
        with self._lock:
            orphans = [
                (g, slot)
                for g, (b, slot) in self.place.items()
                if b is dead
            ]
            for g, _ in orphans:
                self._state[g] = "quiesced"
        for g, slot in orphans:
            try:
                first = self.ring.place(
                    g, exclude=[b.name for b in self.backends if not b.alive]
                )
            except RuntimeError:
                self._mark_orphaned(g, "no live backend")
                continue
            ckpt = f"{dead.checkpoint}.t{slot}" if dead.checkpoint else ""
            if not ckpt or not os.path.exists(ckpt):
                self._mark_orphaned(
                    g, f"no per-tenant checkpoint at {ckpt or '<none>'}"
                )
                continue
            # the ring's pick first, then every other live backend —
            # a tenant orphans only when NO survivor can land it, not
            # merely when the hash's favourite is full
            order = [first] + [
                b.name
                for b in self.backends
                if b.alive and b.name != first
            ]
            errs = []
            for dst_name in order:
                dst = self._by_name[dst_name]
                if not dst.alive:
                    continue
                err = self._land(
                    g, dst, ckpt, src_name=dead.name, kind="failover"
                )
                if err is None:
                    break
                errs.append(f"{dst_name}: {err}")
            else:
                self._mark_orphaned(g, "; ".join(errs) or "no live backend")
        self.failovers += 1

    def _mark_orphaned(self, g: int, why: str) -> None:
        with self._lock:
            self._state[g] = "orphaned"
        self._journal("orphaned", tenant=g, why=why)

    def _claim_vacant(self, dst: _Backend) -> "int | None":
        with self._lock:
            for s, gid in enumerate(dst.slot_ids):
                if gid < 0:
                    dst.slot_ids[s] = -2  # claimed, not yet landed
                    return s
        return None

    def _land(
        self, g: int, dst: _Backend, ckpt: str, *, src_name: str, kind: str
    ) -> "str | None":
        """LOADTENANT ``ckpt`` into a vacant slot of ``dst``, re-send
        buffered rows past the checkpoint's watermark, resume ``g``.
        The tenant must already be quiesced. Returns None on success,
        else the failure reason — the CALLER decides what failure means
        (failover orphans the tenant; migration resumes it at its
        still-live source)."""
        vslot = self._claim_vacant(dst)
        if vslot is None:
            return f"no vacant slot on {dst.name}"
        try:
            reply = dst.control(f"LOADTENANT {vslot} {ckpt}")
        except OSError as e:
            self._report_dead(dst, f"control failed: {e}")
            reply = f"ERR LOADTENANT {vslot} {type(e).__name__}: {e}"
        if not reply.startswith("OK LOADTENANT"):
            with self._lock:
                if dst.slot_ids[vslot] == -2:
                    dst.slot_ids[vslot] = -1  # unclaim
            return f"landing failed: {reply}"
        watermark = int(reply.split()[-1])
        with self._lock:
            dst.slot_ids[vslot] = g
            self.place[g] = (dst, vslot)
        gap, resent = self._resend_from(g, dst, vslot, watermark)
        self._resume(g, dst, vslot)
        self._journal(
            kind,
            tenant=g,
            src=src_name,
            dst=dst.name,
            slot=vslot,
            checkpoint=ckpt,
            watermark=watermark,
            resent_rows=resent,
            lost_rows=gap,
        )
        if kind == "migrated":
            self.migrations += 1
        return None

    def _resend_from(
        self, g: int, dst: _Backend, slot: int, watermark: int
    ) -> "tuple[int, int]":
        """Re-send tenant ``g``'s buffered rows with tenant-local index
        >= ``watermark`` to its new home; returns ``(lost, resent)`` row
        counts. ``lost`` > 0 means the buffer no longer reaches back to
        the checkpoint — journaled by the caller, counted here."""
        with self._lock:
            entries = list(self._buffer[g])
            start = self.rows_forwarded[g] - self._buffered_rows[g]
        gap = max(start - watermark, 0)
        if gap:
            self.rows_lost += gap
        pos, resent = start, 0
        for entry in entries:
            kind, payload, rows = entry
            lo = max(watermark - pos, 0)
            pos += rows
            if lo >= rows:
                continue
            if lo:
                entry = self._slice_entry(entry, lo)
            self._send_entry(dst, slot, entry)
            resent += rows - lo
        with self._lock:
            self.rows_forwarded[g] = max(self.rows_forwarded[g], watermark)
            dst.rows_forwarded += resent
        return gap, resent

    @staticmethod
    def _slice_entry(entry, lo: int):
        """Drop the first ``lo`` rows of a replay entry (the checkpoint
        already covers them)."""
        kind, payload, rows = entry
        if kind == "v1":
            # count data rows past TRACE stamps; keep a stamp only with
            # its row
            out, seen, trace = [], 0, None
            for ln in payload:
                if ln.startswith("TRACE"):
                    trace = ln
                    continue
                if seen >= lo:
                    if trace is not None:
                        out.append(trace)
                    out.append(ln)
                trace = None
                seen += 1
            return ("v1", out, rows - lo)
        header, X, y, _ = wire.decode_frame(payload)
        return ("v2", wire.encode_frame(X[lo:], y[lo:], tenant=0), rows - lo)

    def _resume(self, g: int, b: _Backend, slot: int) -> None:
        """Quiesced → active: flush rows held while the tenant moved,
        THEN flip active — a row routed mid-drain must never overtake
        the held ones."""
        while True:
            with self._lock:
                held = self._pending[g]
                if not held:
                    self._state[g] = "active"
                    return
                self._pending[g] = []
                self._pending_rows[g] = 0
                for entry in held:
                    self._account(g, b, entry)
            for entry in held:
                self._send_entry(b, slot, entry)

    # -- graceful migration + rebalance --------------------------------------

    def migrate_tenant(
        self, g: int, dst_name: str, *, drain_timeout: float = 60.0
    ) -> bool:
        """Live-migrate tenant ``g`` to backend ``dst_name``: quiesce →
        FLUSH + drain the source slot → SAVETENANT → LOADTENANT into a
        vacant slot → re-send any delta → resume. Flags are
        bit-identical across the move (the slot's full identity — global
        id, stream seed, stripe shuffle seed, positions — ships in the
        checkpoint). Returns True on success; failure resumes the tenant
        at its source, serving uninterrupted."""
        dst = self._by_name.get(dst_name)
        if dst is None or not dst.alive:
            raise ValueError(f"no live backend named {dst_name!r}")
        with self._lock:
            if g not in self.place:
                raise ValueError(f"unknown global tenant {g}")
            src, slot = self.place[g]
            if src is dst:
                return True
            if self._state[g] != "active":
                raise RuntimeError(
                    f"tenant {g} is {self._state[g]}; cannot migrate"
                )
            self._state[g] = "quiesced"
            forwarded = self.rows_forwarded[g]
        try:
            # Drain: everything the router forwarded must be ADMITTED
            # (sealed into the batcher's accounting) before the save, so
            # the checkpoint's watermark equals our forwarded count and
            # the delta re-send is empty.
            src.send(b"FLUSH\n")
            deadline = time.monotonic() + drain_timeout
            while time.monotonic() < deadline:
                try:
                    detail = (src.statusz().get("tenant_detail") or [])
                except (urllib.error.URLError, OSError, ValueError):
                    break
                st = detail[slot] if slot < len(detail) else None
                if (
                    st is not None
                    and int(st["rows_admitted"]) >= forwarded
                    and int(st["buffered"]) == 0
                ):
                    break
                time.sleep(0.05)
            ship = self._ship_path(g)
            reply = src.control(f"SAVETENANT {slot} {ship}")
            if not reply.startswith("OK SAVETENANT"):
                raise RuntimeError(f"source refused the save: {reply}")
            err = self._land(
                g, dst, ship, src_name=src.name, kind="migrated"
            )
            if err is None:
                with self._lock:
                    src.slot_ids[slot] = -1  # vacated: new landing capacity
                return True
            raise RuntimeError(err)  # → resume at the source below
        except (OSError, RuntimeError) as e:
            self._journal(
                "migration_failed", tenant=g, src=src.name,
                dst=dst_name, why=str(e),
            )
            self._resume(g, src, slot)  # serve on, from the source
            return False

    def _ship_path(self, g: int) -> str:
        base = self.telemetry_dir or "."
        return os.path.join(base, f"migrate.t{g}.ckpt")

    def _run_rebalance(self) -> None:
        prev: "dict[str, tuple[float, int, dict[int, int]]]" = {}
        while not self._stop.wait(self.rebalance_every_s):
            if self._draining:
                continue
            self.rebalance_once(prev)

    def rebalance_once(self, prev: "dict | None" = None) -> "tuple | None":
        """One rebalance evaluation over the backends' /statusz stream
        accounting; migrates and returns ``(tenant, src, dst)`` when the
        fleet is imbalanced, else None. ``prev`` carries the last poll's
        counters between calls (rates need two samples)."""
        if prev is None:
            prev = {}
        now = time.monotonic()
        rates: "dict[str, float]" = {}
        tenant_rates: "dict[str, dict[int, float]]" = {}
        vacancies: "dict[str, int]" = {}
        for b in self.backends:
            if not b.alive:
                continue
            try:
                s = b.statusz()
            except (urllib.error.URLError, OSError, ValueError):
                continue
            rows = int((s.get("rows") or {}).get("admitted") or 0)
            detail = {
                int(t["id"]): int(t["rows_admitted"])
                for t in s.get("tenant_detail") or []
                if int(t["id"]) >= 0
            }
            with self._lock:
                vacancies[b.name] = sum(1 for g in b.slot_ids if g == -1)
            last = prev.get(b.name)
            if last is not None and now > last[0]:
                dt = now - last[0]
                rates[b.name] = (rows - last[1]) / dt
                tenant_rates[b.name] = {
                    g: (r - last[2].get(g, 0)) / dt
                    for g, r in detail.items()
                }
            prev[b.name] = (now, rows, detail)
        move = plan_rebalance(
            rates, tenant_rates, vacancies, self.rebalance_ratio
        )
        if move is None:
            return None
        g, src, dst = move
        self._journal("rebalance", tenant=g, src=src, dst=dst)
        try:
            if self.migrate_tenant(g, dst):
                return move
        except (ValueError, RuntimeError) as e:
            # the plan raced a failover/quiesce or the destination died
            # since the poll — skip this round, never kill the
            # rebalance thread
            self._journal(
                "rebalance_skipped", tenant=g, dst=dst, why=str(e)
            )
        return None

    # -- ops plane -----------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            placements = {
                str(g): {
                    "backend": b.name,
                    "slot": s,
                    "state": self._state[g],
                    "rows_forwarded": self.rows_forwarded[g],
                }
                for g, (b, s) in sorted(self.place.items())
            }
            backends = [
                {
                    "name": b.name,
                    "spec": repr(b.spec),
                    "alive": b.alive,
                    "rows_forwarded": b.rows_forwarded,
                    "slots": list(b.slot_ids),
                }
                for b in self.backends
            ]
            total = sum(self.rows_forwarded.values())
        dead = [b["name"] for b in backends if not b["alive"]]
        orphaned = [
            g for g, p in placements.items() if p["state"] == "orphaned"
        ]
        now = time.monotonic()
        return {
            "router": True,
            "run_id": self.name,
            "name": self.name,
            "pid": os.getpid(),
            "uptime_s": (
                round(now - self._t_start, 3)
                if self._t_start is not None
                else None
            ),
            "draining": self._draining,
            "tenants": len(placements),
            # the fields the `top` dashboard's StatuszSource renders —
            # a router row reads like a daemon serving the whole fleet
            "rows": {"published": total, "admitted": total},
            "detections": None,
            "ingress": {
                "frames_v1": self.frames_v1,
                "frames_v2": self.frames_v2,
                "decode_errors": self.decode_errors,
            },
            "backend_errors": self.backend_errors,
            "migrations": self.migrations,
            "failovers": self.failovers,
            "rows_lost": self.rows_lost,
            "alerts": (
                [{"rule": f"backend_dead:{n}"} for n in dead]
                + [{"rule": f"orphaned:{g}"} for g in orphaned]
            ),
            "backends": backends,
            "placements": placements,
        }

    def fleetz(self) -> dict:
        """The merged fleet view (``/fleetz``): scrape every live
        backend's ``/statusz`` (falling back to its ``/metrics`` for
        the busy map when the pipeline section is absent) and fold
        into summed rows/s, max per-stage busy share, and per-backend
        bottleneck stages. Computed on request, outside the router
        lock — a slow backend stalls the scrape, never the data path."""
        from ..telemetry.pipeline import aggregate_fleet, backend_snapshot

        with self._lock:
            backends = list(self.backends)
        snaps = []
        for b in backends:
            status = metrics = None
            if b.alive:
                try:
                    status = b.statusz(timeout=2.0)
                    if not (status.get("pipeline") or {}).get("busy_s"):
                        metrics = b.metrics_text(timeout=2.0)
                except (urllib.error.URLError, OSError, ValueError):
                    status = metrics = None
            snaps.append(
                backend_snapshot(
                    b.name or repr(b.spec),
                    status,
                    metrics,
                    # ops address rides into the fleetz row: the history
                    # collector's --fleetz discovery scrapes it
                    ops=f"{b.spec.host}:{b.spec.ops_port}",
                )
            )
        return aggregate_fleet(snaps)

    def _health(self) -> "tuple[int, dict]":
        with self._lock:
            alive = [b.name for b in self.backends if b.alive]
            dead = [b.name for b in self.backends if not b.alive]
            orphaned = [
                g for g, st in self._state.items() if st == "orphaned"
            ]
        healthy = bool(alive) and not orphaned
        return (
            200 if healthy else 503,
            {
                "status": "ok" if healthy else "degraded",
                "alive": alive,
                "dead": dead,
                "orphaned": orphaned,
            },
        )

    def _start_ops(self):
        from ..telemetry.ops import OpsServer

        ops = OpsServer(
            self.host,
            self.ops_port or 0,
            metrics_fn=self._metrics_text,
            health_fn=self._health,
            status_fn=self.status,
            fleetz_fn=self.fleetz,
        )
        ops.start()
        return ops

    def _metrics_text(self) -> str:
        from ..telemetry.pipeline import fleet_metrics_lines

        # fleet_* series ride the router's scrape: aggregate first
        # (its own backend scrapes), THEN take the lock for the
        # router-local counters.
        fleet_lines = fleet_metrics_lines(self.fleetz())
        with self._lock:
            lines = [
                "# TYPE router_rows_forwarded_total counter",
                *(
                    f'router_rows_forwarded_total{{backend="{b.name}"}} '
                    f"{b.rows_forwarded}"
                    for b in self.backends
                ),
                "# TYPE router_backend_alive gauge",
                *(
                    f'router_backend_alive{{backend="{b.name}"}} '
                    f"{int(b.alive)}"
                    for b in self.backends
                ),
                "# TYPE router_migrations_total counter",
                f"router_migrations_total {self.migrations}",
                "# TYPE router_rows_lost_total counter",
                f"router_rows_lost_total {self.rows_lost}",
            ]
        return "\n".join(lines + fleet_lines) + "\n"


class _Reject(Exception):
    """Protocol violation on a CLIENT connection: ERR + close that
    connection, never the router."""


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> None:
    """``router``: the fleet front daemon (see module docstring)."""
    ap = argparse.ArgumentParser(
        prog="python -m distributed_drift_detection_tpu_torch router",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--backend", action="append", default=[],
                    metavar="HOST:PORT:OPS_PORT", required=True,
                    help="one serving daemon (repeatable; data port + "
                    "ops port)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="client-facing data port (0 = OS-assigned; "
                    "printed in the banner)")
    ap.add_argument("--ops-port", type=int, default=None,
                    help="router ops plane (/healthz /metrics /statusz); "
                    "omitted = no ops server, 0 = OS-assigned")
    ap.add_argument("--name", default="router")
    ap.add_argument("--telemetry-dir", default=None,
                    help="placement journal (router.journal.jsonl) + "
                    "migration checkpoint staging")
    ap.add_argument("--health-interval", type=float, default=1.0,
                    help="seconds between backend /healthz polls")
    ap.add_argument("--health-fails", type=int, default=3,
                    help="consecutive missed polls before a backend is "
                    "declared dead")
    ap.add_argument("--no-failover", action="store_true",
                    help="mark a dead backend's tenants orphaned instead "
                    "of re-placing them from checkpoints")
    ap.add_argument("--replay-buffer", type=int,
                    default=REPLAY_BUFFER_ROWS, metavar="ROWS",
                    help="per-tenant replay-buffer rows (must cover the "
                    "worst checkpoint→death gap for lossless failover)")
    ap.add_argument("--rebalance-every", type=float, default=0.0,
                    metavar="S",
                    help="poll the fleet's per-tenant stream accounting "
                    "every S seconds and migrate the hottest tenant off "
                    "an imbalanced backend (0 = off)")
    ap.add_argument("--rebalance-ratio", type=float, default=2.0,
                    help="max/min backend row-rate ratio that triggers a "
                    "rebalance migration")
    ap.add_argument("--connect-timeout", type=float, default=60.0,
                    help="seconds to wait for every backend's ops plane "
                    "at startup (fleets compile before they answer)")
    ap.add_argument("--max-frame-rows", type=int,
                    default=wire.MAX_FRAME_ROWS, metavar="N",
                    help="reject client v2 frames declaring more rows at "
                    "the router's edge; set to the minimum of the "
                    "backends' --max-frame-rows so an oversized frame "
                    "never reaches (and closes) a shared backend "
                    "connection")
    args = ap.parse_args(argv)

    router = TenantRouter(
        [BackendSpec(b) for b in args.backend],
        host=args.host,
        port=args.port,
        ops_port=args.ops_port,
        telemetry_dir=args.telemetry_dir,
        name=args.name,
        health_interval_s=args.health_interval,
        health_fails=args.health_fails,
        failover=not args.no_failover,
        replay_rows=args.replay_buffer,
        rebalance_every_s=args.rebalance_every,
        rebalance_ratio=args.rebalance_ratio,
        connect_timeout=args.connect_timeout,
        max_frame_rows=args.max_frame_rows,
    )
    banner = router.start()
    print(json.dumps(banner), flush=True)

    import signal

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    try:
        while not stop.is_set():
            stop.wait(0.5)
    finally:
        router.stop()


if __name__ == "__main__":
    main(sys.argv[1:])
