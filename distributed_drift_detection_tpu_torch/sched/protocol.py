"""The scheduler control protocol: newline-delimited JSON over TCP — the
port's own copy of the JAX package's ``sched/protocol.py``, the same wire
format, so either package's workers and ``heal --scheduler`` speak to
either package's scheduler.

One request line → exactly one reply line, on a persistent connection
(a worker holds one for its whole life; ``heal --scheduler`` opens one
per submission). Pure stdlib, no torch — the protocol is the seam between
the scheduler daemon and whatever runs cells.

Requests (``op`` discriminates; unknown ops get an ``error`` reply,
never a dropped connection):

=============  ==========================================================
``hello``      worker enrollment: ``{worker, pid, hostname, ...}`` →
               ``welcome`` carrying the scheduler's identity and the
               knobs the worker must honor (``telemetry_dir``,
               ``lease_s``, ``heartbeat_s``, ``poll_s``)
``lease``      request one cell: → ``lease`` (a wire cell + the TTL),
               ``wait`` (cells exist but none grantable — poll again in
               ``poll_s``), or ``drain`` (sweep is whole; exit 0)
``heartbeat``  liveness + progress while a cell runs: → ``ack``, or
               ``revoked`` (the scheduler already re-leased this cell —
               the worker MUST abandon it without recording anything),
               or ``drain``
``done``       cell finished; ``ack`` carries ``accepted`` (False for a
               revoked/unknown lease — the completion is discarded)
``fail``       cell attempt failed (the supervisor's retries are
               exhausted); the scheduler requeues or marks the cell
               failed (``ack`` carries ``requeued``)
``submit``     enqueue extra cells (the ``heal --scheduler`` path):
               ``{cells: [wire cells]}`` → ``ack`` with ``queued`` /
               ``duplicates`` counts
``status``     one ``/statusz``-shaped JSON snapshot (CLI pokes, tests)
``bye``        graceful worker exit → ``ack``
=============  ==========================================================

A **wire cell** is the self-contained description a worker needs to run
one trial and nothing more: the digest payload
(``config.telemetry_config_payload`` — the registry identity), the
bookkeeping fields that stay out of the digest (``results_csv``,
``time_string``, ``data_policy``), the resolved ``app_name`` and the
``digest`` itself. The worker rebuilds the ``RunConfig``
(``config.config_from_payload``) and refuses to run a cell whose
rebuilt config digests differently — the byte-identity contract that
keeps a scheduler-run sweep and a serial ``grid`` run the same cells.
"""

from __future__ import annotations

import json
import socket

# Knob defaults, shared by the scheduler CLI and the worker agent (the
# welcome reply carries the scheduler's actual values; these are the
# one copy of the fallbacks).
DEFAULT_LEASE_S = 120.0  # heartbeat-refreshed lease TTL (stall budget)
DEFAULT_HEARTBEAT_S = 2.0  # worker heartbeat period while a cell runs
DEFAULT_POLL_S = 0.5  # worker re-poll period on a `wait` reply

MAX_LINE_BYTES = 4 << 20  # one request/reply line; a bigger one is abuse


class ProtocolError(ValueError):
    """A malformed message (not JSON, no ``op``, oversized line) or a
    connection that died mid-reply."""


def encode(msg: dict) -> bytes:
    """One wire line: compact JSON + newline."""
    return (json.dumps(msg, separators=(",", ":")) + "\n").encode()


def decode_line(line: "bytes | str") -> dict:
    """Parse one complete wire line into a message dict; raises
    :class:`ProtocolError` on anything that is not a JSON object with an
    ``op`` (untrusted input: the scheduler must reject, never crash)."""
    try:
        msg = json.loads(line)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ProtocolError(f"control line is not JSON ({e})") from None
    if not isinstance(msg, dict) or not isinstance(msg.get("op"), str):
        raise ProtocolError("control message must be a JSON object with 'op'")
    return msg


def error_reply(exc: "BaseException | str") -> dict:
    detail = exc if isinstance(exc, str) else f"{type(exc).__name__}: {exc}"
    return {"op": "error", "error": detail}


def cell_to_wire(cfg, digest: "str | None" = None) -> dict:
    """One trial config → its self-contained wire cell. No torch
    (``config`` + ``telemetry.registry`` only)."""
    from ..config import telemetry_config_payload
    from ..telemetry.registry import config_digest

    payload = telemetry_config_payload(cfg)
    return {
        "app_name": cfg.resolved_app_name(),
        "digest": digest or config_digest(payload),
        "payload": payload,
        # Bookkeeping the digest deliberately excludes but a worker needs
        # to reproduce the serial grid run byte-for-byte:
        "results_csv": cfg.results_csv,
        "time_string": cfg.time_string,
        "data_policy": cfg.data_policy,
    }


def cell_from_wire(cell: dict, **overrides):
    """Rebuild the runnable ``RunConfig`` from a wire cell, verifying the
    round trip digests identically (a schema drift between scheduler and
    worker must fail loudly, not run the wrong experiment)."""
    from ..config import config_from_payload, telemetry_config_payload
    from ..telemetry.registry import config_digest

    cfg = config_from_payload(
        cell["payload"],
        results_csv=cell.get("results_csv", ""),
        time_string=cell.get("time_string", ""),
        data_policy=cell.get("data_policy", "strict"),
        **overrides,
    )
    rebuilt = config_digest(telemetry_config_payload(cfg))
    if rebuilt != cell["digest"]:
        raise ProtocolError(
            f"cell {cell.get('app_name')!r} rebuilds to digest {rebuilt}, "
            f"scheduler sent {cell['digest']} — config schema drift between "
            "scheduler and worker; refusing to run the wrong experiment"
        )
    return cfg


class ControlClient:
    """One persistent request/reply connection to a scheduler.

    Blocking, line-buffered, with a per-request timeout. Thread-safety is
    the caller's problem by design: the worker agent serializes its own
    traffic (the heartbeat thread and the main loop share one lock).
    """

    def __init__(self, host: str, port: int, *, timeout: float = 30.0):
        self.addr = (host, int(port))
        self.timeout = timeout
        self._sock: "socket.socket | None" = None
        self._buf = b""

    def connect(self) -> None:
        if self._sock is not None:
            return
        s = socket.create_connection(self.addr, timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._buf = b""

    def request(self, msg: dict) -> dict:
        """Send one message, wait for its one reply. An ``error`` reply
        raises :class:`ProtocolError` (the scheduler rejected the
        request); transport failures raise ``OSError`` after closing the
        connection so the next request reconnects cleanly."""
        self.connect()
        assert self._sock is not None
        try:
            self._sock.sendall(encode(msg))
            while True:
                nl = self._buf.find(b"\n")
                if nl >= 0:
                    line, self._buf = self._buf[:nl], self._buf[nl + 1 :]
                    reply = decode_line(line)
                    if reply.get("op") == "error":
                        raise ProtocolError(reply.get("error", "rejected"))
                    return reply
                if len(self._buf) > MAX_LINE_BYTES:
                    raise ProtocolError("oversized control reply")
                chunk = self._sock.recv(65536)
                if not chunk:
                    raise OSError("scheduler closed the control connection")
                self._buf += chunk
        except OSError:
            self.close()
            raise

    def __enter__(self) -> "ControlClient":
        self.connect()
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def parse_addr(addr: str) -> "tuple[str, int]":
    """``host:port`` (or bare ``:port`` / ``port`` for loopback) → tuple;
    the one parser behind ``--scheduler`` / ``--connect`` flags."""
    host, _, port = addr.rpartition(":")
    host = host or "127.0.0.1"
    try:
        return host, int(port)
    except ValueError:
        raise ValueError(
            f"scheduler address {addr!r} must be HOST:PORT"
        ) from None
