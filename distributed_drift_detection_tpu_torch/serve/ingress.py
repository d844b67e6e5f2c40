"""Readiness-based TCP ingress for the serving daemon: one event loop,
N connections, v1 text lines and v2 binary frames auto-detected.

The port's own copy of the JAX package's ``serve/ingress.py``, on the
port's wire codec and admission layer.

Two wire protocols share every connection (docs/SERVING.md "Wire
protocol"):

* **v1 — newline-delimited UTF-8 text** (unchanged byte-for-byte from
  the original thread-per-connection ingress):

  - ``v1,...,vF,label`` — CSV fields, label **last**;
  - ``{"x": [..], "y": l}`` / ``[.., l]`` — JSON rows, normalized to the
    same fields at admission;
  - ``TENANT k`` — route this connection's subsequent v1 rows to tenant
    slot ``k``. A malformed or out-of-range id is untrusted client
    input: the connection gets an ``ERR`` line and is dropped — the
    daemon (and every other tenant's stream) keeps serving;
  - ``TRACE <trace_id> <span_id>`` — mark the **next** v1 data row on
    this connection as head-sampled for end-to-end tracing;
  - ``FLUSH`` / ``STOP`` — seal the partial microbatch / graceful drain.

* **v2 — length-prefixed binary columnar frames** (``serve.wire``): a
  16-byte header + one contiguous f32 feature block + i32 label vector.
  A frame carries its own tenant id and admits as a whole through the
  vectorized frame path (``AdmissionController.admit_frame``) — no text
  parse, no per-row Python. Zero-row control frames are the binary
  FLUSH/STOP twins.

Auto-detection costs one byte test per message boundary: every v1
message opens with an ASCII byte (< 0x80), the v2 magic's first wire
byte is 0xF2 — so the per-connection state machine routes each message
unambiguously and a single connection may interleave both freely.

The listener is a **single event loop** (``selectors``, epoll on Linux):
one thread multiplexing every connection through non-blocking sockets,
instead of one thread per connection. Per-connection state is a framing
state machine (buffered text bytes, or an in-flight frame whose payload
is filled by ``recv_into`` straight into its own buffer — the socket's
bytes land once in memory the admitted rows then alias, no intermediate
copy). Admission itself runs on ONE **admitter thread** behind a bounded
in-order work queue: the event loop does only I/O and framing, the
admitter does the vectorized sanitize + microbatch seals, so socket
drain and admission compute overlap as a two-stage pipeline (both
stages release the GIL for their heavy work — syscalls and numpy). One
admitter, not a pool: admission order is stream position, and the
shared-controller lock would serialize a pool anyway. Backpressure is
global by construction: a full work queue blocks the loop, a full
microbatcher queue blocks the admitter, and TCP pushes back on every
client — the daemon's admission rate, not its memory, is the limit.

Handlers admit v1 rows in *message-boundary blocks*: whatever complete
lines arrived together go through ``AdmissionController.admit_lines`` as
one block, so sanitize cost amortizes under load while a trickling
client still admits per line. The server never acknowledges data; the
one response is ``ERR <reason>`` (strict rejections, protocol
violations — the latter also close that connection). An admission-path
failure (an armed ``serve.ingress`` fault, an unexpected bug) poisons
the batcher — the serve loop re-raises it and the daemon dies loudly
rather than serving around a broken ingress.

Per-protocol accounting (``serve_ingress_frames_total{version=v1|v2}``
counts admitted v1 line blocks / v2 data frames;
``serve_ingress_decode_errors_total`` counts structurally invalid
frames, protocol-line violations and mid-frame disconnects) feeds
``/metrics``, the ``/statusz`` ingress section, and the ``top``
dashboard's WIRE column.
"""

from __future__ import annotations

import queue
import selectors
import socket
import threading

import numpy as np

from . import wire

# One recv per readiness event: sized so a loaded ingress hands the
# vectorized admission parse thousands of rows at a time (a ~100-byte v1
# row → ~2.5k rows per block) instead of drip-feeding it.
_RECV_BYTES = 1 << 18

#: The one-byte v2 protocol discriminator as a bytes needle (fast
#: C-level containment scans over text regions).
_MAGIC_BYTES = bytes([wire.MAGIC_BYTE])


class _ProtocolReject(Exception):
    """Connection-local protocol violation (a bad TENANT id, a malformed
    frame header): drop THIS connection after the ERR reply, never the
    daemon."""


class _Connection:
    """Per-connection framing state (the event loop owns the I/O)."""

    __slots__ = ("sock", "buf", "tenant", "trace_next", "pending")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = bytearray()  # unconsumed text/header bytes
        self.tenant = 0  # v1 per-connection routing (the TENANT line)
        self.trace_next = None  # pending TRACE context for the next v1 row
        # In-flight v2 frame: (header, payload bytearray, filled bytes).
        # While set, recv_into fills the payload buffer directly — the
        # socket's payload bytes land once, in memory the admitted rows
        # then alias (wire.payload_views).
        self.pending: "tuple | None" = None


class IngressServer:
    """The listener: ONE daemon thread multiplexing every connection.

    ``on_stop`` is the runner's graceful-drain hook (the ``STOP``
    protocol message, text or control frame); :attr:`batcher` /
    :attr:`admissions` are shared with the serve loop. ``port`` after
    construction carries the bound port (``port=0`` requests an
    OS-assigned one). ``metrics`` (a ``telemetry.metrics``
    ``MetricsRegistry``) adds the per-protocol ingress counters;
    ``max_frame_rows`` bounds a v2 header's declared row count
    (``ServeParams.max_frame_rows``).
    """

    def __init__(
        self, host: str, port: int, admissions, batcher, on_stop,
        sampler=None, metrics=None,
        max_frame_rows: int = wire.MAX_FRAME_ROWS,
        on_control=None,
    ):
        # One admission controller per tenant slot (the TENANT line and
        # the frame tenant field route); a solo daemon passes a
        # 1-element list.
        self.admissions = list(admissions)
        self.batcher = batcher
        self.on_stop = on_stop
        # Tenant-migration control hook (ServeRunner.request_control):
        # SAVETENANT/LOADTENANT wire lines land here, in wire order via
        # the work queue; None (solo embedders) rejects the lines.
        self.on_control = on_control
        # Daemon-side head sampler (telemetry.tracing.HeadSampler) for
        # rows the client did not TRACE-stamp; None/rate-0 = off.
        self.sampler = sampler
        # 0 = the codec default (ServeParams.max_frame_rows's sentinel;
        # wire.MAX_FRAME_ROWS stays the one copy of the constant).
        self.max_frame_rows = int(max_frame_rows) or wire.MAX_FRAME_ROWS
        # Per-protocol accounting (GIL-atomic ints; the ops plane reads
        # them from its own thread via stats()).
        self.frames_v1 = 0  # admitted v1 line blocks
        self.frames_v2 = 0  # admitted v2 data frames
        self.decode_errors = 0  # malformed frames / protocol lines
        self._c_frames = self._c_decode = None
        if metrics is not None:
            self._c_frames = metrics.counter(
                "serve_ingress_frames_total",
                help="Ingress messages admitted per wire protocol "
                "(v1 = text line blocks, v2 = binary data frames)",
            )
            self._c_decode = metrics.counter(
                "serve_ingress_decode_errors_total",
                help="Structurally invalid ingress messages (bad frame "
                "header, malformed protocol line, mid-frame disconnect)",
            )
        self._sel = selectors.DefaultSelector()
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((host, port))
        self._listen.listen(128)
        self._listen.setblocking(False)
        self._conns: "dict[socket.socket, _Connection]" = {}
        self._stop_evt = threading.Event()
        self._thread: "threading.Thread | None" = None
        # The admitter pipeline stage: complete messages (closures) run
        # in arrival order on one worker thread, overlapping admission
        # compute with the loop's socket drain. Bounded: a slow admitter
        # backpressures the loop, and TCP backpressures the clients.
        self._work: "queue.Queue" = queue.Queue(maxsize=8)
        self._admitter: "threading.Thread | None" = None

    # -- shared lookups (also used by tests) ---------------------------------

    def admission_for(self, tenant: int):
        """The admission controller serving ``tenant``."""
        return self.admissions[tenant]

    def check_tenant(self, tenant: int) -> int:
        """Validate a tenant id (TENANT line or frame header field)
        against the daemon's tenant plane."""
        n = len(self.admissions)
        if not 0 <= tenant < n:
            raise ValueError(
                f"TENANT {tenant} out of range (daemon serves {n} tenant(s))"
            )
        return tenant

    def check_trace(self, line: str) -> "tuple[str, str]":
        """Parse + validate a ``TRACE <trace_id> <span_id>`` wire line
        (untrusted client input; raises ValueError on any malformation)."""
        from ..telemetry.tracing import check_trace_token

        parts = line.split()
        if len(parts) != 3:
            raise ValueError(
                f"TRACE line needs exactly 'TRACE <trace_id> <span_id>', "
                f"got {len(parts)} token(s)"
            )
        return check_trace_token(parts[1]), check_trace_token(parts[2])

    def stats(self) -> dict:
        """Per-protocol ingress accounting (the ``/statusz`` ingress
        section; rendered by ``top``'s WIRE column)."""
        return {
            "frames_v1": self.frames_v1,
            "frames_v2": self.frames_v2,
            "decode_errors": self.decode_errors,
            "connections": len(self._conns),
        }

    @property
    def port(self) -> int:
        return self._listen.getsockname()[1]

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._sel.register(self._listen, selectors.EVENT_READ, None)
        self._admitter = threading.Thread(
            target=self._admit_worker, name="serve-admitter", daemon=True
        )
        self._admitter.start()
        self._thread = threading.Thread(
            target=self._run, name="serve-ingress", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None and self._thread is not threading.current_thread():
            # The loop notices the event within one select timeout. A
            # drain-time join may time out while the loop is blocked in a
            # backpressured put — the serve loop keeps consuming, so the
            # thread unwedges and exits on its own (it is a daemon
            # thread either way).
            self._thread.join(timeout=5)
        if self._admitter is not None:
            # Sentinel: drain queued admissions, then exit. NON-blocking:
            # stop() runs on the serve loop — the batcher's only consumer
            # — and the admitter may right now be wedged in a
            # backpressured batcher.push that only our caller's drain can
            # relieve. A blocking put on the full work queue here would
            # deadlock the whole drain; when the queue is full the
            # _stop_evt poll below is the admitter's exit path instead.
            try:
                self._work.put_nowait(None)
            except queue.Full:
                pass
            self._admitter.join(timeout=5)
            self._admitter = None

    def _admit_worker(self) -> None:
        """The admitter stage: run queued admissions in arrival order.
        An admission-path failure already poisoned the batcher inside its
        closure (the serve loop dies loudly); the worker keeps draining
        so the stop sentinel is always reachable. The get() polls so a
        stop() that could not enqueue its sentinel (full queue at drain
        time) still terminates the thread once the backlog drains."""
        while True:
            try:
                task = self._work.get(timeout=0.1)
            except queue.Empty:
                if self._stop_evt.is_set():
                    return
                continue
            if task is None:
                return
            try:
                task()
            except BaseException:
                # Evidence lives in the poisoned batcher + ERR replies;
                # every later admission raises the same poison and is
                # swallowed the same way while the daemon dies.
                pass

    def _run(self) -> None:
        try:
            while not self._stop_evt.is_set():
                for key, _ in self._sel.select(timeout=0.1):
                    if key.data is None:
                        self._accept()
                    else:
                        self._service(key.data)
        finally:
            for conn in list(self._conns.values()):
                self._close(conn)
            try:
                self._sel.unregister(self._listen)
            except (KeyError, ValueError):
                pass
            self._listen.close()
            self._sel.close()

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._listen.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return  # listener closing under us (drain)
            sock.setblocking(False)
            conn = _Connection(sock)
            self._conns[sock] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)

    def _close(self, conn: _Connection) -> None:
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        self._conns.pop(conn.sock, None)
        try:
            conn.sock.close()
        except OSError:
            pass

    # -- I/O -----------------------------------------------------------------

    def _service(self, conn: _Connection) -> None:
        try:
            if conn.pending is not None and not conn.buf:
                # Mid-frame: the socket's payload bytes land directly in
                # the frame's own buffer — no intermediate copy.
                header, payload, filled = conn.pending
                n = conn.sock.recv_into(memoryview(payload)[filled:])
                if n == 0:
                    self._eof(conn)
                    return
                filled += n
                if filled == len(payload):
                    conn.pending = None
                    self._finish_frame(conn, header, payload)
                else:
                    conn.pending = (header, payload, filled)
                return
            data = conn.sock.recv(_RECV_BYTES)
            if not data:
                self._eof(conn)
                return
            conn.buf += data
            self._consume(conn)
        except (BlockingIOError, InterruptedError):
            return
        except _ProtocolReject:
            self._close(conn)  # ERR already sent; just this connection
        except OSError:
            self._close(conn)  # peer went away mid-I/O
        except BaseException as e:
            # Genuine internal failure ON THE LOOP THREAD (a payload
            # allocation failing, a sampler bug — admissions themselves
            # run on the admitter thread and poison from their own
            # closures). Swallowing it would close the connection with
            # zero evidence while the daemon keeps serving; poison the
            # batcher instead so the serve loop dies loudly — the same
            # contract every admission-path failure honors.
            self.batcher.poison(e)
            self._close(conn)

    def _eof(self, conn: _Connection) -> None:
        """Peer closed its half: flush what can be flushed, then close."""
        try:
            if conn.pending is not None:
                # Mid-frame disconnect: the partial frame's rows were
                # never admitted — no misattribution possible — but the
                # stream was structurally cut, which is a decode error.
                conn.pending = None
                self._count_decode_error()
            elif conn.buf.strip():
                # A trailing v1 line without its newline (the original
                # thread-per-connection ingress admitted it too).
                if conn.buf[0] == wire.MAGIC_BYTE:
                    self._count_decode_error()  # truncated frame header
                else:
                    self._process_text(
                        conn,
                        [conn.buf.decode("utf-8", errors="replace")],
                    )
        except _ProtocolReject:
            pass
        finally:
            self._close(conn)

    def _consume(self, conn: _Connection) -> None:
        """Drain complete messages from ``conn.buf`` (the framing state
        machine; partial messages stay buffered)."""
        buf = conn.buf
        n = len(buf)
        pos = 0
        while pos < n:
            if conn.pending is not None:
                # Payload bytes that arrived in the same recv as the
                # header (or as trailing text): copy the overlap into the
                # frame buffer; steady-state payload traffic bypasses
                # this via the recv_into fast path in _service.
                header, payload, filled = conn.pending
                take = min(n - pos, len(payload) - filled)
                payload[filled : filled + take] = memoryview(buf)[
                    pos : pos + take
                ]
                filled += take
                pos += take
                if filled == len(payload):
                    conn.pending = None
                    self._finish_frame(conn, header, payload)
                else:
                    conn.pending = (header, payload, filled)
                continue
            if buf[pos] == wire.MAGIC_BYTE:
                if n - pos < wire.HEADER_SIZE:
                    # Partial header: validate the bytes already here so
                    # a garbage burst fails NOW (ERR + close) instead of
                    # silently waiting for a header that never completes.
                    avail = n - pos
                    if (
                        avail >= 2 and buf[pos + 1] != wire.MAGIC >> 8
                    ) or (avail >= 3 and buf[pos + 2] != wire.VERSION):
                        self._reject(
                            conn,
                            wire.WireError(
                                "bad frame magic/version in partial header"
                            ),
                        )
                    break  # plausible prefix — wait for more bytes
                try:
                    header = wire.decode_header(
                        memoryview(buf)[pos : pos + wire.HEADER_SIZE],
                        max_rows=self.max_frame_rows,
                    )
                except wire.WireError as e:
                    self._reject(conn, e)
                pos += wire.HEADER_SIZE
                if header.is_control:
                    # Through the work queue (like the FLUSH/STOP text
                    # lines): controls must act AFTER the admissions
                    # queued before them.
                    if header.flags & wire.FLAG_FLUSH:
                        self._work.put(self.batcher.flush)
                    if header.flags & wire.FLAG_STOP:
                        self._work.put(self.on_stop)
                    continue
                if header.payload_nbytes == 0:  # unreachable; defensive
                    continue
                # Contract validation BEFORE the payload buffer exists:
                # the decoder's geometry bounds alone still admit a
                # hostile header declaring max_rows × MAX_FRAME_FEATURES
                # (a quarter-terabyte allocation). The daemon's own row
                # contract is known right here, so a frame that cannot
                # possibly admit must be refused pre-allocation — that is
                # the documented no-OOM guarantee (config.max_frame_rows).
                try:
                    tenant = self.check_tenant(header.tenant)
                except (ValueError, IndexError) as e:
                    self._reject(conn, e)
                expect = self.admissions[tenant].num_features
                if header.features != expect:
                    self._reject(
                        conn,
                        wire.WireError(
                            f"frame declares {header.features} feature(s); "
                            f"this daemon serves {expect}"
                        ),
                    )
                # np.empty, not bytearray: the payload is overwritten
                # from the socket, so the zero-fill would be pure memset
                # waste at ingest rates.
                conn.pending = (
                    header, np.empty(header.payload_nbytes, np.uint8), 0
                )
                continue
            # Text region: batch every complete line up to the next
            # message boundary that opens a frame (v1 clients never send
            # one, so their whole recv block admits as a single batch —
            # byte-for-byte the original ingress semantics, and the same
            # bulk rfind + one decode + one split per recv block, not a
            # per-line Python loop — the v1 ingest ceiling must not move).
            cut = buf.rfind(b"\n", pos)
            if cut < 0:
                break  # partial trailing line
            chunk = bytes(buf[pos:cut])
            if _MAGIC_BYTES not in chunk:  # pure text — one C-level scan
                self._process_text(
                    conn, chunk.decode("utf-8", errors="replace").split("\n")
                )
                pos = cut + 1
                continue
            # Rare: a magic byte inside the complete-lines region. Only a
            # line that OPENS with it is a frame boundary — a mid-line
            # 0xF2 is ordinary (dirty) text, exactly like the original
            # per-line ingress. Admit text up to the first frame opener.
            raw = chunk.split(b"\n")
            stop = next(
                (i for i, rl in enumerate(raw) if rl[:1] == _MAGIC_BYTES),
                None,
            )
            if stop is None:
                self._process_text(
                    conn,
                    [rl.decode("utf-8", errors="replace") for rl in raw],
                )
                pos = cut + 1
                continue
            if stop:
                self._process_text(
                    conn,
                    [
                        rl.decode("utf-8", errors="replace")
                        for rl in raw[:stop]
                    ],
                )
            pos += sum(len(rl) + 1 for rl in raw[:stop])
            # buf[pos] is now the frame opener — the next iteration's
            # magic-byte branch parses it.
        del buf[:pos]

    # -- v2 frames -----------------------------------------------------------

    def _finish_frame(self, conn: _Connection, header, payload) -> None:
        """One complete data frame (tenant + feature count were validated
        in _consume, before the payload buffer was even allocated): queue
        the vectorized frame admission for the admitter stage."""
        admission = self.admission_for(header.tenant)
        X, y = wire.payload_views(header, payload)
        traces = None
        if self.sampler:
            # Daemon-side head sampling (fresh root traces) — frames
            # carry no TRACE stamps, so the daemon's sampler is the one
            # trace source on the v2 path. Decided here, on the loop
            # thread, so sampling order matches arrival order.
            traces = [
                (i, *self.sampler.new_context())
                for i in self.sampler.sample_block(header.rows)
            ] or None

        def task() -> None:
            try:
                res = admission.admit_frame(X, y, traces=traces)
            except BaseException as e:
                # The daemon must die loudly on an ingress-path failure
                # (the armed serve.ingress fault is the rehearsal):
                # poison the batcher so the serve loop re-raises, tell
                # the client, and end this connection.
                self.batcher.poison(e)
                self._send(conn, f"ERR {type(e).__name__}: {e}")
                raise
            self.frames_v2 += 1
            if self._c_frames is not None:
                self._c_frames.inc(version="v2")
            if res.get("error"):
                self._send(conn, "ERR " + res["error"])

        self._work.put(task)

    # -- v1 text lines (semantics unchanged from the threaded ingress) ------

    def _process_text(self, conn: _Connection, lines: list[str]) -> None:
        block: list[str] = []
        marks: list[tuple] = []  # (block index, trace_id, span_id)
        for ln in lines:
            s = ln.strip()
            if not s:
                continue
            if s.startswith("TENANT"):
                # Any TENANT-prefixed line is a routing directive: no data
                # row starts with it (CSV rows open with a digit/sign,
                # JSON with {/[), so a malformed one ('TENANT', 'TENANT x')
                # must reject loudly here — falling through as a dirty
                # data row would leave every following row silently
                # routed to the PREVIOUS tenant's slot. Admit what
                # accumulated under the previous tenant first — blocks
                # are per-tenant by construction.
                self._admit(conn, block, marks)
                block, marks = [], []
                try:
                    conn.tenant = self.check_tenant(int(s[6:].strip()))
                except (ValueError, IndexError) as e:
                    # Untrusted client input: reject THIS connection
                    # (ERR + close), never the daemon — one client's
                    # typo must not take down the other tenants.
                    self._reject(conn, e)
            elif s.startswith("TRACE"):
                # Same no-data-row-starts-with-it argument as TENANT: a
                # malformed TRACE must reject here, or it would parse as
                # a dirty data row and silently shift positions.
                try:
                    conn.trace_next = self.check_trace(s)
                except (ValueError, IndexError) as e:
                    self._reject(conn, e)
            elif s.startswith(("SAVETENANT", "LOADTENANT")):
                # Migration control lines (serve.router): `SAVETENANT
                # <slot> <path>` drains slot state into a solo-shaped
                # checkpoint, `LOADTENANT <slot> <path>` installs one.
                # Same no-data-row-starts-with-it argument as TENANT —
                # malformed control must reject loudly, never admit as a
                # dirty row. Admit what accumulated first (wire order),
                # then ride the work queue so the request lands strictly
                # after the admissions before it; the serve loop executes
                # it and replies OK/ERR on this connection.
                self._admit(conn, block, marks)
                block, marks = [], []
                parts = s.split(maxsplit=2)
                try:
                    if self.on_control is None:
                        raise ValueError(
                            "tenant control surface not enabled on this "
                            "daemon"
                        )
                    if len(parts) != 3:
                        raise ValueError(
                            f"{parts[0]} needs exactly "
                            f"'{parts[0]} <slot> <path>'"
                        )
                    op, slot, path = (
                        parts[0],
                        self.check_tenant(int(parts[1])),
                        parts[2],
                    )
                except (ValueError, IndexError) as e:
                    self._reject(conn, e)

                def ctrl(op=op, slot=slot, path=path, conn=conn):
                    self.on_control(
                        op, slot, path,
                        lambda line: self._send(conn, line),
                    )

                self._work.put(ctrl)
            elif s == "FLUSH":
                self._admit(conn, block, marks)
                block, marks = [], []
                # Through the work queue: the flush must seal AFTER the
                # rows queued before it have admitted.
                self._work.put(self.batcher.flush)
            elif s == "STOP":
                self._admit(conn, block, marks)
                block, marks = [], []
                self._work.put(self.on_stop)
            else:
                if conn.trace_next is not None:
                    marks.append((len(block), *conn.trace_next))
                    conn.trace_next = None
                block.append(s)
        self._admit(conn, block, marks)

    def _admit(
        self, conn: _Connection, block: list[str], marks=None
    ) -> None:
        if not block:
            return
        if self.sampler:
            # Daemon-side head sampling of unstamped rows: fresh root
            # traces, one decision batch per ingress block. Rate 0 makes
            # the sampler falsy — this branch costs one bool check.
            # Decided on the loop thread so order matches arrival.
            stamped = {i for i, *_ in marks} if marks else set()
            fresh = [
                (i, *self.sampler.new_context())
                for i in self.sampler.sample_block(len(block))
                if i not in stamped
            ]
            if fresh:
                marks = sorted((marks or []) + fresh)
        # Tenant routing resolves NOW (the TENANT line that set it was
        # processed in order on this thread); the sanitize + push runs on
        # the admitter stage.
        admission = self.admission_for(conn.tenant)
        traces = marks or None

        def task() -> None:
            try:
                res = admission.admit_lines(block, traces=traces)
            except BaseException as e:
                # Same loud-death contract as the frame path.
                self.batcher.poison(e)
                self._send(conn, f"ERR {type(e).__name__}: {e}")
                raise
            self.frames_v1 += 1
            if self._c_frames is not None:
                self._c_frames.inc(version="v1")
            if res.get("error"):
                self._send(conn, "ERR " + res["error"])

        self._work.put(task)

    # -- replies / rejection -------------------------------------------------

    def _reject(self, conn: _Connection, exc: BaseException) -> "None":
        """Protocol violation on ``conn``: count it, answer ``ERR``, and
        raise :class:`_ProtocolReject` (the loop closes the connection)."""
        self._count_decode_error()
        self._send(conn, f"ERR {type(exc).__name__}: {exc}")
        raise _ProtocolReject from exc

    def _count_decode_error(self) -> None:
        self.decode_errors += 1
        if self._c_decode is not None:
            self._c_decode.inc()

    def _send(self, conn: _Connection, line: str) -> None:
        try:
            conn.sock.sendall((line + "\n").encode())
        except (BlockingIOError, InterruptedError, OSError):
            pass  # client already gone/stalled; the counters carry the evidence
