"""Wire protocol v2: length-prefixed binary columnar frames.

The port's own copy of the JAX package's ``serve/wire.py``: the same rows
encode to the same bytes in both packages, so their clients and daemons
interoperate.

The v1 serve protocol ships one CSV/JSON text row per line — admission
parses text row by row, orders of magnitude behind the device. A v2
**frame** is the wire twin of one span of the ``[P, CB, B]`` grid: a
fixed 16-byte header followed by a columnar payload — the whole feature
block as one contiguous little-endian f32 matrix, then the label vector
as i32 — so the daemon admits thousands of rows with a handful of
vectorized numpy calls and **zero text parsing**.

Frame layout (all little-endian)::

    offset  size  field
    ------  ----  -----------------------------------------------------
         0     2  magic     0xDDF2  (first wire byte 0xF2 — non-ASCII,
                            so a byte at a message boundary tells v2
                            frames from v1 text lines unambiguously)
         2     1  version   2
         3     1  flags     0 = data frame; FLAG_FLUSH / FLAG_STOP mark
                            a zero-row CONTROL frame (the binary twins
                            of the FLUSH / STOP text lines)
         4     4  tenant    u32 tenant slot (0 on solo daemons)
         8     4  rows      u32 row count  (>= 1 for data frames)
        12     4  features  u32 feature count (must equal the daemon's
                            --features; label is NOT counted)
        16     …  payload   rows*features f32 feature block (row-major)
                            followed by rows i32 labels

Auto-detection: v1 data rows start with an ASCII digit/sign/``{``/``[``
and v1 controls with an ASCII letter, so the first byte of any v1
message is < 0x80. The magic's first wire byte (0xF2) can therefore
never open a text message — the ingress checks one byte at each message
boundary and routes to the right decoder; one connection may freely mix
text lines and frames.

The decoder validates structure without copying payload bytes:
:func:`decode_header` reads the fixed header from a ``memoryview`` and
bounds-checks the declared geometry (an oversized ``rows``/``features``
is a :class:`WireError` *before* any allocation happens — a malicious
or corrupt header must not OOM the daemon), and :func:`payload_views`
wraps the payload buffer with ``np.frombuffer`` — the returned arrays
alias the buffer, no copy. Everything here is jax-free stdlib + numpy.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

#: u16 little-endian — first byte on the wire is 0xF2 (non-ASCII).
MAGIC = 0xDDF2
MAGIC_BYTE = MAGIC & 0xFF  # 0xF2, the one-byte protocol discriminator
VERSION = 2

_HEADER = struct.Struct("<HBBIII")
HEADER_SIZE = _HEADER.size  # 16

#: Control-frame flags (zero-row frames; the binary FLUSH/STOP twins).
FLAG_FLUSH = 0x01
FLAG_STOP = 0x02
_KNOWN_FLAGS = FLAG_FLUSH | FLAG_STOP

#: Decoder bounds: a header declaring more than this is malformed, not
#: merely large — the daemon must refuse it before allocating anything.
#: (``max_rows`` is overridable per daemon via ServeParams.max_frame_rows.)
MAX_FRAME_ROWS = 1 << 20
MAX_FRAME_FEATURES = 1 << 16


class WireError(ValueError):
    """A structurally invalid v2 frame (bad magic/version, out-of-bounds
    geometry, zero-row data frame, unknown flags). Connection-local: the
    ingress answers ``ERR`` and drops that connection, never the daemon."""


class FrameHeader(NamedTuple):
    """The decoded fixed header of one v2 frame."""

    version: int
    flags: int
    tenant: int
    rows: int
    features: int

    @property
    def is_control(self) -> bool:
        return self.rows == 0 and self.flags != 0

    @property
    def payload_nbytes(self) -> int:
        return self.rows * self.features * 4 + self.rows * 4

    @property
    def frame_nbytes(self) -> int:
        return HEADER_SIZE + self.payload_nbytes


def decode_header(
    buf, *, max_rows: int = MAX_FRAME_ROWS, max_features: int = MAX_FRAME_FEATURES
) -> FrameHeader:
    """Decode + validate the 16-byte header at the start of ``buf``.

    ``buf`` is any buffer-protocol object holding at least
    :data:`HEADER_SIZE` bytes; nothing is copied. Raises
    :class:`WireError` on any structural violation.
    """
    magic, version, flags, tenant, rows, features = _HEADER.unpack_from(buf)
    if magic != MAGIC:
        raise WireError(f"bad frame magic 0x{magic:04X} (expected 0x{MAGIC:04X})")
    if version != VERSION:
        raise WireError(f"unsupported wire version {version} (expected {VERSION})")
    if flags & ~_KNOWN_FLAGS:
        raise WireError(f"unknown frame flags 0x{flags:02X}")
    if flags:
        # Control frame: geometry must be zero — a flagged frame that
        # also declares rows is ambiguous, and ambiguity on an untrusted
        # wire is an error, not a guess.
        if rows or features:
            raise WireError(
                f"control frame (flags 0x{flags:02X}) declares geometry "
                f"rows={rows} features={features}; control frames are empty"
            )
        return FrameHeader(version, flags, tenant, rows, features)
    if rows == 0:
        raise WireError("zero-row data frame (empty frames carry control flags)")
    if rows > max_rows:
        raise WireError(f"frame declares {rows} rows (max {max_rows})")
    if features == 0:
        raise WireError("data frame declares zero features")
    if features > max_features:
        raise WireError(
            f"frame declares {features} features (max {max_features})"
        )
    return FrameHeader(version, flags, tenant, rows, features)


def payload_views(
    header: FrameHeader, payload
) -> "tuple[np.ndarray, np.ndarray]":
    """``(X [rows, features] f32, y [rows] i32)`` views over ``payload``.

    Zero-copy: the arrays alias the buffer (``np.frombuffer``). The
    caller owns the buffer's lifetime — the ingress hands each frame its
    own buffer, filled straight from the socket, so the views stay valid
    for as long as the admitted rows do.
    """
    n, f = header.rows, header.features
    if len(payload) != header.payload_nbytes:
        raise WireError(
            f"payload holds {len(payload)} byte(s); header declares "
            f"{header.payload_nbytes}"
        )
    X = np.frombuffer(payload, dtype="<f4", count=n * f).reshape(n, f)
    y = np.frombuffer(payload, dtype="<i4", count=n, offset=n * f * 4)
    return X, y


def decode_frame(
    buf, *, max_rows: int = MAX_FRAME_ROWS, max_features: int = MAX_FRAME_FEATURES
):
    """Decode one frame from the head of ``buf``.

    Returns ``(header, X, y, consumed_bytes)`` for a complete data frame
    (``X``/``y`` are zero-copy views into ``buf``), ``(header, None,
    None, consumed)`` for a control frame, or ``None`` when ``buf``
    holds a valid but incomplete prefix (wait for more bytes). Raises
    :class:`WireError` on malformed input. The streaming ingress keeps
    its own incremental state machine; this whole-buffer form is the
    reference decoder the tests and fuzzers drive.
    """
    mv = memoryview(buf)
    if len(mv) == 0:
        return None
    if mv[0] != MAGIC_BYTE:
        raise WireError(
            f"bad frame magic: first byte 0x{mv[0]:02X} (expected "
            f"0x{MAGIC_BYTE:02X})"
        )
    if len(mv) < HEADER_SIZE:
        # Partial header: everything present so far must still look like
        # a frame (second magic byte, version), else fail now.
        if len(mv) >= 2 and mv[1] != (MAGIC >> 8):
            raise WireError("bad frame magic (second byte)")
        if len(mv) >= 3 and mv[2] != VERSION:
            raise WireError(f"unsupported wire version {mv[2]}")
        return None
    header = decode_header(mv, max_rows=max_rows, max_features=max_features)
    total = header.frame_nbytes
    if len(mv) < total:
        return None
    if header.is_control:
        return header, None, None, HEADER_SIZE
    X, y = payload_views(header, mv[HEADER_SIZE:total])
    return header, X, y, total


def encode_frame(X, y, *, tenant: int = 0, flags: int = 0) -> bytes:
    """Encode one data frame (client side — ``loadgen --wire v2``).

    ``X`` is ``[rows, features]`` (cast to f32), ``y`` ``[rows]`` (cast
    to i32); rows must be >= 1.
    """
    X = np.ascontiguousarray(X, "<f4")
    y = np.ascontiguousarray(y, "<i4")
    if X.ndim != 2 or y.ndim != 1 or len(X) != len(y):
        raise ValueError(
            f"frame wants X [rows, features] and y [rows]; got "
            f"{X.shape} / {y.shape}"
        )
    if len(y) == 0:
        raise ValueError("cannot encode a zero-row data frame")
    header = _HEADER.pack(
        MAGIC, VERSION, flags, tenant, X.shape[0], X.shape[1]
    )
    return header + X.tobytes() + y.tobytes()


def encode_control(flags: int, *, tenant: int = 0) -> bytes:
    """Encode a control frame (``FLAG_FLUSH`` / ``FLAG_STOP``)."""
    if not flags or flags & ~_KNOWN_FLAGS:
        raise ValueError(f"control flags must be FLUSH/STOP, got 0x{flags:02X}")
    return _HEADER.pack(MAGIC, VERSION, flags, tenant, 0, 0)


def encode_flush() -> bytes:
    """The binary twin of the ``FLUSH`` text line."""
    return encode_control(FLAG_FLUSH)


def encode_stop() -> bytes:
    """The binary twin of the ``STOP`` text line."""
    return encode_control(FLAG_STOP)
