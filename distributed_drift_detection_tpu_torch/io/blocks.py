"""Line-aligned byte-range planning for parallel CSV ingest (the port's
own copy of the JAX package's ``io/blocks.py``).

The host data plane consumes CSV files in bounded blocks. Parallel
ingest needs the boundaries *planned up front* so N workers can parse
disjoint, line-aligned ranges of one ``mmap`` concurrently while the
consumer reassembles results in submission order (row order is then
preserved exactly).

This module is the one boundary rule shared by every consumer — the
parallel contract scan (``io.sanitize.scan_csv``) and, when streaming
ingest is ported (ROADMAP A10b), the chunk feeder — so two paths can
never disagree about which bytes form a block. Pure stdlib.
"""

from __future__ import annotations

import mmap


def line_block_ranges(
    buf, start: int, block_bytes: int
) -> list[tuple[int, int]]:
    """Split ``buf[start:]`` into contiguous ``(lo, hi)`` byte ranges of
    ~``block_bytes`` each, every boundary landing just after a ``\\n``.

    Invariants (the parallel-parse determinism contract):

    * ranges are contiguous and disjoint: ``ranges[i][1] == ranges[i+1][0]``,
      covering ``start..len(buf)`` exactly;
    * every ``hi`` except possibly the last sits one past a newline, so a
      block always holds complete lines (the last block may lack a trailing
      newline — parsers handle the final partial line);
    * a single line longer than ``block_bytes`` extends its block to the
      line's end (the serial reader's carry semantics, planned ahead).

    ``buf`` is anything sliceable with ``find``/``rfind`` (an ``mmap``, a
    ``bytes``); the planner touches only bytes near each boundary, so
    planning a multi-GB file costs a handful of page faults per block.
    """
    if block_bytes <= 0:
        raise ValueError(f"block_bytes must be > 0, got {block_bytes}")
    n = len(buf)
    ranges: list[tuple[int, int]] = []
    lo = start
    while lo < n:
        hi = min(lo + block_bytes, n)
        if hi < n:
            nl = buf.rfind(b"\n", lo, hi)
            if nl < 0:
                # No newline inside the window: one over-long line —
                # extend to its terminating newline (or EOF).
                nl = buf.find(b"\n", hi)
                hi = n if nl < 0 else nl + 1
            else:
                hi = nl + 1
        ranges.append((lo, hi))
        lo = hi
    return ranges


def open_mapped(path: str) -> "tuple[object, mmap.mmap | bytes, int]":
    """Open ``path`` for block-range ingest: ``(file handle, buffer,
    data_start)`` where ``buffer`` is a read-only ``mmap`` of the whole
    file (falling back to an in-memory read where mmap is unavailable —
    e.g. an empty or special file) and ``data_start`` is the offset of
    the first data row (just past the header line). The caller owns both
    the handle and the buffer (``close()`` each; ``bytes`` fallback has a
    no-op close via duck typing at the call sites)."""
    fh = open(path, "rb")
    header_line = fh.readline()
    data_start = len(header_line)
    try:
        buf: "mmap.mmap | bytes" = mmap.mmap(
            fh.fileno(), 0, access=mmap.ACCESS_READ
        )
    except (ValueError, OSError):
        fh.seek(0)
        buf = fh.read()
    return fh, buf, data_start
