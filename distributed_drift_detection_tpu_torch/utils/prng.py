"""Counter-based host PRNG utilities.

``row_uniforms`` yields uniforms that depend only on (seed, stream_id, row
index) — chunking-invariant by construction (counter-based Philox advanced to
the absolute row), which is what lets generators and per-batch shuffles
produce identical results regardless of how the stream is chunked.
"""

from __future__ import annotations

import numpy as np


def row_uniforms(
    seed: int, start: int, n: int, per_row: int, stream_id: int
) -> np.ndarray:
    """``[n, per_row]`` f64 uniforms for absolute rows [start, start+n)."""
    width = -4 * (-per_row // 4)  # one Philox advance unit = one 4x64-bit
    bitgen = np.random.Philox(key=np.uint64(seed) ^ (np.uint64(stream_id) << 32))
    bitgen.advance(int(start) * (width // 4))  # block = 4 f64 draws
    return np.random.Generator(bitgen).random((n, width))[:, :per_row]
