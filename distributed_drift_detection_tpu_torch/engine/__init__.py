"""The engines and their containers: the window engine, the ``window=1``
loop, the chunked streaming engine and the device-generated soak."""

from .chunked import ChunkedDetector
from .soak import (
    ChainedSoakSummary,
    SoakChainState,
    SoakLegFlags,
    SoakResult,
    make_soak_chain,
    make_soak_runner,
    run_soak_chained,
)

__all__ = [
    "ChainedSoakSummary",
    "ChunkedDetector",
    "SoakChainState",
    "SoakLegFlags",
    "SoakResult",
    "make_soak_chain",
    "make_soak_runner",
    "run_soak_chained",
]
