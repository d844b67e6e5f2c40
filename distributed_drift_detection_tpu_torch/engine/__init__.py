"""The engines and their containers: the window engine, the ``window=1``
loop and the device-generated soak."""

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
    "SoakChainState",
    "SoakLegFlags",
    "SoakResult",
    "make_soak_chain",
    "make_soak_runner",
    "run_soak_chained",
]
