"""Always-on online drift serving on the card — the port's own copy of the
JAX package's ``serve`` package, on the port's engines.

* :mod:`.ingress` — one readiness-based event loop multiplexing every
  connection; v1 text lines (CSV/JSON rows, ``FLUSH``/``STOP`` controls)
  and v2 binary columnar frames auto-detected per message;
* :mod:`.wire` — the v2 frame codec (length-prefixed binary columnar
  frames: the wire twin of the ``[P, CB, B]`` grid), byte for byte the
  JAX package's;
* :mod:`.admission` — sanitize-at-admission (the
  ``strict|quarantine|repair`` contract on live traffic) + the
  fixed-geometry :class:`~.admission.MicroBatcher` with a max-linger
  deadline — short batches pad through the validity plane, so shapes
  stay static;
* :mod:`.runner` — the serving loop over a prepared
  :class:`~..engine.chunked.ChunkedDetector` on the card, verdict
  sidecar + schema-v1 telemetry, checkpointed state, graceful SIGTERM
  drain;
* :mod:`.loadgen` — stream replay at a target rows/s with seeded dirty
  injection and the p50/p99 row→verdict latency SLO report, to one daemon
  or, with global tenant ids, through a router;
* :mod:`.router` — the tenant router: consistent-hash placement of
  global tenants across N daemons, tenant-routing rewrites of v1 lines and
  v2 frames, live migration and failover on the daemons'
  ``SAVETENANT``/``LOADTENANT`` surface (torch-free).

Lazy exports (PEP 562): importing the package pulls no torch — the CLIs
decide what they need.
"""

from __future__ import annotations

_EXPORTS = {
    "AdmissionController": ".admission",
    "MicroBatcher": ".admission",
    "TenantMicroBatcher": ".admission",
    "SealedChunk": ".admission",
    "IngressServer": ".ingress",
    "ServeRunner": ".runner",
    "find_verdicts": ".runner",
    "read_verdicts": ".runner",
    "run_loadgen": ".loadgen",
    # fleet layer (tenant router over N daemons)
    "TenantRouter": ".router",
    "BackendSpec": ".router",
    "HashRing": ".router",
    "plan_fleet": ".router",
    # wire protocol v2 (binary columnar frames)
    "WireError": ".wire",
    "encode_frame": ".wire",
    "decode_frame": ".wire",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(_EXPORTS[name], __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
