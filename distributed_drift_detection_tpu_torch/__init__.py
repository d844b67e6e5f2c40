"""PyTorch/CUDA port of ``distributed_drift_detection_tpu``.

The same DDM train/predict/detect/retrain microbatch loop over row-striped
stream partitions, run with PyTorch on one NVIDIA H100. The JAX package
beside it is the reference: both take the same :class:`RunConfig` and give
the same flags (``tests/test_torch_*.py``). The two device hot ops of the
main path — the DDM window statistic and the centroid predict fused with
the error indicator — are CUDA C++ kernels (``csrc/``); everything else is
plain PyTorch.

This package imports nothing of JAX and nothing of the JAX package.
"""

from .config import DDMParams, RunConfig, replace

__version__ = "0.1.0"


def run(cfg, stream=None, device="cuda"):
    """Execute one drift-detection run (lazy import keeps
    ``import distributed_drift_detection_tpu_torch`` light)."""
    from .api import run as _run

    return _run(cfg, stream, device=device)


def run_multi(cfg, streams=None, device="cuda"):
    """Execute a stacked multi-tenant run: T tenants' streams through one
    runner (lazy import, as :func:`run`; ``api.run_multi``)."""
    from .api import run_multi as _run_multi

    return _run_multi(cfg, streams, device=device)


__all__ = ["DDMParams", "RunConfig", "replace", "run", "run_multi", "__version__"]
