"""Carry weights and state across from the JAX package.

The JAX package's pytrees — model parameters, the DDM state, the loop
carry — become the port's tensors. The inputs are the JAX NamedTuples (or
anything with the same field names) whose leaves convert with
``np.asarray``; nothing of JAX is imported here. A single partition's
pytree (no leading axis) gains a leading ``[1]`` partition axis; a vmapped
one (leading ``[P]``) keeps it.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine.loop import LoopCarry
from .models.classifiers import CentroidParams
from .ops.ddm import DDMState


def _tensor(x, dtype: np.dtype, device, batched: bool) -> torch.Tensor:
    a = np.array(x, dtype=dtype)  # a writable copy, whatever held it
    return torch.from_numpy(a if batched else a[None]).to(device)


def centroid_params(params, device="cpu") -> CentroidParams:
    """JAX ``CentroidParams(centroids [C, F] or [P, C, F], bias)``."""
    batched = np.ndim(params.centroids) == 3
    return CentroidParams(
        _tensor(params.centroids, np.float32, device, batched),
        _tensor(params.bias, np.float32, device, batched),
    )


def majority_params(params, device="cpu") -> torch.Tensor:
    """The JAX majority model's class (scalar, or ``[P]``)."""
    return _tensor(params, np.int32, device, np.ndim(params) == 1)


def ddm_state(state, device="cpu") -> DDMState:
    """JAX ``DDMState`` (scalar leaves, or ``[P]``)."""
    batched = np.ndim(state.count) == 1
    return DDMState(
        _tensor(state.count, np.int32, device, batched),
        *(
            _tensor(getattr(state, f), np.float32, device, batched)
            for f in ("err_sum", "ps_min", "p_min", "s_min")
        ),
    )


def loop_carry(carry, model: str, device="cpu") -> LoopCarry:
    """JAX ``LoopCarry`` of a ``'majority'`` or ``'centroid'`` run; its
    PRNG ``key`` is dropped (the ported fits consume none)."""
    batched = np.ndim(carry.retrain) == 1
    if model == "centroid":
        params = centroid_params(carry.params, device)
    elif model == "majority":
        params = majority_params(carry.params, device)
    else:
        raise NotImplementedError(f"model {model!r} is not ported yet")
    return LoopCarry(
        params=params,
        ddm=ddm_state(carry.ddm, device),
        a_X=_tensor(carry.a_X, np.float32, device, batched),
        a_y=_tensor(carry.a_y, np.int32, device, batched),
        a_w=_tensor(carry.a_w, np.float32, device, batched),
        retrain=_tensor(carry.retrain, np.bool_, device, batched),
    )
