"""Carry weights and state across from the JAX package.

The JAX package's pytrees — model parameters, every detector's state, the
loop carry — become the port's tensors. The inputs are the JAX NamedTuples (or
anything with the same field names) whose leaves convert with
``np.asarray``; nothing of JAX is imported here. A single partition's
pytree (no leading axis) gains a leading ``[1]`` partition axis; a vmapped
one (leading ``[P]``) keeps it.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine.loop import LoopCarry
from .models.classifiers import CentroidParams, GNBParams, LinearParams
from .models.forest import ForestParams
from .models.mlp import MLPLayer
from .models.rf import RFParams
from .ops import detectors
from .ops.adwin import ADWINState
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


def _params(cls, params, device, batched_ndim: dict):
    """A NamedTuple of f32 leaves; batched when the leaf named first in
    ``batched_ndim`` has that many dimensions."""
    name, nd = next(iter(batched_ndim.items()))
    batched = np.ndim(getattr(params, name)) == nd
    return cls(*(_tensor(getattr(params, f), np.float32, device, batched)
                 for f in cls._fields))


def gnb_params(params, device="cpu") -> GNBParams:
    """JAX ``GNBParams`` (``offset [F]`` or ``[P, F]``, …)."""
    return _params(GNBParams, params, device, {"offset": 2})


def linear_params(params, device="cpu") -> LinearParams:
    """JAX ``LinearParams`` (``w [F, C]`` or ``[P, F, C]``, ``b``)."""
    return _params(LinearParams, params, device, {"w": 3})


def mlp_params(params, device="cpu") -> tuple:
    """The JAX ``MLPLayer`` tuple (``w [din, dout]`` or ``[P, din, dout]``,
    ``b``) as the port's tuple of :class:`~.models.mlp.MLPLayer`."""
    return tuple(_params(MLPLayer, layer, device, {"w": 3}) for layer in params)


def forest_params(params, device="cpu") -> ForestParams:
    """JAX ``ForestParams(proj [F, T·n], thresh [T·n], leaf_class [T, 2^d])``,
    or vmapped with a leading ``[P]``."""
    batched = np.ndim(params.thresh) == 2
    return ForestParams(
        _tensor(params.proj, np.float32, device, batched),
        _tensor(params.thresh, np.float32, device, batched),
        _tensor(params.leaf_class, np.int32, device, batched),
    )


def rf_params(params, device="cpu") -> RFParams:
    """JAX ``RFParams(X [B, F], y [B], w [B], seed [])`` (numpy leaves),
    or vmapped with a leading ``[P]``: the training snapshot and its seed."""
    batched = np.ndim(params.seed) == 1
    return RFParams(
        _tensor(params.X, np.float32, device, batched),
        _tensor(params.y, np.int32, device, batched),
        _tensor(params.w, np.float32, device, batched),
        _tensor(params.seed, np.int32, device, batched),
    )


# Each detector's state class, and the leaves held in int32 (the rest f32).
_STATES = {
    "ddm": (DDMState, {"count"}),
    "ph": (detectors.PHState, {"count"}),
    "eddm": (detectors.EDDMState, {"count", "num_errors", "last_err_t"}),
    "hddm": (detectors.HDDMState, {"count", "n_min"}),
    "hddm_w": (detectors.HDDMWState, {"count", "n2"}),
    "kswin": (detectors.KSWINState, {"t"}),
    "stepd": (detectors.STEPDState, {"t"}),
    "adwin": (ADWINState, set(ADWINState._fields)),
}


def detector_state(name: str, state, device="cpu"):
    """The JAX state of detector ``name`` (``RunConfig.detector``) with
    scalar leaves (one partition) or a leading ``[P]``; the ring-buffer
    and histogram leaves keep their trailing axes."""
    cls, ints = _STATES[name]
    batched = np.ndim(getattr(state, cls._fields[0])) == 1
    return cls(*(
        _tensor(getattr(state, f), np.int32 if f in ints else np.float32, device, batched)
        for f in cls._fields
    ))


def ddm_state(state, device="cpu") -> DDMState:
    """JAX ``DDMState`` (scalar leaves, or ``[P]``)."""
    return detector_state("ddm", state, device)


_MODEL_PARAMS = {
    "centroid": centroid_params, "majority": majority_params,
    "gnb": gnb_params, "linear": linear_params, "mlp": mlp_params,
    "forest": forest_params, "rf": rf_params,
}


def loop_carry(carry, model: str, device="cpu", detector: str = "ddm",
               keep_key: bool = False) -> LoopCarry:
    """JAX ``LoopCarry`` of a run with ``model`` and ``detector``. For the
    keyed ``mlp``, ``forest`` and ``rf`` — and for any model with
    ``keep_key``, as the chunked engine and ``shuffle=True`` carry it — its
    ``key`` is carried as key data (pass ``carry._replace(
    key=jax.random.key_data(carry.key))``) and kept as uint32 numpy ``[P,
    2]`` on the host; otherwise it is dropped (the fit consumes none)."""
    batched = np.ndim(carry.retrain) == 1
    if model not in _MODEL_PARAMS:
        raise NotImplementedError(f"model {model!r} is not ported yet")
    key = None
    if keep_key or model in ("mlp", "forest", "rf"):
        key = np.array(carry.key, dtype=np.uint32).reshape(-1, 2)
    return LoopCarry(
        params=_MODEL_PARAMS[model](carry.params, device),
        ddm=detector_state(detector, carry.ddm, device),
        a_X=_tensor(carry.a_X, np.float32, device, batched),
        a_y=_tensor(carry.a_y, np.int32, device, batched),
        a_w=_tensor(carry.a_w, np.float32, device, batched),
        retrain=_tensor(carry.retrain, np.bool_, device, batched),
        key=key,
    )


def soak_chain_state(state, model: str, device="cpu", detector: str = "ddm"):
    """JAX ``SoakChainState(carry, gen_keys)`` of a chained soak with
    ``model`` and ``detector``, its keys as key data — pass
    ``state._replace(carry=state.carry._replace(key=jax.random.key_data(
    state.carry.key)), gen_keys=jax.random.key_data(state.gen_keys))`` —
    as the port's, so a chain the JAX package started continues in the port
    (``engine.soak.make_soak_chain``'s ``next_leg``). The generator keys
    stay uint32 numpy ``[P, 2]`` on the host."""
    from .engine.soak import SoakChainState

    return SoakChainState(
        loop_carry(state.carry, model, device, detector),
        np.array(state.gen_keys, dtype=np.uint32).reshape(-1, 2),
    )
