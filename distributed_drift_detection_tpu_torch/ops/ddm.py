"""DDM (Drift Detection Method, Gama et al. 2004) on tensors.

The port's twin of the JAX package's ``ops/ddm.py``:

* :func:`ddm_step` — the per-element recurrence (the executable spec);
* :func:`ddm_window_reference` — the speculative multi-batch statistic in
  plain PyTorch, batched over a leading ``[P]`` partition axis;
* :func:`ddm_window` — the same function; on a CUDA tensor it launches the
  hand-written kernel ``csrc/ddm_window.cu`` (K1), on a CPU tensor it runs
  the plain version.

Semantics (with sample index i, 1-based since the last reset):
``p_i = esum_i / i``, ``s_i = sqrt(p_i(1-p_i)/i)``; the min/warning/change
section runs when ``i + 1 >= min_num_instances``; ``(p+s)_min`` and its
``(p_min, s_min)`` payload update on ``<=`` (a later tie wins); change
when ``p+s > p_min + out_control_level·s_band``, warning (and not change)
when ``p+s > p_min + warning_level·s_band``, with
``s_band = max(s_min, noise_floor/out_control_level)`` when a noise floor
is set. The caller resets the detector on change.

Exactness against the JAX package: counts and error sums are integers held
in f32, so prefix sums in any order agree; XLA on the CPU computes each
threshold ``p_min + level·s_band`` as one fused multiply-add (measured), so
the plain version forms it in float64 — the product of two f32 values is
exact there, and for the shipped levels (0.5, 1.5) so is the sum, which
makes the rounding to f32 the FMA's single rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import DDMParams
from .. import kernels


class DDMState(NamedTuple):
    """Carried detector state; each leaf has the caller's batch shape."""

    count: torch.Tensor  # i32: elements absorbed since last reset
    err_sum: torch.Tensor  # f32: sum of error indicators since last reset
    ps_min: torch.Tensor  # f32: running min of p+s (inf until first update)
    p_min: torch.Tensor  # f32: p at the running min
    s_min: torch.Tensor  # f32: s at the running min


class DDMWindowResult(NamedTuple):
    """Per-batch detection summary over a window of W microbatches."""

    first_warning: torch.Tensor  # i32 [..., W]: index within batch, or −1
    first_change: torch.Tensor  # i32 [..., W]: index within batch, or −1


def ddm_init(shape=(), device="cpu") -> DDMState:
    """Fresh detector state of batch shape ``shape``."""
    inf = torch.full(shape, float("inf"), dtype=torch.float32, device=device)
    return DDMState(
        count=torch.zeros(shape, dtype=torch.int32, device=device),
        err_sum=torch.zeros(shape, dtype=torch.float32, device=device),
        ps_min=inf,
        p_min=inf.clone(),
        s_min=inf.clone(),
    )


def _f32(x: float) -> float:
    """``x`` rounded to float32 (the JAX package's weak-typed scalars)."""
    return float(np.float32(x))


def band_floor(params: DDMParams) -> float:
    """The f32 band floor ``noise_floor / out_control_level`` (0 when off)."""
    if float(params.noise_floor) == 0.0:
        return 0.0
    return float(np.float32(params.noise_floor) / np.float32(params.out_control_level))


def _band_s(s_min: torch.Tensor, params: DDMParams) -> torch.Tensor:
    """Effective band-width std: ``max(s_min, Δ/out_control_level)``;
    Δ = 0 (classic DDM) leaves ``s_min`` untouched."""
    if float(params.noise_floor) == 0.0:
        return s_min
    return torch.clamp_min(s_min, band_floor(params))


def _threshold(p_min: torch.Tensor, level: float, s_band: torch.Tensor):
    """``p_min + level·s_band`` rounded once, as XLA's fused multiply-add."""
    return (p_min.double() + _f32(level) * s_band.double()).float()


def _stats(cnt: torch.Tensor, esum: torch.Tensor):
    cnt_f = cnt.clamp_min(1).float()
    p = esum / cnt_f
    s = torch.sqrt(torch.clamp_min(p * (1.0 - p), 0.0) / cnt_f)
    return p, s, p + s


def ddm_step(state: DDMState, err: torch.Tensor, params: DDMParams = DDMParams()):
    """One ``add_element``: ``(new_state, (warning, change))``."""
    cnt = state.count + 1
    esum = state.err_sum + err
    p, s, ps = _stats(cnt, esum)
    check = (cnt + 1) >= params.min_num_instances
    take = check & (ps <= state.ps_min)
    ps_min = torch.where(take, ps, state.ps_min)
    p_min = torch.where(take, p, state.p_min)
    s_min = torch.where(take, s, state.s_min)
    s_band = _band_s(s_min, params)
    change = check & (ps > _threshold(p_min, params.out_control_level, s_band))
    warning = (
        check & ~change
        & (ps > _threshold(p_min, params.warning_level, s_band))
    )
    return DDMState(cnt, esum, ps_min, p_min, s_min), (warning, change)


def _run_min(ps_masked, p, s):
    """Running (min of ps, payload p, payload s) along the last axis, later
    elements winning ties — the position of the latest element equal to
    the running minimum, taken as a running max of marked positions (so
    the result does not depend on ``cummin``'s own tie rule)."""
    run_ps = torch.cummin(ps_masked, -1).values
    pos = torch.arange(ps_masked.shape[-1], device=ps_masked.device)
    marked = torch.where(ps_masked == run_ps, pos, torch.full_like(pos, -1))
    last = torch.cummax(marked, -1).values
    return run_ps, torch.gather(p, -1, last), torch.gather(s, -1, last)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, −1 when none (i32)."""
    b = mask.shape[-1]
    pos = torch.arange(b, device=mask.device)
    first = torch.where(mask, pos, torch.full_like(pos, b)).amin(-1)
    return torch.where(first < b, first, torch.full_like(first, -1)).int()


def summarise_window(warning: torch.Tensor, change: torch.Tensor) -> DDMWindowResult:
    """``[..., W, B]`` masks → per-batch ``[..., W]`` first indices; a
    warning counts only at or before its batch's first change."""
    b = change.shape[-1]
    first_change = _first_true(change)
    limit = torch.where(first_change >= 0, first_change, torch.full_like(first_change, b))
    pos = torch.arange(b, device=warning.device)
    first_warning = _first_true(warning & (pos <= limit[..., None]))
    return DDMWindowResult(first_warning, first_change)


def ddm_window_reference(
    state: DDMState,
    errs: torch.Tensor,
    valid: torch.Tensor,
    params: DDMParams = DDMParams(),
) -> tuple[DDMState, DDMWindowResult]:
    """Plain PyTorch version of :func:`ddm_window`.

    ``state`` leaves are ``[P]``; ``errs`` ``[P, W, B]`` f32 in {0, 1};
    ``valid`` ``[P, W, B]`` bool. The detector state flows across the W
    batches with no reset in between; returns the state after the whole
    window and ``[P, W]`` first-warning/first-change indices.
    """
    p_, w, b = errs.shape
    e = errs.reshape(p_, w * b)
    v = valid.reshape(p_, w * b).bool()
    cnt = state.count[:, None] + torch.cumsum(v.int(), 1, dtype=torch.int32)
    esum = state.err_sum[:, None] + torch.cumsum(e * v.float(), 1)
    p, s, ps = _stats(cnt, esum)
    check = v & ((cnt + 1) >= params.min_num_instances)
    ps_masked = torch.where(check, ps, torch.full_like(ps, float("inf")))
    run_ps, run_p, run_s = _run_min(ps_masked, p, s)
    # The carried minima precede every window element (same `<=` rule).
    use_run = run_ps <= state.ps_min[:, None]
    ps_min = torch.where(use_run, run_ps, state.ps_min[:, None])
    p_min = torch.where(use_run, run_p, state.p_min[:, None])
    s_min = torch.where(use_run, run_s, state.s_min[:, None])
    s_band = _band_s(s_min, params)
    change = check & (ps > _threshold(p_min, params.out_control_level, s_band))
    warning = (
        check & ~change
        & (ps > _threshold(p_min, params.warning_level, s_band))
    )
    end = DDMState(
        *(x[:, -1].contiguous() for x in (cnt, esum, ps_min, p_min, s_min))
    )
    return end, summarise_window(warning.view(p_, w, b), change.view(p_, w, b))


def _check_cuda(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"ddm_window: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"ddm_window: {name} must be contiguous")


def ddm_window(
    state: DDMState,
    errs: torch.Tensor,
    valid: torch.Tensor,
    params: DDMParams = DDMParams(),
) -> tuple[DDMState, DDMWindowResult]:
    """The DDM window statistic (contract of :func:`ddm_window_reference`).

    CUDA tensors launch kernel K1 (``csrc/ddm_window.cu``) and add one to
    ``ddm_window.launches``; CPU tensors run the plain version. ``valid``
    may be bool or uint8.
    """
    if errs.device.type == "cpu":
        return ddm_window_reference(state, errs, valid, params)
    if errs.device.type != "cuda":
        raise ValueError(f"ddm_window: unsupported device {errs.device}")
    dev = errs.device
    p, w, b = errs.shape
    _check_cuda("errs", errs, torch.float32, (p, w, b), dev)
    if valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"ddm_window: valid must be bool or uint8, got {valid.dtype}")
    _check_cuda("valid", valid, valid.dtype, (p, w, b), dev)
    for name, leaf in state._asdict().items():
        dt = torch.int32 if name == "count" else torch.float32
        _check_cuda(f"state.{name}", leaf, dt, (p,), dev)
    fw = torch.empty((p, w), dtype=torch.int32, device=dev)
    fc = torch.empty((p, w), dtype=torch.int32, device=dev)
    end = DDMState(*(torch.empty_like(leaf) for leaf in state))
    floor = band_floor(params)
    code = kernels.launcher("ddm_window")(
        errs.data_ptr(), valid.data_ptr(),
        *(leaf.data_ptr() for leaf in state),
        p, w * b, w, b, int(params.min_num_instances),
        _f32(params.warning_level), _f32(params.out_control_level),
        floor, int(floor != 0.0),
        fw.data_ptr(), fc.data_ptr(), *(leaf.data_ptr() for leaf in end),
        kernels.stream_handle(dev),
    )
    kernels.check("ddm_window", code)
    ddm_window.launches += 1
    return end, DDMWindowResult(fw, fc)


ddm_window.launches = 0
