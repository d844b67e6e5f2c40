"""Detector zoo: every drift detector behind one kernel interface.

The port's twin of the JAX package's ``ops/detectors.py`` (and, through
:func:`make_detector`, of ``ops/adwin.py``): DDM, Page–Hinkley, EDDM,
HDDM-A, HDDM-W, KSWIN, STEPD and ADWIN, each as

* ``*_init(shape, device)`` — a fresh state whose leaves have the batch
  shape (``[P]``; the ring-buffer members take their params first and add
  their buffer axes);
* ``*_step`` — one element per partition, the executable spec;
* ``_*_masks(state, errs [P, N], valid [P, N])`` — the flattened prefix
  pass, ``(end_state, warning [P, N], change [P, N])``;
* ``*_window`` over ``[P, W, B]`` and ``*_batch`` over ``[P, B]``
  (:func:`.ddm.batch_from_window`).

The statistics, the state-reset protocol (the caller resets on change;
the end state is meaningful only when ``first_change == -1``) and the
parameter validation are the JAX package's; see its module docstring for
the mathematics. The float32 arithmetic is held bit for bit against it
(:mod:`.prefix`: the same scan tree, fused multiply-adds and constant
divisions as XLA on the CPU).

Every member has a hand-written CUDA kernel for its window statistic
(K5-ph ``csrc/ph_window.cu``, K5-eddm ``csrc/eddm_window.cu``, K5-hddm
``csrc/hddm_window.cu``, K5-hddm_w ``csrc/hddm_w_window.cu``, K5-kswin
``csrc/kswin_window.cu``, K5-stepd ``csrc/stepd_window.cu``; ADWIN's,
K5-adwin, is in :mod:`.adwin`): on a CUDA tensor each ``*_window`` launches
its kernel (K5-ph, K5-hddm_w, K5-eddm, K5-hddm, K5-kswin and K5-stepd as a
thread-block cluster per partition where the row fits, :func:`cluster_ctas`
and, for the ring members, :func:`ring_ctas`; K5-adwin one CTA a
partition), on a CPU tensor it runs its plain version,
``*_window_reference``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple

import torch

from .. import kernels
from ..config import (
    ADWINParams,
    DDMParams,
    DETECTOR_NAMES,
    EDDMParams,
    HDDMParams,
    HDDMWParams,
    KSWINParams,
    PHParams,
    STEPDParams,
)
from .ddm import (
    DDMWindowResult,
    _run_min,
    _sm_count,
    batch_from_window,
    check_window_inputs,
    cluster_size,
    ddm_init,
    ddm_window,
    launch_window,
    summarise_window,
)
from .prefix import _SCAN_BASE, associative_scan, cumsum_f32, div_const, f32, fma, ftz, rdiv, sqrt

_INF = float("inf")
# Finite stand-in for "no clamp" in the Page–Hinkley compose (the JAX
# package's _NO_CLAMP): a true -inf would give 0·(-inf) = NaN after an
# identity element when alpha = 0.
_NO_CLAMP = f32(-1e30)


class DetectorKernel(NamedTuple):
    """A drift detector with its parameters bound.

    ``init(shape, device)`` gives a fresh state; ``window(state, errs [P,
    W, B], valid [P, W, B])`` the state after the window and ``[P, W]``
    first-warning/first-change indices, state flowing across batch
    boundaries (:func:`.ddm.ddm_window`'s contract); ``batch(state, errs
    [P, B], valid [P, B])`` the same for one batch, ``[P]`` results.
    """

    name: str
    init: Callable[..., object]
    batch: Callable[..., tuple]
    window: Callable[..., tuple]
    params: object


def _window(masks, state, errs, valid):
    """A ``_*_masks`` pass over ``[P, W, B]`` planes, summarised per batch."""
    p, w, b = errs.shape
    end, warning, change = masks(state, errs.reshape(p, w * b), valid.reshape(p, w * b).bool())
    end = type(end)(*(leaf.contiguous() for leaf in end))
    return end, summarise_window(warning.view(p, w, b), change.view(p, w, b))


# --------------------------------------------------------------------------
# Page–Hinkley
# --------------------------------------------------------------------------


class PHState(NamedTuple):
    count: torch.Tensor  # i32: elements absorbed since last reset
    x_sum: torch.Tensor  # f32: sum of inputs since last reset
    m: torch.Tensor  # f32: clamped cumulative statistic


def ph_init(shape=(), device="cpu") -> PHState:
    return PHState(
        torch.zeros(shape, dtype=torch.int32, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device),
    )


def _validate_ph(params: PHParams) -> None:
    """The compose assumes ``alpha`` in [0, 1]; ``threshold = 0`` is the
    unresolved auto sentinel (``config.auto_ph_threshold``)."""
    if not 0.0 <= float(params.alpha) <= 1.0:
        raise ValueError(f"PHParams.alpha must be in [0, 1], got {params.alpha}")
    if float(params.threshold) <= 0.0:
        raise ValueError(
            f"PHParams.threshold must be > 0, got {params.threshold} (0 = auto, "
            "resolved from stream geometry by api.prepare / "
            "config.auto_ph_threshold — pass a resolved λ to the kernels)"
        )


def ph_thresholds(params: PHParams) -> tuple[float, float]:
    """The f32 change and warning bars: λ and ``warning_fraction·λ`` (the
    product taken in float64, as a Python expression, then rounded)."""
    return f32(params.threshold), f32(params.warning_fraction * params.threshold)


def ph_step(state: PHState, err, params: PHParams):
    """One element per partition: ``(new_state, (warning, change))``."""
    _validate_ph(params)
    thr, wthr = ph_thresholds(params)
    cnt = state.count + 1
    xsum = state.x_sum + err
    mean = xsum / cnt.float()
    c = err - mean - f32(params.delta)
    m = torch.clamp_min(fma(params.alpha, state.m, c), 0.0)
    check = cnt >= params.min_num_instances
    change = check & (m > thr)
    warning = check & ~change & (m > wthr)
    return PHState(cnt, xsum, m), (warning, change)


def _ph_compose(first, second):
    """``m → max(K, A·m + B)`` maps: apply ``first``, then ``second``."""
    a1, b1, k1 = first
    a2, b2, k2 = second
    return ftz(a2 * a1), fma(a2, b1, b2), torch.maximum(k2, fma(a2, k1, b2))


def _ph_masks(state: PHState, errs, valid, params: PHParams):
    """Flat ``[P, N]`` prefix pass → ``(end_state, warning, change)``."""
    _validate_ph(params)
    thr, wthr = ph_thresholds(params)
    v = valid.bool()
    cnt = state.count[:, None] + torch.cumsum(v.int(), 1, dtype=torch.int32)
    # a sum of 0/1 indicators: exact below 2^24 terms in any order
    xsum = state.x_sum[:, None] + torch.cumsum(errs * v.float(), 1)
    mean = xsum / cnt.clamp_min(1).float()
    c = errs - mean - f32(params.delta)
    a, b, k = associative_scan(_ph_compose, (
        torch.where(v, f32(params.alpha), 1.0),
        torch.where(v, c, 0.0),
        torch.where(v, 0.0, _NO_CLAMP),
    ))
    m = torch.maximum(k, fma(a, state.m[:, None], b))
    check = v & (cnt >= params.min_num_instances)
    change = check & (m > thr)
    warning = check & ~change & (m > wthr)
    return PHState(cnt[:, -1], xsum[:, -1], m[:, -1]), warning, change


def ph_window_reference(state: PHState, errs, valid, params: PHParams):
    """Plain PyTorch version of :func:`ph_window`."""
    return _window(lambda s, e, v: _ph_masks(s, e, v, params), state, errs, valid)


def ph_window_args(state, errs, valid, params, first_warning, first_change, end, scratch,
                   ctas):
    """Kernel K5-ph's launch arguments, stream excluded: ``ctas`` from
    :func:`cluster_ctas`, ``scratch`` None on the cluster path."""
    _validate_ph(params)
    p, w, b = errs.shape
    thr, wthr = ph_thresholds(params)
    return (
        errs.data_ptr(), valid.data_ptr(), *(leaf.data_ptr() for leaf in state),
        p, w, b, ctas, int(params.min_num_instances), f32(params.alpha),
        f32(params.delta), thr, wthr, None if scratch is None else scratch.data_ptr(),
        first_warning.data_ptr(), first_change.data_ptr(),
        *(leaf.data_ptr() for leaf in end),
    )


def scratch_words(n: int, elem_words: int, tuple_words: int) -> int:
    """32-bit words of global scratch a zoo kernel needs per row of ``n``
    elements: ``elem_words`` per element, and its scan's levels above the
    first (``n//2 + n//4 + …`` tuples of ``tuple_words``; used when they do
    not fit in shared memory) — ``csrc/zoo_scan.cuh`` ``scan_levels``."""
    levels, m = 0, n
    while m >= 2:
        m //= 2
        levels += m
    return elem_words * n + tuple_words * levels


# Elements a CTA of the zoo kernels' cluster paths owns (csrc/cluster_tree.cuh
# kSeg): 256 threads of 8.
CLUSTER_SEGMENT = 2048


def cluster_ctas(p: int, n: int, sms: int = 132) -> int:
    """CTAs a row of the zoo kernels' cluster paths (K5-ph, K5-hddm_w,
    K5-eddm, K5-hddm): ``ceil(n / 2048)`` when that is at most K1's cluster
    size for ``p`` partitions on ``sms`` multiprocessors
    (:func:`.ddm.cluster_size`: 8 at P = 16, so rows of up to 16,384
    elements); else 0, the one-CTA path with its global scratch. The path
    follows from the shape alone."""
    need = -(-int(n) // CLUSTER_SEGMENT)
    return need if 0 < need <= cluster_size(p, sms) else 0


def _device_sms(dev) -> int:
    idx = dev.index
    return _sm_count(torch.cuda.current_device() if idx is None else idx)


def _device_ctas(dev, p: int, n: int) -> int:
    """:func:`cluster_ctas` on the card ``dev``."""
    return cluster_ctas(p, n, _device_sms(dev))


# The longest window_size on the ring members' cluster path (K5-kswin,
# K5-stepd; csrc/ring_cluster.cuh kWindowCap): every CTA holds the carried
# window's prefix and the window_size values its windows read below its
# own elements, 2·window_size + 1 floats, in its shared memory beside the
# marks and its compacted prefixes.
RING_WINDOW_CAP = 16384


def ring_ctas(p: int, n: int, window_size: int, sms: int = 132) -> int:
    """CTAs a row of K5-kswin's and K5-stepd's cluster path:
    :func:`cluster_ctas` where ``window_size`` is at most
    :data:`RING_WINDOW_CAP`, else 0 — the one-CTA path (its prefix row in
    shared memory or a global scratch). The path follows from ``(p, n,
    window_size)`` alone."""
    return cluster_ctas(p, n, sms) if int(window_size) <= RING_WINDOW_CAP else 0


def ph_scratch(p: int, n: int, ctas: int, device):
    """K5-ph's global scratch (8 B an element and the tree's levels), used
    only on the global-scratch path (``ctas`` 0)."""
    if ctas:
        return None
    return torch.empty((p, scratch_words(n, 2, 3)), dtype=torch.float32, device=device)


def ph_window(state: PHState, errs, valid, params: PHParams):
    """The Page–Hinkley window statistic (contract of :func:`.ddm.ddm_window`).

    CUDA tensors launch kernel K5-ph (``csrc/ph_window.cu``: a thread-block
    cluster of :func:`cluster_ctas` CTAs a partition, or one CTA with a
    global scratch for longer rows) and add one to ``ph_window.launches``;
    a refused launch raises. CPU tensors run the plain version. ``valid``
    may be bool or uint8."""
    if errs.device.type == "cpu":
        return ph_window_reference(state, errs, valid, params)
    if errs.device.type != "cuda":
        raise ValueError(f"ph_window: unsupported device {errs.device}")
    _validate_ph(params)
    check_window_inputs("ph_window", state, errs, valid,
                        {"count": torch.int32, "x_sum": torch.float32, "m": torch.float32})
    dev = errs.device
    p, w, b = errs.shape
    fw = torch.empty((p, w), dtype=torch.int32, device=dev)
    fc = torch.empty_like(fw)
    end = PHState(*(torch.empty_like(leaf) for leaf in state))
    ctas = _device_ctas(dev, p, w * b)
    scratch = ph_scratch(p, w * b, ctas, dev)
    launch_window(
        "ph_window", ph_window_args(state, errs, valid, params, fw, fc, end, scratch, ctas), dev,
    )
    ph_window.launches += 1
    return end, DDMWindowResult(fw, fc)


ph_window.launches = 0


def ph_batch(state: PHState, errs, valid, params: PHParams):
    return batch_from_window(lambda s, e, v: ph_window(s, e, v, params))(state, errs, valid)


# --------------------------------------------------------------------------
# EDDM
# --------------------------------------------------------------------------


class EDDMState(NamedTuple):
    count: torch.Tensor  # i32: elements absorbed since last reset
    num_errors: torch.Tensor  # i32: errors seen since last reset
    d_sum: torch.Tensor  # f32: sum of between-error distances
    d2_sum: torch.Tensor  # f32: sum of squared distances
    last_err_t: torch.Tensor  # i32: element index of the last error (0 = none)
    m2s_max: torch.Tensor  # f32: running max of mean + 2*std


def eddm_init(shape=(), device="cpu") -> EDDMState:
    i, f = torch.int32, torch.float32
    return EDDMState(*(torch.zeros(shape, dtype=d, device=device) for d in (i, i, f, f, i, f)))


def _eddm_stats(d_sum, d2_sum, k):
    k_f = k.clamp_min(1).float()
    mean = d_sum / k_f
    var = torch.clamp_min(fma(-mean, mean, d2_sum / k_f), 0.0)
    return mean + 2.0 * sqrt(var)


def eddm_step(state: EDDMState, err, params: EDDMParams = EDDMParams()):
    """One element per partition: ``(new_state, (warning, change))``."""
    t = state.count + 1
    is_err = err >= 0.5
    contributes = is_err & (state.last_err_t > 0) if params.paper_exact else is_err
    k = state.num_errors + contributes.int()
    d = (t - state.last_err_t).float()
    d_sum = state.d_sum + torch.where(contributes, d, 0.0)
    d2_sum = state.d2_sum + torch.where(contributes, d * d, 0.0)
    m2s = _eddm_stats(d_sum, d2_sum, k)
    update_max = contributes & (m2s > state.m2s_max)
    check = contributes & ~update_max & (k >= params.min_num_errors)
    ratio = m2s / state.m2s_max.clamp_min(f32(1e-30))
    change = check & (ratio < f32(params.change_beta))
    warning = check & ~change & (ratio < f32(params.warning_alpha))
    return EDDMState(
        t, k, d_sum, d2_sum, torch.where(is_err, t, state.last_err_t),
        torch.where(update_max, m2s, state.m2s_max),
    ), (warning, change)


def _eddm_masks(state: EDDMState, errs, valid, params: EDDMParams):
    """Flat ``[P, N]`` prefix pass → ``(end_state, warning, change)``."""
    v = valid.bool()
    t = state.count[:, None] + torch.cumsum(v.int(), 1, dtype=torch.int32)
    is_err = v & (errs >= 0.5)
    # element index of the previous error, strictly before each position
    incl = torch.cummax(torch.where(is_err, t, -1), 1).values
    excl = torch.cat([torch.full_like(incl[:, :1], -1), incl[:, :-1]], 1)
    prev_t = torch.where(excl > 0, excl, state.last_err_t[:, None])
    contributes = is_err & (prev_t > 0) if params.paper_exact else is_err
    k = state.num_errors[:, None] + torch.cumsum(contributes.int(), 1, dtype=torch.int32)
    d_mask = torch.where(contributes, (t - prev_t).float(), 0.0)
    # distances and their squares pass 2^24 within a row: JAX's float32
    # chain, from 0, then the carried sum added with one rounding
    d_sum = state.d_sum[:, None] + cumsum_f32(d_mask, 1)
    d2_sum = state.d2_sum[:, None] + cumsum_f32(d_mask * d_mask, 1)
    m2s = _eddm_stats(d_sum, d2_sum, k)
    # running max over contributing events; an event is tested against the
    # max excluding itself
    ev_cummax = torch.cummax(torch.where(contributes, m2s, -_INF), 1).values
    carried = state.m2s_max[:, None]
    incl_max = torch.maximum(ev_cummax, carried)
    excl_max = torch.maximum(
        torch.cat([torch.full_like(ev_cummax[:, :1], -_INF), ev_cummax[:, :-1]], 1), carried
    )
    update_max = contributes & (m2s > excl_max)
    check = contributes & ~update_max & (k >= params.min_num_errors)
    ratio = m2s / excl_max.clamp_min(f32(1e-30))
    change = check & (ratio < f32(params.change_beta))
    warning = check & ~change & (ratio < f32(params.warning_alpha))
    end = EDDMState(
        t[:, -1], k[:, -1], d_sum[:, -1], d2_sum[:, -1],
        torch.where(incl[:, -1] > 0, incl[:, -1], state.last_err_t), incl_max[:, -1],
    )
    return end, warning, change


def eddm_window_reference(state: EDDMState, errs, valid, params: EDDMParams = EDDMParams()):
    """Plain PyTorch version of :func:`eddm_window`."""
    return _window(lambda s, e, v: _eddm_masks(s, e, v, params), state, errs, valid)


_EDDM_DTYPES = dict(count=torch.int32, num_errors=torch.int32, d_sum=torch.float32,
                    d2_sum=torch.float32, last_err_t=torch.int32, m2s_max=torch.float32)


def eddm_tree_words(n: int) -> int:
    """Floats of K5-eddm's global scratch per row of ``n`` elements: the
    levels of :func:`.prefix.cumsum_f32`'s tree above the elements (``n/16 +
    n/256 + …`` block values while a level holds more than 16), for the
    sums of d and of d² (``csrc/eddm_window.cu`` ``tree_levels``)."""
    total, cur = 0, int(n)
    while cur > _SCAN_BASE:
        cur = -(-cur // _SCAN_BASE)
        total += cur
    return 2 * total


def eddm_window_args(state, errs, valid, params, first_warning, first_change, end, scratch,
                     ctas):
    """Kernel K5-eddm's launch arguments, stream excluded: ``ctas`` from
    :func:`cluster_ctas`, ``scratch`` from :func:`eddm_scratch` (None but
    on the one-CTA path of very long rows)."""
    p, w, b = errs.shape
    return (
        errs.data_ptr(), valid.data_ptr(), *(leaf.data_ptr() for leaf in state),
        p, w, b, ctas, int(bool(params.paper_exact)), int(params.min_num_errors),
        f32(params.warning_alpha), f32(params.change_beta),
        None if scratch is None else scratch.data_ptr(),
        first_warning.data_ptr(), first_change.data_ptr(),
        *(leaf.data_ptr() for leaf in end),
    )


def eddm_scratch(p: int, w: int, b: int, ctas: int, device):
    """K5-eddm's global scratch: on the one-CTA path (``ctas`` 0), where
    the sums' tree does not fit in shared memory on the card
    (``csrc/eddm_window.cu`` ``eddm_window_tree_in_smem``), each row's
    :func:`eddm_tree_words`; else None."""
    if ctas:
        return None
    in_smem = ctypes.c_int(0)
    kernels.check("eddm_window_tree_in_smem", kernels.launcher("eddm_window_tree_in_smem")(
        w, b, ctypes.addressof(in_smem)))
    if in_smem.value:
        return None
    return torch.empty((p, eddm_tree_words(w * b)), dtype=torch.float32, device=device)


def eddm_window(state: EDDMState, errs, valid, params: EDDMParams = EDDMParams()):
    """The EDDM window statistic (contract of :func:`.ddm.ddm_window`).

    CUDA tensors launch kernel K5-eddm (``csrc/eddm_window.cu``: a
    thread-block cluster of :func:`cluster_ctas` CTAs a partition, or one
    CTA for longer rows, its sums' tree in shared memory or in a global
    scratch) and add one to ``eddm_window.launches``; a refused launch
    raises. CPU tensors run the plain version."""
    if errs.device.type == "cpu":
        return eddm_window_reference(state, errs, valid, params)
    if errs.device.type != "cuda":
        raise ValueError(f"eddm_window: unsupported device {errs.device}")
    check_window_inputs("eddm_window", state, errs, valid, _EDDM_DTYPES)
    dev = errs.device
    p, w, b = errs.shape
    fw = torch.empty((p, w), dtype=torch.int32, device=dev)
    fc = torch.empty_like(fw)
    end = EDDMState(*(torch.empty_like(leaf) for leaf in state))
    ctas = _device_ctas(dev, p, w * b)
    scratch = eddm_scratch(p, w, b, ctas, dev)
    launch_window(
        "eddm_window",
        eddm_window_args(state, errs, valid, params, fw, fc, end, scratch, ctas), dev,
    )
    eddm_window.launches += 1
    return end, DDMWindowResult(fw, fc)


eddm_window.launches = 0


def eddm_batch(state: EDDMState, errs, valid, params: EDDMParams = EDDMParams()):
    return batch_from_window(lambda s, e, v: eddm_window(s, e, v, params))(state, errs, valid)


# --------------------------------------------------------------------------
# HDDM-A
# --------------------------------------------------------------------------


class HDDMState(NamedTuple):
    count: torch.Tensor  # i32: elements absorbed since last reset
    err_sum: torch.Tensor  # f32: sum of error indicators
    n_min: torch.Tensor  # i32: element count at the stored cut (0 = none)
    c_min: torch.Tensor  # f32: error sum at the stored cut


def hddm_init(shape=(), device="cpu") -> HDDMState:
    i, f = torch.int32, torch.float32
    return HDDMState(*(torch.zeros(shape, dtype=d, device=device) for d in (i, f, i, f)))


def _validate_hddm(params: HDDMParams) -> None:
    for knob in ("drift_confidence", "warning_confidence"):
        if not 0.0 < float(getattr(params, knob)) < 1.0:
            raise ValueError(
                f"HDDMParams.{knob} must be in (0, 1), got {getattr(params, knob)}"
            )


def _hddm_eps(n_f, confidence: float):
    """Hoeffding deviation bound ε(n, δ) = sqrt(ln(1/δ) / 2n)."""
    return sqrt(rdiv(math.log(1.0 / confidence), 2.0 * n_f))


def _hddm_bound(n, n_min, confidence: float):
    """sqrt(m/2 · ln(2/δ)) with m = (n − n_min) / (n_min · n)."""
    n_f = n.clamp_min(1).float()
    nm_f = n_min.clamp_min(1).float()
    m = (n_f - nm_f) / (nm_f * n_f)
    return sqrt(m.clamp_min(0.0) * 0.5 * f32(math.log(2.0 / confidence)))


def _hddm_carried_key(state: HDDMState, confidence: float):
    nm_f = state.n_min.clamp_min(1).float()
    key = state.c_min / nm_f + _hddm_eps(nm_f, confidence)
    return torch.where(state.n_min > 0, key, _INF)


def _hddm_signal(testable, mean, n, n_min, c_min, params: HDDMParams):
    diff = mean - c_min / n_min.clamp_min(1).float()
    change = testable & (diff >= _hddm_bound(n, n_min, params.drift_confidence))
    warning = testable & ~change & (diff >= _hddm_bound(n, n_min, params.warning_confidence))
    return warning, change


def hddm_step(state: HDDMState, err, params: HDDMParams = HDDMParams()):
    """One element per partition: the candidate cut is considered before
    the test, so an element that becomes the cut never signals."""
    n = state.count + 1
    c = state.err_sum + err
    n_f = n.float()
    mean = c / n_f
    take = mean + _hddm_eps(n_f, params.drift_confidence) <= _hddm_carried_key(
        state, params.drift_confidence
    )
    n_min = torch.where(take, n, state.n_min)
    c_min = torch.where(take, c, state.c_min)
    warning, change = _hddm_signal((n_min > 0) & (n_min < n), mean, n, n_min, c_min, params)
    return HDDMState(n, c, n_min, c_min), (warning, change)


def _hddm_masks(state: HDDMState, errs, valid, params: HDDMParams):
    """Flat ``[P, N]`` prefix pass: the stored cut is a running minimum of
    ``mean + ε(n)`` with the ``(n, c)`` prefix as payload (DDM's
    min-with-payload, later ties winning)."""
    v = valid.bool()
    n = state.count[:, None] + torch.cumsum(v.int(), 1, dtype=torch.int32)
    c = state.err_sum[:, None] + torch.cumsum(errs * v.float(), 1)  # 0/1 terms: exact
    n_f = n.clamp_min(1).float()
    mean = c / n_f
    key = torch.where(v, mean + _hddm_eps(n_f, params.drift_confidence), _INF)
    run_key, run_n, run_c = _run_min(key, n, c)
    use_run = run_key <= _hddm_carried_key(state, params.drift_confidence)[:, None]
    n_min = torch.where(use_run, run_n, state.n_min[:, None])
    c_min = torch.where(use_run, run_c, state.c_min[:, None])
    warning, change = _hddm_signal(
        v & (n_min > 0) & (n_min < n), mean, n, n_min, c_min, params
    )
    return HDDMState(n[:, -1], c[:, -1], n_min[:, -1], c_min[:, -1]), warning, change


def hddm_window_reference(state: HDDMState, errs, valid, params: HDDMParams = HDDMParams()):
    """Plain PyTorch version of :func:`hddm_window`."""
    return _window(lambda s, e, v: _hddm_masks(s, e, v, params), state, errs, valid)


_HDDM_DTYPES = dict(count=torch.int32, err_sum=torch.float32, n_min=torch.int32,
                    c_min=torch.float32)


def hddm_window_args(state, errs, valid, params, first_warning, first_change, end, ctas):
    """Kernel K5-hddm's launch arguments, stream excluded: ``ctas`` from
    :func:`cluster_ctas`, the f32 logs of ε's ``1/δ`` (drift) and of each
    bound's ``2/δ``."""
    _validate_hddm(params)
    p, w, b = errs.shape
    return (
        errs.data_ptr(), valid.data_ptr(), *(leaf.data_ptr() for leaf in state),
        p, w, b, ctas, f32(math.log(1.0 / params.drift_confidence)),
        f32(math.log(2.0 / params.drift_confidence)),
        f32(math.log(2.0 / params.warning_confidence)),
        first_warning.data_ptr(), first_change.data_ptr(),
        *(leaf.data_ptr() for leaf in end),
    )


def hddm_window(state: HDDMState, errs, valid, params: HDDMParams = HDDMParams()):
    """The HDDM-A window statistic (contract of :func:`.ddm.ddm_window`).

    CUDA tensors launch kernel K5-hddm (``csrc/hddm_window.cu``: a
    thread-block cluster of :func:`cluster_ctas` CTAs a partition, or one
    CTA for longer rows) and add one to ``hddm_window.launches``; a refused
    launch raises. CPU tensors run the plain version."""
    if errs.device.type == "cpu":
        return hddm_window_reference(state, errs, valid, params)
    if errs.device.type != "cuda":
        raise ValueError(f"hddm_window: unsupported device {errs.device}")
    _validate_hddm(params)
    check_window_inputs("hddm_window", state, errs, valid, _HDDM_DTYPES)
    dev = errs.device
    p, w, b = errs.shape
    fw = torch.empty((p, w), dtype=torch.int32, device=dev)
    fc = torch.empty_like(fw)
    end = HDDMState(*(torch.empty_like(leaf) for leaf in state))
    ctas = _device_ctas(dev, p, w * b)
    launch_window(
        "hddm_window", hddm_window_args(state, errs, valid, params, fw, fc, end, ctas), dev
    )
    hddm_window.launches += 1
    return end, DDMWindowResult(fw, fc)


hddm_window.launches = 0


def hddm_batch(state: HDDMState, errs, valid, params: HDDMParams = HDDMParams()):
    return batch_from_window(lambda s, e, v: hddm_window(s, e, v, params))(state, errs, valid)


# --------------------------------------------------------------------------
# HDDM-W
# --------------------------------------------------------------------------


class HDDMWState(NamedTuple):
    count: torch.Tensor  # i32: elements absorbed since last reset
    z: torch.Tensor  # f32: stream EWMA
    v: torch.Tensor  # f32: stream Σ(relative weight)²
    z1: torch.Tensor  # f32: EWMA frozen at the stored cut
    v1: torch.Tensor  # f32: bound condition frozen at the cut (0 = no cut)
    n2: torch.Tensor  # i32: elements absorbed after the cut
    z2: torch.Tensor  # f32: post-cut EWMA
    v2: torch.Tensor  # f32: post-cut bound condition


_HDDM_W_DTYPES = dict(
    count=torch.int32, z=torch.float32, v=torch.float32, z1=torch.float32,
    v1=torch.float32, n2=torch.int32, z2=torch.float32, v2=torch.float32,
)


def hddm_w_init(shape=(), device="cpu") -> HDDMWState:
    return HDDMWState(*(torch.zeros(shape, dtype=d, device=device) for d in _HDDM_W_DTYPES.values()))


def _validate_hddm_w(params: HDDMWParams) -> None:
    if not 0.0 < float(params.lam) < 1.0:
        raise ValueError(f"HDDMWParams.lam must be in (0, 1), got {params.lam}")
    for knob in ("drift_confidence", "warning_confidence"):
        if not 0.0 < float(getattr(params, knob)) < 1.0:
            raise ValueError(
                f"HDDMWParams.{knob} must be in (0, 1), got {getattr(params, knob)}"
            )


def hddm_w_constants(params: HDDMWParams) -> dict:
    """The f32 constants of the W-test: λ, 1−λ, (1−λ)², λ², and the two
    logs ln(1/δ) of the bounds."""
    lam = f32(params.lam)
    one_m = f32(1.0 - lam)
    return dict(
        lam=lam, one_m=one_m, one_m2=f32(one_m * one_m), lam2=f32(lam * lam),
        log_drift=f32(math.log(1.0 / params.drift_confidence)),
        log_warning=f32(math.log(1.0 / params.warning_confidence)),
    )


def _hddm_w_eps(v, log_conf: float):
    """ε(v, δ) = sqrt(v · ln(1/δ) / 2)."""
    return sqrt(v * log_conf * 0.5)


def hddm_w_step(state: HDDMWState, err, params: HDDMWParams = HDDMWParams()):
    """One element per partition: the stream EWMA absorbs the element, the
    candidate cut is considered before the test, and a cut-moving element
    resets the monitoring sample without joining it."""
    _validate_hddm_w(params)
    k = hddm_w_constants(params)
    first = state.count == 0
    z = torch.where(first, err, fma(k["one_m"], state.z, k["lam"] * err))
    v = torch.where(first, 1.0, fma(k["one_m2"], state.v, k["lam2"]))
    key = z + _hddm_w_eps(v, k["log_drift"])
    stored = torch.where(state.v1 > 0, state.z1 + _hddm_w_eps(state.v1, k["log_drift"]), _INF)
    take = key < stored  # strict: ties keep the cut and its evidence
    z1 = torch.where(take, z, state.z1)
    v1 = torch.where(take, v, state.v1)
    init2 = ~take & (state.n2 == 0)
    n2 = torch.where(take, 0, state.n2 + 1)
    z2 = torch.where(take, 0.0, torch.where(init2, err, fma(k["one_m"], state.z2, k["lam"] * err)))
    v2 = torch.where(take, 0.0, torch.where(init2, 1.0, fma(k["one_m2"], state.v2, k["lam2"])))
    diff = z2 - z1
    change = ~take & (diff >= _hddm_w_eps(v1 + v2, k["log_drift"]))
    warning = ~take & ~change & (diff >= _hddm_w_eps(v1 + v2, k["log_warning"]))
    return HDDMWState(state.count + 1, z, v, z1, v1, n2, z2, v2), (warning, change)


def _affine_compose(f, g):
    """Two independent affine maps ``y → Ay + B``: apply ``f``, then ``g``."""
    az1, bz1, av1, bv1 = f
    az2, bz2, av2, bv2 = g
    return ftz(az2 * az1), fma(az2, bz1, bz2), ftz(av2 * av1), fma(av2, bv1, bv2)


def _affine_elements(reset, init, absorb, errs, k):
    """Per-element affine maps of an EWMA pair (z, v): ``reset`` → (0, 0),
    ``init`` → (0, x) and (0, 1), ``absorb`` → (1−λ, λx) and ((1−λ)², λ²),
    otherwise the identity."""
    a_z = torch.where(reset | init, 0.0, torch.where(absorb, k["one_m"], 1.0))
    b_z = torch.where(reset, 0.0, torch.where(init, errs, torch.where(absorb, k["lam"] * errs, 0.0)))
    a_v = torch.where(reset | init, 0.0, torch.where(absorb, k["one_m2"], 1.0))
    b_v = torch.where(reset, 0.0, torch.where(init, 1.0, torch.where(absorb, k["lam2"], 0.0)))
    return a_z, b_z, a_v, b_v


def _hddm_w_masks(state: HDDMWState, errs, valid, params: HDDMWParams):
    """Flat ``[P, N]`` prefix pass: two affine-map scans (the stream EWMA,
    then the monitoring EWMA segmented by the cut moves), the cut a strict
    running minimum of ``z + ε(v)``."""
    _validate_hddm_w(params)
    k = hddm_w_constants(params)
    v_ = valid.bool()
    p, n_el = errs.shape
    n = state.count[:, None] + torch.cumsum(v_.int(), 1, dtype=torch.int32)

    is_init = v_ & (n == 1)
    acz, bcz, acv, bcv = associative_scan(
        _affine_compose, _affine_elements(torch.zeros_like(v_), is_init, v_ & ~is_init, errs, k)
    )
    z = fma(acz, state.z[:, None], bcz)
    v = fma(acv, state.v[:, None], bcv)

    key = torch.where(v_, z + _hddm_w_eps(v, k["log_drift"]), _INF)
    carried_key = torch.where(
        state.v1 > 0, state.z1 + _hddm_w_eps(state.v1, k["log_drift"]), _INF
    )
    incl_min = torch.cummin(key, 1).values
    excl_min = torch.cat([torch.full_like(incl_min[:, :1], _INF), incl_min[:, :-1]], 1)
    improve = v_ & (key < torch.minimum(excl_min, carried_key[:, None]))
    pos = torch.arange(n_el, dtype=torch.int32, device=errs.device)
    last_imp = torch.cummax(torch.where(improve, pos, -1), 1).values
    has_cut = last_imp >= 0
    gi = last_imp.clamp_min(0).long()
    z1 = torch.where(has_cut, torch.gather(z, 1, gi), state.z1[:, None])
    v1 = torch.where(has_cut, torch.gather(v, 1, gi), state.v1[:, None])

    e2 = v_ & ~improve
    ce = torch.cumsum(e2.int(), 1, dtype=torch.int32)
    n2 = torch.where(has_cut, ce - torch.gather(ce, 1, gi), state.n2[:, None] + ce)
    is_init2 = e2 & (n2 == 1)
    acz2, bcz2, acv2, bcv2 = associative_scan(
        _affine_compose, _affine_elements(improve, is_init2, e2 & ~is_init2, errs, k)
    )
    z2 = fma(acz2, state.z2[:, None], bcz2)
    v2 = fma(acv2, state.v2[:, None], bcv2)

    testable = e2 & (n2 >= 1)
    diff = z2 - z1
    change = testable & (diff >= _hddm_w_eps(v1 + v2, k["log_drift"]))
    warning = testable & ~change & (diff >= _hddm_w_eps(v1 + v2, k["log_warning"]))
    end = HDDMWState(*(x[:, -1] for x in (n, z, v, z1, v1, n2, z2, v2)))
    return end, warning, change


def hddm_w_window_reference(state: HDDMWState, errs, valid, params: HDDMWParams = HDDMWParams()):
    """Plain PyTorch version of :func:`hddm_w_window`."""
    return _window(lambda s, e, v: _hddm_w_masks(s, e, v, params), state, errs, valid)


def hddm_w_window_args(state, errs, valid, params, first_warning, first_change, end,
                       scratch, ctas):
    """Kernel K5-hddm_w's launch arguments, stream excluded: ``ctas`` from
    :func:`cluster_ctas`, ``scratch`` None on the cluster path."""
    _validate_hddm_w(params)
    p, w, b = errs.shape
    k = hddm_w_constants(params)
    return (
        errs.data_ptr(), valid.data_ptr(), *(leaf.data_ptr() for leaf in state),
        p, w, b, ctas, k["lam"], k["one_m"], k["one_m2"], k["lam2"],
        k["log_drift"], k["log_warning"], None if scratch is None else scratch.data_ptr(),
        first_warning.data_ptr(), first_change.data_ptr(),
        *(leaf.data_ptr() for leaf in end),
    )


def hddm_w_scratch(p: int, n: int, ctas: int, device):
    """K5-hddm_w's global scratch (24 B an element and the tree's levels),
    used only on the global-scratch path (``ctas`` 0)."""
    if ctas:
        return None
    return torch.empty((p, scratch_words(n, 6, 4)), dtype=torch.float32, device=device)


def hddm_w_window(state: HDDMWState, errs, valid, params: HDDMWParams = HDDMWParams()):
    """The HDDM-W window statistic (contract of :func:`.ddm.ddm_window`).

    CUDA tensors launch kernel K5-hddm_w (``csrc/hddm_w_window.cu``: a
    thread-block cluster of :func:`cluster_ctas` CTAs a partition, or one
    CTA with a global scratch for longer rows) and add one to
    ``hddm_w_window.launches``; a refused launch raises. CPU tensors run
    the plain version."""
    if errs.device.type == "cpu":
        return hddm_w_window_reference(state, errs, valid, params)
    if errs.device.type != "cuda":
        raise ValueError(f"hddm_w_window: unsupported device {errs.device}")
    _validate_hddm_w(params)
    check_window_inputs("hddm_w_window", state, errs, valid, _HDDM_W_DTYPES)
    dev = errs.device
    p, w, b = errs.shape
    fw = torch.empty((p, w), dtype=torch.int32, device=dev)
    fc = torch.empty_like(fw)
    end = HDDMWState(*(torch.empty_like(leaf) for leaf in state))
    ctas = _device_ctas(dev, p, w * b)
    scratch = hddm_w_scratch(p, w * b, ctas, dev)
    launch_window(
        "hddm_w_window",
        hddm_w_window_args(state, errs, valid, params, fw, fc, end, scratch, ctas), dev,
    )
    hddm_w_window.launches += 1
    return end, DDMWindowResult(fw, fc)


hddm_w_window.launches = 0


def hddm_w_batch(state: HDDMWState, errs, valid, params: HDDMWParams = HDDMWParams()):
    return batch_from_window(lambda s, e, v: hddm_w_window(s, e, v, params))(state, errs, valid)


# --------------------------------------------------------------------------
# KSWIN and STEPD (ring buffers)
# --------------------------------------------------------------------------


class KSWINState(NamedTuple):
    t: torch.Tensor  # i32: elements absorbed since reset
    buf: torch.Tensor  # f32 [..., window_size]: last w elements, right-aligned


def kswin_init(params: KSWINParams = KSWINParams(), shape=(), device="cpu") -> KSWINState:
    return KSWINState(
        torch.zeros(shape, dtype=torch.int32, device=device),
        torch.zeros((*shape, int(params.window_size)), dtype=torch.float32, device=device),
    )


def _validate_kswin(params: KSWINParams) -> None:
    if not 0.0 < float(params.alpha) < 1.0:
        raise ValueError(f"KSWINParams.alpha must be in (0, 1), got {params.alpha}")
    if not 0 < int(params.stat_size) < int(params.window_size):
        raise ValueError(
            "KSWINParams needs 0 < stat_size < window_size, got "
            f"stat_size={params.stat_size}, window_size={params.window_size}"
        )


@functools.cache
def _kswin_crit(params: KSWINParams) -> float:
    """Two-sample KS critical value c(α)·sqrt((n₁+n₂)/(n₁·n₂)),
    c(α) = sqrt(−ln(α/2)/2), n₁ = stat_size, n₂ = window_size − stat_size;
    computed once a parameter value."""
    r = int(params.stat_size)
    m = int(params.window_size) - r
    c = math.sqrt(-math.log(float(params.alpha) / 2.0) / 2.0)
    return c * math.sqrt((r + m) / (r * m))


def _push(buf, err):
    return torch.cat([buf[..., 1:], err[..., None].float()], -1)


def kswin_step(state: KSWINState, err, params: KSWINParams = KSWINParams()):
    """One element per partition: shift the window, then — once full —
    compare the newest ``stat_size`` elements' mean with the older rest's."""
    _validate_kswin(params)
    w, r = int(params.window_size), int(params.stat_size)
    buf = _push(state.buf, err)
    t = state.t + 1
    p_recent = div_const(buf[..., w - r:].sum(-1), r)
    p_old = div_const(buf[..., : w - r].sum(-1), w - r)
    change = (t >= w) & ((p_recent - p_old).abs() > f32(_kswin_crit(params)))
    return KSWINState(t, buf), (torch.zeros_like(change), change)


def _ring_compact(buf, errs, valid):
    """Compact each row's valid elements into consecutive slots, prepend
    the carried right-aligned window; returns ``ps`` (zero-led prefix sums
    of that ``[P, w+N]`` row, ``[P, w+N+1]``), each position's compaction
    index ``j`` (clipped), the running valid count, and the next carried
    window (the last w stream elements)."""
    p, n_el = errs.shape
    w = buf.shape[-1]
    vcnt = torch.cumsum(valid.int(), 1, dtype=torch.int32)
    slot = torch.where(valid, vcnt - 1, n_el).long()
    compact = torch.zeros((p, n_el + 1), dtype=torch.float32, device=errs.device)
    compact.scatter_(1, slot, errs.float() * valid.float())
    full = torch.cat([buf, compact[:, :n_el]], 1)
    # the window's and the batch's 0/1 indicators: exact below 2^24 terms
    ps = torch.cat([torch.zeros_like(full[:, :1]), torch.cumsum(full, 1)], 1)
    j = (vcnt - 1).clamp(0, n_el - 1).long()
    at = vcnt[:, -1:].long() + torch.arange(w, device=errs.device)
    return ps, j, vcnt, torch.gather(full, 1, at)


def _kswin_masks(state: KSWINState, errs, valid, params: KSWINParams):
    """Flat ``[P, N]`` pass: every position's recent/old window sums are
    differences of one prefix-sum row; no scan."""
    _validate_kswin(params)
    w, r = int(params.window_size), int(params.stat_size)
    v = valid.bool()
    ps, j, vcnt, end_buf = _ring_compact(state.buf, errs, v)
    hi = torch.gather(ps, 1, w + j + 1)
    mid = torch.gather(ps, 1, w + j + 1 - r)
    lo = torch.gather(ps, 1, j + 1)
    gap = (div_const(hi - mid, r) - div_const(mid - lo, w - r)).abs()
    change = v & (state.t[:, None] + vcnt >= w) & (gap > f32(_kswin_crit(params)))
    return KSWINState(state.t + vcnt[:, -1], end_buf), torch.zeros_like(change), change


def kswin_window_reference(state: KSWINState, errs, valid, params: KSWINParams = KSWINParams()):
    """Plain PyTorch version of :func:`kswin_window`."""
    return _window(lambda s, e, v: _kswin_masks(s, e, v, params), state, errs, valid)


def ring_scratch(kernel: str, p: int, w: int, b: int, window_size: int, ctas: int, device):
    """K5-kswin's or K5-stepd's (``kernel``) global scratch: on the one-CTA
    path (``ctas`` 0), where a row's zero-led prefix sums of the carried
    window and the compacted elements (``window_size + w·b + 1`` floats) do
    not fit in shared memory on the card (``csrc/<kernel>.cu``
    ``<kernel>_pre_in_smem``), those rows; else None."""
    if ctas:
        return None
    in_smem = ctypes.c_int(0)
    query = f"{kernel}_pre_in_smem"
    kernels.check(query, kernels.launcher(query)(w, b, int(window_size),
                                                 ctypes.addressof(in_smem)))
    if in_smem.value:
        return None
    return torch.empty((p, int(window_size) + w * b + 1), dtype=torch.float32, device=device)


def _ring_launch_plan(kernel: str, errs, window_size: int):
    """The path of a ring member's launch on the card: (CTAs a row from
    :func:`ring_ctas`, the scratch from :func:`ring_scratch`)."""
    p, w, b = errs.shape
    ctas = ring_ctas(p, w * b, window_size, _device_sms(errs.device))
    return ctas, ring_scratch(kernel, p, w, b, window_size, ctas, errs.device)


def _check_ring(kernel: str, state, window_size: int) -> None:
    if state.buf.shape[-1] != int(window_size):
        raise ValueError(f"{kernel}: state.buf must be [P, {window_size}], "
                         f"got {tuple(state.buf.shape)}")


@functools.cache
def _kswin_consts(params: KSWINParams) -> tuple:
    """K5-kswin's launch constants of ``params``: window_size, stat_size,
    f32(1/r), f32(1/(window_size − r)) and the f32 critical value."""
    ws, r = int(params.window_size), int(params.stat_size)
    return ws, r, f32(1.0 / r), f32(1.0 / (ws - r)), f32(_kswin_crit(params))


def kswin_window_args(state, errs, valid, params, first_warning, first_change, end, scratch,
                      ctas):
    """Kernel K5-kswin's launch arguments, stream excluded: ``ctas`` from
    :func:`ring_ctas`, ``scratch`` from :func:`ring_scratch` (None but on the
    one-CTA path of rows too long for shared memory)."""
    _validate_kswin(params)
    p, w, b = errs.shape
    return (
        errs.data_ptr(), valid.data_ptr(), state.t.data_ptr(), state.buf.data_ptr(),
        p, w, b, ctas, *_kswin_consts(params),
        None if scratch is None else scratch.data_ptr(),
        first_warning.data_ptr(), first_change.data_ptr(),
        end.t.data_ptr(), end.buf.data_ptr(),
    )


def kswin_window(state: KSWINState, errs, valid, params: KSWINParams = KSWINParams()):
    """The KSWIN window statistic (contract of :func:`.ddm.ddm_window`).

    CUDA tensors launch kernel K5-kswin (``csrc/kswin_window.cu``: a
    thread-block cluster of :func:`ring_ctas` CTAs a partition, or one CTA
    for longer rows or windows, its prefix row in shared memory or in a
    global scratch) and add one to ``kswin_window.launches``; a refused
    launch raises. CPU tensors run the plain version."""
    if errs.device.type == "cpu":
        return kswin_window_reference(state, errs, valid, params)
    if errs.device.type != "cuda":
        raise ValueError(f"kswin_window: unsupported device {errs.device}")
    _validate_kswin(params)
    check_window_inputs("kswin_window", state, errs, valid,
                        dict(t=torch.int32, buf=torch.float32))
    _check_ring("kswin_window", state, params.window_size)
    dev = errs.device
    p, w, b = errs.shape
    fw = torch.empty((p, w), dtype=torch.int32, device=dev)
    fc = torch.empty_like(fw)
    end = KSWINState(*(torch.empty_like(leaf) for leaf in state))
    ctas, scratch = _ring_launch_plan("kswin_window", errs, params.window_size)
    launch_window(
        "kswin_window",
        kswin_window_args(state, errs, valid, params, fw, fc, end, scratch, ctas), dev,
    )
    kswin_window.launches += 1
    return end, DDMWindowResult(fw, fc)


kswin_window.launches = 0


def kswin_batch(state: KSWINState, errs, valid, params: KSWINParams = KSWINParams()):
    return batch_from_window(lambda s, e, v: kswin_window(s, e, v, params))(state, errs, valid)


class STEPDState(NamedTuple):
    t: torch.Tensor  # i32: elements absorbed since reset
    total: torch.Tensor  # f32: errors since reset
    buf: torch.Tensor  # f32 [..., window_size]: last w elements, right-aligned


def stepd_init(params: STEPDParams = STEPDParams(), shape=(), device="cpu") -> STEPDState:
    return STEPDState(
        torch.zeros(shape, dtype=torch.int32, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device),
        torch.zeros((*shape, int(params.window_size)), dtype=torch.float32, device=device),
    )


def _validate_stepd(params: STEPDParams) -> None:
    for knob in ("alpha_drift", "alpha_warning"):
        if not 0.0 < float(getattr(params, knob)) < 1.0:
            raise ValueError(
                f"STEPDParams.{knob} must be in (0, 1), got {getattr(params, knob)}"
            )
    if int(params.window_size) < 2:
        raise ValueError(f"STEPDParams.window_size must be >= 2, got {params.window_size}")


@functools.cache
def _z_crit(alpha: float) -> float:
    """Upper critical value of the standard normal at two-sided level α,
    by bisection on ``erf`` (80 iterations); computed once a value."""
    target = 1.0 - alpha / 2.0
    lo, hi = 0.0, 10.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if 0.5 * (1.0 + math.erf(mid / math.sqrt(2.0))) < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _stepd_signal(t, total, recent_sum, params: STEPDParams):
    """The pooled two-proportion z-test with continuity correction of the
    last ``w`` elements against the older rest, drift and warning gated on
    an error increase and on ``t >= 2w``."""
    w = int(params.window_size)
    n_of = (t - w).float().clamp_min(1.0)
    p_r = div_const(recent_sum, w)
    p_o = (total - recent_sum) / n_of
    p_hat = total / t.clamp_min(1).float()
    inv = rdiv(1.0, n_of) + f32(1.0 / w)
    num = (p_o - p_r).abs() - 0.5 * inv
    den = sqrt((p_hat * (1.0 - p_hat) * inv).clamp_min(f32(1e-30)))
    z = num / den
    gate = (t >= 2 * w) & (p_r > p_o)
    change = gate & (z > f32(_z_crit(float(params.alpha_drift))))
    warning = gate & ~change & (z > f32(_z_crit(float(params.alpha_warning))))
    return warning, change


def stepd_step(state: STEPDState, err, params: STEPDParams = STEPDParams()):
    """One element per partition (:func:`_stepd_signal`)."""
    _validate_stepd(params)
    buf = _push(state.buf, err)
    t = state.t + 1
    total = state.total + err.float()
    return STEPDState(t, total, buf), _stepd_signal(t, total, buf.sum(-1), params)


def _stepd_masks(state: STEPDState, errs, valid, params: STEPDParams):
    """Flat ``[P, N]`` pass: KSWIN's skeleton, plus the overall totals as
    an ordinary cumsum."""
    _validate_stepd(params)
    w = int(params.window_size)
    v = valid.bool()
    ps, j, vcnt, end_buf = _ring_compact(state.buf, errs, v)
    ev = errs.float() * v.float()  # 0/1 terms: its cumsum below is exact
    recent = torch.gather(ps, 1, w + j + 1) - torch.gather(ps, 1, j + 1)
    warning, change = _stepd_signal(
        state.t[:, None] + vcnt, state.total[:, None] + torch.cumsum(ev, 1), recent, params
    )
    end = STEPDState(state.t + vcnt[:, -1], state.total + ev.sum(1), end_buf)
    return end, warning & v, change & v


def stepd_window_reference(state: STEPDState, errs, valid, params: STEPDParams = STEPDParams()):
    """Plain PyTorch version of :func:`stepd_window`."""
    return _window(lambda s, e, v: _stepd_masks(s, e, v, params), state, errs, valid)


@functools.cache
def _stepd_consts(params: STEPDParams) -> tuple:
    """K5-stepd's launch constants of ``params``: window_size, f32(1/w) and
    the f32 drift and warning critical values (:func:`_z_crit`)."""
    ws = int(params.window_size)
    return (ws, f32(1.0 / ws), f32(_z_crit(float(params.alpha_drift))),
            f32(_z_crit(float(params.alpha_warning))))


def stepd_window_args(state, errs, valid, params, first_warning, first_change, end, scratch,
                      ctas):
    """Kernel K5-stepd's launch arguments, stream excluded: ``ctas`` from
    :func:`ring_ctas`, ``scratch`` from :func:`ring_scratch` (None but on the
    one-CTA path of rows too long for shared memory), the critical values
    from :func:`_z_crit` on the host."""
    _validate_stepd(params)
    p, w, b = errs.shape
    return (
        errs.data_ptr(), valid.data_ptr(), *(leaf.data_ptr() for leaf in state),
        p, w, b, ctas, *_stepd_consts(params),
        None if scratch is None else scratch.data_ptr(),
        first_warning.data_ptr(), first_change.data_ptr(),
        *(leaf.data_ptr() for leaf in end),
    )


def stepd_window(state: STEPDState, errs, valid, params: STEPDParams = STEPDParams()):
    """The STEPD window statistic (contract of :func:`.ddm.ddm_window`).

    CUDA tensors launch kernel K5-stepd (``csrc/stepd_window.cu``: as
    K5-kswin, a cluster of :func:`ring_ctas` CTAs a partition or one CTA)
    and add one to ``stepd_window.launches``; a refused launch raises. CPU
    tensors run the plain version."""
    if errs.device.type == "cpu":
        return stepd_window_reference(state, errs, valid, params)
    if errs.device.type != "cuda":
        raise ValueError(f"stepd_window: unsupported device {errs.device}")
    _validate_stepd(params)
    check_window_inputs("stepd_window", state, errs, valid,
                        dict(t=torch.int32, total=torch.float32, buf=torch.float32))
    _check_ring("stepd_window", state, params.window_size)
    dev = errs.device
    p, w, b = errs.shape
    fw = torch.empty((p, w), dtype=torch.int32, device=dev)
    fc = torch.empty_like(fw)
    end = STEPDState(*(torch.empty_like(leaf) for leaf in state))
    ctas, scratch = _ring_launch_plan("stepd_window", errs, params.window_size)
    launch_window(
        "stepd_window",
        stepd_window_args(state, errs, valid, params, fw, fc, end, scratch, ctas), dev,
    )
    stepd_window.launches += 1
    return end, DDMWindowResult(fw, fc)


stepd_window.launches = 0


def stepd_batch(state: STEPDState, errs, valid, params: STEPDParams = STEPDParams()):
    return batch_from_window(lambda s, e, v: stepd_window(s, e, v, params))(state, errs, valid)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------


def _kernel(name, init, window, params) -> DetectorKernel:
    return DetectorKernel(name, init, batch_from_window(window), window, params)


def make_detector(
    name: str,
    *,
    ddm: DDMParams = DDMParams(),
    ph: PHParams = PHParams(),
    eddm: EDDMParams = EDDMParams(),
    hddm: HDDMParams = HDDMParams(),
    hddm_w: HDDMWParams = HDDMWParams(),
    adwin: ADWINParams = ADWINParams(),
    kswin: KSWINParams = KSWINParams(),
    stepd: STEPDParams = STEPDParams(),
) -> DetectorKernel:
    """Build a :class:`DetectorKernel` by config name (``RunConfig.detector``),
    validating the member's parameters."""
    if name == "ddm":
        return _kernel("ddm", ddm_init, lambda s, e, v: ddm_window(s, e, v, ddm), ddm)
    if name == "ph":
        if not 0.0 <= ph.alpha <= 1.0:
            raise ValueError(f"PHParams.alpha must be in [0, 1], got {ph.alpha}")
        if ph.threshold <= 0.0:
            raise ValueError(
                f"PHParams.threshold must be > 0, got {ph.threshold} (0 = auto: "
                "let api.prepare resolve it via config.auto_ph_threshold, or "
                "pass an explicit λ)"
            )
        return _kernel("ph", ph_init, lambda s, e, v: ph_window(s, e, v, ph), ph)
    if name == "eddm":
        return _kernel("eddm", eddm_init, lambda s, e, v: eddm_window(s, e, v, eddm), eddm)
    if name == "hddm":
        _validate_hddm(hddm)
        return _kernel("hddm", hddm_init, lambda s, e, v: hddm_window(s, e, v, hddm), hddm)
    if name == "hddm_w":
        _validate_hddm_w(hddm_w)
        return _kernel(
            "hddm_w", hddm_w_init, lambda s, e, v: hddm_w_window(s, e, v, hddm_w), hddm_w
        )
    if name == "adwin":
        from .adwin import _validate_adwin, adwin_init, adwin_window

        _validate_adwin(adwin)
        return _kernel(
            "adwin", lambda shape=(), device="cpu": adwin_init(adwin, shape, device),
            lambda s, e, v: adwin_window(s, e, v, adwin), adwin,
        )
    if name == "kswin":
        _validate_kswin(kswin)
        return _kernel(
            "kswin", lambda shape=(), device="cpu": kswin_init(kswin, shape, device),
            lambda s, e, v: kswin_window(s, e, v, kswin), kswin,
        )
    if name == "stepd":
        _validate_stepd(stepd)
        return _kernel(
            "stepd", lambda shape=(), device="cpu": stepd_init(stepd, shape, device),
            lambda s, e, v: stepd_window(s, e, v, stepd), stepd,
        )
    raise ValueError(f"unknown detector {name!r}; expected one of {DETECTOR_NAMES}")
