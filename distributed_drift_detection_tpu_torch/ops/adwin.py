"""ADWIN: adaptive-windowing drift detection (Bifet & Gavaldà 2007).

The port's twin of the JAX package's ``ops/adwin.py``: an exponential
histogram whose level-k buckets span ``clock·2^k`` elements, a completed
``clock``-element chunk flushed as a new level-0 bucket (insert → cascade
→ cut test over every bucket boundary), change reported at chunk-completing
elements, the histogram forgetting its oldest bucket at capacity. Inputs
are 0/1 error indicators, so every sum is an exact int32; the cut bound

    ε_cut = sqrt((2/m)·p(1−p)·ln(2/δ′)) + (2/(3m))·ln(2/δ′),
    1/m = 1/n₀ + 1/n₁,   δ′ = δ/n

is the one float32 expression. See the JAX package's module docstring for
the restructuring and its invariants.

:func:`adwin_window` launches the hand-written kernel K5-adwin
(``csrc/adwin_window.cu``) on a CUDA tensor and runs the plain version
(:func:`adwin_window_reference`) on a CPU tensor.

``ln n`` is XLA's float32 log on the CPU, operation for operation
(``ops.prefix.xla_log``; in the kernel, ``xla_logf``). It is not
correctly rounded — it differs from the correctly rounded value for about
0.6 % of the integers below 2^24 — so the port computes the same
polynomial with the same fused multiply-adds, and agrees with the JAX
package bit for bit on every n below 2^24 (``tests/test_torch_detectors.py``
checks those below 2^22).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from ..config import ADWINParams
from .ddm import DDMWindowResult, batch_from_window, check_window_inputs, launch_window
from .detectors import _window
from .prefix import f32, fma, rdiv, sqrt, xla_log

# --- opt-in indicator debug guard -------------------------------------------
#
# The exact-int32 sums truncate real-valued errors toward 0. With the guard
# on (DDD_DEBUG_INDICATORS=1, or set_debug_indicator_checks(True)) every
# window call copies its inputs to the host and raises on a valid element
# that is not 0 or 1 — a debug tool: the copy synchronizes the card.

_DEBUG_ENV = "DDD_DEBUG_INDICATORS"
_debug_indicators: bool | None = None  # None = defer to the env var


def set_debug_indicator_checks(enabled: bool | None) -> None:
    """Force the 0/1-indicator guard on/off; ``None`` defers to the
    ``DDD_DEBUG_INDICATORS`` env var (the default)."""
    global _debug_indicators
    _debug_indicators = enabled


def _indicator_checks_enabled() -> bool:
    if _debug_indicators is not None:
        return _debug_indicators
    return os.environ.get(_DEBUG_ENV, "").strip().lower() not in (
        "", "0", "false", "off", "no",
    )


def _maybe_check_indicator(errs, valid=None) -> None:
    if not _indicator_checks_enabled():
        return
    e = errs.detach().cpu().numpy()
    v = np.ones(e.shape, bool) if valid is None else valid.detach().cpu().numpy().astype(bool)
    bad = v & ~((e == 0) | (e == 1))
    if bad.any():
        vals = np.unique(e[bad])[:5]
        raise ValueError(
            f"ADWIN received non-indicator error values {vals.tolist()} — the "
            "kernel's exact-int32 sums require 0/1 indicators; real-valued "
            "errors would be silently truncated to 0 by the int32 cast"
        )


class ADWINState(NamedTuple):
    """Carried ADWIN state, leaves with the batch shape ``[P]`` first."""

    t: torch.Tensor  # i32: elements absorbed since reset
    pend_sum: torch.Tensor  # i32: sum of the current partial chunk
    n: torch.Tensor  # i32: elements represented in the bucketed window
    total: torch.Tensor  # i32: their sum
    sums: torch.Tensor  # i32 [..., L, C]: bucket sums, oldest-first per level
    counts: torch.Tensor  # i32 [..., L]: live buckets per level


def adwin_init(params: ADWINParams = ADWINParams(), shape=(), device="cpu") -> ADWINState:
    L, C = int(params.max_levels), int(params.max_buckets) + 1

    def z(*s):
        return torch.zeros((*shape, *s), dtype=torch.int32, device=device)

    return ADWINState(z(), z(), z(), z(), z(L, C), z(L))


def _validate_adwin(params: ADWINParams) -> None:
    if not 0.0 < float(params.delta) < 1.0:
        raise ValueError(f"ADWINParams.delta must be in (0, 1), got {params.delta}")
    if int(params.clock) < 1:
        raise ValueError(f"ADWINParams.clock must be >= 1, got {params.clock}")
    if int(params.max_buckets) < 2:
        raise ValueError(f"ADWINParams.max_buckets must be >= 2, got {params.max_buckets}")
    if not 1 <= int(params.max_levels) <= 30:
        raise ValueError(
            "ADWINParams.max_levels must be in [1, 30] (2^k bucket sizes in "
            f"int32), got {params.max_levels}"
        )
    capacity = int(params.max_buckets) * int(params.clock) * ((1 << int(params.max_levels)) - 1)
    if capacity > 2**31 - 1:
        raise ValueError(
            "ADWINParams window capacity max_buckets*clock*(2^max_levels - 1)"
            f" = {capacity} overflows the int32 n counter; shrink max_levels,"
            " max_buckets or clock"
        )
    if int(params.min_side) < 1 or int(params.min_window) < 2 * int(params.min_side):
        raise ValueError(
            "ADWINParams needs min_side >= 1 and min_window >= 2*min_side, "
            f"got min_window={params.min_window}, min_side={params.min_side}"
        )


# ln n for n below 2^20 (4 MB a device), built once from `xla_log`: the
# plain version takes ln n once a flush, and xla_log is some 170 small
# tensor operations.
_LOG_TABLE_N = 1 << 20
_log_tables: dict = {}


def log_n(n: torch.Tensor) -> torch.Tensor:
    """``ln(f32(max(n, 1)))`` as XLA computes it (``prefix.xla_log``)."""
    n = n.clamp_min(1)
    table = _log_tables.get(n.device)
    if table is None:
        table = xla_log(torch.arange(_LOG_TABLE_N, device=n.device).clamp_min(1).float())
        _log_tables[n.device] = table
    small = n < _LOG_TABLE_N
    got = table[torch.where(small, n, 0).long()]
    return got if bool(small.all()) else torch.where(small, got, xla_log(n.float()))


def _flush_chunk(sums, counts, n, total, chunk_sum, live, params: ADWINParams):
    """Insert one completed chunk bucket per partition where ``live``,
    cascade the histogram, and run the cut test: ``(sums, counts, n,
    total, fired)``, every input with a leading ``[P]``. A partition that
    is not live is left as it was and does not fire.

    The cascade is the JAX package's closed form: a flush merges along the
    contiguous chain of full levels from level 0, so level k receives a
    bucket iff every level below it is full; each receiving level drops
    its two oldest slots when full (the top level drops one: capacity
    forgetting) and appends the received bucket — level 0 the chunk, level
    k+1 level k's two oldest merged."""
    L, M = int(params.max_levels), int(params.max_buckets)
    C = M + 1
    clock = int(params.clock)
    dev = sums.device
    live_i = live.int()
    full = (counts == M).int()  # [P, L]
    chain = torch.cat([torch.ones_like(full[:, :1]), torch.cumprod(full, 1, dtype=torch.int32)], 1)[:, :L]
    received = live_i[:, None] * chain
    ovf = received * full
    top_ovf = ovf[:, L - 1]
    shift = torch.cat([2 * ovf[:, : L - 1], ovf[:, L - 1:]], 1)
    col = torch.arange(C, dtype=torch.int32, device=dev)
    src = col + shift[..., None]  # [P, L, C]
    base = torch.gather(sums, 2, src.clamp_max(C - 1).long())
    base = torch.where(src < C, base, 0)
    merged = sums[..., 0] + sums[..., 1]
    val = torch.cat([chunk_sum[:, None].int(), merged[:, :-1]], 1)
    app = (received[..., None] > 0) & (col == (counts - shift)[..., None])
    new_sums = torch.where(app, val[..., None], base)
    new_counts = counts + received - shift
    n = n + live_i * clock - top_ovf * (clock << (L - 1))
    total = total + live_i * chunk_sum.int() - top_ovf * sums[:, L - 1, 0]

    # cut test at every bucket boundary, oldest → newest (highest level
    # first, slot 0 first within a level)
    sizes = clock << torch.arange(L - 1, -1, -1, dtype=torch.int32, device=dev)
    slot_ok = col < new_counts.flip(1)[..., None]  # [P, L, C]
    n0 = torch.cumsum(torch.where(slot_ok, sizes[:, None], 0).flatten(1), 1, dtype=torch.int32)
    s0 = torch.cumsum(torch.where(slot_ok, new_sums.flip(1), 0).flatten(1), 1, dtype=torch.int32)
    n1 = n[:, None] - n0
    s1 = total[:, None] - s0
    n0f = n0.clamp_min(1).float()
    n1f = n1.clamp_min(1).float()
    mu0 = s0.float() / n0f
    mu1 = s1.float() / n1f
    p = total.float() / n.clamp_min(1).float()
    var_w = (p * (1.0 - p))[:, None]
    lg = (f32(math.log(2.0 / float(params.delta))) + log_n(n))[:, None]
    inv_m = rdiv(1.0, n0f) + rdiv(1.0, n1f)
    eps_cut = fma(f32(2.0 / 3.0) * inv_m, lg, sqrt(2.0 * inv_m * var_w * lg))
    testable = slot_ok.flatten(1) & (n0 >= params.min_side) & (n1 >= params.min_side)
    viol = testable & ((mu0 - mu1).abs() >= eps_cut)
    fired = live & (n >= params.min_window) & viol.any(1)
    return new_sums, new_counts, n, total, fired


def adwin_step(state: ADWINState, err, params: ADWINParams = ADWINParams()):
    """One element per partition (``err`` ``[P]``, 0/1): buffer it into
    the pending chunk; on the ``clock``-th, flush. ``warning`` is always
    False; ``change`` can be True only at chunk-completing elements."""
    _validate_adwin(params)
    _maybe_check_indicator(err)
    t = state.t + 1
    ps = state.pend_sum + err.int()
    flush = t % int(params.clock) == 0
    sums, counts, n, total, fired = _flush_chunk(
        state.sums, state.counts, state.n, state.total, ps, flush, params
    )
    return ADWINState(t, torch.where(flush, 0, ps), n, total, sums, counts), (
        torch.zeros_like(fired), fired,
    )


def _adwin_masks(state: ADWINState, errs, valid, params: ADWINParams):
    """Flat ``[P, N]`` pass: chunk sums by segment sum, then the
    sequential chunk scan (to the longest row's last completed chunk;
    later chunks are the identity), then each chunk's verdict at the
    element that completes it."""
    _validate_adwin(params)
    v = valid.bool()
    _maybe_check_indicator(errs, v)
    clock = int(params.clock)
    p, n_el = errs.shape
    nc = n_el // clock + 1
    ev = errs.int() * v.int()
    vcnt = torch.cumsum(v.int(), 1, dtype=torch.int32)
    t = state.t[:, None] + vcnt
    n_flush = (state.t % clock + vcnt[:, -1]) // clock
    base = (state.t // clock)[:, None]
    sid = torch.where(v, (t - 1) // clock - base, nc).long()
    chunk_sums = torch.zeros((p, nc + 1), dtype=torch.int32, device=errs.device)
    chunk_sums.scatter_add_(1, sid, ev)
    chunk_sums = chunk_sums[:, :nc]
    chunk_sums[:, 0] += state.pend_sum

    sums, counts, n, total = state.sums, state.counts, state.n, state.total
    fired = torch.zeros((p, nc), dtype=torch.bool, device=errs.device)
    for j in range(int(n_flush.max()) if p else 0):
        sums, counts, n, total, fired[:, j] = _flush_chunk(
            sums, counts, n, total, chunk_sums[:, j], j < n_flush, params
        )

    cid = (t // clock - base - 1).clamp(0, nc - 1).long()
    change = v & (t % clock == 0) & torch.gather(fired, 1, cid)
    flushed = torch.gather(
        torch.cumsum(chunk_sums, 1, dtype=torch.int32), 1, (n_flush - 1).clamp_min(0).long()[:, None]
    )[:, 0]
    all_sum = state.pend_sum + ev.sum(1, dtype=torch.int32)
    end = ADWINState(
        state.t + vcnt[:, -1],
        all_sum - torch.where(n_flush > 0, flushed, 0),
        n, total, sums, counts,
    )
    return end, torch.zeros_like(change), change


def adwin_window_reference(state: ADWINState, errs, valid, params: ADWINParams = ADWINParams()):
    """Plain PyTorch version of :func:`adwin_window`."""
    return _window(lambda s, e, v: _adwin_masks(s, e, v, params), state, errs, valid)


def adwin_scratch(p: int, n: int, params: ADWINParams, device) -> torch.Tensor:
    """Kernel K5-adwin's global scratch: per row and chunk, its sum (then
    its verdict) and the flush's ``ln n`` term — the chunk table, used
    only where it does not fit in shared memory beside the flush ring or
    the histogram."""
    nc = n // int(params.clock) + 1
    return torch.empty((p, 2 * nc), dtype=torch.int32, device=device)


def adwin_window_args(state, errs, valid, params, first_warning, first_change, end, scratch):
    """Kernel K5-adwin's launch arguments, stream excluded."""
    p, w, b = errs.shape
    return (
        errs.data_ptr(), valid.data_ptr(), *(leaf.data_ptr() for leaf in state),
        p, w, b, int(params.clock), int(params.max_buckets), int(params.max_levels),
        int(params.min_window), int(params.min_side),
        f32(math.log(2.0 / float(params.delta))), scratch.data_ptr(),
        first_warning.data_ptr(), first_change.data_ptr(),
        *(leaf.data_ptr() for leaf in end),
    )


def adwin_window(state: ADWINState, errs, valid, params: ADWINParams = ADWINParams()):
    """The ADWIN window statistic (contract of :func:`.ddm.ddm_window`).

    CUDA tensors launch kernel K5-adwin (``csrc/adwin_window.cu``, one CTA
    per partition; a level's slots in registers when ``max_buckets + 1 <=
    8``, else in shared memory, the launcher choosing from ``params``) and
    add one to ``adwin_window.launches``; a refused launch raises. CPU
    tensors run the plain version."""
    if errs.device.type == "cpu":
        return adwin_window_reference(state, errs, valid, params)
    if errs.device.type != "cuda":
        raise ValueError(f"adwin_window: unsupported device {errs.device}")
    _validate_adwin(params)
    _maybe_check_indicator(errs, valid)
    check_window_inputs("adwin_window", state, errs, valid,
                        dict.fromkeys(ADWINState._fields, torch.int32))
    L, C = int(params.max_levels), int(params.max_buckets) + 1
    if tuple(state.sums.shape[1:]) != (L, C) or tuple(state.counts.shape[1:]) != (L,):
        raise ValueError(f"adwin_window: state histogram must be [P, {L}, {C}]")
    dev = errs.device
    p, w, b = errs.shape
    fw = torch.empty((p, w), dtype=torch.int32, device=dev)
    fc = torch.empty_like(fw)
    end = ADWINState(*(torch.empty_like(leaf) for leaf in state))
    scratch = adwin_scratch(p, w * b, params, dev)
    launch_window(
        "adwin_window", adwin_window_args(state, errs, valid, params, fw, fc, end, scratch), dev
    )
    adwin_window.launches += 1
    return end, DDMWindowResult(fw, fc)


adwin_window.launches = 0


def adwin_batch(state: ADWINState, errs, valid, params: ADWINParams = ADWINParams()):
    return batch_from_window(lambda s, e, v: adwin_window(s, e, v, params))(state, errs, valid)
