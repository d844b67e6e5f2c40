"""ctypes bindings of the port's hand-written CUDA kernels.

Each library is built by ``kernels._build`` on first use and loaded once.
A launch function takes raw device pointers (``tensor.data_ptr()``) and
PyTorch's current stream, launches, and returns a CUDA error code (that
of the launch call, or ``cudaGetLastError()``); :func:`check` turns a
nonzero code into an exception — a refused launch, such as K1's cluster
launch on a card without clusters, raises there. The checked,
counted wrappers that callers use live beside their plain PyTorch versions
(``ops/ddm.py`` ``ddm_window``, ``models/classifiers.py``
``centroid_predict_err`` and ``centroid_fit``, ``ops/detectors.py``
``ph_window``, ``hddm_w_window``, ``eddm_window``, ``hddm_window``,
``kswin_window`` and ``stepd_window``, ``ops/adwin.py`` ``adwin_window``,
``utils/threefry.py`` ``init_normals``, ``models/mlp.py`` ``mlp_fit``
and ``mlp_predict_err``, ``models/forest.py`` ``forest_fit`` and
``forest_predict_err``, ``engine/soak.py`` ``soak_batch``, ``ops/shuffle.py``
``shuffle_planes``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong

_SIGNATURES = {
    "ddm_window": (
        "ddm_window_launch",
        [_P, _P, _P, _P, _P, _P, _P,  # errs, live, 5 state leaves
         _I, _I, _I, _I, _I, _I,  # p, n, w, b, cluster size, min_num_instances
         _F, _F, _F, _I,  # warning, out-control, band floor, use floor
         _P, _P, _P, _P, _P, _P, _P,  # first warning/change, 5 end leaves
         _P],  # stream
    ),
    "centroid_predict_err": (
        "centroid_predict_err_launch",
        [_P, _I, _P, _P, _I, _P, _P,  # table, its row stride, labels, idx,
                                      # idx bytes, cent, bias
         _I, _I, _I, _I,  # p, n, c, f
         _P, _P, _P],  # err, pred, stream
    ),
    "centroid_fit": (
        "centroid_fit_launch",
        [_P, _P, _P,  # X, y, w
         _I, _I, _I, _I,  # p, b, f, c
         _P, _P, _P],  # cent, bias, stream
    ),
    # an empty kernel launched as K7 is (same grid, block and shared
    # memory), in K7's library: the floor under K7's time
    "centroid_fit_floor": (
        "centroid_fit_floor_launch",
        [_I, _I, _I, _I, _P],  # p, b, f, c, stream
        "centroid_fit",
    ),
    "ph_window": (
        "ph_window_launch",
        [_P, _P, _P, _P, _P,  # errs, live, 3 state leaves
         _I, _I, _I, _I, _I,  # p, w, b, CTAs a row (0: one CTA, global
                              # scratch), min_num_instances
         _F, _F, _F, _F,  # alpha, delta, threshold, warning threshold
         _P, _P, _P, _P, _P, _P,  # scratch, first warning/change, 3 end leaves
         _P],  # stream
    ),
    "hddm_w_window": (
        "hddm_w_window_launch",
        [_P, _P] + [_P] * 8  # errs, live, 8 state leaves
        + [_I, _I, _I, _I,  # p, w, b, CTAs a row (0: one CTA, global scratch)
           _F, _F, _F, _F, _F, _F,  # λ, 1−λ, (1−λ)², λ², ln(1/δ) drift, warning
           _P, _P, _P]  # scratch, first warning/change
        + [_P] * 8  # 8 end leaves
        + [_P],  # stream
    ),
    "eddm_window": (
        "eddm_window_launch",
        [_P, _P] + [_P] * 6  # errs, live, 6 state leaves
        + [_I, _I, _I, _I,  # p, w, b, CTAs a row (0: one CTA)
           _I, _I,  # paper_exact, min_num_errors
           _F, _F, _P, _P, _P]  # warning_alpha, change_beta, scratch (or null),
                                # first warning/change
        + [_P] * 6  # 6 end leaves
        + [_P],  # stream
    ),
    # whether K5-eddm's one-CTA path at (w, b) keeps its sums' tree in
    # shared memory on the current device (host int out)
    "eddm_window_tree_in_smem": (
        "eddm_window_tree_in_smem", [_I, _I, _P], "eddm_window",
    ),
    "hddm_window": (
        "hddm_window_launch",
        [_P, _P] + [_P] * 4  # errs, live, 4 state leaves
        + [_I, _I, _I, _I,  # p, w, b, CTAs a row (0: one CTA)
           _F, _F, _F,  # f32 ln(1/δ) of the drift confidence, ln(2/δ) of each bound's
           _P, _P]  # first warning/change
        + [_P] * 4  # 4 end leaves
        + [_P],  # stream
    ),
    # each zoo kernel's empty twin, launched as the kernel is at (p, w, b)
    # on its path (CTAs a row; the ring members' window_size, then CTAs a
    # row): the floor
    "eddm_window_floor": (
        "eddm_window_floor_launch", [_I, _I, _I, _I, _P], "eddm_window",
    ),
    "hddm_window_floor": (
        "hddm_window_floor_launch", [_I, _I, _I, _I, _P], "hddm_window",
    ),
    "kswin_window_floor": (
        "kswin_window_floor_launch", [_I, _I, _I, _I, _I, _P], "kswin_window",
    ),
    "stepd_window_floor": (
        "stepd_window_floor_launch", [_I, _I, _I, _I, _I, _P], "stepd_window",
    ),
    "kswin_window": (
        "kswin_window_launch",
        [_P, _P, _P, _P,  # errs, live, t, buf
         _I, _I, _I, _I,  # p, w, b, CTAs a row (0: one CTA)
         _I, _I,  # window_size, stat_size
         _F, _F, _F,  # f32(1/r), f32(1/(window_size − r)), the critical value
         _P, _P, _P, _P, _P,  # scratch (or null), first warning/change, end t, end buf
         _P],  # stream
    ),
    "stepd_window": (
        "stepd_window_launch",
        [_P, _P, _P, _P, _P,  # errs, live, t, total, buf
         _I, _I, _I, _I,  # p, w, b, CTAs a row (0: one CTA)
         _I,  # window_size
         _F, _F, _F,  # f32(1/window_size), the drift and warning critical values
         _P, _P, _P, _P, _P, _P,  # scratch (or null), first warning/change, 3 end leaves
         _P],  # stream
    ),
    # whether K5-kswin's or K5-stepd's one-CTA path at (w, b, window_size)
    # keeps its prefix row in shared memory on the current device (host
    # int out)
    "kswin_window_pre_in_smem": (
        "kswin_window_pre_in_smem", [_I, _I, _I, _P], "kswin_window",
    ),
    "stepd_window_pre_in_smem": (
        "stepd_window_pre_in_smem", [_I, _I, _I, _P], "stepd_window",
    ),
    "adwin_window": (
        "adwin_window_launch",
        [_P, _P] + [_P] * 6  # errs, live, 6 state leaves
        + [_I, _I, _I, _I, _I, _I, _I, _I,  # p, w, b, clock, max_buckets,
                                            # max_levels, min_window, min_side
           _F, _P, _P, _P]  # ln(2/δ), scratch, first warning/change
        + [_P] * 6  # 6 end leaves
        + [_P],  # stream
    ),
    "random_normal": (
        "init_normals_launch",
        [_P, _I, _I, _I,  # keys [P, 2], p, layers, the first layer's split counter
         _P, _P, _LL,  # host normal counts and factors [layers], zeros
         _P, _P],  # out, stream
    ),
    # each kernel's empty twin, launched as the kernel is (same grid,
    # block and shared memory), in its library: the floor under its time
    "random_normal_floor": (
        "init_normals_floor_launch", [_I, _I, _P, _LL, _P], "random_normal",
    ),
    "mlp_fit": (
        "mlp_fit_launch",
        [_P, _P, _P, _P,  # keys, X, y, w
         _I, _I, _I, _P, _P,  # p, b, layers, host widths [L + 1], host init factors [L]
         _I, _F, _F,  # steps, learning rate, momentum
         _P, _P,  # host arrays of the output w and b pointers
         _P, _P,  # the layers' device array past 64 layers, global workspace
         _I, _P],  # CTAs a partition (a cluster), stream
    ),
    "mlp_fit_floor": (
        "mlp_fit_floor_launch", [_I, _I, _I, _P, _I, _P], "mlp_fit",
    ),
    # K9 at a shape (rows, layers, host widths, CTAs a cluster, host int
    # out): the floats of one CTA's workspace; the card's most co-resident
    # clusters
    "mlp_fit_words": (
        "mlp_fit_words", [_I, _I, _P, _I, _P], "mlp_fit",
    ),
    "mlp_fit_max_clusters": (
        "mlp_fit_max_clusters", [_I, _I, _P, _I, _P], "mlp_fit",
    ),
    "mlp_predict_err": (
        "mlp_predict_err_launch",
        [_P, _I, _P, _P, _I,  # table, its row stride, labels, idx, idx bytes
         _I, _I, _I, _P,  # p, n, layers, host widths [L + 1]
         _P, _P,  # host arrays of the w and b pointers
         _P, _P,  # the layers' device array past 64 layers, global workspace
         _I, _I, _I, _I,  # the plan: rows a tile, threads, CTAs a partition,
                          # streamed weights (0: the plan's; -1 for stream)
         _P, _P, _P],  # err, pred, stream
    ),
    # K10's plan at a shape (p, n, layers, host widths, the four plan
    # fields as the launch takes them, host int out[11])
    "mlp_predict_err_plan": (
        "mlp_predict_err_plan", [_I, _I, _I, _P, _I, _I, _I, _I, _P], "mlp_predict_err",
    ),
    "mlp_predict_err_floor": (
        "mlp_predict_err_floor_launch", [_I, _I, _I, _P, _I, _I, _I, _I, _P],
        "mlp_predict_err",
    ),
    "forest_fit": (
        "forest_fit_launch",
        [_P, _P, _P, _P,  # keys, X, y, w
         _I, _I, _I, _I, _I, _I, _F, _I,  # p, b, f, c, trees, depth, the normals' factor, force
         _P, _P, _P, _P,  # proj, thresh, leaf_class, global workspace (or null)
         _P],  # stream
    ),
    "forest_fit_floor": (
        "forest_fit_floor_launch", [_I, _I, _I, _I, _I, _I, _P], "forest_fit",
    ),
    # K11's layout at a shape (rows, F, C, trees, depth, force, host int64
    # out[9]; the last the floats of a partition's global workspace)
    "forest_fit_plan": (
        "forest_fit_plan", [_I, _I, _I, _I, _I, _I, _P], "forest_fit",
    ),
    "forest_predict_err": (
        "forest_predict_err_launch",
        [_P, _I, _P, _P, _I,  # table, its row stride, labels, idx, idx bytes
         _P, _P, _P,  # proj, thresh, leaf_class
         _I, _I, _I, _I, _I, _I, _I,  # p, n, f, trees, depth, classes, force
         _P, _P, _P, _P],  # the tally's global workspace (or null), err, pred, stream
    ),
    "forest_predict_err_floor": (
        "forest_predict_err_floor_launch", [_I, _I, _I, _I, _I, _I, _P], "forest_predict_err",
    ),
    "soak_batch": (
        "soak_batch_launch",
        [_P, _P, _P,  # keys [P, 2], row offsets [P], concept offsets [P]
         _I, _I, _I, _I,  # p, count, b, f (the generated width)
         _I, _I, _I, _I, _I,  # t0, last, drift_every, generator id, classes
         _F, _F, _I, _F,  # the noise's and the prototypes' normal factors,
                          # rotation period (0: none), its phase scale
         _I,  # concepts a tile stages (engine/soak.py k6_plan; 0: none)
         _P, _P, _P,  # table, labels, rows
         _P],  # stream
    ),
    "soak_batch_floor": (
        "soak_batch_floor_launch", [_I, _I, _I, _P], "soak_batch",
    ),
    "shuffle_perm": (
        "shuffle_perm_launch",
        [_P, _I, _I, _I,  # keys, derive, p, width
         _P, _I, _P, _P, _P,  # idx, its bytes, rows, valid, start (or null)
         _I, _I, _I, ctypes.c_uint, _I,  # source batches, b, rounds, tie mask, force
         _P, _P, _P, _P,  # out idx, rows, valid, global scratch (or null)
         _P],  # stream
    ),
    "shuffle_perm_floor": (
        "shuffle_perm_floor_launch", [_I, _I, _I, _I, _P], "shuffle_perm",
    ),
    # K13's layout for batches of b places (b, force, host int out[6]: path,
    # network width, composites a thread, threads a CTA, batches a CTA,
    # dynamic shared bytes)
    "shuffle_perm_path": (
        "shuffle_perm_path", [_I, _I, _P], "shuffle_perm",
    ),
    # K12's plan at a shape on the current device (p, n, F, trees, depth,
    # classes, force, host int64 out[11]; out[9] the words of the global
    # workspace, 0 when the tally sits in shared memory)
    "forest_predict_err_plan": (
        "forest_predict_err_plan", [_I, _I, _I, _I, _I, _I, _I, _P], "forest_predict_err",
    ),
}


@functools.cache
def launcher(name: str):
    """The C launch function of kernel ``name`` (built and loaded once)."""
    from ._build import build

    symbol, argtypes, *library = _SIGNATURES[name]
    lib = ctypes.CDLL(str(build(library[0] if library else name)))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as an integer handle.

    Read as PyTorch's own generated kernel launchers read it
    (``_cuda_getCurrentRawStream``), without building a ``torch.cuda.Stream``
    object on every call."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaGetLastError() = {code}"
        )
