"""The extremely-randomized oblique forest, fitted on the card from a key.

Twin of the JAX package's ``models/classifiers.py`` ``ForestParams`` and
``make_forest`` (:313-446), batched over partitions: ``T`` complete trees
of depth ``d`` (``n = 2^d − 1`` nodes and ``2^d`` leaves each, heap
indexed), every node an oblique split — a Gaussian projection of all the
features against a threshold drawn as a random quantile of the batch's
projections — and every leaf its majority class. A fit, per partition,
from its fit key:

1. ``kp, kt = split(key)``;
2. ``proj = normal(kp, (F, T·n)) / √f32(F)`` — under ``jit`` XLA folds the
   division into the normal's factor, ``erf_inv(u) · f32(f32(√2) ·
   f32(1 / f32(√F)))`` (:func:`forest_factor`), which the port computes;
3. ``z = X @ proj``;
4. the ``idx``-th smallest of each column of ``z`` over the valid rows
   (invalid rows sort last as ``+inf``), ``idx = clip(int32(u · nv), 0, B
   − 1)`` with ``u = uniform(kt, (T·n,), 0.1, 0.9)`` and ``nv = max(Σw,
   1)`` — a stable sort of keys in which −0 equals +0 and NaN sorts last,
   as ``jnp.sort`` compares them — is the node's threshold;
5. each row walks each tree, ``node = 2·node + 1 + (z[node] > thresh[node])``
   ``d`` times, and adds its weight to its (tree, leaf, label) count;
6. a leaf with a positive count takes the first class of largest count,
   an empty one the batch's majority class (ties to the lowest class).

``predict`` walks each row the same way and takes the modal vote of the
trees (ties to the lowest class).

**The projection's order.** XLA's order for ``X @ proj`` is unknown
(ROADMAP C2), so the port fixes one: a row's projection onto a node is an
f32 chain over the features in order from +0, each product and each add
rounded on its own — never fused, never flushed. It is the same number in
the fit, in the fit's routing and in ``predict``, and the kernels equal
their plain versions bit for bit. Against JAX the projections, and so the
thresholds, agree to float32 rounding (ROADMAP C6); ``proj``, ``u`` and
``idx`` are JAX's bit for bit.

Two hand-written kernels carry the family on the card, each beside its
plain version: K11 ``forest_fit`` (``csrc/forest_fit.cu``: the normals
and uniforms from the key, the projections, the thresholds, the routing
and the leaf classes, one CTA a (partition, tree), the thresholds by a
radix select) and K12 ``forest_predict_err`` (``csrc/forest_predict_err.cu``:
persistent CTAs, rows gathered from the padded row table into registers,
two trees walked together computing only the visited projections, an
O(T) tally of the votes and the error indicator). Their layouts are a
function of the shapes (:func:`k11_plan`, :func:`k12_plan`)."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..utils import threefry
from .base import Model, ModelSpec, pad_row_table, row_stride
from .classifiers import _argmax_first
from .mlp import _keys


class ForestParams(NamedTuple):
    proj: torch.Tensor  # [P, F, T·n]: oblique node projections
    thresh: torch.Tensor  # [P, T·n]: node thresholds
    leaf_class: torch.Tensor  # [P, T, 2^d] i32: the class of each leaf


def check_shape(trees: int, depth: int) -> None:
    """The JAX package's validation of ``forest_trees`` and ``forest_depth``."""
    if trees < 1:
        raise ValueError(f"forest_trees must be >= 1, got {trees}")
    if not 1 <= depth <= 16:
        raise ValueError(
            f"forest_depth must be in [1, 16] (2^depth leaves per tree), "
            f"got {depth}"
        )


def forest_factor(f: int) -> float:
    """The float32 factor XLA's jitted fit multiplies ``erf_inv(u)`` by:
    ``normal / √f32(F)`` folded to ``f32(f32(√2) · f32(1 / f32(√F)))``."""
    inv = np.float32(1.0) / np.float32(np.sqrt(np.float32(f)))
    return float(np.float32(threefry.SQRT2) * inv)


def _dims(params: ForestParams) -> tuple[int, int, int, int]:
    """``(F, T, depth, n)`` of a forest's parameters."""
    f = params.proj.shape[1]
    t, leaves = params.leaf_class.shape[1:]
    depth = int(leaves).bit_length() - 1
    return f, t, depth, leaves - 1


def project(X: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """``z [P, N, M]`` of rows ``X [P, N, F]`` onto columns ``proj [P, F,
    M]``: per (row, column) an f32 chain over the features in order from
    +0, each product and each add rounded on its own (the port's order,
    module docstring)."""
    p, n, f = X.shape
    acc = torch.zeros((p, n, proj.shape[2]), dtype=torch.float32, device=X.device)
    for j in range(f):
        acc = acc + X[:, :, j, None] * proj[:, None, j, :]
    return acc


def sort_keys(v: torch.Tensor) -> torch.Tensor:
    """int32 keys whose order is ``jnp.sort``'s order of the float32 ``v``:
    −0 as +0, every NaN as +NaN after ``+inf``."""
    v = torch.where(v == 0, torch.zeros_like(v), v)
    v = torch.where(torch.isnan(v), torch.full_like(v, float("nan")), v)
    bits = v.view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _route(z: torch.Tensor, thresh: torch.Tensor, trees: int, depth: int) -> torch.Tensor:
    """Leaf ids ``[P, N, T]`` of rows with projections ``z [P, N, T·n]``."""
    p, nrows, _ = z.shape
    n = (1 << depth) - 1
    base = torch.arange(trees, device=z.device) * n
    node = torch.zeros((p, nrows, trees), dtype=torch.int64, device=z.device)
    th = thresh[:, None, :].expand(p, nrows, -1)
    for _ in range(depth):
        m = base + node
        node = 2 * node + 1 + (z.gather(2, m) > th.gather(2, m)).long()
    return node - n


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """``Σ x`` over the last axis, an f32 sum from +0 in index order."""
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def forest_draws(key, f: int, trees: int, depth: int, device=None):
    """The fit key's draws for every partition: ``proj [P, F, T·n]`` and
    the uniforms ``u [P, T·n]`` (plain; ``key [P, 2]`` uint32 words)."""
    key = _keys(key)
    if device is not None:
        key = key.to(device)
    tn = trees * ((1 << depth) - 1)
    kk = threefry.split(key, 2)  # [P, 2, 2]: kp, kt
    p = key.shape[0]
    proj = threefry.random_normal_reference(kk[:, 0], f * tn, forest_factor(f)).view(p, f, tn)
    u = threefry.uniform(kk[:, 1], (tn,), 0.1, 0.9)
    return proj, u


def forest_fit_reference(key, X, y, w, trees: int, depth: int, c: int) -> ForestParams:
    """Plain PyTorch version of :func:`forest_fit` (module docstring)."""
    X, w = X.float(), w.float()
    p, b, f = X.shape
    n = (1 << depth) - 1
    proj, u = forest_draws(key, f, trees, depth, X.device)
    z = project(X, proj)  # [P, B, T·n]
    zs = torch.where(w[..., None] > 0, z, torch.full_like(z, float("inf")))
    order = torch.sort(sort_keys(zs), dim=1, stable=True).indices
    nv = _seq_sum(w).clamp_min(1.0)
    idx = (u * nv[:, None]).to(torch.int32).clamp(0, b - 1).long()  # [P, T·n]
    thresh = zs.gather(1, order.gather(1, idx[:, None, :]))[:, 0]

    leaf = _route(z, thresh, trees, depth)  # [P, B, T]
    ok = (y >= 0) & (y < c)
    cls = torch.where(ok, y, 0).long()
    wv = torch.where(ok, w, 0.0)
    parts = torch.arange(p, device=X.device)[:, None]
    tree = torch.arange(trees, device=X.device)[None, :]
    counts = torch.zeros((p, trees, n + 1, c), dtype=torch.float32, device=X.device)
    batch = torch.zeros((p, c), dtype=torch.float32, device=X.device)
    for r in range(b):  # in row order
        counts[parts, tree, leaf[:, r], cls[:, r, None]] += wv[:, r, None]
        batch[parts[:, 0], cls[:, r]] += wv[:, r]
    major = _argmax_first(batch)  # [P]
    leaf_class = torch.where(counts.amax(-1) > 0, _argmax_first(counts), major[:, None, None])
    return ForestParams(proj, thresh, leaf_class.int())


def forest_predict_reference(params: ForestParams, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the predict: ``[P, N]`` i32."""
    _, trees, depth, _ = _dims(params)
    p, nrows, _ = X.shape
    out = torch.empty((p, nrows), dtype=torch.int32, device=X.device)
    # rows in chunks of 1,024, so z and its temporaries stay in cache (on
    # a CPU, 6x faster than chunks of 4,096 at the main path's shapes)
    for lo in range(0, nrows, 1024):
        Xc = X[:, lo:lo + 1024].float()
        leaf = _route(project(Xc, params.proj), params.thresh, trees, depth)
        votes = params.leaf_class.gather(2, leaf.transpose(1, 2)).transpose(1, 2)  # [P, n, T]
        count = sum((votes == votes[..., t, None]).long() for t in range(trees))
        # the modal vote, ties to the lowest class
        score = count * (1 << 32) - votes.long()
        out[:, lo:lo + 1024] = votes.gather(2, score.argmax(-1, keepdim=True))[..., 0]
    return out


def forest_predict_err_reference(params: ForestParams, T, Ty, idx):
    """Plain PyTorch version of :func:`forest_predict_err`: ``(err, pred)``."""
    i = idx.long()
    f = params.proj.shape[1]
    pred = forest_predict_reference(params, T[i, :f])
    return (pred != Ty[i]).float(), pred


def _check(name, t, dtypes, shape, device):
    if t.device != device or t.dtype not in dtypes or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {'/'.join(map(str, dtypes))} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def forest_fit_args(key, X, y, w, trees, depth, c, out: ForestParams, scratch, force=0):
    """Kernel K11's launch arguments, stream excluded, for checked CUDA
    inputs, preallocated outputs and its global workspace (``None`` when
    the layout has none, :func:`forest_fit_scratch`)."""
    p, b, f = X.shape
    return (key.data_ptr(), X.data_ptr(), y.data_ptr(), w.data_ptr(), p, b, f, c, trees,
            depth, forest_factor(f), force, out.proj.data_ptr(), out.thresh.data_ptr(),
            out.leaf_class.data_ptr(), None if scratch is None else scratch.data_ptr())


class K11Plan(NamedTuple):
    """K11's layout at a shape (``csrc/forest_fit.cu`` ``layout``)."""

    counters: bool  # leaf and batch counters in shared memory, else the row rule
    ids_global: bool  # the row rule's leaf ids and counts in the global workspace
    th_staged: bool  # the tree's thresholds in shared memory
    cols_staged: bool  # the tree's projection columns in shared memory
    x_staged: bool  # the batch's rows in shared memory
    z_global: bool  # a chunk's projections z in the global workspace
    chunk: int  # columns a round of the thresholds
    shared_bytes: int
    words: int  # floats of a partition's global workspace (0: none)


@functools.cache
def k11_plan(b: int, f: int, c: int, trees: int, depth: int, force: int = 0) -> K11Plan:
    """K11's layout from the kernel's own ``forest_fit_plan``, once per
    shape (it asks the card nothing)."""
    out = (ctypes.c_longlong * 9)()
    kernels.check("forest_fit_plan",
                  kernels.launcher("forest_fit_plan")(b, f, c, trees, depth, force, out))
    return K11Plan(*(bool(v) for v in out[:6]), *out[6:])


def forest_fit_scratch(p, b, f, c, trees, depth, device, force=0):
    """K11's global workspace ``[P, words]`` f32 (:func:`k11_plan`), or
    ``None`` when its layout has none."""
    words = k11_plan(b, f, c, trees, depth, force).words
    return None if words == 0 else torch.empty((p, words), dtype=torch.float32, device=device)


def forest_fit(key, X, y, w, trees: int, depth: int, c: int, force: int = 0) -> ForestParams:
    """The forest's fit of ``X [P, B, F]`` f32, labels ``y [P, B]`` and
    {0, 1} weights ``w [P, B]`` from the fit keys ``key [P, 2]``.

    CUDA tensors launch kernel K11 (``csrc/forest_fit.cu``) and add one to
    ``forest_fit.launches``; CPU tensors run :func:`forest_fit_reference`.
    ``force`` (tests) takes K11's row rule (1) or its global layout (2)."""
    check_shape(trees, depth)
    if X.device.type == "cpu":
        return forest_fit_reference(key, X, y, w, trees, depth, c)
    if X.device.type != "cuda":
        raise ValueError(f"forest_fit: unsupported device {X.device}")
    dev = X.device
    p, b, f = X.shape
    tn = trees * ((1 << depth) - 1)
    key = _keys(key).contiguous()
    X = X.float().contiguous()
    y = y.int().contiguous()
    w = w.float().contiguous()
    for name, t, shape in (("key", key, (p, 2)), ("y", y, (p, b)), ("w", w, (p, b))):
        _check(f"forest_fit: {name}", t, (t.dtype,), shape, dev)
    out = ForestParams(torch.empty((p, f, tn), dtype=torch.float32, device=dev),
                       torch.empty((p, tn), dtype=torch.float32, device=dev),
                       torch.empty((p, trees, tn // trees + 1), dtype=torch.int32, device=dev))
    if b == 0:
        raise ValueError("forest_fit: a batch needs at least one row")
    if p == 0:
        return out
    code = kernels.launcher("forest_fit")(
        *forest_fit_args(key, X, y, w, trees, depth, c, out,
                         forest_fit_scratch(p, b, f, c, trees, depth, dev, force), force),
        kernels.stream_handle(dev))
    kernels.check("forest_fit", code)
    forest_fit.launches += 1
    return out


forest_fit.launches = 0


class K12Plan(NamedTuple):
    """K12's plan at a shape on a card (``csrc/forest_predict_err.cu``
    ``full_plan``)."""

    regs: bool  # the row in registers (F <= 64, parameters in shared memory)
    rows_staged: bool  # the generic kernel's rows in shared memory
    params_staged: bool  # node-major projections, thresholds and leaf classes in shared memory
    tally_global: bool  # the counters (and kept votes) in the global workspace
    keep_votes: bool  # the counters cleared through the kept votes
    bits: int  # a counter's width
    ctas: int  # CTAs a partition
    threads: int
    shared_bytes: int
    words: int  # 32-bit words of the global workspace (0: none)
    counter_words: int  # a thread's counter words


@functools.cache
def k12_plan(device: torch.device, p: int, n: int, f: int, trees: int, depth: int,
             classes: int, force: int = 0) -> K12Plan:
    """K12's plan on ``device`` as the kernel works it out
    (``forest_predict_err_plan``: the card's SMs and occupancy), once per
    (device, shape, forced layout)."""
    out = (ctypes.c_longlong * 11)()
    with torch.cuda.device(device):
        kernels.check("forest_predict_err_plan", kernels.launcher("forest_predict_err_plan")(
            p, n, f, trees, depth, classes, force, out))
    return K12Plan(*(bool(v) for v in out[:5]), *out[5:])


def k12_workspace(p, n, f, trees, depth, classes, device, force=0) -> torch.Tensor | None:
    """K12's global workspace (:func:`k12_plan`'s words, i32), or ``None``
    when its tally sits in shared memory."""
    words = k12_plan(device, p, n, f, trees, depth, classes, force).words
    return None if words == 0 else torch.empty((words,), dtype=torch.int32, device=device)


def forest_predict_err_args(params: ForestParams, T, Ty, idx, classes, err, pred=None,
                            workspace=None, force=0):
    """Kernel K12's launch arguments, stream excluded, for checked CUDA
    inputs (``T`` padded by :func:`pad_row_table`), preallocated outputs
    and the tally's workspace (:func:`k12_workspace`)."""
    f, trees, depth, _ = _dims(params)
    return (T.data_ptr(), T.shape[1], Ty.data_ptr(), idx.data_ptr(), idx.element_size(),
            params.proj.data_ptr(), params.thresh.data_ptr(), params.leaf_class.data_ptr(),
            idx.shape[0], idx.shape[1], f, trees, depth, classes, force,
            None if workspace is None else workspace.data_ptr(),
            err.data_ptr(), None if pred is None else pred.data_ptr())


def forest_predict_err(params: ForestParams, T, Ty, idx, return_pred=False, classes=None,
                       force=0):
    """The forest's predict fused with the error indicator, over the rows
    ``T[idx]`` of the row table ``T`` — ``[R, F]`` or its padded copy
    ``[R, row_stride(F)]`` — with labels ``Ty [R]`` i32 and gather index
    ``idx [P, N]`` int16 or int32: ``err [P, N]`` f32 (and ``pred``).

    CUDA tensors launch kernel K12 (``csrc/forest_predict_err.cu``) and add
    one to ``forest_predict_err.launches``; they need ``classes``, the
    forest's C, and leaf classes in [0, C) (what a fit gives: the kernel
    tallies C classes). ``force`` (tests) takes one of K12's layouts (the
    kernel's ``kForce*`` bits). CPU tensors run
    :func:`forest_predict_err_reference`."""
    if idx.device.type == "cpu":
        err, pred = forest_predict_err_reference(params, T, Ty, idx)
        return (err, pred) if return_pred else err
    if idx.device.type != "cuda":
        raise ValueError(f"forest_predict_err: unsupported device {idx.device}")
    if classes is None or classes < 1:
        raise ValueError("forest_predict_err: the card's kernel needs the forest's classes")
    dev = idx.device
    f, trees, depth, n = _dims(params)
    if T.shape[1] == f:
        T = pad_row_table(T)
    p, nrows = idx.shape
    for name, t, dtypes, shape in (
            ("T", T, (torch.float32,), (T.shape[0], row_stride(f))),
            ("Ty", Ty, (torch.int32,), (T.shape[0],)),
            ("idx", idx, (torch.int16, torch.int32), (p, nrows)),
            ("proj", params.proj, (torch.float32,), (p, f, trees * n)),
            ("thresh", params.thresh, (torch.float32,), (p, trees * n)),
            ("leaf_class", params.leaf_class, (torch.int32,), (p, trees, n + 1))):
        _check(f"forest_predict_err: {name}", t, dtypes, shape, dev)
    err = torch.empty((p, nrows), dtype=torch.float32, device=dev)
    pred = torch.empty((p, nrows), dtype=torch.int32, device=dev) if return_pred else None
    if p and nrows:
        code = kernels.launcher("forest_predict_err")(
            *forest_predict_err_args(
                params, T, Ty, idx, classes, err, pred,
                k12_workspace(p, nrows, f, trees, depth, classes, dev, force), force),
            kernels.stream_handle(dev))
        kernels.check("forest_predict_err", code)
        forest_predict_err.launches += 1
    return (err, pred) if return_pred else err


forest_predict_err.launches = 0


def make_forest(spec: ModelSpec, *, trees: int = 32, depth: int = 3) -> Model:
    """The oblique forest of ``trees`` trees of depth ``depth``; its ``fit``
    takes the partitions' keys (``keyed``), its ``init`` gives zeros."""
    check_shape(trees, depth)
    f, c = spec.num_features, spec.num_classes
    n = (1 << depth) - 1

    def init(p, device="cpu", key=None):
        return ForestParams(
            torch.zeros((p, f, trees * n), dtype=torch.float32, device=device),
            torch.zeros((p, trees * n), dtype=torch.float32, device=device),
            torch.zeros((p, trees, n + 1), dtype=torch.int32, device=device),
        )

    def fit(X, y, w, key=None):
        if key is None:
            raise ValueError("the forest's fit draws its splits from a key [P, 2]")
        return forest_fit(key, X, y, w, trees, depth, c)

    def predict(params, X):
        return forest_predict_reference(params, X)

    def predict_err(params, T, Ty, idx):
        return forest_predict_err(params, T, Ty, idx, classes=c)

    return Model("forest", init, fit, predict, predict_err, keyed=True)

