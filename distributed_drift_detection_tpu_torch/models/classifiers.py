"""The deterministic-fit classifiers: majority, centroid, gnb, linear.

Twins of the JAX package's ``models/classifiers.py`` ``make_majority``
(:44-59), ``make_centroid`` (:67-104), ``make_gnb`` (:110-184) and
``make_linear`` (:187-240), batched over partitions. The centroid predict
fused with the error indicator is the hand-written CUDA kernel K2
(``csrc/centroid_predict_err.cu``), reached through
:func:`centroid_predict_err`; it gathers rows from the padded row table of
:func:`~.base.pad_row_table`. ``linear``'s score ``X·W + b`` has K2's form
``X·Cᵀ + bias`` with ``C = Wᵀ``, so its predict launches K2 too.

The centroid fit is bit-identical to the JAX package's jitted fit: a
float32 sum over the training rows in row order and a fused multiply-add
chain over the features for the bias (:func:`centroid_fit_reference`); on
the card it is the hand-written kernel K7 (``csrc/centroid_fit.cu``),
reached through :func:`centroid_fit`. ``gnb`` follows the JAX package's
float32 expressions the same way (class sums in row order, XLA's ``log``,
its fused variance), but XLA's order for the global mean and variance is
unknown, so they sum in row order and its parameters agree with the JAX
package's to float32 rounding, not to the bit; ``linear``'s 32 gradient
steps run in float64 and round once, for the same agreement (ROADMAP
Queue C). The predictions the tests compare are equal. ``gnb``'s predict
is two plain products, in float64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..ops.prefix import f32, fma, xla_log
from .base import Model, ModelSpec, pad_row_table, row_stride


def _argmax_first(scores: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (i32), as
    ``jnp.argmax``: a row of all ``-inf`` gives 0."""
    top = scores.amax(-1, keepdim=True)
    pos = torch.arange(scores.shape[-1], device=scores.device)
    hit = torch.where(scores == top, pos, torch.full_like(pos, scores.shape[-1]))
    return hit.amin(-1).clamp_max(scores.shape[-1] - 1).int()


# --------------------------------------------------------------------------
# majority-class
# --------------------------------------------------------------------------


def make_majority(spec: ModelSpec) -> Model:
    c = spec.num_classes

    def init(p, device="cpu", key=None):
        return torch.zeros(p, dtype=torch.int32, device=device)

    def fit(X, y, w, key=None):
        counts = torch.zeros(y.shape[0], c, dtype=torch.float32, device=y.device)
        counts.scatter_add_(1, y.long(), w)
        return _argmax_first(counts)  # ties: the lowest class

    def predict(params, X):
        return params[:, None].expand(X.shape[0], X.shape[1]).contiguous()

    def predict_err(params, T, Ty, idx):
        return (params[:, None] != Ty[idx.long()]).float()

    return Model("majority", init, fit, predict, predict_err)


# --------------------------------------------------------------------------
# nearest-centroid
# --------------------------------------------------------------------------


class CentroidParams(NamedTuple):
    centroids: torch.Tensor  # [P, C, F]
    bias: torch.Tensor  # [P, C]: -0.5‖c‖² for present classes, -inf for absent


def centroid_scores(params: CentroidParams, X: torch.Tensor) -> torch.Tensor:
    """``X [P, N, F] @ centroidsᵀ + bias`` → ``[P, N, C]`` (plain)."""
    return torch.bmm(X, params.centroids.transpose(1, 2)) + params.bias[:, None, :]


def centroid_predict_err_reference(centroids, bias, T, Ty, idx):
    """Plain PyTorch version of :func:`centroid_predict_err`."""
    i = idx.long()
    pred = _argmax_first(centroid_scores(CentroidParams(centroids, bias), T[i]))
    return (pred != Ty[i]).float(), pred


# Shared memory a block can use on an H100 (227 KB). K2 stages one
# partition's centroids and bias there — in chunks of classes when they do
# not fit — and, for F <= 32, its block's K2_BLOCK_ROWS rows with their
# indices and labels (csrc/centroid_predict_err.cu kBlockRows).
MAX_SHARED_BYTES = 232448
K2_BLOCK_ROWS = 256


def _k2_shared_bytes(c: int, f: int) -> int:
    """K2's shared memory with ``c`` classes staged at once."""
    fp = row_stride(f)
    return 4 * (c * fp + c) + (4 * K2_BLOCK_ROWS * (fp + 2) if f <= 32 else 0)


def _check_cuda(name, t, dtypes, shape, device):
    if t.device != device or t.dtype not in dtypes or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"centroid_predict_err: {name} must be {'/'.join(map(str, dtypes))} "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"centroid_predict_err: {name} must be contiguous")


def centroid_predict_err_args(centroids, bias, T, Ty, idx, err, pred=None):
    """Kernel K2's launch arguments, stream excluded, for checked CUDA
    inputs (``T`` padded by :func:`pad_row_table`) and preallocated
    outputs."""
    p, c, f = centroids.shape
    return (
        T.data_ptr(), T.shape[1], Ty.data_ptr(), idx.data_ptr(),
        idx.element_size(), centroids.data_ptr(), bias.data_ptr(),
        p, idx.shape[1], c, f,
        err.data_ptr(), None if pred is None else pred.data_ptr(),
    )


def centroid_predict_err(centroids, bias, T, Ty, idx, return_pred=False):
    """Nearest-centroid predict fused with the error indicator.

    ``centroids [P, C, F]`` and ``bias [P, C]`` f32 per partition, row table
    ``T`` f32 — ``[R, F]``, or its copy ``[R, row_stride(F)]`` from
    :func:`pad_row_table` (columns past F are not read) — with labels
    ``Ty [R]`` i32, gather index ``idx [P, N]`` int16 or int32. Returns
    ``err [P, N]`` f32 (and ``pred [P, N]`` i32 when ``return_pred``).
    CUDA tensors launch kernel K2 (``csrc/centroid_predict_err.cu``) and
    add one to ``centroid_predict_err.launches``; an unpadded ``T`` whose F
    is not a multiple of 4 is padded first (one copy a call). CPU tensors
    run the plain version.
    """
    f = centroids.shape[-1]
    if idx.device.type == "cpu":
        err, pred = centroid_predict_err_reference(centroids, bias, T[:, :f], Ty, idx)
        return (err, pred) if return_pred else err
    if idx.device.type != "cuda":
        raise ValueError(f"centroid_predict_err: unsupported device {idx.device}")
    dev = idx.device
    p, c, _ = centroids.shape
    n = idx.shape[1]
    if T.shape[1] == f:
        T = pad_row_table(T)
    _check_cuda("centroids", centroids, (torch.float32,), (p, c, f), dev)
    _check_cuda("bias", bias, (torch.float32,), (p, c), dev)
    _check_cuda("T", T, (torch.float32,), (T.shape[0], row_stride(f)), dev)
    _check_cuda("Ty", Ty, (torch.int32,), (T.shape[0],), dev)
    _check_cuda("idx", idx, (torch.int16, torch.int32), (p, n), dev)
    if T.data_ptr() % 16:
        raise ValueError("centroid_predict_err: T must start on a 16-byte boundary")
    smem = _k2_shared_bytes(1, f)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"centroid_predict_err: F={f} needs {smem} B of shared memory at "
            f"one class a chunk, over the card's {MAX_SHARED_BYTES}"
        )
    err = torch.empty((p, n), dtype=torch.float32, device=dev)
    pred = torch.empty((p, n), dtype=torch.int32, device=dev) if return_pred else None
    code = kernels.launcher("centroid_predict_err")(
        *centroid_predict_err_args(centroids, bias, T, Ty, idx, err, pred),
        kernels.stream_handle(dev),
    )
    kernels.check("centroid_predict_err", code)
    centroid_predict_err.launches += 1
    return (err, pred) if return_pred else err


centroid_predict_err.launches = 0


def _row_sums(X, y, w, c):
    """Per-class sums of the rows of ``X [P, B, F]`` (with their {0, 1}
    weights ``w``) and the per-class weight counts, each a float32 sum over
    the B rows in row order — the order of XLA's CPU ``onehot.T @ X`` at
    the batch sizes measured (ROADMAP Queue C, C1). A label outside [0, C)
    counts for no class, as in ``one_hot``. At B = 1 XLA's dot is the
    product ``onehot·w·x`` itself, with no +0 start, so a zero product
    keeps its sign."""
    p, b, f = X.shape
    if b == 1:
        oh = (torch.arange(c, device=X.device) == y[:, :1]).float() * w[:, :1].float()
        return oh[..., None] * X[:, 0, None, :], oh
    parts = torch.arange(p, device=X.device)
    ok = (y >= 0) & (y < c)
    cls = torch.where(ok, y, 0).long()
    wv = torch.where(ok, w, 0.0).float()
    sums = torch.zeros((p, c, f), dtype=torch.float32, device=X.device)
    counts = torch.zeros((p, c), dtype=torch.float32, device=X.device)
    for r in range(b):  # each product w·x is exact: 0 or x
        sums[parts, cls[:, r]] += wv[:, r, None] * X[:, r]
        counts[parts, cls[:, r]] += wv[:, r]
    return sums, counts


def _seq_sum(x, dim):
    """``Σ x`` along ``dim``, a float32 sum from 0 in index order (XLA's
    CPU reduce along the features; along the rows, the port's order)."""
    acc = torch.zeros_like(x.select(dim, 0), dtype=torch.float32)
    for t in x.unbind(dim):
        acc = acc + t
    return acc


def _log0(x):
    """XLA's float32 ``log`` of ``x >= 0`` (normal or zero), ``-inf`` at 0."""
    return torch.where(x == 0, float("-inf"), xla_log(torch.where(x == 0, 1.0, x)))


def _fma_sum(a, b):
    """``Σ_f a·b`` over the last axis as one fused multiply-add chain from
    0 in feature order (XLA's CPU reduce of a product)."""
    acc = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    for j in range(a.shape[-1]):
        acc = fma(a[..., j], b[..., j], acc)
    return acc


def centroid_fit_reference(X, y, w, c: int) -> CentroidParams:
    """Plain PyTorch version of :func:`centroid_fit` (float32, the JAX
    package's jitted ``make_centroid.fit`` bit for bit at per_batch <= 384
    on normal inputs)."""
    sums, counts = _row_sums(X, y, w, c)
    cent = sums / counts.clamp_min(1.0)[..., None]
    sq = -0.5 * _fma_sum(cent, cent)
    return CentroidParams(cent, torch.where(counts > 0, sq, float("-inf")))


def centroid_fit_args(X, y, w, cent, bias):
    """Kernel K7's launch arguments, stream excluded, for checked CUDA
    inputs and preallocated outputs."""
    p, b, f = X.shape
    return (X.data_ptr(), y.data_ptr(), w.data_ptr(), p, b, f, cent.shape[1],
            cent.data_ptr(), bias.data_ptr())


def _k7_shared_bytes(c: int, f: int) -> int:
    """K7's shared memory at its smallest row tile, one 32-row chunk, with
    ``c`` classes a chunk (csrc/centroid_fit.cu ``smem_words``): the row
    block feature-major with a row of ones, F + 1 rows of 32 + 4 words, the
    weights, the [c, F + 1] sums and counts, and a row bitmap word per
    class."""
    return 4 * ((f + 1) * 36 + 32 + c * (f + 1) + c)


def centroid_fit(X, y, w, c: int) -> CentroidParams:
    """The nearest-centroid fit of ``X [P, B, F]`` f32, labels ``y [P, B]``
    and {0, 1} weights ``w [P, B]``: per class the mean of its rows and
    ``-0.5‖mean‖²`` (``-inf`` for a class with no weighted row).

    CUDA tensors launch kernel K7 (``csrc/centroid_fit.cu``) and add one to
    ``centroid_fit.launches``; CPU tensors run
    :func:`centroid_fit_reference`. Both are the JAX package's jitted fit
    bit for bit (module docstring)."""
    if X.device.type == "cpu":
        return centroid_fit_reference(X, y, w, c)
    if X.device.type != "cuda":
        raise ValueError(f"centroid_fit: unsupported device {X.device}")
    dev = X.device
    p, b, f = X.shape
    X = X.float().contiguous()
    y = y.int().contiguous()
    w = w.float().contiguous()
    for name, t in (("y", y), ("w", w)):
        if t.device != dev or tuple(t.shape) != (p, b):
            raise ValueError(f"centroid_fit: {name} must be [{p}, {b}] on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if _k7_shared_bytes(1, f) > MAX_SHARED_BYTES:
        raise ValueError(
            f"centroid_fit: F={f} needs {_k7_shared_bytes(1, f)} B of shared "
            f"memory at one class a chunk, over the card's {MAX_SHARED_BYTES}"
        )
    cent = torch.empty((p, c, f), dtype=torch.float32, device=dev)
    bias = torch.empty((p, c), dtype=torch.float32, device=dev)
    code = kernels.launcher("centroid_fit")(
        *centroid_fit_args(X, y, w, cent, bias), kernels.stream_handle(dev)
    )
    kernels.check("centroid_fit", code)
    centroid_fit.launches += 1
    return CentroidParams(cent, bias)


centroid_fit.launches = 0


def make_centroid(spec: ModelSpec) -> Model:
    """Nearest-class-centroid classifier with a closed-form fit; classes
    absent from the training batch get a ``-inf`` score."""
    f, c = spec.num_features, spec.num_classes

    def init(p, device="cpu", key=None):
        bias = torch.full((p, c), float("-inf"), dtype=torch.float32, device=device)
        bias[:, 0] = 0.0
        return CentroidParams(
            torch.zeros((p, c, f), dtype=torch.float32, device=device), bias
        )

    def fit(X, y, w, key=None):
        return centroid_fit(X, y, w, c)

    def predict(params, X):
        return _argmax_first(centroid_scores(params, X))

    def predict_err(params, T, Ty, idx):
        return centroid_predict_err(params.centroids, params.bias, T, Ty, idx)

    return Model("centroid", init, fit, predict, predict_err)


# --------------------------------------------------------------------------
# Gaussian naive Bayes (closed form)
# --------------------------------------------------------------------------


class GNBParams(NamedTuple):
    """Prediction-ready form, as the JAX package's ``GNBParams``."""

    offset: torch.Tensor  # [P, F]: global feature mean the moments are centred on
    half_inv_var: torch.Tensor  # [P, C, F]: ½/σ² (smoothed)
    mean_inv_var: torch.Tensor  # [P, C, F]: μc/σ² (class means centred on offset)
    bias: torch.Tensor  # [P, C]: log prior − ½Σ log σ² − ½Σ μc²/σ² (−inf absent)


def gnb_scores(params: GNBParams, X: torch.Tensor) -> torch.Tensor:
    """``X [P, N, F]`` → ``[P, N, C]`` f64: −½Σ(x−μ)²/σ² + log prior −
    ½Σ log σ², as two products over the centred features."""
    Xc = X.double() - params.offset.double()[:, None]
    return (
        -torch.bmm(Xc * Xc, params.half_inv_var.double().transpose(1, 2))
        + torch.bmm(Xc, params.mean_inv_var.double().transpose(1, 2))
        + params.bias.double()[:, None]
    )


def make_gnb(spec: ModelSpec, *, var_smoothing: float = 1e-6) -> Model:
    """Gaussian naive Bayes with a closed-form fit; variances smoothed by
    ``var_smoothing ×`` the batch's largest feature variance; classes absent
    from the training batch score −inf."""
    f, c = spec.num_features, spec.num_classes

    def init(p, device="cpu", key=None):
        bias = torch.full((p, c), float("-inf"), dtype=torch.float32, device=device)
        bias[:, 0] = 0.0
        return GNBParams(
            torch.zeros((p, f), dtype=torch.float32, device=device),
            torch.full((p, c, f), 0.5, dtype=torch.float32, device=device),
            torch.zeros((p, c, f), dtype=torch.float32, device=device),
            bias,
        )

    def fit(X, y, w, key=None):
        # The JAX package's float32 expressions, with the one multiply-add
        # XLA fuses (the variance); XLA's order for the global mean and
        # variance is unknown (module docstring).
        X, w = X.float(), w.float()
        wsum = w.sum(1).clamp_min(1.0)[:, None]  # [P, 1], sums of {0, 1}: exact
        gmean = _seq_sum(X * w[..., None], 1) / wsum  # [P, F]
        Xc = X - gmean[:, None]
        sums, counts = _row_sums(Xc, y, w, c)  # [P, C, F], [P, C]
        denom = counts.clamp_min(1.0)[..., None]
        mean_c = sums / denom
        sq_c = _row_sums(Xc * Xc, y, w, c)[0] / denom
        gvar = _seq_sum(Xc * Xc * w[..., None], 1) / wsum
        eps = f32(var_smoothing) * gvar.amax(1).clamp_min(f32(1e-12))
        var = fma(-mean_c, mean_c, sq_c).clamp_min(0.0) + eps[:, None, None]
        inv_var = torch.ones_like(var) / var
        bias = (
            _log0(counts / wsum)
            - 0.5 * _seq_sum(_log0(var), -1)
            - 0.5 * _fma_sum(mean_c * mean_c, inv_var)
        )
        return GNBParams(gmean, 0.5 * inv_var, mean_c * inv_var, bias)

    def predict(params, X):
        return _argmax_first(gnb_scores(params, X))

    def predict_err(params, T, Ty, idx):
        i = idx.long()
        return (predict(params, T[i, :f]) != Ty[i]).float()

    return Model("gnb", init, fit, predict, predict_err)


# --------------------------------------------------------------------------
# linear (multinomial logistic regression)
# --------------------------------------------------------------------------


class LinearParams(NamedTuple):
    w: torch.Tensor  # [P, F, C]
    b: torch.Tensor  # [P, C]


def make_linear(spec: ModelSpec, *, fit_steps: int = 32, learning_rate: float = 0.5) -> Model:
    """Softmax regression fitted with ``fit_steps`` full-batch gradient
    steps from zero; predict is kernel K2's ``argmax(X·Cᵀ + bias)`` with
    ``C = Wᵀ``."""
    f, c = spec.num_features, spec.num_classes

    def init(p, device="cpu", key=None):
        return LinearParams(
            torch.zeros((p, f, c), dtype=torch.float32, device=device),
            torch.zeros((p, c), dtype=torch.float32, device=device),
        )

    def fit(X, y, w, key=None):
        X = X.double()
        onehot = torch.nn.functional.one_hot(y.long(), c).double()
        wn = (w.double() / w.double().sum(1, keepdim=True).clamp_min(1.0))[..., None]
        W = torch.zeros((X.shape[0], f, c), dtype=torch.float64, device=X.device)
        b = torch.zeros((X.shape[0], c), dtype=torch.float64, device=X.device)
        for _ in range(int(fit_steps)):
            logits = torch.bmm(X, W) + b[:, None]
            e = torch.exp(logits - logits.amax(-1, keepdim=True))
            g = (e / e.sum(-1, keepdim=True) - onehot) * wn  # [P, B, C]
            W = W - learning_rate * torch.bmm(X.transpose(1, 2), g)
            b = b - learning_rate * g.sum(1)
        return LinearParams(W.float(), b.float())

    def predict(params, X):
        return _argmax_first(torch.bmm(X, params.w) + params.b[:, None])

    def predict_err(params, T, Ty, idx):
        cent = params.w.transpose(1, 2).contiguous()
        return centroid_predict_err(cent, params.b, T, Ty, idx)

    return Model("linear", init, fit, predict, predict_err)


def build_model(name: str, spec: ModelSpec, cfg=None) -> Model:
    """Build a model by config name (``RunConfig.model``); ``cfg`` supplies
    ``fit_steps``, ``linear``'s ``learning_rate`` and ``mlp``'s
    ``mlp_hidden`` and ``mlp_learning_rate``."""
    if name == "majority":
        return make_majority(spec)
    if name == "centroid":
        return make_centroid(spec)
    if name == "gnb":
        return make_gnb(spec)
    if name == "linear":
        if cfg is None:
            return make_linear(spec)
        return make_linear(spec, fit_steps=cfg.fit_steps, learning_rate=cfg.learning_rate)
    if name == "mlp":
        from .mlp import make_mlp

        if cfg is None:
            return make_mlp(spec)
        return make_mlp(spec, hidden=tuple(cfg.mlp_hidden), fit_steps=cfg.fit_steps,
                        learning_rate=cfg.mlp_learning_rate)
    if name in ("forest", "rf"):
        item = {"forest": "A9b", "rf": "A9c"}[name]
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP {item}); the port runs "
            "majority, centroid, gnb, linear and mlp"
        )
    raise ValueError(
        f"unknown model {name!r}; expected majority|centroid|gnb|linear|mlp|forest|rf"
    )
