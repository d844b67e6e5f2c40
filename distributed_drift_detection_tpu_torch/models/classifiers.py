"""The deterministic-fit classifiers of the main path: majority, centroid.

Twins of the JAX package's ``models/classifiers.py`` ``make_majority``
(:44-59) and ``make_centroid`` (:67-104), batched over partitions. The
centroid predict fused with the error indicator is the hand-written CUDA
kernel K2 (``csrc/centroid_predict_err.cu``), reached through
:func:`centroid_predict_err`.

The fits stay plain PyTorch, as the JAX package left them to XLA. The
centroid fit's segment sums are taken in float64 and rounded once to f32:
sums of at most B f32 values are exact there for realistic data, so the
CPU and the card give the same centroids whatever order their reductions
use.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from .base import Model, ModelSpec


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

    def init(p, device="cpu"):
        return torch.zeros(p, dtype=torch.int32, device=device)

    def fit(X, y, w):
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


def _check_cuda(name, t, dtypes, shape, device):
    if t.device != device or t.dtype not in dtypes or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"centroid_predict_err: {name} must be {'/'.join(map(str, dtypes))} "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"centroid_predict_err: {name} must be contiguous")


def centroid_predict_err(centroids, bias, T, Ty, idx, return_pred=False):
    """Nearest-centroid predict fused with the error indicator.

    ``centroids [P, C, F]`` and ``bias [P, C]`` f32 per partition, row table
    ``T [R, F]`` f32 with labels ``Ty [R]`` i32, gather index ``idx [P, N]``
    int16 or int32. Returns ``err [P, N]`` f32 (and ``pred [P, N]`` i32 when
    ``return_pred``). CUDA tensors launch kernel K2
    (``csrc/centroid_predict_err.cu``) and add one to
    ``centroid_predict_err.launches``; CPU tensors run the plain version.
    """
    if idx.device.type == "cpu":
        err, pred = centroid_predict_err_reference(centroids, bias, T, Ty, idx)
        return (err, pred) if return_pred else err
    if idx.device.type != "cuda":
        raise ValueError(f"centroid_predict_err: unsupported device {idx.device}")
    dev = idx.device
    p, c, f = centroids.shape
    n = idx.shape[1]
    _check_cuda("centroids", centroids, (torch.float32,), (p, c, f), dev)
    _check_cuda("bias", bias, (torch.float32,), (p, c), dev)
    _check_cuda("T", T, (torch.float32,), (T.shape[0], f), dev)
    _check_cuda("Ty", Ty, (torch.int32,), (T.shape[0],), dev)
    _check_cuda("idx", idx, (torch.int16, torch.int32), (p, n), dev)
    smem = 4 * (c * f + c + f * 128)  # csrc/centroid_predict_err.cu kThreads
    if smem > 48 * 1024:
        raise ValueError(
            f"centroid_predict_err: C={c}, F={f} need {smem} B of shared "
            "memory, over the kernel's 48 KB"
        )
    err = torch.empty((p, n), dtype=torch.float32, device=dev)
    pred = torch.empty((p, n), dtype=torch.int32, device=dev) if return_pred else None
    code = kernels.launcher("centroid_predict_err")(
        T.data_ptr(), Ty.data_ptr(), idx.data_ptr(), idx.element_size(),
        centroids.data_ptr(), bias.data_ptr(), p, n, c, f,
        err.data_ptr(), pred.data_ptr() if return_pred else None,
        kernels.stream_handle(dev),
    )
    kernels.check("centroid_predict_err", code)
    centroid_predict_err.launches += 1
    return (err, pred) if return_pred else err


centroid_predict_err.launches = 0


def make_centroid(spec: ModelSpec) -> Model:
    """Nearest-class-centroid classifier with a closed-form fit; classes
    absent from the training batch get a ``-inf`` score."""
    f, c = spec.num_features, spec.num_classes

    def init(p, device="cpu"):
        bias = torch.full((p, c), float("-inf"), dtype=torch.float32, device=device)
        bias[:, 0] = 0.0
        return CentroidParams(
            torch.zeros((p, c, f), dtype=torch.float32, device=device), bias
        )

    def fit(X, y, w):
        onehot = torch.nn.functional.one_hot(y.long(), c).float() * w[..., None]
        counts = onehot.sum(1)  # [P, C], sums of {0, 1}: exact
        sums = torch.bmm(onehot.double().transpose(1, 2), X.double()).float()
        cent = sums / counts.clamp_min(1.0)[..., None]
        sq = (-0.5 * (cent.double() ** 2).sum(-1)).float()
        bias = torch.where(counts > 0, sq, torch.full_like(sq, float("-inf")))
        return CentroidParams(cent, bias)

    def predict(params, X):
        return _argmax_first(centroid_scores(params, X))

    def predict_err(params, T, Ty, idx):
        return centroid_predict_err(params.centroids, params.bias, T, Ty, idx)

    return Model("centroid", init, fit, predict, predict_err)


def build_model(name: str, spec: ModelSpec, cfg=None) -> Model:
    """Build a model by config name (``RunConfig.model``)."""
    if name == "majority":
        return make_majority(spec)
    if name == "centroid":
        return make_centroid(spec)
    raise NotImplementedError(
        f"model {name!r} is not ported yet (ROADMAP A4 for gnb/linear, A9 "
        "for mlp/forest/rf); the port runs majority and centroid"
    )
