"""The reference's RandomForest, fitted and run on the host.

The port's twin of the JAX package's ``models/rf.py``. The reference's
classifier is ``sklearn.RandomForestClassifier(n_jobs=CORES)`` fitted fresh
on every retrain (``DDM_Process.py:96-105``); this family runs it through
the port's engines for parity experiments, as the JAX package's does
through ``jax.pure_callback``:

* ``fit`` stays on the device: it snapshots the training microbatch ``(X,
  y, w)`` and a seed drawn from the fit key, ``randint(key, (), 0, 2^31 −
  1)`` bit for bit (``utils/threefry.py``), into :class:`RFParams`;
* ``predict_err`` copies the snapshot and the query rows to the host, once
  for the whole ``[P, N]`` window, and fits or reuses one forest per
  partition — one sklearn model per Spark group — through a
  content-addressed LRU (:class:`_ForestCache`, keyed on the snapshot's
  bytes, the seed and ``n_estimators``), so a forest is fitted once per
  concept, as the reference's ``retrain`` flag fits it. The predictions
  depend only on the snapshot and the seed, never on the cache's state.
  They return to the device as int32, and the error indicator is ``pred !=
  y`` as for every family.

scikit-learn is imported when an ``rf`` model is built, and only then; the
card's machine has none, and there ``rf`` raises :class:`ImportError`
before any work. No kernel is involved: the detector's kernel runs on the
errors as for every family.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..utils import threefry
from .base import Model, ModelSpec

_SEED_MAX = 2**31 - 1


class RFParams(NamedTuple):
    """The training snapshot of every partition."""

    X: torch.Tensor  # [P, B, F] f32
    y: torch.Tensor  # [P, B] i32
    w: torch.Tensor  # [P, B] f32 row validity
    seed: torch.Tensor  # [P] i32, the forest's random_state


def require_sklearn():
    """``sklearn.ensemble.RandomForestClassifier``, or :class:`ImportError`
    naming scikit-learn when it cannot be imported."""
    try:
        from sklearn.ensemble import RandomForestClassifier
    except ImportError as e:
        raise ImportError(
            "model 'rf' is the reference's host RandomForest "
            "(sklearn.ensemble.RandomForestClassifier) and needs scikit-learn, "
            "which cannot be imported here; pick an on-device model "
            "(centroid, gnb, linear, mlp, forest) instead"
        ) from e
    return RandomForestClassifier


class _ForestCache:
    """Content-addressed LRU of fitted forests (host side)."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._store: OrderedDict[bytes, object] = OrderedDict()

    def get_or_fit(self, X, y, w, seed, n_estimators, n_jobs):
        key = (
            X.tobytes()
            + y.tobytes()
            + w.tobytes()
            + np.int64(seed).tobytes()
            + np.int64(n_estimators).tobytes()
        )
        if key in self._store:
            self._store.move_to_end(key)
            return self._store[key]
        mask = w > 0
        forest = None  # nothing to fit on: predict falls back to class 0
        if mask.any():
            forest = require_sklearn()(
                n_estimators=n_estimators,
                n_jobs=n_jobs or None,
                random_state=int(seed) & 0x7FFFFFFF,
            )
            forest.fit(X[mask], y[mask])
        self._store[key] = forest
        if len(self._store) > self.capacity:
            self._store.popitem(last=False)
        return forest


def make_rf(
    spec: ModelSpec,
    batch_size: int,
    *,
    n_estimators: int = 100,
    n_jobs: int = 0,
    cache_size: int = 64,
) -> Model:
    """The reference's RandomForest as a keyed, host-predicting
    :class:`Model`. ``batch_size`` fixes the snapshot's shape;
    ``n_estimators=100`` is sklearn's default, which the reference uses;
    ``n_jobs`` is its ``CORES`` (0: sklearn's default). Raises
    :class:`ImportError` without scikit-learn."""
    require_sklearn()
    f, b = spec.num_features, int(batch_size)
    cache = _ForestCache(cache_size)

    def init(p, device="cpu", key=None):
        # the all-zero snapshot: predict gives class 0 until the first fit
        return RFParams(
            torch.zeros((p, b, f), dtype=torch.float32, device=device),
            torch.zeros((p, b), dtype=torch.int32, device=device),
            torch.zeros((p, b), dtype=torch.float32, device=device),
            torch.zeros((p,), dtype=torch.int32, device=device),
        )

    def fit(X, y, w, key=None):
        if key is None:
            raise ValueError("the rf fit draws its seed from a key [P, 2]")
        seed = threefry.randint(key, (), 0, _SEED_MAX)
        return RFParams(X.float(), y.int(), w.float(), seed.to(X.device))

    def host_predict(params: RFParams, X: np.ndarray) -> np.ndarray:
        """``[P, N]`` int32 predictions of the host rows ``X [P, N, F]``."""
        tX, ty, tw, seeds = (t.cpu().numpy() for t in params)
        out = np.zeros(X.shape[:2], np.int32)
        for p in range(X.shape[0]):
            forest = cache.get_or_fit(
                tX[p], ty[p], tw[p], int(seeds[p]), n_estimators, n_jobs
            )
            if forest is not None and X.shape[1]:
                out[p] = forest.predict(X[p]).astype(np.int32)
        return out

    def predict(params, X):
        pred = host_predict(params, X.float().cpu().numpy())
        return torch.from_numpy(pred).to(X.device)

    def predict_err(params, T, Ty, idx):
        i = idx.long()
        pred = predict(params, T[i, :f])
        return (pred != Ty[i]).float()

    return Model("rf", init, fit, predict, predict_err, keyed=True, host_callback=True)
