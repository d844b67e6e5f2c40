"""The port's majority and centroid models against the JAX package's.

Fits run on the same numpy-seeded batches in both packages; predictions use
JAX-fitted parameters carried across through ``convert.py``. Predictions
must be exact. Scores agree within ``rtol = atol = 1e-6``: the matmul sums
in another order than XLA on the CPU. The centroid predict fused with the
error indicator is kernel K2 on the card (``tests/test_torch_kernels.py``);
on CPU tensors its wrapper runs the plain version tested here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_drift_detection_tpu.models import ModelSpec as JSpec  # noqa: E402
from distributed_drift_detection_tpu.models.classifiers import (  # noqa: E402
    CentroidParams as JCentroid,
)
from distributed_drift_detection_tpu.models.classifiers import (  # noqa: E402
    make_centroid as j_centroid,
)
from distributed_drift_detection_tpu.models.classifiers import (  # noqa: E402
    make_majority as j_majority,
)
from distributed_drift_detection_tpu_torch import convert  # noqa: E402
from distributed_drift_detection_tpu_torch.models import ModelSpec  # noqa: E402
from distributed_drift_detection_tpu_torch.models.classifiers import (  # noqa: E402
    build_model,
    centroid_predict_err,
    centroid_scores,
    make_centroid,
    make_majority,
)

P, B, F, C, N = 4, 30, 6, 5, 40


@pytest.fixture(scope="module")
def data():
    """Per-partition training batches (a few classes each, some padded
    rows), and query rows near the class prototypes."""
    rng = np.random.default_rng(0)
    protos = rng.normal(size=(C, F)).astype(np.float32) * 3
    y = rng.integers(0, 3, (P, B)).astype(np.int32) + np.arange(P)[:, None] % 3
    X = (protos[y] + 0.2 * rng.normal(size=(P, B, F))).astype(np.float32)
    w = (rng.random((P, B)) < 0.85).astype(np.float32)
    qy = rng.integers(0, C, (P, N)).astype(np.int32)
    qX = (protos[qy] + 0.3 * rng.normal(size=(P, N, F))).astype(np.float32)
    return X, y, w, qX, qy


@pytest.fixture(scope="module")
def jax_centroid(data):
    X, y, w, qX, _ = data
    m = j_centroid(JSpec(F, C))
    params = jax.vmap(lambda a, b, c: m.fit(None, a, b, c))(X, y, w)
    scores = jax.vmap(lambda p, x: x @ p.centroids.T + p.bias)(params, qX)
    preds = jax.vmap(m.predict)(params, qX)
    return params, np.asarray(scores), np.asarray(preds)


def test_centroid_fit_matches_jax(data, jax_centroid):
    X, y, w, _, _ = data
    jp = jax_centroid[0]
    tp = make_centroid(ModelSpec(F, C)).fit(
        torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w)
    )
    np.testing.assert_allclose(tp.centroids.numpy(), np.asarray(jp.centroids), rtol=1e-6, atol=1e-6)
    jb, tb = np.asarray(jp.bias), tp.bias.numpy()
    np.testing.assert_array_equal(np.isinf(jb), np.isinf(tb))  # absent classes
    fin = np.isfinite(jb)
    np.testing.assert_allclose(tb[fin], jb[fin], rtol=1e-6, atol=1e-6)


def test_centroid_predict_with_carried_params(data, jax_centroid):
    _, _, _, qX, _ = data
    jp, jscores, jpreds = jax_centroid
    tp = convert.centroid_params(jp)
    model = make_centroid(ModelSpec(F, C))
    scores = centroid_scores(tp, torch.from_numpy(qX)).numpy()
    fin = np.isfinite(jscores)
    np.testing.assert_array_equal(fin, np.isfinite(scores))
    np.testing.assert_allclose(scores[fin], jscores[fin], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(model.predict(tp, torch.from_numpy(qX)).numpy(), jpreds)


def test_centroid_predict_err_matches_jax(data, jax_centroid):
    """The fused predict + error indicator over a row table and int16
    gather indices, against JAX's gather + predict + compare."""
    _, _, _, qX, qy = data
    jp, _, jpreds = jax_centroid
    T, Ty = qX.reshape(-1, F), qy.reshape(-1)
    idx = np.arange(P * N, dtype=np.int16).reshape(P, N)
    before = centroid_predict_err.launches
    err, pred = centroid_predict_err(
        *convert.centroid_params(jp), torch.from_numpy(T), torch.from_numpy(Ty),
        torch.from_numpy(idx), return_pred=True,
    )
    np.testing.assert_array_equal(pred.numpy(), jpreds)
    np.testing.assert_array_equal(err.numpy(), (jpreds != qy).astype(np.float32))
    assert centroid_predict_err.launches == before  # CPU tensors launch nothing


def _tie_params():
    """Class 0 absent (-inf bias), classes 1 and 3 identical (exact tie),
    class 2 a hair away from class 4 (near tie well above rounding)."""
    cent = np.zeros((C, F), np.float32)
    cent[1] = cent[3] = 1.0
    cent[2] = 2.0
    cent[4] = 2.0
    cent[4, 0] = 2.001
    bias = -0.5 * (cent * cent).sum(1)
    bias[0] = -np.inf
    return JCentroid(jnp.asarray(cent), jnp.asarray(bias.astype(np.float32)))


@pytest.mark.parametrize(
    "row, want",
    [
        (np.full(F, 1.0), 1),  # exact tie 1 == 3: the first wins
        (np.r_[2.05, np.full(F - 1, 2.0)], 4),  # near tie, 4 ahead by 5e-5
        (np.r_[1.95, np.full(F - 1, 2.0)], 2),  # near tie, 2 ahead by 5e-5
    ],
)
def test_centroid_ties(row, want):
    jp = _tie_params()
    x = np.asarray(row, np.float32)[None]
    jpred = int(j_centroid(JSpec(F, C)).predict(jp, jnp.asarray(x))[0])
    tpred = int(make_centroid(ModelSpec(F, C)).predict(
        convert.centroid_params(jp), torch.from_numpy(x)[None])[0, 0])
    assert jpred == tpred == want


def test_centroid_all_absent_row_predicts_zero():
    jp = JCentroid(jnp.zeros((C, F)), jnp.full((C,), -jnp.inf))
    x = np.ones((1, F), np.float32)
    jpred = int(j_centroid(JSpec(F, C)).predict(jp, jnp.asarray(x))[0])
    tpred = int(make_centroid(ModelSpec(F, C)).predict(
        convert.centroid_params(jp), torch.from_numpy(x)[None])[0, 0])
    assert jpred == tpred == 0


def test_centroid_init_matches_jax():
    j = j_centroid(JSpec(F, C)).init(None)
    t = make_centroid(ModelSpec(F, C)).init(2)
    for leaf_j, leaf_t in zip(j, t):
        for p in range(2):
            np.testing.assert_array_equal(np.asarray(leaf_j), leaf_t[p].numpy())


@pytest.mark.parametrize("seed", range(3))
def test_majority_matches_jax(seed, data):
    """Fit (ties resolve to the lowest class), predict and the error
    indicator."""
    _, _, _, qX, qy = data
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, (P, B)).astype(np.int32)
    y[0, : B // 2], y[0, B // 2:] = 2, 1  # an exact 15/15 tie -> class 1
    w = np.ones((P, B), np.float32)
    jm = j_majority(JSpec(F, C))
    jp = np.asarray(jax.vmap(lambda a, b: jm.fit(None, None, a, b))(y, w))
    tm = make_majority(ModelSpec(F, C))
    tp = tm.fit(None, torch.from_numpy(y), torch.from_numpy(w))
    np.testing.assert_array_equal(tp.numpy(), jp)
    assert jp[0] == 1
    carried = convert.majority_params(jp)
    jpred = np.asarray(jax.vmap(jm.predict)(jnp.asarray(jp), jnp.asarray(qX)))
    np.testing.assert_array_equal(tm.predict(carried, torch.from_numpy(qX)).numpy(), jpred)
    T, Ty = torch.from_numpy(qX.reshape(-1, F)), torch.from_numpy(qy.reshape(-1))
    idx = torch.arange(P * N, dtype=torch.int32).view(P, N)
    err = tm.predict_err(carried, T, Ty, idx)
    np.testing.assert_array_equal(err.numpy(), (jpred != qy).astype(np.float32))


def test_loop_carry_converts():
    """A JAX window-engine carry (vmapped over partitions) converts leaf by
    leaf, the PRNG key dropped."""
    from distributed_drift_detection_tpu.engine.loop import LoopCarry as JCarry
    from distributed_drift_detection_tpu.ops.ddm import ddm_init

    jp = j_centroid(JSpec(F, C)).init(None)
    one = JCarry(jp, ddm_init(), jnp.ones((B, F)), jnp.zeros(B, jnp.int32),
                 jnp.ones(B), jnp.bool_(True), jax.random.key(0))
    jc = jax.tree.map(lambda a: jnp.stack([a, a]), one)
    tc = convert.loop_carry(jc, "centroid")
    assert tc.a_X.shape == (2, B, F) and tc.a_X.dtype == torch.float32
    assert tc.params.bias.shape == (2, C) and tc.retrain.dtype == torch.bool
    assert tc.ddm.count.dtype == torch.int32 and torch.isinf(tc.ddm.ps_min).all()


def test_unported_models_raise():
    with pytest.raises(NotImplementedError, match="A4"):
        build_model("gnb", ModelSpec(F, C))
