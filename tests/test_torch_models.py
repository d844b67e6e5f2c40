"""The port's majority, centroid, gnb and linear models against the JAX
package's.

Fits run on the same numpy-seeded batches in both packages; predictions use
JAX-fitted parameters carried across through ``convert.py``. Predictions
must be exact. The centroid fit is bit-identical to the JAX package's
jitted fit (``test_centroid_fit_bit_identical_to_jitted_jax``); against
its eager, op-by-op form, which rounds the squares of the bias before it
sums them, it agrees to ``rtol = atol = 1e-6``. Scores agree within
``rtol = atol = 1e-6``: the matmul sums in another order than XLA on the
CPU, and at a near tie the argmax can differ
(``test_centroid_predict_near_ties``). The port's gnb fit follows the JAX
package's float32 expressions but sums the global moments in row order,
and linear fits in float64 and rounds once, so their fitted parameters
agree to a stated tolerance, not to the bit: linear's to ``rtol = 1e-4``,
``atol = 1e-5`` (float32 rounding over 32 gradient steps); gnb's to
``rtol = 1e-3`` — the float32 variance ``E[(x−m)²]_c − μ_c²`` cancels, so
a different rounding of the global mean moves it by about 1e-4 relative.
Predictions are compared exactly. The centroid predict fused with the
error indicator is kernel K2 on the card, the fit kernel K7
(``tests/test_torch_kernels.py``); on CPU tensors their wrappers run the
plain versions tested here.
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
from distributed_drift_detection_tpu_torch.ops.prefix import fma  # noqa: E402
from distributed_drift_detection_tpu_torch.models.classifiers import (  # noqa: E402
    build_model,
    centroid_predict_err,
    centroid_scores,
    _argmax_first,
    _row_sums,
    centroid_fit,
    centroid_fit_reference,
    make_centroid,
    make_majority,
    pad_row_table,
    row_stride,
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


def _fit_batch(seed, b, f, c, p=4):
    """A training batch per partition: rows near ``c`` prototypes, about
    one row in ten padded (weight 0), the last class absent."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(c, f)).astype(np.float32) * 3
    y = rng.integers(0, c - 1, (p, b)).astype(np.int32)
    X = (protos[y] + 0.5 * rng.normal(size=(p, b, f))).astype(np.float32)
    w = (rng.random((p, b)) < 0.9).astype(np.float32)
    return X, y, w


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("f, c", [(21, 40), (27, 5)])
@pytest.mark.parametrize("per_batch", [100, 256])
def test_centroid_fit_bit_identical_to_jitted_jax(per_batch, f, c, seed):
    """The port's centroid fit (K7's plain version on CPU tensors) equals
    ``jax.jit(jax.vmap(fit))`` of the JAX package bit for bit: centroids,
    biases, and the -inf of absent classes."""
    X, y, w = _fit_batch(seed, per_batch, f, c)
    m = j_centroid(JSpec(f, c))
    jp = jax.jit(jax.vmap(lambda a, b, d: m.fit(None, a, b, d)))(X, y, w)
    tp = centroid_fit(*(torch.from_numpy(a) for a in (X, y, w)), c)
    for j, t in zip(jp, tp):
        assert np.array_equal(np.asarray(j).view(np.int32), t.numpy().view(np.int32))
    assert np.isinf(np.asarray(jp.bias)[:, -1]).all()


# K7's order, modelled on the CPU: cases of (per_batch, label layout) at
# P = 4, F = 21, C = 40.
K7_ORDER_CASES = {
    "per_batch_1": (1, None),
    "per_batch_100": (100, None),
    "per_batch_256": (256, None),
    "per_batch_384": (384, None),
    "one_class": (100, "one_class"),
    "no_class": (100, "no_class"),
    "weights_0": (100, "weights_0"),
    "negative_zero": (100, "negative_zero"),
}


def _k7_order_batch(case, f=21, c=40):
    """``_fit_batch`` with a few labels outside [0, C), then the case's
    layout."""
    b, layout = K7_ORDER_CASES[case]
    X, y, w = _fit_batch(sorted(K7_ORDER_CASES).index(case), b, f, c)
    rng = np.random.default_rng(b)
    y[rng.random(y.shape) < 0.03] = c
    y[rng.random(y.shape) < 0.02] = -1
    if layout == "one_class":
        y[:] = 3
    elif layout == "no_class":
        y[:] = np.where(rng.random(y.shape) < 0.5, c, -7)
    elif layout == "weights_0":
        w[:] = 0.0
    elif layout == "negative_zero":
        X[:, :, ::4] = -0.0
        X[:, ::5] = -0.0
        X[:, :, 1] = -np.abs(X[:, :, 1])
    return X, y, w


def _k7_sorted_rows(y, c):
    """csrc/centroid_fit.cu ``class_rows`` on one partition's labels ``y
    [B]`` (B in one row tile): bit i of class k's word for 32-row chunk ch
    marks row 32·ch + i; read chunk by chunk, low bit first, class k's
    words list its rows. Returns (list, offsets): ``list[off[k]:off[k + 1]]``
    holds class k's rows in the kernel's order."""
    words = [[sum(1 << i for i, lab in enumerate(y[c0:c0 + 32].tolist()) if lab == k)
              for c0 in range(0, len(y), 32)] for k in range(c)]
    order, off = [], [0]
    for k in range(c):
        for ch, m in enumerate(words[k]):
            while m:
                low = m & -m
                order.append(32 * ch + low.bit_length() - 1)
                m ^= low
        off.append(len(order))
    return torch.tensor(order, dtype=torch.long), torch.tensor(off, dtype=torch.long)


def _k7_class_sums(X, y, w, c):
    """The kernel's sums: per class, from +0, w·x and w of the rows in its
    slice of the sorted list, in list order (at B = 1, XLA's product)."""
    p, b, f = X.shape
    sums = torch.zeros((p, c, f), dtype=torch.float32)
    counts = torch.zeros((p, c), dtype=torch.float32)
    lists = []
    for q in range(p):
        order, off = _k7_sorted_rows(y[q], c)
        lists.append((order, off))
        for k in range(c):
            if b == 1:
                oh = torch.tensor(1.0 if int(y[q, 0]) == k else 0.0) * w[q, 0]
                sums[q, k], counts[q, k] = oh * X[q, 0], oh
                continue
            a = torch.zeros(f, dtype=torch.float32)
            n = torch.zeros((), dtype=torch.float32)
            for r in order[off[k]:off[k + 1]].tolist():
                a = a + w[q, r] * X[q, r]
                n = n + w[q, r]
            sums[q, k], counts[q, k] = a, n
    return sums, counts, lists


@pytest.mark.parametrize("case", sorted(K7_ORDER_CASES))
def test_centroid_fit_sorted_list_model(case):
    """A CPU model of K7's order — a stable class-sorted row list, each
    class summed over its slice in list order — is stable, gives the plain
    version's sums and counts bit for bit, and its centroids and biases
    equal ``centroid_fit_reference``'s and ``jax.jit(jax.vmap(fit))``'s."""
    f, c = 21, 40
    X, y, w = _k7_order_batch(case, f, c)
    tX, ty, tw = (torch.from_numpy(a) for a in (X, y, w))
    sums, counts, lists = _k7_class_sums(tX, ty, tw, c)
    for q, (order, off) in enumerate(lists):
        labels = ty[q, order]
        for k in range(c):
            rows = order[off[k]:off[k + 1]]
            assert bool((labels[off[k]:off[k + 1]] == k).all())
            assert bool((rows[1:] > rows[:-1]).all())  # stable: row order
            assert len(rows) == int((ty[q] == k).sum())
    want_sums, want_counts = _row_sums(tX, ty, tw, c)
    assert torch.equal(sums.view(torch.int32), want_sums.view(torch.int32))
    assert torch.equal(counts.view(torch.int32), want_counts.view(torch.int32))

    cent = sums / counts.clamp_min(1.0)[..., None]
    sq = torch.zeros((X.shape[0], c), dtype=torch.float32)
    for j in range(f):
        sq = fma(cent[..., j], cent[..., j], sq)
    bias = torch.where(counts > 0, -0.5 * sq, float("-inf"))
    ref = centroid_fit_reference(tX, ty, tw, c)
    m = j_centroid(JSpec(f, c))
    jp = jax.jit(jax.vmap(lambda a, b, d: m.fit(None, a, b, d)))(X, y, w)
    for mine, r, j in zip((cent, bias), ref, jp):
        assert torch.equal(mine.view(torch.int32), r.view(torch.int32))
        assert np.array_equal(mine.numpy().view(np.int32), np.asarray(j).view(np.int32))
    if case in ("no_class", "weights_0"):
        assert bool(torch.isinf(bias).all()) and not bool(torch.signbit(cent).any())


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


@pytest.mark.parametrize("f", [1, 4, 6, 21, 27, 32, 37])
def test_pad_row_table(f):
    """K2's row table: row stride F rounded up to 4, equal to T on the
    first F columns and zero beyond; T itself when F is a multiple of 4."""
    T = torch.from_numpy(np.random.default_rng(f).normal(size=(7, f)).astype(np.float32))
    padded = pad_row_table(T)
    assert padded.shape == (7, row_stride(f)) and padded.is_contiguous()
    assert row_stride(f) % 4 == 0 and 0 <= row_stride(f) - f < 4
    assert torch.equal(padded[:, :f], T) and not padded[:, f:].any()
    assert (padded is T) == (f % 4 == 0)


def test_centroid_predict_err_takes_padded_table(data, jax_centroid):
    """The wrapper reads only the first F columns of a padded row table."""
    _, _, _, qX, qy = data
    jp, _, jpreds = jax_centroid
    T = torch.from_numpy(qX.reshape(-1, F))
    idx = torch.arange(P * N, dtype=torch.int32).view(P, N)
    err, pred = centroid_predict_err(
        *convert.centroid_params(jp), pad_row_table(T), torch.from_numpy(qy.reshape(-1)),
        idx, return_pred=True,
    )
    np.testing.assert_array_equal(pred.numpy(), jpreds)
    np.testing.assert_array_equal(err.numpy(), (jpreds != qy).astype(np.float32))


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


def test_centroid_predict_near_ties():
    """Rows within a few ulps of equidistant from two centroids (ROADMAP
    Queue C, C2): the port's ``centroid_scores`` argmax and the JAX
    package's jitted ``make_centroid.predict`` agree on every row whose
    float64 margin between its two best classes exceeds F + 1 roundings
    of the largest term; on the rest they can differ, since neither sums
    the dot in the other's order (measured: about a third of these rows)."""
    f, c, n = 21, 40, 2000
    rng = np.random.default_rng(5)
    cent = (rng.normal(size=(c, f)) * 3).astype(np.float32)
    bias = (-0.5 * (cent.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    i = rng.integers(0, c, n)
    k = (i + 1 + rng.integers(0, c - 1, n)) % c
    d = cent[i].astype(np.float64) - cent[k]
    db = bias[i].astype(np.float64) - bias[k]
    x0 = (cent[i] + cent[k]) / 2 + 0.3 * rng.normal(size=(n, f))
    x = (x0 - ((x0 * d).sum(1) + db)[:, None] / (d * d).sum(1)[:, None] * d).astype(np.float32)
    bits = x.view(np.int32).copy()
    bits[np.arange(n), rng.integers(0, f, n)] += rng.integers(-3, 4, n)
    x = bits.view(np.float32)
    jpred = np.asarray(jax.jit(j_centroid(JSpec(f, c)).predict)(
        JCentroid(jnp.asarray(cent), jnp.asarray(bias)), jnp.asarray(x)))
    params = convert.centroid_params(JCentroid(jnp.asarray(cent)[None], jnp.asarray(bias)[None]))
    tpred = _argmax_first(centroid_scores(params, torch.from_numpy(x)[None]))[0].numpy()
    s64 = np.sort(x.astype(np.float64) @ cent.T.astype(np.float64) + bias, 1)
    scale = (np.abs(x).astype(np.float64) @ np.abs(cent.T) + np.abs(bias)).max(1)
    clear = s64[:, -1] - s64[:, -2] > (f + 1) * scale * 2.0**-24
    assert clear.sum() > n // 10 and (~clear).sum() > n // 2
    np.testing.assert_array_equal(tpred[clear], jpred[clear])


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
    """mlp is ported (tests/test_torch_mlp.py); forest and rf still raise,
    naming their ROADMAP items."""
    for name, item in (("forest", "A9b"), ("rf", "A9c")):
        with pytest.raises(NotImplementedError, match=item):
            build_model(name, ModelSpec(F, C))
    assert build_model("mlp", ModelSpec(F, C)).keyed


def _jax_fit(name, data):
    from distributed_drift_detection_tpu.models.classifiers import build_model as jbuild

    X, y, w, qX, _ = data
    m = jbuild(name, JSpec(F, C))
    params = jax.vmap(lambda a, b, c: m.fit(None, a, b, c))(X, y, w)
    return params, np.asarray(jax.vmap(m.predict)(params, qX))


@pytest.mark.parametrize("name", ["gnb", "linear"])
def test_fit_matches_jax(name, data):
    """Fitted parameters leaf by leaf (tolerance in the module docstring);
    gnb's -inf biases of absent classes exactly."""
    X, y, w, _, _ = data
    jp, _ = _jax_fit(name, data)
    tp = build_model(name, ModelSpec(F, C)).fit(
        torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w))
    assert jp._fields == tp._fields
    for f in jp._fields:
        j, t = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert j.shape == t.shape and t.dtype == np.float32, f
        np.testing.assert_array_equal(np.isinf(j), np.isinf(t), err_msg=f)
        fin = np.isfinite(j)
        rtol = 1e-3 if name == "gnb" else 1e-4  # see the module docstring
        np.testing.assert_allclose(t[fin], j[fin], rtol=rtol, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("name", ["gnb", "linear"])
def test_predict_with_carried_params(name, data):
    """With the JAX package's fitted parameters carried across, predict and
    the error indicator (K2's plain version for linear) are exact, and so
    are the predictions of the port's own fit."""
    X, y, w, qX, qy = data
    jp, jpreds = _jax_fit(name, data)
    carried = getattr(convert, f"{name}_params")(jp)
    model = build_model(name, ModelSpec(F, C))
    np.testing.assert_array_equal(model.predict(carried, torch.from_numpy(qX)).numpy(), jpreds)
    T, Ty = torch.from_numpy(qX.reshape(-1, F)), torch.from_numpy(qy.reshape(-1))
    idx = torch.arange(P * N, dtype=torch.int32).view(P, N)
    err = model.predict_err(carried, pad_row_table(T), Ty, idx)
    np.testing.assert_array_equal(err.numpy(), (jpreds != qy).astype(np.float32))
    own = model.fit(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w))
    np.testing.assert_array_equal(model.predict(own, torch.from_numpy(qX)).numpy(), jpreds)


@pytest.mark.parametrize("name", ["gnb", "linear"])
def test_init_matches_jax(name):
    from distributed_drift_detection_tpu.models.classifiers import build_model as jbuild

    j = jbuild(name, JSpec(F, C)).init(None)
    t = build_model(name, ModelSpec(F, C)).init(2)
    for leaf_j, leaf_t in zip(j, t):
        for p in range(2):
            np.testing.assert_array_equal(np.asarray(leaf_j), leaf_t[p].numpy())


def test_linear_uses_the_run_config():
    """build_model passes RunConfig.fit_steps and learning_rate to linear."""
    from distributed_drift_detection_tpu_torch.config import RunConfig

    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.normal(size=(1, 20, F)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, C, (1, 20)).astype(np.int32))
    w = torch.ones((1, 20))
    a = build_model("linear", ModelSpec(F, C), RunConfig(fit_steps=3, learning_rate=0.1))
    b = build_model("linear", ModelSpec(F, C))
    assert not torch.equal(a.fit(X, y, w).w, b.fit(X, y, w).w)
    assert torch.equal(
        a.fit(X, y, w).w,
        build_model("linear", ModelSpec(F, C), RunConfig(fit_steps=3, learning_rate=0.1)).fit(X, y, w).w,
    )
