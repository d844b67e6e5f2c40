"""The port's MLP (``models/mlp.py``) against the JAX package's ``make_mlp``.

The same numpy inputs and the same threefry keys go through both: the init
is JAX's jitted init bit for bit; the fit (32 SGD + momentum steps of
float32 matrix products, whose summation order XLA does not share) agrees
with JAX's jitted fit to ``rtol`` 1e-4 and ``atol`` 2e-6 on every
parameter; with JAX's fitted parameters carried across,
the predictions are equal except on rows whose two best logits lie within
``1e-4·(1 + |top logit|)`` of each other. The engines' spans continue a
carried JAX state — key chain included — to the same flags and end key.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from distributed_drift_detection_tpu.models import ModelSpec as JSpec  # noqa: E402
from distributed_drift_detection_tpu.models.classifiers import make_mlp as j_mlp  # noqa: E402
from distributed_drift_detection_tpu_torch import convert  # noqa: E402
from distributed_drift_detection_tpu_torch.models import ModelSpec, build_model  # noqa: E402
from distributed_drift_detection_tpu_torch.models.base import pad_row_table  # noqa: E402
from distributed_drift_detection_tpu_torch.models.mlp import (  # noqa: E402
    make_mlp,
    mlp_forward,
    mlp_predict_err,
)

RTOL, ATOL = 1e-4, 2e-6
# (P, B, F, C, hidden, fit_steps)
FIT_CASES = {
    "smoke_width": (3, 100, 21, 40, (128, 64), 32),
    "narrow": (4, 37, 27, 5, (16, 8), 4),
    "one_hidden": (2, 50, 21, 40, (32,), 8),
    "invalid_rows": (3, 64, 21, 40, (16, 8), 8),
    "all_invalid": (2, 100, 21, 40, (16, 8), 8),
}


def _batch(seed, p, b, f, c):
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(c, f)).astype(np.float32) * 2
    y = rng.integers(0, c, (p, b)).astype(np.int32)
    X = (protos[y] + 0.5 * rng.normal(size=(p, b, f))).astype(np.float32)
    w = (rng.random((p, b)) < 0.9).astype(np.float32)
    return X, y, w, protos


def _keys(seed, p):
    keys = jax.random.split(jax.random.key(seed), p)
    return keys, torch.from_numpy(np.asarray(jax.random.key_data(keys)).view(np.int32).copy())


def _models(f, c, hidden, steps):
    return (j_mlp(JSpec(f, c), hidden=hidden, fit_steps=steps),
            make_mlp(ModelSpec(f, c), hidden=hidden, fit_steps=steps))


@pytest.mark.parametrize("f, c, hidden", [(21, 40, (128, 64)), (27, 5, (16, 8)), (21, 3, (7,))])
def test_mlp_init_bit_identical_to_jitted_jax(f, c, hidden):
    jm, tm = _models(f, c, hidden, 1)
    jkeys, tkeys = _keys(11, 4)
    want = jax.jit(jax.vmap(jm.init))(jkeys)
    got = tm.init(4, "cpu", key=tkeys)
    assert len(got) == len(want) == len(hidden) + 1
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.w.numpy().view(np.int32), np.asarray(a.w).view(np.int32))
        np.testing.assert_array_equal(b.b.numpy(), np.asarray(a.b))


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_mlp_fit_close_to_jitted_jax(case):
    p, b, f, c, hidden, steps = FIT_CASES[case]
    X, y, w, _ = _batch(3, p, b, f, c)
    if case == "invalid_rows":
        w[:, ::3] = 0.0
        y[0, :5] = c  # labels of no class
        w[1] = 0.0  # one partition's batch all invalid
    if case == "all_invalid":
        w[:] = 0.0
    jm, tm = _models(f, c, hidden, steps)
    jkeys, tkeys = _keys(5, p)
    want = jax.jit(jax.vmap(jm.fit))(jkeys, X, y, w)
    got = tm.fit(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w), key=tkeys)
    for a, g in zip(want, got):
        for jv, tv in ((a.w, g.w), (a.b, g.b)):
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)
    if case == "all_invalid":  # no gradient: the fit is the init, bit for bit
        init = tm.init(p, "cpu", key=tkeys)
        for g, i in zip(got, init):
            assert torch.equal(g.w, i.w) and torch.equal(g.b, i.b)


def _near_tie(params, X):
    """Rows whose two best float64 logits lie within 1e-4·(1 + |top|)."""
    h = torch.from_numpy(X).double()
    for layer in params[:-1]:
        h = torch.relu(torch.bmm(h, layer.w.double()) + layer.b.double()[:, None])
    logits = torch.bmm(h, params[-1].w.double()) + params[-1].b.double()[:, None]
    top2 = logits.topk(2, -1).values
    return ((top2[..., 0] - top2[..., 1]) <= 1e-4 * (1 + top2[..., 0].abs())).numpy()


@pytest.mark.parametrize("hidden", [(128, 64), (16, 8)])
def test_mlp_predict_with_carried_params(hidden):
    """JAX's fitted parameters, carried across by ``convert.mlp_params``:
    ``predict`` and ``predict_err`` (gathered from the padded row table)
    equal JAX's ``predict`` and ``pred != y`` except on near ties."""
    p, b, f, c = 3, 100, 21, 40
    X, y, w, protos = _batch(4, p, b, f, c)
    jm, tm = _models(f, c, hidden, 16)
    jkeys, _ = _keys(2, p)
    jp = jax.jit(jax.vmap(jm.fit))(jkeys, X, y, w)
    carried = convert.mlp_params(jp)
    rng = np.random.default_rng(9)
    T = (protos[rng.integers(0, c, 800)] + 0.7 * rng.normal(size=(800, f))).astype(np.float32)
    Ty = rng.integers(0, c, 800).astype(np.int32)
    idx = rng.integers(0, 800, (p, 500)).astype(np.int16)
    rows = T[idx.astype(np.int64)]
    want = np.asarray(jax.vmap(jm.predict)(jp, rows))
    tie = _near_tie(carried, rows)
    got = tm.predict(carried, torch.from_numpy(rows)).numpy()
    assert tie.sum() < 5
    np.testing.assert_array_equal(got[~tie], want[~tie])
    err = mlp_predict_err(carried, pad_row_table(torch.from_numpy(T)), torch.from_numpy(Ty),
                          torch.from_numpy(idx)).numpy()
    want_err = (want != Ty[idx.astype(np.int64)]).astype(np.float32)
    np.testing.assert_array_equal(err[~tie], want_err[~tie])


def test_mlp_params_convert():
    jm, _ = _models(21, 40, (16, 8), 1)
    jkeys, _ = _keys(0, 3)
    batched = jax.vmap(jm.init)(jkeys)
    for params, p in ((batched, 3), (jm.init(jkeys[0]), 1)):
        got = convert.mlp_params(params)
        for a, g in zip(params, got):
            assert g.w.shape == (p, *np.shape(a.w)[-2:]) and g.w.dtype == torch.float32
            np.testing.assert_array_equal(g.w.numpy().reshape(np.shape(a.w)), np.asarray(a.w))
            np.testing.assert_array_equal(g.b.numpy().reshape(np.shape(a.b)), np.asarray(a.b))


def test_build_model_reads_the_mlp_config():
    from distributed_drift_detection_tpu_torch.config import RunConfig

    m = build_model("mlp", ModelSpec(5, 3), RunConfig(mlp_hidden=(6, 4), fit_steps=2,
                                                     mlp_learning_rate=0.1))
    assert m.keyed and m.name == "mlp"
    params = m.init(2, "cpu", key=torch.zeros((2, 2), dtype=torch.int32))
    assert [tuple(layer.w.shape) for layer in params] == [(2, 5, 6), (2, 6, 4), (2, 4, 3)]
    for name in ("centroid", "gnb", "linear", "majority"):
        assert not build_model(name, ModelSpec(5, 3)).keyed
    with pytest.raises(ValueError, match="key"):
        m.fit(torch.zeros((2, 4, 5)), torch.zeros((2, 4), dtype=torch.int32), torch.ones((2, 4)))


def _stream():
    from distributed_drift_detection_tpu.io import stream as jstream

    return jstream.load_stream(
        "synth:prototypes,seed=0,concepts=6,rows_per_concept=100,features=5", 3, seed=0
    )


def _jax_carry(jm, det_init, p, first_X, first_y, first_w, seed=0):
    from distributed_drift_detection_tpu.engine import loop as jloop

    keys = jax.random.split(jax.random.key(seed), p)
    pair = jax.vmap(jax.random.split)(keys)
    return jloop.LoopCarry(
        params=jax.vmap(jm.init)(pair[:, 1]),
        ddm=jax.vmap(lambda _: det_init())(jnp.arange(p)),
        a_X=jnp.asarray(first_X), a_y=jnp.asarray(first_y),
        a_w=jnp.asarray(first_w, jnp.float32), retrain=jnp.ones(p, bool),
        key=pair[:, 0],
    )


def _keyed(carry):
    return carry._replace(key=jax.random.key_data(carry.key))


def test_mlp_window_span_continues_a_carried_jax_state():
    """The JAX window engine runs the first half of a stream with the mlp;
    its LoopCarry, key data included, carried across through
    ``convert.loop_carry``, lets the port's span run the second half (the
    key chain drawn on the host) with the same flags and the same end key."""
    from distributed_drift_detection_tpu import config as jconfig
    from distributed_drift_detection_tpu.engine import loop as jloop
    from distributed_drift_detection_tpu.engine import window as jwindow
    from distributed_drift_detection_tpu.io import stream as jstream
    from distributed_drift_detection_tpu.ops.ddm import ddm_init
    from distributed_drift_detection_tpu_torch import config as tconfig
    from distributed_drift_detection_tpu_torch.engine import loop as tloop
    from distributed_drift_detection_tpu_torch.engine import window as twindow

    stream = _stream()
    b = jstream.stripe_partitions_indexed(stream, 4, 25, shuffle_seed=7)
    f, c = stream.num_features, stream.num_classes
    jm, tm = _models(f, c, (16, 8), 4)
    jspan = jax.jit(jax.vmap(
        jwindow.make_window_span(jm, jconfig.DDMParams(), window=8, rotations=3),
        in_axes=(0, jloop.IndexedBatches(None, None, 0, 0, 0)),
    ))

    def half(lo, hi):
        return jloop.IndexedBatches(*(jnp.asarray(x) for x in (
            b.base_X, b.base_y, b.idx[:, lo:hi], b.rows[:, lo:hi], b.valid[:, lo:hi]
        )))

    i0 = np.asarray(b.idx[:, 0], np.int64)
    init = _jax_carry(jm, ddm_init, 4, b.base_X[i0], b.base_y[i0], b.valid[:, 0])
    mid = b.idx.shape[1] // 2
    carry, _ = jspan(init, half(1, mid))
    jend, jflags = jspan(carry, half(mid, None))

    second = tloop.IndexedBatches(*(torch.from_numpy(np.array(x)) for x in half(mid, None)))
    tspan = twindow.make_window_span(tm, tconfig.DDMParams(), window=8, rotations=3)
    tend, tflags = tspan(convert.loop_carry(_keyed(carry), "mlp"), second)

    assert (np.asarray(jflags.change_local) >= 0).any()
    for name in jflags._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jflags, name)),
                                      getattr(tflags, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(tend.key, np.asarray(jax.random.key_data(jend.key)))
    for a, g in zip(jend.params, tend.params):
        np.testing.assert_allclose(g.w.numpy(), np.asarray(a.w), rtol=RTOL, atol=ATOL)


def test_mlp_partition_step_continues_a_carried_jax_state():
    """The sequential (window=1) engine with the mlp: the JAX step's carry,
    key data included, lets the port's step run the second half of a dense
    stream (splitting the carried key itself) to the same flags and key."""
    from jax import lax

    from distributed_drift_detection_tpu import config as jconfig
    from distributed_drift_detection_tpu.engine import loop as jloop
    from distributed_drift_detection_tpu.io import stream as jstream
    from distributed_drift_detection_tpu.ops.ddm import ddm_init
    from distributed_drift_detection_tpu_torch import config as tconfig
    from distributed_drift_detection_tpu_torch.engine import loop as tloop

    stream = _stream()
    b = jstream.stripe_partitions(stream, 4, 25, shuffle_seed=7)
    f, c = stream.num_features, stream.num_classes
    jm, tm = _models(f, c, (16, 8), 4)
    jstep = jloop.make_partition_step(jm, jconfig.DDMParams(), shuffle=False)
    p, nb = b.y.shape[:2]
    mid = nb // 2
    init = _jax_carry(jm, ddm_init, p, b.X[:, 0], b.y[:, 0], b.valid[:, 0], seed=3)

    @jax.jit
    def scan(carry, part):
        return jax.vmap(lambda cc, bb: lax.scan(jstep, cc, bb))(carry, part)

    def part(lo, hi):
        return jloop.Batches(*(jnp.asarray(x[:, lo:hi]) for x in b))

    carry, _ = scan(init, part(1, mid))
    jend, jflags = scan(carry, part(mid, nb))
    assert (np.asarray(jflags.change_local) >= 0).any()

    tstep = tloop.make_partition_step(tm, tconfig.DDMParams())
    X = torch.from_numpy(np.ascontiguousarray(b.X))
    table = pad_row_table(X.reshape(-1, f))
    labels = torch.from_numpy(np.ascontiguousarray(b.y)).reshape(-1)
    idx = torch.arange(table.shape[0], dtype=torch.int32).view(p, nb, -1)
    tcarry = convert.loop_carry(_keyed(carry), "mlp")
    flags = []
    for s in range(mid, nb):
        tcarry, fl = tstep(tcarry, table, labels, idx[:, s].contiguous(),
                           torch.from_numpy(b.rows[:, s].copy()), torch.from_numpy(b.valid[:, s].copy()))
        flags.append(fl)
    for i, name in enumerate(jflags._fields):
        got = torch.stack([fl[i] for fl in flags], 1).numpy()
        np.testing.assert_array_equal(np.asarray(getattr(jflags, name)), got, err_msg=name)
    np.testing.assert_array_equal(tcarry.key, np.asarray(jax.random.key_data(jend.key)))
