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


@pytest.mark.parametrize("dims", [(5, 16, 8, 3), (21, 128, 64, 40)])
def test_init_normals_bit_identical_to_jitted_jax(dims):
    """K8's plain version, the whole init in one call (``split``, then a
    layer's normals, then the zero biases, in one buffer): equal bit for
    bit to JAX's jitted ``make_mlp.init`` at 3 partitions and to the
    per-layer composition it replaces."""
    from distributed_drift_detection_tpu_torch.models.mlp import init_scales, mlp_init
    from distributed_drift_detection_tpu_torch.utils import threefry

    jm = j_mlp(JSpec(dims[0], dims[-1]), hidden=dims[1:-1], fit_steps=1)
    jkeys, tkeys = _keys(17, 3)
    want = jax.jit(jax.vmap(jm.init))(jkeys)
    counts = [a * b for a, b in zip(dims[:-1], dims[1:])]
    buf = threefry.init_normals_reference(tkeys, counts, init_scales(dims), 3 * sum(dims[1:]))
    assert buf.shape == (3 * (sum(counts) + sum(dims[1:])),)
    got = mlp_init(tkeys, dims)  # views of one such buffer
    per_layer = mlp_init(tkeys, dims, normal=threefry.random_normal_reference)
    at = 0
    for a, g, r, (din, dout) in zip(want, got, per_layer, zip(dims[:-1], dims[1:])):
        w = np.asarray(a.w).view(np.int32)
        np.testing.assert_array_equal(g.w.numpy().view(np.int32), w)
        np.testing.assert_array_equal(r.w.numpy().view(np.int32), w)
        np.testing.assert_array_equal(buf[at:at + 3 * din * dout].view(3, din, dout)
                                      .numpy().view(np.int32), w)
        np.testing.assert_array_equal(g.b.numpy(), np.asarray(a.b))
        assert g.w.untyped_storage().data_ptr() == got[0].w.untyped_storage().data_ptr()
        at += 3 * din * dout
    assert not bool(buf[at:].any())


def test_init_normals_arguments():
    """The one-call init refuses mismatched layer tables; a layer of no
    normals leaves the zeros alone, and one layer is the normals of
    ``split(key, 1)[0]``."""
    from distributed_drift_detection_tpu_torch.utils import threefry

    keys = _keys(3, 2)[1]
    with pytest.raises(ValueError, match="counts"):
        threefry.init_normals(keys, [4, 5], [1.0])
    got = threefry.init_normals(keys, [0], [1.0], zeros=6)
    assert torch.equal(got, torch.zeros(6))
    one = threefry.init_normals(keys, [7], [threefry.SQRT2])
    assert torch.equal(one.view(2, 7), threefry.random_normal_reference(
        threefry.split(keys, 1)[:, 0], 7))


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


@pytest.mark.parametrize("hidden", [(128, 64), (16, 8), (256, 128), (512,), ()])
def test_mlp_predict_with_carried_params(hidden):
    """JAX's fitted parameters, carried across by ``convert.mlp_params``:
    ``predict`` and ``predict_err`` (gathered from the padded row table)
    equal JAX's ``predict`` and ``pred != y`` except on near ties — for
    the main path's net and the nets K10 streams or runs with no hidden
    layer."""
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


# --------------------------------------------------------------------------
# K9's launch plan and its cluster dataflow, mirrored in Python
# (csrc/mlp_fit.cu `layout`, `cut`, `pull` and the kernel's barriers)
# --------------------------------------------------------------------------

from distributed_drift_detection_tpu_torch.models import mlp as tmlp  # noqa: E402


def _cut(n, k, cs):
    """CTA k's first unit of a layer of n: whole groups of 4 units
    (csrc/mlp_fit.cu ``cut``)."""
    return min(n, 4 * (k * -(-n // 4) // cs))


def _owner(c, n, cs):
    """The CTA whose slice of n holds unit c (csrc/mlp_fit.cu ``owner``)."""
    return ((c // 4 + 1) * cs - 1) // -(-n // 4)


def _pad4(n):
    """A row stride for n floats (csrc/mlp_fit.cu ``pad4``)."""
    return ((((n + 3) & ~3) // 4) | 1) * 4


def _layout(dims, rows, cs):
    """csrc/mlp_fit.cu ``layout``, region by region: {name: (offset, floats)}."""
    def r4(n):
        return (n + 3) & ~3

    layers = len(dims) - 1
    regions, off = {"header": (0, 9 * layers + 6)}, r4(9 * layers + 6)

    def put(name, n):
        nonlocal off
        regions[name] = (off, n)
        off += r4(n)

    pairs = list(zip(dims[:-1], dims[1:]))
    for l, (din, dout) in enumerate(pairs):
        put(f"w{l}", din * _pad4(dout))
        put(f"b{l}", dout)
    for l, (din, dout) in enumerate(pairs):
        widest = max(_cut(dout, k + 1, cs) - _cut(dout, k, cs) for k in range(cs))
        put(f"vw{l}", din * 4 * -(-((dout + 3) // 4) // cs))
        put(f"vb{l}", 4 * -(-((dout + 3) // 4) // cs))
        assert widest <= regions[f"vb{l}"][1]
    for l, d in enumerate(dims[1:]):
        put(f"act{l}", rows * _pad4(d))
    for l in range(1, len(dims) - 2):
        if cs > 1:
            put(f"grad{l}", rows * _pad4(dims[l + 1]))
    put("row", rows)
    put("x", rows * _pad4(dims[0]))
    put("y", rows)
    put("wn", rows)
    return regions, off


# (dims, B): SMOKE at F = 21 and F = 27, B = 37 with C = 5, the global
# workspace's B = 300, narrow widths, one hidden layer, none, nine layers
K9_SHAPES = [((21, 128, 64, 40), 100), ((27, 128, 64, 40), 100), ((27, 128, 64, 5), 37),
             ((21, 128, 64, 40), 300), ((21, 16, 8, 5), 50), ((21, 32, 40), 64), ((21, 5), 40),
             ((21, *(32,) * 8, 40), 64)]


@pytest.mark.parametrize("cs", [1, 2, 4, 8])
@pytest.mark.parametrize("dims, b", K9_SHAPES)
def test_k9_words_mirror_the_kernel_layout(dims, b, cs):
    """``_k9_words`` is the kernel's per-CTA layout: disjoint regions, each
    on a 16-byte boundary, the velocities holding the widest slice, every
    row stride a multiple of 4 floats (float4 reads) and an odd number of
    float4s (no bank conflicts) that covers its row rounded up to 4."""
    regions, total = _layout(dims, b, cs)
    assert tmlp._k9_words(dims, b, cs) == total
    spans = sorted(regions.values())
    for (o1, n1), (o2, _) in zip(spans, spans[1:]):
        assert o1 % 4 == 0 and o1 + n1 <= o2
    for n in dims:
        assert _pad4(n) % 8 == 4 and _pad4(n) >= n + (-n) % 4


@pytest.mark.parametrize("n", [1, 5, 8, 16, 21, 40, 64, 128, 129])
@pytest.mark.parametrize("cs", [1, 2, 4, 8])
def test_k9_slices_partition_the_units(n, cs):
    """The CTAs' slices of a layer cover its units once, in order, each
    starting on a group of 4, and ``owner`` names the CTA whose slice holds
    each unit."""
    cuts = [_cut(n, k, cs) for k in range(cs + 1)]
    assert cuts[0] == 0 and cuts[-1] == n and cuts == sorted(cuts)
    assert all(c % 4 == 0 for c in cuts[:-1])
    for c in range(n):
        k = _owner(c, n, cs)
        assert cuts[k] <= c < cuts[k + 1]


# H100 SXM-like co-residency tables, {cs: clusters the card holds at once}
ROOMY = {8: 16, 4: 33, 2: 66}
TIGHT = {8: 14, 4: 12, 2: 66}


@pytest.mark.parametrize("dims, b, p, table, want", [
    ((21, 128, 64, 40), 100, 16, ROOMY, (4, True)),   # SMOKE, F = 21
    ((27, 128, 64, 40), 100, 16, ROOMY, (4, True)),   # F = 27
    ((21, 128, 64, 40), 100, 16, TIGHT, (2, True)),   # 16 clusters of 4 do not fit
    ((27, 128, 64, 40), 100, 16, {}, (1, True)),      # no cluster fits: one CTA, shared
    ((21, 128, 64, 40), 100, 200, ROOMY, (1, True)),  # more partitions than any wave
    ((21, 128, 64, 40), 300, 3, ROOMY, (1, False)),   # the global workspace
    ((21, 128, 64, 40), 110, 4, ROOMY, (4, True)),    # only 4 CTAs a partition fit shared memory
])
def test_k9_plan_is_a_function_of_the_shapes(dims, b, p, table, want):
    """``k9_plan`` on ``_k9_words``: the first of ``K9_CLUSTER_SIZES``
    whose workspace fits shared memory and whose P clusters are
    co-resident, else one CTA in shared or global memory; the card is asked
    only about sizes that fit, and the same shapes give the same plan."""
    assert set(tmlp.K9_CLUSTER_SIZES) <= set(tmlp.K9_CTAS)
    asked = []

    def words(cs):
        return tmlp._k9_words(dims, b, cs)

    def max_clusters(cs):
        asked.append(cs)
        return table.get(cs, 0)

    got = tmlp.k9_plan(p, words, max_clusters)
    assert got == want
    assert all(4 * tmlp._k9_words(dims, b, cs) <= tmlp.MAX_SHARED_BYTES for cs in asked)
    assert tmlp.k9_plan(p, words, max_clusters) == got
    shared = 4 * tmlp._k9_words(dims, b, got[0]) <= tmlp.MAX_SHARED_BYTES
    assert got[1] == shared


# (dims, P, N, rows a tile, streamed weights, global workspace, shared
# bytes, global floats a CTA): the main path's net; ROADMAP C5's (256, 128)
# and (512,), whose weights and activations do not fit together at 128
# rows (their weights stream at 64); no hidden layer; nine layers; a layer
# too wide for shared memory even at 8 rows (the global workspace); F = 27.
K10_PLANS = [
    ((21, 128, 64, 40), 16, 12800, 128, 0, 0, 178336, 0),
    ((21, 256, 128, 40), 16, 12800, 64, 1, 0, 149152, 0),
    ((21, 512, 40), 16, 12800, 64, 1, 0, 194848, 0),
    ((21, 40), 16, 12800, 128, 0, 0, 47680, 0),
    ((21, *(32,) * 8, 40), 2, 500, 128, 0, 0, 97696, 0),
    ((21, 4096, 40), 2, 300, 128, 1, 1, 33792, 551496),
    ((27, 128, 64, 5), 3, 1000, 128, 0, 0, 179552, 0),
]


@pytest.mark.parametrize("case", range(len(K10_PLANS)))
def test_k10_plan_is_a_function_of_the_shapes(case):
    """``k10_plan`` (the Python copy of K10's ``choose_plan`` and
    ``full_plan``): the row tile, weight path, workspace and word counts
    follow from the net's shapes alone; the plan fits shared memory, its
    weights are resident when they fit beside 64 or 128 rows, and the CTAs
    a partition are the card's share — at least one, at most the tiles."""
    dims, p, n, rows, stream, global_, shared, gwords = K10_PLANS[case]
    plan = tmlp.k10_plan(dims, p, n, 132, lambda *_: 1)
    assert (plan.rows, plan.stream, plan.global_) == (rows, stream, global_)
    assert (plan.shared_bytes, plan.global_words) == (shared, gwords)
    assert plan.threads == tmlp.K10_THREADS
    assert plan.shared_bytes <= tmlp.MAX_SHARED_BYTES
    assert plan.ctas == min(132 // p, -(-n // rows))
    assert tmlp.k10_plan(dims, p, n, 132, lambda *_: 1) == plan
    assert tmlp.k10_plan(dims, 1000, n, 132, lambda *_: 1).ctas == 1
    # forcing the plan's own fields gives the plan itself
    assert tmlp.k10_plan(dims, p, n, 132, lambda *_: 1, *tmlp.k10_force(plan)) == plan
    if not stream:  # the resident weights also stream, at the same rows
        forced = tmlp.k10_plan(dims, p, n, 132, lambda *_: 1, rows=rows, stream=1)
        assert (forced.rows, forced.stream) == (rows, 1)


def test_k10_plan_refuses_what_no_plan_fits():
    """A forced plan that does not fit, or threads the kernel does not
    take, raise with the shape in the message."""
    with pytest.raises(ValueError, match="no launch plan"):
        tmlp.k10_plan((21, 128, 64, 40), 16, 12800, 132, lambda *_: 1, rows=12)
    with pytest.raises(ValueError, match="threads"):
        tmlp.k10_plan((21, 128, 64, 40), 16, 12800, 132, lambda *_: 1, threads=512)


@pytest.mark.parametrize("layers", [1, 9, 64])
def test_check_dims_takes_up_to_64_layers(layers):
    """The kernels take any depth of any width: up to ``INLINE_LAYERS``
    (64) layers in the launch's parameters, past it (65, 200) in a device
    array (``net_desc``, none below); no layer and a zero width raise."""
    tmlp._check_dims("k", (21, *(8,) * (layers - 1), 40))
    assert tmlp.net_desc((21, *(8,) * (layers - 1), 40), "cpu") is None
    for deep in (tmlp.INLINE_LAYERS + 1, 200):
        dims = (21, *(8,) * (deep - 1), 40)
        tmlp._check_dims("k", dims)
        assert tmlp.net_desc(dims, "cpu").numel() == 24 * deep + 4
    with pytest.raises(ValueError, match="layers"):
        tmlp._check_dims("k", (21,))
    with pytest.raises(ValueError, match="width"):
        tmlp._check_dims("k", (21, *(8,) * (layers - 1), 0))


def _chain(A, B):
    """out[m, n] = Σ_t A[m, t]·B[t, n], one float32 chain an output in t
    order (elementwise, so a slice's values do not depend on the slice)."""
    acc = torch.zeros(A.shape[0], B.shape[1])
    for t in range(A.shape[1]):
        acc = acc + A[:, t:t + 1] * B[t:t + 1, :]
    return acc


class _Cta:
    """One CTA's replica of K9's workspace, with what it read and wrote
    itself and what other CTAs sent into it since the last barrier."""

    def __init__(self, bufs):
        self.buf = bufs
        self.marks()

    def marks(self):
        self.read, self.wrote, self.got = (
            {n: torch.zeros(t.shape, dtype=torch.bool) for n, t in self.buf.items()}
            for _ in range(3))

    def get(self, name, at):
        self.read[name][at] = True
        return self.buf[name][at].clone()

    def set(self, name, at, value):
        self.wrote[name][at] = True
        self.buf[name][at] = value


def _k9_model(key, X, y, w, dims, steps, cs, lr=0.05, mom=0.9):
    """K9's per-CTA dataflow for one partition: each CTA a generator that
    yields at the kernel's cluster barriers, holding its own replica of the
    workspace (what it neither computes nor receives stays NaN) and sending
    (``put``, ``push_rows``) into the others' replicas. At each barrier no
    CTA may have read or written, since the last one, what another sent
    into it then (the sender does not wait for the receiver). Returns each
    layer's (w, b) gathered from the CTAs' own columns."""
    L, B, c = len(dims) - 1, X.shape[0], dims[-1]
    nan = float("nan")
    init = tmlp.mlp_init(key[None], dims, normal=tmlp.threefry.random_normal_reference)
    ctas = []
    for k in range(cs):
        bufs = {"x": X.clone()}
        for l in range(L):
            din, dout = dims[l], dims[l + 1]
            j0, j1 = _cut(dout, k, cs), _cut(dout, k + 1, cs)
            bufs[f"w{l}"] = torch.full((din, dout), nan)
            bufs[f"w{l}"][:, j0:j1] = init[l].w[0][:, j0:j1]
            bufs[f"b{l}"] = torch.full((dout,), nan)
            bufs[f"b{l}"][j0:j1] = 0.0
            bufs[f"vw{l}"] = torch.zeros(din, j1 - j0)
            bufs[f"vb{l}"] = torch.zeros(j1 - j0)
            bufs[f"act{l}"] = torch.full((B, dout), nan)
            if 1 <= l < L - 1 and cs > 1:
                bufs[f"grad{l}"] = torch.full((B, dout), nan)
        ctas.append(_Cta(bufs))
    wn = w / torch.clamp(w.sum(), min=1.0)
    onehot = (torch.arange(c)[None] == y[:, None].long())
    every = slice(None)

    def grad(l):
        return f"grad{l}" if 1 <= l < L - 1 and cs > 1 else f"act{l}"

    def put(k, name, at, value, share=True):
        ctas[k].set(name, at, value)
        for m in range(cs):
            if m != k and share:
                ctas[m].buf[name][at] = value
                ctas[m].got[name][at] = True

    def push_rows(k, l):
        din, dout = dims[l], dims[l + 1]
        j0, j1 = _cut(dout, k, cs), _cut(dout, k + 1, cs)
        for i in range(din):
            o = _owner(i, din, cs)
            if o != k:
                ctas[o].buf[f"w{l}"][i, j0:j1] = ctas[k].get(f"w{l}", (i, slice(j0, j1)))
                ctas[o].got[f"w{l}"][i, j0:j1] = True

    def program(k):
        me = ctas[k]
        for step in range(steps):
            yield  # C
            if cs > 1:
                for l in range(1, L):
                    if l == 1 or step == 0:
                        push_rows(k, l)
            for l in range(L):
                dout = dims[l + 1]
                cols = slice(_cut(dout, k, cs), _cut(dout, k + 1, cs))
                inp = me.get("x" if l == 0 else f"act{l - 1}", every)
                z = _chain(inp, me.get(f"w{l}", (every, cols))) + me.get(f"b{l}", cols)
                put(k, f"act{l}", (every, cols), torch.relu(z) if l < L - 1 else z)
                yield  # the layer's output is complete everywhere
            e = me.get(f"act{L - 1}", every)
            e = torch.exp(e - e.amax(-1, keepdim=True))
            s = torch.zeros(B)
            for j in range(c):
                s = s + e[:, j]
            g_y = -wn
            g_sum = torch.where((y >= 0) & (y < c), g_y, 0.0)
            me.set(f"act{L - 1}", every,
                   torch.where(onehot, g_y[:, None], -0.0) + e * (-g_sum / s)[:, None])
            for l in reversed(range(L)):
                din, dout = dims[l], dims[l + 1]
                j0, j1 = _cut(dout, k, cs), _cut(dout, k + 1, cs)
                inp = me.get("x" if l == 0 else f"act{l - 1}", every)
                d = me.get(grad(l), (every, slice(j0, j1)))
                me.set(f"vw{l}", every, mom * me.get(f"vw{l}", every) - lr * _chain(inp.T, d))
                gb = torch.zeros(j1 - j0)
                for r in range(B):
                    gb = gb + d[r]
                me.set(f"vb{l}", every, mom * me.get(f"vb{l}", every) - lr * gb)
                if l > 0:
                    units = slice(_cut(din, k, cs), _cut(din, k + 1, cs))
                    back = _chain(me.get(grad(l), every), me.get(f"w{l}", (units, every)).T)
                    h = me.get(f"act{l - 1}", (every, units))
                    put(k, grad(l - 1), (every, units), torch.where(h > 0, back, 0.0),
                        share=l >= 2)
                cols = slice(j0, j1)
                me.set(f"w{l}", (every, cols),
                       me.get(f"w{l}", (every, cols)) + me.get(f"vw{l}", every))
                me.set(f"b{l}", cols, me.get(f"b{l}", cols) + me.get(f"vb{l}", every))
                if cs > 1 and l >= 2:
                    yield  # the gradient sent above is complete everywhere
                    push_rows(k, l)

    gens = [program(k) for k in range(cs)]
    live = True
    while live:
        live = False
        for g in gens:  # each CTA up to its next barrier
            live = next(g, "done") is None or live
        for k, cta in enumerate(ctas):
            for name, got in cta.got.items():
                clash = got & (cta.read[name] | cta.wrote[name])
                assert not clash.any(), f"CTA {k} used {name} while another sent into it"
            cta.marks()
    out = []
    for l in range(L):
        dout = dims[l + 1]
        W, b = torch.empty(dims[l], dout), torch.empty(dout)
        for k in range(cs):
            j0, j1 = _cut(dout, k, cs), _cut(dout, k + 1, cs)
            W[:, j0:j1], b[j0:j1] = ctas[k].buf[f"w{l}"][:, j0:j1], ctas[k].buf[f"b{l}"][j0:j1]
        out.append((W, b))
    return out


# (B, F, C, hidden, steps): narrow widths with C = 5 (at 8 CTAs some own no
# logit), two and three hidden layers (backward products exchanged), one,
# none
K9_MODEL_CASES = {
    "h16_8_c5": (12, 7, 5, (16, 8), 3),
    "h6_9_4_c3": (9, 5, 3, (6, 9, 4), 3),
    "h10": (8, 6, 4, (10,), 3),
    "no_hidden": (7, 6, 5, (), 3),
}


@pytest.mark.parametrize("cs", [2, 4, 8])
@pytest.mark.parametrize("case", sorted(K9_MODEL_CASES))
def test_k9_cluster_dataflow_model(case, cs):
    """K9's exchange schedule: with ``cs`` CTAs a partition, every value a
    CTA reads it computed or received before the last barrier, and no CTA
    sends into a value another may still be reading or writing — so the
    fit equals the one-CTA fit bit for bit, and that one agrees with
    ``mlp_fit_reference``."""
    b, f, c, hidden, steps = K9_MODEL_CASES[case]
    dims = (f, *hidden, c)
    X, y, w, _ = _batch(len(case), 1, b, f, c)
    w[0, ::4] = 0.0
    _, key = _keys(len(case), 1)
    X, y, w = (torch.from_numpy(a[0]) for a in (X, y, w))
    one = _k9_model(key[0], X, y, w, dims, steps, 1)
    got = _k9_model(key[0], X, y, w, dims, steps, cs)
    for (gw, gb), (ow, ob) in zip(got, one):
        assert torch.equal(gw.view(torch.int32), ow.view(torch.int32))
        assert torch.equal(gb.view(torch.int32), ob.view(torch.int32))
    want = tmlp.mlp_fit_reference(key, X[None], y[None], w[None], dims, steps, 0.05, 0.9)
    for (ow, ob), layer in zip(one, want):
        torch.testing.assert_close(ow, layer.w[0], rtol=1e-4, atol=2e-6)
        torch.testing.assert_close(ob, layer.b[0], rtol=1e-4, atol=2e-6)
