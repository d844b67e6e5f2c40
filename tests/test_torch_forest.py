"""The port's oblique forest (``models/forest.py``) against the JAX package's
``make_forest``.

The same numpy inputs and the same threefry keys go through both. The
fit's draws — ``proj``, the uniforms and the order-statistic indices — are
JAX's jitted fit's bit for bit. The projections ``X @ proj`` follow the
port's fixed order (an f32 chain over the features, ROADMAP C6), so with
JAX's ``proj`` carried across the thresholds agree to ``rtol`` 1e-6 and
the leaf classes are equal on batches whose rows sit off the thresholds;
with JAX's fitted parameters carried across the predictions are equal off
the near ties. ``run`` with ``model='forest'`` gives JAX's detections and a
mean delay within a batch of it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import distributed_drift_detection_tpu as jpkg  # noqa: E402
from distributed_drift_detection_tpu import config as jconfig  # noqa: E402
from distributed_drift_detection_tpu.models import ModelSpec as JSpec  # noqa: E402
from distributed_drift_detection_tpu.models.classifiers import make_forest as j_forest  # noqa: E402
import distributed_drift_detection_tpu_torch as tpkg  # noqa: E402
from distributed_drift_detection_tpu_torch import config as tconfig  # noqa: E402
from distributed_drift_detection_tpu_torch import convert  # noqa: E402
from distributed_drift_detection_tpu_torch.models import ModelSpec, build_model  # noqa: E402
from distributed_drift_detection_tpu_torch.models import forest as tforest  # noqa: E402
from distributed_drift_detection_tpu_torch.models.base import pad_row_table  # noqa: E402
from distributed_drift_detection_tpu_torch.utils import threefry  # noqa: E402

# (P, B, F, C, trees, depth)
CASES = {
    "smoke_width": (2, 100, 21, 40, 8, 3),
    "rialto_width": (3, 64, 27, 10, 4, 2),
    "depth1": (2, 50, 5, 3, 3, 1),
    "one_tree": (2, 30, 7, 4, 1, 3),
    # the shapes the kernels' layouts branch on: trees across a warp's
    # boundary, a column of more rows than a warp's registers hold (with
    # repeated rows, so equal keys meet the stable order), and C = 2,000
    # (K12's counters in device memory)
    "trees33": (2, 60, 5, 4, 33, 2),
    "b1500_repeated": (2, 1500, 5, 6, 4, 2),
    "c2000": (2, 100, 5, 2000, 4, 2),
}


def _batch(seed, p, b, f, c):
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(c, f)).astype(np.float32) * 2
    y = rng.integers(0, c, (p, b)).astype(np.int32)
    X = (protos[y] + 0.5 * rng.normal(size=(p, b, f))).astype(np.float32)
    w = (rng.random((p, b)) < 0.9).astype(np.float32)
    return X, y, w


def _keys(seed, p):
    keys = jax.random.split(jax.random.key(seed), p)
    return keys, np.asarray(jax.random.key_data(keys), np.uint32)


def _jax_fit(case, seed=0, w_override=None):
    p, b, f, c, trees, depth = CASES[case]
    X, y, w = _batch(seed, p, b, f, c)
    if "repeated" in case:  # each run of 5 rows one row, one label
        src = np.arange(b) // 5 * 5
        X, y = X[:, src], y[:, src]
    if w_override is not None:
        w = w_override
    keys, kd = _keys(seed + 1, p)
    m = j_forest(JSpec(f, c), trees=trees, depth=depth)
    jp = jax.jit(jax.vmap(m.fit))(keys, X, y, w)
    return (X, y, w, kd), jp, m


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gap(X, jp):
    """Each row's float64 distance from each node's threshold, and twice
    the error bound of two f32 chains of F products (both sides' chains):
    ``(F + 1)·2^-23·Σ|x·p|`` each."""
    x, pr = X.astype(np.float64), np.asarray(jp.proj, np.float64)
    z64 = np.einsum("pbf,pfm->pbm", x, pr)
    scale = np.einsum("pbf,pfm->pbm", np.abs(x), np.abs(pr))
    gap = np.abs(z64 - np.asarray(jp.thresh, np.float64)[:, None, :])
    return gap, 2 * (x.shape[-1] + 1) * 2.0**-23 * scale


def _jax_draws(kd, f, trees, depth):
    """JAX's u and idx-free draws, jitted as the fit draws them."""
    tn = trees * ((1 << depth) - 1)

    def draw(k):
        _, kt = jax.random.split(jax.random.wrap_key_data(k))
        return jax.random.uniform(kt, (tn,), minval=0.1, maxval=0.9)

    return np.asarray(jax.jit(jax.vmap(draw))(jnp.asarray(kd)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_draws_bit_for_bit(case):
    """proj and the uniforms equal the jitted JAX fit's; so does idx, the
    order statistic each threshold takes."""
    (X, y, w, kd), jp, _ = _jax_fit(case)
    p, b, f, c, trees, depth = CASES[case]
    proj, u = tforest.forest_draws(kd, f, trees, depth)
    np.testing.assert_array_equal(proj.numpy().view(np.int32), np.asarray(jp.proj).view(np.int32))
    ju = _jax_draws(kd, f, trees, depth)
    np.testing.assert_array_equal(u.numpy().view(np.int32), ju.view(np.int32))
    nv = np.maximum(w.sum(1, dtype=np.float32), np.float32(1))
    jidx = np.clip((ju * nv[:, None]).astype(np.int32), 0, b - 1)
    tidx = (u * torch.from_numpy(nv)[:, None]).to(torch.int32).clamp(0, b - 1).numpy()
    np.testing.assert_array_equal(tidx, jidx)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_matches_jax(case):
    """Thresholds to rtol 1e-6; leaf classes equal where no row sits within
    float32 rounding of a threshold it is compared with."""
    (X, y, w, kd), jp, _ = _jax_fit(case)
    p, b, f, c, trees, depth = CASES[case]
    tp = tforest.forest_fit(kd, _t(X), _t(y), _t(w), trees, depth, c)
    np.testing.assert_allclose(tp.thresh.numpy(), np.asarray(jp.thresh), rtol=1e-6, atol=1e-6)
    # partitions whose rows sit off the thresholds: each row's float64
    # projection farther than the f32 chains' error from every threshold
    # but the one it is the source of (there both sides compare equal)
    gap, tol = _gap(X, jp)
    source = tforest.project(_t(X), tp.proj).numpy() == tp.thresh.numpy()[:, None, :]
    near = (gap < tol) & ~source
    clean = ~near.any(axis=(1, 2))
    assert clean.any()
    np.testing.assert_array_equal(tp.leaf_class.numpy()[clean], np.asarray(jp.leaf_class)[clean])


def test_fit_all_weights_zero():
    """An all-invalid batch: +inf thresholds, every leaf the batch majority
    (class 0), as JAX."""
    p, b, f, c, trees, depth = CASES["depth1"]
    (X, y, w, kd), jp, _ = _jax_fit("depth1", w_override=np.zeros((p, b), np.float32))
    tp = tforest.forest_fit(kd, _t(X), _t(y), _t(w), trees, depth, c)
    assert np.isinf(tp.thresh.numpy()).all() and np.isinf(np.asarray(jp.thresh)).all()
    np.testing.assert_array_equal(tp.leaf_class.numpy(), np.asarray(jp.leaf_class))


@pytest.mark.parametrize("case", sorted(CASES))
def test_predict_with_carried_params(case):
    """JAX's fitted params carried across: the port's predict (and
    predict_err through the padded row table) equal JAX's predict off the
    rows that sit within rounding of a threshold."""
    (X, y, w, kd), jp, m = _jax_fit(case)
    p, b, f, c, trees, depth = CASES[case]
    rng = np.random.default_rng(9)
    qX, qy, _ = _batch(9, p, 300, f, c)
    jpred = np.asarray(jax.vmap(m.predict)(jp, qX))
    params = convert.forest_params(jp)
    tpred = tforest.forest_predict_reference(params, _t(qX)).numpy()
    gap, tol = _gap(qX, jp)
    near = (gap < tol).any(-1)
    assert (~near).sum() > 0.5 * near.size
    np.testing.assert_array_equal(tpred[~near], jpred[~near])
    table = qX.reshape(-1, f)
    labels = qy.reshape(-1)
    idx = rng.permutation(len(labels)).reshape(p, -1).astype(np.int16)
    err, pred = tforest.forest_predict_err(params, pad_row_table(_t(table)), _t(labels),
                                           _t(idx), return_pred=True)
    want = tforest.forest_predict_reference(params, _t(table[idx.astype(np.int64)]))
    np.testing.assert_array_equal(pred.numpy(), want.numpy())
    np.testing.assert_array_equal(err.numpy(), (want.numpy() != labels[idx]).astype(np.float32))


def test_predict_ties_go_to_the_lowest_class():
    """Two trees voting 3 and 1: the lowest class wins, as jnp.argmax."""
    p, f, trees, depth = 1, 2, 2, 1
    params = tforest.ForestParams(
        torch.ones((p, f, trees)), torch.zeros((p, trees)),
        torch.tensor([[[3, 3], [1, 1]]], dtype=torch.int32))
    pred = tforest.forest_predict_reference(params, torch.ones((p, 4, f)))
    assert (pred == 1).all()


def test_sort_keys_order_like_jnp_sort():
    v = np.array([np.nan, 1.0, -0.0, 0.0, -np.inf, np.inf, -2.5, 0.0, -0.0], np.float32)
    order = torch.sort(tforest.sort_keys(torch.from_numpy(v)), stable=True).indices.numpy()
    np.testing.assert_array_equal(v[order].view(np.int32), np.asarray(jnp.sort(v)).view(np.int32))


def _select_row_model(keys, k):
    """K11's warp select (csrc/forest_fit.cu ``select_row``) in NumPy: the
    row at rank ``k`` in the stable order of the int32 ``keys``, by a radix
    select from the highest bit the keys differ in until one candidate is
    left, then the rank among the candidates in the order of 32-row slots
    and lanes (row order). Also returns the passes taken."""
    u = (keys.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000  # the signed order, unsigned
    b = len(u)
    all_, any_ = int(np.bitwise_and.reduce(u)), int(np.bitwise_or.reduce(u))
    key, ge, passes = all_, 0xFFFFFFFF, 0
    if all_ != any_:
        hb = (all_ ^ any_).bit_length() - 1
        ge = ~(0xFFFFFFFF >> (31 - hb)) & 0xFFFFFFFF
        key &= ge
        total = b
        for bit in range(hb, -1, -1):
            if total <= 1:
                break
            gb = ge | (1 << bit)
            below = int(((u & gb) == key).sum())  # the ballots' popcounts
            if k >= below:
                k -= below
                key |= 1 << bit
                total -= below
            else:
                total = below
            ge = gb
            passes += 1
    for s in range((b + 31) // 32):
        r = np.arange(s * 32, min(s * 32 + 32, b))
        eq = r[(u[r] & ge) == key]
        if k < len(eq):
            return int(eq[k]), passes
        k -= len(eq)
    raise AssertionError("rank past the rows")


@pytest.mark.parametrize("b", [1, 2, 31, 100, 128, 129, 1500])
def test_k11_select_model_is_the_stable_sort(b):
    """K11's selection finds every rank of jnp.sort's stable order: keys of
    floats with repeats, ±0, ±inf, NaN and invalid rows (as +inf)."""
    rng = np.random.default_rng(b)
    pool = np.array([0.0, -0.0, 1.5, -2.25, np.inf, -np.inf, np.nan, 1e-40, -1e-40],
                    np.float32)
    z = np.where(rng.random(b) < 0.3, rng.choice(pool, b),
                 rng.normal(size=b).astype(np.float32) * 4)
    z = np.where(rng.random(b) < 0.2, z[rng.integers(0, b, b)], z).astype(np.float32)
    valid = rng.random(b) < 0.85
    zs = np.where(valid, z, np.float32(np.inf)).astype(np.float32)
    keys = tforest.sort_keys(torch.from_numpy(zs)).numpy()
    order = np.argsort(keys, kind="stable")
    for k in range(b):
        assert _select_row_model(keys, k)[0] == order[k]
    same = np.full(b, 7, np.int32)  # one key: the rank is the row
    assert [_select_row_model(same, k)[0] for k in range(b)] == list(range(b))
    # distinct values: a few passes more than log2 B on the mean (as many
    # as two close keys need to part), not 32
    keys = tforest.sort_keys(torch.from_numpy(rng.normal(size=b).astype(np.float32))).numpy()
    passes = [_select_row_model(keys, k)[1] for k in range(b)]
    assert np.mean(passes) <= b.bit_length() + 8 and max(passes) <= 32


def _tally_model(votes, classes):
    """K12's per-thread tally (csrc/forest_predict_err.cu ``Tally``) in
    Python: counters of 8, 16 or 32 bits (by T) packed in 32-bit words,
    the mode kept as the votes come, then the counters cleared — through
    the kept votes when that is cheaper than every word. Returns the mode
    and whether every counter was left at zero."""
    trees = len(votes)
    bits = 8 if trees < 256 else 16 if trees < 65536 else 32
    lg_bits = bits.bit_length() - 1
    lg_cpw = 5 - lg_bits
    words = -(-classes // (1 << lg_cpw))
    mask = (1 << bits) - 1
    cnt = [0] * words
    best = best_n = 0
    for v in votes:
        if not 0 <= v < classes:
            continue  # jax.nn.one_hot drops it
        w, sh = v >> lg_cpw, (v & ((1 << lg_cpw) - 1)) << lg_bits
        cnt[w] = (cnt[w] + (1 << sh)) & 0xFFFFFFFF
        k = (cnt[w] >> sh) & mask
        if k > best_n or (k == best_n and v < best):
            best, best_n = v, k
    if words > trees:  # cleared through the kept votes
        for v in votes:
            if 0 <= v < classes:
                cnt[v >> lg_cpw] = 0
    else:
        cnt = [0] * words
    return best, not any(cnt)


@pytest.mark.parametrize("trees, classes", [(1, 3), (32, 40), (33, 5), (64, 2000),
                                            (300, 7), (255, 40), (256, 40), (40, 2000)])
def test_k12_tally_model_is_the_modal_vote(trees, classes):
    """K12's O(T) tally gives the plain version's modal vote (ties to the
    lowest class) on votes in [0, C), and jnp.argmax of JAX's one-hot
    tally when some votes lie outside it; its counters end at zero."""
    rng = np.random.default_rng(trees * 7 + classes)
    for _ in range(40):
        span = min(classes, int(rng.integers(1, 6)))
        votes = rng.integers(0, span, trees) * max(1, classes // span)
        got, clean = _tally_model(votes.tolist(), classes)
        assert clean
        want = tforest.forest_predict_reference(tforest.ForestParams(
            torch.zeros((1, 1, trees)), torch.zeros((1, trees)),
            torch.from_numpy(np.repeat(votes.astype(np.int32)[None, :, None], 2, 2))),
            torch.zeros((1, 1, 1)))
        assert got == int(want)
    votes = rng.integers(-3, classes + 3, trees)
    got, clean = _tally_model(votes.tolist(), classes)
    tally = jnp.sum(jax.nn.one_hot(jnp.asarray(votes), classes), axis=0)
    assert clean and got == int(jnp.argmax(tally))


@pytest.mark.parametrize("kw, match", [
    (dict(trees=0), "forest_trees"), (dict(depth=0), "forest_depth"),
    (dict(depth=17), "forest_depth")])
def test_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match) as t:
        tforest.make_forest(ModelSpec(5, 3), **kw)
    with pytest.raises(ValueError, match=match) as j:
        j_forest(JSpec(5, 3), **kw)
    assert str(t.value) == str(j.value)


def test_build_model_reads_the_config():
    m = build_model("forest", ModelSpec(5, 3), tconfig.RunConfig(forest_trees=3, forest_depth=2))
    assert m.keyed and m.name == "forest"
    params = m.init(2)
    assert params.proj.shape == (2, 5, 9) and params.leaf_class.shape == (2, 3, 4)
    assert build_model("rf", ModelSpec(5, 3)).keyed  # rf is ported (tests/test_torch_rf.py)


BASE = dict(
    dataset="synth:prototypes,seed=0,concepts=6,rows_per_concept=100,features=5",
    mult_data=3, partitions=4, per_batch=50, results_csv="",
    model="forest", forest_trees=4, forest_depth=2,
)
RUNS = {
    "auto": {},
    "r1": dict(window_rotations=1),
    "window1": dict(window=1),
    "deeper": dict(forest_trees=8, forest_depth=3),
}


@pytest.fixture(scope="module", params=sorted(RUNS))
def run_pair(request):
    kw = {**BASE, **RUNS[request.param]}
    return (request.param, jpkg.run(jconfig.RunConfig(**kw)),
            tpkg.run(tconfig.RunConfig(**kw), device="cpu"))


def test_run_matches_jax(run_pair):
    """JAX's detections, a mean delay within a batch of it, and the same
    resolved config (the forest's retrain guard included); whether the
    flags are equal bit for bit is printed."""
    name, j, t = run_pair
    jm, tm = j.metrics, t.metrics
    assert jm.num_detections > 0
    assert tm.num_detections == jm.num_detections
    assert abs(tm.mean_delay_rows - jm.mean_delay_rows) <= BASE["per_batch"]
    for f in ("window", "window_rotations", "retrain_error_threshold"):
        assert getattr(j.config, f) == getattr(t.config, f), f
    same = all(np.array_equal(np.asarray(getattr(j.flags, f)), getattr(t.flags, f))
               for f in j.flags._fields)
    print(f"forest {name}: flags {'equal' if same else 'NOT equal'} to JAX's; "
          f"{tm.num_detections} detections, {tm.mean_delay_rows:.4f} rows "
          f"(JAX {jm.mean_delay_rows:.4f})")


def test_run_metrics_are_complete(run_pair):
    _, j, t = run_pair
    assert [f.name for f in dataclasses.fields(t.metrics)] == \
        [f.name for f in dataclasses.fields(j.metrics)]
    assert t.flags.change_global.shape == np.asarray(j.flags.change_global).shape


def test_loop_carry_keeps_the_forest_key():
    from distributed_drift_detection_tpu.engine.loop import LoopCarry as JCarry
    from distributed_drift_detection_tpu.ops.ddm import ddm_init

    m = j_forest(JSpec(5, 3), trees=2, depth=2)
    one = JCarry(m.init(None), ddm_init(), jnp.ones((4, 5)), jnp.zeros(4, jnp.int32),
                 jnp.ones(4), jnp.bool_(True), jax.random.key_data(jax.random.key(3)))
    jc = jax.tree.map(lambda a: jnp.stack([a, a]), one)
    tc = convert.loop_carry(jc, "forest")
    assert tc.params.proj.shape == (2, 5, 6) and tc.params.leaf_class.dtype == torch.int32
    np.testing.assert_array_equal(tc.key, np.asarray(jc.key, np.uint32))
    np.testing.assert_array_equal(threefry.split(tc.key, 2)[:, 0],
                                  np.asarray(jax.random.key_data(jax.vmap(
                                      lambda k: jax.random.split(jax.random.wrap_key_data(k))[0])(
                                          jc.key))))
