"""The port's ``rf`` (the reference's host RandomForest) against the JAX
package's, and ``utils/threefry.randint`` against ``jax.random.randint``.

``randint`` must equal JAX's bit for bit on 64 seeded keys for every range
below: the rf fit's ``(0, 2^31 − 1)``, small spans, a negative ``minval``,
spans past 2^16 and 2^31, shaped outputs, ``maxval <= minval``. The same
configs then run through the JAX package's ``run`` and the port's
``run(cfg, device='cpu')`` with ``model='rf'`` (``rf_estimators`` 5 on
``synth:`` streams of a few thousand rows): every ``FlagRows`` leaf, the
drift vote and the ``DelayMetrics`` must be equal on the window engine at
R = 3, on ``window=1``, with a zoo detector (HDDM-W) and on a CSV with a
quarantined row. With scikit-learn hidden, ``build_model('rf')`` and
``run`` raise the :class:`ImportError` that names it, before any work.
"""

import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("sklearn")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import distributed_drift_detection_tpu as jpkg  # noqa: E402
from distributed_drift_detection_tpu import config as jconfig  # noqa: E402
from distributed_drift_detection_tpu.models import ModelSpec as JSpec  # noqa: E402
from distributed_drift_detection_tpu.models.rf import make_rf as j_make_rf  # noqa: E402
import distributed_drift_detection_tpu_torch as tpkg  # noqa: E402
from distributed_drift_detection_tpu_torch import config as tconfig  # noqa: E402
from distributed_drift_detection_tpu_torch import convert  # noqa: E402
from distributed_drift_detection_tpu_torch.engine.loop import device_keys  # noqa: E402
from distributed_drift_detection_tpu_torch.io import datasets as tdatasets  # noqa: E402
from distributed_drift_detection_tpu_torch.io import synth as tsynth  # noqa: E402
from distributed_drift_detection_tpu_torch.models import ModelSpec, build_model  # noqa: E402
from distributed_drift_detection_tpu_torch.models import rf as trf  # noqa: E402
from distributed_drift_detection_tpu_torch.utils import threefry  # noqa: E402

SPEC = "prototypes,seed=0,concepts=6,rows_per_concept=100,features=5"
BASE = dict(dataset=f"synth:{SPEC}", mult_data=3, partitions=4, per_batch=50,
            results_csv="", model="rf", rf_estimators=5)

# (shape, minval, maxval): the rf fit's range first
RANGES = [
    ((), 0, 2**31 - 1),
    ((), 0, 7),
    ((5,), -100, 13),
    ((3, 4), 5, 5),
    ((2,), 9, 3),
    ((), -(2**31), 2**31 - 1),
    ((4,), 0, 65537),
    ((4,), -7, 70000),
    ((3,), 0, 2**16),
    ((2,), -(2**31), 0),
    ((2, 3), -(2**31), -(2**31) + 3),
]


@pytest.fixture(scope="module")
def keys():
    """64 seeded keys as JAX keys and as their uint32 data."""
    seeds = np.random.default_rng(0).integers(-(2**31), 2**31, 64)
    jk = [jax.random.key(int(s)) for s in seeds]
    return jk, [np.asarray(jax.random.key_data(k), np.uint32) for k in jk]


@pytest.mark.parametrize("shape, lo, hi", RANGES)
def test_randint_matches_jax(keys, shape, lo, hi):
    for jk, kd in zip(*keys):
        want = np.asarray(jax.random.randint(jk, shape, lo, jnp.int32(hi)))
        got = threefry.randint(kd, shape, lo, hi)
        on_torch = threefry.randint(torch.from_numpy(kd.view(np.int32).copy()), shape, lo, hi)
        assert got.dtype == want.dtype == np.int32 and on_torch.dtype == torch.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(on_torch.numpy(), want)


def test_randint_of_a_batch_of_keys():
    """A key ``[P, 2]`` draws for each partition, as ``vmap`` does."""
    ks = jax.random.split(jax.random.key(3), 6)
    want = jax.vmap(lambda k: jax.random.randint(k, (2,), -5, jnp.int32(1000)))(ks)
    got = threefry.randint(np.asarray(jax.random.key_data(ks)), (2,), -5, 1000)
    np.testing.assert_array_equal(got, np.asarray(want))


def _rf_csv(tmp_path_factory):
    """SPEC as a CSV with data row 100's 4th field NaN (quarantined)."""
    d = tmp_path_factory.mktemp("rf")
    X, y = tsynth.parse_synth(SPEC)
    path = str(d / "dirty.csv")
    tdatasets._write_schema_csv(X, y, path)
    with open(path) as fh:
        lines = fh.read().splitlines()
    f = lines[101].split(",")
    f[3] = "nan"
    lines[101] = ",".join(f)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return dict(dataset=path, data_policy="quarantine",
                quarantine_path=str(d / "q.jsonl"))


CONFIGS = {
    "window_r3": dict(window=8, window_rotations=3),
    "window1": dict(window=1),
    "hddm_w": dict(detector="hddm_w"),
    "quarantined_csv": "csv",
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request, tmp_path_factory):
    kw = CONFIGS[request.param]
    if kw == "csv":
        kw = _rf_csv(tmp_path_factory)
    j = jpkg.run(jconfig.RunConfig(**{**BASE, **kw}))
    t = tpkg.run(tconfig.RunConfig(**{**BASE, **kw}), device="cpu")
    return j, t


def test_rf_flags_equal(pair):
    j, t = pair
    assert j.metrics.num_detections > 0
    for f in j.flags._fields:
        a, b = np.asarray(getattr(j.flags, f)), getattr(t.flags, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_rf_vote_and_metrics_equal(pair):
    j, t = pair
    np.testing.assert_array_equal(np.asarray(j.drift_vote), t.drift_vote)
    for f in dataclasses.fields(j.metrics):
        np.testing.assert_array_equal(
            getattr(j.metrics, f.name), getattr(t.metrics, f.name), err_msg=f.name
        )
    for f in ("window", "window_rotations", "retrain_error_threshold"):
        assert getattr(j.config, f) == getattr(t.config, f), f


def test_rf_fit_seed_matches_jax():
    """The fit's seed is ``randint(key, (), 0, 2^31 − 1)`` of each
    partition's fit key, bit for bit, and the snapshot is the batch."""
    rng = np.random.default_rng(5)
    p, b, f = 4, 30, 5
    X = rng.normal(size=(p, b, f)).astype(np.float32)
    y = rng.integers(0, 3, (p, b)).astype(np.int32)
    w = (rng.random((p, b)) > 0.2).astype(np.float32)
    ks = jax.random.split(jax.random.key(11), p)
    jm = j_make_rf(JSpec(f, 3), b, n_estimators=3)
    jp = jax.vmap(jm.fit)(ks, jnp.asarray(X), jnp.asarray(y), jnp.asarray(w))
    tm = build_model("rf", ModelSpec(f, 3), tconfig.RunConfig(per_batch=b, rf_estimators=3))
    tp = tm.fit(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w),
                key=device_keys(np.asarray(jax.random.key_data(ks)), "cpu"))
    assert tp.seed.dtype == torch.int32
    np.testing.assert_array_equal(tp.seed.numpy(), np.asarray(jp.seed))
    np.testing.assert_array_equal(tp.X.numpy(), X)
    preds_j = np.asarray(jax.vmap(jm.predict)(jp, jnp.asarray(X)))
    np.testing.assert_array_equal(tm.predict(tp, torch.from_numpy(X)).numpy(), preds_j)


def test_rf_convert_round_trips():
    """A JAX ``RFParams`` (numpy leaves, vmapped or one partition) converts
    into the port's, and ``loop_carry`` carries rf's key as key data."""
    from distributed_drift_detection_tpu.models.rf import RFParams as JRF

    rng = np.random.default_rng(6)
    leaves = (rng.normal(size=(3, 10, 4)).astype(np.float32),
              rng.integers(0, 3, (3, 10)).astype(np.int32),
              np.ones((3, 10), np.float32), np.array([1, 2, 2**31 - 2], np.int32))
    t = convert.rf_params(JRF(*leaves))
    assert isinstance(t, trf.RFParams)
    for a, b in zip(leaves, t):
        assert b.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(b.numpy(), a)
    one = convert.rf_params(JRF(*(a[0] for a in leaves)))
    assert one.X.shape == (1, 10, 4) and one.seed.shape == (1,)

    from distributed_drift_detection_tpu.engine.loop import LoopCarry as JCarry
    from distributed_drift_detection_tpu.ops.ddm import ddm_init

    ks = jax.random.split(jax.random.key(2), 3)
    carry = JCarry(
        params=JRF(*leaves), ddm=jax.vmap(lambda _: ddm_init())(jnp.arange(3)),
        a_X=leaves[0], a_y=leaves[1], a_w=leaves[2], retrain=np.ones(3, bool),
        key=jax.random.key_data(ks),
    )
    tc = convert.loop_carry(carry, "rf")
    np.testing.assert_array_equal(tc.key, np.asarray(jax.random.key_data(ks)))
    np.testing.assert_array_equal(tc.params.seed.numpy(), leaves[3])


def test_rf_predictions_ignore_the_cache_state():
    """A forest depends on its snapshot and seed only: a cache of one entry,
    refitting every call, predicts what a cache of many does."""
    rng = np.random.default_rng(7)
    p, b, f = 3, 40, 5
    X = torch.from_numpy(rng.normal(size=(p, b, f)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, (p, b)).astype(np.int32))
    w = torch.ones((p, b))
    key = torch.from_numpy(threefry.split(threefry.key(1), p).view(np.int32))
    small = trf.make_rf(ModelSpec(f, 3), b, n_estimators=4, cache_size=1)
    big = trf.make_rf(ModelSpec(f, 3), b, n_estimators=4, cache_size=64)
    params = small.fit(X, y, w, key=key)
    for _ in range(2):
        np.testing.assert_array_equal(small.predict(params, X).numpy(),
                                      big.predict(params, X).numpy())
    # the all-zero snapshot predicts class 0
    assert not small.predict(small.init(p), X).any()


def _hide_sklearn(monkeypatch):
    for name in ("sklearn", "sklearn.ensemble"):
        monkeypatch.setitem(sys.modules, name, None)


def test_rf_without_sklearn_raises_importerror(monkeypatch):
    _hide_sklearn(monkeypatch)
    with pytest.raises(ImportError, match="scikit-learn") as e:
        build_model("rf", ModelSpec(5, 3))
    assert "host RandomForest" in str(e.value)
    # before any work: the dataset is never opened
    cfg = tconfig.RunConfig(**{**BASE, "dataset": "no/such/data.csv"})
    with pytest.raises(ImportError, match="scikit-learn"):
        tpkg.run(cfg, device="cpu")


def test_rf_model_is_keyed_and_host_side():
    m = build_model("rf", ModelSpec(5, 3), tconfig.RunConfig(per_batch=20))
    assert m.keyed and m.host_callback and m.name == "rf"
    params = m.init(2)
    assert params.X.shape == (2, 20, 5) and params.seed.dtype == torch.int32


def test_rf_refuses_an_explicit_mesh():
    """As the JAX package refuses it (``api.py`` ``_build_runner``), before
    the mesh's own refusal (ROADMAP A15)."""
    with pytest.raises(ValueError, match="host callback"):
        tpkg.run(tconfig.RunConfig(**{**BASE, "mesh_devices": 2}), device="cpu")
