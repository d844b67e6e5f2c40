"""The in-loop shuffle (``shuffle=True``) of the port against the JAX
package's, on the CPU.

``utils/threefry.py`` ``permutation`` must equal ``jax.random.permutation``
bit for bit (jax 0.9.0: 0 sorts at n = 1, one up to 1625, two from 1626),
and ``ops/shuffle.py`` ``shuffle_planes_reference`` — the plain version of
kernel K13 — must be that permutation applied to a span's planes. The
engines with ``shuffle=True`` then give JAX's ``FlagRows`` bit for bit for
the deterministic fits (centroid with DDM, gnb with Page–Hinkley) on the
loop engine and on the window engine at W = 4 with R = 1 and R = 2; the mlp
is held to the C4 bar (ROADMAP: its detections JAX's, their mean delay
within one batch). Inputs: ``synth:prototypes,seed=0,concepts=6,
rows_per_concept=100,features=5`` ×3, 4 partitions, 50 rows a batch.
K13 itself is held to this plain version on the card
(``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_drift_detection_tpu import config as jconfig  # noqa: E402
from distributed_drift_detection_tpu.engine import loop as jloop  # noqa: E402
from distributed_drift_detection_tpu.engine import window as jwindow  # noqa: E402
from distributed_drift_detection_tpu.io import stream as jstream  # noqa: E402
from distributed_drift_detection_tpu.models import ModelSpec as JSpec  # noqa: E402
from distributed_drift_detection_tpu.models import build_model as jbuild  # noqa: E402
from distributed_drift_detection_tpu.ops.detectors import make_detector as jdet  # noqa: E402
from distributed_drift_detection_tpu_torch import config as tconfig  # noqa: E402
from distributed_drift_detection_tpu_torch.engine import loop as tloop  # noqa: E402
from distributed_drift_detection_tpu_torch.engine import window as twindow  # noqa: E402
from distributed_drift_detection_tpu_torch.models import ModelSpec, build_model  # noqa: E402
from distributed_drift_detection_tpu_torch.ops import shuffle  # noqa: E402
from distributed_drift_detection_tpu_torch.ops.detectors import make_detector as tdet  # noqa: E402
from distributed_drift_detection_tpu_torch.utils import threefry  # noqa: E402

DATASET = "synth:prototypes,seed=0,concepts=6,rows_per_concept=100,features=5"
SEEDS = (0, 3, 12345, 2**31 - 1)


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1625, 1626, 2000])
def test_permutation_matches_jax(n):
    """Bit for bit, from numpy keys and from torch keys, over several keys
    at once (a leading key axis)."""
    keys = jnp.stack([jax.random.key_data(jax.random.key(s)) for s in SEEDS])
    want = np.stack([np.asarray(jax.random.permutation(jax.random.key(s), n)) for s in SEEDS])
    kd = np.asarray(keys, np.uint32)
    np.testing.assert_array_equal(threefry.permutation(kd, n), want)
    np.testing.assert_array_equal(
        threefry.permutation(torch.from_numpy(kd.astype(np.int64)), n).numpy(), want
    )


def test_permutation_rounds_at_the_boundaries():
    assert [threefry.permutation_rounds(n) for n in (0, 1, 2, 1625, 1626, 2000)] == \
        [0, 0, 1, 1, 2, 2]


@pytest.mark.parametrize("tie_mask", [0, 0x3, 0xFF00])
def test_permutation_with_forced_ties_is_the_stable_sort(tie_mask):
    """Draws ANDed with a mask tie often: each round is a stable sort (a
    tie keeps the earlier place first), the same in numpy and torch."""
    kd = threefry.key(7)
    for n in (100, 1626):
        x = np.arange(n)
        k = kd
        for _ in range(threefry.permutation_rounds(n)):
            pair = threefry.split(k, 2)
            k, sub = pair[0], pair[1]
            bits = threefry.random_bits(sub, (n,)) & tie_mask
            x = x[np.argsort(bits, kind="stable")]
        np.testing.assert_array_equal(threefry.permutation(kd, n, tie_mask), x)
        got = threefry.permutation(torch.from_numpy(kd.astype(np.int64)), n, tie_mask)
        np.testing.assert_array_equal(got.numpy(), x)
    if tie_mask == 0:  # every draw ties: the identity
        np.testing.assert_array_equal(threefry.permutation(kd, 50, 0), np.arange(50))


@pytest.mark.parametrize("derive", [True, False])
@pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32])
def test_shuffle_planes_is_the_permutation_of_each_batch(derive, idx_dtype):
    """K13's plain version: batch ``start[p] + i`` of each partition,
    permuted with ``split(keys[p], W)[i]`` (derive) or ``keys[p, i]``."""
    rng = np.random.default_rng(0)
    p, nb, w, b = 3, 9, 4, 30
    idx = torch.from_numpy(rng.integers(0, 1000, (p, nb, b))).to(idx_dtype)
    rows = torch.from_numpy(rng.integers(0, 10**6, (p, nb, b)).astype(np.int32))
    valid = torch.from_numpy(rng.random((p, nb, b)) < 0.7)
    start = torch.tensor([0, 3, 5])
    if derive:
        keys = threefry.split(threefry.key(1), p)
        per = threefry.split(keys, w)
    else:
        keys = threefry.split(threefry.key(1), p * w).reshape(p, w, 2)
        per = keys
    got = shuffle.shuffle_planes(
        torch.from_numpy(keys.view(np.int32)), idx, rows, valid, w, start, derive=derive
    )
    for q in range(p):
        for i in range(w):
            perm = threefry.permutation(per[q, i], b)
            s = int(start[q]) + i
            assert got[0][q, i].tolist() == idx[q, s][perm].int().tolist()
            assert got[1][q, i].tolist() == rows[q, s][perm].tolist()
            assert got[2][q, i].tolist() == valid[q, s][perm].tolist()
    assert got[0].dtype == torch.int32


def _models(name):
    spec = jstream.load_stream(DATASET, 3, seed=0)
    s = (spec.num_features, spec.num_classes)
    if name == "mlp":
        kw = dict(mlp_hidden=(16, 8), fit_steps=8)
        return (jbuild("mlp", JSpec(*s), jconfig.RunConfig(**kw)),
                build_model("mlp", ModelSpec(*s), tconfig.RunConfig(**kw)))
    return jbuild(name, JSpec(*s)), build_model(name, ModelSpec(*s))


@pytest.fixture(scope="module")
def planes():
    stream = jstream.load_stream(DATASET, 3, seed=0)
    b = jstream.stripe_partitions(stream, 4, 50)
    return (jloop.Batches(*(jnp.asarray(x) for x in b)),
            tloop.Batches(*(torch.from_numpy(np.ascontiguousarray(x)) for x in b)),
            stream.dist_between_changes)


ENGINES = [(1, 1), (4, 1), (4, 2)]


def _runners(model, detector, window, rotations):
    jm, tm = _models(model)
    jd = jdet(detector, ph=jconfig.PHParams(threshold=8.0)) if detector == "ph" else None
    td = tdet(detector, ph=tconfig.PHParams(threshold=8.0)) if detector == "ph" else None
    if window == 1:
        return (jax.vmap(jloop.make_partition_runner(jm, jconfig.DDMParams(), detector=jd)),
                tloop.make_partition_runner(tm, tconfig.DDMParams(), detector=td))
    return (
        jax.vmap(jwindow.make_window_runner(jm, jconfig.DDMParams(), window=window,
                                            rotations=rotations, shuffle=True, detector=jd)),
        twindow.make_window_runner(tm, tconfig.DDMParams(), window=window,
                                   rotations=rotations, shuffle=True, detector=td),
    )


def _run_both(planes, model, detector, window, rotations):
    jb, tb, _ = planes
    jrun, trun = _runners(model, detector, window, rotations)
    keys = jax.random.split(jax.random.key(0), 4)
    return jrun(jb, keys), trun(tb, np.asarray(jax.random.key_data(keys), np.uint32))


@pytest.mark.parametrize("window, rotations", ENGINES, ids=["loop", "w4r1", "w4r2"])
@pytest.mark.parametrize("model, detector", [("centroid", "ddm"), ("gnb", "ph")])
def test_shuffled_engines_match_jax(planes, model, detector, window, rotations):
    """``make_partition_runner`` (the JAX default ``shuffle=True``) and
    ``make_window_runner(shuffle=True)``: JAX's flags bit for bit."""
    jf, tf = _run_both(planes, model, detector, window, rotations)
    assert (np.asarray(jf.change_global) >= 0).any()
    for f in jf._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jf, f)), getattr(tf, f).numpy(), err_msg=f)


@pytest.mark.parametrize("window, rotations", [(1, 1), (4, 2)], ids=["loop", "w4r2"])
def test_shuffled_mlp_meets_the_c4_bar(planes, window, rotations):
    """The mlp's fits agree with JAX's to a tolerance only (C4): its
    detections a partition are JAX's and their mean delay is within one
    batch."""
    jf, tf = _run_both(planes, "mlp", "ddm", window, rotations)
    jc, tc = np.asarray(jf.change_global), tf.change_global.numpy()
    np.testing.assert_array_equal((jc >= 0).sum(1), (tc >= 0).sum(1))
    d = planes[2]
    assert abs(np.mean(jc[jc >= 0] % d) - np.mean(tc[tc >= 0] % d)) <= 50


def test_a_shuffle_without_a_key_is_refused():
    _, tm = _models("centroid")
    run = tloop.make_partition_runner(tm, tconfig.DDMParams())
    b = tloop.Batches(torch.zeros((2, 3, 4, 5)), torch.zeros((2, 3, 4), dtype=torch.int32),
                      torch.zeros((2, 3, 4), dtype=torch.int32), torch.ones((2, 3, 4), dtype=torch.bool))
    with pytest.raises(ValueError, match="keys"):
        run(b)
    span = twindow.make_window_span(tm, tconfig.DDMParams(), window=2, shuffle=True)
    carry = tloop.LoopCarry(tm.init(2, "cpu"), tdet("ddm").init((2,), "cpu"), b.X[:, 0],
                            b.y[:, 0], b.valid[:, 0].float(), torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError, match="key"):
        span(carry, b)


def test_the_step_shuffles_its_own_batch_as_the_runner_does(planes):
    """``make_partition_step(shuffle=True)`` called with no precomputed keys
    splits the carry's key and permutes its batch itself (one K13 launch
    a step on the card): step by step, the runner's flags."""
    _, tb, _ = planes
    _, tm = _models("centroid")
    keys = threefry.split(threefry.key(0), 4)
    want = tloop.make_partition_runner(tm, tconfig.DDMParams())(tb, keys)
    step = tloop.make_partition_step(tm, tconfig.DDMParams())
    table, labels, idx = tloop.dense_table(tb.X, tb.y)
    carry = tloop.LoopCarry(tm.init(4, "cpu"), tdet("ddm").init((4,), "cpu"),
                            tb.X[:, 0].contiguous(), tb.y[:, 0].contiguous(),
                            tb.valid[:, 0].float(), torch.ones(4, dtype=torch.bool),
                            threefry.split(keys, 2)[:, 0])
    got = []
    for s in range(1, tb.y.shape[1]):
        carry, f = step(carry, table, labels, idx[:, s], tb.rows[:, s], tb.valid[:, s])
        got.append(f)
    for i, name in enumerate(want._fields):
        np.testing.assert_array_equal(torch.stack([f[i] for f in got], 1).numpy(),
                                      getattr(want, name).numpy(), err_msg=name)
