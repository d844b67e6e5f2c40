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


# (B, path, network width, composites a thread, threads a CTA): each path's
# edges (csrc/shuffle_perm.cu; ops/shuffle.py k13_layout mirrors it): the
# warp path rounds B up to 32 places, K = width / 32 a lane, 4 warps (batches)
# a CTA; the CTA path takes 16 composites a thread to width 4096, 32
# beyond; the global path half a place a thread, at most 1024.
K13_EDGES = [(1, "warp", 32, 1, 128), (2, "warp", 32, 1, 128), (16, "warp", 32, 1, 128),
             (17, "warp", 32, 1, 128), (32, "warp", 32, 1, 128), (33, "warp", 64, 2, 128),
             (100, "warp", 128, 4, 128), (1024, "warp", 1024, 32, 128),
             (1025, "cta", 2048, 16, 128), (1625, "cta", 2048, 16, 128),
             (1626, "cta", 2048, 16, 128), (4096, "cta", 4096, 16, 256),
             (4097, "cta", 8192, 32, 256), (8192, "cta", 8192, 32, 256),
             (8193, "cta", 16384, 32, 512),
             (16384, "cta", 16384, 32, 512),
             (16385, "global", 32768, 0, 1024), (20000, "global", 32768, 0, 1024)]


@pytest.mark.parametrize("b, path, width, per_thread, threads", K13_EDGES)
def test_k13_layout_paths(b, path, width, per_thread, threads):
    """``k13_layout``'s path, network width and threads at every path edge;
    its shared bytes fit a CTA (227 KB); ``force`` 1 takes the global path
    at any B."""
    lay = shuffle.k13_layout(b)
    assert (lay["path"], lay["npow2"], lay["per_thread"], lay["threads"]) == \
        (path, width, per_thread, threads)
    assert lay["warps"] == (shuffle.K13_WARPS if path == "warp" else 1)
    assert lay["shared_bytes"] <= 232448
    if path == "warp":  # a warp's permutation (33·K ints) and source row (64·K ints, 32·K bytes)
        assert lay["shared_bytes"] == lay["warps"] * (4 * 33 * per_thread + 9 * 32 * per_thread)
    forced = shuffle.k13_layout(b, force=1)
    assert forced["path"] == "global" and forced["shared_bytes"] == 0
    assert forced["npow2"] == 1 << (b - 1).bit_length()


def _bitonic_blocked(v):
    """K13's network on composites ``v [T, K]`` in its blocked layout —
    thread (lane) t holds places t·K .. t·K + K − 1: a stage of stride j < K
    compare-exchanges a thread's own columns r and r | j, one of stride j ≥
    K takes thread t ^ (j / K) (a lane of the warp while j < 32·K, across
    warps on the CTA path beyond); place e keeps the smaller of itself and
    its partner when (e & j == 0) == (e & k == 0). Returns the sorted [T,
    K] and the largest lane xor a stage took."""
    v = v.copy()
    t_n, k_n = v.shape
    n = t_n * k_n
    e = np.arange(n).reshape(t_n, k_n)
    widest = 0
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            up = (e & k) == 0
            if j < k_n:
                lo = [r for r in range(k_n) if not r & j]
                hi = [r | j for r in lo]
                x, y = v[:, lo], v[:, hi]
                swap = (x > y) == up[:, lo]
                v[:, lo], v[:, hi] = np.where(swap, y, x), np.where(swap, x, y)
            else:
                o = v[np.arange(t_n) ^ (j // k_n)]
                widest = max(widest, j // k_n)
                keep_min = ((e & j) == 0) == up
                v = np.where(keep_min, np.minimum(v, o), np.maximum(v, o))
            j //= 2
        k *= 2
    return v, widest


def _k13_model_permutation(key, b, tie_mask):
    """The permutation K13 computes for ``b`` places under ``key`` (numpy
    ``[2]`` uint32), on the layout ``k13_layout`` gives: each round's
    composites (bits << 32) | place, sentinels in the padding, sorted by
    :func:`_bitonic_blocked`; the sorted low words compose with the
    permutation so far."""
    lay = shuffle.k13_layout(b)
    width, k_n = lay["npow2"], lay["per_thread"]
    perm = np.arange(b)
    for _ in range(threefry.permutation_rounds(b)):
        pair = threefry.split(key, 2)
        key, sub = pair[0], pair[1]
        comp = np.full(width, np.uint64(2**64 - 1), np.uint64)
        bits = threefry.random_bits(sub, (b,)).astype(np.uint64) & np.uint64(tie_mask)
        comp[:b] = (bits << np.uint64(32)) | np.arange(b, dtype=np.uint64)
        out, widest = _bitonic_blocked(comp.reshape(width // k_n, k_n))
        assert widest < 32 or lay["path"] == "cta"  # the warp path's xors stay in the warp
        perm = perm[(out.reshape(-1)[:b] & np.uint64(threefry.M32)).astype(np.int64)]
    return perm


@pytest.mark.parametrize("width", [32, 64, 128, 256, 512, 1024])
def test_warp_network_sorts(width):
    """The warp path's index rule (32 lanes of K = width / 32) sorts random
    distinct composites as ``np.sort`` does, lane xors below 32."""
    rng = np.random.default_rng(width)
    comp = rng.choice(2**62, width, replace=False).astype(np.uint64)
    got, widest = _bitonic_blocked(comp.reshape(32, width // 32))
    np.testing.assert_array_equal(got.reshape(-1), np.sort(comp))
    assert widest == 16


@pytest.mark.parametrize("tie_mask", [0, 0x3, 0xFF00, threefry.M32])
@pytest.mark.parametrize("b", [2, 17, 33, 100, 1024])
def test_warp_network_is_the_permutation(b, tie_mask):
    """With draws forced to tie, the warp path's network over composites
    gives ``threefry.permutation`` (the stable sort): the place breaks
    every tie."""
    kd = threefry.key(b)
    np.testing.assert_array_equal(_k13_model_permutation(kd, b, tie_mask),
                                  threefry.permutation(kd, b, tie_mask))


@pytest.mark.parametrize("tie_mask", [0x3, threefry.M32])
@pytest.mark.parametrize("b", [1025, 1626, 2000, 4096, 4097, 16384])
def test_cta_network_is_the_permutation(b, tie_mask):
    """The CTA path's rule — K composites a thread (16 to width 4096, 32
    beyond), the stages that cross warps on thread t ^ (j / K), one or two
    rounds composed — gives
    ``threefry.permutation``, with and without forced ties; at full draws
    JAX's too."""
    kd = threefry.key(b + 1)
    got = _k13_model_permutation(kd, b, tie_mask)
    np.testing.assert_array_equal(got, threefry.permutation(kd, b, tie_mask))
    if tie_mask == threefry.M32:
        np.testing.assert_array_equal(got, np.asarray(jax.random.permutation(
            jax.random.wrap_key_data(jnp.asarray(kd)), b)))


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
