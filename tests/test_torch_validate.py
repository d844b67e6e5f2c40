"""The port's ``utils/validate.py`` and profiler capture against the JAX
package's, on the CPU.

``validate_stream`` and ``validate_flag_rows`` accept and reject what the
JAX package's do, with its messages; ``checked_ddm_window`` passes and
fails the JAX package's checkify checks on the same inputs, with their
messages, and its window equals ``ddm_window``; ``run(validate=True)``
gives the flags of the plain run and of the JAX package's validated run,
and a corrupt stream raises the JAX package's error before any work;
``profile_dir`` and ``trace_dir`` each write one Chrome trace, and the two
together raise the JAX package's ``ValueError``.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import distributed_drift_detection_tpu as jpkg  # noqa: E402
from distributed_drift_detection_tpu import config as jconfig  # noqa: E402
from distributed_drift_detection_tpu.io.stream import StreamData as JStream  # noqa: E402
from distributed_drift_detection_tpu.ops.ddm import DDMState as JDDMState  # noqa: E402
from distributed_drift_detection_tpu.utils import validate as jvalidate  # noqa: E402
import distributed_drift_detection_tpu_torch as tpkg  # noqa: E402
from distributed_drift_detection_tpu_torch import config as tconfig  # noqa: E402
from distributed_drift_detection_tpu_torch.engine.loop import FlagRows  # noqa: E402
from distributed_drift_detection_tpu_torch.io.stream import StreamData as TStream  # noqa: E402
from distributed_drift_detection_tpu_torch.ops import ddm  # noqa: E402
from distributed_drift_detection_tpu_torch.utils import validate as tvalidate  # noqa: E402
from distributed_drift_detection_tpu_torch.utils.timing import trace_files  # noqa: E402

BASE = dict(
    dataset="synth:prototypes,seed=0,concepts=6,rows_per_concept=100,features=5",
    mult_data=3, partitions=4, per_batch=50, results_csv="",
)


def _stream_case(name):
    """(kwargs of a StreamData) for a corruption ``name``."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(60, 4)).astype(np.float32)
    y = rng.integers(0, 3, 60).astype(np.int32)
    ok = np.ones(60, bool)
    if name == "clean":
        return dict(X=X, y=y, num_classes=3)
    if name == "nan_valid":
        X[[7, 30], 2] = np.nan
        return dict(X=X, y=y, num_classes=3)
    if name == "nan_masked":
        X[7, 2] = np.inf
        ok[7] = False
        return dict(X=X, y=y, num_classes=3, row_ok=ok)
    if name == "label_high":
        y[[4, 9]] = [3, 5]
        return dict(X=X, y=y, num_classes=3)
    if name == "label_negative":
        y[11] = -1
        return dict(X=X, y=y, num_classes=3)
    if name == "mask_shape":
        return dict(X=X, y=y, num_classes=3, row_ok=ok[:50])
    if name == "all_masked":
        return dict(X=X, y=y, num_classes=3, row_ok=~ok)
    if name == "table_nan":  # a compressed stream: the table is audited
        X[5, 0] = np.nan
        src = np.tile(np.arange(60, dtype=np.int32), 2)
        return dict(base_X=X, base_y=y, src=src, num_classes=3)
    raise KeyError(name)


STREAM_CASES = ["clean", "nan_valid", "nan_masked", "label_high", "label_negative",
                "mask_shape", "all_masked", "table_nan"]


def _outcome(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", STREAM_CASES)
def test_validate_stream_matches_jax(name):
    want = _outcome(jvalidate.validate_stream, JStream(**_stream_case(name)))
    got = _outcome(tvalidate.validate_stream, TStream(**_stream_case(name)))
    assert got == want
    assert (want is None) == (name in ("clean", "nan_masked"))


def _flag_case(name):
    p, nb, b = 3, 9, 20
    rng = np.random.default_rng(5)
    wl = np.full((p, nb - 1), -1, np.int32)
    cl = np.full((p, nb - 1), -1, np.int32)
    wl[0, 2], cl[0, 2], cl[1, 4] = 3, 8, 11
    rows = (np.arange(1, nb) * b)[None] * p + np.arange(p)[:, None] * b
    wg = np.where(wl >= 0, rows + wl, -1).astype(np.int32)
    cg = np.where(cl >= 0, rows + cl, -1).astype(np.int32)
    forced = rng.random((p, nb - 1)) < 0.1
    num_rows = p * nb * b
    if name == "shape":
        wg = wg[:, :-1]
    elif name == "rows":
        wl, wg, cl, cg, forced = (a[:, :-1] for a in (wl, wg, cl, cg, forced))
    elif name == "local_range":
        cl[2, 1], cg[2, 1] = b, rows[2, 1] + b
    elif name == "global_range":
        cg[1, 4] = num_rows
    elif name == "sentinel":
        wg[2, 5] = 17
    elif name == "order":
        wl[0, 2], wg[0, 2] = 9, rows[0, 2] + 9
    return (FlagRows(wl, wg, cl, cg, forced), nb, b, num_rows)


FLAG_CASES = ["clean", "shape", "rows", "local_range", "global_range", "sentinel", "order"]


@pytest.mark.parametrize("name", FLAG_CASES)
def test_validate_flag_rows_matches_jax(name):
    args = _flag_case(name)
    want = _outcome(jvalidate.validate_flag_rows, *args)
    assert _outcome(tvalidate.validate_flag_rows, *args) == want
    assert (want is None) == (name == "clean")


# state (count, err_sum), errs, valid mask — one partition, W = 2, B = 5
DDM_CASES = {
    "ok": ((7, 2.0), [[0, 1, 0, 0, 1], [0, 0, 0, 1, 0]]),
    "not_indicators": ((7, 2.0), [[0, 1, 0.5, 0, 1], [0, 0, 0, 1, 0]]),
    "negative_count": ((-1, 0.0), [[0, 1, 0, 0, 1], [0, 0, 0, 1, 0]]),
    "err_sum_above_count": ((3, 4.5), [[0, 1, 0, 0, 1], [0, 0, 0, 1, 0]]),
    "near_2_24": ((2**24 - 4, 5.0), [[0, 1, 0, 0, 1], [0, 0, 0, 1, 0]]),
}


@pytest.mark.parametrize("name", sorted(DDM_CASES))
def test_checked_ddm_window_matches_jax(name):
    (count, esum), errs = DDM_CASES[name]
    e = np.asarray(errs, np.float32)
    valid = np.ones(e.shape, bool)
    valid[1, 4] = False
    jstate = JDDMState(jnp.int32(count), jnp.float32(esum), jnp.float32(0.1),
                       jnp.float32(0.05), jnp.float32(0.05))
    jerr, (jend, jres) = jvalidate.checked_ddm_window(jstate, jnp.asarray(e), jnp.asarray(valid))
    tstate = ddm.DDMState(torch.tensor([count], dtype=torch.int32),
                          *(torch.tensor([v], dtype=torch.float32) for v in (esum, 0.1, 0.05, 0.05)))
    terr, (tend, tres) = tvalidate.checked_ddm_window(
        tstate, torch.from_numpy(e)[None], torch.from_numpy(valid)[None])
    assert terr.get() == jerr.get()
    assert (terr.get() is None) == (name == "ok")
    if name == "ok":
        terr.throw()
        for t, j in zip(tres, jres):
            np.testing.assert_array_equal(t[0].numpy(), np.asarray(j))
        np.testing.assert_array_equal(tend.count.numpy(), [int(jend.count)])
    else:
        with pytest.raises(ValueError) as t:
            terr.throw()
        with pytest.raises(ValueError) as j:
            jerr.throw()
        assert str(t.value) == str(j.value)
    want_end, want_res = ddm.ddm_window(tstate, torch.from_numpy(e)[None],
                                        torch.from_numpy(valid)[None])
    for a, b in zip(tend + tres, want_end + want_res):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def plain_run():
    return tpkg.run(tconfig.RunConfig(**BASE), device="cpu")


def test_run_validate_gives_the_same_flags(plain_run):
    """``validate=True`` audits the stream and the flag table and changes no
    flag: the port's validated run equals its plain run and the JAX
    package's validated run."""
    got = tpkg.run(tconfig.RunConfig(**BASE, validate=True), device="cpu")
    want = jpkg.run(jconfig.RunConfig(**BASE, validate=True))
    for name in got.flags._fields:
        np.testing.assert_array_equal(getattr(got.flags, name), getattr(plain_run.flags, name))
        np.testing.assert_array_equal(getattr(got.flags, name), np.asarray(getattr(want.flags, name)))
    assert got.metrics.num_detections == plain_run.metrics.num_detections
    assert got.metrics.mean_delay_rows == plain_run.metrics.mean_delay_rows


def test_run_validate_refuses_a_corrupt_stream_before_any_work(plain_run):
    stream = plain_run.stream
    bad = TStream(X=stream.X.copy(), y=stream.y.copy(), num_classes=stream.num_classes,
                  dist_between_changes=stream.dist_between_changes)
    bad.X[12, 1] = np.nan
    jbad = JStream(X=bad.X, y=bad.y, num_classes=bad.num_classes,
                   dist_between_changes=bad.dist_between_changes)
    with pytest.raises(ValueError) as j:
        jpkg.run(jconfig.RunConfig(**BASE, validate=True), stream=jbad)
    with pytest.raises(ValueError) as t:
        tpkg.run(tconfig.RunConfig(**BASE, validate=True), stream=bad, device="cpu")
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("field", ["profile_dir", "trace_dir"])
def test_profile_and_trace_dirs_write_a_trace(plain_run, tmp_path, field):
    """Each writes one Chrome trace into a timestamped session directory;
    the run's flags are the plain run's. The profile spans the whole Final
    Time span, so it saw the upload and the collect too."""
    d = str(tmp_path / field)
    res = tpkg.run(tconfig.RunConfig(**BASE, **{field: d}), device="cpu")
    for name in res.flags._fields:
        np.testing.assert_array_equal(getattr(res.flags, name), getattr(plain_run.flags, name))
    files = trace_files(d)
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_profile_and_trace_dirs_together_raise_as_in_jax(tmp_path):
    kw = dict(BASE, profile_dir=str(tmp_path / "p"), trace_dir=str(tmp_path / "t"))
    with pytest.raises(ValueError) as j:
        jpkg.run(jconfig.RunConfig(**kw))
    with pytest.raises(ValueError) as t:
        tpkg.run(tconfig.RunConfig(**kw), device="cpu")
    assert str(t.value) == str(j.value)
    assert not (tmp_path / "p").exists() and not (tmp_path / "t").exists()
