"""The port's tenant plane — ``api.run_multi``/``prepare_multi``, the
chunked engine's ``tenants``, ``engine/loop.py`` ``stack_tenants`` and
``parallel/mesh.py`` ``split_tenant_flags``/``tenant_drift_vote`` —
against solo runs and against the JAX package's, on the CPU (the twin of
``tests/test_tenancy.py:62-400``).

Inputs: ``synth:prototypes,seed=...,concepts=6,rows_per_concept=100,
features=5`` streams, 4 partitions, 50 rows a batch. Tolerance: none —
every tenant's flags, vote and detections equal its solo run's and JAX's
bit for bit (deterministic fits).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import distributed_drift_detection_tpu as jpkg  # noqa: E402
from distributed_drift_detection_tpu import config as jconfig  # noqa: E402
from distributed_drift_detection_tpu.engine import loop as jloop  # noqa: E402
from distributed_drift_detection_tpu.parallel import mesh as jmesh  # noqa: E402
import distributed_drift_detection_tpu_torch as tpkg  # noqa: E402
from distributed_drift_detection_tpu_torch import api  # noqa: E402
from distributed_drift_detection_tpu_torch import config as tconfig  # noqa: E402
from distributed_drift_detection_tpu_torch.engine.chunked import ChunkedDetector  # noqa: E402
from distributed_drift_detection_tpu_torch.engine.loop import FlagRows, stack_tenants  # noqa: E402
from distributed_drift_detection_tpu_torch.io.stream import StreamData, stripe_chunk  # noqa: E402
from distributed_drift_detection_tpu_torch.io.synth import planted_prototypes_xy  # noqa: E402
from distributed_drift_detection_tpu_torch.models import ModelSpec, build_model  # noqa: E402
from distributed_drift_detection_tpu_torch.parallel import mesh as tmesh  # noqa: E402

DATASET = "synth:prototypes,seed={tenant},concepts=6,rows_per_concept=100,features=5"
DS0, DS1 = DATASET.format(tenant=0), DATASET.format(tenant=1)


def _cfg(mod, **kw):
    base = dict(dataset=DATASET, mult_data=2, partitions=4, per_batch=50, results_csv="")
    return mod.RunConfig(**{**base, **kw})


def _flags_equal(got, ref, msg=""):
    for f, a, b in zip(ref._fields, got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"{msg} {f}")


@pytest.fixture(scope="module")
def multi():
    """Three tenants of different lengths (ragged), on both packages."""
    kw = dict(dataset=DATASET.replace("rows_per_concept=100", "rows_per_concept=9{tenant}"),
              tenants=3, window=8)
    return (jpkg.run_multi(_cfg(jconfig, **kw)),
            tpkg.run_multi(_cfg(tconfig, **kw), device="cpu"),
            tconfig.tenant_configs(_cfg(tconfig, **kw)))


def test_run_multi_matches_jax(multi):
    j, t, _ = multi
    assert len(t.results) == 3 and t.rows == j.rows
    for a, b in zip(j.results, t.results):
        _flags_equal(b.flags, a.flags)
        np.testing.assert_array_equal(b.drift_vote, a.drift_vote)
        assert b.metrics.num_detections == a.metrics.num_detections
        assert b.metrics.mean_delay_rows == a.metrics.mean_delay_rows
        np.testing.assert_array_equal(b.metrics.delays, a.metrics.delays)
        assert b.config.seed == a.config.seed


def test_ragged_run_multi_matches_solo_runs(multi):
    _, t, cfgs = multi
    lengths = set()
    for r, c in zip(t.results, cfgs):
        solo = api.run(c, device="cpu")
        lengths.add(solo.stream.num_rows)
        _flags_equal(r.flags, solo.flags)
        np.testing.assert_array_equal(r.drift_vote, solo.drift_vote)
        assert r.metrics.num_detections == solo.metrics.num_detections
    assert len(lengths) == 3
    assert t.rows == sum(lengths) and t.agg_rows_per_sec > 0


def test_quarantine_masked_tenants_match_solo():
    """A tenant-specific quarantine mask rides the stacked validity plane."""
    streams = []
    for t in range(2):
        X, y = planted_prototypes_xy(seed=t, concepts=3, rows_per_concept=240, features=7)
        ok = np.ones(len(y), bool)
        ok[np.arange(5 + 3 * t) * 7] = False
        streams.append(StreamData(X=X, y=y, num_classes=3, dist_between_changes=240,
                                  row_ok=ok))
    cfgs = [_cfg(tconfig, seed=t, window=8) for t in range(2)]
    m = api.run_multi(cfgs, streams=streams, device="cpu")
    for t in range(2):
        _flags_equal(m.results[t].flags, api.run(cfgs[t], stream=streams[t], device="cpu").flags)


def test_collect_full_matches_compact():
    cfg = _cfg(tconfig, tenants=2, window=8)
    a = api.run_multi(cfg, device="cpu")
    b = api.run_multi(tconfig.replace(cfg, collect="full"), device="cpu")
    for x, y in zip(a.results, b.results):
        _flags_equal(x.flags, y.flags)


def _tenant_chunks(seed, p=4, b=50, cb=2, k=3):
    X, y = planted_prototypes_xy(seed=seed, concepts=6, rows_per_concept=200, features=5)
    span = p * b * cb
    return [stripe_chunk(X[i * span:(i + 1) * span], y[i * span:(i + 1) * span], i * span,
                         p, b, cb, shuffle_seed=seed + 0x5EED) for i in range(k)]


@pytest.mark.parametrize("kw", [dict(window=1), dict(window=4, rotations=2, shuffle=True)],
                         ids=["loop", "w4r2_shuffle"])
def test_chunked_tenants_match_solo_detectors_and_jax(kw):
    """A ``tenants=3`` detector fed stacked chunks equals three solo
    detectors fed each tenant's chunks, and the JAX package's plane."""
    from distributed_drift_detection_tpu.engine.chunked import ChunkedDetector as JCD
    from distributed_drift_detection_tpu.models import ModelSpec as JSpec
    from distributed_drift_detection_tpu.models import build_model as jbuild

    T = 3
    model = build_model("centroid", ModelSpec(5, 6))
    chunks = [_tenant_chunks(7 + t) for t in range(T)]
    solos = [ChunkedDetector(model, partitions=4, seed=7 + t, device="cpu", **kw)
             for t in range(T)]
    plane = ChunkedDetector(model, partitions=4, seed=7, tenants=T, device="cpu", **kw)
    jplane = JCD(jbuild("centroid", JSpec(5, 6)), partitions=4, seed=7, tenants=T, **kw)
    assert plane.tenant_seeds == (7, 8, 9) and plane.partitions == 12
    for k in range(3):
        stacked = stack_tenants([chunks[t][k] for t in range(T)])
        got = plane.feed(stacked)
        _flags_equal(got, jplane.feed(jloop.Batches(*stacked)), f"chunk {k}")
        for t, per in enumerate(plane.tenant_flags(got)):
            _flags_equal(per, solos[t].feed(chunks[t][k]), f"chunk {k} tenant {t}")


def _leaves(tree):
    from distributed_drift_detection_tpu_torch.utils.checkpoint import _flatten

    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in _flatten(tree)]


def test_tenant_checkpoint_roundtrip(tmp_path):
    """``save_tenant`` writes a solo-shaped checkpoint a solo detector
    restores (its state then a solo detector's that read the same stream),
    and ``restore_tenant`` scatters it into a slot, the others untouched."""
    model = build_model("centroid", ModelSpec(5, 6))
    chunks = [_tenant_chunks(11 + t, k=2) for t in range(2)]
    plane = ChunkedDetector(model, partitions=4, seed=11, tenants=2, window=4, device="cpu")
    for k in range(2):
        plane.feed(stack_tenants([chunks[t][k] for t in range(2)]))
    path = os.path.join(tmp_path, "t1.ckpt")
    plane.save_tenant(path, 1, extra_meta={"rows_admitted": 7})
    solo = ChunkedDetector(model, partitions=4, seed=99, window=4, device="cpu")
    meta = solo.restore(path, example_chunk=chunks[0][0])
    assert meta["tenant"] == 1 and meta["partitions"] == 4 and meta["rows_admitted"] == 7
    ref = ChunkedDetector(model, partitions=4, seed=12, window=4, device="cpu")
    for c in chunks[1]:
        ref.feed(c)
    for a, b in zip(_leaves(solo.carry), _leaves(ref.carry)):
        np.testing.assert_array_equal(a, b)
    before = _leaves(plane.tenant_carry(1))
    plane.restore_tenant(path, 0)
    for a, b in zip(_leaves(plane.tenant_carry(0)), before):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(plane.tenant_carry(1)), before):
        np.testing.assert_array_equal(a, b)
    fresh = ChunkedDetector(model, partitions=4, tenants=2, window=4, device="cpu")
    fresh.restore_tenant(path, 1, example_chunk=stack_tenants([chunks[0][0]] * 2))
    for a, b in zip(_leaves(fresh.tenant_carry(1)), before):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="out of range"):
        plane.tenant_carry(2)


def test_stack_tenants_matches_jax():
    """Ragged tenants pad with masked trailing batches, as JAX stacks them;
    a geometry disagreement is refused."""
    a = stripe_chunk(*planted_prototypes_xy(seed=1, concepts=2, rows_per_concept=100,
                                            features=3), 0, 2, 25, 4)
    b = stripe_chunk(*planted_prototypes_xy(seed=2, concepts=2, rows_per_concept=150,
                                            features=3), 0, 2, 25, 6)
    got = stack_tenants([a, b])
    want = jloop.stack_tenants([jloop.Batches(*a), jloop.Batches(*b)])
    for f in got._fields:
        x, y = getattr(got, f), np.asarray(getattr(want, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert got.y.shape == (4, 6, 25) and not got.valid[:2, 4:].any()
    assert (got.rows[:2, 4:] == -1).all()
    bad = stripe_chunk(*planted_prototypes_xy(seed=1, concepts=2, rows_per_concept=100,
                                              features=3), 0, 2, 20, 5)
    with pytest.raises(ValueError, match="partitions/per_batch"):
        stack_tenants([a, bad])
    with pytest.raises(ValueError, match="at least one"):
        stack_tenants([])


def test_split_tenant_flags_and_votes_match_jax():
    rng = np.random.default_rng(0)
    shape = (6, 9)
    cg = np.where(rng.random(shape) < 0.3, rng.integers(0, 500, shape), -1).astype(np.int32)
    leaves = [cg, cg, cg, cg, rng.random(shape) < 0.1]
    for cols in (None, [9, 5, 7]):
        got = tmesh.split_tenant_flags(FlagRows(*leaves), 3, flag_cols=cols)
        want = jmesh.split_tenant_flags(jloop.FlagRows(*leaves), 3, flag_cols=cols)
        for g, w in zip(got, want):
            _flags_equal(g, w)
            np.testing.assert_array_equal(tmesh.tenant_drift_vote(g), jmesh.tenant_drift_vote(w))
    tflags = tmesh.split_tenant_flags(FlagRows(*(torch.from_numpy(x) for x in leaves)), 2)
    assert tflags[1].change_global.shape == (3, 9)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.split_tenant_flags(FlagRows(*leaves), 4)


def test_run_and_prepare_refuse_a_multi_tenant_config():
    cfg = _cfg(tconfig, tenants=2)
    with pytest.raises(ValueError, match="run_multi"):
        api.run(cfg, device="cpu")
    with pytest.raises(ValueError, match="prepare_multi"):
        api.prepare(cfg, device="cpu")


def test_prepare_multi_refuses_what_jax_refuses():
    """A kernel disagreement and an explicit window disagreement are loud;
    only the auto PH threshold is pinned to tenant 0's."""
    with pytest.raises(ValueError, match="different kernel"):
        api.prepare_multi([_cfg(tconfig, dataset=DS0), _cfg(tconfig, dataset=DS1, per_batch=25)],
                          device="cpu")
    with pytest.raises(ValueError, match="different kernel"):
        api.prepare_multi([_cfg(tconfig, dataset=DS0, window=8),
                           _cfg(tconfig, dataset=DS1, window=4)], device="cpu")
    with pytest.raises(ValueError, match="solo"):
        api.prepare_multi([_cfg(tconfig, tenants=2)], device="cpu")
    ph = tconfig.PHParams(threshold=0.0, delta=0.01)
    short = DS1.replace("rows_per_concept=100", "rows_per_concept=80")
    prep = api.prepare_multi(
        [_cfg(tconfig, dataset=DS0, detector="ph", ph=ph, window=8),
         _cfg(tconfig, dataset=short, detector="ph", ph=ph, window=8, seed=1)],
        device="cpu",
    )
    c0, c1 = prep.configs
    assert c1.ph.threshold == c0.ph.threshold > 0 and c1.ph.delta == 0.01
    jph = jconfig.PHParams(threshold=0.0, delta=0.01)
    jprep = jpkg.api.prepare_multi(
        [_cfg(jconfig, dataset=DS0, detector="ph", ph=jph, window=8),
         _cfg(jconfig, dataset=short, detector="ph", ph=jph, window=8, seed=1)]
    )
    assert [c.ph.threshold for c in jprep.configs] == [c.ph.threshold for c in prep.configs]
    np.testing.assert_array_equal(prep.keys, np.asarray(
        jpkg.api.jax.random.key_data(jprep.keys)))


def test_run_multi_telemetry_and_results_rows(tmp_path):
    """One ``run_started``/``run_completed`` pair carrying ``tenants``, a
    ``kind="multi"`` registry record, and a results row a tenant."""
    from distributed_drift_detection_tpu_torch.results import read_results
    from distributed_drift_detection_tpu_torch.telemetry.events import read_events

    tele, rows = str(tmp_path / "tele"), str(tmp_path / "r.csv")
    m = api.run_multi(_cfg(tconfig, tenants=2, telemetry_dir=tele, results_csv=rows),
                      device="cpu")
    ev = read_events(m.telemetry_path)
    started = [e for e in ev if e["type"] == "run_started"]
    done = [e for e in ev if e["type"] == "run_completed"]
    assert len(started) == len(done) == 1
    assert started[0]["config"]["tenants"] == 2 and done[0]["tenants"] == 2
    with open(os.path.join(tele, "index.jsonl")) as fh:
        assert '"kind": "multi"' in fh.read()
    assert len(read_results(rows)) == 2
