"""The port's streaming ingest — ``engine/chunked.py`` ``ChunkedDetector``,
``io/feeder.py``, ``io/stream.py``'s chunk stripers, ``io/synth.py``'s
chunk generators, ``api.prepare_chunked`` and the ``chunked`` CLI —
against the JAX package's, on the CPU (the twin of ``tests/test_chunked.py``
and ``tests/test_ingest_pipeline.py``).

Inputs: ``synth:prototypes,seed=0,concepts=6,rows_per_concept=100,
features=5`` ×3 (1,800 rows), 4 partitions, 50 rows a batch, 3 batches a
chunk; CSVs of those rows, clean and dirty. Tolerance: none — chunks,
planes and ``FlagRows`` are compared bit for bit (the fits here are
deterministic).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

from distributed_drift_detection_tpu import config as jconfig  # noqa: E402
from distributed_drift_detection_tpu.engine.chunked import ChunkedDetector as JCD  # noqa: E402
from distributed_drift_detection_tpu.harness import chunked_cli as jcli  # noqa: E402
from distributed_drift_detection_tpu.io import feeder as jfeed  # noqa: E402
from distributed_drift_detection_tpu.io import stream as jstream  # noqa: E402
from distributed_drift_detection_tpu.io import synth as jsynth  # noqa: E402
from distributed_drift_detection_tpu.models import ModelSpec as JSpec  # noqa: E402
from distributed_drift_detection_tpu.models import build_model as jbuild  # noqa: E402
from distributed_drift_detection_tpu.ops.detectors import make_detector as jdet  # noqa: E402
from distributed_drift_detection_tpu_torch import api, convert  # noqa: E402
from distributed_drift_detection_tpu_torch import config as tconfig  # noqa: E402
from distributed_drift_detection_tpu_torch.engine.chunked import ChunkedDetector as TCD  # noqa: E402
from distributed_drift_detection_tpu_torch.engine.loop import Batches  # noqa: E402
from distributed_drift_detection_tpu_torch.harness import chunked_cli as tcli  # noqa: E402
from distributed_drift_detection_tpu_torch.io import feeder as tfeed  # noqa: E402
from distributed_drift_detection_tpu_torch.io import stream as tstream  # noqa: E402
from distributed_drift_detection_tpu_torch.io import synth as tsynth  # noqa: E402
from distributed_drift_detection_tpu_torch.io.datasets import _write_schema_csv  # noqa: E402
from distributed_drift_detection_tpu_torch.models import ModelSpec, build_model  # noqa: E402
from distributed_drift_detection_tpu_torch.ops.detectors import make_detector as tdet  # noqa: E402
from distributed_drift_detection_tpu_torch.telemetry.metrics import MetricsRegistry  # noqa: E402

SPEC = "prototypes,seed=0,concepts=6,rows_per_concept=100,features=5"
P, B, CB = 4, 50, 3


@pytest.fixture(scope="module")
def stream():
    return jstream.load_stream("synth:" + SPEC, 3, seed=0)


def _pair(stream, model="centroid", detector="ddm", **kw):
    s = (stream.num_features, stream.num_classes)
    ph = {"ph": jconfig.PHParams(threshold=8.0)} if detector == "ph" else {}
    j = JCD(jbuild(model, JSpec(*s)), partitions=P, detector=jdet(detector, **ph), **kw)
    ph = {"ph": tconfig.PHParams(threshold=8.0)} if detector == "ph" else {}
    t = TCD(build_model(model, ModelSpec(*s)), partitions=P, detector=tdet(detector, **ph),
            device="cpu", **kw)
    return j, t


def _chunks(mod, stream, shuffle_seed=5, **kw):
    return mod.chunk_stream_arrays(stream.X, stream.y, P, B, CB, shuffle_seed=shuffle_seed, **kw)


def _flags_equal(j, t):
    for f, a, b in zip(j._fields, j, t):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)


ENGINES = {
    "loop": dict(window=1),
    "w8r2": dict(window=8, rotations=2),
    "loop_shuffle": dict(window=1, shuffle=True),
    "w4r2_shuffle": dict(window=4, rotations=2, shuffle=True),
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_chunked_matches_jax_chunked(stream, engine):
    """The port's ChunkedDetector gives the JAX package's flags on the same
    chunks, with the host shuffle and with the in-loop one."""
    j, t = _pair(stream, **ENGINES[engine])
    jf = j.run(_chunks(jfeed, stream))
    tf = t.run(_chunks(tfeed, stream))
    assert (tf.change_global >= 0).any()
    _flags_equal(jf, tf)
    assert t.batches_done == j.batches_done and t.rows_done == j.rows_done


@pytest.mark.parametrize("window", [1, 8])
def test_chunked_equals_oneshot(stream, window):
    """Chunked with the host shuffle = ``api.run``'s one-shot flags (JAX's
    contract, ``tests/test_api_chunked_parity.py``)."""
    cfg = tconfig.RunConfig(dataset="synth:" + SPEC, mult_data=3, partitions=P, per_batch=B,
                            window=window, window_rotations=1, results_csv="")
    one = api.run(cfg, device="cpu")
    _, t = _pair(stream, window=window)
    got = t.run(_chunks(tfeed, stream, tconfig.host_shuffle_seed(cfg)))
    _flags_equal(one.flags, got)


@pytest.mark.parametrize("detector", ["ph", "hddm_w"])
def test_chunked_zoo_matches_jax(stream, detector):
    j, t = _pair(stream, detector=detector, window=8)
    _flags_equal(j.run(_chunks(jfeed, stream)), t.run(_chunks(tfeed, stream)))


@pytest.mark.parametrize("window", [1, 8])
def test_checkpoint_resume_exact(stream, window, tmp_path):
    """Save after chunk 2, restore into a fresh detector: the remaining
    flags equal the uninterrupted run's."""
    _, full = _pair(stream, window=window)
    whole = full.run(_chunks(tfeed, stream))
    chunks = list(_chunks(tfeed, stream))
    _, a = _pair(stream, window=window)
    head = [a.feed(c) for c in chunks[:2]]
    path = str(tmp_path / "c.ckpt")
    a.save(path)
    _, b = _pair(stream, window=window)
    meta = b.restore(path, example_chunk=chunks[0])
    assert meta["batches_done"] == a.batches_done == b.batches_done
    tail = [b.feed(c) for c in chunks[2:]]
    _flags_equal(whole, [np.concatenate([f[i].numpy() for f in head + tail], 1)
                         for i in range(5)])


def test_auto_retrain_guard_resolution(stream):
    """RETRAIN_AUTO resolves per family as the JAX engine resolves it."""
    for model in ("gnb", "centroid", "forest", "mlp"):
        j, t = _pair(stream, model=model)
        assert t.retrain_error_threshold == j.retrain_error_threshold


def test_carry_handed_over_from_jax_mid_stream(stream):
    """JAX's detector runs two chunks; its carry, through
    ``convert.loop_carry`` (key kept), lets the port's detector run the
    rest with JAX's flags — in-loop shuffle included."""
    import jax

    chunks_j = list(_chunks(jfeed, stream))
    chunks_t = list(_chunks(tfeed, stream))
    for kw in (dict(window=8, rotations=2), dict(window=1, shuffle=True)):
        j, t = _pair(stream, **kw)
        for c in chunks_j[:2]:
            j.feed(c)
        carry = j.carry._replace(key=jax.random.key_data(j.carry.key))
        t.carry = convert.loop_carry(carry, "centroid", keep_key=True)
        t.batches_done = j.batches_done
        jrest = [j.feed(c) for c in chunks_j[2:]]
        trest = [t.feed(c) for c in chunks_t[2:]]
        for jf, tf in zip(jrest, trest):
            _flags_equal(jf, tf)
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(j.carry.key)), t.carry.key)


def test_bf16_transport_plane_matches_ml_dtypes(stream):
    """The uint16 plane of bfloat16 bits is ``ml_dtypes``' cast bit for bit
    (NaN, ±inf, subnormals and ties included), through ``stripe_chunk`` and
    the pooled striper; a bf16 chunked run gives JAX's bf16 flags."""
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2**32, 50000, dtype=np.uint64).astype(np.uint32)
    u[:6] = [0x7F800001, 0xFF800001, 0x7F800000, 0xFF800000, 0x3F808000, 0x0000FFFF]
    x = u.view(np.float32)
    with np.errstate(all="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(tstream.to_bfloat16_bits(x), want)
    X, y = stream.X[:700], stream.y[:700]
    jc = jstream.stripe_chunk(X, y, 0, P, B, 4, 3, feature_dtype=ml_dtypes.bfloat16)
    for dt in ("bfloat16", torch.bfloat16):
        tc = tstream.stripe_chunk(X, y, 0, P, B, 4, 3, feature_dtype=dt)
        st = tstream.ChunkStriper(P, B, 4, 3, feature_dtype=dt).stripe(X, y, 0)
        for c in (tc, st):
            assert c.X.dtype == np.uint16
            np.testing.assert_array_equal(c.X, np.asarray(jc.X).view(np.uint16))
            for f in ("y", "rows", "valid"):
                np.testing.assert_array_equal(getattr(c, f), np.asarray(getattr(jc, f)))
    j, t = _pair(stream, window=8)
    jf = j.run(_chunks(jfeed, stream, feature_dtype=ml_dtypes.bfloat16))
    tf = t.run(_chunks(tfeed, stream, feature_dtype="bfloat16"))
    _flags_equal(jf, tf)


def test_chunk_striper_is_stripe_chunk_and_reuses_its_staging(stream):
    """The pooled striper's chunks equal ``stripe_chunk``'s, masked rows and
    a short last span included; a chunk handed on stays intact after the
    striper is reused."""
    st = tstream.ChunkStriper(P, B, CB, 5)
    first = st.stripe(stream.X[:600], stream.y[:600], 0)
    kept = Batches(*(x.copy() for x in first))
    mask = np.arange(400) % 7 != 3
    second = st.stripe(stream.X[600:1000], stream.y[600:1000], 600, row_valid=mask)
    want = tstream.stripe_chunk(stream.X[600:1000], stream.y[600:1000], 600, P, B, CB, 5,
                                row_valid=mask)
    for f in Batches._fields:
        np.testing.assert_array_equal(getattr(second, f), getattr(want, f))
        np.testing.assert_array_equal(getattr(first, f), getattr(kept, f))


def test_synth_chunks_and_generator_chunks_match_jax():
    for fn, kw in ((tsynth.sea_chunk, dict(drift_every=700, noise=0.1)),
                   (tsynth.hyperplane_chunk, dict(features=6, drift_every=500, rotate_scale=0.01)),
                   (tsynth.hyperplane_chunk, dict(features=4))):
        jfn = getattr(jsynth, fn.__name__)
        for start, stop in ((0, 1000), (1234, 2999)):
            for a, b in zip(fn(3, start, stop, **kw), jfn(3, start, stop, **kw)):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    tch = list(tfeed.generator_chunks(lambda s, e: tsynth.sea_chunk(1, s, e, 900),
                                      5000, P, B, CB, shuffle_seed=2))
    jch = list(jfeed.generator_chunks(lambda s, e: jsynth.sea_chunk(1, s, e, 900),
                                      5000, P, B, CB, shuffle_seed=2))
    assert len(tch) == len(jch) == 9
    for a, b in zip(tch, jch):
        for f in Batches._fields:
            np.testing.assert_array_equal(getattr(a, f), np.asarray(getattr(b, f)))


def _dirty_csv(path, n=900, f=4, seed=7):
    """NaN cells, non-numeric cells, bad labels and ragged rows, straddling
    block edges at small ``block_bytes`` (``tests/test_ingest_pipeline.py``)."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        row = [repr(float(v)) for v in rng.normal(size=f)]
        row.append(str(int(rng.integers(0, 5))))
        if i % 83 == 3:
            row[1] = "nan"
        if i % 127 == 5:
            row[0] = "junk"
        if i % 149 == 7:
            row[f] = "bad"
        if i % 211 == 9:
            row = row[:f]
        if i % 173 == 11:
            row[f] = "2.5"
        lines.append(",".join(row))
    with open(path, "w") as fh:
        fh.write(",".join(f"f{i}" for i in range(f)) + ",target\n")
        fh.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    d = tmp_path_factory.mktemp("chunked")
    clean = str(d / "clean.csv")
    _write_schema_csv(*tsynth.parse_synth(SPEC), clean)
    dirty = str(d / "dirty.csv")
    _dirty_csv(dirty)
    return {"clean": clean, "dirty": dirty, "dir": d}


@pytest.mark.parametrize("policy, which", [(None, "clean"), ("strict", "clean"),
                                           ("quarantine", "dirty"), ("repair", "dirty")])
@pytest.mark.parametrize("workers", [1, 3])
def test_csv_chunks_match_jax(csvs, policy, which, workers):
    """``csv_chunks`` at 1 and 3 workers, one batch a chunk: JAX's chunks
    bit for bit, and the same quarantine sidecar (streaming repair from
    running means)."""
    out = {}
    for name, mod in (("jax", jfeed), ("port", tfeed)):
        side = str(csvs["dir"] / f"{name}-{policy}-{workers}.jsonl")
        reg = MetricsRegistry() if name == "port" else None
        out[name] = (list(mod.csv_chunks(
            csvs[which], P, B, 1, shuffle_seed=5, block_bytes=2048, workers=workers,
            data_policy=policy, quarantine_path=side, num_classes=5, metrics=reg,
        )), side, reg)
    (jc, jside, _), (tc, tside, reg) = out["jax"], out["port"]
    assert len(jc) == len(tc) > 1
    for a, b in zip(jc, tc):
        for f in Batches._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), getattr(b, f), err_msg=f)
    if policy in ("quarantine", "repair"):
        with open(jside) as fj, open(tside) as ft:
            assert ft.read() == fj.read()
    rows = int(reg.counter("ingest_rows_total").values[()])
    assert rows == sum(int(np.asarray(c.valid).sum()) for c in tc) + int(
        reg.counter("ingest_quarantined_total").values.get((), 0))
    assert set(tfeed.stage_breakdown(reg)) == {"read", "parse", "sanitize", "stripe"}


@pytest.mark.parametrize("workers", [1, 3])
def test_csv_chunked_run_matches_jax(csvs, workers):
    """The CSV through ``prefetch_chunks`` and both detectors: equal flags;
    the upload stage is accounted."""
    j = JCD(jbuild("centroid", JSpec(5, 6)), partitions=P, window=8)
    t = TCD(build_model("centroid", ModelSpec(5, 6)), partitions=P, window=8, device="cpu")
    reg = MetricsRegistry()
    jf = j.run(jfeed.csv_chunks(csvs["clean"], P, B, CB, shuffle_seed=5, workers=workers))
    tf = t.run(tfeed.prefetch_chunks(
        tfeed.csv_chunks(csvs["clean"], P, B, CB, shuffle_seed=5, workers=workers,
                         metrics=reg), metrics=reg), metrics=reg)
    _flags_equal(jf, tf)
    assert tfeed.stage_breakdown(reg)["upload"] > 0


def test_run_groups_and_telemetry_keep_the_flags(stream, tmp_path):
    """``collect_every`` groups and a telemetered drain give the default
    run's flags; the log holds a chunk event and a heartbeat a chunk."""
    from distributed_drift_detection_tpu_torch.telemetry.events import EventLog, read_events

    _, a = _pair(stream, window=8)
    want = a.run(_chunks(tfeed, stream))
    _, b = _pair(stream, window=8)
    _flags_equal(want, b.run(_chunks(tfeed, stream), collect_every=2))
    log = EventLog.open_run(str(tmp_path), name="chunked")
    _, c = _pair(stream, window=8, validate=True)
    _flags_equal(want, c.run(_chunks(tfeed, stream), telemetry=log, metrics=MetricsRegistry()))
    log.close()
    kinds = [e["type"] for e in read_events(log.path)]
    assert kinds.count("chunk_completed") == kinds.count("heartbeat") == 3


def test_prefetch_propagates_producer_errors():
    def bad():
        yield 1
        raise RuntimeError("producer broke")

    it = tfeed.prefetch_chunks(bad())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer broke"):
        next(it)
    assert tfeed.resolve_ingest_workers(0) == jfeed.resolve_ingest_workers(0)
    assert tfeed.resolve_ingest_workers(3) == 3


def test_prepare_chunked_and_its_refusals():
    cfg = tconfig.RunConfig(partitions=P, per_batch=B, window=8, results_csv="")
    det, info = api.prepare_chunked(cfg, 5, 6, chunk_batches=CB, device="cpu")
    assert info["aot_shapes"] == 2 and info["aot_failed"] is False
    assert {"cached", "build_seconds", "aot_seconds"} <= set(info)
    assert det.partitions == P and det.carry is None
    jcfg = jconfig.RunConfig(partitions=P, per_batch=B, window=8, results_csv="")
    from distributed_drift_detection_tpu import api as japi

    for kw, args, err in ((dict(window=0), (5, 6), "window=0"),
                          ({}, (0, 6), "serving geometry"),
                          ({}, (5, -1), "serving geometry")):
        for fn, c in ((lambda *a, **k: api.prepare_chunked(*a, device="cpu", **k),
                       tconfig.replace(cfg, **kw)),
                      (japi.prepare_chunked, jconfig.replace(jcfg, **kw))):
            with pytest.raises(ValueError, match=err):
                fn(c, *args)
    with pytest.raises(ValueError, match="chunk_batches"):
        api.prepare_chunked(cfg, 5, 6, chunk_batches=0, device="cpu")
    # a mesh is ported: prepare_chunked on a 2-device mesh gives the JAX
    # package's detector on its 2-device mesh, flags bit for bit
    from distributed_drift_detection_tpu.parallel.mesh import make_mesh as jmesh
    from distributed_drift_detection_tpu_torch.parallel.mesh import make_mesh

    stream = jstream.load_stream("synth:" + SPEC, 3, seed=0)
    tdet_, _ = api.prepare_chunked(cfg, 5, 6, chunk_batches=CB, device="cpu",
                                   mesh=make_mesh(devices=["cpu"] * 2))
    jdet_, _ = japi.prepare_chunked(jcfg, 5, 6, chunk_batches=CB, mesh=jmesh(2))
    _flags_equal(jdet_.run(_chunks(jfeed, stream)), tdet_.run(_chunks(tfeed, stream)))
    m = build_model("centroid", ModelSpec(5, 6))
    with pytest.raises(ValueError, match="not divisible"):
        TCD(m, partitions=P, mesh=make_mesh(devices=["cpu"] * 3), device="cpu")
    # on_drift is ported (tests/test_torch_adapt.py): as in the JAX package,
    # a bad policy spec is refused when the first drained chunk resolves it
    rng = np.random.default_rng(0)
    chunk = tstream.stripe_chunk(rng.standard_normal((P * B * CB, 5)).astype(np.float32),
                                 rng.integers(0, 6, P * B * CB).astype(np.int32), 0, P, B, CB)
    for det in (TCD(m, partitions=P, on_drift="refit", device="cpu"),
                JCD(jbuild("centroid", JSpec(5, 6)), partitions=P, on_drift="refit")):
        with pytest.raises(ValueError, match="unknown on_drift policy"):
            det.run([chunk])
    # the chunk tracer is ported: an empty drain takes one and emits nothing
    assert TCD(m, partitions=P, device="cpu").run([], tracer=object()).change_global.shape == (P, 0)
    with pytest.raises(ValueError, match="rotations"):
        TCD(m, partitions=P, rotations=2, device="cpu")


@pytest.mark.parametrize("extra", [[], ["--data-policy", "quarantine"]],
                         ids=["clean", "quarantine"])
def test_chunked_cli_matches_jax(csvs, capsys, tmp_path, extra):
    """The ``chunked`` subcommand's final JSON line: JAX's rows, chunks,
    detections and quarantined counts (JAX's CLI at 1 worker, the port's
    at 1 and 4)."""
    from distributed_drift_detection_tpu_torch.__main__ import main as tmain

    dataset = csvs["dirty"] if extra else csvs["clean"]
    classes = "5" if extra else "6"
    keys = ("rows", "chunks", "detections", "quarantined")
    outs = {}
    for workers in ("1", "4"):
        args = [dataset, "--classes", classes, "--partitions", str(P), "--per-batch", str(B),
                "--chunk-batches", str(CB), "--ingest-workers", workers,
                "--block-bytes", "4096", *extra]
        if extra:
            args += ["--quarantine-path", str(tmp_path / f"q{workers}.jsonl")]
        if workers == "1":
            jcli.main(list(args))
            j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        tmain(["chunked", *args], device="cpu")
        t = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
        assert set(t["pipeline_s"]) == set(j["pipeline_s"])
        assert t["ingest_workers"] == int(workers)
        outs[workers] = t["detections"]
    assert outs["1"] == outs["4"]
    # --trace-sample is ported (its spans: tests/test_torch_serve_planes.py);
    # untelemetered it samples nothing and the counts stay JAX's
    tcli.main([dataset, "--classes", classes, "--partitions", str(P), "--per-batch", str(B),
               "--chunk-batches", str(CB), "--trace-sample", "0.5", *extra,
               *(["--quarantine-path", str(tmp_path / "qt.jsonl")] if extra else [])],
              device="cpu")
    t = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
