"""CSV ingest of the port against the JAX package's, under the stream contract.

The same CSVs — written here from ``synth:`` streams in the reference's
schema (header ``0..F-1,target``), a dirty copy with a NaN cell, a ragged
row and a non-integral label, and a rialto-schema fixture — go through the
JAX package's loaders and ``run(cfg)`` and through the port's
``load_csv``, ``load_csv_sane`` and ``run(cfg, device='cpu')``: parsed
bits, masks, quarantine reports and sidecars, ``StreamContractError``
messages, every ``FlagRows`` leaf, the vote and the ``DelayMetrics`` must
be equal.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import distributed_drift_detection_tpu as jpkg  # noqa: E402
from distributed_drift_detection_tpu import config as jconfig  # noqa: E402
from distributed_drift_detection_tpu.io import blocks as jblocks  # noqa: E402
from distributed_drift_detection_tpu.io import datasets as jdatasets  # noqa: E402
from distributed_drift_detection_tpu.io import native as jnative  # noqa: E402
from distributed_drift_detection_tpu.io import sanitize as jsanitize  # noqa: E402
from distributed_drift_detection_tpu.io import stream as jstream  # noqa: E402
from distributed_drift_detection_tpu.resilience import faults as jfaults  # noqa: E402
import distributed_drift_detection_tpu_torch as tpkg  # noqa: E402
from distributed_drift_detection_tpu_torch import config as tconfig  # noqa: E402
from distributed_drift_detection_tpu_torch.io import blocks as tblocks  # noqa: E402
from distributed_drift_detection_tpu_torch.io import datasets as tdatasets  # noqa: E402
from distributed_drift_detection_tpu_torch.io import native as tnative  # noqa: E402
from distributed_drift_detection_tpu_torch.io import sanitize as tsanitize  # noqa: E402
from distributed_drift_detection_tpu_torch.io import stream as tstream  # noqa: E402
from distributed_drift_detection_tpu_torch.io import synth as tsynth  # noqa: E402
from distributed_drift_detection_tpu_torch.resilience import faults as tfaults  # noqa: E402

SPEC = "prototypes,seed=0,concepts=6,rows_per_concept=100,features=5"
GEOMETRY = dict(mult_data=3, partitions=4, per_batch=50, results_csv="")


def _dirty(lines: list[str]) -> list[str]:
    """The data lines (header first) with data row 100's 4th field NaN,
    data row 250 ragged (its last two fields dropped) and data row 400's
    label non-integral."""
    out = list(lines)
    f = out[101].split(",")
    f[3] = "nan"
    out[101] = ",".join(f)
    out[251] = ",".join(out[251].split(",")[:-2])
    f = out[401].split(",")
    f[-1] = f[-1] + ".5"
    out[401] = ",".join(f)
    return out


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    """Paths of the SMOKE-shaped twin, its dirty copy and a rialto fixture."""
    d = tmp_path_factory.mktemp("csv")
    X, y = tsynth.parse_synth(SPEC)
    clean = str(d / "clean.csv")
    tdatasets._write_schema_csv(X, y, clean)
    with open(clean) as fh:
        lines = fh.read().splitlines()
    dirty = str(d / "dirty.csv")
    with open(dirty, "w") as fh:
        fh.write("\n".join(_dirty(lines)) + "\n")
    rialto = str(d / "rialto.csv")
    tdatasets.rialto_fixture_csv(rialto, rows_per_class=60, seed=3)
    return {"clean": clean, "dirty": dirty, "rialto": rialto, "dir": d}


def _eq(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def test_schema_writer_matches_jax(csvs, tmp_path):
    X, y = tsynth.parse_synth(SPEC)
    j = str(tmp_path / "j.csv")
    assert jdatasets._write_schema_csv(X, y, j) == (len(y), X.shape[1])
    with open(j) as a, open(csvs["clean"]) as b:
        assert a.read() == b.read()


def test_rialto_fixture_matches_jax(csvs, tmp_path):
    j = str(tmp_path / "j.csv")
    jdatasets.rialto_fixture_csv(j, rows_per_class=60, seed=3)
    with open(j) as a, open(csvs["rialto"]) as b:
        assert a.read() == b.read()


def test_convert_data_labels_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    np.savetxt(tmp_path / "x.data", rng.normal(size=(30, 6)))
    np.savetxt(tmp_path / "x.labels", rng.integers(0, 3, 30), fmt="%d")
    args = (str(tmp_path / "x.data"), str(tmp_path / "x.labels"))
    assert tdatasets.convert_data_labels_to_csv(*args, str(tmp_path / "t.csv")) == \
        jdatasets.convert_data_labels_to_csv(*args, str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


def test_native_parser_builds_into_the_port(csvs):
    """The port compiles native/ddd_native.cc into its own build directory
    (never into native/), keyed by the source's hash."""
    assert tnative.native_available()
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert "distributed_drift_detection_tpu_torch" in str(path)


@pytest.mark.parametrize("name", ["clean", "rialto"])
def test_load_csv_parsers_agree(csvs, monkeypatch, name):
    """The native parser, the NumPy parser and the JAX package's load_csv
    give the same bits."""
    path = csvs[name]
    tX, ty = tstream.load_csv(path)
    jX, jy = jstream.load_csv(path)
    _eq(tX, jX, "X")
    _eq(ty, jy, "y")
    monkeypatch.setattr(tnative, "load_csv_native", lambda p: None)
    nX, ny = tstream.load_csv(path)
    _eq(nX, tX, "numpy X")
    _eq(ny, ty, "numpy y")


def test_load_csv_errors_match_jax(csvs, tmp_path):
    """A missing target column and a ragged file raise the JAX package's
    messages."""
    bad = tmp_path / "notarget.csv"
    bad.write_text("a,b\n1,2\n")
    for load in (tstream.load_csv, jstream.load_csv):
        with pytest.raises(ValueError, match="target column 'target' not in header"):
            load(str(bad))
    with pytest.raises(ValueError) as t:
        tstream.load_csv(csvs["dirty"])
    with pytest.raises(ValueError) as j:
        jstream.load_csv(csvs["dirty"])
    assert str(t.value) == str(j.value)


def test_parse_block_matches_jax(csvs):
    with open(csvs["clean"], "rb") as fh:
        fh.readline()
        block = fh.read()
    _eq(tnative.parse_block(block, 6), jnative.parse_block(block, 6))
    with open(csvs["dirty"], "rb") as fh:
        fh.readline()
        dirty = fh.read()
    with pytest.raises(ValueError):
        tnative.parse_block(dirty, 6)


def test_line_block_ranges_match_jax(csvs):
    fh, buf, start = tblocks.open_mapped(csvs["clean"])
    try:
        for bb in (1, 100, 4096, 10**6):
            assert tblocks.line_block_ranges(buf, start, bb) == \
                jblocks.line_block_ranges(buf, start, bb)
    finally:
        buf.close()
        fh.close()


def _sane(mod, path, policy, sidecar):
    return mod.load_csv_sane(path, policy=policy, quarantine_path=sidecar)


def _sidecar(path):
    with open(path) as fh:
        return fh.read().splitlines()


@pytest.mark.parametrize("policy", ["quarantine", "repair"])
def test_load_csv_sane_matches_jax(csvs, tmp_path, policy):
    """X, y, row_ok, the QuarantineReport (the sidecar path aside) and the
    sidecar line for line."""
    t = _sane(tsanitize, csvs["dirty"], policy, str(tmp_path / "t.jsonl"))
    j = _sane(jsanitize, csvs["dirty"], policy, str(tmp_path / "j.jsonl"))
    _eq(t.X, j.X, "X")
    _eq(t.y, j.y, "y")
    _eq(t.row_ok, j.row_ok, "row_ok")
    assert t.report._replace(sidecar=None) == j.report._replace(sidecar=None)
    assert t.report.rows_quarantined == (3 if policy == "quarantine" else 1)
    assert _sidecar(tmp_path / "t.jsonl") == _sidecar(tmp_path / "j.jsonl")
    assert tsanitize.read_quarantine(str(tmp_path / "t.jsonl")) == \
        jsanitize.read_quarantine(str(tmp_path / "j.jsonl"))


def test_strict_raises_the_jax_message(csvs):
    with pytest.raises(tsanitize.StreamContractError) as t:
        tsanitize.load_csv_sane(csvs["dirty"])
    with pytest.raises(jsanitize.StreamContractError) as j:
        jsanitize.load_csv_sane(csvs["dirty"])
    assert str(t.value) == str(j.value)
    assert (t.value.row, t.value.column, t.value.total) == (j.value.row, j.value.column, 3)


@pytest.mark.parametrize("header", ["0,1,1,target", "0,,1,target", "0,1,2"])
@pytest.mark.parametrize("policy", ["strict", "quarantine", "repair"])
def test_bad_headers_raise_under_every_policy(tmp_path, header, policy):
    path = tmp_path / "h.csv"
    path.write_text(header + "\n1,2,3,0\n")
    with pytest.raises(tsanitize.StreamContractError) as t:
        tsanitize.load_csv_sane(str(path), policy=policy)
    with pytest.raises(jsanitize.StreamContractError) as j:
        jsanitize.load_csv_sane(str(path), policy=policy)
    assert str(t.value) == str(j.value)


def test_clean_csv_has_no_report(csvs):
    for policy in ("strict", "quarantine", "repair"):
        t = tsanitize.load_csv_sane(csvs["clean"], policy=policy)
        assert t.row_ok is None and t.report is None
    with pytest.raises(ValueError, match="unknown data_policy"):
        tsanitize.load_csv_sane(csvs["clean"], policy="lenient")


def test_scan_csv_matches_jax(csvs):
    for jobs in (1, 3):
        assert tsanitize.scan_csv(csvs["dirty"], jobs=jobs) == \
            jsanitize.scan_csv(csvs["dirty"], jobs=jobs)


def test_streaming_repair_matches_jax(csvs):
    """The block-wise policy helpers: running column means, label-domain
    demotion, repair and the strict/quarantine block policy."""
    with open(csvs["dirty"]) as fh:
        header = fh.readline().strip().split(",")
        lines = fh.read().splitlines()
    out = []
    for mod in (tsanitize, jsanitize):
        arr, issues = mod.parse_rows(lines, len(header))
        issues += mod.scan_matrix(arr, 5, header, flagged=frozenset(i.row for i in issues))
        stats = mod.RunningColumnStats(len(header))
        stats.update(arr)
        issues = mod.demote_unroundable_labels(issues, arr, 5, 6)
        arr, rest, fixed = mod.repair_rows(arr, issues, 5, stats)
        arr, ok = mod.apply_block_policy(arr, rest, path="x", policy="quarantine")
        out.append((arr, ok, fixed, stats.means()))
    for a, b in zip(*out):
        _eq(a, b)


@pytest.mark.parametrize("kind", ["nan_cell", "bad_label", "ragged_row"])
def test_stream_load_fault_site_matches_jax(csvs, kind):
    """The ``stream.load`` corruption kinds dirty the same rows in both."""
    try:
        tfaults.arm("stream.load", kind=kind, times=3, seed=7)
        jfaults.arm("stream.load", kind=kind, times=3, seed=7)
        t = tsanitize.load_csv_sane(csvs["clean"], policy="quarantine")
        j = jsanitize.load_csv_sane(csvs["clean"], policy="quarantine")
    finally:
        tfaults.disarm_all()
        jfaults.disarm_all()
    _eq(t.X, j.X)
    _eq(t.row_ok, j.row_ok)
    assert t.report == j.report and t.report.rows_quarantined == 3


def test_masked_stream_matches_jax(csvs):
    """synthesize_stream with a quarantine mask, and the dense stripe that
    folds it into the validity plane; the packed striper refuses it."""
    t = _sane(tsanitize, csvs["dirty"], "quarantine", None)
    for mult in (2, 0.7):
        ts = tstream.synthesize_stream(t.X, t.y, mult, seed=3, row_ok=t.row_ok)
        js = jstream.synthesize_stream(t.X, t.y, mult, seed=3, row_ok=t.row_ok)
        assert ts.has_masked_rows and js.has_masked_rows
        _eq(ts.X, js.X)
        _eq(ts.y, js.y)
        _eq(ts.row_ok, js.row_ok)
        tb = tstream.stripe_partitions(ts, 4, 30, shuffle_seed=5)
        jb = jstream.stripe_partitions(js, 4, 30, shuffle_seed=5)
        for a, b in zip(tb, jb):
            _eq(a, b)
        assert not tb.valid.all()
    with pytest.raises(ValueError, match="quarantine-masked"):
        tstream.stripe_partitions_packed(
            tstream.synthesize_stream(t.X, t.y, 2, row_ok=t.row_ok), 4, 30)


def test_load_stream_matches_jax(csvs, tmp_path):
    for policy in (None, "strict"):
        ts = tstream.load_stream(csvs["clean"], 2, seed=1, data_policy=policy)
        js = jstream.load_stream(csvs["clean"], 2, seed=1, data_policy=policy)
        _eq(ts.base_X, js.base_X)
        _eq(ts.src, js.src)
        assert ts.quarantine is None and not ts.has_masked_rows
    ts = tstream.load_stream(csvs["dirty"], 2, seed=1, data_policy="repair",
                             quarantine_path=str(tmp_path / "q.jsonl"))
    assert ts.quarantine.rows_quarantined == 1 and ts.has_masked_rows


def test_missing_csv_raises():
    with pytest.raises(FileNotFoundError):
        tstream.load_stream("no/such/file.csv")
    with pytest.raises(FileNotFoundError):
        tpkg.run(tconfig.RunConfig(dataset="no/such/file.csv", **GEOMETRY), device="cpu")


def _runs(cfgkw, tmp_path):
    jq, tq = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    j = jpkg.run(jconfig.RunConfig(**cfgkw, quarantine_path=jq))
    t = tpkg.run(tconfig.RunConfig(**cfgkw, quarantine_path=tq), device="cpu")
    return j, t, jq, tq


def _same_run(j, t):
    assert j.metrics.num_detections > 0
    for f in j.flags._fields:
        a, b = np.asarray(getattr(j.flags, f)), getattr(t.flags, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(np.asarray(j.drift_vote), t.drift_vote)
    for f in dataclasses.fields(j.metrics):
        np.testing.assert_array_equal(getattr(j.metrics, f.name),
                                      getattr(t.metrics, f.name), err_msg=f.name)


@pytest.mark.parametrize("window", [0, 1], ids=["window_engine", "window1"])
def test_twin_csv_runs_as_its_synth_spec(csvs, tmp_path, window):
    """The synth: twin written as a CSV runs, under strict, to the flags of
    its synth: run and of the JAX package's run of the CSV."""
    kw = dict(GEOMETRY, window=window)
    j, t, _, _ = _runs(dict(kw, dataset=csvs["clean"]), tmp_path)
    _same_run(j, t)
    s = tpkg.run(tconfig.RunConfig(dataset="synth:" + SPEC, **kw), device="cpu")
    _same_run(j, s)
    assert t.stream.quarantine is None


@pytest.mark.parametrize("window", [0, 1], ids=["window_engine", "window1"])
@pytest.mark.parametrize("policy", ["quarantine", "repair"])
def test_dirty_csv_runs_match_jax(csvs, tmp_path, policy, window):
    """The dirty CSV under quarantine and repair: masked rows ride the dense
    striper; flags, vote, metrics, the report and the sidecar equal JAX's."""
    kw = dict(GEOMETRY, dataset=csvs["dirty"], data_policy=policy, window=window)
    j, t, jq, tq = _runs(kw, tmp_path)
    _same_run(j, t)
    assert t.stream.has_masked_rows
    assert t.stream.quarantine._replace(sidecar=None) == j.stream.quarantine._replace(sidecar=None)
    assert t.stream.quarantine.sidecar == tq
    assert [json.loads(x) for x in _sidecar(tq)] == [json.loads(x) for x in _sidecar(jq)]


def test_dirty_csv_strict_run_raises(csvs):
    with pytest.raises(tsanitize.StreamContractError, match="data row 100"):
        tpkg.run(tconfig.RunConfig(dataset=csvs["dirty"], **GEOMETRY), device="cpu")


def test_rialto_fixture_run_matches_jax(csvs, tmp_path):
    """F = 27, 10 classes, the rialto schema."""
    kw = dict(GEOMETRY, dataset=csvs["rialto"], mult_data=2, per_batch=20)
    j, t, _, _ = _runs(kw, tmp_path)
    assert t.stream.num_features == 27 and t.stream.num_classes == 10
    _same_run(j, t)


def test_default_quarantine_path_is_resolved_like_jax(csvs, tmp_path, monkeypatch):
    """Without quarantine_path the sidecar lands in the working directory."""
    monkeypatch.chdir(tmp_path)
    t = tpkg.run(tconfig.RunConfig(dataset=csvs["dirty"], data_policy="quarantine",
                                   **GEOMETRY), device="cpu")
    assert t.stream.quarantine.sidecar == "quarantine.jsonl"
    assert len(_sidecar(tmp_path / "quarantine.jsonl")) == 3
