"""The port daemon's telemetry planes — ``telemetry/tracing.py``,
``telemetry/forensics.py``, ``telemetry/incident.py``, ``telemetry/slo.py``,
``telemetry/ops.py`` and the chunk tracer in ``engine/chunked.py``,
``io/feeder.py`` and the ``chunked`` CLI — against the JAX package's, on
the CPU (the serving cases of ``tests/test_tracing.py``,
``tests/test_forensics.py`` and ``tests/test_incident.py``).

Inputs: a ``planted_prototypes`` stream of the JAX package (seed 21, 3
concepts of 400 rows, 6 features) served by a JAX daemon and by the port
daemon (``device='cpu'``) with the same configuration: 4 partitions, 50
rows a batch, 2 batches a chunk, daemon-side trace sampling at rate 1,
forensics on. The artifacts must be the JAX package's schema, so its
readers (``timeline``, ``explain``, ``report``, ``incident``) render the
port's unchanged. Tolerance: none, apart from run ids, times and
latencies.
"""

import glob
import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from distributed_drift_detection_tpu import RunConfig as JRunConfig  # noqa: E402
from distributed_drift_detection_tpu.config import ServeParams as JServeParams  # noqa: E402
from distributed_drift_detection_tpu.engine.chunked import ChunkedDetector as JCD  # noqa: E402
from distributed_drift_detection_tpu.harness import chunked_cli as jcli  # noqa: E402
from distributed_drift_detection_tpu.io import planted_prototypes  # noqa: E402
from distributed_drift_detection_tpu.io import feeder as jfeeder  # noqa: E402
from distributed_drift_detection_tpu.io import stream as jstream  # noqa: E402
from distributed_drift_detection_tpu.models import ModelSpec as JSpec  # noqa: E402
from distributed_drift_detection_tpu.models import build_model as jbuild  # noqa: E402
from distributed_drift_detection_tpu.serve import ServeRunner as JServeRunner  # noqa: E402
from distributed_drift_detection_tpu.telemetry import forensics as jforensics  # noqa: E402
from distributed_drift_detection_tpu.telemetry import incident as jincident  # noqa: E402
from distributed_drift_detection_tpu.telemetry import report as jreport  # noqa: E402
from distributed_drift_detection_tpu.telemetry import timeline as jtimeline  # noqa: E402
from distributed_drift_detection_tpu.telemetry.events import EventLog as JEventLog  # noqa: E402
from distributed_drift_detection_tpu.telemetry.events import read_events  # noqa: E402
from distributed_drift_detection_tpu.telemetry.tracing import ChunkTracer as JChunkTracer  # noqa: E402
from distributed_drift_detection_tpu_torch import RunConfig  # noqa: E402
from distributed_drift_detection_tpu_torch.config import ServeParams  # noqa: E402
from distributed_drift_detection_tpu_torch.engine.chunked import ChunkedDetector as TCD  # noqa: E402
from distributed_drift_detection_tpu_torch.harness import chunked_cli as tcli  # noqa: E402
from distributed_drift_detection_tpu_torch.io.datasets import _write_schema_csv  # noqa: E402
from distributed_drift_detection_tpu_torch.io.synth import parse_synth  # noqa: E402
from distributed_drift_detection_tpu_torch.models import ModelSpec, build_model  # noqa: E402
from distributed_drift_detection_tpu_torch.resilience import faults  # noqa: E402
from distributed_drift_detection_tpu_torch.serve import ServeRunner  # noqa: E402
from distributed_drift_detection_tpu_torch.serve.loadgen import format_lines  # noqa: E402
from distributed_drift_detection_tpu_torch.telemetry import registry  # noqa: E402
from distributed_drift_detection_tpu_torch.telemetry.events import EventLog  # noqa: E402
from distributed_drift_detection_tpu_torch.telemetry.tracing import ChunkTracer  # noqa: E402

P, B, CB = 4, 50, 2
# fields of a span event that are clocks or per-process identity
_CLOCKS = {"ts", "start_ts", "dur_s", "mono", "run_id"}


def _kw(tele, **kw):
    return dict(partitions=P, per_batch=B, model="centroid", results_csv="", seed=21,
                window=1, data_policy="quarantine", telemetry_dir=tele, **kw)


def _pkw(stream, **kw):
    return dict(num_features=6, num_classes=stream.num_classes, port=None,
                chunk_batches=CB, linger_s=0.05, trace_sample=1.0, **kw)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The same stream through a JAX daemon and the port daemon, each with
    its own telemetry dir: ``{name: (banner, runner, telemetry dir)}``."""
    root = tmp_path_factory.mktemp("served")
    stream = planted_prototypes(21, concepts=3, rows_per_concept=400, features=6)
    lines = format_lines(stream.X, stream.y)
    out = {}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for name, make in (
            ("jax", lambda d: JServeRunner(JRunConfig(**_kw(d)), JServeParams(**_pkw(stream)),
                                           keep_flags=True)),
            ("port", lambda d: ServeRunner(RunConfig(**_kw(d)), ServeParams(**_pkw(stream)),
                                           keep_flags=True, device="cpu")),
        ):
            d = str(root / name)
            runner = make(d)
            banner = runner.start()
            for i in range(0, len(lines), 150):
                runner.admission.admit_lines(lines[i : i + 150])
            runner.batcher.flush()
            runner.request_stop()
            assert runner.serve_forever() == 0
            out[name] = (banner, runner, d)
    finally:
        os.chdir(cwd)
    return out


def _bundles(banner):
    stem = os.path.splitext(banner["run_log"])[0]
    out = {}
    for p in sorted(glob.glob(stem + ".forensics/drift-*.json")):
        with open(p) as fh:
            b = json.load(fh)
        b.pop("run_id")
        b.pop("ts")
        out[os.path.basename(p)] = b
    return out


def test_forensics_bundles_equal_jax_daemon(served):
    """One bundle per drift verdict, each equal field by field to the JAX
    daemon's (window stats, thresholds, trajectory, context rows, trace
    ids), and counted on ``/statusz`` and in the metric."""
    jb, tb = _bundles(served["jax"][0]), _bundles(served["port"][0])
    runner = served["port"][1]
    assert tb and len(tb) == runner._detections
    assert sorted(tb) == sorted(jb)
    for name in jb:
        assert tb[name] == jb[name], name
    assert runner._statusz()["forensics"] == {"enabled": True, "bundles": len(tb)}
    events = read_events(served["port"][0]["run_log"])
    assert sum(e["type"] == "drift_forensics" for e in events) == len(tb)


def _spans(log_path):
    """A log's span events without clocks; ``span_id`` (drawn unseeded) is
    replaced by the span's name and ``parent_id`` by its parent's name,
    so the chain's shape is compared, not its random ids."""
    spans = [e for e in read_events(log_path) if e["type"] == "span"]
    names = {e["span_id"]: e["name"] for e in spans}
    out = []
    for e in spans:
        e = {k: v for k, v in e.items() if k not in _CLOCKS}
        e["span_id"] = e["name"]
        e["parent_id"] = names.get(e["parent_id"], e["parent_id"])
        out.append(e)
    return sorted(out, key=lambda e: json.dumps(e, sort_keys=True))


def test_daemon_trace_spans_equal_jax(served):
    """Trace sampling at rate 1: the per-chunk stage spans (feed, device,
    collect, publish) carry the JAX daemon's fields, names, trace ids and
    parents."""
    j, t = (_spans(served[n][0]["run_log"]) for n in ("jax", "port"))
    assert t and t == j
    assert {e["name"] for e in t} >= {"serve.feed", "serve.device", "serve.collect",
                                      "serve.publish"}


@pytest.mark.parametrize("reader", ["timeline", "explain", "report"])
def test_jax_readers_render_port_artifacts(reader, served, tmp_path, capsys):
    """The JAX package's readers take the port daemon's telemetry dir as
    they take its own daemon's."""
    d = served["port"][2]
    if reader == "timeline":
        jtimeline.main([d, "-o", str(tmp_path / "t.json")])
        assert "log(s)" in capsys.readouterr().out
        trace = json.load(open(tmp_path / "t.json"))
        assert jtimeline.validate_chrome_trace(trace) > 0
    elif reader == "explain":
        jforensics.main([d])
        assert f"{len(_bundles(served['port'][0]))} bundle(s)" in capsys.readouterr().out
    else:
        jreport.main(["--dir", d])
        out = capsys.readouterr().out
        assert f"run        {served['port'][1]._log.run_id}" in out


def _get(url, timeout=5):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_stall_alert_writes_incident_bundle(tmp_path, monkeypatch):
    """A planted ``serve.flush`` stall fires ``stall_s``: ``/healthz``
    turns 503, the incident recorder writes a bundle the JAX package's
    ``incident`` reader diagnoses as publish-bound, the alert resolves,
    ``/metrics`` carries the latency histograms, and the drain leaves no
    crash flight record."""
    monkeypatch.chdir(tmp_path)
    stream = planted_prototypes(2, concepts=2, rows_per_concept=100, features=6)
    tele = str(tmp_path / "tele")
    params = ServeParams(num_features=6, num_classes=stream.num_classes, port=None,
                         ops_port=0, chunk_batches=CB, linger_s=0.05, heartbeat_s=0.1,
                         slo=("stall_s=0.4",), slo_interval_s=0.05)
    faults.arm("serve.flush", kind="stall", at=1, seconds=1.5)
    try:
        runner = ServeRunner(RunConfig(**_kw(tele)), params, device="cpu")
        banner = runner.start()
        thread = threading.Thread(target=runner.serve_forever, daemon=True)
        thread.start()
        runner.admission.admit_lines(format_lines(stream.X[:100], stream.y[:100]))
        runner.batcher.flush()
        base = f"http://127.0.0.1:{banner['ops_port']}"
        captured, degraded = None, False
        for _ in range(120):
            degraded = degraded or _get(base + "/healthz")[0] == 503
            iz = json.loads(_get(base + "/incidentz")[1])
            if iz["count"] >= 1:
                captured = iz
                break
            time.sleep(0.05)
        assert captured is not None and captured["latest"]["rule"] == "stall_s"
        time.sleep(1.6)  # the stall ends, publish resumes, the alert resolves
        code, body = _get(base + "/healthz")
        assert code == 200 and json.loads(body)["status"] == "serving"
        assert "serve_row_latency_seconds_bucket" in _get(base + "/metrics")[1]
        runner.request_stop()
        thread.join(60)
    finally:
        faults.disarm_all()
    assert not thread.is_alive()
    root = jincident.resolve_incidents_dir(tele)
    (bundle,) = jincident.list_bundles(root)
    b = jincident.read_bundle(bundle)
    assert not b["partial"] and b["resolved"]["state"] == "resolved"
    assert {"flightrec.jsonl", "pipeline.json", "statusz.json"} <= set(b["manifest"]["files"])
    assert jincident.diagnose(b)[0]["cause"] == "publish-bound"
    assert jincident.main(["diagnose", tele]) == 0
    assert all(r["status"] == "completed" for r in registry.runs(tele).values())
    assert not glob.glob(os.path.join(tele, "*.flightrec.jsonl"))


SPEC = "prototypes,seed=0,concepts=6,rows_per_concept=100,features=5"


@pytest.mark.parametrize("where", ["engine", "cli"])
def test_chunk_tracer_spans_equal_jax(where, tmp_path, monkeypatch):
    """``ChunkedDetector.run(tracer=...)`` and the ``chunked`` CLI's
    ``--trace-sample 1``: the ``kernel`` (and the CLI's ``ingest``) spans
    carry the JAX package's fields, chunk keys and trace ids."""
    monkeypatch.chdir(tmp_path)
    logs = {}
    if where == "engine":
        s = jstream.load_stream("synth:" + SPEC, 3, seed=0)
        chunks = list(jfeeder.chunk_stream_arrays(s.X, s.y, P, B, CB))
        spec = (s.num_features, s.num_classes)
        for name, det, log_cls, tracer_cls in (
            ("jax", JCD(jbuild("centroid", JSpec(*spec)), partitions=P), JEventLog, JChunkTracer),
            ("port", TCD(build_model("centroid", ModelSpec(*spec)), partitions=P, device="cpu"),
             EventLog, ChunkTracer),
        ):
            log = log_cls.open_run(str(tmp_path / name), name="c")
            det.run(iter(chunks), telemetry=log, tracer=tracer_cls(log, rate=1.0, seed=0))
            log.close()
            logs[name] = log.path
    else:
        X, y = parse_synth(SPEC)
        _write_schema_csv(X, y, str(tmp_path / "s.csv"))
        for name, main in (("jax", jcli.main),
                           ("port", lambda a: tcli.main(a, device="cpu"))):
            main([str(tmp_path / "s.csv"), "--classes", "6", "--partitions", str(P),
                  "--per-batch", str(B), "--chunk-batches", str(CB), "--window", "1",
                  "--telemetry-dir", str(tmp_path / name), "--trace-sample", "1.0"])
            logs[name] = registry.newest_run_log(str(tmp_path / name))
    j, t = _spans(logs["jax"]), _spans(logs["port"])
    assert t and t == j
    names = {"kernel"} if where == "engine" else {"kernel", "ingest"}
    assert {e["name"] for e in t} == names


@pytest.mark.parametrize("how", ["runner", "cli"])
def test_active_on_drift_refused(how, tmp_path, monkeypatch):
    """An active ``--on-drift`` spec the plane cannot take (a tenant it does
    not have, an unknown knob) is refused: by the ``serve`` CLI at argv time,
    before any work (no telemetry, no socket, no detector); by
    ``ServeRunner.start`` before it serves, as in the JAX package. A valid
    spec builds the adaptation plane (``tests/test_torch_adapt.py`` drives
    it)."""
    monkeypatch.chdir(tmp_path)
    tele = str(tmp_path / "tele")
    if how == "runner":
        for pkg, runner, cfg, sp in (("port", ServeRunner, RunConfig, ServeParams),
                                     ("jax", JServeRunner, JRunConfig, JServeParams)):
            kw = dict(device="cpu") if pkg == "port" else {}
            r = runner(cfg(**_kw(None)),
                       sp(num_features=5, num_classes=3, on_drift=("3=retrain",), port=None),
                       **kw)
            with pytest.raises(ValueError, match="targets tenant"):
                r.start()
        r = ServeRunner(RunConfig(**_kw(None)),
                        ServeParams(num_features=5, num_classes=3, on_drift=("retrain",),
                                    port=None), device="cpu")
        r.start()
        assert r._adapt is not None and r._adapt.active
        r.request_stop()
        assert r.serve_forever() == 0
    else:
        from distributed_drift_detection_tpu_torch.__main__ import main

        with pytest.raises(SystemExit) as e:
            main(["serve", "--features", "5", "--classes", "3", "--telemetry-dir", tele,
                  "--on-drift", "shadow,bogus=1"], device="cpu")
        assert e.value.code == 2
    assert not os.path.exists(tele)


def test_history_readers_equal_jax(tmp_path):
    """The incident plane's window extract reads a series store (the JAX
    package's writer) as the JAX package's readers do: the segments, the
    samples of a window, and the per-tenant rows ranking."""
    from distributed_drift_detection_tpu.telemetry import history as jhistory
    from distributed_drift_detection_tpu_torch.telemetry import history as thistory

    root = str(tmp_path / "store")
    store = jhistory.HistoryStore(root, segment_bytes=2048)
    t0 = 1_000_000.0
    for k in range(12):
        store.append_samples(
            [(jhistory.TENANT_ROWS_METRIC, {"tenant": str(t), "instance": "d0"},
              float(k * (t + 1) * 100)) for t in range(3)],
            ts=t0 + k, mono=50.0 + k)
    store.close()
    assert thistory.list_segments(root) == jhistory.list_segments(root)
    assert len(thistory.list_segments(root)) > 1  # rotated segments are read too
    kw = dict(start=t0 + 2, end=t0 + 9)
    assert thistory.read_samples(root, **kw) == jhistory.read_samples(root, **kw)
    kw = dict(window_s=6.0, at=t0 + 11)
    ranked = thistory.top_tenants(root, **kw)
    assert ranked == jhistory.top_tenants(root, **kw)
    assert [r["tenant"] for r in ranked] == ["2", "1", "0"]
