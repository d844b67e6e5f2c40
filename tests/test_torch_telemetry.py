"""The port's run log, run registry and metric exports against the JAX
package's, on the same ``synth:`` config.

``run(cfg, device='cpu')`` of the port and ``run(cfg)`` of the JAX package
each write a run log, an ``index.jsonl`` and the two exports under their
own ``telemetry_dir``. The event types must come in the same order, with
one documented exception: the JAX package also emits ``cost_analysis`` and
a ``source="memory_analysis"`` snapshot from XLA's compiled program, which
the port does not have (``telemetry/profile.py``: no FLOP count is
invented). ``run_started``'s config and identity, the flag events and
``run_completed``'s totals must be equal, the JAX package's
``validate_event`` must accept every line the port writes, the registry
statuses and digests must be equal, and so must ``detections_total`` and
``rows_processed_total``. Also here: the ``api.run`` fault site in both
packages, the schema's refusals, the registry's compaction, the exporters'
text, the device-memory snapshot on the CPU and the fleet identity.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import distributed_drift_detection_tpu as jpkg  # noqa: E402
from distributed_drift_detection_tpu import config as jconfig  # noqa: E402
from distributed_drift_detection_tpu.resilience import faults as jfaults  # noqa: E402
from distributed_drift_detection_tpu.telemetry import events as jevents  # noqa: E402
from distributed_drift_detection_tpu.telemetry import metrics as jmetrics  # noqa: E402
from distributed_drift_detection_tpu.telemetry import registry as jregistry  # noqa: E402
from distributed_drift_detection_tpu.telemetry.report import render_report  # noqa: E402
import distributed_drift_detection_tpu_torch as tpkg  # noqa: E402
from distributed_drift_detection_tpu_torch import config as tconfig  # noqa: E402
from distributed_drift_detection_tpu_torch.io import datasets as tdatasets  # noqa: E402
from distributed_drift_detection_tpu_torch.io import synth as tsynth  # noqa: E402
from distributed_drift_detection_tpu_torch.resilience import faults as tfaults  # noqa: E402
from distributed_drift_detection_tpu_torch.telemetry import events as tevents  # noqa: E402
from distributed_drift_detection_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402
from distributed_drift_detection_tpu_torch.telemetry import profile as tprofile  # noqa: E402
from distributed_drift_detection_tpu_torch.telemetry import registry as tregistry  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = "prototypes,seed=0,concepts=6,rows_per_concept=100,features=5"
BASE = dict(dataset=f"synth:{SPEC}", mult_data=3, partitions=4, per_batch=50, results_csv="")
ENVELOPE = ("v", "ts", "seq")


@pytest.fixture(autouse=True)
def _disarm():
    """Fault arming is process-global in each package; no test may leak it."""
    tfaults.disarm_all()
    jfaults.disarm_all()
    yield
    tfaults.disarm_all()
    jfaults.disarm_all()


def _runs(tmp, **kw):
    """Both packages' telemetered runs of one config: {name: (result, dir)}."""
    out = {}
    for name, run, mod in (("jax", jpkg.run, jconfig),
                           ("port", lambda c: tpkg.run(c, device="cpu"), tconfig)):
        tele = str(tmp / name)
        out[name] = (run(mod.RunConfig(**{**BASE, **kw}, telemetry_dir=tele)), tele)
    return out


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """Each package's run log as parsed events, its registry and its dir."""
    runs = _runs(tmp_path_factory.mktemp("tele"))
    return {name: dict(result=res, dir=tele, events=tevents.read_events(res.telemetry_path),
                       index=tregistry.read_index(tele))
            for name, (res, tele) in runs.items()}


def _payload(event):
    return {k: v for k, v in event.items() if k not in ENVELOPE}


def _xla_only(event) -> bool:
    """The two events only XLA's compiled program feeds."""
    return event["type"] == "cost_analysis" or (
        event["type"] == "memory_snapshot" and event["source"] == "memory_analysis")


def test_event_sequence_matches_jax(logs):
    jtypes = [e["type"] for e in logs["jax"]["events"] if not _xla_only(e)]
    ttypes = [e["type"] for e in logs["port"]["events"]]
    assert ttypes == jtypes
    assert ttypes[0] == "run_started" and ttypes[-1] == "run_completed"
    assert [e["seq"] for e in logs["port"]["events"]] == list(range(len(ttypes)))
    phases = [e["phase"] for e in logs["port"]["events"] if e["type"] == "phase_completed"]
    assert phases == [e["phase"] for e in logs["jax"]["events"]
                      if e["type"] == "phase_completed"]


def test_run_started_config_and_identity_match_jax(logs):
    (j, t) = (next(e for e in logs[n]["events"] if e["type"] == "run_started")
              for n in ("jax", "port"))
    assert t["config"] == j["config"]
    for key in ("hostname", "process_index", "process_count"):
        assert t[key] == j[key]
    assert t["run_id"] == os.path.splitext(os.path.basename(
        logs["port"]["result"].telemetry_path))[0]
    assert "-proc0-" in t["run_id"]


def test_flag_events_match_jax(logs):
    def flags(name):
        return [_payload(e) for e in logs[name]["events"]
                if e["type"] in ("drift_detected", "retrain")]

    assert flags("port") == flags("jax")
    assert sum(e["type"] == "drift_detected" for e in flags("port")) == \
        logs["port"]["result"].metrics.num_detections > 0


def test_run_completed_matches_jax(logs):
    (j, t) = (logs[n]["events"][-1] for n in ("jax", "port"))
    for key in ("rows", "detections", "collect_mode", "collect_events", "collect_overflow"):
        assert t[key] == j[key], key
    assert t["seconds"] == logs["port"]["result"].total_time
    compile_ev = next(e for e in logs["port"]["events"] if e["type"] == "compile_completed")
    # the CPU builds no kernel: nothing rebuilt, no nvcc time
    assert (compile_ev["cached"], compile_ev["seconds"]) == (True, 0.0)
    assert (compile_ev["aot_seconds"], compile_ev["aot_cached"]) == (0.0, False)


def test_jax_validate_event_accepts_every_port_line(logs):
    path = logs["port"]["result"].telemetry_path
    with open(path) as fh:
        lines = [json.loads(ln) for ln in fh]
    for event in lines:
        jevents.validate_event(event)
    assert jevents.read_events(path) == logs["port"]["events"]
    out = render_report(logs["port"]["events"])  # the JAX package's reader
    assert "detections" in out


def test_registry_matches_jax(logs):
    def summary(name):
        return [(r["status"], r.get("config_digest")) for r in logs[name]["index"]]

    assert summary("port") == summary("jax")
    assert [s for s, _ in summary("port")] == ["running", "completed"]
    (jrun,), (trun,) = (tregistry.runs(logs[n]["dir"]).values() for n in ("jax", "port"))
    assert trun["config_digest"] == jregistry.config_digest(
        jconfig.telemetry_config_payload(jconfig.RunConfig(**BASE)))
    assert set(trun) == set(jrun)
    for key in ("rows", "detections", "hostname", "process_index", "process_count"):
        assert trun[key] == jrun[key], key
    assert tregistry.newest_run_log(logs["port"]["dir"]) == logs["port"]["result"].telemetry_path


def test_exports_match_jax(logs):
    samples = {}
    for name in ("jax", "port"):
        base = os.path.splitext(logs[name]["result"].telemetry_path)[0]
        with open(base + ".prom") as fh:
            samples[name] = jmetrics.parse_prometheus_text(fh.read())
        with open(base + ".metrics.json") as fh:
            assert set(json.load(fh)) >= {"detections_total", "rows_processed_total",
                                           "phase_seconds", "compile_seconds"}
    for name in ("detections_total", "rows_processed_total"):
        pick = {k: v for k, v in samples["port"].items() if k[0] == name}
        assert pick and pick == {k: v for k, v in samples["jax"].items() if k[0] == name}
    # no compiler analysis in the port, so no xla_* gauge
    assert not [k for k in samples["port"] if k[0].startswith("xla_")]


@pytest.mark.parametrize("telemetered", [False, True], ids=["plain", "telemetry"])
def test_api_run_fault_site_fires_in_both_packages(tmp_path, telemetered):
    """``DDD_FAULTS=api.run`` raises in both packages, inside the registry
    bracket: the failed record and the partial log land as a crash leaves
    them."""
    for name, run, mod, faults in (
            ("jax", jpkg.run, jconfig, jfaults),
            ("port", lambda c: tpkg.run(c, device="cpu"), tconfig, tfaults)):
        tele = str(tmp_path / name) if telemetered else None
        assert faults.arm_from_env("api.run:at=1") == ["api.run"]
        with pytest.raises(faults.InjectedFault, match="api.run"):
            run(mod.RunConfig(**BASE, telemetry_dir=tele))
        assert faults.armed("api.run").fired == 1
        faults.disarm_all()
        if telemetered:
            assert [r["status"] for r in tregistry.read_index(tele)] == ["running", "failed"]
            (log,) = [p for p in os.listdir(tele) if p != "index.jsonl"]
            assert [e["type"] for e in tevents.read_events(os.path.join(tele, log))] == \
                ["run_started"]


def test_quarantined_rows_match_jax(tmp_path):
    """A dirty CSV under ``quarantine``: each telemetered run gets its own
    sidecar named after its log, a ``rows_quarantined`` event and the
    ``ingest_quarantined_total`` counter, as in the JAX package."""
    path = str(tmp_path / "dirty.csv")
    tdatasets._write_schema_csv(*tsynth.parse_synth(SPEC), path)
    with open(path) as fh:
        lines = fh.read().splitlines()
    lines[101] = lines[101].replace(lines[101].split(",")[3], "nan", 1)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    runs = _runs(tmp_path, dataset=path, data_policy="quarantine")
    got = {}
    for name, (res, tele) in runs.items():
        (ev,) = [e for e in tevents.read_events(res.telemetry_path)
                 if e["type"] == "rows_quarantined"]
        assert ev["sidecar"] == os.path.splitext(res.telemetry_path)[0] + ".quarantine.jsonl"
        assert os.path.exists(ev["sidecar"])
        with open(os.path.splitext(res.telemetry_path)[0] + ".prom") as fh:
            prom = jmetrics.parse_prometheus_text(fh.read())
        got[name] = (ev["rows"], ev["policy"], ev["repaired"],
                     prom[("ingest_quarantined_total", ())], res.metrics.num_detections)
    assert got["port"] == got["jax"] and got["port"][0] == 1


def test_torn_write_reads_back_as_in_jax(tmp_path):
    """``telemetry.emit`` armed ``torn_write`` leaves a torn tail that the
    tolerant read skips and the strict read refuses, in both packages."""
    out = {}
    for name, ev_mod, faults in (("jax", jevents, jfaults), ("port", tevents, tfaults)):
        log = ev_mod.EventLog.open_run(str(tmp_path / name), name="torn")
        log.emit("run_started", run_id=log.run_id, config={})
        faults.arm("telemetry.emit", at=1, kind="torn_write")
        with pytest.raises(faults.InjectedFault):
            log.emit("phase_completed", phase="detect", seconds=1.0)
        faults.disarm_all()
        log.close()
        with pytest.raises(ev_mod.SchemaError, match="not JSON"):
            ev_mod.read_events(log.path)
        out[name] = [e["type"] for e in ev_mod.read_events(log.path, allow_partial_tail=True)]
    assert out["port"] == out["jax"] == ["run_started"]


@pytest.mark.parametrize("event", [
    {"v": 1, "type": "bogus", "ts": 0, "seq": 0},
    {"v": 2, "type": "retrain", "ts": 0, "seq": 0, "partition": 0, "batch": 1, "forced": 0},
    {"v": 1, "type": "retrain", "seq": 0, "partition": 0, "batch": 1, "forced": 0},
    {"v": 1, "type": "retrain", "ts": 0, "seq": 0, "partition": 0, "batch": 1},
    {"v": 1, "type": "run_completed", "ts": 0, "seq": 0, "rows": None, "seconds": 1,
     "detections": 0},
    ["not", "a", "dict"],
], ids=["unknown_type", "version", "envelope", "missing", "null", "not_object"])
def test_schema_refusals_match_jax(event):
    msgs = []
    for mod in (tevents, jevents):
        with pytest.raises(mod.SchemaError) as e:
            mod.validate_event(event)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert tevents.EVENT_SCHEMA == jevents.EVENT_SCHEMA
    assert tevents.SCHEMA_VERSION == jevents.SCHEMA_VERSION


def test_registry_compaction_and_cli_match_jax(tmp_path, capsys):
    """The same status records in two directories: the packages' folds,
    compactions and ``registry compact`` CLI lines agree."""
    outs = {}
    for name, reg in (("jax", jregistry), ("port", tregistry)):
        d = str(tmp_path / name)
        with reg.attempt_scope(1):
            reg.record(d, "a", "running", config_digest="d1", log="a.jsonl")
            reg.record(d, "a", "failed")
        with reg.attempt_scope(2):
            reg.record(d, "a", "completed", rows=10)
        reg.record(d, "b", "running", config_digest="d2")
        with pytest.raises(ValueError, match="unknown registry status"):
            reg.record(d, "b", "bogus")
        before = {k: {f: v for f, v in r.items() if f not in ("ts", "started_ts")}
                  for k, r in reg.runs(d).items()}
        reg.main(["compact", d, "--min-records", "99"])
        reg.main(["compact", d])
        reg.main(["compact", d])
        after = {k: {f: v for f, v in r.items() if f not in ("ts", "started_ts")}
                 for k, r in reg.runs(d).items()}
        assert after == before
        outs[name] = (before, capsys.readouterr().out, len(reg.read_index(d)))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0]["a"]["attempt"] == 2 and outs["port"][2] == 2


def test_exporters_match_jax(tmp_path):
    texts = []
    for mod in (tmetrics, jmetrics):
        reg = mod.MetricsRegistry()
        reg.counter("detections_total", help="by partition").inc(3, partition="1")
        reg.gauge("compile_seconds", help='a "quoted" help').set(0.25)
        h = reg.histogram("phase_seconds", help="phases")
        for v in (0.0005, 0.2, 7.0, 400.0):
            h.observe(v, phase="detect")
        with pytest.raises(ValueError):
            reg.counter("detections_total").inc(-1)
        paths = mod.write_exports(reg, str(tmp_path / type(reg).__module__.split(".")[0]))
        texts.append((reg.to_prometheus_text(), reg.to_json(),
                      [os.path.basename(p).split(".", 1)[1] for p in paths]))
    assert texts[0] == texts[1]
    assert tmetrics.parse_prometheus_text(texts[0][0]) == jmetrics.parse_prometheus_text(texts[0][0])


def test_profile_on_the_cpu(tmp_path):
    """No device snapshot on the CPU (as XLA-CPU) and no compiler analysis:
    nothing is emitted and no gauge is recorded."""
    assert tprofile.device_memory_stats("cpu") is None
    stats = tprofile.compiled_stats(object())
    assert stats == {"cost": None, "memory": None}
    log = tevents.EventLog.open_run(str(tmp_path), name="p")
    tprofile.emit_compiled_events(log, stats)
    tprofile.emit_device_memory_event(log, None, when="before_detect")
    log.close()
    assert tevents.read_events(log.path) == []
    reg = tmetrics.MetricsRegistry()
    tprofile.record_compiled_gauges(reg, stats)
    tprofile.record_device_memory_gauges(reg, None)
    snap = {"bytes_in_use": 5, "peak_bytes_in_use": 9, "bytes_limit": 100}
    tprofile.record_device_memory_gauges(reg, snap, when="after_detect")
    assert reg.to_json()["device_peak_bytes_in_use"]["samples"][0]["value"] == 9.0


@pytest.mark.parametrize("env", [
    {},
    {"JAX_PROCESS_ID": "1", "JAX_PROCESS_COUNT": "2"},
    {"SLURM_PROCID": "3", "SLURM_NTASKS": "4", "OMPI_COMM_WORLD_RANK": "7"},
], ids=["single", "jax_env", "slurm"])
def test_host_identity_matches_jax(env):
    """The port reads the launcher's environment in the JAX package's order;
    in a fresh process (no backend, no process group) both packages give
    the same identity."""
    code = (
        "import json\n"
        "from distributed_drift_detection_tpu_torch.parallel import multihost as t\n"
        "from distributed_drift_detection_tpu.parallel import multihost as j\n"
        "a, b = t.fleet_worker_identity(), j.fleet_worker_identity()\n"
        "print(json.dumps([a, b]))\n"
    )
    clean = {k: v for k, v in os.environ.items()
             if k not in ("JAX_PROCESS_ID", "JAX_PROCESS_COUNT", "SLURM_PROCID",
                          "SLURM_NTASKS", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env={**clean, **env},
                         capture_output=True, text=True, timeout=120, check=False)
    assert out.returncode == 0, out.stderr
    port, jax_ = json.loads(out.stdout.splitlines()[-1])
    assert port == jax_
    want = {"": (0, 1), "JAX_PROCESS_ID": (1, 2), "SLURM_PROCID": (3, 4)}[next(iter(env), "")]
    assert (port["process_index"], port["process_count"]) == want
