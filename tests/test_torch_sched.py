"""The port's sweep fleet: ``heal``, the scheduler, its worker agents and the
supervisor's registry bracket, held against the JAX package's.

The protocol, lease and scheduler cases are the JAX package's
``tests/test_sched.py`` run on the port's modules, in-process with stub
executors (the control plane imports no torch). The registry is shared
ground: a registry written by either package gives the same ``heal`` plan
under both, and the JAX package's ``heal --scheduler`` submits to the
port's scheduler. The end-to-end cases run the port on the CPU: a
supervised run that crashes once and is retried, a crashed sweep healed
exactly, and a multi-process sweep whose ``sched-worker --device cpu``
agents are killed by an armed fault and respawned until every cell
completed exactly once, with the serial grid's rows.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from distributed_drift_detection_tpu.resilience import faults as jfaults  # noqa: E402
from distributed_drift_detection_tpu.resilience import heal as jheal  # noqa: E402
from distributed_drift_detection_tpu.sched import protocol as jprotocol  # noqa: E402
from distributed_drift_detection_tpu.telemetry import registry as jregistry  # noqa: E402
from distributed_drift_detection_tpu.telemetry.report import render_report  # noqa: E402
from distributed_drift_detection_tpu_torch.config import (  # noqa: E402
    RunConfig,
    replace,
    telemetry_config_payload,
)
from distributed_drift_detection_tpu_torch.harness.grid import (  # noqa: E402
    grid_configs,
    run_grid,
    sweep_spec,
)
from distributed_drift_detection_tpu_torch.metrics import RESULT_COLUMNS  # noqa: E402
from distributed_drift_detection_tpu_torch.resilience import faults, heal  # noqa: E402
from distributed_drift_detection_tpu_torch.resilience.policy import NO_RETRY, RetryPolicy  # noqa: E402
from distributed_drift_detection_tpu_torch.resilience.supervisor import supervised_run  # noqa: E402
from distributed_drift_detection_tpu_torch.results import read_results  # noqa: E402
from distributed_drift_detection_tpu_torch.sched import protocol  # noqa: E402
from distributed_drift_detection_tpu_torch.sched.leases import CellQueue, audit_exactly_once  # noqa: E402
from distributed_drift_detection_tpu_torch.sched.scheduler import Scheduler  # noqa: E402
from distributed_drift_detection_tpu_torch.sched.worker import Worker  # noqa: E402
from distributed_drift_detection_tpu_torch.telemetry import registry  # noqa: E402
from distributed_drift_detection_tpu_torch.telemetry.events import read_events  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one of tests/test_torch_run.py's streams: small enough for the CPU
DATASET = "synth:prototypes,seed=0,concepts=6,rows_per_concept=100,features=5"


@pytest.fixture(autouse=True)
def _disarm():
    faults.disarm_all()
    jfaults.disarm_all()
    yield
    faults.disarm_all()
    jfaults.disarm_all()


def _spec(tmp_path, mults=(1, 2, 4), partitions=(1, 2), trials=1, dataset="synth:rialto,seed=0"):
    return sweep_spec(dataset, list(mults), list(partitions), trials=trials, per_batch=50,
                      results_csv=str(tmp_path / "results.csv"), spec="off")


def _spec_file(tmp_path, **kw):
    spec = _spec(tmp_path, **kw)
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    return str(path), spec


def _wires(spec):
    return [protocol.cell_to_wire(cfg) for cfg in heal.spec_configs(spec)]


def _stub_run_cell(cell, tele_dir, retries=0):
    """Mimic api.run's registry bracket without torch."""
    rid = f"stub-{cell['app_name']}"
    registry.record(tele_dir, rid, "running", config_digest=cell["digest"])
    registry.record(tele_dir, rid, "completed", config_digest=cell["digest"])
    return {"rows": 100, "total_time": 0.01, "detections": 1}


def _cell_records(tele):
    return [r for r in registry.runs(tele).values() if r.get("kind") is None]


# --- protocol ---------------------------------------------------------------


def test_protocol_roundtrip_and_rejection():
    msg = {"op": "lease", "worker": "w0"}
    assert protocol.decode_line(protocol.encode(msg).strip()) == msg
    assert protocol.encode(msg) == jprotocol.encode(msg)
    for bad in (b"not json", b'["no", "op"]', b'{"noop": 1}'):
        with pytest.raises(protocol.ProtocolError):
            protocol.decode_line(bad)
    assert protocol.parse_addr("127.0.0.1:9000") == ("127.0.0.1", 9000)
    assert protocol.parse_addr(":9000") == ("127.0.0.1", 9000)
    with pytest.raises(ValueError):
        protocol.parse_addr("nope")


def test_cell_wire_roundtrip_pins_digest():
    cfg = grid_configs(RunConfig(dataset="synth:rialto,seed=0", per_batch=50),
                       mults=[2.0], partitions=[4], trials=1)[0]
    wire = protocol.cell_to_wire(cfg)
    assert wire["digest"] == registry.config_digest(telemetry_config_payload(cfg))
    assert wire == jprotocol.cell_to_wire(jprotocol.cell_from_wire(wire))  # the JAX wire
    rebuilt = protocol.cell_from_wire(wire, telemetry_dir="/tmp/x")
    assert telemetry_config_payload(rebuilt) == wire["payload"]
    assert rebuilt.resolved_app_name() == wire["app_name"]
    assert rebuilt.telemetry_dir == "/tmp/x"
    bad = {**wire, "payload": {**wire["payload"], "seed": 99}}
    with pytest.raises(protocol.ProtocolError, match="digest"):
        protocol.cell_from_wire(bad)


# --- lease state machine ----------------------------------------------------


def test_cellqueue_lease_lifecycle(tmp_path):
    q = CellQueue(lease_s=10.0, max_attempts=2)
    spec = _spec(tmp_path, mults=(1,), partitions=(1,), trials=6)
    assert q.add(_wires(spec)) == (6, 0)
    assert q.add(_wires(spec)) == (0, 6)  # idempotent
    now = 100.0
    lease = q.grant("w0", now)
    assert lease is not None and lease.cell.state == "leased"
    assert q.heartbeat(lease.lease_id, now + 5)
    assert q.revoke_expired(now + 14.9) == []
    assert [e.lease_id for e in q.revoke_expired(now + 15.1)] == [lease.lease_id]
    assert lease.cell.state == "queued"
    assert q.complete(lease.lease_id, "w0") is None  # revoked: discarded
    lease2 = q.grant("w1", now + 20)
    assert lease2.cell is lease.cell and lease2.cell.attempts == 2
    assert q.complete(lease2.lease_id, "w1") is lease2.cell
    lease3 = q.grant("w0", now + 21)
    assert q.complete(lease3.lease_id, "w9") is None  # not the holder
    cell3, requeued = q.fail(lease3.lease_id, "w0")
    assert requeued and cell3.state == "queued"
    lease4 = q.grant("w0", now + 22)
    cell4, requeued = q.fail(lease4.lease_id, "w0")
    assert lease4.cell is cell3 and not requeued and cell4.state == "failed"
    counts = q.counts()
    assert counts["completed"] == 1 and counts["failed"] == 1 and not q.whole()


def test_grant_geometry_affinity(tmp_path):
    q = CellQueue(lease_s=10.0, max_attempts=3)
    q.add(_wires(_spec(tmp_path, mults=(1, 2), partitions=(1,), trials=2)))
    a, b = q.grant("w0", 0.0), q.grant("w1", 0.0)
    assert b.cell.geometry != a.cell.geometry  # a cold geometry, not g1's 2nd trial
    q.complete(a.lease_id, "w0")
    q.complete(b.lease_id, "w1")
    a2, b2 = q.grant("w0", 0.0), q.grant("w1", 0.0)
    assert a2.cell.geometry == a.cell.geometry and b2.cell.geometry == b.cell.geometry
    assert a2.cell.digest != a.cell.digest


def test_cellqueue_disconnect_revokes_all_held(tmp_path):
    q = CellQueue(lease_s=10.0, max_attempts=3)
    q.add(_wires(_spec(tmp_path)))
    a, b = q.grant("w0", 0.0), q.grant("w0", 0.0)
    q.grant("w1", 0.0)
    held = q.revoke_worker("w0")
    assert {lease.lease_id for lease in held} == {a.lease_id, b.lease_id}
    assert a.cell.state == b.cell.state == "queued" and len(q.leases) == 1


def test_audit_exactly_once(tmp_path):
    tele = str(tmp_path)
    q = CellQueue(lease_s=1.0)
    q.add(_wires(_spec(tmp_path, mults=(1, 2), partitions=(1,))))
    expected = q.expected_digests()
    d1, d2 = sorted(expected)
    audit = audit_exactly_once(tele, expected)
    assert not audit["ok"] and set(audit["missing"]) == {d1, d2}
    registry.record(tele, "r1", "completed", config_digest=d1)
    registry.record(tele, "r2", "completed", config_digest=d2)
    assert audit_exactly_once(tele, expected)["ok"]
    registry.record(tele, "r3", "completed", config_digest=d1)
    audit = audit_exactly_once(tele, expected)
    assert not audit["ok"] and audit["duplicates"] == {d1: 1}


# --- scheduler daemon (in-process, stub executors) --------------------------


def test_scheduler_end_to_end_with_stub_workers(tmp_path):
    tele = str(tmp_path / "tele")
    sched = Scheduler(tele, lease_s=30.0, ops_port=0)
    assert sched.add_spec(_spec(tmp_path)) == {"cells_total": 6, "completed": 0, "queued": 6}
    sched.start()
    try:
        workers = [Worker("127.0.0.1", sched.port, worker_id=f"stub{i}",
                          run_cell=_stub_run_cell, progress=lambda _m: None)
                   for i in range(2)]
        threads = [threading.Thread(target=w.run, daemon=True) for w in workers]
        for t in threads:
            t.start()
        assert sched.wait_whole(timeout=30), sched.status()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
        assert sum(w.cells_done for w in workers) == 6
        status = sched.status()
        assert status["cells"]["completed"] == 6 and len(status["workers"]) == 2
        base = f"http://127.0.0.1:{sched.ops_port}"
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        assert "sched_cells_completed_total 6" in text and "fleet_backends_alive" in text
        assert json.load(urllib.request.urlopen(base + "/healthz"))["healthy"]
        assert json.load(urllib.request.urlopen(base + "/fleetz"))["fleet"]["backends"] == 2
    finally:
        summary = sched.stop()
    assert summary["whole"] and summary["audit"]["ok"], summary
    recs = [r for r in registry.runs(tele).values() if r.get("kind") == "sched"]
    assert len(recs) == 1 and recs[0]["status"] == "completed" and recs[0]["audit_ok"] is True
    with open(os.path.join(tele, "sched.journal.jsonl")) as fh:
        events = {json.loads(ln)["event"] for ln in fh}
    assert {"scheduler_started", "lease_granted", "cell_completed",
            "scheduler_stopped"} <= events
    assert registry.newest_run_log(tele) is None  # the journal is a sidecar


def test_scheduler_resumes_from_registry(tmp_path):
    tele = str(tmp_path / "tele")
    spec = _spec(tmp_path)
    for wire in _wires(spec)[:4]:
        _stub_run_cell(wire, tele)
    sched = Scheduler(tele, lease_s=30.0)
    assert sched.add_spec(spec) == {"cells_total": 6, "completed": 4, "queued": 2}
    sched.start()
    try:
        w = Worker("127.0.0.1", sched.port, worker_id="s0", run_cell=_stub_run_cell,
                   progress=lambda _m: None)
        assert w.run() == 0 and w.cells_done == 2
        assert sched.wait_whole(timeout=10)
    finally:
        summary = sched.stop()
    assert summary["whole"] and summary["audit"]["ok"] and summary["leases_granted"] == 2


def test_scheduler_revokes_silent_worker_and_releases(tmp_path):
    tele = str(tmp_path / "tele")
    sched = Scheduler(tele, lease_s=0.4, ops_port=None)
    sched.add_spec(_spec(tmp_path, mults=(1,), partitions=(1,)))
    sched.start()
    try:
        dead = protocol.ControlClient("127.0.0.1", sched.port)
        dead.request({"op": "hello", "worker": "wedged"})
        lease = dead.request({"op": "lease", "worker": "wedged"})
        assert lease["op"] == "lease"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not sched.status()["evictions"]:
            time.sleep(0.05)
        assert sched.status()["evictions"] == 1
        late = dead.request({"op": "done", "worker": "wedged",
                             "lease_id": lease["lease_id"], "result": {}})
        assert late == {"op": "ack", "accepted": False}
        w = Worker("127.0.0.1", sched.port, worker_id="alive", run_cell=_stub_run_cell,
                   progress=lambda _m: None)
        assert w.run() == 0 and w.cells_done == 1
        assert sched.wait_whole(timeout=10)
    finally:
        summary = sched.stop()
    assert summary["whole"] and summary["leases_revoked"] == 1, summary


def test_scheduler_survives_armed_lease_fault(tmp_path):
    faults.arm("sched.lease", at=1, times=1)
    sched = Scheduler(str(tmp_path / "tele"), lease_s=30.0)
    sched.add_spec(_spec(tmp_path, mults=(1,), partitions=(1,)))
    sched.start()
    try:
        notes = []
        w = Worker("127.0.0.1", sched.port, worker_id="w0", run_cell=_stub_run_cell,
                   sleep=lambda _s: None, progress=notes.append)
        assert w.run() == 0 and w.cells_done == 1
        assert any("lease rejected" in m for m in notes)
        assert sched.status()["lease_errors"] == 1
    finally:
        summary = sched.stop()
    assert summary["whole"], summary


def test_worker_abandons_cell_on_revoked_heartbeat(tmp_path):
    sched = Scheduler(str(tmp_path / "tele"), lease_s=0.5, heartbeat_s=0.05)
    sched.add_spec(_spec(tmp_path, mults=(1,), partitions=(1,)))
    sched.start()
    try:
        release, calls = threading.Event(), []

        def wedged_run_cell(cell, tele_dir, retries=0):
            calls.append(1)
            if len(calls) == 1:  # revoked behind the agent's back mid-cell
                release.wait(10)
                return {"rows": 0, "total_time": 0.0, "detections": 0}
            return _stub_run_cell(cell, tele_dir)

        w = Worker("127.0.0.1", sched.port, worker_id="w0", run_cell=wedged_run_cell,
                   progress=lambda _m: None)
        t = threading.Thread(target=w.run, daemon=True)
        t.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not sched.queue.leases:
            time.sleep(0.02)
        with sched._lock:
            assert len(sched.queue.revoke_worker("w0")) == 1
        release.set()
        assert sched.wait_whole(timeout=10)
        t.join(timeout=10)
        assert not t.is_alive() and w.cells_done == 1
    finally:
        summary = sched.stop()
    assert summary["whole"], summary


def test_scheduler_submit_and_heal_push(tmp_path):
    """``heal --scheduler`` of either package submits exactly the missing
    plan to the port's scheduler; submissions are idempotent."""
    tele = str(tmp_path / "tele")
    spec_path, spec = _spec_file(tmp_path)
    for wire in _wires(spec)[:2]:
        _stub_run_cell(wire, tele)
    sched = Scheduler(tele, lease_s=30.0)
    sched.start()
    try:
        with pytest.raises(SystemExit) as exc:
            heal.main([spec_path, "--telemetry-dir", tele,
                       "--scheduler", f"127.0.0.1:{sched.port}"])
        assert exc.value.code == 0 and sched.status()["cells"]["total"] == 4
        for mod in (heal, jheal):  # resubmission queues nothing new
            loaded = mod.load_spec(spec_path)
            ack = mod.submit_to_scheduler(loaded, mod.sweep_plan(loaded, tele),
                                          f"127.0.0.1:{sched.port}")
            assert ack["queued"] == 0 and ack["duplicates"] == 4
        w = Worker("127.0.0.1", sched.port, worker_id="w0", run_cell=_stub_run_cell,
                   progress=lambda _m: None)
        assert w.run() == 0 and w.cells_done == 4
    finally:
        summary = sched.stop()
    assert summary["whole"] and summary["audit"]["ok"], summary
    with pytest.raises(SystemExit) as exc:
        heal.main([spec_path, "--telemetry-dir", tele])
    assert exc.value.code == 0


def test_scheduler_rejects_malformed_submit(tmp_path):
    sched = Scheduler(str(tmp_path / "tele"), lease_s=30.0)
    sched.start()
    try:
        client = protocol.ControlClient("127.0.0.1", sched.port)
        with pytest.raises(protocol.ProtocolError, match="wire cells"):
            client.request({"op": "submit", "cells": [{"nope": 1}]})
        with pytest.raises(protocol.ProtocolError, match="unknown op"):
            client.request({"op": "gibberish"})
        client.connect()
        client._sock.sendall(b"not json\n")
        client._sock.sendall(protocol.encode({"op": "status"}))
        buf = b""
        while buf.count(b"\n") < 2:
            buf += client._sock.recv(65536)
        first, second = buf.split(b"\n")[:2]
        assert json.loads(first)["op"] == "error" and json.loads(second)["op"] == "status"
        client.close()
    finally:
        sched.stop()


# --- heal and the registry across the packages -------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_heal_plans_agree_across_packages(tmp_path, writer):
    """A registry written by either package gives the same plan under both
    ``heal``s: the digests are byte for byte the same."""
    tele = str(tmp_path / "tele")
    spec_path, _ = _spec_file(tmp_path, dataset=DATASET)
    reg = registry if writer == "port" else jregistry
    wires = _wires(heal.load_spec(spec_path))
    for i, wire in enumerate(wires[:3]):
        reg.record(tele, f"r{i}", "running", config_digest=wire["digest"])
        reg.record(tele, f"r{i}", "completed" if i != 1 else "failed")
    plans = [mod.sweep_plan(mod.load_spec(spec_path), tele) for mod in (heal, jheal)]
    assert plans[0] == plans[1]
    assert plans[0]["completed"] == 2 and len(plans[0]["missing"]) == 4
    assert [c["digest"] for c in plans[0]["missing"]] == \
        [w["digest"] for i, w in enumerate(wires) if i not in (0, 2)]


def test_supervised_run_brackets_attempts_in_registry(tmp_path):
    tele = str(tmp_path / "tele")
    cfg = RunConfig(dataset=DATASET, mult_data=3, partitions=4, per_batch=50,
                    results_csv="", telemetry_dir=tele)
    faults.arm("api.run", at=1)  # the first attempt crashes inside the bracket
    res = supervised_run(cfg, RetryPolicy(max_attempts=2, backoff_base_s=0.0, jitter=0.0),
                         device="cpu")
    assert res.metrics.num_detections > 0
    by = [(r["status"], r.get("attempt")) for r in registry.read_index(tele)]
    assert by == [("running", 1), ("failed", 1), ("running", 2), ("completed", 2)]
    sup_logs = [p for p in os.listdir(tele) if "retries" in p]
    assert len(sup_logs) == 1
    (ev,) = read_events(os.path.join(tele, sup_logs[0]))
    assert ev["type"] == "run_retried" and (ev["attempt"], ev["max_attempts"]) == (1, 2)
    assert "InjectedFault" in ev["reason"]
    out = render_report([ev])  # the JAX package's report renders the port's log
    assert "retries    1 attempt(s) re-run" in out and "InjectedFault" in out
    # without retries: no retry log, and the records carry attempt 1
    tele2 = str(tmp_path / "tele2")
    supervised_run(replace(cfg, telemetry_dir=tele2), NO_RETRY, device="cpu")
    assert not [p for p in os.listdir(tele2) if "retries" in p]
    assert [r["attempt"] for r in registry.read_index(tele2)] == [1, 1]


def test_sweep_crash_then_heal_reruns_exactly_the_missing_cells(tmp_path):
    """3 mults × 2 partitions, one injected crash mid-sweep: ``heal`` re-runs
    exactly the missing cells and the registry ends whole — and the JAX
    package's ``heal`` reads the port's registry as whole too."""
    spec_path, spec_dict = _spec_file(tmp_path, dataset=DATASET)
    csv = spec_dict["results_csv"]
    tele = str(tmp_path / "tele")
    base = RunConfig(dataset=DATASET, per_batch=50, results_csv=csv)
    faults.arm("api.run", at=3)
    with pytest.raises(faults.InjectedFault):
        run_grid(base, mults=[1, 2, 4], partitions=[1, 2], trials=1, spec="off",
                 telemetry_dir=tele, progress=lambda *_: None, device="cpu")
    faults.disarm_all()
    assert sorted(r["status"] for r in _cell_records(tele)) == ["completed", "completed", "failed"]
    (sweep,) = [r for r in registry.runs(tele).values() if r.get("kind") == "sweep"]
    assert sweep["status"] == "failed"

    spec = heal.load_spec(spec_path)
    plan = heal.sweep_plan(spec, tele)
    assert plan["cells_total"] == 6 and plan["completed"] == 2
    missing = [c["app_name"] for c in plan["missing"]]
    assert len(missing) == 4
    heal.write_plan_json(plan, str(tmp_path / "plan.json"))
    with open(tmp_path / "plan.json") as fh:
        assert [c["app_name"] for c in json.load(fh)["missing"]] == missing
    script = str(tmp_path / "missing.sh")
    heal.write_plan_script(plan, spec_path, script, retries=5, timeout_s=600, device="cpu")
    with open(script) as fh:
        text = fh.read()
    assert text.count("python -m distributed_drift_detection_tpu_torch heal ") == 4
    assert text.count("--execute --cell") == 4
    assert text.count("--retries 5 --timeout-s 600.0 --device cpu") == 4
    assert all(name in text for name in missing) and os.access(script, os.X_OK)

    executed = heal.execute(spec, tele, policy=RetryPolicy(max_attempts=2, backoff_base_s=0.0,
                                                           jitter=0.0),
                            progress=lambda *_: None, device="cpu")
    assert executed == 4
    after = heal.sweep_plan(spec, tele)
    assert after["completed"] == 6 and not after["missing"]
    assert jheal.sweep_plan(jheal.load_spec(spec_path), tele) == after
    digests = [registry.config_digest(telemetry_config_payload(c)) for c in heal.spec_configs(spec)]
    assert heal.completed_digests(tele) == {d: 1 for d in digests}
    (heal_rec,) = [r for r in registry.runs(tele).values() if r.get("kind") == "heal"]
    assert heal_rec["status"] == "completed"
    assert len(read_results(csv)) == 6
    assert heal.execute(spec, tele, progress=lambda *_: None, device="cpu") == 0
    with pytest.raises(ValueError, match="not in the sweep spec"):
        heal.execute(spec, tele, only={"no-such-cell"}, progress=lambda *_: None, device="cpu")


# --- the multi-process sweep --------------------------------------------------


def test_multiprocess_sweep_with_killed_workers_exactly_once(tmp_path):
    """4 cells, 2 spawned ``sched-worker --device cpu`` agents of the port,
    a seeded ``sched.worker`` fault killing an agent mid-sweep and the
    elastic respawn replacing it: every cell completed exactly once, with
    result rows equal to a serial grid run's but for their times."""
    serial_csv, sched_csv = str(tmp_path / "serial.csv"), str(tmp_path / "sched.csv")
    spec = sweep_spec(DATASET, [2, 3], [2, 4], trials=1, per_batch=50,
                      results_csv=sched_csv, spec="off")
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    assert run_grid(RunConfig(dataset=DATASET, per_batch=50, results_csv=serial_csv),
                    mults=[2.0, 3.0], partitions=[2, 4], trials=1, spec="off",
                    progress=lambda _m: None, device="cpu") == 4
    tele = str(tmp_path / "tele")
    # worker 0 (seed 10) dies at one of its first two cells; 1 (seed 11)
    # and the respawned 2 (seed 12) do not within 4 cells
    env = {**os.environ, "PYTHONPATH": REPO,
           "DDD_FAULTS": "sched.worker:rate=0.5,seed=10,times=1"}
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_drift_detection_tpu_torch", "sched",
         str(spec_path), "--telemetry-dir", tele, "--workers", "2", "--device", "cpu",
         "--lease-s", "60", "--json", "--timeout", "240"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-3000:])
    summary = json.loads(proc.stdout.splitlines()[-1])
    assert summary["whole"] and summary["audit"]["ok"] and summary["completed"] == 4, summary
    assert "respawning as index 2" in proc.stderr
    assert sorted(heal.completed_digests(tele).values()) == [1] * 4
    with open(os.path.join(tele, "sched.journal.jsonl")) as fh:
        joined = [json.loads(ln) for ln in fh if '"worker_joined"' in ln]
    assert len(joined) == 3 and all(j["hostname"] for j in joined)
    keep = [c for c in RESULT_COLUMNS if c not in ("Exp Start Time", "Final Time", "Rows Per Sec")]

    def projected(path):
        return sorted(tuple(str(r[c]) for c in keep) for r in read_results(path))

    assert projected(sched_csv) == projected(serial_csv)


def test_fleet_modules_import_no_torch():
    """The scheduler, ``heal``'s plan mode and the registry run where no
    torch is installed: importing them loads neither torch nor jax."""
    code = (
        "import sys\n"
        "import distributed_drift_detection_tpu_torch.sched.scheduler\n"
        "import distributed_drift_detection_tpu_torch.resilience.heal\n"
        "import distributed_drift_detection_tpu_torch.telemetry.registry\n"
        "import distributed_drift_detection_tpu_torch.sched.worker\n"
        "import distributed_drift_detection_tpu_torch.telemetry.ops\n"
        "import distributed_drift_detection_tpu_torch.telemetry.profile\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'distributed_drift_detection_tpu')]\n"
        "assert not bad, bad[:5]\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=False)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
