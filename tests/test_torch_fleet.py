"""The port's tenant router and fleet serving — ``serve/router.py``,
``serve/loadgen.py``'s ``--router`` posture and the daemons' tenant control
surface — against the JAX package's, on the CPU (the twin of the router
cases of ``tests/test_fleet_serving.py``).

Inputs: ``planted_prototypes(5, concepts=3, rows_per_concept=220,
features=6)`` (and seeds 3, 7 for the control surface and the migration),
served by port daemons (``device='cpu'``) of 2 tenant slots each, 4
partitions, 25 rows a batch, 2 batches a chunk, ``window=1``, the centroid
and DDM, behind the port's router or the JAX package's. The reference of a
tenant is its solo daemon fed the same dealt sub-stream, the port's and the
JAX package's. Tolerance: none — flags leaf by leaf and the per-tenant
verdict entries field by field.
"""

import io
import json
import os
import socket
import threading
import time
from collections import deque
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_drift_detection_tpu import RunConfig as JRunConfig  # noqa: E402
from distributed_drift_detection_tpu.config import ServeParams as JServeParams  # noqa: E402
from distributed_drift_detection_tpu.config import tenant_configs as jtenant_configs  # noqa: E402
from distributed_drift_detection_tpu.io import planted_prototypes  # noqa: E402
from distributed_drift_detection_tpu.serve import ServeRunner as JServeRunner  # noqa: E402
from distributed_drift_detection_tpu.serve import router as jrouter  # noqa: E402
from distributed_drift_detection_tpu_torch import RunConfig  # noqa: E402
from distributed_drift_detection_tpu_torch.config import ServeParams, tenant_configs  # noqa: E402
from distributed_drift_detection_tpu_torch.parallel.mesh import split_tenant_flags  # noqa: E402
from distributed_drift_detection_tpu_torch.serve import (  # noqa: E402
    BackendSpec,
    HashRing,
    ServeRunner,
    TenantRouter,
    plan_fleet,
    read_verdicts,
    wire,
)
from distributed_drift_detection_tpu_torch.serve import router as trouter  # noqa: E402
from distributed_drift_detection_tpu_torch.serve.loadgen import format_lines, run_loadgen  # noqa: E402
from distributed_drift_detection_tpu_torch.serve.router import plan_rebalance  # noqa: E402

SPAN = 4 * 25 * 2  # partitions * per_batch * chunk_batches


def _flags_equal(a, b, msg=""):
    for name in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)), err_msg=f"{msg} {name}")


# -- router units: placement, planning, slicing, the migration rails ---------


@pytest.mark.parametrize("names, exclude", [(["a", "b", "c"], ["b"]),
                                            (["b0", "b1", "b2", "b3"], ["b1", "b3"]),
                                            (["x"], [])])
def test_hashring_matches_jax(names, exclude):
    """The port's ring places every global tenant where the JAX package's
    does, with and without excluded backends; excluding a backend moves
    only its keys."""
    ring, jring = HashRing(names), jrouter.HashRing(names)
    before = {g: ring.place(g) for g in range(64)}
    assert before == {g: jring.place(g) for g in range(64)}
    after = {g: ring.place(g, exclude=exclude) for g in range(64)}
    assert after == {g: jring.place(g, exclude=exclude) for g in range(64)}
    for g in range(64):
        if before[g] not in exclude:
            assert after[g] == before[g]
    with pytest.raises(RuntimeError, match="no live backend"):
        ring.place(0, exclude=names)
    with pytest.raises(ValueError, match="duplicate"):
        HashRing(names + names[:1])


@pytest.mark.parametrize("tenants, backends, spares", [(16, 3, 2), (4, 2, 1), (2, 4, 1),
                                                       (9, 2, 0)])
def test_plan_fleet_matches_jax(tenants, backends, spares):
    names = [f"b{i}" for i in range(backends)]
    assign = plan_fleet(tenants, names, spares=spares)
    assert assign == jrouter.plan_fleet(tenants, names, spares=spares)
    assert sorted(g for ids in assign.values() for g in ids if g >= 0) == list(range(tenants))
    assert all(len(ids) >= 1 for ids in assign.values())
    if spares:
        assert all(ids.count(-1) >= 1 for ids in assign.values())


@pytest.mark.parametrize("case", [
    ({"a": 1000.0, "b": 10.0}, {"a": {0: 800.0, 1: 200.0}, "b": {2: 10.0}}, {"a": 0, "b": 1},
     (0, "a", "b")),
    ({"a": 30.0, "b": 20.0}, {"a": {0: 20.0, 1: 10.0}, "b": {2: 20.0}}, {"a": 1, "b": 1}, None),
    ({"a": 1000.0, "b": 10.0}, {"a": {0: 1000.0}, "b": {2: 10.0}}, {"a": 1, "b": 1}, None),
    ({"a": 1000.0, "b": 10.0}, {"a": {0: 800.0, 1: 200.0}, "b": {2: 10.0}}, {"a": 1, "b": 0},
     None),
])
def test_plan_rebalance_matches_jax(case):
    rates, tenant_rates, vacant, want = case
    assert plan_rebalance(rates, tenant_rates, vacant, ratio=2.0) == want
    assert jrouter.plan_rebalance(rates, tenant_rates, vacant, ratio=2.0) == want


def test_backend_spec_parse():
    spec = BackendSpec("10.0.0.1:7007:7008")
    assert (spec.host, spec.port, spec.ops_port) == ("10.0.0.1", 7007, 7008)
    with pytest.raises(ValueError, match="host:port:ops_port"):
        BackendSpec("10.0.0.1:7007")


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_slice_entry_matches_jax(version):
    """The failover re-send drops the rows a checkpoint covers, in the
    JAX package's bytes: v1 keeps a TRACE stamp only with its surviving
    row, v2 re-encodes the frame's tail."""
    if version == "v1":
        entry = ("v1", ["TRACE t0 s0", "1.0,2.0,0", "1.5,2.5,1", "TRACE t2 s2", "2.0,3.0,0"], 3)
        got = TenantRouter._slice_entry(entry, 2)
        assert got == ("v1", ["TRACE t2 s2", "2.0,3.0,0"], 1)
    else:
        X = np.arange(12, dtype=np.float32).reshape(4, 3)
        y = np.arange(4, dtype=np.int32)
        entry = ("v2", wire.encode_frame(X, y, tenant=5), 4)
        got = TenantRouter._slice_entry(entry, 1)
        assert got[0] == "v2" and got[2] == 3
        _, X2, y2, _ = wire.decode_frame(got[1])
        np.testing.assert_array_equal(np.asarray(X2), X[1:])
        np.testing.assert_array_equal(np.asarray(y2), y[1:])
    want = jrouter.TenantRouter._slice_entry(entry, 2 if version == "v1" else 1)
    assert got[0] == want[0] and got[2] == want[2]
    assert bytes(got[1]) == bytes(want[1]) if version == "v2" else got[1] == want[1]


def _stub_router():
    """A router wired to two stub backends without start(): src serves
    global tenant 0 in slot 0, dst is full (no vacancy)."""
    r = TenantRouter([BackendSpec("127.0.0.1:1:2"), BackendSpec("127.0.0.1:3:4")])
    src, dst = r.backends
    src.name, dst.name = "src", "dst"
    src.slot_ids, dst.slot_ids = [0], [7]
    r._by_name = {"src": src, "dst": dst}
    r.ring = HashRing(["src", "dst"])
    r.place[0] = (src, 0)
    r._state[0] = "active"
    r._buffer[0] = deque()
    r._buffered_rows[0] = 0
    r._pending[0] = []
    r._pending_rows[0] = 0
    r.rows_forwarded[0] = 0
    return r, src, dst


def test_migrate_failure_resumes_at_source():
    """A migration that cannot land (no vacant slot) resumes the tenant at
    its still-live source, never orphaned with its rows held."""
    r, src, dst = _stub_router()
    src.send = lambda payload: None
    src.control = lambda line, timeout=120.0: f"OK {line.split()[0]} done"
    src.statusz = lambda timeout=5.0: {
        "tenant_detail": [{"id": 0, "rows_admitted": 0, "buffered": 0}]}
    assert r.migrate_tenant(0, "dst", drain_timeout=0.5) is False
    assert r._state[0] == "active" and r.place[0] == (src, 0)
    assert src.slot_ids == [0] and dst.slot_ids == [7]
    assert r._pending[0] == [] and r._pending_rows[0] == 0


def test_orphaned_pending_is_capped():
    """An orphaned tenant's held rows are bounded like the replay buffer;
    dropped rows count in rows_lost."""
    r, _, _ = _stub_router()
    r.replay_rows = 8
    r._state[0] = "orphaned"
    for i in range(5):
        r._dispatch(0, ("v1", [f"{i},0"] * 4, 4))
    assert r._pending_rows[0] == 8 and len(r._pending[0]) == 2
    assert r.rows_lost == 12 and 0 in r._pending_overflowed


def test_rebalance_survives_migration_race(monkeypatch):
    """A rebalance plan racing a failover (migrate_tenant raises) skips
    the round instead of killing the rebalance thread."""
    import urllib.error

    r, src, dst = _stub_router()
    monkeypatch.setattr(trouter, "plan_rebalance", lambda *a: (0, "src", "dst"))

    def boom(g, dst_name, **kw):
        raise RuntimeError("tenant 0 is quiesced; cannot migrate")

    monkeypatch.setattr(r, "migrate_tenant", boom)
    for b in (src, dst):
        b.statusz = lambda timeout=5.0: (_ for _ in ()).throw(urllib.error.URLError("down"))
    assert r.rebalance_once() is None


# -- the fleet end to end -----------------------------------------------------


def _kw(tele=None, tenants=2, **kw):
    kw.setdefault("seed", 5)
    return dict(partitions=4, per_batch=25, model="centroid", shuffle_batches=True,
                results_csv="", window=1, data_policy="quarantine", telemetry_dir=tele,
                tenants=tenants, **kw)


def _pkw(stream, **kw):
    kw.setdefault("port", 0)
    kw.setdefault("ops_port", 0)
    kw.setdefault("chunk_batches", 2)
    kw.setdefault("linger_s", 0.05)
    return dict(num_features=stream.num_features, num_classes=stream.num_classes, **kw)


def _daemon(tele, stream, tenants=2, cfg_kw=None, **kw):
    r = ServeRunner(RunConfig(**_kw(tele, tenants=tenants, **(cfg_kw or {}))),
                    ServeParams(**_pkw(stream, **kw)), keep_flags=True, device="cpu")
    banner = r.start()
    t = threading.Thread(target=r.serve_forever, daemon=True)
    t.start()
    return r, banner, t


def _solo(pkg, cfg_kw, stream, feeds):
    """A daemon of ``pkg`` fed ``feeds`` (a list of per-tenant line lists,
    flushed in order) in process; returns it drained."""
    if pkg == "port":
        r = ServeRunner(*cfg_kw, ServeParams(**_pkw(stream, port=None, ops_port=None)),
                        keep_flags=True, device="cpu")
    else:
        r = JServeRunner(*cfg_kw, JServeParams(**_pkw(stream, port=None, ops_port=None)),
                         keep_flags=True)
    r.start()
    for feed in feeds:
        for t, lines in enumerate(feed):
            r.admissions[t].admit_lines(lines)
        r.batcher.flush()
    r.request_stop()
    assert r.serve_forever() == 0
    return r


def _tenant_records(paths, gid):
    """Global tenant ``gid``'s per-tenant verdict entries across a fleet's
    sidecars, in rows_through order."""
    out = []
    for p in paths:
        if not p or not os.path.exists(p):
            continue
        for rec in read_verdicts(p):
            for ent in rec.get("tenants") or []:
                if int(ent.get("id", ent["tenant"])) == gid and ent["rows"]:
                    out.append(ent)
    out.sort(key=lambda e: int(e["rows_through"]))
    return out


def _records_equal(got, ref, msg=""):
    assert len(got) == len(ref), f"{msg}: {len(got)} vs {len(ref)} entries"
    for i, (g, r) in enumerate(zip(got, ref)):
        for k in ("rows", "rows_through", "start_row", "detections"):
            assert int(g[k]) == int(r[k]), f"{msg} entry {i} {k}"
        assert [tuple(c) for c in g["changes"]] == [tuple(c) for c in r["changes"]], \
            f"{msg} entry {i} changes"


@pytest.fixture(scope="module")
def replay_stream():
    return planted_prototypes(5, concepts=3, rows_per_concept=220, features=6)


@pytest.mark.parametrize("router_pkg, wire_version", [("port", "v1"), ("port", "v2"),
                                                      ("jax", "v2")])
def test_fleet_router_replay_parity(router_pkg, wire_version, replay_stream, tmp_path,
                                    monkeypatch):
    """Two port daemons (a tenant and a vacant spare slot each) behind a
    router — the port's, or the JAX package's in front of port daemons —
    and a 2-tenant loadgen replay through it (``--router`` posture: global
    ids, fleet verdict tailing): full coverage, and each tenant's flags
    and verdict entries equal its solo daemon's on its dealt sub-stream,
    the port's and the JAX package's."""
    monkeypatch.chdir(tmp_path)
    stream = replay_stream
    lines = format_lines(stream.X, stream.y)
    backends = []
    for name, gid in (("A", 0), ("B", 1)):
        # a long linger: every seal at the wire's FLUSH/STOP drain
        backends.append(_daemon(f"tele{name}", stream, tenant_ids=(gid, -1), name=name,
                                linger_s=30.0))
    mod = trouter if router_pkg == "port" else jrouter
    router = mod.TenantRouter(
        [mod.BackendSpec(f"127.0.0.1:{b['port']}:{b['ops_port']}") for _, b, _ in backends],
        telemetry_dir=str(tmp_path / "teleR"), ops_port=0)
    banner = router.start()
    assert banner["tenants"] == [0, 1]
    X = np.ascontiguousarray(stream.X, np.float32)
    y = np.ascontiguousarray(stream.y, np.int32)
    rep = run_loadgen(banner["host"], banner["port"], lines if wire_version == "v1" else None,
                      rate=0.0, timeout=180, stop=True, tenants=2, wire_version=wire_version,
                      arrays=(X, y) if wire_version == "v2" else None, frame_rows=64,
                      fleet_dirs=["teleA", "teleB"])
    for _, _, t in backends:
        t.join(timeout=180)
        assert not t.is_alive()
    status = router.status()
    router.stop()
    assert not rep["timeout"] and rep["rows_covered"] == len(lines)
    assert rep["tenant_rows_covered"] == rep["tenant_rows_sent"]
    assert status["rows_lost"] == 0 and status["router"] is True
    journal = [json.loads(x) for x in open(tmp_path / "teleR" / "router.journal.jsonl")]
    assert journal and all("event" in e for e in journal)
    streams = [[], []]
    for base in range(0, len(lines), 64):
        streams[(base // 64) % 2].extend(range(base, min(base + 64, len(lines))))
    detections = 0
    for (r, _, _), gid in zip(backends, (0, 1)):
        sub = [lines[i] for i in streams[gid]]
        got = split_tenant_flags(r.flags(), 2)[0]  # slot 0 serves gid
        for pkg, cfgs in (("port", tenant_configs(RunConfig(**_kw()))),
                          ("jax", jtenant_configs(JRunConfig(**_kw())))):
            solo = _solo(pkg, (cfgs[gid],), stream, [[sub]])
            _flags_equal(got, solo.flags(), f"tenant {gid} against its {pkg} solo daemon")
        detections += int((np.asarray(got.change_global) >= 0).sum())
    assert detections > 0


def test_live_migration_bit_parity(tmp_path, monkeypatch):
    """Drain → ship checkpoint → resume on the second port daemon through
    the port's router: the migrated tenant's verdict entries equal an
    unmigrated 2-tenant daemon's (the port's and the JAX package's), no
    verdict is lost past the shipped checkpoint, the other tenant keeps
    serving, and the JAX package's ``top`` renders the router's live
    ``/statusz``."""
    from distributed_drift_detection_tpu.telemetry import top as jtop

    monkeypatch.chdir(tmp_path)
    stream = planted_prototypes(7, concepts=3, rows_per_concept=300, features=6)
    lines = format_lines(stream.X, stream.y)
    half = 2 * SPAN
    subs = [lines[0::2], lines[1::2]]
    backends, threads = {}, []
    for name, gid in (("A", 0), ("B", 1)):
        r, banner, t = _daemon(f"tele{name}", stream, cfg_kw=dict(seed=7),
                               tenant_ids=(gid, -1), name=name,
                               checkpoint=str(tmp_path / f"{name}.ckpt"),
                               tenant_checkpoints=True, linger_s=30.0)
        backends[name] = (r, banner)
        threads.append(t)
    router = TenantRouter([BackendSpec(f"127.0.0.1:{b['port']}:{b['ops_port']}")
                           for _, b in backends.values()],
                          telemetry_dir=str(tmp_path / "teleR"), ops_port=0)
    rbanner = router.start()

    def send(sock, gid, block):
        sock.sendall((f"TENANT {gid}\n" + "\n".join(block) + "\n").encode())

    with socket.create_connection(("127.0.0.1", router.port), timeout=30) as sock:
        send(sock, 0, subs[0][:half])
        send(sock, 1, subs[1][:half])
        sock.sendall(b"FLUSH\n")
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            with router._lock:
                if router.rows_forwarded[0] == half:
                    break
            time.sleep(0.02)
        else:
            pytest.fail("router never forwarded phase 1")
        deadline = time.monotonic() + 120
        while not router.migrate_tenant(0, "B"):
            assert time.monotonic() < deadline, "migration never succeeded"
            time.sleep(0.2)
        assert router.place[0][0].name == "B"
        rows = jtop.StatuszSource(f"http://127.0.0.1:{rbanner['ops_port']}/statusz").poll(0.0)
        row = rows[0]  # the router's row, then the port router's /fleetz rows
        assert len(rows) == 4  # the router, its two backends, the fleet aggregate
        assert row["status"] == "router" and "mig:1" in row["wire"] and "be:2/2" in row["wire"]
        assert "be:2/2" in jtop.render(rows, 0.0)
        send(sock, 0, subs[0][half:])
        send(sock, 1, subs[1][half:])
        sock.sendall(b"FLUSH\nSTOP\n")
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive()
    status = router.status()
    router.stop()
    assert status["migrations"] == 1 and status["rows_lost"] == 0
    journal = [json.loads(x) for x in open(tmp_path / "teleR" / "router.journal.jsonl")]
    assert any("migrat" in json.dumps(e) for e in journal)
    rA, _ = backends["A"]
    rB, _ = backends["B"]
    assert rB.tenant_ids.index(0) == 1  # landed in B's spare slot
    got0 = _tenant_records([rA.verdicts_path, rB.verdicts_path], 0)
    got1 = _tenant_records([rB.verdicts_path], 1)
    feeds = [[subs[0][:half], subs[1][:half]], [subs[0][half:], subs[1][half:]]]
    for pkg, cfg in (("port", RunConfig(**_kw(str(tmp_path / "tp"), seed=7))),
                     ("jax", JRunConfig(**_kw(str(tmp_path / "tj"), seed=7)))):
        solo = _solo(pkg, (cfg,), stream, feeds)
        ref0 = _tenant_records([solo.verdicts_path], 0)
        _records_equal(got0, ref0, f"tenant 0 against the {pkg} daemon")
        _records_equal(got1, _tenant_records([solo.verdicts_path], 1),
                       f"tenant 1 against the {pkg} daemon")
        assert sum(int(e["detections"]) for e in ref0) > 0
    covered = 0
    for ent in got0:
        assert int(ent["rows_through"]) - int(ent["rows"]) <= covered
        covered = max(covered, int(ent["rows_through"]))
    assert covered == len(subs[0])


def test_router_status_matches_jax_router(tmp_path, monkeypatch):
    """The port's router and the JAX package's, each in front of the same
    port daemon, answer ``/statusz`` with the same keys and placements,
    and the JAX package's ``top`` renders the port router's row as it
    renders its own router's."""
    from distributed_drift_detection_tpu.telemetry import top as jtop

    monkeypatch.chdir(tmp_path)
    stream = planted_prototypes(3, concepts=2, rows_per_concept=200, features=6)
    r, banner, t = _daemon("tele", stream, tenant_ids=(0, -1), name="A", linger_s=30.0)
    spec = f"127.0.0.1:{banner['port']}:{banner['ops_port']}"
    rows = {}
    statuses = {}
    for pkg, mod in (("port", trouter), ("jax", jrouter)):
        router = mod.TenantRouter([mod.BackendSpec(spec)], ops_port=0,
                                  telemetry_dir=str(tmp_path / f"tele{pkg}"))
        b = router.start()
        statuses[pkg] = router.status()
        with mock.patch.object(jtop.urllib.request, "urlopen",
                               return_value=_Resp(json.dumps(statuses[pkg]).encode())):
            got = jtop.StatuszSource(f"http://127.0.0.1:{b['ops_port']}/statusz").poll(0.0)
            rows[pkg] = got[0] if isinstance(got, list) else got
        router.stop()
    with socket.create_connection(("127.0.0.1", banner["port"]), timeout=30) as sock:
        sock.sendall(b"STOP\n")
    t.join(timeout=120)
    assert set(statuses["port"]) == set(statuses["jax"])
    assert statuses["port"]["placements"] == statuses["jax"]["placements"]
    assert rows["port"]["status"] == rows["jax"]["status"] == "router"
    assert rows["port"]["wire"] == rows["jax"]["wire"]


class _Resp(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_savetenant_refuses_buffered_rows(tmp_path, monkeypatch):
    """The control surface's safety rail on the port daemon: SAVETENANT
    under buffered (unsealed) rows answers ERR, as the JAX daemon does,
    and the daemon keeps serving."""
    monkeypatch.chdir(tmp_path)
    stream = planted_prototypes(3, concepts=2, rows_per_concept=200, features=6)
    r, banner, t = _daemon(None, stream, linger_s=60.0)
    lines = format_lines(stream.X, stream.y)
    with socket.create_connection(("127.0.0.1", banner["port"]), timeout=30) as sock:
        sock.sendall(("TENANT 0\n" + "\n".join(lines[:7]) + "\n").encode())
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and r.batcher.tenant_state(0)["buffered"] != 7:
            time.sleep(0.02)
        sock.sendall(f"SAVETENANT 0 {tmp_path / 'x.ckpt'}\n".encode())
        sock.settimeout(60)
        buf = b""
        while b"\n" not in buf:
            buf += sock.recv(4096)
        assert buf.startswith(b"ERR SAVETENANT 0") and b"buffered" in buf
        sock.sendall(b"FLUSH\nSTOP\n")
    t.join(timeout=120)
    assert not t.is_alive()
    assert not os.path.exists(tmp_path / "x.ckpt")


def test_router_and_loadgen_cli(tmp_path, monkeypatch, capsys):
    """``loadgen --router`` through the port's CLI, on the CPU: two port
    daemons (``--device cpu`` in the CLI's terms) behind the port's router,
    and the loadgen JSON covering every row across both daemons'
    sidecars."""
    from distributed_drift_detection_tpu_torch.__main__ import main

    monkeypatch.chdir(tmp_path)
    spec = "synth:prototypes,seed=5,concepts=2,rows_per_concept=200,features=6"
    from distributed_drift_detection_tpu_torch.io.synth import parse_synth

    X, y = parse_synth(spec[len("synth:"):])
    stream = planted_prototypes(5, concepts=2, rows_per_concept=200, features=6)
    assert np.array_equal(X, stream.X) and np.array_equal(y, stream.y)
    backends = [_daemon(f"tele{n}", stream, tenant_ids=(g, -1), name=n, linger_s=30.0)
                for n, g in (("A", 0), ("B", 1))]
    router = TenantRouter([BackendSpec(f"127.0.0.1:{b['port']}:{b['ops_port']}")
                           for _, b, _ in backends], telemetry_dir=str(tmp_path / "teleR"))
    rb = router.start()
    with pytest.raises(SystemExit) as e:
        main(["loadgen", spec, "--port", str(rb["port"]), "--router", "--tenants", "2",
              "--dir", "teleA", "--dir", "teleB", "--stop", "--timeout", "120"])
    assert e.value.code == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for _, _, t in backends:
        t.join(timeout=120)
        assert not t.is_alive()
    router.stop()
    assert rep["router"] is True and rep["fleet_dirs"] == ["teleA", "teleB"]
    assert rep["rows_covered"] == rep["rows_sent"] == stream.num_rows
