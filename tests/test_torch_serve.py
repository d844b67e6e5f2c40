"""The port's serving daemon — ``serve/runner.py`` ``ServeRunner``,
``serve/admission.py`` and the ``serve`` CLI — against the JAX package,
on the CPU (the twin of ``tests/test_serve.py`` and the serving cases of
``tests/test_tenancy.py`` and ``tests/test_fleet_serving.py``).

Inputs: ``planted_prototypes`` streams of the JAX package (seeds 1–15,
2–3 concepts, 5–7 features), 4 partitions, 50 rows a batch, 2 batches a
chunk, ``window=1``, the centroid and DDM. The port daemon runs with
``device='cpu'``; its reference is the JAX package's one-shot ``run`` on
the same stream, the corrupted rows masked. Tolerance: none — ``FlagRows``
field by field, the extra served columns sentinels.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_drift_detection_tpu import RunConfig as JRunConfig  # noqa: E402
from distributed_drift_detection_tpu import run as jrun  # noqa: E402
from distributed_drift_detection_tpu.config import replace as jreplace  # noqa: E402
from distributed_drift_detection_tpu.config import tenant_configs as jtenant_configs  # noqa: E402
from distributed_drift_detection_tpu.io import planted_prototypes  # noqa: E402
from distributed_drift_detection_tpu.io.stream import StreamData  # noqa: E402
from distributed_drift_detection_tpu_torch import RunConfig  # noqa: E402
from distributed_drift_detection_tpu_torch.config import ServeParams  # noqa: E402
from distributed_drift_detection_tpu_torch.io.sanitize import read_quarantine  # noqa: E402
from distributed_drift_detection_tpu_torch.parallel.mesh import split_tenant_flags  # noqa: E402
from distributed_drift_detection_tpu_torch.resilience import faults  # noqa: E402
from distributed_drift_detection_tpu_torch.serve import (  # noqa: E402
    MicroBatcher,
    ServeRunner,
    read_verdicts,
)
from distributed_drift_detection_tpu_torch.serve.loadgen import apply_dirty, format_lines  # noqa: E402
from distributed_drift_detection_tpu_torch.telemetry import registry  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, B, CB = 4, 50, 2
SPAN = P * B * CB


def _kw(seed, **kw):
    kw.setdefault("data_policy", "quarantine")
    return dict(partitions=P, per_batch=B, model="centroid", shuffle_batches=True,
                results_csv="", seed=seed, window=1, **kw)


def _cfg(seed, telemetry_dir=None, **kw):
    return RunConfig(**_kw(seed, telemetry_dir=telemetry_dir, **kw))


def _params(stream, **kw):
    kw.setdefault("port", None)
    kw.setdefault("chunk_batches", CB)
    kw.setdefault("linger_s", 0.05)
    return ServeParams(num_features=stream.num_features,
                       num_classes=stream.num_classes, **kw)


def _runner(cfg, params, **kw):
    return ServeRunner(cfg, params, device="cpu", **kw)


def _drive(runner, lines, block=150):
    """Synchronous in-process serve: admit → flush → drain."""
    for i in range(0, len(lines), block):
        runner.admission.admit_lines(lines[i : i + block])
    runner.batcher.flush()
    runner.request_stop()
    assert runner.serve_forever() == 0
    return runner


def _jax_flags(stream, seed, bad_rows=(), **kw):
    """The JAX package's one-shot flags on ``stream``, ``bad_rows`` masked."""
    ok = None
    if len(bad_rows):
        ok = np.ones(stream.num_rows, bool)
        ok[list(bad_rows)] = False
    ref = StreamData(X=stream.X, y=stream.y, num_classes=stream.num_classes,
                     dist_between_changes=stream.dist_between_changes, row_ok=ok)
    return jrun(JRunConfig(**_kw(seed, **kw)), stream=ref).flags


def _assert_flag_parity(got, ref):
    """Served flags == batch flags on every FlagRows leaf; the extra served
    columns (grid padding past the one-shot width) are sentinels."""
    w = np.asarray(ref.change_global).shape[1]
    for name in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name))[:, :w],
                                      np.asarray(getattr(ref, name)), err_msg=name)
    assert np.all(np.asarray(got.change_global)[:, w:] == -1)
    assert np.all(~np.asarray(got.forced_retrain)[:, w:])


def _table_from_verdicts(records, partitions):
    total = max(r["flag_base"] + r["cols"] for r in records)
    cg = np.full((partitions, total), -1, np.int64)
    for r in records:
        for p, b, pos in r["changes"]:
            cg[p, r["flag_base"] + b] = pos
    return cg


# --- served vs batch (clean and quarantine, two seeds each) ----------------


@pytest.mark.parametrize("policy, seed", [("clean", 3), ("clean", 11),
                                          ("quarantine", 5), ("quarantine", 9)])
def test_served_vs_batch_parity(policy, seed, tmp_path, monkeypatch):
    """1,440 (clean) or 1,320 (dirty) rows: 3 full chunks and a short
    final chunk padded through the validity plane. Under quarantine, NaN
    cells and out-of-domain labels are masked in place; the sidecar names
    exactly those rows."""
    monkeypatch.chdir(tmp_path)
    rows = 480 if policy == "clean" else 440
    stream = planted_prototypes(seed, concepts=3, rows_per_concept=rows, features=7 - (policy != "clean"))
    lines = format_lines(stream.X, stream.y)
    bad_rows = []
    if policy == "quarantine":
        corrupted = apply_dirty(lines, f"nan_cell:6:{seed}")
        corrupted += apply_dirty(lines, f"bad_label:3:{seed + 1}")
        bad_rows = sorted({r for r, _ in corrupted})
        assert bad_rows
    runner = _runner(_cfg(seed, telemetry_dir=str(tmp_path / "tele")), _params(stream),
                     keep_flags=True)
    banner = runner.start()
    _drive(runner, lines)
    assert runner._published == 4  # multi-chunk, the short tail included
    ref = _jax_flags(stream, seed, bad_rows)
    assert (np.asarray(ref.change_global) >= 0).any()
    _assert_flag_parity(runner.flags(), ref)
    cg = _table_from_verdicts(read_verdicts(banner["verdicts"]), P)
    np.testing.assert_array_equal(cg, runner.flags().change_global)
    assert runner.admission.rows_quarantined == len(bad_rows)
    sidecar = os.path.splitext(banner["run_log"])[0] + ".quarantine.jsonl"
    recs = read_quarantine(sidecar) if os.path.exists(sidecar) else []
    assert {r["row"] for r in recs} == set(bad_rows)


# --- lifecycle --------------------------------------------------------------


def test_kill_and_resume_bit_identical(tmp_path, monkeypatch):
    """``serve.flush`` raises at the third publication (chunk 2's state
    advanced, its verdict and checkpoint not written); a fresh daemon
    resumes from the checkpoint, the client replays from
    ``rows_admitted``, and the two runs' flags are the batch run's."""
    monkeypatch.chdir(tmp_path)
    stream = planted_prototypes(4, concepts=3, rows_per_concept=400, features=7)
    cfg = _cfg(4, telemetry_dir=str(tmp_path / "tele"))
    ckpt = str(tmp_path / "serve.ckpt")
    lines = format_lines(stream.X, stream.y)
    faults.arm("serve.flush", at=3)
    try:
        r1 = _runner(cfg, _params(stream, checkpoint=ckpt), keep_flags=True)
        r1.start()
        for i in range(0, len(lines), 150):
            r1.admission.admit_lines(lines[i : i + 150])
        r1.batcher.flush()
        r1.request_stop()
        with pytest.raises(faults.InjectedFault):
            r1.serve_forever()
    finally:
        faults.disarm_all()
    assert r1._published == 2 and os.path.exists(ckpt)
    assert [r["status"] for r in registry.runs(str(tmp_path / "tele")).values()] == ["failed"]
    r2 = _runner(cfg, _params(stream, checkpoint=ckpt), keep_flags=True)
    banner = r2.start()
    assert banner["resumed"] and r2.resumed_meta["chunk_index"] == 2
    replay_from = int(r2.resumed_meta["rows_admitted"])
    assert replay_from == 800
    _drive(r2, lines[replay_from:])
    f1, f2 = r1.flags(), r2.flags()
    combined = type(f1)(*(np.concatenate([a, b], axis=1) for a, b in zip(f1, f2)))
    _assert_flag_parity(combined, _jax_flags(stream, 4))
    statuses = sorted(r["status"] for r in registry.runs(str(tmp_path / "tele")).values())
    assert statuses == ["completed", "failed"]


def test_serve_flush_torn_write_tears_sidecar(tmp_path, monkeypatch):
    """A torn write at the first publication leaves a torn trailing line
    the readers tolerate; a resumed daemon drops it before appending."""
    from distributed_drift_detection_tpu_torch.serve.runner import reconcile_torn_tail

    monkeypatch.chdir(tmp_path)
    stream = planted_prototypes(2, concepts=2, rows_per_concept=120, features=5)
    faults.arm("serve.flush", at=1, kind="torn_write")
    try:
        runner = _runner(_cfg(2, telemetry_dir=str(tmp_path / "t")), _params(stream))
        banner = runner.start()
        runner.admission.admit_lines(format_lines(stream.X, stream.y))
        runner.batcher.flush()
        runner.request_stop()
        with pytest.raises(faults.InjectedFault):
            runner.serve_forever()
    finally:
        faults.disarm_all()
    assert read_verdicts(banner["verdicts"]) == []
    with open(banner["verdicts"]) as fh:
        assert fh.read()  # the torn prefix is there
    assert reconcile_torn_tail(banner["verdicts"])
    assert os.path.getsize(banner["verdicts"]) == 0


def test_ingress_fault_poisons_daemon(tmp_path, monkeypatch):
    """An armed ``serve.ingress`` fault poisons the batcher; the serve
    loop raises it and the registry reads ``failed``."""
    monkeypatch.chdir(tmp_path)
    stream = planted_prototypes(6, concepts=2, rows_per_concept=100, features=5)
    runner = _runner(_cfg(6, telemetry_dir=str(tmp_path / "t")), _params(stream))
    runner.start()
    loop_exc = []

    def _loop():
        try:
            runner.serve_forever()
        except BaseException as e:  # noqa: BLE001 — the test inspects it
            loop_exc.append(e)

    t = threading.Thread(target=_loop)
    t.start()
    faults.arm("serve.ingress", at=2)
    try:
        runner.admission.admit_lines(format_lines(stream.X[:50], stream.y[:50]))
        with pytest.raises(faults.InjectedFault) as ei:
            runner.admission.admit_lines(format_lines(stream.X[50:], stream.y[50:]))
        runner.batcher.poison(ei.value)
    finally:
        faults.disarm_all()
    t.join(timeout=60)
    assert not t.is_alive()
    assert loop_exc and isinstance(loop_exc[0], faults.InjectedFault)
    assert [r["status"] for r in registry.runs(str(tmp_path / "t")).values()] == ["failed"]


@pytest.mark.parametrize("how", ["linger", "drain"])
def test_partial_batch_sealed(how, tmp_path, monkeypatch):
    """``linger``: a partial microbatch seals short at its deadline and
    positions advance by the full grid span. ``drain``: ``request_stop``
    (the SIGTERM path) seals the lingering partial batch and publishes it
    before the registry reads ``completed``."""
    monkeypatch.chdir(tmp_path)
    if how == "linger":
        mb = MicroBatcher(2, 10, 2, linger_s=0.05)
        mb.push(np.zeros((7, 3), np.float32), np.zeros(7, np.int32))
        t0 = time.monotonic()
        item = mb.get(2.0)
        assert item is not None and item.meta["rows"] == 7 and item.meta["short"]
        assert time.monotonic() - t0 < 1.0
        assert mb.start_row == 2 * 10 * 2
        return
    stream = planted_prototypes(1, concepts=2, rows_per_concept=90, features=5)
    runner = _runner(_cfg(1, telemetry_dir=str(tmp_path / "t")),
                     _params(stream, linger_s=60.0), keep_flags=True)
    runner.start()
    t = threading.Thread(target=runner.serve_forever)
    t.start()
    runner.admission.admit_lines(format_lines(stream.X, stream.y))
    runner.request_stop()
    t.join(timeout=60)
    assert not t.is_alive()
    assert runner._rows_published == stream.num_rows
    rec = list(registry.runs(str(tmp_path / "t")).values())
    assert [r["status"] for r in rec] == ["completed"] and rec[0]["kind"] == "serve"


def test_sigterm_drain_and_restart_resume(tmp_path):
    """The ``serve`` subcommand with ``--device cpu`` as a process: SIGTERM
    drains (exit 0, registry completed, checkpoint on disk); a restarted
    daemon resumes and the two verdict streams rebuild the JAX package's
    batch flags."""
    stream = planted_prototypes(15, concepts=2, rows_per_concept=300, features=5)
    ref = _jax_flags(stream, 15)
    tele = str(tmp_path / "tele")
    ckpt = str(tmp_path / "serve.ckpt")
    lines = format_lines(stream.X, stream.y)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    argv = [
        sys.executable, "-m", "distributed_drift_detection_tpu_torch", "serve",
        "--features", "5", "--classes", "2", "--partitions", "4", "--per-batch", "50",
        "--chunk-batches", "1", "--port", "0", "--seed", "15", "--telemetry-dir", tele,
        "--checkpoint", ckpt, "--linger-s", "0.1", "--device", "cpu",
    ]

    def _run_daemon(send_lines, cover_through):
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE, env=env, text=True, cwd=tmp_path)
        try:
            banner = json.loads(proc.stdout.readline())
            with socket.create_connection((banner["host"], banner["port"]), timeout=10) as sock:
                sock.sendall(("\n".join(send_lines) + "\nFLUSH\n").encode())
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                recs = read_verdicts(banner["verdicts"])
                if recs and recs[-1]["rows_through"] >= cover_through:
                    break
                time.sleep(0.05)
            else:
                raise AssertionError("verdicts never covered the replay")
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=120) == 0
            return banner
        finally:
            if proc.poll() is None:
                proc.kill()

    half = 400  # aligned to the [4, 1, 50] = 200-row chunk grid
    b1 = _run_daemon(lines[:half], half)
    assert [r["status"] for r in registry.runs(tele).values()] == ["completed"]
    assert os.path.exists(ckpt)
    b2 = _run_daemon(lines[half:], len(lines))
    assert b2["resumed"]
    cg = _table_from_verdicts(read_verdicts(b1["verdicts"]) + read_verdicts(b2["verdicts"]), 4)
    w = np.asarray(ref.change_global).shape[1]
    np.testing.assert_array_equal(cg[:, :w], np.asarray(ref.change_global))
    assert np.all(cg[:, w:] == -1)
    assert sorted(r["status"] for r in registry.runs(tele).values()) == ["completed", "completed"]


# --- tenants ----------------------------------------------------------------


def _tenant_streams(T=2):
    return [planted_prototypes(5 + t, concepts=3, rows_per_concept=400, features=7)
            for t in range(T)]


def _admit_interleaved(runner, lines, lo, hi):
    for base in range(lo, hi, SPAN):
        for t, tl in enumerate(lines):
            runner.admissions[t].admit_lines(tl[base : min(base + SPAN, hi)])


def test_tenant_slots_equal_solo_daemons(tmp_path, monkeypatch):
    """A 2-slot daemon fed interleaved per-tenant traffic: each slot's
    flags equal its tenant's solo port daemon and the JAX package's solo
    batch run; the sidecar attributes each tenant's detections."""
    monkeypatch.chdir(tmp_path)
    streams = _tenant_streams()
    lines = [format_lines(s.X, s.y) for s in streams]
    runner = _runner(_cfg(5, tenants=2), _params(streams[0]), keep_flags=True)
    runner.start()
    _admit_interleaved(runner, lines, 0, len(lines[0]))
    runner.batcher.flush()
    runner.request_stop()
    assert runner.serve_forever() == 0
    recs = read_verdicts(runner.verdicts_path)  # before the solo daemons reuse the path
    per = split_tenant_flags(runner.flags(), 2)
    jcfg = JRunConfig(**_kw(5, tenants=2))
    for t, c in enumerate(jtenant_configs(jcfg)):
        solo = _drive(_start(_runner(_cfg(5 + t), _params(streams[t]), keep_flags=True)),
                      lines[t])
        ref = jrun(jreplace(c, data_policy="strict"), stream=streams[t]).flags
        assert (np.asarray(ref.change_global) >= 0).any()
        for name in ref._fields:
            np.testing.assert_array_equal(getattr(per[t], name), getattr(solo.flags(), name),
                                          err_msg=f"tenant {t} {name}")
        _assert_flag_parity(per[t], ref)
    assert recs and all(len(r["tenants"]) == 2 for r in recs)
    for r in recs:
        assert sum(e["detections"] for e in r["tenants"]) == r["detections"]


def _start(runner):
    runner.start()
    return runner


def _serve_in_thread(runner):
    t = threading.Thread(target=runner.serve_forever)
    t.start()
    return t


def _control(runner, op, slot, path):
    got = []
    runner.request_control(op, slot, path, got.append)
    deadline = time.monotonic() + 60
    while not got and time.monotonic() < deadline:
        time.sleep(0.01)
    assert got, f"{op} never answered"
    return got[0]


def _wait_published(runner, n):
    deadline = time.monotonic() + 60
    while runner._published < n and time.monotonic() < deadline:
        time.sleep(0.01)
    assert runner._published >= n


def test_savetenant_loadtenant_round_trip(tmp_path, monkeypatch):
    """``SAVETENANT`` of slot 1 after two published chunks, then
    ``LOADTENANT`` into slot 1 of a fresh 2-slot daemon fed the rest of
    that tenant's stream: the tenant's flags continue bit for bit those
    of an uninterrupted 2-slot daemon."""
    monkeypatch.chdir(tmp_path)
    streams = _tenant_streams()
    lines = [format_lines(s.X, s.y) for s in streams]
    n = len(lines[0])
    whole = _runner(_cfg(5, tenants=2), _params(streams[0]), keep_flags=True)
    whole.start()
    _admit_interleaved(whole, lines, 0, n)
    whole.batcher.flush()
    whole.request_stop()
    assert whole.serve_forever() == 0
    ref = split_tenant_flags(whole.flags(), 2)[1]

    cut = 2 * SPAN
    ckpt = str(tmp_path / "slot1.ckpt")
    a = _runner(_cfg(5, tenants=2), _params(streams[0], linger_s=60.0), keep_flags=True)
    a.start()
    ta = _serve_in_thread(a)
    _admit_interleaved(a, lines, 0, cut)
    _wait_published(a, 2)
    assert _control(a, "SAVETENANT", 1, ckpt) == f"OK SAVETENANT 1 {cut}"
    a.request_stop()
    ta.join(timeout=60)

    b = _runner(_cfg(5, tenants=2), _params(streams[0]), keep_flags=True)
    b.start()
    tb = _serve_in_thread(b)
    assert _control(b, "LOADTENANT", 1, ckpt) == f"OK LOADTENANT 1 {cut}"
    assert b.batcher.tenant_state(1)["start_row"] == cut
    _admit_interleaved(b, lines, cut, n)
    b.batcher.flush()
    b.request_stop()
    tb.join(timeout=60)
    assert not tb.is_alive()
    got = split_tenant_flags(b.flags(), 2)[1]
    col = 2 * CB - 1  # the first chunk loses its first microbatch to batch_a
    w = got.change_global.shape[1]
    assert (ref.change_global[:, col:] >= 0).any()
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name)[:, col : col + w],
                                      err_msg=name)
