"""The port's eleven readers — ``report``, ``perf``, ``watch``, ``top``,
``pipeline``, ``history``, ``collector``, ``correlate``, ``timeline``,
``explain`` and ``incident`` (``telemetry/``) — against the JAX package's.

Each case runs one subcommand through the port's ``__main__.main`` and the
JAX package's on the same artifacts and requires the same standard output,
standard error and exit code; the program name in argparse's usage lines is
the one difference allowed. Where a reader writes a file (``timeline -o``,
``top --record``, ``collector --store``), each package writes its own and
the files must be equal byte for byte.

The artifacts, written by both packages on the CPU: a telemetered
``synth:`` run (JAX ``run``, port ``run(device='cpu')``); a served stream
with forensics (a JAX daemon and a port daemon); a planted ``serve.flush``
stall under a ``stall_s`` rule, whose incident bundle each package's
daemon writes; two processes' run logs of one config, one written by each
package's ``EventLog`` on clocks 500 s apart; history stores written by
each package's ``HistoryStore`` with the same samples, a torn copy, and
the stores each package's ``collector`` and ``top --record`` build; the
repo's ``BENCH_r0*.json`` files and torn copies of them. ``top`` and
``collector`` scrape stub ``http.server`` endpoints that serve fixed
``/statusz``, ``/fleetz``, ``/metrics`` and ``/incidentz`` bodies (the
port daemon's own). The wall and monotonic clocks are frozen while a
reader runs, so ages, stamps and the collector's boot token are equal.
A subprocess per reader checks that its CLI imports neither torch nor JAX.
"""

import glob
import http.server
import itertools
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from distributed_drift_detection_tpu import RunConfig as JRunConfig  # noqa: E402
from distributed_drift_detection_tpu import __main__ as jmain  # noqa: E402
from distributed_drift_detection_tpu import run as jrun  # noqa: E402
from distributed_drift_detection_tpu.config import ServeParams as JServeParams  # noqa: E402
from distributed_drift_detection_tpu.io import planted_prototypes  # noqa: E402
from distributed_drift_detection_tpu.resilience import faults as jfaults  # noqa: E402
from distributed_drift_detection_tpu.serve import ServeRunner as JServeRunner  # noqa: E402
from distributed_drift_detection_tpu.telemetry import events as jevents  # noqa: E402
from distributed_drift_detection_tpu.telemetry import history as jhistory  # noqa: E402
from distributed_drift_detection_tpu.telemetry import watch as jwatch  # noqa: E402
from distributed_drift_detection_tpu_torch import RunConfig  # noqa: E402
from distributed_drift_detection_tpu_torch import __main__ as tmain  # noqa: E402
from distributed_drift_detection_tpu_torch import run as trun  # noqa: E402
from distributed_drift_detection_tpu_torch.config import ServeParams  # noqa: E402
from distributed_drift_detection_tpu_torch.resilience import faults as tfaults  # noqa: E402
from distributed_drift_detection_tpu_torch.serve import ServeRunner  # noqa: E402
from distributed_drift_detection_tpu_torch.serve.loadgen import format_lines  # noqa: E402
from distributed_drift_detection_tpu_torch.telemetry import events as tevents  # noqa: E402
from distributed_drift_detection_tpu_torch.telemetry import history as thistory  # noqa: E402
from distributed_drift_detection_tpu_torch.telemetry import pipeline as tpipeline  # noqa: E402
from distributed_drift_detection_tpu_torch.telemetry import registry as tregistry  # noqa: E402
from distributed_drift_detection_tpu_torch.telemetry import watch as twatch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = "prototypes,seed=0,concepts=6,rows_per_concept=100,features=5"
RUN = dict(dataset=f"synth:{SPEC}", mult_data=3, partitions=4, per_batch=50, results_csv="")
P, B, CB = 4, 50, 2
T0 = 1_000_000.0  # the hand-written stores' first stamp
READERS = ("report", "perf", "watch", "top", "pipeline", "history", "collector",
           "correlate", "timeline", "explain", "incident")


def _serve_kw(tele, **kw):
    return dict(partitions=P, per_batch=B, model="centroid", results_csv="", seed=21,
                window=1, data_policy="quarantine", telemetry_dir=tele, **kw)


def _serve(make_runner, lines):
    runner = make_runner()
    banner = runner.start()
    for i in range(0, len(lines), 150):
        runner.admission.admit_lines(lines[i : i + 150])
    runner.batcher.flush()
    runner.request_stop()
    assert runner.serve_forever() == 0
    return banner, runner


def _stall(make_runner, stream, faults_mod):
    """A ``serve.flush`` stall of 1.5 s under ``stall_s=0.4``: the daemon's
    incident recorder writes one bundle, resolved once publish resumes."""
    faults_mod.arm("serve.flush", kind="stall", at=1, seconds=1.5)
    try:
        runner = make_runner()
        runner.start()
        thread = threading.Thread(target=runner.serve_forever, daemon=True)
        thread.start()
        runner.admission.admit_lines(format_lines(stream.X[:100], stream.y[:100]))
        runner.batcher.flush()
        deadline = time.monotonic() + 30
        while not runner._incidents.count() and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(1.6)  # the stall ends, publish resumes, the alert resolves
        runner.request_stop()
        thread.join(60)
    finally:
        faults_mod.disarm_all()
    assert not thread.is_alive()


def _fill_store(store_cls, root):
    """Three tenants' rows counters, stage busy counters and a gauge, one
    instance, 12 stamps of one writer run, rotated in segments of 2 KiB."""
    store = store_cls(root, segment_bytes=2048, boot="writer-0")
    for k in range(12):
        samples = [(thistory.TENANT_ROWS_METRIC, {"tenant": str(t), "instance": "d0"},
                    float(k * (t + 1) * 100)) for t in range(3)]
        samples += [(tpipeline.SERVE_STAGE_BUSY_METRIC, {"stage": s, "instance": "d0"},
                     float(k * w)) for s, w in (("feed", 0.2), ("device", 0.5),
                                               ("publish", 0.1))]
        samples += [(tpipeline.SERVE_WALL_METRIC, {"instance": "d0"}, float(k)),
                    (tpipeline.SERVE_ROWS_METRIC, {"instance": "d0"}, float(k * 1000)),
                    ("serve_p99_ms", {"instance": "d0"}, 3.0 + (k % 4)),
                    ("serve_incidents_total", {"instance": "d0"}, float(k // 5))]
        store.append_samples(samples, ts=T0 + 10 * k, mono=50.0 + 10 * k)
    store.close()


def _proc_log(log_cls, path, t0, index, config):
    """One process's run log of a two-process run on a fixed clock."""
    now = {"t": t0}
    log = log_cls(path, clock=lambda: now["t"])
    log.emit("run_started", run_id=f"mp-proc{index}", config=config, hostname=f"host{index}",
             process_index=index, process_count=2)
    for dt, etype, fields in (
        (1.0, "phase_completed", {"phase": "upload", "seconds": 0.4}),
        (2.0 + index, "phase_completed", {"phase": "detect", "seconds": 1.0 + index}),
        (3.0 + index, "heartbeat", {"rows_done": 800, "elapsed_s": 2.0 + index}),
        (4.0 + index, "chunk_completed", {"chunk": 0, "batches_done": 4, "detections": 1}),
        (5.0 + index, "run_completed", {"rows": 800, "seconds": 5.0 + index, "detections": 2}),
    ):
        now["t"] = t0 + dt
        log.emit(etype, **fields)
    log.close()


class _Stub(http.server.BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - the stdlib's name
        body = self.server.bodies.get(self.path.split("?")[0])
        if body is None:
            self.send_error(404)
            return
        data = body.encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def date_time_string(self, timestamp=None):
        return "Thu, 01 Jan 2026 00:00:00 GMT"  # reads no clock

    def log_message(self, *args):
        pass


def _stub_server(bodies):
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    server.bodies = bodies
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """Every artifact the cases read, by placeholder name."""
    root = tmp_path_factory.mktemp("readers")
    a = {"root": str(root), "empty": str(root / "empty")}
    os.makedirs(a["empty"])
    cwd = os.getcwd()
    os.chdir(root)
    tfaults.disarm_all()
    jfaults.disarm_all()
    try:
        # a telemetered synth: run, each package
        for name, run, cfg in (("j", jrun, JRunConfig),
                               ("p", lambda c: trun(c, device="cpu"), RunConfig)):
            res = run(cfg(**RUN, telemetry_dir=str(root / f"run_{name}")))
            a[f"{name}run"], a[f"{name}rundir"] = res.telemetry_path, str(root / f"run_{name}")
        # a served stream with forensics, each package
        stream = planted_prototypes(21, concepts=3, rows_per_concept=400, features=6)
        lines = format_lines(stream.X, stream.y)
        pkw = dict(num_features=6, num_classes=stream.num_classes, port=None,
                   chunk_batches=CB, linger_s=0.05, trace_sample=1.0)
        for name, make in (
            ("j", lambda d: JServeRunner(JRunConfig(**_serve_kw(d)), JServeParams(**pkw))),
            ("p", lambda d: ServeRunner(RunConfig(**_serve_kw(d)), ServeParams(**pkw),
                                        device="cpu")),
        ):
            d = str(root / f"served_{name}")
            banner, runner = _serve(lambda: make(d), lines)
            a[f"{name}served"], a[f"{name}servedlog"] = d, banner["run_log"]
            stem = os.path.splitext(banner["run_log"])[0]
            a[f"{name}bundle"] = sorted(glob.glob(stem + ".forensics/drift-*.json"))[0]
            if name == "p":
                statusz, metrics = runner._statusz(), runner._metrics.to_prometheus_text()
        a["pprom"] = os.path.splitext(a["pservedlog"])[0] + ".prom"
        a["pmetricsjson"] = os.path.splitext(a["pservedlog"])[0] + ".metrics.json"
        # the planted stall's incident bundle, each package
        small = planted_prototypes(2, concepts=2, rows_per_concept=100, features=6)
        skw = dict(num_features=6, num_classes=small.num_classes, port=None, ops_port=0,
                   chunk_batches=CB, linger_s=0.05, heartbeat_s=0.1, slo=("stall_s=0.4",),
                   slo_interval_s=0.05)
        for name, make, fmod in (
            ("j", lambda d: JServeRunner(JRunConfig(**_serve_kw(d)), JServeParams(**skw)),
             jfaults),
            ("p", lambda d: ServeRunner(RunConfig(**_serve_kw(d)), ServeParams(**skw),
                                        device="cpu"), tfaults),
        ):
            d = str(root / f"stall_{name}")
            _stall(lambda: make(d), small, fmod)
            a[f"{name}stall"] = d
        (inc,) = glob.glob(str(root / "stall_p" / "*.incidents"))
        a["pincbundle"] = sorted(glob.glob(os.path.join(inc, "incident-*")))[0]
        a["partialinc"] = str(root / "partial.incidents")
        shutil.copytree(inc, a["partialinc"])
        os.remove(os.path.join(a["partialinc"], os.path.basename(a["pincbundle"]),
                               "manifest.json"))
        # two processes of one run, one log written by each package
        mp = root / "mp"
        os.makedirs(mp)
        config = {"dataset": "synth", "seed": 1, "partitions": 8}
        _proc_log(tevents.EventLog, str(mp / "run-proc0.jsonl"), 1000.0, 0, config)
        _proc_log(jevents.EventLog, str(mp / "run-proc1.jsonl"), 1500.0, 1, config)
        a["mp"], a["mp0"], a["mp1"] = str(mp), str(mp / "run-proc0.jsonl"), str(mp / "run-proc1.jsonl")
        # history stores with the same samples, each package's writer; a torn
        # copy of the port's (a line cut short after the last whole line)
        for name, cls in (("j", jhistory.HistoryStore), ("p", thistory.HistoryStore)):
            _fill_store(cls, str(root / f"store_{name}"))
            a[f"{name}store"] = str(root / f"store_{name}")
        a["tornstore"] = str(root / "store_torn")
        shutil.copytree(a["pstore"], a["tornstore"])
        last = thistory.list_segments(a["tornstore"])[-1]
        with open(last, "a") as fh:
            fh.write('{"name": "serve_p99_ms", "labels": {"instance": "d0"}, "ts": 1000')
        # run logs cut short: the port's run without run_completed, and a torn
        # final line
        with open(a["prun"]) as fh:
            body = fh.read().splitlines(keepends=True)
        a["stalledlog"], a["tornlog"] = str(root / "stalled.jsonl"), str(root / "torn.jsonl")
        with open(a["stalledlog"], "w") as fh:
            fh.writelines(body[:-1])
        with open(a["tornlog"], "w") as fh:
            fh.writelines(body[:-1])
            fh.write(body[-1][: len(body[-1]) // 2])
        # bench artifacts: the repo's, a wrapper whose tail lost more of its
        # head, a raw line cut mid-way, and a file that is not JSON at all
        a.update({f"bench{k}": os.path.join(REPO, f"BENCH_r0{k}.json") for k in range(1, 6)})
        with open(a["bench4"]) as fh:
            w4 = json.load(fh)
        line = next(ln for ln in w4["tail"].splitlines() if ln.startswith("{"))
        a["benchhead"] = str(root / "BENCH_head.json")
        with open(a["benchhead"], "w") as fh:
            json.dump({**w4, "parsed": None, "tail": line[len(line) // 3:]}, fh)
        a["benchcut"] = str(root / "BENCH_cut.json")
        with open(a["benchcut"], "w") as fh:
            fh.write(line[: len(line) // 2])
        a["benchbad"] = str(root / "BENCH_bad.json")
        with open(a["benchbad"], "w") as fh:
            fh.write("[1, 2]")
    finally:
        os.chdir(cwd)
        tfaults.disarm_all()
        jfaults.disarm_all()
    # stub ops endpoints: a daemon (the port daemon's /statusz and /metrics,
    # an incident index) and a router whose /fleetz lists it and a dead one
    daemon, a["stub"] = _stub_server({"/statusz": json.dumps(statusz), "/metrics": metrics,
                                      "/incidentz": json.dumps({"count": 2, "open": 1})})
    fleetz = tpipeline.aggregate_fleet([
        tpipeline.backend_snapshot("d0", statusz, metrics, ops=a["stub"]),
        tpipeline.backend_snapshot("d1", None, ops="127.0.0.1:1"),
    ])
    router_statusz = {"router": True, "run_id": "router", "uptime_s": 5.0, "draining": False,
                      "rows": {"published": 1000, "admitted": 1000}, "detections": None,
                      "ingress": {"frames_v1": 3, "frames_v2": 7, "decode_errors": 0},
                      "migrations": 1, "failovers": 2, "rows_lost": 0,
                      "alerts": [{"rule": "backend_dead:d1"}],
                      "backends": [{"name": "d0", "alive": True},
                                   {"name": "d1", "alive": False}], "placements": {}}
    router, a["router"] = _stub_server({"/statusz": json.dumps(router_statusz),
                                        "/fleetz": json.dumps(fleetz)})
    a["regdir"] = str(root / "registry")
    tregistry.record(a["regdir"], "serve-d0", "running", kind="serve", name="d0", ops=a["stub"])
    tregistry.record(a["regdir"], "serve-old", "completed", kind="serve", name="old",
                     ops="127.0.0.1:1")
    a["now"] = time.time() + 30.0
    a["later"] = repr(a["now"] + 30.0)  # a window end past the built stores' stamps
    yield a
    daemon.shutdown()
    router.shutdown()


def _freeze(monkeypatch, now):
    """Replace both clocks, for one reader's run, by clocks that start at
    ``now`` (the monotonic one at 5000) and step 0.25 s a reading, so the
    same code reads the same times (``watch`` binds its clock as a
    default)."""
    ticks = itertools.count()

    def wall():
        return now + 0.25 * next(ticks)

    monkeypatch.setattr(time, "time", wall)
    monkeypatch.setattr(time, "monotonic", lambda: 5000.0 + 0.25 * next(ticks))
    for mod in (jwatch, twatch):
        monkeypatch.setitem(mod.watch.__kwdefaults__, "clock", wall)


def _invoke(main, argv, capsys):
    """``(exit code, stdout, stderr)``; an exception that ends the CLI is
    its code as ``type: message``."""
    try:
        main(argv)
        code = 0
    except SystemExit as e:
        code = 0 if e.code is None else e.code
    except Exception as e:  # noqa: BLE001 - compared, not handled
        code = f"{type(e).__name__}: {e}"
    cap = capsys.readouterr()
    return code, cap.out, cap.err


def _tree(d):
    """Every file under ``d``: relative path -> bytes (a file: its bytes)."""
    if not os.path.isdir(d):
        with open(d, "rb") as fh:
            return fh.read()
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def _program_name_aside(text):
    """The port's program name as the JAX package's, and argparse's usage
    blocks (wrapped at the program name's length) on one line each."""
    lines, out = text.replace("distributed_drift_detection_tpu_torch",
                              "distributed_drift_detection_tpu").split("\n"), []
    for line in lines:
        if out and out[-1].startswith("usage: ") and line.startswith(" "):
            out[-1] = " ".join([out[-1], *line.split()])
        else:
            out.append(" ".join(line.split()) if line.startswith("usage: ") else line)
    return "\n".join(out)


def _compare(art, argv, capsys, monkeypatch, tmp_path, writes=()):
    """Run ``argv`` through both packages' CLIs: equal code, stdout and
    stderr (the port's program name aside), and every path of ``writes``
    (under ``{out}``) equal byte for byte. Returns the port's result."""
    got = {}
    for name, main in (("jax", jmain.main), ("port", tmain.main)):
        out = str(tmp_path / name)
        os.makedirs(out)
        args = [a.format(out=out, **art) for a in argv]
        _freeze(monkeypatch, art["now"])
        try:
            code, stdout, stderr = _invoke(main, args, capsys)
        finally:
            monkeypatch.undo()
        norm = _program_name_aside
        got[name] = (code if not isinstance(code, str) else norm(code),
                     norm(stdout).replace(out, "{out}"), norm(stderr).replace(out, "{out}"),
                     {w: _tree(os.path.join(out, w)) for w in writes})
    assert got["port"][0] == got["jax"][0], "exit code"
    assert got["port"][1] == got["jax"][1], "stdout"
    assert got["port"][2] == got["jax"][2], "stderr"
    for w in writes:
        assert got["port"][3][w] == got["jax"][3][w], w
    return got["port"]


COLLECT = ["--count", "2", "--interval", "0", "--timeout", "2"]
CASES = {
    # report: run logs and served logs of both packages, --dir, errors
    "report-port-run": (["report", "{prun}"], 0),
    "report-jax-run": (["report", "{jrun}"], 0),
    "report-port-dir": (["report", "--dir", "{prundir}"], 0),
    "report-port-served": (["report", "{pservedlog}"], 0),
    "report-jax-served": (["report", "--dir", "{jserved}"], 0),
    "report-empty-dir": (["report", "--dir", "{empty}"], "report: no run logs in {empty}"),
    "report-usage": (["report"], 2),
    # perf: the repo's bench artifacts (r05's tail is head-truncated) and torn copies
    "perf-r04-r05": (["perf", "{bench4}", "{bench5}"], None),
    "perf-all-informational": (["perf", "{bench1}", "{bench2}", "{bench3}", "{bench4}",
                                "{bench5}", "--informational"], 0),
    "perf-tolerance": (["perf", "{bench3}", "{bench4}", "--tolerance", "0.01"], None),
    "perf-head-torn": (["perf", "{bench4}", "{benchhead}"], None),
    "perf-cut-line": (["perf", "{bench4}", "{benchcut}"], None),
    "perf-not-bench": (["perf", "{benchbad}"], None),
    # watch: completed, stalled, torn, nothing
    "watch-port-run": (["watch", "{prun}", "--once"], 0),
    "watch-jax-dir": (["watch", "{jrundir}", "--once"], 0),
    "watch-served": (["watch", "{pservedlog}", "--once", "--stall-after", "5"], 0),
    "watch-stalled": (["watch", "{stalledlog}", "--once", "--stall-after", "5"], 3),
    "watch-torn-tail": (["watch", "{tornlog}", "--once"], 0),
    "watch-nothing": (["watch", "{empty}", "--once"], 4),
    # top: logs, live stubs, a dead endpoint, trends, record and replay
    "top-logs": (["top", "--once", "{prun}", "{jrundir}", "{pservedlog}", "{empty}"], 0),
    "top-statusz": (["top", "--once", "--statusz", "{stub}"], 0),
    "top-router-fleetz": (["top", "--once", "--statusz", "http://{router}/statusz"], 0),
    "top-down": (["top", "--once", "--statusz", "127.0.0.1:1"], 0),
    "top-store-trend": (["top", "--once", "--statusz", "{stub}", "--store", "{pstore}"], 0),
    "top-record": (["top", "--once", "{prun}", "--statusz", "{stub}", "--record", "{out}/rec"],
                   0),
    "top-replay-port": (["top", "--replay", "{precorded}", "--once"], 0),
    "top-replay-jax": (["top", "--replay", "{jrecorded}", "--once"], 0),
    "top-replay-nothing": (["top", "--replay", "{empty}", "--once"], 4),
    "top-usage": (["top"], 2),
    # pipeline: exports of both daemons, a live stub, the window mode
    "pipeline-port-log": (["pipeline", "{pservedlog}"], 0),
    "pipeline-jax-log": (["pipeline", "{jservedlog}"], 0),
    "pipeline-prom-json": (["pipeline", "{pprom}", "--json"], 0),
    "pipeline-metrics-json": (["pipeline", "{pmetricsjson}"], 0),
    "pipeline-url": (["pipeline", "http://{stub}"], 0),
    "pipeline-window": (["pipeline", "{pstore}", "--window", "60", "--at", "1000110"], 0),
    "pipeline-window-jax-store": (["pipeline", "{jstore}", "--window", "60", "--instance", "d0",
                                   "--at", "1000110", "--json"], 0),
    "pipeline-no-export": (["pipeline", "{prun}"], 2),
    # history: both writers' stores, the torn one, the collectors' and the
    # recorders' stores (cross-reads), errors
    "history-range-port-store": (["history", "range", "{pstore}", "serve_p99_ms", "--window",
                                  "200", "--at", "1000110"], 0),
    "history-range-jax-store-step": (["history", "range", "{jstore}", "serve_p99_ms", "--window",
                                      "200", "--at", "1000110", "--step", "30", "--agg", "max",
                                      "--json"], 0),
    "history-rate": (["history", "rate", "{pstore}", "serve_tenant_rows_total", "--label",
                      "tenant=1", "--window", "60", "--at", "1000110"], 0),
    "history-quantile": (["history", "quantile", "{jstore}", "serve_p99_ms", "--q", "0.5",
                          "--window", "200", "--at", "1000110", "--json"], 0),
    "history-top-tenants": (["history", "top-tenants", "{pstore}", "--window", "60", "--at",
                             "1000110", "--limit", "2"], 0),
    "history-series": (["history", "series", "{jstore}"], 0),
    "history-torn-store": (["history", "range", "{tornstore}", "serve_p99_ms", "--window",
                            "200", "--at", "1000110", "--json"], 0),
    "history-empty-window": (["history", "rate", "{pstore}", "serve_p99_ms", "--at", "1"], 3),
    "history-no-store": (["history", "series", "{empty}"], 4),
    "history-port-collector-store": (["history", "rate", "{pcollected}",
                                      "serve_rows_published", "--window", "60", "--at",
                                      "{later}", "--json"], 0),
    "history-jax-collector-store": (["history", "range", "{jcollected}", "up", "--window",
                                     "60", "--at", "{later}"], 0),
    "history-port-recorded-store": (["history", "series", "{precorded}", "--json"], 0),
    "history-usage": (["history", "range", "{pstore}"], 2),
    # collector: explicit, fleetz and registry discovery, SLO rules, down
    "collector-statusz": (["collector", "--store", "{out}/s", "--statusz", "{stub}", *COLLECT],
                          0),
    "collector-fleetz": (["collector", "--store", "{out}/s", "--fleetz", "{router}", *COLLECT],
                         0),
    "collector-registry": (["collector", "--store", "{out}/s", "--registry", "{regdir}",
                            *COLLECT], 0),
    "collector-slo": (["collector", "--store", "{out}/s", "--statusz", "{stub}", "--telemetry-dir",
                       "{out}/t", "--slo", "burn_rate=serve_p99_ms:5:1/60:0.5", *COLLECT], 0),
    "collector-down": (["collector", "--store", "{out}/s", "--statusz", "127.0.0.1:1", *COLLECT],
                       0),
    "collector-threshold-rule": (["collector", "--store", "{out}/s", "--statusz", "{stub}",
                                  "--telemetry-dir", "{out}/t", "--slo", "p99_ms=5", *COLLECT],
                                 2),
    "collector-usage": (["collector", "--store", "{out}/s"], 2),
    # correlate: two processes (one log by each package), errors
    "correlate-dir": (["correlate", "{mp}"], 0),
    "correlate-logs": (["correlate", "{mp1}", "{mp0}"], 0),
    "correlate-mixed-configs": (["correlate", "{prun}", "{pservedlog}"], None),
    "correlate-nothing": (["correlate", "{empty}"], None),
    # timeline: the two processes, each package's daemon, garbage
    "timeline-processes": (["timeline", "{mp}", "-o", "{out}/mp.trace.json"], 0),
    "timeline-port-served": (["timeline", "{pserved}", "-o", "{out}/s.trace.json"], 0),
    "timeline-jax-served": (["timeline", "{jservedlog}", "{pservedlog}", "-o",
                             "{out}/s.trace.json"], 0),
    "timeline-nothing": (["timeline", "{empty}", "-o", "{out}/x.json"], None),
    # explain: each package's bundles, by dir, log and bundle
    "explain-port-dir": (["explain", "{pserved}"], 0),
    "explain-jax-dir": (["explain", "{jserved}"], 0),
    "explain-port-log": (["explain", "{pservedlog}"], 0),
    "explain-port-bundle": (["explain", "{pbundle}"], 0),
    "explain-jax-bundle": (["explain", "{jbundle}"], 0),
    "explain-nothing": (["explain", "{empty}"], None),
    # incident: each package's stall bundle, partial bundles, the fleet index
    "incident-list-port": (["incident", "list", "{pstall}"], 0),
    "incident-list-jax-json": (["incident", "list", "{jstall}", "--json"], 0),
    "incident-show-port": (["incident", "show", "{pincbundle}"], 0),
    "incident-show-jax-json": (["incident", "show", "{jstall}", "--json"], 0),
    "incident-diagnose-port": (["incident", "diagnose", "{pstall}"], 0),
    "incident-diagnose-jax-json": (["incident", "diagnose", "{jstall}", "--json"], 0),
    "incident-list-partial": (["incident", "list", "{partialinc}"], 0),
    "incident-diagnose-partial": (["incident", "diagnose", "{partialinc}"], None),
    "incident-list-store": (["incident", "list", "{pstall}", "--store", "{pstore}", "--window",
                             "1e9"], 0),
    "incident-nothing": (["incident", "list", "{empty}"], 4),
    # every reader's --help: the JAX module's text, the program name aside
    **{f"{r}-help": ([r, "--help"], 0) for r in READERS},
}
# the cases whose reader writes files under {out}, compared byte for byte
WRITES = {"top-record": ("rec",), "collector-statusz": ("s",), "collector-fleetz": ("s",),
          "collector-registry": ("s",), "collector-slo": ("s",), "collector-down": ("s",),
          "timeline-processes": ("mp.trace.json",), "timeline-port-served": ("s.trace.json",),
          "timeline-jax-served": ("s.trace.json",)}


@pytest.fixture(scope="module")
def stores(art, tmp_path_factory):
    """The stores each package's ``collector`` and ``top --record`` build
    from the stub daemon, with the clocks frozen (the other package's
    reader queries them)."""
    root = tmp_path_factory.mktemp("built")
    mp = pytest.MonkeyPatch()
    try:
        for name, main in (("j", jmain.main), ("p", tmain.main)):
            _freeze(mp, art["now"])
            for argv in (["collector", "--store", str(root / f"{name}c"), "--statusz",
                          art["stub"], *COLLECT],
                         ["top", "--once", art["prun"], "--statusz", art["stub"], "--record",
                          str(root / f"{name}r")]):
                try:
                    main(argv)
                except SystemExit as e:
                    assert e.code in (0, None)
            mp.undo()
    finally:
        mp.undo()
    return {"pcollected": str(root / "pc"), "jcollected": str(root / "jc"),
            "precorded": str(root / "pr"), "jrecorded": str(root / "jr")}


@pytest.mark.parametrize("case", list(CASES))
def test_reader_matches_jax(case, art, stores, capsys, monkeypatch, tmp_path):
    """The port's subcommand prints the JAX package's bytes and returns its
    exit code on the same artifacts (``None``: whatever the JAX package's
    is); readers that write files write the JAX package's bytes."""
    argv, want = CASES[case]
    code, out, err, _ = _compare({**art, **stores}, argv, capsys, monkeypatch, tmp_path,
                                 WRITES.get(case, ()))
    if want is not None:
        assert code == (want.format(**art) if isinstance(want, str) else want)
    if code == 0:
        assert out.strip(), "no output"


def test_readers_cover_the_cli():
    """Every case names one of the eleven readers, each has several, and
    every reader is a subcommand of both packages' CLIs."""
    seen = {c.split("-")[0] for c in CASES}
    assert seen == set(READERS)
    assert all(sum(c.split("-")[0] == r for c in CASES) >= 4 for r in READERS)
    assert set(READERS) <= set(tmain.SUBCOMMANDS)
    assert all(not tmain.SUBCOMMANDS[r][1] for r in READERS)


def test_history_stores_equal_across_writers(art):
    """Both packages' ``HistoryStore`` write the same segments, byte for
    byte, from the same samples and stamps; the torn tail of a store is
    skipped by both packages' readers and truncated by a resumed writer of
    either."""
    assert _tree(art["pstore"]) == _tree(art["jstore"])
    assert len(thistory.list_segments(art["pstore"])) > 1
    kw = dict(start=T0, end=T0 + 200)
    torn = thistory.read_samples(art["tornstore"], **kw)
    assert torn == jhistory.read_samples(art["tornstore"], **kw)
    assert torn == thistory.read_samples(art["pstore"], **kw)
    copies = {}
    for name, cls in (("j", jhistory.HistoryStore), ("p", thistory.HistoryStore)):
        d = os.path.join(art["root"], f"resumed_{name}")
        shutil.copytree(art["tornstore"], d)
        with cls(d, boot="writer-1") as store:
            store.append("serve_p99_ms", 9.0, labels={"instance": "d0"}, ts=T0 + 120,
                         mono=1.0)
        copies[name] = _tree(d)
    assert copies["p"] == copies["j"]
    assert thistory.read_samples(os.path.join(art["root"], "resumed_p"), name="serve_p99_ms",
                                 start=T0 + 120)[0]["value"] == 9.0


def test_collector_store_counts_the_metrics(art, stores):
    """The store the port's collector built from the stub daemon holds its
    ``/metrics`` samples: the published rows counter equals the scraped
    one, once a cycle, and ``up`` is 1."""
    from distributed_drift_detection_tpu_torch.telemetry.metrics import parse_prometheus_text

    import urllib.request

    with urllib.request.urlopen(f"http://{art['stub']}/metrics", timeout=5) as r:
        scraped = parse_prometheus_text(r.read().decode())
    rows = [v for (n, _), v in scraped.items() if n == tpipeline.SERVE_ROWS_METRIC]
    recs = thistory.read_samples(stores["pcollected"], name=tpipeline.SERVE_ROWS_METRIC)
    assert rows and [r["value"] for r in recs] == rows * 2
    ups = thistory.read_samples(stores["pcollected"], name="up")
    assert [r["value"] for r in ups] == [1.0, 1.0]


@pytest.mark.parametrize("reader", READERS)
def test_reader_cli_imports_neither_torch_nor_jax(reader, art):
    """``python -m distributed_drift_detection_tpu_torch <reader> ...`` in a
    fresh interpreter runs to its end without importing torch, JAX or the
    JAX package."""
    argv = {
        "report": ["report", art["prun"]],
        "perf": ["perf", art["bench4"], art["bench5"], "--informational"],
        "watch": ["watch", art["prun"], "--once"],
        "top": ["top", "--once", art["prun"]],
        "pipeline": ["pipeline", art["pservedlog"]],
        "history": ["history", "series", art["pstore"]],
        "collector": ["collector", "--store", os.path.join(art["root"], "sub_store"),
                      "--statusz", art["stub"], "--count", "1", "--interval", "0"],
        "correlate": ["correlate", art["mp"]],
        "timeline": ["timeline", art["mp"], "-o", os.path.join(art["root"], "sub.json")],
        "explain": ["explain", art["pbundle"]],
        "incident": ["incident", "diagnose", art["pstall"]],
    }[reader]
    from chip_smoke import READER_GUARD  # the card's phase 21 runs each reader so

    p = subprocess.run([sys.executable, "-c", READER_GUARD, *argv], capture_output=True,
                       text=True, cwd=REPO, timeout=120)
    assert p.returncode == 0, p.stderr
    guard = p.stderr.strip().splitlines()[-1]
    assert guard == "READER [0, []]", guard
    assert p.stdout.strip()
