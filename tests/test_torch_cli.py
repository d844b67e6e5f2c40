"""The port's command line (``__main__.py``, ``doctor``) against the JAX
package's, and ``RunConfig.compile_cache_dir`` as the port's build
directory.

``main(argv, device='cpu')`` with the reference's 7 positional arguments
must print the JAX package's summary line (apart from ``final_time``) and
append the same results row (apart from its times); partial argv, bad flag
values and ``doctor`` must give the JAX package's exit codes and messages;
the port's subcommands must be the JAX package's (the readers' output is
held to JAX's in ``tests/test_torch_readers.py``); ``--trace-dir`` and
``--profile-dir`` must capture
a trace and refuse each other as the JAX package's do; ``--telemetry-dir``,
``heal``, ``sched``,
``sched-worker`` and ``registry`` must give the JAX package's output on
the same artifacts (and speak its scheduler's protocol).
"""

import csv
import json
import os
import subprocess
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from distributed_drift_detection_tpu import __main__ as jmain  # noqa: E402
from distributed_drift_detection_tpu.io import sanitize as jsanitize  # noqa: E402
from distributed_drift_detection_tpu.sched import scheduler as jscheduler  # noqa: E402
from distributed_drift_detection_tpu.telemetry import events as jevents  # noqa: E402
from distributed_drift_detection_tpu.telemetry import registry as jregistry  # noqa: E402
from distributed_drift_detection_tpu_torch import __main__ as tmain  # noqa: E402
from distributed_drift_detection_tpu_torch import api, config as tconfig  # noqa: E402
from distributed_drift_detection_tpu_torch.io import datasets as tdatasets  # noqa: E402
from distributed_drift_detection_tpu_torch.io import native as tnative  # noqa: E402
from distributed_drift_detection_tpu_torch.io import sanitize as tsanitize  # noqa: E402
from distributed_drift_detection_tpu_torch.io import synth as tsynth  # noqa: E402
from distributed_drift_detection_tpu_torch.kernels import _build  # noqa: E402
from distributed_drift_detection_tpu_torch.harness import grid as tgrid  # noqa: E402
from distributed_drift_detection_tpu_torch.resilience import heal as theal  # noqa: E402
from distributed_drift_detection_tpu_torch.results import read_results  # noqa: E402
from distributed_drift_detection_tpu_torch.sched import protocol as tprotocol  # noqa: E402
from distributed_drift_detection_tpu_torch.sched import scheduler as tscheduler  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = "prototypes,seed=0,concepts=6,rows_per_concept=100,features=5"
ARGV = ["spark://x:7077", "4", "8g", "2", "stamp-1", "8"]


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    """SPEC's rows as a clean CSV and a dirty copy (data row 100's 4th
    field NaN, data row 250 ragged)."""
    d = tmp_path_factory.mktemp("cli")
    clean = str(d / "stream.csv")
    tdatasets._write_schema_csv(*tsynth.parse_synth(SPEC), clean)
    with open(clean) as fh:
        lines = fh.read().splitlines()
    f = lines[101].split(",")
    f[3] = "nan"
    lines[101] = ",".join(f)
    lines[251] = ",".join(lines[251].split(",")[:-2])
    dirty = str(d / "dirty.csv")
    with open(dirty, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return {"clean": clean, "dirty": dirty}


def _summary(out: str) -> str:
    line = [ln for ln in out.splitlines() if ln.startswith("rows=")][-1]
    return line[: line.index(" final_time=")]


@pytest.mark.parametrize("flags", [[], ["--collect", "full"],
                                   ["--data-policy", "quarantine"]],
                         ids=["plain", "collect_full", "quarantine"])
def test_argv_run_matches_jax(csvs, tmp_path, monkeypatch, capsys, flags):
    """The reference's argv order (``DDM_Process.py:15-21``): the summary
    line and the results row of the JAX package, the Spark-only knobs
    recorded verbatim."""
    dataset = csvs["dirty"] if "quarantine" in flags else csvs["clean"]
    rows = {}
    for name, run_main in (("jax", jmain.main),
                           ("port", lambda a: tmain.main(a, device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        run_main([*flags, *ARGV, dataset])
        out = capsys.readouterr().out
        rows[name] = (_summary(out), read_results(str(d / "ddm_cluster_runs.csv")))
    assert rows["port"][0] == rows["jax"][0]
    assert "detections=" in rows["port"][0]
    (jrow,), (trow,) = rows["jax"][1], rows["port"][1]
    assert list(trow) == list(jrow)
    timed = {"Final Time", "Rows Per Sec"}
    assert {k: v for k, v in trow.items() if k not in timed} == \
        {k: v for k, v in jrow.items() if k not in timed}
    assert list(trow.values())[1:7] == ["stamp-1", "spark://x:7077", "4", "8.0", "8g", "2"]


@pytest.mark.parametrize("argv", [
    ["only", "three", "args"],
    ARGV[:5],
    [*ARGV, "a.csv", "extra"],
    ["u", "four", "8g", "2", "t", "8"],
    ["--data-policy", "bogus"],
    ["--collect", "nope"],
    ["--tenants", "x"],
    ["--tenants", "0"],
    ["--data-policy"],
])
def test_usage_errors_match_jax(argv):
    with pytest.raises(SystemExit) as t:
        tmain.main(list(argv), device="cpu")
    with pytest.raises(SystemExit) as j:
        jmain.main(list(argv))
    def detail(code):  # the line after the usage block, if any
        last = str(code).splitlines()[-1]
        return last if last.startswith("(") else None

    assert str(t.value.code).startswith("usage: python -m distributed_drift_detection_tpu_torch ")
    assert detail(t.value.code) == detail(j.value.code)


@pytest.mark.parametrize("name", ["chunked", "loadgen", "router", "serve"])
def test_unported_subcommands_name_their_items(name, csvs, capsys, tmp_path, monkeypatch):
    """The subcommands that run or serve experiments, through the port's
    CLI on the CPU. ``chunked`` (ROADMAP A10b) runs, printing
    the JAX package's final JSON line (``tests/test_torch_chunked.py``
    holds its numbers to JAX's). ``serve`` (A12a) starts on the CPU,
    prints its banner and drains (``--max-chunks 0``); ``loadgen`` (A12a)
    and ``router`` (A12b) are ported: ``loadgen --router`` without the
    fleet's ``--dir`` and ``router`` without a ``--backend`` are usage
    errors, as in the JAX package (``tests/test_torch_serve.py``,
    ``tests/test_torch_wire.py`` and ``tests/test_torch_fleet.py`` drive
    them)."""
    if name == "serve":
        monkeypatch.chdir(tmp_path)
        with pytest.raises(SystemExit) as e:
            tmain.main(["serve", "--features", "5", "--classes", "6", "--max-chunks", "0"],
                       device="cpu")
        assert e.value.code == 0
        banner = json.loads(capsys.readouterr().out.strip().splitlines()[0])
        assert banner["serving"] and banner["port"] > 0 and banner["wire"] == ["v1", "v2"]
        return
    if name in ("loadgen", "router"):
        argv = (["loadgen", csvs["clean"], "--port", "1", "--router"] if name == "loadgen"
                else ["router", "--port", "0"])
        with pytest.raises(SystemExit) as e:
            tmain.main(argv)
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert ("--router needs --dir" in err) if name == "loadgen" else ("--backend" in err)
        return
    if name == "chunked":
        tmain.main(["chunked", csvs["clean"], "--classes", "6", "--partitions", "4",
                    "--per-batch", "50", "--chunk-batches", "2"], device="cpu")
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["rows"] == 600 and out["chunks"] == 2


@pytest.mark.parametrize("argv, item", [
    pytest.param(["--tenants", "2", *ARGV], "A11", id="argv2-A11"),
])
def test_unported_flags_name_their_items(argv, item, csvs, tmp_path, monkeypatch, capsys):
    """``--tenants 2`` (ROADMAP A11, ported) runs the stacked tenant plane
    on the CPU and prints the JAX package's lines a tenant and the
    aggregate (apart from the times)."""
    monkeypatch.chdir(tmp_path)
    lines = {}
    for name, run_main in (("jax", jmain.main),
                           ("port", lambda a: tmain.main(a, device="cpu"))):
        run_main([*argv, csvs["clean"]])
        out = capsys.readouterr().out.splitlines()
        lines[name] = [ln.split(" final_time=")[0] for ln in out]
    assert lines["port"] == lines["jax"]
    assert [ln.split()[0] for ln in lines["port"]] == ["tenant=0", "tenant=1", "tenants=2"]


@pytest.mark.parametrize("flag", ["--trace-dir", "--profile-dir"])
def test_profiler_flags_match_jax(csvs, tmp_path, monkeypatch, capsys, flag):
    """``--trace-dir`` / ``--profile-dir DIR`` (either spelling) run as the
    JAX package's flags do: the summary line, and a capture session under
    DIR (a Chrome trace); both flags together raise the JAX package's
    ``ValueError`` before any work."""
    from distributed_drift_detection_tpu_torch.utils.timing import trace_files

    monkeypatch.chdir(tmp_path)
    d = str(tmp_path / "prof")
    tmain.main([f"{flag}={d}", *ARGV, csvs["clean"]], device="cpu")
    assert capsys.readouterr().out.startswith("rows=")
    assert len(trace_files(d)) == 1
    both = ["--trace-dir", "t", "--profile-dir", "p", *ARGV, csvs["clean"]]
    with pytest.raises(ValueError) as j:
        jmain.main(list(both))
    with pytest.raises(ValueError) as t:
        tmain.main(list(both), device="cpu")
    assert str(t.value) == str(j.value)
    assert not os.path.exists("t") and not os.path.exists("p")


def test_unported_subcommands_cover_the_jax_cli():
    """Every subcommand of the JAX package's CLI is a subcommand of the
    port's, and the port has no other; its usage text names each."""
    jax_subcommands = {ln.split()[3] for ln in jmain._USAGE.splitlines()[1:]}
    assert set(tmain.SUBCOMMANDS) == jax_subcommands
    assert {ln.split()[3] for ln in tmain._USAGE.splitlines()[1:]} == jax_subcommands


@pytest.mark.parametrize("which, extra", [("clean", []), ("dirty", []),
                                          ("dirty", ["--max-report", "1"]),
                                          ("dirty", ["--jobs", "3"]), ("missing", []),
                                          ("synth", [])])
def test_doctor_matches_jax(csvs, capsys, which, extra):
    path = {"missing": "no/such.csv", "synth": f"synth:{SPEC}"}.get(which) or csvs[which]
    codes, outs = [], []
    for main in (tsanitize.main, jsanitize.main):
        with pytest.raises(SystemExit) as e:
            main([*extra, path])
        cap = capsys.readouterr()
        codes.append(e.value.code)
        outs.append((cap.out, cap.err))
    assert codes[0] == codes[1] == {"clean": 0, "dirty": 1, "missing": 2, "synth": 0}[which]
    assert outs[0] == outs[1]


def test_doctor_through_the_module_and_the_cli(csvs):
    """``python -m distributed_drift_detection_tpu_torch doctor``: exit 0 on
    the clean CSV, 1 on the dirty one, without touching a card or JAX."""
    for which, code in (("clean", 0), ("dirty", 1)):
        out = subprocess.run(
            [sys.executable, "-c",
             "import sys, runpy; sys.argv = ['x', 'doctor', sys.argv[1]]\n"
             "try:\n    runpy.run_module('distributed_drift_detection_tpu_torch', "
             "run_name='__main__')\nexcept SystemExit as e:\n"
             "    assert 'jax' not in sys.modules; raise\n", csvs[which]],
            cwd=REPO, capture_output=True, text=True, timeout=120, check=False)
        assert out.returncode == code, out.stderr


def test_compile_cache_dir_names_the_build_directory(tmp_path):
    """``RunConfig.compile_cache_dir`` is where the kernels and the native
    parser are built and loaded from; empty keeps ``kernels/_build/``.
    Resolving it builds nothing."""
    cache = tmp_path / "cache"
    cfg = tconfig.RunConfig(dataset=f"synth:{SPEC}", mult_data=1, partitions=2,
                            per_batch=50, results_csv="", compile_cache_dir=str(cache))
    try:
        api.prepare(cfg, device="cpu")
        assert _build.build_dir() == cache.resolve()
        assert _build.library_path("ddm_window").parent == cache.resolve()
        assert tnative.library_path().parent == cache.resolve()
        assert not cache.exists()  # nothing built on the CPU for a synth: stream
        api.prepare(tconfig.replace(cfg, compile_cache_dir=""), device="cpu")
        assert _build.build_dir() == _build.BUILD_DIR
        assert _build.library_path("centroid_fit").parent == _build.BUILD_DIR
    finally:
        _build.set_build_dir("")


def test_cli_passes_compile_cache_dir(csvs, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cache = tmp_path / "kcache"
    try:
        tmain.main(["--compile-cache-dir", str(cache), *ARGV, csvs["clean"]], device="cpu")
        assert _build.build_dir() == cache.resolve()
    finally:
        _build.set_build_dir("")
    assert "detections=" in capsys.readouterr().out
    with open(tmp_path / "ddm_cluster_runs.csv") as fh:
        assert len(list(csv.reader(fh))) == 2


# --- the fleet surface: --telemetry-dir, heal, sched, sched-worker, registry --


def _fleet_spec(d, csv_path, mults=(2, 3)):
    spec = tgrid.sweep_spec(csv_path, list(mults), [2], trials=1, per_batch=50,
                            results_csv=str(d / "results.csv"), spec="off")
    path = d / "spec.json"
    path.write_text(json.dumps(spec))
    return str(path), spec


def _complete(tele, spec, n=None):
    """Record the first ``n`` cells of ``spec`` completed, as a run would."""
    for i, cfg in enumerate(theal.spec_configs(spec)[:n]):
        wire = tprotocol.cell_to_wire(cfg)
        jregistry.record(tele, f"r{i}", "running", config_digest=wire["digest"])
        jregistry.record(tele, f"r{i}", "completed")


def _exit(fn, argv):
    with pytest.raises(SystemExit) as e:
        fn(argv)
    return e.value.code


def test_telemetry_dir_flag_matches_jax(csvs, tmp_path, monkeypatch, capsys):
    """``--telemetry-dir``: the JAX package's summary line, then a
    ``telemetry=`` line naming a run log the JAX package's reader takes."""
    out = {}
    for name, run_main in (("jax", jmain.main),
                           ("port", lambda a: tmain.main(a, device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        run_main(["--telemetry-dir", str(d / "tele"), *ARGV, csvs["clean"]])
        lines = capsys.readouterr().out.splitlines()
        log = lines[-1][len("telemetry="):]
        assert lines[-1].startswith("telemetry=") and os.path.dirname(log) == str(d / "tele")
        events = jevents.read_events(log)
        out[name] = (_summary("\n".join(lines)), [e["type"] for e in events
                                                   if e["type"] != "cost_analysis"
                                                   and e.get("source") != "memory_analysis"],
                     [r["status"] for r in jregistry.read_index(str(d / "tele"))])
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("name", ["heal", "registry", "sched", "sched-worker"])
def test_fleet_subcommands_match_jax(name, csvs, tmp_path, capsys):
    """Each subcommand on the same artifacts: the JAX package's exit code
    and output (``sched``: its summary but for the scheduler's id;
    ``sched-worker``: each package's agent drains from the other's
    scheduler)."""
    spec_path, spec = _fleet_spec(tmp_path, csvs["clean"])
    results = {}
    for pkg, main in (("jax", jmain.main), ("port", lambda a: tmain.main(a, device="cpu"))):
        tele = str(tmp_path / pkg)
        if name == "heal":  # one of two cells done: plan, JSON, exit 1
            _complete(tele, spec, 1)
            plan = str(tmp_path / f"{pkg}-plan.json")
            code = _exit(main, ["heal", spec_path, "--telemetry-dir", tele, "--json", plan])
            with open(plan) as fh:
                got = json.load(fh)
            assert got.pop("telemetry_dir") == tele
            results[pkg] = (code, capsys.readouterr().out.replace(plan, "PLAN"), got)
        elif name == "registry":
            _complete(tele, spec)
            main(["registry", "compact", tele, "--min-records", "9"])
            main(["registry", "compact", tele])
            results[pkg] = (capsys.readouterr().out,
                            [{k: v for k, v in r.items() if k != "ts"}
                             for r in jregistry.read_index(tele)])
        elif name == "sched":  # every cell already completed: whole, exit 0
            _complete(tele, spec)
            code = _exit(main, ["sched", spec_path, "--telemetry-dir", tele, "--json"])
            summary = json.loads(capsys.readouterr().out.splitlines()[-1])
            results[pkg] = (code, {k: v for k, v in summary.items() if k != "scheduler"})
        else:  # the other package's scheduler, sweep whole: hello, lease, drain
            other = jscheduler if pkg == "port" else tscheduler
            _complete(tele, spec)
            sched = other.Scheduler(tele, lease_s=30.0)
            sched.add_spec(theal.load_spec(spec_path))
            sched.start()
            try:
                code = _exit(main, ["sched-worker", "--connect", f"127.0.0.1:{sched.port}"])
                status = sched.status()
            finally:
                summary = sched.stop()
            results[pkg] = (code, summary["whole"], summary["audit"]["ok"],
                            [w["alive"] for w in status["workers"]])
    assert results["port"] == results["jax"]
    if name == "heal":
        assert results["port"][0] == 1 and len(results["port"][2]["missing"]) == 1
    if name in ("sched", "sched-worker"):
        assert results["port"][0] == 0


def test_heal_execute_through_the_cli(csvs, tmp_path, capsys):
    """``heal --execute`` runs exactly the missing cell (on the CPU here),
    then the plan is whole under both packages' ``heal``."""
    spec_path, spec = _fleet_spec(tmp_path, csvs["clean"])
    tele = str(tmp_path / "tele")
    _complete(tele, spec, 1)
    assert _exit(lambda a: tmain.main(a, device="cpu"),
                 ["heal", spec_path, "--telemetry-dir", tele, "--execute"]) == 0
    out = capsys.readouterr().out
    assert "heal [1/1]" in out and "after heal: 2/2 completed, 0 missing" in out
    for main in (jmain.main, lambda a: tmain.main(a, device="cpu")):
        assert _exit(main, ["heal", spec_path, "--telemetry-dir", tele]) == 0
    assert len(read_results(str(tmp_path / "results.csv"))) == 1
