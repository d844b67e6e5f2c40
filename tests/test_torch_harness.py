"""The port's experiment surface against the JAX package's: the sweep grid
(``harness/grid.py``), ``results.read_results``, the retry policy and the
supervisor (``resilience/``) and the delay-parity harness
(``harness/parity.py``).

The grid tests are twins of ``tests/test_harness.py``'s, on a CSV written
here as ``outdoorStream.csv`` (the notebook's spec rule keys on the name),
run on the CPU. The trial keys and ``grid_configs`` must equal the JAX
package's on every config of ``KEY_CONFIGS``, and a results CSV written by
the JAX package's ``run_grid`` must resume in the port's with no trial run
(a torn last row: exactly one).
"""

import csv
import dataclasses
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_drift_detection_tpu import config as jconfig  # noqa: E402
from distributed_drift_detection_tpu import results as jresults  # noqa: E402
from distributed_drift_detection_tpu.harness import grid as jgrid  # noqa: E402
from distributed_drift_detection_tpu.harness import parity as jparity  # noqa: E402
from distributed_drift_detection_tpu.resilience import policy as jpolicy  # noqa: E402
from distributed_drift_detection_tpu.resilience import supervisor as jsupervisor  # noqa: E402
import distributed_drift_detection_tpu_torch as tpkg  # noqa: E402
from distributed_drift_detection_tpu_torch import config as tconfig  # noqa: E402
from distributed_drift_detection_tpu_torch import results as tresults  # noqa: E402
from distributed_drift_detection_tpu_torch.harness import grid as tgrid  # noqa: E402
from distributed_drift_detection_tpu_torch.harness import parity as tparity  # noqa: E402
from distributed_drift_detection_tpu_torch.io import datasets as tdatasets  # noqa: E402
from distributed_drift_detection_tpu_torch.io import synth as tsynth  # noqa: E402
from distributed_drift_detection_tpu_torch.resilience import faults as tfaults  # noqa: E402
from distributed_drift_detection_tpu_torch.resilience import policy as tpolicy  # noqa: E402
from distributed_drift_detection_tpu_torch.resilience import supervisor as tsupervisor  # noqa: E402
from distributed_drift_detection_tpu_torch.telemetry import registry as tregistry  # noqa: E402

SPEC = "prototypes,seed=0,concepts=6,rows_per_concept=100,features=5"


def quiet(*_):
    pass


@pytest.fixture(scope="module")
def outdoor(tmp_path_factory):
    """SPEC's rows as ``outdoorStream.csv``, in the reference's schema."""
    path = tmp_path_factory.mktemp("grid") / "outdoorStream.csv"
    tdatasets._write_schema_csv(*tsynth.parse_synth(SPEC), str(path))
    return str(path)


def base_cfg(mod, dataset, tmp_path, name="runs.csv", **kw):
    return mod.RunConfig(dataset=dataset, per_batch=50, model="majority",
                         results_csv=str(tmp_path / name), **kw)


def tgrid_run(base, mults, partitions, **kw):
    return tgrid.run_grid(base, mults=mults, partitions=partitions,
                          progress=kw.pop("progress", quiet), device="cpu", **kw)


def _rewrite(path, rows):
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=rows[0].keys())
        w.writeheader()
        w.writerows(rows)


def test_grid_idempotent_resume(outdoor, tmp_path):
    """The built-in crash recovery (C14): a second invocation runs nothing;
    deleting rows re-runs exactly the missing trials."""
    base = base_cfg(tconfig, outdoor, tmp_path)
    assert tgrid_run(base, [1], [1, 2], trials=2) == 4
    assert tgrid_run(base, [1], [1, 2], trials=2) == 0
    rows = tresults.read_results(base.results_csv)
    _rewrite(base.results_csv, rows[:-1])
    assert len(tgrid.missing_configs(tgrid.grid_configs(base, [1], [1, 2], trials=2))) == 1
    assert tgrid_run(base, [1], [1, 2], trials=2) == 1


def test_grid_spec_rule_warns_and_skips(outdoor, tmp_path):
    """The notebook's per-dataset validity rule: off-spec cells warn by
    default, are dropped with spec='skip', run silently with spec='off'."""
    R = tconfig.RunConfig
    assert tgrid.off_spec_reason(R(dataset=outdoor, mult_data=1)) is not None
    assert tgrid.off_spec_reason(R(dataset=outdoor, mult_data=64, partitions=32)) is not None
    assert tgrid.off_spec_reason(R(dataset=outdoor, mult_data=64, partitions=16)) is None
    assert tgrid.off_spec_reason(R(dataset="synth:rialto", mult_data=0.5))
    assert tgrid.off_spec_reason(R(dataset="synth:rialto", mult_data=1)) is None
    assert tgrid.off_spec_reason(R(dataset="myown.csv", mult_data=0.5, partitions=99)) is None

    msgs = []
    assert tgrid_run(base_cfg(tconfig, outdoor, tmp_path), [1], [1], trials=1,
                     progress=msgs.append) == 1
    warned = [m for m in msgs if "off-spec" in m]
    assert len(warned) == 1 and "mult_data=64" in warned[0]

    base2 = base_cfg(tconfig, outdoor, tmp_path, "runs2.csv")
    msgs2 = []
    assert tgrid_run(base2, [1], [1], trials=1, spec="skip", progress=msgs2.append) == 0
    assert any("skipping" in m for m in msgs2)
    msgs3 = []
    assert tgrid_run(base2, [1], [1], trials=1, spec="off", progress=msgs3.append) == 1
    assert not any("spec" in m for m in msgs3)
    with pytest.raises(ValueError, match="spec"):
        tgrid_run(base2, [1], [1], trials=1, spec="bogus")


def test_grid_detector_sweep_distinct_keys(outdoor, tmp_path):
    base = base_cfg(tconfig, outdoor, tmp_path)
    cfgs = tgrid.grid_configs(base, [1], [1], trials=1, detectors=["ddm", "ph", "eddm"])
    assert [c.detector for c in cfgs] == ["ddm", "ph", "eddm"]
    keys = [c.resolved_app_name() for c in cfgs]
    assert len(set(keys)) == 3
    assert "ph" in keys[1] and "eddm" in keys[2]
    assert "ph" not in keys[0] and "eddm" not in keys[0]
    assert tgrid_run(base, [1], [1], trials=1, detectors=["ddm", "eddm"]) == 2
    assert tgrid_run(base, [1], [1], trials=1, detectors=["ddm", "eddm"]) == 0
    assert tgrid_run(base, [1], [1], trials=1, detectors=["ddm", "eddm", "ph"]) == 1


def test_grid_key_carries_execution_policy(outdoor, tmp_path):
    base = base_cfg(tconfig, outdoor, tmp_path)
    k_auto = tgrid._config_key(base)
    assert f"-w0r0v{tconfig.AUTO_POLICY_VERSION}-" in k_auto
    k_pinned = tgrid._config_key(tconfig.replace(base, window=16, window_rotations=1))
    assert "-w16r1-" in k_pinned and k_auto != k_pinned
    assert tgrid_run(base, [1], [1], trials=1) == 1
    assert tgrid_run(base, [1], [1], trials=1) == 0
    assert tgrid_run(tconfig.replace(base, window=16, window_rotations=1), [1], [1],
                     trials=1) == 1


# Base configs whose sweeps' keys and configs must equal the JAX package's:
# models, detectors with their parameters, execution policies, data
# policies, the retrain guard, the DDM noise floor, seeds and batch sizes.
KEY_CONFIGS = {
    "default": {},
    "centroid": dict(model="centroid"),
    "gnb_guard": dict(model="gnb"),
    "forest_guard": dict(model="forest"),
    "mlp": dict(model="mlp"),
    "rf": dict(model="rf"),
    "linear": dict(model="linear"),
    "ph": dict(detector="ph"),
    "eddm": dict(detector="eddm"),
    "hddm": dict(detector="hddm"),
    "hddm_w": dict(detector="hddm_w"),
    "adwin": dict(detector="adwin"),
    "kswin": dict(detector="kswin"),
    "stepd": dict(detector="stepd"),
    "window16r1": dict(window=16, window_rotations=1),
    "window1": dict(window=1),
    "window0r3": dict(window=0, window_rotations=3),
    "quarantine": dict(data_policy="quarantine"),
    "repair": dict(data_policy="repair"),
    "retrain0": dict(retrain_error_threshold=0.0),
    "retrain_none": dict(model="gnb", retrain_error_threshold=None),
    "robust": dict(ddm="robust"),
    "seed7_b100": dict(seed=7, per_batch=100),
    "rialto": dict(dataset="synth:rialto,seed=1"),
}


def _key_cfg(mod, **kw):
    if kw.get("ddm") == "robust":
        kw["ddm"] = mod.DDM_ROBUST
    return mod.RunConfig(**{"dataset": "outdoorStream.csv", **kw})


@pytest.mark.parametrize("name", sorted(KEY_CONFIGS))
def test_grid_keys_and_configs_match_jax(name):
    kw = KEY_CONFIGS[name]
    args = ([0.5, 64], [1, 16], None, 2, None)
    j = jgrid.grid_configs(_key_cfg(jconfig, **kw), *args)
    t = tgrid.grid_configs(_key_cfg(tconfig, **kw), *args)
    assert len(j) == len(t) == 8
    for a, b in zip(j, t):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert jgrid._config_key(a) == tgrid._config_key(b)
        assert a.resolved_app_name() == b.resolved_app_name()
        assert jgrid.off_spec_reason(a) == tgrid.off_spec_reason(b)
    swept = dict(models=["centroid", "rf"], detectors=["ddm", "adwin"])
    j = jgrid.grid_configs(_key_cfg(jconfig, **kw), [1], [4], trials=1, **swept)
    t = tgrid.grid_configs(_key_cfg(tconfig, **kw), [1], [4], trials=1, **swept)
    assert [c.time_string for c in j] == [c.time_string for c in t]


def test_sweep_spec_matches_jax():
    args = ("outdoorStream.csv", [64, 128], [4, 16])
    assert tgrid.sweep_spec(*args, trials=2) == jgrid.sweep_spec(*args, trials=2)
    assert tgrid.SWEEP_DEFAULTS == jgrid.SWEEP_DEFAULTS
    with pytest.raises(ValueError, match="unknown sweep knob"):
        tgrid.sweep_spec(*args, bogus=1)


def test_jax_grid_csv_resumes_in_the_port(outdoor, tmp_path):
    """A results CSV written by the JAX package's ``run_grid`` resumes in the
    port's: 0 trials run; with its last row torn halfway, exactly 1."""
    jbase = base_cfg(jconfig, outdoor, tmp_path)
    assert jgrid.run_grid(jbase, mults=[1, 2], partitions=[1, 2], trials=1,
                          progress=quiet) == 4
    tbase = base_cfg(tconfig, outdoor, tmp_path)
    assert tgrid_run(tbase, [1, 2], [1, 2], trials=1) == 0
    with open(tbase.results_csv, "rb") as fh:
        data = fh.read()
    last = data.rstrip(b"\r\n").rfind(b"\n") + 1
    with open(tbase.results_csv, "wb") as fh:
        fh.write(data[: last + (len(data) - last) // 2])
    assert len(tresults.read_results(tbase.results_csv, allow_partial_tail=True)) == 3
    assert tgrid_run(tbase, [1, 2], [1, 2], trials=1) == 1
    rows = tresults.read_results(tbase.results_csv)
    assert len(rows) == 4 and len({r["Spark App"] for r in rows}) == 4


def test_grid_main_writes_the_spec_and_refuses_telemetry(outdoor, tmp_path, monkeypatch):
    import json

    monkeypatch.setattr(tgrid, "run_grid", lambda *a, **k: 0)
    out = tmp_path / "spec.json"
    tgrid.main(["--dataset", outdoor, "--mults", "64,128", "--partitions", "4,16",
                "--trials", "2", "--spec-out", str(out)])
    assert json.loads(out.read_text()) == jgrid.sweep_spec(
        outdoor, [64.0, 128.0], [4, 16], models=["centroid"], detectors=["ddm"],
        trials=2, per_batch=100, results_csv="ddm_cluster_runs.csv", spec="warn",
        data_policy="strict")
    monkeypatch.undo()
    # profile_dir: one capture session a trial, none for the warm-up
    # (utils.timing.maybe_trace); telemetry_dir (tests/test_torch_sched.py):
    # a trial's run log and registry records
    from distributed_drift_detection_tpu_torch.utils.timing import trace_files

    prof = str(tmp_path / "prof")
    assert tgrid_run(base_cfg(tconfig, outdoor, tmp_path, "prof.csv"), [1], [1, 2],
                     trials=1, warmup=True, profile_dir=prof) == 2
    assert len(trace_files(prof)) == 2
    tele = str(tmp_path / "tele")
    assert tgrid_run(base_cfg(tconfig, outdoor, tmp_path), [1], [2], trials=1,
                     telemetry_dir=tele) == 1
    statuses = sorted((r.get("kind") or "", r["status"]) for r in tregistry.runs(tele).values())
    assert statuses == [("", "completed"), ("sweep", "completed")]


def test_grid_continue_on_error_and_armed_faults(outdoor, tmp_path, monkeypatch):
    """``DDD_FAULTS`` arms ``grid.cell``: with a retry the crash heals; with
    none and ``on_error='continue'`` the other cells run and a summary
    ``RuntimeError`` names the failed one."""
    base = base_cfg(tconfig, outdoor, tmp_path)
    monkeypatch.setenv("DDD_FAULTS", "grid.cell:at=1")
    try:
        msgs = []
        assert tgrid_run(base, [64], [1, 2], trials=1, retries=1, spec="off",
                         progress=msgs.append) == 2
        assert any("armed" in m for m in msgs)
        base2 = base_cfg(tconfig, outdoor, tmp_path, "runs2.csv")
        with pytest.raises(RuntimeError, match="1 of 2 trials failed"):
            tgrid_run(base2, [64], [1, 2], trials=1, spec="off", on_error="continue")
        assert len(tresults.read_results(base2.results_csv)) == 1
    finally:
        tfaults.disarm_all()


def _results_text(kind):
    head = "a,b,c\r\n"
    return {
        "clean": head + "1,2,3\r\n4,5,6\r\n",
        "no_newline": head + "1,2,3\r\n4,5",
        "short_last": head + "1,2,3\r\n4,5\r\n",
        "torn_full": head + "1,2,3\r\n4,5,6",
        "blank_lines": head + "1,2,3\r\n\r\n4,5,6\r\n\r\n",
        "interior_short": head + "1,2\r\n4,5,6\r\n",
        "overlong": head + "1,2,3,4\r\n",
        "header_only": head,
        "empty": "",
    }[kind]


@pytest.mark.parametrize("kind", ["clean", "no_newline", "short_last", "torn_full",
                                  "blank_lines", "interior_short", "overlong",
                                  "header_only", "empty"])
@pytest.mark.parametrize("partial", [False, True])
def test_read_results_matches_jax(tmp_path, kind, partial):
    path = tmp_path / "r.csv"
    path.write_bytes(_results_text(kind).encode())

    def outcome(fn):
        try:
            return fn(str(path), allow_partial_tail=partial)
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(tresults.read_results) == outcome(jresults.read_results)


POLICIES = [
    dict(),
    dict(seed=3, jitter=0.5),
    dict(backoff_base_s=0.1, backoff_factor=3.0, backoff_max_s=2.0, seed=11),
    dict(jitter=0.0),
]


@pytest.mark.parametrize("kw", POLICIES, ids=["default", "jitter", "capped", "nojitter"])
def test_retry_policy_matches_jax(kw):
    t, j = tpolicy.RetryPolicy(**kw), jpolicy.RetryPolicy(**kw)
    assert [t.backoff_s(a) for a in range(1, 9)] == [j.backoff_s(a) for a in range(1, 9)]
    for exc in (ValueError("x"), TypeError(), KeyError(), OSError(), RuntimeError(),
                NotImplementedError(), MemoryError(), tpolicy.AttemptTimeout(),
                tfaults.InjectedFault("x"), ZeroDivisionError()):
        assert t.classify(exc) == j.classify(exc), type(exc)
    assert tpolicy.NO_RETRY == tpolicy.RetryPolicy(max_attempts=1)


@pytest.mark.parametrize("kw, match", [
    (dict(max_attempts=0), "max_attempts"), (dict(timeout_s=0), "timeout_s"),
    (dict(jitter=1.0), "jitter"), (dict(backoff_base_s=-1), "backoff")])
def test_retry_policy_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match) as t:
        tpolicy.RetryPolicy(**kw).validate()
    with pytest.raises(ValueError, match=match) as j:
        jpolicy.RetryPolicy(**kw).validate()
    assert str(t.value) == str(j.value)


def _flaky(fails, exc):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= fails:
            raise exc(f"attempt {len(calls)}")
        return "done"

    return fn, calls


@pytest.mark.parametrize("fails, exc, attempts", [
    (0, RuntimeError, 3), (2, RuntimeError, 3), (5, RuntimeError, 3),
    (1, ValueError, 3), (1, OSError, 1)])
def test_supervise_matches_jax(fails, exc, attempts):
    """Attempt counts, backoffs and the note on the re-raised exception."""
    outcomes = []
    for mod, pmod in ((tsupervisor, tpolicy), (jsupervisor, jpolicy)):
        fn, calls = _flaky(fails, exc)
        sleeps, retried = [], []
        policy = pmod.RetryPolicy(max_attempts=attempts, seed=5)
        try:
            result = mod.supervise(fn, policy, sleep=sleeps.append,
                                   on_retry=lambda a, e, b: retried.append((a, str(e), b)))
            raised = None
        except Exception as e:
            result, raised = None, (type(e), str(e), getattr(e, "__notes__", []))
        outcomes.append((result, raised, len(calls), sleeps, retried))
    assert outcomes[0] == outcomes[1]


def test_supervise_refuses_telemetry(tmp_path):
    """``supervise(telemetry_dir=...)`` was refused until the registry was
    ported; now a run that needs no retry leaves no retry log, and one that
    retries leaves one ``run_retried`` event, as in the JAX package."""
    tele = str(tmp_path / "tele")
    assert tsupervisor.supervise(lambda: 1, telemetry_dir=tele) == 1
    assert not os.path.exists(tele)
    for mod, pmod in ((tsupervisor, tpolicy), (jsupervisor, jpolicy)):
        fn, _ = _flaky(1, RuntimeError)
        d = str(tmp_path / mod.__name__.split(".")[0])
        assert mod.supervise(fn, pmod.RetryPolicy(max_attempts=2, seed=5), telemetry_dir=d,
                             name="cell", sleep=lambda _s: None) == "done"
        (log,) = os.listdir(d)
        assert log.startswith("cell-retries-")
        with open(os.path.join(d, log)) as fh:
            (ev,) = [json.loads(ln) for ln in fh]
        assert (ev["type"], ev["attempt"], ev["max_attempts"]) == ("run_retried", 1, 2)


def test_supervised_run_retry_after_a_timeout():
    """A timed-out attempt is abandoned and retried; the retry's
    ``RunResult`` has the flags of a plain run."""
    cfg = tconfig.RunConfig(dataset=f"synth:{SPEC}", mult_data=2, partitions=2,
                            per_batch=50, results_csv="")
    want = tpkg.run(cfg, device="cpu")
    calls = []

    def attempt():
        calls.append(1)
        if len(calls) == 1:
            time.sleep(3.0)  # past the budget: abandoned
        return tpkg.run(cfg, device="cpu")

    res = tsupervisor.supervise(attempt, tpolicy.RetryPolicy(max_attempts=2, timeout_s=1.0),
                                sleep=lambda _: None)
    assert len(calls) == 2
    for f in want.flags._fields:
        np.testing.assert_array_equal(getattr(res.flags, f), getattr(want.flags, f))
    res2 = tsupervisor.supervised_run(cfg, tpolicy.NO_RETRY, device="cpu")
    assert res2.metrics.num_detections == want.metrics.num_detections


PARITY = dict(dataset=f"synth:{SPEC}", mult_data=8.0, partitions=4, per_batch=50,
              seeds=range(2), rf_estimators=5)


def _nan_as_none(rows):
    return [{k: None if isinstance(v, float) and v != v else v for k, v in r.items()}
            for r in rows]


@pytest.fixture(scope="module")
def parity_rows():
    models = ("rf", "centroid", "gnb")
    return (jparity.measure_delay_parity(models=models, **PARITY),
            tparity.measure_delay_parity(models=models, device="cpu", **PARITY))


def test_parity_rows_match_jax(parity_rows):
    j, t = parity_rows
    assert len(j) == len(t) == 6 and all(r["detections"] > 0 for r in t)
    assert _nan_as_none(j) == _nan_as_none(t)
    assert tparity.check_criterion(t) == jparity.check_criterion(j)
    assert tparity.check_spurious(t) == jparity.check_spurious(j)
    assert tparity.summarize(t) == [tparity.ParitySummary(*s) for s in jparity.summarize(j)]


def test_parity_report_and_csv_match_jax(parity_rows, tmp_path):
    j, t = parity_rows
    jout, tout = [], []
    required = ("centroid", "gnb")
    assert tparity.report(t, tout.append, required) == jparity.report(j, jout.append, required)
    assert tout == jout
    tparity.write_csv(t, str(tmp_path / "t.csv"))
    jparity.write_csv(j, str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    assert tparity.FIELDS == jparity.FIELDS
    for name in ("DEFAULT_MODELS", "REQUIRED_MODELS", "SPURIOUS_TOLERANCE"):
        assert getattr(tparity, name) == getattr(jparity, name)


def test_parity_main_on_the_cpu(tmp_path, capsys):
    """``--device cpu`` runs in this process; the exit status is the gate
    over the required models swept."""
    out = tmp_path / "p.csv"
    with pytest.raises(SystemExit) as e:
        tparity.main(["--geometry", f"synth:{SPEC}|8|4", "--per-batch", "50", "--seeds", "1",
                      "--models", "rf,centroid", "--rf-estimators", "5", "--out", str(out),
                      "--device", "cpu"])
    assert e.value.code == 0
    assert "centroid: delay gap vs rf" in capsys.readouterr().out
    assert len(list(csv.DictReader(open(out)))) == 2
