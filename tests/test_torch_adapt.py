"""The port's adaptation plane — ``adapt/shadow.py``, ``adapt/refit.py``
and their hooks in ``engine/chunked.py`` and ``serve/runner.py`` — against
the JAX package's, on the CPU (the twin of ``tests/test_adapt.py``).

Inputs: the JAX package's ``recurring_drift_xy(seed=1, concepts=4,
rows_per_concept=600)`` (8 classes), served by a JAX daemon and by the port
daemon (``device='cpu'``) with the same configuration: 2 partitions, 25
rows a batch, 2 batches a chunk, ``window=1``, the centroid and DDM,
quarantine, forensics off. Windows are ≤ 384 rows (100, 80 and 200), where
the centroid's window fit is JAX's bit for bit (ROADMAP Queue C, C1).
Tolerance: none — flags leaf by leaf, the adaptation events' fields (but
for times and ids), ``snapshot()`` and ``recovery_rows()``; the mlp
refit's parameters to C4's ``rtol`` 1e-4.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distributed_drift_detection_tpu import RunConfig as JRunConfig  # noqa: E402
from distributed_drift_detection_tpu.adapt import policy as jpolicy  # noqa: E402
from distributed_drift_detection_tpu.adapt.refit import AdaptationController as JAC  # noqa: E402
from distributed_drift_detection_tpu.config import ServeParams as JServeParams  # noqa: E402
from distributed_drift_detection_tpu.engine.chunked import ChunkedDetector as JCD  # noqa: E402
from distributed_drift_detection_tpu.io.stream import stripe_chunk  # noqa: E402
from distributed_drift_detection_tpu.io.synth import recurring_drift_xy  # noqa: E402
from distributed_drift_detection_tpu.models import ModelSpec as JSpec  # noqa: E402
from distributed_drift_detection_tpu.models import build_model as jbuild  # noqa: E402
from distributed_drift_detection_tpu.serve import ServeRunner as JServeRunner  # noqa: E402
from distributed_drift_detection_tpu.telemetry.events import read_events  # noqa: E402
from distributed_drift_detection_tpu_torch import RunConfig  # noqa: E402
from distributed_drift_detection_tpu_torch import convert  # noqa: E402
from distributed_drift_detection_tpu_torch.adapt import policy as tpolicy  # noqa: E402
from distributed_drift_detection_tpu_torch.adapt.refit import AdaptationController as TAC  # noqa: E402
from distributed_drift_detection_tpu_torch.adapt.shadow import (  # noqa: E402
    make_pair_scorer,
    pair_errors,
    should_demote,
    should_promote,
)
from distributed_drift_detection_tpu_torch.config import ServeParams  # noqa: E402
from distributed_drift_detection_tpu_torch.engine.chunked import ChunkedDetector as TCD  # noqa: E402
from distributed_drift_detection_tpu_torch.models import ModelSpec  # noqa: E402
from distributed_drift_detection_tpu_torch.models import build_model  # noqa: E402
from distributed_drift_detection_tpu_torch.ops.prefix import fma  # noqa: E402
from distributed_drift_detection_tpu_torch.serve import ServeRunner, read_verdicts  # noqa: E402
from distributed_drift_detection_tpu_torch.serve.loadgen import format_lines  # noqa: E402
from distributed_drift_detection_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

P, B, CB = 2, 25, 2
SPAN = P * B * CB
STREAM = recurring_drift_xy(seed=1, concepts=4, rows_per_concept=600)
# the adaptation event's fields that are not clocks or ids
_EVENT_KEYS = ("tenant", "trigger_chunk", "policy", "rows_refit", "err_before", "err_after",
               "promoted", "applied_chunk", "rows_to_apply", "pre_drift_err", "window_rows",
               "demoted")


def _kw(tmp, seed=0, tenants=1, **kw):
    return dict(partitions=P, per_batch=B, model="centroid", results_csv="", seed=seed,
                window=1, tenants=tenants, telemetry_dir=str(tmp),
                data_policy="quarantine", **kw)


def _pkw(features, classes, **kw):
    kw.setdefault("port", None)
    kw.setdefault("chunk_batches", CB)
    kw.setdefault("linger_s", 0.05)
    kw.setdefault("slo", ("none",))
    kw.setdefault("forensics", False)
    return dict(num_features=features, num_classes=classes, **kw)


def _runner(pkg, tmp, pkw, cfg_kw=None, **kw):
    """A ``pkg`` ('jax' or 'port') daemon on the CPU, started."""
    tmp.mkdir(parents=True, exist_ok=True)
    cfg_kw = cfg_kw or {}
    if pkg == "jax":
        r = JServeRunner(JRunConfig(**_kw(tmp, **cfg_kw)), JServeParams(**pkw), **kw)
    else:
        r = ServeRunner(RunConfig(**_kw(tmp, **cfg_kw)), ServeParams(**pkw), device="cpu", **kw)
    r.start()
    return r


def _drive(runner, lines, block=100):
    for i in range(0, len(lines), block):
        runner.admission.admit_lines(lines[i : i + block])
    runner.batcher.flush()
    runner.request_stop()
    assert runner.serve_forever() == 0
    return runner


def _logs(tmp):
    """The run logs in ``tmp`` in the order their runs started: by the
    process-local run counter that ends each name (``telemetry/events.py``;
    a plain sort of the names puts run 10 before run 9)."""
    names = [n for n in os.listdir(tmp)
             if n.endswith(".jsonl") and ".verdicts" not in n and ".quarantine" not in n
             and n != "index.jsonl"]
    return [os.path.join(tmp, n)
            for n in sorted(names, key=lambda n: int(n[: -len(".jsonl")].rsplit("-", 1)[1]))]


def _adapt_events(tmp):
    out = []
    for path in _logs(tmp):
        out += [{k: e.get(k) for k in _EVENT_KEYS}
                for e in read_events(path) if e["type"] == "adaptation"]
    return out


def _flags_equal(a, b):
    for name in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)), err_msg=name)


def _strip(recs):
    return [{k: v for k, v in r.items() if k not in ("ts", "lat_ms")} for r in recs]


# -- the policy grammar and the gates ---------------------------------------


@pytest.mark.parametrize("spec", ["retrain", "2=shadow,window_rows=400,margin=0.05",
                                  "alert_only", "shadow,cooldown_rows=80,epsilon=0.1"])
def test_policy_grammar_matches_jax(spec):
    assert tuple(tpolicy.parse_policy(spec)) == tuple(jpolicy.parse_policy(spec))
    specs = [spec, "1=retrain"]
    assert ([tuple(p) for p in tpolicy.resolve_policies(specs, 3)]
            == [tuple(p) for p in jpolicy.resolve_policies(specs, 3)])


@pytest.mark.parametrize("errs", [(0.4, 0.1), (0.1, 0.09), (None, 0.0), (0.1, 0.4),
                                  (None, None), (0.3, 0.3)])
def test_gates_match_jax(errs):
    from distributed_drift_detection_tpu.adapt import shadow as jshadow

    for margin in (0.0, 0.02):
        assert should_promote(*errs, margin) == jshadow.should_promote(*errs, margin)
        assert should_demote(*errs, margin) == jshadow.should_demote(*errs, margin)


# -- the pair scorer ---------------------------------------------------------


@pytest.mark.parametrize("model", ["centroid", "gnb", "linear", "mlp", "forest"])
def test_pair_scorer_matches_jax(model):
    """Champion and challenger — JAX fits of two windows of different
    concepts, converted — scored on a third window with a masked tail:
    the pair's errors equal the JAX scorer's bit for bit."""
    from distributed_drift_detection_tpu.adapt.shadow import make_pair_scorer as jscorer
    from distributed_drift_detection_tpu.adapt.shadow import pair_errors as jpair

    X, y = recurring_drift_xy(seed=3, concepts=3, rows_per_concept=120, features=6, classes=4)
    cfg_kw = dict(mlp_hidden=(16, 8), fit_steps=8) if model == "mlp" else {}
    jm = jbuild(model, JSpec(6, 4), JRunConfig(**cfg_kw))
    tm = build_model(model, ModelSpec(6, 4), RunConfig(**cfg_kw))
    w = np.ones(120, np.float32)

    def jfit(lo, k):
        p = jax.jit(jm.fit)(jax.random.key(k), X[lo:lo + 120], y[lo:lo + 120], w)
        return jax.tree.map(lambda l: np.stack([np.asarray(l)] * P), p)

    jch, jcl = jfit(0, 1), jfit(120, 2)
    conv = getattr(convert, f"{model}_params")
    tch, tcl = conv(jch), conv(jcl)
    Xs, ys = X[240:], y[240:].astype(np.int32)
    ws = np.ones(120, np.float32)
    ws[100:] = 0.0
    got = pair_errors(make_pair_scorer(tm), tch, tcl, Xs, ys, ws)
    want = jpair(jscorer(jm), jch, jcl, Xs, ys, ws)
    assert got == want
    assert pair_errors(make_pair_scorer(tm), tch, tcl, Xs, ys, ws * 0) == (None, None)


# -- the controller's keys and fits -----------------------------------------


@pytest.mark.parametrize("model, f, c", [("mlp", 6, 4), ("centroid", 12, 8), ("centroid", 6, 4)])
def test_refit_keys_and_window_fit_match_jax(model, f, c):
    """The refit keys are JAX's ``fold_in(fold_in(key(seed + 0xADA27), t),
    n)`` bit for bit; the window fit expanded to P partitions equals JAX's:
    the mlp within C4's ``rtol`` 1e-4, the centroid bit for bit at STREAM's
    width (F = 12, C = 8). At F = 6, C = 4 XLA's CPU program for the
    single-partition fit sums ‖mean‖² without fusing the products (ROADMAP
    Queue C, C10): the centroids stay bit for bit, the bias is the fused
    chain's (kernel K7's) and within an ulp of JAX's."""
    cfg_kw = dict(mlp_hidden=(16, 8), fit_steps=8) if model == "mlp" else {}
    jm = jbuild(model, JSpec(f, c), JRunConfig(**cfg_kw))
    tm = build_model(model, ModelSpec(f, c), RunConfig(**cfg_kw))
    pol = ["retrain,window_rows=80", "retrain,window_rows=80"]
    jd = JCD(jm, partitions=P, seed=5, window=1, tenants=2)
    td = TCD(tm, partitions=P, seed=5, window=1, tenants=2, device="cpu")
    kw = dict(per_batch=B, num_features=f, rows_per_chunk=SPAN, seed=5)
    jc = JAC(jd, jpolicy.resolve_policies(pol, 2), **kw)
    tc = TAC(td, tpolicy.resolve_policies(pol, 2), **kw)
    X, y = recurring_drift_xy(seed=2, concepts=2, rows_per_concept=40, features=f, classes=c)
    w = np.ones(80, np.float32)
    w[70:] = 0.0
    c10 = model == "centroid" and (f, c) == (6, 4)
    for t in (0, 1):
        for _ in range(2):
            jk = jc._next_key(t, jc.states[t])
            tk = tc._next_key(t, tc.states[t])
            np.testing.assert_array_equal(np.asarray(jax.random.key_data(jk)), tk)
        want = jax.tree.map(np.asarray, jc._fit_window(jk, X, y, w))
        got = tc._fit_window(tk, X, y, w)
        for i, (a, b) in enumerate(zip(tckpt._flatten(got), jax.tree.leaves(want))):
            assert tuple(a.shape) == b.shape
            if model == "mlp":
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=2e-6)
            elif c10 and i == 1:
                fused = torch.zeros(c)
                for j in range(f):
                    fused = fma(got.centroids[0, :, j], got.centroids[0, :, j], fused)
                live = np.isfinite(b[0])
                np.testing.assert_array_equal(a[0].numpy()[live], (-0.5 * fused).numpy()[live])
                np.testing.assert_array_max_ulp(a.numpy()[:, live], b[:, live], maxulp=1)
            else:
                np.testing.assert_array_equal(a.numpy(), b)


def test_c1_refit_window_fit_past_384_rows(tmp_path):
    """ROADMAP C1 past 384 rows: the refit's window fit of the centroid on
    800 rows (F = 12, C = 8), where XLA no longer sums the rows in one
    chain, equals JAX's within ``rtol`` 1e-4; and a daemon whose refit
    window is 400 rows serves JAX's flags, verdicts, adaptation events,
    ``snapshot()`` and ``recovery_rows()`` (a drift in the first chunks,
    refit on 400 rows)."""
    f, c = 12, 8
    pol = ["retrain,window_rows=800", "retrain,window_rows=800"]
    jd = JCD(jbuild("centroid", JSpec(f, c), JRunConfig()), partitions=P, seed=5, window=1,
             tenants=2)
    td = TCD(build_model("centroid", ModelSpec(f, c)), partitions=P, seed=5, window=1,
             tenants=2, device="cpu")
    kw = dict(per_batch=B, num_features=f, rows_per_chunk=SPAN, seed=5)
    jc = JAC(jd, jpolicy.resolve_policies(pol, 2), **kw)
    tc = TAC(td, tpolicy.resolve_policies(pol, 2), **kw)
    X, y = recurring_drift_xy(seed=2, concepts=2, rows_per_concept=400, features=f, classes=c)
    w = np.ones(800, np.float32)
    key = tc._next_key(0, tc.states[0])
    want = jax.tree.map(np.asarray, jc._fit_window(jc._next_key(0, jc.states[0]), X, y, w))
    got = tc._fit_window(key, X, y, w)
    for a, b in zip(tckpt._flatten(got), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4)

    lines = format_lines(STREAM[0][:600], STREAM[1][:600])  # a drift and its refit
    runs = [_drive(_runner(pkg, tmp_path / pkg,
                           _pkw(STREAM[0].shape[1], 8, on_drift=("retrain,window_rows=400",)),
                           keep_flags=True), lines) for pkg in ("jax", "port")]
    _flags_equal(runs[1].flags(), runs[0].flags())
    assert (_strip(read_verdicts(runs[1].verdicts_path))
            == _strip(read_verdicts(runs[0].verdicts_path)))
    ev = _adapt_events(tmp_path / "port")
    assert ev == _adapt_events(tmp_path / "jax")
    assert any(e["promoted"] and e["rows_refit"] > 384 for e in ev)
    assert runs[1]._adapt.snapshot() == runs[0]._adapt.snapshot()
    assert runs[1]._adapt.recovery_rows() == runs[0]._adapt.recovery_rows()


# -- the daemon: retrain and shadow against the JAX daemon ------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """STREAM through a JAX and a port daemon for each policy:
    ``{(policy, pkg): (runner, telemetry dir)}``."""
    root = tmp_path_factory.mktemp("adapt")
    X, y = STREAM
    lines = format_lines(X, y)
    out = {}
    for pol in ("retrain", "shadow", "retrain,window_rows=200"):
        for pkg in ("jax", "port"):
            d = root / f"{pol.replace(',', '_').replace('=', '')}_{pkg}"
            r = _runner(pkg, d, _pkw(X.shape[1], 8, on_drift=(pol,)), keep_flags=True)
            _drive(r, lines)
            out[pol, pkg] = (r, str(d))
    return out


@pytest.mark.parametrize("pol", ["retrain", "shadow", "retrain,window_rows=200"])
def test_served_adaptation_matches_jax(pol, served):
    """The served flags, the verdict sidecar (but for wall clocks), the
    adaptation events, ``snapshot()`` and ``recovery_rows()`` equal the JAX
    daemon's; the adaptation really happened and really reacted."""
    (jr, jd), (tr, td) = served[pol, "jax"], served[pol, "port"]
    _flags_equal(tr.flags(), jr.flags())
    assert _strip(read_verdicts(tr.verdicts_path)) == _strip(read_verdicts(jr.verdicts_path))
    ev = _adapt_events(td)
    assert ev and ev == _adapt_events(jd)
    if pol == "shadow":
        assert any(e["promoted"] for e in ev)
    else:
        assert all(e["promoted"] for e in ev)
    assert tr._adapt.snapshot() == jr._adapt.snapshot()
    assert tr._adapt.recovery_rows() == jr._adapt.recovery_rows() is not None
    assert tr._statusz()["adaptation"] == tr._adapt.snapshot()


def test_adaptation_events_schema_span_and_metrics(served):
    """The port's run log holds one ``adaptation`` span a decision, the
    JAX package's reader validates it, and ``adaptations_total`` counts the
    events by outcome."""
    tr, td = served["retrain", "port"]
    events = read_events(_logs(td)[0])
    adapts = [e for e in events if e["type"] == "adaptation"]
    spans = [e for e in events if e["type"] == "span" and e["name"] == "adaptation"]
    assert adapts and len(spans) == len(adapts)
    text = tr._metrics.to_prometheus_text()
    total = sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                if line.startswith("adaptations_total{"))
    assert total == len(adapts)
    assert "adaptation_active" in text and "adaptation_recovery_rows" in text


@pytest.mark.parametrize("how", ["daemon", "chunked"])
def test_alert_only_matches_policy_free(how, tmp_path):
    """``alert_only`` builds nothing and equals the policy-free run byte
    for byte (flags, and the verdict sidecar but for wall clocks), which
    equals the JAX package's; the adapting run's flags differ."""
    X, y = STREAM
    if how == "chunked":
        tm = build_model("centroid", ModelSpec(X.shape[1], 8))
        runs = [TCD(tm, partitions=P, seed=0, window=1, on_drift=od, device="cpu")
                for od in (None, "alert_only", "retrain")]
        flags = [d.run(_chunks(X, y)) for d in runs]
        jf = JCD(jbuild("centroid", JSpec(X.shape[1], 8), JRunConfig()), partitions=P,
                 seed=0, window=1).run(_chunks(X, y))
        assert runs[1].adapt is not None and not runs[1].adapt.active
    else:
        lines = format_lines(X, y)
        runs = [_drive(_runner("port", tmp_path / tag, _pkw(X.shape[1], 8, on_drift=od),
                               keep_flags=True), lines)
                for tag, od in (("free", ()), ("alert", ("alert_only",)), ("adapt", ("retrain",)))]
        flags = [r.flags() for r in runs]
        jf = _drive(_runner("jax", tmp_path / "jax", _pkw(X.shape[1], 8), keep_flags=True),
                    lines).flags()
        assert runs[0]._adapt is None and runs[1]._adapt is None
        assert (_strip(read_verdicts(runs[0].verdicts_path))
                == _strip(read_verdicts(runs[1].verdicts_path)))
    _flags_equal(flags[0], flags[1])
    _flags_equal(flags[0], jf)
    assert not np.array_equal(np.asarray(flags[2].change_global),
                              np.asarray(flags[0].change_global))


def _chunks(X, y, striper=stripe_chunk, **kw):
    for s in range(0, len(X), SPAN):
        yield striper(X[s : s + SPAN], y[s : s + SPAN], s, P, B, CB, **kw)


@pytest.mark.parametrize("pol, plane", [("retrain", "f32"), ("shadow", "f32"),
                                        ("retrain,window_rows=200", "f32"),
                                        ("retrain", "bf16")])
def test_chunked_on_drift_hook_matches_jax(pol, plane):
    """``ChunkedDetector(on_drift=...)`` resolves the controller on the
    first chunk and gives the JAX package's flags, snapshot and recovery;
    on a bfloat16 transport plane the window rows and the error probe read
    the features widened as JAX's do."""
    X, y = STREAM
    jkw, tkw = {}, {}
    if plane == "bf16":
        import ml_dtypes

        from distributed_drift_detection_tpu_torch.io import stream as tstream

        jkw = dict(feature_dtype=ml_dtypes.bfloat16)
        tkw = dict(striper=tstream.stripe_chunk, feature_dtype="bfloat16")
    jd = JCD(jbuild("centroid", JSpec(X.shape[1], 8), JRunConfig()), partitions=P, seed=0,
             window=1, on_drift=pol)
    td = TCD(build_model("centroid", ModelSpec(X.shape[1], 8)), partitions=P, seed=0,
             window=1, on_drift=pol, device="cpu")
    _flags_equal(td.run(_chunks(X, y, **tkw)), jd.run(_chunks(X, y, **jkw)))
    assert td.adapt.snapshot() == jd.adapt.snapshot()
    assert td.adapt.snapshot()["adaptations"] > 0
    assert td.adapt.recovery_rows() == jd.adapt.recovery_rows() is not None


def test_shadow_demotes_regressed_challenger():
    """The probation path unit-driven in both packages side by side (the
    JAX package's own demotion drive): a promotion, then a probation window
    of the pre-drift concept the champion wins on; the port promotes and
    demotes at the same chunks as JAX and restores its champion's params
    bit for bit."""
    X, y = recurring_drift_xy(seed=3, concepts=2, rows_per_concept=400, features=6, classes=4)
    b, span = 20, P * 20 * CB
    chunks = [stripe_chunk(X[s : s + span], y[s : s + span], s, P, b, CB)
              for s in range(0, 800, span)]
    pol = ["shadow,window_rows=80,margin=0.0,cooldown_rows=80"]
    kw = dict(per_batch=b, num_features=6, rows_per_chunk=span)
    jd = JCD(jbuild("centroid", JSpec(6, 4), JRunConfig()), partitions=P, seed=0, window=1)
    td = TCD(build_model("centroid", ModelSpec(6, 4)), partitions=P, seed=0, window=1,
             device="cpu")
    ctls = {"jax": JAC(jd, jpolicy.resolve_policies(pol, 1), **kw),
            "port": TAC(td, tpolicy.resolve_policies(pol, 1), **kw)}
    outcomes = {k: [] for k in ctls}
    for k, c in ctls.items():
        orig = c._count
        c._count = lambda t, st, o, k=k, orig=orig: (outcomes[k].append(o), orig(t, st, o))
    champ = {}
    rows = 0
    for i, c in enumerate(chunks):
        rows += span
        for k, det in (("jax", jd), ("port", td)):
            flags = det.feed(det.place(c))
            flags = (jax.tree.map(np.asarray, flags) if k == "jax"
                     else type(flags)(*(np.asarray(f) for f in flags)))
            st = ctls[k].states[0]
            if st.phase == "probation":
                champ[k] = st.champion
            ctls[k].on_chunk({"chunk": i, "rows_through": rows}, flags,
                             chunks[0] if st.phase == "probation" else c)
        assert outcomes["port"] == outcomes["jax"]
        if "demoted" in outcomes["jax"]:
            break
    assert outcomes["port"][:1] == ["promoted"] and "demoted" in outcomes["port"]
    restored = tckpt._flatten(ctls["port"]._tenant_params(0))
    for a, b_ in zip(restored, tckpt._flatten(champ["port"])):
        np.testing.assert_array_equal(a.numpy(), b_.numpy())
    # JAX's restored champion: the centroids bit for bit, the bias (an
    # earlier window fit's, at F = 6, C = 4) within an ulp (ROADMAP C10)
    jcent, jbias = jax.tree.leaves(jax.device_get(ctls["jax"]._tenant_params(0)))
    np.testing.assert_array_equal(restored[0].numpy(), np.asarray(jcent))
    live = np.isfinite(np.asarray(jbias))
    np.testing.assert_array_equal(np.isfinite(restored[1].numpy()), live)
    np.testing.assert_array_max_ulp(restored[1].numpy()[live], np.asarray(jbias)[live], maxulp=1)


# -- the tenant plane: a swap keeps the carry's layout ----------------------


def test_tenant_adaptation_keeps_carry_layout(tmp_path):
    """The port's twin of ``test_tenant_adaptation_zero_recompiles``: 8
    tenants of one partition adapt on the same planted drift; every swap
    keeps every carry leaf's shape, dtype and device (the serve loop's
    chunk shapes and the prepared launch plans stay valid), the adaptation
    count and the flags equal the JAX daemon's."""
    T = 8
    X, y = recurring_drift_xy(seed=1, concepts=2, rows_per_concept=100, features=6, classes=4)
    lines = format_lines(X, y)
    out = {}
    for pkg in ("jax", "port"):
        r = _runner(pkg, tmp_path / pkg, _pkw(6, 4, on_drift=("retrain",)),
                    cfg_kw=dict(tenants=T), keep_flags=True)
        layouts = []
        if pkg == "port":
            swap = r._adapt._swap_full

            def spy(carry, *a, swap=swap):
                new = swap(carry, *a)
                layouts.append([(tuple(l.shape), l.dtype, l.device) == (tuple(m.shape), m.dtype,
                                                                       m.device)
                                for l, m in zip(tckpt._flatten(carry), tckpt._flatten(new))
                                if isinstance(l, torch.Tensor)])
                return new

            r._adapt._swap_full = spy
        for s in range(0, len(lines), 20):
            for t in range(T):
                r.admissions[t].admit_lines(lines[s : s + 20])
        r.batcher.flush()
        r.request_stop()
        assert r.serve_forever() == 0
        out[pkg] = (r, layouts)
    (jr, _), (tr, layouts) = out["jax"], out["port"]
    assert tr._adapt.snapshot() == jr._adapt.snapshot()
    assert tr._adapt.snapshot()["adaptations"] >= T // 2
    assert layouts and all(all(x) and x for x in layouts)
    _flags_equal(tr.flags(), jr.flags())


# -- drain -> checkpoint -> bit-identical resume ------------------------------


def test_mid_adaptation_drain_resume_bit_identical(tmp_path):
    """At ``window_rows=200`` (two chunks), a drain mid-accumulation
    writes the ``.adapt`` sidecar beside the carry; the resumed daemon's
    flags and adaptation decisions equal the uninterrupted run's, which
    equal the JAX daemon's."""
    X, y = STREAM
    lines = format_lines(X, y)
    pol = "retrain,window_rows=200"

    def run_segments(pkg, d, segments):
        ckpt = str(d / "serve.ckpt")
        flags = []
        for seg in segments:
            r = _runner(pkg, d, _pkw(X.shape[1], 8, on_drift=(pol,), checkpoint=ckpt),
                        keep_flags=True)
            _drive(r, seg)
            if r.flags() is not None:
                flags.append(r.flags())
        cg = np.concatenate([np.asarray(f.change_global) for f in flags], axis=1)
        return cg, _adapt_events(d)

    cut = 700  # chunk-span aligned (7 x 100), mid-accumulation
    cg_split, ev_split = run_segments("port", tmp_path / "split", [lines[:cut], lines[cut:]])
    cg_full, ev_full = run_segments("port", tmp_path / "full", [lines])
    cg_jax, ev_jax = run_segments("jax", tmp_path / "jax", [lines])
    assert os.path.exists(tmp_path / "split" / "serve.ckpt.adapt")
    np.testing.assert_array_equal(cg_split, cg_full)
    np.testing.assert_array_equal(cg_full, cg_jax)
    key = lambda e: {k: e[k] for k in ("tenant", "trigger_chunk", "policy", "rows_refit",
                                       "promoted")}
    assert [key(e) for e in ev_split] == [key(e) for e in ev_full] == [key(e) for e in ev_jax]
    assert ev_full == ev_jax


# -- explain: the JAX package's reader renders a port adaptation -------------


def test_explain_renders_port_adaptation(tmp_path, capsys):
    from distributed_drift_detection_tpu.telemetry.forensics import main as explain_main

    X, y = STREAM
    _drive(_runner("port", tmp_path, _pkw(X.shape[1], 8, on_drift=("retrain",),
                                          forensics=True)), format_lines(X, y))
    explain_main([str(tmp_path)])
    out = capsys.readouterr().out
    assert "drift @ row" in out and "reaction" in out
    assert "policy=retrain" in out and "promoted" in out


def test_serve_cli_on_drift_runs(tmp_path, monkeypatch, capsys):
    """``serve --on-drift retrain`` starts on the CPU (``--device cpu``),
    its banner names the policies, and a bad spec is a usage error."""
    import json

    from distributed_drift_detection_tpu_torch.__main__ import main

    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        main(["serve", "--features", "5", "--classes", "3", "--max-chunks", "0",
              "--on-drift", "retrain", "--on-drift", "1=shadow", "--tenants", "2",
              "--device", "cpu"])
    assert e.value.code == 0
    banner = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert banner["on_drift"] == ["retrain", "shadow"]
    with pytest.raises(SystemExit) as e:
        main(["serve", "--features", "5", "--classes", "3", "--on-drift", "retrain,bogus=1",
              "--device", "cpu"])
    assert e.value.code == 2
