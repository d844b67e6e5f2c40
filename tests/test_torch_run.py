"""The port's ``run`` against the JAX package's ``run``, end to end.

``run(cfg, device='cpu')`` of the port and ``run(cfg)`` of the JAX package
take the same config on the same ``synth:`` stream; every ``FlagRows``
leaf, the drift vote and the ``DelayMetrics`` must be equal. The configs
cover the auto W×R window engine, a pinned depth, the retrain guard, an
unshuffled stream, both collect modes, the majority model, the DDM_ROBUST
noise floor, a subsampled (``mult_data < 1``) stream, which rides the
dense striper, every detector of the zoo on the window engine, the
sequential ``window=1`` engine (DDM, Page–Hinkley, ADWIN, and gnb), the
gnb and linear models, and the mlp — whose fits draw JAX's threefry key
chain — on the window engine at R = 1, R = 4 and the auto depth, and on
``window=1``: its fitted parameters agree with JAX's to a tolerance only,
but on these configs the flags come out equal bit for bit.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import distributed_drift_detection_tpu as jpkg  # noqa: E402
from distributed_drift_detection_tpu import config as jconfig  # noqa: E402
import distributed_drift_detection_tpu_torch as tpkg  # noqa: E402
from distributed_drift_detection_tpu_torch import config as tconfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(
    dataset="synth:prototypes,seed=0,concepts=6,rows_per_concept=100,features=5",
    mult_data=3, partitions=4, per_batch=50, results_csv="",
)
MLP_NARROW = dict(mlp_hidden=(16, 8), fit_steps=8)
CONFIGS = {
    "auto": {},
    "rotations2": dict(window_rotations=2),
    "window16r3": dict(window=16, window_rotations=3),
    "retrain0.3": dict(retrain_error_threshold=0.3),
    "unshuffled": dict(shuffle_batches=False),
    "collect_full": dict(collect="full"),
    "majority": dict(model="majority"),
    "robust": dict(ddm="robust"),
    "dense": dict(mult_data=0.8, per_batch=10),
    "ph": dict(detector="ph"),
    "eddm": dict(detector="eddm"),
    "hddm": dict(detector="hddm"),
    "hddm_w": dict(detector="hddm_w"),
    "adwin": dict(detector="adwin", window=8),
    "kswin": dict(detector="kswin", mult_data=8),
    "stepd": dict(detector="stepd"),
    "seq_ddm": dict(window=1),
    "seq_ph": dict(window=1, detector="ph"),
    "seq_adwin": dict(window=1, detector="adwin"),
    "seq_gnb": dict(window=1, model="gnb"),
    "gnb": dict(model="gnb"),
    "linear": dict(model="linear"),
    # the mlp on JAX's threefry key chain, at narrow widths: the auto W×R
    # window engine, R = 1 and R = 4, and window=1
    "mlp": dict(model="mlp", **MLP_NARROW),
    "mlp_r1": dict(model="mlp", window_rotations=1, **MLP_NARROW),
    "mlp_w8r4": dict(model="mlp", window=8, window_rotations=4, **MLP_NARROW),
    "seq_mlp": dict(model="mlp", window=1, **MLP_NARROW),
}


def _cfg(mod, **kw):
    if kw.get("ddm") == "robust":
        kw["ddm"] = mod.DDM_ROBUST
    return mod.RunConfig(**{**BASE, **kw})


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    kw = CONFIGS[request.param]
    return jpkg.run(_cfg(jconfig, **kw)), tpkg.run(_cfg(tconfig, **kw), device="cpu")


def test_flags_equal(pair):
    j, t = pair
    assert (j.metrics.num_detections > 0) and j.flags._fields == t.flags._fields
    for f in j.flags._fields:
        a, b = np.asarray(getattr(j.flags, f)), getattr(t.flags, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_vote_equal(pair):
    j, t = pair
    assert j.drift_vote.dtype == t.drift_vote.dtype
    np.testing.assert_array_equal(np.asarray(j.drift_vote), t.drift_vote)


def test_metrics_and_resolved_config_equal(pair):
    j, t = pair
    for f in dataclasses.fields(j.metrics):
        np.testing.assert_array_equal(
            getattr(j.metrics, f.name), getattr(t.metrics, f.name), err_msg=f.name
        )
    for f in ("window", "window_rotations", "retrain_error_threshold"):
        assert getattr(j.config, f) == getattr(t.config, f), f
    assert tuple(j.config.ph) == tuple(t.config.ph)  # the resolved λ
    assert set(t.timings) == {"prepare", "upload", "detect", "collect"}


def test_run_result_has_the_jax_fields():
    from distributed_drift_detection_tpu.api import RunResult as J
    from distributed_drift_detection_tpu_torch.api import RunResult as T

    assert J._fields == T._fields


def test_compact_overflow_falls_back_loudly():
    """A compacted table too small for the run's flagged slots warns and
    falls back to the full plane: flags are unchanged, never truncated."""
    cfg = _cfg(tconfig)
    full = tpkg.run(tconfig.replace(cfg, collect="full"), device="cpu")
    with pytest.warns(RuntimeWarning, match="overflowed"):
        small = tpkg.run(tconfig.replace(cfg, collect_capacity=2), device="cpu")
    for f in full.flags._fields:
        np.testing.assert_array_equal(getattr(full.flags, f), getattr(small.flags, f))


def test_results_csv_row(tmp_path):
    path = tmp_path / "runs.csv"
    r = tpkg.run(tconfig.replace(_cfg(tconfig), results_csv=str(path)), device="cpu")
    lines = path.read_text().splitlines()
    assert len(lines) == 2 and lines[0].startswith("Spark App,")
    assert f",{r.metrics.num_detections},centroid,ddm," in lines[1]


def test_port_imports_no_jax():
    """Every module of the port, found by walking the package, imports
    without JAX, the JAX package or scikit-learn, and none touches CUDA
    at import."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import distributed_drift_detection_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) > 60, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.split('.')[0] in ('distributed_drift_detection_tpu', 'sklearn')]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=False,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_default_device_is_the_card():
    """``run(cfg)`` runs on the card by default and, without one, raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present here; the raise is the no-card path")
    with pytest.raises(RuntimeError, match="cuda"):
        tpkg.run(_cfg(tconfig))


@pytest.mark.parametrize("script", ["chip_smoke.py", "chip_kernel_ab.py"])
def test_chip_scripts_refuse_without_a_card(script):
    """The chip scripts import no JAX, and without a card they exit 2
    having printed no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present here; the refusal is the no-card path")
    mod = script[:-3]
    out = subprocess.run(
        [sys.executable, "-c", f"import sys, {mod}; assert 'jax' not in sys.modules"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=False,
    )
    assert out.returncode == 0, out.stderr
    args = ["parent-tree"] if script == "chip_kernel_ab.py" else []
    out = subprocess.run(
        [sys.executable, script, *args], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=False,
    )
    assert out.returncode == 2 and out.stdout == "", (out.stdout, out.stderr)


@pytest.mark.parametrize(
    "kw, item",
    [
        (dict(mesh_tenant_devices=2), "A15"),
        (dict(tenants=2), "A11"),
        (dict(mesh_devices=2), "A15"),
    ],
)
def test_unported_surfaces_raise(kw, item):
    """The surfaces ROADMAP A11 and A15 named, now ported. The tenant plane
    (A11): ``run`` on a ``tenants=2`` config raises the JAX package's
    ``ValueError`` naming ``run_multi``. The mesh (A15): ``mesh_devices=2``
    on two devices (``["cpu"] * 2``; the JAX package's eight CPU devices)
    gives the JAX run's flags, vote and metrics; ``mesh_tenant_devices=2``
    on a one-tenant run raises the JAX package's ``ValueError``."""
    if item == "A11":
        for run, mod in ((jpkg.run, jconfig), (lambda c: tpkg.run(c, device="cpu"), tconfig)):
            with pytest.raises(ValueError, match="use run_multi"):
                run(_cfg(mod, **kw))
        return
    if "mesh_tenant_devices" in kw:
        with pytest.raises(ValueError, match="tenant mesh axis") as j:
            jpkg.run(_cfg(jconfig, **kw))
        with pytest.raises(ValueError, match="tenant mesh axis") as t:
            tpkg.run(_cfg(tconfig, **kw), device=["cpu"] * 2)
        assert str(t.value) == str(j.value)
        return
    j = jpkg.run(_cfg(jconfig, **kw))
    t = tpkg.run(_cfg(tconfig, **kw), device=["cpu"] * 2)
    for f in j.flags._fields:
        np.testing.assert_array_equal(getattr(j.flags, f), getattr(t.flags, f), err_msg=f)
    assert np.asarray(j.drift_vote).tobytes() == t.drift_vote.tobytes()
    assert t.metrics.num_detections == j.metrics.num_detections
    assert t.metrics.mean_delay_rows == j.metrics.mean_delay_rows


def test_a_missing_csv_raises():
    """CSV datasets are ported (tests/test_torch_csv.py): a path that does
    not exist raises FileNotFoundError, as in the JAX package."""
    for run, mod in ((jpkg.run, jconfig), (lambda c: tpkg.run(c, device="cpu"), tconfig)):
        with pytest.raises(FileNotFoundError):
            run(_cfg(mod, dataset="no/such/data.csv"))


def test_forest_builds_where_it_was_refused():
    """forest is ported (tests/test_torch_forest.py): ``build_model`` and
    ``run`` take it, with the JAX package's trees and depth."""
    from distributed_drift_detection_tpu_torch.models import ModelSpec, build_model

    m = build_model("forest", ModelSpec(5, 3), _cfg(tconfig, forest_trees=2, forest_depth=2))
    assert m.keyed and m.init(1).leaf_class.shape == (1, 2, 4)


@pytest.mark.parametrize("kw", [{}, CONFIGS["dense"], CONFIGS["seq_ddm"]],
                         ids=["packed", "dense", "window1"])
def test_fit_inputs_need_no_copy(monkeypatch, kw):
    """The engines hand the centroid fit contiguous f32 rows, i32 labels
    and f32 weights, so its wrapper's conversions copy nothing and add no
    launch on the card (packed, dense and ``window=1`` streams)."""
    from distributed_drift_detection_tpu_torch.models import classifiers

    seen = []
    fit = classifiers.centroid_fit

    def spy(X, y, w, c):
        seen.append([(t.dtype, t.is_contiguous()) for t in (X, y, w)])
        return fit(X, y, w, c)

    monkeypatch.setattr(classifiers, "centroid_fit", spy)
    tpkg.run(_cfg(tconfig, **kw), device="cpu")
    want = [(torch.float32, True), (torch.int32, True), (torch.float32, True)]
    assert seen and all(s == want for s in seen)


def test_config_is_a_copy():
    """The port's RunConfig has the JAX package's fields and defaults."""
    j = {f.name: f.default for f in dataclasses.fields(jconfig.RunConfig)}
    t = {f.name: f.default for f in dataclasses.fields(tconfig.RunConfig)}
    assert j.keys() == t.keys()
    assert {k: repr(v) for k, v in j.items()} == {k: repr(v) for k, v in t.items()}


def test_window_span_continues_a_carried_jax_state():
    """The JAX engine runs the first half of a stream; its LoopCarry,
    carried across through ``convert.loop_carry``, lets the port's span
    run the second half with the same flags and the same end state."""
    import jax
    import jax.numpy as jnp
    from distributed_drift_detection_tpu.engine import loop as jloop
    from distributed_drift_detection_tpu.engine import window as jwindow
    from distributed_drift_detection_tpu.io import stream as jstream
    from distributed_drift_detection_tpu.models import ModelSpec as JSpec
    from distributed_drift_detection_tpu.models import build_model as jbuild
    from distributed_drift_detection_tpu.ops.ddm import ddm_init
    from distributed_drift_detection_tpu_torch import convert
    from distributed_drift_detection_tpu_torch.engine import loop as tloop
    from distributed_drift_detection_tpu_torch.engine import window as twindow
    from distributed_drift_detection_tpu_torch.models import ModelSpec, build_model

    stream = jstream.load_stream(BASE["dataset"], 3, seed=0)
    b = jstream.stripe_partitions_indexed(stream, 4, 25, shuffle_seed=7)
    spec = (stream.num_features, stream.num_classes)
    jspan = jax.vmap(
        jwindow.make_window_span(jbuild("centroid", JSpec(*spec)), jconfig.DDMParams(),
                                 window=8, rotations=2),
        in_axes=(0, jloop.IndexedBatches(None, None, 0, 0, 0)),
    )

    def half(lo, hi):
        return jloop.IndexedBatches(*(jnp.asarray(x) for x in (
            b.base_X, b.base_y, b.idx[:, lo:hi], b.rows[:, lo:hi], b.valid[:, lo:hi]
        )))

    i0 = np.asarray(b.idx[:, 0], np.int64)
    p = b.idx.shape[0]
    init = jloop.LoopCarry(
        params=jax.vmap(lambda _: jbuild("centroid", JSpec(*spec)).init(None))(jnp.arange(p)),
        ddm=jax.vmap(lambda _: ddm_init())(jnp.arange(p)),
        a_X=jnp.asarray(b.base_X[i0]), a_y=jnp.asarray(b.base_y[i0]),
        a_w=jnp.asarray(b.valid[:, 0], jnp.float32), retrain=jnp.ones(p, bool),
        key=jax.random.split(jax.random.key(0), p),
    )
    mid = b.idx.shape[1] // 2
    carry, _ = jspan(init, half(1, mid))
    jend, jflags = jspan(carry, half(mid, None))

    second = tloop.IndexedBatches(*(torch.from_numpy(np.array(x)) for x in half(mid, None)))
    tspan = twindow.make_window_span(build_model("centroid", ModelSpec(*spec)),
                                     tconfig.DDMParams(), window=8, rotations=2)
    tend, tflags = tspan(convert.loop_carry(carry, "centroid"), second)

    assert (np.asarray(jflags.change_local) >= 0).any()
    for f in jflags._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jflags, f)), getattr(tflags, f).numpy())
    for f in jend.ddm._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jend.ddm, f)), getattr(tend.ddm, f).numpy())
    for f in ("a_X", "a_y", "a_w", "retrain"):
        np.testing.assert_array_equal(np.asarray(getattr(jend, f)), getattr(tend, f).numpy())
    np.testing.assert_allclose(tend.params.centroids.numpy(), np.asarray(jend.params.centroids),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("capacity", [5, 40, 200])
def test_compact_flag_table_matches_jax(capacity):
    """The device-side compaction gives the JAX package's table, byte for
    byte — the embedded count included, also when it overflows."""
    from distributed_drift_detection_tpu.engine.loop import FlagRows as JFlags
    from distributed_drift_detection_tpu.parallel.mesh import compact_flag_table as jcompact
    from distributed_drift_detection_tpu_torch.engine.loop import FlagRows as TFlags
    from distributed_drift_detection_tpu_torch.parallel.mesh import compact_flag_table as tcompact

    rng = np.random.default_rng(capacity)
    shape = (6, 30)
    wl = np.where(rng.random(shape) < 0.1, rng.integers(0, 50, shape), -1).astype(np.int32)
    cl = np.where(rng.random(shape) < 0.1, rng.integers(0, 50, shape), -1).astype(np.int32)
    leaves = [wl, wl * 7, cl, cl * 7, rng.random(shape) < 0.05]
    j = np.asarray(jcompact(JFlags(*leaves), capacity))
    t = tcompact(TFlags(*(torch.from_numpy(x) for x in leaves)), capacity).numpy()
    assert j.dtype == t.dtype and j.tobytes() == t.tobytes()


def test_partition_step_continues_a_carried_jax_state():
    """The sequential (window=1) engine: the JAX package's step runs the
    first half of a dense stream with the gnb model and Page–Hinkley; its
    LoopCarry, carried across through ``convert.loop_carry``, lets the
    port's step run the second half with the same flags and the same end
    detector state, bit for bit."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from distributed_drift_detection_tpu.engine import loop as jloop
    from distributed_drift_detection_tpu.io import stream as jstream
    from distributed_drift_detection_tpu.models import ModelSpec as JSpec
    from distributed_drift_detection_tpu.models import build_model as jbuild
    from distributed_drift_detection_tpu.ops.detectors import make_detector as jdet
    from distributed_drift_detection_tpu_torch import convert
    from distributed_drift_detection_tpu_torch.engine import loop as tloop
    from distributed_drift_detection_tpu_torch.models import ModelSpec, build_model
    from distributed_drift_detection_tpu_torch.models.base import pad_row_table
    from distributed_drift_detection_tpu_torch.ops.detectors import make_detector as tdet

    stream = jstream.load_stream(BASE["dataset"], 3, seed=0)
    b = jstream.stripe_partitions(stream, 4, 25, shuffle_seed=7)
    spec = (stream.num_features, stream.num_classes)
    jph, tph = jconfig.PHParams(threshold=8.0), tconfig.PHParams(threshold=8.0)
    jmodel = jbuild("gnb", JSpec(*spec))
    jstep = jloop.make_partition_step(jmodel, jconfig.DDMParams(), shuffle=False,
                                      detector=jdet("ph", ph=jph))
    p, nb = b.y.shape[:2]
    mid = nb // 2
    init = jloop.LoopCarry(
        params=jax.vmap(lambda _: jmodel.init(None))(jnp.arange(p)),
        ddm=jax.vmap(lambda _: jdet("ph", ph=jph).init())(jnp.arange(p)),
        a_X=jnp.asarray(b.X[:, 0]), a_y=jnp.asarray(b.y[:, 0]),
        a_w=jnp.asarray(b.valid[:, 0], jnp.float32), retrain=jnp.ones(p, bool),
        key=jax.random.split(jax.random.key(0), p),
    )

    def scan(carry, lo, hi):
        part = jloop.Batches(*(jnp.asarray(x[:, lo:hi]) for x in b))
        return jax.vmap(lambda c, bb: lax.scan(jstep, c, bb))(carry, part)

    carry, _ = scan(init, 1, mid)
    jend, jflags = scan(carry, mid, nb)
    assert (np.asarray(jflags.change_local) >= 0).any()

    tstep = tloop.make_partition_step(build_model("gnb", ModelSpec(*spec)), tconfig.DDMParams(),
                                      shuffle=False, detector=tdet("ph", ph=tph))
    X = torch.from_numpy(np.ascontiguousarray(b.X))
    table = pad_row_table(X.reshape(-1, spec[0]))
    labels = torch.from_numpy(np.ascontiguousarray(b.y)).reshape(-1)
    idx = torch.arange(table.shape[0], dtype=torch.int32).view(p, nb, -1)
    tcarry = convert.loop_carry(carry, "gnb", detector="ph")
    flags = []
    for s in range(mid, nb):
        tcarry, f = tstep(tcarry, table, labels, idx[:, s].contiguous(),
                          torch.from_numpy(b.rows[:, s].copy()), torch.from_numpy(b.valid[:, s].copy()))
        flags.append(f)
    for i, name in enumerate(jflags._fields):
        got = torch.stack([f[i] for f in flags], 1).numpy()
        np.testing.assert_array_equal(np.asarray(getattr(jflags, name)), got, err_msg=name)
    for name in jend.ddm._fields:
        j, t = np.asarray(getattr(jend.ddm, name)), getattr(tcarry.ddm, name).numpy()
        np.testing.assert_array_equal(j.view(np.int32), t.view(np.int32), err_msg=name)
    for name in ("a_X", "a_y", "a_w", "retrain"):
        np.testing.assert_array_equal(np.asarray(getattr(jend, name)), getattr(tcarry, name).numpy())
