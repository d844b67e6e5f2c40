"""The port's ``run`` against the JAX package's ``run``, end to end.

``run(cfg, device='cpu')`` of the port and ``run(cfg)`` of the JAX package
take the same config on the same ``synth:`` stream; every ``FlagRows``
leaf, the drift vote and the ``DelayMetrics`` must be equal. The configs
cover the auto W×R window engine, a pinned depth, the retrain guard, an
unshuffled stream, both collect modes, the majority model, the DDM_ROBUST
noise floor and a subsampled (``mult_data < 1``) stream, which rides the
dense striper.
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
    code = (
        "import sys, distributed_drift_detection_tpu_torch as p\n"
        "import distributed_drift_detection_tpu_torch.api, "
        "distributed_drift_detection_tpu_torch.convert, "
        "distributed_drift_detection_tpu_torch.kernels._build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.split('.')[0] == 'distributed_drift_detection_tpu']\n"
        "assert not bad, bad\n"
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


@pytest.mark.parametrize(
    "kw, item",
    [
        (dict(model="mlp"), "A9"),
        (dict(detector="ph"), "A8"),
        (dict(tenants=2), "A11"),
        (dict(mesh_devices=2), "A15"),
        (dict(window=1), "A5"),
        (dict(telemetry_dir="t"), "A15"),
        (dict(validate=True), "A15"),
        (dict(dataset="data.csv"), "A10"),
    ],
)
def test_unported_surfaces_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        tpkg.run(_cfg(tconfig, **kw), device="cpu")


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
