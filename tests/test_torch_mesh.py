"""The port's device mesh — ``parallel/mesh.py``, the meshed ``run``,
``run_multi``, ``ChunkedDetector`` and soak — against the JAX package's on
its 8-device CPU backend (``tests/conftest.py``).

The port's meshes are ``["cpu"] * n``: n shards of the plane on the CPU,
each running the one-device runner over its rows, merged as JAX merges its
sharded program's outputs. Inputs: ``synth:`` streams made from a seed, at
F = 12 (``C10`` in ROADMAP.md: XLA fuses a one-partition fit differently
below F = 9), P ≤ 8, a few hundred rows a partition. Tolerance: none — the
flags, the drift vote's bytes, every ``DelayMetrics`` field and the
compacted table's bytes are compared exactly. The mlp's fitted parameters
agree with JAX's to a tolerance only (``tests/test_torch_mlp.py``); its
meshed run is held bit for bit to the port's unsharded run, and its flags
to JAX's as ``tests/test_torch_run.py`` holds them.
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import distributed_drift_detection_tpu as jpkg  # noqa: E402
from distributed_drift_detection_tpu import config as jconfig  # noqa: E402
from distributed_drift_detection_tpu.engine import soak as jsoak  # noqa: E402
from distributed_drift_detection_tpu.engine.chunked import ChunkedDetector as JCD  # noqa: E402
from distributed_drift_detection_tpu.engine.loop import FlagRows as JFlags  # noqa: E402
from distributed_drift_detection_tpu.io import feeder as jfeed  # noqa: E402
from distributed_drift_detection_tpu.io import stream as jstream  # noqa: E402
from distributed_drift_detection_tpu.models import ModelSpec as JSpec  # noqa: E402
from distributed_drift_detection_tpu.models import build_model as jbuild  # noqa: E402
from distributed_drift_detection_tpu.parallel import mesh as jmesh  # noqa: E402
import distributed_drift_detection_tpu_torch as tpkg  # noqa: E402
from distributed_drift_detection_tpu_torch import api  # noqa: E402
from distributed_drift_detection_tpu_torch import config as tconfig  # noqa: E402
from distributed_drift_detection_tpu_torch.engine import soak as tsoak  # noqa: E402
from distributed_drift_detection_tpu_torch.engine.chunked import ChunkedDetector as TCD  # noqa: E402
from distributed_drift_detection_tpu_torch.engine.loop import FlagRows  # noqa: E402
from distributed_drift_detection_tpu_torch.io import feeder as tfeed  # noqa: E402
from distributed_drift_detection_tpu_torch.models import ModelSpec, build_model  # noqa: E402
from distributed_drift_detection_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from distributed_drift_detection_tpu_torch.utils import threefry  # noqa: E402

SPEC = "synth:prototypes,seed=0,concepts=6,rows_per_concept=400,features=12"
BASE = dict(dataset=SPEC, mult_data=2, partitions=8, per_batch=50, results_csv="")
CPU8 = ["cpu"] * 8


def _cpus(n):
    return ["cpu"] * n


def _flags_equal(want, got, what=""):
    for f in FlagRows._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(want, f)), np.asarray(getattr(got, f)), err_msg=f"{what} {f}"
        )


def _metrics_equal(want, got):
    for field in dataclasses.fields(got):
        np.testing.assert_array_equal(
            np.asarray(getattr(want, field.name)), np.asarray(getattr(got, field.name)),
            err_msg=field.name,
        )


def _runs_equal(j, t):
    _flags_equal(j.flags, t.flags)
    assert np.asarray(j.drift_vote).tobytes() == np.asarray(t.drift_vote).tobytes()
    _metrics_equal(j.metrics, t.metrics)


# -- the mesh and its sharding rules (JAX tests/test_fleet_serving.py:81 on) --


def test_make_mesh_shapes_and_errors_match_jax():
    for kw in ({}, dict(num_devices=4), dict(tenant_devices=2), dict(tenant_devices=4),
               dict(num_devices=6, tenant_devices=2), dict(tenant_devices=1)):
        j = jmesh.make_mesh(**kw)
        t = tmesh.make_mesh(devices=CPU8, **kw)
        assert t.axis_names == j.axis_names
        assert t.devices.shape == j.devices.shape
        assert t.shape == dict(j.shape)
        assert tmesh.plane_axes(t) == jmesh.plane_axes(j)
    for kw in (dict(tenant_devices=3), dict(num_devices=6, tenant_devices=4)):
        with pytest.raises(ValueError, match="tenant axis") as je:
            jmesh.make_mesh(**kw)
        with pytest.raises(ValueError, match="tenant axis") as te:
            tmesh.make_mesh(devices=CPU8, **kw)
        assert str(te.value) == str(je.value)
    # a sequence may repeat a device; a single name is that device
    assert tmesh.make_mesh(devices=["cpu"] * 3).size == 3
    assert tmesh.make_mesh(devices="cpu").size == 1


def test_plane_sharding_divisibility():
    t = tmesh.make_mesh(devices=CPU8, tenant_devices=2)
    sh = tmesh.plane_sharding(t, t.size * 2)
    assert sh.spec == tmesh.P((tmesh.TENANT_AXIS, tmesh.PARTITION_AXIS)) and sh.splits
    assert tmesh.partition_sharding(t, t.size * 2) == sh
    assert not tmesh.NamedSharding(t, tmesh.P()).splits
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.plane_sharding(t, t.size + 1)
    with pytest.raises(ValueError, match="not divisible"):
        jmesh.plane_sharding(jmesh.make_mesh(tenant_devices=2), 9)


def test_match_partition_rules_tree():
    """The JAX test's tree: first match wins, scalars and unmatched leaves
    replicate, a catch-all tail splits them, ``mesh=`` gives shardings."""
    t = tmesh.make_mesh(devices=CPU8, tenant_devices=2)
    j = jmesh.make_mesh(tenant_devices=2)
    tree = {
        "params": {"centroids": np.zeros((8, 3, 5))},
        "count": np.zeros(()),
        "odd_leaf": np.zeros((8, 2)),
    }

    def same(tspecs, jspecs):
        for k in ("count", "odd_leaf"):
            assert tuple(tspecs[k]) == tuple(jspecs[k]), k
        assert tuple(tspecs["params"]["centroids"]) == tuple(jspecs["params"]["centroids"])

    for rules in (((r"params/", "S"),), ((r"params/", "S"), (r".*", "S")),
                  ((r"centroids", None), (r".*", "S"))):
        tr = tuple((pat, tmesh.P() if s is None else tmesh.P(tmesh.plane_axes(t)))
                   for pat, s in rules)
        jr = tuple((pat, jmesh.P() if s is None else jmesh.P(jmesh.plane_axes(j)))
                   for pat, s in rules)
        same(tmesh.match_partition_rules(tr, tree), jmesh.match_partition_rules(jr, tree))
    sharded = tmesh.match_partition_rules(((r"params/", tmesh.P(tmesh.plane_axes(t))),),
                                          tree, mesh=t)
    assert sharded["params"]["centroids"].mesh.shape_tuple == tuple(j.shape_tuple)
    assert sharded["params"]["centroids"].splits and not sharded["count"].splits


def test_plane_shardings_split_and_gather_a_carry():
    """``plane_shardings`` on a real carry: every plane-major leaf splits
    into the mesh's contiguous shards and ``gather_tree`` joins them back,
    bit for bit, with the carry's host keys staying numpy."""
    det = TCD(build_model("centroid", ModelSpec(12, 6)), partitions=8, window=4, device="cpu")
    s = jstream.load_stream(SPEC, 2, seed=0)
    det.feed(next(iter(tfeed.chunk_stream_arrays(s.X, s.y, 8, 50, 2, shuffle_seed=1))))
    carry = det.carry
    mesh = tmesh.make_mesh(devices=_cpus(4))
    shards = tmesh.split_tree(carry, mesh)
    assert len(shards) == 4 and shards[1].a_X.shape[0] == 2
    assert isinstance(shards[3].key, np.ndarray) and shards[3].key.shape == (2, 2)
    back = tmesh.gather_tree(shards, mesh)
    for a, b in zip(jax.tree_util.tree_leaves(carry, is_leaf=lambda x: x is None),
                    jax.tree_util.tree_leaves(back, is_leaf=lambda x: x is None)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- run and run_multi --------------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's runs of BASE, by mesh width (cached)."""
    cache = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            cache[key] = jpkg.run(jconfig.RunConfig(**{**BASE, **kw}))
        return cache[key]

    return get


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_run_on_a_mesh_matches_jax(jax_runs, n):
    """``run`` with ``mesh_devices = n`` on eight devices: the JAX package's
    meshed run's flags, vote bytes and metrics, and the merged compacted
    table of the whole plane (``collect='compact'``, the default)."""
    t = tpkg.run(tconfig.RunConfig(**BASE, mesh_devices=n), device=CPU8)
    _runs_equal(jax_runs(mesh_devices=n), t)
    prep = api.prepare(tconfig.RunConfig(**BASE, mesh_devices=n), device=CPU8)
    assert (prep.mesh is None) if n == 1 else (prep.mesh.size == n)


def test_six_partitions_step_down_to_three(jax_runs):
    """P = 6 with ``mesh_devices=4``: the JAX rule steps the width down to
    3, and the port's shards are three."""
    kw = dict(partitions=6, mesh_devices=4)
    prep = api.prepare(tconfig.RunConfig(**{**BASE, **kw}), device=CPU8)
    assert prep.mesh.size == 3
    _runs_equal(jax_runs(**kw), tpkg.run(tconfig.RunConfig(**{**BASE, **kw}), device=CPU8))


SMALL = "synth:prototypes,seed=0,concepts=6,rows_per_concept=200,features=12"


@pytest.mark.parametrize("kw", [dict(detector="ph"),
                                dict(model="forest", forest_trees=4, dataset=SMALL),
                                dict(collect="full", window=1)],
                         ids=["ph", "forest", "seq_full"])
def test_run_families_on_a_mesh_match_jax(jax_runs, kw):
    t = tpkg.run(tconfig.RunConfig(**{**BASE, **kw}, mesh_devices=4), device=CPU8)
    _runs_equal(jax_runs(mesh_devices=4, **kw), t)


def test_mlp_on_a_mesh():
    """The mlp on a 2-shard mesh: bit for bit the port's unsharded run (its
    keys are the whole plane's, sliced), and JAX's meshed run's flags."""
    kw = dict(BASE, dataset=SMALL, mult_data=1, partitions=4, model="mlp",
              mlp_hidden=(16, 8), fit_steps=8)
    one = tpkg.run(tconfig.RunConfig(**kw), device="cpu")
    two = tpkg.run(tconfig.RunConfig(**kw, mesh_devices=2), device=CPU8)
    _flags_equal(one.flags, two.flags)
    assert one.drift_vote.tobytes() == two.drift_vote.tobytes()
    _metrics_equal(one.metrics, two.metrics)
    j = jpkg.run(jconfig.RunConfig(**kw, mesh_devices=2))
    _flags_equal(j.flags, two.flags)


def test_one_partition_a_shard_at_low_width():
    """C10's geometry: P = 8 on 8 devices (one partition a shard) at F = 7,
    where XLA fuses the one-partition fit's bias otherwise. The port's
    meshed run is its unsharded run bit for bit, and JAX's meshed run's:
    flags, vote bytes and metrics (ROADMAP.md C10: 40 detections each)."""
    spec = "synth:prototypes,seed=0,concepts=6,rows_per_concept=400,features=7"
    kw = dict(BASE, dataset=spec)
    one = tpkg.run(tconfig.RunConfig(**kw), device="cpu")
    eight = tpkg.run(tconfig.RunConfig(**kw, mesh_devices=8), device=CPU8)
    _flags_equal(one.flags, eight.flags)
    j = jpkg.run(jconfig.RunConfig(**kw, mesh_devices=8))
    _runs_equal(j, eight)
    assert eight.metrics.num_detections == 40


@pytest.mark.parametrize("mesh_devices, width", [(0, 6), (4, 3)])
def test_every_entry_point_resolves_one_mesh_width(mesh_devices, width):
    """One rule turns a device list into a mesh (``resolve_mesh``, JAX
    ``_build_runner``'s): at P = 6 on eight devices ``prepare``,
    ``prepare_chunked`` and ``ChunkedDetector`` step down to the same
    width (3 with ``mesh_devices=4``, as ``test_six_partitions_step_down_to_three``
    holds ``run`` to JAX's), and the soak over those six partitions too."""
    cfg = tconfig.RunConfig(**{**BASE, "partitions": 6, "window": 4,
                               "mesh_devices": mesh_devices})
    run_mesh = api.prepare(cfg, device=CPU8).mesh
    det, _ = api.prepare_chunked(cfg, 12, 6, chunk_batches=2, device=CPU8)
    assert run_mesh.size == det.mesh.size == len(det._shards) == width
    if mesh_devices == 0:
        m = build_model("centroid", ModelSpec(12, 6))
        assert TCD(m, partitions=6, window=4, device=CPU8).mesh.size == width
        mesh, shards = tsoak._mesh_shards(m, None, CPU8, 6)
        assert mesh.size == len(shards) == width


MULTI = dict(dataset="synth:rialto,seed=3,rows_per_class=160", partitions=2, per_batch=50,
             model="centroid", results_csv="", tenants=4)


@pytest.mark.parametrize("tenant_devices", [2, 4])
def test_run_multi_on_a_tenant_mesh(tenant_devices):
    """``run_multi`` on a 2-D (tenants, partitions) mesh of the eight
    devices: each tenant's flags and vote are the JAX package's meshed
    run's and the port's unsharded run's."""
    j = jpkg.run_multi(jconfig.RunConfig(**MULTI, mesh_tenant_devices=tenant_devices))
    t = tpkg.run_multi(tconfig.RunConfig(**MULTI, mesh_tenant_devices=tenant_devices),
                       device=CPU8)
    ref = tpkg.run_multi(tconfig.RunConfig(**MULTI), device="cpu")
    for k in range(4):
        for want in (j.results[k], ref.results[k]):
            _flags_equal(want.flags, t.results[k].flags, f"tenant {k}")
            assert np.asarray(want.drift_vote).tobytes() == t.results[k].drift_vote.tobytes()
            _metrics_equal(want.metrics, t.results[k].metrics)


@pytest.mark.parametrize("kw, devices", [
    (dict(tenants=3, mesh_tenant_devices=2), 8),  # 3 tenants % 2
    (dict(tenants=4, mesh_tenant_devices=4, mesh_devices=2), 8),  # 2 devices % 4
])
def test_run_multi_tenant_mesh_errors_match_jax(kw, devices):
    cfg = {**MULTI, **kw}
    with pytest.raises(ValueError, match="tenant") as je:
        jpkg.run_multi(jconfig.RunConfig(**cfg))
    with pytest.raises(ValueError, match="tenant") as te:
        tpkg.run_multi(tconfig.RunConfig(**cfg), device=_cpus(devices))
    assert str(te.value) == str(je.value)


# -- the compacted table's merge ----------------------------------------------


def _plane(rng, p, nbf, density):
    hit = rng.random((p, nbf)) < density
    warn = np.where(hit & (rng.random((p, nbf)) < 0.5), rng.integers(0, 50, (p, nbf)), -1)
    change = np.where(hit & (warn < 0), rng.integers(0, 50, (p, nbf)), -1)
    forced = hit & (warn < 0) & (change < 0)
    return [warn.astype(np.int32), (warn * 7).astype(np.int32),
            change.astype(np.int32), (change * 7).astype(np.int32), forced]


@pytest.mark.parametrize("density, k, shards", [
    (0.1, 64, 4),  # no overflow
    (0.3, 12, 4),  # every shard alone overflows
    (0.05, 12, 4),  # the sum overflows, no shard does
    (0.0, 16, 2),  # nothing flagged
    (1.0, 16, 8),  # every slot flagged
    (0.2, 1, 4),  # K = 1
    (0.2, 8 * 30, 2),  # K = every slot
])
def test_merged_compact_table_is_the_whole_planes(density, k, shards):
    """Each shard's table (K4's plain version, at the global capacity, its
    partitions offset) merged in shard order is JAX's ``compact_flag_table``
    of the whole plane, byte for byte."""
    rng = np.random.default_rng(int(density * 100) + k)
    p, nbf = 8, 30
    leaves = _plane(rng, p, nbf, density)
    flagged = sum(((leaves[0] >= 0) | (leaves[2] >= 0) | leaves[4]).ravel())
    per = p // shards
    counts = [int(((leaves[0][s * per:(s + 1) * per] >= 0) | (leaves[2][s * per:(s + 1) * per] >= 0)
                   | leaves[4][s * per:(s + 1) * per]).sum()) for s in range(shards)]
    if (density, k) == (0.3, 12):
        assert min(counts) > k
    if (density, k) == (0.05, 12):
        assert max(counts) <= k < flagged
    want = np.asarray(jmesh.compact_flag_table(JFlags(*(jnp.asarray(x) for x in leaves)), k))
    tl = [torch.from_numpy(x) for x in leaves]
    tables = [
        tmesh.compact_flag_table(FlagRows(*(x[s * per:(s + 1) * per] for x in tl)), k, s * per)
        for s in range(shards)
    ]
    got = tmesh.merge_compact_tables(tables, k).numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert tmesh.compact_flag_table(FlagRows(*tl), k).numpy().tobytes() == want.tobytes()


# -- the chunked engine and the soak on a mesh ---------------------------------


def test_chunked_on_a_mesh_matches_jax():
    """JAX ``tests/test_chunked.py:229`` (P = 8, 40 rows a batch, 6 a
    chunk, window 4, an 8-device mesh) on the port's 8-shard mesh, and a
    checkpoint moved from a 4-shard mesh into one device and back."""
    stream = jstream.load_stream(SPEC, 2, seed=0)
    p, b = 8, 40
    jspec = JSpec(stream.num_features, stream.num_classes)
    tspec = ModelSpec(stream.num_features, stream.num_classes)

    def chunks(mod, cb=6):
        return mod.chunk_stream_arrays(stream.X, stream.y, p, b, cb, shuffle_seed=11)

    want = JCD(jbuild("centroid", jspec), partitions=p, seed=0, window=4,
               mesh=jmesh.make_mesh(8)).run(chunks(jfeed))
    model = build_model("centroid", tspec)
    got = TCD(model, partitions=p, seed=0, window=4, mesh=tmesh.make_mesh(devices=CPU8),
              device="cpu").run(chunks(tfeed))
    _flags_equal(want, got)
    want = TCD(model, partitions=p, seed=0, window=4, device="cpu").run(chunks(tfeed, cb=2))
    for a_dev, b_dev in ((_cpus(4), "cpu"), ("cpu", _cpus(2))):
        it = list(chunks(tfeed, cb=2))
        first = TCD(model, partitions=p, seed=0, window=4, device=a_dev)
        parts = [first.feed(c) for c in it[:2]]
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "carry.npz")
            first.save(path)
            second = TCD(model, partitions=p, seed=0, window=4, device=b_dev)
            second.restore(path, example_chunk=it[2])
            parts += [second.feed(c) for c in it[2:]]
        host = [[np.asarray(x) for x in f] for f in parts]
        _flags_equal(want, FlagRows(*(np.concatenate(xs, 1) for xs in zip(*host))),
                     f"{a_dev} -> {b_dev}")


SOAK = dict(partitions=8, per_batch=50, num_batches=20, drift_every=250)


def test_soak_on_a_mesh_matches_jax():
    """JAX ``tests/test_soak.py:113`` cut to 20 batches of 50 rows: the
    soak sharded over eight devices."""
    want = jax.jit(jsoak.make_soak_runner(jbuild("centroid", JSpec(8, 8)), **SOAK,
                                          mesh=jmesh.make_mesh(8)))(jax.random.key(0))
    got = tsoak.make_soak_runner(build_model("centroid", ModelSpec(8, 8)), **SOAK,
                                 mesh=tmesh.make_mesh(devices=CPU8))(threefry.key(0))
    _flags_equal(want.flags, got.flags)


def test_chained_soak_on_a_mesh_matches_jax():
    """JAX ``tests/test_soak.py:411`` cut to three legs of 5 batches of 50
    rows on an 8-device mesh, the state a shard on its device between legs;
    and the chained driver on 2 shards equal to its unsharded run."""
    chain = dict(partitions=8, per_batch=50, batches_per_leg=5, legs=3, drift_every=250)

    def collect(first, nxt, key):
        out = first(key)
        parts = [out.flags]
        for s in range(1, 3):
            out = nxt(out.state, s)
            parts.append(out.flags)
        return out, [np.concatenate([np.asarray(x[i]) for x in parts], 1) for i in range(5)]

    _, want = collect(*jsoak.make_soak_chain(jbuild("centroid", JSpec(8, 8)), **chain,
                                             mesh=jmesh.make_mesh(8)), jax.random.key(0))
    out, got = collect(*tsoak.make_soak_chain(build_model("centroid", ModelSpec(8, 8)), **chain,
                                              mesh=tmesh.make_mesh(devices=CPU8)),
                       threefry.key(0))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert len(out.state) == 8 and out.state[7].gen_keys.shape == (1, 2)
    m = build_model("centroid", ModelSpec(8, 8))
    kw = dict(partitions=4, per_batch=50, total_rows=8_000, drift_every=250,
              max_leg_rows=4_000)
    one = tsoak.run_soak_chained(m, **kw, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        two = tsoak.run_soak_chained(m, **kw, device=_cpus(2),
                                     checkpoint_path=os.path.join(d, "chain.ckpt"))
    assert one.detections > 0
    assert (two.detections, two.planted_boundaries) == (one.detections, one.planted_boundaries)
    np.testing.assert_array_equal(one.delays, two.delays)


def test_host_callback_model_refused_on_a_mesh():
    """``require_shardable``: a host-callback model on a mesh raises the
    JAX package's message."""
    from distributed_drift_detection_tpu_torch.models.base import Model, require_shardable

    rf = Model("rf", None, None, None, None, host_callback=True)
    with pytest.raises(ValueError, match="host callback"):
        require_shardable(rf, tmesh.make_mesh(devices=_cpus(2)))
    require_shardable(rf, None)


def test_prepare_chunked_builds_the_tenant_mesh():
    """``prepare_chunked`` with ``mesh_tenant_devices=2`` (JAX
    ``tests/test_fleet_serving.py:168``): a 2 × 4 (tenants, partitions)
    mesh of the eight devices, each chunk's flags the JAX package's; a
    tenant count the tenant axis does not divide is refused."""
    from distributed_drift_detection_tpu import api as japi
    from distributed_drift_detection_tpu.engine.loop import stack_tenants
    from distributed_drift_detection_tpu.io.stream import stripe_chunk
    from distributed_drift_detection_tpu.io.synth import rialto_like_xy

    p, b, cb, t_count, f = 2, 50, 2, 4, 27
    span = p * b * cb
    per_tenant = []
    for t in range(t_count):
        X, y = rialto_like_xy(seed=100 + t, rows_per_class=3 * span // 10)
        per_tenant.append([stripe_chunk(X[k * span:(k + 1) * span], y[k * span:(k + 1) * span],
                                        k * span, p, b, cb, shuffle_seed=t) for k in range(3)])
    stacked = [stack_tenants([per_tenant[t][k] for t in range(t_count)]) for k in range(3)]
    kw = dict(partitions=p, per_batch=b, window=4, tenants=t_count, mesh_tenant_devices=2,
              seed=7, results_csv="")
    jdet, _ = japi.prepare_chunked(jconfig.RunConfig(**kw), f, 10, chunk_batches=cb)
    tdet, _ = api.prepare_chunked(tconfig.RunConfig(**kw), f, 10, chunk_batches=cb, device=CPU8)
    assert tdet.mesh.devices.shape == (2, 4)
    for k, c in enumerate(stacked):
        _flags_equal(jdet.feed(c), tdet.feed(c), f"chunk {k}")
    assert len(tdet._carry) == 8  # a carry a shard
    with pytest.raises(ValueError, match="tenant") as je:
        japi.prepare_chunked(jconfig.RunConfig(**{**kw, "tenants": 3}), f, 10, chunk_batches=cb)
    with pytest.raises(ValueError, match="tenant") as te:
        api.prepare_chunked(tconfig.RunConfig(**{**kw, "tenants": 3}), f, 10, chunk_batches=cb,
                            device=CPU8)
    assert str(te.value) == str(je.value)


def test_on_drift_on_a_mesh_matches_unsharded():
    """``on_drift`` refits on a 2-shard mesh (one partition a shard): the
    refit reads and writes only its tenant's rows of the carry
    (``carry_rows``), so the flags and the controller's snapshot are the
    unsharded detector's and the JAX package's."""
    from distributed_drift_detection_tpu.io.stream import stripe_chunk
    from distributed_drift_detection_tpu.io.synth import recurring_drift_xy

    X, y = recurring_drift_xy(seed=1, concepts=4, rows_per_concept=600)
    p, b, cb = 2, 25, 2
    span = p * b * cb

    def chunks():
        for s in range(0, len(X), span):
            yield stripe_chunk(X[s:s + span], y[s:s + span], s, p, b, cb)

    jd = JCD(jbuild("centroid", JSpec(X.shape[1], 8), jconfig.RunConfig()), partitions=p,
             seed=0, window=1, on_drift="retrain")
    want = jd.run(chunks())
    model = build_model("centroid", ModelSpec(X.shape[1], 8))
    for device in ("cpu", _cpus(2)):
        td = TCD(model, partitions=p, seed=0, window=1, on_drift="retrain", device=device)
        _flags_equal(want, td.run(chunks()), f"{device}")
        assert td.adapt.snapshot() == jd.adapt.snapshot()
    assert td.mesh is not None and td.adapt.snapshot()["adaptations"] > 0


def test_serve_mesh_tenants_matches_unmeshed(tmp_path, monkeypatch):
    """JAX ``tests/test_fleet_serving.py:741``: a daemon on a 2 × 1
    (tenants, partitions) mesh (``--mesh-tenants 2``) publishes the
    unmeshed daemon's flags bit for bit."""
    from distributed_drift_detection_tpu.io import planted_prototypes
    from distributed_drift_detection_tpu_torch.config import ServeParams
    from distributed_drift_detection_tpu_torch.serve import ServeRunner
    from distributed_drift_detection_tpu_torch.serve.loadgen import format_lines

    monkeypatch.chdir(tmp_path)
    stream = planted_prototypes(9, concepts=2, rows_per_concept=260, features=6)
    lines = format_lines(stream.X, stream.y)

    def drive(device, **kw):
        cfg = tconfig.RunConfig(partitions=4, per_batch=25, model="centroid", seed=9,
                                shuffle_batches=True, results_csv="", window=1,
                                data_policy="quarantine", tenants=2, **kw)
        r = ServeRunner(cfg, ServeParams(num_features=stream.num_features,
                                         num_classes=stream.num_classes, port=None,
                                         ops_port=None, chunk_batches=2, linger_s=0.05),
                        keep_flags=True, device=device)
        r.start()
        for t in range(2):
            r.admissions[t].admit_lines(lines[t::2])
        r.batcher.flush()
        r.request_stop()
        assert r.serve_forever() == 0
        return r, r.flags()

    _, ref = drive("cpu")
    r, got = drive(_cpus(2), mesh_tenant_devices=2)
    assert r.det.mesh.devices.shape == (2, 1)
    _flags_equal(ref, got, "mesh-tenants daemon")
    assert int((np.asarray(ref.change_global) >= 0).sum()) > 0
