"""The port's device-generated soak (``engine/soak.py``, kernel K6's plain
version) against the JAX package's ``engine/soak.py``, on the CPU.

The generators' plain versions give JAX's bits (``sea``, ``hyperplane``
and ``prototypes`` bit for bit; ``hyperplane_gradual``'s features bit for
bit and its labels equal off margins within a few roundings of 0, the
limit ROADMAP C9 records: the port's sine is correctly rounded, XLA's is
the C library's ``sinf``). The runners give JAX's flags leaf by leaf:
``window=1``, ``window>1`` at rotations 1 and 2, ``tenants=2``, a zoo
detector by name with Page–Hinkley's auto λ, SEA; the chain equals the
one-shot run modulo the partition row offset, and the driver's summary is
that stream folded leg by leg; a chain killed at ``soak.leg`` resumes from
its checkpoint to the uninterrupted summary; a JAX chain's leg 0 continues
in the port (``convert.soak_chain_state``). The JAX package's sequential
runner at ``GEOM`` compiles once, in a module fixture, and is the
reference of the windowed, tenant and chained runs through the JAX
package's own contracts (windowed = sequential, tenant block = solo run,
chain = one-shot).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from distributed_drift_detection_tpu.engine import soak as jsoak  # noqa: E402
from distributed_drift_detection_tpu.models import ModelSpec as JSpec  # noqa: E402
from distributed_drift_detection_tpu.models import build_model as jbuild  # noqa: E402
from distributed_drift_detection_tpu_torch import convert  # noqa: E402
from distributed_drift_detection_tpu_torch.config import DDMParams  # noqa: E402
from distributed_drift_detection_tpu_torch.engine import soak as tsoak  # noqa: E402
from distributed_drift_detection_tpu_torch.engine.loop import device_keys  # noqa: E402
from distributed_drift_detection_tpu_torch.models import ModelSpec as TSpec  # noqa: E402
from distributed_drift_detection_tpu_torch.models import build_model as tbuild  # noqa: E402
from distributed_drift_detection_tpu_torch.resilience import faults  # noqa: E402
from distributed_drift_detection_tpu_torch.utils import threefry  # noqa: E402
from distributed_drift_detection_tpu_torch.utils.checkpoint import (  # noqa: E402
    CheckpointCorruptError,
)

GEOM = dict(partitions=4, per_batch=50, num_batches=30, drift_every=500)
RUNS = {
    "seq": {},
    "window4": dict(window=4),
    "window4_r2": dict(window=4, rotations=2, chunk_batches=5),
    "ph_by_name": dict(detector="ph"),
    "sea": dict(generator="sea", spec=(3, 2)),
}
# GEOM's stream in 3 legs of 10 batches
CHAIN = dict(partitions=4, per_batch=50, total_rows=6_000, drift_every=500,
             max_leg_rows=2_000)


def _flags_equal(want, got):
    for name in want._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(want, name)), np.asarray(getattr(got, name)), err_msg=name
        )


def _jkey(seed):
    return jax.random.fold_in(jax.random.key(seed), 3)


def _tkey(seed):
    return torch.from_numpy(np.asarray(jax.random.key_data(_jkey(seed))).astype(np.int64))


@pytest.mark.parametrize("data", [0, 1, 4099, 2**31 - 1, 2**32 - 1])
def test_fold_in_matches_jax(data):
    key = jax.random.key(17)
    want = np.asarray(jax.random.key_data(jax.random.fold_in(key, np.uint32(data))))
    kd = np.asarray(jax.random.key_data(key))
    np.testing.assert_array_equal(threefry.fold_in(kd, data), want)
    np.testing.assert_array_equal(
        threefry.fold_in(torch.from_numpy(kd.astype(np.int64)), data).numpy(), want)


def test_draws_match_jax_at_the_generators_shapes():
    """``uniform`` at (B, 3), (B, F) and (F,), ``normal`` at (C, F) and (B,
    F), ``randint`` at (B,) and ``split`` give JAX's bits (one jitted
    program of all the draws)."""
    b, f, c = 257, 10, 8
    shapes = ((b, 3), (b, f), (f,))

    def draws(key):
        return ([jax.random.uniform(key, s) for s in shapes]
                + [jax.random.normal(key, s) for s in ((c, f), (b, f))]
                + [jax.random.randint(key, (b,), 0, c),
                   jax.random.key_data(jax.random.split(key))])

    want = [np.asarray(a) for a in jax.jit(draws)(_jkey(1))]
    tk = _tkey(1)
    got = ([threefry.uniform(tk, s) for s in shapes]
           + [threefry.normal(tk, s) for s in ((c, f), (b, f))]
           + [threefry.randint(tk, (b,), 0, c), threefry.split(tk, 2)])
    for g, w in zip(got, want):
        if w.dtype == np.float32:
            np.testing.assert_array_equal(g.numpy().view(np.int32), w.view(np.int32))
        else:
            np.testing.assert_array_equal(g.numpy().astype(np.int64), w.astype(np.int64))


# (generator, F, first row, block0): nonzero concept offsets, a batch that
# straddles concept boundaries, rows next to 2^31 - 1
GEN_CASES = [
    ("sea", 3, 12_345, 3), ("hyperplane", 10, 12_345, 3),
    ("hyperplane_gradual", 10, 12_345, 3), ("prototypes", 8, 12_345, 3),
    ("prototypes", 5, 2**31 - 1 - 2_000, 0), ("hyperplane_gradual", 4, 2**31 - 1 - 2_000, 9),
]


@pytest.mark.parametrize("gen, f, row0, block0", GEN_CASES)
def test_generators_match_jax(gen, f, row0, block0):
    """X bit for bit for every generator, labels bit for bit but for
    ``hyperplane_gradual``'s, which must agree off |margin| within 4·F
    roundings of its terms (ROADMAP C9)."""
    b, de = 2_000, 700
    rows = np.arange(b, dtype=np.int32) + np.int32(row0)
    jgen = jsoak._GENERATORS[gen][0]
    Xj, yj = map(np.asarray, jax.jit(
        lambda k, r: jgen(k, r, de, f, block0=block0))(_jkey(2), jnp.asarray(rows)))
    X, y = tsoak._GENERATORS[gen][0](_tkey(2), torch.from_numpy(rows), de, f, block0=block0)
    np.testing.assert_array_equal(X.numpy().view(np.int32), Xj.view(np.int32))
    if gen != "hyperplane_gradual":
        np.testing.assert_array_equal(y.numpy(), yj)
        return
    X64 = X.double()
    rp = de
    phase = (torch.from_numpy(rows).long() % rp).float() * tsoak.rotation_scale(rp)
    arg = phase[:, None] + torch.arange(f, dtype=torch.float32)
    wk = threefry.fold_in(torch.tensor(threefry.key(7), dtype=torch.int64),
                          block0 + torch.from_numpy(rows).long() // de)
    w = threefry.uniform(wk, (f,)).double() + 0.3 * torch.sin(arg.double())
    margin = (X64 * w).sum(1) - 0.5 * w.sum(1)
    scale = (X64 * w).abs().sum(1) + 0.5 * w.abs().sum(1)
    off = margin.abs() > 4 * f * 2.0**-23 * scale
    assert bool(off.all()) or off.float().mean() > 0.99
    np.testing.assert_array_equal(y.numpy()[off.numpy()], yj[off.numpy()])


def test_soak_batch_reference_layout():
    """K6's plain version: partition-major rows, zero padding past F, row
    positions −1 past ``last``, the clamped tail generated at ``last``, and
    partition-local rows with ``block0s`` giving the one-shot's concepts."""
    p, b, f, de, nb = 3, 40, 5, 140, 7
    keys = device_keys(threefry.split(threefry.key(4), p), "cpu")
    kw = dict(per_batch=b, features=f, drift_every=de, generator="prototypes")
    offs = torch.arange(p) * nb * b
    got = tsoak.soak_batch(keys, 5, 4, nb - 1, offs.int(), torch.zeros(p, dtype=torch.int32), **kw)
    assert got.table.shape == (p * 4 * b, 8) and got.labels.shape == (p * 4 * b,)
    assert bool((got.table[:, f:] == 0).all())
    rows = got.rows.view(p, 4, b)
    assert bool((rows[:, 2:] == -1).all()) and bool((rows[:, :2] >= 0).all())
    tail = got.table.view(p, 4, b, -1)
    assert torch.equal(tail[:, 1], tail[:, 2]) and torch.equal(tail[:, 1], tail[:, 3])
    one = tsoak.soak_batch(keys, 3, 1, nb - 1, offs.int(), torch.zeros(p, dtype=torch.int32), **kw)
    blocks = (torch.arange(p) * (nb * b // de)).int()
    local = tsoak.soak_batch(keys, 3, 1, nb - 1, torch.zeros(p, dtype=torch.int32), blocks, **kw)
    assert torch.equal(one.table, local.table) and torch.equal(one.labels, local.labels)
    assert torch.equal(one.rows - offs.int()[:, None, None], local.rows)


def _jrunner(spec=(8, 8), **kw):
    return jax.jit(jsoak.make_soak_runner(jbuild("centroid", JSpec(*spec)), **dict(GEOM, **kw)))


def _trun(spec=(8, 8), key=0, **kw):
    cfg = dict(GEOM, **kw)
    return tsoak.make_soak_runner(tbuild("centroid", TSpec(*spec)), device="cpu", **cfg)(
        threefry.key(key))


@pytest.fixture(scope="module")
def one_shot():
    """The JAX package's sequential soak at ``GEOM``: its jitted runner and
    its result for ``key(0)``."""
    run = _jrunner()
    return run, run(jax.random.key(0))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_soak_runner_matches_jax(name, one_shot):
    """Flags leaf by leaf. The windowed runs are held to the JAX package's
    sequential run: its windowed soak is bit-identical to it for a
    deterministic fit (its ``test_window_soak_matches_sequential``)."""
    kw = RUNS[name]
    if kw and "window" not in kw:
        want = _jrunner(**kw)(jax.random.key(0))
    else:
        want = one_shot[1]
    got = _trun(**kw)
    _flags_equal(want.flags, got.flags)
    assert got.rows_processed == int(want.rows_processed)
    assert int((np.asarray(want.flags.change_global) >= 0).sum()) > 0


def test_tenant_blocks_are_solo_runs(one_shot):
    """``tenants=2``: tenant t's block of the port's plane equals the JAX
    package's solo run keyed by ``split(key, 2)[t]``, as its runner lays
    the plane out."""
    run, _ = one_shot
    got = _trun(tenants=2)
    p = GEOM["partitions"]
    for t, k in enumerate(jax.random.split(jax.random.key(0), 2)):
        want = run(k)
        _flags_equal(want.flags, type(got.flags)(*(leaf[t * p:(t + 1) * p] for leaf in got.flags)))


def _legs_of(flags, p, nb, b, legs, bpl):
    """A one-shot run's flags cut into a chain's legs (leg 0 without batch
    0), rows made partition-local."""
    offset = (np.arange(p) * nb * b)[:, None]
    out, start = [], 0
    for s in range(legs):
        n = bpl - 1 if s == 0 else bpl
        leg = {}
        for name in flags._fields:
            a = np.asarray(getattr(flags, name))[:, start:start + n]
            if name in ("warning_global", "change_global"):
                a = np.where(a >= 0, a - offset, a)
            leg[name] = a
        out.append(leg)
        start += n
    return out


def test_chain_matches_the_one_shot(one_shot):
    """The port's chain (3 legs of 10 batches) equals the JAX one-shot run
    of the same stream, modulo the partition row offset (JAX :436-443)."""
    p, b, nb = GEOM["partitions"], GEOM["per_batch"], GEOM["num_batches"]
    first, nxt = tsoak.make_soak_chain(
        tbuild("centroid", TSpec(8, 8)), partitions=p, per_batch=b,
        batches_per_leg=10, legs=3, drift_every=GEOM["drift_every"], device="cpu")
    out = first(threefry.key(0))
    got = [out.flags]
    for s in (1, 2):
        out = nxt(out.state, s)
        got.append(out.flags)
    for leg, want in zip(got, _legs_of(one_shot[1].flags, p, nb, b, 3, 10)):
        for name, a in want.items():
            np.testing.assert_array_equal(a, getattr(leg, name).numpy(), err_msg=name)


@pytest.fixture(scope="module")
def chained():
    """The port's driver over ``GEOM``'s stream in 3 legs, uninterrupted."""
    return tsoak.run_soak_chained(tbuild("centroid", TSpec(8, 8)), device="cpu", **CHAIN)


def test_chained_driver_summary_matches_jax(chained, one_shot):
    """The driver's summary is the JAX package's one-shot stream folded leg
    by leg: its detections, their delays in leg order, the planted
    boundaries (the JAX package's count) and the rows."""
    p, b, nb, de = (GEOM[k] for k in ("partitions", "per_batch", "num_batches", "drift_every"))
    legs = _legs_of(one_shot[1].flags, p, nb, b, 3, 10)
    cg = [leg["change_global"] for leg in legs]
    delays = np.concatenate([c[c >= 0].astype(np.int64) % de for c in cg])
    assert chained.legs == 3 and chained.rows_processed == p * nb * b
    assert chained.requested_rows == CHAIN["total_rows"]
    assert chained.detections == delays.size
    np.testing.assert_array_equal(chained.delays, delays)
    assert chained.planted_boundaries == jsoak.planted_interior_boundaries(p, nb * b, de)
    assert chained.detections == chained.planted_boundaries


def test_checkpoint_resume_after_a_soak_leg_kill(chained, tmp_path):
    """A chain killed before leg 2 (``DDD_FAULTS``' ``soak.leg``) resumes
    from its checkpoint at leg 2 and returns the uninterrupted summary; the
    checkpoint is removed at the end."""
    ckpt = str(tmp_path / "chain.ckpt")
    seen = []
    faults.arm("soak.leg", at=3)
    try:
        with pytest.raises(faults.InjectedFault):
            tsoak.run_soak_chained(tbuild("centroid", TSpec(8, 8)), device="cpu",
                                   checkpoint_path=ckpt, **CHAIN)
    finally:
        faults.disarm_all()
    assert os.path.exists(ckpt)
    got = tsoak.run_soak_chained(
        tbuild("centroid", TSpec(8, 8)), device="cpu", checkpoint_path=ckpt,
        on_leg=lambda s, fl: seen.append(s), **CHAIN)
    assert seen == list(range(2, chained.legs))
    assert got.detections == chained.detections and got.legs == chained.legs
    np.testing.assert_array_equal(got.delays, chained.delays)
    assert not os.path.exists(ckpt)


def test_checkpoint_geometry_mismatch_and_torn_file(tmp_path):
    """A checkpoint of another geometry raises the JAX package's
    ``ValueError``, one without the key fingerprint the legacy refusal,
    and a torn file ``CheckpointCorruptError``."""
    from distributed_drift_detection_tpu_torch.utils import checkpoint

    ckpt = str(tmp_path / "c.ckpt")
    kw = dict(CHAIN, partitions=2, total_rows=2_000, max_leg_rows=500)
    model = tbuild("centroid", TSpec(8, 8))
    faults.arm("soak.leg", at=2)
    try:
        with pytest.raises(faults.InjectedFault):
            tsoak.run_soak_chained(model, device="cpu", checkpoint_path=ckpt, **kw)
    finally:
        faults.disarm_all()
    with pytest.raises(ValueError, match="different chain geometry"):
        tsoak.run_soak_chained(model, device="cpu", checkpoint_path=ckpt,
                               **dict(kw, drift_every=250))
    with pytest.raises(ValueError, match="different chain geometry"):
        tsoak.run_soak_chained(model, device="cpu", checkpoint_path=ckpt,
                               key=threefry.key(5), **kw)
    impl = tsoak._make_soak_chain_impl(model, partitions=2, per_batch=50,
                                       batches_per_leg=10, legs=2, drift_every=500,
                                       device="cpu")
    state, meta = checkpoint.load_checkpoint(ckpt, impl.template())
    del meta["key_fp"]
    checkpoint.save_checkpoint(ckpt, state, meta)
    with pytest.raises(ValueError, match="predates the PRNG-key fingerprint"):
        tsoak.run_soak_chained(model, device="cpu", checkpoint_path=ckpt, **kw)
    with open(ckpt, "r+b") as fh:
        fh.truncate(os.path.getsize(ckpt) // 2)
    with pytest.raises(CheckpointCorruptError, match="torn/corrupt checkpoint"):
        tsoak.run_soak_chained(model, device="cpu", checkpoint_path=ckpt, **kw)


def test_a_jax_chain_continues_in_the_port(one_shot):
    """Leg 0 on the JAX package, leg 1 in the port from its converted state
    (``convert.soak_chain_state``): leg 1's flags equal the JAX stream's."""
    p, b, nb, de = (GEOM[k] for k in ("partitions", "per_batch", "num_batches", "drift_every"))
    kw = dict(partitions=p, per_batch=b, drift_every=de, batches_per_leg=10, legs=3)
    impl = jsoak._make_soak_chain_impl(jbuild("centroid", JSpec(8, 8)), **kw)
    st = impl.first(jax.random.key(0), impl.block0s).state
    st = st._replace(carry=st.carry._replace(key=jax.random.key_data(st.carry.key)),
                     gen_keys=jax.random.key_data(st.gen_keys))
    state = convert.soak_chain_state(jax.tree.map(np.asarray, st), "centroid")
    _, tnext = tsoak.make_soak_chain(tbuild("centroid", TSpec(8, 8)), device="cpu", **kw)
    got = tnext(state, 1).flags
    for name, a in _legs_of(one_shot[1].flags, p, nb, b, 3, 10)[1].items():
        np.testing.assert_array_equal(a, getattr(got, name).numpy(), err_msg=name)


@pytest.mark.parametrize("kw, match", [
    (dict(generator="nope"), "unknown generator"),
    (dict(num_batches=2**22, partitions=1024), "int32 global-row-index"),
    (dict(window=0), "window must be >= 1"),
    (dict(window=4, chunk_batches=-1), "chunk_batches must be >= 0"),
    (dict(chunk_batches=4), "only applies to the windowed soak"),
    (dict(rotations=2), "rotations only applies"),
    (dict(tenants=0), "tenants must be >= 1"),
])
def test_runner_input_checks_match_jax(kw, match):
    cfg = dict(GEOM, **kw)
    with pytest.raises(ValueError, match=match) as j:
        jsoak.make_soak_runner(jbuild("centroid", JSpec(8, 8)), **cfg)
    with pytest.raises(ValueError, match=match) as t:
        tsoak.make_soak_runner(tbuild("centroid", TSpec(8, 8)), device="cpu", **cfg)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("kw, match", [
    (dict(batches_per_leg=7), "must be a multiple of drift_every"),
    (dict(legs=2**22, batches_per_leg=10), "exceeds int32 positions"),
    (dict(partitions=2048, legs=2000, drift_every=1), "total concept blocks"),
])
def test_chain_input_checks_match_jax(kw, match):
    cfg = dict(partitions=2, per_batch=100, batches_per_leg=10, legs=2, drift_every=1000)
    cfg.update(kw)
    with pytest.raises(ValueError, match=match) as j:
        jsoak._make_soak_chain_impl(jbuild("centroid", JSpec(8, 8)), **cfg)
    with pytest.raises(ValueError, match=match) as t:
        tsoak._make_soak_chain_impl(tbuild("centroid", TSpec(8, 8)), device="cpu", **cfg)
    assert str(t.value) == str(j.value)


def test_a_mesh_is_refused_by_name():
    with pytest.raises(NotImplementedError, match="A15d"):
        tsoak.make_soak_runner(tbuild("centroid", TSpec(8, 8)), mesh=object(),
                               device="cpu", **GEOM)


@pytest.mark.parametrize("name", ["ddm", "ph", "eddm", "hddm", "adwin"])
def test_soak_detector_names_resolve_as_in_jax(name):
    from distributed_drift_detection_tpu.config import DDMParams as JDDM

    want = jsoak.resolve_soak_detector(JDDM(), name, 1000)
    got = tsoak.resolve_soak_detector(DDMParams(), name, 1000)
    assert got.name == want.name
    assert [float(v) for v in got.params] == [float(v) for v in want.params]


@pytest.mark.parametrize("p, r, de", [(4, 4000, 1000), (128, 8_200_000, 100_000),
                                      (3, 1234, 100), (1, 1000, 1000)])
def test_planted_interior_boundaries_match_jax(p, r, de):
    assert tsoak.planted_interior_boundaries(p, r, de) == jsoak.planted_interior_boundaries(p, r, de)


# --- K6's plan (engine/soak.py k6_plan, k6_tile_concepts): the tile a CTA
# generates and the concept tables it stages, checked here without a card


def _tile_rows(row_off, t, last, b, tile):
    """The row positions of a K6 tile, as the kernel forms them."""
    te = min(t, last)
    i0 = tile * tsoak.K6_TILE
    n = min(tsoak.K6_TILE, b - i0)
    return row_off + te * b + i0 + np.arange(n, dtype=np.int64)


@pytest.mark.parametrize("de", [1, 7, 255, 256, 700, 100_000])
@pytest.mark.parametrize("b", [1, 64, 257, 2000])
def test_k6_tile_concepts_match_blocks(de, b):
    """A tile's concept span from its first row and length is exactly the
    set of ``_blocks`` of its rows, on random offsets, clamped window tails
    and rows up to 2^31 − 1, and never more than ``k6_max_span``."""
    rng = np.random.default_rng(de * 7919 + b)
    nb = 50
    offs = [0, 2**31 - nb * b, *rng.integers(0, 2**31 - nb * b, 6).tolist()]
    tiles = -(-b // tsoak.K6_TILE)
    for row_off in offs:
        for t in (0, 3, nb - 1, nb + 4):  # the last clamped to nb - 1
            for tile in range(tiles):
                rows = _tile_rows(row_off, t, nb - 1, b, tile)
                assert rows[-1] <= 2**31 - 1
                first, span = tsoak.k6_tile_concepts(rows[0], len(rows), de)
                blocks = tsoak._blocks(torch.from_numpy(rows), de, 0)
                assert sorted(set(blocks.tolist())) == list(range(first, first + span))
                assert span <= tsoak.k6_max_span(b, de)
    # the worst case is reached: a tile starting on a concept's last row
    n = min(tsoak.K6_TILE, b)
    assert tsoak.k6_tile_concepts(de - 1, n, de)[1] == tsoak.k6_max_span(b, de)


# (generator, F, B, classes, drift_every, force) -> (slots, per_concept);
# None: the forced layout is refused
K6_PLANS = {
    "prototypes_main": (("prototypes", 8, 2000, 8, 100_000, 0), (2, 64)),
    "hyperplane_main": (("hyperplane", 10, 2000, 2, 100_000, 0), (2, 10)),
    "gradual_main": (("hyperplane_gradual", 10, 2000, 2, 100_000, 0), (2, 10)),
    "sea_one_layout": (("sea", 3, 2000, 2, 100_000, 2), (0, 0)),
    "forced_per_row": (("prototypes", 8, 2000, 8, 100_000, 1), (0, 64)),
    # 38 concepts a tile: their prototypes cost more than the rows' own
    "de7_prototypes": (("prototypes", 8, 2000, 8, 7, 0), (0, 64)),
    "de7_forced": (("prototypes", 8, 2000, 8, 7, 2), (38, 64)),
    "de7_hyperplane": (("hyperplane", 10, 2000, 2, 7, 0), (38, 10)),
    "de1_hyperplane_past_budget": (("hyperplane", 20, 2000, 2, 1, 0), (0, 20)),
    # C·F past the budget (and past a CTA's shared memory when forced)
    "classes_4096": (("prototypes", 16, 1000, 4096, 100_000, 0), (0, 65536)),
    "classes_4096_forced": (("prototypes", 16, 1000, 4096, 100_000, 2), None),
    "classes_256_cost": (("prototypes", 8, 2000, 256, 100_000, 0), (0, 2048)),
    "classes_512_forced_slots": (("prototypes", 8, 300, 512, 18, 2), (14, 4096)),
    "small_batch": (("prototypes", 8, 64, 8, 100_000, 0), (2, 64)),
    "b1": (("hyperplane", 10, 1, 2, 1, 0), (1, 10)),
}


@pytest.mark.parametrize("case", sorted(K6_PLANS))
def test_k6_plan_layouts(case):
    """The plan stages a tile's concept tables when they fit the budget
    and cost no more hashes than the rows' own draws, else takes the
    per-row layout; ``force`` reaches each layout (refused only where one
    concept's table exceeds a CTA's shared memory)."""
    (gen, f, b, c, de, force), want = K6_PLANS[case]
    if want is None:
        with pytest.raises(ValueError, match="does not fit"):
            tsoak.k6_plan(16, 1, b, f, gen, c, de, force)
        return
    plan = tsoak.k6_plan(16, 2, b, f, gen, c, de, force)
    assert (plan.slots, plan.per_concept) == want
    assert plan.tiles == -(-b // tsoak.K6_TILE) and plan.ctas == 32 * plan.tiles
    assert plan.span == tsoak.k6_max_span(b, de)
    assert plan.shared_bytes == plan.slots * (8 + 4 * plan.per_concept)
    assert plan.shared_bytes <= tsoak.K6_MAX_SHARED
    assert plan.layout == ("staged" if plan.slots else "per-row")
    if force == 0 and plan.slots:
        assert plan.slots * plan.per_concept <= tsoak.K6_STAGE_FLOATS


def test_k6_plan_rejects_an_unknown_force():
    with pytest.raises(ValueError, match="force"):
        tsoak.k6_plan(4, 1, 100, 8, "prototypes", 8, 100, 3)


def _k6_staged_model(keys, t0, count, last, row_offs, block0s, *, per_batch, features,
                     drift_every, generator, classes=8, slots):
    """K6's staged layout in plain PyTorch, tile by tile as a CTA works: the
    batch's keys once, each reached concept's table (prototypes × the
    factor, or weight uniforms) once, each row's own draws, the table read
    at (row // de − first, y·F + f) — or a row's entries inline where the
    tile reaches more than ``slots`` concepts."""
    from distributed_drift_detection_tpu_torch.models.base import row_stride

    gid = tsoak._generator(generator)[2]
    p, b, f, de = keys.shape[0], per_batch, features, drift_every
    out = torch.zeros((p * count * b, row_stride(f)))
    labels = torch.zeros(p * count * b, dtype=torch.int32)
    key11 = torch.as_tensor(threefry.key(11 if gid == 3 else 7)).long()
    for q in range(p):
        for c in range(count):
            te = min(t0 + c, last)
            kt = threefry.fold_in(keys[q].long(), te)
            for tile in range(-(-b // tsoak.K6_TILE)):
                rows = _tile_rows(int(row_offs[q]), t0 + c, last, b, tile)
                i = torch.arange(tile * tsoak.K6_TILE, tile * tsoak.K6_TILE + len(rows))
                first, span = tsoak.k6_tile_concepts(rows[0], len(rows), de)
                staged = span <= slots
                blocks = int(block0s[q]) + torch.from_numpy(rows) // de
                ckeys = threefry.fold_in(key11, blocks)  # a row's concept key
                e = (q * count + c) * b + i
                if gid == 3:
                    kc, kn = threefry.split(kt, 2)
                    y = threefry.randint(kc, (b,), 0, classes)[i]
                    if staged:
                        tkeys = threefry.fold_in(key11, int(block0s[q]) + first
                                                 + torch.arange(span))
                        table = threefry.normal_erf_inv(threefry.unit_floats(threefry.bits_at(
                            tkeys, torch.arange(classes * f)))) * tsoak.normal_factor(3.0)
                        slot = torch.from_numpy(rows) // de - first
                        proto = table[slot[:, None], y[:, None] * f + torch.arange(f)]
                    else:
                        proto = threefry.normal_erf_inv(threefry.unit_floats(threefry.bits_at(
                            ckeys, y[:, None] * f + torch.arange(f)))) * tsoak.normal_factor(3.0)
                    noise = threefry.normal_erf_inv(threefry._unit_floats(kn, (b, f)))[i]
                    out[e, :f] = tsoak.fma(noise, tsoak.normal_factor(0.08), proto)
                    labels[e] = y.int()
                else:
                    kx = threefry.split(kt, 2)[0]
                    X = threefry.uniform(kx, (b, f))[i]
                    if staged:
                        tkeys = threefry.fold_in(key11, int(block0s[q]) + first
                                                 + torch.arange(span))
                        w = threefry.uniform(tkeys, (f,))[torch.from_numpy(rows) // de - first]
                    else:
                        w = threefry.uniform(ckeys, (f,))
                    if gid == 2:
                        period = max(de, 1)
                        phase = (torch.from_numpy(rows) % period).float() * tsoak.rotation_scale(
                            period)
                        arg = phase[:, None] + torch.arange(f, dtype=torch.float32)
                        w = tsoak.fma(torch.sin(arg.double()).float(), 0.3, w)
                    out[e, :f] = X
                    labels[e] = (tsoak.hyperplane_margin(X, w) > 0).int()
    return out, labels


@pytest.mark.parametrize("generator, f, de, slots", [
    ("prototypes", 8, 7, 38), ("prototypes", 5, 300, 2), ("prototypes", 8, 18, 14),
    ("hyperplane", 10, 7, 38), ("hyperplane_gradual", 10, 300, 2), ("hyperplane", 1, 100, 0),
])
def test_k6_staged_model_matches_the_reference(generator, f, de, slots):
    """The staged layout's arithmetic — a tile's concept tables indexed by
    (row // de − first, y·F + f), a tile past its slots computing inline —
    gives the plain version's bits, on partition-local rows with concept
    offsets and a clamped tail."""
    p, b, count, t0, last = 3, 300, 3, 4, 5
    keys = device_keys(threefry.split(threefry.key(9), p), "cpu")
    offs = torch.tensor([0, 5_000, 2**31 - 1 - 10 * b], dtype=torch.int32)
    block0s = torch.tensor([0, 17, 3], dtype=torch.int32)
    kw = dict(per_batch=b, features=f, drift_every=de, generator=generator)
    want = tsoak.soak_batch_reference(keys, t0, count, last, offs, block0s, **kw)
    table, labels = _k6_staged_model(keys, t0, count, last, offs, block0s, slots=slots, **kw)
    assert torch.equal(table.view(torch.int32), want.table.view(torch.int32))
    assert torch.equal(labels, want.labels)
