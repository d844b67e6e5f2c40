"""The port's host stream construction against the JAX package's.

On every ``synth:`` registry spec at a small size, the port's
``parse_synth``, ``synthesize_stream``, ``stripe_partitions``,
``stripe_partitions_packed`` and ``expand_packed`` must give planes
byte-identical to the JAX package's, with the per-batch shuffle on and off.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from distributed_drift_detection_tpu.engine import loop as jloop  # noqa: E402
from distributed_drift_detection_tpu.io import stream as jstream  # noqa: E402
from distributed_drift_detection_tpu.io import synth as jsynth  # noqa: E402
from distributed_drift_detection_tpu_torch.engine import loop as tloop  # noqa: E402
from distributed_drift_detection_tpu_torch.io import stream as tstream  # noqa: E402
from distributed_drift_detection_tpu_torch.io import synth as tsynth  # noqa: E402

SPECS = [
    "prototypes,seed=1,concepts=6,rows_per_concept=60,features=5",
    "rialto,seed=2,rows_per_class=30",
    "gradual,seed=3,concepts=3,rows_per_concept=120,transition=30",
    "recurring,seed=4,concepts=4,rows_per_concept=80",
]
SHUFFLE = [None, 0x5EED + 3]


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_registry_is_the_same():
    assert sorted(tsynth.SYNTH_REGISTRY) == sorted(jsynth._SYNTH_REGISTRY)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_synth(spec):
    (jX, jy), (tX, ty) = jsynth.parse_synth(spec), tsynth.parse_synth(spec)
    _eq(jX, tX)
    _eq(jy, ty)


@pytest.mark.parametrize("mult", [3, 0.7])
@pytest.mark.parametrize("spec", SPECS)
def test_synthesize_stream(spec, mult):
    j = jstream.load_stream("synth:" + spec, mult, seed=5)
    t = tstream.load_stream("synth:" + spec, mult, seed=5)
    assert (j.num_classes, j.dist_between_changes, j.num_rows) == (
        t.num_classes, t.dist_between_changes, t.num_rows
    )
    _eq(j.X, t.X)
    _eq(j.y, t.y)
    if mult >= 1:
        for f in ("base_X", "base_y", "src"):
            _eq(getattr(j, f), getattr(t, f))


@pytest.mark.parametrize("shuffle", SHUFFLE, ids=["unshuffled", "shuffled"])
@pytest.mark.parametrize("spec", SPECS)
def test_stripe_partitions(spec, shuffle):
    j = jstream.load_stream("synth:" + spec, 0.9, seed=1)
    t = tstream.load_stream("synth:" + spec, 0.9, seed=1)
    jb = jstream.stripe_partitions(j, 4, 16, shuffle_seed=shuffle)
    tb = tstream.stripe_partitions(t, 4, 16, shuffle_seed=shuffle)
    for f in jloop.Batches._fields:
        _eq(getattr(jb, f), getattr(tb, f))


@pytest.mark.parametrize("shuffle", SHUFFLE, ids=["unshuffled", "shuffled"])
@pytest.mark.parametrize("spec", SPECS)
def test_stripe_packed_and_expand(spec, shuffle):
    j = jstream.load_stream("synth:" + spec, 2, seed=3)
    t = tstream.load_stream("synth:" + spec, 2, seed=3)
    jp = jstream.stripe_partitions_packed(j, 3, 20, shuffle_seed=shuffle)
    tp = tstream.stripe_partitions_packed(t, 3, 20, shuffle_seed=shuffle)
    for f in jloop.PackedIndexedBatches._fields:
        _eq(getattr(jp, f), getattr(tp, f))
    je = jloop.expand_packed(jloop.PackedIndexedBatches(
        *(jnp.asarray(x) for x in jp)
    ))
    te = tloop.expand_packed(tloop.PackedIndexedBatches(
        *(torch.from_numpy(np.asarray(x)) for x in tp[:4]), int(tp.n_rows)
    ))
    _eq(je.rows, te.rows.numpy())
    _eq(je.valid, te.valid.numpy())


def test_csv_datasets_load_like_jax(tmp_path):
    """CSV ingest is ported (tests/test_torch_csv.py): a CSV written from a
    synth: spec loads to the planes of the JAX package's load_stream."""
    from distributed_drift_detection_tpu_torch.io.datasets import _write_schema_csv
    from distributed_drift_detection_tpu_torch.io.synth import parse_synth

    path = str(tmp_path / "s.csv")
    _write_schema_csv(*parse_synth("prototypes,seed=2,concepts=3,rows_per_concept=20,features=4"),
                      path)
    j = jstream.load_stream(path, 2, seed=1, data_policy="strict")
    t = tstream.load_stream(path, 2, seed=1, data_policy="strict")
    _eq(j.base_X, t.base_X)
    _eq(j.src, t.src)
    with pytest.raises(FileNotFoundError):
        tstream.load_stream("some.csv")
