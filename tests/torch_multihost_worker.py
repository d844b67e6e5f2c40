"""Worker body of the port's multi-process test (the twin of
``tests/multihost_worker.py``).

Launched N times by ``tests/test_torch_multihost.py``: fresh processes,
each contributing two CPU devices to the mesh, wired by
``torch.distributed`` (gloo). Drives ``initialize`` → ``global_mesh`` →
``host_partition_slice`` → ``local_stripe`` → ``shard_batches_global`` →
the mesh runner, then checks, against a one-device run of the same stream
computed in this process: the drift vote and the compacted flag table
(byte for byte; both are the whole run's in every process), this
process's own rows of the packed flag plane, the whole plane's host flags
from the table, and ``host_flags``' refusal of a run with no table.

argv: ``coordinator_address num_processes process_id [plain|packed]``;
with ``env`` as the coordinator the process group comes from torchrun's
variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``).
The port imports no JAX, so neither does this worker.
"""

import sys

import numpy as np

DEVICES_PER_PROC = 2
PARTITIONS = 8
PER_BATCH = 8


def _plain_stream(c: int, f: int):
    """A dense stream, every plane of its stripe cut to the shards."""
    from distributed_drift_detection_tpu_torch.io.stream import StreamData, stripe_partitions

    rng = np.random.default_rng(0)
    n = PARTITIONS * 16 * PER_BATCH
    y = (np.arange(n) * c // n).astype(np.int32)
    means = rng.normal(scale=4.0, size=(c, f)).astype(np.float32)
    X = means[y] + rng.normal(scale=1.0, size=(n, f)).astype(np.float32)
    stream = StreamData(X, y, num_classes=c, dist_between_changes=n // c)
    return stripe_partitions(stream, PARTITIONS, PER_BATCH), 4, False


def _packed_stream(c: int, f: int):
    """A duplicated stream in its packed form: the row table shared, the
    index planes cut to the shards."""
    from distributed_drift_detection_tpu_torch.io.stream import (
        stripe_partitions_packed,
        synthesize_stream,
    )

    rng = np.random.default_rng(0)
    n0, mult = 256, 8
    y0 = (np.arange(n0) * c // n0).astype(np.int64)
    means = rng.normal(scale=4.0, size=(c, f)).astype(np.float32)
    X0 = means[y0] + rng.normal(scale=1.0, size=(n0, f)).astype(np.float32)
    stream = synthesize_stream(X0, y0, mult_data=mult, seed=0)
    assert stream.src is not None
    return stripe_partitions_packed(stream, PARTITIONS, PER_BATCH, shuffle_seed=7), 64, True


def main(coord: str, nproc: int, pid: int, mode: str = "plain") -> None:
    from distributed_drift_detection_tpu_torch.config import DDMParams
    from distributed_drift_detection_tpu_torch.models import ModelSpec, build_model
    from distributed_drift_detection_tpu_torch.parallel import multihost
    from distributed_drift_detection_tpu_torch.parallel.mesh import (
        auto_compact_capacity,
        host_flags,
        make_mesh_runner,
        shard_batches,
    )

    if coord == "env":
        assert multihost._multiprocess_signalled()
        multihost.initialize()
    else:
        multihost.initialize(coordinator_address=coord, num_processes=nproc, process_id=pid)
    assert multihost.process_count() == nproc and multihost.process_index() == pid
    assert multihost.host_identity()["process_index"] == pid

    c, f = 4, 6
    batches, window, packed = {"plain": _plain_stream, "packed": _packed_stream}[mode](c, f)
    model = build_model("centroid", ModelSpec(f, c))
    plane = batches.idx if packed else batches.y
    cap = auto_compact_capacity(PARTITIONS, plane.shape[1] - 1)

    mesh = multihost.global_mesh(devices=["cpu"] * DEVICES_PER_PROC)
    assert mesh.size == nproc * DEVICES_PER_PROC and mesh.process_count == nproc
    sl = multihost.host_partition_slice(PARTITIONS, mesh)
    per_host = PARTITIONS // nproc
    assert sl == slice(pid * per_host, (pid + 1) * per_host), sl
    local, _ = multihost.local_stripe(batches, None, sl)
    assert (local.idx if packed else local.y).shape[0] == per_host
    if packed:
        assert local.base_X.shape == batches.base_X.shape  # the row table whole
    db, _ = multihost.shard_batches_global(local, None, mesh, PARTITIONS)
    assert db.rows == PARTITIONS and len(db.shards) == DEVICES_PER_PROC
    out = make_mesh_runner(model, DDMParams(), mesh, window=window, packed=packed,
                           compact_capacity=cap)(db)

    single = make_mesh_runner(model, DDMParams(), None, window=window, packed=packed,
                              compact_capacity=cap)(shard_batches(batches, None, None, "cpu")[0])
    assert out.drift_vote.numpy().tobytes() == single.drift_vote.numpy().tobytes()
    assert (single.drift_vote > 0).any(), "no drift found: a vacuous run"
    assert out.compact.numpy().tobytes() == single.compact.numpy().tobytes()
    assert out.packed.shape[1] == per_host
    np.testing.assert_array_equal(out.packed.numpy(), single.packed[:, sl].numpy())
    # the collect step: the whole plane's flags from the merged table in
    # every process; with no table (collect='full') a process holds only
    # its own rows, so host_flags refuses rather than return a part
    got, info = host_flags(out)
    want, _ = host_flags(single)
    assert info["mode"] == "compact" and not info["overflow"], info
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    full = make_mesh_runner(model, DDMParams(), mesh, window=window, packed=packed)(db)
    try:
        host_flags(full)
    except RuntimeError as e:
        assert "across processes" in str(e), e
    else:
        raise AssertionError("host_flags returned one process's rows as the whole plane")
    print(f"worker {pid}/{nproc} [{mode}]: OK ({per_host} partitions checked, "
          f"{int(single.compact[-1, 0])} flagged slots)")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
         sys.argv[4] if len(sys.argv) > 4 else "plain")
