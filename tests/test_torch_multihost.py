"""The port's multi-process runs — ``parallel/multihost.py`` — mirroring
the JAX package's ``tests/test_multihost.py`` (one process) and
``tests/test_multihost_multiprocess.py`` (real processes).

One process: ``initialize`` is a no-op without a launcher's signal (and
SLURM's rank variables alone are identity, not a signal), the slice and
stripe arithmetic, and ``shard_batches_global`` degenerating to
``shard_batches``. Real processes: ``tests/torch_multihost_worker.py``
launched 2 (and, in the slow tier, 4) times on the CPU, each contributing
two CPU devices, over a gloo process group; each checks the run's drift
vote and compacted table byte for byte and its own rows of the flag plane
against a one-device run. Tolerance: none.
"""

import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_drift_detection_tpu.parallel import multihost as jmh  # noqa: E402
from distributed_drift_detection_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from distributed_drift_detection_tpu_torch.engine.loop import Batches, PackedIndexedBatches  # noqa: E402
from distributed_drift_detection_tpu_torch.parallel import multihost  # noqa: E402
from distributed_drift_detection_tpu_torch.parallel.mesh import (  # noqa: E402
    PARTITION_AXIS,
    TENANT_AXIS,
    make_mesh,
    shard_batches,
)

_WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
_SIGNALS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "SLURM_PROCID", "SLURM_NTASKS")


@pytest.fixture
def no_launcher(monkeypatch):
    for var in _SIGNALS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_initialize_is_noop_without_signal(no_launcher):
    assert not multihost._multiprocess_signalled()
    multihost.initialize()
    assert not torch.distributed.is_initialized()
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)


def test_signal_detection(no_launcher):
    no_launcher.setenv("SLURM_PROCID", "1")
    no_launcher.setenv("SLURM_NTASKS", "2")
    assert not multihost._multiprocess_signalled()  # identity, not a signal
    assert multihost.host_identity()["process_index"] == 1
    multihost.initialize()  # a serve daemon launched so starts no process group
    assert not torch.distributed.is_initialized()
    no_launcher.setenv("MASTER_ADDR", "127.0.0.1")
    no_launcher.setenv("WORLD_SIZE", "1")
    assert not multihost._multiprocess_signalled()  # one process is no cluster
    no_launcher.setenv("WORLD_SIZE", "2")
    assert multihost._multiprocess_signalled()


def test_host_partition_slice_single_process():
    mesh = make_mesh(devices=["cpu"] * 8)
    assert multihost.host_partition_slice(16, mesh) == jmh.host_partition_slice(
        16, jmake_mesh(8)) == slice(0, 16)
    with pytest.raises(ValueError, match="not divisible") as t:
        multihost.host_partition_slice(12, mesh)
    with pytest.raises(ValueError, match="not divisible") as j:
        jmh.host_partition_slice(12, jmake_mesh(8))
    assert str(t.value) == str(j.value)


def test_global_mesh_single_process(no_launcher):
    mesh = multihost.global_mesh(devices=["cpu"] * 4)
    assert mesh.size == 4 and mesh.axis_names == (PARTITION_AXIS,)
    assert mesh.local_shards() == [0, 1, 2, 3] and mesh.process_count == 1
    two_d = multihost.global_mesh(tenant_devices=2, devices=["cpu"] * 4)
    assert two_d.axis_names == (TENANT_AXIS, PARTITION_AXIS) and two_d.devices.shape == (2, 2)


def test_local_stripe_slices_partition_planes():
    rng = np.random.default_rng(0)
    packed = PackedIndexedBatches(
        base_X=np.zeros((7, 3), np.float32), base_y=np.zeros(7, np.int32),
        idx=rng.integers(0, 7, (8, 4, 5)).astype(np.int16),
        perm=rng.integers(0, 5, (8, 4, 5)).astype(np.uint8), n_rows=160,
    )
    keys = rng.integers(0, 2**32, (8, 2), dtype=np.uint64).astype(np.uint32)
    local, lk = multihost.local_stripe(packed, keys, slice(2, 6))
    assert local.idx.shape[0] == 4 and local.perm.shape[0] == 4 and lk.shape == (4, 2)
    assert local.base_X.shape == (7, 3)  # the shared row table passes through
    np.testing.assert_array_equal(lk, keys[2:6])
    dense = Batches(rng.random((8, 3, 5, 2), dtype=np.float32),
                    rng.integers(0, 3, (8, 3, 5)).astype(np.int32),
                    np.arange(120, dtype=np.int32).reshape(8, 3, 5), np.ones((8, 3, 5), bool))
    local, lk = multihost.local_stripe(dense, None, slice(4, 8))
    assert lk is None and all(leaf.shape[0] == 4 for leaf in local)


def test_shard_batches_global_degenerates():
    """One process: ``shard_batches_global`` is ``shard_batches``."""
    rng = np.random.default_rng(0)
    p, nb, b, f = 8, 3, 10, 4
    batches = Batches(rng.random((p, nb, b, f), dtype=np.float32),
                      rng.integers(0, 3, (p, nb, b)).astype(np.int32),
                      np.arange(p * nb * b, dtype=np.int32).reshape(p, nb, b),
                      np.ones((p, nb, b), bool))
    keys = np.arange(p * 2, dtype=np.uint32).reshape(p, 2)
    mesh = make_mesh(devices=["cpu"] * 4)
    got, _ = multihost.shard_batches_global(batches, keys, mesh, p)
    want, _ = shard_batches(batches, keys, mesh)
    assert got.rows == want.rows == p
    for g, w in zip(got.shards, want.shards):
        assert (g.lo, g.hi) == (w.lo, w.hi)
        np.testing.assert_array_equal(g.key, w.key)
        for a, c in zip(g.batches, w.batches):
            assert torch.equal(a, c)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(nproc: int, mode: str = "plain", timeout: int = 120, env_launch: bool = False):
    """``nproc`` workers under one shared deadline; each ``(rc, output)``,
    the output kept whatever happens (a peer stuck at the rendezvous never
    hides the real failure)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(_WORKER)))
    port = _free_port()
    base = {k: v for k, v in os.environ.items() if k not in _SIGNALS}
    base["PYTHONPATH"] = os.pathsep.join(p for p in (repo, base.get("PYTHONPATH")) if p)
    procs = []
    for pid in range(nproc):
        env = dict(base)
        if env_launch:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(pid),
                       WORLD_SIZE=str(nproc))
            coord = "env"
        else:
            coord = f"127.0.0.1:{port}"
        procs.append(subprocess.Popen(
            [sys.executable, _WORKER, coord, str(nproc), str(pid), mode], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=repo,
        ))
    outs = [None] * nproc
    threads = []
    for i, p in enumerate(procs):
        def drain(i=i, p=p):
            out, _ = p.communicate()
            outs[i] = (p.returncode, out)

        t = threading.Thread(target=drain, daemon=True)
        t.start()
        threads.append(t)
    deadline = time.monotonic() + timeout
    try:
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for t in threads:
            t.join(30)
    return [o if o is not None else (-9, "<no output: killed at the deadline>") for o in outs]


def _check(results, nproc, mode):
    for pid, (rc, out) in enumerate(results):
        assert rc == 0, f"worker {pid} exited {rc}:\n{out}"
        assert f"worker {pid}/{nproc} [{mode}]: OK" in out, out


def test_two_process_run_matches_single_process():
    """Two real processes on the CPU, launched with torchrun's variables
    (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``): each gives the
    one-device run's vote and compacted table, its own partitions' flags
    and, through ``host_flags``, the whole plane's host flags; a run with
    no table is refused by ``host_flags``."""
    _check(_launch(2, "plain", env_launch=True), 2, "plain")


def test_host_flags_refuses_a_part_of_the_plane():
    """A result that holds only this process's rows of a wider plane and
    no compacted table has no whole-plane flags to give: ``host_flags``
    raises (the JAX package cannot bring a non-addressable plane to the
    host either); the whole plane's result is read as before."""
    from distributed_drift_detection_tpu_torch.parallel.mesh import MeshRunResult, host_flags

    packed = torch.full((5, 2, 3), -1, dtype=torch.int32)
    packed[2, 1, 0] = 0
    packed[4] = 0
    vote = torch.zeros(3)
    flags, info = host_flags(MeshRunResult(None, vote, packed))
    assert info == {"mode": "full", "events": None, "overflow": False}
    assert flags.change_local[1, 0] == 0 and flags.change_global.shape == (2, 3)
    with pytest.raises(RuntimeError, match="across processes"):
        host_flags(MeshRunResult(None, vote, packed, partitions=4))


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["plain", "packed"])
@pytest.mark.parametrize("nproc", [2, 4])
def test_multiprocess_flags_match_single_device(nproc, mode):
    """Both data planes, 2 and 4 processes, the process group from
    explicit kwargs."""
    _check(_launch(nproc, mode, timeout=300), nproc, mode)
