"""Multi-process runs of the partition mesh, and the fleet identity of a
process: the port's twin of the JAX package's ``parallel/multihost.py``.

Partitions never talk to each other during the stream, so the only
cross-process traffic is the end-of-run drift vote's counts (an
``all_reduce``) and the compacted flag tables (an ``all_gather``): a few KB
on CPU tensors. The control plane is ``torch.distributed`` with the
``gloo`` backend, which works on any machine, one with a single card
included. The same program runs in every process::

    from distributed_drift_detection_tpu_torch.parallel import multihost

    multihost.initialize()                 # torchrun's env, or explicit kwargs
    mesh = multihost.global_mesh()         # every process's cards, process-major
    batches = stripe_partitions(stream, partitions, per_batch)
    sl = multihost.host_partition_slice(partitions, mesh)
    local, lkeys = multihost.local_stripe(batches, keys, sl)
    db, dk = multihost.shard_batches_global(local, lkeys, mesh, partitions)
    out = make_mesh_runner(model, ddm, mesh, ...)(db)   # vote and table global

Each process feeds only its own partitions, and keeps its own rows of the
flag plane (``MeshRunResult.packed``); the vote and the compacted table are
the whole run's in every process.

The JAX package asks its distributed runtime first and its backend next;
the port has no backend to probe. It reads the launcher's environment in
the JAX package's order (:data:`_RANK_ENV`, :data:`_WORLD_ENV`), then
``torch.distributed`` when a process group is already up, and falls back
to the single-process identity ``(0, 1)``. Without a launcher and a
process group both packages give ``(0, 1)``. torch is consulted only if
this process already imported it, so the scheduler, which imports no
torch, stays without it.
"""

from __future__ import annotations

import os
import socket
import sys

# Launcher rank/world-size variables, most specific first (the JAX
# package's own convention, then the SLURM and OpenMPI ones).
_RANK_ENV = ("JAX_PROCESS_ID", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
_WORLD_ENV = ("JAX_PROCESS_COUNT", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")


def _env_int(names) -> "int | None":
    for var in names:
        val = os.environ.get(var, "")
        if val.strip().isdigit():
            return int(val)
    return None


def _torch_distributed() -> "tuple[int, int] | None":
    """``(rank, world size)`` of an initialised ``torch.distributed``
    process group, else ``None``."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return int(dist.get_rank()), int(dist.get_world_size())


def _multiprocess_signalled() -> bool:
    """Whether a launcher asked for a multi-process run: torchrun's
    ``MASTER_ADDR`` with ``WORLD_SIZE`` above 1. A rank variable alone
    (``SLURM_PROCID``/``SLURM_NTASKS``) is identity, not a signal."""
    world = os.environ.get("WORLD_SIZE", "").strip()
    return bool(os.environ.get("MASTER_ADDR")) and world.isdigit() and int(world) > 1


def initialize(**kwargs) -> None:
    """Start the control plane: a ``gloo`` process group (JAX
    ``initialize``). With explicit kwargs (``coordinator_address``
    ``host:port``, ``num_processes``, ``process_id``, the JAX package's
    names) or the launcher's signal (:func:`_multiprocess_signalled`, then
    ``env://``) it initializes and its errors propagate — a misconfigured
    launch fails loudly, not as N single-process runs. With neither it is a
    no-op: the single process is the whole cluster. A second call is a
    no-op."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return
    if not kwargs and not _multiprocess_signalled():
        return
    if kwargs:
        dist.init_process_group(
            "gloo",
            init_method=f"tcp://{kwargs['coordinator_address']}",
            world_size=int(kwargs["num_processes"]),
            rank=int(kwargs["process_id"]),
        )
    else:
        dist.init_process_group("gloo", init_method="env://")


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return (_torch_distributed() or (0, 1))[0]


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return (_torch_distributed() or (0, 1))[1]


def global_mesh(tenant_devices: int = 0, devices="cuda"):
    """The partition mesh over every process's devices, process-major (JAX
    ``global_mesh``): each process contributes ``devices``
    (``device.resolve_devices``: every visible card by default; ``"cpu"``
    or a list for a CPU run), 2-D ``(tenants, partitions)`` when
    ``tenant_devices > 1``. A process's shards are a contiguous range, so
    :func:`host_partition_slice` is its rows of the plane."""
    from ..device import resolve_devices
    from .mesh import PARTITION_AXIS, TENANT_AXIS, Mesh

    local = [str(d) for d in resolve_devices(devices)]
    rank, world = process_index(), process_count()
    if world > 1:
        import torch.distributed as dist

        every = [None] * world
        dist.all_gather_object(every, local)
    else:
        every = [local]
    flat = [d for names in every for d in names]
    owner = [r for r, names in enumerate(every) for _ in names]
    if tenant_devices and tenant_devices > 1:
        if len(flat) % tenant_devices:
            raise ValueError(
                f"{len(flat)} device(s) do not split into a "
                f"{tenant_devices}-row tenant axis"
            )
        return Mesh(flat, (TENANT_AXIS, PARTITION_AXIS), owner, rank).reshape(
            tenant_devices, -1)
    return Mesh(flat, (PARTITION_AXIS,), owner, rank)


def host_partition_slice(partitions: int, mesh) -> slice:
    """The contiguous range of partition indices this process feeds: its
    shards' rows of the plane (JAX ``host_partition_slice``)."""
    n = mesh.size
    if partitions % n:
        raise ValueError(f"{partitions} partitions not divisible by {n} devices")
    per_dev = partitions // n
    local = mesh.local_shards()
    if not local:
        return slice(0, 0)
    if local != list(range(local[0], local[0] + len(local))):
        raise ValueError("host's devices are not contiguous in the mesh")
    return slice(local[0] * per_dev, (local[-1] + 1) * per_dev)


def local_stripe(batches, keys, sl: slice):
    """This process's partitions of host-striped arrays: the plane-major
    leaves and the keys cut to ``sl``; a packed stream's row table is
    shared, so it passes through whole."""
    from ..engine.loop import Batches, PackedIndexedBatches

    cut = None if keys is None else keys[sl]
    if isinstance(batches, PackedIndexedBatches):
        return batches._replace(idx=batches.idx[sl], perm=batches.perm[sl]), cut
    return Batches(*(leaf[sl] for leaf in batches)), cut


def shard_batches_global(batches, keys, mesh, partitions: "int | None" = None):
    """Multi-process upload: each process places only its own stripe (cut
    with :func:`host_partition_slice` and :func:`local_stripe`) on its own
    shards. ``partitions`` is the whole plane's rows (default: the stripe's
    times the mesh's devices over this process's). In one process this is
    ``parallel.mesh.shard_batches``."""
    from ..engine.loop import PackedIndexedBatches
    from .mesh import shard_batches

    if mesh.process_count == 1:
        return shard_batches(batches, keys, mesh)
    if partitions is None:
        n_local = len(mesh.local_shards())
        if n_local == 0:
            raise ValueError(
                "this process addresses no devices in the mesh; pass the "
                "global `partitions` count explicitly"
            )
        plane = batches.idx if isinstance(batches, PackedIndexedBatches) else batches.y
        partitions = int(plane.shape[0]) * mesh.size // n_local
    return shard_batches(batches, keys, mesh, partitions=partitions)


def all_reduce_counts(count):
    """The sum over processes of a count tensor (the drift vote's changed
    partitions a step), on its device."""
    import torch.distributed as dist

    host = count.cpu()
    dist.all_reduce(host)
    return host.to(count.device)


def all_gather_tables(table) -> list:
    """Every process's compacted table, in process order, on ``table``'s
    device."""
    import torch
    import torch.distributed as dist

    host = table.cpu()
    out = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(out, host)
    return [t.to(table.device) for t in out]


def host_identity() -> dict:
    """This process's fleet identity: ``{hostname, process_index,
    process_count}`` — the ``run_started`` extras that name a process's
    run log among its siblings'."""
    rank, world = _env_int(_RANK_ENV), _env_int(_WORLD_ENV)
    if rank is None and world is None:
        rank, world = _torch_distributed() or (None, None)
    return {
        "hostname": socket.gethostname(),
        "process_index": 0 if rank is None else rank,
        "process_count": 1 if world is None else world,
    }


def fleet_worker_identity() -> dict:
    """Identity extras a sweep-fleet worker agent (``sched/worker.py``)
    stamps onto its scheduler hello: :func:`host_identity` plus the pid,
    so the scheduler's worker rows and each cell's ``run_started`` extras
    name workers the same way."""
    return {**host_identity(), "pid": os.getpid()}
