"""Fleet identity of a process — the part of the JAX package's
``parallel/multihost.py`` the run log and the sweep scheduler read
(:func:`host_identity`, :func:`fleet_worker_identity`). The multi-host
mesh itself waits for ROADMAP A15d.

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
