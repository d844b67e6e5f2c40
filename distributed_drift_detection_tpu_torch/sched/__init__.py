"""Elastic sweep scheduler of the port: the registry-driven fleet
controller — the port's own copies of the JAX package's ``sched/``.

The reference's experimental campaign is a bash loop
(``run_experiments.sh``) walking a (multiplier × instances × memory ×
cores) grid serially, with crash recovery done by hand. Here the sweep is
data (a sweep-spec JSON), the run registry is the durable work ledger, and
cells are leased to worker processes that each run exactly once:

* :mod:`.scheduler` — the **scheduler daemon**: expands a spec into cells
  (the exact ``grid_configs`` expansion ``heal`` diffs), pre-completes
  what the registry shows done, grants heartbeat-refreshed **leases** over
  a TCP control protocol, revokes the leases of dead or wedged workers and
  re-leases their cells until every cell completed exactly once.
* :mod:`.worker` — the **worker agent** (``python -m
  distributed_drift_detection_tpu_torch sched-worker``): leases cells,
  runs each under ``resilience.supervisor`` on the card (``--device``),
  heartbeats while a cell runs, and reports done/fail.
* :mod:`.protocol` — the newline-JSON wire contract both sides speak (and
  ``heal --scheduler`` submits plans through); the JAX package's, byte for
  byte.
* :mod:`.leases` — the pure lease/queue state machine + the exactly-once
  registry audit.

Everything but the worker's cell execution imports no torch.
"""

from .leases import Cell, CellQueue, audit_exactly_once  # noqa: F401
from .protocol import ControlClient, cell_from_wire, cell_to_wire  # noqa: F401
