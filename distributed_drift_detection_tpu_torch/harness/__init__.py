"""The paper's experiment loop on the port: the resumable sweep grid
(:mod:`.grid`) and the delay-parity harness (:mod:`.parity`). The JAX
package's ``aggregate`` and ``plots`` read only the results CSV, which the
port writes in the same schema, so they are not copied."""

from .grid import grid_configs, missing_configs, off_spec_reason, run_grid

__all__ = ["grid_configs", "missing_configs", "off_spec_reason", "run_grid"]
