"""Multi-tenant batched solves: T independent problems, one program.

The fleet packs many independent problems of one shape (per-tenant
``(X_t, y_t, loss, lam_t, seed_t)``) into tenant-major tensors -- the
tenant axis right after the grid axes of every array -- and runs each
solver's ``per_problem=True`` cell program on them: every collective is
reduced once and every solver kernel launched once per outer step for all
T x P x Q cells, each cell reading its tenant's ``lam``, ``n`` (and
D3CA's ``beta``) from the kernel's per-cell scalars.

  * :mod:`repro_torch.fleet.batch`     -- problems, shape buckets, the
    tenant-axis stacking rule and the ``active``-mask wrapper;
  * :mod:`repro_torch.fleet.solver`    -- :class:`FleetSolver`, the
    batched drive loop with per-tenant convergence freezing and warm
    starts;
  * :mod:`repro_torch.fleet.scheduler` -- :class:`FleetScheduler`,
    admission, bucketing and per-tenant result unpacking.
"""
from .batch import (FleetProblem, bucket_key, fleet_cell_program,
                    named_axes, solo_config, stack_grid)
from .scheduler import FleetScheduler
from .solver import FLEET_ENGINES, FLEET_SOLVERS, FleetProgram, FleetSolver

__all__ = [
    "FLEET_ENGINES",
    "FLEET_SOLVERS",
    "FleetProblem",
    "FleetProgram",
    "FleetScheduler",
    "FleetSolver",
    "bucket_key",
    "fleet_cell_program",
    "named_axes",
    "solo_config",
    "stack_grid",
]
