"""Core: the paper's doubly distributed optimization algorithms."""
from .comm import Collective, Comm, CommSchedule, SyncComm
from .d3ca import D3CAConfig, d3ca_simulated, d3ca_simulated_program
from .engines import (CellProgram, EngineProgram, drive, drive_with_callback,
                      grid_program)
from .indices import ArrayIndexSource, GeneratorIndexSource
from .losses import LOSSES, get_loss
from .partition import DoublyPartitioned, partition
from .radisa import RADiSAConfig, radisa_simulated, radisa_simulated_program
from .reference import duality_gap, objective, rel_opt, serial_sdca
from .solver import (BLOCK_FORMATS, ENGINES, SolveResult, Solver,
                     available_solvers, get_solver, register_solver)
from .local import LOCAL_BACKENDS
from .util import resolve_device

__all__ = [
    "Collective", "Comm", "CommSchedule", "SyncComm",
    "D3CAConfig", "d3ca_simulated", "d3ca_simulated_program",
    "CellProgram", "EngineProgram", "drive", "drive_with_callback",
    "grid_program",
    "ArrayIndexSource", "GeneratorIndexSource",
    "LOSSES", "get_loss",
    "DoublyPartitioned", "partition",
    "RADiSAConfig", "radisa_simulated", "radisa_simulated_program",
    "duality_gap", "objective", "rel_opt", "serial_sdca",
    "BLOCK_FORMATS", "ENGINES", "LOCAL_BACKENDS", "SolveResult", "Solver",
    "available_solvers", "get_solver", "register_solver",
    "resolve_device",
]
