"""Core: the paper's doubly distributed optimization algorithms."""
from .admm import ADMMConfig, admm_simulated, admm_simulated_program
from .comm import Collective, Comm, CommSchedule, LocalComm, SyncComm
from .comm_model import (LinkModel, Topology, as_topology, fit_link,
                         overlap_split, predict_comm_s)
from .compress import (CompressedComm, CompressionPolicy,
                       CompressionSchedule, as_compression, as_policy,
                       available_codecs, get_codec, wire_accounting)
from .d3ca import D3CAConfig, d3ca_simulated, d3ca_simulated_program
from .engines import (CellProgram, EngineProgram, drive, drive_with_callback,
                      grid_bind_state, grid_program)
from .indices import (ArrayIndexSource, GeneratorIndexSource,
                      TenantIndexSource)
from .losses import LOSSES, get_loss
from .partition import (DoublyPartitioned, SparseDoublyPartitioned,
                        ell_gather, ell_scatter_add, partition,
                        partition_sparse)
from .radisa import RADiSAConfig, radisa_simulated, radisa_simulated_program
from .reference import duality_gap, objective, rel_opt, serial_sdca
from .sfk import SFKConfig, sfk_simulated, sfk_simulated_program
from .solver import (BLOCK_FORMATS, ENGINES, SolveResult, Solver,
                     available_solvers, get_solver, register_solver)
from .local import LOCAL_BACKENDS
from .util import resolve_device

__all__ = [
    "ADMMConfig", "admm_simulated", "admm_simulated_program",
    "Collective", "Comm", "CommSchedule", "LocalComm", "SyncComm",
    "LinkModel", "Topology", "as_topology", "fit_link", "overlap_split",
    "predict_comm_s",
    "CompressedComm", "CompressionPolicy", "CompressionSchedule",
    "as_compression", "as_policy", "available_codecs",
    "get_codec", "wire_accounting",
    "D3CAConfig", "d3ca_simulated", "d3ca_simulated_program",
    "CellProgram", "EngineProgram", "drive", "drive_with_callback",
    "grid_bind_state", "grid_program",
    "ArrayIndexSource", "GeneratorIndexSource", "TenantIndexSource",
    "LOSSES", "get_loss",
    "DoublyPartitioned", "SparseDoublyPartitioned", "ell_gather",
    "ell_scatter_add", "partition", "partition_sparse",
    "RADiSAConfig", "radisa_simulated", "radisa_simulated_program",
    "duality_gap", "objective", "rel_opt", "serial_sdca",
    "SFKConfig", "sfk_simulated", "sfk_simulated_program",
    "BLOCK_FORMATS", "ENGINES", "LOCAL_BACKENDS", "SolveResult", "Solver",
    "available_solvers", "get_solver", "register_solver",
    "resolve_device",
]
