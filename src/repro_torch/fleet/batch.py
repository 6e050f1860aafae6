"""Batching T independent problems into one tenant-major program.

Three pieces live here:

  * :class:`FleetProblem` / :func:`bucket_key` -- the admission unit and
    the shape-bucket rule.  Problems whose *padded* grid shapes agree
    (same loss, same ``ceil_to(n, P)``, same ``ceil_to(m, P*Q)``) pack
    into one batch.  The bucket key uses the natural padded shapes of the
    solver framework, so a tenant's block extents (``n_p``, ``m_q``) --
    and with them every index draw -- are identical inside the fleet and
    in a solo :meth:`~repro_torch.core.solver.Solver.solve` of the same
    problem.
  * :func:`stack_grid` / :func:`named_axes` -- where the tenant axis
    lands in the packed tensors: right after the grid axes an array
    varies over (its dim spec), so the (P, Q) grid stays the leading pair
    of every payload the collectives reduce, and the solver kernels take
    all T x P x Q cells of an outer step in one launch.
  * :func:`fleet_cell_program` -- wraps a solver's ``per_problem=True``
    cell program (which already runs every tenant at once) with the
    ``active`` mask that freezes converged tenants exactly;
    :func:`tenant_cell_program` builds it for a solver by name (the
    ``make_cell`` a rank of a process grid resolves), and
    :func:`admm_setup_tenants` factors every tenant's ADMM normal matrix
    on a rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.admm import admm_cell_program, admm_factor, admm_gram
from repro_torch.core.comm import ProcessWire
from repro_torch.core.d3ca import d3ca_cell_program
from repro_torch.core.engines import CellProgram
from repro_torch.core.partition import _ceil_to
from repro_torch.core.radisa import radisa_cell_program
from repro_torch.core.sfk import sfk_cell_program


@dataclasses.dataclass(frozen=True)
class FleetProblem:
    """One tenant's problem: data, loss, regularizer, seed.

    ``lam`` and ``seed`` are per tenant (they ride through the packed
    arrays and the tenant's index source); every other solver knob comes
    from the shared config of the batch.  ``f_star`` (optional) enables
    the per-tenant ``rel_opt`` history field and rel-opt early stopping,
    as in :meth:`repro_torch.core.solver.Solver.solve`.
    ``index_source`` (optional) replaces the tenant's default source, a
    ``GeneratorIndexSource`` seeded from ``seed`` -- how a caller feeds a
    tenant another implementation's exact coordinate orders.
    """

    tenant_id: str
    loss_name: str
    X: Any                      # (n, m) array / tensor or CSRMatrix
    y: Any                      # (n,)
    lam: float
    seed: int = 0
    f_star: Optional[float] = None
    index_source: Any = None

    @property
    def n(self) -> int:
        return int(self.X.shape[0])

    @property
    def m(self) -> int:
        return int(self.X.shape[1])


def bucket_key(problem: FleetProblem, P: int, Q: int) -> Tuple:
    """Shape-bucket key: problems with equal keys pack into one batch.

    Uses the framework's natural padded shapes (rows to a multiple of P,
    features to a multiple of P*Q), so bucketing never changes a
    tenant's block extents relative to its solo solve.
    """
    return (problem.loss_name, _ceil_to(problem.n, P),
            _ceil_to(problem.m, P * Q))


def solo_config(cfg, problem: FleetProblem):
    """The config a solo ``Solver.solve`` needs to reproduce this
    tenant's fleet result: the shared config with the tenant's ``lam``
    (and ``seed``, for configs that carry one) substituted in."""
    updates = {"lam": problem.lam}
    if hasattr(cfg, "seed"):
        updates["seed"] = problem.seed
    return dataclasses.replace(cfg, **updates)


# ---------------------------------------------------------------------------
# the tenant axis
# ---------------------------------------------------------------------------

def named_axes(ds) -> int:
    """Number of grid axes a dim spec names: where its tenant axis goes."""
    return sum(1 for e in tuple(ds) if e is not None)


def stack_grid(arrs, ds) -> torch.Tensor:
    """Stack per-tenant blocked tensors on the tenant axis, right after
    the grid axes of the dim spec ``ds`` (``("data", "model")`` for the
    blocks, ``("data",)`` for row vectors, ``("model",)`` for the primal
    blocks, ``()`` for per-tenant scalars).  The result is contiguous."""
    return torch.stack(list(arrs), dim=named_axes(ds))


def _freeze(active, new, old, ds):
    keep = (active > 0).reshape(
        [-1 if i == named_axes(ds) else 1 for i in range(new.dim())])
    return torch.where(keep, new, old)


def fleet_cell_program(base: CellProgram) -> CellProgram:
    """The fleet's program: ``base`` -- a ``per_problem=True`` cell program,
    which runs all T tenants in one pass -- behind the ``active`` mask.

    The wrapped program's data tuple is ``(active, *base data)``, where
    ``active`` ((T,) of 0/1) freezes converged tenants exactly: a frozen
    tenant's state is carried through ``torch.where`` untouched, bit for
    bit, while its lanes keep feeding the shared collectives and kernel
    launches (harmlessly -- the where discards the result).  All T
    tenants share ONE round of every declared collective and one launch
    of every kernel per outer step.
    """
    specs = base.state_specs
    single = isinstance(specs[0], str)

    def cell(comm, t, data, state):
        active, *inner = data
        out = base.cell(comm, t, tuple(inner), state)
        if single:
            return _freeze(active, out, state, specs)
        return tuple(_freeze(active, o, s, ds)
                     for o, s, ds in zip(out, state, specs))

    def payload_shapes(data, state):
        return base.payload_shapes(tuple(data[1:]), state)

    return CellProgram(base.schedule, cell, state_specs=specs,
                       payload_shapes=payload_shapes)


def tenant_cell_program(*, solver: str, loss, cfg, n: int, m_q: int,
                        sparse: bool, local_backend: str = "kernel",
                        index_source=None) -> CellProgram:
    """The fleet's program of ``solver`` (``d3ca | radisa | sfk |
    admm``): its ``per_problem=True`` cell program behind
    :func:`fleet_cell_program`.  ``index_source`` is the tenants' streams
    (a :class:`~repro_torch.core.indices.TenantIndexSource`, or a rank's
    cell of one); ADMM draws none.  A process grid's ranks build it from
    the path ``"repro_torch.fleet.batch:tenant_cell_program"``."""
    kw = dict(n=n, m_q=m_q, sparse=sparse, per_problem=True)
    if solver == "admm":
        base = admm_cell_program(loss.name, cfg, **kw)
    else:
        make = {"d3ca": d3ca_cell_program, "radisa": radisa_cell_program,
                "sfk": sfk_cell_program}[solver]
        base = make(loss, cfg, index_source=index_source,
                    local_backend=local_backend, **kw)
    return fleet_cell_program(base)


def admm_setup_tenants(ctx, data, *, cfg, lams, m_q: int, sparse: bool):
    """A rank's ADMM setup for a fleet on a process grid: for each tenant
    t, its cell's A^T A summed over the rank's column of the grid (an
    all-reduce over the "data" group) and factored with that tenant's
    ``lams[t]`` -- the per-tenant counterpart of
    ``core/admm.py::admm_setup_distributed``.  ``data`` is the rank's
    ``(active, *x_parts, y, mask, n)``; returns it with the factors
    ``chol (1, T, m_q, m_q)`` before ``n``, the layout the fleet's ADMM
    program reads."""
    active, *x_parts, y, mask, n_t = data
    wire = ProcessWire(ctx)
    chols = []
    for t, lam in enumerate(lams):
        gram = admm_gram(tuple(x[:, :, t] for x in x_parts), m_q, sparse)
        chols.append(admm_factor(wire.all_reduce(gram, "data"),
                                 dataclasses.replace(cfg, lam=lam)))
    return (active, *x_parts, y, mask, torch.stack(chols, dim=1), n_t)
