"""Index sources: where the solvers' random coordinate orders come from.

The cell programs never sample by themselves; they ask an index source
for the four streams the algorithms need, per outer iteration ``t``
(1-based):

  * ``sdca_rows(t)   -> (P, steps) int32`` -- D3CA's local coordinate
    order, one per row partition p, SHARED by all q of that partition and
    sampled WITH replacement;
  * ``svrg_rows(t)   -> (P, Q, L) int32``  -- RADiSA's minibatch order,
    one per cell;
  * ``radisa_perm(t) -> (P,) int64``       -- RADiSA's (and SFK's) shared
    permutation assigning sub-block ``perm[p]`` to row partition p;
  * ``sfk_sample(t)  -> (P, n_p) float32`` -- SFK's Bernoulli row sample,
    1.0 for a sampled row, one per row partition p, SHARED by all q of
    that partition.

``GeneratorIndexSource`` draws them from a ``torch.Generator`` seeded from
the solver config's seed (a device generator on a CUDA device);
``ArrayIndexSource`` replays arrays it was given, which is how a caller
reproduces another implementation's exact streams; ``TenantIndexSource``
stacks one source per tenant on the tenant axis of the fleet path;
``CellIndexSource`` is one cell's view of a whole-grid source, for a rank
of a process grid (``repro_torch.launch.mesh``), which draws exactly what
that cell of the grid engine consumes -- of a ``TenantIndexSource`` too,
whose streams keep the grid axes first, so a rank of a fleet on the mesh
draws what cell (p, q) of every tenant draws in the grid-engine fleet.
"""
from __future__ import annotations

import copy
from typing import Mapping, Optional

import torch

from ..kernels._launch import TENANT_AXES
from .util import resolve_device

_SDCA, _SVRG, _PERM, _SAMPLE = 0, 1, 2, 3


class GeneratorIndexSource:
    """Default source.  Every stream of every iteration is drawn from the
    generator re-seeded with ``(seed, t, stream)``, so a draw depends on
    nothing but those: the same config gives the same orders whatever was
    drawn before, on a given device type."""

    def __init__(self, seed: int, *, P: int, Q: int, n_p: int,
                 steps: Optional[int] = None, L: Optional[int] = None,
                 sample_frac: float = 0.5, device="cuda"):
        self.seed = int(seed)
        self.P, self.Q, self.n_p = P, Q, n_p
        self.steps = steps if steps is not None else n_p
        self.L = L if L is not None else n_p
        self.sample_frac = float(sample_frac)
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device)

    def __getstate__(self):
        # a generator is re-made, not sent: every draw re-seeds it anyway
        state = dict(self.__dict__)
        del state["_gen"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._gen = torch.Generator(device=self.device)

    def to(self, device) -> "GeneratorIndexSource":
        """The same streams drawn on ``device`` (a copy)."""
        return GeneratorIndexSource(
            self.seed, P=self.P, Q=self.Q, n_p=self.n_p, steps=self.steps,
            L=self.L, sample_frac=self.sample_frac, device=device)

    def _reseed(self, t: int, stream: int) -> torch.Generator:
        self._gen.manual_seed((self.seed * 1_000_003 + int(t)) * 4 + stream)
        return self._gen

    def sdca_rows(self, t: int) -> torch.Tensor:
        return torch.randint(0, self.n_p, (self.P, self.steps),
                             generator=self._reseed(t, _SDCA),
                             device=self.device, dtype=torch.int32)

    def svrg_rows(self, t: int) -> torch.Tensor:
        return torch.randint(0, self.n_p, (self.P, self.Q, self.L),
                             generator=self._reseed(t, _SVRG),
                             device=self.device, dtype=torch.int32)

    def radisa_perm(self, t: int) -> torch.Tensor:
        return torch.randperm(self.P, generator=self._reseed(t, _PERM),
                              device=self.device)

    def sfk_sample(self, t: int) -> torch.Tensor:
        u = torch.rand((self.P, self.n_p), generator=self._reseed(t, _SAMPLE),
                       device=self.device)
        return (u < self.sample_frac).to(torch.float32)


class ArrayIndexSource:
    """Replays given streams.  Each argument maps the outer iteration
    ``t`` (1-based) to that iteration's array -- a dict, or a sequence /
    stacked array whose entry ``t - 1`` belongs to iteration ``t``."""

    def __init__(self, *, sdca=None, svrg=None, perm=None, sample=None,
                 device="cuda"):
        self._streams = {"sdca_rows": sdca, "svrg_rows": svrg,
                         "radisa_perm": perm, "sfk_sample": sample}
        self.device = resolve_device(device)

    def to(self, device) -> "ArrayIndexSource":
        """The same streams, returned on ``device`` (a copy)."""
        out = copy.copy(self)
        out.device = resolve_device(device)
        return out

    def _get(self, name: str, t: int, dtype) -> torch.Tensor:
        stream = self._streams[name]
        if stream is None:
            raise KeyError(f"this ArrayIndexSource was given no {name} "
                           "stream")
        try:
            arr = stream[t] if isinstance(stream, Mapping) else stream[t - 1]
        except (KeyError, IndexError):
            raise KeyError(f"{name}: no array for outer iteration "
                           f"t={t}") from None
        return torch.as_tensor(arr, device=self.device).to(dtype).contiguous()

    def sdca_rows(self, t: int) -> torch.Tensor:
        return self._get("sdca_rows", t, torch.int32)

    def svrg_rows(self, t: int) -> torch.Tensor:
        return self._get("svrg_rows", t, torch.int32)

    def radisa_perm(self, t: int) -> torch.Tensor:
        return self._get("radisa_perm", t, torch.int64)

    def sfk_sample(self, t: int) -> torch.Tensor:
        return self._get("sfk_sample", t, torch.float32)


class TenantIndexSource:
    """T per-tenant sources as one: every stream of every tenant, stacked
    on the tenant axis right after the grid axes the stream varies over
    -- ``sdca_rows -> (P, T, steps)``, ``svrg_rows -> (P, Q, T, L)``,
    ``radisa_perm -> (P, T)``, ``sfk_sample -> (P, T, n_p)`` -- so each
    tenant of a fleet draws exactly what its solo solve draws."""

    # each stream takes the tenant axis of the kernel argument it becomes
    # (the SFK sample multiplies the row mask)
    _AXIS = {"sdca_rows": TENANT_AXES["sdca_epoch"]["idx"],
             "svrg_rows": TENANT_AXES["svrg_inner"]["idx"],
             "radisa_perm": TENANT_AXES["svrg_inner"]["lo"],
             "sfk_sample": TENANT_AXES["svrg_inner"]["mask"]}

    def __init__(self, sources):
        self.sources = list(sources)

    def to(self, device) -> "TenantIndexSource":
        """The same streams drawn on ``device`` (every tenant's source
        moved; a copy) -- what a rank of a process grid draws from, cut
        to its cell by :class:`CellIndexSource`."""
        return TenantIndexSource([s.to(device) for s in self.sources])

    def _stack(self, name: str, t: int) -> torch.Tensor:
        return torch.stack([getattr(s, name)(t) for s in self.sources],
                           dim=self._AXIS[name])

    def sdca_rows(self, t: int) -> torch.Tensor:
        return self._stack("sdca_rows", t)

    def svrg_rows(self, t: int) -> torch.Tensor:
        return self._stack("svrg_rows", t)

    def radisa_perm(self, t: int) -> torch.Tensor:
        return self._stack("radisa_perm", t)

    def sfk_sample(self, t: int) -> torch.Tensor:
        return self._stack("sfk_sample", t)


class CellIndexSource:
    """Cell (p, q)'s view of a whole-grid source: each stream keeps the
    grid axes it varies over, cut to that cell -- ``sdca_rows -> (1,
    steps)``, ``svrg_rows -> (1, 1, L)``, ``radisa_perm -> (1,)``,
    ``sfk_sample -> (1, n_p)`` -- so a rank holding that one cell
    consumes exactly what the grid engine's cell (p, q) consumes.  The
    whole source is drawn on ``device`` and cut."""

    def __init__(self, source, p: int, q: int, device="cuda"):
        self.source = source.to(device)
        self.p, self.q = int(p), int(q)

    def sdca_rows(self, t: int) -> torch.Tensor:
        return self.source.sdca_rows(t)[self.p:self.p + 1].contiguous()

    def svrg_rows(self, t: int) -> torch.Tensor:
        return self.source.svrg_rows(t)[self.p:self.p + 1,
                                        self.q:self.q + 1].contiguous()

    def radisa_perm(self, t: int) -> torch.Tensor:
        return self.source.radisa_perm(t)[self.p:self.p + 1].contiguous()

    def sfk_sample(self, t: int) -> torch.Tensor:
        return self.source.sfk_sample(t)[self.p:self.p + 1].contiguous()
