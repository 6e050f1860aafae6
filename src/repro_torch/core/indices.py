"""Index sources: where the solvers' random coordinate orders come from.

The cell programs never sample by themselves; they ask an index source
for the three streams the algorithms need, per outer iteration ``t``
(1-based):

  * ``sdca_rows(t)   -> (P, steps) int32`` -- D3CA's local coordinate
    order, one per row partition p, SHARED by all q of that partition and
    sampled WITH replacement;
  * ``svrg_rows(t)   -> (P, Q, L) int32``  -- RADiSA's minibatch order,
    one per cell;
  * ``radisa_perm(t) -> (P,) int64``       -- RADiSA's shared permutation
    assigning sub-block ``perm[p]`` to row partition p.

``GeneratorIndexSource`` draws them from a ``torch.Generator`` seeded from
the solver config's seed (a device generator on a CUDA device);
``ArrayIndexSource`` replays arrays it was given, which is how a caller
reproduces another implementation's exact streams.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

_SDCA, _SVRG, _PERM = 0, 1, 2


class GeneratorIndexSource:
    """Default source.  Every stream of every iteration is drawn from the
    generator re-seeded with ``(seed, t, stream)``, so a draw depends on
    nothing but those: the same config gives the same orders whatever was
    drawn before, on a given device type."""

    def __init__(self, seed: int, *, P: int, Q: int, n_p: int,
                 steps: Optional[int] = None, L: Optional[int] = None,
                 device="cpu"):
        self.seed = int(seed)
        self.P, self.Q, self.n_p = P, Q, n_p
        self.steps = steps if steps is not None else n_p
        self.L = L if L is not None else n_p
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device)

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


class ArrayIndexSource:
    """Replays given streams.  Each argument maps the outer iteration
    ``t`` (1-based) to that iteration's array -- a dict, or a sequence /
    stacked array whose entry ``t - 1`` belongs to iteration ``t``."""

    def __init__(self, *, sdca=None, svrg=None, perm=None, device="cpu"):
        self._streams = {"sdca_rows": sdca, "svrg_rows": svrg,
                         "radisa_perm": perm}
        self.device = torch.device(device)

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
