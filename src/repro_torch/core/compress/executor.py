"""CompressedComm: a Comm executor that compresses collective payloads.

Wraps a :class:`~repro_torch.core.comm.SyncComm` or one of its
bounded-staleness subclasses (:class:`~repro_torch.core.comm.StaleComm`,
:class:`~repro_torch.core.comm.OverlapComm`): every cell's contribution
is encoded/decoded by the collective's codec *before* the inner executor
reduces it -- the order a real bandwidth-saving all-reduce imposes
(quantize, put on the wire, reduce) -- so the residual of a step belongs
to the payload that step dispatched, whenever the inner executor
consumes the reduction.  The payload is blocked ``(P', Q', *cell)`` (all
cells on the grid engine, the rank's one cell on a process grid) and the
codec codes each cell on its own (one scale or one top-k per cell).

Error feedback: each stateful codec's residual enters through ``ef``
(one ``(P', Q', *cell)`` f32 buffer per compressed collective, carried
in the engine state) and the updated residuals come back out via
:attr:`CompressedComm.ef_out`.

Wire accounting: every Comm executor records the exact payload bytes one
cell put on the wire per collective in ``.wire_bytes`` (the base class
records the uncompressed size; this class records the codec's payload
size).  :func:`wire_accounting` computes the same numbers from a schedule
and the per-cell payload shapes -- that is what the engine attaches to
``EngineProgram.comm_bytes`` and what surfaces in the solver history.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..comm import Comm, CommSchedule
from .codecs import IdentityCodec, dtype_itemsize, dtype_name
from .policy import CompressionPolicy


class CompressedComm(Comm):
    """Compress each declared collective's payload per its policy codec,
    then delegate the actual reduction to the wrapped executor."""

    def __init__(self, inner: Comm, policy: CompressionPolicy,
                 ef: Optional[dict] = None):
        super().__init__(inner.schedule, inner.sizes, device=inner.device,
                         payload_shapes=inner.payload_shapes,
                         wire=inner.wire)
        self.inner = inner
        self.policy = policy
        self.ef_in = dict(ef or {})
        #: updated error-feedback residuals, one per stateful collective
        self.ef_out: Dict[str, torch.Tensor] = {}

    def axis_index(self, axis: str):
        return self.inner.axis_index(axis)

    def axis_size(self, axis: str) -> int:
        return self.inner.axis_size(axis)

    def _exec(self, point, value):
        codec = self.policy.codec_for(point.name)
        self.wire_bytes[point.name] = codec.payload_nbytes(
            tuple(value.shape[2:]), value.dtype)
        if codec.stateful:
            if point.name not in self.ef_in:
                raise KeyError(f"no error-feedback residual for compressed "
                               f"collective {point.name!r}: the engine "
                               f"state carries {sorted(self.ef_in)}")
            deq, new_err = codec.apply(value, self.ef_in[point.name])
            self.ef_out[point.name] = new_err
            deq = deq.to(value.dtype)
        else:
            deq, _ = codec.apply(value)
        return self.inner._exec(point, deq)

    def finalize(self):
        super().finalize()
        self.inner._executed = set(self._executed)
        self.inner.finalize()
        missing = (set(self.policy.stateful_names(self.schedule))
                   - set(self.ef_out))
        if missing:
            raise ValueError(
                f"error-feedback residuals never produced for compressed "
                f"collectives {sorted(missing)}")


# ---------------------------------------------------------------------------
# exact bytes-on-wire accounting
# ---------------------------------------------------------------------------

#: the dtype of every collective payload of the four solvers
PAYLOAD_DTYPE = torch.float32


def wire_accounting(schedule: CommSchedule, payload_shapes: dict,
                    sizes: dict,
                    policy: Optional[CompressionPolicy] = None) -> dict:
    """Exact per-step wire cost of one outer iteration.

    Every cell of the P x Q grid contributes one payload to each declared
    collective per step (psum/pmean/allgather alike), so a collective
    moves ``P * Q * payload_bytes`` per step; the codec decides the
    payload layout.  ``payload_shapes`` maps collective name to the
    per-cell *input* shape (what one cell hands to ``comm``, without the
    grid axes; float32); ``sizes`` holds the logical grid extents.
    Returns::

        {"collectives": {name: {op, axis, codec, payload_shape,
                                payload_dtype, payload_bytes_per_cell,
                                uncompressed_bytes_per_cell, cells,
                                bytes_per_step,
                                uncompressed_bytes_per_step}},
         "bytes_per_step": ...,            # sum over collectives
         "uncompressed_bytes_per_step": ...,
         "compression": <policy spec or None>}

    With no policy (or the identity codec) ``bytes_per_step`` equals
    ``uncompressed_bytes_per_step`` exactly.
    """
    identity = IdentityCodec()
    cells = int(sizes["data"]) * int(sizes["model"])
    per = {}
    total = 0
    total_raw = 0
    for point in schedule:
        shape = tuple(int(d) for d in payload_shapes[point.name])
        codec = policy.codec_for(point.name) if policy is not None \
            else identity
        raw = math.prod(shape) * dtype_itemsize(PAYLOAD_DTYPE)
        comp = codec.payload_nbytes(shape, PAYLOAD_DTYPE)
        per[point.name] = {
            "op": point.op, "axis": point.axis, "codec": codec.name,
            "payload_shape": shape,
            "payload_dtype": dtype_name(PAYLOAD_DTYPE),
            "payload_bytes_per_cell": int(comp),
            "uncompressed_bytes_per_cell": int(raw),
            "cells": cells,
            "bytes_per_step": int(comp) * cells,
            "uncompressed_bytes_per_step": int(raw) * cells,
        }
        total += int(comp) * cells
        total_raw += int(raw) * cells
    return {"collectives": per,
            "bytes_per_step": total,
            "uncompressed_bytes_per_step": total_raw,
            "compression": policy.spec if policy is not None else None}
