"""The bytes a rank hands to each collective in one step of a cell,
counted from the specs (the port's counterpart of
``repro/roofline/hlo.py``, which reads them off XLA's HLO; the port has
no HLO).

A training step's come from ``launch/mesh_train.py::wire_bytes``, a
prefill or decode step's from ``launch/mesh_serve.py::serve_wire_bytes``
-- the same counts the steps' own ``WIRE`` counters read when they run
(their tests hold them equal).  They are returned in
``collective_bytes_from_hlo``'s dict shape, each kind's bytes times its
wire factor (the reference's per-op model of bytes on the wire per
participating device, ring / bidirectional, k -> inf; a copy):

    all-reduce(N)          ~ 2 N          (reduce-scatter + all-gather)
    all-gather(out N)      ~ N
    reduce-scatter(in N)   ~ N
    all-to-all(N)          ~ N
    collective-permute(N)  ~ N

The serving steps hold their parameter views across steps
(``launch/mesh_serve.py``): the one-time gather of the views is under
``once``, in the same shape, apart from the step's.
"""
from __future__ import annotations

from typing import Dict, Optional

#: bytes on the wire per byte a rank hands to each kind of collective
WIRE_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

#: ``sharding/collectives.py::WIRE``'s kinds by their HLO names
HLO_NAMES = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
             "all_reduce": "all-reduce"}


def collective_bytes(wire: Dict[str, int],
                     counts: Optional[Dict[str, int]] = None) -> dict:
    """``{"total_bytes", "by_kind_bytes", "by_kind_count"}`` of the bytes
    handed to each kind of collective (``WIRE``'s keys), each times its
    wire factor; ``counts``: the calls of each kind, where they were
    counted (``{}`` otherwise)."""
    by_kind = {}
    for kind, n in wire.items():
        if n:
            name = HLO_NAMES[kind]
            by_kind[name] = float(n) * WIRE_FACTOR[name]
    return {
        "total_bytes": float(sum(by_kind.values())),
        "by_kind_bytes": by_kind,
        "by_kind_count": {HLO_NAMES[k]: int(v)
                          for k, v in (counts or {}).items() if v},
    }


def step_collectives(model, shape, accum_steps: Optional[int] = None
                     ) -> dict:
    """The collectives of one step of cell ``shape`` (a ``ShapeConfig``)
    of a sharded model (a ``Transformer`` over a mesh: one of its ranks),
    from the specs: :func:`collective_bytes` of the step, and for prefill
    and decode the views' one-time gather under ``once``."""
    if shape.kind == "train":
        from ..launch.mesh_train import wire_bytes
        return collective_bytes(wire_bytes(model, shape.batch, shape.seq,
                                           accum_steps))
    from ..launch.mesh_serve import serve_wire_bytes
    got = serve_wire_bytes(model, shape.batch, shape.seq, shape.kind)
    out = collective_bytes(got["step"])
    out["once"] = collective_bytes(got["views"])
    return out
