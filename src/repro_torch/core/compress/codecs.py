"""Compression codecs for cross-cell reductions.

A *codec* turns the payload of one declared collective (see
``repro_torch.core.comm.CommSchedule``) into a smaller wire
representation and back.  The solvers never see the codec: the
:class:`~repro_torch.core.compress.executor.CompressedComm` executor
encodes every cell's contribution, immediately decodes it, and hands the
(lossy) result to the underlying ``SyncComm`` -- which is what a
bandwidth-saving all-reduce does semantically, since the reduction itself
operates on dequantized values.

**A codec acts on a blocked payload.**  On the grid engine every cell's
payload arrives at once, as one tensor ``(A, B, *cell)`` whose two
leading axes enumerate the cells (``(P, Q)`` for a policy codec, ``(G,
Q)`` -- pods by feature blocks -- for the cross-pod codec of a
hierarchical reduction).  Each cell is coded on its own, exactly as one
device would code its payload: int8 and fp8 take one scale per cell (the
max-abs over the trailing axes), top-k one ``torch.topk`` per cell over
the flattened trailing axes -- one call for all cells, never a loop.

Lossy codecs carry **error feedback** (Seide et al. 2014, Karimireddy et
al. 2019): the quantization residual of step t is added to the payload
of step t+1, so the *accumulated* communicated signal tracks the true
accumulated signal.  The residual is one float32 buffer per (cell,
collective), carried in the engine state on the solver's device.

Codecs:

  * ``identity``  -- no-op; ``apply`` returns the input tensor object
    unchanged, so an identity-codec run is bit-identical to an
    uncompressed one;
  * ``int8``      -- symmetric quantization to int8 with one float32
    scale per cell (max-abs / 127), ~4x fewer wire bytes than f32;
  * ``fp8``       -- a float8 (e4m3) cast with one float32 scale per
    cell; the same 1-byte payload as int8, a relative error profile;
  * ``topk:FRAC`` -- magnitude top-k sparsification: the largest
    ``ceil(FRAC * size)`` entries of each cell travel as (value, index)
    pairs.

``payload_nbytes(shape, dtype)`` is exact arithmetic over one cell's
payload layout (``shape`` is the per-cell shape), so the wire accounting
of :func:`~repro_torch.core.compress.executor.wire_accounting` is exact:
the identity codec reports precisely the uncompressed payload bytes.

No codec syncs with the host: scales stay device tensors.

The tree-level int8 helpers :func:`init_error` / :func:`compress` /
:func:`decompress` keep the legacy numerics (one scale per leaf).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..util import resolve_device

FP8_E4M3_MAX = 448.0
_FP8_DTYPE = getattr(torch, "float8_e4m3fn", None)

#: leading axes of a blocked payload that enumerate its cells
CELL_AXES = 2


def dtype_itemsize(dtype) -> int:
    """Bytes per element of a torch dtype, or of anything numpy names
    (``"float32"``, ``np.int8``)."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def dtype_name(dtype) -> str:
    """``"float32"`` for ``torch.float32`` as for ``np.float32``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _cells(t: torch.Tensor) -> torch.Tensor:
    """``(A, B, *cell) -> (A, B, size)``: each cell flattened."""
    return t.reshape(*t.shape[:CELL_AXES], -1)


def _per_cell(scale: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-cell ``(A, B)`` tensor shaped to broadcast over the cells."""
    return scale.reshape(*scale.shape, *([1] * (ndim - CELL_AXES)))


def _cell_scale(t: torch.Tensor, qmax: float) -> torch.Tensor:
    """``max|t| / qmax + 1e-12`` of every cell, float32 ``(A, B)``."""
    return _cells(t).abs().amax(dim=-1) / qmax + 1e-12


class Codec:
    """One compression scheme for a collective's blocked payload.

    ``encode(value) -> payload`` (tuple of tensors, the wire format of
    every cell), ``decode(payload, shape) -> value``-shaped dequantized
    tensor (``shape`` is the blocked shape), and ``apply(value, err)``
    fuses encode/decode with error feedback: returns ``(dequantized,
    new_err)`` where ``new_err`` is ``None`` for stateless codecs.
    ``payload_nbytes(shape, dtype)`` is the exact wire size of ONE
    cell's payload of per-cell ``shape``, computed arithmetically.
    """

    name: str = "?"
    #: True when the codec is lossy and carries an error-feedback
    #: residual (one f32 buffer per cell per collective)
    stateful: bool = False

    def encode(self, value):
        raise NotImplementedError

    def decode(self, payload, shape):
        raise NotImplementedError

    def payload_nbytes(self, shape, dtype) -> int:
        raise NotImplementedError

    def init_state(self, shape, device="cuda"):
        """Zero error-feedback residual of a blocked payload ``shape``."""
        return torch.zeros(shape, dtype=torch.float32,
                           device=resolve_device(device))

    def apply(self, value, err=None):
        if not self.stateful:
            return self.decode(self.encode(value), value.shape), None
        t = value.to(torch.float32) + (0.0 if err is None else err)
        deq = self.decode(self.encode(t), value.shape)
        return deq, t - deq

    def __repr__(self):
        return f"<codec {self.name}>"


class IdentityCodec(Codec):
    """Exact passthrough; reports the uncompressed payload bytes."""

    name = "identity"
    stateful = False

    def encode(self, value):
        return (value,)

    def decode(self, payload, shape):
        return payload[0]

    def apply(self, value, err=None):
        # return the input tensor OBJECT: an identity-codec run reduces
        # the very tensor an uncompressed run reduces (bit-identical)
        return value, None

    def payload_nbytes(self, shape, dtype) -> int:
        return math.prod(shape) * dtype_itemsize(dtype)


class Int8Codec(Codec):
    """Symmetric int8 quantization with one f32 scale per cell.

    ``scale = max|t| / 127 + 1e-12`` (the legacy formula); codes are
    ``clip(round(t / scale), -127, 127)`` with round-half-to-even and a
    true division.  Wire payload per cell: ``size`` int8 values + 4
    scale bytes.
    """

    name = "int8"
    stateful = True

    def encode(self, value):
        t = value.to(torch.float32)
        scale = _cell_scale(t, 127.0)
        q = torch.clamp(torch.round(t / _per_cell(scale, t.ndim)),
                        -127, 127).to(torch.int8)
        return q, scale

    def decode(self, payload, shape):
        q, scale = payload
        return q.to(torch.float32) * _per_cell(scale, q.ndim)

    def payload_nbytes(self, shape, dtype) -> int:
        return math.prod(shape) * 1 + 4          # int8 payload + f32 scale


class Fp8Codec(Codec):
    """float8 (e4m3) quantization with one f32 scale per cell.

    Each cell is scaled into the e4m3 range (``max|t| / 448 + 1e-12``),
    cast to ``torch.float8_e4m3fn`` and back -- the cast is the
    quantizer, so the error profile is fp8's (relative, not absolute like
    int8's).  Wire payload per cell: ``size`` fp8 bytes + 4 scale bytes.
    """

    name = "fp8"
    stateful = True

    def __init__(self):
        if _FP8_DTYPE is None:
            raise NotImplementedError(
                "codec 'fp8' needs torch.float8_e4m3fn, which this torch "
                "build does not provide; use 'int8' instead")

    def encode(self, value):
        t = value.to(torch.float32)
        scale = _cell_scale(t, FP8_E4M3_MAX)
        return (t / _per_cell(scale, t.ndim)).to(_FP8_DTYPE), scale

    def decode(self, payload, shape):
        q, scale = payload
        return q.to(torch.float32) * _per_cell(scale, q.ndim)

    def payload_nbytes(self, shape, dtype) -> int:
        return math.prod(shape) * 1 + 4          # fp8 payload + f32 scale


class TopKCodec(Codec):
    """Magnitude top-k sparsification: every cell keeps its ``ceil(frac *
    size)`` largest-|.| entries and zeroes the rest.  Wire payload per
    cell: k (value, int32 index) pairs; everything dropped lands in the
    error-feedback residual and travels on a later step."""

    stateful = True

    def __init__(self, frac: float = 0.1):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"topk fraction must be in (0, 1], got {frac}")
        self.frac = float(frac)

    @property
    def name(self) -> str:
        return f"topk:{self.frac:g}"

    def k_of(self, size: int) -> int:
        return max(1, min(size, int(math.ceil(self.frac * size))))

    def encode(self, value):
        flat = _cells(value.to(torch.float32))
        _, idx = torch.topk(flat.abs(), self.k_of(flat.shape[-1]), dim=-1)
        return flat.gather(-1, idx), idx.to(torch.int32)

    def decode(self, payload, shape):
        vals, idx = payload
        size = math.prod(shape[CELL_AXES:])
        out = torch.zeros((*vals.shape[:-1], size), dtype=torch.float32,
                          device=vals.device)
        return out.scatter_(-1, idx.long(), vals).reshape(shape)

    def payload_nbytes(self, shape, dtype) -> int:
        # encode always emits f32 values (+ int32 indices), whatever the
        # input dtype, so the wire cost is 8 bytes per kept entry
        return self.k_of(math.prod(shape)) * (4 + 4)


# ---------------------------------------------------------------------------
# codec registry
# ---------------------------------------------------------------------------

_FACTORIES = {
    "identity": IdentityCodec,
    "none": IdentityCodec,       # accepted spelling in policy specs
    "int8": Int8Codec,
    "fp8": Fp8Codec,
}


def available_codecs():
    return sorted(_FACTORIES) + ["topk:FRAC"]


def get_codec(spec) -> Codec:
    """Codec instance from a spec string: ``identity`` / ``none`` /
    ``int8`` / ``fp8`` / ``topk`` / ``topk:0.25``."""
    if isinstance(spec, Codec):
        return spec
    s = str(spec).strip().lower()
    if s.startswith("topk"):
        rest = s[len("topk"):]
        if rest in ("", ":"):
            return TopKCodec()
        return TopKCodec(float(rest.lstrip(":")))
    try:
        return _FACTORIES[s]()
    except KeyError:
        raise ValueError(f"unknown codec {spec!r}; available: "
                         f"{available_codecs()}") from None


# ---------------------------------------------------------------------------
# legacy tree-level helpers: one int8 scale per leaf
# ---------------------------------------------------------------------------

_INT8 = Int8Codec()


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of nested dicts / lists / tuples."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _one_cell(t):
    """A whole tensor as a blocked payload of one cell."""
    return t.reshape(1, 1, *t.shape)


def init_error(params):
    """Zero error-feedback residual tree matching ``params``."""
    return _tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)


def compress(grads, error):
    """Int8-with-error-feedback over a tree, one scale per leaf.
    Returns ``(int8 tree, scale tree, new error tree)``."""
    def one(g, e):
        t = g.to(torch.float32) + e
        q, s = _INT8.encode(_one_cell(t))
        deq = _INT8.decode((q, s), q.shape).reshape(t.shape)
        return _Coded(q.reshape(t.shape), s.reshape(()), t - deq)

    out = _tree_map(one, grads, error)
    return tuple(_tree_map(lambda c, i=i: c.parts[i], out) for i in range(3))


class _Coded:
    """One leaf's ``(q, scale, err)``: a tree leaf, not a tuple node."""

    def __init__(self, *parts):
        self.parts = parts


def decompress(qs, ss):
    """Inverse of :func:`compress` (without the residual)."""
    return _tree_map(lambda q, s: q.to(torch.float32) * s, qs, ss)
