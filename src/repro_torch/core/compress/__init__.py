"""Compressed-communication subsystem for the doubly distributed solvers.

Three pieces, composable with the grid engine's reductions:

  * :mod:`~repro_torch.core.compress.codecs` -- identity / int8 / fp8 /
    top-k payload codecs with error feedback, acting on blocked payloads
    (one scale or one top-k per cell);
  * :mod:`~repro_torch.core.compress.policy` -- ``CompressionPolicy``
    mapping CommSchedule collective *names* to codecs (validated against
    each solver's declared schedule at build time), and the adaptive
    ``CompressionSchedule``;
  * :mod:`~repro_torch.core.compress.executor` -- the ``CompressedComm``
    executor (wraps ``SyncComm``) plus exact bytes-on-wire accounting
    (``wire_accounting``).

End to end: ``get_solver("d3ca")(compression="int8")``.
"""
from .codecs import (Codec, Fp8Codec, IdentityCodec, Int8Codec, TopKCodec,
                     available_codecs, compress, decompress, get_codec,
                     init_error)
from .executor import CompressedComm, wire_accounting
from .policy import (CompressionPolicy, CompressionSchedule, as_compression,
                     as_policy, identity_policy)

__all__ = [
    "Codec", "Fp8Codec", "IdentityCodec", "Int8Codec", "TopKCodec",
    "available_codecs", "get_codec",
    "compress", "decompress", "init_error",
    "CompressedComm", "wire_accounting",
    "CompressionPolicy", "CompressionSchedule", "as_compression",
    "as_policy", "identity_policy",
]
