"""CompressionPolicy: which codec runs on which named collective.

A policy maps the *names* a solver's
:class:`~repro_torch.core.comm.CommSchedule` declares to
:class:`~repro_torch.core.compress.codecs.Codec` instances, with a default
codec for every name not mentioned.  Because collectives are named, a
policy can compress the big vector reductions while leaving the
numerically delicate ones exact::

    # compress D3CA's primal-dual map, keep the dual average exact
    CompressionPolicy.from_spec("w_contrib=int8,dalpha=identity")

    # one codec for every declared collective
    CompressionPolicy.from_spec("int8")

    # mixed: default int8, but ADMM's ridge rhs stays exact
    CompressionPolicy.from_spec("int8,rhs=identity")

Policies are validated against each solver's declared schedule at
program-build time (:meth:`CompressionPolicy.validate`): naming a
collective the solver never declares is a loud error listing what IS
declared, so a typo cannot silently leave a reduction uncompressed.
"""
from __future__ import annotations

from typing import Dict, Optional

from .codecs import Codec, IdentityCodec, get_codec


class CompressionPolicy:
    """Per-collective codec assignment with a default."""

    def __init__(self, default="identity",
                 per_collective: Optional[Dict[str, object]] = None):
        self.default: Codec = get_codec(default)
        self.per_collective: Dict[str, Codec] = {
            name: get_codec(c) for name, c in (per_collective or {}).items()}

    # -- construction --------------------------------------------------------
    @classmethod
    def from_spec(cls, spec: str) -> "CompressionPolicy":
        """Parse ``"int8"`` / ``"topk:0.1"`` / ``"dw=int8,z=identity"`` /
        ``"int8,rhs=identity"`` (bare entry = default codec)."""
        default = "identity"
        per: Dict[str, str] = {}
        seen_default = False
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            if "=" in part:
                name, codec = part.split("=", 1)
                name, codec = name.strip(), codec.strip()
                if not name or not codec:
                    raise ValueError(f"malformed policy entry {part!r} in "
                                     f"spec {spec!r}")
                if name in per:
                    raise ValueError(f"collective {name!r} assigned twice "
                                     f"in spec {spec!r}")
                per[name] = codec
            else:
                if seen_default:
                    raise ValueError(f"two default codecs in spec {spec!r}")
                default, seen_default = part, True
        return cls(default=default, per_collective=per)

    # -- lookup --------------------------------------------------------------
    def codec_for(self, name: str) -> Codec:
        return self.per_collective.get(name, self.default)

    def stateful_names(self, schedule) -> tuple:
        """Names of the schedule's collectives whose codec carries an
        error-feedback residual."""
        return tuple(p.name for p in schedule
                     if self.codec_for(p.name).stateful)

    @property
    def spec(self) -> str:
        """Canonical round-trippable spec string."""
        parts = [self.default.name]
        parts += [f"{n}={c.name}"
                  for n, c in sorted(self.per_collective.items())]
        return ",".join(parts)

    # -- build-time contract -------------------------------------------------
    def validate(self, schedule) -> "CompressionPolicy":
        """Every explicitly named collective must be declared by the
        solver's CommSchedule."""
        unknown = sorted(set(self.per_collective) - set(schedule.names))
        if unknown:
            raise ValueError(
                f"compression policy names collectives {unknown} that this "
                f"solver's CommSchedule never declares "
                f"(declared: {sorted(schedule.names)}); fix the policy spec "
                "or drop the entry")
        return self

    def __repr__(self):
        return f"CompressionPolicy({self.spec!r})"


class CompressionSchedule:
    """Adaptive per-collective codec switching: a sequence of
    :class:`CompressionPolicy` stages advanced by observed convergence.

    The CoCoA-style story: aggressive sparsification (top-k) buys the
    most wire early, when updates are large and redundant; near
    convergence the iterates need the denser signal, so the schedule
    falls back to a gentler codec (int8).  The solver's outer loop
    watches the ``rel_opt`` slope in solver history (objective decrease
    when no ``f_star`` is known) and advances to the next stage when progress
    per iteration flattens below ``slope_tol`` decades/iter over a
    ``window``-iteration lookback.  Stage switches happen between outer
    steps at the host level -- each stage is a fresh program build warm
    started from the current iterates, since a codec cannot change
    inside a compiled step.

    Spec grammar (``@``-separated options after the ``->`` stage
    chain)::

        adaptive                              # topk:0.25 -> int8
        adaptive:topk:0.1->int8               # explicit stages
        adaptive:topk:0.25->int8->identity@slope=0.02@window=4
    """

    DEFAULT_STAGES = ("topk:0.25", "int8")

    def __init__(self, stages=None, *, slope_tol: float = 0.05,
                 window: int = 3):
        stages = tuple(stages) if stages else self.DEFAULT_STAGES
        self.stages = tuple(as_policy(s) for s in stages)
        if any(s is None for s in self.stages):
            raise ValueError("CompressionSchedule stages must be policies")
        self.slope_tol = float(slope_tol)
        self.window = int(window)
        if self.window < 1:
            raise ValueError(f"window={window} must be >= 1")
        if self.slope_tol < 0:
            raise ValueError(f"slope_tol={slope_tol} must be >= 0")

    @classmethod
    def from_spec(cls, spec: str) -> "CompressionSchedule":
        text = str(spec).strip()
        head, *opts = text.split("@")
        head = head.strip()
        if not (head == "adaptive" or head.startswith("adaptive:")):
            raise ValueError(f"bad adaptive spec {spec!r}: expected "
                             "'adaptive[:stage->stage...][@slope=..]'")
        body = head[len("adaptive"):].lstrip(":")
        stages = [s.strip() for s in body.split("->") if s.strip()] or None
        kw = {}
        for opt in opts:
            key, _, val = opt.strip().partition("=")
            if key == "slope":
                kw["slope_tol"] = float(val)
            elif key == "window":
                kw["window"] = int(val)
            else:
                raise ValueError(f"unknown adaptive option {opt!r} in "
                                 f"spec {spec!r} (know: slope, window)")
        return cls(stages, **kw)

    @property
    def spec(self) -> str:
        chain = "->".join(s.spec for s in self.stages)
        return (f"adaptive:{chain}@slope={self.slope_tol:g}"
                f"@window={self.window}")

    def validate(self, schedule) -> "CompressionSchedule":
        for s in self.stages:
            s.validate(schedule)
        return self

    def should_advance(self, values) -> bool:
        """True when the convergence metric (smaller = better, e.g.
        rel_opt) has flattened: its log10 decrease per iteration over
        the last ``window`` iterations fell below ``slope_tol``."""
        import math
        if len(values) < self.window + 1:
            return False
        a = max(float(values[-1 - self.window]), 1e-12)
        b = max(float(values[-1]), 1e-12)
        slope = (math.log10(a) - math.log10(b)) / self.window
        return slope < self.slope_tol

    def __repr__(self):
        return f"CompressionSchedule({self.spec!r})"


def as_compression(compression):
    """Normalize the ``compression=`` knob including adaptive schedules:
    returns ``None``, a :class:`CompressionPolicy`, or a
    :class:`CompressionSchedule` (``"adaptive..."`` specs)."""
    if isinstance(compression, CompressionSchedule):
        return compression
    if isinstance(compression, str) \
            and compression.strip().startswith("adaptive"):
        return CompressionSchedule.from_spec(compression)
    return as_policy(compression)


def as_policy(compression) -> Optional[CompressionPolicy]:
    """Normalize the user-facing ``compression=`` knob.

    ``None`` means *no compression machinery at all* (the engine builds
    the exact uncompressed program); a policy whose codecs are all identity
    still routes through :class:`CompressedComm` but is bit-identical by
    construction.  Accepts a policy, a spec string, a codec name, or a
    ``{collective: codec}`` dict (dict entries may include a
    ``"default"`` key).
    """
    if compression is None:
        return None
    if isinstance(compression, CompressionPolicy):
        return compression
    if isinstance(compression, dict):
        per = dict(compression)
        default = per.pop("default", "identity")
        return CompressionPolicy(default=default, per_collective=per)
    if isinstance(compression, Codec):
        return CompressionPolicy(default=compression)
    return CompressionPolicy.from_spec(str(compression))


def identity_policy() -> CompressionPolicy:
    return CompressionPolicy(default=IdentityCodec())
