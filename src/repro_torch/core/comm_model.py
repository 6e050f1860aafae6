"""Alpha-beta wire-time model for the declared collectives.

The CommSchedule names every cross-cell reduction and ``wire_accounting``
reports *exact bytes per step*; this module turns those bytes into
**predicted seconds** on a modelled interconnect.  Pure arithmetic: it
touches no device and no tensor.

Model
-----
A link is ``(alpha, beta)``: per-message latency in seconds and
per-byte inverse bandwidth in s/byte.  For an allreduce of ``n`` bytes
over ``k`` participants:

  * ring:  ``T = 2 (k - 1) alpha + 2 (k - 1)/k * n * beta``
           (reduce-scatter + all-gather, the classic 2(k-1)/k factor --
           bandwidth-optimal, latency grows linearly in k);
  * tree:  ``T = 2 ceil(log2 k) (alpha + n beta)``
           (recursive halving/doubling counted as log-depth full-vector
           hops -- latency-optimal, pays the full vector per hop).

For an allgather of ``n`` bytes contributed per participant:

  * ring:  ``T = (k - 1) (alpha + n beta)``
  * tree:  ``T = ceil(log2 k) alpha + (k - 1) n beta``

``pmean`` costs the same wire time as ``psum`` (the division is local).

Topology
--------
``Topology`` describes a two-level machine: ``pods`` groups along one
logical axis (default ``"data"``), a fat intra-pod link and a thin
inter-pod link, and an optional cross-pod codec.  A collective over the
pod-split axis is executed hierarchically (full-precision reduce within
the pod, codec-compressed across pods -- exactly what
``SyncComm._reduce_hierarchical`` in :mod:`repro_torch.core.comm` does),
and its predicted time is the sum of the two stages.  Collectives over
other axes ride the intra-pod link.

Calibration
-----------
``fit_link`` least-squares fits ``(alpha, beta)`` from measured per-step
``comm_s`` samples (each sample: a schedule's accounting dict plus a
measured time), clamping both at >= 0.

Overlap
-------
``overlap_split``: with ``tau`` steps of local work available to hide
the wire, ``hidden = min(comm_s, tau * local_s)`` and the *exposed*
remainder is what lands on the critical path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "LinkModel", "Topology", "INTRA_POD_LINK", "INTER_POD_LINK",
    "collective_time", "predict_comm_s", "fit_link", "overlap_split",
    "hierarchical_accounting",
]


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """One interconnect link: ``alpha_s`` per-message latency and
    ``beta_s_per_byte`` inverse bandwidth."""

    alpha_s: float
    beta_s_per_byte: float
    name: str = "link"

    def __post_init__(self):
        if self.alpha_s < 0 or self.beta_s_per_byte < 0:
            raise ValueError("LinkModel parameters must be >= 0")

    @property
    def bandwidth_gbps(self) -> float:
        """Bidirectional bandwidth implied by beta, in GB/s."""
        if self.beta_s_per_byte == 0:
            return math.inf
        return 1.0 / self.beta_s_per_byte / 1e9


# Modelled priors, not readings of any chip or network: a fat intra-pod
# link (1 us, 300 GB/s) and a thin inter-pod link (10 us, 25 GB/s), the
# reference package's values, kept so that the two packages predict the
# same seconds.  A time predicted from them is a model's, never a
# measurement; ``fit_link`` re-fits alpha/beta from measured comm_s.
INTRA_POD_LINK = LinkModel(1e-6, 1.0 / 300e9, name="intra_pod")
INTER_POD_LINK = LinkModel(10e-6, 1.0 / 25e9, name="inter_pod")


def _allreduce_time(nbytes: float, k: int, link: LinkModel,
                    algo: str) -> float:
    if k <= 1 or nbytes <= 0:
        return 0.0
    a, b = link.alpha_s, link.beta_s_per_byte
    if algo == "ring":
        return 2 * (k - 1) * a + 2 * (k - 1) / k * nbytes * b
    if algo == "tree":
        h = math.ceil(math.log2(k))
        return 2 * h * (a + nbytes * b)
    raise ValueError(f"unknown collective algorithm {algo!r} "
                     "(expected 'ring' or 'tree')")


def _allgather_time(nbytes: float, k: int, link: LinkModel,
                    algo: str) -> float:
    if k <= 1 or nbytes <= 0:
        return 0.0
    a, b = link.alpha_s, link.beta_s_per_byte
    if algo == "ring":
        return (k - 1) * (a + nbytes * b)
    if algo == "tree":
        return math.ceil(math.log2(k)) * a + (k - 1) * nbytes * b
    raise ValueError(f"unknown collective algorithm {algo!r} "
                     "(expected 'ring' or 'tree')")


def collective_time(op: str, nbytes: float, k: int, link: LinkModel,
                    algo: str = "ring") -> float:
    """Predicted seconds for one ``op`` of ``nbytes`` (per participant)
    over ``k`` participants on ``link``."""
    if op in ("psum", "pmean"):
        return _allreduce_time(nbytes, k, link, algo)
    if op == "allgather":
        return _allgather_time(nbytes, k, link, algo)
    raise ValueError(f"unknown collective op {op!r}")


@dataclasses.dataclass(frozen=True)
class Topology:
    """Two-level machine model for the hierarchical executors.

    ``pods`` groups along logical ``axis`` (the leading mesh/vmap axis
    of the two-level split); ``codec`` names the cross-pod payload
    codec ("identity" disables compression); ``algo`` selects the
    wire-time formula.  ``pods == 1`` is the flat machine (the
    executors then take the ordinary single-psum path).
    """

    pods: int = 1
    codec: str = "identity"
    algo: str = "ring"
    axis: str = "data"
    intra: LinkModel = INTRA_POD_LINK
    inter: LinkModel = INTER_POD_LINK

    def __post_init__(self):
        if self.pods < 1:
            raise ValueError(f"pods must be >= 1, got {self.pods}")
        if self.algo not in ("ring", "tree"):
            raise ValueError(f"algo must be 'ring' or 'tree', "
                             f"got {self.algo!r}")

    @classmethod
    def from_spec(cls, spec) -> "Topology":
        """Parse ``"pods=2"``, ``"pods=4:int8"``, ``"pods=2:int8:tree"``
        (codec and algo optional, in that order)."""
        if isinstance(spec, Topology):
            return spec
        if not isinstance(spec, str) or not spec.strip():
            raise ValueError(f"bad topology spec {spec!r}")
        parts = [p.strip() for p in spec.strip().split(":")]
        head = parts[0]
        if not head.startswith("pods="):
            raise ValueError(
                f"bad topology spec {spec!r}: expected 'pods=G[:codec[:algo]]'")
        try:
            pods = int(head[len("pods="):])
        except ValueError:
            raise ValueError(f"bad pod count in topology spec {spec!r}")
        codec, algo = "identity", "ring"
        if len(parts) >= 2 and parts[1]:
            codec = parts[1]
        if len(parts) >= 3 and parts[2]:
            algo = parts[2]
        if len(parts) > 3:
            raise ValueError(f"bad topology spec {spec!r}: too many fields")
        return cls(pods=pods, codec=codec, algo=algo)

    @property
    def spec(self) -> str:
        return f"pods={self.pods}:{self.codec}:{self.algo}"

    def hierarchical(self) -> bool:
        return self.pods > 1


def as_topology(spec) -> Optional[Topology]:
    """None | spec-string | Topology -> Optional[Topology]."""
    if spec is None:
        return None
    return Topology.from_spec(spec)


def _codec_nbytes(codec_name: str, nbytes: float) -> float:
    """Cross-pod payload bytes after the topology codec.  Uses the
    codec registry's per-element payload accounting on a synthetic f32
    vector of the same byte size (collectives here are f32 payloads)."""
    if codec_name in (None, "identity"):
        return nbytes
    from .compress import get_codec
    codec = get_codec(codec_name)
    numel = max(int(round(nbytes / 4.0)), 1)
    return float(codec.payload_nbytes((numel,), "float32"))


def hierarchical_accounting(acct: dict, topology: Optional[Topology],
                            sizes: Dict[str, int]) -> dict:
    """Rewrite a ``wire_accounting`` dict for a two-level topology.

    For each collective over the pod-split axis, the flat bytes become
    an intra-pod stage (full precision, unchanged per-cell bytes) plus
    an inter-pod stage (one codec-compressed contribution per pod).
    Other collectives are unchanged.  Adds ``intra_bytes_per_step`` /
    ``inter_bytes_per_step`` totals so the emitters can report both
    tiers; ``bytes_per_step`` stays the total.
    """
    if topology is None or not topology.hierarchical():
        return acct
    out = {k: v for k, v in acct.items() if k != "collectives"}
    out["collectives"] = {}
    out["topology"] = topology.spec
    total = intra_total = inter_total = 0.0
    for name, c in acct["collectives"].items():
        c = dict(c)
        if c.get("axis") == topology.axis and sizes.get(topology.axis, 1) > 1:
            per_cell = c["payload_bytes_per_cell"]   # post-policy payload
            k_total = sizes[topology.axis]
            pods = topology.pods
            cells = c["cells"]
            other = cells // k_total       # independent reductions in flight
            intra = per_cell * k_total * other
            inter_per_pod = _codec_nbytes(topology.codec, per_cell)
            inter = inter_per_pod * pods * other
            c["intra_bytes_per_step"] = intra
            c["inter_bytes_per_step"] = inter
            c["bytes_per_step"] = intra + inter
            intra_total += intra
            inter_total += inter
        else:
            intra_total += c["bytes_per_step"]
            c["intra_bytes_per_step"] = c["bytes_per_step"]
            c["inter_bytes_per_step"] = 0.0
        total += c["bytes_per_step"]
        out["collectives"][name] = c
    out["bytes_per_step"] = total
    out["intra_bytes_per_step"] = intra_total
    out["inter_bytes_per_step"] = inter_total
    return out


def predict_comm_s(acct: dict, sizes: Dict[str, int], *,
                   topology: Optional[Topology] = None,
                   link: LinkModel = INTRA_POD_LINK,
                   algo: str = "ring") -> dict:
    """Predicted per-step communication seconds for a schedule.

    ``acct`` is the ``wire_accounting`` dict attached to every grid
    ``EngineProgram`` (``prog.comm_bytes``); ``sizes`` the logical axis
    extents (``{"data": P, "model": Q}``).  Collectives are serial
    within a step (each one is a data dependency of the next cell
    phase), so the total is the sum over collectives.  With a
    hierarchical topology the pod-split collectives cost
    ``intra_stage + inter_stage``; independent reductions over the
    *other* axis are modelled as perfectly parallel (disjoint links).

    Returns ``{"collectives": {name: {...}}, "total_s": float}``.
    """
    out: dict = {"collectives": {}, "total_s": 0.0, "algo": algo}
    for name, c in acct["collectives"].items():
        axis = c.get("axis")
        k = int(sizes.get(axis, 1))
        per_cell = float(c["payload_bytes_per_cell"])
        op = c.get("op", "psum")
        entry: dict = {"axis": axis, "k": k, "bytes": per_cell}
        if (topology is not None and topology.hierarchical()
                and axis == topology.axis and k > 1):
            k_in = k // topology.pods
            intra = collective_time(op, per_cell, k_in, topology.intra,
                                    topology.algo)
            inter_bytes = _codec_nbytes(topology.codec, per_cell)
            inter = collective_time(op, inter_bytes, topology.pods,
                                    topology.inter, topology.algo)
            entry.update(intra_s=intra, inter_s=inter,
                         wire_s=intra + inter)
        else:
            tlink = link if topology is None else topology.intra
            talgo = algo if topology is None else topology.algo
            entry["wire_s"] = collective_time(op, per_cell, k, tlink, talgo)
        out["collectives"][name] = entry
        out["total_s"] += entry["wire_s"]
    return out


def _coeffs(acct: dict, sizes: Dict[str, int], algo: str) -> Tuple[float,
                                                                   float]:
    """(alpha, beta) coefficients of the linear model for one schedule:
    predicted_s = A * alpha + B * beta on a single flat link."""
    A = B = 0.0
    for c in acct["collectives"].values():
        k = int(sizes.get(c.get("axis"), 1))
        n = float(c["payload_bytes_per_cell"])
        if k <= 1 or n <= 0:
            continue
        op = c.get("op", "psum")
        if op in ("psum", "pmean"):
            if algo == "ring":
                A += 2 * (k - 1)
                B += 2 * (k - 1) / k * n
            else:
                A += 2 * math.ceil(math.log2(k))
                B += 2 * math.ceil(math.log2(k)) * n
        else:                                   # allgather
            if algo == "ring":
                A += (k - 1)
                B += (k - 1) * n
            else:
                A += math.ceil(math.log2(k))
                B += (k - 1) * n
    return A, B


def fit_link(samples: Sequence[Tuple[dict, Dict[str, int], float]], *,
             algo: str = "ring", name: str = "fitted") -> LinkModel:
    """Least-squares fit of ``(alpha, beta)`` from measured comm times.

    Each sample is ``(acct, sizes, measured_comm_s)``.  Solves the 2x2
    normal equations, clamps both parameters at >= 0 (re-solving the
    1-parameter problem when one clamps), so the result is always a
    valid :class:`LinkModel`.  With fewer than two samples (or a
    singular system) it falls back to a pure-bandwidth fit.
    """
    rows: List[Tuple[float, float, float]] = []
    for acct, sizes, t in samples:
        A, B = _coeffs(acct, sizes, algo)
        if A > 0 or B > 0:
            rows.append((A, B, max(float(t), 0.0)))
    if not rows:
        return LinkModel(0.0, 0.0, name=name)
    saa = sum(a * a for a, _, _ in rows)
    sbb = sum(b * b for _, b, _ in rows)
    sab = sum(a * b for a, b, _ in rows)
    sat = sum(a * t for a, _, t in rows)
    sbt = sum(b * t for _, b, t in rows)
    det = saa * sbb - sab * sab
    if det > 1e-30 * max(saa * sbb, 1e-30):
        alpha = (sat * sbb - sbt * sab) / det
        beta = (saa * sbt - sab * sat) / det
    else:
        alpha, beta = -1.0, -1.0                # force the clamp path
    if alpha < 0 or beta < 0:
        # Clamp + re-solve each 1-parameter problem, keep the better fit.
        cand = []
        if sbb > 0:
            cand.append((0.0, max(sbt / sbb, 0.0)))
        if saa > 0:
            cand.append((max(sat / saa, 0.0), 0.0))
        if not cand:
            return LinkModel(0.0, 0.0, name=name)

        def sse(ab):
            a0, b0 = ab
            return sum((a * a0 + b * b0 - t) ** 2 for a, b, t in rows)
        alpha, beta = min(cand, key=sse)
    return LinkModel(float(alpha), float(beta), name=name)


def overlap_split(comm_s: float, local_s: float, tau: int) -> dict:
    """Split measured ``comm_s`` into hidden vs exposed under the
    overlap engine: tau steps of local solve are available to hide the
    wire, so ``hidden = min(comm_s, tau * local_s)``.  tau = 0 (or the
    sync/async engines) exposes everything."""
    comm_s = max(float(comm_s), 0.0)
    hidden = min(comm_s, max(int(tau), 0) * max(float(local_s), 0.0))
    return {"comm_hidden_s": hidden, "comm_exposed_s": comm_s - hidden}
