"""Mixture-of-Experts FFN with capacity-based chunked dispatch (counterpart
of ``repro/models/moe.py``).

The sequence is cut into chunks of ``cfg.moe.chunk`` tokens (the last one
padded, its padding masked out of routing); every (row, chunk) routes its
tokens on its own: top-k experts by router logit, the lower expert index
first on a tie (as ``lax.top_k``), gates the softmax of the k logits in
float32, and a capacity of ``max(1, int(C k / E capacity_factor))`` slots
an expert, filled token-major over the flattened (token, choice) order.
Choices past an expert's capacity are dropped.

The reference builds one-hot dispatch and combine tensors and contracts
them with einsums; here the kept choices are scattered into their (expert,
slot) rows and the experts' outputs gathered back by index -- the same
tokens kept and dropped, the same products.  The chunks of all rows run
as one batch (each (row, chunk) is independent), so the number of
operators does not grow with the sequence.

On a rank of a mesh whose "model" axis splits the MoE, the routing runs
whole on every rank from the full router (the same tokens, the same
choices) and the rank's experts compute their part: with the experts
split (E % M == 0) the rank's weights are its E / M experts and only the
choices routed to them are dispatched (``first_expert`` names the first);
with the experts' ``d_ff`` split (``expert_ff``) every expert runs on the
rank's columns.  Either way the output is the rank's partial sum
(``partial=True``: float32, summed over "model" by the caller).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import trunc_normal


#: the logical axes of one layer's MoE leaves (the reference's ``init_moe``)
MOE_LOGICAL = {
    "router": ("fsdp", "experts"),
    "w_gate": ("experts", "fsdp", "ff"),
    "w_up": ("experts", "fsdp", "ff"),
    "w_down": ("experts", "ff", "fsdp"),
}


def init_moe(gen, cfg: ModelConfig, n: int, device):
    """``n`` stacked layers' router and expert weights (leading axis n)."""
    E, dm, dff = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    dt = cfg.pdtype
    return {
        "router": trunc_normal(gen, (n, dm, E), dm ** -0.5, dt, device),
        "w_gate": trunc_normal(gen, (n, E, dm, dff), dm ** -0.5, dt, device),
        "w_up": trunc_normal(gen, (n, E, dm, dff), dm ** -0.5, dt, device),
        "w_down": trunc_normal(gen, (n, E, dff, dm), dff ** -0.5, dt,
                               device),
    }


def top_k_lower_first(logits, k: int):
    """``(values, indices)`` of the k largest entries on the last axis,
    descending, equal values in ascending index order (``lax.top_k``'s
    order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(x, params, cfg: ModelConfig, valid=None, first_expert=0,
              partial=False):
    """Chunks x: (N, C, dm) -> (N, C, dm), each row of N one (row, chunk)
    of the reference's dispatch.  ``valid``: optional (N, C) bool --
    padded tokens take no capacity and give 0.  The expert weights of
    ``params`` are experts ``[first_expert, first_expert + n)`` (n their
    leading extent); a choice of another expert contributes 0.
    ``partial``: the float32 sum of the k products, not cast back."""
    moe = cfg.moe
    N, C, dm = x.shape
    E, k = moe.n_experts, moe.top_k
    cap = max(1, int(C * k / E * moe.capacity_factor))
    cdt = cfg.cdtype

    logits = x @ params["router"].to(cdt)                     # (N, C, E)
    gate_logits, expert = top_k_lower_first(logits, k)         # (N, C, k)
    gates = torch.softmax(gate_logits.float(), dim=-1)

    # slot of each (token, choice) in its expert's capacity: the number of
    # earlier choices of the same expert in token-major (C, k) order
    sel = F.one_hot(expert, E).float()                         # (N, C, k, E)
    if valid is not None:
        sel = sel * valid.float()[:, :, None, None]
    flat = sel.reshape(N, C * k, E)
    before = (torch.cumsum(flat, dim=1) - flat).reshape(N, C, k, E)
    slot = (before * sel).sum(-1).long()                       # (N, C, k)
    keep = (sel.sum(-1) > 0) & (slot < cap)
    # the rows of this rank's experts (all of them on one device)
    n_e = params["w_gate"].shape[0]
    mine = keep & (expert >= first_expert) & (expert < first_expert + n_e)
    trash = n_e * cap
    row = torch.where(mine, (expert - first_expert) * cap + slot,
                      torch.full_like(slot, trash)).reshape(N, C * k)

    # the kept choices' tokens in their (expert, slot) rows; dropped ones
    # in a trash row that no expert reads
    src = x[:, :, None, :].expand(N, C, k, dm).reshape(N, C * k, dm)
    xe = torch.zeros((N, trash + 1, dm), dtype=x.dtype, device=x.device)
    xe = xe.scatter(1, row[..., None].expand(N, C * k, dm), src)
    xe = xe[:, :trash].reshape(N, n_e, cap, dm)
    h = F.silu(torch.einsum("nexd,edf->nexf", xe, params["w_gate"].to(cdt))) \
        * torch.einsum("nexd,edf->nexf", xe, params["w_up"].to(cdt))
    ye = torch.einsum("nexf,efd->nexd", h, params["w_down"].to(cdt))
    ye = F.pad(ye.reshape(N, trash, dm), (0, 0, 0, 1))         # trash row 0
    got = torch.gather(ye, 1, row[..., None].expand(N, C * k, dm))
    # the gates rounded to the compute dtype (the reference's combine
    # tensor), the k products summed in float32
    w = (gates * keep).to(cdt).float().reshape(N, C * k, 1)
    out = (got.float() * w).reshape(N, C, k, dm).sum(2)
    return out if partial else out.to(x.dtype)


def moe_ffn(params, x, cfg: ModelConfig, *, first_expert=0, partial=False):
    """x: (B, S, dm) -> (B, S, dm): the reference's chunked dispatch over
    chunks of ``min(cfg.moe.chunk, S)`` tokens, a ragged tail padded and
    masked out of routing (its one-chunk, unrolled and scanned branches
    are the same computation chunk by chunk).  ``first_expert``,
    ``partial``: a rank's part (:func:`_dispatch`)."""
    B, S, dm = x.shape
    C = min(cfg.moe.chunk, S)
    n = -(-S // C)
    valid = None
    if S % C:
        x = F.pad(x, (0, 0, 0, n * C - S))
        valid = (torch.arange(n * C, device=x.device) < S).reshape(1, n, C)
        valid = valid.expand(B, n, C).reshape(B * n, C)
    out = _dispatch(x.reshape(B * n, C, dm), params, cfg, valid,
                    first_expert, partial)
    return out.reshape(B, n * C, dm)[:, :S]
