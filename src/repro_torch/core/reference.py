"""Reference serial solvers and metrics.

* ``serial_sdca`` -- plain single-machine SDCA (= CoCoA/D3CA with P=Q=1);
  run long enough it gives the ``f*`` used by the paper's
  relative-optimality-difference metric (f_t - f*) / f*.
* ``duality_gap`` -- F(w(alpha)) - D(alpha), a certificate of optimality.
* ``rel_opt`` -- the paper's convergence metric.
"""
from __future__ import annotations

import torch

from .local import KERNEL_LOSSES, local_sdca
from .losses import get_loss
from .util import as_tensor, resolve_device


def serial_sdca(loss_name: str, X, y, *, lam, epochs=100, seed=0, perms=None,
                device="cuda"):
    """Exact serial SDCA on dense (X, y). Returns (w, alpha).

    One epoch visits every observation once in a random order.  That is
    the local SDCA epoch on a 1 x 1 grid (Q = 1, no padded rows, the
    running alpha and w as starting point), so each epoch goes through
    ``kernels.sdca.sdca_epoch``: the CUDA kernel on a CUDA device -- a
    per-step loop of tensor operations is unusable at 14 000 steps an
    epoch -- and its plain version on the CPU.

    The kernel covers hinge and squared; logistic runs the plain per-step
    loop of ``local.local_sdca`` instead, and recovers w from the
    primal-dual map w = X^T alpha / (lam n).

    ``perms`` optionally gives the visiting orders as an (epochs, n)
    integer array; by default they come from a ``torch.Generator`` seeded
    with ``seed``.
    """
    from repro_torch.kernels.sdca import sdca_epoch
    loss = get_loss(loss_name)
    device = resolve_device(device)
    X = as_tensor(X, device).contiguous()
    y = as_tensor(y, device)
    n, m = X.shape
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    ones = torch.ones((n,), device=device)
    alpha = torch.zeros((n,), device=device)
    w = torch.zeros((m,), device=device)
    for e in range(epochs):
        if perms is None:
            idx = torch.randperm(n, generator=gen, device=device)
        else:
            idx = torch.as_tensor(perms[e], device=device)
        idx = idx.to(torch.int32).contiguous()
        if loss_name in KERNEL_LOSSES:
            dalpha, w = sdca_epoch(X, y, ones, alpha, w, idx, lam=lam, n=n,
                                   Q=1, loss=loss_name)
            alpha = alpha + dalpha
        else:
            dalpha = local_sdca(loss, X[None, None], y[None], ones[None],
                                alpha[None], w[None], lam=lam, n=n, Q=1,
                                idx=idx[None], backend="ref")
            alpha = alpha + dalpha[0, 0]
            w = X.T @ alpha / (lam * n)
    return w, alpha


def duality_gap(loss_name: str, X, y, w, alpha, lam):
    loss = get_loss(loss_name)
    return (loss.objective(X, y, w, lam)
            - loss.dual_objective(X, y, alpha, lam))


def rel_opt(f_t, f_star):
    """The paper's relative optimality difference (f_t - f*) / f*."""
    return (f_t - f_star) / abs(f_star)


def objective(loss_name: str, X, y, w, lam):
    return get_loss(loss_name).objective(X, y, w, lam)
