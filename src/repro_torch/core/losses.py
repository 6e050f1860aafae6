"""Convex losses for the ERM objective (1) of Nathan & Klabjan (2016).

    min_w  F(w) = (1/n) sum_i f_i(w^T x_i) + lambda ||w||^2

Every loss provides:
  * ``value(z, y)``      -- f_i(z) parametrized by the label y
  * ``grad(z, y)``       -- df/dz (a subgradient for hinge)
  * ``conj(a, y)``       -- the convex conjugate phi_i*(-a) used by the dual
                            objective (2); +inf outside the dual feasible box
                            is encoded by ``dual_bounds``.
  * ``dual_bounds(y)``   -- feasible interval for the dual variable alpha_i
  * ``sdca_delta(...)``  -- the (approximate) maximizer of the *local* D3CA
                            objective of Algorithm 2 step 3 (scaled by 1/Q):
        max_d  (1/Q) * (-phi*(-(alpha+d))) - (lam*n/2) ||w + d*x/(lam n)||^2
    closed form for hinge / squared, a few Newton steps for logistic.

All functions are elementwise on float32 tensors of any (broadcastable)
shape, so the blocked (P, Q, ...) arrays of the grid engine pass through
unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Loss:
    name: str
    value: Callable
    grad: Callable
    conj: Callable
    dual_bounds: Callable
    sdca_delta: Callable

    def objective(self, X, y, w, lam, mask=None, n=None):
        """Primal objective F(w); `mask` marks real (non-padded) rows."""
        z = X @ w
        vals = self.value(z, y)
        if mask is not None:
            vals = vals * mask
        n_eff = n if n is not None else (mask.sum() if mask is not None else X.shape[0])
        # NOTE: the paper writes lam*||w||^2 in eq. (1) but its dual (2),
        # primal-dual map (3) and the SDCA closed form are all derived under
        # the standard (lam/2)*||w||^2 convention -- used consistently here.
        return vals.sum() / n_eff + 0.5 * lam * torch.sum(w * w)

    def dual_objective(self, X, y, alpha, lam, mask=None, n=None):
        """Dual objective D(alpha) of eq. (2)."""
        if mask is not None:
            alpha = alpha * mask
        n_eff = n if n is not None else (mask.sum() if mask is not None else X.shape[0])
        v = X.T @ alpha / (lam * n_eff)
        conj_term = self.conj(alpha, y)
        if mask is not None:
            conj_term = conj_term * mask
        return -conj_term.sum() / n_eff - lam / 2.0 * torch.sum(v * v)


def _box(y):
    """Dual feasible box of a label: [0, 1] for y > 0, [-1, 0] otherwise
    (a padded row has y = 0 and gets [-1, 0])."""
    pos = y > 0
    lo = torch.where(pos, 0.0, -1.0).to(y.dtype)
    hi = torch.where(pos, 1.0, 0.0).to(y.dtype)
    return lo, hi


# ----------------------------------------------------------------------------
# hinge: f(z) = max(0, 1 - y z);  phi*(-a) = -a y, feasible iff a*y in [0, 1]
# ----------------------------------------------------------------------------

def _hinge_value(z, y):
    return torch.clamp(1.0 - y * z, min=0.0)


def _hinge_grad(z, y):
    return torch.where(y * z < 1.0, -y, torch.zeros_like(y))


def _hinge_conj(a, y):
    # phi*(-a) = -a*y  on the feasible box (0 <= a*y <= 1)
    return -a * y


def _hinge_sdca_delta(alpha, x_sq, zloc, y, lam, n, Q, beta=None):
    """Closed-form local maximizer for hinge.

    d/dD [ (1/Q)(alpha+D) y - zloc*D - D^2 ||x||^2/(2 lam n) ] = 0
      =>  D = (y/Q - zloc) * lam*n / ||x||^2,  then clip so that
          (alpha + D) * y in [0, 1].
    ``beta`` (paper's step-size variant) replaces ||x||^2 when given.
    """
    denom = x_sq if beta is None else torch.as_tensor(
        beta, dtype=zloc.dtype, device=zloc.device)
    denom = torch.clamp(denom, min=1e-12)
    d = (y / Q - zloc) * lam * n / denom
    lo, hi = _box(y)
    return torch.minimum(torch.maximum(alpha + d, lo), hi) - alpha


# ----------------------------------------------------------------------------
# squared: f(z) = (z - y)^2 ; phi*(-a) = -a y + a^2 / 4  (unconstrained)
# ----------------------------------------------------------------------------

def _sq_value(z, y):
    return (z - y) ** 2


def _sq_grad(z, y):
    return 2.0 * (z - y)


def _sq_conj(a, y):
    return -a * y + a * a / 4.0


def _sq_bounds(y):
    big = torch.full_like(y, float("inf"))
    return -big, big


def _sq_sdca_delta(alpha, x_sq, zloc, y, lam, n, Q, beta=None):
    # d/dD [ (1/Q)((alpha+D) y - (alpha+D)^2/4) - zloc*D - D^2 ||x||^2/(2 lam n) ]
    #  = y/Q - (alpha+D)/(2Q) - zloc - D ||x||^2/(lam n) = 0
    denom_x = x_sq if beta is None else torch.as_tensor(
        beta, dtype=zloc.dtype, device=zloc.device)
    num = y / Q - alpha / (2.0 * Q) - zloc
    den = 1.0 / (2.0 * Q) + denom_x / (lam * n)
    return num / torch.clamp(den, min=1e-12)


# ----------------------------------------------------------------------------
# logistic: f(z) = log(1 + exp(-y z))
# phi*(-a): with t = a*y in (0,1):  t log t + (1-t) log(1-t)
# ----------------------------------------------------------------------------

def _log_value(z, y):
    return torch.nn.functional.softplus(-y * z)


def _log_grad(z, y):
    return -y * torch.sigmoid(-y * z)


def _xlogx(t):
    return torch.where(t > 0, t * torch.log(torch.clamp(t, min=1e-30)),
                       torch.zeros_like(t))


def _log_conj(a, y):
    t = torch.clamp(a * y, 0.0, 1.0)
    return _xlogx(t) + _xlogx(1.0 - t)


def _log_sdca_delta(alpha, x_sq, zloc, y, lam, n, Q, beta=None, newton_iters=8):
    """Newton on the local objective's derivative in D, with
    q = ||x||^2/(lam n) and t = (alpha + D) y kept inside (0, 1):

      phi*(-a) = t log t + (1-t) log(1-t),  d/da phi*(-a) = y (log t - log(1-t))
      obj'(D)  = -(1/Q) y log(t/(1-t)) - zloc - D q = 0
    """
    denom_x = x_sq if beta is None else torch.as_tensor(
        beta, dtype=zloc.dtype, device=zloc.device)
    q = torch.clamp(denom_x, min=1e-12) / (lam * n)
    eps = 1e-6
    # padded rows carry y = 0; dividing by y would poison the masked-out
    # delta with NaN (0 * inf), so divide by a harmless stand-in there
    safe_y = torch.where(y == 0, torch.ones_like(y), y)
    shape = torch.broadcast_shapes(alpha.shape, zloc.shape, y.shape)
    # start strictly inside the box
    t0 = torch.clamp(alpha * y, eps, 1.0 - eps)
    D = (t0 / safe_y - alpha).expand(shape)
    for _ in range(newton_iters):
        t = torch.clamp((alpha + D) * y, eps, 1.0 - eps)
        g = -(1.0 / Q) * y * (torch.log(t) - torch.log1p(-t)) - zloc - D * q
        # g'(D) = -(1/Q) * y^2 * (1/t + 1/(1-t)) - q   (y^2 == 1)
        gp = -(1.0 / Q) * (1.0 / t + 1.0 / (1.0 - t)) - q
        D_new = D - g / gp
        # project back so that (alpha + D) y stays inside (0, 1)
        t_new = torch.clamp((alpha + D_new) * y, eps, 1.0 - eps)
        D = t_new / safe_y - alpha
    return D


hinge = Loss("hinge", _hinge_value, _hinge_grad, _hinge_conj, _box,
             _hinge_sdca_delta)
squared = Loss("squared", _sq_value, _sq_grad, _sq_conj, _sq_bounds,
               _sq_sdca_delta)
logistic = Loss("logistic", _log_value, _log_grad, _log_conj, _box,
                _log_sdca_delta)

LOSSES = {fn.name: fn for fn in (hinge, squared, logistic)}


def get_loss(name: str) -> Loss:
    return LOSSES[name]
