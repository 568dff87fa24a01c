"""Newton constraint solver for the pyramidal cone, batched over worlds.

Plain PyTorch version of the solve inside kernel B3. It follows the
algorithm of the TPU kernel `_newton_core`
(`mujoco_warp_tpu/pallas/solver_kernels.py:103`), not the XLA solver's:
init (:446-466), the loop (:468-504), and its linesearch (:398-444) — a
fixed bracket of LS_K log-spaced alphas, a secant, and 4 safeguarded
Newton/bisection polish steps. A world that has converged is frozen
(alpha = 0, :480) while the others iterate, so each world's answer is
the one a per-world loop gives.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import Model

MINVAL = 1e-15
LS_K = 10
# bracket scales of the linesearch, float32 like the kernel's constants
LS_SCALES = tuple(float(s) for s in np.logspace(-3.0, 0.7, LS_K,
                                                 dtype=np.float64
                                                 ).astype(np.float32))
LS_POLISH = 4


def cholesky(A: torch.Tensor) -> torch.Tensor:
  """Lower Cholesky factor of (W, n, n) SPD matrices, column by column;
  a pivot below MINVAL is floored there (no NaN for a singular A)."""
  n = A.shape[-1]
  L = torch.zeros_like(A)
  for j in range(n):
    s = A[:, :, j] - torch.einsum('wik,wk->wi', L[:, :, :j], L[:, j, :j])
    col = s * torch.rsqrt(torch.clamp(s[:, j:j + 1], min=MINVAL))
    L[:, j:, j] = col[:, j:]
  return L


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve L L^T x = b for (W, n, n) L and (W, n) b."""
  y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
  return torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                       upper=True)[..., 0]


def _classes(nj: int, ne: int, nf: int, device):
  """Row classes of the efc layout: equality, friction, one-sided."""
  r = torch.arange(nj, device=device)
  return r < ne, (r >= ne) & (r < ne + nf), r >= ne + nf


def _update_constraint(jaref, D, fl, rf, is_eq, is_fr, is_one):
  """Row forces, the constraint cost (W, 1) and the quadratic-row mask."""
  lin_neg = is_fr & (jaref <= -rf)
  lin_pos = is_fr & (jaref >= rf)
  quad = is_eq | (is_fr & ~lin_neg & ~lin_pos) | (is_one & (jaref < 0))
  force = torch.where(quad, -D * jaref, 0.0)
  force = torch.where(lin_neg, fl, force)
  force = torch.where(lin_pos, -fl, force)
  cost = torch.where(quad, 0.5 * D * jaref * jaref, 0.0)
  cost = torch.where(lin_neg, -fl * (0.5 * rf + jaref), cost)
  cost = torch.where(lin_pos, -fl * (0.5 * rf - jaref), cost)
  return force, torch.sum(cost, 1, keepdim=True), quad


def objective(qM, J, D, aref, fl, qfrc_smooth, qacc_smooth, qacc, ne: int,
              nf: int) -> torch.Tensor:
  """The cost the Newton solve minimizes, (W,), at qacc: the Gauss term
  0.5 (M qacc - qfrc_smooth) . (qacc - qacc_smooth) plus the constraint
  cost of jaref = J qacc - aref."""
  ma = torch.einsum('wij,wj->wi', qM, qacc)
  jaref = torch.einsum('wrn,wn->wr', J, qacc) - aref
  rf = fl / torch.clamp(D, min=MINVAL)
  _, cost, _ = _update_constraint(jaref, D, fl, rf,
                                  *_classes(J.shape[1], ne, nf, J.device))
  gauss = 0.5 * torch.sum((ma - qfrc_smooth) * (qacc - qacc_smooth), 1)
  return gauss + cost[:, 0]


def newton(m: Model, qM, J, D, aref, fl, qfrc_smooth, warmstart, ne: int,
           nf: int, use_warmstart: bool = True, hdiag=None) -> dict:
  """Solve for qacc with J (W, nj, nv) rows: [0, ne) equality, [ne,
  ne + nf) friction, the rest one-sided. hdiag (nv,), if given, is the
  integration diagonal of the final re-solve (qM + diag(hdiag)) qacc_euler
  = qfrc_smooth + qfrc_constraint; without it qacc_euler = qacc."""
  W, nj, nv = J.shape
  dev, dt = J.device, J.dtype
  tol = m.opt.tolerance
  rescale = torch.clamp(m.stat.meaninertia, min=MINVAL) * max(1, nv)
  is_eq, is_fr, is_one = _classes(nj, ne, nf, dev)
  rf = fl / torch.clamp(D, min=MINVAL)
  qfs = qfrc_smooth

  qld = cholesky(qM)
  qacc_smooth = cho_solve(qld, qfs)
  mv_qm = lambda x: torch.einsum('wij,wj->wi', qM, x)
  mv_j = lambda x: torch.einsum('wrn,wn->wr', J, x)
  mv_jt = lambda y: torch.einsum('wrn,wr->wn', J, y)
  rowsum = lambda x: torch.sum(x, 1, keepdim=True)

  def update_constraint(jaref):
    return _update_constraint(jaref, D, fl, rf, is_eq, is_fr, is_one)

  def gauss_cost(qacc, ma):
    return 0.5 * rowsum((ma - qfs) * (qacc - qacc_smooth))

  def newton_dir(grad, quad):
    dh = D * quad.to(dt)
    H = qM + torch.einsum('wrn,wr,wrm->wnm', J, dh, J)
    return cho_solve(cholesky(H), grad)

  def linesearch(jaref, search, ma, jv, mv):
    g0 = rowsum(search * (ma - qfs))
    h0 = rowsum(search * mv)

    def phi_d(alpha):
      x = jaref + alpha * jv
      lin_neg = is_fr & (x <= -rf)
      lin_pos = is_fr & (x >= rf)
      quad = is_eq | (is_fr & ~lin_neg & ~lin_pos) | (is_one & (x < 0))
      d1 = torch.where(quad, D * x * jv, 0.0)
      d1 = d1 + torch.where(lin_neg, -fl * jv, 0.0)
      d1 = d1 + torch.where(lin_pos, fl * jv, 0.0)
      d2 = torch.where(quad, D * jv * jv, 0.0)
      return g0 + alpha * h0 + rowsum(d1), h0 + rowsum(d2)

    zero = torch.zeros((W, 1), dtype=dt, device=dev)
    p1_0, p2_0 = phi_d(zero)
    alpha0 = torch.clamp(-p1_0 / torch.clamp(p2_0, min=MINVAL), min=0.0)
    lo, p1_lo = zero, p1_0
    hi = torch.full_like(zero, float('inf'))
    p1_hi = torch.full_like(zero, float('inf'))
    for s in LS_SCALES:
      a = alpha0 * s
      p1_a, _ = phi_d(a)
      neg = p1_a < 0
      lo = torch.where(neg, a, lo)
      p1_lo = torch.where(neg, p1_a, p1_lo)
      first_pos = ~neg & ~torch.isfinite(hi)
      hi = torch.where(first_pos, a, hi)
      p1_hi = torch.where(first_pos, p1_a, p1_hi)
    diff = p1_hi - p1_lo
    secant = lo - p1_lo * (hi - lo) / torch.where(
        torch.abs(diff) < MINVAL, torch.ones_like(diff), diff)
    a_max = alpha0 * LS_SCALES[-1]
    p1_m, p2_m = phi_d(a_max)
    newton_tail = a_max - p1_m / torch.clamp(p2_m, min=MINVAL)
    alpha = torch.where(torch.isfinite(hi), secant,
                        torch.maximum(newton_tail, a_max))
    alpha_cap = 10.0 * a_max
    for _ in range(LS_POLISH):
      p1_a, p2_a = phi_d(alpha)
      neg = p1_a < 0
      lo = torch.where(neg, torch.maximum(lo, alpha), lo)
      hi = torch.where(neg, hi, torch.minimum(hi, alpha))
      step = alpha - p1_a / torch.clamp(p2_a, min=MINVAL)
      inside = (step > lo) & (step < hi)
      alpha = torch.where(inside, step, torch.where(
          torch.isfinite(hi), 0.5 * (lo + hi), torch.maximum(step, lo)))
      alpha = torch.minimum(torch.clamp(alpha, min=0.0), alpha_cap)
    return torch.where(p1_0 >= 0, 0.0, alpha)

  qacc = warmstart if use_warmstart else qacc_smooth
  ma = mv_qm(qacc)
  jaref = mv_j(qacc) - aref
  force, cost_c, quad = update_constraint(jaref)
  cost = cost_c + gauss_cost(qacc, ma)
  grad = ma - qfs - mv_jt(force)
  search = -newton_dir(grad, quad)
  done = torch.sqrt(rowsum(grad * grad)) / rescale < tol
  niter = torch.zeros((W, 1), dtype=torch.int32, device=dev)

  while not bool(done.all()):
    jv = mv_j(search)
    mv = mv_qm(search)
    alpha = torch.where(done, 0.0, linesearch(jaref, search, ma, jv, mv))
    qacc = qacc + alpha * search
    ma = ma + alpha * mv
    jaref = jaref + alpha * jv
    force, cost_c, quad = update_constraint(jaref)
    newcost = cost_c + gauss_cost(qacc, ma)
    grad = ma - qfs - mv_jt(force)
    mgrad = newton_dir(grad, quad)
    improvement = (cost - newcost) / rescale
    gradnorm = torch.sqrt(rowsum(grad * grad)) / rescale
    niter = niter + (~done).to(torch.int32)
    newdone = (done | (improvement < tol) | (gradnorm < tol) |
               (niter >= m.opt.iterations))
    search = torch.where(done, search, -mgrad)
    cost = torch.where(done, cost, newcost)
    done = newdone

  force, _, _ = update_constraint(jaref)
  qfrc_constraint = mv_jt(force)
  if hdiag is None:
    qacc_euler = qacc
  else:
    qacc_euler = cho_solve(cholesky(qM + torch.diag(hdiag)),
                           qfs + qfrc_constraint)
  return dict(qacc=qacc, qfrc_constraint=qfrc_constraint, efc_force=force,
              solver_niter=niter[:, 0], qacc_smooth=qacc_smooth, qLD=qld,
              qacc_euler=qacc_euler)
