"""Constraint solvers for the pyramidal cone, batched over worlds.

`newton` is the plain PyTorch version of the solve inside kernels B3 and
B4; `newton_solve` is B4's plain version, `newton` under the signature of
the TPU kernel `newton_solve_batched`
(`mujoco_warp_tpu/pallas/solver_kernels.py:534`). It follows the
algorithm of `_newton_core` (:103): init (:446-466), the loop (:468-504),
and its linesearch (:398-444) — a fixed bracket of LS_K log-spaced
alphas, a secant, and 4 safeguarded Newton/bisection polish steps.

`solve` is the solve of the unfused step, Newton or CG, which the JAX
package runs as XLA (`mujoco_warp_tpu/solver.py`: `solve` :732 on its
unfused branch, `_solve_xla` :761, `_iteration` :551, `_update_gradient`
:350 and the `ls_parallel` `_linesearch` :481-525). Each Newton
direction solves H = qM + Jᵀ diag(D·quad) J with kernel B5; each CG
direction preconditions the gradient with the factor of qM in qLD,
through kernel B6 (a lower Cholesky factor, nv <= 32) or B8 (the packed
tree LD), and combines it with the last direction by Polak-Ribière.

In all, a world that has converged is frozen while the others iterate,
so each world's answer is the one a per-world loop gives.
"""

from __future__ import annotations

import numpy as np
import torch

from .io import efc_layout
from .kernels import batch_linalg as kb
from .types import ConstraintType, DisableBit, Model, SolverType

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


def newton_solve(m: Model, qM, J, D, aref, fl, qfrc_smooth, warmstart,
                 hb=None) -> dict:
  """Plain version of kernel B4: the Newton solve of `forward_batched`
  from qfrc_smooth, rows laid out as `efc_layout` says. hb (nv,), if
  given, is the integration diagonal h * damping of the re-solve for
  qacc_euler (`euler_damp` of the TPU kernel). Returns qacc,
  qfrc_constraint, efc_force, solver_niter, qacc_smooth, qLD (the lower
  Cholesky factor of qM) and qacc_euler."""
  ne, nf, _, _, _ = efc_layout(m, 0)
  return newton(m, qM, J, D, aref, fl, qfrc_smooth, warmstart, ne, nf,
                use_warmstart=not m.opt.disableflags & DisableBit.WARMSTART,
                hdiag=hb)


# calls of `solve` and the passes of their loops (Newton or CG) since the
# counts were last reset. Newton: B5 launches once per call and once per
# pass; CG: B6 or B8 does
counts = {'solve': 0, 'passes': 0}


def _row_masks(efc_type):
  """Equality, friction and one-sided rows from the efc types
  (solver._row_masks :216)."""
  is_eq = efc_type == ConstraintType.EQUALITY
  is_fr = ((efc_type == ConstraintType.FRICTION_DOF) |
           (efc_type == ConstraintType.FRICTION_TENDON))
  is_one = ~is_eq & ~is_fr & (efc_type != ConstraintType.CONTACT_ELLIPTIC)
  return is_eq, is_fr, is_one


def _linesearch_parallel(jaref, search, ma, qfrc_smooth, mv, jv, D, fl, rf,
                         is_eq, is_fr, is_one):
  """alpha (W,) of the exact piecewise-quadratic linesearch along search:
  LS_K log-spaced candidates around the unconstrained Newton step, a
  secant in the bracket (or a Newton step past the last candidate) and
  3 capped Newton polish steps (solver._linesearch :481-525)."""
  g0 = torch.sum(search * (ma - qfrc_smooth), -1)
  h0 = torch.sum(search * mv, -1)
  rows = lambda t: t[:, None]                 # (W, nj) -> (W, 1, nj)

  def phi_d(alpha):
    """(phi', phi'') at alpha (W, k) -> (W, k) each."""
    x = rows(jaref) + alpha[..., None] * rows(jv)
    lin_neg = rows(is_fr) & (x <= -rows(rf))
    lin_pos = rows(is_fr) & (x >= rows(rf))
    quad = rows(is_eq) | (rows(is_fr) & ~lin_neg & ~lin_pos) | (
        rows(is_one) & (x < 0.0))
    d1 = torch.where(quad, rows(D) * x * rows(jv), 0.0)
    d1 = d1 + torch.where(lin_neg, -rows(fl) * rows(jv), 0.0)
    d1 = d1 + torch.where(lin_pos, rows(fl) * rows(jv), 0.0)
    d2 = torch.where(quad, rows(D) * rows(jv) * rows(jv), 0.0)
    return (g0[:, None] + alpha * h0[:, None] + torch.sum(d1, -1),
            h0[:, None] + torch.sum(d2, -1))

  p1_0, p2_0 = phi_d(torch.zeros_like(g0)[:, None])
  alpha0 = torch.clamp(-p1_0 / torch.clamp(p2_0, min=MINVAL), min=0.0)
  scales = torch.tensor(LS_SCALES, dtype=jaref.dtype, device=jaref.device)
  alphas = alpha0 * scales                    # (W, K)
  p1_k, _ = phi_d(alphas)
  neg = p1_k < 0
  any_neg = neg.any(-1, keepdim=True)
  inf = torch.full_like(alphas, float('inf'))
  lo = torch.where(any_neg, torch.where(neg, alphas, 0.0).amax(
      -1, keepdim=True), 0.0)
  p1_lo = torch.where(any_neg, torch.where(neg, p1_k, -inf).amax(
      -1, keepdim=True), p1_0)
  hi = torch.where(neg, inf, alphas).amin(-1, keepdim=True)
  p1_hi = torch.where(neg, inf, p1_k).amin(-1, keepdim=True)
  diff = p1_hi - p1_lo
  secant = lo - p1_lo * (hi - lo) / torch.where(diff.abs() < MINVAL, 1.0,
                                                diff)
  a_max = alphas[:, -1:]
  p1_m, p2_m = phi_d(a_max)
  newton_tail = a_max - p1_m / torch.clamp(p2_m, min=MINVAL)
  alpha = torch.where(torch.isfinite(hi), secant,
                      torch.clamp(newton_tail, min=0.0))
  alpha_cap = 10.0 * a_max
  for _ in range(3):
    p1_a, p2_a = phi_d(alpha)
    alpha = alpha - p1_a / torch.clamp(p2_a, min=MINVAL)
    alpha = torch.minimum(torch.clamp(alpha, min=0.0), alpha_cap)
  return torch.where(p1_0 >= 0, 0.0, alpha)[:, 0]


def solve(m: Model, qM, J, D, aref, fl, efc_type, qfrc_smooth, qacc_smooth,
          qacc_warmstart, qLD=None) -> dict:
  """Newton or CG solve (m.opt.solver) of the unfused step for J (W, nj,
  nv), its rows typed by efc_type. CG reads qLD, the factor of qM that
  `kernels.batch_linalg.m_solve_factor` returned. Loops until every world
  is done, so the loop's passes (added to counts['passes']) are the
  slowest world's solver_niter; returns qacc, qfrc_constraint, efc_force
  and solver_niter (W,)."""
  W, nj, nv = J.shape
  counts['solve'] += 1
  if (nj == 0 or nv == 0 or m.opt.iterations == 0 or
      m.opt.disableflags & DisableBit.CONSTRAINT):
    return dict(qacc=qacc_smooth, qfrc_constraint=torch.zeros_like(
        qacc_smooth), efc_force=torch.zeros_like(D),
                solver_niter=torch.zeros(W, dtype=torch.int32,
                                         device=J.device))
  if not m.opt.ls_parallel:
    raise NotImplementedError('the iterative linesearch (ls_parallel=False)'
                              ' is not ported yet')
  cg = m.opt.solver == SolverType.CG
  if cg and qLD is None:
    raise ValueError('the CG solver needs qLD, the factor of qM')
  tol = m.opt.tolerance
  rescale = lambda v: v / (torch.clamp(m.stat.meaninertia, min=MINVAL) *
                           max(1, nv))
  is_eq, is_fr, is_one = _row_masks(efc_type)
  rf = fl / torch.clamp(D, min=MINVAL)
  mv_qm = lambda x: torch.einsum('wij,wj->wi', qM, x)
  mv_j = lambda x: torch.einsum('wrn,wn->wr', J, x)
  mv_jt = lambda y: torch.einsum('wrn,wr->wn', J, y)

  def constraint(jaref):
    force, cost, quad = _update_constraint(jaref, D, fl, rf, is_eq, is_fr,
                                           is_one)
    return force, mv_jt(force), cost[:, 0], quad

  def gradient(ma, qfrc_constraint, quad):
    grad = ma - qfrc_smooth - qfrc_constraint
    if cg:
      return grad, kb.m_cho_solve(qLD, grad, m.dof_parentid)
    jd = J * (D * quad.to(D.dtype))[..., None]
    H = qM + torch.bmm(jd.transpose(1, 2), J)
    return grad, kb.spd_solve(H, grad)

  def gauss(qacc, ma):
    return 0.5 * torch.sum((ma - qfrc_smooth) * (qacc - qacc_smooth), -1)

  use_ws = not m.opt.disableflags & DisableBit.WARMSTART
  qacc = qacc_warmstart if use_ws else qacc_smooth
  ma = mv_qm(qacc)
  jaref = mv_j(qacc) - aref
  force, qfrc_constraint, cost_c, quad = constraint(jaref)
  cost = cost_c + gauss(qacc, ma)
  grad, mgrad = gradient(ma, qfrc_constraint, quad)
  search = -mgrad
  prev_grad, prev_mgrad = grad, mgrad         # read by CG alone
  niter = torch.zeros(W, dtype=torch.int32, device=J.device)
  done = rescale(torch.sqrt(torch.sum(grad * grad, -1))) < tol
  while not bool(done.all()):
    mv, jv = mv_qm(search), mv_j(search)
    alpha = _linesearch_parallel(jaref, search, ma, qfrc_smooth, mv, jv, D,
                                 fl, rf, is_eq, is_fr, is_one)[:, None]
    n_qacc = qacc + alpha * search
    n_ma = ma + alpha * mv
    n_jaref = jaref + alpha * jv
    n_force, n_qfc, cost_c, quad = constraint(n_jaref)
    n_cost = cost_c + gauss(n_qacc, n_ma)
    n_grad, mgrad = gradient(n_ma, n_qfc, quad)
    n_search = -mgrad
    if cg:                                    # Polak-Ribière
      beta_den = torch.clamp(torch.sum(prev_grad * prev_mgrad, -1),
                             min=MINVAL)
      beta = torch.clamp(torch.sum(n_grad * (mgrad - prev_mgrad), -1) /
                         beta_den, min=0.0)
      n_search = n_search + beta[:, None] * search
    improvement = rescale(cost - n_cost)
    gradnorm = rescale(torch.sqrt(torch.sum(n_grad * n_grad, -1)))
    n_niter = niter + 1
    n_done = (done | (improvement < tol) | (gradnorm < tol) |
              (n_niter >= m.opt.iterations))
    # masked commit: converged worlds keep their state
    keep = done[:, None]
    qacc = torch.where(keep, qacc, n_qacc)
    ma = torch.where(keep, ma, n_ma)
    jaref = torch.where(keep, jaref, n_jaref)
    force = torch.where(keep, force, n_force)
    qfrc_constraint = torch.where(keep, qfrc_constraint, n_qfc)
    search = torch.where(keep, search, n_search)
    if cg:
      prev_grad = torch.where(keep, prev_grad, n_grad)
      prev_mgrad = torch.where(keep, prev_mgrad, mgrad)
    cost = torch.where(done, cost, n_cost)
    niter = torch.where(done, niter, n_niter)
    done = n_done
    counts['passes'] += 1
  return dict(qacc=qacc, qfrc_constraint=qfrc_constraint, efc_force=force,
              solver_niter=niter)
