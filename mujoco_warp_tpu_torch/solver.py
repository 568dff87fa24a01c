"""Constraint solvers for the pyramidal and the elliptic cone, batched
over worlds.

`newton` is the plain PyTorch version of the solve inside kernels B3 and
B4 (and B3e and B4-elliptic, with the cone); `newton_solve` is B4's
plain version, `newton` under the signature of the TPU kernel
`newton_solve_batched` (`mujoco_warp_tpu/pallas/solver_kernels.py:534`).
It follows the algorithm of `_newton_core` (:103): init (:446-466), the
loop (:468-504), and its linesearch (:398-444) — a fixed bracket of LS_K
log-spaced alphas, a secant, and 4 safeguarded Newton/bisection polish
steps — and its cone code (:139-178 precompute, :213-245 constraint
update, :283-346 Hessian, :351-390 linesearch terms), in `Cone`.

`solve` is the solve of the unfused step, Newton or CG, which the JAX
package runs as XLA (`mujoco_warp_tpu/solver.py`: `solve` :732 on its
unfused branch, `_solve_xla` :761, `_iteration` :551, `_update_gradient`
:350, `_linesearch` :407 with its `ls_parallel` branch :481-525 and its
iterative branch :527-547, the elliptic cone :225-345). Each Newton
direction solves H = qM + Jᵀ diag(D·quad) J (+ the cone's blocks) with
kernel B5; each CG direction preconditions the gradient with the factor
of qM in qLD, through kernel B6 (a lower Cholesky factor, nv <= 32) or
B8 (the packed tree LD), and combines it with the last direction by
Polak-Ribière.

In all, a world that has converged is frozen while the others iterate,
so each world's answer is the one a per-world loop gives.
"""

from __future__ import annotations

import numpy as np
import torch

from .io import efc_layout
from .kernels import batch_linalg as kb
from .types import ConeType, ConstraintType, DisableBit, Model, SolverType

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


def cone_inputs(m: Model, contact):
  """(friction (W, C, 5), dim (W, C) int32 with 0 in empty slots,
  impratio) of the elliptic cone, as the JAX package hands them to its
  Newton kernels (`forward.py:494-502`, `solver.py:620-627`), or None
  where it builds no cone: a pyramidal model, an empty pool, or contacts
  of one row each (stride < 2)."""
  nconmax = contact.dist.shape[1]
  stride = efc_layout(m, nconmax)[3]
  if m.opt.cone != ConeType.ELLIPTIC or nconmax == 0 or stride < 2:
    return None
  dim = torch.where(contact.geom[..., 0] >= 0, contact.dim, 0)
  return contact.friction, dim.to(torch.int32), m.opt.impratio


def _zones(N, T, mu, is_ell):
  """Bottom and middle zones of the cone (the top zone acts not at all);
  only elliptic contacts have them."""
  top = N >= mu * T
  bottom = ~top & (mu * N + T <= 0.0)
  middle = ~top & ~bottom
  return bottom & is_ell, middle & is_ell


class Cone:
  """The elliptic cone of one solve: the contact rows [base, base + C·S)
  of the efc layout in blocks of S per contact; per contact the scales
  s (row 0: mu = friction[0] / sqrt(impratio), row r >= 1:
  friction[min(r - 1, 4)]), the rows it has (r < dim), whether it is
  elliptic (dim > 1; dim-1 contacts keep the one-sided row) and
  Dm = D_0 / (mu² (1 + mu²)) (`_newton_core` :139-178, the XLA
  `_elliptic_quantities` :238)."""

  def __init__(self, m: Model, D, inputs):
    friction, dim, impratio = inputs
    W, nj = D.shape
    C = friction.shape[1]
    ne, nf, nl, S, njmax = efc_layout(m, C)
    if njmax != nj:
      raise ValueError(f'cone: {nj} efc rows, the layout has {njmax}')
    self.base, self.S, self.C = ne + nf + nl, S, C
    r = torch.arange(S, device=D.device)
    self.mu = friction[..., 0] / torch.sqrt(torch.clamp(impratio,
                                                        min=MINVAL))
    self.s = torch.where(r == 0, self.mu[..., None],
                         friction[..., torch.clamp(r - 1, 0, 4)])
    self.rv = (r < dim[..., None]).to(D.dtype)
    self.is_ell = dim > 1
    self.d_blk = self.blocks(D)
    mu2 = self.mu * self.mu
    self.dm = self.d_blk[..., 0] / torch.clamp(mu2 * (1.0 + mu2),
                                               min=MINVAL)
    self.ell_rows = torch.cat([
        torch.zeros((W, self.base), dtype=torch.bool, device=D.device),
        self.is_ell[..., None].expand(W, C, S).reshape(W, C * S)], 1)

  def blocks(self, vec):
    """(..., nj) -> the contact rows (..., C, S)."""
    return vec[..., self.base:].reshape(vec.shape[:-1] + (self.C, self.S))

  def _xu(self, jaref):
    x = self.blocks(jaref) * self.rv
    u = x * self.s
    T = torch.sqrt(torch.clamp(torch.sum(u[..., 1:] ** 2, -1), min=0.0))
    return x, u, u[..., 0], T

  def update(self, jaref, force, cost, quad):
    """force, cost (W, 1) and quad with the elliptic contacts' rows set
    to the cone's forces, cost and quadratic (bottom-zone) rows, and the
    middle-zone mask (W, C); the row handling before must have given
    those rows nothing (`_newton_core` :213-245, `_update_constraint`
    :295-337)."""
    x, u, N, T = self._xu(jaref)
    bottom, middle = _zones(N, T, self.mu, self.is_ell)
    mu, dm, rv = self.mu, self.dm, self.rv
    nmt = N - mu * T
    f_norm = -dm * nmt * mu
    t_safe = torch.clamp(T, min=MINVAL)
    f_fric = -(f_norm / t_safe)[..., None] * (u * self.s)
    f_mid = torch.cat([f_norm[..., None], f_fric[..., 1:]], -1)
    f_bot = -self.d_blk * x
    f_blk = torch.where(middle[..., None], f_mid, torch.where(
        bottom[..., None], f_bot, 0.0)) * rv
    c_mid = 0.5 * dm * nmt * nmt
    c_bot = torch.sum(0.5 * self.d_blk * x * x * rv, -1)
    c_blk = torch.where(middle, c_mid, torch.where(bottom, c_bot, 0.0))
    quad_blk = bottom[..., None] & (rv > 0)
    flat = lambda t: t.reshape(t.shape[0], -1)
    tail = self.ell_rows[:, self.base:]
    force = torch.cat([force[:, :self.base], torch.where(
        tail, flat(f_blk), force[:, self.base:])], 1)
    quad = torch.cat([quad[:, :self.base], torch.where(
        tail, flat(quad_blk), quad[:, self.base:])], 1)
    return (force, cost + torch.sum(c_blk, 1, keepdim=True), quad,
            middle)

  def hessian(self, J, jaref, middle):
    """Jcᵀ C Jc (W, nv, nv): the cone-surface blocks C of the contacts in
    the middle zone (`_newton_core` :283-329, `_update_gradient`
    :361-393)."""
    _, u, N, T = self._xu(jaref)
    mu, S = self.mu, self.S
    t_safe = torch.clamp(T, min=MINVAL)
    t3 = torch.clamp(T * t_safe * t_safe, min=MINVAL)
    hc = (mu * N / t3)[..., None, None] * u[..., :, None] * u[..., None, :]
    eye = torch.eye(S, dtype=u.dtype, device=u.device)
    hc = hc + eye * (mu * mu - mu * N / t_safe)[..., None, None]
    edge = -(mu / t_safe)[..., None] * u
    hc[..., 0, :] = edge
    hc[..., :, 0] = edge
    hc[..., 0, 0] = 1.0
    scale = (self.dm[..., None, None] * self.s[..., :, None] *
             self.s[..., None, :])
    rv = self.rv > 0
    mask = middle[..., None, None] & rv[..., :, None] & rv[..., None, :]
    blk = torch.where(mask, hc * scale, 0.0)
    Jc = J[:, self.base:].reshape(J.shape[0], self.C, S, J.shape[2])
    return torch.einsum('wcsn,wcst,wctk->wnk', Jc, blk, Jc)

  def line(self, jaref, jv):
    """phi(x) -> the cone's terms (phi', phi'') (W, A) of the linesearch at
    x = jaref + alpha jv (W, A, nj) (`_newton_core` :351-390,
    `_linesearch` :424-473)."""
    e = lambda t: t[:, None]
    jvb = self.blocks(jv) * self.rv
    vb = jvb * self.s
    v1, vfr2 = vb[..., 0], torch.sum(vb[..., 1:] ** 2, -1)
    mu, dm = e(self.mu), e(self.dm)

    def phi(x):
      xb = self.blocks(x) * e(self.rv)
      ub = xb * e(self.s)
      n_a = ub[..., 0]
      t_a = torch.sqrt(torch.clamp(torch.sum(ub[..., 1:] ** 2, -1),
                                   min=MINVAL))
      t1 = torch.sum(ub[..., 1:] * e(vb)[..., 1:], -1) / t_a
      t2 = (e(vfr2) - t1 * t1) / t_a
      bottom, middle = _zones(n_a, t_a, mu, e(self.is_ell))
      nmt = n_a - mu * t_a
      n1mt1 = e(v1) - mu * t1
      d1_mid = dm * nmt * n1mt1
      d2_mid = dm * (n1mt1 * n1mt1 - nmt * mu * t2)
      d1_bot = torch.sum(e(self.d_blk) * xb * e(jvb), -1)
      d2_bot = torch.sum(e(self.d_blk) * e(jvb) * e(jvb), -1)
      d1 = torch.where(middle, d1_mid, torch.where(bottom, d1_bot, 0.0))
      d2 = torch.where(middle, d2_mid, torch.where(bottom, d2_bot, 0.0))
      return torch.sum(d1, -1), torch.sum(d2, -1)
    return phi


def _tikhonov(H):
  """H + 1e-7 tr(H) / nv I: the relative floor that keeps the cone's
  Hessian factorizable in float32 (`_newton_core` :330-343, XLA
  `_update_gradient` :394-400)."""
  nv = H.shape[-1]
  tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) / nv
  return H + (1e-7 * tr)[:, None, None] * torch.eye(nv, dtype=H.dtype,
                                                   device=H.device)


def _constraint(jaref, D, fl, rf, masks, cone):
  """Forces, cost (W, 1), quadratic rows and the cone's middle zone (None
  without a cone)."""
  force, cost, quad = _update_constraint(jaref, D, fl, rf, *masks)
  if cone is None:
    return force, cost, quad, None
  return cone.update(jaref, force, cost, quad)


def objective(qM, J, D, aref, fl, qfrc_smooth, qacc_smooth, qacc, ne: int,
              nf: int, cone: Cone | None = None) -> torch.Tensor:
  """The cost the Newton solve minimizes, (W,), at qacc: the Gauss term
  0.5 (M qacc - qfrc_smooth) . (qacc - qacc_smooth) plus the constraint
  cost of jaref = J qacc - aref (with the elliptic cone's, given its
  `Cone`)."""
  ma = torch.einsum('wij,wj->wi', qM, qacc)
  jaref = torch.einsum('wrn,wn->wr', J, qacc) - aref
  rf = fl / torch.clamp(D, min=MINVAL)
  is_eq, is_fr, is_one = _classes(J.shape[1], ne, nf, J.device)
  if cone is not None:
    is_one = is_one & ~cone.ell_rows
  _, cost, _, _ = _constraint(jaref, D, fl, rf, (is_eq, is_fr, is_one),
                              cone)
  gauss = 0.5 * torch.sum((ma - qfrc_smooth) * (qacc - qacc_smooth), 1)
  return gauss + cost[:, 0]


def _phi(jaref, search, ma, qfrc_smooth, mv, jv, D, fl, rf, masks, cone):
  """phi_d(alpha (W, k)) -> (phi', phi'') (W, k) of the cost along
  search at the k step lengths alpha."""
  is_eq, is_fr, is_one = (t[:, None] if t.dim() == 2 else t for t in masks)
  g0 = torch.sum(search * (ma - qfrc_smooth), -1)[:, None]
  h0 = torch.sum(search * mv, -1)[:, None]
  rows = lambda t: t[:, None]                 # (W, nj) -> (W, 1, nj)
  cone_phi = cone.line(jaref, jv) if cone is not None else None

  def phi_d(alpha):
    x = rows(jaref) + alpha[..., None] * rows(jv)
    lin_neg = is_fr & (x <= -rows(rf))
    lin_pos = is_fr & (x >= rows(rf))
    quad = is_eq | (is_fr & ~lin_neg & ~lin_pos) | (is_one & (x < 0.0))
    d1 = torch.where(quad, rows(D) * x * rows(jv), 0.0)
    d1 = d1 + torch.where(lin_neg, -rows(fl) * rows(jv), 0.0)
    d1 = d1 + torch.where(lin_pos, rows(fl) * rows(jv), 0.0)
    d2 = torch.where(quad, rows(D) * rows(jv) * rows(jv), 0.0)
    p1 = g0 + alpha * h0 + torch.sum(d1, -1)
    p2 = h0 + torch.sum(d2, -1)
    if cone_phi is not None:
      c1, c2 = cone_phi(x)
      p1, p2 = p1 + c1, p2 + c2
    return p1, p2
  return phi_d


def newton(m: Model, qM, J, D, aref, fl, qfrc_smooth, warmstart, ne: int,
           nf: int, use_warmstart: bool = True, hdiag=None,
           cone=None) -> dict:
  """Solve for qacc with J (W, nj, nv) rows: [0, ne) equality, [ne,
  ne + nf) friction, the rest one-sided, or with `cone` (`cone_inputs`)
  the elliptic contacts' blocks. hdiag (nv,) or per world (W, nv), if
  given, is the integration diagonal of the final re-solve (qM +
  diag(hdiag)) qacc_euler = qfrc_smooth + qfrc_constraint; without it
  qacc_euler = qacc."""
  W, nj, nv = J.shape
  dev, dt = J.device, J.dtype
  tol = m.opt.tolerance
  rescale = torch.clamp(m.stat.meaninertia, min=MINVAL) * max(1, nv)
  is_eq, is_fr, is_one = _classes(nj, ne, nf, dev)
  K = Cone(m, D, cone) if cone is not None else None
  if K is not None:
    is_one = is_one & ~K.ell_rows
  masks = (is_eq, is_fr, is_one)
  rf = fl / torch.clamp(D, min=MINVAL)
  qfs = qfrc_smooth

  qld = cholesky(qM)
  qacc_smooth = cho_solve(qld, qfs)
  mv_qm = lambda x: torch.einsum('wij,wj->wi', qM, x)
  mv_j = lambda x: torch.einsum('wrn,wn->wr', J, x)
  mv_jt = lambda y: torch.einsum('wrn,wr->wn', J, y)
  rowsum = lambda x: torch.sum(x, 1, keepdim=True)

  def update_constraint(jaref):
    return _constraint(jaref, D, fl, rf, masks, K)

  def gauss_cost(qacc, ma):
    return 0.5 * rowsum((ma - qfs) * (qacc - qacc_smooth))

  def newton_dir(grad, quad, jaref, middle):
    dh = D * quad.to(dt)
    H = qM + torch.einsum('wrn,wr,wrm->wnm', J, dh, J)
    if K is not None:
      H = _tikhonov(H + K.hessian(J, jaref, middle))
    return cho_solve(cholesky(H), grad)

  def linesearch(jaref, search, ma, jv, mv):
    phi_d = _phi(jaref, search, ma, qfs, mv, jv, D, fl, rf, masks, K)
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
  force, cost_c, quad, middle = update_constraint(jaref)
  cost = cost_c + gauss_cost(qacc, ma)
  grad = ma - qfs - mv_jt(force)
  search = -newton_dir(grad, quad, jaref, middle)
  done = torch.sqrt(rowsum(grad * grad)) / rescale < tol
  niter = torch.zeros((W, 1), dtype=torch.int32, device=dev)

  while not bool(done.all()):
    jv = mv_j(search)
    mv = mv_qm(search)
    alpha = torch.where(done, 0.0, linesearch(jaref, search, ma, jv, mv))
    qacc = qacc + alpha * search
    ma = ma + alpha * mv
    jaref = jaref + alpha * jv
    force, cost_c, quad, middle = update_constraint(jaref)
    newcost = cost_c + gauss_cost(qacc, ma)
    grad = ma - qfs - mv_jt(force)
    mgrad = newton_dir(grad, quad, jaref, middle)
    improvement = (cost - newcost) / rescale
    gradnorm = torch.sqrt(rowsum(grad * grad)) / rescale
    niter = niter + (~done).to(torch.int32)
    newdone = (done | (improvement < tol) | (gradnorm < tol) |
               (niter >= m.opt.iterations))
    search = torch.where(done, search, -mgrad)
    cost = torch.where(done, cost, newcost)
    done = newdone

  force = update_constraint(jaref)[0]
  qfrc_constraint = mv_jt(force)
  if hdiag is None:
    qacc_euler = qacc
  else:
    qacc_euler = cho_solve(cholesky(qM + torch.diag_embed(hdiag)),
                           qfs + qfrc_constraint)
  return dict(qacc=qacc, qfrc_constraint=qfrc_constraint, efc_force=force,
              solver_niter=niter[:, 0], qacc_smooth=qacc_smooth, qLD=qld,
              qacc_euler=qacc_euler)


def newton_solve(m: Model, qM, J, D, aref, fl, qfrc_smooth, warmstart,
                 hb=None, cone=None) -> dict:
  """Plain version of kernel B4 (B4-elliptic with `cone`, the
  `cone_inputs` of the contacts): the Newton solve of `forward_batched`
  from qfrc_smooth, rows laid out as `efc_layout` says. hb (nv,), if
  given, is the integration diagonal h * damping of the re-solve for
  qacc_euler (`euler_damp` of the TPU kernel). Returns qacc,
  qfrc_constraint, efc_force, solver_niter, qacc_smooth, qLD (the lower
  Cholesky factor of qM) and qacc_euler."""
  ne, nf, _, _, _ = efc_layout(m, 0)
  return newton(m, qM, J, D, aref, fl, qfrc_smooth, warmstart, ne, nf,
                use_warmstart=not m.opt.disableflags & DisableBit.WARMSTART,
                hdiag=hb, cone=cone)


# calls of `solve`, the passes of their loops (Newton or CG) and the steps
# of the iterative linesearch (the slowest world's, summed over passes)
# since the counts were last reset. Newton: B5 launches once per call and
# once per pass; CG: B6 or B8 does
counts = {'solve': 0, 'passes': 0, 'linesearch': 0}


def _row_masks(efc_type):
  """Equality, friction and one-sided rows from the efc types
  (solver._row_masks :216); elliptic rows are none of them."""
  is_eq = efc_type == ConstraintType.EQUALITY
  is_fr = ((efc_type == ConstraintType.FRICTION_DOF) |
           (efc_type == ConstraintType.FRICTION_TENDON))
  is_one = ~is_eq & ~is_fr & (efc_type != ConstraintType.CONTACT_ELLIPTIC)
  return is_eq, is_fr, is_one


def _linesearch_parallel(phi_d, p1_0, p2_0):
  """alpha (W,) of the exact piecewise-quadratic linesearch: LS_K
  log-spaced candidates around the unconstrained Newton step, a secant
  in the bracket (or a Newton step past the last candidate) and 3 capped
  Newton polish steps (solver._linesearch :481-525)."""
  alpha0 = torch.clamp(-p1_0 / torch.clamp(p2_0, min=MINVAL), min=0.0)
  scales = torch.tensor(LS_SCALES, dtype=p1_0.dtype, device=p1_0.device)
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


def _linesearch_iterative(phi_d, p1_0, p2_0, m: Model, nv: int):
  """alpha (W,) of the iterative linesearch (solver._linesearch
  :527-547): from the unconstrained Newton step, ls_iterations steps of
  Newton inside the bracket, bisection outside it, or growth until phi'
  turns positive; a world stops once |phi'| < ls_tolerance ·
  meaninertia · nv. The loop ends early once every world has stopped,
  which changes no alpha."""
  alpha = torch.clamp(-p1_0 / torch.clamp(p2_0, min=MINVAL), min=0.0)
  lo, hi = torch.zeros_like(alpha), alpha
  has_hi = torch.zeros_like(p1_0, dtype=torch.bool)
  done = p1_0 >= 0
  tol = m.opt.ls_tolerance * torch.clamp(m.stat.meaninertia,
                                         min=MINVAL) * max(1, nv)
  for _ in range(m.opt.ls_iterations):
    if bool(done.all()):
      break
    counts['linesearch'] += 1
    p1, p2 = phi_d(alpha)
    lo = torch.where(p1 < 0, alpha, lo)
    hi = torch.where(p1 >= 0, alpha, hi)
    has_hi = has_hi | (p1 >= 0)
    step = alpha - p1 / torch.clamp(p2, min=MINVAL)
    grow = torch.maximum(step, 2.0 * torch.clamp(alpha, min=1.0))
    inside = (step > lo) & (step < hi)
    nxt = torch.where(has_hi, torch.where(inside, step, 0.5 * (lo + hi)),
                      grow)
    done = done | (torch.abs(p1) < tol)
    alpha = torch.where(done, alpha, nxt)
  return torch.where(p1_0 >= 0, 0.0, alpha)[:, 0]


def solve(m: Model, qM, J, D, aref, fl, efc_type, qfrc_smooth, qacc_smooth,
          qacc_warmstart, qLD=None, cone=None) -> dict:
  """Newton or CG solve (m.opt.solver) of the unfused step for J (W, nj,
  nv), its rows typed by efc_type; `cone` (`cone_inputs`) adds the
  elliptic contacts' blocks. The linesearch is the parallel one or, with
  `ls_parallel` off (as `put_model` and `override_model` set it for the
  elliptic cone), the iterative one. CG reads qLD, the factor of qM that
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
  cg = m.opt.solver == SolverType.CG
  if cg and qLD is None:
    raise ValueError('the CG solver needs qLD, the factor of qM')
  tol = m.opt.tolerance
  rescale = lambda v: v / (torch.clamp(m.stat.meaninertia, min=MINVAL) *
                           max(1, nv))
  masks = _row_masks(efc_type)
  K = Cone(m, D, cone) if cone is not None else None
  rf = fl / torch.clamp(D, min=MINVAL)
  mv_qm = lambda x: torch.einsum('wij,wj->wi', qM, x)
  mv_j = lambda x: torch.einsum('wrn,wn->wr', J, x)
  mv_jt = lambda y: torch.einsum('wrn,wr->wn', J, y)

  def constraint(jaref):
    force, cost, quad, middle = _constraint(jaref, D, fl, rf, masks, K)
    return force, mv_jt(force), cost[:, 0], quad, middle

  def gradient(ma, qfrc_constraint, quad, jaref, middle):
    grad = ma - qfrc_smooth - qfrc_constraint
    if cg:
      return grad, kb.m_cho_solve(qLD, grad, m.dof_parentid)
    jd = J * (D * quad.to(D.dtype))[..., None]
    H = qM + torch.bmm(jd.transpose(1, 2), J)
    if K is not None:
      H = _tikhonov(H + K.hessian(J, jaref, middle))
    return grad, kb.spd_solve(H, grad)

  def gauss(qacc, ma):
    return 0.5 * torch.sum((ma - qfrc_smooth) * (qacc - qacc_smooth), -1)

  def linesearch(jaref, search, ma, mv, jv):
    phi_d = _phi(jaref, search, ma, qfrc_smooth, mv, jv, D, fl, rf, masks,
                 K)
    p1_0, p2_0 = phi_d(torch.zeros((W, 1), dtype=J.dtype, device=J.device))
    if m.opt.ls_parallel:
      return _linesearch_parallel(phi_d, p1_0, p2_0)
    return _linesearch_iterative(phi_d, p1_0, p2_0, m, nv)

  use_ws = not m.opt.disableflags & DisableBit.WARMSTART
  qacc = qacc_warmstart if use_ws else qacc_smooth
  ma = mv_qm(qacc)
  jaref = mv_j(qacc) - aref
  force, qfrc_constraint, cost_c, quad, middle = constraint(jaref)
  cost = cost_c + gauss(qacc, ma)
  grad, mgrad = gradient(ma, qfrc_constraint, quad, jaref, middle)
  search = -mgrad
  prev_grad, prev_mgrad = grad, mgrad         # read by CG alone
  niter = torch.zeros(W, dtype=torch.int32, device=J.device)
  done = rescale(torch.sqrt(torch.sum(grad * grad, -1))) < tol
  while not bool(done.all()):
    mv, jv = mv_qm(search), mv_j(search)
    alpha = linesearch(jaref, search, ma, mv, jv)[:, None]
    n_qacc = qacc + alpha * search
    n_ma = ma + alpha * mv
    n_jaref = jaref + alpha * jv
    n_force, n_qfc, cost_c, quad, middle = constraint(n_jaref)
    n_cost = cost_c + gauss(n_qacc, n_ma)
    n_grad, mgrad = gradient(n_ma, n_qfc, quad, n_jaref, middle)
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
