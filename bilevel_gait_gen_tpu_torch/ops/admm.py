"""ADMM QP solver (OSQP-style operator splitting), the alternative backend
of ``mpc/solver.py``, batch first (port of
``bilevel_gait_gen_tpu/ops/admm.py``; the design notes are there).

Two-sided form, per scenario (every operand carries a leading scenario
dimension B):

    min 1/2 x^T P x + q^T x   s.t.  l <= A x <= u

Ruiz equilibration, a vector rho with equality rows boosted 1e3x, adaptive
rho refactoring the KKT matrix at four fixed segment boundaries,
over-relaxation, convergence freezing per scenario.  No hand-written
kernel: the JAX package's solver reaches no Pallas kernel either.

Capturable by a CUDA graph: the factorization is ``cholesky_ex`` (NaN
where it fails, as ``jnp.linalg.cholesky`` gives, and no status read back),
the solves two ``solve_triangular`` calls (``cholesky_solve`` is refused
under capture on the card), and the convergence flags and counts are
tensors; no Python branch looks at a value.  :func:`solve_primal` is
differentiable through the two-sided IFT adjoint of the reference
(``_solve_bwd``), a ``torch.autograd.Function``.
"""
from __future__ import annotations

import dataclasses

import torch

from bilevel_gait_gen_tpu_torch.ops import pdip
from bilevel_gait_gen_tpu_torch.utils import jnp_compat as jc


@dataclasses.dataclass(frozen=True)
class ADMMSolution:
    x: torch.Tensor        # [B, n]
    z: torch.Tensor        # [B, m] projected constraint value
    y: torch.Tensor        # [B, m] dual
    iters: torch.Tensor    # [B] int32
    pri_res: torch.Tensor  # [B]
    dua_res: torch.Tensor  # [B]


def _cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where the factorization fails."""
    L, info = torch.linalg.cholesky_ex(K)
    nan = torch.full((), float("nan"), dtype=K.dtype, device=K.device)
    return torch.where((info == 0)[..., None, None], L, nan)


def _cho_solve(L: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 r by two triangular solves, as the JAX package takes them
    (``torch.cholesky_solve`` may not run under a CUDA graph capture)."""
    z = torch.linalg.solve_triangular(L, r[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, z, upper=True)[..., 0]


def _ruiz_equilibrate(P, q, A, n_iters: int = 10):
    """Ruiz equilibration of [[P, A^T], [A, 0]] plus a cost scalar c.
    Returns (Ph, qh, Ah, d_x, d_c, c) with Ph = c Dx P Dx, Ah = Dc A Dx."""
    dtype, dev = q.dtype, q.device
    d_x = torch.ones(q.shape, dtype=dtype, device=dev)
    d_c = torch.ones(A.shape[:-1], dtype=dtype, device=dev)
    c = torch.ones(q.shape[:-1], dtype=dtype, device=dev)
    Ph, qh, Ah = P, q, A
    for _ in range(n_iters):
        # column norms of the stacked [Ph; Ah] block for the x scaling
        col = torch.sqrt(jc.maximum(torch.maximum(
            torch.amax(torch.abs(Ph), dim=-2),
            torch.amax(torch.abs(Ah), dim=-2)), 1e-8))
        row = torch.sqrt(jc.maximum(torch.amax(torch.abs(Ah), dim=-1), 1e-8))
        e_x = 1.0 / col
        e_c = 1.0 / row
        Ph = Ph * e_x[..., :, None] * e_x[..., None, :]
        qh = qh * e_x
        Ah = Ah * e_c[..., :, None] * e_x[..., None, :]
        d_x = d_x * e_x
        d_c = d_c * e_c
        # cost scaling: the quadratic part against the linear part
        g = 1.0 / jc.maximum(torch.maximum(
            torch.mean(torch.amax(torch.abs(Ph), dim=-2), dim=-1),
            torch.amax(torch.abs(qh), dim=-1)), 1e-8)
        Ph = Ph * g[..., None, None]
        qh = qh * g[..., None]
        c = c * g
    return Ph, qh, Ah, d_x, d_c, c


def solve(P: torch.Tensor, q: torch.Tensor, A: torch.Tensor, l: torch.Tensor,
          u: torch.Tensor, *, rho: float = 0.1, sigma: float = 1e-6,
          alpha: float = 1.6, iters: int = 200, tol: float = 1e-6,
          warm: ADMMSolution | None = None, scaling: int = 10,
          adaptive_rho: bool = True) -> ADMMSolution:
    """OSQP iteration for B scenarios: P [B, n, n], q [B, n], A [B, m, n],
    l and u [B, m].  Residuals are reported unscaled."""
    n = q.shape[-1]
    dtype, dev = q.dtype, q.device
    if scaling > 0:
        Ph, qh, Ah, d_x, d_c, c = _ruiz_equilibrate(P, q, A, scaling)
    else:
        Ph, qh, Ah = P, q, A
        d_x = torch.ones(q.shape, dtype=dtype, device=dev)
        d_c = torch.ones(l.shape, dtype=dtype, device=dev)
        c = torch.ones(q.shape[:-1], dtype=dtype, device=dev)
    lh = l * d_c
    uh = u * d_c
    is_eq = (u - l) < 1e-12
    inv_dx = 1.0 / d_x
    inv_dc = 1.0 / d_c

    if warm is None:
        x = torch.zeros_like(q)
        z = jc.clip(torch.zeros_like(l), lh, uh)
        y = torch.zeros_like(l)
    else:       # scale the unscaled warm start in
        x = warm.x * inv_dx
        z = jc.clip(warm.z * d_c, lh, uh)
        y = warm.y * c[..., None] * inv_dc

    # segments: refactor K when rho adapts (a fixed count)
    n_seg = 4 if adaptive_rho else 1
    seg_len = max(iters // n_seg, 1)
    rho_s = torch.full(q.shape[:-1], rho, dtype=dtype, device=dev)
    done = torch.zeros(q.shape[:-1], dtype=torch.bool, device=dev)
    it = torch.zeros(q.shape[:-1], dtype=torch.int32, device=dev)
    eye = torch.eye(n, dtype=dtype, device=dev)
    scale = 1.0 + torch.amax(torch.abs(q), dim=-1)
    AhT = Ah.mT.contiguous()        # A^T products without a copy each
    one = torch.ones((), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(n_seg):
        rho_vec = torch.where(is_eq, 1e3 * rho_s[..., None], rho_s[..., None])
        K = Ph + sigma * eye + (AhT * rho_vec[..., None, :]) @ Ah
        L = _cholesky(K)
        pri = dua = torch.zeros_like(scale)
        for _ in range(seg_len):
            rhs = sigma * x - qh + pdip._mv(AhT, rho_vec * z - y)
            x_t = _cho_solve(L, rhs)
            Ax_t = pdip._mv(Ah, x_t)
            z_t = alpha * Ax_t + (1 - alpha) * z
            x_new = alpha * x_t + (1 - alpha) * x
            z_new = jc.clip(z_t + y / rho_vec, lh, uh)
            y_new = y + rho_vec * (z_t - z_new)

            # unscaled residuals (x_u = Dx x, y_u = Dc y / c)
            Ax_u = pdip._mv(Ah, x_new) * inv_dc
            z_u = z_new * inv_dc
            pri = torch.amax(torch.abs(Ax_u - z_u), dim=-1)
            dua = torch.amax(torch.abs(
                (pdip._mv(Ph, x_new) + qh + pdip._mv(AhT, y_new)) * inv_dx),
                dim=-1) / c
            conv = (pri < tol * scale) & (dua < 1e2 * tol * scale)
            stop = done | conv
            take = (~stop)[..., None]
            x = torch.where(take, x_new, x)
            z = torch.where(take, z_new, z)
            y = torch.where(take, y_new, y)
            it = it + torch.where(stop, zero, one)
            done = stop
        # OSQP rho adaptation: sqrt of the residual ratio, clipped
        ratio = torch.sqrt((pri + 1e-12) / (dua + 1e-12))
        rho_s = jc.clip(rho_s * jc.clip(ratio, 0.1, 10.0), 1e-6, 1e6)

    # unscale (x = Dx x^, y = Dc y^ / c)
    x = x * d_x
    y = y * d_c / c[..., None]
    Ax = pdip._mv(A, x)
    z = jc.clip(Ax, l, u)
    pri = torch.amax(torch.abs(Ax - z), dim=-1)
    dua = torch.amax(torch.abs(pdip._mv(P, x) + q + pdip._mv(A.mT, y)), dim=-1)
    return ADMMSolution(x=x, z=z, y=y, iters=it, pri_res=pri, dua_res=dua)


def from_onesided(H, q, Aeq, beq, G, h):
    """The one-sided (pdip) form as the two-sided ADMM form."""
    A = torch.cat([Aeq, G], dim=-2)
    big = torch.full(h.shape, -1e30, dtype=q.dtype, device=q.device)
    l = torch.cat([beq, big], dim=-1)
    u = torch.cat([beq, h], dim=-1)
    return H, q, A, l, u


def solve_onesided(H, q, Aeq, beq, G, h, *, rho: float = 0.1,
                   iters: int = 400, tol: float = 1e-8,
                   warm: ADMMSolution | pdip.QPSolution | None = None
                   ) -> pdip.QPSolution:
    """Drive the two-sided ADMM from the one-sided MPC form and return a
    ``pdip.QPSolution``, so that ``mpc/solver.py`` can use ADMM as a
    drop-in backend.  ``warm`` takes an ADMMSolution or a pdip QPSolution
    of a previous step (x, the equality duals y and the inequality duals
    lam become the two-sided dual)."""
    P, q2, A, l, u = from_onesided(H, q, Aeq, beq, G, h)
    p = beq.shape[-1]
    m = h.shape[-1]
    aw = None
    if isinstance(warm, ADMMSolution):
        aw = warm
    elif warm is not None:
        zeros = torch.zeros_like(warm.gap)
        aw = ADMMSolution(x=warm.x, z=jc.clip(pdip._mv(A, warm.x), l, u),
                          y=torch.cat([warm.y, warm.lam], dim=-1),
                          iters=torch.zeros_like(warm.iters), pri_res=zeros,
                          dua_res=zeros)
    sol = solve(P, q2, A, l, u, rho=rho, iters=iters, tol=tol, warm=aw)
    y_eq = sol.y[..., :p]
    lam = jc.maximum(sol.y[..., p:], 0.0)
    s = jc.maximum(h - pdip._mv(G, sol.x), 0.0)
    gap = torch.abs(torch.sum(lam * s, dim=-1)) / max(m, 1)
    viol = torch.amax(jc.maximum(pdip._mv(G, sol.x) - h, 0.0), dim=-1)
    pri = (torch.maximum(torch.amax(torch.abs(pdip._mv(Aeq, sol.x) - beq),
                                    dim=-1), viol) if p > 0 else
           torch.maximum(torch.zeros_like(viol), viol))
    return pdip.QPSolution(x=sol.x, y=y_eq, lam=lam, s=s, iters=sol.iters,
                           gap=gap, pri_res=pri, dua_res=sol.dua_res)


# ----------------------------------------------------------------------------
# Differentiation: IFT adjoint in the two-sided form
# ----------------------------------------------------------------------------

class _SolvePrimal(torch.autograd.Function):
    """x*(P, q, A, l, u) with the two-sided IFT adjoint as its backward."""

    @staticmethod
    def forward(ctx, P, q, A, l, u, opts):
        sol = solve(P, q, A, l, u, **dict(opts))
        ctx.opts = opts
        ctx.save_for_backward(P, q, A, l, u, sol.x, sol.y)
        return sol.x

    @staticmethod
    def backward(ctx, gx):
        P, q, A, l, u, x, y = ctx.saved_tensors
        return (*_solve_bwd(ctx.opts, P, A, l, u, x, y, gx), None)


def solve_primal(P, q, A, l, u, opts: tuple = ()) -> torch.Tensor:
    """ADMM solve returning the primal x [B, n], differentiable with
    respect to all problem data through :func:`_solve_bwd`."""
    return _SolvePrimal.apply(P, q, A, l, u, tuple(opts))


def _solve_bwd(opts, P, A, l, u, x, y, gx):
    """Two-sided IFT adjoint.  Active rows (|y_i| above threshold or the
    bound gap below it) are treated as equalities A_act x = bnd with
    multiplier nu = y, in the penalized reduced form (P + A^T W A + reg I)
    vx = gx with W = w_act on active rows, vnu = W A vx; then
    dP = -(vx x^T + x vx^T) / 2, dq = -vx, dA = -(y vx^T + vnu x^T),
    dl = vnu on lower-active rows, du = vnu on upper-active ones."""
    o = dict(opts)
    dtype, dev = x.dtype, x.device
    n = x.shape[-1]
    eps = torch.finfo(dtype).eps
    absu = torch.abs(u)
    scale = (1.0 + torch.amax(absu * (absu < 1e20), dim=-1)
             + torch.amax(torch.abs(x), dim=-1))
    act_tol = (o.get("act_tol", 1e4 * eps) * scale)[..., None]
    y_tol = (o.get("y_tol", 1e4 * eps)
             * (1.0 + torch.amax(torch.abs(y), dim=-1)))[..., None]
    w_act = o.get("w_act", 0.01 / eps)
    reg = o.get("reg", 50.0 * eps)

    Ax = pdip._mv(A, x)
    low = ((Ax - l) < act_tol) | (y < -y_tol)
    up = ((u - Ax) < act_tol) | (y > y_tol)
    W = torch.where(low | up, torch.full((), w_act, dtype=dtype, device=dev),
                    0.0)
    M = (P + A.mT @ (A * W[..., None])
         + reg * torch.eye(n, dtype=dtype, device=dev))
    L = _cholesky(M)
    vx = _cho_solve(L, gx)
    # one refinement step against the penalized matrix
    vx = vx + _cho_solve(L, gx - pdip._mv(M, vx))
    vnu = W * pdip._mv(A, vx)

    def outer(a, b):
        return a[..., :, None] * b[..., None, :]

    dP = -0.5 * (outer(vx, x) + outer(x, vx))
    dq = -vx
    dA = -(outer(y, vx) + outer(vnu, x))
    dl = torch.where(low, vnu, 0.0)
    du = torch.where(up & ~low, vnu, 0.0)
    return dP, dq, dA, dl, du
