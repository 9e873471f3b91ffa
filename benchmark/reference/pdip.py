"""Dense predictor-corrector interior-point QP solver with the IFT adjoint
(port of ``bilevel_gait_gen_tpu/ops/pdip.py``; the design notes are there).

Problem form, per scenario (batch first: every operand carries a leading
scenario dimension B):

    min 1/2 x^T H x + q^T x   s.t.  A x = b,  G x <= h

Each sweep, in tensor code: M = H + G^T W G + reg I, an exact inverse
(``inverse``: "chol" the Cholesky, "schur" the shifted recursive Schur
inverse) or a Newton-Schulz refresh of the carried one, then
:func:`_iteration_math` (the port's fused sweep kernel computes the same
sweep on padded operands).

``torch.linalg.cholesky`` raises on a matrix that is not positive definite
where ``jnp.linalg.cholesky`` returns NaN; the solver's guards (the
Newton-Schulz fallback, ``step_ok``, the solver's quality gate) rely on the
NaN, so :func:`_chol_inverse` uses ``cholesky_ex`` and fills the failed
problems with NaN instead of failing the batch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import jnp_compat as jc


@dataclasses.dataclass(frozen=True)
class QPSolution:
    x: torch.Tensor        # [B, n] primal
    y: torch.Tensor        # [B, p] equality duals
    lam: torch.Tensor      # [B, m] inequality duals (>= 0)
    s: torch.Tensor        # [B, m] slacks (>= 0)
    iters: torch.Tensor    # [B] int32 iterations until convergence
    gap: torch.Tensor      # [B] final complementarity gap
    pri_res: torch.Tensor  # [B] final primal residual (inf-norm)
    dua_res: torch.Tensor  # [B] final dual residual (inf-norm)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched M @ v: [B, r, c] x [B, c] -> [B, r]."""
    return jc.matvec(M, v)


def _vtm(v: torch.Tensor, M: torch.Tensor,
         Mt: torch.Tensor | None = None) -> torch.Tensor:
    """Batched M^T @ v: [B, r] x [B, r, c] -> [B, c] (``Mt``: M's
    ``jnp_compat.transposed``, made once a solve)."""
    return jc.vecmat(v, M, Mt)


def _amax_abs(v: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(v), dim=-1)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _equilibrate(H, q, A, b, G, h):
    """Ruiz-style diagonal equilibration: x = d * xt, y = e_a * yt,
    lam = e_g * lamt, s = st / e_g."""
    dg = torch.diagonal(H, dim1=-2, dim2=-1)
    floor = 1e-8 * torch.clamp_min(torch.amax(dg, dim=-1, keepdim=True), 1.0)
    d = 1.0 / torch.sqrt(torch.maximum(dg, floor))
    Hs = H * d[..., :, None] * d[..., None, :]
    qs = q * d
    Ad = A * d[..., None, :]
    ra = torch.linalg.vector_norm(Ad, dim=-1)
    one = torch.ones((), dtype=H.dtype, device=H.device)
    e_a = torch.where(ra > 1e-12, 1.0 / torch.clamp_min(ra, 1e-12), one)
    As = Ad * e_a[..., None]
    bs = b * e_a
    Gd = G * d[..., None, :]
    rg = torch.linalg.vector_norm(Gd, dim=-1)
    e_g = torch.where(rg > 1e-12, 1.0 / torch.clamp_min(rg, 1e-12), one)
    Gs = Gd * e_g[..., None]
    hs = h * e_g
    return Hs, qs, As, bs, Gs, hs, d, e_a, e_g


def _chol_inverse(M: torch.Tensor) -> torch.Tensor:
    """Explicit inverse through a Cholesky factorization, NaN where the
    factorization fails.  The input is symmetrized first, as
    ``jnp.linalg.cholesky`` does."""
    Ms = 0.5 * (M + M.mT)
    L, info = torch.linalg.cholesky_ex(Ms)
    z = torch.linalg.solve_triangular(L, _eye(M.shape[-1], M), upper=False)
    X = torch.linalg.solve_triangular(L.mT, z, upper=True)
    nan = torch.full((), float("nan"), dtype=M.dtype, device=M.device)
    return torch.where((info == 0)[..., None, None], X, nan)


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [..., n] with A x = b for symmetric positive definite A
    [..., n, n] (batch dimensions broadcast), through ``cholesky_ex`` and two
    triangular solves: no factorization check reads a status back, so the
    solve runs inside a CUDA graph, where ``torch.linalg.solve`` checks its
    status on the host.  It stands where the JAX package calls
    ``jnp.linalg.solve`` on such a matrix."""
    L = torch.linalg.cholesky_ex(A).L
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def _schur_inverse(M: torch.Tensor, base: int = 32) -> torch.Tensor:
    """SPD inverse by recursive 2x2 Schur-complement blocks: matrix products
    above the ``base``-sized leaves, which use :func:`_chol_inverse`.  On
    near-singular matrices the intermediate Schur complements go indefinite
    in float32 and the leaves return NaN; see
    :func:`_shifted_schur_inverse`."""
    n = M.shape[-1]
    if n <= base:
        return _chol_inverse(M)
    k = min(((n + 1) // 2 + 7) & ~7, n - 1)     # split at a multiple of 8
    A = M[..., :k, :k]
    B = M[..., :k, k:]
    C = M[..., k:, k:]
    Ai = _schur_inverse(A, base)
    W = Ai @ B
    Si = _schur_inverse(C - B.mT @ W, base)
    WSi = W @ Si
    top = torch.cat([Ai + WSi @ W.mT, -WSi], dim=-1)
    bot = torch.cat([-WSi.mT, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _shifted_schur_inverse(M: torch.Tensor, delta: float = 1e-3,
                           ns: int = 14) -> torch.Tensor:
    """``inverse="schur"``: the recursive Schur inverse of M + delta I (the
    shift keeps every intermediate Schur complement positive definite),
    then ``ns`` Newton-Schulz steps X <- X (2I - M X) that deflate the
    shift."""
    I = _eye(M.shape[-1], M)
    X = _schur_inverse(M + delta * I)
    for _ in range(ns):
        X = X @ (2.0 * I - M @ X)
    return X


_INVERSES = {"schur": _shifted_schur_inverse}


def _ns_refresh(X: torch.Tensor, M: torch.Tensor, steps: int = 2):
    """Newton-Schulz inverse tracking: X <- X (2I - M X)."""
    I2 = 2.0 * _eye(M.shape[-1], M)
    for _ in range(steps):
        X = X @ (I2 - M @ X)
    return X


def _kkt_solve(Mi, A, Si, r1, r2, At=None):
    """Solve [[M, A^T], [A, 0]] [dx, dy] = [r1, r2] given M^-1, S^-1."""
    Mi_r1 = _mv(Mi, r1)
    dy = _mv(Si, _mv(A, Mi_r1) - r2)
    dx = Mi_r1 - _mv(Mi, _vtm(dy, A, At))
    return dx, dy


def _refine(Mi, A, Si, M, r1, r2, dx, dy, steps: int = 1, At=None):
    """Iterative refinement of the KKT solve."""
    for _ in range(steps):
        e1 = r1 - (_mv(M, dx) + _vtm(dy, A, At))
        e2 = r2 - _mv(A, dx)
        cx, cy = _kkt_solve(Mi, A, Si, e1, e2, At)
        dx = dx + cx
        dy = dy + cy
    return dx, dy


def _iteration_math(H, q, A, b, G, h, g_active, x, y, lam, s, done, it, best,
                    M, Mi, *, reg: float, tol: float, refine_steps: int,
                    chol_inverse_fn: Callable, At=None, Gt=None):
    """One Mehrotra predictor-corrector iteration once M^-1 is known.

    Shared by every sweep (in the port also by ``kernels.ipm_iter_reference``, the
    plain version of the fused CUDA sweep), as the JAX package shares it
    between XLA and the Pallas kernel.  ``done`` is bool [B], ``it`` int32
    [B], ``best`` = (x, y, lam, s, merit [B]); ``At``, ``Gt``: A's and G's
    ``jnp_compat.transposed``, which a solve makes once for its sweeps."""
    dtype = q.dtype
    eps = torch.finfo(dtype).eps
    w_hi = 0.01 / eps
    p = b.shape[-1]
    inf = torch.full((), float("inf"), dtype=dtype, device=q.device)
    m_act = torch.clamp_min(torch.sum(g_active, dim=-1), 1.0).to(dtype)
    W = torch.clamp(lam / s, 1.0 / w_hi, w_hi)

    AMi = A @ Mi
    S_mat = jc.matmul_nt(AMi, A) + max(reg, 1e-7) * _eye(p, q)
    Si = chol_inverse_fn(S_mat)

    r_d = _mv(H, x) + q + _vtm(y, A, At) + _vtm(lam, G, Gt)
    r_p = _mv(A, x) - b
    r_g = _mv(G, x) + s - h
    mu = torch.sum(s * lam, dim=-1) / m_act

    def solve_dir(sigma_mu, ds_extra):
        rhs_c = (sigma_mu[..., None] - lam * ds_extra) / s
        r1 = -(r_d + _vtm(rhs_c - lam + W * r_g, G, Gt))
        r2 = -r_p
        dx, dy = _kkt_solve(Mi, A, Si, r1, r2, At)
        dx, dy = _refine(Mi, A, Si, M, r1, r2, dx, dy, refine_steps, At)
        ds = -r_g - _mv(G, dx)
        dlam = rhs_c - lam - W * ds
        return dx, dy, ds, dlam

    dx_a, dy_a, ds_a, dl_a = solve_dir(torch.zeros_like(mu),
                                       torch.zeros_like(lam))

    def max_step(v, dv):
        neg = dv < 0
        ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), inf)
        return torch.clamp_max(torch.amin(ratio, dim=-1), 1.0)

    a_p = max_step(s, ds_a)
    a_d = max_step(lam, dl_a)
    mu_aff = torch.sum((s + a_p[..., None] * ds_a)
                       * (lam + a_d[..., None] * dl_a), dim=-1) / m_act
    sigma = torch.clamp((mu_aff / torch.clamp_min(mu, 1e-30)) ** 3, 0.0, 1.0)

    dx_c, dy_c, ds_c, dl_c = solve_dir(sigma * mu, ds_a * dl_a)
    a_p = 0.99 * max_step(s, ds_c)
    a_d = 0.99 * max_step(lam, dl_c)

    scale = 1.0 + _amax_abs(q)
    mu_floor = 100.0 * eps * scale
    rp_max = _amax_abs(r_p)
    rd_max = _amax_abs(r_d)
    conv = ((mu < torch.maximum(tol * scale, mu_floor))
            & (rp_max < 1e3 * tol * scale) & (rd_max < 1e3 * tol * scale))
    # reject non-finite steps (a blown-up factorization): freeze at the
    # last good iterate
    step_ok = (torch.isfinite(dx_c).all(-1) & torch.isfinite(dy_c).all(-1)
               & torch.isfinite(ds_c).all(-1) & torch.isfinite(dl_c).all(-1))
    new_done = done | conv
    take = ~(new_done | ~step_ok)

    merit = mu + rp_max / scale + rd_max / scale
    bx, by, blam, bs, bmerit = best
    improved = (merit < bmerit) & torch.isfinite(merit)
    imp = improved[..., None]
    best = (torch.where(imp, x, bx), torch.where(imp, y, by),
            torch.where(imp, lam, blam), torch.where(imp, s, bs),
            torch.where(improved, merit, bmerit))

    # torch.where, not a 0/1 multiplier: 0 * NaN would poison the iterate
    # whenever a step is rejected for a blown-up factorization
    tk = take[..., None]
    x = torch.where(tk, x + a_p[..., None] * dx_c, x)
    y = torch.where(tk, y + a_d[..., None] * dy_c, y)
    s = torch.where(tk, torch.clamp_min(s + a_p[..., None] * ds_c, 1e-30), s)
    lam = torch.where(tk, torch.clamp_min(lam + a_d[..., None] * dl_c, 1e-30),
                      lam)
    it = it + torch.where(new_done, 0, 1).to(it.dtype)
    return x, y, lam, s, new_done, it, best


def solve(H, q, A, b, G, h, *, iters: int = 25, tol: float = 1e-9,
          reg: float = 1e-8, refine_steps: int = 1, exact_every: int = 1,
          ns_steps: int = 2,
          inverse: str = "chol", warm: QPSolution | None = None) -> QPSolution:
    """Mehrotra predictor-corrector interior point, ``iters`` sweeps.

    Masked rows: a disabled equality row is all zero with b = 0; a disabled
    inequality row is all zero with h = 1."""
    Hs, qs, As, bs, Gs, hs, d, e_a, e_g = _equilibrate(H, q, A, b, G, h)
    warm_s = None
    if warm is not None:
        # scale the warm start into the equilibrated space and push it
        # interior; warm_ok gates on the gap = inf "never solved" sentinel
        warm_ok = torch.isfinite(warm.gap) & torch.isfinite(warm.x).all(-1)
        warm_s = (warm.x / d, warm.y / e_a,
                  torch.clamp_min(warm.lam / e_g, 1e-3),
                  torch.clamp_min(warm.s * e_g, 1e-3), warm_ok)
    sol = _solve_impl(Hs, qs, As, bs, Gs, hs, iters=iters, tol=tol, reg=reg,
                      refine_steps=refine_steps, warm=warm_s,
                      exact_every=exact_every, ns_steps=ns_steps,
                      inverse=inverse)
    x = d * sol.x
    y = e_a * sol.y
    lam = e_g * sol.lam
    s = sol.s / e_g
    # residuals in the ORIGINAL scaling
    gap, pri, dua = _residuals(H, q, A, b, G, h, x, y, lam, s)
    if iters == 0 and warm_s is not None:
        # the fast path cannot recover from a sentinel warm start: surface
        # it as inf residuals, not as a solution
        ok = warm_s[-1]
        inf = torch.full_like(gap, float("inf"))
        gap = torch.where(ok, gap, inf)
        pri = torch.where(ok, pri, inf)
        dua = torch.where(ok, dua, inf)
    return QPSolution(x=x, y=y, lam=lam, s=s, iters=sol.iters, gap=gap,
                      pri_res=pri, dua_res=dua)


def _residuals(H, q, A, b, G, h, x, y, lam, s, g_active=None, At=None,
               Gt=None):
    """(gap, primal, dual) residuals; masked G rows do not count."""
    if g_active is None:
        g_active = torch.any(G != 0, dim=-1)
    m_act = torch.clamp_min(torch.sum(g_active, dim=-1), 1).to(x.dtype)
    gap = torch.sum(s * lam, dim=-1) / m_act
    if b.shape[-1] > 0:
        pri = _amax_abs(_mv(A, x) - b)
    else:
        pri = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    r_g = _mv(G, x) + s - h
    pri = torch.maximum(pri, _amax_abs(torch.where(g_active, r_g, 0.0)))
    dua = _amax_abs(_mv(H, x) + q + _vtm(y, A, At) + _vtm(lam, G, Gt))
    return gap, pri, dua


def _solve_impl(H, q, A, b, G, h, *, iters, tol, reg, refine_steps,
                warm=None, exact_every: int = 1, ns_steps: int = 2,
                inverse: str = "chol") -> QPSolution:
    eps = torch.finfo(q.dtype).eps
    reg = max(reg, 50.0 * eps)
    w_hi = 0.01 / eps
    n, m, p = q.shape[-1], h.shape[-1], b.shape[-1]
    dtype, dev = q.dtype, q.device
    Bsz = q.shape[0]

    if iters == 0 and warm is not None:
        # IFT-at-solution fast path: the forward pass is the identity on the
        # warm point; a sentinel or non-finite warm start reports inf
        g_active = torch.any(G != 0, dim=-1)
        wx, wy, wlam, ws, warm_ok = warm
        one = torch.ones((), dtype=dtype, device=dev)
        s = torch.where(g_active, ws, one)
        lam = torch.where(g_active, wlam, 1e-6 * one)
        gap, pri, dua = _residuals(H, q, A, b, G, h, wx, wy, lam, s, g_active)
        inf = torch.full_like(gap, float("inf"))
        return QPSolution(
            x=wx, y=wy, lam=lam, s=s,
            iters=torch.zeros(Bsz, dtype=torch.int32, device=dev),
            gap=torch.where(warm_ok, gap, inf),
            pri_res=torch.where(warm_ok, pri, inf),
            dua_res=torch.where(warm_ok, dua, inf))

    n_real, m_real = n, m
    g_active = torch.any(G != 0, dim=-1)
    one = torch.ones((), dtype=dtype, device=dev)
    At, Gt = jc.transposed(A), jc.transposed(G)

    # Mehrotra start: the equality-constrained QP, then slacks/duals pushed
    # strictly interior.  ``inverse`` selects the start point's inverse and
    # the unrolled path's exact refresh; the fused path's exact refresh is
    # the Cholesky whatever it says, as in the JAX package.
    inv = _INVERSES.get(inverse, _chol_inverse)
    Mi0 = inv(H + max(reg, 1e-8) * _eye(n, q))
    S0 = A @ (Mi0 @ A.mT) + max(reg, 1e-7) * _eye(p, q)
    Si0 = _chol_inverse(S0)
    x, y = _kkt_solve(Mi0, A, Si0, -q, b, At)
    s_raw = h - _mv(G, x)
    s_floor = 0.1 * (1.0 + _amax_abs(h))
    s = torch.where(g_active, torch.maximum(s_raw, s_floor[..., None]), one)
    mu0 = 1.0 + _amax_abs(q) / n
    lam = torch.where(g_active, mu0[..., None] / s, 1e-6 * one)

    if warm is not None:
        wx, wy, wlam, ws, warm_ok = warm
        ws = torch.where(g_active, ws, one)
        wlam = torch.where(g_active, wlam, 1e-6 * one)
        ok = warm_ok[..., None]
        x = torch.where(ok, wx, x)
        y = torch.where(ok, wy, y)
        lam = torch.where(ok, wlam, lam)
        s = torch.where(ok, ws, s)

    g_active_f = g_active.to(dtype)
    done = torch.zeros(Bsz, dtype=torch.bool, device=dev)
    it = torch.zeros(Bsz, dtype=torch.int32, device=dev)
    best = (x.clone(), y.clone(), lam.clone(), s.clone(),
            torch.full((Bsz,), float("inf"), dtype=dtype, device=dev))
    Mi_prev = Mi0
    eye_n = _eye(n, q)
    for i in range(iters):
        # exact refresh on the first two sweeps and on the cadence,
        # Newton-Schulz tracking in between; the choice depends only on the
        # sweep index, so only the branch taken runs
        exact = (i < 2) or (i % exact_every == 0)
        W = torch.clamp(lam / s, 1.0 / w_hi, w_hi)
        M = H + G.mT @ (G * W[..., None]) + reg * eye_n
        if exact:
            Mi = inv(M)
        else:
            # a divergent refresh (non-finite) falls back to the stale
            # finite inverse until the next exact refresh
            Mi_ns = _ns_refresh(Mi_prev, M, ns_steps)
            ok = torch.isfinite(Mi_ns).all(-1).all(-1)
            Mi = torch.where(ok[..., None, None], Mi_ns, Mi_prev)
        x, y, lam, s, done, it, best = _iteration_math(
            H, q, A, b, G, h, g_active_f, x, y, lam, s, done, it, best,
            M, Mi, reg=reg, tol=tol, refine_steps=refine_steps,
            chol_inverse_fn=_chol_inverse, At=At, Gt=Gt)
        Mi_prev = Mi
    return _finalize(H, q, A, b, G, h, g_active, x, y, lam, s, it, best,
                     n_real, m_real, At, Gt)


def _finalize(H, q, A, b, G, h, g_active, x, y, lam, s, it, best,
              n_real: int, m_real: int, At=None, Gt=None) -> QPSolution:
    """Best-iterate competition, final residuals, padding stripped."""
    m_act = torch.clamp_min(torch.sum(g_active, dim=-1), 1).to(x.dtype)

    def merit_of(x_, y_, lam_, s_):
        mu_ = torch.sum(s_ * lam_, dim=-1) / m_act
        rp_ = _amax_abs(_mv(A, x_) - b)
        rd_ = _amax_abs(_mv(H, x_) + q + _vtm(y_, A, At) + _vtm(lam_, G, Gt))
        sc = 1.0 + _amax_abs(q)
        return mu_ + rp_ / sc + rd_ / sc

    bx, by, blam, bs, bmerit = best
    take_final = (merit_of(x, y, lam, s) < bmerit)[..., None]
    x = torch.where(take_final, x, bx)
    y = torch.where(take_final, y, by)
    lam = torch.where(take_final, lam, blam)
    s = torch.where(take_final, s, bs)
    gap, pri, dua = _residuals(H, q, A, b, G, h, x, y, lam, s, g_active, At,
                               Gt)
    return QPSolution(x=x[..., :n_real], y=y, lam=lam[..., :m_real],
                      s=s[..., :m_real], iters=it, gap=gap, pri_res=pri,
                      dua_res=dua)


# ----------------------------------------------------------------------------
# Differentiable wrapper: implicit-function-theorem adjoint
# ----------------------------------------------------------------------------

class _SolvePrimal(torch.autograd.Function):
    """x*(H, q, A, b, G, h) with the IFT adjoint as its backward."""

    @staticmethod
    def forward(ctx, H, q, A, b, G, h, opts, warm):
        sol = solve(H, q, A, b, G, h, warm=warm, **dict(opts))
        ctx.opts = opts
        ctx.save_for_backward(H, q, A, b, G, h, sol.x, sol.y, sol.lam, sol.s)
        return sol.x

    @staticmethod
    def backward(ctx, gx):
        H, q, A, b, G, h, x, y, lam, s = ctx.saved_tensors
        grads = _bwd_impl(ctx.opts, H, q, A, b, G, h, x, y, lam, s, gx)
        return (*grads, None, None)


def solve_primal(H, q, A, b, G, h, opts: tuple = (),
                 warm: QPSolution | None = None) -> torch.Tensor:
    """QP solve returning the primal x [B, n], differentiable with respect
    to all data through the IFT adjoint.  ``warm`` warm-starts the forward
    solve and receives no gradient."""
    return _SolvePrimal.apply(H, q, A, b, G, h, tuple(opts), warm)


def _bwd_impl(opts, H, q, A, b, G, h, x, y, lam, s, gx):
    """IFT adjoint: solve (H + G^T W G) v_x + A^T v_y = gx, A v_x = 0 in the
    equilibrated space (W = lam / s), then dL/dtheta = -v^T dg/dtheta."""
    dtype = x.dtype
    reg = dict(opts).get("reg", 1e-8)
    Hs, _, As, _, Gs, _, d, e_a, e_g = _equilibrate(H, q, A, b, G, h)
    n = x.shape[-1]
    eps = torch.finfo(dtype).eps
    reg = max(reg, 50.0 * eps)
    W = torch.clamp(lam / s, 100.0 * eps, 0.01 / eps)
    Wt = W / (e_g * e_g)
    M = Hs + Gs.mT @ (Gs * Wt[..., None]) + reg * _eye(n, x)
    Mi = _chol_inverse(M)
    p = A.shape[-2]
    S_mat = As @ (Mi @ As.mT) + max(reg, 1e-7) * _eye(p, x)
    Si = _chol_inverse(S_mat)
    zero_p = torch.zeros(x.shape[:-1] + (p,), dtype=dtype, device=x.device)
    gxs = d * gx
    vxs, vys = _kkt_solve(Mi, As, Si, gxs, zero_p)
    vxs, vys = _refine(Mi, As, Si, M, gxs, zero_p, vxs, vys, 2)
    vx = d * vxs
    vy = e_a * vys
    c = W * _mv(G, vx)                  # = D(lam) v_lam

    def outer(u, v):
        return u[..., :, None] * v[..., None, :]

    dH = -0.5 * (outer(vx, x) + outer(x, vx))
    dq = -vx
    dA = -(outer(y, vx) + outer(vy, x))
    db = vy
    dG = -(outer(lam, vx) + outer(c, x))
    dh = c
    return dH, dq, dA, db, dG, dh
