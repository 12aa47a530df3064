"""Plain implicit-feedback ALS by conjugate gradients over COO: the
reference for the `train_ials_cg` kind (Hu, Koren and Volinsky's
objective; Takács, Pilászy and Tikk's warm-started CG, RecSys 2011).
Plain PyTorch; it imports nothing of the program and takes no layout the
program built: `train_ials._Side` sorts the benchmark's own nonzeros by
row and by column and cuts the rows into blocks.

With C = 1 + alpha·V at the nonzeros and 1 elsewhere, W half first, each
half from the other's newest factor, every row u of W has the system

  A_u = H Hᵀ + Σ_{i∈u} alpha·v_ui h_i h_iᵀ + ridge_u I,
  b_u = H (c_u ⊙ v_u),

built block by block in float64 as `train_ials._Side.solve` builds it
(the same ridge: lambda + eps + max(eps, 100·2⁻²³)·(the mean diagonal of
the row's Gram), the program's model for float32 factors). Each row then
takes `steps` Jacobi-preconditioned CG steps from its current value
(the residual b - A x0, a step length of 0 where pᵀAp ≤ 0, a direction
update of 0 where the last rᵀz ≤ 0) and is clamped at 0; the columns of
H likewise on Vᵀ and W. The systems are formed here, as the program does
not: the reference holds to the algorithm, not to the program's
matrix-free formulation.

The fit's error is the unweighted ||V - WH||_F that the loop reports.
`precision="tf32"` is the control: every operand of a Gram product
rounded to TF32 first, as `train_ials` rounds it, the steps in float32.
"""

from __future__ import annotations

import torch

from benchmark.reference import train_fits as base
from benchmark.reference.train_ials import REL_RIDGE, _Side


def _block_systems(side, Tr, G, rows, width, alpha, lam, eps, dtype, rnd):
    """The ridged systems (b, r, r) and right-hand sides (b, r) of one
    block of `side`'s rows against the rounded table Tr, its Gram G."""
    r = Tr.shape[1]
    b = rows.numel()
    start, count = side.start[rows], side.counts[rows]
    dG = torch.zeros(b, r, r, dtype=dtype, device=Tr.device)
    rhs = torch.zeros(b, r, dtype=dtype, device=Tr.device)
    step = max(1, side.slots // b)
    for lo in range(0, max(width, 1), step):
        lanes = torch.arange(lo, min(lo + step, max(width, 1)),
                             device=Tr.device)
        live = lanes[None, :] < count[:, None]
        pos = torch.where(live, start[:, None] + lanes[None, :], 0)
        v = torch.where(live, side.vals[pos].to(dtype), 0.0)
        t = Tr.index_select(0, side.other[pos].reshape(-1)) \
            .reshape(b, -1, r)
        dG += rnd(t * rnd(alpha * v)[:, :, None]).transpose(1, 2) @ t
        rhs += (rnd(v * (1.0 + alpha * v))[:, None, :] @ t)[:, 0]
    A = G[None] + dG
    diag = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / r
    A += (lam + eps + max(eps, REL_RIDGE) * diag)[:, None, None] \
        * torch.eye(r, dtype=dtype, device=Tr.device)
    return A, rhs


def pcg(A, rhs, x0, steps):
    """`steps` Jacobi-preconditioned CG steps on the systems A (b, r, r)
    from x0 (b, r), unclamped."""
    def matvec(p):
        return (A @ p[:, :, None])[:, :, 0]

    dinv = 1.0 / torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1),
                             min=torch.finfo(A.dtype).tiny)
    x = x0
    res = rhs - matvec(x)
    z = dinv * res
    p = z
    rz = (res * z).sum(1, keepdim=True)
    for _ in range(steps):
        Ap = matvec(p)
        denom = (p * Ap).sum(1, keepdim=True)
        a = torch.where(denom > 0, rz / torch.where(denom > 0, denom, 1.0),
                        0.0)
        x = x + a * p
        res = res - a * Ap
        z = dinv * res
        rz2 = (res * z).sum(1, keepdim=True)
        p = z + torch.where(rz > 0, rz2 / torch.where(rz > 0, rz, 1.0),
                            0.0) * p
        rz = rz2
    return x


def solve_cg(side, T, X, alpha, lam, eps, steps, dtype, rnd):
    """Every row of `side` (n_own, r), clamped, by `steps` CG steps from
    its row of X (n_own, r) against the table T (n_other, r)."""
    Tr = rnd(T.to(dtype))
    G = Tr.T @ Tr
    out = torch.zeros(side.n, T.shape[1], dtype=dtype, device=T.device)
    for rows, width in side.blocks:
        A, rhs = _block_systems(side, Tr, G, rows, width, alpha, lam, eps,
                                dtype, rnd)
        x = pcg(A, rhs, X[rows].to(dtype), steps)
        out[rows] = torch.clamp(x, min=0.0)
    return out


def fit(rows, cols, vals, n, m, W0, H0, alpha: float, lambda_w: float,
        lambda_h: float, iterations: int, eps: float, steps: int,
        precision: str = "float64", chunk: int = 1 << 22):
    """`iterations` iALS steps of `steps` CG steps a half from (W0, H0).
    Returns (W, H, error) with W, H float64 (float32 under the control)
    and the error a Python float."""
    if precision not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    # the control rounds to TF32 itself; no product may do it unasked
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = torch.float64 if precision == "float64" else torch.float32
    rnd = base.round_tf32 if precision == "tf32" else (lambda x: x)
    r = W0.shape[1]
    size = torch.finfo(dtype).bits // 8
    users = _Side(rows, cols, vals, n, r, size)
    items = _Side(cols, rows, vals, m, r, size)
    W, H = W0.to(dtype).clone(), H0.to(dtype).clone()
    for _ in range(iterations):
        W = solve_cg(users, H.T, W, alpha, lambda_w, eps, steps, dtype, rnd)
        H = solve_cg(items, W, H.T, alpha, lambda_h, eps, steps, dtype,
                     rnd).T.contiguous()
    P = base._Products(rows, cols, vals, n, m, dtype,
                       precision == "tf32", chunk)
    return W, H, base.error(P, W, H, "frobenius")
