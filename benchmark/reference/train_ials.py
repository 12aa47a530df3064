"""Plain implicit-feedback ALS over COO: the reference for the `train_ials`
kind (Hu, Koren and Volinsky, ICDM 2008). Plain PyTorch; it imports
nothing of the program and takes no layout the program built: it sorts
the benchmark's own nonzeros by row and by column, and solves in float64.

With C = 1 + alpha·V at the nonzeros and 1 elsewhere, W half first, each
half from the other's newest factor, every row u of W solves

  (H Hᵀ + Σ_{i∈u} alpha·v_ui h_i h_iᵀ + ridge_u I) w_u = H (c_u ⊙ v_u)

by Cholesky (`torch.linalg.cholesky`, `cholesky_solve`) and is clamped at
0; the columns of H likewise on Vᵀ and W. Each block of rows gathers its
rows' nonzeros, padded to the block's widest row, so one batched product
gives the block's Gram deltas and right-hand sides.

The ridge is the one deliberate departure from plain float64: ridge_u =
lambda + eps + max(eps, 100·2⁻²³)·(the mean diagonal of row u's system),
the program's model for float32 factors (its float32 machine epsilon,
whatever the precision here). Its condition numbers reach about 444 at
this rank, where float64's own relative floor would move the solutions
by about 10⁻³ and swamp the comparison.

The fit's error is the unweighted ||V - WH||_F that the loop reports
(`train_fits.error`). `precision="tf32"` is the control: every operand
of a product rounded to TF32 first, the solves in float32.
"""

from __future__ import annotations

import torch

from benchmark.reference import train_fits as base

# the program's relative ridge: 100 float32 machine epsilons
REL_RIDGE = 100.0 * 2.0**-23
# a block's gathered nonzeros (padded) and its systems stay about this
# many bytes each
BLOCK_BYTES = 1 << 29


class _Side:
    """One side's rows: its nonzeros sorted by row, each row's first
    nonzero and count, and blocks of rows of similar counts."""

    def __init__(self, own, other, vals, n_own, r, itemsize):
        order = torch.argsort(own, stable=True)
        self.other, self.vals = other[order], vals[order]
        counts = torch.bincount(own, minlength=n_own)
        self.counts = counts
        self.start = torch.cumsum(counts, 0) - counts
        by_count = torch.argsort(counts, stable=True)
        c = counts[by_count].cpu().numpy()
        slots = max(1, BLOCK_BYTES // (r * itemsize))
        most_rows = max(1, BLOCK_BYTES // (r * r * itemsize))
        self.blocks = []
        i = 0
        while i < n_own:
            j = min(n_own, i + most_rows,
                    i + max(1, slots // max(int(c[i]), 1)))
            while j - i > 1 and (j - i) * int(c[j - 1]) > slots:
                j = i + max(1, slots // int(c[j - 1]))
            self.blocks.append((by_count[i:j], int(c[j - 1])))
            i = j
        self.n, self.slots = n_own, slots

    def solve(self, T, alpha, lam, eps, dtype, rnd):
        """Every row's clamped solution (n_own, r) against the table T
        (the other side's factor, (n_other, r))."""
        r = T.shape[1]
        Tr = rnd(T.to(dtype))
        G = Tr.T @ Tr
        out = torch.zeros(self.n, r, dtype=dtype, device=T.device)
        eye = torch.eye(r, dtype=dtype, device=T.device)
        for rows, width in self.blocks:
            b = rows.numel()
            start, count = self.start[rows], self.counts[rows]
            dG = torch.zeros(b, r, r, dtype=dtype, device=T.device)
            rhs = torch.zeros(b, r, dtype=dtype, device=T.device)
            step = max(1, self.slots // b)
            for lo in range(0, max(width, 1), step):
                lanes = torch.arange(lo, min(lo + step, max(width, 1)),
                                     device=T.device)
                live = lanes[None, :] < count[:, None]
                pos = torch.where(live, start[:, None] + lanes[None, :], 0)
                v = torch.where(live, self.vals[pos].to(dtype), 0.0)
                t = Tr.index_select(0, self.other[pos].reshape(-1)) \
                    .reshape(b, -1, r)
                dG += rnd(t * rnd(alpha * v)[:, :, None]).transpose(1, 2) @ t
                rhs += (rnd(v * (1.0 + alpha * v))[:, None, :] @ t)[:, 0]
            A = G[None] + dG
            diag = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / r
            A += (lam + eps + max(eps, REL_RIDGE) * diag)[:, None, None] * eye
            L = torch.linalg.cholesky(A)
            x = torch.cholesky_solve(rhs[:, :, None], L)[:, :, 0]
            out[rows] = torch.clamp(x, min=0.0)
        return out


def fit(rows, cols, vals, n, m, W0, H0, alpha: float, lambda_w: float,
        lambda_h: float, iterations: int, eps: float,
        precision: str = "float64", chunk: int = 1 << 22):
    """`iterations` iALS steps from (W0, H0). Returns (W, H, error) with
    W, H float64 (float32 under the control) and the error a Python
    float."""
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
        W = users.solve(H.T, alpha, lambda_w, eps, dtype, rnd)
        H = items.solve(W, alpha, lambda_h, eps, dtype, rnd).T.contiguous()
    P = base._Products(rows, cols, vals, n, m, dtype,
                       precision == "tf32", chunk)
    return W, H, base.error(P, W, H, "frobenius")
