"""Plain confidence-weighted MU over COO: the reference for the
`train_weighted` kind. Plain PyTorch; it imports nothing of the program,
and gathers and scatter-adds at the benchmark's own nonzeros in float64
(`reference/train_fits.py`'s products). With C = 1 + alpha·V at the
nonzeros and 1 elsewhere, W half first, each half from the other's
newest factor:
  W <- W * [(C⊙V) Hᵀ] / (W (H Hᵀ) + alpha·[(V⊙WH) Hᵀ] + eps)
  H <- H * [Wᵀ (C⊙V)] / ((WᵀW) H + alpha·[Wᵀ (V⊙WH)] + eps)
and the fit's error is the unweighted ||V - WH||_F. `precision="tf32"`
is the control, as in `train_fits`."""

from __future__ import annotations

import torch

from benchmark.reference import train_fits as base


def fit(rows, cols, vals, n, m, W0, H0, alpha: float, iterations: int,
        eps: float, precision: str = "float64", chunk: int = 1 << 22):
    """`iterations` weighted MU steps from (W0, H0): (W, H, error)."""
    if precision not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    dtype = torch.float64 if precision == "float64" else torch.float32
    tf32 = precision == "tf32"
    rnd = base.round_tf32 if tf32 else (lambda x: x)
    P = base._Products(rows, cols, vals, n, m, dtype, tf32, chunk)
    cv = P.vals * (1.0 + alpha * P.vals)
    W, H = W0.to(dtype).clone(), H0.to(dtype).clone()
    for _ in range(iterations):
        vs = P.vals * P.sampled(W, H)
        W = W * (P.spmm(cv, H.T, True)
                 / (base._mm(W, base._mm(H, H.T, rnd), rnd)
                    + alpha * P.spmm(vs, H.T, True) + eps))
        vs = P.vals * P.sampled(W, H)
        H = H * (P.spmm(cv, W, False).T
                 / (base._mm(base._mm(W.T, W, rnd), H, rnd)
                    + alpha * P.spmm(vs, W, False).T + eps))
    return W, H, base.error(P, W, H, "frobenius")
