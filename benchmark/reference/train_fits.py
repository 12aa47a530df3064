"""Plain multiplicative updates over COO: the reference for training
cells. Plain PyTorch; it imports nothing of the program and takes no
layout the program built: it gathers the factors at the benchmark's own
nonzeros and scatter-adds the products, in float64.

The rules are the configuration's (Lee and Seung's MU, W half first, each
half from the other's newest factor):
  KL:        W <- W * [(V / (WH + eps)) Hᵀ] / max(Σ_j H, eps)
             H <- H * [Wᵀ (V / (WH + eps))] / max(Σ_i W, eps)
  Frobenius: W <- W * (V Hᵀ) / (W (H Hᵀ) + eps)
             H <- H * (Wᵀ V) / ((WᵀW) H + eps)
and the fit's error is D_KL(V || WH) with its logs clamped at 1e-12, or
||V - WH||_F by the Gram identity (exact in float64).

`precision="tf32"` is the control: the same steps in float32 with every
operand of a product rounded to TF32's 10-bit mantissa first, as the
tensor cores would take them with TF32 on.
"""

from __future__ import annotations

import torch

LOG_EPS = 1e-12


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 explicit mantissa bits), to nearest,
    ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Products:
    """Gathered products at the nonzeros, in chunks of `chunk`."""

    def __init__(self, rows, cols, vals, n, m, dtype, tf32, chunk):
        self.rows, self.cols, self.vals = rows, cols, vals.to(dtype)
        self.n, self.m, self.dtype = n, m, dtype
        self.rnd = round_tf32 if tf32 else (lambda x: x)
        self.chunk = chunk

    def _spans(self):
        nnz = self.vals.numel()
        return ((lo, min(lo + self.chunk, nnz))
                for lo in range(0, nnz, self.chunk))

    def sampled(self, W, H):
        """(WH) at every nonzero."""
        Ht = H.T
        out = torch.empty_like(self.vals)
        for lo, hi in self._spans():
            a = self.rnd(W.index_select(0, self.rows[lo:hi]))
            b = self.rnd(Ht.index_select(0, self.cols[lo:hi]))
            out[lo:hi] = (a * b).sum(dim=1)
        return out

    def spmm(self, coef, T, by_rows):
        """Σ over nonzeros of coef · T[other index] into the rows (by_rows)
        or the columns of V: (coef ∘ V-pattern) @ T or its transpose."""
        dst, src = ((self.rows, self.cols) if by_rows
                    else (self.cols, self.rows))
        out = torch.zeros(self.n if by_rows else self.m, T.shape[1],
                          dtype=self.dtype, device=T.device)
        for lo, hi in self._spans():
            g = self.rnd(T.index_select(0, src[lo:hi]))
            c = self.rnd(coef[lo:hi])
            out.index_add_(0, dst[lo:hi], c[:, None] * g)
        return out


def _mm(a, b, rnd):
    return rnd(a) @ rnd(b)


def fit(rows, cols, vals, n, m, W0, H0, objective: str, iterations: int,
        eps: float, precision: str = "float64", chunk: int = 1 << 22):
    """`iterations` MU steps from (W0, H0). Returns (W, H, error) with W, H
    float64 (float32 under the control) and the error a Python float."""
    if precision not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    dtype = torch.float64 if precision == "float64" else torch.float32
    tf32 = precision == "tf32"
    rnd = round_tf32 if tf32 else (lambda x: x)
    P = _Products(rows, cols, vals, n, m, dtype, tf32, chunk)
    W, H = W0.to(dtype).clone(), H0.to(dtype).clone()
    for _ in range(iterations):
        if objective == "kl":
            ratio = P.vals / (P.sampled(W, H) + eps)
            W = W * (P.spmm(ratio, H.T, True)
                     / torch.clamp(H.sum(dim=1), min=eps)[None, :])
            ratio = P.vals / (P.sampled(W, H) + eps)
            H = H * (P.spmm(ratio, W, False).T
                     / torch.clamp(W.sum(dim=0), min=eps)[:, None])
        elif objective == "frobenius":
            W = W * (P.spmm(P.vals, H.T, True)
                     / (_mm(W, _mm(H, H.T, rnd), rnd) + eps))
            H = H * (P.spmm(P.vals, W, False).T
                     / (_mm(_mm(W.T, W, rnd), H, rnd) + eps))
        else:
            raise ValueError(f"unknown objective {objective!r}")
    return W, H, error(P, W, H, objective)


def error(P: _Products, W, H, objective: str) -> float:
    v = P.vals
    s = P.sampled(W, H)
    if objective == "kl":
        logs = torch.where(v > 0, v * torch.log(
            torch.clamp(v, min=LOG_EPS) / torch.clamp(s, min=LOG_EPS)), 0.0)
        return float(logs.sum() - v.sum() + W.sum(dim=0) @ H.sum(dim=1))
    quad = torch.sum((W.T @ W) * (H @ H.T))
    return float(torch.sqrt(torch.clamp(
        (v * v).sum() - 2.0 * (v * s).sum() + quad, min=0.0)))
