"""Int8-stored V for the fused MU half-steps (port of
``nmftpu/kernels/quantized.py``).

V is stored once as int8 with one per-matrix scale, V ~= scale * Vq,
which quarters the bytes of V read per half-step. The CUDA kernels are
those of ``csrc/dense_mu.cu`` instantiated for ``int8_t``: the int8 tile
is exact in tf32, so each numerator product on the tensor cores takes
two terms (V·hi + V·lo of the float32 factor) instead of three, the sums
run in float32, and the scale multiplies each numerator once in the
epilogue.

Unlike ``nmftpu``'s ``w_update_fused_q``/``h_update_fused_q``, which take
Hᵀ and Wᵀ, these take W and H as they are: the kernels read both along
their contiguous axis, so no transpose is needed.

Beside each wrapper is its plain torch twin (``*_plain``); a wrapper runs
it only for CPU tensors. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from nmftpu_torch.kernels import dense_mu as K
from nmftpu_torch.kernels.dense_mu import (
    _check_cuda_operands,
    _check_shapes,
    _on_cpu,
    launch,
)
from nmftpu_torch.linalg.dense import LOCAL, _apply_order

LAUNCHES = {"w_update_fused_q": 0, "h_update_fused_q": 0}

# quantize_v works through V in row blocks of about this many elements,
# so its temporaries stay small next to V itself
_QUANT_CHUNK = 1 << 26


def quantize_v(V, vmax=None):
    """V -> (Vq int8, scale float32 0-dim) with V ~= scale * Vq (symmetric,
    no zero point). Bit-equal to ``nmftpu.kernels.quantized.quantize_v``:
    the same float ops, and ``torch.round`` rounds half to even like
    ``jnp.round``. max|V| is max(max V, -min V), which is exact. `vmax`,
    if given, stands for max|V| (a tile of V passes the whole matrix's)."""
    if vmax is None:
        vmax = torch.maximum(V.amax(), -V.amin())
    scale = vmax / 127.0
    scale = torch.clamp(scale, min=1e-30)
    Vq = torch.empty(V.shape, dtype=torch.int8, device=V.device)
    step = max(1, _QUANT_CHUNK // max(V.shape[1], 1))
    for i in range(0, V.shape[0], step):
        Vq[i:i + step] = torch.clamp(
            torch.round(V[i:i + step] / scale), -127, 127
        ).to(torch.int8)
    return Vq, scale.to(torch.float32)


def w_update_fused_q_plain(Vq, scale, W, H, G, eps=1e-9):
    """W * (scale * Vq H^T) / (W G + eps)."""
    numer = (Vq.to(W.dtype) @ H.T) * scale
    return W * numer / (W @ G + eps)


def h_update_fused_q_plain(Vq, scale, W, H, G, eps=1e-9):
    """H * (scale * W^T Vq) / (G H + eps)."""
    numer = (W.T @ Vq.to(W.dtype)) * scale
    return H * numer / (G @ H + eps)


def w_update_fused_q(Vq, scale, W, H, G, eps=1e-9):
    """W * (V H^T) / (W G + eps) with V = scale * Vq (int8), in one
    kernel; G = H H^T. Returns a new (n, r) tensor."""
    if _on_cpu(Vq, scale, W, H, G):
        _check_shapes("w_update_fused_q", Vq, W, H, G)
        return w_update_fused_q_plain(Vq, scale, W, H, G, eps)
    _check_cuda_operands("w_update_fused_q", Vq, torch.int8, W, H, G, scale)
    return launch("nmftpu_w_update_i8", "w_update_fused_q", LAUNCHES,
                  Vq, scale, W, H, G, torch.empty_like(W), eps)


def h_update_fused_q(Vq, scale, W, H, G, eps=1e-9):
    """H * (W^T V) / (G H + eps) with V = scale * Vq (int8), in one
    kernel; G = W^T W. Returns a new (r, m) tensor."""
    if _on_cpu(Vq, scale, W, H, G):
        _check_shapes("h_update_fused_q", Vq, W, H, G)
        return h_update_fused_q_plain(Vq, scale, W, H, G, eps)
    _check_cuda_operands("h_update_fused_q", Vq, torch.int8, W, H, G, scale)
    return launch("nmftpu_h_update_i8", "h_update_fused_q", LAUNCHES,
                  Vq, scale, W, H, G, torch.empty_like(H), eps)


def _vq_ht(Vq, H, block_rows=4096):
    """Vq Hᵀ (n, r) in H's dtype, the int8 rows upcast a panel at a time
    (the fused kernels' numerator before the scale)."""
    out = torch.empty((Vq.shape[0], H.shape[0]), dtype=H.dtype,
                      device=H.device)
    for s in range(0, Vq.shape[0], block_rows):
        out[s:s + block_rows] = Vq[s:s + block_rows].to(H.dtype) @ H.T
    return out


def _wt_vq(W, Vq, block_rows=4096):
    """Wᵀ Vq (r, m) in W's dtype, summed over row panels of Vq."""
    out = torch.zeros((W.shape[1], Vq.shape[1]), dtype=W.dtype,
                      device=W.device)
    for s in range(0, Vq.shape[0], block_rows):
        out += W[s:s + block_rows].T @ Vq[s:s + block_rows].to(W.dtype)
    return out


def mu_update_frobenius_q(Vq, scale, W, H, eps=1e-9, order="WH",
                          sums=LOCAL):
    """Full MU (Frobenius) iteration against int8-quantized V. Semantics
    match nmftpu_torch.linalg.dense.mu_update_frobenius on V = scale * Vq.
    A half-step that is not local to this tile (`sums`) sums the float
    numerator scale · Vq Hᵀ (Wᵀ Vq) over the ranks and ends on
    ``dense_mu.fused_multiply_divide``. Returns new tensors."""

    def upd_w(W, H):
        G = sums.cols(H @ H.T)
        if sums.local_w:
            return w_update_fused_q(Vq, scale, W, H, G, eps=eps)
        return K.fused_multiply_divide(W, sums.cols(_vq_ht(Vq, H)) * scale,
                                       W @ G, eps=eps)

    def upd_h(W, H):
        G = sums.rows(W.T @ W)
        if sums.local_h:
            return h_update_fused_q(Vq, scale, W, H, G, eps=eps)
        return K.fused_multiply_divide(H, sums.rows(_wt_vq(W, Vq)) * scale,
                                       G @ H, eps=eps)

    return _apply_order(upd_w, upd_h, W, H, order)
