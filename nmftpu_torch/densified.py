"""Densified-bf16 sparse strategy (port of the bf16 MU Frobenius/KL
subset of ``nmftpu/densified.py``).

Whenever the interaction matrix fits device memory as bfloat16 (ML-20M
is 7.4 GB), the nonzeros are scattered into a dense bf16 V ONCE and the
updates run dense: computing the zeros costs less than gathering around
them. The Frobenius objective is unchanged (it is defined over all nm
entries); KL and its divergence run over row panels of `block_rows`
rows, so neither the dense ratio V/(WH) nor any V-sized float32 copy
ever exists.

Every contraction takes bf16-rounded operands and sums in float32, the
contract of ``dot_general(bf16, bf16, preferred_element_type=f32)``:
the rounded operands are upcast and multiplied in float32, where each
product of two bf16 values is exact (``linalg.dense._bf16_dot``).

The int8 storage (``densify_quantized`` and the int8 branches) needs the
int8 x int8 contraction that ROADMAP queue 1 item 2 still owes, and
raises in ``sparse_ops``.
"""

from __future__ import annotations

import torch

from nmftpu_torch.linalg.dense import _apply_order, _bf16_dot
from nmftpu_torch.sparse_ops import DeviceCOO, _chunks


def densify(coo: DeviceCOO, dtype=torch.bfloat16,
            row_multiple: int = 1) -> torch.Tensor:
    """Scatter the padded COO into a dense (n_pad, m) tensor of `dtype`
    on the COO's device, once; n_pad rounds n up to `row_multiple`. The
    extra zero rows are absorbing under every update rule. Values round
    to `dtype` (to nearest even) before they are added; duplicates sum
    (in `dtype`, in no set order on CUDA). Padding entries add 0 at
    (0, 0)."""
    n, m = coo.shape
    n_pad = ((n + row_multiple - 1) // row_multiple) * row_multiple
    acc = torch.zeros((n_pad, m), dtype=dtype, device=coo.values.device)
    flat = acc.view(-1)
    for v, rr, cc in _chunks(coo):
        flat.index_add_(0, rr.long() * m + cc, v.to(dtype))
    return acc


def _panels(n: int, block_rows: int):
    """(start, stop) of the row panels, the last one possibly shorter."""
    return ((s, min(s + block_rows, n)) for s in range(0, n, block_rows))


def _kl_numer_w_blocked(Vd, Q, P, eps, block_rows):
    """Blockwise numerator (V / (Q P)) Pᵀ -> (n, r) for the left-factor
    KL half-step; Q (n, r) forms the reconstruction with P (r, m). Each
    panel's WH and ratio exist at panel size only."""
    n = Vd.shape[0]
    Pt = P.T.to(torch.bfloat16)
    out = torch.empty((n, Q.shape[1]), dtype=torch.float32, device=Vd.device)
    for s, e in _panels(n, block_rows):
        WH = _bf16_dot(Q[s:e], P)
        ratio = Vd[s:e].float() / (WH + eps)
        out[s:e] = _bf16_dot(ratio, Pt)
    return out


def _kl_numer_h_blocked(Vd, Q, H, eps, block_rows):
    """Blockwise numerator Qᵀ (V / (Q H)) -> (r, m) for the right-factor
    KL half-step, accumulated over row panels."""
    n = Vd.shape[0]
    out = torch.zeros((Q.shape[1], H.shape[1]), dtype=torch.float32,
                      device=Vd.device)
    for s, e in _panels(n, block_rows):
        WH = _bf16_dot(Q[s:e], H)
        ratio = Vd[s:e].float() / (WH + eps)
        out += _bf16_dot(Q[s:e].T, ratio)
    return out


def mu_update_kl_densified(Vd, W, H, eps=1e-9, order="WH", block_rows=4096):
    """KL MU against a dense bf16 V, blockwise over row panels: one pass
    over V per half-step; WH = W_blk H and the ratio V/(WH) live only at
    panel size. Orders "WH" and "HW"; "jacobi" raises."""

    def upd_w(W, H):
        numer = _kl_numer_w_blocked(Vd, W, H, eps, block_rows)
        h_sum = torch.clamp(torch.sum(H, dim=1), min=eps)[None, :]
        return W * (numer / h_sum)

    def upd_h(W, H):
        numer = _kl_numer_h_blocked(Vd, W, H, eps, block_rows)
        w_sum = torch.clamp(torch.sum(W, dim=0), min=eps)[:, None]
        return H * (numer / w_sum)

    return _apply_order(upd_w, upd_h, W, H, order)


def frobenius_error_densified(Vd, W, H, sum_v_sq, block_rows=4096):
    """Gram-trick ||V - WH||_F with bf16 V; `sum_v_sq` must come from the
    same bf16-rounded V (`sum_v_sq_densified`) for the cancellation to
    hold. The cross term Wᵀ V contracts bf16 W and V in row panels."""
    WtV = _bf16_dot(W.T, Vd, block_rows)
    cross = torch.sum(WtV * H)
    quad = torch.sum((W.T @ W) * (H @ H.T))
    return torch.sqrt(torch.clamp(sum_v_sq - 2.0 * cross + quad, min=0.0))


def kl_error_densified(Vd, W, H, eps=1e-12, block_rows=4096):
    """Blockwise D_KL(V || WH) against dense bf16 V (no V-sized
    intermediates)."""
    total = torch.zeros((), dtype=torch.float32, device=Vd.device)
    for s, e in _panels(Vd.shape[0], block_rows):
        V32 = Vd[s:e].float()
        WH = _bf16_dot(W[s:e], H)
        term = torch.where(
            V32 > 0,
            V32 * torch.log(torch.clamp(V32, min=eps)
                            / torch.clamp(WH, min=eps)),
            0.0,
        )
        total += torch.sum(term - V32 + WH)
    return total


def sum_v_sq_densified(Vd, block_rows=4096):
    """||V||_F² in float32, panel by panel (no full float32 copy of V)."""
    total = torch.zeros((), dtype=torch.float32, device=Vd.device)
    for s, e in _panels(Vd.shape[0], block_rows):
        blk = Vd[s:e].float()
        total += torch.sum(blk * blk)
    return total
