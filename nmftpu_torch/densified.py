"""Densified sparse strategy (port of the MU Frobenius, KL, weighted and
beta-divergence subset of ``nmftpu/densified.py``, bf16 and int8
storage, and of its ALS-family, GDCLS and nsNMF updates, which the
dense registry runs on bf16 V and, for nsNMF under KL, on int8 V).

Whenever the interaction matrix fits device memory as bfloat16 (ML-20M
is 7.4 GB) or int8, the nonzeros are scattered into a dense V ONCE and
the updates run dense: computing the zeros costs less than gathering
around them. The Frobenius objective is unchanged (it is defined over
all nm entries); KL, its divergence and the confidence-weighted update
run over row panels of `block_rows` rows, so neither the dense ratio
V/(WH), nor C = 1 + αV, nor C⊙(WH), nor any V-sized float32 copy ever
exists.

Every contraction takes bf16-rounded operands and sums in float32, the
contract of ``dot_general(bf16, bf16, preferred_element_type=f32)``:
the rounded operands are upcast and multiplied in float32, where each
product of two bf16 values is exact (``linalg.dense._bf16_dot``).

int8 storage (`densify_quantized`): V ~= scale · Vq with one symmetric
scale. The KL and beta numerators fold the scale in after the
contraction; the
weighted update applies it per panel before the confidence; the
Frobenius MU runs on ``linalg.dense.mu_update_frobenius_int8x8`` (the
int8 kernels' one-sided entries on the card).

The updates take ``linalg.dense.Sums`` as the dense ones do (`sums`,
for a tile of V on a mesh).
"""

from __future__ import annotations

import torch

from nmftpu_torch.linalg.dense import (
    LOCAL,
    _apply_order,
    _bf16_dot,
    _beta_apply,
    _beta_powers,
    _jacobi_kl_scale,
    _panels,
    beta_gamma,
    solve_clamped,
)
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


def densify_quantized(coo: DeviceCOO, row_multiple: int = 1,
                      clip: float = 127.0):
    """Scatter the padded COO into a dense (n_pad, m) int8 tensor with one
    symmetric per-matrix scale, V ~= scale · Vq -> (Vq, scale float32
    0-dim). The same padding contract as `densify`. Each value rounds
    to scale · round(v / scale) (half to even, clipped to ±clip), an
    error of at most scale / 2; exact where the values lie on a grid of
    at most 255 levels (e.g. implicit-feedback 1s). Duplicate
    coordinates sum IN INT8, as in ``nmftpu``: two entries of one cell
    can wrap past 127 (a behaviour of the reference, kept)."""
    n, m = coo.shape
    n_pad = ((n + row_multiple - 1) // row_multiple) * row_multiple
    scale = torch.clamp(coo.values.abs().amax() / clip,
                        min=1e-30).to(torch.float32)
    acc = torch.zeros((n_pad, m), dtype=torch.int8, device=coo.values.device)
    flat = acc.view(-1)
    for v, rr, cc in _chunks(coo):
        q = torch.clamp(torch.round(v.to(torch.float32) / scale), -clip,
                        clip).to(torch.int8)
        flat.index_add_(0, rr.long() * m + cc, q)
    return acc, scale


def _kl_numer_w_blocked(Vd, Q, P, eps, block_rows, scale=None):
    """Blockwise numerator (V / (Q P)) Pᵀ -> (n, r) for the left-factor
    KL half-step; Q (n, r) forms the reconstruction with P (r, m). Each
    panel's WH and ratio exist at panel size only. `scale` (int8
    storage, V = scale · Vd): the ratio Vq / (WH + eps) is contracted
    and the scalar multiplies the result, as in ``nmftpu``."""
    n = Vd.shape[0]
    Pt = P.T.to(torch.bfloat16)
    out = torch.empty((n, Q.shape[1]), dtype=torch.float32, device=Vd.device)
    for s, e in _panels(n, block_rows):
        WH = _bf16_dot(Q[s:e], P)
        ratio = Vd[s:e].float() / (WH + eps)
        out[s:e] = _bf16_dot(ratio, Pt)
    return out if scale is None else out * scale


def _kl_numer_h_blocked(Vd, Q, H, eps, block_rows, scale=None):
    """Blockwise numerator Qᵀ (V / (Q H)) -> (r, m) for the right-factor
    KL half-step, accumulated over row panels; `scale` as in
    `_kl_numer_w_blocked`."""
    n = Vd.shape[0]
    out = torch.zeros((Q.shape[1], H.shape[1]), dtype=torch.float32,
                      device=Vd.device)
    for s, e in _panels(n, block_rows):
        WH = _bf16_dot(Q[s:e], H)
        ratio = Vd[s:e].float() / (WH + eps)
        out += _bf16_dot(Q[s:e].T, ratio)
    return out if scale is None else out * scale


def mu_update_kl_densified(Vd, W, H, eps=1e-9, order="WH", block_rows=4096,
                           scale=None, sums=LOCAL):
    """KL MU against a dense bf16 or int8 V, blockwise over row panels:
    one pass over V per half-step; WH = W_blk H and the ratio V/(WH)
    live only at panel size. Orders "WH", "HW" and "jacobi" (both
    numerators from the incoming factors, with the KL scale correction
    of ``linalg.dense.mu_update_kl``; ΣV is summed in float32). `scale`:
    int8-stored V = scale · Vd, folded into the numerators (and ΣV)."""

    def upd_w(W, H):
        numer = sums.cols(_kl_numer_w_blocked(Vd, W, H, eps, block_rows,
                                              scale))
        h_sum = torch.clamp(sums.cols(torch.sum(H, dim=1)), min=eps)[None, :]
        return W * (numer / h_sum)

    def upd_h(W, H):
        numer = sums.rows(_kl_numer_h_blocked(Vd, W, H, eps, block_rows,
                                              scale))
        w_sum = torch.clamp(sums.rows(torch.sum(W, dim=0)), min=eps)[:, None]
        return H * (numer / w_sum)

    if order == "jacobi":
        numer_w = sums.cols(_kl_numer_w_blocked(Vd, W, H, eps, block_rows,
                                                scale))
        numer_h = sums.rows(_kl_numer_h_blocked(Vd, W, H, eps, block_rows,
                                                scale))
        h_sum = torch.clamp(sums.cols(torch.sum(H, dim=1)), min=eps)
        w_sum = torch.clamp(sums.rows(torch.sum(W, dim=0)), min=eps)
        sum_v = sums.both(torch.sum(Vd, dtype=torch.float32))
        if scale is not None:
            sum_v = sum_v * scale
        inv_a = _jacobi_kl_scale(sum_v, w_sum, h_sum, eps)
        return (W * (numer_w / h_sum[None, :]) * inv_a,
                H * (numer_h / w_sum[:, None]) * inv_a)
    return _apply_order(upd_w, upd_h, W, H, order)


def nsnmf_update_kl_densified(Vd, W, H, S, eps=1e-9, order="WH",
                              block_rows=4096, scale=None, sums=LOCAL):
    """nsNMF under KL against a dense bf16 or int8 V: KL MU half-steps
    over row panels with the smoothed partners (S H stands in for H in
    the W step, W S for W in the H step). `scale` as in
    `mu_update_kl_densified` (int8-stored V = scale · Vd)."""

    def upd_w(W, H):
        SH = S @ H
        numer = sums.cols(_kl_numer_w_blocked(Vd, W, SH, eps, block_rows,
                                              scale))
        s_sum = torch.clamp(sums.cols(torch.sum(SH, dim=1)), min=eps)[None, :]
        return W * (numer / s_sum)

    def upd_h(W, H):
        WS = W @ S
        numer = sums.rows(_kl_numer_h_blocked(Vd, WS, H, eps, block_rows,
                                              scale))
        s_sum = torch.clamp(sums.rows(torch.sum(WS, dim=0)), min=eps)[:, None]
        return H * (numer / s_sum)

    return _apply_order(upd_w, upd_h, W, H, order)


def _big_vht(Vd, H):
    """V·Hᵀ (n, r) in float32 from bf16-rounded V and H (`_bf16_dot`)."""
    return _bf16_dot(Vd, H.T)


def _big_wtv(W, Vd):
    """Wᵀ·V (r, m) in float32 from bf16-rounded W and V."""
    return _bf16_dot(W.T, Vd)


def als_family_update_densified(Vd, W, H, shift_w=0.0, shift_h=0.0,
                                off_w=0.0, off_h=0.0, eps=1e-9, order="WH",
                                sums=LOCAL):
    """ALS / ACLS / AHCLS (the shifts of ``linalg.dense._als_family_shifts``)
    against a dense bf16 V: the O(nmr) right-hand sides contract bf16
    operands into float32 (`_big_vht`, `_big_wtv`); the r x r solves run
    in the factors' dtype (``linalg.dense.solve_clamped``)."""

    def upd_w(W, H):
        rhs = sums.cols(_big_vht(Vd, H)).T.to(H.dtype)    # (r, n)
        return solve_clamped(sums.cols(H @ H.T), rhs, shift_w, off_w, eps).T

    def upd_h(W, H):
        rhs = sums.rows(_big_wtv(W, Vd)).to(W.dtype)      # (r, m)
        return solve_clamped(sums.rows(W.T @ W), rhs, shift_h, off_h, eps)

    return _apply_order(upd_w, upd_h, W, H, order)


def gdcls_update_densified(Vd, W, H, lambda_tik=0.0, eps=1e-9, order="WH",
                           sums=LOCAL):
    """GDCLS against a dense bf16 V: the MU W step and the Tikhonov H
    solve, both right-hand sides bf16 contractions."""

    def upd_w(W, H):
        return W * (sums.cols(_big_vht(Vd, H))
                    / (W @ sums.cols(H @ H.T) + eps))

    def upd_h(W, H):
        return solve_clamped(sums.rows(W.T @ W),
                             sums.rows(_big_wtv(W, Vd)).to(W.dtype),
                             lambda_tik, 0.0, eps)

    return _apply_order(upd_w, upd_h, W, H, order)


def nsnmf_update_densified(Vd, W, H, S, eps=1e-9, order="WH", sums=LOCAL):
    """nsNMF (Frobenius) against a dense bf16 V: MU against the smoothed
    partners, the numerators bf16 contractions."""

    def upd_w(W, H):
        SH = S @ H
        return W * (sums.cols(_big_vht(Vd, SH))
                    / (W @ sums.cols(SH @ SH.T) + eps))

    def upd_h(W, H):
        WS = W @ S
        return H * (sums.rows(_big_wtv(WS, Vd))
                    / (sums.rows(WS.T @ WS) @ H + eps))

    return _apply_order(upd_w, upd_h, W, H, order)


def _beta_terms_w_blocked(Vd, W, H, beta, eps, block_rows, scale=None):
    """Blockwise numer = ((WH)^(β-2) ⊙ V) Hᵀ and denom = (WH)^(β-1) Hᵀ,
    both (n, r), for the beta-MU W half-step: one pass over V, WH = W_blk
    H (bf16 operands, float32 sums) and its powers at panel size only;
    the two weighted panels round to bf16 in their contractions, as in
    ``nmftpu``. `scale` (int8 storage, V = scale · Vd): the power
    multiplies the stored int8 value and the scalar multiplies the
    numerator after the contraction (V enters it linearly). `eps` is
    unused (the guards are `_beta_powers`' EPSILON clamps)."""
    n = Vd.shape[0]
    Ht = H.T.to(torch.bfloat16)
    numer = torch.empty((n, W.shape[1]), dtype=torch.float32,
                        device=Vd.device)
    denom = torch.empty_like(numer)
    for s, e in _panels(n, block_rows):
        pwr_n, pwr_d = _beta_powers(_bf16_dot(W[s:e], H), beta)
        pwr_n *= Vd[s:e]
        numer[s:e] = _bf16_dot(pwr_n, Ht)
        del pwr_n
        denom[s:e] = _bf16_dot(pwr_d, Ht)
    return (numer if scale is None else numer * scale), denom


def _beta_terms_h_blocked(Vd, W, H, beta, eps, block_rows, scale=None):
    """Blockwise numer = Wᵀ ((WH)^(β-2) ⊙ V) and denom = Wᵀ (WH)^(β-1),
    both (r, m), accumulated over row panels; the rest as
    `_beta_terms_w_blocked`."""
    Hb = H.to(torch.bfloat16)
    numer = torch.zeros((W.shape[1], H.shape[1]), dtype=torch.float32,
                        device=Vd.device)
    denom = torch.zeros_like(numer)
    for s, e in _panels(Vd.shape[0], block_rows):
        Wt = W[s:e].T
        pwr_n, pwr_d = _beta_powers(_bf16_dot(W[s:e], Hb), beta)
        pwr_n *= Vd[s:e]
        numer += _bf16_dot(Wt, pwr_n)
        del pwr_n
        denom += _bf16_dot(Wt, pwr_d)
    return (numer if scale is None else numer * scale), denom


def mu_update_beta_densified(Vd, W, H, beta, eps=1e-9, order="WH",
                             block_rows=4096, scale=None, sums=LOCAL):
    """Generalized beta-divergence MU against a dense bf16 or int8 V,
    over row panels (the dense twin is ``linalg.dense.mu_update_beta``):
    sklearn's float beta_loss semantics, i.e. the EPSILON power guards
    of `_beta_powers`, a zero denominator replaced by EPSILON, the gamma
    exponent, and entries below float64's machine eps zeroed after each
    half-step when β < 1. `eps` is accepted for the update signature and
    unused. Orders "WH" and "HW"."""
    gamma = beta_gamma(beta)

    def upd_w(W, H):
        numer, denom = _beta_terms_w_blocked(Vd, W, H, beta, eps, block_rows,
                                             scale)
        return _beta_apply(W, sums.cols(numer), sums.cols(denom), beta,
                           gamma)

    def upd_h(W, H):
        numer, denom = _beta_terms_h_blocked(Vd, W, H, beta, eps, block_rows,
                                             scale)
        return _beta_apply(H, sums.rows(numer), sums.rows(denom), beta,
                           gamma)

    return _apply_order(upd_w, upd_h, W, H, order)


def beta_divergence_densified(Vd, W, H, beta, eps=1e-12, block_rows=4096,
                              scale=None):
    """D_β(V || WH) over row panels, with the zero-entry conventions of
    ``linalg.dense.beta_divergence`` (WH clamped to `eps`; for β ≤ 0 V
    too); int8 V is dequantized per panel. β = 0 is the Itakura–Saito
    sum Σ V/WH − log(V/WH) − 1."""
    total = torch.zeros((), dtype=torch.float32, device=Vd.device)
    for s, e in _panels(Vd.shape[0], block_rows):
        V32 = Vd[s:e].float()
        if scale is not None:
            V32 = V32 * scale
        WH = torch.clamp(_bf16_dot(W[s:e], H), min=eps)
        if beta == 0.0:
            div = torch.clamp(V32, min=eps) / WH
            total += torch.sum(div - torch.log(div) - 1.0)
            continue
        if beta <= 0.0:
            Vb = torch.clamp(V32, min=eps) ** beta
        else:
            Vb = torch.where(V32 > 0,
                             torch.where(V32 > 0, V32, 1.0) ** beta, 0.0)
        total += torch.sum(Vb + (beta - 1.0) * WH ** beta
                           - beta * V32 * WH ** (beta - 1.0))
    return total if beta == 0.0 else total / (beta * (beta - 1.0))


def _weighted_panel(Vd, W, H, alpha, s, e, scale):
    """(C⊙V, C⊙WH) of rows s:e in float32, C = 1 + alpha·V."""
    V32 = Vd[s:e].float()
    if scale is not None:
        V32 = V32 * scale
    C = V32 * alpha
    C += 1.0
    CWH = _bf16_dot(W[s:e], H)
    CWH *= C
    C *= V32
    return C, CWH


def _weighted_terms_w_blocked(Vd, W, H, alpha, block_rows, scale=None):
    """numer = (C⊙V) Hᵀ and denom = (C⊙WH) Hᵀ, both (n, r) float32,
    over row panels."""
    n, Ht = Vd.shape[0], H.T
    numer = torch.empty((n, W.shape[1]), dtype=torch.float32,
                        device=Vd.device)
    denom = torch.empty_like(numer)
    for s, e in _panels(n, block_rows):
        CV, CWH = _weighted_panel(Vd, W, H, alpha, s, e, scale)
        numer[s:e] = _bf16_dot(CV, Ht)
        del CV
        denom[s:e] = _bf16_dot(CWH, Ht)
    return numer, denom


def _weighted_terms_h_blocked(Vd, W, H, alpha, block_rows, scale=None):
    """numer = Wᵀ (C⊙V) and denom = Wᵀ (C⊙WH), both (r, m) float32,
    accumulated over row panels."""
    numer = torch.zeros((W.shape[1], H.shape[1]), dtype=torch.float32,
                        device=Vd.device)
    denom = torch.zeros_like(numer)
    for s, e in _panels(Vd.shape[0], block_rows):
        CV, CWH = _weighted_panel(Vd, W, H, alpha, s, e, scale)
        Wt = W[s:e].T
        numer += _bf16_dot(Wt, CV)
        del CV
        denom += _bf16_dot(Wt, CWH)
    return numer, denom


def mu_update_frobenius_weighted_densified(Vd, W, H, alpha, eps=1e-9,
                                           order="WH", block_rows=4096,
                                           scale=None, sums=LOCAL):
    """Confidence-weighted MU (c = 1 + alpha·v) against a dense bf16 or
    int8 V, over row panels: per panel V32 = V in float32 (times `scale`
    for int8), C = 1 + alpha·V32, WH as a bf16 x bf16 -> float32
    product, then C⊙V and C⊙WH, which the contractions with H or W round
    to bf16 (where ``nmftpu`` rounds them). Each half-step computes only
    its own numerator and denominator, so C and C⊙WH exist at panel size
    only. Orders "WH" and "HW"."""

    def upd_w(W, H):
        numer, denom = _weighted_terms_w_blocked(Vd, W, H, alpha,
                                                 block_rows, scale)
        return W * (sums.cols(numer) / (sums.cols(denom) + eps))

    def upd_h(W, H):
        numer, denom = _weighted_terms_h_blocked(Vd, W, H, alpha,
                                                 block_rows, scale)
        return H * (sums.rows(numer) / (sums.rows(denom) + eps))

    return _apply_order(upd_w, upd_h, W, H, order)


def frobenius_error_densified(Vd, W, H, sum_v_sq, block_rows=4096):
    """Gram-trick ||V - WH||_F with bf16 V; `sum_v_sq` must come from the
    same bf16-rounded V (`sum_v_sq_densified`) for the cancellation to
    hold. The cross term Wᵀ V contracts bf16 W and V in row panels."""
    WtV = _bf16_dot(W.T, Vd, block_rows)
    cross = torch.sum(WtV * H)
    quad = torch.sum((W.T @ W) * (H @ H.T))
    return torch.sqrt(torch.clamp(sum_v_sq - 2.0 * cross + quad, min=0.0))


def frobenius_error_int8_densified(Vq, scale, W, H, sum_v_sq,
                                   block_rows=4096):
    """Gram-trick ||scale·Vq - WH||_F. The cross term contracts bf16 W
    with Vq in row panels (int8 is exact in bf16), scaled after;
    `sum_v_sq` must come from `sum_v_sq_int8_densified`."""
    WtV = _bf16_dot(W.T, Vq, block_rows)
    cross = scale * torch.sum(WtV * H)
    quad = torch.sum((W.T @ W) * (H @ H.T))
    return torch.sqrt(torch.clamp(sum_v_sq - 2.0 * cross + quad, min=0.0))


def kl_error_densified(Vd, W, H, eps=1e-12, block_rows=4096, scale=None):
    """Blockwise D_KL(V || WH) against dense bf16 V, or int8 V with
    `scale` (dequantized per panel); no V-sized intermediates."""
    total = torch.zeros((), dtype=torch.float32, device=Vd.device)
    for s, e in _panels(Vd.shape[0], block_rows):
        V32 = Vd[s:e].float()
        if scale is not None:
            V32 = V32 * scale
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


def sum_v_sq_int8_densified(Vq, scale, block_rows=4096):
    """||scale·Vq||_F² = scale² · Σ Vq², the sum in float32 per panel."""
    return scale * scale * sum_v_sq_densified(Vq, block_rows)
