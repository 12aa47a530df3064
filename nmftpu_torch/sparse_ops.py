"""Sparse NMF on one device (port of ``nmftpu/sparse_ops.py``): the
scatter-COO engine, sparse init, and the driver that routes sparse V to
the scatter, ELL or densified engine.

Nonzeros live in a zero-padded, row-sorted COO layout (`DeviceCOO`),
processed in chunks of `chunk` nonzeros (`index_select` gathers and
`index_add_` scatters), so no nnz x r intermediate exists at once.
Padding entries carry value 0 and indices 0, exact no-ops in every
primitive. On CUDA `index_add_` is atomic: its summation order changes
from run to run.

Primitives (all O(nnz · r)):
  wt_v(coo, W)        -> Wᵀ V   (r, m)     [scatter-add over columns]
  v_ht(coo, H)        -> V Hᵀ   (n, r)     [scatter-add over rows]
  sddmm(coo, W, H)    -> (W H) sampled at the nonzero positions  (N,)

Every algorithm of ``nmftpu`` runs here: MU under the Frobenius, KL and
generalized beta objectives, confidence-weighted (alpha_confidence > 0)
and masked (mask="observed"); the ALS family (ALS, ACLS, AHCLS), GDCLS,
nsNMF (Frobenius, KL) and HALS (scatter only; its sweeps on the CUDA
HALS kernel for float32 on the card); iALS and masked completion ALS
(per-row normal equations, `ell` and `scatter`). The engines are
`scatter`, `ell` and `densified` (bf16 or int8 V; the int8 ALS family,
GDCLS and nsNMF-Frobenius take their right-hand sides from the int8
kernel's one-sided entries). The inits are all of ``nmftpu``'s: copy,
random, mean_columns, the three k-means ones (Lloyd over the sparse
columns) and the NNDSVD variants (a host `svds`, V never densified).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

import numpy as np
import torch

from nmftpu_torch import sparse as host_sparse
from nmftpu_torch.algorithms.registry import _identity_h, _smoothed_h
from nmftpu_torch.config import (
    Algorithm,
    Initialization,
    NmfConfig,
    Objective,
    resolve_dtype,
)
from nmftpu_torch.driver import _resolve_device
from nmftpu_torch.init import run_generator
from nmftpu_torch.linalg.dense import (
    EPSILON,
    _acc_dtype,
    _als_family_shifts,
    _apply_order,
    _beta_apply,
    beta_denom_h_blocked,
    beta_denom_w_blocked,
    beta_gamma,
    beta_sum_wh_blocked,
    hals_half_sweep,
    nsnmf_smoothing_matrix,
    row_solver,
    solve_clamped,
)
from nmftpu_torch.loop import LoopOps, NmfResult, build_runner, execute

DEFAULT_CHUNK = 131072

# Device-memory budget for the densified-bf16 strategy: matrices up to
# this dense-bf16 footprint run dense instead of on the gather/scatter
# engines. Override with NMFTPU_DENSIFY_BUDGET_BYTES.
DENSIFY_BUDGET_BYTES = int(
    os.environ.get("NMFTPU_DENSIFY_BUDGET_BYTES", 8 * 1024**3)
)


@dataclasses.dataclass(frozen=True)
class DeviceCOO:
    """Padded, row-sorted COO on a device. Padding: value 0, row/col 0."""

    values: torch.Tensor  # (N,) padded to a multiple of `chunk`
    rows: torch.Tensor    # (N,) int32
    cols: torch.Tensor    # (N,) int32
    shape: tuple[int, int]
    nnz: int              # true nonzero count
    chunk: int

    @property
    def n_chunks(self) -> int:
        return self.values.shape[0] // self.chunk

    def with_values(self, values) -> "DeviceCOO":
        return dataclasses.replace(self, values=values)


def device_put_sparse(
    mat: host_sparse.SparseMatrix,
    dtype=torch.float32,
    chunk: int = DEFAULT_CHUNK,
    device=None,
) -> DeviceCOO:
    """A host sparse container as padded row-sorted DeviceCOO on `device`
    (default "cuda"; raises without one)."""
    device = _resolve_device(None, device)
    csr = mat.to_csr()  # row-major order: locality in the row gather
    coo = csr.to_coo()
    nnz = coo.nnz
    chunk = int(min(chunk, max(256, 1 << (nnz - 1).bit_length())))
    padded = ((nnz + chunk - 1) // chunk) * chunk if nnz else chunk
    values = torch.zeros(padded, dtype=dtype)
    rows = torch.zeros(padded, dtype=torch.int32)
    cols = torch.zeros(padded, dtype=torch.int32)
    values[:nnz] = torch.from_numpy(np.asarray(coo.data)).to(dtype)
    rows[:nnz] = torch.from_numpy(coo.row)
    cols[:nnz] = torch.from_numpy(coo.col)
    return DeviceCOO(
        values=values.to(device), rows=rows.to(device),
        cols=cols.to(device), shape=coo.shape, nnz=nnz, chunk=chunk,
    )


# ---------------------------------------------------------------------------
# Chunked primitives
# ---------------------------------------------------------------------------


def _chunks(coo: DeviceCOO):
    """(values, rows, cols) of each chunk of `coo.chunk` nonzeros."""
    for s in range(0, coo.values.shape[0], coo.chunk):
        e = s + coo.chunk
        yield coo.values[s:e], coo.rows[s:e], coo.cols[s:e]


def wt_v(coo: DeviceCOO, W) -> torch.Tensor:
    """Wᵀ V -> (r, m): scatter v_k · W[row_k, :] into column col_k."""
    acc_dt = _acc_dtype(W.dtype)
    acc = torch.zeros((coo.shape[1], W.shape[1]), dtype=acc_dt,
                      device=W.device)
    for v, rr, cc in _chunks(coo):
        contrib = v[:, None] * W.index_select(0, rr)
        acc.index_add_(0, cc, contrib.to(acc_dt))
    return acc.T.to(W.dtype)


def v_ht(coo: DeviceCOO, H) -> torch.Tensor:
    """V Hᵀ -> (n, r): scatter v_k · H[:, col_k] into row row_k."""
    Ht = H.T.contiguous()
    acc_dt = _acc_dtype(H.dtype)
    acc = torch.zeros((coo.shape[0], H.shape[0]), dtype=acc_dt,
                      device=H.device)
    for v, rr, cc in _chunks(coo):
        contrib = v[:, None] * Ht.index_select(0, cc)
        acc.index_add_(0, rr, contrib.to(acc_dt))
    return acc.to(H.dtype)


def sddmm(coo: DeviceCOO, W, H) -> torch.Tensor:
    """(W H) sampled at the nonzero coordinates -> (N,) padded values
    (pad entries hold W[0]·H[:, 0])."""
    Ht = H.T.contiguous()
    return torch.cat([
        torch.sum(W.index_select(0, rr) * Ht.index_select(0, cc), dim=1)
        for _, rr, cc in _chunks(coo)
    ])


def project_columns(coo: DeviceCOO, weights) -> torch.Tensor:
    """V A for a dense (m, k) column-mixing matrix A -> (n, k) (the
    MeanColumns init's column averages)."""
    return v_ht(coo, weights.T)


def col_sums(coo: DeviceCOO) -> torch.Tensor:
    """Per-column sums of V -> (m,)."""
    acc_dt = _acc_dtype(coo.values.dtype)
    acc = torch.zeros(coo.shape[1], dtype=acc_dt, device=coo.values.device)
    for v, _, cc in _chunks(coo):
        acc.index_add_(0, cc, v.to(acc_dt))
    return acc


# ---------------------------------------------------------------------------
# Sparse error metrics
# ---------------------------------------------------------------------------


def _sum_v_sq(coo: DeviceCOO) -> torch.Tensor:
    vv = coo.values.to(_acc_dtype(coo.values.dtype))
    return torch.sum(vv * vv)


def frobenius_error(coo: DeviceCOO, W, H, sum_v_sq=None) -> torch.Tensor:
    """||V - WH||_F over ALL nm entries by the Gram/trace identity:
    sum_v_sq - 2 tr(Hᵀ (Wᵀ V)) + tr((Wᵀ W)(H Hᵀ)); the only
    nnz-dependent term is the sparse Wᵀ V."""
    if sum_v_sq is None:
        sum_v_sq = _sum_v_sq(coo)
    cross = torch.sum(wt_v(coo, W) * H)
    quad = torch.sum((W.T @ W) * (H @ H.T))
    return torch.sqrt(torch.clamp(sum_v_sq - 2.0 * cross + quad, min=0.0))


def kl_error(coo: DeviceCOO, W, H, eps=1e-12) -> torch.Tensor:
    """D_KL(V || WH) = Σ_nz v log(v / WH) - Σ v + Σ WH, with Σ WH =
    (column sums of W) · (row sums of H): only the nonzero positions
    need the sampled WH."""
    wh_nz = sddmm(coo, W, H)
    v = coo.values
    log_term = torch.where(
        v > 0,
        v * torch.log(torch.clamp(v, min=eps) / torch.clamp(wh_nz, min=eps)),
        0.0,
    )
    sum_wh = torch.sum(W, dim=0) @ torch.sum(H, dim=1)
    return torch.sum(log_term) - torch.sum(v) + sum_wh


# ---------------------------------------------------------------------------
# Sparse update rules
# ---------------------------------------------------------------------------


def mu_update_frobenius_sparse(coo, W, H, eps=1e-9, order="WH"):
    """Sparse MU (Frobenius): numerators are SpMMs, denominators Gram
    products."""

    def upd_w(W, H):
        return W * (v_ht(coo, H) / (W @ (H @ H.T) + eps))

    def upd_h(W, H):
        return H * (wt_v(coo, W) / ((W.T @ W) @ H + eps))

    return _apply_order(upd_w, upd_h, W, H, order)


def mu_update_kl_sparse(coo, W, H, eps=1e-9, order="WH"):
    """Sparse MU (KL): the ratio V/(WH) is nonzero only at V's nonzeros,
    so one SDDMM + one SpMM per half-step; denominators are factor
    sums."""

    def upd_w(W, H):
        ratio = coo.with_values(coo.values / (sddmm(coo, W, H) + eps))
        denom = torch.clamp(torch.sum(H, dim=1), min=eps)[None, :]
        return W * (v_ht(ratio, H) / denom)

    def upd_h(W, H):
        ratio = coo.with_values(coo.values / (sddmm(coo, W, H) + eps))
        denom = torch.clamp(torch.sum(W, dim=0), min=eps)[:, None]
        return H * (wt_v(ratio, W) / denom)

    return _apply_order(upd_w, upd_h, W, H, order)


def _beta_numer_values(coo, W, H, beta):
    """V ⊙ (WH)^(β-2) at the nonzeros, the whole beta-MU numerator
    weight, as a COO of the same structure (sklearn's numerator guard:
    WH clamped up to EPSILON when β < 2). Pad entries carry 0."""
    wh_nz = sddmm(coo, W, H)
    wh_n = torch.clamp(wh_nz, min=EPSILON) if beta < 2.0 else wh_nz
    if beta == 0.0:
        pwr = 1.0 / (wh_n * wh_n)
    else:
        pwr = wh_n ** (beta - 2.0)
    return coo.with_values(coo.values * pwr)


def mu_update_beta_sparse(coo, W, H, beta, eps=1e-9, order="WH",
                          block=2048):
    """Generalized beta-divergence MU on the scatter engine. Numerator:
    (WH)^(β-2) ⊙ V is nonzero only at V's stored set, so it is one SDDMM
    and one scatter SpMM per half-step, as KL's. Denominator:
    (WH)^(β-1) Hᵀ, dense in FLOPs (O(n·m·r)) and streamed through panels
    of `block` columns or rows. Guards, γ and the β < 1 stabilization are
    sklearn's (``linalg.dense.mu_update_beta`` is the dense oracle);
    `eps` is accepted for the update signature and unused."""
    gamma = beta_gamma(beta)

    def upd_w(W, H):
        numer = v_ht(_beta_numer_values(coo, W, H, beta), H)
        return _beta_apply(W, numer, beta_denom_w_blocked(W, H, beta, block),
                           beta, gamma)

    def upd_h(W, H):
        numer = wt_v(_beta_numer_values(coo, W, H, beta), W)
        return _beta_apply(H, numer, beta_denom_h_blocked(W, H, beta, block),
                           beta, gamma)

    return _apply_order(upd_w, upd_h, W, H, order)


def beta_divergence_sparse(coo, W, H, beta, block=2048):
    """D_β(V || WH) with the semantics of sklearn's _beta_divergence on a
    sparse X: stored values filtered to v > EPSILON, the sampled WH
    clamped up to EPSILON, and Σ (WH)^β over all n·m entries computed in
    column panels (β = 0's counterpart of that term is the constant
    n·m)."""
    wh_c = torch.clamp(sddmm(coo, W, H), min=EPSILON)
    v = coo.values
    keep = v > EPSILON
    acc_dt = _acc_dtype(W.dtype)
    n, m = coo.shape
    if beta == 0.0:
        div = (v / wh_c).to(acc_dt)
        return (torch.sum(torch.where(keep, div, 0.0)) - float(n) * float(m)
                - torch.sum(torch.where(
                    keep, torch.log(torch.where(keep, div, 1.0)), 0.0)))
    sum_wh_beta = beta_sum_wh_blocked(W, H, beta, block)
    sum_x_wh = torch.sum(torch.where(
        keep, (v * wh_c ** (beta - 1.0)).to(acc_dt), 0.0))
    sum_x_beta = torch.sum(torch.where(keep, (v ** beta).to(acc_dt), 0.0))
    res = sum_x_beta - beta * sum_x_wh + (beta - 1.0) * sum_wh_beta
    return res / (beta * (beta - 1.0))


def mu_update_frobenius_weighted_sparse(coo, W, H, alpha, eps=1e-9,
                                        order="WH"):
    """Confidence-weighted MU, c = 1 + alpha·v at the nonzeros and 1
    elsewhere (BASELINE config 3). The unit part of C keeps the Gram
    denominators; the alpha part is an SDDMM and an SpMM:

      W <- W ⊙ ((C⊙V) Hᵀ) / (W (H Hᵀ) + alpha (V⊙WH)_nz Hᵀ + eps)
      H <- H ⊙ (Wᵀ (C⊙V)) / ((Wᵀ W) H + alpha Wᵀ (V⊙WH)_nz + eps)
    """
    cv = coo.with_values(coo.values * (1.0 + alpha * coo.values))

    def upd_w(W, H):
        swh = coo.with_values(coo.values * sddmm(coo, W, H))
        denom = W @ (H @ H.T) + alpha * v_ht(swh, H) + eps
        return W * (v_ht(cv, H) / denom)

    def upd_h(W, H):
        swh = coo.with_values(coo.values * sddmm(coo, W, H))
        denom = (W.T @ W) @ H + alpha * wt_v(swh, W) + eps
        return H * (wt_v(cv, W) / denom)

    return _apply_order(upd_w, upd_h, W, H, order)


# ---------------------------------------------------------------------------
# Masked completion (mask="observed"): the objective runs over the stored
# set only
# ---------------------------------------------------------------------------


def _obs_mask(coo: DeviceCOO) -> DeviceCOO:
    """0/1 observation indicator at the stored coordinates. Padding holds
    value 0, so `values != 0` is exactly the valid-entry mask; a stored
    zero counts as unobserved (the NmfConfig.mask contract)."""
    return coo.with_values((coo.values != 0).to(coo.values.dtype))


def mu_update_frobenius_masked(coo, W, H, eps=1e-9, order="WH"):
    """Completion MU under Σ_obs (v - wh)²: the numerator is the observed
    SpMM, the denominator the SpMM of WH sampled on the observed set,

        W <- W ⊙ (V_obs Hᵀ) / ((WH)_obs Hᵀ + eps)

    so unobserved entries exert no pull toward zero."""
    mask = _obs_mask(coo)

    def upd_w(W, H):
        wh = coo.with_values(mask.values * sddmm(coo, W, H))
        return W * (v_ht(coo, H) / (v_ht(wh, H) + eps))

    def upd_h(W, H):
        wh = coo.with_values(mask.values * sddmm(coo, W, H))
        return H * (wt_v(coo, W) / (wt_v(wh, W) + eps))

    return _apply_order(upd_w, upd_h, W, H, order)


def mu_update_kl_masked(coo, W, H, eps=1e-9, order="WH"):
    """Masked KL MU under Σ_obs v log(v/wh) - v + wh: the usual ratio
    SpMM over the observed row/column mass of the partner factor (the
    SpMM of the 0/1 mask) instead of the full sums."""
    mask = _obs_mask(coo)

    def upd_w(W, H):
        ratio = coo.with_values(coo.values / (sddmm(coo, W, H) + eps))
        return W * (v_ht(ratio, H) / (v_ht(mask, H) + eps))

    def upd_h(W, H):
        ratio = coo.with_values(coo.values / (sddmm(coo, W, H) + eps))
        return H * (wt_v(ratio, W) / (wt_v(mask, W) + eps))

    return _apply_order(upd_w, upd_h, W, H, order)


def frobenius_error_masked(coo, W, H) -> torch.Tensor:
    """sqrt(Σ_obs (v - wh)²): the completion residual, not the
    full-matrix Frobenius error."""
    keep = (coo.values != 0).to(torch.float32)
    resid = keep * (coo.values.to(torch.float32) - sddmm(coo, W, H))
    return torch.sqrt(torch.sum(resid * resid))


def kl_error_masked(coo, W, H, eps=1e-12) -> torch.Tensor:
    """Σ_obs v log(v/wh) - v + wh over the observed set."""
    v = coo.values.to(torch.float32)
    wh = torch.clamp(sddmm(coo, W, H), min=eps)
    term = v * torch.log(torch.clamp(v, min=eps) / wh) - v + wh
    return torch.sum(torch.where(coo.values != 0, term, 0.0))


# ---------------------------------------------------------------------------
# The ALS family, HALS, GDCLS and nsNMF on the scatter engine: the O(nnz·r)
# right-hand sides are the SpMMs, the r x r work is dense
# ---------------------------------------------------------------------------


def als_family_update_sparse(coo, W, H, shift_w=0.0, shift_h=0.0, off_w=0.0,
                             off_h=0.0, eps=1e-9, order="WH"):
    """ALS / ACLS / AHCLS on sparse V: the normal equations with the
    sparse right-hand sides V Hᵀ and Wᵀ V, the diagonal (and AHCLS
    off-diagonal) shifts, then clamp (``linalg.dense.solve_clamped``)."""
    def upd_w(W, H):
        return solve_clamped(H @ H.T, v_ht(coo, H).T, shift_w, off_w, eps).T

    def upd_h(W, H):
        return solve_clamped(W.T @ W, wt_v(coo, W), shift_h, off_h, eps)

    return _apply_order(upd_w, upd_h, W, H, order)


def hals_update_sparse(coo, W, H, eps=1e-9, order="WH", l2_w=0.0, l2_h=0.0,
                       l1_w=0.0, l1_h=0.0):
    """HALS on sparse V: the numerators are the SpMMs (V stays sparse),
    the cyclic column sweeps are the dense path's
    (``linalg.dense.hals_half_sweep``: the CUDA sweep kernel for float32
    on the card at r >= 16), which never touch V. `eps` is unused (the
    sweep guards its division)."""
    eye = torch.eye(W.shape[1], dtype=W.dtype, device=W.device)

    def sweep_w(W, H):
        return hals_half_sweep(v_ht(coo, H) - l1_w, H @ H.T + l2_w * eye, W)

    def sweep_h(W, H):
        return hals_half_sweep(wt_v(coo, W).T - l1_h, W.T @ W + l2_h * eye,
                               H.T).T.contiguous()

    return _apply_order(sweep_w, sweep_h, W, H, order)


def gdcls_update_sparse(coo, W, H, lambda_tik=0.0, eps=1e-9, order="WH"):
    """GDCLS on sparse V: the Frobenius MU step for W, the Tikhonov least
    squares (WᵀW + lambda_tik I) H = Wᵀ V for H, clamped."""
    def upd_w(W, H):
        return W * (v_ht(coo, H) / (W @ (H @ H.T) + eps))

    def upd_h(W, H):
        return solve_clamped(W.T @ W, wt_v(coo, W), lambda_tik, 0.0, eps)

    return _apply_order(upd_w, upd_h, W, H, order)


def nsnmf_update_sparse(coo, W, H, S, eps=1e-9, objective="frobenius",
                        order="WH"):
    """nsNMF on sparse V: MU against the smoothed partners (S H stands in
    for H in the W step, W S for W in the H step), under the Frobenius
    objective (SpMM numerators) or KL (an SDDMM ratio and an SpMM)."""
    if objective == "frobenius":
        def upd_w(W, H):
            SH = S @ H
            return W * (v_ht(coo, SH) / (W @ (SH @ SH.T) + eps))

        def upd_h(W, H):
            WS = W @ S
            return H * (wt_v(coo, WS) / ((WS.T @ WS) @ H + eps))
    else:
        def upd_w(W, H):
            SH = S @ H
            ratio = coo.with_values(coo.values / (sddmm(coo, W, SH) + eps))
            denom = torch.clamp(torch.sum(SH, dim=1), min=eps)[None, :]
            return W * (v_ht(ratio, SH) / denom)

        def upd_h(W, H):
            WS = W @ S
            ratio = coo.with_values(coo.values / (sddmm(coo, WS, H) + eps))
            denom = torch.clamp(torch.sum(WS, dim=0), min=eps)[:, None]
            return H * (wt_v(ratio, WS) / denom)

    return _apply_order(upd_w, upd_h, W, H, order)


# ---------------------------------------------------------------------------
# iALS and masked completion ALS: per-row normal equations
# ---------------------------------------------------------------------------


def _weighted_row_grams(coo, T, alpha, n_rows, by_cols=False, sub=4096,
                        weight_fn=None):
    """(n_rows, r, r) float32: per row Σ_nz w(v) · t_c t_cᵀ over the
    row's nonzeros, t_c the gathered row of the (·, r) table T (Hᵀ for
    the W half, W for the H half with `by_cols`). The sparse-aware iALS
    Gram delta: only the observed entries carry c - 1 = αv, so the cost
    is O(nnz · r²). The outer products run in slices of `sub` nonzeros
    (the tail slice of a chunk included), so a (sub, r, r) intermediate
    is the largest; each slice goes to its rows by one `index_add_`.
    weight_fn replaces the weight αv (masked ALS passes the indicator
    v != 0); padding holds v = 0, which both forms weigh 0."""
    if weight_fn is None:
        def weight_fn(v):
            return alpha * v
    r = T.shape[1]
    acc = torch.zeros((n_rows, r, r), dtype=torch.float32, device=T.device)
    T = T.to(torch.float32).contiguous()
    sub = min(sub, coo.chunk)
    for v, rr, cc in _chunks(coo):
        idx, tbl = (cc, rr) if by_cols else (rr, cc)
        for s in range(0, v.shape[0], sub):
            t = T.index_select(0, tbl[s:s + sub])
            w = weight_fn(v[s:s + sub]).to(torch.float32)
            outer = (w[:, None, None] * t[:, :, None]) * t[:, None, :]
            acc.index_add_(0, idx[s:s + sub], outer)
    return acc


def als_update_weighted_sparse(coo, W, H, alpha, lambda_w=0.0, lambda_h=0.0,
                               eps=1e-9, order="WH", solver="exact",
                               cg_steps=3):
    """Sparse-aware confidence-weighted ALS (iALS, Hu-Koren-Volinsky):
    minimizes ||√C ⊙ (V - WH)||² + λ||·||² with C = 1 + αV; each
    half-step solves every row's weighted normal equations

        (H Hᵀ + Σ_{i∈u} αv_ui h_i h_iᵀ + (λ + eps) I) w_u = H (c_u ⊙ v_u)

    in float32 (as ``nmftpu``, whatever the factors' dtype). Unobserved
    entries have c = 1 and enter only through the shared Gram:
    O(nnz · r²) for the Gram deltas, O((n + m) · r³) for the solves,
    and (n + m) · r² · 4 bytes of Grams (`_check_weighted_gram_budget`).
    """
    solve = row_solver(solver, cg_steps)
    cv = coo.with_values(coo.values * (1.0 + alpha * coo.values))
    n, m = coo.shape

    def upd_w(W, H):
        G = (H @ H.T).to(torch.float32)
        dG = _weighted_row_grams(coo, H.T, alpha, n)
        rhs = v_ht(cv, H).to(torch.float32)
        return solve(G, dG, rhs, lambda_w, eps, W).to(W.dtype)

    def upd_h(W, H):
        G = (W.T @ W).to(torch.float32)
        dG = _weighted_row_grams(coo, W, alpha, m, by_cols=True)
        rhs = wt_v(cv, W).T.to(torch.float32)
        return solve(G, dG, rhs, lambda_h, eps, H.T).T.contiguous().to(
            H.dtype)

    return _apply_order(upd_w, upd_h, W, H, order)


def als_update_masked_sparse(coo, W, H, lambda_w=0.0, lambda_h=0.0,
                             eps=1e-9, order="WH", solver="exact",
                             cg_steps=3):
    """Matrix-completion ALS: minimizes Σ_obs (v - wh)² + λ||·||² by
    solving, per row u, the observed-only normal equations

        (Σ_{i∈obs(u)} h_i h_iᵀ + (λ + eps) I) w_u = Σ_{i∈obs(u)} v_ui h_i

    (the iALS machinery with a 0/1 weight and no shared base Gram:
    unobserved entries weigh nothing). A row with no observations solves
    to 0 under the ridge; clamped at 0 as the ALS family is."""
    solve = row_solver(solver, cg_steps)
    n, m = coo.shape

    def indicator(v):
        return v != 0

    def upd_w(W, H):
        dG = _weighted_row_grams(coo, H.T, 0.0, n, weight_fn=indicator)
        rhs = v_ht(coo, H).to(torch.float32)
        return solve(None, dG, rhs, lambda_w, eps, W).to(W.dtype)

    def upd_h(W, H):
        dG = _weighted_row_grams(coo, W, 0.0, m, by_cols=True,
                                 weight_fn=indicator)
        rhs = wt_v(coo, W).T.to(torch.float32)
        return solve(None, dG, rhs, lambda_h, eps, H.T).T.contiguous().to(
            H.dtype)

    return _apply_order(upd_w, upd_h, W, H, order)


def _smoothing_aux(config: NmfConfig, dtype=None):
    """make_aux of nsNMF on a sparse engine: (S,) on the operand's device.
    S is built in `dtype` (scatter: V's) or, by default, in float32 and
    then cast to the factors' dtype, as ``nmftpu``'s densified and ELL
    engines build it and XLA promotes it."""
    factors = resolve_dtype(config.dtype)

    def make_aux(op):
        S = nsnmf_smoothing_matrix(config.rank, config.theta,
                                   dtype=dtype or torch.float32,
                                   device=_operand_device(op))
        return (S.to(factors),)

    return make_aux


def _operand_device(op):
    """The device of a plan's operand: a DeviceCOO, a dense V, the
    (Vq, scale) pair or an EllPair."""
    if isinstance(op, DeviceCOO):
        return op.values.device
    if isinstance(op, tuple):
        op = op[0]
    if isinstance(op, torch.Tensor):
        return op.device
    return op.rows.buckets[0].vals.device


def build_sparse_update(config: NmfConfig):
    """(make_aux, update, effective_h) for the scatter engine, as
    ``nmftpu``'s: MU (Frobenius, KL or beta; confidence-weighted or
    masked), masked completion ALS, iALS, the ALS family, HALS, GDCLS and
    nsNMF."""
    eps = config.eps
    order = config.update_order
    alg = config.algorithm
    no_aux = lambda coo: ()  # noqa: E731

    def run(fn, **kw):
        return (no_aux,
                lambda coo, aux, W, H: fn(coo, W, H, eps=eps, order=order,
                                          **kw),
                _identity_h)

    if alg is Algorithm.MU:
        if config.mask == "observed":
            return run(mu_update_frobenius_masked
                       if config.objective is Objective.FROBENIUS
                       else mu_update_kl_masked)
        if config.alpha_confidence > 0.0:
            return run(mu_update_frobenius_weighted_sparse,
                       alpha=config.alpha_confidence)
        if config.objective is Objective.FROBENIUS:
            return run(mu_update_frobenius_sparse)
        if config.objective is Objective.BETA:
            return run(mu_update_beta_sparse, beta=config.beta)
        return run(mu_update_kl_sparse)
    solves = dict(lambda_w=config.lambda_w, lambda_h=config.lambda_h,
                  solver=config.als_solver, cg_steps=config.cg_steps)
    if alg is Algorithm.ALS and config.mask == "observed":
        return run(als_update_masked_sparse, **solves)
    if alg is Algorithm.ALS and config.alpha_confidence > 0.0:
        return run(als_update_weighted_sparse,
                   alpha=config.alpha_confidence, **solves)
    if alg in (Algorithm.ALS, Algorithm.ACLS, Algorithm.AHCLS):
        return run(als_family_update_sparse, **dict(zip(
            ("shift_w", "shift_h", "off_w", "off_h"),
            _als_family_shifts(config))))
    if alg is Algorithm.HALS:
        return run(hals_update_sparse, l2_w=config.lambda_w,
                   l2_h=config.lambda_h, l1_w=config.l1_w, l1_h=config.l1_h)
    if alg is Algorithm.GDCLS:
        return run(gdcls_update_sparse, lambda_tik=config.lambda_tik)
    if alg is Algorithm.NSNMF:
        obj = "frobenius" if config.objective is Objective.FROBENIUS else "kl"
        return (_smoothing_aux(config, resolve_dtype(config.dtype)),
                lambda coo, aux, W, H: nsnmf_update_sparse(
                    coo, W, H, aux[0], eps=eps, objective=obj, order=order),
                _smoothed_h)
    raise ValueError(f"unknown algorithm: {alg}")


# ---------------------------------------------------------------------------
# Sparse initialization (without densifying V)
# ---------------------------------------------------------------------------


def extract_columns(coo: DeviceCOO, col_idx) -> torch.Tensor:
    """Columns `col_idx` (k distinct indices) of V densified -> (n, k):
    a per-column slot map (slot of each wanted column, -1 elsewhere)
    sends each nonzero of a wanted column to its (row, slot) cell by one
    flat `index_add_` per chunk; the others add 0 at slot 0."""
    n, m = coo.shape
    device = coo.values.device
    col_idx = torch.as_tensor(col_idx, device=device).long()
    k = col_idx.shape[0]
    slot = torch.full((m,), -1, dtype=torch.long, device=device)
    slot[col_idx] = torch.arange(k, device=device)
    acc = torch.zeros((n, k), dtype=coo.values.dtype, device=device)
    flat = acc.view(-1)
    for v, rr, cc in _chunks(coo):
        s = slot[cc.long()]
        flat.index_add_(0, rr.long() * k + torch.clamp(s, min=0),
                        torch.where(s >= 0, v, 0.0))
    return acc


def _lloyd_sparse(coo: DeviceCOO, centroids, max_iter: int):
    """`max_iter` Lloyd rounds over the columns of sparse V from
    `centroids` (n, r), on the SpMM primitives (the twin of
    ``init.kmeans._lloyd``): the assignment's cross term is (Wᵀ V)ᵀ with
    W := centroids, the centroid update V · onehot. Returns (centroids,
    assignments (m,) int64); an empty cluster keeps its centroid."""
    rank = centroids.shape[1]
    col_sq = col_sums(coo.with_values(coo.values * coo.values))

    def assign(centroids):
        cross = wt_v(coo, centroids).T                    # (m, r)
        cent_sq = torch.sum(centroids * centroids, dim=0)
        d2 = col_sq[:, None] - 2.0 * cross + cent_sq[None, :]
        return torch.argmin(d2, dim=1)

    for _ in range(max_iter):
        onehot = torch.nn.functional.one_hot(
            assign(centroids), rank).to(coo.values.dtype)  # (m, r)
        sums = project_columns(coo, onehot)               # (n, r)
        counts = torch.sum(onehot, dim=0)
        new = sums / torch.clamp(counts, min=1.0)[None, :]
        centroids = torch.where(counts[None, :] > 0, new, centroids)
    return centroids, assign(centroids)


def kmeans_columns_sparse(coo: DeviceCOO, rank, gen, max_iter=25):
    """Lloyd's k-means over the columns of sparse V, started from `rank`
    distinct columns drawn with `gen` (a torch.Generator on V's device).
    Returns (centroids (n, rank), assignments (m,))."""
    cols = torch.randperm(coo.shape[1], generator=gen,
                          device=coo.values.device)[:rank]
    return _lloyd_sparse(coo, extract_columns(coo, cols), max_iter)


def host_csr(coo: DeviceCOO):
    """The true nonzeros of `coo` as a scipy CSR on the host (the chunk
    padding stripped)."""
    import scipy.sparse as sps

    k = coo.nnz
    return sps.coo_matrix(
        (coo.values[:k].cpu().numpy(),
         (coo.rows[:k].cpu().numpy(), coo.cols[:k].cpu().numpy())),
        shape=coo.shape).tocsr()


def sparse_initialize_factors(coo: DeviceCOO, rank, method: Initialization,
                              gen, W0=None, H0=None, kmeans_max_iter=25):
    """(W, H) on V's device in V's dtype for every init of ``nmftpu``,
    with V never densified; `gen` is the run's torch.Generator on that
    device. The random draws are the sklearn 'random' convention,
    (u + 1e-4) · sqrt(mean(V) / rank), as in ``nmftpu`` (not its bits);
    the k-means inits cluster V's columns (`kmeans_columns_sparse`), the
    NNDSVD variants run a host `svds` (``init.nndsvd``) with the
    nndsvdar fill seeded from `gen`."""
    n, m = coo.shape
    dtype, device = coo.values.dtype, coo.values.device

    if method is Initialization.COPY_EXISTING:
        if W0 is None or H0 is None:
            raise ValueError("COPY_EXISTING requires both W0 and H0")
        # always copy: the caller's warm start survives restarts
        return (
            torch.as_tensor(W0, dtype=dtype, device=device).clone(),
            torch.as_tensor(H0, dtype=dtype, device=device).clone(),
        )

    mean_v = torch.sum(coo.values) / (float(n) * float(m))
    scale = torch.sqrt(torch.clamp(mean_v, min=1e-12) / rank).to(dtype)

    def rand(shape):
        u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
        return (u + 1e-4) * scale

    if method is Initialization.ALL_RANDOM_VALUES:
        W = rand((n, rank))
        return W, rand((rank, m))

    if method is Initialization.MEAN_COLUMNS:
        q = int(min(max(5, m // max(rank, 1)), m))
        cols = torch.randint(0, m, (rank, q), generator=gen, device=device)
        # A[j, k] = (# times column j was drawn for column k of W) / q
        A = torch.zeros((m, rank), dtype=dtype, device=device)
        A.index_put_(
            (cols.reshape(-1),
             torch.arange(rank, device=device).repeat_interleave(q)),
            torch.tensor(1.0 / q, dtype=dtype, device=device),
            accumulate=True,
        )
        W = project_columns(coo, A)
        return W, rand((rank, m))

    if method in (Initialization.NNDSVD, Initialization.NNDSVDA,
                  Initialization.NNDSVDAR):
        from nmftpu_torch.init.nndsvd import nndsvd_init

        seed = int(torch.randint(0, 2**31 - 1, (), generator=gen,
                                 device=device))
        W, H = nndsvd_init(host_csr(coo), rank, variant=method.value,
                           seed=seed)
        return (torch.as_tensor(W, dtype=dtype, device=device),
                torch.as_tensor(H, dtype=dtype, device=device))

    if method in (Initialization.K_MEANS_AND_RANDOM_VALUES,
                  Initialization.K_MEANS_AND_NON_NEGATIVE_WTV,
                  Initialization.K_MEANS_AND_ABSOLUTE_WTV):
        centroids, _ = kmeans_columns_sparse(coo, rank, gen,
                                             max_iter=kmeans_max_iter)
        W = torch.clamp(centroids, min=0.0) + 1e-6
        if method is Initialization.K_MEANS_AND_RANDOM_VALUES:
            H = rand((rank, m))
        elif method is Initialization.K_MEANS_AND_NON_NEGATIVE_WTV:
            H = torch.clamp(wt_v(coo, W), min=0.0) + 1e-6
        else:
            H = torch.abs(wt_v(coo, W)) + 1e-6
        return W, H

    raise ValueError(f"unknown initialization method: {method}")


# ---------------------------------------------------------------------------
# Engines' loop operations
# ---------------------------------------------------------------------------


def _masked_ops(make_aux, update, frobenius, kl, numel) -> LoopOps:
    """Completion semantics: every reported metric, the RMSD's
    denominator included, runs over the observed set."""
    return LoopOps(
        make_aux=make_aux,
        update=update,
        effective_h=lambda aux, H: H,
        frobenius=lambda V, aux, W, He, svsq: frobenius(V, W, He),
        kl=lambda V, aux, W, He: kl(V, W, He),
        sum_v_sq=lambda V: torch.zeros((), dtype=torch.float32),
        numel=numel,
    )


def _sparse_ops_bundle(config: NmfConfig) -> LoopOps:
    make_aux, update, effective_h = build_sparse_update(config)
    if config.mask == "observed":
        return _masked_ops(make_aux, update, frobenius_error_masked,
                           kl_error_masked, lambda coo: coo.nnz)
    def divergence(coo, aux, W, He):
        if config.objective is Objective.BETA:
            return beta_divergence_sparse(coo, W, He, config.beta)
        return kl_error(coo, W, He)

    return LoopOps(
        make_aux=make_aux,
        update=update,
        effective_h=effective_h,
        frobenius=lambda coo, aux, W, He, svsq: frobenius_error(
            coo, W, He, svsq),
        kl=divergence,
        sum_v_sq=_sum_v_sq,
        numel=lambda coo: coo.shape[0] * coo.shape[1],
    )


def _densified_family(config: NmfConfig, int8: bool):
    """(make_aux, update, effective_h) of the ALS family, GDCLS and nsNMF
    on the densified operand: bf16 Vd, or the (Vq, scale) pair, whose
    Frobenius right-hand sides are #6's one-sided int8 entries on the
    card (``linalg.dense.*_int8x8``)."""
    from nmftpu_torch import densified as DF
    from nmftpu_torch.linalg import dense as D

    eps, order, alg = config.eps, config.update_order, config.algorithm
    no_aux = lambda V: ()  # noqa: E731
    if alg in (Algorithm.ALS, Algorithm.ACLS, Algorithm.AHCLS):
        shifts = dict(zip(("shift_w", "shift_h", "off_w", "off_h"),
                          _als_family_shifts(config)))
        if int8:
            def update(V, aux, W, H):
                return D.als_family_update_int8x8(V[0], V[1], W, H, **shifts,
                                                  eps=eps, order=order)
        else:
            def update(Vd, aux, W, H):
                return DF.als_family_update_densified(Vd, W, H, **shifts,
                                                      eps=eps, order=order)
        return no_aux, update, _identity_h
    if alg is Algorithm.GDCLS:
        lt = config.lambda_tik
        if int8:
            def update(V, aux, W, H):
                return D.gdcls_update_int8x8(V[0], V[1], W, H, lambda_tik=lt,
                                             eps=eps, order=order)
        else:
            def update(Vd, aux, W, H):
                return DF.gdcls_update_densified(Vd, W, H, lambda_tik=lt,
                                                 eps=eps, order=order)
        return no_aux, update, _identity_h
    if alg is not Algorithm.NSNMF:
        raise ValueError(f"algorithm {alg.value!r} does not run on the "
                         "densified engine")
    if config.objective is Objective.KL:
        def update(V, aux, W, H):
            Vd, scale = V if int8 else (V, None)
            return DF.nsnmf_update_kl_densified(Vd, W, H, aux[0], eps=eps,
                                                order=order, scale=scale)
    elif int8:
        def update(V, aux, W, H):
            return D.nsnmf_update_frobenius_int8x8(V[0], V[1], W, H, aux[0],
                                                   eps=eps, order=order)
    else:
        def update(Vd, aux, W, H):
            return DF.nsnmf_update_densified(Vd, W, H, aux[0], eps=eps,
                                             order=order)
    return _smoothing_aux(config), update, _smoothed_h


def _densified_ops_bundle(config: NmfConfig, coo: DeviceCOO) -> LoopOps:
    """Every algorithm but HALS, iALS and masked ALS on the densified
    operand: bf16 Vd, or the (Vq, scale) pair of `densify_quantized`
    under v_storage="int8"."""
    from nmftpu_torch import densified as DF
    from nmftpu_torch.linalg import dense as D

    eps = config.eps
    order = config.update_order
    alpha = config.alpha_confidence
    kl = config.objective is Objective.KL
    beta = config.beta if config.objective is Objective.BETA else None
    int8 = config.v_storage == "int8"
    n, m = coo.shape
    # the true n·m, not the row-padded shape: pad rows add no error
    numel = lambda V: n * m  # noqa: E731

    def divergence(Vd, W, H, scale=None):
        """D_KL, or D_β under the beta objective (int8: with the scale)."""
        if beta is None:
            return DF.kl_error_densified(Vd, W, H, scale=scale)
        return DF.beta_divergence_densified(Vd, W, H, beta, scale=scale)

    make_aux, effective_h = (lambda V: ()), _identity_h
    if config.algorithm is not Algorithm.MU:
        make_aux, update, effective_h = _densified_family(config, int8)
    elif int8:
        if kl:
            def update(V, aux, W, H):
                return DF.mu_update_kl_densified(V[0], W, H, eps=eps,
                                                 order=order, scale=V[1])
        elif beta is not None:
            def update(V, aux, W, H):
                return DF.mu_update_beta_densified(V[0], W, H, beta, eps=eps,
                                                   order=order, scale=V[1])
        elif alpha > 0.0:
            def update(V, aux, W, H):
                return DF.mu_update_frobenius_weighted_densified(
                    V[0], W, H, alpha, eps=eps, order=order, scale=V[1])
        else:
            # the int8 x int8 numerators (#6's one-sided entries on the
            # card)
            def update(V, aux, W, H):
                return D.mu_update_frobenius_int8x8(V[0], V[1], W, H,
                                                    eps=eps, order=order)
    elif kl:
        def update(Vd, aux, W, H):
            return DF.mu_update_kl_densified(Vd, W, H, eps=eps, order=order)
    elif beta is not None:
        def update(Vd, aux, W, H):
            return DF.mu_update_beta_densified(Vd, W, H, beta, eps=eps,
                                               order=order)
    elif alpha > 0.0:
        def update(Vd, aux, W, H):
            return DF.mu_update_frobenius_weighted_densified(
                Vd, W, H, alpha, eps=eps, order=order)
    else:
        def update(Vd, aux, W, H):
            return D.mu_update_frobenius_bf16v(Vd, W, H, eps=eps,
                                               order=order)
    if int8:
        return LoopOps(
            make_aux=make_aux,
            update=update,
            effective_h=effective_h,
            frobenius=lambda V, aux, W, He, svsq: (
                DF.frobenius_error_int8_densified(V[0], V[1], W, He, svsq)),
            kl=lambda V, aux, W, He: divergence(V[0], W, He, scale=V[1]),
            sum_v_sq=lambda V: DF.sum_v_sq_int8_densified(V[0], V[1]),
            numel=numel,
        )
    return LoopOps(
        make_aux=make_aux,
        update=update,
        effective_h=effective_h,
        frobenius=lambda Vd, aux, W, He, svsq: DF.frobenius_error_densified(
            Vd, W, He, svsq),
        kl=lambda Vd, aux, W, He: divergence(Vd, W, He),
        # from the bf16-rounded V, consistent with the bf16 cross term of
        # the Gram-trick error
        sum_v_sq=DF.sum_v_sq_densified,
        numel=numel,
    )


def _ell_ops_bundle(config: NmfConfig) -> LoopOps:
    from nmftpu_torch import sparse_ell as SE

    eps = config.eps
    order = config.update_order
    alg = config.algorithm
    solves = dict(lambda_w=config.lambda_w, lambda_h=config.lambda_h,
                  solver=config.als_solver, cg_steps=config.cg_steps)
    if config.mask == "observed":
        if alg is Algorithm.ALS:
            def upd(pair, W, H, eps, order):
                return SE.als_update_masked_ell(pair, W, H, eps=eps,
                                                order=order, **solves)
        elif config.objective is Objective.FROBENIUS:
            upd = SE.mu_update_frobenius_masked_ell
        else:
            upd = SE.mu_update_kl_masked_ell
        return _masked_ops(
            lambda pair: (),
            lambda pair, aux, W, H: upd(pair, W, H, eps=eps, order=order),
            SE.frobenius_error_masked_ell, SE.kl_error_masked_ell,
            lambda pair: pair.rows.nnz)
    from nmftpu_torch.kernels import sparse_ell_kernel as SEK

    wt_v = SE.wt_v_ell
    if config.use_pallas:
        # the error check's Wᵀ V on the kernel too (nmftpu leaves it to
        # XLA's gather): at ML-20M scale the plain one costs ten kernel
        # iterations
        wt_v = SEK.wt_v_ell_pallas
    beta = config.beta if config.objective is Objective.BETA else None
    make_aux, effective_h = (lambda pair: ()), _identity_h
    if alg is Algorithm.ALS and config.alpha_confidence > 0.0:
        alpha = config.alpha_confidence

        # the cg solver's products on #11's CG rule and #10 (their plain
        # twins on CPU tensors)
        def update(pair, aux, W, H):
            return SE.als_update_weighted_ell_exact(
                pair, W, H, alpha, eps=eps, order=order,
                product=SEK.ell_cg, spmm=SEK.v_ht_ell_pallas, **solves)
    elif alg in (Algorithm.ALS, Algorithm.ACLS, Algorithm.AHCLS):
        shifts = dict(zip(("shift_w", "shift_h", "off_w", "off_h"),
                          _als_family_shifts(config)))

        def update(pair, aux, W, H):
            return SE.als_family_update_ell(pair, W, H, **shifts, eps=eps,
                                            order=order)
    elif alg is Algorithm.GDCLS:
        lt = config.lambda_tik

        def update(pair, aux, W, H):
            return SE.gdcls_update_ell(pair, W, H, lambda_tik=lt, eps=eps,
                                       order=order)
    elif alg is Algorithm.NSNMF:
        fn = (SE.nsnmf_update_kl_ell if config.objective is Objective.KL
              else SE.nsnmf_update_ell)
        make_aux, effective_h = _smoothing_aux(config), _smoothed_h

        def update(pair, aux, W, H):
            return fn(pair, W, H, aux[0], eps=eps, order=order)
    elif alg is not Algorithm.MU:
        raise ValueError(f"algorithm {alg.value!r} does not run on the ELL "
                         "engine")
    elif config.objective is Objective.KL:
        # both numerators on the CUDA kernel #11 with or without use_pallas
        # (nmftpu has no KL kernel for the flag to choose); on CPU tensors
        # its twin, SE.mu_update_kl_ell's own arithmetic
        def update(pair, aux, W, H):
            return SE.mu_update_kl_ell(pair, W, H, eps=eps, order=order,
                                       numerator=SEK.ell_kl)
    elif beta is not None:
        # the fused gather-once numerator, the dense denominator in
        # panels (config validation keeps use_pallas off under beta)
        def update(pair, aux, W, H):
            return SE.mu_update_beta_ell(pair, W, H, beta, eps=eps,
                                         order=order)
    elif config.alpha_confidence > 0.0:
        # one gather per half-step, with or without use_pallas (as in
        # nmftpu)
        alpha = config.alpha_confidence

        def update(pair, aux, W, H):
            return SE.mu_update_frobenius_weighted_ell(pair, W, H, alpha,
                                                       eps=eps, order=order)
    elif config.use_pallas:
        # both SpMM directions on the hand-written CUDA kernel
        def update(pair, aux, W, H):
            return SEK.mu_update_frobenius_ell_pallas(pair, W, H, eps=eps,
                                                      order=order)
    else:
        def update(pair, aux, W, H):
            return SE.mu_update_frobenius_ell(pair, W, H, eps=eps,
                                              order=order)

    def divergence(pair, aux, W, He):
        if beta is None:
            return SE.kl_error_ell(pair, W, He)
        return SE.beta_divergence_ell(pair, W, He, beta)

    return LoopOps(
        make_aux=make_aux,
        update=update,
        effective_h=effective_h,
        frobenius=lambda pair, aux, W, He, svsq: SE.frobenius_error_ell(
            pair, W, He, svsq, wt_v=wt_v),
        kl=divergence,
        sum_v_sq=lambda pair: SE.sum_v_sq_ell(pair.rows),
        numel=lambda pair: pair.shape[0] * pair.shape[1],
    )


def _default_weighted_gram_budget(device=None) -> int:
    """The per-row Grams' budget where NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES
    is unset: half of a CUDA device's total memory (the share 8 GiB was
    of the 16 GB TPU ``nmftpu`` set it for), else 8 GiB, as ``nmftpu``."""
    if device is not None and torch.device(device).type == "cuda":
        props = torch.cuda.get_device_properties(torch.device(device))
        return props.total_memory // 2
    return 8 * 1024**3


def _check_weighted_gram_budget(n: int, m: int, rank: int,
                                device=None) -> None:
    """iALS and masked ALS hold (n, r, r) + (m, r, r) float32 Grams:
    refuse clearly beyond NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES (read at
    call time; by default `_default_weighted_gram_budget(device)`)
    instead of failing for device memory."""
    env = os.environ.get("NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES")
    budget = (int(env) if env is not None
              else _default_weighted_gram_budget(device))
    need = (n + m) * rank * rank * 4
    if need > budget:
        raise ValueError(
            f"weighted ALS per-row Grams need ~{need / 2**30:.1f} "
            f"GiB ((n+m)\u00b7r\u00b2 f32) \u2014 over the "
            f"{budget / 2**30:.1f} GiB budget "
            "(NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES). Lower the rank "
            "or use the weighted MU algorithm."
        )


def _check_engine(config: NmfConfig, strategy: str, n: int, m: int,
                  device=None) -> None:
    """The engines an algorithm runs on, as ``prepare_sparse`` in
    ``nmftpu`` checks them: iALS and masked ALS on `ell` or `scatter`
    (within the Gram budget of `device` wherever per-row Grams are built:
    iALS with the cg solver on `ell` builds none), HALS on `scatter`. A
    plan checks each config it runs too, where ``nmftpu`` would run a
    HALS config on another engine's MU or nsNMF update."""
    if (config.algorithm is Algorithm.ALS
            and (config.alpha_confidence > 0.0
                 or config.mask == "observed")):
        if strategy not in ("scatter", "ell"):
            raise ValueError(
                "weighted ALS (iALS) and masked ALS run on the 'ell' "
                "(batched-GEMM Gram deltas, the fast path) or 'scatter' "
                f"(f64-exact oracle) engines; strategy resolved to "
                f"{strategy!r}"
            )
        matrix_free = (strategy == "ell" and config.mask != "observed"
                       and config.als_solver == "cg")
        if not matrix_free:
            _check_weighted_gram_budget(n, m, config.rank, device)
    if config.algorithm is Algorithm.HALS and strategy != "scatter":
        raise ValueError(
            "HALS runs on the 'scatter' sparse engine (exact "
            f"numerators); strategy resolved to {strategy!r}"
        )


def _densified_supported(config: NmfConfig) -> bool:
    return True  # every algorithm/objective combination in nmftpu


def _resolve_strategy(V, config: NmfConfig, strategy: str, n: int,
                      m: int) -> str:
    """``nmftpu``'s choice of engine, verbatim: `auto` picks densified
    when 2·n·m bytes (1·n·m for int8) fit DENSIFY_BUDGET_BYTES, ell
    beyond it, scatter for float64 (the only engine that holds values
    and accumulates in float64) and for HALS."""
    if config.mask == "observed":
        if strategy == "densified":
            raise ValueError(
                "mask='observed' cannot run the densified engine: "
                "densifying materializes the unobserved entries as "
                "zero-valued DATA, which is exactly what the completion "
                "objective must not do; use 'ell' (MU) or 'scatter'"
            )
        if strategy == "auto":
            if config.dtype == "float64":
                strategy = "scatter"
            else:
                strategy = "ell"
    if strategy == "auto":
        if config.objective is Objective.BETA:
            if config.dtype == "float64":
                return "scatter"
            v_bytes_b = 1 if config.v_storage == "int8" else 2
            if v_bytes_b * n * m <= DENSIFY_BUDGET_BYTES:
                return "densified"
            return "ell"
        if (config.algorithm is Algorithm.ALS
                and config.alpha_confidence > 0.0):
            return "scatter" if config.dtype == "float64" else "ell"
        if config.algorithm is Algorithm.HALS:
            return "scatter"
        if config.dtype == "float64":
            return "scatter"
        v_bytes = 1 if config.v_storage == "int8" else 2
        if (
            _densified_supported(config)
            and v_bytes * n * m <= DENSIFY_BUDGET_BYTES
        ):
            return "densified"
        if not isinstance(V, DeviceCOO):
            return "ell"
        return "scatter"
    return strategy


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


class SparsePlan:
    """Device-resident sparse operand reusable across runs.

    `prepare_sparse` pays the one-time layout cost once (ELL bucket build,
    densify scatter: seconds at ML-20M scale); `.run()` executes the
    factorization loop on it, with any config of the same dtype (and, on
    the densified engine, the same V storage)."""

    def __init__(self, *, coo, operand, strategy, dtype, config, n_pad):
        self.coo = coo
        self.operand = operand
        self.strategy = strategy
        self.dtype = dtype
        self.config = config
        self.n_pad = n_pad
        self.shape = coo.shape

    def _bundle(self, config: NmfConfig) -> LoopOps:
        if self.strategy == "ell":
            return _ell_ops_bundle(config)
        if self.strategy == "densified":
            return _densified_ops_bundle(config, self.coo)
        return _sparse_ops_bundle(config)

    def run(
        self,
        config: NmfConfig | None = None,
        W0=None,
        H0=None,
        callback: Callable[[Any, Any, Any, Any], None] | None = None,
        interrupt: Callable[[], bool] | None = None,
    ) -> NmfResult:
        """Execute the factorization loop on the prepared layout."""
        if config is None:
            config = self.config
        n, m = self.shape
        if config.rank > min(n, m):
            raise ValueError(
                f"rank {config.rank} exceeds min(V.shape) = {min(n, m)}"
            )
        if resolve_dtype(config.dtype) != self.dtype:
            raise ValueError(
                f"config.dtype {config.dtype} differs from the plan's "
                f"layout dtype {self.dtype}; re-run prepare_sparse"
            )
        if self.strategy == "densified" and config.mask == "observed":
            # nmftpu runs such a config unmasked on the densified plan and
            # reports its RMSD over the observed count
            raise ValueError(
                "mask='observed' cannot run on a densified plan: the "
                "unobserved entries are zero-valued data there; re-run "
                "prepare_sparse with strategy='ell' or 'scatter'"
            )
        if self.strategy == "densified" and (
                (config.v_storage == "int8")
                != (self.config.v_storage == "int8")):
            raise ValueError(
                "config.v_storage changes the densified layout "
                f"({self.config.v_storage!r} at prepare time vs "
                f"{config.v_storage!r}); re-run prepare_sparse"
            )
        _check_engine(config, self.strategy, n, m,
                      self.coo.values.device)
        if self.strategy in ("ell", "scatter") \
                and config.v_storage != "float32":
            raise ValueError(
                f"v_storage={config.v_storage!r} is only honored by the "
                f"'densified' sparse engine; this plan's strategy is "
                f"{self.strategy!r}"
            )
        runner = build_runner(config, self._bundle(config), callback,
                              interrupt)
        coo, n_pad = self.coo, self.n_pad
        device = coo.values.device

        def init_fn(run_idx):
            W, H = sparse_initialize_factors(
                coo, config.rank, config.init_method,
                run_generator(config.seed, run_idx, device), W0=W0, H0=H0,
                kmeans_max_iter=config.kmeans_max_iter,
            )
            if n_pad != n:  # zero rows are absorbing under every rule
                W = torch.nn.functional.pad(W, (0, 0, 0, n_pad - n))
            return W, H

        # masked runs report every metric over the observed set
        result = execute(self.operand, config, runner, init_fn,
                         numel=(coo.nnz if config.mask == "observed"
                                else n * m))
        if n_pad != n:
            result.W = result.W[:n]
        return result


def prepare_sparse(
    V: host_sparse.SparseMatrix | DeviceCOO,
    config: NmfConfig,
    strategy: str = "auto",
    device=None,
) -> SparsePlan:
    """Build the device layout for sparse V once, returning a reusable
    :class:`SparsePlan`. device: where the layout lives and the run
    happens (a DeviceCOO moves there); by default a DeviceCOO's own
    device, else "cuda" (raises without one)."""
    if config.mu_style == "jacobi":
        raise ValueError(
            "mu_style='jacobi' is wired through the dense engine only; "
            "sparse engines run gauss-seidel half-steps"
        )
    dtype = resolve_dtype(config.dtype)
    if isinstance(V, DeviceCOO):
        if V.values.dtype != dtype:
            raise ValueError(
                f"DeviceCOO values are {V.values.dtype} but config.dtype "
                f"is {config.dtype}; re-upload with device_put_sparse("
                "..., dtype=...) or match the config"
            )
        coo = V if device is None else dataclasses.replace(
            V, values=V.values.to(device), rows=V.rows.to(device),
            cols=V.cols.to(device))
    else:
        coo = device_put_sparse(V, dtype=dtype, device=device)
    n, m = coo.shape
    if config.rank > min(n, m):
        raise ValueError(
            f"rank {config.rank} exceeds min(V.shape) = {min(n, m)}"
        )
    strategy = _resolve_strategy(V, config, strategy, n, m)
    if strategy not in ("ell", "densified", "scatter"):
        raise ValueError(
            f"strategy must be 'auto', 'ell', 'densified' or 'scatter', "
            f"got {strategy!r}"
        )
    _check_engine(config, strategy, n, m, coo.values.device)
    if strategy in ("ell", "scatter") and config.v_storage != "float32":
        raise ValueError(
            f"v_storage={config.v_storage!r} is only honored by the "
            f"'densified' sparse engine (and the dense path); the "
            f"resolved strategy is {strategy!r}, which would run "
            "full-precision. Pass strategy='densified' (raise "
            "NMFTPU_DENSIFY_BUDGET_BYTES if the matrix exceeds the "
            "densify budget) or v_storage='float32'."
        )

    n_pad = n
    if strategy == "ell":
        if isinstance(V, DeviceCOO):
            raise ValueError("ell strategy needs a host sparse container")
        from nmftpu_torch import sparse_ell as SE

        operand = SE.build_ell_pair(V, dtype=dtype,
                                    device=coo.values.device)
    elif strategy == "densified":
        from nmftpu_torch import densified as DF

        # rows padded to the panel size of the blocked updates
        if config.v_storage == "int8":
            operand = DF.densify_quantized(coo, row_multiple=4096)
            n_pad = operand[0].shape[0]
        else:
            operand = DF.densify(coo, row_multiple=4096)
            n_pad = operand.shape[0]
    else:
        operand = coo

    return SparsePlan(coo=coo, operand=operand, strategy=strategy,
                      dtype=dtype, config=config, n_pad=n_pad)


def compute_sparse(
    V: host_sparse.SparseMatrix | DeviceCOO,
    config: NmfConfig,
    W0=None,
    H0=None,
    strategy: str = "auto",
    callback: Callable[[Any, Any, Any, Any], None] | None = None,
    interrupt: Callable[[], bool] | None = None,
    device=None,
) -> NmfResult:
    """Sparse twin of `driver.compute`: V stays sparse end to end.

    strategy:
      "scatter"   — chunked COO gather/scatter updates (any size);
      "densified" — scatter V once into dense bf16 (int8 under
                    v_storage="int8") and run dense updates (blockwise
                    for KL and weighting) whenever n·m·2 (n·m) bytes fit;
      "ell"       — gather-only bucketed padded-segment layout; with
                    use_pallas=True the MU-Frobenius SpMMs run the CUDA
                    ELL kernel, and MU-KL's numerators always run the
                    CUDA KL kernel (kernels/sparse_ell_kernel.py);
      "auto"      — as ``nmftpu``: densified within DENSIFY_BUDGET_BYTES,
                    else ell; ell for iALS and masked ALS, scatter for
                    HALS and for float64.

    Repeated factorizations of one matrix should call
    :func:`prepare_sparse` once and ``plan.run(...)`` per run: this
    function rebuilds the device layout on every call.
    """
    plan = prepare_sparse(V, config, strategy=strategy, device=device)
    return plan.run(W0=W0, H0=H0, callback=callback, interrupt=interrupt)
