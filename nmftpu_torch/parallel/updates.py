"""Update rules and error metrics of the 2-D grid engine (port of
``nmftpu/parallel/updates.py``).

Each rank runs the single-device chunked COO primitives
(``sparse_ops.wt_v / v_ht / sddmm``) on its own tile, and the only
traffic between ranks is

    psum over 'items': V Hᵀ partials (block_rows, r), H Hᵀ (r, r),
                       H row sums (r,)
    psum over 'users': Wᵀ V partials (r, block_cols), Wᵀ W (r, r),
                       W column sums (r,)

(the MPI-FAUN 2-D pattern, O((n/pu + m/pi) r) per iteration). W stays
replicated along 'items' and H along 'users': every rank of a group
applies the same update to the same summed operands, so the replicas
stay equal.

Padding rows and columns of W and H start at zero and stay there under
every rule (zero numerators, zero right-hand sides), so they never
reach an error. A sum gathers its operands in the group's order, so
float32 results differ from ``nmftpu``'s by summation order only.
"""

from __future__ import annotations

import torch

from nmftpu_torch.config import Algorithm, NmfConfig, Objective
from nmftpu_torch.linalg import dense as D
from nmftpu_torch.parallel.mesh import AXIS_ITEMS, AXIS_USERS, psum
from nmftpu_torch.sparse_ops import (
    _als_family_shifts,
    _beta_apply,
    _beta_numer_values,
    _panels,
    _row_solver,
    _weighted_row_grams,
    beta_denom_h_blocked,
    beta_denom_w_blocked,
    sddmm,
    v_ht,
    wt_v,
)

_BOTH = (AXIS_USERS, AXIS_ITEMS)


def _mu(F, numer, denom):
    """F ⊙ numer / denom, in place on the temporaries (numer is the
    result): W-sized arrays are the largest operands of a step."""
    numer /= denom
    del denom
    numer *= F
    return numer


# ---------------------------------------------------------------------------
# Half-steps: rank-local primitives on `local` (this rank's tile), sums
# over the mesh axes
# ---------------------------------------------------------------------------


def _upd_w_fro(g, local, W, H, eps):
    numer = psum(v_ht(local, H), g, AXIS_ITEMS)            # (br, r)
    denom = W @ psum(H @ H.T, g, AXIS_ITEMS)
    denom += eps
    return _mu(W, numer, denom)


def _upd_h_fro(g, local, W, H, eps):
    numer = psum(wt_v(local, W), g, AXIS_USERS)            # (r, bc)
    denom = psum(W.T @ W, g, AXIS_USERS) @ H
    denom += eps
    return _mu(H, numer, denom)


def _ratio(local, W, H, eps):
    return local.with_values(local.values / (sddmm(local, W, H) + eps))


def _upd_w_kl(g, local, W, H, eps):
    numer = psum(v_ht(_ratio(local, W, H, eps), H), g, AXIS_ITEMS)
    h_sum = psum(torch.sum(H, dim=1), g, AXIS_ITEMS)
    return W * (numer / torch.clamp(h_sum, min=eps)[None, :])


def _upd_h_kl(g, local, W, H, eps):
    numer = psum(wt_v(_ratio(local, W, H, eps), W), g, AXIS_USERS)
    w_sum = psum(torch.sum(W, dim=0), g, AXIS_USERS)
    return H * (numer / torch.clamp(w_sum, min=eps)[:, None])


def _upd_w_beta(g, local, W, H, beta, eps):
    """Beta MU's W half: the numerator is the summed SpMM of the
    SDDMM-powered values (nonzero only at the stored set); the dense
    denominator streams (W H_local)^(β-1) H_localᵀ panels on each rank,
    summed over 'items'. Guards, γ and the β < 1 stabilization are
    sklearn's (``linalg.dense.mu_update_beta`` is the oracle)."""
    numer = psum(v_ht(_beta_numer_values(local, W, H, beta), H), g,
                 AXIS_ITEMS)
    blk = max(1, min(2048, H.shape[1]))
    denom = psum(beta_denom_w_blocked(W, H, beta, blk), g, AXIS_ITEMS)
    return _beta_apply(W, numer, denom, beta, D.beta_gamma(beta))


def _upd_h_beta(g, local, W, H, beta, eps):
    numer = psum(wt_v(_beta_numer_values(local, W, H, beta), W), g,
                 AXIS_USERS)
    blk = max(1, min(2048, W.shape[0]))
    denom = psum(beta_denom_h_blocked(W, H, beta, blk), g, AXIS_USERS)
    return _beta_apply(H, numer, denom, beta, D.beta_gamma(beta))


def _observed_wh(local, W, H):
    """WH sampled on the stored set (tile padding holds v = 0, so it
    drops out of the mask)."""
    return local.with_values(
        torch.where(local.values != 0, sddmm(local, W, H), 0.0))


def _upd_w_fro_masked(g, local, W, H, eps):
    """Completion MU's W half: the Gram denominator becomes the summed
    SpMM of WH on the observed set, as the numerator is summed."""
    numer = psum(v_ht(local, H), g, AXIS_ITEMS)
    denom = psum(v_ht(_observed_wh(local, W, H), H), g, AXIS_ITEMS)
    return W * (numer / (denom + eps))


def _upd_h_fro_masked(g, local, W, H, eps):
    numer = psum(wt_v(local, W), g, AXIS_USERS)
    denom = psum(wt_v(_observed_wh(local, W, H), W), g, AXIS_USERS)
    return H * (numer / (denom + eps))


def _mask(local):
    return local.with_values((local.values != 0).to(local.values.dtype))


def _upd_w_kl_masked(g, local, W, H, eps):
    """Masked KL's W half: the observed row mass of H (the SpMM of the
    0/1 mask) replaces H's full row sums."""
    numer = psum(v_ht(_ratio(local, W, H, eps), H), g, AXIS_ITEMS)
    denom = psum(v_ht(_mask(local), H), g, AXIS_ITEMS)
    return W * (numer / (denom + eps))


def _upd_h_kl_masked(g, local, W, H, eps):
    numer = psum(wt_v(_ratio(local, W, H, eps), W), g, AXIS_USERS)
    denom = psum(wt_v(_mask(local), W), g, AXIS_USERS)
    return H * (numer / (denom + eps))


def _indicator(v):
    return v != 0


def _upd_w_als_masked(g, local, W, H, lam, eps, solve):
    """Completion ALS's W half: per-row observed-only Grams from the
    tile (a 0/1 weight, no shared base Gram), summed over 'items', then
    the batched per-row solves and the clamp. Rank memory: (block_rows,
    r, r) float32."""
    dG = psum(_weighted_row_grams(local, H.T, 0.0, W.shape[0],
                                  weight_fn=_indicator), g, AXIS_ITEMS)
    rhs = psum(v_ht(local, H), g, AXIS_ITEMS).to(torch.float32)
    return solve(None, dG, rhs, lam, eps, W.to(torch.float32)).to(W.dtype)


def _upd_h_als_masked(g, local, W, H, lam, eps, solve):
    dG = psum(_weighted_row_grams(local, W, 0.0, H.shape[1], by_cols=True,
                                  weight_fn=_indicator), g, AXIS_USERS)
    rhs = psum(wt_v(local, W), g, AXIS_USERS).T.to(torch.float32)
    out = solve(None, dG, rhs, lam, eps, H.T.to(torch.float32))
    return out.T.contiguous().to(H.dtype)


def _upd_w_weighted(g, local, W, H, alpha, eps):
    cv = local.with_values(local.values * (1.0 + alpha * local.values))
    swh = local.with_values(local.values * sddmm(local, W, H))
    numer = psum(v_ht(cv, H), g, AXIS_ITEMS)
    HHt = psum(H @ H.T, g, AXIS_ITEMS)
    alpha_part = psum(v_ht(swh, H), g, AXIS_ITEMS)
    return W * (numer / (W @ HHt + alpha * alpha_part + eps))


def _upd_h_weighted(g, local, W, H, alpha, eps):
    cv = local.with_values(local.values * (1.0 + alpha * local.values))
    swh = local.with_values(local.values * sddmm(local, W, H))
    numer = psum(wt_v(cv, W), g, AXIS_USERS)
    WtW = psum(W.T @ W, g, AXIS_USERS)
    alpha_part = psum(wt_v(swh, W), g, AXIS_USERS)
    return H * (numer / (WtW @ H + alpha * alpha_part + eps))


def _upd_w_hals(g, local, W, H, l2, l1, eps):
    """HALS's W sweep: the numerator and the Gram summed as ALS sums
    them, then the cyclic column sweep on this rank's rows alone (W's
    rows are disjoint across 'users'): the CUDA sweep kernel for float32
    on the card (``linalg.dense.hals_half_sweep``)."""
    eye = torch.eye(W.shape[1], dtype=W.dtype, device=W.device)
    XHt = psum(v_ht(local, H), g, AXIS_ITEMS) - l1
    G = psum(H @ H.T, g, AXIS_ITEMS) + l2 * eye
    return D.hals_half_sweep(XHt, G, W)


def _upd_h_hals(g, local, W, H, l2, l1, eps):
    eye = torch.eye(W.shape[1], dtype=W.dtype, device=W.device)
    XtW = psum(wt_v(local, W), g, AXIS_USERS).T - l1       # (bc, r)
    G = psum(W.T @ W, g, AXIS_USERS) + l2 * eye
    return D.hals_half_sweep(XtW, G, H.T).T.contiguous()


def _upd_w_als_weighted(g, local, W, H, alpha, lam, eps, solve):
    """iALS's W half: per-row weighted Grams from the tile's nonzeros,
    summed over 'items' so each W block sees its rows' whole Σ αv h hᵀ;
    the base Gram and the c ⊙ v right-hand sides summed as plain ALS's.
    The per-row solves follow config.als_solver (exact Cholesky, or CG
    warm-started at the incoming block). Rank memory: (block_rows, r, r)
    float32."""
    G = psum((H @ H.T).to(torch.float32), g, AXIS_ITEMS)
    dG = psum(_weighted_row_grams(local, H.T, alpha, W.shape[0]), g,
              AXIS_ITEMS)
    cv = local.with_values(local.values * (1.0 + alpha * local.values))
    rhs = psum(v_ht(cv, H), g, AXIS_ITEMS).to(torch.float32)
    return solve(G, dG, rhs, lam, eps, W.to(torch.float32)).to(W.dtype)


def _upd_h_als_weighted(g, local, W, H, alpha, lam, eps, solve):
    G = psum((W.T @ W).to(torch.float32), g, AXIS_USERS)
    dG = psum(_weighted_row_grams(local, W, alpha, H.shape[1],
                                  by_cols=True), g, AXIS_USERS)
    cv = local.with_values(local.values * (1.0 + alpha * local.values))
    rhs = psum(wt_v(cv, W), g, AXIS_USERS).T.to(torch.float32)
    out = solve(G, dG, rhs, lam, eps, H.T.to(torch.float32))
    return out.T.contiguous().to(H.dtype)


def _upd_w_als(g, local, W, H, shift, off, eps):
    rhs = psum(v_ht(local, H), g, AXIS_ITEMS).T              # (r, br)
    gram = psum(H @ H.T, g, AXIS_ITEMS)
    return D.solve_clamped(gram, rhs, shift, off, eps).T.contiguous()


def _upd_h_als(g, local, W, H, shift, off, eps):
    rhs = psum(wt_v(local, W), g, AXIS_USERS)                # (r, bc)
    gram = psum(W.T @ W, g, AXIS_USERS)
    return D.solve_clamped(gram, rhs, shift, off, eps)


def _upd_w_nsnmf(g, local, W, H, S, eps, kl):
    SH = S @ H
    if kl:
        numer = psum(v_ht(_ratio(local, W, SH, eps), SH), g, AXIS_ITEMS)
        s_sum = psum(torch.sum(SH, dim=1), g, AXIS_ITEMS)
        return W * (numer / torch.clamp(s_sum, min=eps)[None, :])
    numer = psum(v_ht(local, SH), g, AXIS_ITEMS)
    G = psum(SH @ SH.T, g, AXIS_ITEMS)
    return W * (numer / (W @ G + eps))


def _upd_h_nsnmf(g, local, W, H, S, eps, kl):
    WS = W @ S
    if kl:
        numer = psum(wt_v(_ratio(local, WS, H, eps), WS), g, AXIS_USERS)
        s_sum = psum(torch.sum(WS, dim=0), g, AXIS_USERS)
        return H * (numer / torch.clamp(s_sum, min=eps)[:, None])
    numer = psum(wt_v(local, WS), g, AXIS_USERS)
    G = psum(WS.T @ WS, g, AXIS_USERS)
    return H * (numer / (G @ H + eps))


# ---------------------------------------------------------------------------
# Registry: (make_aux, update, effective_h) on the mesh
# ---------------------------------------------------------------------------


def half_steps(config: NmfConfig):
    """(upd_w, upd_h), each f(mesh, local, W, H, aux) -> factor block,
    for every algorithm the grid engine takes, and whether the run
    carries nsNMF's smoothing matrix as aux[0]."""
    eps = config.eps
    alg, obj = config.algorithm, config.objective
    lw, lh = config.lambda_w, config.lambda_h

    def pair(fw, fh, *args):
        return (lambda g, l, W, H, aux: fw(g, l, W, H, *args),
                lambda g, l, W, H, aux: fh(g, l, W, H, *args)), False

    if config.mask == "observed":
        # config validation has restricted this to MU (Frobenius, KL)
        # and ALS (Frobenius)
        if alg is Algorithm.MU:
            if obj is Objective.FROBENIUS:
                return pair(_upd_w_fro_masked, _upd_h_fro_masked, eps)
            return pair(_upd_w_kl_masked, _upd_h_kl_masked, eps)
        solve = _row_solver(config.als_solver, config.cg_steps)
        return (
            (lambda g, l, W, H, aux: _upd_w_als_masked(g, l, W, H, lw, eps,
                                                       solve),
             lambda g, l, W, H, aux: _upd_h_als_masked(g, l, W, H, lh, eps,
                                                       solve)), False)
    if alg is Algorithm.MU:
        if obj is Objective.FROBENIUS and config.alpha_confidence > 0.0:
            return pair(_upd_w_weighted, _upd_h_weighted,
                        config.alpha_confidence, eps)
        if obj is Objective.FROBENIUS:
            return pair(_upd_w_fro, _upd_h_fro, eps)
        if obj is Objective.BETA:
            return pair(_upd_w_beta, _upd_h_beta, config.beta, eps)
        return pair(_upd_w_kl, _upd_h_kl, eps)
    if alg is Algorithm.HALS:
        return (
            (lambda g, l, W, H, aux: _upd_w_hals(g, l, W, H, lw,
                                                 config.l1_w, eps),
             lambda g, l, W, H, aux: _upd_h_hals(g, l, W, H, lh,
                                                 config.l1_h, eps)), False)
    if alg is Algorithm.ALS and config.alpha_confidence > 0.0:
        a = config.alpha_confidence
        solve = _row_solver(config.als_solver, config.cg_steps)
        return (
            (lambda g, l, W, H, aux: _upd_w_als_weighted(g, l, W, H, a, lw,
                                                         eps, solve),
             lambda g, l, W, H, aux: _upd_h_als_weighted(g, l, W, H, a, lh,
                                                         eps, solve)), False)
    if alg in (Algorithm.ALS, Algorithm.ACLS, Algorithm.AHCLS):
        sw, sh, ow, oh = _als_family_shifts(config)
        return (
            (lambda g, l, W, H, aux: _upd_w_als(g, l, W, H, sw, ow, eps),
             lambda g, l, W, H, aux: _upd_h_als(g, l, W, H, sh, oh, eps)),
            False)
    if alg is Algorithm.GDCLS:
        lt = config.lambda_tik
        return (
            (lambda g, l, W, H, aux: _upd_w_fro(g, l, W, H, eps),
             lambda g, l, W, H, aux: _upd_h_als(g, l, W, H, lt, 0.0, eps)),
            False)
    if alg is Algorithm.NSNMF:
        kl = obj is not Objective.FROBENIUS
        return (
            (lambda g, l, W, H, aux: _upd_w_nsnmf(g, l, W, H, aux[0], eps,
                                                  kl),
             lambda g, l, W, H, aux: _upd_h_nsnmf(g, l, W, H, aux[0], eps,
                                                  kl)), True)
    raise ValueError(f"unknown algorithm: {alg}")


def ordered(config: NmfConfig, upd_w, upd_h):
    """One iteration: the two half-steps in config.update_order."""
    if config.update_order == "WH":
        def step(W, H, *a):
            W = upd_w(W, H, *a)
            return W, upd_h(W, H, *a)
    else:
        def step(W, H, *a):
            H = upd_h(W, H, *a)
            return upd_w(W, H, *a), H
    return step


def smoothing_aux(config: NmfConfig, dtype, device):
    """nsNMF's (S,), built in the tiles' dtype on this rank's device."""
    return (D.nsnmf_smoothing_matrix(config.rank, config.theta, dtype=dtype,
                                     device=device),)


def build_sharded_update(config: NmfConfig, mesh):
    """The sharded twin of ``sparse_ops.build_sparse_update``: returns
    (make_aux, update, effective_h) for the loop, update(scoo, aux, W, H)
    one iteration on this rank's blocks."""
    (upd_w, upd_h), smoothed = half_steps(config)
    step = ordered(
        config,
        lambda W, H, local, aux: upd_w(mesh, local, W, H, aux),
        lambda W, H, local, aux: upd_h(mesh, local, W, H, aux))

    def update(scoo, aux, W, H):
        return step(W, H, scoo.local(), aux)

    if smoothed:
        return ((lambda scoo: smoothing_aux(config, scoo.values.dtype,
                                            scoo.values.device)),
                update, (lambda aux, H: aux[0] @ H))
    return (lambda scoo: ()), update, (lambda aux, H: H)


# ---------------------------------------------------------------------------
# Error metrics (the same scalar on every rank)
# ---------------------------------------------------------------------------


def frobenius_grid(mesh, wt_v_local, W, H, svsq):
    """||V - WH||_F by the Gram/trace identity from this rank's Wᵀ V
    partial (r, block_cols): the partial summed over 'users', its trace
    with H over 'items', the Grams over their axes."""
    WtV = psum(wt_v_local, mesh, AXIS_USERS)
    cross = psum(torch.sum(WtV * H), mesh, AXIS_ITEMS)
    WtW = psum(W.T @ W, mesh, AXIS_USERS)
    HHt = psum(H @ H.T, mesh, AXIS_ITEMS)
    return torch.sqrt(torch.clamp(svsq - 2.0 * cross + torch.sum(WtW * HHt),
                                  min=0.0))


def kl_grid(mesh, local_sum, W, H):
    """D_KL from this rank's Σ_nz v log(v / wh) - Σ v, plus Σ WH as
    (column sums of W) · (row sums of H)."""
    total = psum(local_sum, mesh, _BOTH)
    w_col = psum(torch.sum(W, dim=0), mesh, AXIS_USERS)
    h_row = psum(torch.sum(H, dim=1), mesh, AXIS_ITEMS)
    return total + w_col @ h_row


def kl_terms(v, wh):
    """Σ v log(v / wh) - Σ v over stored values (v = 0 adds nothing)."""
    log_term = torch.where(
        v > 0,
        v * torch.log(torch.clamp(v, min=1e-12) / torch.clamp(wh, min=1e-12)),
        0.0)
    return torch.sum(log_term) - torch.sum(v)


def build_sharded_errors(mesh, masked=False):
    """(frobenius(scoo, W, He, svsq), kl(scoo, W, He)), each the same
    scalar on every rank. With masked=True both run over the OBSERVED set
    only (completion semantics; tile padding holds v = 0, which the mask
    drops)."""
    if masked:
        def frobenius(scoo, W, H, svsq):
            local = scoo.local()
            v = local.values
            resid = torch.where(v != 0, v - sddmm(local, W, H), 0.0)
            return torch.sqrt(psum(torch.sum(resid * resid), mesh, _BOTH))

        def kl(scoo, W, H):
            local = scoo.local()
            v = local.values
            wh = torch.clamp(sddmm(local, W, H), min=1e-12)
            term = v * torch.log(torch.clamp(v, min=1e-12) / wh) - v + wh
            return psum(torch.sum(torch.where(v != 0, term, 0.0)), mesh,
                        _BOTH)

        return frobenius, kl

    def frobenius(scoo, W, H, svsq):
        return frobenius_grid(mesh, wt_v(scoo.local(), W), W, H, svsq)

    def kl(scoo, W, H):
        local = scoo.local()
        return kl_grid(mesh, kl_terms(local.values, sddmm(local, W, H)), W, H)

    return frobenius, kl


def sum_wh_beta_tile(mesh, W, H, beta, n, m):
    """Σ (W H_local)^β over the VALID part of this rank's tile, streamed
    through (block_rows, 2048) panels. Padding rows and columns are
    masked explicitly (a padded zero is +inf at β < 0; a real zero of WH
    gives inf as sklearn's does). Shared by the scatter and ELL beta
    errors."""
    br, bc = W.shape[0], H.shape[1]
    i, j = mesh.get_local_rank(AXIS_USERS), mesh.get_local_rank(AXIS_ITEMS)
    rows = (i * br + torch.arange(br, device=W.device)) < n
    acc = torch.zeros((), dtype=torch.float32, device=W.device)
    for s, e in _panels(bc, max(1, min(2048, bc))):
        WH = (W @ H[:, s:e]).to(torch.float32)
        cols = (j * bc + s + torch.arange(e - s, device=W.device)) < m
        valid = rows[:, None] & cols[None, :]
        acc += torch.sum(torch.where(valid, WH ** beta, 0.0))
    return acc


def beta_grid(mesh, v, wh, W, H, beta, shape):
    """D_β over the grid from this rank's stored values `v` and their
    sampled WH (sklearn's sparse-X semantics, the twin of
    ``sparse_ops.beta_divergence_sparse``): stored-set terms from the
    tile, the zero-position term Σ (WH)^β from `sum_wh_beta_tile`."""
    n, m = shape
    keep = v > D.EPSILON
    wh_c = torch.clamp(wh, min=D.EPSILON)
    if beta == 0.0:
        div = (v / wh_c).to(torch.float32)
        local = (torch.sum(torch.where(keep, div, 0.0))
                 - torch.sum(torch.where(
                     keep, torch.log(torch.where(keep, div, 1.0)), 0.0)))
        return psum(local, mesh, _BOTH) - float(n) * float(m)
    local = (torch.sum(torch.where(keep, (v ** beta).to(torch.float32), 0.0))
             - beta * torch.sum(torch.where(
                 keep, (v * wh_c ** (beta - 1.0)).to(torch.float32), 0.0))
             + (beta - 1.0) * sum_wh_beta_tile(mesh, W, H, beta, n, m))
    return psum(local, mesh, _BOTH) / (beta * (beta - 1.0))


def build_sharded_beta_error(mesh, beta: float):
    """D_β(V || WH) on the grid, the same scalar on every rank."""
    def err(scoo, W, H):
        local = scoo.local()
        return beta_grid(mesh, local.values, sddmm(local, W, H), W, H, beta,
                         scoo.shape)

    return err
