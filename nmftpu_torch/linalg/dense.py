"""Dense update rules, solvers and error metrics, plain torch (port of
``nmftpu/linalg/dense.py`` but for iALS, ``als_update_weighted``): MU
(Frobenius, KL and the generalized beta divergence; Gauss–Seidel and
Jacobi; float32 / bf16 / int8 V; confidence-weighted Frobenius), HALS,
the ALS family (ALS, ACLS, AHCLS), GDCLS and nsNMF on float32 and int8 V,
the least-squares solvers with the one route of the per-row solves
(`row_solver`), and the dense-factor pieces every sparse engine shares.

Conventions
-----------
V : (n, m)  nonnegative data ("users" x "items")
W : (n, r)  left factor  (user embeddings)
H : (r, m)  right factor (item embeddings)

Every update returns new tensors. The large products are ``torch.matmul``
(on the card: cuBLAS, full float32 while TF32 is off), as ``nmftpu``
leaves them to XLA. The epsilon guard is added to the denominators.
Hand-written CUDA kernels run for CUDA tensors in two places: the int8 x
int8 products (``kernels.dual_numer``: the MU numerators and the int8
family's right-hand sides) and the HALS half-sweep
(``kernels.hals_sweep``); on CPU tensors those wrappers run their plain
torch twins.

Every update takes `sums` (a `Sums`; `LOCAL` by default): the routes
call it on each contraction over V's columns (the W side) or rows (the H
side). On one device those are whole and it adds nothing; a rank that
holds one tile of V (``parallel.dense_mesh``) sums them over the ranks.
"""

from __future__ import annotations

import math

import torch

from nmftpu_torch.config import Algorithm, NmfConfig


class Sums:
    """The sums of a route's partial contractions. One device holds the
    whole V, so every contraction is already whole and each method
    returns its argument. A mesh that tiles V (``parallel.dense_mesh.
    MeshSums``) overrides them: `cols` sums a W-side partial (over its
    tile's columns) across the ranks that share its rows, `rows` an
    H-side partial across those that share its columns, `both` over all
    ranks; maximum=True takes the max (the int8 scales of the whole
    matrix). `local_w` / `local_h` say whether a half-step reads only
    this rank's tile, so that a fused kernel may run it whole."""

    local_w = True
    local_h = True

    def cols(self, x, maximum=False):
        return x

    def rows(self, x, maximum=False):
        return x

    def both(self, x, maximum=False):
        return x


LOCAL = Sums()


def _panels(n: int, block: int):
    """(start, stop) of the panels of `block` rows (or columns) over n,
    the last one possibly narrower: no panel has a pad row."""
    return ((s, min(s + block, n)) for s in range(0, n, block))


def _acc_dtype(dtype):
    """Sums run at >= float32: thousands of contributions per row or
    column would vanish below a bf16 running sum's ulp. float64 stays
    float64."""
    return torch.promote_types(dtype, torch.float32)


def mu_update_w_frobenius(V, W, H, eps, sums=LOCAL):
    """W <- W * (V H^T) / (W (H H^T) + eps).   One Lee–Seung half-step.
    Stacked factors (S, n, r) / (S, r, m) with V (n, m) or (S, n, m) run
    as batched GEMMs (the lockstep runner's `stacked_update`)."""
    numer = sums.cols(V @ H.mT)          # (n, r)   O(nmr)
    HHt = sums.cols(H @ H.mT)            # (r, r)   O(mr^2)
    denom = W @ HHt + eps                # (n, r)   O(nr^2)
    return W * (numer / denom)


def mu_update_h_frobenius(V, W, H, eps, sums=LOCAL):
    """H <- H * (W^T V) / ((W^T W) H + eps); stacked as the W step."""
    numer = sums.rows(W.mT @ V)          # (r, m)
    WtW = sums.rows(W.mT @ W)            # (r, r)
    denom = WtW @ H + eps                # (r, m)
    return H * (numer / denom)


def _apply_order(upd_w, upd_h, W, H, order):
    """Sequence the two MU half-steps: "WH" is Gauss–Seidel with W first
    (the second half-step sees the first's fresh factor); "HW" the
    classic Lee–Seung presentation. The "jacobi" coupling does not route
    here: each update that offers it has its own scale-corrected branch
    (`_jacobi_fro_apply`, `mu_update_kl`)."""
    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    elif order == "HW":
        H = upd_h(W, H)
        W = upd_w(W, H)
    else:
        raise NotImplementedError(
            f"update order {order!r} is not ported; 'WH' and 'HW' are"
        )
    return W, H


def _jacobi_fro_apply(W, H, numer_w, numer_h, G_w, G_h, eps, sums=LOCAL):
    """Scale-corrected simultaneous (Jacobi) Frobenius MU step.

    The raw simultaneous step W ⊙ rw, H ⊙ rh squares the correction of
    the global scale of WH that each half-step makes on its own, and
    two-cycles on a scale-mismatched iterate. Both ratios are divided by
    √s, where s = ⟨V, WH⟩/‖WH‖² = ⟨numer_w, W⟩/⟨WᵀW, HHᵀ⟩ is the optimal
    global scale, read from the update's own pieces. At a stationary pair
    s = 1, so the fixed points are those of Gauss–Seidel. The pieces come
    summed; only ⟨numer_w, W⟩ is summed here, over W's rows."""
    s_num = sums.rows(torch.sum(numer_w * W))
    s_den = torch.clamp(torch.sum(G_w * G_h), min=eps)
    inv_a = torch.rsqrt(torch.clamp(s_num / s_den, min=eps))
    W_new = W * (numer_w / (W @ G_h + eps)) * inv_a
    H_new = H * (numer_h / (G_w @ H + eps)) * inv_a
    return W_new, H_new


def mu_update_frobenius(V, W, H, eps=1e-9, order="WH", sums=LOCAL):
    """One full MU iteration under the Frobenius objective. order="WH"
    updates W first, "HW" H first; "jacobi" updates both from the
    incoming factors with the scale correction of `_jacobi_fro_apply`."""
    if order == "jacobi":
        return _jacobi_fro_apply(
            W, H, sums.cols(V @ H.T), sums.rows(W.T @ V),
            sums.rows(W.T @ W), sums.cols(H @ H.T), eps, sums,
        )
    return _apply_order(
        lambda W, H: mu_update_w_frobenius(V, W, H, eps, sums),
        lambda W, H: mu_update_h_frobenius(V, W, H, eps, sums),
        W, H, order,
    )


def mu_update_w_kl(V, W, H, eps, sums=LOCAL):
    """KL half-step: W <- W * ((V / (WH)) H^T) / (row-broadcast sum_j H);
    stacked factors as `mu_update_w_frobenius`."""
    ratio = V / (W @ H + eps)            # (n, m)
    numer = sums.cols(ratio @ H.mT)      # (n, r)
    denom = torch.clamp(sums.cols(torch.sum(H, dim=-1)),
                        min=eps).unsqueeze(-2)
    return W * (numer / denom)


def mu_update_h_kl(V, W, H, eps, sums=LOCAL):
    """KL half-step: H <- H * (W^T (V / (WH))) / (col-broadcast sum_i W);
    stacked factors as `mu_update_w_frobenius`."""
    ratio = V / (W @ H + eps)
    numer = sums.rows(W.mT @ ratio)      # (r, m)
    denom = torch.clamp(sums.rows(torch.sum(W, dim=-2)),
                        min=eps).unsqueeze(-1)
    return H * (numer / denom)


def _jacobi_kl_scale(sum_v, w_sum, h_sum, eps):
    """1/√a for the simultaneous KL step: a = ΣV / ΣWH is the closed-form
    argmin of KL(V ‖ a·WH), with ΣWH = ⟨colsum W, rowsum H⟩; a = 1 at any
    KL stationary point."""
    s = sum_v / torch.clamp(torch.dot(w_sum, h_sum), min=eps)
    return torch.rsqrt(torch.clamp(s, min=eps))


def mu_update_kl(V, W, H, eps=1e-9, order="WH", sums=LOCAL):
    """One full MU iteration under the KL (generalized I-divergence)
    objective. order="jacobi" computes both half-steps from one shared
    WH/ratio pass, both ratios divided by √a (`_jacobi_kl_scale`)."""
    if order == "jacobi":
        ratio = V / (W @ H + eps)
        numer_w = sums.cols(ratio @ H.T)
        numer_h = sums.rows(W.T @ ratio)
        h_sum = torch.clamp(sums.cols(torch.sum(H, dim=1)), min=eps)
        w_sum = torch.clamp(sums.rows(torch.sum(W, dim=0)), min=eps)
        inv_a = _jacobi_kl_scale(sums.both(torch.sum(V)), w_sum, h_sum, eps)
        return (W * (numer_w / h_sum[None, :]) * inv_a,
                H * (numer_h / w_sum[:, None]) * inv_a)
    return _apply_order(
        lambda W, H: mu_update_w_kl(V, W, H, eps, sums),
        lambda W, H: mu_update_h_kl(V, W, H, eps, sums),
        W, H, order,
    )


# ---------------------------------------------------------------------------
# Generalized beta divergence (sklearn's solver='mu' with a float beta_loss)
# ---------------------------------------------------------------------------


def beta_gamma(beta: float) -> float:
    """sklearn's MU exponent for the generalized beta divergence (Févotte
    & Idier 2011): the raw multiplicative ratio is raised to gamma to
    keep the update a descent step outside beta in [1, 2]."""
    if beta < 1.0:
        return 1.0 / (2.0 - beta)
    if beta > 2.0:
        return 1.0 / (beta - 1.0)
    return 1.0


# sklearn zeroes factor entries below float64 machine eps after each
# beta < 1 half-step ("necessary for stability"); the same constant, so
# that the parity tests agree on the support pattern
_STAB_EPS = 2.220446049250313e-16
# sklearn's EPSILON = np.finfo(np.float32).eps: every beta-MU guard clamps
# entries below it up to it (not just exact zeros), whatever the dtype
EPSILON = 1.1920929e-07


def _beta_powers(WH, beta):
    """sklearn's guarded power pair for one beta-MU half-step: WH^(beta-2)
    for the numerator and WH^(beta-1) for the denominator. Two separate
    guards, as in _multiplicative_update_w/_h: the numerator's clamps
    WH < EPSILON when beta < 2, the denominator's only when beta < 1."""
    WH_n = torch.clamp(WH, min=EPSILON) if beta < 2.0 else WH
    if beta == 1.0:
        pwr_n = 1.0 / WH_n
    elif beta == 0.0:
        pwr_n = 1.0 / (WH_n * WH_n)
    else:
        pwr_n = WH_n ** (beta - 2.0)
    WH_d = torch.clamp(WH, min=EPSILON) if beta < 1.0 else WH
    return pwr_n, WH_d ** (beta - 1.0)


def _beta_ratio(numer, denom, l1, l2, X, gamma):
    """(numer / denom)^gamma with sklearn's regularization on the
    denominator and its zero-denominator replacement."""
    if l1 > 0.0:
        denom = denom + l1
    if l2 > 0.0:
        denom = denom + l2 * X
    d = numer / torch.where(denom == 0.0, EPSILON, denom)
    return d ** gamma if gamma != 1.0 else d


def beta_w_step(V, W, H, beta, l1_w=0.0, l2_w=0.0, gamma=1.0,
                sums=LOCAL):
    """One multiplicative W update under the generalized beta divergence:
    sklearn's _multiplicative_update_w dense branch, guard for guard."""
    S = sums.cols
    if beta == 2.0:
        numer = S(V @ H.T)
        denom = W @ S(H @ H.T)
    else:
        pwr_n, pwr_d = _beta_powers(W @ H, beta)
        numer = S((pwr_n * V) @ H.T)
        if beta == 1.0:
            denom = S(torch.sum(H, dim=1))[None, :].expand_as(W)
        else:
            denom = S(pwr_d @ H.T)
    return W * _beta_ratio(numer, denom, l1_w, l2_w, W, gamma)


def beta_h_terms(V, W, H, beta, sums=LOCAL):
    """(numerator, denominator) of the beta-MU H update before
    regularization."""
    S = sums.rows
    if beta == 2.0:
        return S(W.T @ V), S(W.T @ W) @ H
    pwr_n, pwr_d = _beta_powers(W @ H, beta)
    numer = S(W.T @ (pwr_n * V))
    if beta == 1.0:
        W_sum = S(torch.sum(W, dim=0))
        W_sum = torch.where(W_sum == 0.0, 1.0, W_sum)
        return numer, W_sum[:, None].expand_as(H)
    return numer, S(W.T @ pwr_d)


def beta_h_step(V, W, H, beta, l1_h=0.0, l2_h=0.0, gamma=1.0, sums=LOCAL):
    """One multiplicative H update (sklearn's _multiplicative_update_h,
    dense branch, without the online accumulators)."""
    numer, denom = beta_h_terms(V, W, H, beta, sums)
    return H * _beta_ratio(numer, denom, l1_h, l2_h, H, gamma)


def mu_update_beta(V, W, H, beta, eps=1e-9, order="WH", sums=LOCAL):
    """One MU iteration under the generalized beta divergence:

        W <- W * ( ((WH)^(b-2) . V) H^T / ((WH)^(b-1) H^T) )^gamma

    and symmetrically for H; beta < 1 zeroes entries below float64's
    machine eps after each half-step. `eps` is accepted for the update
    signature and unused: the guards are sklearn's EPSILON clamps, so a
    float64 run matches sklearn's _multiplicative_update_w/_h to
    roundoff. One full (n, m) WH per half-step."""
    gamma = beta_gamma(beta)

    def stabilize(X):
        return torch.where(X < _STAB_EPS, 0.0, X) if beta < 1.0 else X

    return _apply_order(
        lambda W, H: stabilize(beta_w_step(V, W, H, beta, gamma=gamma,
                                           sums=sums)),
        lambda W, H: stabilize(beta_h_step(V, W, H, beta, gamma=gamma,
                                           sums=sums)),
        W, H, order,
    )


def _beta_pwr_d(WH, beta):
    """The denominator's power (WH)^(β-1) of one beta-MU half-step, with
    sklearn's guard: WH clamped up to EPSILON only when β < 1 (the
    numerator's separate guard is ``sparse_ops._beta_numer_values``)."""
    WH_d = torch.clamp(WH, min=EPSILON) if beta < 1.0 else WH
    return WH_d ** (beta - 1.0)


def beta_denom_w_blocked(W, H, beta, block=2048):
    """(WH)^(β-1) Hᵀ -> (n, r) over column panels of H. The beta-MU
    denominator is dense whatever V's sparsity (the power does not
    factor as β = 2's W (H Hᵀ) or β = 1's row sums do), but it needs
    only one (n, block) panel of WH at a time."""
    out = torch.zeros((W.shape[0], H.shape[0]), dtype=W.dtype,
                      device=W.device)
    for s, e in _panels(H.shape[1], block):
        Hb = H[:, s:e]
        out += _beta_pwr_d(W @ Hb, beta) @ Hb.T
    return out


def beta_denom_h_blocked(W, H, beta, block=2048):
    """Wᵀ (WH)^(β-1) -> (r, m) over row panels of W (the twin of
    `beta_denom_w_blocked`)."""
    out = torch.zeros((W.shape[1], H.shape[1]), dtype=H.dtype,
                      device=H.device)
    for s, e in _panels(W.shape[0], block):
        Wb = W[s:e]
        out += Wb.T @ _beta_pwr_d(Wb @ H, beta)
    return out


def beta_sum_wh_blocked(W, H, beta, block=2048):
    """Σ over ALL n·m entries of (WH)^β, over column panels: the one term
    of the sparse beta divergence that touches the zero positions. The
    last panel is narrower, so no pad column's 0^β (+inf for β < 0)
    enters; ``nmftpu`` pads and masks the same columns out."""
    acc_dt = _acc_dtype(W.dtype)
    total = torch.zeros((), dtype=acc_dt, device=W.device)
    for s, e in _panels(H.shape[1], block):
        total += torch.sum((W @ H[:, s:e]).to(acc_dt) ** beta)
    return total


def _beta_apply(F, numer, denom, beta, gamma):
    """F ⊙ (numer / denom)^γ with sklearn's zero-denominator replacement,
    then β < 1's stabilization (entries below float64's machine eps
    zeroed)."""
    d = numer / torch.where(denom == 0.0, EPSILON, denom)
    if gamma != 1.0:
        d = d ** gamma
    F = F * d
    return torch.where(F < _STAB_EPS, 0.0, F) if beta < 1.0 else F


def _bf16_dot(a, b, block_rows=4096):
    """a @ b with both operands rounded to bfloat16 and the products
    summed in float32 — the contract of ``dot_general(bf16, bf16,
    preferred_element_type=f32)``: a product of two bf16 values is exact
    in float32, so upcasting the rounded operands gives the same sums.

    The larger operand is upcast one panel of `block_rows` rows at a
    time (rows of `a` if it is the larger, else rows of `b`, the
    contraction dimension), so a V-sized operand never gets a float32
    copy (nor, when it is int8, a bf16 one: int8 values are exact in
    bf16); the panels change only the float32 summation order."""

    def up(x):
        return x.to(torch.bfloat16).float()

    if a.numel() >= b.numel():
        bf = up(b)
        out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32,
                          device=a.device)
        for s in range(0, a.shape[0], block_rows):
            out[s:s + block_rows] = up(a[s:s + block_rows]) @ bf
        return out
    af = up(a)
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for s in range(0, b.shape[0], block_rows):
        out += af[:, s:s + block_rows] @ up(b[s:s + block_rows])
    return out


def mu_update_frobenius_bf16v(Vb, W, H, eps=1e-9, order="WH", sums=LOCAL):
    """MU (Frobenius) against a bfloat16-stored V: the two O(nmr)
    numerators contract bf16 operands into float32; everything else stays
    in W/H's dtype. Plain torch, no kernel."""

    def vht(H):
        return sums.cols(_bf16_dot(Vb, H.T)).to(H.dtype)    # V H^T (n, r)

    def wtv(W):
        return sums.rows(_bf16_dot(W.T, Vb)).to(W.dtype)    # W^T V (r, m)

    def upd_w(W, H):
        return W * (vht(H) / (W @ sums.cols(H @ H.T) + eps))

    def upd_h(W, H):
        return H * (wtv(W) / (sums.rows(W.T @ W) @ H + eps))

    if order == "jacobi":
        return _jacobi_fro_apply(
            W, H, vht(H), wtv(W), sums.rows(W.T @ W), sums.cols(H @ H.T),
            eps, sums,
        )
    return _apply_order(upd_w, upd_h, W, H, order)


# ---------------------------------------------------------------------------
# int8 x int8 MU: V stored int8 once, the factor operand of each big
# contraction requantized per call, int32 sums, both scales after
# ---------------------------------------------------------------------------


def quantize_sym(X, clip=127.0, amax=None):
    """Symmetric per-matrix int8 quantization: X ~= scale * Xq. Returns
    (scale float32 0-dim, Xq int8). Bit-equal to ``nmftpu``'s: the scale
    is computed in X's type, and ``torch.round`` rounds half to even like
    ``jnp.round``. `amax`, if given, stands for max|X| (a sharded factor
    passes the whole matrix's, so every block takes one scale)."""
    if amax is None:
        amax = X.abs().amax()
    scale = torch.clamp(amax / clip, min=1e-30)
    Xq = torch.clamp(torch.round(X / scale), -clip, clip).to(torch.int8)
    return scale.to(torch.float32), Xq


def quantize_sym_t(X, clip=127.0, amax=None):
    """`quantize_sym` of X (n, r) with Xq emitted transposed, (r, n) and
    contiguous, as the int8 kernels take the W side: the same scale and
    the same integers bit for bit (the same elementwise operations, with
    the quotient written in the transposed layout); `amax` as there."""
    if amax is None:
        amax = X.abs().amax()
    scale = torch.clamp(amax / clip, min=1e-30)
    Xt = torch.empty((X.shape[1], X.shape[0]), dtype=X.dtype,
                     device=X.device)
    torch.div(X.T, scale, out=Xt)
    Xq = torch.clamp(torch.round(Xt), -clip, clip).to(torch.int8)
    return scale.to(torch.float32), Xq


def _quantize_h(X, sums=LOCAL):
    """`quantize_sym` of an (r, ·) right factor, one scale for the whole
    matrix (its blocks' max taken over V's columns)."""
    return quantize_sym(X, amax=sums.cols(X.abs().amax(), maximum=True))


def _quantize_wt(X, sums=LOCAL):
    """`quantize_sym_t` of an (·, r) left factor, one scale for the whole
    matrix (its blocks' max taken over V's rows)."""
    return quantize_sym_t(X, amax=sums.rows(X.abs().amax(), maximum=True))


def _vht_ints(Vq, X, sums=LOCAL):
    """(Vq·Xqᵀ int32 (n, r), s_x, Xq): X requantized, int8 × int8 →
    int32 (``kernels.dual_numer.vht_int8``); partial sums added in int32,
    so they wrap as one device's sum does."""
    from nmftpu_torch.kernels import dual_numer as DN

    s_x, Xq = _quantize_h(X, sums)
    return sums.cols(DN.vht_int8(Vq, Xq)), s_x, Xq


def _wtv_ints(Vq, X, sums=LOCAL):
    """(Xqᵀ·Vq int32 (r, m), s_x, Xqᵀ); X (n, r) as `_vht_ints`."""
    from nmftpu_torch.kernels import dual_numer as DN

    s_x, XqT = _quantize_wt(X, sums)
    return sums.rows(DN.wtv_int8(Vq, XqT)), s_x, XqT


def _rhs_vht_int8(Vq, scale_v, X, sums=LOCAL):
    """V·Xᵀ (n, r) with int8 V: X requantized per call, int8 × int8 →
    int32, both scales after."""
    ints, s_x, _ = _vht_ints(Vq, X, sums)
    return ints.to(torch.float32) * (scale_v * s_x)


def _rhs_wtv_int8(Vq, scale_v, X, sums=LOCAL):
    """Xᵀ·V (r, m) with int8 V; X (n, r) requantized per call."""
    ints, s_x, _ = _wtv_ints(Vq, X, sums)
    return ints.to(torch.float32) * (scale_v * s_x)


def mu_update_frobenius_int8x8(Vq, scale_v, W, H, eps=1e-9, order="WH",
                               use_fused=False, sums=LOCAL):
    """MU (Frobenius) with the O(nmr) contractions as int8 x int8 ->
    int32: V is stored int8 once (V ~= scale_v * Vq); the factor operand
    of each big contraction is requantized per half-step and both scales
    fold in after the integer sums. order="jacobi" takes both numerators
    from the same (W, H); with `use_fused` they come from one kernel
    launch (``kernels.dual_numer.dual_numerators_int8``), which gives the
    same integers as the two one-sided contractions. Unlike ``nmftpu``'s,
    the fused kernel takes any shape, so no tiling or memory gate
    decides."""

    def upd_w(W, H):
        numer = _rhs_vht_int8(Vq, scale_v, H, sums)
        return W * (numer / (W @ sums.cols(H @ H.T) + eps))

    def upd_h(W, H):
        numer = _rhs_wtv_int8(Vq, scale_v, W, sums)
        return H * (numer / (sums.rows(W.T @ W) @ H + eps))

    if order == "jacobi":
        if use_fused:
            from nmftpu_torch.kernels import dual_numer as DN

            numer_w, numer_h = DN.dual_numerators_int8(Vq, scale_v, W, H,
                                                       sums=sums)
        else:
            numer_w = _rhs_vht_int8(Vq, scale_v, H, sums)
            numer_h = _rhs_wtv_int8(Vq, scale_v, W, sums)
        return _jacobi_fro_apply(
            W, H, numer_w, numer_h, sums.rows(W.T @ W), sums.cols(H @ H.T),
            eps, sums,
        )
    return _apply_order(upd_w, upd_h, W, H, order)


# ---------------------------------------------------------------------------
# Confidence-weighted MU (implicit feedback, BASELINE config 3)
# ---------------------------------------------------------------------------


def mu_update_frobenius_weighted(V, C, W, H, eps=1e-9, order="WH",
                                 sums=LOCAL):
    """Confidence-weighted MU: minimizes ||sqrt(C) ⊙ (V - WH)||_F², with
    C an elementwise confidence (1 + alpha·V, built once by the
    registry):

        W <- W ⊙ ((C⊙V) Hᵀ) / ((C⊙(WH)) Hᵀ + eps)
        H <- H ⊙ (Wᵀ (C⊙V)) / (Wᵀ (C⊙(WH)) + eps)

    Dense float V: C⊙V once, C⊙(WH) per half-step at n·m size, as in
    ``nmftpu``. Orders "WH" and "HW"."""
    CV = C * V

    def upd_w(W, H):
        CWH = C * (W @ H)
        return W * (sums.cols(CV @ H.T) / (sums.cols(CWH @ H.T) + eps))

    def upd_h(W, H):
        CWH = C * (W @ H)
        return H * (sums.rows(W.T @ CV) / (sums.rows(W.T @ CWH) + eps))

    return _apply_order(upd_w, upd_h, W, H, order)


# ---------------------------------------------------------------------------
# Least-squares solvers (normal equations of the ALS family and fold-in)
# ---------------------------------------------------------------------------


def spd_solve(A, rhs):
    """Solve A X = rhs for symmetric positive definite A (r, r), or a
    batch (b, r, r) with rhs (b, r, k): Cholesky once, a triangular solve
    against the r-wide identity only, then A^-1 = L^-T L^-1 applied to
    the wide rhs as one product, as ``nmftpu`` does. A matrix whose
    factorization fails gives NaN, as XLA's Cholesky does; the
    factorization's status is never read on the host, so nothing here
    waits for the device."""
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info == 0)[..., None, None], L, float("nan"))
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return (Linv.mT @ Linv) @ rhs


def solve_clamped(gram, rhs, shift, off, eps):
    """ALS-family normal-equation solve: the Gram plus a diagonal shift
    (and an optional AHCLS shift off · 11ᵀ), spd_solve, clamp at 0."""
    r = gram.shape[0]
    A = gram + (shift + eps) * torch.eye(r, gram.shape[1], dtype=gram.dtype,
                                         device=gram.device)
    if off:
        A = A + off
    return torch.clamp(spd_solve(A, rhs), min=0.0)


def _solve_h(gram, rhs, eps):
    """Solve (gram + eps I) H = rhs for H (r, m)."""
    r = gram.shape[0]
    return spd_solve(
        gram + eps * torch.eye(r, dtype=gram.dtype, device=gram.device), rhs)


def _ridged(Gb, shift, eps):
    """The per-row systems of the batched solves, Gb (b, r, r) plus a
    scale-aware ridge: shift + eps + max(eps, 100 machine eps) times each
    row's mean diagonal. Weighted Grams can be large and numerically
    singular (a constant init makes H C Hᵀ rank 1); an absolute 1e-9
    shift sits below float32 Cholesky's cancellation noise there and
    turns the factors NaN."""
    r = Gb.shape[-1]
    diag_mean = torch.diagonal(Gb, dim1=-2, dim2=-1).sum(-1)[:, None, None] / r
    rel_floor = 100.0 * torch.finfo(Gb.dtype).eps
    ridge = shift + eps + max(eps, rel_floor) * diag_mean
    return Gb + ridge * torch.eye(r, dtype=Gb.dtype, device=Gb.device)


def _batched_solve_clamped(Gb, rhs, shift, eps):
    """Per-row solves (b, r, r) x (b, r) -> clamp(>= 0) (b, r), on the
    ridged systems of `_ridged`: one batched Cholesky."""
    sol = spd_solve(_ridged(Gb, shift, eps), rhs[..., None])[..., 0]
    return torch.clamp(sol, min=0.0)


def _batched_solve_clamped_cg(Gb, rhs, shift, eps, x0, steps=3):
    """Warm-started Jacobi-preconditioned conjugate gradients for the
    per-row normal equations of weighted/masked ALS, then clamp(>= 0):
    `steps` batched matvecs instead of a batched Cholesky (Takács &
    Pilászy 2011); the outer ALS loop is itself iterative, so a warm start
    from the previous factors makes a few inner steps enough. A row whose
    search direction has no curvature (converged) freezes."""
    A = _ridged(Gb, shift, eps)
    dinv = 1.0 / torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1),
                             min=torch.finfo(A.dtype).tiny)

    def matvec(p):
        return torch.einsum("nij,nj->ni", A, p)

    x = x0.to(A.dtype)
    res = rhs - matvec(x)
    z = dinv * res
    p = z
    rz = torch.sum(res * z, dim=1, keepdim=True)
    for _ in range(steps):
        Ap = matvec(p)
        denom = torch.sum(p * Ap, dim=1, keepdim=True)
        ok = denom > 0
        alpha = torch.where(ok, rz / torch.where(ok, denom, 1.0), 0.0)
        x = x + alpha * p
        res = res - alpha * Ap
        z = dinv * res
        rz2 = torch.sum(res * z, dim=1, keepdim=True)
        pos = rz > 0
        p = z + torch.where(pos, rz2 / torch.where(pos, rz, 1.0), 0.0) * p
        rz = rz2
    return torch.clamp(x, min=0.0)


# The plain per-row solves (and the CG steps) run over panels of rows
# whose (rows, r, r) systems take about this many bytes each: the Cholesky
# factor, its inverse and their product are each one such array, never
# one of all n rows; kernel #12 takes all rows at once
ROW_SOLVE_PANEL_BYTES = 1 << 30


def _panel_solve(G, dG, rhs, solve_panel):
    """(rows, r): solve_panel(Gb, s, e) for the rows s:e of each panel of
    `ROW_SOLVE_PANEL_BYTES`, Gb = G + dG[s:e] (dG[s:e] where G is None)."""
    rows, r = rhs.shape
    panel = max(1, ROW_SOLVE_PANEL_BYTES // (r * r * dG.element_size()))
    out = torch.empty_like(rhs)
    for s, e in _panels(rows, panel):
        Gb = dG[s:e] if G is None else G[None] + dG[s:e]
        out[s:e] = solve_panel(Gb, s, e)
    return out


def row_solver(solver="exact", cg_steps=3):
    """solve(G, dG, rhs, shift, eps, x0) -> (rows, r), clamped at 0: the
    per-row systems G + dG[i] (G the shared (r, r) base Gram, or None)
    solved exactly or by `cg_steps` warm-started Jacobi-preconditioned CG
    steps from x0 (`_batched_solve_clamped_cg`), over panels of rows
    (`ROW_SOLVE_PANEL_BYTES`). The exact solve (x0 unused) is one launch
    of kernel #12 for all rows (``kernels.row_solve.solve_rows``) on CUDA
    float32 rows of r <= ``ROW_SOLVE_MAX_RANK``, else the panel loop over
    `_batched_solve_clamped`. Each row's solve is independent of the
    panel it falls in. Every per-row weighted solve of the package runs
    here (iALS, masked ALS, the dense iALS, the weighted fold-in)."""
    from nmftpu_torch.kernels import row_solve as RS

    def solve(G, dG, rhs, shift, eps, x0):
        if solver == "cg":
            return _panel_solve(G, dG, rhs, lambda Gb, s, e:
                                _batched_solve_clamped_cg(
                                    Gb, rhs[s:e], shift, eps, x0[s:e],
                                    steps=cg_steps))
        if RS.takes(dG.device, dG.dtype, rhs.shape[1]):
            # #12 reads a row's right-hand side as r contiguous floats; the
            # mesh's H halves pass the transpose of an (r, m) sum
            if rhs.stride(1) != 1:
                rhs = rhs.contiguous()
            return RS.solve_rows(G, dG, rhs, shift, eps)
        return _panel_solve(G, dG, rhs, lambda Gb, s, e:
                            _batched_solve_clamped(Gb, rhs[s:e], shift, eps))

    return solve


# The dense iALS builds each panel's (rows, r, r) Grams from sub-panels
# whose (rows, r, m) intermediate (the partner scaled by each row's
# confidences) takes at most about this many bytes
WEIGHTED_GRAM_SUBPANEL_BYTES = 1 << 30


def als_update_weighted(V, W, H, alpha, lambda_w=0.0, lambda_h=0.0,
                        eps=1e-9, order="WH", block=1024, sums=LOCAL):
    """Confidence-weighted ALS (iALS, Hu-Koren-Volinsky) on dense V with
    C = 1 + alpha·V: each half-step solves every row's weighted normal
    equations

        (H C_u Hᵀ + (λ + eps) I) w_u = H (c_u ⊙ v_u)

    (the column dual for H) and clamps at 0; the objective of
    `mu_update_frobenius_weighted`, minimized exactly per row. Panels of
    `block` rows (columns) each take one exact `row_solver` call; a
    panel's Grams are built in sub-panels of rows whose (rows, r, m)
    scaled partner stays within WEIGHTED_GRAM_SUBPANEL_BYTES (a single
    (1024, r, m) product is 28 GB at the ML-20M width, r = 64). O(n m r²)
    a half-step: sparse V takes ``sparse_ops.als_update_weighted_sparse``,
    which pays O(nnz r²)."""
    solve = row_solver()
    n, m = V.shape
    r = W.shape[1]

    def grams(P, Cp):
        """Σ_k c[u, k] p_k p_kᵀ for each row u of Cp (rows, K), P (r, K)."""
        sub = max(1, WEIGHTED_GRAM_SUBPANEL_BYTES
                  // (r * P.shape[1] * P.element_size()))
        return torch.cat([(P[None] * Cp[a:b, None, :]) @ P.T
                          for a, b in _panels(Cp.shape[0], sub)])

    def upd_w(W, H):
        out = torch.empty((n, r), dtype=V.dtype, device=V.device)
        for s, e in _panels(n, block):
            Vp = V[s:e]
            Cp = 1.0 + alpha * Vp
            out[s:e] = solve(None, sums.cols(grams(H, Cp)),
                             sums.cols((Cp * Vp) @ H.T), lambda_w, eps, None)
        return out

    def upd_h(W, H):
        out = torch.empty((r, m), dtype=V.dtype, device=V.device)
        Wt = W.T
        for s, e in _panels(m, block):
            Vp = V[:, s:e]
            Cp = (1.0 + alpha * Vp).T                     # (cols, n)
            rhs = sums.rows((Cp * Vp.T) @ W)              # (cols, r)
            out[:, s:e] = solve(None, sums.rows(grams(Wt, Cp)), rhs,
                                lambda_h, eps, None).T
        return out

    return _apply_order(upd_w, upd_h, W, H, order)


# ---------------------------------------------------------------------------
# The ALS family (ALS, ACLS, AHCLS), GDCLS and nsNMF; float32 V
# ---------------------------------------------------------------------------


def als_update(V, W, H, eps=1e-9, order="WH", sums=LOCAL):
    """ALS iteration: exact least squares through the normal equations,
    then clamp at 0:

        H = max(0, (WᵀW + eps I)⁻¹ WᵀV),  W likewise from (HHᵀ + eps I).

    The solves are r x r (`spd_solve`); the right-hand sides WᵀV and HVᵀ
    are the O(nmr) products. ACLS without penalties."""
    return acls_update(V, W, H, 0.0, 0.0, eps, order, sums)


def acls_update(V, W, H, lambda_w=0.0, lambda_h=0.0, eps=1e-9, order="WH",
                sums=LOCAL):
    """ACLS (Langville et al.): ALS with the sparsity penalties on the
    diagonal, (WᵀW + lambda_h I) H = WᵀV and the dual for W, then clamp."""

    def upd_w(W, H):
        return torch.clamp(_solve_h(sums.cols(H @ H.T), sums.cols(H @ V.T),
                                    lambda_w + eps).T, min=0.0)

    def upd_h(W, H):
        return torch.clamp(_solve_h(sums.rows(W.T @ W), sums.rows(W.T @ V),
                                    lambda_h + eps), min=0.0)

    return _apply_order(upd_w, upd_h, W, H, order)


def _ahcls_shift(lam, alpha, r, dtype):
    """AHCLS diagonal and off-diagonal shifts from a Hoyer-sparseness
    target alpha in [0, 1] (Langville et al.): the normal-equation matrix
    becomes G + lam·beta·I + lam·(1 - beta)·11ᵀ with
    beta = ((1 - alpha)·√r + alpha)² / r. The square root is taken in
    `dtype` (V's), as ``nmftpu``'s dense AHCLS does; the int8 and bf16
    routes take their shifts from `_als_family_shifts` (float64) instead.
    Returns 0-dim CPU tensors of `dtype`, which enter device arithmetic
    as scalars."""
    sr = torch.sqrt(torch.tensor(float(r), dtype=dtype))
    beta = ((1.0 - alpha) * sr + alpha) ** 2 / r
    return lam * beta, lam * (1.0 - beta)


def _als_family_shifts(config: NmfConfig):
    """(shift_w, shift_h, off_w, off_h) for the generic ALS-family solve
    (`solve_clamped`): ALS = the plain normal equations, ACLS = the
    diagonal sparsity penalties, AHCLS = the Hoyer-target diagonal and
    off-diagonal shifts (Langville et al.), computed in float64 on the
    host. The dense float32 AHCLS takes its shift from `_ahcls_shift`
    (in V's dtype) instead, as in ``nmftpu``."""
    if config.algorithm is Algorithm.ALS:
        return 0.0, 0.0, 0.0, 0.0
    if config.algorithm is Algorithm.ACLS:
        return config.lambda_w, config.lambda_h, 0.0, 0.0
    r = config.rank

    def hoyer(lam, a):
        sr = math.sqrt(r)
        beta = ((1.0 - a) * sr + a) ** 2 / r
        return lam * beta, lam * (1.0 - beta)

    sw, ow = hoyer(config.lambda_w, config.alpha_w)
    sh, oh = hoyer(config.lambda_h, config.alpha_h)
    return sw, sh, ow, oh


def ahcls_update(V, W, H, lambda_w=0.0, lambda_h=0.0, alpha_w=0.5,
                 alpha_h=0.5, eps=1e-9, order="WH", sums=LOCAL):
    """AHCLS: ACLS plus the Hoyer-sparseness targets alpha_w / alpha_h
    (`_ahcls_shift`), solved with `spd_solve` and clamped at 0."""
    r = W.shape[1]
    dt = V.dtype
    eye = torch.eye(r, dtype=dt, device=V.device)
    ones = torch.ones((r, r), dtype=dt, device=V.device)
    (diag_w, off_w), (diag_h, off_h) = (_ahcls_shift(lambda_w, alpha_w, r, dt),
                                        _ahcls_shift(lambda_h, alpha_h, r, dt))

    def upd_w(W, H):
        A = sums.cols(H @ H.T) + (diag_w + eps) * eye + off_w * ones
        return torch.clamp(spd_solve(A, sums.cols(H @ V.T)).T, min=0.0)

    def upd_h(W, H):
        A = sums.rows(W.T @ W) + (diag_h + eps) * eye + off_h * ones
        return torch.clamp(spd_solve(A, sums.rows(W.T @ V)), min=0.0)

    return _apply_order(upd_w, upd_h, W, H, order)


def gdcls_update(V, W, H, lambda_tik=0.0, eps=1e-9, order="WH", sums=LOCAL):
    """GDCLS: a Frobenius MU step for W, a Tikhonov-regularized least
    squares solve (WᵀW + lambda_tik I) H = WᵀV for H, clamped at 0."""

    def upd_w(W, H):
        return mu_update_w_frobenius(V, W, H, eps, sums)

    def upd_h(W, H):
        return torch.clamp(_solve_h(sums.rows(W.T @ W), sums.rows(W.T @ V),
                                    lambda_tik + eps), min=0.0)

    return _apply_order(upd_w, upd_h, W, H, order)


def nsnmf_smoothing_matrix(rank, theta, dtype=torch.float32, device=None):
    """S = (1 - theta) I + (theta / r) 11ᵀ, the nsNMF smoothing matrix."""
    eye = torch.eye(rank, dtype=dtype, device=device)
    ones = torch.ones((rank, rank), dtype=dtype, device=device)
    return (1.0 - theta) * eye + (theta / rank) * ones


def nsnmf_update(V, W, H, S, eps=1e-9, objective="frobenius", order="WH",
                 sums=LOCAL):
    """One nsNMF iteration (Pascual-Montano 2006), V ≈ W S H: MU
    half-steps against the smoothed partners, S H standing in for H in
    the W step and W S for W in the H step; `objective` "frobenius" or
    "kl"."""
    if objective == "frobenius":
        upd_w, upd_h = mu_update_w_frobenius, mu_update_h_frobenius
    else:
        upd_w, upd_h = mu_update_w_kl, mu_update_h_kl
    return _apply_order(lambda W, H: upd_w(V, W, S @ H, eps, sums),
                        lambda W, H: upd_h(V, W @ S, H, eps, sums), W, H,
                        order)


# ---------------------------------------------------------------------------
# The ALS family, GDCLS and nsNMF on int8 V: the O(nmr) right-hand sides
# on #6's one-sided int8 entries, the r x r solves in float32
# ---------------------------------------------------------------------------


def _ls_terms_w_int8(Vq, scale_v, H, sums=LOCAL):
    """(gram, rhs) of the W-side normal equations with H quantized once:
    gram = H̃H̃ᵀ (r, r) and rhs = H̃Ṽᵀ (r, n), both from the same
    dequantized H̃ = Hq·s_h. Consistency matters: an exact float32 Gram
    beside a quantized rhs perturbs the solve by cond(G) ≈ cond(H)²,
    while the consistent pair is the exact solution of the quantized
    least-squares problem. The rhs is the transpose of
    ``kernels.dual_numer.vht_int8``'s Vq Hqᵀ (the same integers)."""
    ints, s_h, Hq = _vht_ints(Vq, H, sums)
    Hd = Hq.to(torch.float32) * s_h
    rhs = ints.T.to(torch.float32) * (scale_v * s_h)
    return sums.cols(Hd @ Hd.T), rhs


def _ls_terms_h_int8(Vq, scale_v, W, sums=LOCAL):
    """(gram, rhs) of the H-side normal equations with W quantized once:
    gram = W̃ᵀW̃ (r, r), rhs = W̃ᵀṼ (r, m) from
    ``kernels.dual_numer.wtv_int8`` (W̃ᵀ comes transposed from
    `quantize_sym_t`). See `_ls_terms_w_int8`."""
    ints, s_w, WqT = _wtv_ints(Vq, W, sums)
    WdT = WqT.to(torch.float32) * s_w
    rhs = ints.to(torch.float32) * (scale_v * s_w)
    return sums.rows(WdT @ WdT.T), rhs


def als_family_update_int8x8(Vq, scale_v, W, H, shift_w=0.0, shift_h=0.0,
                             off_w=0.0, off_h=0.0, eps=1e-9, order="WH",
                             sums=LOCAL):
    """ALS / ACLS / AHCLS (the shifts of `_als_family_shifts`)
    with V stored int8 (V ≈ scale_v·Vq): each half-step quantizes its
    factor operand once and builds both the Gram and the rhs from it
    (`_ls_terms_*_int8`), so the float32 r x r solve is the exact solution
    of the quantized least-squares problem. The factors keep their dtype
    (a float64 factor holds the float32 solve's values)."""

    def upd_w(W, H):
        gram, rhs = _ls_terms_w_int8(Vq, scale_v, H, sums)
        return solve_clamped(gram, rhs, shift_w, off_w, eps).T.to(W.dtype)

    def upd_h(W, H):
        gram, rhs = _ls_terms_h_int8(Vq, scale_v, W, sums)
        return solve_clamped(gram, rhs, shift_h, off_h, eps).to(H.dtype)

    return _apply_order(upd_w, upd_h, W, H, order)


def gdcls_update_int8x8(Vq, scale_v, W, H, lambda_tik=0.0, eps=1e-9,
                        order="WH", sums=LOCAL):
    """GDCLS with int8-stored V: the MU W step and the Tikhonov H solve,
    both right-hand sides on the int8 entries; the H solve takes the
    consistent quantized Gram (see `als_family_update_int8x8`)."""

    def upd_w(W, H):
        numer = _rhs_vht_int8(Vq, scale_v, H, sums)
        return W * (numer / (W @ sums.cols(H @ H.T) + eps))

    def upd_h(W, H):
        gram, rhs = _ls_terms_h_int8(Vq, scale_v, W, sums)
        return solve_clamped(gram, rhs, lambda_tik, 0.0, eps).to(H.dtype)

    return _apply_order(upd_w, upd_h, W, H, order)


def nsnmf_update_frobenius_int8x8(Vq, scale_v, W, H, S, eps=1e-9,
                                  order="WH", sums=LOCAL):
    """nsNMF (Frobenius) with int8-stored V: MU against the smoothed
    partners (S H for the W step, W S for the H step), the numerators on
    the int8 entries."""

    def upd_w(W, H):
        SH = S @ H
        numer = _rhs_vht_int8(Vq, scale_v, SH, sums)
        return W * (numer / (W @ sums.cols(SH @ SH.T) + eps))

    def upd_h(W, H):
        WS = W @ S
        numer = _rhs_wtv_int8(Vq, scale_v, WS, sums)
        return H * (numer / (sums.rows(WS.T @ WS) @ H + eps))

    return _apply_order(upd_w, upd_h, W, H, order)


# ---------------------------------------------------------------------------
# HALS / coordinate descent
# ---------------------------------------------------------------------------


def _hals_step(w_col, grad, hess):
    """max(w - grad / hess, 0), leaving the column as it is where
    hess == 0 (sklearn skips such columns)."""
    ok = hess != 0
    new = torch.clamp(w_col - grad / torch.where(ok, hess, 1.0), min=0.0)
    return torch.where(ok, new, w_col)


def _hals_half_sweep(XHt, G, W):
    """One cyclic HALS sweep over the r columns of W:

        W[:, t] <- max(W[:, t] - (W G[:, t] - XHt[:, t]) / G[t, t], 0)

    sequentially in t (each column sees the already-updated earlier
    columns): the update of sklearn's coordinate-descent solver
    (`_cdnmf_fast._update_cdnmf_fast`, identity permutation). XHt (n, r)
    and the Gram G (r, r) are precomputed. Returns a new tensor."""
    W = W.clone()
    for t in range(G.shape[0]):
        grad = W @ G[:, t] - XHt[:, t]
        W[:, t] = _hals_step(W[:, t], grad, G[t, t])
    return W


def _hals_half_sweep_blocked(XHt, G, W, block=32):
    """Blocked Gauss–Seidel HALS sweep, the same column order as
    `_hals_half_sweep`: per block of `block` columns (the last one
    shorter when `block` does not divide r), one (n, r) @ (r, b) GEMM
    forms the gradient base, and after column t changes by delta every
    later column of the block shifts by delta * G[t, s] (rank-1
    corrections). The same update in exact arithmetic; float32 differs
    only in summation order. Returns a new tensor."""
    n, r = W.shape
    block = min(block, r)
    W = W.clone()
    for start in range(0, r, block):
        b = min(block, r - start)
        Gb = G[:, start:start + b]                     # (r, b)
        base = W @ Gb - XHt[:, start:start + b]        # (n, b)
        Wb = W[:, start:start + b]                     # (n, b), read below
        Gbb = Gb[start:start + b]                      # (b, b)
        new_cols = []
        for t in range(b):
            w_col = Wb[:, t]
            new = _hals_step(w_col, base[:, t], Gbb[t, t])
            # shift the gradients of the later columns (columns <= t are
            # shifted too, and never read again)
            base = base + (new - w_col)[:, None] * Gbb[t][None, :]
            new_cols.append(new)
        W[:, start:start + b] = torch.stack(new_cols, dim=1)
    return W


def hals_half_sweep(XHt, G, W, impl="auto", block=16):
    """One HALS half-sweep:

    * ``kernel``  — the CUDA sweep (`kernels.hals_sweep`; for CPU tensors
      its plain twin, the blocked sweep). ``auto`` picks it for float32
      tensors on the card at r >= 16.
    * ``blocked`` — `_hals_half_sweep_blocked` (any dtype and device;
      ``auto``'s choice for float64 and CPU tensors).
    * ``seq``     — the strictly sequential oracle (``auto`` below r = 16).

    The same update in exact arithmetic; float32 differs in summation
    order only. The kernel takes W contiguous, so a transposed factor
    (the H sweep passes Hᵀ) is copied to (n, r) first."""
    r = G.shape[0]
    if impl == "auto":
        if r < 16:
            impl = "seq"
        elif W.dtype == torch.float32 and W.device.type == "cuda":
            impl = "kernel"
        else:
            impl = "blocked"
    if impl == "kernel":
        from nmftpu_torch.kernels import hals_sweep as HS

        return HS.hals_sweep(XHt.contiguous(), G.contiguous(),
                             W.contiguous(), block=min(block, r))
    if impl == "blocked":
        return _hals_half_sweep_blocked(XHt, G, W, block=block)
    if impl == "seq":
        return _hals_half_sweep(XHt, G, W)
    raise ValueError(f"impl must be auto|kernel|blocked|seq, got {impl!r}")


def hals_update(V, W, H, eps=1e-9, order="WH", l2_w=0.0, l2_h=0.0,
                l1_w=0.0, l1_h=0.0, block=16, impl="auto", sums=LOCAL):
    """HALS / coordinate descent (Cichocki & Phan; sklearn's default 'cd'
    solver): one cyclic rank-1 sweep over W's columns, then one over H's
    rows (order "WH"; "HW" the other way). Frobenius objective only.
    Regularization as sklearn's _update_coordinate_descent: L2 adds to
    the Gram diagonal, L1 subtracts from the numerator. `eps` is unused
    (the hess != 0 branch guards the division). block=1 runs the
    sequential sweep, block > 1 `hals_half_sweep` with `impl`. Returns
    new tensors, H contiguous."""
    r = W.shape[1]
    eye = torch.eye(r, dtype=W.dtype, device=W.device)
    if block > 1:
        def half(XHt, G, X):
            return hals_half_sweep(XHt, G, X, impl=impl, block=block)
    else:
        half = _hals_half_sweep

    def sweep_w(W, H):
        return half(sums.cols(V @ H.T) - l1_w, sums.cols(H @ H.T) + l2_w * eye,
                    W)

    def sweep_h(W, H):
        return half(sums.rows(V.T @ W) - l1_h, sums.rows(W.T @ W) + l2_h * eye,
                    H.T).T.contiguous()

    return _apply_order(sweep_w, sweep_h, W, H, order)


# ---------------------------------------------------------------------------
# Error metrics (SURVEY.md C9) — stay on the device as 0-dim tensors.
# ---------------------------------------------------------------------------


def frobenius_error_sq(V, W, H, sum_v_sq=None):
    """||V - WH||_F^2 via the Gram/trace identity.

    ||V - WH||^2 = ||V||^2 - 2 tr(H^T (W^T V)) + tr((W^T W)(H H^T)).
    Avoids materializing WH when V is large; the only O(nmr) term is W^T V.
    `sum_v_sq` (= ||V||_F^2) can be precomputed once outside the loop.
    """
    if sum_v_sq is None:
        sum_v_sq = torch.sum(V * V)
    WtV = W.T @ V                        # (r, m)
    cross = torch.sum(WtV * H)
    WtW = W.T @ W
    HHt = H @ H.T
    quad = torch.sum(WtW * HHt)
    # Clamp: the identity can go slightly negative in floating point near
    # convergence.
    return torch.clamp(sum_v_sq - 2.0 * cross + quad, min=0.0)


def frobenius_error(V, W, H, sum_v_sq=None):
    """||V - WH||_F."""
    return torch.sqrt(frobenius_error_sq(V, W, H, sum_v_sq))


def rmsd(V, W, H, sum_v_sq=None):
    """Root-mean-square deviation: sqrt(||V - WH||_F^2 / (n m))."""
    n, m = V.shape[0], H.shape[1]
    return torch.sqrt(
        frobenius_error_sq(V, W, H, sum_v_sq) / (float(n) * float(m))
    )


def kl_error(V, W, H, eps=1e-12):
    """Generalized KL (I-)divergence D(V || WH) = sum V log(V/WH) - V + WH.
    Zero entries of V contribute only their +WH term."""
    WH = W @ H
    ratio_term = torch.where(
        V > 0,
        V * torch.log(torch.clamp(V, min=eps) / torch.clamp(WH, min=eps)),
        0.0,
    )
    return torch.sum(ratio_term - V + WH)


def beta_divergence(V, W, H, beta, eps=1e-12):
    """Generalized beta divergence D_beta(V || WH), sklearn's
    _beta_divergence general and Itakura–Saito branches (without the
    square root):

      beta = 0:   sum V/WH - log(V/WH) - 1
      otherwise:  sum (V^b + (b-1) WH^b - b V WH^(b-1)) / (b (b-1))

    WH is eps-guarded; for beta <= 0 zero entries of V are too (the IS
    divergence is +inf at V = 0, where sklearn reports inf; the finite
    eps proxy keeps best-of-N comparable). beta = 1 and 2 use kl_error /
    frobenius_error."""
    WH = torch.clamp(W @ H, min=eps)
    if beta == 0.0:
        div = torch.clamp(V, min=eps) / WH
        return torch.sum(div - torch.log(div) - 1.0)
    if beta <= 0.0:
        Vb = torch.clamp(V, min=eps) ** beta
    else:
        Vb = torch.where(V > 0, torch.where(V > 0, V, 1.0) ** beta, 0.0)
    term = Vb + (beta - 1.0) * WH ** beta - beta * V * WH ** (beta - 1.0)
    return torch.sum(term) / (beta * (beta - 1.0))
