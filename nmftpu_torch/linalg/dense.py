"""Dense update rules and error metrics, plain torch (port of the MU
(Frobenius and KL, Gauss–Seidel and Jacobi, float32 / bf16 / int8 V) and
HALS subset of ``nmftpu/linalg/dense.py``).

Conventions
-----------
V : (n, m)  nonnegative data ("users" x "items")
W : (n, r)  left factor  (user embeddings)
H : (r, m)  right factor (item embeddings)

Every update returns new tensors. The large products are ``torch.matmul``
(on the card: cuBLAS, full float32 while TF32 is off), as ``nmftpu``
leaves them to XLA. The epsilon guard is added to the denominators.
Three functions reach hand-written CUDA kernels for CUDA tensors: the
int8 x int8 numerators (``kernels.dual_numer``) and the HALS half-sweep
(``kernels.hals_sweep``); on CPU tensors those wrappers run their plain
torch twins.
"""

from __future__ import annotations

import torch


def mu_update_w_frobenius(V, W, H, eps):
    """W <- W * (V H^T) / (W (H H^T) + eps).   One Lee–Seung half-step."""
    numer = V @ H.T                      # (n, r)   O(nmr)
    HHt = H @ H.T                        # (r, r)   O(mr^2)
    denom = W @ HHt + eps                # (n, r)   O(nr^2)
    return W * (numer / denom)


def mu_update_h_frobenius(V, W, H, eps):
    """H <- H * (W^T V) / ((W^T W) H + eps)."""
    numer = W.T @ V                      # (r, m)
    WtW = W.T @ W                        # (r, r)
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


def _jacobi_fro_apply(W, H, numer_w, numer_h, G_w, G_h, eps):
    """Scale-corrected simultaneous (Jacobi) Frobenius MU step.

    The raw simultaneous step W ⊙ rw, H ⊙ rh squares the correction of
    the global scale of WH that each half-step makes on its own, and
    two-cycles on a scale-mismatched iterate. Both ratios are divided by
    √s, where s = ⟨V, WH⟩/‖WH‖² = ⟨numer_w, W⟩/⟨WᵀW, HHᵀ⟩ is the optimal
    global scale, read from the update's own pieces. At a stationary pair
    s = 1, so the fixed points are those of Gauss–Seidel."""
    s_num = torch.sum(numer_w * W)
    s_den = torch.clamp(torch.sum(G_w * G_h), min=eps)
    inv_a = torch.rsqrt(torch.clamp(s_num / s_den, min=eps))
    W_new = W * (numer_w / (W @ G_h + eps)) * inv_a
    H_new = H * (numer_h / (G_w @ H + eps)) * inv_a
    return W_new, H_new


def mu_update_frobenius(V, W, H, eps=1e-9, order="WH"):
    """One full MU iteration under the Frobenius objective. order="WH"
    updates W first, "HW" H first; "jacobi" updates both from the
    incoming factors with the scale correction of `_jacobi_fro_apply`."""
    if order == "jacobi":
        return _jacobi_fro_apply(
            W, H, V @ H.T, W.T @ V, W.T @ W, H @ H.T, eps,
        )
    return _apply_order(
        lambda W, H: mu_update_w_frobenius(V, W, H, eps),
        lambda W, H: mu_update_h_frobenius(V, W, H, eps),
        W, H, order,
    )


def mu_update_w_kl(V, W, H, eps):
    """KL half-step: W <- W * ((V / (WH)) H^T) / (row-broadcast sum_j H)."""
    ratio = V / (W @ H + eps)            # (n, m)
    numer = ratio @ H.T                  # (n, r)
    denom = torch.clamp(torch.sum(H, dim=1), min=eps)[None, :]
    return W * (numer / denom)


def mu_update_h_kl(V, W, H, eps):
    """KL half-step: H <- H * (W^T (V / (WH))) / (col-broadcast sum_i W)."""
    ratio = V / (W @ H + eps)
    numer = W.T @ ratio                  # (r, m)
    denom = torch.clamp(torch.sum(W, dim=0), min=eps)[:, None]
    return H * (numer / denom)


def _jacobi_kl_scale(sum_v, w_sum, h_sum, eps):
    """1/√a for the simultaneous KL step: a = ΣV / ΣWH is the closed-form
    argmin of KL(V ‖ a·WH), with ΣWH = ⟨colsum W, rowsum H⟩; a = 1 at any
    KL stationary point."""
    s = sum_v / torch.clamp(torch.dot(w_sum, h_sum), min=eps)
    return torch.rsqrt(torch.clamp(s, min=eps))


def mu_update_kl(V, W, H, eps=1e-9, order="WH"):
    """One full MU iteration under the KL (generalized I-divergence)
    objective. order="jacobi" computes both half-steps from one shared
    WH/ratio pass, both ratios divided by √a (`_jacobi_kl_scale`)."""
    if order == "jacobi":
        ratio = V / (W @ H + eps)
        numer_w = ratio @ H.T
        numer_h = W.T @ ratio
        h_sum = torch.clamp(torch.sum(H, dim=1), min=eps)
        w_sum = torch.clamp(torch.sum(W, dim=0), min=eps)
        inv_a = _jacobi_kl_scale(torch.sum(V), w_sum, h_sum, eps)
        return (W * (numer_w / h_sum[None, :]) * inv_a,
                H * (numer_h / w_sum[:, None]) * inv_a)
    return _apply_order(
        lambda W, H: mu_update_w_kl(V, W, H, eps),
        lambda W, H: mu_update_h_kl(V, W, H, eps),
        W, H, order,
    )


def _bf16_dot(a, b, block_rows=4096):
    """a @ b with both operands rounded to bfloat16 and the products
    summed in float32 — the contract of ``dot_general(bf16, bf16,
    preferred_element_type=f32)``: a product of two bf16 values is exact
    in float32, so upcasting the rounded operands gives the same sums.

    The larger operand is upcast one panel of `block_rows` rows at a
    time (rows of `a` if it is the larger, else rows of `b`, the
    contraction dimension), so a V-sized operand never gets a float32
    copy; the panels change only the float32 summation order."""
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.numel() >= b.numel():
        bf = b.float()
        out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32,
                          device=a.device)
        for s in range(0, a.shape[0], block_rows):
            out[s:s + block_rows] = a[s:s + block_rows].float() @ bf
        return out
    af = a.float()
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for s in range(0, b.shape[0], block_rows):
        out += af[:, s:s + block_rows] @ b[s:s + block_rows].float()
    return out


def mu_update_frobenius_bf16v(Vb, W, H, eps=1e-9, order="WH"):
    """MU (Frobenius) against a bfloat16-stored V: the two O(nmr)
    numerators contract bf16 operands into float32; everything else stays
    in W/H's dtype. Plain torch, no kernel."""

    def upd_w(W, H):
        numer = _bf16_dot(Vb, H.T).to(W.dtype)      # V H^T (n, r)
        return W * (numer / (W @ (H @ H.T) + eps))

    def upd_h(W, H):
        numer = _bf16_dot(W.T, Vb).to(W.dtype)      # W^T V (r, m)
        return H * (numer / ((W.T @ W) @ H + eps))

    if order == "jacobi":
        return _jacobi_fro_apply(
            W, H, _bf16_dot(Vb, H.T).to(W.dtype),
            _bf16_dot(W.T, Vb).to(W.dtype), W.T @ W, H @ H.T, eps,
        )
    return _apply_order(upd_w, upd_h, W, H, order)


# ---------------------------------------------------------------------------
# int8 x int8 MU: V stored int8 once, the factor operand of each big
# contraction requantized per call, int32 sums, both scales after
# ---------------------------------------------------------------------------


def quantize_sym(X, clip=127.0):
    """Symmetric per-matrix int8 quantization: X ~= scale * Xq. Returns
    (scale float32 0-dim, Xq int8). Bit-equal to ``nmftpu``'s: the scale
    is computed in X's type, and ``torch.round`` rounds half to even like
    ``jnp.round``."""
    scale = torch.clamp(X.abs().amax() / clip, min=1e-30)
    Xq = torch.clamp(torch.round(X / scale), -clip, clip).to(torch.int8)
    return scale.to(torch.float32), Xq


def quantize_sym_t(X, clip=127.0):
    """`quantize_sym` of X (n, r) with Xq emitted transposed, (r, n) and
    contiguous, as the int8 kernels take the W side: the same scale and
    the same integers bit for bit (the same elementwise operations, with
    the quotient written in the transposed layout)."""
    scale = torch.clamp(X.abs().amax() / clip, min=1e-30)
    Xt = torch.empty((X.shape[1], X.shape[0]), dtype=X.dtype,
                     device=X.device)
    torch.div(X.T, scale, out=Xt)
    Xq = torch.clamp(torch.round(Xt), -clip, clip).to(torch.int8)
    return scale.to(torch.float32), Xq


def _rhs_vht_int8(Vq, scale_v, X):
    """V·Xᵀ (n, r) with int8 V: X requantized per call, int8 × int8 →
    int32 (``kernels.dual_numer.vht_int8``), both scales after."""
    from nmftpu_torch.kernels import dual_numer as DN

    s_x, Xq = quantize_sym(X)
    return DN.vht_int8(Vq, Xq).to(torch.float32) * (scale_v * s_x)


def _rhs_wtv_int8(Vq, scale_v, X):
    """Xᵀ·V (r, m) with int8 V; X (n, r) requantized per call."""
    from nmftpu_torch.kernels import dual_numer as DN

    s_x, XqT = quantize_sym_t(X)
    return DN.wtv_int8(Vq, XqT).to(torch.float32) * (scale_v * s_x)


def mu_update_frobenius_int8x8(Vq, scale_v, W, H, eps=1e-9, order="WH",
                               use_fused=False):
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
        numer = _rhs_vht_int8(Vq, scale_v, H)
        return W * (numer / (W @ (H @ H.T) + eps))

    def upd_h(W, H):
        numer = _rhs_wtv_int8(Vq, scale_v, W)
        return H * (numer / ((W.T @ W) @ H + eps))

    if order == "jacobi":
        if use_fused:
            from nmftpu_torch.kernels import dual_numer as DN

            numer_w, numer_h = DN.dual_numerators_int8(Vq, scale_v, W, H)
        else:
            numer_w = _rhs_vht_int8(Vq, scale_v, H)
            numer_h = _rhs_wtv_int8(Vq, scale_v, W)
        return _jacobi_fro_apply(
            W, H, numer_w, numer_h, W.T @ W, H @ H.T, eps,
        )
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
                l1_w=0.0, l1_h=0.0, block=16, impl="auto"):
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
        return half(V @ H.T - l1_w, H @ H.T + l2_w * eye, W)

    def sweep_h(W, H):
        return half(V.T @ W - l1_h, W.T @ W + l2_h * eye, H.T).T.contiguous()

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
