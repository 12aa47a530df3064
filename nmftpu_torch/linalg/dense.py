"""Dense MU-Frobenius update rules and error metrics, plain torch (port of
the matching subset of ``nmftpu/linalg/dense.py``).

Conventions
-----------
V : (n, m)  nonnegative data ("users" x "items")
W : (n, r)  left factor  (user embeddings)
H : (r, m)  right factor (item embeddings)

Every update returns new tensors. The large products are ``torch.matmul``
(on the card: cuBLAS, full float32 while TF32 is off), as ``nmftpu``
leaves them to XLA. The epsilon guard is added to the denominators.
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
    classic Lee–Seung presentation. The "jacobi" coupling is not ported
    yet (the registry raises for it)."""
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


def mu_update_frobenius(V, W, H, eps=1e-9, order="WH"):
    """One full MU iteration under the Frobenius objective."""
    return _apply_order(
        lambda W, H: mu_update_w_frobenius(V, W, H, eps),
        lambda W, H: mu_update_h_frobenius(V, W, H, eps),
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

    return _apply_order(upd_w, upd_h, W, H, order)


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
