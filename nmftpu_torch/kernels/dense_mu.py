"""Fused dense MU half-steps (port of ``nmftpu/kernels/dense_mu.py``).

One Lee–Seung half-step for W is
    W <- W * (V H^T) / (W G + eps),   G = H H^T,
and for H
    H <- H * (W^T V) / (G H + eps),   G = W^T W.
Each is one hand-written CUDA kernel (``csrc/dense_mu.cu``): the numerator
GEMM accumulates in registers, the block applies the Gram denominator over
the full rank, and the multiply/divide epilogue runs before the only
store, so the numerator never reaches device memory. The kernels compute
in float32 on the CUDA cores; the source states the precision contract and
what bounds them.

Beside each wrapper is its plain torch twin (``*_plain``), the same
function written with ``torch.matmul``. A wrapper runs the twin only when
its tensors lie on the CPU; for CUDA tensors it launches the kernel or
raises. ``LAUNCHES`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import torch

from nmftpu_torch.kernels import _build
from nmftpu_torch.linalg.dense import _apply_order

LAUNCHES = {"w_update_fused": 0, "h_update_fused": 0}


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (plain twin); False when
    all lie on one CUDA device (kernel). Anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    (device,) = devices
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return False


def _check_shapes(what, V, W, H, G):
    if V.ndim != 2 or W.ndim != 2 or H.ndim != 2 or G.ndim != 2:
        raise ValueError(f"{what}: V, W, H and G must be 2-D")
    n, m = V.shape
    r = H.shape[0]
    if W.shape != (n, r) or H.shape != (r, m) or G.shape != (r, r):
        raise ValueError(
            f"{what}: expected V (n, m), W (n, r), H (r, m), G (r, r); got "
            f"V {tuple(V.shape)}, W {tuple(W.shape)}, H {tuple(H.shape)}, "
            f"G {tuple(G.shape)}"
        )
    return n, m, r


def _check_cuda_operands(what, V, v_dtype, W, H, G, scale=None):
    """What the CUDA entries take: V of `v_dtype`, float32 factors and
    Gram, every operand contiguous, every extent in [1, 2**31)."""
    n, m, r = _check_shapes(what, V, W, H, G)
    if V.dtype != v_dtype:
        raise TypeError(f"{what}: V must be {v_dtype}, got {V.dtype}")
    for name, t in (("W", W), ("H", H), ("G", G)):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
    if scale is not None and (scale.dtype != torch.float32
                              or scale.numel() != 1):
        raise TypeError(f"{what}: scale must be one float32 value")
    for name, t in (("V", V), ("W", W), ("H", H), ("G", G)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if min(n, m, r) < 1 or max(n, m, r) >= 2**31:
        raise ValueError(f"{what}: extents must lie in [1, 2**31), got "
                         f"n={n}, m={m}, r={r}")
    return n, m, r


def launch(entry, what, counts, V, scale, W, H, G, out, eps):
    """Launch one C entry of the library on the current stream of V's
    device, raise on a launch error, and count the launch."""
    n, m = V.shape
    r = H.shape[0]
    lib = _build.load()
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream(V.device).cuda_stream
        rc = getattr(lib, entry)(
            V.data_ptr(), None if scale is None else scale.data_ptr(),
            W.data_ptr(), H.data_ptr(), G.data_ptr(), out.data_ptr(),
            n, m, r, float(eps), stream,
        )
    _build.check(rc, what)
    counts[what] += 1
    return out


# ---------------------------------------------------------------------------
# Plain twins: the same functions in torch.matmul.
# ---------------------------------------------------------------------------


def w_update_fused_plain(V, W, H, G, eps=1e-9):
    """W * (V H^T) / (W G + eps)."""
    return W * (V @ H.T) / (W @ G + eps)


def h_update_fused_plain(V, W, H, G, eps=1e-9):
    """H * (W^T V) / (G H + eps)."""
    return H * (W.T @ V) / (G @ H + eps)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def w_update_fused(V, W, H, G, eps=1e-9):
    """W * (V H^T) / (W G + eps) in one kernel; G (r, r) = H H^T.
    V (n, m), W (n, r), H (r, m). Returns a new (n, r) tensor."""
    if _on_cpu(V, W, H, G):
        _check_shapes("w_update_fused", V, W, H, G)
        return w_update_fused_plain(V, W, H, G, eps)
    _check_cuda_operands("w_update_fused", V, torch.float32, W, H, G)
    return launch("nmftpu_w_update_f32", "w_update_fused", LAUNCHES,
                  V, None, W, H, G, torch.empty_like(W), eps)


def h_update_fused(V, W, H, G, eps=1e-9):
    """H * (W^T V) / (G H + eps) in one kernel; G (r, r) = W^T W.
    V (n, m), W (n, r), H (r, m). Returns a new (r, m) tensor."""
    if _on_cpu(V, W, H, G):
        _check_shapes("h_update_fused", V, W, H, G)
        return h_update_fused_plain(V, W, H, G, eps)
    _check_cuda_operands("h_update_fused", V, torch.float32, W, H, G)
    return launch("nmftpu_h_update_f32", "h_update_fused", LAUNCHES,
                  V, None, W, H, G, torch.empty_like(H), eps)


def mu_update_frobenius_fused(V, W, H, eps=1e-9, order="WH"):
    """One full MU (Frobenius) iteration with the fused half-step kernels;
    the (r, r) Grams are plain torch.matmul. Semantics identical to
    nmftpu_torch.linalg.dense.mu_update_frobenius. Returns new tensors."""
    return _apply_order(
        lambda W, H: w_update_fused(V, W, H, H @ H.T, eps=eps),
        lambda W, H: h_update_fused(V, W, H, W.T @ W, eps=eps),
        W, H, order,
    )
