"""Fused dense MU half-steps (port of ``nmftpu/kernels/dense_mu.py``).

One Lee–Seung half-step for W is
    W <- W * (V H^T) / (W G + eps),   G = H H^T,
and for H
    H <- H * (W^T V) / (G H + eps),   G = W^T W.
Each is one hand-written CUDA kernel (``csrc/dense_mu.cu``) on the tensor
cores: float32 operands split into tf32 hi and lo parts as their tiles are
staged (hi·hi + hi·lo + lo·hi, float32 accuracy; the source states the
precision argument and what bounds the kernel). A block owns 64 rows of V
(the W step) or 64 columns (the H step) and all r factors up to 256 (128
rows or columns when r <= 64), so V is read once; the numerator never
reaches device memory except as the partial sums of a split depth
(`mu_splits`), which the last block of a tile adds in split order before
the Gram denominator and the multiply/divide epilogue, the only store. `fused_multiply_divide`, the
elementwise X * numer / (denom + eps) on its own, is a third kernel
(``csrc/muldiv.cu``). On one device no update calls it; on a mesh that
tiles V (``parallel.dense_mesh``) a half-step whose numerator spans
ranks sums it first and applies the epilogue here.

Beside each wrapper is its plain torch twin (``*_plain``), the same
function written with ``torch.matmul``. A wrapper runs the twin only when
its tensors lie on the CPU; for CUDA tensors it launches the kernel or
raises. ``LAUNCHES`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import torch

from nmftpu_torch.kernels import _build
from nmftpu_torch.linalg.dense import LOCAL, _apply_order

LAUNCHES = {"w_update_fused": 0, "h_update_fused": 0,
            "fused_multiply_divide": 0}


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


# the kernel's depth stage, the most stages in one split's promoted sum,
# and the SMs of an H100 (the split rule's default)
MU_STAGE, MU_MAX_STAGES, H100_SMS = 16, 512, 132


def mu_tile(r):
    """(rows, factors, blocks an SM) of one block of the kernel: 128 rows
    and 64 factors for r <= 64, else 64 rows and 256 factors (`Cfg` in
    ``csrc/dense_mu.cu``; the two must agree)."""
    return (128, 64, 2) if r <= 64 else (64, 256, 1)


def mu_splits(rows, depth, r, sms=H100_SMS):
    """How many parts the kernel splits a half-step's depth into: `rows`
    is the product's row count (n for the W step, m for the H step),
    `depth` its contraction (m, n). At least enough that no split is
    deeper than MU_MAX_STAGES stages (its promoted float32 sum stays
    short); then, with fewer blocks than about two waves of the card, the
    fewest splits that give two waves, or one wave at least 90% full,
    each split at least 16 stages deep. Every split is non-empty (the
    kernel checks)."""
    tile_rows, cols, per_sm = mu_tile(r)
    base = -(-rows // tile_rows) * -(-r // cols)
    slots = sms * per_sm
    stages = -(-depth // MU_STAGE)
    least = -(-stages // MU_MAX_STAGES)
    best = least
    for s in range(least, max(least, stages // 16) + 1):
        per = -(-stages // s)
        best = -(-stages // per)
        blocks = base * best
        waves = -(-blocks // slots)
        if blocks >= 2 * slots or (blocks >= 0.9 * slots
                                   and blocks >= 0.9 * waves * slots):
            break
    return best


def launch(entry, what, counts, V, scale, W, H, G, out, eps):
    """Launch one C entry of the library on the current stream of V's
    device, raise on a launch error, and count the launch. The split
    depth's workspace (splits x rows x r float32 partials) and its
    arrival counters (zeroed) are allocated here."""
    n, m = V.shape
    r = H.shape[0]
    # the H step's product is (m, r) over depth n, the W step's (n, r)
    rows, depth = (m, n) if entry.startswith("nmftpu_h_") else (n, m)
    splits = mu_splits(rows, depth, r,
                       torch.cuda.get_device_properties(V.device)
                       .multi_processor_count)
    ws = torch.empty(splits * rows * r, dtype=torch.float32, device=V.device)
    tile_rows, cols, _ = mu_tile(r)
    counters = torch.zeros(-(-rows // tile_rows) * -(-r // cols),
                           dtype=torch.int32, device=V.device)
    _build.launch(
        entry, what, V.device,
        V.data_ptr(), None if scale is None else scale.data_ptr(),
        W.data_ptr(), H.data_ptr(), G.data_ptr(), out.data_ptr(),
        ws.data_ptr(), counters.data_ptr(), n, m, r, splits, float(eps),
    )
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


# ---------------------------------------------------------------------------
# Standalone fused multiply-divide (csrc/muldiv.cu); no update path calls
# it, as in nmftpu
# ---------------------------------------------------------------------------

_MULDIV_ENTRIES = {torch.float32: "nmftpu_muldiv_f32",
                   torch.float64: "nmftpu_muldiv_f64"}


def fused_multiply_divide_plain(X, numer, denom, eps=1e-9):
    """X * numer / (denom + eps)."""
    return X * numer / (denom + eps)


def fused_multiply_divide(X, numer, denom, eps=1e-9):
    """X * numer / (denom + eps) in one elementwise pass, bit-equal to the
    plain version; three tensors of one shape and dtype (float32 or
    float64 on CUDA). Returns a new tensor."""
    if not X.shape == numer.shape == denom.shape:
        raise ValueError(
            "fused_multiply_divide: X, numer and denom must have one shape; "
            f"got {tuple(X.shape)}, {tuple(numer.shape)}, "
            f"{tuple(denom.shape)}")
    if _on_cpu(X, numer, denom):
        return fused_multiply_divide_plain(X, numer, denom, eps)
    if not X.dtype == numer.dtype == denom.dtype or \
            X.dtype not in _MULDIV_ENTRIES:
        raise TypeError(
            "fused_multiply_divide: X, numer and denom must all be float32 "
            f"or all float64; got {X.dtype}, {numer.dtype}, {denom.dtype}")
    for name, t in (("X", X), ("numer", numer), ("denom", denom)):
        if not t.is_contiguous():
            raise ValueError(f"fused_multiply_divide: {name} must be "
                             "contiguous")
    out = torch.empty_like(X)
    _build.launch(_MULDIV_ENTRIES[X.dtype], "fused_multiply_divide",
                  X.device, X.data_ptr(), numer.data_ptr(), denom.data_ptr(),
                  out.data_ptr(), X.numel(), float(eps))
    LAUNCHES["fused_multiply_divide"] += 1
    return out


def mu_update_frobenius_fused(V, W, H, eps=1e-9, order="WH", sums=LOCAL):
    """One full MU (Frobenius) iteration with the fused half-step kernels;
    the (r, r) Grams are plain torch.matmul. Semantics identical to
    nmftpu_torch.linalg.dense.mu_update_frobenius. A half-step that is
    not local to this tile (`sums`) sums its numerator over the ranks
    and ends on `fused_multiply_divide`. Returns new tensors."""

    def upd_w(W, H):
        G = sums.cols(H @ H.T)
        if sums.local_w:
            return w_update_fused(V, W, H, G, eps=eps)
        return fused_multiply_divide(W, sums.cols(V @ H.T), W @ G, eps=eps)

    def upd_h(W, H):
        G = sums.rows(W.T @ W)
        if sums.local_h:
            return h_update_fused(V, W, H, G, eps=eps)
        return fused_multiply_divide(H, sums.rows(W.T @ V), G @ H, eps=eps)

    return _apply_order(upd_w, upd_h, W, H, order)
