"""int8 x int8 MU numerators as hand-written CUDA kernels (port of
``nmftpu/kernels/dual_numer.py`` and of the int8 contractions that
``nmftpu/linalg/dense.py`` leaves to XLA).

With V stored as int8 (V ~= scale_v * Vq) and the factors requantized per
call (``linalg.dense.quantize_sym``), the two MU numerators are integer
products summed in int32:

    numer_w = Vq Hqᵀ  (n, r) -> float32 * (scale_v * scale_h)
    numer_h = Wqᵀ Vq  (r, m) -> float32 * (scale_v * scale_w)

``csrc/dual_numer.cu`` has three entries on the int8 tensor cores
(``wgmma`` .s32.s8.s8): the dual one, which takes both from one stream of
V's tiles (Jacobi MU, ``use_pallas=True``), and two one-sided ones
(``vht_int8``, ``wtv_int8``), which serve the Gauss–Seidel int8 path,
whose second numerator needs the first half-step's factor. The W side
comes transposed, Wqᵀ (r, n), contiguous, so that both operands of Wqᵀ Vq
are K-major; ``linalg.dense.quantize_sym_t`` emits it directly. Integer
sums are exact and order-free, so the kernels, their twins and
``nmftpu``'s XLA contractions give the same int32 values bit for bit,
wrapping modulo 2**32 as XLA does once |sum| >= 2**31 (possible when the
contraction is longer than 133,143 = 2**31 / 127**2). The kernels add
into their outputs, so the wrappers allocate them zeroed.

The plain twins compute in float64, which is exact for these sums below
2**53 (``torch.matmul`` has no int32 GEMM on CUDA), over row panels so no
V-sized float64 copy exists, and then wrap to int32. A wrapper runs its
twin only for CPU tensors; for CUDA tensors it launches its kernel or
raises. ``LAUNCHES`` counts kernel launches per entry.

Not carried over from the TPU version: the (bn, bm) = (1024, 1024)
tiling that n and m had to divide, ``vmem_limit_bytes``, ``available()``.
"""

from __future__ import annotations

import torch

from nmftpu_torch.kernels import _build
from nmftpu_torch.kernels.dense_mu import _on_cpu
from nmftpu_torch.linalg.dense import LOCAL, _quantize_h, _quantize_wt

LAUNCHES = {"dual_numerators_int8": 0, "vht_int8": 0, "wtv_int8": 0}

# the twins upcast V to float64 this many rows at a time
_PANEL_ROWS = 8192


def _wrap_int32(x):
    """float64 holding exact integers -> int32, modulo 2**32 (int64 to
    int32 keeps the low 32 bits, as XLA's int32 sums wrap)."""
    return x.to(torch.int64).to(torch.int32)


def vht_exact(Vq, Xq):
    """Vq Xqᵀ (n, r) as exact float64 integers; Vq (n, m), Xq (r, m)
    int8."""
    Xd = Xq.double().T
    out = torch.empty((Vq.shape[0], Xq.shape[0]), dtype=torch.float64,
                      device=Vq.device)
    for s in range(0, Vq.shape[0], _PANEL_ROWS):
        out[s:s + _PANEL_ROWS] = Vq[s:s + _PANEL_ROWS].double() @ Xd
    return out


def wtv_exact(Vq, XqT):
    """XqT Vq (r, m) as exact float64 integers; Vq (n, m), XqT (r, n)
    int8."""
    out = torch.zeros((XqT.shape[0], Vq.shape[1]), dtype=torch.float64,
                      device=Vq.device)
    for s in range(0, Vq.shape[0], _PANEL_ROWS):
        out += (XqT[:, s:s + _PANEL_ROWS].double()
                @ Vq[s:s + _PANEL_ROWS].double())
    return out


def vht_int8_plain(Vq, Xq):
    """Vq Xqᵀ (n, r) in int32; Vq (n, m), Xq (r, m) int8."""
    return _wrap_int32(vht_exact(Vq, Xq))


def wtv_int8_plain(Vq, XqT):
    """XqT Vq (r, m) in int32; Vq (n, m), XqT (r, n) int8."""
    return _wrap_int32(wtv_exact(Vq, XqT))


def _check_shapes(what, Vq, WqT=None, Hq=None):
    n, m = Vq.shape if Vq.ndim == 2 else (None, None)
    bad = Vq.ndim != 2
    if WqT is not None:
        bad |= WqT.ndim != 2 or WqT.shape[1] != n
    if Hq is not None:
        bad |= Hq.ndim != 2 or Hq.shape[1] != m
    if WqT is not None and Hq is not None:
        bad |= WqT.shape[0] != Hq.shape[0]
    if bad:
        raise ValueError(
            f"{what}: expected Vq (n, m), Wqᵀ (r, n), Hq (r, m); got Vq "
            f"{tuple(Vq.shape)}"
            + ("" if WqT is None else f", Wqᵀ {tuple(WqT.shape)}")
            + ("" if Hq is None else f", Hq {tuple(Hq.shape)}"))


def _check_cuda_operands(what, *tensors):
    """What the CUDA entries take: int8 operands, contiguous, every extent
    in [1, 2**31)."""
    for t in tensors:
        if t.dtype != torch.int8:
            raise TypeError(f"{what}: operands must be int8, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
        if min(t.shape) < 1 or max(t.shape) >= 2**31:
            raise ValueError(f"{what}: extents must lie in [1, 2**31), got "
                             f"{tuple(t.shape)}")


def _launch(entry, what, Vq, WqT, Hq, *ptrs_and_dims):
    """Launch with the widest copies that the rows of V and Hq (stride m;
    gv) and of Wqᵀ (stride n; gw) allow."""
    n, m = Vq.shape
    gv = _build.copy_alignment(
        m, *(t.data_ptr() for t in (Vq, Hq) if t is not None))
    gw = 16 if WqT is None else _build.copy_alignment(n, WqT.data_ptr())
    _build.launch(entry, what, Vq.device, *ptrs_and_dims, gv, gw)
    LAUNCHES[what] += 1


def vht_int8(Vq, Hq):
    """Vq Hqᵀ -> (n, r) int32; Vq (n, m), Hq (r, m) int8."""
    _check_shapes("vht_int8", Vq, Hq=Hq)
    if _on_cpu(Vq, Hq):
        return vht_int8_plain(Vq, Hq)
    _check_cuda_operands("vht_int8", Vq, Hq)
    (n, m), r = Vq.shape, Hq.shape[0]
    out = torch.zeros((n, r), dtype=torch.int32, device=Vq.device)
    _launch("nmftpu_int8_vht", "vht_int8", Vq, None, Hq, Vq.data_ptr(),
            Hq.data_ptr(), out.data_ptr(), n, m, r)
    return out


def wtv_int8(Vq, WqT):
    """Wqᵀ Vq -> (r, m) int32; Vq (n, m), WqT = Wqᵀ (r, n) int8."""
    _check_shapes("wtv_int8", Vq, WqT=WqT)
    if _on_cpu(Vq, WqT):
        return wtv_int8_plain(Vq, WqT)
    _check_cuda_operands("wtv_int8", Vq, WqT)
    (n, m), r = Vq.shape, WqT.shape[0]
    out = torch.zeros((r, m), dtype=torch.int32, device=Vq.device)
    _launch("nmftpu_int8_wtv", "wtv_int8", Vq, WqT, None, Vq.data_ptr(),
            WqT.data_ptr(), out.data_ptr(), n, m, r)
    return out


def dual_int8_plain(Vq, WqT, Hq):
    """(Vq Hqᵀ, Wqᵀ Vq) in int32."""
    return vht_int8_plain(Vq, Hq), wtv_int8_plain(Vq, WqT)


def dual_int8(Vq, WqT, Hq):
    """(Vq Hqᵀ (n, r), Wqᵀ Vq (r, m)) in int32 from one kernel launch;
    Vq (n, m), WqT = Wqᵀ (r, n), Hq (r, m) int8."""
    _check_shapes("dual_numerators_int8", Vq, WqT, Hq)
    if _on_cpu(Vq, WqT, Hq):
        return dual_int8_plain(Vq, WqT, Hq)
    _check_cuda_operands("dual_numerators_int8", Vq, WqT, Hq)
    (n, m), r = Vq.shape, Hq.shape[0]
    # the kernel adds each block's share of both products
    nw = torch.zeros((n, r), dtype=torch.int32, device=Vq.device)
    nh = torch.zeros((r, m), dtype=torch.int32, device=Vq.device)
    _launch("nmftpu_int8_dual", "dual_numerators_int8", Vq, WqT, Hq,
            Vq.data_ptr(), WqT.data_ptr(), Hq.data_ptr(), nw.data_ptr(),
            nh.data_ptr(), n, m, r)
    return nw, nh


def _numerators(ints, Vq, scale_v, W, H, sums=LOCAL):
    scale_w, WqT = _quantize_wt(W, sums)
    scale_h, Hq = _quantize_h(H, sums)
    nw, nh = ints(Vq, WqT, Hq)
    return (sums.cols(nw).to(torch.float32) * (scale_v * scale_h),
            sums.rows(nh).to(torch.float32) * (scale_v * scale_w))


def dual_numerators_int8_plain(Vq, scale_v, W, H):
    """The twin of `dual_numerators_int8`, in torch."""
    return _numerators(dual_int8_plain, Vq, scale_v, W, H)


def dual_numerators_int8(Vq, scale_v, W, H, sums=LOCAL):
    """Both Jacobi-MU numerators from one pass over Vq's tiles.

    Vq (n, m) int8 with scale `scale_v` (V = scale_v * Vq); W (n, r) and
    H (r, m), quantized here per call. Returns (numer_w (n, r) ~= V Hᵀ,
    numer_h (r, m) ~= Wᵀ V), float32, both scales folded in. `sums` (a
    ``linalg.dense.Sums``, for a tile of V on a mesh) takes the factors'
    scales over the whole matrix and adds the int32 partials."""
    return _numerators(dual_int8, Vq, scale_v, W, H, sums)
