"""The HALS half-sweep as a hand-written CUDA kernel (port of
``nmftpu/kernels/hals_sweep.py``).

One HALS half-step is a cyclic Gauss–Seidel sweep over the r columns of W:

    for t in 0..r:  W[:, t] <- max(W[:, t] - (W G[:, t] - XHt[:, t]) / G[t, t], 0)

sequential in t and independent across rows. The kernel
(``csrc/hals_sweep.cu``) gives each block TR rows of W (32 at r = 256),
kept in shared memory for the whole sweep, and streams G's column panels
through a two-buffer cp.async ring, blocked like
``linalg.dense._hals_half_sweep_blocked``: a (TR x b) gradient base of
depth r, summed by each thread over a 4 x 4 tile and a slice of the depth
quads and then across the slices in order, then the b-step chain with
rank-1 corrections, in registers, multiplying by the hessian's reciprocal
where the blocked sweep divides.

Not carried over from the TPU version: the transposed (r, tile_n) layout
and the host-built stack of transposed diagonal blocks (``GbbT``), the
VMEM budget and tile choice, the padding of r to a block multiple.

`hals_sweep_plain` is the same function in torch (the blocked sweep);
`hals_sweep` runs it only for CPU tensors, and for CUDA tensors launches
the kernel or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from nmftpu_torch.kernels import _build
from nmftpu_torch.kernels.dense_mu import _on_cpu

LAUNCHES = {"hals_sweep": 0}

# the widest column block the kernel takes
MAX_BLOCK = 16
# the largest rank: four rows of W (each r floats, padded to 4 mod 8
# quads) beside G's panels and the partial bases (51,264 bytes) in a
# block's 232,448 bytes of shared memory
MAX_RANK = 11_324


def _check_shapes(XHt, G, W):
    if (W.ndim != 2 or XHt.shape != W.shape
            or G.shape != (W.shape[1], W.shape[1])):
        raise ValueError(
            "hals_sweep: expected XHt and W (n, r) and G (r, r); got XHt "
            f"{tuple(XHt.shape)}, G {tuple(G.shape)}, W {tuple(W.shape)}")


def _check_cuda_operands(XHt, G, W, block):
    """What the CUDA entry takes: float32, contiguous, extents in
    [1, 2**31), r <= MAX_RANK, block in [1, MAX_BLOCK]."""
    for name, t in (("XHt", XHt), ("G", G), ("W", W)):
        if t.dtype != torch.float32:
            raise TypeError(f"hals_sweep: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"hals_sweep: {name} must be contiguous")
    n, r = W.shape
    if min(n, r) < 1 or max(n, r) >= 2**31:
        raise ValueError(f"hals_sweep: extents must lie in [1, 2**31), got "
                         f"n={n}, r={r}")
    if r > MAX_RANK:
        raise ValueError(f"hals_sweep: rank {r} exceeds the kernel's "
                         f"{MAX_RANK}")
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"hals_sweep: block must lie in [1, {MAX_BLOCK}], "
                         f"got {block}")


def hals_sweep_plain(XHt, G, W, block=16):
    """The blocked half-sweep in torch (``linalg.dense.
    _hals_half_sweep_blocked``)."""
    from nmftpu_torch.linalg.dense import _hals_half_sweep_blocked

    _check_shapes(XHt, G, W)
    return _hals_half_sweep_blocked(XHt, G, W, block=block)


def hals_sweep(XHt, G, W, block=16):
    """One blocked Gauss–Seidel HALS half-sweep of W (n, r) against XHt
    (n, r) (V Hᵀ - l1, or Vᵀ W - l1) and the Gram G (r, r) (+ l2 on its
    diagonal), in one kernel launch. Returns a new (n, r) tensor; the
    same update as ``linalg.dense._hals_half_sweep`` in exact arithmetic,
    float32 roundoff apart."""
    if _on_cpu(XHt, G, W):
        return hals_sweep_plain(XHt, G, W, block=block)
    _check_shapes(XHt, G, W)
    _check_cuda_operands(XHt, G, W, block)
    n, r = W.shape
    out = torch.empty_like(W)
    _build.launch("nmftpu_hals_sweep_f32", "hals_sweep", W.device,
                  XHt.data_ptr(), G.data_ptr(), W.data_ptr(), out.data_ptr(),
                  n, r, block)
    LAUNCHES["hals_sweep"] += 1
    return out
