"""The per-row ridged solves of the iALS family as one hand-written CUDA
kernel (#12, ``csrc/row_solve.cu`` ``row_chol_solve_kernel``).

`solve_rows(G, dG, rhs, shift, eps)` returns, for every row i,

    x_i = max(0, (G + dG_i + rho_i I)^-1 rhs_i),
    rho_i = shift + eps + max(eps, 100 · 2^-23) · tr(G + dG_i) / r,

the systems and the ridge of ``linalg.dense._ridged`` (G the shared
(r, r) base Gram, or None). It is one launch for all rows of CUDA
tensors: each row's lower triangle is read once, factored (a Cholesky of
the system bordered by rhs, which carries the forward substitution) and
solved in shared memory and registers, and only x is written; no
inverse and no (rows, r, r) intermediate exists. It replaces no TPU
kernel: ``nmftpu`` leaves these solves to XLA's batched Cholesky.

``sparse_ops._row_solver``'s exact solver is the one place that routes:
it calls `solve_rows` where `takes` holds (CUDA, float32, r <=
`ROW_SOLVE_MAX_RANK`) and otherwise runs the plain path, its panel loop
over ``linalg.dense._batched_solve_clamped``. `solve_rows` raises on
anything the kernel does not take. ``LAUNCHES["row_solve"]`` counts the
launches, one per call.
"""

from __future__ import annotations

import torch

from nmftpu_torch.kernels import _build

LAUNCHES = {"row_solve": 0}

# a 16 x 16 block of threads holds a system of up to 8 x 16 rows
ROW_SOLVE_MAX_RANK = 128

# linalg.dense._ridged's relative floor for float32 systems
_RIDGE_FLOOR = 100.0 * torch.finfo(torch.float32).eps


def takes(device, dtype, r) -> bool:
    """Whether `solve_rows` launches the kernel for rows of width r in
    `dtype` on `device`."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and r <= ROW_SOLVE_MAX_RANK)


def _check(G, dG, rhs):
    """What #12 takes: float32 dG (rows, r, r) and rhs (rows, r) whose
    rows may lie at any stride but are each contiguous, G (r, r) or None,
    1 <= r <= `ROW_SOLVE_MAX_RANK`."""
    tensors = (dG, rhs) if G is None else (dG, rhs, G)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("solve_rows: G, dG and rhs must be float32, got "
                        f"{[t.dtype for t in tensors]}")
    if rhs.ndim != 2 or dG.ndim != 3:
        raise ValueError(f"solve_rows: expected dG (rows, r, r) and rhs "
                         f"(rows, r), got {tuple(dG.shape)}, "
                         f"{tuple(rhs.shape)}")
    rows, r = rhs.shape
    if dG.shape != (rows, r, r) or (G is not None and G.shape != (r, r)):
        raise ValueError(
            f"solve_rows: dG {tuple(dG.shape)} and G "
            f"{None if G is None else tuple(G.shape)} do not match rhs "
            f"{tuple(rhs.shape)}")
    if not 1 <= r <= ROW_SOLVE_MAX_RANK:
        raise ValueError(
            f"solve_rows: r = {r} outside 1..{ROW_SOLVE_MAX_RANK}")
    if (dG.stride(1), dG.stride(2)) != (r, 1) or rhs.stride(1) != 1 or \
            dG.stride(0) < r * r or rhs.stride(0) < r:
        raise ValueError("solve_rows: each row's system and right-hand side "
                         "must be contiguous")


def solve_rows(G, dG, rhs, shift, eps):
    """(rows, r) float32: every row's ridged solve, clamped at 0; NaN for
    a row whose system is not positive definite. One launch of #12; a
    raise for tensors off one CUDA device or what `_check` refuses."""
    tensors = (dG, rhs) if G is None else (dG, rhs, G)
    if any(t.device != rhs.device for t in tensors) or \
            rhs.device.type != "cuda":
        raise ValueError("solve_rows: G, dG and rhs must be on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    _check(G, dG, rhs)
    rows, r = rhs.shape
    out = torch.empty((rows, r), dtype=torch.float32, device=rhs.device)
    if rows:
        # the kernel reads G's lower triangle through its transpose, so
        # that a warp's 16 rows of one column are one coalesced read
        Gt = None if G is None else G.T.contiguous()
        _build.launch("nmftpu_row_solve_f32", "row_solve", rhs.device,
                      None if Gt is None else Gt.data_ptr(), dG.data_ptr(),
                      rhs.data_ptr(), out.data_ptr(), rows, r, dG.stride(0),
                      rhs.stride(0), shift + eps, max(eps, _RIDGE_FLOOR))
        LAUNCHES["row_solve"] += 1
    return out
