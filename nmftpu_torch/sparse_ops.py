"""Sparse NMF on one device (port of the MU Frobenius/KL subset of
``nmftpu/sparse_ops.py``): the scatter-COO engine, sparse init, and the
driver that routes sparse V to the scatter, ELL or densified engine.

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

Ported: the MU algorithm under the Frobenius and KL objectives on the
`scatter`, `ell` (with `use_pallas=True`: the CUDA ELL SpMM kernel) and
`densified` (bf16 V) engines, and the copy, random and mean_columns
inits. Everything else raises NotImplementedError naming its part of
ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

import numpy as np
import torch

from nmftpu_torch import sparse as host_sparse
from nmftpu_torch.config import (
    Algorithm,
    Initialization,
    NmfConfig,
    Objective,
    resolve_dtype,
)
from nmftpu_torch.driver import _resolve_device
from nmftpu_torch.init import run_generator
from nmftpu_torch.linalg.dense import _apply_order
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


def _scatter_acc_dtype(dtype):
    """Scatter-add accumulators run at >= float32: thousands of
    contributions per row or column would vanish below a bf16 running
    sum's ulp. float64 stays float64."""
    return torch.promote_types(dtype, torch.float32)


def wt_v(coo: DeviceCOO, W) -> torch.Tensor:
    """Wᵀ V -> (r, m): scatter v_k · W[row_k, :] into column col_k."""
    acc_dt = _scatter_acc_dtype(W.dtype)
    acc = torch.zeros((coo.shape[1], W.shape[1]), dtype=acc_dt,
                      device=W.device)
    for v, rr, cc in _chunks(coo):
        contrib = v[:, None] * W.index_select(0, rr)
        acc.index_add_(0, cc, contrib.to(acc_dt))
    return acc.T.to(W.dtype)


def v_ht(coo: DeviceCOO, H) -> torch.Tensor:
    """V Hᵀ -> (n, r): scatter v_k · H[:, col_k] into row row_k."""
    Ht = H.T.contiguous()
    acc_dt = _scatter_acc_dtype(H.dtype)
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
    acc_dt = _scatter_acc_dtype(coo.values.dtype)
    acc = torch.zeros(coo.shape[1], dtype=acc_dt, device=coo.values.device)
    for v, _, cc in _chunks(coo):
        acc.index_add_(0, cc, v.to(acc_dt))
    return acc


# ---------------------------------------------------------------------------
# Sparse error metrics
# ---------------------------------------------------------------------------


def _sum_v_sq(coo: DeviceCOO) -> torch.Tensor:
    vv = coo.values.to(_scatter_acc_dtype(coo.values.dtype))
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


def _unported(what: str, where: str):
    raise NotImplementedError(
        f"{what} is not ported to nmftpu_torch yet ({where} in "
        "ROADMAP.md); run it with nmftpu"
    )


def _check_ported(config: NmfConfig) -> None:
    """Raise NotImplementedError for a sparse configuration outside the
    ported MU Frobenius/KL engines."""
    if config.algorithm is not Algorithm.MU:
        _unported(f"algorithm={config.algorithm.value!r} on sparse V",
                  "slice 4")
    if config.mask == "observed":
        _unported("mask='observed' (masked completion)", "slice 3")
    if config.alpha_confidence > 0.0:
        _unported("confidence weighting (alpha_confidence > 0)", "slice 3")
    if config.objective is Objective.BETA:
        _unported("objective='beta-divergence' on sparse V", "slice 3")
    if config.v_storage == "int8":
        _unported("v_storage='int8' (densify_quantized)",
                  "slice 3 item 9")


def build_sparse_update(config: NmfConfig):
    """(make_aux, update, effective_h) for the scatter engine: MU under
    the Frobenius or the KL objective."""
    _check_ported(config)
    eps = config.eps
    order = config.update_order
    upd = (mu_update_frobenius_sparse
           if config.objective is Objective.FROBENIUS
           else mu_update_kl_sparse)
    return (
        lambda coo: (),
        lambda coo, aux, W, H: upd(coo, W, H, eps=eps, order=order),
        lambda aux, H: H,
    )


# ---------------------------------------------------------------------------
# Sparse initialization (without densifying V)
# ---------------------------------------------------------------------------


def sparse_initialize_factors(coo: DeviceCOO, rank, method: Initialization,
                              gen, W0=None, H0=None):
    """(W, H) on V's device in V's dtype for the copy, random and
    mean_columns inits; `gen` is the run's torch.Generator on that
    device. The random draws are the sklearn 'random' convention,
    (u + 1e-4) · sqrt(mean(V) / rank), as in ``nmftpu`` (not its
    bits)."""
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

    raise NotImplementedError(
        f"init {method.value!r} is not ported to nmftpu_torch yet "
        "(ROADMAP.md slice 4); use 'copy', 'random' or 'mean_columns'"
    )


# ---------------------------------------------------------------------------
# Engines' loop operations
# ---------------------------------------------------------------------------


def _sparse_ops_bundle(config: NmfConfig) -> LoopOps:
    make_aux, update, effective_h = build_sparse_update(config)
    return LoopOps(
        make_aux=make_aux,
        update=update,
        effective_h=effective_h,
        frobenius=lambda coo, aux, W, He, svsq: frobenius_error(
            coo, W, He, svsq),
        kl=lambda coo, aux, W, He: kl_error(coo, W, He),
        sum_v_sq=_sum_v_sq,
        numel=lambda coo: coo.shape[0] * coo.shape[1],
    )


def _densified_ops_bundle(config: NmfConfig, coo: DeviceCOO) -> LoopOps:
    from nmftpu_torch import densified as DF
    from nmftpu_torch.linalg import dense as D

    _check_ported(config)
    eps = config.eps
    order = config.update_order
    if config.objective is Objective.FROBENIUS:
        def update(Vd, aux, W, H):
            return D.mu_update_frobenius_bf16v(Vd, W, H, eps=eps,
                                               order=order)
    else:
        def update(Vd, aux, W, H):
            return DF.mu_update_kl_densified(Vd, W, H, eps=eps, order=order)
    n, m = coo.shape
    return LoopOps(
        make_aux=lambda Vd: (),
        update=update,
        effective_h=lambda aux, H: H,
        frobenius=lambda Vd, aux, W, He, svsq: DF.frobenius_error_densified(
            Vd, W, He, svsq),
        kl=lambda Vd, aux, W, He: DF.kl_error_densified(Vd, W, He),
        # from the bf16-rounded V, consistent with the bf16 cross term of
        # the Gram-trick error
        sum_v_sq=DF.sum_v_sq_densified,
        # the true n·m, not the row-padded shape: pad rows add no error
        numel=lambda Vd: n * m,
    )


def _ell_ops_bundle(config: NmfConfig) -> LoopOps:
    from nmftpu_torch import sparse_ell as SE

    _check_ported(config)
    eps = config.eps
    order = config.update_order
    wt_v = SE.wt_v_ell
    if config.use_pallas:
        from nmftpu_torch.kernels import sparse_ell_kernel as SEK

        # the error check's Wᵀ V on the kernel too (nmftpu leaves it to
        # XLA's gather): at ML-20M scale the plain one costs ten kernel
        # iterations
        wt_v = SEK.wt_v_ell_pallas
    if config.objective is Objective.KL:
        def update(pair, aux, W, H):
            return SE.mu_update_kl_ell(pair, W, H, eps=eps, order=order)
    elif config.use_pallas:
        # both SpMM directions on the hand-written CUDA kernel
        def update(pair, aux, W, H):
            return SEK.mu_update_frobenius_ell_pallas(pair, W, H, eps=eps,
                                                      order=order)
    else:
        def update(pair, aux, W, H):
            return SE.mu_update_frobenius_ell(pair, W, H, eps=eps,
                                              order=order)
    return LoopOps(
        make_aux=lambda pair: (),
        update=update,
        effective_h=lambda aux, H: H,
        frobenius=lambda pair, aux, W, He, svsq: SE.frobenius_error_ell(
            pair, W, He, svsq, wt_v=wt_v),
        kl=lambda pair, aux, W, He: SE.kl_error_ell(pair, W, He),
        sum_v_sq=lambda pair: SE.sum_v_sq_ell(pair.rows),
        numel=lambda pair: pair.shape[0] * pair.shape[1],
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
            )
            if n_pad != n:  # zero rows are absorbing under every rule
                W = torch.nn.functional.pad(W, (0, 0, 0, n_pad - n))
            return W, H

        result = execute(self.operand, config, runner, init_fn, numel=n * m)
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
    _check_ported(config)
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
      "densified" — scatter V once into dense bf16 and run dense updates
                    (blockwise for KL) whenever n·m·2 bytes fit;
      "ell"       — gather-only bucketed padded-segment layout; with
                    use_pallas=True the MU-Frobenius SpMMs run the CUDA
                    ELL kernel (kernels/sparse_ell_kernel.py);
      "auto"      — as ``nmftpu``: densified within DENSIFY_BUDGET_BYTES,
                    else ell; scatter for float64.

    Repeated factorizations of one matrix should call
    :func:`prepare_sparse` once and ``plan.run(...)`` per run: this
    function rebuilds the device layout on every call.
    """
    plan = prepare_sparse(V, config, strategy=strategy, device=device)
    return plan.run(W0=W0, H0=H0, callback=callback, interrupt=interrupt)
