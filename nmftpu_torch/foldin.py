"""Fold-in / out-of-sample projection (port of ``nmftpu/foldin.py``): user
factors for new interaction rows against a fixed item table H.

``transform(V_new, H)`` learns only the (b, r) user block with H frozen,
so a user who appeared after training gets an embedding without touching
the trained table. The semantics are sklearn's ``NMF.transform`` (MU with
``update_H=False``).

With H fixed, the Frobenius numerator ``V Hᵀ`` and the Gram ``H Hᵀ`` are
loop-invariant: both are formed once, and each iteration is a few
(b, r) x (r, r) products. Sparse rows never read the whole table: the
numerators touch only the gathered rows ``Ht[cols]``, up-cast (and
scaled) per gathered row.

Algorithms:
  * ``mu``   — multiplicative updates, Frobenius, KL or generalized beta;
  * ``als``  — one-shot regularized nonnegative least squares (normal
    equations through ``linalg.dense.spd_solve``, then a clamp); with
    ``alpha_confidence`` the implicit-feedback weighted fold-in
    (Gram_u = HHᵀ + Σ_obs (c_i − 1) h_i h_iᵀ);
  * ``hals`` — W-only HALS sweeps (``linalg.dense.hals_half_sweep``: the
    CUDA sweep kernel for float32 tensors on the card).

The Gram of an int8 table is an int8 x int8 -> int32 contraction, run on
the one-sided entry of the int8 numerator kernel
(``kernels.dual_numer.vht_int8``) over panels short enough that no int32
sum wraps, and added exactly in int64 (`int8_gram`).

A table sharded over the items axis of a rank mesh
(`prepare_table_sharded`, a ``Recommender(mesh=)``'s) keeps each rank's
items: the Gram and row sums are each rank's own, summed over the axis
(an int8 Gram in int64, exact), and a gather of history rows takes each
row from the rank that owns it, assembled by a sum over the axis. The
solves then run replicated, with equal bits on every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nmftpu_torch._operands import _tensor
from nmftpu_torch.sparse import SparseMatrix

# #6 sums in int32, which wraps past 2**31 - 1: a panel of at most
# floor((2**31 - 1) / 127**2) = 133,144 items cannot, whatever its values
GRAM_PANEL_INT8 = 1 << 17
# a float table's Gram up-casts this many items at a time to float32
# (1 GB at r = 256), so a bf16 table never gets a whole float32 copy
GRAM_PANEL_FLOAT = 1 << 20


@dataclasses.dataclass(frozen=True)
class TransformResult:
    """Learned user block for a fixed item table."""

    W: torch.Tensor   # (b, rank) nonnegative user factors, on the device
    error: float      # objective at exit (Frobenius norm, KL or D_beta)
    rmsd: float       # Frobenius objective only; NaN for KL
    num_iterations: int


@dataclasses.dataclass(frozen=True)
class PreparedTable:
    """Loop-invariant per-table quantities for repeated fold-ins.

    ``Ht`` is the (m, r) transposed view of the table as it is stored,
    (r, m) in the table's dtype (a bf16 or int8 serving table is never
    up-cast in full, only its gathered rows are); ``G`` (r, r) and
    ``h_sum`` (r,) are float32, the int8 scale folded in."""

    Ht: torch.Tensor
    G: torch.Tensor
    h_sum: torch.Tensor
    # int8 tables: true H = scale * Ht.T (0-dim) or diag(scale) @ Ht.T
    # ((r,) per-dimension scales)
    scale: torch.Tensor | None = None
    # a sharded table: `Ht` holds this rank's items of the mesh's items
    # axis, the first of them item `offset`, of `n_items` in all
    mesh: object = None
    offset: int = 0
    n_items: int | None = None

    @property
    def shape(self):
        m, r = self.Ht.shape
        return r, (m if self.n_items is None else self.n_items)


def int8_gram(Hq, panel=GRAM_PANEL_INT8):
    """Hq Hqᵀ (r, r) of an int8 table Hq (r, m), exact, as int64: one
    launch of ``kernels.dual_numer.vht_int8`` per contiguous panel of
    `panel` items (int32 sums that cannot wrap), the panels added in
    int64."""
    from nmftpu_torch.kernels import dual_numer as DN

    r, m = Hq.shape
    G = torch.zeros((r, r), dtype=torch.int64, device=Hq.device)
    for lo in range(0, m, panel):
        P = Hq[:, lo:lo + panel].contiguous()
        G += DN.vht_int8(P, P)
    return G


def _float_gram(H, panel=GRAM_PANEL_FLOAT):
    """(H Hᵀ float32, row sums float64) of a float32 or bf16 table H
    (r, m), float32 panels of `panel` items at a time."""
    r, m = H.shape
    G = torch.zeros((r, r), dtype=torch.float32, device=H.device)
    h_sum = torch.zeros(r, dtype=torch.float64, device=H.device)
    for lo in range(0, m, panel):
        P = H[:, lo:lo + panel].float()
        G += P @ P.T
        h_sum += P.sum(dim=1)
    return G, h_sum


def prepare_table(H, scale=None, *, device=None) -> PreparedTable:
    """Precompute the table-invariant fold-in quantities once.

    H: the (rank, m) item table, float32, bfloat16 or int8 (a tensor, or
    an array placed on `device`; by default a tensor's own device, else
    CUDA). scale: for an int8 table, a scalar (true H = scale · H_int8)
    or a (rank,) vector of per-dimension scales (true H = diag(scale) @
    H_int8, the serving default); the Gram and the row sums fold it
    in."""
    from nmftpu_torch.driver import _resolve_device

    H = _tensor(H, _resolve_device(H, device))
    if H.ndim != 2:
        raise ValueError(f"H must be (rank, n_items), got shape "
                         f"{tuple(H.shape)}")
    if H.dtype.is_floating_point:
        G, h_sum = _float_gram(H)
        h_sum = h_sum.float()
    else:
        if scale is None:
            raise ValueError("an integer table needs its quantization "
                             "scale")
        G = int8_gram(H).double()
        # row sums per panel: a whole-table sum in int64 could stage an
        # int64 copy of the table (8 bytes an entry)
        h_sum = torch.zeros(H.shape[0], dtype=torch.int64, device=H.device)
        for lo in range(0, H.shape[1], GRAM_PANEL_INT8):
            h_sum += H[:, lo:lo + GRAM_PANEL_INT8].sum(dim=1,
                                                       dtype=torch.int32)
        h_sum = h_sum.double()
    if scale is None:
        return PreparedTable(Ht=H.T, G=G, h_sum=h_sum)
    sc = _tensor(scale, H.device, torch.float32)
    outer = sc[:, None] * sc[None, :] if sc.ndim == 1 else sc * sc
    return PreparedTable(Ht=H.T, G=(G * outer.to(G.dtype)).float(),
                         h_sum=(h_sum * sc.to(h_sum.dtype)).float(),
                         scale=sc)


def prepare_table_sharded(H, mesh, n_items: int, scale=None
                          ) -> PreparedTable:
    """`prepare_table` of a table sharded over the items axis of `mesh`:
    H (rank, n_items / shards) is this rank's slice, on its device. The
    Gram and the row sums are summed over the axis before the scale
    folds in, so an int8 table's are the unsharded ones bit for bit (the
    int64 Gram is exact in any order)."""
    from nmftpu_torch.parallel.mesh import AXIS_ITEMS, psum

    if H.dtype.is_floating_point:
        G, h_sum = _float_gram(H)
        G = psum(G, mesh, AXIS_ITEMS)
        h_sum = psum(h_sum, mesh, AXIS_ITEMS).float()
    else:
        if scale is None:
            raise ValueError("an integer table needs its quantization "
                             "scale")
        G = psum(int8_gram(H), mesh, AXIS_ITEMS).double()
        h_sum = torch.zeros(H.shape[0], dtype=torch.int64, device=H.device)
        for lo in range(0, H.shape[1], GRAM_PANEL_INT8):
            h_sum += H[:, lo:lo + GRAM_PANEL_INT8].sum(dim=1,
                                                       dtype=torch.int32)
        h_sum = psum(h_sum, mesh, AXIS_ITEMS).double()
    layout = dict(mesh=mesh, offset=mesh.get_local_rank(AXIS_ITEMS)
                  * H.shape[1], n_items=int(n_items))
    if scale is None:
        return PreparedTable(Ht=H.T, G=G, h_sum=h_sum, **layout)
    sc = _tensor(scale, H.device, torch.float32)
    outer = sc[:, None] * sc[None, :] if sc.ndim == 1 else sc * sc
    return PreparedTable(Ht=H.T, G=(G * outer.to(G.dtype)).float(),
                         h_sum=(h_sum * sc.to(h_sum.dtype)).float(),
                         scale=sc, **layout)


def _table_rows(prep, cols):
    """The table's rows for item ids `cols` (a 1-D int64 tensor), float32
    (nnz, r), scaled: only these rows are read and up-cast. On a sharded
    table each rank reads the rows it owns, zero the others, and a sum
    over the items axis assembles them (one owner per row, so the sum
    adds only zeros)."""
    if prep.mesh is None:
        rows = prep.Ht.T.index_select(1, cols).float().T.contiguous()
    else:
        from nmftpu_torch.parallel.mesh import AXIS_ITEMS, psum

        loc = cols - prep.offset
        own = (loc >= 0) & (loc < prep.Ht.shape[0])
        rows = prep.Ht.T.index_select(
            1, torch.where(own, loc, 0)).float().T.contiguous()
        rows = psum(rows * own[:, None], prep.mesh, AXIS_ITEMS)
    return rows if prep.scale is None else rows * prep.scale


def _table_f32(prep):
    """The whole table (r, m) in float32 (dense rows only; unscaled, as a
    scaled table takes sparse rows)."""
    return prep.Ht.T.float()


# ---------------------------------------------------------------------------
# W-only loops (the numerator inputs formed once, outside the loop)
# ---------------------------------------------------------------------------


def _mu_fro_w_loop(N, G, W, num_iterations, eps):
    """W ← W ⊙ N / (W G + eps), k times; N (b, r) and G (r, r) fixed."""
    for _ in range(num_iterations):
        W = W * (N / (W @ G + eps))
    return W


def _beta_w_loop_dense(V, H, W, num_iterations, beta):
    """Generalized-beta projection: k W-only MU steps with H fixed
    (``linalg.dense.beta_w_step`` and the beta < 1 stabilization of
    ``mu_update_beta``, W half only)."""
    from nmftpu_torch.linalg import dense as D

    gamma = D.beta_gamma(beta)
    for _ in range(num_iterations):
        W = D.beta_w_step(V, W, H, beta, gamma=gamma)
        if beta < 1.0:
            W = torch.where(W < D._STAB_EPS, 0.0, W)
    return W


def _mu_kl_w_loop_dense(V, Ht, h_sum, W, num_iterations, eps):
    """KL: W ← W ⊙ ((V/(WH)) Hᵀ) / h_sum, dense V (b, m)."""
    denom = h_sum[None, :] + eps
    for _ in range(num_iterations):
        W = W * (((V / (W @ Ht.T + eps)) @ Ht) / denom)
    return W


def _mu_kl_w_loop_sparse(vals, rows, Hc, h_sum, W, num_iterations, eps,
                         num_rows):
    """KL on sparse rows: the reconstruction is sampled only at the
    nonzeros (over the gathered rows Hc = Ht[cols]); zero entries of V add
    nothing to the KL numerator."""
    denom = h_sum[None, :] + eps
    for _ in range(num_iterations):
        pred = torch.sum(W[rows] * Hc, dim=1)
        ratio = vals / (pred + eps)
        numer = torch.zeros((num_rows, W.shape[1]), dtype=W.dtype,
                            device=W.device).index_add_(
            0, rows, ratio[:, None] * Hc)
        W = W * (numer / denom)
    return W


# ---------------------------------------------------------------------------
# Input plumbing
# ---------------------------------------------------------------------------


def _flat_nnz(data: SparseMatrix):
    csr = data.to_csr()
    b, m = csr.shape
    counts = np.diff(csr.indptr).astype(np.int64)
    rows = np.repeat(np.arange(b, dtype=np.int64), counts)
    return (rows, csr.indices.astype(np.int64), csr.data,
            np.asarray(csr.indptr, np.int64), (b, m))


def _init_w(b, r, seed, W0, device):
    """W0 as given (checked), or ``np.random.default_rng(seed)``'s
    uniform(0.1, 1.0) draw, the one ``nmftpu`` makes."""
    if W0 is not None:
        if isinstance(W0, torch.Tensor):
            W0 = W0.detach().cpu()
        W = np.asarray(W0, dtype=np.float32)
        if W.shape != (b, r):
            raise ValueError(f"W0 must be shape {(b, r)}, got {W.shape}")
        if (W < 0).any():
            raise ValueError("W0 must be nonnegative")
        return torch.tensor(W, device=device)
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0.1, 1.0, (b, r)),
                           dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Errors (the Gram trick keeps sparse error evaluation off the m axis)
# ---------------------------------------------------------------------------


def _fro_error_sparse(vals, rows, Hc, W, G, sum_v_sq):
    """‖V−WH‖ via ⟨V,WH⟩ sampled at the nonzeros + tr((WᵀW)(HHᵀ))."""
    pred = torch.sum(W[rows] * Hc, dim=1)
    cross = torch.sum(vals * pred)
    sq = sum_v_sq - 2.0 * cross + torch.sum((W.T @ W) * G)
    return torch.sqrt(torch.clamp(sq, min=0.0))


def _kl_error_sparse(vals, rows, Hc, W, h_sum, eps):
    """Σ_nz v·log(v/pred) − Σv + ΣWH (zero entries add only their WH
    mass)."""
    pred = torch.sum(W[rows] * Hc, dim=1)
    pos = torch.sum(vals * (torch.log(vals + eps) - torch.log(pred + eps)))
    return pos - torch.sum(vals) + torch.sum(W @ h_sum)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def transform(
    data,
    H,
    *,
    algorithm: str = "mu",
    objective: str = "frobenius",
    num_iterations: int = 100,
    eps: float = 1e-9,
    lambda_w: float = 0.0,
    alpha_confidence: float = 0.0,
    W0=None,
    seed: int = 0,
    beta: float | None = None,
    device=None,
) -> TransformResult:
    """Learn nonnegative user factors W for ``data`` ≈ W H with H fixed.

    data: dense (b, m) rows (array or tensor) or a sparse container of
    ``nmftpu_torch.sparse`` with b rows. H: the trained (rank, m) item
    table, or a :class:`PreparedTable` (which skips the per-call Gram).
    The computation runs on the table's device (`device` places an array
    H; by default CUDA). algorithm: ``"mu"`` (Frobenius, KL or beta
    objective), ``"als"`` (one-shot regularized least squares and a clamp;
    takes ``alpha_confidence``, c = 1 + alpha·v) or ``"hals"`` (W-only
    sweeps, Frobenius). lambda_w: the Tikhonov shift of the ALS normal
    equations and HALS's Gram. Rows with no interactions come back about
    zero under every rule. Returns a TransformResult whose W stays on the
    device."""
    from nmftpu_torch.linalg import dense as D

    prep = (H if isinstance(H, PreparedTable)
            else prepare_table(H, device=device))
    r, m = prep.shape
    dev = prep.G.device
    dtype = torch.float32
    G, h_sum = prep.G, prep.h_sum

    if algorithm not in ("mu", "als", "hals"):
        raise ValueError(
            f"algorithm must be mu|als|hals, got {algorithm!r}"
        )
    if objective not in ("frobenius", "kl", "beta"):
        raise ValueError(
            f"objective must be frobenius|kl|beta, got {objective!r}"
        )
    if objective == "beta":
        if beta is None:
            raise ValueError("objective='beta' needs the beta value")
        # the specialized loops are both faster and guard-identical
        if beta == 2.0:
            objective = "frobenius"
        elif beta == 1.0:
            objective = "kl"
    if algorithm in ("als", "hals") and objective != "frobenius":
        raise ValueError(
            f"{algorithm} transform supports the frobenius objective"
        )
    sparse_in = isinstance(data, SparseMatrix)
    if objective == "beta" and sparse_in:
        raise ValueError(
            "generalized-beta transform needs dense rows (the "
            "denominator samples the full reconstruction); densify "
            "the batch or use objective='kl'/'frobenius'"
        )
    if alpha_confidence and algorithm != "als":
        raise ValueError(
            "alpha_confidence weighting requires algorithm='als'"
        )

    b_in = data.shape[0] if hasattr(data, "shape") else len(data)
    if b_in == 0:  # an empty batch (e.g. an empty serving request)
        return TransformResult(
            W=torch.zeros((0, r), dtype=dtype, device=dev), error=0.0,
            rmsd=float("nan") if objective == "kl" else 0.0,
            num_iterations=0,
        )
    if sparse_in:
        rows_np, cols_np, vals_np, indptr_np, (b, m_in) = _flat_nnz(data)
        if m_in != m:
            raise ValueError(
                f"data has {m_in} columns but H has {m} items"
            )
        if cols_np.size:
            # a bad item id from a serving caller must fail here, not
            # read past the table
            lo, hi = int(cols_np.min()), int(cols_np.max())
            if lo < 0 or hi >= m:
                raise ValueError(
                    f"item index out of range: [{lo}, {hi}] vs {m} items"
                )
        if vals_np.size and float(vals_np.min()) < 0:
            raise ValueError("data must be nonnegative")
        rows = torch.as_tensor(rows_np, device=dev)
        vals = torch.as_tensor(vals_np, dtype=dtype, device=dev)
        Hc = _table_rows(prep, torch.as_tensor(cols_np, device=dev))
        N = torch.zeros((b, r), dtype=dtype, device=dev).index_add_(
            0, rows, vals[:, None] * Hc)
        sum_v_sq = torch.sum(vals * vals)
    else:
        if prep.mesh is not None:
            raise ValueError(
                "dense fold-in against a sharded table is not supported: "
                "pass sparse data (serving histories)")
        if prep.scale is not None:
            raise ValueError(
                "dense fold-in against a quantized table is not "
                "supported — pass sparse data (serving histories), or "
                "dequantize the table first"
            )
        V = _tensor(data, dev, dtype)
        if V.ndim != 2 or V.shape[1] != m:
            raise ValueError(f"data must be (b, {m}), got "
                             f"{tuple(V.shape)}")
        if bool((V < 0).any()):
            raise ValueError("data must be nonnegative")
        b = V.shape[0]
        # V rounded to the table's dtype, float32 sums
        N = (V @ prep.Ht if prep.Ht.dtype == dtype
             else D._bf16_dot(V, prep.Ht))
        sum_v_sq = torch.sum(V * V)

    eye = torch.eye(r, dtype=dtype, device=dev)
    if algorithm == "als":
        if alpha_confidence:
            if not sparse_in:
                H32 = _table_f32(prep)
                C = 1.0 + alpha_confidence * V
                # per-user Gram H diag(C_u) Hᵀ, batched
                Gb = torch.einsum("rm,um,sm->urs", H32, C, H32)
                rhs = (C * V) @ H32.T
            else:
                Gb, rhs = _weighted_grams_sparse(
                    G, prep, cols_np, vals_np, indptr_np, b,
                    alpha_confidence,
                )
            # the per-row route: a scale-aware ridge (linalg.dense._ridged)
            # for large, near-singular weighted Grams; #12 on the card
            W = D.row_solver()(None, Gb, rhs, lambda_w, eps, None)
        else:
            A = G + (lambda_w + eps) * eye
            W = torch.clamp(D.spd_solve(A, N.T).T, min=0.0)
        iters_done = 1
    elif algorithm == "hals":
        # W-only cyclic column sweeps against the frozen table, the
        # projection twin of Algorithm.HALS: N and the Gram are fixed, so
        # each iteration is one half-sweep
        W = _init_w(b, r, seed, W0, dev)
        Gh = G + lambda_w * eye
        for _ in range(num_iterations):
            W = D.hals_half_sweep(N, Gh, W)
        iters_done = num_iterations
    else:
        W = _init_w(b, r, seed, W0, dev)
        if objective == "beta":
            W = _beta_w_loop_dense(V, _table_f32(prep), W, num_iterations,
                                   float(beta))
        elif objective == "frobenius":
            W = _mu_fro_w_loop(N, G, W, num_iterations, eps)
        elif sparse_in:
            W = _mu_kl_w_loop_sparse(vals, rows, Hc, h_sum, W,
                                     num_iterations, eps, b)
        else:
            W = _mu_kl_w_loop_dense(V, _table_f32(prep).T, h_sum, W,
                                    num_iterations, eps)
        iters_done = num_iterations

    # exit-time objective
    if objective == "beta":
        err = float(D.beta_divergence(V, W, _table_f32(prep), float(beta)))
        rmsd = float("nan")
    elif objective == "kl":
        if sparse_in:
            err = float(_kl_error_sparse(vals, rows, Hc, W, h_sum, 1e-12))
        else:
            err = float(D.kl_error(V, W, _table_f32(prep)))
        rmsd = float("nan")
    else:
        if sparse_in:
            err = float(_fro_error_sparse(vals, rows, Hc, W, G, sum_v_sq))
        else:
            err = float(D.frobenius_error(V, W, _table_f32(prep),
                                          sum_v_sq=sum_v_sq))
        rmsd = err / float(np.sqrt(b * m))
    return TransformResult(W=W, error=err, rmsd=rmsd,
                           num_iterations=iters_done)


def _weighted_grams_sparse(G, prep, cols_np, vals_np, indptr_np, b, alpha):
    """Batched per-user weighted Grams from CSR structure.

    Pads each user's items to the batch's longest history (on the host,
    in numpy) and forms

      Gram_u = HHᵀ + Σ_i (c_i − 1) h_i h_iᵀ,   rhs_u = Σ_i c_i v_i h_i

    with c = 1 + alpha·v, as one batched product over the gathered
    (b, kmax, r) rows; unobserved entries (v = 0, c = 1) contribute only
    through the shared HHᵀ."""
    counts = np.diff(indptr_np)
    kmax = max(int(counts.max()) if len(counts) else 0, 1)
    rows = np.repeat(np.arange(b), counts)
    pos = np.arange(len(cols_np)) - np.repeat(indptr_np[:-1], counts)
    idx = np.zeros((b, kmax), dtype=np.int64)
    val = np.zeros((b, kmax), dtype=np.float32)
    idx[rows, pos] = cols_np
    val[rows, pos] = vals_np
    dev = G.device
    r = G.shape[0]
    Hk = _table_rows(prep, torch.as_tensor(idx.reshape(-1), device=dev)
                     ).reshape(b, kmax, r)
    v = torch.as_tensor(val, device=dev)  # zero on padding: c − 1 = 0
    Gb = G[None] + (Hk * (alpha * v)[..., None]).mT @ Hk
    rhs = torch.bmm(((1.0 + alpha * v) * v)[:, None, :], Hk)[:, 0]
    return Gb, rhs
