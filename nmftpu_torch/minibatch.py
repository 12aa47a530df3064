"""Online / mini-batch NMF (port of ``nmftpu/minibatch.py``): the
`sklearn.decomposition.MiniBatchNMF` algorithm of Fevotte & Idier 2011 +
Lefevre, Bach & Fevotte 2011. W is updated per mini-batch of rows, H
through exponentially-forgotten sufficient-statistic accumulators A/B, so
the model fits row streams and datasets far beyond device memory.

V itself need not be on the device: `minibatch_fit` slices row panels
from any row-sliceable source (a numpy array, np.memmap, the sklearn
facade's `_RowSource` over scipy.sparse) and sends one panel at a time,
and `OnlineNMF.partial_fit` consumes an arbitrary stream of row batches,
so the resident state is H/A/B (3 x r x m), W (n x r) and the current
panel. A V already on the device (a tensor, or an in-memory array within
`_FUSED_BUDGET`) runs `epoch_fused`: the same steps over row windows
(views) of the one device copy of V.

Numerics mirror sklearn's `_multiplicative_update_w/_h` guard for guard
(EPSILON clamps, the gamma MM exponent, the beta<1 / beta<=1 factor
stabilizations), through the beta helpers of `linalg.dense`.

Entry points run on CUDA unless the caller passes ``device="cpu"`` (or
a CPU tensor). With ``mesh=`` (a rank mesh, every rank calling alike)
the item axis of H, A, B and of each batch is sharded over ALL the
mesh's ranks, flattened to one 'mb_items' axis as ``nmftpu`` flattens
it: the H step is then local to each rank, and every contraction of the
W step, the costs and the norms is a per-rank partial summed over the
axis (`_Cols`). m must be divisible by the rank count.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from nmftpu_torch.config import _dtype_name, resolve_dtype
from nmftpu_torch.linalg import dense as D
from nmftpu_torch.linalg.dense import (
    EPSILON,
    LOCAL,
    _STAB_EPS,
    Sums,
    beta_gamma,
    beta_h_terms,
    beta_w_step,
)

# device memory budget for holding V on the device in the epoch-fused
# path (bytes; read once at import, as nmftpu reads it)
_FUSED_BUDGET = int(os.environ.get("NMFTPU_MINIBATCH_FUSED_BUDGET_BYTES",
                                   8 * 1024**3))


AXIS_MB = "mb_items"


class _Cols(Sums):
    """This rank's columns of the flat 'mb_items' axis of a mesh: the
    shard of a full (·, m) operand it keeps, the sum of a partial over
    the shards (`sum`, and `cols` for the shared beta W step), and the
    gather of the full H."""

    def __init__(self, mesh, m: int):
        from nmftpu_torch.parallel.mesh import axis_index, flat_mesh

        self.device = _mesh_device(mesh)
        p = mesh.size()
        if m % p:
            raise ValueError(
                f"the item count m={m} must be divisible by the {p} "
                "ranks of the mesh (the item axis is sharded evenly)")
        self.flat = flat_mesh(mesh, AXIS_MB)
        self.m, self.m_loc = m, m // p
        self.lo = axis_index(self.flat, AXIS_MB) * self.m_loc

    def take(self, X):
        """This rank's columns of a full (·, m) array or tensor."""
        return X[:, self.lo:self.lo + self.m_loc]

    def sum(self, x):
        from nmftpu_torch.parallel.mesh import psum

        return psum(x, self.flat, AXIS_MB)

    def cols(self, x, maximum=False):
        import torch.distributed as dist

        from nmftpu_torch.parallel.mesh import psum

        return psum(x, self.flat, AXIS_MB,
                    dist.ReduceOp.MAX if maximum else dist.ReduceOp.SUM)

    def barrier(self):
        import torch.distributed as dist

        dist.barrier(group=self.flat.get_group(AXIS_MB))

    def gather(self, H):
        """The full (r, m) from each rank's (r, m / p)."""
        from nmftpu_torch.parallel.mesh import all_gather

        parts = all_gather(H, self.flat, AXIS_MB)
        return parts.permute(1, 0, 2).reshape(H.shape[0], -1)


def _mesh_device(mesh):
    from nmftpu_torch.parallel.mesh import check_mesh, mesh_device

    check_mesh(mesh)
    return mesh_device(mesh)


def _cols(mesh, m):
    return None if mesh is None else _Cols(mesh, m)


def _summer(cols):
    """x summed over the item shards, or x itself without them."""
    return (lambda x: x) if cols is None else cols.sum


def _device(V, device) -> torch.device:
    """`device` if given, else a tensor source's own device (the facade's
    `_RowSource` unwrapped), else CUDA (raises without one)."""
    from nmftpu_torch.driver import _resolve_device

    return _resolve_device(getattr(V, "X", V), device)


def _put(x, dtype, device):
    """A panel or factor (array, tensor) as a tensor of `dtype` on
    `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def w_mu_step(Xb, W, H, beta=2.0, l1_w=0.0, l2_w=0.0, gamma=1.0,
              cols=None):
    """One multiplicative W update on a row batch (sklearn's
    _multiplicative_update_w; shared implementation with the batch
    beta engine). cols: the item shards (Xb and H hold this rank's)."""
    return beta_w_step(Xb, W, H, beta, l1_w=l1_w, l2_w=l2_w, gamma=gamma,
                       sums=LOCAL if cols is None else cols)


def h_online_step(Xb, W, H, A, B, rho, beta=2.0, l1_h=0.0, l2_h=0.0,
                  gamma=1.0):
    """Online H update: fold this batch's MU numerator/denominator into
    the forgetting accumulators (A, B) and re-solve H = (A/B)^gamma
    (sklearn's _multiplicative_update_h with A/B/rho). Returns
    (H, A, B)."""
    numer, denom = beta_h_terms(Xb, W, H, beta)
    if l1_h > 0.0:
        denom = denom + l1_h
    if l2_h > 0.0:
        denom = denom + l2_h * H
    denom = torch.where(denom == 0.0, EPSILON, denom)
    Hg = H ** (1.0 / gamma) if gamma != 1.0 else H
    A = rho * A + numer * Hg
    B = rho * B + denom
    Hn = A / B
    if gamma != 1.0:
        Hn = Hn ** gamma
    if beta <= 1.0:
        Hn = torch.where(Hn < _STAB_EPS, 0.0, Hn)
    return Hn, A, B


def solve_w(Xb, H, beta=2.0, l1_w=0.0, l2_w=0.0, gamma=1.0,
            max_iter=200, tol=1e-4, mean_v=None, cols=None):
    """Solve for a batch's W with H frozen (sklearn's _solve_W: the
    transform path and the fresh-restarts path), from the flat
    sqrt(mean/r) start, stopping on relative W change <= tol (one host
    read per step when tol > 0). mean_v: optional precomputed global
    mean of the full matrix for the flat start."""
    r = H.shape[0]
    if mean_v is not None:
        mean = torch.tensor(mean_v, dtype=Xb.dtype, device=Xb.device)
    elif cols is None:
        mean = torch.mean(Xb)
    else:
        mean = cols.sum(torch.sum(Xb)) / (Xb.shape[0] * cols.m)
    avg = torch.sqrt(mean / r)
    W = avg.expand(Xb.shape[0], r).clone()
    for _ in range(int(max_iter)):
        Wn = w_mu_step(Xb, W, H, beta, l1_w, l2_w, gamma, cols)
        if tol > 0:
            diff = torch.linalg.norm(Wn - W) / torch.clamp(
                torch.linalg.norm(Wn), min=EPSILON)
            W = Wn
            if not float(diff) > tol:
                break
        else:
            W = Wn
    return W


def _divergence(Xb, W, H, beta, cols=None):
    """D_beta(Xb || W H) of a batch (0.5 ‖·‖² for beta = 2); on item
    shards each rank's terms summed (the Gram trick's clamp after the
    sum)."""
    if beta == 2.0:
        if cols is None:
            return 0.5 * D.frobenius_error_sq(Xb, W, H)
        sq, cross = cols.sum(torch.stack([torch.sum(Xb * Xb),
                                          torch.sum((W.T @ Xb) * H)]))
        quad = torch.sum((W.T @ W) * cols.sum(H @ H.T))
        return 0.5 * torch.clamp(sq - 2.0 * cross + quad, min=0.0)
    S = _summer(cols)
    if beta == 1.0:
        return S(D.kl_error(Xb, W, H))
    return S(D.beta_divergence(Xb, W, H, beta))


def minibatch_step(Xb, W, H, A, B, rho, beta=2.0, l1_w=0.0, l2_w=0.0,
                   l1_h=0.0, l2_h=0.0, gamma=1.0, fresh=False,
                   fresh_max_iter=30, fresh_tol=0.0, with_cost=False,
                   cols=None):
    """One full mini-batch step (sklearn's _minibatch_step with
    update_H=True): W step (warm single MU step, or a fresh solve),
    beta<1 stabilization, online H/A/B update. Returns
    (W, H, A, B, cost); cost is the per-sample regularized batch
    divergence (a 0-dim tensor) when with_cost, else 0. cols: the item
    shards (Xb, H, A, B hold this rank's columns; the H step is local)."""
    if fresh or W is None:
        W = solve_w(Xb, H, beta, l1_w, l2_w, gamma,
                    max_iter=fresh_max_iter, tol=fresh_tol, cols=cols)
    else:
        W = w_mu_step(Xb, W, H, beta, l1_w, l2_w, gamma, cols)
    if beta < 1.0:
        W = torch.where(W < _STAB_EPS, 0.0, W)
    if with_cost:
        S = _summer(cols)
        cost = (
            _divergence(Xb, W, H, beta, cols) + l1_w * torch.sum(W)
            + l1_h * S(torch.sum(H))
            + l2_w * torch.sum(W * W) + l2_h * S(torch.sum(H * H))
        ) / Xb.shape[0]
    else:
        cost = torch.zeros((), dtype=Xb.dtype, device=Xb.device)
    H, A, B = h_online_step(Xb, W, H, A, B, rho, beta, l1_h, l2_h, gamma)
    return W, H, A, B, cost


def epoch_fused(V, W, H, A, B, rho, *, batch_size, beta=2.0, l1_w=0.0,
                l2_w=0.0, l1_h_full=0.0, l2_h_full=0.0, l1_h_tail=0.0,
                l2_h_tail=0.0, gamma=1.0, fresh=False,
                fresh_max_iter=30, fresh_tol=0.0, cols=None):
    """One full epoch of mini-batch steps over a device-resident V: the
    steps of the per-batch loop in its order, each on a row window (a
    view) of V, never a second V-sized buffer, with the tail batch's
    own H-regularization scale (sklearn scales H penalties by the
    batch's row count). The same results as the per-batch loop. Returns
    (W, H, A, B); W is a new tensor."""
    n = V.shape[0]
    if not fresh:
        W = W.clone()
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        full = hi - lo == batch_size
        Wb, H, A, B, _ = minibatch_step(
            V[lo:hi], None if fresh else W[lo:hi], H, A, B, rho,
            beta=beta, l1_w=l1_w, l2_w=l2_w,
            l1_h=l1_h_full if full else l1_h_tail,
            l2_h=l2_h_full if full else l2_h_tail, gamma=gamma,
            fresh=fresh, fresh_max_iter=fresh_max_iter,
            fresh_tol=fresh_tol, cols=cols,
        )
        if not fresh:
            W[lo:hi] = Wb
    return W, H, A, B


def divergence_blocked(V, W, H, beta, batch=1024, dtype=torch.float32,
                       device=None):
    """D_beta(V || WH) summed over row panels (the divergence is
    row-additive for every beta), so V streams through batch-sized
    panels exactly like the fit loop: reconstruction_err_ without V or
    WH on the device whole. Returns a float."""
    dtype = resolve_dtype(dtype)
    dev = _device(W, device)
    n = V.shape[0]
    W = _put(W, dtype, dev)
    H = _put(H, dtype, dev)
    total = 0.0
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        Xb = _put(V[lo:hi], dtype, dev)
        Wb = W[lo:hi]
        if beta == 2.0:
            d = 0.5 * D.frobenius_error_sq(Xb, Wb, H)
        elif beta == 1.0:
            d = D.kl_error(Xb, Wb, H)
        else:
            d = D.beta_divergence(Xb, Wb, H, beta)
        total += float(d)
    return total


class OnlineNMF:
    """Streaming NMF: feed row batches in any order, read H at any time.

    The device-resident state is only (H, A, B), three (r, m) tensors,
    so the item axis can be large and the row stream unbounded. Each
    `partial_fit(Xb)` runs one mini-batch step (fresh W solve, as
    sklearn's partial_fit); `transform(X)` solves W for new rows with H
    frozen.

    With ``mesh=`` every rank feeds the same full batches and keeps its
    shard of the item axis: `H`, `_A`, `_B` are this rank's (r, m / p)
    columns, `components()` the whole H on every rank.

    `beta` is the divergence exponent (2 = Frobenius, 1 = KL, 0 =
    Itakura-Saito, any float). alpha_w/alpha_h/l1_ratio carry sklearn's
    scaled-penalty semantics (W penalties scale by n_features, H
    penalties by the batch's row count). device: where the state lives
    (default CUDA).
    """

    def __init__(self, rank, *, beta=2.0, batch_size=1024,
                 forget_factor=0.7, n_rows_hint=None, alpha_w=0.0,
                 alpha_h="same", l1_ratio=0.0, fresh_max_iter=30,
                 transform_max_iter=200, transform_tol=1e-4,
                 dtype="float32", seed=0, mesh=None, device=None):
        self.rank = int(rank)
        self.beta = float(beta)
        self.gamma = beta_gamma(self.beta)
        self.batch_size = int(batch_size)
        self.forget_factor = float(forget_factor)
        # rho = forget_factor ** (batch_size / n_rows): with no known
        # total row count (a true stream), one batch per "dataset"
        n_hint = n_rows_hint if n_rows_hint else batch_size
        self.rho = self.forget_factor ** (self.batch_size / float(n_hint))
        self.alpha_w = float(alpha_w)
        self.alpha_h = (
            self.alpha_w if alpha_h == "same" else float(alpha_h)
        )
        self.l1_ratio = float(l1_ratio)
        self.fresh_max_iter = int(fresh_max_iter)
        self.transform_max_iter = int(transform_max_iter)
        self.transform_tol = float(transform_tol)
        self.dtype = resolve_dtype(dtype)
        self.seed = int(seed)
        self.mesh = mesh
        self._cols = None  # the item shards, once m is known
        self.device = (_mesh_device(mesh) if mesh is not None
                       else _device(None, device))
        self.H = None
        self._A = None
        self._B = None
        self.n_steps = 0

    def _regs(self, batch_rows, n_features):
        l1_w = n_features * self.alpha_w * self.l1_ratio
        l2_w = n_features * self.alpha_w * (1.0 - self.l1_ratio)
        l1_h = batch_rows * self.alpha_h * self.l1_ratio
        l2_h = batch_rows * self.alpha_h * (1.0 - self.l1_ratio)
        return l1_w, l2_w, l1_h, l2_h

    def _place(self, X):
        """A full (·, m) batch as this rank's columns, on the device."""
        X = _put(X, self.dtype, self.device)
        if self.mesh is None:
            return X
        if self._cols is None:
            self._cols = _Cols(self.mesh, X.shape[1])
        return self._cols.take(X)

    def components(self):
        """The whole (r, m) H (gathered from the item shards on a
        mesh)."""
        if self.H is None or self._cols is None:
            return self.H
        return self._cols.gather(self.H)

    def _ensure_state(self, Xb, H0=None):
        """The first state from the first FULL batch Xb (every rank the
        same), then this rank's columns of it."""
        if self.H is not None:
            return
        m = Xb.shape[1]
        if H0 is not None:
            self.H = _put(H0, self.dtype, self.device)
        elif self.rank <= min(Xb.shape):
            # sklearn partial_fit's first-call default: NNDSVDA seeded
            # from the first batch (the host SVD)
            from nmftpu_torch.init.nndsvd import nndsvd_init

            _, H0n = nndsvd_init(Xb.cpu().numpy(), self.rank,
                                 variant="nndsvda", seed=self.seed)
            self.H = _put(H0n, self.dtype, self.device)
        else:
            # overcomplete rank: mean-scaled positive random start (a
            # torch stream, not nmftpu's jax.random one)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed)
            avg = float(np.sqrt(float(torch.mean(Xb)) / self.rank))
            self.H = avg * torch.abs(torch.randn(
                (self.rank, m), generator=gen, dtype=self.dtype,
                device=self.device))
        if self.mesh is not None:
            self._cols = _Cols(self.mesh, m)
            self.H = self._cols.take(self.H).contiguous()
        self._A = self.H
        self._B = torch.ones_like(self.H)

    def save(self, path):
        """Persist the full streaming state (H, A, B, step count,
        hyperparameters) as ``online_state.npz`` and
        ``online_meta.json``, the layout ``nmftpu`` writes without
        orbax, so a stream can resume after a crash or redeploy. On a
        mesh every rank calls it: the state is gathered and the first
        rank writes it."""
        if self.H is None:
            raise ValueError("nothing to save: no data seen yet")
        state = {"H": self.H, "A": self._A, "B": self._B}
        if self._cols is not None:
            state = {k: self._cols.gather(v) for k, v in state.items()}
            if self._cols.lo:      # not the first shard's rank
                self._cols.barrier()
                return
        path = os.path.abspath(path)
        os.makedirs(path, exist_ok=True)
        meta = {
            "n_steps": self.n_steps,
            "rank": self.rank,
            "beta": self.beta,
            "batch_size": self.batch_size,
            "forget_factor": self.forget_factor,
            "rho": self.rho,
            "alpha_w": self.alpha_w,
            "alpha_h": self.alpha_h,
            "l1_ratio": self.l1_ratio,
            "fresh_max_iter": self.fresh_max_iter,
            "transform_max_iter": self.transform_max_iter,
            "transform_tol": self.transform_tol,
            "seed": self.seed,
            "dtype": _dtype_name(self.dtype),
        }
        np.savez(os.path.join(path, "online_state.npz"),
                 **{k: v.cpu().numpy() for k, v in state.items()})
        with open(os.path.join(path, "online_meta.json"), "w") as f:
            json.dump(meta, f)
        if self._cols is not None:
            # the other ranks return once the files are written
            self._cols.barrier()

    @classmethod
    def load(cls, path, mesh=None, device=None):
        """Restore a saved stream state (this package's or ``nmftpu``'s
        npz layout); continue with partial_fit as if never
        interrupted. mesh= re-shards H, A and B over the mesh's ranks."""
        path = os.path.abspath(path)
        with open(os.path.join(path, "online_meta.json")) as f:
            meta = json.load(f)
        npz = os.path.join(path, "online_state.npz")
        if not os.path.exists(npz):
            raise ValueError(
                f"{path} holds no online_state.npz (an orbax "
                "online_state/ directory from nmftpu with orbax is not "
                "read by nmftpu_torch)"
            )
        n_steps = meta.pop("n_steps")
        rho = meta.pop("rho")
        dtype = meta.pop("dtype")
        rank = meta.pop("rank")
        alpha_h = meta.pop("alpha_h")
        model = cls(rank, dtype=dtype, alpha_h=alpha_h, device=device,
                    mesh=mesh, **meta)
        model.rho = rho  # the exact resumed forgetting rate
        data = np.load(npz)
        model.H, model._A, model._B = (
            model._place(data[k]).contiguous() for k in ("H", "A", "B"))
        model.n_steps = int(n_steps)
        return model

    def set_components(self, H):
        """Replace the resident H (a full (r, m) H: on a mesh each rank
        keeps its columns); the A/B accumulators are kept, as sklearn's
        partial_fit uses self.components_ in place."""
        self.H = self._place(H).contiguous()

    def partial_fit(self, Xb, H0=None):
        """One online step on a row batch (fresh W solve, like
        sklearn's MiniBatchNMF.partial_fit). Returns self."""
        Xb = _put(Xb, self.dtype, self.device)
        self._ensure_state(Xb, H0)
        l1_w, l2_w, l1_h, l2_h = self._regs(Xb.shape[0], Xb.shape[1])
        _, self.H, self._A, self._B, _ = minibatch_step(
            self._place(Xb), None, self.H, self._A, self._B, self.rho,
            beta=self.beta, l1_w=l1_w, l2_w=l2_w, l1_h=l1_h, l2_h=l2_h,
            gamma=self.gamma, fresh=True,
            fresh_max_iter=self.fresh_max_iter,
            fresh_tol=self.transform_tol, cols=self._cols,
        )
        self.n_steps += 1
        return self

    def transform(self, X):
        """Solve W for rows of X against the current H (frozen)."""
        if self.H is None:
            raise ValueError("OnlineNMF has not seen any data yet")
        l1_w, l2_w, _, _ = self._regs(X.shape[0], X.shape[1])
        return solve_w(
            self._place(X), self.H, self.beta, l1_w, l2_w, self.gamma,
            max_iter=self.transform_max_iter, tol=self.transform_tol,
            cols=self._cols,
        )


def _can_fuse(V, monitor, dtype):
    """Epoch fusion needs V on the device (a tensor, or an in-memory
    ndarray within budget — memmap and sparse sources stay on the
    streaming host loop) and no per-batch host monitoring."""
    if monitor:
        return False
    arr = getattr(V, "X", V)  # unwrap the facade's _RowSource
    if isinstance(arr, torch.Tensor):
        return True
    if not isinstance(arr, np.ndarray) or isinstance(arr, np.memmap):
        return False
    itemsize = torch.empty((), dtype=resolve_dtype(dtype)).element_size()
    return arr.shape[0] * arr.shape[1] * itemsize <= _FUSED_BUDGET


def minibatch_fit(
    V, rank, *, batch_size=1024, max_iter=200, beta=2.0,
    forget_factor=0.7, alpha_w=0.0, alpha_h="same", l1_ratio=0.0,
    tol=1e-4, max_no_improvement=10, fresh_restarts=False,
    fresh_restarts_max_iter=30, transform_max_iter=None,
    W0=None, H0=None, dtype="float32", verbose=0, fused="auto",
    mesh=None, device=None,
):
    """Full mini-batch fit over a row-sliceable V (sklearn's
    MiniBatchNMF._fit_transform loop, cycling fixed batch slices).

    V may be any object supporting `V[a:b]` row slicing + `.shape` — a
    numpy array, np.memmap, h5py dataset or tensor — so datasets far
    beyond device memory stream through panel by panel. Early stopping
    matches sklearn: relative H change <= tol, and an EWA of the
    per-sample batch cost with a max_no_improvement patience (pass tol=0
    AND max_no_improvement=None to run exactly max_iter epochs).

    Returns (W, H, n_iter, n_steps), W and H tensors on the device.

    mesh: every rank calls alike with the whole V, W0, H0; each keeps
    its shard of the item axis (see the module docstring) and gets the
    whole W and H back.
    """
    n, m = V.shape
    rank = int(rank)
    batch_size = min(int(batch_size), n)
    gamma = beta_gamma(float(beta))
    rho = float(forget_factor) ** (batch_size / float(n))
    a_w = float(alpha_w)
    a_h = a_w if alpha_h == "same" else float(alpha_h)
    tmax = (max_iter if transform_max_iter is None
            else int(transform_max_iter))

    if W0 is None or H0 is None:
        raise ValueError(
            "minibatch_fit requires explicit W0/H0 (use "
            "nmftpu_torch.init.initialize_factors or the sklearn facade, "
            "which resolves init= exactly like sklearn)"
        )
    cols = _cols(mesh, m)
    dev = _device(V, device) if cols is None else cols.device
    dt = resolve_dtype(dtype)

    def local(X):
        """A full (·, m) operand as this rank's columns, on the device."""
        X = _put(X, dt, dev)
        return X if cols is None else cols.take(X).contiguous()

    W = _put(W0, dt, dev)
    H = local(H0)
    A = H
    B = torch.ones_like(H)

    slices = [
        (s, min(s + batch_size, n)) for s in range(0, n, batch_size)
    ]
    steps_per_iter = len(slices)
    n_steps_max = int(max_iter) * steps_per_iter
    monitor = (tol is not None and tol > 0) or (
        max_no_improvement is not None
    )

    l1_w = m * a_w * float(l1_ratio)
    l2_w = m * a_w * (1.0 - float(l1_ratio))

    H_buffer = H
    ewa = None
    ewa_min = None
    no_improvement = 0
    step = 0

    if fused == "auto":
        use_fused = _can_fuse(V, monitor, dt)
    else:
        use_fused = bool(fused)
        if use_fused and monitor:
            raise ValueError(
                "fused=True cannot honor per-batch early stopping "
                "(tol > 0 / max_no_improvement); pass tol=0 and "
                "max_no_improvement=None, or fused=False/'auto'"
            )
        if use_fused and not isinstance(
            getattr(V, "X", V), (np.ndarray, torch.Tensor)
        ):
            raise ValueError(
                "fused=True needs an in-memory dense ndarray (memmap/"
                "sparse sources stream through the host loop); use "
                "fused=False/'auto'"
            )
    if use_fused:
        # the per-batch steps over views of the one device copy of V
        Vd = local(getattr(V, "X", V))
        tail_rows = n - (len(slices) - 1) * batch_size
        kw = dict(
            batch_size=batch_size, beta=float(beta), l1_w=l1_w,
            l2_w=l2_w,
            l1_h_full=batch_size * a_h * float(l1_ratio),
            l2_h_full=batch_size * a_h * (1.0 - float(l1_ratio)),
            l1_h_tail=tail_rows * a_h * float(l1_ratio),
            l2_h_tail=tail_rows * a_h * (1.0 - float(l1_ratio)),
            gamma=gamma, fresh=fresh_restarts,
            fresh_max_iter=int(fresh_restarts_max_iter),
            fresh_tol=float(tol or 0.0), cols=cols,
        )
        for _ in range(int(max_iter)):
            W, H, A, B = epoch_fused(Vd, W, H, A, B, rho, **kw)
        if fresh_restarts:
            W = solve_w(Vd, H, float(beta), l1_w, l2_w, gamma,
                        max_iter=tmax, tol=float(tol or 0.0), cols=cols)
        return W, _whole(H, cols), int(max_iter), n_steps_max

    if not fresh_restarts:
        W = W.clone()  # rows are written in place below
    for step in range(n_steps_max):
        lo, hi = slices[step % steps_per_iter]
        Xb = local(V[lo:hi])
        b = hi - lo
        l1_h = b * a_h * float(l1_ratio)
        l2_h = b * a_h * (1.0 - float(l1_ratio))
        Wb, H, A, B, cost = minibatch_step(
            Xb, (None if fresh_restarts else W[lo:hi]), H, A, B, rho,
            beta=float(beta), l1_w=l1_w, l2_w=l2_w, l1_h=l1_h,
            l2_h=l2_h, gamma=gamma, fresh=fresh_restarts,
            fresh_max_iter=int(fresh_restarts_max_iter),
            fresh_tol=float(tol or 0.0),
            with_cost=monitor, cols=cols,
        )
        if not fresh_restarts:
            W[lo:hi] = Wb
        if monitor and step > 0:
            cost = float(cost)
            if verbose:
                print(f"[nmftpu_torch.minibatch] step {step + 1}/"
                      f"{n_steps_max} batch cost {cost:.6g}")
            alpha = min(b / (n + 1), 1.0)
            ewa = cost if ewa is None else ewa * (1 - alpha) + cost * alpha
            if cols is None:
                h_diff = float(
                    torch.linalg.norm(H - H_buffer) / torch.linalg.norm(H))
            else:
                sq = cols.sum(torch.stack([torch.sum((H - H_buffer) ** 2),
                                           torch.sum(H * H)]))
                h_diff = float(torch.sqrt(sq[0]) / torch.sqrt(sq[1]))
            if tol and tol > 0 and h_diff <= tol:
                break
            if ewa_min is None or ewa < ewa_min:
                no_improvement = 0
                ewa_min = ewa
            else:
                no_improvement += 1
            if (max_no_improvement is not None
                    and no_improvement >= max_no_improvement):
                break
        H_buffer = H

    if fresh_restarts:
        if _can_fuse(V, False, dt):
            # in memory within budget: the exact full-matrix solve
            Vd = local(getattr(V, "X", V))
            W = solve_w(Vd, H, float(beta), l1_w, l2_w, gamma,
                        max_iter=tmax, tol=float(tol or 0.0), cols=cols)
        else:
            # an out-of-core source: never V on the device whole
            W = _solve_w_streamed(V, H, slices, float(beta), l1_w,
                                  l2_w, gamma, tmax,
                                  float(tol or 0.0), local, cols)

    n_steps = step + 1
    n_iter = int(math.ceil(n_steps / steps_per_iter))
    return W, _whole(H, cols), n_iter, n_steps


def _whole(H, cols):
    return H if cols is None else cols.gather(H)


def _solve_w_streamed(V, H, slices, beta, l1_w, l2_w, gamma, max_iter,
                      tol, local, cols=None):
    """Final fresh-restarts W solve without V on the device whole: the
    rows of W are independent given H, so each batch panel solves
    separately. The flat start uses the global mean (streamed), like
    sklearn's _solve_W on the full X; the tol early-stop applies per
    panel rather than on the global W norm (it changes when iteration
    stops, not the fixed point)."""
    total = 0.0
    for lo, hi in slices:
        total += float(torch.sum(local(V[lo:hi])) if cols is None
                       else cols.sum(torch.sum(local(V[lo:hi]))))
    mean_v = total / (V.shape[0] * V.shape[1])
    parts = [
        solve_w(local(V[lo:hi]), H, beta, l1_w, l2_w, gamma,
                max_iter=max_iter, tol=tol, mean_v=mean_v, cols=cols)
        for lo, hi in slices
    ]
    return torch.cat(parts, dim=0)
