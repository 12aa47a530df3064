"""Serving layer (port of ``nmftpu/serving.py``, one device): the learned
factors as embedding tables behind a recommend/score API.

`Recommender` holds W and the item table H on one torch device (CUDA by
default; ``device="cpu"`` runs the kernels' plain twins), plus the
training interactions for seen-item exclusion, and serves top-k MIPS
recommendations as host numpy arrays; `save`/`load` persist the tables in
``nmftpu``'s format.

Differences from ``nmftpu``, none of which changes a result:
* the table is never padded to a multiple of ``reservoir_slots``: the
  kernels mask their ragged last tile themselves;
* there is no block-halving retry on out-of-memory (an XLA compile
  workaround): a ``torch.cuda.OutOfMemoryError`` propagates, except from
  the 4x-slot reservoir scan of ``recommend_certified``'s optional
  escalation, which then leaves its rows to the exact scan;
* the exact re-scan of uncertified rows runs on just those rows (no
  power-of-two batch padding, which only served JAX's compile cache).

Not ported yet: ``mesh=`` (multi-GPU, slice 6) and fold-in
(``fold_in``, ``fold_in_batch``, ``recommend_from_history*``, which need
``foldin.py`` and slice 4's solvers); both raise NotImplementedError.
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np
import torch

from nmftpu_torch._operands import _tensor
from nmftpu_torch.kernels.mips_reservoir import reservoir_topk_mips
from nmftpu_torch.retrieval.exclusion import build_block_exclusion
from nmftpu_torch.retrieval.mips import (
    certify_topk,
    rescore_and_sort,
    topk_mips_blocked,
    topk_mips_certified,
    topk_mips_excluded,
)
from nmftpu_torch.sparse import SparseCSR, SparseMatrix

# single-device scans take megablocks, clamped to the catalog
_SERVE_BLOCK = 1 << 20
# oversampling exclusion retrieves k + S candidates and drops the seen
# items at the end; wider seen lists take the scatter-list form
_MAX_OVERSAMPLE_SEEN = 4096
# int8 quantization works through H in column blocks of this many items
_QUANT_CHUNK = 1 << 20

TABLE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}

_FOLD_IN = (
    "fold-in (fold_in, fold_in_batch, recommend_from_history*) needs "
    "foldin.py and the solvers of the other algorithms, not ported yet "
    "(ROADMAP queue 1, slice 4)"
)


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to serve on the CPU with "
            "the kernels' plain torch twins"
        )
    return dev


def quantize_table(H):
    """H (r, m) float32 -> (Hq int8, scale (r,) float32), true H ~=
    diag(scale) @ Hq, with per-dimension symmetric scales. The same float
    ops as ``nmftpu``'s numpy code (serving.py:89-96), so both packages
    hold identical int8 bits; `round` is half to even in both."""
    scale = torch.clamp(H.abs().amax(dim=1) / 127.0, min=1e-30)
    Hq = torch.empty(H.shape, dtype=torch.int8, device=H.device)
    for lo in range(0, H.shape[1], _QUANT_CHUNK):
        blk = H[:, lo:lo + _QUANT_CHUNK]
        Hq[:, lo:lo + _QUANT_CHUNK] = torch.clamp(
            torch.round(blk / scale[:, None]), -127, 127).to(torch.int8)
    return Hq, scale


class Recommender:
    """Top-k recommendation serving over factor embedding tables."""

    def __init__(self, W, H, train: SparseMatrix | None = None,
                 mesh=None, block: int | None = None,
                 method: str = "approx", table_dtype: str = "float32",
                 reservoir_slots: int = 4096, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "Recommender(mesh=...) belongs to the multi-GPU path, not "
                "ported yet (ROADMAP queue 1, slice 6)"
            )
        if table_dtype not in TABLE_DTYPES:
            raise ValueError(
                f"table_dtype must be float32|bfloat16|int8, "
                f"got {table_dtype!r}"
            )
        dev = _resolve_device(device)
        H = _tensor(H, dev, torch.float32)
        # the ITEM table is the scanned operand: bf16 halves and int8
        # quarters its footprint and read traffic; int8 uses
        # per-dimension scales that fold into the query side
        h_scale = None
        if table_dtype == "int8":
            table, h_scale = quantize_table(H)
        else:
            table = H.to(TABLE_DTYPES[table_dtype])
        self._setup(W, table, h_scale, train, block, method,
                    reservoir_slots, dev)

    @classmethod
    def from_table(cls, W, table, *, h_scale=None,
                   train: SparseMatrix | None = None,
                   block: int | None = None, method: str = "approx",
                   reservoir_slots: int = 4096, device="cuda"):
        """A Recommender over an item table already in its serving dtype
        (float32, bfloat16, or int8 with its (r,) `h_scale`), taken as it
        is: nothing is re-quantized."""
        dev = _resolve_device(device)
        table = _tensor(table, dev)
        if table.dtype not in TABLE_DTYPES.values():
            raise TypeError(f"table dtype {table.dtype} is not one of "
                            "float32, bfloat16, int8")
        if (h_scale is None) != (table.dtype != torch.int8):
            raise ValueError("an int8 table needs h_scale, and only an "
                             "int8 table takes one")
        if h_scale is not None:
            h_scale = _tensor(h_scale, dev, torch.float32)
        rec = cls.__new__(cls)
        rec._setup(W, table, h_scale, train, block, method,
                   reservoir_slots, dev)
        return rec

    def _setup(self, W, table, h_scale, train, block, method,
               reservoir_slots, device):
        if method not in ("approx", "exact", "reservoir"):
            raise ValueError(
                f"method must be approx|exact|reservoir, got {method!r}"
            )
        self.device = device
        self.W = _tensor(W, device, torch.float32)
        self.H = table
        self._h_scale = h_scale
        self.table_dtype = {v: k for k, v in TABLE_DTYPES.items()}[
            table.dtype]
        self._m_items = int(table.shape[1])
        # a block wider than m would only waste memory
        self.block = (max(1, min(_SERVE_BLOCK, self._m_items))
                      if block is None else int(block))
        self.method = method
        self.reservoir_slots = int(reservoir_slots)
        self._train_csr = train.to_csr() if train is not None else None

    def _queries(self, user_ids):
        return self.W[_tensor(user_ids, self.device, torch.int64)]

    def _topk(self, Wq, k, lists, candidate_k, seen=None):
        """Top-k dispatch for every serving entry point. Exclusion
        prefers the oversampling form (`seen`, a padded (b, S) id
        array); `lists` is the wide-seen scatter-list fallback."""
        if (self.method == "reservoir" and candidate_k is not None
                and lists is None):
            warnings.warn(
                "candidate_k has no effect on the reservoir scan — "
                "its recall is tuned via reservoir_slots (missed "
                "items ~ C(k,3)/slots^2)", UserWarning, stacklevel=3,
            )
        if self.method == "reservoir":
            if lists is None:
                return reservoir_topk_mips(
                    Wq, self.H, k, slots=self.reservoir_slots, seen=seen,
                    h_scale=self._h_scale, m_items=self._m_items,
                )
            # wide-seen scatter-lists fallback: the blocked approx scan
            return topk_mips_blocked(
                Wq, self.H, k, block=self.block, exclude_lists=lists,
                method="approx", candidate_k=candidate_k,
                h_scale=self._h_scale,
            )
        if seen is not None:
            return topk_mips_excluded(
                Wq, self.H, k, seen, block=self.block, method=self.method,
                candidate_k=candidate_k, h_scale=self._h_scale,
            )
        return topk_mips_blocked(
            Wq, self.H, k, block=self.block, exclude_lists=lists,
            method=self.method, candidate_k=candidate_k,
            h_scale=self._h_scale,
        )

    @property
    def n_users(self) -> int:
        return self.W.shape[0]

    @property
    def n_items(self) -> int:
        return self._m_items

    def user_embedding(self, user_ids) -> np.ndarray:
        return self._queries(np.asarray(user_ids)).cpu().numpy()

    def _exclusion(self, user_ids):
        """Block-bucketed seen lists: O(total_seen), never a (b, m)
        mask."""
        if self._train_csr is None:
            return None
        return build_block_exclusion(user_ids, self._train_csr,
                                     self.n_items, self.block)

    def _seen_padded(self, csr: SparseCSR, user_ids, k: int):
        """Padded (b, S) seen-item array for the oversampling exclusion
        form, or None when the batch's widest seen list is too wide for
        oversampling (k + S candidates) or exceeds the candidate width."""
        counts = np.diff(csr.indptr)[user_ids]
        S = int(counts.max()) if counts.size else 0
        cap = (2 * self.reservoir_slots if self.method == "reservoir"
               else self.block)
        if S == 0 or k + S > min(_MAX_OVERSAMPLE_SEEN, cap):
            return None
        return self._seen_full(csr, user_ids, S)

    def _seen_full(self, csr: SparseCSR, user_ids, S: int | None = None):
        """UNCAPPED padded (b, S) seen array (the certify pass's seen
        discount gathers b*S table columns whatever the width). None for
        an all-empty batch."""
        if S is None:
            counts = np.diff(csr.indptr)[user_ids]
            S = int(counts.max()) if counts.size else 0
        if S == 0:
            return None
        seen = np.full((len(user_ids), S), -1, np.int32)
        for row, u in enumerate(np.asarray(user_ids)):
            lo, hi = csr.indptr[u], csr.indptr[u + 1]
            seen[row, :hi - lo] = csr.indices[lo:hi]
        return seen

    def recommend(self, user_ids, k: int = 100,
                  exclude_seen: bool = True, candidate_k: int | None = None):
        """Top-k items for each user id. Returns (scores, item_ids), both
        (len(user_ids), k) numpy arrays. candidate_k tunes the approx
        path's per-block candidate count. When fewer than k candidates
        exist the tail slots carry score=-inf with a filler index —
        filter on the score."""
        user_ids = np.atleast_1d(np.asarray(user_ids))
        Wq = self._queries(user_ids)
        seen = lists = None
        if exclude_seen and self._train_csr is not None:
            # the exact method takes scatter lists (its top-k cost grows
            # with the candidate width k + S); the others oversample
            if self.method != "exact":
                seen = self._seen_padded(self._train_csr, user_ids, k)
            if seen is None:
                lists = self._exclusion(user_ids)
        s, i = self._topk(Wq, k, lists, candidate_k, seen=seen)
        return s.cpu().numpy(), i.cpu().numpy()

    def recommend_certified(self, user_ids, k: int = 100,
                            exclude_seen: bool = True,
                            candidate_k: int | None = None,
                            fallback: str | None = None):
        """Like `recommend` but returns (scores, item_ids, certified):
        certified[u] proves row u IS the exact top-k up to ties at the
        kth score (a count of the items scoring above it, see
        `retrieval.mips.topk_mips_certified`).

        fallback="exact": uncertified rows are re-scanned so that every
        returned row is the exact top-k; more than 16 of them first take
        one reservoir pass at 4x the slots, and whatever certifies there
        skips the exact scan. `certified` still reports the first pass.

        Users whose seen list is too wide for oversampling take the
        scatter-list scan plus a wide-seen certify discount; the
        certificate stays exact."""
        if fallback not in (None, "exact"):
            raise ValueError(
                f"fallback must be None or 'exact', got {fallback!r}"
            )
        user_ids = np.atleast_1d(np.asarray(user_ids))
        Wq = self._queries(user_ids)
        seen_os, seen_full, lists = self._certified_exclusion(
            user_ids, k, exclude_seen)
        s, i, cert = self._certified_scan(Wq, k, candidate_k, seen_os,
                                          seen_full, lists)
        s, i, cert = (t.cpu().numpy() for t in (s, i, cert))
        if fallback == "exact" and not cert.all():
            rows = np.flatnonzero(~cert)
            s, i = s.copy(), i.copy()
            # rows tied at the kth score never certify at any slot count,
            # so a small subset goes straight to the exact scan
            if len(rows) > 16:
                rows = self._escalate_rows(s, i, rows, user_ids, k,
                                           exclude_seen)
            if len(rows):
                s2, i2 = self._exact_rows(user_ids[rows], k, exclude_seen)
                s[rows], i[rows] = s2, i2
        return s, i, cert

    def _escalate_rows(self, s, i, rows, user_ids, k, exclude_seen):
        """One certified pass at 4x reservoir_slots over a row subset:
        splice the rows that certify into (s, i) IN PLACE and return the
        rest. Applies to the reservoir method where ``nmftpu`` applies it:
        its padded table width ceil(m / slots) * slots divisible by the
        escalated slot count. Returns `rows` unchanged otherwise."""
        esc = self.reservoir_slots * 4
        padded = -(-self._m_items // self.reservoir_slots) \
            * self.reservoir_slots
        if self.method != "reservoir" or padded % esc != 0:
            return rows
        sub_users = user_ids[rows]
        Wq = self._queries(sub_users)
        seen_os = None
        if exclude_seen and self._train_csr is not None:
            seen_full = self._seen_full(self._train_csr, sub_users)
            if seen_full is not None:
                if k + seen_full.shape[1] > min(_MAX_OVERSAMPLE_SEEN,
                                                2 * esc):
                    return rows  # truly wide: the exact scan handles it
                seen_os = _tensor(seen_full, self.device)
        try:
            s0, i0 = reservoir_topk_mips(
                Wq, self.H, k, slots=esc, seen=seen_os,
                h_scale=self._h_scale, m_items=self._m_items,
            )
        except torch.cuda.OutOfMemoryError:
            # the 4x-slot candidates are an optimization only: the exact
            # scan is the safety net
            warnings.warn(
                f"escalated certified pass ran out of device memory; "
                f"falling back to the exact scan for {len(rows)} rows",
                RuntimeWarning, stacklevel=3,
            )
            return rows
        s1, i1 = rescore_and_sort(
            Wq, self.H, i0, h_scale=self._h_scale,
            invalid=s0 == float("-inf"), seen=seen_os,
        )
        cert1 = certify_topk(Wq, self.H, s1, k, block=self.block,
                             h_scale=self._h_scale, seen=seen_os)
        s1, i1, cert1 = (t.cpu().numpy() for t in (s1, i1, cert1))
        ok = np.flatnonzero(cert1)
        s[rows[ok]], i[rows[ok]] = s1[ok], i1[ok]
        return rows[np.flatnonzero(~cert1)]

    def _certified_exclusion(self, user_ids, k: int, exclude_seen: bool):
        """(seen_os, seen_full, lists) for a certified scan: the capped
        oversample array when the batch fits it, else the UNCAPPED
        certify-discount array plus scatter lists for the candidate scan
        (the wide-seen degrade — exact either way). Arrays on the
        device."""
        seen_os = seen_full = lists = None
        if exclude_seen and self._train_csr is not None:
            seen_os = self._seen_padded(self._train_csr, user_ids, k)
            if seen_os is None:
                seen_full = self._seen_full(self._train_csr, user_ids)
                if seen_full is not None:
                    lists = self._exclusion(user_ids)
        return (None if seen_os is None else _tensor(seen_os, self.device),
                None if seen_full is None
                else _tensor(seen_full, self.device),
                lists)

    def _certified_scan(self, Wq, k, candidate_k, seen_os, seen_full,
                        lists):
        """Certified candidates + certificate."""
        if lists is not None:
            # wide-seen degrade: candidates from the scatter-list scan;
            # the certify discount gathers the full (b, S) seen columns
            s, i = topk_mips_blocked(
                Wq, self.H, k, block=self.block, exclude_lists=lists,
                method="approx", candidate_k=candidate_k,
                h_scale=self._h_scale,
            )
            cert = certify_topk(Wq, self.H, s, k, block=self.block,
                                h_scale=self._h_scale, seen=seen_full)
            return s, i, cert
        if self.method == "reservoir":
            # candidates from the reservoir scan, re-scored at the
            # certify pass's rules: filler/seen slots (-inf from the
            # scan) stay -inf, so the re-score revives no dropped id
            if candidate_k is not None:
                warnings.warn(
                    "candidate_k has no effect on the reservoir "
                    "scan — tune reservoir_slots instead",
                    UserWarning, stacklevel=3,
                )
            s0, i = reservoir_topk_mips(
                Wq, self.H, k, slots=self.reservoir_slots, seen=seen_os,
                h_scale=self._h_scale, m_items=self._m_items,
            )
            s, i = rescore_and_sort(
                Wq, self.H, i, h_scale=self._h_scale,
                invalid=s0 == float("-inf"), seen=seen_os,
            )
            cert = certify_topk(Wq, self.H, s, k, block=self.block,
                                h_scale=self._h_scale, seen=seen_os)
            return s, i, cert
        return topk_mips_certified(
            Wq, self.H, k, block=self.block, candidate_k=candidate_k,
            h_scale=self._h_scale, seen=seen_os,
        )

    def _exact_rows(self, user_ids, k: int, exclude_seen: bool):
        """Exact top-k for a row subset (the fallback="exact" re-scan):
        the blocked exact scan with scatter-list exclusion."""
        user_ids = np.asarray(user_ids)
        lists = (self._exclusion(user_ids)
                 if exclude_seen and self._train_csr is not None else None)
        s, i = topk_mips_blocked(
            self._queries(user_ids), self.H, k, block=self.block,
            exclude_lists=lists, method="exact", h_scale=self._h_scale,
        )
        return s.cpu().numpy(), i.cpu().numpy()

    # -- cold users: fold-in against the frozen item table -----------------

    def fold_in(self, item_ids, values=None, **kwargs):
        raise NotImplementedError(_FOLD_IN)

    def fold_in_batch(self, histories, **kwargs):
        raise NotImplementedError(_FOLD_IN)

    def recommend_from_history(self, item_ids, values=None, k: int = 100,
                               **kwargs):
        raise NotImplementedError(_FOLD_IN)

    def recommend_from_history_batch(self, histories, k: int = 100,
                                     **kwargs):
        raise NotImplementedError(_FOLD_IN)

    def score(self, user_id: int, item_ids) -> np.ndarray:
        """Predicted affinities for specific (user, items) pairs. Gathers
        only the requested table columns on the device; the dot runs in
        numpy, as in ``nmftpu``."""
        item_ids = np.atleast_1d(np.asarray(item_ids))
        if item_ids.size and (
            item_ids.min() < 0 or item_ids.max() >= self.n_items
        ):
            raise ValueError(
                f"item index out of range for {self.n_items} items"
            )
        cols = self.H.index_select(
            1, _tensor(item_ids, self.device, torch.int64))
        cols = cols.float().cpu().numpy()
        if self._h_scale is not None:
            cols = cols * self._h_scale.cpu().numpy().reshape(-1, 1)
        return self.W[int(user_id)].cpu().numpy() @ cols

    # -- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        """The bundle of ``nmftpu``'s `save`: W.npy, H.npy (float32, int8
        dequantized), meta.json and train.npz."""
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "W.npy"), self.W.cpu().numpy())
        Hf = self.H.float().cpu().numpy()
        if self._h_scale is not None:
            Hf = Hf * self._h_scale.cpu().numpy().reshape(-1, 1)
        np.save(os.path.join(path, "H.npy"), Hf)
        meta = {"n_users": self.n_users, "n_items": self.n_items,
                "rank": int(self.W.shape[1]),
                "table_dtype": self.table_dtype,
                "method": self.method, "block": int(self.block),
                "reservoir_slots": self.reservoir_slots}
        if self._train_csr is not None:
            np.savez(
                os.path.join(path, "train.npz"),
                indptr=self._train_csr.indptr,
                indices=self._train_csr.indices,
                data=self._train_csr.data,
            )
            meta["has_train"] = True
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, mesh=None, device="cuda") -> "Recommender":
        W = np.load(os.path.join(path, "W.npy"))
        H = np.load(os.path.join(path, "H.npy"))
        meta = {}
        meta_path = os.path.join(path, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        train = None
        tr_path = os.path.join(path, "train.npz")
        if os.path.exists(tr_path):
            z = np.load(tr_path)
            train = SparseCSR(z["indptr"], z["indices"], z["data"],
                              (W.shape[0], H.shape[1]))
        return cls(W, H, train=train, mesh=mesh,
                   block=int(meta.get("block", 8192)),
                   method=meta.get("method", "approx"),
                   table_dtype=meta.get("table_dtype", "float32"),
                   reservoir_slots=int(meta.get("reservoir_slots", 4096)),
                   device=device)
