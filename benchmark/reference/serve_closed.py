"""Exact top-k with seen-item exclusion: the reference for serving cells.
Plain PyTorch; it imports nothing of the program and takes none of its
tables: it quantizes the benchmark's own H again by a frozen copy of the
configuration's int8 rule, and scores in float64.

The scoring rule is the configuration's:
* float32 table: float32 queries times the float32 table;
* int8 table: per-dimension symmetric scales, scale_t = max_j |H_tj| / 127
  (at least 1e-30), Hq = clamp(round(H / scale), -127, 127); the scale
  folds into the float32 query, which is rounded to bf16; the products
  run on those values.
The reference sums those products in float64, so its scores are exact to
float64 rounding.

`precision` selects the control, the step below the configuration's
precision: "tf32" rounds a float32 table's operands to TF32; "fp8"
rounds the int8 table's queries to fp8 e4m3 (a per-row scale onto
e4m3's largest value, 448) instead of bf16.
"""

from __future__ import annotations

import torch

from benchmark.reference.train_fits import round_tf32

INT8_MAX = 127.0
FP8_MAX = 448.0


def int8_table(H: torch.Tensor, chunk: int = 1 << 20):
    """(Hq int8 (r, m), scale (r,) float32) by the configuration's rule."""
    scale = torch.clamp(H.abs().amax(dim=1) / INT8_MAX, min=1e-30)
    Hq = torch.empty(H.shape, dtype=torch.int8, device=H.device)
    for lo in range(0, H.shape[1], chunk):
        Hq[:, lo:lo + chunk] = torch.clamp(
            torch.round(H[:, lo:lo + chunk] / scale[:, None]),
            -INT8_MAX, INT8_MAX).to(torch.int8)
    return Hq, scale


class Table:
    """The scored table of a configuration, rebuilt from H."""

    def __init__(self, H: torch.Tensor, table_dtype: str,
                 precision: str = "float64"):
        if table_dtype not in ("float32", "int8"):
            raise ValueError(f"no reference for table {table_dtype!r}")
        if precision not in ("float64", "tf32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.dtype, self.precision = table_dtype, precision
        self.r, self.m = H.shape
        if table_dtype == "int8":
            self.T, self.scale = int8_table(H)
        else:
            self.T, self.scale = H, None

    def queries(self, Wq: torch.Tensor) -> torch.Tensor:
        q = Wq.float()
        if self.scale is None:
            return round_tf32(q) if self.precision == "tf32" else q
        q = q * self.scale
        if self.precision == "fp8":
            s = torch.clamp(q.abs().amax(dim=1, keepdim=True) / FP8_MAX,
                            min=1e-30)
            return (q / s).to(torch.float8_e4m3fn).float() * s
        return q.to(torch.bfloat16).float()

    def block(self, lo: int, hi: int) -> torch.Tensor:
        """Columns lo..hi of the table as the product takes them."""
        blk = self.T[:, lo:hi].float()
        if self.precision == "tf32":
            blk = round_tf32(blk)
        return blk

    def scores(self, q, lo, hi):
        """(b, hi - lo) scores: float64 sums, or float32 sums of the
        TF32-rounded operands under that control."""
        if self.precision == "tf32":
            return (q @ self.block(lo, hi)).double()
        return q.double() @ self.block(lo, hi).double()


def topk(table: Table, Wq, seen, k: int, block: int = 1 << 19,
         rows: int = 512):
    """Exact top-k (scores float64 descending, ids int64) of each query
    row over the whole table, the row's seen items excluded. seen: one
    int64 tensor of item ids per row."""
    b = Wq.shape[0]
    dev = Wq.device
    out_s = torch.empty(b, k, dtype=torch.float64, device=dev)
    out_i = torch.empty(b, k, dtype=torch.int64, device=dev)
    for r0 in range(0, b, rows):
        r1 = min(r0 + rows, b)
        q = table.queries(Wq[r0:r1])
        pr = torch.cat([torch.full((len(seen[j]),), j - r0, device=dev)
                        for j in range(r0, r1)]).long()
        pc = torch.cat([seen[j] for j in range(r0, r1)]).long()
        best_s = torch.full((r1 - r0, k), float("-inf"),
                            dtype=torch.float64, device=dev)
        best_i = torch.zeros(r1 - r0, k, dtype=torch.int64, device=dev)
        for lo in range(0, table.m, block):
            hi = min(lo + block, table.m)
            s = table.scores(q, lo, hi)
            inb = (pc >= lo) & (pc < hi)
            s[pr[inb], pc[inb] - lo] = float("-inf")
            bs, bi = torch.topk(s, min(k, hi - lo), dim=1)
            cs = torch.cat([best_s, bs], dim=1)
            ci = torch.cat([best_i, bi + lo], dim=1)
            best_s, p = torch.topk(cs, k, dim=1)
            best_i = ci.gather(1, p)
        out_s[r0:r1], out_i[r0:r1] = best_s, best_i
    return out_s, out_i


def score_ids(table: Table, Wq, ids) -> torch.Tensor:
    """(b, K) float64 scores of the given item ids (b, K)."""
    q = table.queries(Wq).double()
    cols = table.T.index_select(1, ids.reshape(-1)).double()
    if table.precision == "tf32":
        cols = round_tf32(cols.float()).double()
    cols = cols.view(table.r, *ids.shape)
    return torch.einsum("br,rbk->bk", q, cols)
