"""The per-row weighted Grams and right-hand sides of the iALS family on
the ELL layout as one hand-written CUDA kernel (#13, ``csrc/ell_gram.cu``
``ell_gram_kernel`` and ``ell_gram_reduce_kernel``).

`grams_rhs(ell, table, rule)` returns, for every row i of the container,

    dG_i = Σ_k w(v_ik) · t_k t_kᵀ  (n, r, r),   rhs_i = Σ_k c(v_ik) · t_k  (n, r),

t_k = table[col_k], float32, each row's full symmetric Gram and its
right-hand side written once: no gathered copy of the table rows, no
per-segment products, no `index_add_` and no zero fill. It replaces no
TPU kernel: ``nmftpu`` leaves this to XLA's gathers and einsums.

`rule` is a `GramRule`: iALS (`ials_rule(alpha)`: w = αv, c = v(1 + αv))
or masked completion ALS (`MASKED`: w = [v ≠ 0], c = v). Both vanish at
v = 0, which is what lets the kernel skip pad lanes.

The work is dealt into units (`work_units`): runs of at most `UNIT_NNZ`
nonzeros of one row inside one bucket, built from the container's
buckets on their device once and kept on the container (`units_of`). A
row of one unit is written by its block; the units of a longer row write
partial sums to workspace slots that a second launch adds in slot order,
so equal inputs give bit-equal outputs.

``sparse_ell.grams_and_rhs_ell`` is the one place that routes: it calls
`grams_rhs` where its caller names a rule and `takes` holds (CUDA,
float32, r <= `ELL_GRAM_MAX_RANK`), and otherwise runs its plain path
(gathers, batched products, `index_add_`), the tests' reference.
`grams_rhs` raises on anything the kernel does not take.
``LAUNCHES["ell_gram"]`` counts the launches: one a call, two where a
row has several units.
"""

from __future__ import annotations

import dataclasses

import torch

from nmftpu_torch.kernels import _build

LAUNCHES = {"ell_gram": 0}

# a block's 8 x 4 tiles cover the lower triangle of up to 128 x 128
ELL_GRAM_MAX_RANK = 128

# the most nonzeros one block sums for one row (csrc/ell_gram.cu
# UNIT_MAX): the ELL builder's default segment width, so a unit is a
# segment (or, for wider segments, a slice of one) and the heaviest item's
# 120,000 clicks are spread over hundreds of blocks
UNIT_NNZ = 512

# floats of one partial slot (csrc/ell_gram.cu WS_SLOT): 8 float4 for
# each of the widest block's 288 threads, then the right-hand side
WS_SLOT_FLOATS = 32 * 288 + 128

# segments a pass when trimming the buckets' segments
_TRIM_ELEMENTS = 1 << 22


@dataclasses.dataclass(frozen=True)
class GramRule:
    """The weight w and value c of a stored value v in the Grams and
    right-hand sides; `code` names the rule to the kernel (0 iALS, 1
    masked)."""

    code: int
    alpha: float = 0.0

    def weight(self, v):
        return self.alpha * v if self.code == 0 else v != 0

    def value(self, v):
        return v * (1.0 + self.alpha * v) if self.code == 0 else v


def ials_rule(alpha: float) -> GramRule:
    """Hu, Koren and Volinsky's confidence: w = αv, c = v(1 + αv)."""
    return GramRule(0, float(alpha))


MASKED = GramRule(1)


@dataclasses.dataclass(frozen=True)
class WorkUnits:
    """One half-step's work, on the buckets' device.

    units: (U, 4) int64, the longest and the shortest left in turn:
    (bucket, flat start in its
    values and columns, nonzeros, destination), the destination a row,
    or -1 - the unit's partial slot; a row with no nonzeros has one unit
    of 0 nonzeros. splits: (S, 3) int64, one per row of several units:
    (row, first slot, slots), its slots consecutive in unit order.
    addresses: (buckets, 2) int64, each bucket's values and columns."""

    units: torch.Tensor
    splits: torch.Tensor
    addresses: torch.Tensor
    slots: int


def _trimmed_lengths(vals: torch.Tensor) -> torch.Tensor:
    """(nseg,) int64: each segment's lanes up to its last nonzero value
    (0 for a segment of zeros), in passes of about `_TRIM_ELEMENTS`."""
    nseg, width = vals.shape
    lane = torch.arange(1, width + 1, device=vals.device, dtype=torch.int32)
    step = max(1, _TRIM_ELEMENTS // max(width, 1))
    return torch.cat([torch.where(vals[s:s + step] != 0, lane, 0).amax(1)
                      for s in range(0, nseg, step)]).long()


def work_units(buckets, n: int, cap: int = UNIT_NNZ) -> WorkUnits:
    """Deal the nonzeros of an ELL container's `buckets` (n rows) into
    units of at most `cap`: each segment trimmed after its last nonzero
    value (what follows adds nothing under either rule) and cut into
    slices of `cap`, walking a row's segments bucket by bucket. Built
    from the buckets on their device; waits for the device (the counts
    become host integers), so it runs once per container."""
    dev = buckets[0].vals.device if buckets else torch.device("cpu")
    i64 = dict(dtype=torch.int64, device=dev)
    parts = []
    for b, bucket in enumerate(buckets):
        nseg, width = bucket.vals.shape
        if nseg == 0:
            continue
        seg_len = _trimmed_lengths(bucket.vals)
        per = (seg_len + cap - 1) // cap
        seg = torch.repeat_interleave(torch.arange(nseg, **i64), per)
        first = torch.cumsum(per, 0) - per
        k = torch.arange(seg.numel(), **i64) - first[seg]
        parts.append(torch.stack([
            torch.full_like(seg, b), seg * width + k * cap,
            torch.clamp(seg_len[seg] - k * cap, max=cap),
            bucket.out_row.long()[seg]], dim=1))
    units = torch.cat(parts) if parts else torch.empty((0, 4), **i64)
    # group each row's units (bucket by bucket, then by start: the sort is
    # stable over the buckets' order) and give the rows of several their
    # partial slots
    units = units[torch.sort(units[:, 3], stable=True).indices]
    count = torch.bincount(units[:, 3], minlength=n)
    split = count[units[:, 3]] > 1
    slot = torch.cumsum(split.long(), 0) - 1
    units[:, 3] = torch.where(split, -1 - slot, units[:, 3])
    split_rows = torch.nonzero(count > 1).flatten()
    slots_of = count[split_rows]
    splits = torch.stack([split_rows, torch.cumsum(slots_of, 0) - slots_of,
                          slots_of], dim=1)
    empty = torch.nonzero(count == 0).flatten()
    zeros = torch.zeros_like(empty)
    units = torch.cat([units, torch.stack([zeros, zeros, zeros, empty],
                                          dim=1)])
    # longest and shortest in turn: the heaviest units start first, and
    # the blocks beside them store more than they compute
    order = torch.sort(units[:, 2], descending=True, stable=True).indices
    turns = torch.empty_like(order)
    half = (order.numel() + 1) // 2
    turns[0::2] = order[:half]
    turns[1::2] = order[half:].flip(0)
    units = units[turns].contiguous()
    addresses = torch.tensor([[b.vals.data_ptr(), b.cols.data_ptr()]
                              for b in buckets], **i64).reshape(-1, 2)
    return WorkUnits(units=units, splits=splits.contiguous(),
                     addresses=addresses, slots=int(split.sum()))


def units_of(ell) -> WorkUnits:
    """`work_units` of an ELL container (``sparse_ell.EllRows``), built
    at its first use and kept in its `cache`."""
    got = ell.cache.get("gram_units")
    if got is None:
        got = ell.cache["gram_units"] = work_units(ell.buckets, ell.shape[0])
    return got


def grams_rhs_plain(ell, table, rule: GramRule):
    """The launches' function in torch, for small containers on any
    device: each unit of `units_of(ell)` summed from its own nonzeros in
    the table's type and written to its row or its slot, then each split
    row's slots added in slot order. A row that no unit or split writes
    stays NaN."""
    units = units_of(ell)
    n, r = ell.shape[0], table.shape[1]
    grams = torch.full((n, r, r), float("nan"), dtype=table.dtype,
                       device=table.device)
    rhs = torch.full((n, r), float("nan"), dtype=table.dtype,
                     device=table.device)
    part_g = torch.zeros((units.slots, r, r), dtype=table.dtype,
                         device=table.device)
    part_r = torch.zeros((units.slots, r), dtype=table.dtype,
                         device=table.device)
    for b, start, length, dst in units.units.tolist():
        g = torch.zeros((r, r), dtype=table.dtype, device=table.device)
        h = torch.zeros((r,), dtype=table.dtype, device=table.device)
        if length:
            bucket = ell.buckets[b]
            v = bucket.vals.reshape(-1)[start:start + length]
            t = table[bucket.cols.reshape(-1)[start:start + length].long()]
            g = (t * rule.weight(v).to(table.dtype)[:, None]).T @ t
            h = rule.value(v).to(table.dtype) @ t
        if dst >= 0:
            grams[dst], rhs[dst] = g, h
        else:
            part_g[-1 - dst], part_r[-1 - dst] = g, h
    for row, first, count in units.splits.tolist():
        grams[row] = part_g[first:first + count].sum(0)
        rhs[row] = part_r[first:first + count].sum(0)
    return grams, rhs


def takes(device, dtype, r) -> bool:
    """Whether `grams_rhs` launches the kernel for a table of width r in
    `dtype` on `device`."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and r <= ELL_GRAM_MAX_RANK)


def _check(ell, table, rule):
    """What #13 takes: a float32 (m, r) row-major table on a CUDA device,
    1 <= r <= `ELL_GRAM_MAX_RANK`; the container's buckets on that
    device, float32 values and int32 columns, contiguous; a `GramRule`."""
    if table.device.type != "cuda":
        raise ValueError(f"grams_rhs: the table must be on a CUDA device, "
                         f"got {table.device}")
    if table.dtype != torch.float32 or table.ndim != 2 or \
            not table.is_contiguous():
        raise TypeError(f"grams_rhs: expected a contiguous float32 (m, r) "
                        f"table, got {table.dtype} {tuple(table.shape)}")
    r = table.shape[1]
    if not 1 <= r <= ELL_GRAM_MAX_RANK:
        raise ValueError(
            f"grams_rhs: r = {r} outside 1..{ELL_GRAM_MAX_RANK}")
    for b in ell.buckets:
        if b.vals.device != table.device or b.cols.device != table.device:
            raise ValueError("grams_rhs: the buckets and the table must be "
                             "on one device")
        if b.vals.dtype != torch.float32 or b.cols.dtype != torch.int32 or \
                not (b.vals.is_contiguous() and b.cols.is_contiguous()):
            raise TypeError("grams_rhs: each bucket needs contiguous float32 "
                            "values and int32 columns, got "
                            f"{b.vals.dtype}, {b.cols.dtype}")
    if not isinstance(rule, GramRule) or rule.code not in (0, 1):
        raise TypeError(f"grams_rhs: unknown rule {rule!r}")


def grams_rhs(ell, table, rule: GramRule):
    """((n, r, r), (n, r)) float32: every row's Gram delta Σ w(v) t tᵀ
    (full, symmetric) and right-hand side Σ c(v) t over its stored
    nonzeros, t the `table` row of each column. One launch of #13, and a
    second that adds the split rows' partials where a row has several
    units; a raise for what `_check` refuses."""
    _check(ell, table, rule)
    units = units_of(ell)
    n, r = ell.shape[0], table.shape[1]
    dev = table.device
    grams = torch.empty((n, r, r), dtype=torch.float32, device=dev)
    rhs = torch.empty((n, r), dtype=torch.float32, device=dev)
    ws = torch.empty((units.slots, WS_SLOT_FLOATS), dtype=torch.float32,
                     device=dev)
    n_units, n_splits = units.units.shape[0], units.splits.shape[0]
    if n_units:
        _build.launch("nmftpu_ell_gram_f32", "ell_gram", dev,
                      units.addresses.data_ptr(), units.units.data_ptr(),
                      n_units, units.splits.data_ptr(), n_splits,
                      table.data_ptr(), r, grams.data_ptr(), rhs.data_ptr(),
                      ws.data_ptr(), rule.code, rule.alpha)
        LAUNCHES["ell_gram"] += 1 + (n_splits > 0)
    return grams, rhs
