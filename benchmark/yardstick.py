"""The benchmark's yardstick: the card's peaks, the least time a piece of
work can take on it, the operations and bytes each timed call needs,
counted from shapes, and the percentile of the latency tail.

The counts follow the rule of the port's kernel table: each input byte
read once, each output byte written once, and the operations the
algorithm needs for these inputs (nonzeros, not padded lanes).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates: float32 on the CUDA cores,
# TF32, bf16 and int8 on the tensor cores; HBM3 bandwidth
F32_PEAK = 67e12
TF32_PEAK = 495e12
BF16_PEAK = 989e12
INT8_PEAK = 1979e12
HBM_BYTES_PER_S = 3.35e12

# the peak that bounds a product, by the precision its operands run in
PEAKS = {"float32": F32_PEAK, "tf32": TF32_PEAK, "bfloat16": BF16_PEAK,
         "int8": INT8_PEAK}

_TABLE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}
# the peak of a table's product: int8 and bf16 tables multiply bf16
# queries on the bf16 tensor cores; a float32 table stays in float32
# (TF32 off)
_TABLE_PEAK = {"float32": "float32", "bfloat16": "bfloat16",
               "int8": "bfloat16"}


def bound_s(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """The least seconds the card could take for this work: the larger of
    its operations over `peak` and its bytes over the HBM rate, and which
    of the two that is."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def mu_flops_per_iteration(objective: str, n: int, m: int, r: int,
                           nnz: int) -> float:
    """Operations one sparse MU iteration (both half-steps) needs.

    KL: per half-step the sampled product (WH) at every nonzero, 2·nnz·r,
    and the numerator Σ (v / (WH)) · row, 2·nnz·r: 8·nnz·r in all (the
    denominators are row sums, O((n + m)·r)).
    Frobenius: per half-step one of V·Hᵀ or Wᵀ·V, 2·nnz·r, one Gram,
    2·(n or m)·r², and the Gram's product with the other factor,
    2·(m or n)·r²: 4·nnz·r + 4·(n + m)·r² in all."""
    if objective == "kl":
        return 8.0 * nnz * r
    if objective == "frobenius":
        return 4.0 * nnz * r + 4.0 * (n + m) * r * r
    raise ValueError(f"no operation count for objective {objective!r}")


def ell_spmm_work(n: int, m: int, r: int, nnz: int) -> tuple[float, float]:
    """(operations, bytes) of one ELL SpMM launch (#10), V·Hᵀ or Vᵀ·W:
    each nonzero's value and column read once (8 bytes), the gathered
    float32 table read once and the float32 output written once."""
    return 2.0 * nnz * r, nnz * 8.0 + (n + m) * r * 4.0


def ell_kl_work(own: int, table: int, r: int, nnz: int
                ) -> tuple[float, float]:
    """(operations, bytes) of one ELL KL numerator launch (#11), the W
    half-step (own n rows, table m) or the H half-step (own m, table n):
    at every nonzero the sampled product <own, table> and the ratio's
    product with the table row, 4·nnz·r; each nonzero's value and column
    read once (8 bytes), the own and table factors read once and the
    float32 numerator (own's shape) written once."""
    return 4.0 * nnz * r, nnz * 8.0 + (2 * own + table) * r * 4.0


def scan_work(b: int, m: int, r: int, table_dtype: str,
              out_bytes_per_row: float) -> tuple[float, float]:
    """(operations, bytes) of one scan of a (r, m) table for b float32
    queries: 2·b·m·r, the table read once, the queries read once and
    `out_bytes_per_row` written per query."""
    return (2.0 * b * m * r,
            m * r * _TABLE_BYTES[table_dtype] + b * r * 4.0
            + b * out_bytes_per_row)


def table_peak(table_dtype: str) -> float:
    return PEAKS[_TABLE_PEAK[table_dtype]]


def reservoir_scan_bound(b: int, m: int, r: int, table_dtype: str,
                         slots: int) -> float:
    """Least seconds of one reservoir scan (#8): the table once, the
    queries, and the (score, id) pair of 2 candidates per slot written
    once."""
    flops, nbytes = scan_work(b, m, r, table_dtype, 2 * slots * 8.0)
    return bound_s(flops, nbytes, table_peak(table_dtype))[0]


def count_above_bound(b: int, m: int, r: int, table_dtype: str) -> float:
    """Least seconds of one certificate count (#9): the table once, the
    queries and the per-dimension scale read, a threshold read and a
    count written per query."""
    flops, nbytes = scan_work(b, m, r, table_dtype, 8.0)
    return bound_s(flops, nbytes + r * 4.0, table_peak(table_dtype))[0]


def percentile(values, p: float) -> float:
    """The p-th percentile (0..100) of `values`, linear between ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * p / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
