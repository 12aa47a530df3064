"""The yardstick against hand counts at small shapes, and the trace
reduction on a hand-made chrome trace."""

import pytest

from benchmark import tracing, yardstick


def test_mu_operation_counts_by_hand():
    n, m, r, nnz = 5, 7, 3, 11
    # KL: per half-step a sampled product and a numerator, 2·nnz·r each
    assert yardstick.mu_flops_per_iteration("kl", n, m, r, nnz) \
        == 2 * (2 * nnz * r + 2 * nnz * r)
    # Frobenius: per half-step one SpMM (2·nnz·r), one Gram and its
    # product with the other factor (2·n·r² + 2·m·r²); 4·nnz·r, not 8
    fro = yardstick.mu_flops_per_iteration("frobenius", n, m, r, nnz)
    assert fro == 2 * (2 * nnz * r + 2 * n * r * r + 2 * m * r * r)
    assert fro - 4 * (n + m) * r * r == 4 * nnz * r
    with pytest.raises(ValueError):
        yardstick.mu_flops_per_iteration("beta", n, m, r, nnz)


def test_spmm_and_scan_work_by_hand():
    flops, nbytes = yardstick.ell_spmm_work(4, 6, 2, 10)
    assert flops == 2 * 10 * 2
    assert nbytes == 10 * (4 + 4) + 4 * 2 * 4 + 6 * 2 * 4
    # #11's W half: own W (4 rows) read and its numerator written, H (6
    # rows) read; a sampled product and a ratio times a row a nonzero
    flops, nbytes = yardstick.ell_kl_work(4, 6, 2, 10)
    assert flops == 2 * 10 * 2 + 2 * 10 * 2
    assert nbytes == 10 * (4 + 4) + (4 + 4 + 6) * 2 * 4
    flops, nbytes = yardstick.scan_work(3, 100, 8, "int8", 16)
    assert flops == 2 * 3 * 100 * 8
    assert nbytes == 100 * 8 * 1 + 3 * 8 * 4 + 3 * 16
    assert yardstick.scan_work(3, 100, 8, "float32", 0)[1] == \
        100 * 8 * 4 + 3 * 8 * 4


def test_bound_takes_the_larger_side():
    s, by = yardstick.bound_s(67e12, 1.0, yardstick.F32_PEAK)
    assert by == "operations" and s == pytest.approx(1.0)
    s, by = yardstick.bound_s(1.0, 3.35e12, yardstick.F32_PEAK)
    assert by == "bytes" and s == pytest.approx(1.0)
    # the serving kernels' bound at config 5 (the port's kernel table)
    ms = yardstick.reservoir_scan_bound(512, 10_485_760, 256, "int8",
                                        4096) * 1e3
    assert ms == pytest.approx(2.779, abs=1e-3)
    assert yardstick.table_peak("int8") == yardstick.BF16_PEAK
    assert yardstick.table_peak("float32") == yardstick.F32_PEAK


def test_percentile():
    assert yardstick.percentile(list(range(101)), 95) == pytest.approx(95)
    assert yardstick.percentile([1.0, 2.0], 50) == pytest.approx(1.5)


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


HAND_TRACE = [
    _x("bench.request", "user_annotation", 0, 1000),
    _x("aten::mm", "cpu_op", 10, 50),
    _x("cudaStreamSynchronize", "cuda_runtime", 400, 500),
    _x("void ell_spmm_kernel<float, 4, 2>", "kernel", 100, 200),
    _x("ampere_sgemm_128x64", "kernel", 250, 100),      # overlaps
    _x("count_tc_kernel<int8>", "kernel", 600, 100),
    _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 800, 50),
    {"ph": "i", "name": "marker", "cat": "kernel", "ts": 5},
]


def test_kernel_classes():
    assert tracing.kernel_class("void ell_spmm_kernel<float>") == \
        "ell_rowsums"
    assert tracing.kernel_class("void ell_kl_kernel<float, 4, 2>") == \
        "ell_kl"
    assert tracing.kernel_class("reservoir_merge_kernel") == \
        "reservoir_scan"
    assert tracing.kernel_class("count_band_kernel<b>") == "count_above"
    assert tracing.kernel_class("void at::native::indexSelectLargeIndex") \
        == "gather"
    assert tracing.kernel_class("sm90_xmma_gemm") == "gemm"
    assert tracing.kernel_class("void at::native::sbtopk::gatherTopK") \
        == "gather"
    assert tracing.kernel_class("radixSortKVInPlace") == "topk_sort"


def test_device_summary_on_a_hand_made_trace():
    s = tracing.device_summary(HAND_TRACE)
    # union of [100, 350], [600, 700], [800, 850] µs
    assert s["busy_s"] == pytest.approx((250 + 100 + 50) / 1e6)
    assert s["span_s"] == pytest.approx(750 / 1e6)
    assert s["classes"]["ell_rowsums"] == {"seconds": 200e-6, "events": 1}
    assert s["classes"]["gemm"]["seconds"] == pytest.approx(100e-6)
    assert s["classes"]["count_above"]["events"] == 1


def test_idle_gaps_named_by_the_host():
    r = tracing.reduce_trace(HAND_TRACE)
    gaps = dict(r["breakdown"]["idle_gaps"])
    # busy [100, 350], [600, 700], [800, 850]; the host from 0 to 1000.
    # 0..100 and 350..600 start inside the request span alone (aten::mm
    # ended at 60, the synchronize starts at 400); 700..800 and
    # 850..1000 start inside the synchronize
    assert gaps["bench.request"] == pytest.approx((100 + 250) / 1e6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx((100 + 150) / 1e6)
    assert r["breakdown"]["device_ops"][0] == ["ell_rowsums", 200e-6]
    assert len(r["breakdown"]["device_ops"]) <= tracing.TOP
