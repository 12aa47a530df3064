"""The ELL MU-KL numerator's kernel module on the CPU: the plain twin of
#11 (`sparse_ell.kl_numerator_ell`) against `sampled_rowsums_ell` with
the ratio coefficient and a float64 oracle, the ELL engine's KL update
(`sparse_ell.mu_update_kl_ell` with #11's wrapper as its numerator, with
or without use_pallas) against the plain rule, bit for bit, and the
wrapper's operand checks. The CUDA kernel itself is held against its twin on the card by
test_torch_kernels_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nmftpu_torch import sparse as S  # noqa: E402
from nmftpu_torch import sparse_ell as SE  # noqa: E402
from nmftpu_torch.config import NmfConfig, Objective  # noqa: E402
from nmftpu_torch.kernels import sparse_ell_kernel as SEK  # noqa: E402
from nmftpu_torch.sparse_ops import _ell_ops_bundle  # noqa: E402
from nmftpu_torch.utils.metrics import counters  # noqa: E402

EPS = 1e-9
# the float64 oracle against the float32 twin: sums of <= 512 positive
# ratios, each sample a dot of <= 100 terms, ~(sqrt(512) + sqrt(100)) *
# 2^-24 = 2e-6 apart; float64 to roundoff
ORACLE_RTOL = {torch.float32: 2e-5, torch.float64: 1e-11}

# (seg_max, bucket widths, chunk_segments): every default width with rows
# split over several 512-wide segments, and narrow buckets padded with
# all-zero segments to a multiple of 8
LAYOUTS = {
    "default": dict(seg_max=512, buckets=SE.DEFAULT_BUCKETS,
                    chunk_segments=2048),
    "narrow": dict(seg_max=16, buckets=(4, 8, 16), chunk_segments=8),
}


def _matrix(seed=0, n=160, m=1400):
    """Nonnegative n x m: most rows hold 1..12 nonzeros, rows of every
    bucket width up to 512 and rows of 600 and 1,200 (split at 512), an
    empty row, and an explicit zero every 9th stored value."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 13, n)
    lens[10:20] = (24, 48, 96, 192, 384, 500, 512, 600, 1200, 0)
    a = np.zeros((n, m), np.float64)
    for i, k in enumerate(lens):
        a[i, rng.choice(m, k, replace=False)] = rng.uniform(0.5, 5.0, k)
    csr = S.from_dense(a).to_csr()
    data = np.asarray(csr.data).copy()
    data[::9] = 0.0
    return S.SparseCSR(csr.indptr, csr.indices, data, csr.shape)


def _pair(dtype, layout):
    return SE.build_ell_pair(_matrix(), dtype=dtype, device="cpu",
                             **LAYOUTS[layout])


def _factors(n, m, r, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, r, generator=g, dtype=dtype) + 0.05,
            torch.rand(r, m, generator=g, dtype=dtype) + 0.05)


def _oracle(mat, own, table):
    """Σ_k v_k / (<own[i], table[k]> + eps) · table[k] in float64, dense."""
    v = torch.from_numpy(np.asarray(mat.todense(), np.float64))
    o, t = own.double(), table.double()
    ratio = torch.where(v != 0, v / (o @ t.T + EPS), torch.zeros_like(v))
    return ratio @ t


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("r", [1, 3, 64, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_twin_is_sampled_rowsums_with_the_ratio(layout, r, dtype):
    """Both halves: the twin (and the wrapper on CPU tensors, which runs
    it) gives sampled_rowsums_ell's bits with the ratio coefficient, and
    the float64 oracle to roundoff; nothing is launched."""
    pair = _pair(dtype, layout)
    n, m = pair.shape
    widths = {b.width for b in pair.rows.buckets}
    if layout == "default":
        assert widths == set(SE.DEFAULT_BUCKETS)
    else:
        assert any(not bool(b.vals.any(1).all()) for b in pair.rows.buckets)
    W, H = _factors(n, m, r, dtype)
    ratio = (lambda v, s: v / (s + EPS),)
    csr = _matrix()
    before = SEK.LAUNCHES["ell_kl"]
    for ell, own, table, dense in (
            (pair.rows, W, H.T, csr),
            (pair.cols, H.T, W, csr.T)):
        want, = SE.sampled_rowsums_ell(ell, own, table.T, ratio)
        got = SE.kl_numerator_ell(ell, own, table, EPS)
        assert got.dtype == dtype and got.shape == (ell.shape[0], r)
        assert torch.equal(got, want)
        assert torch.equal(SEK.ell_kl(ell, own, table, EPS), want)
        exact = _oracle(dense, own, table)
        err = float((got.double() - exact).abs().max() / exact.abs().max())
        assert err < ORACLE_RTOL[dtype]
    assert SEK.LAUNCHES["ell_kl"] == before


def _today(pair, W, H, eps, order):
    """The ELL KL step as the engine ran it before #11: the fused
    gather-once ratio + SpMM on each container, written out."""
    from nmftpu_torch.linalg.dense import _apply_order

    ratio = (lambda v, s: v / (s + eps),)

    def upd_w(W, H):
        numer, = SE.sampled_rowsums_ell(pair.rows, W, H, ratio)
        return W * (numer / torch.clamp(H.sum(1), min=eps)[None, :])

    def upd_h(W, H):
        numer, = SE.sampled_rowsums_ell(pair.cols, H.T, W.T, ratio)
        return H * (numer.T / torch.clamp(W.sum(0), min=eps)[:, None])

    return _apply_order(upd_w, upd_h, W, H, order)


@pytest.mark.parametrize("order", ["WH", "HW"])
@pytest.mark.parametrize("dtype,use_pallas", [
    (torch.float32, False), (torch.float32, True),
    # the config refuses use_pallas under float64
    (torch.float64, False)])
def test_engine_kl_update_keeps_the_plain_bits(order, dtype, use_pallas):
    """The ELL engine's MU-KL update on CPU tensors (routed to #11's step
    with or without use_pallas) gives sparse_ell.mu_update_kl_ell's W and
    H, and the step as it was written before the route, bit for bit;
    launches.ell_kl stays 0."""
    pair = _pair(dtype, "default")
    n, m = pair.shape
    W, H = _factors(n, m, 16, dtype, seed=3)
    cfg = NmfConfig(rank=16, objective=Objective.KL, update_order=order,
                    use_pallas=use_pallas,
                    dtype="float64" if dtype == torch.float64 else "float32")
    before = counters()["launches.ell_kl"]
    got = _ell_ops_bundle(cfg).update(pair, (), W, H)
    assert counters()["launches.ell_kl"] == before
    for want in (SE.mu_update_kl_ell(pair, W, H, eps=cfg.eps, order=order),
                 _today(pair, W, H, cfg.eps, order)):
        for x, y in zip(got, want):
            assert x.dtype == dtype and torch.equal(x, y)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_engine_kl_update_looks_up_the_rule_when_called(monkeypatch,
                                                        use_pallas):
    """The ELL engine's MU-KL update calls sparse_ell.mu_update_kl_ell
    through the module at every step, with #11's wrapper as its
    numerator, so a rule put in its place there (as the benchmark's
    planted faults do) is the rule the engine runs."""
    seen = []

    def rule(pair, W, H, *args, **kw):
        seen.append(kw.get("numerator"))
        return W, H

    pair = _pair(torch.float32, "narrow")
    n, m = pair.shape
    W, H = _factors(n, m, 4, torch.float32)
    update = _ell_ops_bundle(NmfConfig(rank=4, objective=Objective.KL,
                                       use_pallas=use_pallas)).update
    monkeypatch.setattr(SE, "mu_update_kl_ell", rule)
    got = update(pair, (), W, H)
    assert seen == [SEK.ell_kl]
    assert got[0] is W and got[1] is H


def _kl_operands(r=8, dtype=torch.float32):
    pair = _pair(dtype, "narrow")
    n, m = pair.shape
    W, H = _factors(n, m, r, dtype)
    return pair.rows, W, H.T.contiguous()


def _replace_bucket(ell, **fields):
    import dataclasses

    b = dataclasses.replace(ell.buckets[0], **fields)
    return dataclasses.replace(ell, buckets=(b, *ell.buckets[1:]))


@pytest.mark.parametrize("case,exc,match", [
    ("table float16", TypeError, "float32 or float64"),
    ("table 1-D", TypeError, "2-D"),
    ("table strided", ValueError, "table must be contiguous"),
    ("own float64", ValueError, "own must be a contiguous"),
    ("own strided", ValueError, "own must be a contiguous"),
    ("own wrong r", ValueError, "own must be a contiguous"),
    ("own wrong rows", ValueError, "container's"),
    ("out_row int64", ValueError, "out_row must be a contiguous int32"),
    ("out_row short", ValueError, "out_row must be a contiguous int32"),
    ("cols int64", TypeError, "int32"),
    ("vals float64", TypeError, "float32"),
    ("r beyond one pass", ValueError, "exceeds one pass"),
])
def test_kl_wrapper_checks_what_the_kernel_takes(case, exc, match):
    """What a CUDA launch of #11 checks first, exercised on CPU tensors
    (the check reads types, shapes and strides only)."""
    ell, own, table = _kl_operands()
    b = ell.buckets[0]
    if case == "table float16":
        table = table.half()
    elif case == "table 1-D":
        table = table[:, 0].contiguous()
    elif case == "table strided":
        table = table.T.contiguous().T
    elif case == "own float64":
        own = own.double()
    elif case == "own strided":
        own = own.T.contiguous().T
    elif case == "own wrong r":
        own = own[:, :4].contiguous()
    elif case == "own wrong rows":
        own = own[:-1].contiguous()
    elif case == "out_row int64":
        ell = _replace_bucket(ell, out_row=b.out_row.long())
    elif case == "out_row short":
        ell = _replace_bucket(ell, out_row=b.out_row[:-1].contiguous())
    elif case == "cols int64":
        ell = _replace_bucket(ell, cols=b.cols.long())
    elif case == "vals float64":
        ell = _replace_bucket(ell, vals=b.vals.double())
    elif case == "r beyond one pass":
        ell, own, table = _kl_operands(r=257)
    with pytest.raises(exc, match=match):
        SEK._check_kl(ell, own, table)


@pytest.mark.parametrize("dtype,r", [(torch.float32, 256),
                                     (torch.float64, 128)])
def test_kl_wrapper_takes_one_pass_rows(dtype, r):
    """The widest rows one pass covers pass the checks; one column more
    does not."""
    ell, own, table = _kl_operands(r, dtype)
    SEK._check_kl(ell, own, table)
    assert SEK.KL_MAX_RANK[dtype] == r
    ell, own, table = _kl_operands(r + 1, dtype)
    with pytest.raises(ValueError, match="exceeds one pass"):
        SEK._check_kl(ell, own, table)


def test_counters_report_the_kl_launches():
    snap = counters()
    assert snap["launches.ell_kl"] == SEK.LAUNCHES["ell_kl"]
    assert "launches.ell_rowsums" in snap
