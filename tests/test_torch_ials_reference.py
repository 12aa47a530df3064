"""The port's iALS on the ELL plan (`prepare_sparse(..., strategy="ell")`
then `SparsePlan.run`, the path of the benchmark's training cells)
against the benchmark's plain float64 reference
(`benchmark/reference/train_ials.py`) on tiny click matrices; its spans
and counters under `torch.profiler` on the CPU; and the per-row Grams'
default budget, which follows the device.

Tolerances, against the float64 reference after 10 iterations from the
same start:
* W and H, the largest difference over the reference's largest entry,
  at RTOL_FACTOR = 1e-3: each float32 half-step solves rows whose systems
  reach a condition number of a few hundred (the ridge holds them below
  1 / (100 · 2^-23) ≈ 8.4e4), so each solve lands within about
  κ · 2^-24 ≈ 3e-5 of float64's, and ten iterations of clamped solves
  carry it forward (the port reads 2.6e-5 to 6.0e-5 on these seeds);
* the error ||V - WH||_F, relative, at RTOL_ERR = 1e-5: it moves with
  the factors' error only where the fit is off its optimum (the port
  reads 7e-8 to 1.6e-6).
The TF32 control (every operand of a product rounded to 10 mantissa
bits, the solves in float32) reads 1.0e-2 to 2.1e-2 on W and H: it
fails.
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import nmftpu_torch as nt  # noqa: E402
from benchmark.reference import train_ials as RI  # noqa: E402
from nmftpu_torch import sparse_ell as TE  # noqa: E402
from nmftpu_torch import sparse_ops as TS  # noqa: E402
from nmftpu_torch.config import NmfConfig  # noqa: E402
from nmftpu_torch.sparse import SparseCSR  # noqa: E402
from nmftpu_torch.utils import counters  # noqa: E402

N, M, R = 240, 160, 16
ALPHA, LAM, EPS = 40.0, 0.1, 1e-9
ITERS = 10
RTOL_FACTOR = 1e-3
RTOL_ERR = 1e-5
SEEDS = [0, 1, 2**31 + 77]
CPU = [torch.profiler.ProfilerActivity.CPU]


def _clicks(seed, n=N, m=M, clicks=2400, floor=5):
    """A click matrix (every value 1): at least `floor` items a user,
    items by Zipf-like popularity, the last item never clicked. Returns
    the host CSR and row-sorted COO tensors."""
    rng = np.random.default_rng(seed)
    extra = rng.multinomial(clicks - floor * n, np.ones(n) / n)
    pop = 1.0 / np.arange(1, m) ** 0.9
    rows, cols = [], []
    for u, k in enumerate(floor + extra):
        items = np.sort(rng.choice(m - 1, k, replace=False,
                                   p=pop / pop.sum()))
        rows.append(np.full(k, u))
        cols.append(items)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    vals = np.ones(rows.size, np.float32)
    csr = SparseCSR(indptr, cols.astype(np.int32), vals, (n, m))
    return csr, (torch.as_tensor(rows), torch.as_tensor(cols),
                 torch.as_tensor(vals))


def _start(seed, n=N, m=M, r=R, nnz=2400):
    """(W0, H0) uniform, scaled to the clicks' mean as the benchmark's
    kinds scale them."""
    gen = torch.Generator().manual_seed(seed + 1)
    scale = (nnz / (n * m) / r) ** 0.5
    return (torch.rand(n, r, generator=gen).add_(1e-4).mul_(scale),
            torch.rand(r, m, generator=gen).add_(1e-4).mul_(scale))


def _config(iters=ITERS, solver="exact", check=5):
    return NmfConfig(rank=R, algorithm="als", alpha_confidence=ALPHA,
                     lambda_w=LAM, lambda_h=LAM, als_solver=solver,
                     init_method="copy_existing", num_iterations=iters,
                     check_interval=check, threshold_value=0.0, eps=EPS)


def _port(csr, W0, H0, **kw):
    cfg = _config(**kw)
    plan = nt.prepare_sparse(csr, cfg, strategy="ell", device="cpu")
    assert plan.strategy == "ell"
    return plan.run(W0=W0, H0=H0)


def _gaps(W, H, err, ref):
    Wr, Hr, er = ref
    return {"w": float((W.double() - Wr).abs().max() / Wr.abs().max()),
            "h": float((H.double() - Hr).abs().max() / Hr.abs().max()),
            "err": abs(float(err) - er) / er}


def _reference(coo, W0, H0, precision="float64"):
    return RI.fit(*coo, N, M, W0, H0, ALPHA, LAM, LAM, ITERS, EPS,
                  precision=precision)


@pytest.mark.parametrize("seed", SEEDS)
def test_port_matches_the_float64_reference(seed):
    csr, coo = _clicks(seed)
    W0, H0 = _start(seed)
    res = _port(csr, W0, H0)
    assert res.num_iterations == ITERS
    g = _gaps(res.W, res.H, res.frobenius_error, _reference(coo, W0, H0))
    assert g["w"] <= RTOL_FACTOR and g["h"] <= RTOL_FACTOR, g
    assert g["err"] <= RTOL_ERR, g


@pytest.mark.parametrize("seed", SEEDS)
def test_the_tf32_control_fails_the_comparison(seed):
    _, coo = _clicks(seed)
    W0, H0 = _start(seed)
    Wc, Hc, ec = _reference(coo, W0, H0, precision="tf32")
    assert Wc.dtype == torch.float32
    g = _gaps(Wc, Hc, ec, _reference(coo, W0, H0))
    assert (g["w"] > RTOL_FACTOR or g["h"] > RTOL_FACTOR
            or g["err"] > RTOL_ERR), g


def test_reference_blocks_split_wide_rows(monkeypatch):
    """Blocks of a few gathered slots (so rows split across passes and
    blocks hold one row) give the same fit as one block a side, to
    float64's rounding: the sums run in another order, and ten
    iterations carry their last bits forward (3e-11 seen)."""
    _, coo = _clicks(3)
    W0, H0 = _start(3)
    whole = _reference(coo, W0, H0)
    monkeypatch.setattr(RI, "BLOCK_BYTES", 8 * R * 7)
    split = _reference(coo, W0, H0)
    for a, b in zip(whole[:2], split[:2]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)
    assert whole[2] == pytest.approx(split[2], rel=1e-12)


def test_reference_one_half_solves_its_normal_equations():
    """The reference's first W half-step against each row's system built
    densely in float64 and solved by LU, the ridge as documented (the H
    half that follows leaves W as it is)."""
    _, coo = _clicks(4)
    W0, H0 = _start(4)
    Hd = H0.double()
    W1, _, _ = RI.fit(*coo, N, M, W0, H0, ALPHA, LAM, LAM, 1, EPS)
    V = torch.zeros(N, M, dtype=torch.float64)
    V[coo[0], coo[1]] = 1.0
    for u in (0, 17, 101, N - 1):
        c = 1.0 + ALPHA * V[u]
        A = (Hd * c[None, :]) @ Hd.T
        A += (LAM + EPS + RI.REL_RIDGE * torch.diagonal(A).mean()) \
            * torch.eye(R, dtype=torch.float64)
        want = torch.clamp(torch.linalg.solve(A, Hd @ (c * V[u])), min=0.0)
        torch.testing.assert_close(W1[u], want, rtol=1e-10, atol=1e-13)


def _span_names(prof, tmp_path):
    import json

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in events if e.get("ph") == "X"
            and e.get("name", "").startswith("nmftpu.")]


@pytest.mark.parametrize("solver", ["exact", "cg"])
def test_a_fit_marks_grams_and_solves_and_counts_rows(tmp_path, solver):
    csr, _ = _clicks(5)
    W0, H0 = _start(5)
    iters = 4
    before = counters()
    with torch.profiler.profile(activities=CPU) as prof:
        res = _port(csr, W0, H0, iters=iters, solver=solver, check=2)
    after = counters()
    assert {f"ials.{k}" for k in TE.IALS_COUNTS} <= set(before)
    assert all(type(after[f"ials.{k}"]) is int for k in TE.IALS_COUNTS)
    moved = {k: v - before[k] for k, v in after.items()}
    names = _span_names(prof, tmp_path)
    assert res.num_iterations == iters
    assert names.count("nmftpu.loop.update") == iters
    assert names.count("nmftpu.ials.grams") == 2 * iters
    assert names.count("nmftpu.ials.solve") == 2 * iters
    assert moved["ials.rows_solved"] == iters * (N + M)
    plan = nt.prepare_sparse(csr, _config(), strategy="ell", device="cpu")
    segments = sum(b.vals.shape[0] for ell in (plan.operand.rows,
                                               plan.operand.cols)
                   for b in ell.buckets)
    assert moved["ials.gram_segments"] == iters * segments


def test_spans_leave_the_fit_bit_identical():
    csr, _ = _clicks(6)
    W0, H0 = _start(6)
    plain = _port(csr, W0, H0, iters=3)
    with torch.profiler.profile(activities=CPU):
        traced = _port(csr, W0, H0, iters=3)
    assert torch.equal(plain.W, traced.W) and torch.equal(plain.H, traced.H)


# -- the per-row Grams' default budget ---------------------------------------

# BASELINE config 3 at Liang et al.'s shape: (136,677 + 20,108) · 128² · 4
# bytes = 9.57 GiB of Grams
C3 = (136_677, 20_108, 128)
GIB = 2**30


def _card(monkeypatch, total):
    """A CUDA device of `total` bytes, as torch would describe it; no card
    is needed."""
    seen = []

    def props(dev):
        seen.append(dev)
        return types.SimpleNamespace(total_memory=total)

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    return seen


def _refusal(*args):
    try:
        TS._check_weighted_gram_budget(*args)
    except ValueError as e:
        return str(e)
    return ""


@pytest.mark.parametrize("device", [None, "cpu", torch.device("cpu")])
def test_default_budget_is_8_gib_off_a_card(monkeypatch, device):
    monkeypatch.delenv("NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES", raising=False)
    assert TS._default_weighted_gram_budget(device) == 8 * GIB
    msg = _refusal(*C3, device)
    assert "9.6 GiB" in msg and "over the 8.0 GiB budget" in msg, msg


@pytest.mark.parametrize("total,fits", [(80 * 10**9, True),
                                        (16 * 10**9, False),
                                        (24 * GIB, True)],
                         ids=["h100-80gb", "16gb", "24gib"])
def test_default_budget_is_half_the_card(monkeypatch, total, fits):
    monkeypatch.delenv("NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES", raising=False)
    seen = _card(monkeypatch, total)
    dev = torch.device("cuda", 0)
    assert TS._default_weighted_gram_budget(dev) == total // 2
    assert seen == [dev]
    msg = _refusal(*C3, dev)
    if fits:
        assert msg == ""
    else:
        assert f"over the {total // 2 / GIB:.1f} GiB budget" in msg, msg


@pytest.mark.parametrize("device", ["cpu", torch.device("cuda", 0)],
                         ids=["cpu", "cuda"])
def test_the_variable_overrides_the_default(monkeypatch, device):
    _card(monkeypatch, 80 * 10**9)
    monkeypatch.setenv("NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES", str(16 * GIB))
    assert _refusal(*C3, device) == ""
    monkeypatch.setenv("NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES", str(GIB))
    assert "over the 1.0 GiB budget" in _refusal(*C3, device)


def test_a_plan_checks_the_budget_of_its_own_device(monkeypatch):
    """prepare_sparse and SparsePlan.run hand the layout's device to the
    check: a CPU plan keeps the 8 GiB default, whatever a card would
    allow."""
    monkeypatch.delenv("NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES", raising=False)
    seen = []
    real = TS._check_weighted_gram_budget

    def spy(n, m, rank, device=None):
        seen.append(torch.device(device).type)
        return real(n, m, rank, device)

    monkeypatch.setattr(TS, "_check_weighted_gram_budget", spy)
    csr, _ = _clicks(7)
    plan = nt.prepare_sparse(csr, _config(iters=1), strategy="ell",
                             device="cpu")
    plan.run(W0=_start(7)[0], H0=_start(7)[1])
    assert seen == ["cpu", "cpu"]
