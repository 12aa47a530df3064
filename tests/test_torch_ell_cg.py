"""The matrix-free iALS CG half-step on ELL (`sparse_ell.cg_half_ell`) and
the rule of #11 it runs on (`kernels.sparse_ell_kernel.ell_cg`, whose
plain twin is `sparse_ell.cg_product_ell`).

On the CPU: the twin against an explicit loop over the stored values in
float64, and the wrapper on CPU tensors, which runs the twin and
launches nothing; the half-step against the iteration it must repeat,
`linalg.dense._batched_solve_clamped_cg` on every row's system built in
float64 from the dense matrix, to 1e-10, with warm starts, a row frozen
from its first step and steps past r; in float32 against today's
materialized route (`grams_and_rhs_ell`, then `row_solver("cg")`),
each against float64 CG on the same rows; the ELL engine's cg run, which
builds no (rows, r, r) tensor and never reaches `grams_and_rhs_ell`, the
counts and spans of its half-steps.

On the card (marked `cuda`, skipped without a device): #11's CG rule
against its twin at r = 64, 128 and 256 (and float64 up to 128), one
launch a container; an iALS cg fit through `prepare_sparse` with its
launches, each half-step against float64 CG. This file imports no jax,
so on the card's machine run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_ell_cg.py

Tolerances: float64 against float64 to roundoff, 1e-10; a float32
half-step's error against float64 CG on the same systems at most twice
the materialized route's, or within 10 kappa u (u = 2^-24, kappa the
largest condition number of the rows' systems), the rule of
tests/test_torch_ials.py for two float32 CG runs; the kernel against its
twin as #11's KL rule, RULE_RTOL of the largest entry.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmftpu_torch as nt  # noqa: E402
from nmftpu_torch import sparse as S  # noqa: E402
from nmftpu_torch import sparse_ell as SE  # noqa: E402
from nmftpu_torch.config import Initialization, NmfConfig  # noqa: E402
from nmftpu_torch.kernels import sparse_ell_kernel as SEK  # noqa: E402
from nmftpu_torch.linalg import dense as TD  # noqa: E402
from nmftpu_torch.utils.metrics import counters  # noqa: E402

U32 = 2.0 ** -24
EPS = 1e-9
ALPHA, LAM = 5.0, 0.05
# r = 12 is no bucket width (powers of two), so a (k, 12, 12) tensor can
# only be a row system
RANK = 12
RULE_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _csr(seed=0, n=200, m=150, density=0.1):
    """Ratings 1..5 at `density`, a long row (3), an empty row (5) and
    column (7), every 9th stored value an explicit zero."""
    rng = np.random.default_rng(seed)
    a = np.where(rng.random((n, m)) < density, rng.integers(1, 6, (n, m)),
                 0).astype(np.float64)
    a[3, rng.choice(m, 4 * m // 5, replace=False)] = 1.0
    a[5, :] = 0.0
    a[:, 7] = 0.0
    csr = S.from_dense(a).to_csr()
    data = np.asarray(csr.data).copy()
    data[::9] = 0.0
    csr = S.SparseCSR(csr.indptr, csr.indices, data, csr.shape)
    return csr, np.asarray(csr.todense(), np.float64)


def _factors(n, m, r=RANK, dtype=torch.float64, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, r, generator=g, dtype=dtype) * 0.9 + 0.1,
            torch.rand(r, m, generator=g, dtype=dtype) * 0.9 + 0.1)


def _systems(dense, table):
    """Every row's iALS system G + Σ αv t tᵀ (rows, r, r) and right-hand
    side Σ v(1 + αv) t (rows, r) in float64, from the dense matrix."""
    V = torch.as_tensor(dense, dtype=torch.float64)
    T = table.double()
    A = torch.einsum("mr,um,ms->urs", T, ALPHA * V, T) + (T.T @ T)[None]
    return A, (V * (1.0 + ALPHA * V)) @ T


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs()
                 .max())


# ---------------------------------------------------------------------------
# the rule's twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", ["rows", "cols"])
def test_twin_matches_an_explicit_loop(side):
    """Σ_k α v_k <own[row], table[col_k]> table[col_k], nonzero by
    nonzero, on signed rows (a CG direction has both signs)."""
    csr, dense = _csr(seed=2)
    pair = SE.build_ell_pair(csr, dtype=torch.float64, device="cpu")
    W, H = _factors(*dense.shape, seed=3)
    ell, own, table, V = ((pair.rows, W - 0.5, H.T.contiguous(), dense)
                          if side == "rows" else
                          (pair.cols, H.T - 0.5, W, dense.T))
    want = torch.zeros_like(own)
    for i, j in zip(*np.nonzero(V)):
        c = ALPHA * V[i, j] * float(own[i] @ table[j])
        want[i] += c * table[j]
    got = SE.cg_product_ell(ell, own.contiguous(), table, ALPHA)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_wrapper_on_cpu_tensors_runs_the_twin():
    csr, dense = _csr(seed=4)
    pair = SE.build_ell_pair(csr, device="cpu")
    W, H = _factors(*dense.shape, dtype=torch.float32, seed=5)
    before = SEK.LAUNCHES["ell_cg"]
    got = SEK.ell_cg(pair.rows, W, H.T.contiguous(), ALPHA)
    assert SEK.LAUNCHES["ell_cg"] == before
    assert torch.equal(got, SE.cg_product_ell(pair.rows, W,
                                              H.T.contiguous(), ALPHA))


# ---------------------------------------------------------------------------
# the half-step against the materialized iteration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [1, 3, 20])
@pytest.mark.parametrize("side", ["rows", "cols"])
def test_half_step_is_the_materialized_cg_in_float64(side, steps):
    """The same warm start, the same steps, the same ridge: to 1e-10 of
    `_batched_solve_clamped_cg` on the rows' systems. The empty row (5)
    starts at 0, so its residual is 0 and it freezes at once; 20 steps
    run past r and past convergence."""
    csr, dense = _csr(seed=6)
    pair = SE.build_ell_pair(csr, dtype=torch.float64, device="cpu")
    W, H = _factors(*dense.shape, seed=7)
    W[5] = 0.0
    ell, table, x0, V = ((pair.rows, H.T.contiguous(), W, dense)
                         if side == "rows" else
                         (pair.cols, W, H.T, dense.T))
    got = SE.cg_half_ell(ell, table, x0, LAM, EPS, ALPHA, steps)
    A, rhs = _systems(V, table)
    want = TD._batched_solve_clamped_cg(A, rhs, LAM, EPS, x0, steps=steps)
    assert got.dtype == torch.float64 and got.shape == x0.shape
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)
    if side == "rows":
        assert torch.equal(got[5], torch.zeros(RANK, dtype=torch.float64))


def test_a_warm_start_at_the_solution_stays_there():
    """From the exact solution the residual is roundoff: one more half
    step moves no row beyond it."""
    csr, dense = _csr(seed=8)
    pair = SE.build_ell_pair(csr, dtype=torch.float64, device="cpu")
    _, H = _factors(*dense.shape, seed=9)
    table = H.T.contiguous()
    A, rhs = _systems(dense, table)
    exact = torch.linalg.solve(TD._ridged(A, LAM, EPS), rhs[..., None])[
        ..., 0]
    got = SE.cg_half_ell(pair.rows, table, exact, LAM, EPS, ALPHA, 3)
    torch.testing.assert_close(got, torch.clamp(exact, min=0.0),
                               rtol=1e-10, atol=1e-12)


def _cg64(V, table, x0, steps):
    A, rhs = _systems(V, table)
    return (TD._batched_solve_clamped_cg(A, rhs, LAM, EPS, x0.double(),
                                         steps=steps),
            float(torch.linalg.cond(TD._ridged(A, LAM, EPS)).max()))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("side", ["rows", "cols"])
def test_half_step_in_float32_against_the_materialized_route(side, steps):
    """float32 against today's route (`grams_and_rhs_ell`, then
    `row_solver("cg")`): each against float64 CG from the same start, the
    matrix-free error at most twice the route's, or within 10 kappa u."""
    csr, dense = _csr(seed=10)
    pair = SE.build_ell_pair(csr, device="cpu")
    W, H = _factors(*dense.shape, dtype=torch.float32, seed=11)
    ell, table, x0, V = ((pair.rows, H.T.contiguous(), W, dense)
                         if side == "rows" else
                         (pair.cols, W, H.T, dense.T))
    got = SE.cg_half_ell(ell, table, x0, LAM, EPS, ALPHA, steps)
    dG, rhs = SE.grams_and_rhs_ell(ell, table, lambda v: ALPHA * v,
                                   lambda v: v * (1.0 + ALPHA * v))
    route = TD.row_solver("cg", steps)(table.T @ table, dG, rhs, LAM, EPS,
                                       x0)
    want, kappa = _cg64(V, table, x0, steps)
    assert got.dtype == torch.float32
    err, route_err = _rel(got, want), _rel(route, want)
    assert err <= max(2 * route_err, 10 * kappa * U32), (err, route_err,
                                                         kappa)


# ---------------------------------------------------------------------------
# the engine's cg run
# ---------------------------------------------------------------------------


def _config(iters, steps=3):
    return NmfConfig(rank=RANK, algorithm="als", alpha_confidence=ALPHA,
                     lambda_w=LAM, lambda_h=LAM, als_solver="cg",
                     cg_steps=steps,
                     init_method=Initialization.COPY_EXISTING,
                     num_iterations=iters, check_interval=iters,
                     threshold_value=0.0, eps=EPS)


def test_a_cg_run_builds_no_row_system(monkeypatch):
    """Every operator's output shape over a 3-iteration cg fit on ELL:
    none is a stack of (r, r) systems, and `grams_and_rhs_ell` and the
    row solver are never reached."""
    from torch.utils._python_dispatch import TorchDispatchMode

    def refuse(*args, **kw):
        raise AssertionError("the cg route built per-row Grams")

    monkeypatch.setattr(SE, "grams_and_rhs_ell", refuse)
    monkeypatch.setattr(TD, "_batched_solve_clamped_cg", refuse)
    shapes = []

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    shapes.append(tuple(t.shape))
            return out

    csr, dense = _csr(seed=12)
    W0, H0 = _factors(*dense.shape, dtype=torch.float32, seed=13)
    plan = nt.prepare_sparse(csr, _config(3), strategy="ell", device="cpu")
    with Shapes():
        res = plan.run(W0=W0, H0=H0)
    assert res.num_iterations == 3 and torch.isfinite(res.W).all()
    assert shapes
    assert not [s for s in shapes if len(s) >= 3
                and s[-2:] == (RANK, RANK)]


def test_a_cg_run_counts_its_products_and_rows():
    csr, dense = _csr(seed=14)
    W0, H0 = _factors(*dense.shape, dtype=torch.float32, seed=15)
    plan = nt.prepare_sparse(csr, _config(4, steps=2), strategy="ell",
                             device="cpu")
    before = counters()
    plan.run(W0=W0, H0=H0)
    moved = {k: v - before[k] for k, v in counters().items()}
    assert moved["ials.cg_matvecs"] == 4 * 2 * (2 + 1)
    assert moved["ials.rows_solved"] == 4 * sum(dense.shape)
    assert moved["ials.gram_segments"] == 0
    assert moved["launches.ell_cg"] == 0          # the twin, on the CPU


def test_the_engine_passes_the_kernel_routes(monkeypatch):
    """The ELL engine's cg half-steps take their sparse products from
    `SEK.ell_cg` (steps + 1 a half-step) and their right-hand sides and
    diagonals from `SEK.v_ht_ell_pallas`, the wrappers that launch #11
    and #10 on the card."""
    calls = {"product": 0, "spmm": 0}

    def spy(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(SEK, "ell_cg", spy("product", SEK.ell_cg))
    monkeypatch.setattr(SEK, "v_ht_ell_pallas",
                        spy("spmm", SEK.v_ht_ell_pallas))
    csr, dense = _csr(seed=18)
    W0, H0 = _factors(*dense.shape, dtype=torch.float32, seed=19)
    plan = nt.prepare_sparse(csr, _config(2, steps=2), strategy="ell",
                             device="cpu")
    plan.run(W0=W0, H0=H0)
    assert calls["product"] == 2 * 2 * (2 + 1)
    assert calls["spmm"] >= 2 * 2 * 2


def test_the_engine_step_is_the_half_step():
    """`als_update_weighted_ell_exact(..., solver="cg")` is two
    `cg_half_ell` calls in float32, W from (W, H) then H from the new W."""
    csr, dense = _csr(seed=16)
    pair = SE.build_ell_pair(csr, device="cpu")
    W, H = _factors(*dense.shape, dtype=torch.float32, seed=17)
    Wn, Hn = SE.als_update_weighted_ell_exact(pair, W, H, ALPHA, LAM,
                                              2 * LAM, eps=EPS,
                                              solver="cg", cg_steps=3)
    w = SE.cg_half_ell(pair.rows, H.T, W, LAM, EPS, ALPHA, 3)
    h = SE.cg_half_ell(pair.cols, w, H.T, 2 * LAM, EPS, ALPHA, 3)
    assert torch.equal(Wn, w) and torch.equal(Hn, h.T.contiguous())
    assert Hn.is_contiguous() and (Wn >= 0).all() and (Hn >= 0).all()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_csr(seed, n=4000, m=2500):
    """Most rows 1..8 nonzeros, 40 rows of 9..600, one of 1,300 (three
    segments), an empty one, every 7th stored value an explicit zero."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 9, n)
    lens[rng.choice(n, 40, replace=False)] = rng.integers(9, 600, 40)
    lens[3], lens[4] = 1300, 0
    rows = np.repeat(np.arange(n), lens)
    cols = np.concatenate([rng.choice(m, k, replace=False) for k in lens])
    vals = rng.integers(1, 6, rows.size).astype(np.float32)
    vals[::7] = 0.0
    return S.SparseCOO(row=rows, col=cols, data=vals,
                       shape=(n, m)).to_csr()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,r", [
    *((torch.float32, r) for r in (64, 128, 256)),
    *((torch.float64, r) for r in (64, 128))])
def test_ell_cg_matches_twin(dev, dtype, r):
    """Both halves, one launch each, on signed own rows."""
    csr = _card_csr(r)
    pair = SE.build_ell_pair(csr, dtype=dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(r)
    W = torch.rand(csr.shape[0], r, generator=g, device=dev,
                   dtype=dtype) - 0.5
    H = torch.rand(r, csr.shape[1], generator=g, device=dev,
                   dtype=dtype) + 0.05
    for ell, own, table in ((pair.rows, W, H.T.contiguous()),
                            (pair.cols, H.T.contiguous() - 0.5, W)):
        before = SEK.LAUNCHES["ell_cg"]
        got = SEK.ell_cg(ell, own, table, 40.0)
        assert SEK.LAUNCHES["ell_cg"] - before == 1
        want = SE.cg_product_ell(ell, own, table, 40.0)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (ell.shape[0], r)
        assert _rel(got, want) <= RULE_RTOL[dtype], _rel(got, want)


@pytest.mark.cuda
def test_ials_cg_fit_on_the_card(dev):
    """Two iterations of an ELL iALS cg fit at r = 64: 2 (3 + 1) launches
    of the CG rule an iteration, none of #13 or #12; each half-step of
    the first iteration against float64 CG, within twice the plain twin's
    error or 10 kappa u."""
    r = 64
    csr = _card_csr(21, n=1500, m=1400)
    dense = np.asarray(csr.todense(), np.float64)
    g = torch.Generator(device=dev).manual_seed(21)
    W0 = torch.rand(csr.shape[0], r, generator=g, device=dev) + 0.05
    H0 = torch.rand(r, csr.shape[1], generator=g, device=dev) + 0.05
    cfg = NmfConfig(rank=r, algorithm="als", alpha_confidence=ALPHA,
                    lambda_w=LAM, lambda_h=LAM, als_solver="cg",
                    init_method=Initialization.COPY_EXISTING,
                    num_iterations=2, check_interval=2, threshold_value=0.0,
                    eps=EPS)
    plan = nt.prepare_sparse(csr, cfg, strategy="ell", device=dev)
    before = counters()
    res = plan.run(W0=W0, H0=H0)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in counters().items()}
    assert moved["launches.ell_cg"] == 2 * 2 * (3 + 1)
    assert moved["launches.ell_gram"] == 0
    assert moved["launches.row_solve"] == 0
    assert torch.isfinite(res.W).all() and torch.isfinite(res.H).all()
    pair, cpu = plan.operand, SE.build_ell_pair(csr, device="cpu")
    kernels = dict(product=SEK.ell_cg, spmm=SEK.v_ht_ell_pallas)
    w_card = SE.cg_half_ell(pair.rows, H0.T, W0, LAM, EPS, ALPHA, 3,
                            **kernels)
    h_card = SE.cg_half_ell(pair.cols, w_card, H0.T, LAM, EPS, ALPHA, 3,
                            **kernels)
    for ell, table, x0, V, got in ((cpu.rows, H0.T, W0, dense, w_card),
                                   (cpu.cols, w_card, H0.T, dense.T,
                                    h_card)):
        twin = SE.cg_half_ell(ell, table.cpu(), x0.cpu(), LAM, EPS, ALPHA,
                              3)
        want, kappa = _cg64(V, table.cpu(), x0.cpu(), 3)
        err, twin_err = _rel(got.cpu(), want), _rel(twin, want)
        assert err <= max(2 * twin_err, 10 * kappa * U32), (err, twin_err,
                                                            kappa)
