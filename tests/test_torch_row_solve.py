"""The per-row ridged solves of the iALS family (`kernels/row_solve.py`,
kernel #12) and their route in ``sparse_ops._row_solver``.

On the CPU: the exact row solver is, bit for bit, the panel loop over
``linalg.dense._batched_solve_clamped`` it always was (with and without
a base Gram, in one panel or many); that plain path against float64
Cholesky; a system that is not positive definite gives a NaN row; the
route (CUDA, float32, r <= 128) and the wrapper's checks, CPU tensors
refused.

On the card (marked `cuda`, skipped without a device): the kernel
against float64 Cholesky at r in {1, 7, 16, 64, 127, 128} and 1, 33 and
16,385 rows, no less accurate than the plain path on the same systems;
NaN rows; one launch per call, whatever the panel size; rows at a
stride (the ring's layout); r = 129 on the plain path; the ELL iALS
update on the kernel against the same update on the plain path. This
file imports no jax, so on the card's machine run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_row_solve.py

Tolerance against float64: a float32 Cholesky-type solve of a system of
condition number kappa is off by at most about kappa · u (u = 2^-24)
times a small multiple; 10 kappa u, the rule of test_torch_ials.py. The
kernel against the plain path: its worst row no worse than the plain
path's worst, or than kappa u.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nmftpu_torch import sparse_ops as TS  # noqa: E402
from nmftpu_torch.kernels import row_solve as RS  # noqa: E402
from nmftpu_torch.linalg import dense as TD  # noqa: E402
from nmftpu_torch.utils.metrics import counters  # noqa: E402

U32 = 2.0 ** -24
LAM, EPS = 0.1, 1e-9


def _systems(rows, r, kappa=1e3, seed=0, base=True, dtype=torch.float32,
             device="cpu"):
    """(G, dG, rhs): per row an SPD system G + dG_i of condition number
    kappa, Q diag(λ) Qᵀ with λ log-uniform over [1, kappa] (both ends
    taken) and Q two random Householder reflections; dG_i = A_i - G need
    not be definite, G = P Pᵀ / r shared, or None. Right-hand sides in
    [-1, 2), so that the clamp bites."""
    g = torch.Generator(device=device).manual_seed(seed)
    f64 = dict(generator=g, dtype=torch.float64, device=device)
    lam = torch.exp(torch.rand(rows, r, **f64) * np.log(kappa))
    lam[:, 0], lam[:, -1] = 1.0, kappa
    A = torch.diag_embed(lam)
    for _ in range(2):
        u = torch.randn(rows, r, 1, **f64)
        u = u / u.norm(dim=1, keepdim=True)
        Au = A @ u
        A = (A - 2.0 * u @ Au.mT - 2.0 * Au @ u.mT
             + 4.0 * (u.mT @ Au) * (u @ u.mT))
    G = None
    if base:
        P = torch.rand(r, 3 * r, **f64) / r
        G = P @ P.T
        A = A - G[None]
        G = G.to(dtype)
    rhs = 3.0 * torch.rand(rows, r, **f64) - 1.0
    return G, A.to(dtype), rhs.to(dtype)


def _exact64(G, dG, rhs, shift=LAM, eps=EPS):
    """The float32 path's ridged systems (``linalg.dense._ridged`` with
    float32's floor) solved by float64 Cholesky and clamped."""
    Gb = dG.double() + (0.0 if G is None else G.double()[None])
    r = Gb.shape[-1]
    mean = torch.diagonal(Gb, dim1=-2, dim2=-1).sum(-1)[:, None, None] / r
    A = Gb + (shift + eps + max(eps, 100 * 2.0 ** -23) * mean) * torch.eye(
        r, dtype=torch.float64, device=Gb.device)
    x = torch.cholesky_solve(rhs.double()[..., None],
                             torch.linalg.cholesky(A))[..., 0]
    return torch.clamp(x, min=0.0)


def _row_err(x, want):
    """The worst row's max |x - want| over its max |want|."""
    x = x.double()
    scale = want.abs().amax(1).clamp_min(1e-30)
    return float(((x - want).abs().amax(1) / scale).max())


def _panel_loop(G, dG, rhs, shift, eps, panel_bytes):
    """The exact row solver as the port always ran it: panels of rows,
    each G + dG's batched Cholesky solve, clamped."""
    rows, r = rhs.shape
    panel = max(1, panel_bytes // (r * r * dG.element_size()))
    out = torch.empty_like(rhs)
    for s in range(0, rows, panel):
        e = min(s + panel, rows)
        Gb = dG[s:e] if G is None else G[None] + dG[s:e]
        out[s:e] = TD._batched_solve_clamped(Gb, rhs[s:e], shift, eps)
    return out


# ---------------------------------------------------------------------------
# CPU: the route keeps the plain path, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("panel_rows", [None, 5], ids=["whole", "panels"])
@pytest.mark.parametrize("base", [True, False], ids=["ials", "masked"])
def test_exact_row_solver_on_cpu_is_the_panel_loop(monkeypatch, base,
                                                   panel_rows):
    G, dG, rhs = _systems(37, 12, seed=1, base=base)
    if panel_rows:
        monkeypatch.setattr(TS, "ROW_SOLVE_PANEL_BYTES",
                            panel_rows * 12 * 12 * 4)
    before = RS.LAUNCHES["row_solve"]
    got = TS._row_solver("exact", 3)(G, dG, rhs, LAM, EPS, rhs)
    want = _panel_loop(G, dG, rhs, LAM, EPS, TS.ROW_SOLVE_PANEL_BYTES)
    assert torch.equal(got, want)
    assert RS.LAUNCHES["row_solve"] == before


@pytest.mark.parametrize("r", [1, 7, 16, 64, 128])
def test_plain_twin_matches_float64(r):
    G, dG, rhs = _systems(24, r, seed=r)
    want = _exact64(G, dG, rhs)
    got = TS._row_solver("exact", 3)(G, dG, rhs, LAM, EPS, rhs)
    assert got.dtype == torch.float32 and got.shape == rhs.shape
    assert (got >= 0).all()
    assert _row_err(got, want) <= 10 * 1e3 * U32


@pytest.mark.parametrize("base", [True, False], ids=["ials", "masked"])
def test_indefinite_system_gives_a_nan_row(base):
    G, dG, rhs = _systems(6, 16, kappa=1e2, seed=3, base=base)
    dG[2] -= 50.0 * torch.eye(16) * dG[2].abs().max()
    got = TS._row_solver("exact", 3)(G, dG, rhs, 0.0, EPS, rhs)
    assert torch.isnan(got[2]).all()
    keep = [0, 1, 3, 4, 5]
    assert torch.isfinite(got[keep]).all()
    want = _exact64(G, dG[keep], rhs[keep], shift=0.0)
    assert _row_err(got[keep], want) <= 10 * 1e2 * U32


@pytest.mark.parametrize("device,dtype,r,kernel", [
    ("cuda", torch.float32, 128, True),
    ("cuda", torch.float32, 1, True),
    ("cuda", torch.float32, 129, False),
    ("cuda", torch.float64, 64, False),
    ("cpu", torch.float32, 64, False),
])
def test_route(device, dtype, r, kernel):
    assert RS.takes(torch.device(device), dtype, r) is kernel


def test_rank_129_takes_the_plain_path():
    G, dG, rhs = _systems(3, 129, kappa=1e2, seed=4)
    before = RS.LAUNCHES["row_solve"]
    got = TS._row_solver("exact", 3)(G, dG, rhs, LAM, EPS, rhs)
    assert torch.equal(got, _panel_loop(G, dG, rhs, LAM, EPS,
                                        TS.ROW_SOLVE_PANEL_BYTES))
    assert RS.LAUNCHES["row_solve"] == before


def _bad_operands(case):
    G, dG, rhs = _systems(4, 8, kappa=10.0, seed=5)
    if case == "float64":
        return TypeError, (G, dG.double(), rhs)
    if case == "rhs_shape":
        return ValueError, (G, dG, rhs[:, :7])
    if case == "G_shape":
        return ValueError, (G[:7, :7], dG, rhs)
    if case == "rows_not_contiguous":
        return ValueError, (G, dG.transpose(1, 2), rhs)
    if case == "rhs_not_contiguous":
        return ValueError, (G, dG, rhs.T.contiguous().T)
    if case == "rank_129":
        return ValueError, (None, torch.zeros(2, 129, 129),
                            torch.zeros(2, 129))
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["float64", "rhs_shape", "G_shape",
                                  "rows_not_contiguous", "rhs_not_contiguous",
                                  "rank_129"])
def test_wrapper_checks(case):
    err, args = _bad_operands(case)
    with pytest.raises(err):
        RS._check(*args)


def test_wrapper_refuses_cpu_tensors():
    G, dG, rhs = _systems(4, 8, kappa=10.0, seed=5)
    before = RS.LAUNCHES["row_solve"]
    for base in (G, None):
        with pytest.raises(ValueError, match="CUDA"):
            RS.solve_rows(base, dG, rhs, LAM, EPS)
    assert RS.LAUNCHES["row_solve"] == before


def test_wrapper_takes_rows_at_a_stride():
    """The ring's layout: each row's r² Gram entries and r right-hand
    side entries side by side in one (rows, r² + r) buffer."""
    G, dG, rhs = _systems(5, 8, kappa=10.0, seed=6)
    both = torch.cat([dG.reshape(5, 64), rhs], dim=1)
    RS._check(G, both[:, :64].reshape(5, 8, 8), both[:, 64:])
    RS._check(None, dG, rhs)


def test_counters_report_the_launches():
    assert counters()["launches.row_solve"] == RS.LAUNCHES["row_solve"]


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 33, 16_385])
@pytest.mark.parametrize("r", [1, 7, 16, 64, 127, 128])
def test_kernel_against_float64(dev, r, rows):
    kappa = 1e3
    G, dG, rhs = _systems(rows, r, kappa, seed=r + rows, device=dev)
    want = _exact64(G, dG, rhs)
    before = RS.LAUNCHES["row_solve"]
    got = RS.solve_rows(G, dG, rhs, LAM, EPS)
    plain = _panel_loop(G, dG, rhs, LAM, EPS, TS.ROW_SOLVE_PANEL_BYTES)
    assert RS.LAUNCHES["row_solve"] == before + 1
    assert (got >= 0).all()
    k_err, p_err = _row_err(got, want), _row_err(plain, want)
    # no larger than the plain path's, or than kappa u, which any float32
    # solve of one of these systems may be off by
    assert k_err <= max(p_err, kappa * U32), (k_err, p_err)


@pytest.mark.cuda
@pytest.mark.parametrize("base", [True, False], ids=["ials", "masked"])
def test_kernel_nan_rows(dev, base):
    G, dG, rhs = _systems(40, 64, kappa=1e2, seed=7, base=base, device=dev)
    bad = [0, 17, 39]
    for i in bad:
        dG[i] -= 50.0 * torch.eye(64, device=dev) * dG[i].abs().max()
    dG[17, 5, 5] = float("nan")
    got = RS.solve_rows(G, dG, rhs, 0.0, EPS)
    keep = [i for i in range(40) if i not in bad]
    assert torch.isnan(got[bad]).all()
    assert torch.isfinite(got[keep]).all()
    want = _exact64(G, dG[keep], rhs[keep], shift=0.0)
    assert _row_err(got[keep], want) <= 10 * 1e2 * U32


@pytest.mark.cuda
@pytest.mark.parametrize("base", [True, False], ids=["ials", "masked"])
def test_one_launch_per_call_without_panels(dev, monkeypatch, base):
    G, dG, rhs = _systems(300, 128, seed=8, base=base, device=dev)
    solve = TS._row_solver("exact", 3)
    whole = solve(G, dG, rhs, LAM, EPS, rhs)
    monkeypatch.setattr(TS, "ROW_SOLVE_PANEL_BYTES", 7 * 128 * 128 * 4)
    before = counters()["launches.row_solve"]
    again = solve(G, dG, rhs, LAM, EPS, rhs)
    assert counters()["launches.row_solve"] == before + 1
    assert torch.equal(again, whole)


@pytest.mark.cuda
def test_kernel_takes_rows_at_a_stride(dev):
    G, dG, rhs = _systems(50, 24, seed=9, device=dev)
    both = torch.cat([dG.reshape(50, 24 * 24), rhs], dim=1)
    got = RS.solve_rows(G, both[:, :576].reshape(50, 24, 24),
                        both[:, 576:], LAM, EPS)
    assert torch.equal(got, RS.solve_rows(G, dG, rhs, LAM, EPS))


@pytest.mark.cuda
def test_row_solver_takes_a_transposed_rhs(dev):
    """The mesh's H halves hand the row solver the transpose of an (r, m)
    sum as the right-hand sides."""
    G, dG, rhs = _systems(40, 32, seed=13, device=dev)
    solve = TS._row_solver("exact", 3)
    want = solve(G, dG, rhs, LAM, EPS, rhs)
    before = RS.LAUNCHES["row_solve"]
    got = solve(G, dG, rhs.T.contiguous().T, LAM, EPS, rhs)
    assert RS.LAUNCHES["row_solve"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_rank_129_on_the_card_takes_the_plain_path(dev):
    G, dG, rhs = _systems(3, 129, kappa=1e2, seed=10, device=dev)
    before = RS.LAUNCHES["row_solve"]
    got = TS._row_solver("exact", 3)(G, dG, rhs, LAM, EPS, rhs)
    assert RS.LAUNCHES["row_solve"] == before
    assert _row_err(got, _exact64(G, dG, rhs)) <= 10 * 1e2 * U32


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_does_not_take(dev):
    G, dG, rhs = _systems(4, 8, kappa=10.0, seed=11, device=dev)
    with pytest.raises(TypeError):
        RS.solve_rows(G, dG.double(), rhs, LAM, EPS)
    with pytest.raises(ValueError):
        RS.solve_rows(G, dG.transpose(1, 2), rhs, LAM, EPS)
    with pytest.raises(ValueError):
        RS.solve_rows(None, torch.zeros(2, 129, 129, device=dev),
                      torch.zeros(2, 129, device=dev), LAM, EPS)


@pytest.mark.cuda
def test_ell_ials_on_the_kernel(dev, monkeypatch):
    """One iALS iteration on the ELL engine: two launches, and the
    plain path's factors within 1e-3 of their largest entry (float32
    solves of systems of kappa up to ~10^3 on both paths, each off by up
    to 10 kappa u = 6e-4)."""
    from nmftpu_torch import sparse_ell as TE
    from nmftpu_torch.sparse import from_dense

    rng = np.random.default_rng(12)
    n, m, r = 300, 200, 32
    a = np.where(rng.random((n, m)) < 0.05, 1.0, 0.0).astype(np.float32)
    pair = TE.build_ell_pair(from_dense(a), device=dev)
    W = torch.tensor(rng.uniform(0.1, 1.0, (n, r)), dtype=torch.float32,
                     device=dev)
    H = torch.tensor(rng.uniform(0.1, 1.0, (r, m)), dtype=torch.float32,
                     device=dev)
    before = RS.LAUNCHES["row_solve"]
    W1, H1 = TE.als_update_weighted_ell_exact(pair, W, H, 40.0, LAM, LAM)
    assert RS.LAUNCHES["row_solve"] == before + 2
    monkeypatch.setattr(RS, "takes", lambda *a: False)
    W2, H2 = TE.als_update_weighted_ell_exact(pair, W, H, 40.0, LAM, LAM)
    assert RS.LAUNCHES["row_solve"] == before + 2
    for got, want in ((W1, W2), (H1, H2)):
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= 1e-3
