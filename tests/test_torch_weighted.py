"""Confidence-weighted MU (alpha_confidence > 0, BASELINE config 3) in the
port against nmftpu on the same numpy inputs: the dense float32 update,
the densified row-panel update (bf16 and int8 V), the ELL and scatter
updates, the registry's and the sparse driver's routes, nmf end to end on
every engine and storage, an independent float64 numpy oracle for one
step, the weighted objective's descent, and the synthetic generator
config 3 is built with."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import nmftpu  # noqa: E402
import nmftpu_torch as nt  # noqa: E402
from nmftpu import densified as JD  # noqa: E402
from nmftpu import sparse as js  # noqa: E402
from nmftpu import sparse_ell as JE  # noqa: E402
from nmftpu import sparse_ops as JS  # noqa: E402
from nmftpu.data import synthetic as JSYN  # noqa: E402
from nmftpu.linalg import dense as JLD  # noqa: E402
from nmftpu_torch import densified as TD  # noqa: E402
from nmftpu_torch import sparse_ell as TE  # noqa: E402
from nmftpu_torch import sparse as ts  # noqa: E402
from nmftpu_torch import sparse_ops as TS  # noqa: E402
from nmftpu_torch.algorithms import registry as TR  # noqa: E402
from nmftpu_torch.convert import sparse_from_nmftpu  # noqa: E402
from nmftpu_torch.data import synthetic as TSYN  # noqa: E402
from nmftpu_torch.kernels import quantized as TQ  # noqa: E402
from nmftpu_torch.linalg import dense as TLD  # noqa: E402

# float32, one step: sums of at most a few hundred nonnegative terms in
# another order, ~sqrt(K) 2^-24 ~ 1e-6
RTOL_STEP = 1e-5
# float32, the error after ten steps: the per-step reordering compounds
RTOL_ERR = 1e-4
# float64 against float64: the same sums in another order
RTOL_F64 = 1e-10
# densified bf16/int8 against nmftpu's after one step: the same bf16
# roundings, but a float32 reordering of C.WH can flip one rounding by an
# ulp (2^-8 of one term of a sum of ~45)
RTOL_BF16_STEP = 1e-4
# densified against nmftpu after ten steps, on the error: flips compound
# in the factors (~6e-3 after 20 steps), the error stays within 1e-5
RTOL_BF16_ERR = 1e-4
# the port's densified step against the float64 oracle: bf16 rounds H
# (numerator) and W, H, C.WH, H (denominator), 2^-9 each: 5 * 2^-9
RTOL_BF16_ORACLE = 5 * 2**-9
N, M, RANK = 60, 45, 5
ALPHAS = [2.0, 40.0]


def _data(seed=0, n=N, m=M, density=0.2, ones=False):
    """Nonnegative n x m clicks (values 1) or counts (1..5) at `density`,
    with an empty row (3) and column (4), and nonnegative factors."""
    rng = np.random.default_rng(seed)
    vals = 1.0 if ones else rng.integers(1, 6, (n, m))
    V = np.where(rng.random((n, m)) < density, vals, 0.0).astype(np.float32)
    V[3, :] = 0.0
    V[:, 4] = 0.0
    W = rng.uniform(0.1, 1.0, (n, RANK)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (RANK, m)).astype(np.float32)
    return V, W, H


def _rel(a, b):
    a = np.asarray(a.double() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.double() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _oracle_step(V, W, H, alpha, order="WH", eps=1e-9):
    """One weighted MU step in float64 numpy, from the objective's
    definition: C = 1 + alpha V, W <- W (C V) Hᵀ / ((C (WH)) Hᵀ + eps)."""
    V, W, H = (np.asarray(x, np.float64) for x in (V, W, H))
    C = 1.0 + alpha * V

    def upd_w(W, H):
        return W * ((C * V) @ H.T) / ((C * (W @ H)) @ H.T + eps)

    def upd_h(W, H):
        return H * (W.T @ (C * V)) / (W.T @ (C * (W @ H)) + eps)

    if order == "WH":
        W = upd_w(W, H)
        return W, upd_h(W, H)
    H = upd_h(W, H)
    return upd_w(W, H), H


def _objective(V, W, H, alpha):
    V, W, H = (np.asarray(x, np.float64) for x in (V, W, H))
    return float(np.sum((1.0 + alpha * V) * (V - W @ H) ** 2))


# ---------------------------------------------------------------------------
# module 1: the dense float32 update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("order", ["WH", "HW"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dense_weighted_update_matches_nmftpu(alpha, order, dtype):
    V, W, H = (x.astype(dtype) for x in _data())
    C = 1.0 + alpha * V
    want = JLD.mu_update_frobenius_weighted(
        jnp.asarray(V), jnp.asarray(C), jnp.asarray(W), jnp.asarray(H),
        order=order)
    got = TLD.mu_update_frobenius_weighted(
        torch.tensor(V), torch.tensor(C), torch.tensor(W), torch.tensor(H),
        order=order)
    tol = RTOL_F64 if dtype == np.float64 else RTOL_STEP
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(V).dtype
        assert _rel(g, w) < tol


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("order", ["WH", "HW"])
def test_dense_weighted_update_matches_the_float64_oracle(alpha, order):
    V, W, H = _data(seed=1)
    got = TLD.mu_update_frobenius_weighted(
        *(torch.tensor(x, dtype=torch.float64)
          for x in (V, 1.0 + alpha * V, W, H)), order=order)
    for g, w in zip(got, _oracle_step(V, W, H, alpha, order)):
        assert _rel(g, w) < RTOL_F64


def test_dense_weighted_update_refuses_jacobi():
    V, W, H = (torch.tensor(x) for x in _data())
    with pytest.raises(NotImplementedError, match="jacobi"):
        TLD.mu_update_frobenius_weighted(V, 1.0 + V, W, H, order="jacobi")


# ---------------------------------------------------------------------------
# module 2: the densified row-panel update
# ---------------------------------------------------------------------------


def _densified(V, storage):
    """V as nmftpu's and the port's densified operand: bf16, or int8
    with its scale (quantize_v, as the registry builds it)."""
    if storage == "bfloat16":
        return ((jnp.asarray(V).astype(jnp.bfloat16), None),
                (torch.tensor(V).to(torch.bfloat16), None))
    from nmftpu.kernels import quantized as JQ

    jq, js_ = JQ.quantize_v(jnp.asarray(V))
    tq, ts_ = TQ.quantize_v(torch.tensor(V))
    return (jq, js_), (tq, ts_)


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
@pytest.mark.parametrize("block_rows", [4096, 16])
@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("order", ["WH", "HW"])
def test_weighted_densified_matches_nmftpu(storage, block_rows, alpha,
                                           order):
    """One step; 16-row panels leave a 12-row tail over 60 rows."""
    V, W, H = _data()
    (jv, jscale), (tv, tscale) = _densified(V, storage)
    want = JD.mu_update_frobenius_weighted_densified(
        jv, jnp.asarray(W), jnp.asarray(H), alpha, order=order,
        block_rows=block_rows, scale=jscale)
    got = TD.mu_update_frobenius_weighted_densified(
        tv, torch.tensor(W), torch.tensor(H), alpha, order=order,
        block_rows=block_rows, scale=tscale)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g, w) < RTOL_BF16_STEP


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_weighted_densified_matches_the_float64_oracle(storage, alpha):
    """Clicks (values 1) are exact in bf16 and int8: the step differs
    from float64 only by the bf16 roundings of the contractions."""
    V, W, H = _data(seed=2, ones=True)
    _, (tv, tscale) = _densified(V, storage)
    got = TD.mu_update_frobenius_weighted_densified(
        tv, torch.tensor(W), torch.tensor(H), alpha, block_rows=16,
        scale=tscale)
    for g, w in zip(got, _oracle_step(V, W, H, alpha)):
        assert _rel(g, w) < RTOL_BF16_ORACLE


def test_weighted_densified_holds_no_nm_float32_array(monkeypatch):
    """Every float32 intermediate is panel-sized: with 16-row panels no
    tensor the update allocates has more than 16 * m elements beyond
    the factors (the n x r numerator and denominator)."""
    V, W, H = _data()
    tv = torch.tensor(V).to(torch.bfloat16)
    biggest = []
    real = TD._bf16_dot

    def spy(a, b, *args):
        biggest.append(max(a.numel() if a.shape[0] != N else 0,
                           b.numel() if b.shape[0] != RANK else 0))
        return real(a, b, *args)

    monkeypatch.setattr(TD, "_bf16_dot", spy)
    TD.mu_update_frobenius_weighted_densified(
        tv, torch.tensor(W), torch.tensor(H), 40.0, block_rows=16)
    assert biggest and max(biggest) <= 16 * M


# ---------------------------------------------------------------------------
# modules 6 and 7: ELL and scatter
# ---------------------------------------------------------------------------


def _sparse(V, dtype=np.float32):
    jsp = js.from_dense(V)
    return jsp, sparse_from_nmftpu(jsp)


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("order", ["WH", "HW"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_weighted_ell_matches_nmftpu(alpha, order, dtype):
    V, W, H = (x.astype(dtype) for x in _data())
    jsp, tsp = _sparse(V)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    jp = JE.build_ell_pair(jsp, dtype=jnp.dtype(dtype), seg_max=8,
                           buckets=(2, 4, 8))
    tp = TE.build_ell_pair(tsp, dtype=tdt, device="cpu", seg_max=8,
                           buckets=(2, 4, 8))
    want = JE.mu_update_frobenius_weighted_ell(
        jp, jnp.asarray(W), jnp.asarray(H), alpha, order=order)
    got = TE.mu_update_frobenius_weighted_ell(
        tp, torch.tensor(W), torch.tensor(H), alpha, order=order)
    tol = RTOL_F64 if dtype == np.float64 else RTOL_STEP
    for g, w in zip(got, want):
        assert g.dtype == tdt and _rel(g, w) < tol
    for g, w in zip(got, _oracle_step(V, W, H, alpha, order)):
        assert _rel(g, w) < (RTOL_F64 if dtype == np.float64 else RTOL_STEP)


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("order", ["WH", "HW"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_weighted_scatter_matches_nmftpu(alpha, order, dtype):
    V, W, H = (x.astype(dtype) for x in _data())
    jsp, tsp = _sparse(V)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    jc = JS.device_put_sparse(jsp, dtype=jnp.dtype(dtype), chunk=256)
    tc = TS.device_put_sparse(tsp, dtype=tdt, chunk=256, device="cpu")
    want = JS.mu_update_frobenius_weighted_sparse(
        jc, jnp.asarray(W), jnp.asarray(H), alpha, order=order)
    got = TS.mu_update_frobenius_weighted_sparse(
        tc, torch.tensor(W), torch.tensor(H), alpha, order=order)
    tol = RTOL_F64 if dtype == np.float64 else RTOL_STEP
    for g, w in zip(got, want):
        assert g.dtype == tdt and _rel(g, w) < tol
    for g, w in zip(got, _oracle_step(V, W, H, alpha, order)):
        assert _rel(g, w) < tol


# ---------------------------------------------------------------------------
# module 3: the registry's routes; the sparse driver's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("storage,route,scaled", [
    ("float32", (TLD, "mu_update_frobenius_weighted"), False),
    ("bfloat16", (TD, "mu_update_frobenius_weighted_densified"), False),
    ("int8", (TD, "mu_update_frobenius_weighted_densified"), True),
])
def test_registry_routes_weighted_mu(monkeypatch, storage, route, scaled):
    calls = []
    mod, name = route
    real = getattr(mod, name)

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)

    monkeypatch.setattr(mod, name, spy)
    make_aux, update, _ = TR.build_dense_update(
        nt.NmfConfig(rank=RANK, alpha_confidence=40.0, v_storage=storage))
    V, W, H = (torch.tensor(x) for x in _data())
    aux = make_aux(V)
    if storage == "float32":
        assert torch.equal(aux[0], 1.0 + 40.0 * V)
    update(V, aux, W, H)
    assert len(calls) == 1
    assert (calls[0].get("scale") is not None) == scaled


@pytest.mark.parametrize("strategy,route,use_pallas", [
    ("densified", (TD, "mu_update_frobenius_weighted_densified"), False),
    ("ell", (TE, "mu_update_frobenius_weighted_ell"), False),
    ("ell", (TE, "mu_update_frobenius_weighted_ell"), True),
    ("scatter", (TS, "mu_update_frobenius_weighted_sparse"), False),
])
def test_sparse_driver_routes_weighted_mu(monkeypatch, strategy, route,
                                          use_pallas):
    """Weighting takes one route per engine; use_pallas does not change
    it on ELL (nmftpu runs the weighted ELL update on its XLA gather)."""
    calls = []
    mod, name = route
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    V, W, H = _data()
    _, tsp = _sparse(V)
    nt.nmf(tsp, RANK, init="copy", W0=W, H0=H, num_iterations=2,
           alpha_confidence=40.0, strategy=strategy, use_pallas=use_pallas,
           device="cpu")
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# nmf end to end, every engine and storage
# ---------------------------------------------------------------------------


ENGINES = [
    ("dense", "float32", RTOL_STEP, RTOL_ERR),
    ("dense", "bfloat16", RTOL_BF16_STEP, RTOL_BF16_ERR),
    ("dense", "int8", RTOL_BF16_STEP, RTOL_BF16_ERR),
    ("densified", "float32", RTOL_BF16_STEP, RTOL_BF16_ERR),
    ("densified", "int8", RTOL_BF16_STEP, RTOL_BF16_ERR),
    ("ell", "float32", RTOL_STEP, RTOL_ERR),
    ("scatter", "float32", RTOL_STEP, RTOL_ERR),
]


def _nmf_pair(engine, storage, alpha, iters, ones=False):
    V, W, H = _data(ones=ones)
    kw = dict(init="copy", W0=W, H0=H, num_iterations=iters,
              alpha_confidence=alpha, v_storage=storage)
    if engine == "dense":
        return (nmftpu.nmf(V, RANK, **kw),
                nt.nmf(V, RANK, device="cpu", **kw), V)
    jsp, tsp = _sparse(V)
    return (nmftpu.nmf(jsp, RANK, strategy=engine, **kw),
            nt.nmf(tsp, RANK, strategy=engine, device="cpu", **kw), V)


@pytest.mark.parametrize("engine,storage,step_tol,err_tol", ENGINES)
@pytest.mark.parametrize("alpha", ALPHAS)
def test_nmf_weighted_matches_nmftpu(engine, storage, step_tol, err_tol,
                                     alpha):
    """Factors after one step, the error after ten (W0/H0 explicit)."""
    want, got, _ = _nmf_pair(engine, storage, alpha, 1)
    assert _rel(got.W, want.W) < step_tol
    assert _rel(got.H, want.H) < step_tol
    want, got, _ = _nmf_pair(engine, storage, alpha, 10)
    assert got.num_iterations == want.num_iterations == 10
    assert abs(got.frobenius_error / want.frobenius_error - 1) < err_tol
    assert abs(got.rmsd / want.rmsd - 1) < err_tol


@pytest.mark.parametrize("engine,storage,step_tol,err_tol", ENGINES)
def test_weighted_objective_falls_monotonically(engine, storage, step_tol,
                                                err_tol):
    """sum c (v - wh)^2, recomputed in float64 after each of 8 steps,
    falls at every step on every engine (clicks: exact in int8)."""
    V, W, H = _data(seed=5, ones=True)
    alpha = 40.0
    objs = [_objective(V, W, H, alpha)]
    Wc, Hc = W, H
    for _ in range(8):
        kw = dict(init="copy", W0=Wc, H0=Hc, num_iterations=1,
                  alpha_confidence=alpha, v_storage=storage, device="cpu")
        res = (nt.nmf(V, RANK, **kw) if engine == "dense" else
               nt.nmf(_sparse(V)[1], RANK, strategy=engine, **kw))
        Wc, Hc = res.W.numpy(), res.H.numpy()
        objs.append(_objective(V, Wc, Hc, alpha))
    assert all(b < a for a, b in zip(objs[:-1], objs[1:])), objs


def test_sparse_auto_resolves_weighted_like_nmftpu():
    """Config 3's choice: weighted MU goes to densified under the budget,
    to ELL above it (float64: scatter), as nmftpu resolves it."""
    from nmftpu.config import NmfConfig as JConfig
    from nmftpu_torch.convert import config_from_nmftpu

    host = ts.SparseCOO([0], [0], [1.0], (1, 1))
    for n, m in ((138_000, 27_000), (400_000, 27_000)):
        for dtype in ("float32", "float64"):
            for storage in ("float32", "bfloat16", "int8"):
                if dtype == "float64" and storage != "float32":
                    continue
                jcfg = JConfig(rank=128, alpha_confidence=40.0, dtype=dtype,
                               v_storage=storage)
                want = JS._resolve_strategy(host, jcfg, "auto", n, m)
                got = TS._resolve_strategy(host, config_from_nmftpu(jcfg),
                                           "auto", n, m)
                assert got == want
    assert TS._resolve_strategy(host, nt.NmfConfig(
        rank=128, alpha_confidence=40.0), "auto", 138_000, 27_000) \
        == "densified"


# ---------------------------------------------------------------------------
# module 11: the synthetic generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n=1380, m=270, nnz=40_000, alpha_user=0.9, alpha_item=0.9,
         seed=2),
    dict(n=500, m=300, nnz=5_000, rank=4, seed=7, dtype=np.float64),
])
def test_synthetic_powerlaw_is_nmftpus_bit_for_bit(kw):
    want = JSYN.synthetic_powerlaw_sparse(**kw)
    got = TSYN.synthetic_powerlaw_sparse(**kw)
    assert isinstance(got, ts.SparseCOO)
    assert got.shape == want.shape and got.nnz == want.nnz
    assert got.nnz < kw["nnz"]          # duplicates collapsed
    for a, b in ((got.row, want.row), (got.col, want.col),
                 (got.data, want.data)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_chip_scripts_import_neither_jax_nor_nmftpu():
    """chip_smoke.py (which drives config 3 on the card), chip_profile.py,
    chip_ablate.py and the rank programs of the multi-rank tests
    (tests/torch_parallel_ranks.py and tests/torch_mesh_ranks.py, which
    the spawned ranks import)
    import nmftpu_torch only: no import statement anywhere in them names
    jax or nmftpu."""
    import ast
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("chip_smoke.py", "chip_profile.py", "chip_ablate.py",
                 os.path.join("tests", "torch_parallel_ranks.py"),
                 os.path.join("tests", "torch_mesh_ranks.py")):
        with open(os.path.join(repo, name)) as f:
            tree = ast.parse(f.read())
        mods = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods.append(node.module or "")
        assert "nmftpu_torch" in {m.split(".")[0] for m in mods}, name
        bad = [m for m in mods
               if m.split(".")[0] in ("jax", "jaxlib", "nmftpu")]
        assert not bad, (name, bad)
