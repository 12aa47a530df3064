"""The per-row weighted Grams and right-hand sides of the iALS family on
ELL (`kernels/ell_gram.py`, kernel #13) and their route,
``sparse_ell.grams_and_rhs_ell``.

On the CPU: the work units built from real ELL containers (tiny,
skewed, with rows across buckets and empty rows): every stored nonzero
lies in exactly one unit, no unit is longer than its cap, a row's units
cover it whole, empty rows get one empty unit and zero results, split
rows get consecutive partial slots, and the index is the same from call
to call; the launches' function in torch (`grams_rhs_plain`) against the
plain path; the rules; the route (CPU, float64, r > 128 and no rule take
the plain path); the wrapper's refusals.

On the card (marked `cuda`, skipped without a device): #13 against the
plain path and against float64 at r in {16, 100, 128} under both rules,
on a matrix with a row of 110,000 nonzeros, empty rows and rows across
buckets, and on the transposed container of a smaller one; its error at
most twice the plain path's; bit-equal outputs from two calls; its
launches; an iALS fit on ELL through #13 and #12 against the plain
path. This file imports no jax, so on the card's machine run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_ell_gram.py

Tolerances: a Gram or right-hand side is a float32 sum of positive terms
(table entries in [0.1, 1), values 1..5), relative error about sqrt(k) u
for k terms; against the plain path (another order of the same sums)
RTOL_SUM = 1e-5, as tests/test_torch_ials.py holds the Grams.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nmftpu_torch import sparse_ell as SE  # noqa: E402
from nmftpu_torch.kernels import ell_gram as EG  # noqa: E402
from nmftpu_torch.sparse import SparseCOO  # noqa: E402
from nmftpu_torch.utils.metrics import counters  # noqa: E402

RTOL_SUM = 1e-5
ALPHA = 40.0
RULES = {"ials": EG.ials_rule(ALPHA), "masked": EG.MASKED}


def _coo(n, m, seed, density=0.02, long_rows=(), empty_rows=(),
         zeros=False):
    """Ratings 1..5 at `density`; each (row, k) of `long_rows` holds k
    distinct columns; `empty_rows` hold none; with `zeros`, a few stored
    zeros (values 0) among the nonzeros."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(n):
        k = dict(long_rows).get(i, rng.binomial(m, density))
        if i in empty_rows:
            k = 0
        rows.append(np.full(k, i))
        cols.append(rng.choice(m, k, replace=False))
    row, col = np.concatenate(rows), np.concatenate(cols)
    data = rng.integers(1, 6, row.size).astype(np.float32)
    if zeros:
        data[rng.choice(row.size, max(1, row.size // 50), replace=False)] = 0
    return SparseCOO(row=row.astype(np.int64), col=col.astype(np.int64),
                     data=data, shape=(n, m))


def _tiny():
    return _coo(12, 40, seed=1, density=0.2, empty_rows=(4,))


def _skewed():
    """A row of 1,700 nonzeros (four segments: three of 512 in the
    widest bucket and 164 in the 256 one), one of 600 (512 + 88), an
    empty row, stored zeros."""
    return _coo(40, 2000, seed=2, long_rows=((3, 1700), (17, 600)),
                empty_rows=(5, 30), zeros=True)


CONTAINERS = {"tiny": _tiny, "skewed": _skewed}


def _ell(name, device="cpu", transposed=False):
    coo = CONTAINERS[name]()
    return SE.build_ell_rows(coo.T if transposed else coo, device=device)


def _table(m, r, seed=3, device="cpu", dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (0.1 + 0.9 * torch.rand(m, r, generator=g)).to(device=device,
                                                          dtype=dtype)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def _row_nnz(ell):
    """Stored nonzero values of each row (counted from the buckets)."""
    out = torch.zeros(ell.shape[0], dtype=torch.int64)
    for b in ell.buckets:
        out.index_add_(0, b.out_row.long().cpu(),
                       (b.vals != 0).sum(1).cpu())
    return out


# ---------------------------------------------------------------------------
# the work units
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transposed", [False, True], ids=["rows", "cols"])
@pytest.mark.parametrize("cap", [8, 64, EG.UNIT_NNZ])
@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_every_nonzero_in_exactly_one_unit(name, cap, transposed):
    ell = _ell(name, transposed=transposed)
    wu = EG.work_units(ell.buckets, ell.shape[0], cap=cap)
    assert wu.units.dtype == torch.int64 and wu.units.shape[1] == 4
    cover = [torch.zeros(b.vals.numel(), dtype=torch.int64)
             for b in ell.buckets]
    for b, start, length, _ in wu.units.tolist():
        assert 0 <= length <= cap
        if length:
            cover[b][start:start + length] += 1
    for b, c in zip(ell.buckets, cover):
        assert int(c.max()) <= 1
        assert bool((c[b.vals.reshape(-1) != 0] == 1).all())
        # a unit never runs past its segment's row
        seg = torch.arange(b.vals.numel()) // b.width
        rows = b.out_row.long()[seg]
        for _, start, length, _ in (u for u in wu.units.tolist()
                                    if u[2] and ell.buckets[u[0]] is b):
            assert len(set(rows[start:start + length].tolist())) == 1


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_units_longest_and_shortest_in_turn(name):
    ell = _ell(name)
    units = EG.work_units(ell.buckets, ell.shape[0]).units
    lens = units[:, 2]
    long, short = lens[0::2], lens[1::2]
    assert bool((long[:-1] >= long[1:]).all())
    assert bool((short[:-1] <= short[1:]).all())
    assert int(long[-1]) >= int(short[-1])
    assert int(lens[0]) == int(lens.max()) <= EG.UNIT_NNZ


def _units_by_row(wu, n):
    """row -> [(bucket, start, length, slot or None)], in unit order."""
    split_of = {}
    for row, first, count in wu.splits.tolist():
        for s in range(first, first + count):
            split_of[s] = row
    out = {i: [] for i in range(n)}
    for b, start, length, dst in wu.units.tolist():
        if dst >= 0:
            out[dst].append((b, start, length, None))
        else:
            out[split_of[-1 - dst]].append((b, start, length, -1 - dst))
    return out


@pytest.mark.parametrize("cap", [64, EG.UNIT_NNZ])
def test_rows_across_buckets_are_covered_whole(cap):
    ell = _ell("skewed")
    wu = EG.work_units(ell.buckets, ell.shape[0], cap=cap)
    by_row = _units_by_row(wu, ell.shape[0])
    nnz = _row_nnz(ell)
    for row in (3, 17):
        units = by_row[row]
        assert len({u[0] for u in units}) == 2   # two buckets
        covered = 0
        for b, start, length, _ in units:
            v = ell.buckets[b].vals.reshape(-1)[start:start + length]
            covered += int((v != 0).sum())
        assert covered == int(nnz[row])


def test_split_rows_get_their_partial_slots():
    ell = _ell("skewed")
    wu = EG.work_units(ell.buckets, ell.shape[0], cap=64)
    by_row = _units_by_row(wu, ell.shape[0])
    used = sorted(-1 - d for d in wu.units[:, 3].tolist() if d < 0)
    assert used == list(range(wu.slots))
    assert wu.splits.shape[1] == 3
    split_rows = wu.splits[:, 0].tolist()
    assert split_rows == sorted(split_rows)
    for row, first, count in wu.splits.tolist():
        slots = [u[3] for u in by_row[row]]
        assert count == len(slots) >= 2
        assert sorted(slots) == list(range(first, first + count))
    for row, units in by_row.items():
        assert len(units) >= 1
        if row not in split_rows:
            assert len(units) == 1 and units[0][3] is None


def test_empty_rows_get_one_empty_unit_and_zero_results():
    ell = _ell("skewed")
    wu = EG.units_of(ell)
    by_row = _units_by_row(wu, ell.shape[0])
    for row in (5, 30):
        assert [u[2] for u in by_row[row]] == [0]
    grams, rhs = EG.grams_rhs_plain(ell, _table(ell.shape[1], 8),
                                    RULES["ials"])
    assert not bool(grams.isnan().any() or rhs.isnan().any())
    for row in (5, 30):
        assert bool((grams[row] == 0).all() and (rhs[row] == 0).all())


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_index_is_the_same_from_call_to_call(name):
    ell = _ell(name)
    first = EG.units_of(ell)
    assert EG.units_of(ell) is first
    again = EG.work_units(ell.buckets, ell.shape[0])
    assert torch.equal(first.units, again.units)
    assert torch.equal(first.splits, again.splits)
    assert first.slots == again.slots
    # the cache is the container's own: a copy of it builds its own
    other = _ell(name)
    assert "gram_units" not in other.cache


# ---------------------------------------------------------------------------
# the launches' function in torch, the rules and the route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("transposed", [False, True], ids=["rows", "cols"])
@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_plain_model_matches_the_plain_path(name, transposed, rule):
    ell = _ell(name, transposed=transposed)
    T = _table(ell.shape[1], 12)
    ru = RULES[rule]
    got_g, got_r = EG.grams_rhs_plain(ell, T, ru)
    want_g, want_r = SE.grams_and_rhs_ell(ell, T, ru.weight, ru.value)
    assert _rel(got_g, want_g) <= RTOL_SUM and _rel(got_r, want_r) <= RTOL_SUM


def test_rules_are_the_callers_functions():
    v = torch.tensor([0.0, 1.0, 2.5, 5.0])
    ials = EG.ials_rule(ALPHA)
    assert torch.equal(ials.weight(v), ALPHA * v)
    assert torch.equal(ials.value(v), v * (1.0 + ALPHA * v))
    assert torch.equal(EG.MASKED.weight(v), v != 0)
    assert torch.equal(EG.MASKED.value(v), v)
    assert (ials.code, EG.MASKED.code) == (0, 1)


@pytest.mark.parametrize("device,dtype,r,kernel", [
    ("cuda", torch.float32, 128, True),
    ("cuda", torch.float32, 1, True),
    ("cuda", torch.float32, 129, False),
    ("cuda", torch.float64, 64, False),
    ("cpu", torch.float32, 64, False),
])
def test_route(device, dtype, r, kernel):
    assert EG.takes(device, dtype, r) is kernel


@pytest.mark.parametrize("case", ["cpu", "float64", "r129", "no_rule"])
def test_route_takes_the_plain_path(monkeypatch, case):
    """Off what the kernel takes, grams_and_rhs_ell never calls it, and
    gives the plain path's result."""
    def refuse(*a, **k):
        raise AssertionError("the kernel was called")

    monkeypatch.setattr(EG, "grams_rhs", refuse)
    ell = _ell("tiny")
    r = 129 if case == "r129" else 6
    dtype = torch.float64 if case == "float64" else torch.float32
    T = _table(ell.shape[1], r, dtype=dtype)
    ru = RULES["ials"]
    got = SE.grams_and_rhs_ell(ell, T, ru.weight, ru.value,
                               rule=None if case == "no_rule" else ru)
    want = SE.grams_and_rhs_ell(ell, T, ru.weight, ru.value)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].dtype == torch.float32 and got[0].shape == (12, r, r)


def test_the_route_would_take_the_kernel_on_the_card(monkeypatch):
    """With the route's predicate true, grams_and_rhs_ell hands the
    container, the contiguous table and the rule to the kernel."""
    seen = {}

    def fake(ell, table, rule):
        seen.update(ell=ell, table=table, rule=rule)
        return "kernel"

    monkeypatch.setattr(EG, "takes", lambda *a: True)
    monkeypatch.setattr(EG, "grams_rhs", fake)
    ell = _ell("tiny")
    T = _table(6, ell.shape[1]).T
    ru = RULES["masked"]
    assert SE.grams_and_rhs_ell(ell, T, ru.weight, ru.value,
                                rule=ru) == "kernel"
    assert seen["ell"] is ell and seen["rule"] is ru
    assert seen["table"].is_contiguous() and torch.equal(seen["table"], T)


def test_wrapper_refuses_cpu_tensors():
    ell = _ell("tiny")
    with pytest.raises(ValueError, match="CUDA"):
        EG.grams_rhs(ell, _table(ell.shape[1], 8), RULES["ials"])


def test_counters_report_the_launches():
    assert counters()["launches.ell_gram"] == EG.LAUNCHES["ell_gram"]


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _f64(ell, T, rule):
    """float64 Grams and right-hand sides through the plain path's
    per-segment sums, the weights taken of float64 values."""
    T = T.double()
    n, r = ell.shape[0], T.shape[1]
    G = torch.zeros((n, r, r), dtype=torch.float64, device=T.device)
    h = torch.zeros((n, r), dtype=torch.float64, device=T.device)
    for b in ell.buckets:
        for s, e, g, x in SE._bucket_grams_rhs(
                b, T, lambda v: rule.weight(v.double()),
                lambda v: rule.value(v.double()), 256):
            G.index_add_(0, b.out_row[s:e], g)
            h.index_add_(0, b.out_row[s:e], x)
    return G, h


def _row_err(x, want):
    """The largest over rows of max|x_i - want_i| / max|want_i| (rows
    whose result is not all zero)."""
    x, want = x.double().flatten(1), want.flatten(1)
    scale = want.abs().amax(1)
    keep = scale > 0
    return float(((x - want).abs().amax(1)[keep] / scale[keep]).max())


def _heavy(device):
    """300 rows, 120,000 columns: row 7 holds 110,000 nonzeros (215
    units), row 20 1,700 (four, across two buckets), rows 2 and 250
    none, stored zeros among the rest (about 360 a row, one unit each)."""
    coo = _coo(300, 120_000, seed=5, density=0.003,
               long_rows=((7, 110_000), (20, 1700)), empty_rows=(2, 250),
               zeros=True)
    return SE.build_ell_rows(coo, device=device)


def _check_against_plain(ell, T, rule):
    before = EG.LAUNCHES["ell_gram"]
    g, h = SE.grams_and_rhs_ell(ell, T, rule.weight, rule.value, rule=rule)
    launches = EG.LAUNCHES["ell_gram"] - before
    g2, h2 = SE.grams_and_rhs_ell(ell, T, rule.weight, rule.value, rule=rule)
    assert torch.equal(g, g2) and torch.equal(h, h2)
    pg, ph = SE.grams_and_rhs_ell(ell, T, rule.weight, rule.value)
    wg, wh = _f64(ell, T, rule)
    assert bool(torch.isfinite(g).all() and torch.isfinite(h).all())
    assert bool((g == g.transpose(1, 2)).all())
    for got, plain, want in ((g, pg, wg), (h, ph, wh)):
        assert _rel(got, plain) <= RTOL_SUM
        assert _row_err(got, want) <= 2 * _row_err(plain, want)
    return launches


@pytest.mark.cuda
@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("r", [16, 100, 128])
def test_kernel_on_a_heavy_row(dev, r, rule):
    ell = _heavy(dev)
    T = _table(ell.shape[1], r, seed=r, device=dev)
    launches = _check_against_plain(ell, T, RULES[rule])
    assert launches == 2
    g, h = SE.grams_and_rhs_ell(ell, T, RULES[rule].weight,
                                RULES[rule].value, rule=RULES[rule])
    for row in (2, 250):
        assert bool((g[row] == 0).all() and (h[row] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("r", [16, 100, 128])
def test_kernel_on_the_transposed_container(dev, r, rule):
    """The item half's shape: 3,000 rows of a 2,000 x 3,000 matrix's
    transpose, a few columns across buckets."""
    coo = _coo(2000, 3000, seed=6, density=0.01,
               long_rows=((1, 2900), (40, 1500)), empty_rows=(9,))
    ell = SE.build_ell_rows(coo.T, device=dev)
    T = _table(ell.shape[1], r, seed=r + 1, device=dev)
    _check_against_plain(ell, T, RULES[rule])


@pytest.mark.cuda
def test_one_launch_without_split_rows(dev):
    coo = _coo(500, 400, seed=7, density=0.05)
    ell = SE.build_ell_rows(coo, device=dev)
    assert EG.units_of(ell).slots == 0
    assert _check_against_plain(ell, _table(400, 64, device=dev),
                                RULES["ials"]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 7, 33])
def test_kernel_at_odd_widths(dev, r):
    """Widths that are not a multiple of 4 take the kernel's scalar
    loads and stores."""
    ell = _heavy(dev)
    _check_against_plain(ell, _table(ell.shape[1], r, device=dev),
                         RULES["ials"])


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_does_not_take(dev):
    ell = _heavy(dev)
    T = _table(ell.shape[1], 16, device=dev)
    with pytest.raises(ValueError, match="outside"):
        EG.grams_rhs(ell, _table(ell.shape[1], 129, device=dev),
                     RULES["ials"])
    with pytest.raises(TypeError, match="float32"):
        EG.grams_rhs(ell, T.double(), RULES["ials"])
    with pytest.raises(TypeError, match="rule"):
        EG.grams_rhs(ell, T, "ials")


@pytest.mark.cuda
def test_ials_fit_on_the_kernels(dev, monkeypatch):
    """An iALS fit of 3 iterations on the ELL engine through #13 and #12
    against the same fit on the plain Grams: 2 launches of #13 an
    iteration (no row of either half is split), and the factors within 1e-3 of
    their largest entry (float32 solves of kappa up to ~10^3 on both
    paths, each off by up to 10 kappa u = 6e-4)."""
    import nmftpu_torch as nt

    coo = _coo(400, 300, seed=8, density=0.05, long_rows=((0, 280),))
    coo = SparseCOO(row=coo.row, col=coo.col,
                    data=np.ones_like(coo.data), shape=coo.shape)
    rng = np.random.default_rng(9)
    r = 32
    W0 = rng.uniform(0.1, 1.0, (400, r)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (r, 300)).astype(np.float32)
    kw = dict(algorithm="als", alpha_confidence=ALPHA, lambda_w=0.1,
              lambda_h=0.1, num_iterations=3, check_interval=3, W0=W0,
              H0=H0, init="copy", strategy="ell", device=dev)
    before = counters()
    got = nt.nmf(coo, r, **kw)
    after = counters()
    assert after["launches.ell_gram"] - before["launches.ell_gram"] == 6
    assert after["launches.row_solve"] - before["launches.row_solve"] == 6
    monkeypatch.setattr(EG, "takes", lambda *a: False)
    want = nt.nmf(coo, r, **kw)
    assert counters()["launches.ell_gram"] == after["launches.ell_gram"]
    for g, w in ((got.W, want.W), (got.H, want.H)):
        rel = float((torch.as_tensor(g) - torch.as_tensor(w)).abs().max()
                    / torch.as_tensor(w).abs().max())
        assert rel <= 1e-3
