"""The count kernel's exact band (``nmftpu_torch/kernels/count_above.py``)
on the CPU.

The CUDA count kernel scores on the bf16 tensor cores, which sum the r
exact float32 products in another order than the k-ordered chain the
certificate's theta comes from. Its rule: a score above theta + tau
counts, one below theta - tau does not, and the pairs in between are
re-scored by the chain. Here tau is held against the chain for other
summation orders (reverse, 16-blocked, pairwise, and an emulation of a
tensor-core accumulation that aligns each group to its largest addend and
truncates), and counting through the band is held to the chain's count
exactly, and to ``nmftpu``'s count kernel (interpret mode) where no score
ties theta. The kernel itself is held to the chain count on the card by
``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from nmftpu.kernels import count_above as JC  # noqa: E402
from nmftpu_torch._operands import _scan_operands  # noqa: E402
from nmftpu_torch.kernels import count_above as CA  # noqa: E402
from nmftpu_torch.retrieval.mips import _gather_scores  # noqa: E402

KINDS = ["bfloat16", "int8_vector", "bfloat16_signed"]


def _operands(b, r, m, kind, seed):
    """(Wq float32, H table, h_scale) as the serving tables hold them."""
    rng = np.random.default_rng(seed)
    if kind == "bfloat16_signed":
        Wq = rng.standard_normal((b, r)).astype(np.float32)
        H = rng.standard_normal((r, m)).astype(np.float32)
        return torch.tensor(Wq), torch.tensor(H).to(torch.bfloat16), None
    Wq = rng.uniform(0.0, 1.0, (b, r)).astype(np.float32)
    mag = np.logspace(0, -2, r).astype(np.float32)[:, None]
    H = (rng.uniform(0.0, 1.0, (r, m)) * mag).astype(np.float32)
    if kind == "bfloat16":
        return torch.tensor(Wq), torch.tensor(H).to(torch.bfloat16), None
    sc = np.maximum(np.abs(H).max(axis=1) / 127.0, 1e-30).astype(np.float32)
    Hq = np.clip(np.round(H / sc[:, None]), -127, 127).astype(np.int8)
    return torch.tensor(Wq), torch.tensor(Hq), torch.tensor(sc)


def _products(Wq, H, hs):
    """(r, b, m) float32: the exact products bf16(q[k]) H[k, j]."""
    q = _scan_operands(Wq, H.dtype, hs)[0]
    p = q.double().T[:, :, None] * H.double()[:, None, :]
    assert torch.equal(p.float().double(), p)          # each is exact
    return p.float().numpy()


def _chain(p):
    acc = np.zeros(p.shape[1:], np.float32)
    for k in range(p.shape[0]):
        acc = acc + p[k]
    return acc


def _reverse(p):
    return _chain(p[::-1])


def _blocked16(p):
    acc = np.zeros(p.shape[1:], np.float32)
    for k0 in range(0, p.shape[0], 16):
        acc = acc + _chain(p[k0:k0 + 16])
    return acc


def _pairwise(p):
    while p.shape[0] > 1:
        if p.shape[0] % 2:
            p = np.concatenate([p, np.zeros_like(p[:1])])
        p = p[0::2] + p[1::2]
    return p[0]


def _truncate(x, like):
    """x (float64) cut toward zero to a multiple of ulp32(max |like|) over
    axis 0 (float32's 24-bit significand at the largest exponent)."""
    e = np.frexp(np.abs(like).max(axis=0))[1]
    quantum = np.ldexp(1.0, e - 24)
    return np.trunc(x / quantum) * quantum


def _tensor_core_like(p):
    """Each 16-deep step adds its products to the accumulator the way a
    truncating tensor core may: every addend (the accumulator included)
    aligned to the largest one's exponent and cut toward zero to 24 bits,
    summed exactly, and the sum cut toward zero to a float32."""
    acc = np.zeros(p.shape[1:], np.float64)
    for k0 in range(0, p.shape[0], 16):
        add = np.concatenate([acc[None], p[k0:k0 + 16].astype(np.float64)])
        s = _truncate(add, add).sum(axis=0)
        acc = _truncate(s[None], s[None])[0]
    assert np.array_equal(acc.astype(np.float32).astype(np.float64), acc)
    return acc.astype(np.float32)


ORDERS = {"reverse": _reverse, "blocked16": _blocked16,
          "pairwise": _pairwise, "tensor_core_like": _tensor_core_like}


def _tau(Wq, H, hs):
    q = _scan_operands(Wq, H.dtype, hs)[0]
    return CA.band_tau(q, CA.table_h_max(H)).numpy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("r", [16, 37, 256])
@pytest.mark.parametrize("order", list(ORDERS))
def test_tau_bounds_every_summation_order(kind, r, order):
    """|other order - chain| <= tau, and within the derivation's 2.5 r
    2^-23 ||q||_1 h_max (the kernel's header), so tau's constant 4 keeps
    a margin."""
    Wq, H, hs = _operands(8, r, 300, kind, seed=r)
    p = _products(Wq, H, hs)
    diff = np.abs(ORDERS[order](p).astype(np.float64)
                  - _chain(p).astype(np.float64))
    tau = _tau(Wq, H, hs)[:, None]
    assert (diff <= tau * 2.5 / CA.BAND_C).all()


@pytest.mark.parametrize("kind", KINDS)
def test_chain_scores_are_gather_scores_bit_for_bit(kind):
    Wq, H, hs = _operands(6, 37, 200, kind, seed=1)
    q = _scan_operands(Wq, H.dtype, hs)[0]
    rows = torch.arange(6).repeat_interleave(200)
    cols = torch.arange(200).repeat(6).int()
    got = CA.chain_scores(q[rows], H, cols).reshape(6, 200)
    want = _gather_scores(Wq, H, torch.arange(200).int().repeat(6, 1), hs)
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(), _chain(_products(Wq, H, hs)))


def _thresholds(chain, rank):
    """Each row's `rank`-th chain score (an item sits exactly at theta, as
    in the certificate), row 0 -inf, row 1 +inf."""
    theta = torch.tensor(np.sort(chain, axis=1)[:, -rank].copy())
    theta[0], theta[1] = float("-inf"), float("inf")
    return theta


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("r", [37, 256])
@pytest.mark.parametrize("scores", ["matmul", *ORDERS])
def test_band_resolves_any_order_to_the_chain_count(kind, r, scores):
    b, m = 8, 300
    Wq, H, hs = _operands(b, r, m, kind, seed=r + 1)
    p = _products(Wq, H, hs)
    chain = _chain(p)
    theta = _thresholds(chain, 10)
    if scores == "matmul":
        s = _scan_operands(Wq, H.dtype, hs)[0] @ H.float()
    else:
        s = torch.tensor(ORDERS[scores](p))
    got, band = CA.count_through_band(Wq, H, theta, s, h_scale=hs)
    want = (torch.tensor(chain) > theta[:, None]).sum(1, dtype=torch.int32)
    assert torch.equal(got, want)
    assert got[0] == m and got[1] == 0
    assert band >= b - 2          # the item at theta, in every finite row


@pytest.mark.parametrize("kind", ["bfloat16", "int8_vector"])
def test_all_ties_go_through_the_band_and_none_counts(kind):
    b, r, m = 5, 37, 120
    Wq, H, hs = _operands(b, r, 1, kind, seed=3)
    H = H.expand(r, m).contiguous()                     # one column, m times
    theta = _gather_scores(Wq, H, torch.zeros(b, 1, dtype=torch.int32),
                           hs)[:, 0]
    theta[0] = float("-inf")
    s = _scan_operands(Wq, H.dtype, hs)[0] @ H.float()
    got, band = CA.count_through_band(Wq, H, theta, s, h_scale=hs)
    assert got.tolist() == [m] + [0] * (b - 1)
    assert band == (b - 1) * m


@pytest.mark.parametrize("kind", KINDS)
def test_zero_queries_never_enter_the_band(kind):
    """A query whose bf16 row is all zero (row 4 only after rounding)
    scores exactly 0 on every item: with theta 0 or -0 every item ties it,
    yet no pair enters the band and none counts; theta < 0 counts every
    item. Only the other rows' pairs go through the band."""
    b, r, m = 6, 37, 300
    Wq, H, hs = _operands(b, r, m, kind, seed=5)
    Wq[1:4] = 0.0
    Wq[4] = 1e-45                           # zero once rounded to bf16
    chain = _chain(_products(Wq, H, hs))
    assert not chain[1:5].any()
    theta = torch.tensor(np.sort(chain, axis=1)[:, -10].copy())
    theta[1:5] = torch.tensor([0.0, -0.0, -1.0, 0.0])
    s = _scan_operands(Wq, H.dtype, hs)[0] @ H.float()
    got, band = CA.count_through_band(Wq, H, theta, s, h_scale=hs)
    want = (torch.tensor(chain) > theta[:, None]).sum(1, dtype=torch.int32)
    assert torch.equal(got, want)
    assert got[1:5].tolist() == [0, 0, m, 0]
    keep = torch.tensor([0, 5])
    _, others = CA.count_through_band(Wq[keep], H, theta[keep], s[keep],
                                      h_scale=hs)
    assert band == others >= 2


@pytest.mark.parametrize("kind", ["bfloat16", "int8_vector"])
def test_band_count_matches_nmftpu_off_ties(kind):
    """Thresholds between item scores: the band rule, the chain and
    nmftpu's count kernel (interpret mode) give the same counts."""
    Wq, H, hs = _operands(16, 16, 1000, kind, seed=4)
    chain = _chain(_products(Wq, H, hs))
    srt = np.sort(chain, axis=1)
    theta = ((srt[:, -20].astype(np.float64) + srt[:, -21]) / 2).astype(
        np.float32)
    Hj = jnp.asarray(H.float().numpy(), jnp.bfloat16 if kind == "bfloat16"
                     else jnp.int8)
    sc = None if hs is None else hs.numpy()
    ref = JC.count_above_fused(jnp.asarray(Wq.numpy()), Hj,
                               jnp.asarray(theta), h_scale=sc, tile=256,
                               q_block=8, interpret=True)
    s = _scan_operands(Wq, H.dtype, hs)[0] @ H.float()
    got, _ = CA.count_through_band(Wq, H, torch.tensor(theta), s,
                                   h_scale=hs)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(got.numpy(), (chain > theta[:, None]).sum(1))


def test_band_limits_round_outward():
    q = torch.rand(6, 37)
    theta = torch.tensor([0.0, 1.0, -3.5, 1e-30, float("inf"),
                          float("-inf")])
    lo, hi = CA.band_limits(q, theta, 128.0)
    tau = CA.band_tau(q, 128.0)
    fin = torch.isfinite(theta)
    assert lo.dtype == hi.dtype == torch.float32
    assert bool((lo.double()[fin] <= theta.double()[fin] - tau[fin]).all())
    assert bool((hi.double()[fin] >= theta.double()[fin] + tau[fin]).all())
    # +inf: nothing finite above hi, nothing finite in [lo, hi]
    assert hi[4] == float("inf") and lo[4] == torch.finfo(torch.float32).max
    # -inf: every finite score above hi
    assert lo[5] == float("-inf") and hi[5] == -torch.finfo(torch.float32).max
    # an all-zero query: both limits infinite, on the side theta puts them
    lo, hi = CA.band_limits(torch.zeros(3, 37),
                            torch.tensor([0.0, -1e-30, 2.0]), 128.0)
    assert lo.tolist() == hi.tolist() == [float("inf"), float("-inf"),
                                          float("inf")]


def test_table_h_max():
    H = torch.tensor([[1.0, -7.0, 2.0], [3.0, 0.5, -40.0]])
    assert CA.table_h_max(H.to(torch.int8)) == CA.INT8_H_MAX
    assert float(CA.table_h_max(H.to(torch.bfloat16))) == 40.0
    assert float(CA.table_h_max(H.to(torch.bfloat16), m_items=2)) == 7.0
    assert CA.table_h_max(H.to(torch.bfloat16), h_max=9.0) == 9.0


@pytest.mark.parametrize("b,m", [(512, 10_485_760), (2048, 10_485_760),
                                 (37, 10_007), (1, 64), (700, 130)])
def test_count_plan_covers_every_tile_in_one_wave(b, m):
    per, ranges = CA.count_plan(b, m)
    tiles = -(-m // 64)
    qblocks = -(-b // 128)
    assert per * ranges >= tiles > per * (ranges - 1)
    assert qblocks * ranges <= max(132, qblocks)
    assert per >= 2 or tiles < 2
