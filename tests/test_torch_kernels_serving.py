"""The serving kernels' plain torch twins against nmftpu's Pallas kernels
(interpret mode on the CPU) and a slot-wise numpy oracle, the wrappers'
checks and CPU route, and the build's per-entry signatures. The CUDA
kernels themselves are held against these twins on the card by
test_torch_kernels_cuda.py."""

import os
import re
import stat
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from nmftpu.kernels import count_above as JC  # noqa: E402
from nmftpu.kernels import mips_reservoir as JR  # noqa: E402
from nmftpu.retrieval import mips as JM  # noqa: E402
from nmftpu_torch.kernels import _build  # noqa: E402
from nmftpu_torch.kernels import count_above as CA  # noqa: E402
from nmftpu_torch.kernels import mips_reservoir as MR  # noqa: E402

# float32 sums of r <= 16 products in two orders: ~sqrt(r) * 2^-24
RTOL = 1e-5


def _inputs(b, r, m, seed=0):
    rng = np.random.default_rng(seed)
    Wq = rng.uniform(0.0, 1.0, (b, r)).astype(np.float32)
    mag = np.logspace(0, -2, r).astype(np.float32)[:, None]
    H = (rng.uniform(0.0, 1.0, (r, m)) * mag).astype(np.float32)
    return Wq, H


def _tables(H):
    """{kind: (jax table, torch table, h_scale)}."""
    Hb = jnp.asarray(H, jnp.bfloat16)
    sc = np.maximum(np.abs(H).max(axis=1) / 127.0, 1e-30).astype(np.float32)
    Hq = np.clip(np.round(H / sc[:, None]), -127, 127).astype(np.int8)
    s0 = np.float32(np.abs(H).max() / 127.0)
    Hq0 = np.clip(np.round(H / s0), -127, 127).astype(np.int8)
    return {
        "float32": (jnp.asarray(H), torch.tensor(H), None),
        "bfloat16": (Hb, torch.tensor(np.asarray(Hb).astype(np.float32))
                     .to(torch.bfloat16), None),
        "int8_vector": (jnp.asarray(Hq), torch.tensor(Hq), sc),
        "int8_scalar": (jnp.asarray(Hq0), torch.tensor(Hq0), s0),
    }


def _slotwise_top2_oracle(full, slots):
    """Per (query, slot) the best two (score, id), slot = id mod slots;
    equal scores keep the lower id. The kernel's reduction in numpy."""
    b, m = full.shape
    cand_s = np.full((b, 2 * slots), -np.inf, np.float32)
    cand_i = np.zeros((b, 2 * slots), np.int32)
    for q in range(b):
        for slot in range(min(slots, m)):
            ids = np.arange(slot, m, slots)
            order = np.argsort(-full[q, ids], kind="stable")[:2]
            for pos, o in enumerate(order):
                cand_s[q, slot + pos * slots] = full[q, ids[o]]
                cand_i[q, slot + pos * slots] = ids[o]
    return cand_s, cand_i


def assert_same_candidates(s, i, s_ref, i_ref, rtol=RTOL):
    """Slot by slot: scores within rtol (-inf equal); where the ids
    differ, the two competing scores lie within rtol of each other."""
    s, i, s_ref, i_ref = (np.asarray(x) for x in (s, i, s_ref, i_ref))
    np.testing.assert_allclose(s, s_ref, rtol=rtol, atol=0)
    slots = s.shape[1] // 2
    diff = (i != i_ref) & np.isfinite(s_ref)
    for q, c in zip(*np.nonzero(diff)):
        # best and second of one slot tied, or this slot's winner tied
        # with an item the other side kept in the partner column
        partner = c + slots if c < slots else c - slots
        assert abs(s_ref[q, c] - s_ref[q, partner]) <= \
            rtol * abs(s_ref[q, c]) or i[q, c] == i_ref[q, partner], (q, c)


# ---------------------------------------------------------------------------
# reservoir_scan_plain
# ---------------------------------------------------------------------------


RES_SHAPES = [(8, 8, 500, 128), (16, 16, 1000, 256), (5, 3, 40, 64)]


@pytest.mark.parametrize("shape", RES_SHAPES)
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8_vector"])
def test_reservoir_twin_matches_nmftpu(shape, kind):
    """The twin's (b, 2R) candidates against nmftpu's _reservoir_scan in
    interpret mode (padded table and query block, as its wrapper does);
    m is not a multiple of R, so the ragged last tile is masked."""
    b, r, m, slots = shape
    Wq, H = _inputs(b, r, m, seed=m)
    Hj, Ht, sc = _tables(H)[kind]
    Wq_eff = Wq if sc is None else Wq * sc
    mp = -(-m // slots) * slots
    Hp = jnp.pad(Hj, ((0, 0), (0, mp - m)))
    s_ref, i_ref = JR._reservoir_scan(jnp.asarray(Wq_eff), Hp, m, slots,
                                      b, interpret=True)
    s, i = MR.reservoir_scan_plain(torch.tensor(Wq_eff), Ht, m, slots)
    assert s.shape == (b, 2 * slots) and i.dtype == torch.int32
    assert_same_candidates(s, i, s_ref, i_ref)


@pytest.mark.parametrize("shape", RES_SHAPES)
def test_reservoir_twin_matches_the_slotwise_oracle(shape):
    b, r, m, slots = shape
    Wq, H = _inputs(b, r, m, seed=1)
    _, Ht, _ = _tables(H)["bfloat16"]
    q = torch.tensor(Wq).to(torch.bfloat16).double()
    full = (q @ Ht.double()).float().numpy()
    s_ref, i_ref = _slotwise_top2_oracle(full, slots)
    s, i = MR.reservoir_scan_plain(torch.tensor(Wq), Ht, m, slots)
    assert_same_candidates(s, i, s_ref, i_ref)


def test_reservoir_twin_tie_keeps_the_lower_id():
    """Equal scores in one slot: the earlier (lower) id stays first, and
    the later one becomes the second, as strict '>' in nmftpu's merge."""
    Wq = torch.ones(1, 2)
    H = torch.tensor([[1.0, 0.0, 1.0, 0.0, 1.0, 0.5],
                      [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    s, i = MR.reservoir_scan_plain(Wq, H, 6, 2)
    # slot 0 sees ids 0, 2, 4 (all 1.0); slot 1 sees 1, 3, 5
    assert i.tolist() == [[0, 5, 2, 1]]
    assert s.tolist() == [[1.0, 0.5, 1.0, 0.0]]


def _split_scan(Wq, H, m, slots, cuts):
    """The twin over the tile ranges [cuts[i], cuts[i + 1]), merged."""
    parts = [MR.reservoir_scan_plain(Wq, H, m, slots, tiles=(a, c))
             for a, c in zip(cuts, cuts[1:])]
    return MR.reservoir_merge_plain(torch.stack([p[0] for p in parts]),
                                    torch.stack([p[1] for p in parts]))


@pytest.mark.parametrize("shape", RES_SHAPES)
@pytest.mark.parametrize("kind", ["bfloat16", "int8_vector"])
def test_reservoir_split_walk_merges_to_the_one_pass_scan(shape, kind):
    """The tensor-core scan's split: the tile walk cut at several j (an
    empty range, halves, every tile alone), each range scanned by the twin
    and the ranges merged in order, equals the one-pass twin bit for bit
    and nmftpu's _reservoir_scan in interpret mode."""
    b, r, m, slots = shape
    Wq, H = _inputs(b, r, m, seed=m + 7)
    Hj, Ht, sc = _tables(H)[kind]
    Wq_eff = Wq if sc is None else Wq * sc
    tiles = -(-m // slots)
    Hp = jnp.pad(Hj, ((0, 0), (0, tiles * slots - m)))
    s_ref, i_ref = JR._reservoir_scan(jnp.asarray(Wq_eff), Hp, m, slots, b,
                                      interpret=True)
    s1, i1 = MR.reservoir_scan_plain(torch.tensor(Wq_eff), Ht, m, slots)
    for cuts in ([0, 0, tiles], [0, tiles // 2, tiles],
                 list(range(tiles + 1))):
        s, i = _split_scan(torch.tensor(Wq_eff), Ht, m, slots, cuts)
        assert torch.equal(s, s1) and torch.equal(i, i1), cuts
        assert_same_candidates(s, i, s_ref, i_ref)


@pytest.mark.parametrize("cuts", [[0, 1, 3], [0, 2, 3], [0, 1, 2, 3]])
def test_reservoir_split_walk_keeps_the_lower_id_on_ties(cuts):
    """Equal scores in different ranges: the merge keeps the earlier,
    lower id first, as the one-pass scan and nmftpu's kernel do."""
    Wq = torch.ones(1, 2)
    H = torch.tensor([[1.0, 0.0, 1.0, 0.0, 1.0, 0.5],
                      [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    s, i = _split_scan(Wq, H, 6, 2, cuts)
    assert i.tolist() == [[0, 5, 2, 1]]
    assert s.tolist() == [[1.0, 0.5, 1.0, 0.0]]
    s_ref, i_ref = JR._reservoir_scan(jnp.asarray(Wq.numpy()),
                                      jnp.asarray(H.numpy()), 6, 2, 1,
                                      interpret=True)
    assert np.asarray(i_ref).tolist() == i.tolist()


@pytest.mark.parametrize("b,slots,m,plan", [
    (512, 4096, 10_485_760, (2560, 1)),    # config 5: 256 blocks, one range
    (2048, 4096, 10_485_760, (2560, 1)),
    (512, 16_384, 10_485_760, (640, 1)),   # the escalation's slots
    (64, 4096, 10_485_760, (1280, 2)),     # 64 blocks: two ranges fill a wave
    (256, 4096, 10_485_760, (2560, 1)),    # 128 blocks: a wave already
    (37, 1024, 10_007, (5, 2)),            # 16 blocks: ranges of >= 4 tiles
    (4, 64, 10_000_000, (1184, 132)),      # 1 block: one per SM
    (1, 64, 100, (2, 1)),
])
def test_tc_plan(b, slots, m, plan):
    assert MR.tc_plan(b, slots, m) == plan


@pytest.mark.parametrize("b,slots", [(4096, 4096), (1, 64)])
def test_tc_plan_keeps_each_range_under_65536_tiles(b, slots):
    """A block keeps 16-bit tile indices, so no range may hold more."""
    m = 2**31 - 1
    tiles = -(-m // slots)
    per, splits = MR.tc_plan(b, slots, m)
    assert per <= 65536 and (splits - 1) * per < tiles <= splits * per


@pytest.mark.parametrize("offsets,g", [
    ((0, 10_485_760, 4096), 16),       # config 5's int8 table
    ((0, 2 * 10_485_760, 2 * 4096), 16),
    ((0, 26_744, 64), 8),              # 8 mod 16: ML-20M's m
    ((0, 1500, 64), 4),
    ((0, 10_007, 1024), 1),            # phase 7's odd m
    ((0, 2 * 10_007, 2 * 1024), 1),    # bf16 rows 2 mod 4 bytes
    ((8, 4096, 4096), 8),              # the base address counts too
])
def test_copy_alignment(offsets, g):
    assert _build.copy_alignment(*offsets) == g


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8,
                                   torch.float32])
def test_every_table_takes_ranks_up_to_max_rank(dtype):
    """The kernels take r <= MAX_RANK for every table type (the
    tensor-core scan streams ranks above 288 in chunks); the twins take
    any rank (max_rank=None)."""
    for r in (512, MR.MAX_RANK):
        ok = MR.check_scan_operands("t", torch.zeros(2, r),
                                    torch.zeros(r, 9, dtype=dtype), 9,
                                    (dtype,))
        assert ok == (2, r)
    big = (torch.zeros(2, MR.MAX_RANK + 1),
           torch.zeros(MR.MAX_RANK + 1, 9, dtype=dtype))
    with pytest.raises(ValueError, match=str(MR.MAX_RANK)):
        MR.check_scan_operands("t", *big, 9, (dtype,))
    assert MR.check_scan_operands("t", *big, 9, (dtype,), None) == \
        (2, MR.MAX_RANK + 1)


@pytest.mark.parametrize("kind", ["bfloat16", "int8_vector"])
def test_cpu_wrappers_take_ranks_above_the_kernels_limit(kind):
    """On CPU tensors the wrappers run the twins, which have no rank
    limit: at a rank above MAX_RANK they give the twins' results, and
    the scan nmftpu's _reservoir_scan's in interpret mode."""
    b, r, m, slots = 3, MR.MAX_RANK + 8, 200, 64
    Wq, H = _inputs(b, r, m, seed=11)
    Hj, Ht, sc = _tables(H)[kind]
    Wq_eff = torch.tensor(Wq if sc is None else Wq * sc)
    s, i = MR.reservoir_scan(Wq_eff, Ht, m, slots)
    s0, i0 = MR.reservoir_scan_plain(Wq_eff, Ht, m, slots)
    assert torch.equal(s, s0) and torch.equal(i, i0)
    Hp = jnp.pad(Hj, ((0, 0), (0, 256 - m)))
    s_ref, i_ref = JR._reservoir_scan(jnp.asarray(Wq_eff.numpy()), Hp, m,
                                      slots, b, interpret=True)
    assert_same_candidates(s, i, s_ref, i_ref)
    theta = s[:, 5]
    hs = None if sc is None else torch.tensor(sc)
    assert torch.equal(
        CA.count_above_fused(torch.tensor(Wq), Ht, theta, h_scale=hs),
        CA.count_above_fused_plain(torch.tensor(Wq), Ht, theta, h_scale=hs))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8_vector",
                                  "int8_scalar"])
def test_reservoir_topk_mips_matches_nmftpu(kind):
    b, r, m, k, slots = 8, 16, 700, 10, 128
    Wq, H = _inputs(b, r, m, seed=3)
    Hj, Ht, sc = _tables(H)[kind]
    rng = np.random.default_rng(3)
    seen = np.full((b, 5), -1, np.int32)
    seen[:, :3] = rng.integers(0, m, (b, 3))
    for sn in (None, seen):
        s_ref, i_ref = JR.reservoir_topk_mips(
            jnp.asarray(Wq), Hj, k, slots=slots, h_scale=sc, q_block=8,
            seen=None if sn is None else jnp.asarray(sn), interpret=True)
        s, i = MR.reservoir_topk_mips(torch.tensor(Wq), Ht, k, slots=slots,
                                      h_scale=sc, seen=sn)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=RTOL)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        if sn is not None:
            for row in range(b):
                assert not set(i[row].tolist()) & set(sn[row].tolist())


def test_reservoir_validation_matches_nmftpu():
    Wq, H = _inputs(2, 4, 64)
    Wt, Ht = torch.tensor(Wq), torch.tensor(H)
    with pytest.raises(ValueError, match="quantization scale"):
        MR.reservoir_topk_mips(Wt, Ht.to(torch.int8), 3, slots=64)
    with pytest.raises(ValueError, match="only meaningful with an integer"):
        MR.reservoir_topk_mips(Wt, Ht, 3, slots=64, h_scale=0.5)
    with pytest.raises(ValueError, match="2\\*slots"):
        MR.reservoir_topk_mips(Wt, Ht, 3, slots=4,
                               seen=np.zeros((2, 6), np.int32))
    with pytest.raises(ValueError, match="slots"):
        MR.reservoir_scan(Wt, Ht, 64, 0)


# ---------------------------------------------------------------------------
# count_above_fused_plain
# ---------------------------------------------------------------------------


def _thetas(Wq, H, seed):
    """Random per-row thresholds inside the score range."""
    full = Wq.astype(np.float64) @ H.astype(np.float64)
    rng = np.random.default_rng(seed)
    return np.array([np.quantile(row, q) for row, q in
                     zip(full, rng.uniform(0.5, 1.0, len(full)))],
                    np.float32) * np.float32(1.0001)


@pytest.mark.parametrize("kind", ["bfloat16", "int8_vector"])
@pytest.mark.parametrize("shape", [(24, 16, 1000), (7, 5, 333)])
def test_count_twin_matches_nmftpu_exactly(kind, shape):
    b, r, m = shape
    Wq, H = _inputs(b, r, m, seed=4)
    Hj, Ht, sc = _tables(H)[kind]
    theta = _thetas(Wq, H, 4)
    ref = JM._count_above(jnp.asarray(Wq), Hj, jnp.asarray(theta), 256, sc)
    fused = JC.count_above_fused(jnp.asarray(Wq), Hj, jnp.asarray(theta),
                                 h_scale=sc, tile=256, q_block=8,
                                 interpret=True)
    got = CA.count_above_fused_plain(torch.tensor(Wq), Ht,
                                     torch.tensor(theta), h_scale=sc)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(fused))


def test_count_twin_scalar_scale_agrees_up_to_boundary_items():
    """A scalar scale divides theta in the twin (as in nmftpu's kernel)
    where _count_above multiplies the scores: counts may differ only by
    the items whose score lies within rounding of theta. Thresholds set
    exactly at item scores make such items exist."""
    b, r, m = 16, 16, 2000
    Wq, H = _inputs(b, r, m, seed=5)
    Hj, Ht, sc = _tables(H)["int8_scalar"]
    full = np.asarray(JM._score_dot(jnp.asarray(Wq), Hj, sc))
    theta = np.sort(full, axis=1)[:, -50].copy()        # the 50th score
    ref = np.asarray(JM._count_above(jnp.asarray(Wq), Hj,
                                     jnp.asarray(theta), 512, sc))
    got = CA.count_above_fused_plain(torch.tensor(Wq), Ht,
                                     torch.tensor(theta), h_scale=sc).numpy()
    near = (np.abs(full - theta[:, None])
            <= 4 * np.spacing(np.abs(theta))[:, None]).sum(1)
    assert (np.abs(got - ref) <= near).all()
    assert (ref == 49).all()                    # the reference itself


def test_count_twin_theta_minus_inf_counts_every_item():
    Wq, H = _inputs(3, 4, 100)
    got = CA.count_above_fused_plain(
        torch.tensor(Wq), torch.tensor(H).to(torch.bfloat16),
        torch.full((3,), float("-inf")), m_items=90)
    assert got.tolist() == [90, 90, 90]


def test_count_validation_matches_nmftpu():
    Wq, H = _inputs(2, 4, 64)
    Wt, Ht, th = torch.tensor(Wq), torch.tensor(H), torch.zeros(2)
    with pytest.raises(ValueError, match="bfloat16/int8"):
        CA.count_above_fused(Wt, Ht, th)
    with pytest.raises(ValueError, match="quantization scale"):
        CA.count_above_fused(Wt, Ht.to(torch.int8), th)
    with pytest.raises(ValueError, match="only meaningful with an integer"):
        CA.count_above_fused(Wt, Ht.to(torch.bfloat16), th, h_scale=0.5)


# ---------------------------------------------------------------------------
# wrappers: CPU route, checks, counts
# ---------------------------------------------------------------------------


def test_cpu_wrappers_run_the_twins_and_count_nothing():
    Wq, H = _inputs(6, 8, 300)
    Wt, Hb = torch.tensor(Wq), torch.tensor(H).to(torch.bfloat16)
    counts = (dict(MR.LAUNCHES), dict(CA.LAUNCHES))
    s, i = MR.reservoir_scan(Wt, Hb, 300, 64)
    s0, i0 = MR.reservoir_scan_plain(Wt, Hb, 300, 64)
    assert torch.equal(s, s0) and torch.equal(i, i0)
    theta = s[:, 3]
    assert torch.equal(CA.count_above_fused(Wt, Hb, theta),
                       CA.count_above_fused_plain(Wt, Hb, theta))
    assert (dict(MR.LAUNCHES), dict(CA.LAUNCHES)) == counts
    assert not any(MR.VARIANT_LAUNCHES.values())


@pytest.mark.parametrize("bad,error", [
    ("wq_dtype", TypeError), ("table_dtype", TypeError),
    ("wq_strided", ValueError), ("h_strided", ValueError),
    ("shape", ValueError), ("rank", ValueError), ("m_items", ValueError),
])
def test_scan_operand_checks(bad, error):
    """The checks a CUDA launch passes first (run here on CPU tensors)."""
    Wq, H = (torch.tensor(x) for x in _inputs(4, 8, 50))
    m = 50
    if bad == "wq_dtype":
        Wq = Wq.double()
    elif bad == "table_dtype":
        H = H.half()
    elif bad == "wq_strided":
        Wq = Wq.T.contiguous().T
    elif bad == "h_strided":
        H = H.T.contiguous().T
    elif bad == "shape":
        Wq = Wq[:, :7]
    elif bad == "rank":
        Wq = torch.zeros(4, MR.MAX_RANK + 1)
        H = torch.zeros(MR.MAX_RANK + 1, 50)
    elif bad == "m_items":
        m = 51
    with pytest.raises(error):
        MR.check_scan_operands("test", Wq, H, m,
                               (torch.float32, torch.bfloat16))


def test_scan_operand_checks_accept_valid_operands():
    Wq, H = (torch.tensor(x) for x in _inputs(4, 8, 50))
    assert MR.check_scan_operands("test", Wq, H, 40, (torch.float32,)) \
        == (4, 8)


def test_wrappers_reject_other_devices():
    Wq, H = (torch.tensor(x) for x in _inputs(4, 8, 50))
    with pytest.raises(ValueError, match="different devices"):
        MR.reservoir_scan(Wq.to("meta"), H, 50, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        CA.count_above_fused(Wq.to("meta"), H.to(torch.bfloat16).to("meta"),
                             torch.zeros(4, device="meta"))


# ---------------------------------------------------------------------------
# the build: per-entry signatures, one nvcc per source
# ---------------------------------------------------------------------------


def test_every_entry_declares_its_own_signature():
    """Each C entry's parameter count in csrc/ equals its argtypes, and
    pointer-sized parameters are declared as such."""
    text = "".join(p.read_text() for p in _build._sources())
    assert isinstance(_build.ENTRIES, dict)
    for entry, argtypes in _build.ENTRIES.items():
        m = re.search(rf"int {entry}\(([^)]*)\)", text)
        assert m, entry
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), entry
        for p, t in zip(params, argtypes):
            if "*" in p or p.startswith("cudaStream_t"):
                assert t is _build.ctypes.c_void_p, (entry, p)
            elif p.startswith("long long"):
                assert t is _build.ctypes.c_longlong, (entry, p)
            elif p.startswith("int "):
                assert t is _build.ctypes.c_int, (entry, p)


def _fake_nvcc(tmp_path, fail_on=None):
    """A stand-in nvcc that logs its arguments and writes its -o file."""
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"log = {str(tmp_path / 'calls')!r}\n"
        "open(log, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        f"if {fail_on!r} and any(a.endswith({fail_on!r}) for a in sys.argv):\n"
        "    print('error: boom'); sys.exit(2)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('x')\n"
        "print('ptxas info    : Used 1 registers')\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_build_compiles_each_source_then_links_one_library(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    out = _build.build()
    assert out.exists() and out.parent == tmp_path / "build"
    calls = (tmp_path / "calls").read_text().splitlines()
    sources = _build._sources()
    assert len(sources) >= 3
    assert len(calls) == len(sources) + 1
    compiled = sorted(c.split()[-1] for c in calls if " -c " in c)
    assert compiled == sorted(map(str, sources))
    assert "-shared" in calls[-1] and "arch=compute_90a,code=sm_90a" in \
        calls[-1]
    log = out.with_suffix(".so.log").read_text()
    # every step's command line and output, compiles and the link
    assert log.count("Used 1 registers") == len(calls)
    assert all(c in log for c in calls)
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        [out.name, out.name + ".log"])


def test_build_failure_of_one_source_raises_and_leaves_no_library(
        tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc",
                        lambda: _fake_nvcc(tmp_path, "count_above.cu"))
    with pytest.raises(RuntimeError, match="count_above.cu"):
        _build.build()
    assert not _build.library_path().exists()
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        _build.library_path().name + ".log"]
