"""`python -m nmftpu_torch` against `python -m nmftpu` on the same files,
on the CPU (NMFTPU_PLATFORM=cpu): the same summary keys, the same
iteration counts, errors from the same deterministic init (NNDSVD, the
same host SVD in both packages) within rtol 1e-4 on dense float32 V and
within 5 * 2^-9 on sparse V (auto's densified bf16 engine in both,
whose factors round to bf16 at every step); --save writes a bundle
Recommender.load reads, --metrics one JSONL record per check."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nmftpu import __main__ as JCLI  # noqa: E402
from nmftpu_torch import __main__ as TCLI  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ML100K = os.path.join(REPO, "tests", "fixtures", "ml100k_u.data")


def _summary(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("NMFTPU_PLATFORM", "cpu")


def test_dense_npy_matches_nmftpu(cpu, tmp_path, capsys):
    rng = np.random.default_rng(0)
    V = rng.uniform(0.1, 2.0, (60, 40)).astype(np.float32)
    path = str(tmp_path / "v.npy")
    np.save(path, V)
    argv = [path, "--rank", "5", "--iters", "20", "--init", "nndsvd",
            "--verbosity", "0"]
    want = _summary(JCLI.main, argv, capsys)
    got = _summary(TCLI.main, argv, capsys)
    assert set(got) == set(want)
    assert got["iterations"] == want["iterations"] == 20
    np.testing.assert_allclose(got["frobenius_error"],
                               want["frobenius_error"], rtol=1e-4)
    got = _summary(TCLI.main, argv + ["--objective", "kl"], capsys)
    want = _summary(JCLI.main, argv + ["--objective", "kl"], capsys)
    assert set(got) == set(want) and "kl_error" in got
    np.testing.assert_allclose(got["kl_error"], want["kl_error"], rtol=1e-4)


def test_movielens_recall_save_metrics(cpu, tmp_path, capsys):
    argv = [ML100K, "--rank", "8", "--iters", "20", "--init", "nndsvd",
            "--eval-recall", "10", "--verbosity", "0"]
    want = _summary(JCLI.main, argv, capsys)
    jsonl = str(tmp_path / "m.jsonl")
    save = str(tmp_path / "bundle")
    got = _summary(TCLI.main, argv + ["--save", save, "--metrics", jsonl],
                   capsys)
    assert set(got) == set(want) | {"saved"}
    assert 0.0 <= got["recall@10"] <= 1.0
    np.testing.assert_allclose(got["frobenius_error"],
                               want["frobenius_error"], rtol=5 * 2**-9)
    recs = [json.loads(x) for x in open(jsonl)]
    assert [r["iteration"] for r in recs] == [10, 20]
    assert all(r["cli"] is True for r in recs)
    from nmftpu_torch.serving import Recommender

    from nmftpu_torch.data import load_movielens

    inter = load_movielens(ML100K)
    rec = Recommender.load(save, device="cpu")
    assert (rec.n_users, rec.n_items) == (inter.n_users, inter.n_items)
    out = rec.recommend([0, 5], k=10)
    assert np.asarray(out[0]).shape == (2, 10)


def test_eval_recall_on_npy_refused_as_nmftpu(cpu, tmp_path):
    path = str(tmp_path / "v.npy")
    np.save(path, np.ones((4, 3), np.float32))
    with pytest.raises(SystemExit) as jerr:
        JCLI.main([path, "--eval-recall", "5"])
    with pytest.raises(SystemExit) as terr:
        TCLI.main([path, "--eval-recall", "5"])
    assert str(terr.value) == str(jerr.value)


def test_python_dash_m_runs_on_the_cpu(tmp_path):
    """The module entry point in a fresh interpreter with
    NMFTPU_PLATFORM=cpu: exit 0, the summary JSON last."""
    path = str(tmp_path / "v.npy")
    np.save(path, np.random.default_rng(1).uniform(
        0.1, 1, (30, 20)).astype(np.float32))
    out = subprocess.run(
        [sys.executable, "-m", "nmftpu_torch", path, "--rank", "3",
         "--iters", "10", "--algorithm", "hals"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "NMFTPU_PLATFORM": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["iterations"] == 10 and summary["rmsd"] > 0
    assert "dense matrix (30, 20)" in out.stdout
