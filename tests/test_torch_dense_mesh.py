"""Dense V on the port's rank mesh (nmftpu_torch.driver.compute(mesh=),
parallel.dense_mesh) against nmftpu.driver.compute(mesh=) on the CPU.

The port runs in one 4-rank gloo world (meshes 2 x 2, 1 x 4 and 4 x 1;
30 x 37 V, so every mesh pads rows or columns); the ranks run
tests/torch_mesh_ranks.py, which imports neither jax nor nmftpu.
nmftpu runs here on meshes of the conftest's virtual CPU devices, from
the same numpy inputs and W0/H0.

Tolerances:
* against the port's own one-device run: float32 routes 1e-5 of max|x|
  (sums in another order); bf16 V 2e-2 of max|x| for the factors and
  1e-4 relative for the errors (a factor rounded to bf16 can flip a
  rounding boundary where the order of a sum moved it by an ulp);
* against nmftpu's mesh run: float32 routes, errors 1e-4 relative and
  factors 1e-3 of max|x| after 2 iterations; bf16 V, errors 1e-3 and
  factors 2e-2;
* int8 V: off the TPU nmftpu's mesh run takes its dequantized bf16
  route (nmftpu/algorithms/registry.py:226-236), so the port's int8 x
  int8 routes are held as the single-device int8 tests hold them: one
  iteration against nmftpu's `mu_update_frobenius_int8x8` /
  `als_family_update_int8x8` on the unpadded V, 1e-5 of max|x| (the
  integer sums are exact; the Grams' order differs); use_pallas int8
  (#3/#4: float factors against the int8 V and its scale) against MU in
  float64 numpy on the dequantized V, 1e-5 of max|x| after 2 iterations;
  int8 KL against nmftpu's mesh run as the float32 routes.
* the inits (float64, num_iterations=0): against the port's
  `initialize_factors` of the zero-padded V (of V itself for random
  values) from the run's generator, 1e-12 of max|x|; the deterministic
  ones and k-means (nmftpu's `jax.random.choice` handed the port's seed
  columns) against nmftpu's mesh run's, 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nmftpu.driver as j_driver
from nmftpu import Algorithm, Initialization, NmfConfig, Objective
from nmftpu.kernels import quantized as JQ
from nmftpu.linalg import dense as JD
from nmftpu.parallel import make_grid_mesh
from nmftpu_torch.parallel import launch

import torch_mesh_ranks as M

N, M_, RANK = 30, 37, 4
TIMEOUT = 300
TWO = dict(rank=RANK, num_iterations=2, check_interval=1)
ONE = dict(rank=RANK, num_iterations=1, check_interval=1)

FLOAT = {
    "mu-frobenius": {},
    "mu-frobenius-hw": dict(update_order="HW"),
    "mu-kl": dict(objective="kullback-leibler"),
    "beta-1.5": dict(objective="beta-divergence", beta=1.5),
    "weighted": dict(alpha_confidence=4.0),
    "als": dict(algorithm="als"),
    "acls": dict(algorithm="acls", lambda_w=0.1, lambda_h=0.1),
    "ahcls": dict(algorithm="ahcls", lambda_w=0.1, lambda_h=0.1),
    "gdcls": dict(algorithm="gdcls", lambda_tik=0.05),
    "nsnmf-frobenius": dict(algorithm="nsnmf", theta=0.3),
    "nsnmf-kl": dict(algorithm="nsnmf", theta=0.3,
                     objective="kullback-leibler"),
    "hals": dict(algorithm="hals"),
    "ials": dict(algorithm="als", alpha_confidence=4.0, lambda_w=0.1,
                 lambda_h=0.1),
    "jacobi": dict(mu_style="jacobi"),
    "jacobi-kl": dict(mu_style="jacobi", objective="kullback-leibler"),
    "pallas": dict(use_pallas=True),
}
BF16 = {
    "bf16": dict(v_storage="bfloat16"),
    "bf16-kl": dict(v_storage="bfloat16", objective="kullback-leibler"),
    "bf16-als": dict(v_storage="bfloat16", algorithm="als"),
    "bf16-weighted": dict(v_storage="bfloat16", alpha_confidence=4.0),
    "bf16-beta": dict(v_storage="bfloat16", objective="beta-divergence",
                      beta=1.5),
}
INT8_LOOP = {
    "int8": dict(v_storage="int8"),
    "int8-jacobi": dict(v_storage="int8", mu_style="jacobi",
                        use_pallas=True),
    "int8-als": dict(v_storage="int8", algorithm="als"),
}
INT8_MESH = {
    "int8-pallas": dict(v_storage="int8", use_pallas=True),
    "int8-kl": dict(v_storage="int8", objective="kullback-leibler"),
}
# held against a float64 oracle on the dequantized V (nmftpu's CPU route
# for it dequantizes to bf16)
ORACLE = ("int8-pallas",)
ALL = {**{k: {**TWO, **v} for k, v in {**FLOAT, **BF16,
                                       **INT8_MESH}.items()},
       **{k: {**ONE, **v} for k, v in INT8_LOOP.items()}}
# the meshes whose axis of size 1 makes a half-step local: the whole
# kernels #1-#4 run there, #5 takes the other half
SUBSET = ("mu-frobenius", "mu-kl", "als", "hals", "pallas", "int8",
          "int8-pallas", "bf16")
SHAPES = ((2, 2), (1, 4), (4, 1))
INITS = ("all_random_values", "mean_columns", "kmeans_random",
         "kmeans_nonnegative_wtv", "kmeans_absolute_wtv", "nndsvd",
         "nndsvda", "nndsvdar")
INIT_KNOBS = dict(rank=RANK, num_iterations=0, dtype="float64", seed=3,
                  kmeans_max_iter=5)
# deterministic given the seed columns, so comparable with nmftpu's
J_INITS = ("kmeans_nonnegative_wtv", "kmeans_absolute_wtv", "nndsvd",
           "nndsvda")


def _data():
    rng = np.random.default_rng(0)
    V = rng.uniform(0.2, 2.0, (N, M_)) * (rng.uniform(size=(N, M_)) < 0.7)
    # the tiles' maxima differ, so a per-tile int8 scale would differ
    V[:5, :5] *= 3.0
    W0 = rng.uniform(0.1, 1.0, (N, RANK))
    H0 = rng.uniform(0.1, 1.0, (RANK, M_))
    return {"V": V.astype(np.float32), "W0": W0.astype(np.float32),
            "H0": H0.astype(np.float32)}


@pytest.fixture(scope="module")
def ranks():
    data = _data()
    runs = [((2, 2), list(ALL.items())),
            ((1, 4), [(n, ALL[n]) for n in SUBSET]),
            ((4, 1), [(n, ALL[n]) for n in SUBSET])]
    inits = [(s, [(i, {**INIT_KNOBS, "init_method": i}) for i in INITS])
             for s in SHAPES]
    return {"data": data, "out": launch(M.dense, 4,
                                        args=(runs, data, inits),
                                        timeout=TIMEOUT, threads=1)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _j_config(knobs):
    kw = dict(knobs)
    for key, enum in (("algorithm", Algorithm), ("objective", Objective)):
        if key in kw:
            kw[key] = enum(kw[key])
    return NmfConfig(init_method=Initialization.COPY_EXISTING, **kw)


def _j_mesh(knobs, data, shape):
    mesh = make_grid_mesh(shape, devices=jax.devices()[:4])
    return j_driver.compute(data["V"], _j_config(knobs), W0=data["W0"],
                            H0=data["H0"], mesh=mesh)


def test_ranks_import_neither_jax_nor_nmftpu(ranks):
    for r in ranks["out"]:
        assert r["_imported"] == {"jax": False, "nmftpu": False}


CASES = [(s, n) for s in SHAPES for n in (ALL if s == (2, 2) else SUBSET)]


@pytest.mark.parametrize("shape,name", CASES)
def test_mesh_equals_one_device(ranks, shape, name):
    """Every rank gets the full factors, equal to the one-device run's."""
    out = ranks["out"]
    one = out[0]["one"][name]
    got = out[0][shape][name]
    bf16 = name.startswith("bf16")
    tol = 2e-2 if bf16 else 1e-5
    assert got["W"].shape == (N, RANK) and got["H"].shape == (RANK, M_)
    assert _rel(got["W"], one["W"]) <= tol
    assert _rel(got["H"], one["H"]) <= tol
    assert got["error"] == pytest.approx(one["error"],
                                         rel=1e-4 if bf16 else 1e-5)
    for r in out[1:]:
        np.testing.assert_array_equal(r[shape][name]["W"], got["W"])
        np.testing.assert_array_equal(r[shape][name]["H"], got["H"])


MESH_CASES = [(s, n) for s, n in CASES
              if n not in INT8_LOOP and n not in ORACLE]


@pytest.mark.parametrize("shape,name", MESH_CASES)
def test_mesh_matches_nmftpu_mesh(ranks, shape, name):
    want = _j_mesh(ALL[name], ranks["data"], shape)
    got = ranks["out"][0][shape][name]
    bf16 = name.startswith("bf16")
    err_tol, tol = (1e-3, 2e-2) if bf16 else (1e-4, 1e-3)
    assert got["num_iterations"] == want.num_iterations
    assert got["error"] == pytest.approx(float(want.error), rel=err_tol)
    if want.kl_error is not None:
        assert got["kl_error"] == pytest.approx(float(want.kl_error),
                                                rel=err_tol)
    np.testing.assert_allclose(got["errors"], np.asarray(want.stats.errors),
                               rtol=err_tol)
    assert _rel(got["W"], want.W) <= tol
    assert _rel(got["H"], want.H) <= tol


def _j_int8_step(name, data):
    """One iteration of nmftpu's int8 x int8 update on the unpadded V."""
    Vq, scale = JQ.quantize_v(jnp.asarray(data["V"]))
    W, H = jnp.asarray(data["W0"]), jnp.asarray(data["H0"])
    if name == "int8":
        return JD.mu_update_frobenius_int8x8(Vq, scale, W, H)
    if name == "int8-jacobi":
        return JD.mu_update_frobenius_int8x8(Vq, scale, W, H,
                                             order="jacobi")
    return JD.als_family_update_int8x8(Vq, scale, W, H)


@pytest.mark.parametrize("shape,name", [(s, n) for s, n in CASES
                                        if n in INT8_LOOP])
def test_int8_mesh_matches_nmftpu_int8x8(ranks, shape, name):
    Wj, Hj = _j_int8_step(name, ranks["data"])
    got = ranks["out"][0][shape][name]
    assert _rel(got["W"], Wj) <= 1e-5
    assert _rel(got["H"], Hj) <= 1e-5


def test_int8_tiles_take_the_whole_matrix_scale(ranks):
    """The mesh's int8 tiles hold the whole V's integers under the whole
    V's scale; a tile's own scale would give other integers (a different
    result), which this data makes sure of."""
    for r in ranks["out"]:
        s = r["scale"]
        assert s["mesh_scale"] == s["whole_scale"]
        assert s["mesh_q_equal"]
        if s["coords"] != (0, 0):
            assert s["own_scale"] != s["whole_scale"]
            assert not s["own_q_equal"]


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_fused_kernels_match_the_dequantized_oracle(ranks, shape):
    """use_pallas int8: #4 (#3) where the W (H) half is local, #5 after
    the summed float numerator elsewhere; both are MU on scale · Vq."""
    data = ranks["data"]
    Vq, scale = JQ.quantize_v(jnp.asarray(data["V"]))
    V = np.asarray(Vq, np.float64) * float(scale)
    W, H = data["W0"].astype(np.float64), data["H0"].astype(np.float64)
    for _ in range(2):
        W = W * (V @ H.T) / (W @ (H @ H.T) + 1e-9)
        H = H * (W.T @ V) / ((W.T @ W) @ H + 1e-9)
    got = ranks["out"][0][shape]["int8-pallas"]
    assert _rel(got["W"], W) <= 1e-5
    assert _rel(got["H"], H) <= 1e-5


def _padded(V, shape):
    """V zero padded to a multiple of the mesh, as nmftpu pads it."""
    (n, m), (pu, pi) = V.shape, shape
    return np.pad(V, ((0, -n % pu), (0, -m % pi)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("init", INITS)
def test_mesh_inits_are_the_one_device_inits(ranks, shape, init):
    """Random values are the one-device draws on V; every data-dependent
    init is `initialize_factors` of the zero-padded V, draw for draw."""
    import torch

    from nmftpu_torch import Initialization as TI
    from nmftpu_torch.init import initialize_factors, run_generator

    V = ranks["data"]["V"].astype(np.float64)
    src = V if init == "all_random_values" else _padded(V, shape)
    W, H = initialize_factors(torch.as_tensor(src), RANK, TI(init),
                              run_generator(INIT_KNOBS["seed"], 0, "cpu"),
                              kmeans_max_iter=INIT_KNOBS["kmeans_max_iter"])
    for r in ranks["out"]:
        got = r["init"][shape][init]
        assert _rel(got["W"], W[:N].numpy()) <= 1e-12
        assert _rel(got["H"], H[:, :M_].numpy()) <= 1e-12


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("init", J_INITS)
def test_mesh_inits_match_nmftpu_mesh(ranks, shape, init, monkeypatch):
    """nmftpu's mesh run inits on its padded V; k-means takes the port's
    seed columns (drawn over the padded columns)."""
    import torch

    from nmftpu_torch.init import run_generator

    V = ranks["data"]["V"]
    m_pad = _padded(V, shape).shape[1]
    seeds = torch.randperm(m_pad, generator=run_generator(
        INIT_KNOBS["seed"], 0, "cpu"))[:RANK].numpy()
    monkeypatch.setattr(jax.random, "choice",
                        lambda key, a, shape, replace: jnp.asarray(seeds))
    want = j_driver.compute(V, NmfConfig(**dict(
        INIT_KNOBS, init_method=Initialization(init))),
        mesh=make_grid_mesh(shape, devices=jax.devices()[:4]))
    for r in ranks["out"]:
        got = r["init"][shape][init]
        assert _rel(got["W"], want.W) <= 1e-10
        assert _rel(got["H"], want.H) <= 1e-10
