"""int8 GDCLS and ALS at all of ML-20M's 138,493 rows: nmftpu and the port
side by side, with float32 beside them.

The int8 ALS family quantizes the whole of W with one scale
(`quantize_sym`), so a W whose entries spread over more than 254 steps of
that scale keeps few of them in its int8 copy. `chip_smoke.py` phase 21
(b) runs int8 GDCLS and ALS at ML-20M's shape on the card (138,493 ×
26,744, r = 64), where nmftpu cannot run. This file runs
``nmftpu.linalg.dense``'s `gdcls_update_int8x8` (λ_tik = 0.1) and
`als_family_update_int8x8` and the port's from the same W0, H0 and
quantized ratings for 10 iterations on the CPU: all 138,493 rows, m cut
from 26,744 to 8192 so that V fits in host memory, the 20,000,263
ratings of phase 21 (b) drawn by the phase's own generator
(`synthetic_ratings`, on the CPU), r = 64, W0 and H0 uniform + 0.01. The
port's float32 GDCLS or ALS on the dequantized ratings runs beside them.

Held: each iteration's Frobenius error, port against nmftpu, within 1e-3
relative, the int8 tolerance after ten iterations of
`tests/test_torch_als_family.py` (the two requantize the same factors;
float32 sums in another order move a few entries across a rounding edge,
ROADMAP hazard "Requantization flips", and the clamped solves carry the
flip on); the share of W's entries at 0 in its int8 copy after each
iteration within 0.01. Then what the card shows at the full shape: int8
GDCLS rises at the same iterations after falling and ends above
float32's error by more than 1e-3, in both packages; int8 ALS ends below
float32's by more than 1e-3, in both. The trajectories print with
``-s``.

Marked slow: about 8 GB of host memory and three to four minutes a case.
Run it with

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_int8_scale_witness.py -m slow -s
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

N, M, NNZ, RANK = 138_493, 8192, 20_000_263, 64
LAMBDA_TIK = 0.1
ITERS = 10
ERROR_RTOL = 1e-3
ZEROS_ATOL = 0.01
FROM_FLOAT32 = 1e-3


def _error(Vq, scale, W, H, rows=4096) -> float:
    """||scale·Vq - W H||_F over row panels (float32 panels, float64 sum)."""
    total = 0.0
    for i in range(0, Vq.shape[0], rows):
        R = Vq[i:i + rows].float() * scale - W[i:i + rows] @ H
        total += float(torch.sum(R.double() ** 2))
    return total ** 0.5


def _zeros(W) -> float:
    from nmftpu_torch.linalg import dense as TD

    return float((TD.quantize_sym(W)[1] == 0).float().mean())


@pytest.mark.slow
@pytest.mark.parametrize("alg", ["gdcls", "als"])
def test_int8_one_w_scale_at_ml20m_rows(alg):
    import jax
    import jax.numpy as jnp

    from nmftpu.linalg import dense as JD
    from nmftpu_torch.kernels import quantized as Q
    from nmftpu_torch.linalg import dense as TD

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    torch.set_num_threads(4)
    V = chip_smoke.synthetic_ratings(
        N, M, NNZ, torch.Generator().manual_seed(chip_smoke.SEED + 5), "cpu")
    Vq, scale = Q.quantize_v(V)
    # V becomes the dequantized ratings in place: float32's operand
    V.copy_(Vq)
    V.mul_(scale)
    gen = torch.Generator().manual_seed(chip_smoke.SEED + 21)
    W0 = torch.rand(N, RANK, generator=gen) + 0.01
    H0 = torch.rand(RANK, M, generator=gen) + 0.01

    if alg == "gdcls":
        j_step = jax.jit(lambda Vq, s, W, H: JD.gdcls_update_int8x8(
            Vq, s, W, H, lambda_tik=LAMBDA_TIK))

        def t_step(Vq, s, W, H):
            return TD.gdcls_update_int8x8(Vq, s, W, H, lambda_tik=LAMBDA_TIK)

        def f_step(V, W, H):
            return TD.gdcls_update(V, W, H, lambda_tik=LAMBDA_TIK)
    else:
        j_step = jax.jit(JD.als_family_update_int8x8)
        t_step, f_step = TD.als_family_update_int8x8, TD.als_update
    Vq_j, s_j = jnp.asarray(Vq.numpy()), jnp.asarray(scale.numpy())
    Wj, Hj = jnp.asarray(W0.numpy()), jnp.asarray(H0.numpy())
    Wt, Ht, Wf, Hf = W0, H0, W0, H0
    runs = {f"nmftpu {alg} int8": [], f"port {alg} int8": [],
            f"port {alg} float32": []}
    zeros = {f"nmftpu {alg} int8": [], f"port {alg} int8": []}
    for _ in range(ITERS):
        Wj, Hj = j_step(Vq_j, s_j, Wj, Hj)
        Wt, Ht = t_step(Vq, scale, Wt, Ht)
        Wf, Hf = f_step(V, Wf, Hf)
        Wjt, Hjt = (torch.from_numpy(np.array(x)) for x in (Wj, Hj))
        for errs, (W, H) in zip(runs.values(),
                                ((Wjt, Hjt), (Wt, Ht), (Wf, Hf))):
            errs.append(_error(Vq, scale, W, H))
        for z, W in zip(zeros.values(), (Wjt, Wt)):
            z.append(_zeros(W))
    for name, errs in runs.items():
        print(f"\n{name} errors 1..{ITERS}: "
              + " ".join(f"{e:.7g}" for e in errs))
    for name, z in zeros.items():
        print(f"{name} W int8 entries at 0, 1..{ITERS}: "
              + " ".join(f"{x:.4f}" for x in z))

    ref, port, f32 = (np.array(e) for e in runs.values())
    np.testing.assert_allclose(port, ref, rtol=ERROR_RTOL)
    z_ref, z_port = zeros.values()
    np.testing.assert_allclose(z_port, z_ref, rtol=0, atol=ZEROS_ATOL)
    if alg == "als":
        for errs in (ref, port):
            assert 1 - errs[-1] / f32[-1] > FROM_FLOAT32, (errs, f32)
        return
    for errs in (ref, port):
        rises = np.flatnonzero(np.diff(errs) > 0) + 1
        assert rises.size and rises[0] >= 2, errs
        assert errs[-1] / f32[-1] - 1 > FROM_FLOAT32, (errs, f32)
    np.testing.assert_array_equal(
        np.flatnonzero(np.diff(ref) > 0), np.flatnonzero(np.diff(port) > 0))
