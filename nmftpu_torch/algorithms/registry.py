"""Dispatch an NmfConfig to concrete update-step callables (port of the
MU (Frobenius, KL) and HALS branches of ``nmftpu/algorithms/registry.py``).

`build_dense_update(config)` returns a triple:

  make_aux(V)            -> tuple of per-problem constants computed once
                            outside the iteration loop (the int8 or bf16
                            copy of V, or ());
  update(V, aux, W, H)   -> (W, H) one full iteration, as new tensors;
  effective_h(aux, H)    -> the H used in error metrics (H itself here).

Routes, in ``nmftpu``'s order of precedence (`order` is "jacobi" under
mu_style="jacobi", else update_order):

  HALS                                 -> linalg.dense.hals_update
                                          (CUDA sweep kernel on the card)
  Frobenius, v_storage="int8":
    use_pallas and not jacobi          -> kernels.quantized (CUDA kernels)
    otherwise                          -> linalg.dense.
                                          mu_update_frobenius_int8x8
                                          (int8 CUDA kernels; jacobi with
                                          use_pallas: the dual kernel)
  Frobenius, v_storage="bfloat16"      -> linalg.dense.
                                          mu_update_frobenius_bf16v
  Frobenius, use_pallas=True           -> kernels.dense_mu (CUDA kernels)
  Frobenius                            -> linalg.dense.mu_update_frobenius
  KL, v_storage="bfloat16"             -> densified.mu_update_kl_densified
  KL                                   -> linalg.dense.mu_update_kl

On the CPU, ``nmftpu`` runs int8 V as a bf16-dequantized contraction;
the port takes the int8 x int8 route on every device. Every other
configuration raises NotImplementedError naming the part of the port
(ROADMAP.md, queue 1) that brings it.
"""

from __future__ import annotations

import torch

from nmftpu_torch.config import Algorithm, NmfConfig, Objective
from nmftpu_torch.linalg import dense as D


def _unported(what: str, where: str):
    raise NotImplementedError(
        f"{what} is not ported to nmftpu_torch yet ({where} in "
        "ROADMAP.md); run it with nmftpu"
    )


def _jacobi_order(config: NmfConfig) -> str:
    """The coupling the MU builders take. mu_style="jacobi" replaces the
    update order; ``nmftpu`` lets it override an explicit
    update_order="HW" silently, the port refuses that pair ("WH" is the
    default, so it cannot tell an explicit "WH" from none)."""
    if config.mu_style != "jacobi":
        return config.update_order
    if config.update_order != "WH":
        raise ValueError(
            "mu_style='jacobi' updates W and H simultaneously, so "
            f"update_order={config.update_order!r} has no meaning with it; "
            "drop update_order or use mu_style='gauss-seidel'"
        )
    return "jacobi"


def build_dense_update(config: NmfConfig):
    eps = config.eps

    def effective_h(aux, H):
        return H

    if config.algorithm is Algorithm.HALS:
        # config validation keeps HALS to float32-stored V, Frobenius
        lw, lh = config.lambda_w, config.lambda_h
        l1w, l1h = config.l1_w, config.l1_h
        hals_order = config.update_order

        def update(V, aux, W, H):
            return D.hals_update(V, W, H, eps=eps, order=hals_order,
                                 l2_w=lw, l2_h=lh, l1_w=l1w, l1_h=l1h)

        return (lambda V: ()), update, effective_h
    if config.algorithm is not Algorithm.MU:
        _unported(f"algorithm={config.algorithm.value!r}", "slice 4b")
    if config.objective is Objective.BETA:
        _unported("objective='beta-divergence'", "slice 4b")
    if config.alpha_confidence > 0.0:
        _unported("confidence weighting (alpha_confidence > 0)", "slice 3")
    order = _jacobi_order(config)
    kl = config.objective is Objective.KL

    if kl and config.v_storage == "int8":
        _unported("objective='kl' with v_storage='int8' (the quantized "
                  "densified KL)", "slice 3 item 9, densify_quantized")

    if config.v_storage == "int8":
        from nmftpu_torch.kernels import quantized as Q

        def make_aux(V):
            return Q.quantize_v(V)

        if config.use_pallas and order != "jacobi":
            def update(V, aux, W, H):
                return Q.mu_update_frobenius_q(aux[0], aux[1], W, H,
                                               eps=eps, order=order)
        else:
            # use_pallas + jacobi opts into the dual-numerator kernel
            fused = bool(config.use_pallas)

            def update(V, aux, W, H):
                return D.mu_update_frobenius_int8x8(
                    aux[0], aux[1], W, H, eps=eps, order=order,
                    use_fused=fused)

    elif config.v_storage == "bfloat16":

        def make_aux(V):
            return (V.to(torch.bfloat16),)

        if kl:
            from nmftpu_torch import densified as DF

            def update(V, aux, W, H):
                return DF.mu_update_kl_densified(aux[0], W, H, eps=eps,
                                                 order=order)
        else:
            def update(V, aux, W, H):
                return D.mu_update_frobenius_bf16v(aux[0], W, H, eps=eps,
                                                   order=order)

    elif kl:

        def make_aux(V):
            return ()

        def update(V, aux, W, H):
            return D.mu_update_kl(V, W, H, eps=eps, order=order)

    elif config.use_pallas:
        from nmftpu_torch.kernels import dense_mu as K

        def make_aux(V):
            return ()

        def update(V, aux, W, H):
            return K.mu_update_frobenius_fused(V, W, H, eps=eps, order=order)

    else:

        def make_aux(V):
            return ()

        def update(V, aux, W, H):
            return D.mu_update_frobenius(V, W, H, eps=eps, order=order)

    return make_aux, update, effective_h
