"""Dispatch an NmfConfig to concrete update-step callables (port of the
MU-Frobenius branches of ``nmftpu/algorithms/registry.py``).

`build_dense_update(config)` returns a triple:

  make_aux(V)            -> tuple of per-problem constants computed once
                            outside the iteration loop (the int8 or bf16
                            copy of V, or ());
  update(V, aux, W, H)   -> (W, H) one full iteration, as new tensors;
  effective_h(aux, H)    -> the H used in error metrics (H itself here).

Routes, in ``nmftpu``'s order of precedence:

  v_storage="int8", use_pallas=True -> kernels.quantized (CUDA kernels)
  v_storage="bfloat16"              -> linalg.dense.mu_update_frobenius_bf16v
  use_pallas=True                   -> kernels.dense_mu (CUDA kernels)
  otherwise                         -> linalg.dense.mu_update_frobenius

Every other configuration raises NotImplementedError naming the part of
the port (ROADMAP.md, queue 1) that brings it.
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


def build_dense_update(config: NmfConfig):
    eps = config.eps
    order = config.update_order

    if config.algorithm is not Algorithm.MU:
        _unported(f"algorithm={config.algorithm.value!r}", "slice 4")
    if config.mu_style == "jacobi":
        _unported("mu_style='jacobi'", "slice 4, queue 2 dual_numer")
    if config.objective is not Objective.FROBENIUS:
        _unported(f"objective={config.objective.value!r}",
                  "slice 1 item 2 (KL), slice 4 (beta)")
    if config.alpha_confidence > 0.0:
        _unported("confidence weighting (alpha_confidence > 0)", "slice 3")

    if config.v_storage == "int8" and not config.use_pallas:
        # nmftpu runs int8 x int8 contractions here; on Hopper that is
        # an int8 tensor-core kernel still to be written
        _unported("v_storage='int8' without use_pallas",
                  "slice 1 item 4, the int8 tensor-core kernel")

    if config.v_storage == "int8":
        from nmftpu_torch.kernels import quantized as Q

        def make_aux(V):
            return Q.quantize_v(V)

        def update(V, aux, W, H):
            return Q.mu_update_frobenius_q(aux[0], aux[1], W, H, eps=eps,
                                           order=order)

    elif config.v_storage == "bfloat16":

        def make_aux(V):
            return (V.to(torch.bfloat16),)

        def update(V, aux, W, H):
            return D.mu_update_frobenius_bf16v(aux[0], W, H, eps=eps,
                                               order=order)

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

    def effective_h(aux, H):
        return H

    return make_aux, update, effective_h
