"""Dispatch an NmfConfig to concrete update-step callables (port of
``nmftpu/algorithms/registry.py``).

`build_dense_update(config, sums)` returns a triple:

  make_aux(V)            -> tuple of per-problem constants computed once
                            outside the iteration loop (the int8 or bf16
                            copy of V, the nsNMF smoothing matrix S, the
                            confidence C = 1 + alpha·V, or ());
  update(V, aux, W, H)   -> (W, H) one full iteration, as new tensors;
  effective_h(aux, H)    -> the H used in error metrics: S @ H for nsNMF,
                            H itself otherwise.

Routes, in ``nmftpu``'s order of precedence (`order` is "jacobi" under
mu_style="jacobi", else update_order):

  not MU, Frobenius, v_storage="int8"  -> linalg.dense:
    ALS, ACLS, AHCLS                        als_family_update_int8x8
    GDCLS                                   gdcls_update_int8x8
    nsNMF                                   nsnmf_update_frobenius_int8x8
                                          (the right-hand sides on #6's
                                          one-sided int8 CUDA entries)
  not MU, Frobenius, v_storage="bfloat16" -> densified:
    ALS, ACLS, AHCLS                        als_family_update_densified
    GDCLS                                   gdcls_update_densified
    nsNMF                                   nsnmf_update_densified
  MU:
    alpha_confidence > 0, float32 V    -> linalg.dense.
                                          mu_update_frobenius_weighted
    alpha_confidence > 0, bf16/int8 V  -> densified.
                                          mu_update_frobenius_weighted_
                                          densified (int8: with the scale)
    Frobenius, v_storage="int8":
      use_pallas and not jacobi        -> kernels.quantized (CUDA kernels)
      otherwise                        -> linalg.dense.
                                          mu_update_frobenius_int8x8
                                          (int8 CUDA kernels; jacobi with
                                          use_pallas: the dual kernel)
    Frobenius, v_storage="bfloat16"    -> linalg.dense.
                                          mu_update_frobenius_bf16v
    Frobenius, use_pallas=True         -> kernels.dense_mu (CUDA kernels)
    Frobenius                          -> linalg.dense.mu_update_frobenius
    KL, v_storage="int8" or "bfloat16" -> densified.mu_update_kl_densified
                                          (int8: with the scale)
    KL                                 -> linalg.dense.mu_update_kl
    beta divergence, float32 V         -> linalg.dense.mu_update_beta
    beta divergence, bf16/int8 V       -> densified.mu_update_beta_densified
  ALS, alpha_confidence > 0 (iALS)     -> linalg.dense.als_update_weighted
  ALS (float32 V)                      -> linalg.dense.als_update
  HALS                                 -> linalg.dense.hals_update
                                          (CUDA sweep kernel on the card)
  ACLS, AHCLS, GDCLS (float32 V)       -> linalg.dense.acls_update,
                                          ahcls_update, gdcls_update
  nsNMF, KL, bf16 or int8 V            -> densified.nsnmf_update_kl_
                                          densified (int8: with the scale)
  nsNMF, float32 V (Frobenius or KL)   -> linalg.dense.nsnmf_update

The ALS family on int8 and bf16 V takes its shifts from
``sparse_ops._als_family_shifts`` (float64); dense float32 AHCLS takes
``linalg.dense._ahcls_shift`` (in V's dtype), as ``nmftpu`` does.
On the CPU, ``nmftpu`` runs int8 MU as a bf16-dequantized contraction;
the port takes the int8 x int8 route on every device. Dense iALS solves
each row exactly whatever `als_solver` says, as ``nmftpu``'s does.

`sums` (``linalg.dense.Sums``, `LOCAL` by default) goes to every route:
on a mesh that tiles V (``parallel.dense_mesh``) V is this rank's tile,
the contractions are summed over the ranks, int8 V takes the whole
matrix's scale, and the fused kernels run only the half-steps local to
the tile.
"""

from __future__ import annotations

import torch

from nmftpu_torch.config import Algorithm, NmfConfig, Objective
from nmftpu_torch.linalg import dense as D
from nmftpu_torch.linalg.dense import LOCAL


def _quantize_v(sums):
    """V -> (Vq int8, scale): `quantize_v` with the whole matrix's max|V|
    (its tiles' max over the mesh)."""
    from nmftpu_torch.kernels import quantized as Q

    def quantize(V):
        vmax = sums.both(torch.maximum(V.amax(), -V.amin()), maximum=True)
        return Q.quantize_v(V, vmax=vmax)

    return quantize


def _low_precision_v(v_storage: str, sums=LOCAL):
    """make_aux for the densified routes: (Vq int8, scale) from
    `quantize_v` for int8 storage, (V in bf16, None) for bfloat16."""
    if v_storage == "int8":
        return _quantize_v(sums)
    return lambda V: (V.to(torch.bfloat16), None)


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


def _smoothing(config: NmfConfig, V, dtype=torch.float32):
    """nsNMF's S in `dtype`, then in V's (the factors') dtype: the
    low-precision routes build S in float32, as ``nmftpu`` does, and a
    float64 run multiplies it as float64, as XLA promotes it."""
    return D.nsnmf_smoothing_matrix(config.rank, config.theta, dtype=dtype,
                                    device=V.device).to(V.dtype)


def _identity_h(aux, H):
    """The effective H of every algorithm but nsNMF: H itself."""
    return H


def _smoothed_h(aux, H):
    """nsNMF's effective H, S @ H (S last in the aux)."""
    return aux[-1] @ H


def _low_precision_family(config: NmfConfig, sums=LOCAL):
    """The ALS family, GDCLS and nsNMF on int8 V (Frobenius: the
    right-hand sides on #6's one-sided int8 entries) or bf16 V (bf16
    contractions into float32), and nsNMF under KL over row panels of
    either; aux = (V int8 or bf16, scale or None) and, for nsNMF, S."""
    eps, order, alg = config.eps, config.update_order, config.algorithm
    int8 = config.v_storage == "int8"
    make_v = _low_precision_v(config.v_storage, sums)
    from nmftpu_torch import densified as DF

    if alg in (Algorithm.ALS, Algorithm.ACLS, Algorithm.AHCLS):
        from nmftpu_torch.sparse_ops import _als_family_shifts

        shifts = dict(zip(("shift_w", "shift_h", "off_w", "off_h"),
                          _als_family_shifts(config)))
        if int8:
            def update(V, aux, W, H):
                return D.als_family_update_int8x8(
                    aux[0], aux[1], W, H, **shifts, eps=eps, order=order,
                    sums=sums)
        else:
            def update(V, aux, W, H):
                return DF.als_family_update_densified(
                    aux[0], W, H, **shifts, eps=eps, order=order, sums=sums)

        return make_v, update, _identity_h
    if alg is Algorithm.GDCLS:
        lt = config.lambda_tik
        if int8:
            def update(V, aux, W, H):
                return D.gdcls_update_int8x8(aux[0], aux[1], W, H,
                                             lambda_tik=lt, eps=eps,
                                             order=order, sums=sums)
        else:
            def update(V, aux, W, H):
                return DF.gdcls_update_densified(aux[0], W, H, lambda_tik=lt,
                                                 eps=eps, order=order,
                                                 sums=sums)

        return make_v, update, _identity_h
    if alg is not Algorithm.NSNMF:
        raise ValueError(f"unknown algorithm: {alg}")

    def make_aux(V):
        return (*make_v(V), _smoothing(config, V))

    if config.objective is Objective.KL:
        def update(V, aux, W, H):
            return DF.nsnmf_update_kl_densified(aux[0], W, H, aux[2],
                                                eps=eps, order=order,
                                                scale=aux[1], sums=sums)
    elif int8:
        def update(V, aux, W, H):
            return D.nsnmf_update_frobenius_int8x8(aux[0], aux[1], W, H,
                                                   aux[2], eps=eps,
                                                   order=order, sums=sums)
    else:
        def update(V, aux, W, H):
            return DF.nsnmf_update_densified(aux[0], W, H, aux[2], eps=eps,
                                             order=order, sums=sums)

    return make_aux, update, _smoothed_h


def _float32_v_family(config: NmfConfig, sums=LOCAL):
    """ALS, ACLS, AHCLS, GDCLS and nsNMF (Frobenius or KL) on float32
    V."""
    eps, order, alg = config.eps, config.update_order, config.algorithm
    lw, lh = config.lambda_w, config.lambda_h

    if alg is Algorithm.ALS:
        if config.alpha_confidence > 0.0:
            # iALS: every row's weighted normal equations, solved exactly
            # (config validation keeps V float32 here; the dense path
            # solves exactly whatever als_solver says, as nmftpu's)
            alpha = config.alpha_confidence

            def update(V, aux, W, H):
                return D.als_update_weighted(V, W, H, alpha, lambda_w=lw,
                                             lambda_h=lh, eps=eps,
                                             order=order, sums=sums)
        else:
            def update(V, aux, W, H):
                return D.als_update(V, W, H, eps=eps, order=order, sums=sums)
    elif alg is Algorithm.ACLS:
        def update(V, aux, W, H):
            return D.acls_update(V, W, H, lambda_w=lw, lambda_h=lh, eps=eps,
                                 order=order, sums=sums)
    elif alg is Algorithm.AHCLS:
        aw, ah = config.alpha_w, config.alpha_h

        def update(V, aux, W, H):
            return D.ahcls_update(V, W, H, lambda_w=lw, lambda_h=lh,
                                  alpha_w=aw, alpha_h=ah, eps=eps,
                                  order=order, sums=sums)
    elif alg is Algorithm.GDCLS:
        lt = config.lambda_tik

        def update(V, aux, W, H):
            return D.gdcls_update(V, W, H, lambda_tik=lt, eps=eps,
                                  order=order, sums=sums)
    elif alg is Algorithm.NSNMF:
        obj = "frobenius" if config.objective is Objective.FROBENIUS else "kl"

        def make_aux(V):
            return (_smoothing(config, V, V.dtype),)

        def update(V, aux, W, H):
            return D.nsnmf_update(V, W, H, aux[0], eps=eps, objective=obj,
                                  order=order, sums=sums)

        return make_aux, update, _smoothed_h
    else:
        raise ValueError(f"unknown algorithm: {alg}")
    return (lambda V: ()), update, _identity_h


def build_dense_update(config: NmfConfig, sums=LOCAL):
    eps = config.eps

    if (config.algorithm not in (Algorithm.MU, Algorithm.HALS)
            and config.v_storage != "float32"):
        # config validation keeps confidence weighting away from here, and
        # KL to nsNMF
        return _low_precision_family(config, sums)
    if config.algorithm is Algorithm.HALS:
        # config validation keeps HALS to float32-stored V, Frobenius
        lw, lh = config.lambda_w, config.lambda_h
        l1w, l1h = config.l1_w, config.l1_h
        hals_order = config.update_order

        def update(V, aux, W, H):
            return D.hals_update(V, W, H, eps=eps, order=hals_order,
                                 l2_w=lw, l2_h=lh, l1_w=l1w, l1_h=l1h,
                                 sums=sums)

        return (lambda V: ()), update, _identity_h
    if config.algorithm is not Algorithm.MU:
        return _float32_v_family(config, sums)
    order = _jacobi_order(config)
    if config.objective is Objective.BETA:
        # config validation keeps beta to MU, without jacobi or weighting
        beta = config.beta
        if config.v_storage == "float32":
            def update(V, aux, W, H):
                return D.mu_update_beta(V, W, H, beta, eps=eps, order=order,
                                        sums=sums)

            return (lambda V: ()), update, _identity_h
        # bf16 or int8 V: the densified row-panel update; int8's scale
        # folds into the numerators after the contraction
        from nmftpu_torch import densified as DF

        def update(V, aux, W, H):
            return DF.mu_update_beta_densified(aux[0], W, H, beta, eps=eps,
                                               order=order, scale=aux[1],
                                               sums=sums)

        return _low_precision_v(config.v_storage, sums), update, _identity_h
    kl = config.objective is Objective.KL

    if config.alpha_confidence > 0.0 and config.v_storage == "float32":
        # config validation keeps weighting to MU under Frobenius, and
        # away from jacobi
        alpha = config.alpha_confidence

        def make_aux(V):
            return (1.0 + alpha * V,)

        def update(V, aux, W, H):
            return D.mu_update_frobenius_weighted(V, aux[0], W, H, eps=eps,
                                                  order=order, sums=sums)

    elif config.alpha_confidence > 0.0 or (
            kl and config.v_storage != "float32"):
        # bf16 or int8 V, weighted or KL: the densified row-panel updates
        # (C = 1 + alpha V rebuilt per panel, never at n x m)
        from nmftpu_torch import densified as DF

        make_aux = _low_precision_v(config.v_storage, sums)
        alpha = config.alpha_confidence

        if kl:
            def update(V, aux, W, H):
                return DF.mu_update_kl_densified(aux[0], W, H, eps=eps,
                                                 order=order, scale=aux[1],
                                                 sums=sums)
        else:
            def update(V, aux, W, H):
                return DF.mu_update_frobenius_weighted_densified(
                    aux[0], W, H, alpha, eps=eps, order=order,
                    scale=aux[1], sums=sums)

    elif config.v_storage == "int8":
        from nmftpu_torch.kernels import quantized as Q

        make_aux = _quantize_v(sums)

        if config.use_pallas and order != "jacobi":
            def update(V, aux, W, H):
                return Q.mu_update_frobenius_q(aux[0], aux[1], W, H,
                                               eps=eps, order=order,
                                               sums=sums)
        else:
            # use_pallas + jacobi opts into the dual-numerator kernel
            fused = bool(config.use_pallas)

            def update(V, aux, W, H):
                return D.mu_update_frobenius_int8x8(
                    aux[0], aux[1], W, H, eps=eps, order=order,
                    use_fused=fused, sums=sums)

    elif config.v_storage == "bfloat16":

        def make_aux(V):
            return (V.to(torch.bfloat16),)

        def update(V, aux, W, H):
            return D.mu_update_frobenius_bf16v(aux[0], W, H, eps=eps,
                                               order=order, sums=sums)

    elif kl:

        def make_aux(V):
            return ()

        def update(V, aux, W, H):
            return D.mu_update_kl(V, W, H, eps=eps, order=order, sums=sums)

    elif config.use_pallas:
        from nmftpu_torch.kernels import dense_mu as K

        def make_aux(V):
            return ()

        def update(V, aux, W, H):
            return K.mu_update_frobenius_fused(V, W, H, eps=eps, order=order,
                                               sums=sums)

    else:

        def make_aux(V):
            return ()

        def update(V, aux, W, H):
            return D.mu_update_frobenius(V, W, H, eps=eps, order=order,
                                         sums=sums)

    return make_aux, update, _identity_h
