"""Training traffic under implicit-feedback ALS (iALS; Hu, Koren and
Volinsky): c = 1 + alpha·v at the clicks and 1 elsewhere, each half-step
solving every row's weighted normal equations with the configuration's
ridge (`alpha`, `lambda_w`, `lambda_h`), on the program's ELL engine with
the traffic's `als_solver`. `train_fits`'s set-up, window, answers,
comparison and faults, with this rule's program configuration, work
count and reference call."""

from __future__ import annotations

import dataclasses

from benchmark.kinds.train_fits import TrainFits


def ials_work(n: int, m: int, r: int, nnz: int) -> tuple[float, float]:
    """(operations, bytes) of one iALS iteration, both half-steps.

    Operations: each nonzero's Gram delta α·v·t tᵀ and its right-hand
    side term c·v·t in each half, 4·nnz·r² + 4·nnz·r; the two base Grams
    HHᵀ and WᵀW, 2·(n + m)·r²; each row's Cholesky and its two triangular
    solves, (n + m)·(r³/3 + 2·r²). An explicit inverse is not counted:
    the algorithm does not need one.
    Bytes: each half reads every nonzero's value and column (8 bytes) and
    the other side's factor, and writes its own factor, in float32; the
    per-row Grams are an intermediate and not counted."""
    flops = (4.0 * nnz * r * r + 4.0 * nnz * r + 2.0 * (n + m) * r * r
             + (n + m) * (r ** 3 / 3.0 + 2.0 * r * r))
    nbytes = 2 * nnz * 8.0 + 2 * (n + m) * r * 4.0
    return flops, nbytes


class TrainIals(TrainFits):
    def program_config(self, cfg, traffic):
        return dataclasses.replace(
            super().program_config(cfg, traffic), algorithm="als",
            alpha_confidence=cfg["alpha"], lambda_w=cfg["lambda_w"],
            lambda_h=cfg["lambda_h"], als_solver=traffic["als_solver"])

    def flops_per_iteration(self, cfg, traffic, n, m, r, nnz) -> float:
        """`ials_work`'s operations: 4·nnz·r² + 4·nnz·r + 2·(n + m)·r²
        + (n + m)·(r³/3 + 2·r²)."""
        return ials_work(n, m, r, nnz)[0]

    def layer_record(self, state, rec) -> dict:
        """`TrainFits`'s record, and `ials_work`'s operations and bytes of
        one iteration (for `ials_roofline`)."""
        out = super().layer_record(state, rec)
        out["ials_work"] = ials_work(out["n"], out["m"], out["r"],
                                     out["nnz"])
        return out

    def reference_fit(self, state, ref, precision="float64"):
        ctx, coo = state["ctx"], state["coo"]
        cfg = ctx.config
        return ref.fit(coo["rows"], coo["cols"], coo["vals"], coo["n"],
                       coo["m"], state["W0"], state["H0"], cfg["alpha"],
                       cfg["lambda_w"], cfg["lambda_h"],
                       ctx.traffic["iterations"], cfg["eps"],
                       precision=precision)


KIND = TrainIals()
