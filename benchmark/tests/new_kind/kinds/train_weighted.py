"""Training traffic under confidence-weighted MU: c = 1 + alpha·v at the
ratings and 1 elsewhere (Hu, Koren and Volinsky's confidence, with
`alpha_confidence` from the traffic), on the program's ELL engine.
`train_fits`'s set-up, window, answers and comparison, with this rule's
program configuration, operation count and reference call."""

from __future__ import annotations

import dataclasses

from benchmark.kinds.train_fits import TrainFits


class TrainWeighted(TrainFits):
    def program_config(self, cfg, traffic):
        return dataclasses.replace(
            super().program_config(cfg, traffic),
            alpha_confidence=traffic["alpha_confidence"])

    def flops_per_iteration(self, cfg, traffic, n, m, r, nnz) -> float:
        """Per half-step: the sampled product at every rating, 2·nnz·r;
        the two sums over the ratings, (C⊙V)·Hᵀ and (V⊙WH)·Hᵀ, 4·nnz·r;
        one Gram and its product with the other factor, 2·(n + m)·r²:
        12·nnz·r + 4·(n + m)·r² an iteration."""
        return 12.0 * nnz * r + 4.0 * (n + m) * r * r

    def reference_fit(self, state, ref, precision="float64"):
        ctx, coo = state["ctx"], state["coo"]
        return ref.fit(coo["rows"], coo["cols"], coo["vals"], coo["n"],
                       coo["m"], state["W0"], state["H0"],
                       ctx.traffic["alpha_confidence"],
                       ctx.traffic["iterations"], ctx.config["eps"],
                       precision=precision)


KIND = TrainWeighted()
