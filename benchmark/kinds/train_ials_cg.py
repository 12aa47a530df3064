"""Training traffic under iALS by conjugate gradients (Takács, Pilászy
and Tikk, RecSys 2011): `train_ials`'s fits with `als_solver="cg"` and
the traffic's `cg_steps` warm-started Jacobi-preconditioned steps a
half-step, which the program's ELL engine runs without forming a row's
system. `train_fits`'s set-up, window and faults, with this solver's
work count (`ials_cg_work`), the launches of #11's CG rule, and the
reference `reference/train_ials_cg.py`.

The check. Fifteen outer iterations of 3-step CG, clamped, amplify
float32 rounding (about 1e-6 a half-step from a warm start) to the same
~1e-2 that TF32 rounding reaches: a window fit's gaps to the float64
reference (`w_gap`, `h_gap`, `err_gap`) cannot tell the two precisions
apart. So once the window has closed, off its clock, the plan runs one
more fit of the first iteration alone from the same (W0, H0), and the
comparison adds that fit's gaps to the reference's first iteration
(`w_gap_first`, `h_gap_first`, `err_gap_first`), where a precision
step still shows."""

from __future__ import annotations

import dataclasses

from benchmark.kinds.train_fits import TrainFits
from benchmark.kinds.train_ials import TrainIals

# the iterations of the fit that the check adds after the window
FIRST = 1


def ials_cg_work(n: int, m: int, r: int, nnz: int,
                 steps: int) -> tuple[float, float]:
    """(operations, bytes) of one iteration of iALS by `steps` CG steps a
    half-step, both halves, with no per-row system formed.

    Operations, per half with `rows` own rows and `other` table rows:
    steps + 1 products of the rows' systems with a vector each (the warm
    start's residual, then one a step), each the sparse term
    Σ αv (t·p) t, 4·nnz·r (the sample and the sum), and the base Gram's
    product G·p, 2·rows·r²; the base Gram tableᵀ·table, 2·other·r²; the
    right-hand sides Σ c·v·t and the diagonals Σ αv·t², 4·nnz·r:
    (s + 1)·(4·nnz·r + 2·rows·r²) + 2·other·r² + 4·nnz·r. The steps'
    vector updates, O(rows·r), are not counted.
    Bytes: each of the s + 3 sparse passes a half reads every nonzero's
    value and column (8 bytes), the other side's factor and its own
    vectors, in float32."""
    flops = nbytes = 0.0
    for rows, other in ((n, m), (m, n)):
        flops += ((steps + 1) * (4.0 * nnz * r + 2.0 * rows * r * r)
                  + 2.0 * other * r * r + 4.0 * nnz * r)
        nbytes += (steps + 3) * (8.0 * nnz + (rows + other) * r * 4.0)
    return flops, nbytes


class TrainIalsCg(TrainIals):
    def program_config(self, cfg, traffic):
        return dataclasses.replace(super().program_config(cfg, traffic),
                                   cg_steps=traffic["cg_steps"])

    def flops_per_iteration(self, cfg, traffic, n, m, r, nnz) -> float:
        """`ials_cg_work`'s operations: per half (s + 1)·(4·nnz·r +
        2·rows·r²) + 2·other·r² + 4·nnz·r, s = `cg_steps`."""
        return ials_cg_work(n, m, r, nnz, traffic["cg_steps"])[0]

    def launches(self) -> dict:
        """`train_fits`'s counts and #11's CG rule's (0 where the program
        has no such rule)."""
        from nmftpu_torch.kernels import sparse_ell_kernel as SEK

        return dict(super().launches(),
                    ell_cg=SEK.LAUNCHES.get("ell_cg", 0))

    def window(self, state, seconds, sl):
        """`TrainFits`'s window, then, off its clock and out of its traced
        slice, one fit of the first `FIRST` iterations on the same plan
        from the same (W0, H0), kept under "first"."""
        rec = super().window(state, seconds, sl)
        cfg = dataclasses.replace(state["pcfg"], num_iterations=FIRST,
                                  check_interval=FIRST)
        try:
            rec["first"] = state["plan"].run(cfg, W0=state["W0"],
                                             H0=state["H0"])
        except RuntimeError as e:
            state["ctx"].log(f"first-iteration fit failed: {e}")
            rec["first"] = None
        return rec

    def layer_record(self, state, rec) -> dict:
        """`TrainFits`'s record (the exact route's work count does not
        apply)."""
        return TrainFits.layer_record(self, state, rec)

    def reference_fit(self, state, ref, precision="float64",
                      iterations=None):
        ctx, coo = state["ctx"], state["coo"]
        cfg = ctx.config
        return ref.fit(coo["rows"], coo["cols"], coo["vals"], coo["n"],
                       coo["m"], state["W0"], state["H0"], cfg["alpha"],
                       cfg["lambda_w"], cfg["lambda_h"],
                       iterations or ctx.traffic["iterations"], cfg["eps"],
                       ctx.traffic["cg_steps"], precision=precision)

    def answers(self, state, rec):
        """The window's kept fits, as `TrainFits` gives them, and the
        first-iteration fit's (W, H, error)."""
        first = rec.get("first")
        return {"fits": super().answers(state, rec),
                "first": None if first is None else
                (first.W, first.H, first.frobenius_error)}

    def control(self, state, rec, ref):
        """The reference in the control precision in the program's place,
        for the window's fits and for the first-iteration fit."""
        prec = state["ctx"].control
        return {"fits": [self.reference_fit(state, ref, precision=prec)],
                "first": self.reference_fit(state, ref, precision=prec,
                                            iterations=FIRST)}

    def compare(self, state, answers_, ref) -> dict:
        """`TrainFits`'s three numbers over the window's fits, and the same
        three over the first-iteration fit against the reference's first
        iteration, suffixed `_first`."""
        out = super().compare(state, answers_["fits"], ref)
        if "reference_first" not in state:
            state["reference_first"] = self.reference_fit(
                state, ref, iterations=FIRST)
        first = super().compare(
            dict(state, reference=state["reference_first"]),
            [] if answers_["first"] is None else [answers_["first"]], ref)
        out.update((k + "_first", v) for k, v in first.items())
        return out


KIND = TrainIalsCg()
