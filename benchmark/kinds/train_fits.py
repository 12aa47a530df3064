"""Training traffic: back-to-back fits on one prepared sparse plan.

Set-up makes the ratings on the device from the seed, builds the
program's host CSR and its plan once (`sparse_ops.prepare_sparse`), draws
the warm start (W0, H0) from the seed, and runs one fit to warm up. The
window then calls `SparsePlan.run` again and again, each fit warm-started
from the same (W0, H0) with `init="copy_existing"`, as a daily refresh of
yesterday's factors would be, and closes at the end of the fit that
crosses `--seconds`.

`iter_ms` is the window's wall time over every MU iteration completed in
it. The check runs the reference from the same (W0, H0) once the
program's plan is freed and holds a sample of the window's fits, drawn
from the seed, against it: W, H (largest difference over the reference's
largest entry) and the fit's error (relative).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import faults, yardstick


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class TrainFits:
    """Back-to-back MU fits on one ELL plan (see the module)."""

    # the faults this kind's cells can have (`faults.py`)
    FAULTS = {"unchanged": faults.unchanged_update,
              "half": faults.half_ratings, "altered": faults.altered_w}

    def program_config(self, cfg, traffic):
        """The program's configuration of one fit."""
        from nmftpu_torch.config import NmfConfig, Objective

        objective = {"kl": Objective.KL,
                     "frobenius": Objective.FROBENIUS}[traffic["objective"]]
        return NmfConfig(
            rank=cfg["rank"], objective=objective,
            init_method="copy_existing",
            num_iterations=traffic["iterations"],
            check_interval=traffic["check_interval"],
            threshold_value=traffic["threshold"], eps=cfg["eps"],
            dtype=cfg["dtype"], use_pallas=traffic["use_pallas"])

    def flops_per_iteration(self, cfg, traffic, n, m, r, nnz) -> float:
        """Operations one iteration of the rule needs."""
        return yardstick.mu_flops_per_iteration(traffic["objective"], n, m,
                                                r, nnz)

    def launches(self) -> dict:
        """The program's counts of its kernels' launches, by kernel."""
        from nmftpu_torch.kernels import sparse_ell_kernel as SEK

        return {k: SEK.LAUNCHES[k] for k in ("ell_rowsums", "ell_kl")}

    def setup(self, ctx):
        from nmftpu_torch import native_loader
        from nmftpu_torch.sparse_ops import prepare_sparse

        cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
        if dev.type == "cuda" and not native_loader.available():
            # the native host ELL build, once into native/build/
            native_loader.build()
        gen = ctx.datagen(cfg["data"]["generator"])
        coo = gen.training(cfg["data"], ctx.seed, dev)
        csr = gen.host_csr(coo)
        pcfg = self.program_config(cfg, traffic)
        plan = prepare_sparse(csr, pcfg, strategy=traffic["strategy"],
                              device=dev)
        del csr
        n, m, r = coo["n"], coo["m"], cfg["rank"]
        mean_v = float(coo["vals"].double().sum()) / (n * m)
        W0, H0 = gen.uniform_factors(n, m, r, ctx.seed, dev,
                                     scale=(mean_v / r) ** 0.5)
        state = {"ctx": ctx, "coo": coo, "plan": plan, "pcfg": pcfg,
                 "W0": W0, "H0": H0}
        plan.run(W0=W0, H0=H0)      # warm-up: kernels loaded, caches full
        _sync(dev)
        return state

    def _slice(self, sl, before, iters, wall_s):
        after = self.launches()
        return {"iterations": iters,
                "launches": {k: after[k] - before[k] for k in after},
                "wall_s": wall_s, "trace": sl.stop()}

    def window(self, state, seconds, sl):
        ctx = state["ctx"]
        plan, W0, H0 = state["plan"], state["W0"], state["H0"]
        # a seeded reservoir sample of `check_fits` fits is kept for the
        # check; the others' factors are freed as the window goes, so the
        # window allocates no more device memory than one fit needs
        pick = np.random.default_rng(ctx.seed)
        kept, done, iters, failed = [], 0, 0, 0
        slice_rec = None
        if sl is not None:
            sl.start()      # before the clock: the profiler's start-up
            before = self.launches()
        t0 = time.perf_counter()
        while True:
            try:
                with torch.profiler.record_function("bench.fit"):
                    res = plan.run(W0=W0, H0=H0)
                _sync(ctx.device)
                done += 1
                iters += res.num_iterations
                if len(kept) < ctx.traffic["check_fits"]:
                    kept.append(res)
                else:
                    j = int(pick.integers(0, done))
                    if j < len(kept):
                        kept[j] = res
                del res
            except RuntimeError as e:      # a failed fit counts, and ends
                ctx.log(f"fit failed: {e}")
                failed += 1
                break
            now = time.perf_counter()
            if sl is not None and sl.due(now):
                slice_rec = self._slice(sl, before, iters, now - t0)
                # reading the trace is not the program's time: the
                # window's clock stands still while it runs
                t0 += time.perf_counter() - now
                now = time.perf_counter()
            if now - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        if sl is not None and sl.running:
            slice_rec = self._slice(sl, before, iters, wall)
        return {"fits": kept, "iterations": iters, "wall_s": wall,
                "attempted": done + failed, "failed": failed,
                "slice": slice_rec}

    def end_to_end(self, rec) -> dict:
        return {"iter_ms": rec["wall_s"] * 1e3 / max(rec["iterations"], 1)}

    def layer_record(self, state, rec) -> dict:
        """What the per-layer readers read: the shapes, the work one
        iteration needs, the window's time per iteration outside the
        traced slice, and the slice."""
        cfg, traffic = state["ctx"].config, state["ctx"].traffic
        coo = state["coo"]
        n, m, r, nnz = coo["n"], coo["m"], cfg["rank"], coo["nnz"]
        sl = rec["slice"]
        wall, iters = rec["wall_s"], rec["iterations"]
        if sl is not None and iters > sl["iterations"]:
            wall, iters = wall - sl["wall_s"], iters - sl["iterations"]
        return {"n": n, "m": m, "r": r, "nnz": nnz,
                "flops_per_iteration": self.flops_per_iteration(
                    cfg, traffic, n, m, r, nnz),
                "peak": yardstick.PEAKS[cfg["dtype"]],
                "iteration_s": wall / max(iters, 1),
                "slice": sl}

    def release(self, state):
        state.pop("plan", None)
        if state["ctx"].device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_fit(self, state, ref, precision="float64"):
        """The reference's fit from the same (W0, H0): (W, H, error)."""
        ctx, coo = state["ctx"], state["coo"]
        return ref.fit(coo["rows"], coo["cols"], coo["vals"], coo["n"],
                       coo["m"], state["W0"], state["H0"],
                       ctx.traffic["objective"], ctx.traffic["iterations"],
                       ctx.config["eps"], precision=precision)

    def answers(self, state, rec):
        """(W, H, error) of every fit kept from the window."""
        kl = any(f.kl_error is not None for f in rec["fits"])
        return [(f.W, f.H, f.kl_error if kl else f.frobenius_error)
                for f in rec["fits"]]

    def control(self, state, rec, ref):
        """The reference in the control precision, in the program's
        place: one fit's answer, judged as the window's fits are."""
        W, H, err = self.reference_fit(state, ref,
                                       precision=state["ctx"].control)
        return [(W, H, err)]

    def compare(self, state, answers_, ref) -> dict:
        """The numbers compared: over every answer, the largest W and H
        difference over the reference's largest entry, and the error's
        relative difference."""
        if "reference" not in state:
            state["reference"] = self.reference_fit(state, ref)
        Wr, Hr, er = state["reference"]
        w_den, h_den = float(Wr.abs().max()), float(Hr.abs().max())
        out = {"w_gap": 0.0, "h_gap": 0.0, "err_gap": 0.0}
        if not answers_:
            return {k: float("inf") for k in out}
        for W, H, err in answers_:
            out["w_gap"] = max(out["w_gap"], float(
                (W.double() - Wr).abs().max()) / w_den)
            out["h_gap"] = max(out["h_gap"], float(
                (H.double() - Hr).abs().max()) / h_den)
            out["err_gap"] = max(out["err_gap"],
                                 abs(float(err) - er) / abs(er))
        return out


KIND = TrainFits()
