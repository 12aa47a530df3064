"""Readings that set a cell's limits, taken on the card: the program's
compared numbers on many seeds; the control's, the reference computed
in the precision below the configuration's and put in the program's
place; and each fault's that the cell's kind declares (`FAULTS`). Each
seed's set-up is paid once, in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \\
        --seconds <s> [--control 1,2] [--faults 1,2] [--out <file>]

prints one JSON line per seed and side ("program", "control", or the
fault's name) and appends it to --out. The benchmark's runs never run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--control", type=_ints, default=[])
    p.add_argument("--faults", type=_ints, default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from benchmark import faults, harness

    cell = harness.find_cell(ROOT, args.workload)
    dev = harness.device_for(cell)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    kind, ref = cell.kind, cell.reference

    def emit(seed, side, numbers, **extra):
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "side": side, **numbers, **extra})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in args.seeds:
        ctx = harness.Ctx(cell, seed, dev)
        t = time.perf_counter()
        state = kind.setup(ctx)
        setup_s = time.perf_counter() - t
        rec = kind.window(state, args.seconds, None)
        e2e = kind.end_to_end(rec)
        kind.release(state)
        t = time.perf_counter()
        emit(seed, "program", kind.compare(state, kind.answers(state, rec),
                                           ref), setup_s=setup_s,
             check_s=time.perf_counter() - t, **e2e)
        if seed in args.control:
            t = time.perf_counter()
            ans = kind.control(state, rec, ref)
            emit(seed, "control", kind.compare(state, ans, ref),
                 precision=ctx.control, control_s=time.perf_counter() - t)
        for fault in kind.FAULTS if seed in args.faults else ():
            with faults.planted(kind, fault):
                st = kind.setup(ctx)
                got = kind.window(st, 0.0, None)
                kind.release(st)
            emit(seed, fault, kind.compare(state, kind.answers(st, got),
                                           ref))
            del st, got
        del state, rec
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
