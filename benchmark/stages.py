"""A cell's time by the program's own stages: one traced run of a cell,
its slice reduced by the spans the program marks while a profiler runs
(``nmftpu.<layer>.<stage>``, `nmftpu_torch.utils.span`) and by the
difference of the program's counters (`nmftpu_torch.utils.counters`)
over the slice, as `tracing.Slice` keeps them.

    python3 benchmark/stages.py --workload <name> --seed <n> \\
        --seconds <s>

from the root of a checkout, on the card. The run is the cell's set-up
and window as `run.py` makes them; no check follows. The last line of
standard output is one JSON object: each span's `count`, `host_s`,
`device_s` and `idle_s` (`tracing.program_spans`), the counters'
difference, every per-layer metric of the cell as its reader reads it
(None where it finds nothing) and the closure of the idle time (the
idle seconds laid to spans and `outside` against the sum of the gaps
`tracing.idle_gaps` names).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark import harness, tracing  # noqa: E402


def run(root: Path, workload: str, seed: int, seconds: float,
        device=None) -> dict:
    """One traced run of a cell, reduced by stage (see the module)."""
    import torch

    cell = harness.find_cell(root, workload)
    dev = harness.device_for(cell, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    kind = cell.kind
    state = kind.setup(harness.Ctx(cell, seed, dev))
    sl = tracing.Slice(cell.traffic["trace_seconds"], dev)
    rec = kind.window(state, seconds, sl)
    layer = kind.layer_record(state, rec)
    kind.release(state)
    tr = layer["slice"]["trace"]
    spans = tr["spans"]
    metrics = {m["name"]: cell.reader(m["name"]).read(layer)
               for m in cell.per_layer()}
    attributed = sum(s["idle_s"] for s in spans.values())
    out = {"workload": workload, "seed": seed,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else dev.type),
           "window_s": tr["window_s"], "busy_s": tr["busy_s"],
           "idle_gaps_s": tr["idle_gaps_s"], "attributed_idle_s": attributed,
           "metrics": metrics, "spans": spans, "counters": tr["counters"]}
    if "uncertified" in layer["slice"]:
        out["slice_uncertified_rows"] = sum(layer["slice"]["uncertified"])
        out["slice_requests"] = layer["slice"]["requests"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    try:
        out = run(root, args.workload, args.seed, args.seconds)
    except harness.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
