"""Run one cell of the benchmark of the PyTorch and CUDA port
(``nmftpu_torch``) on the card this process is started on.

    python3 benchmark/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result as one JSON object; the numbers compared for `correct` are the
last lines of standard error. Without a card (or with fewer than the cell
asks for) it prints no result and exits 2; if a JAX module or the JAX
package was imported, it prints no result and exits 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program keeps its own under nmftpu_torch/_build/ and
    native/build/)."""
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not (ROOT / "BENCHMARK.json").is_file():
        print(f"no BENCHMARK.json at {ROOT}", file=sys.stderr)
        return 2
    _cache_dirs()
    # the checkout root, not this folder, heads the import path
    sys.path[0] = str(ROOT)
    from benchmark import harness

    try:
        out = harness.run_cell(ROOT, args.workload, args.seed,
                               args.seconds, bool(args.trace), T0)
    except harness.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    # the window has closed and every reader has run: whatever this
    # process loaded is in sys.modules now
    found = harness.forbidden_modules()
    if found:
        print("no result: imported " + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
