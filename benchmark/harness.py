"""The benchmark's driver: finds a cell's files by the names in
`BENCHMARK.json`, runs its set-up, window and check, reads its per-layer
metrics, and builds the result line.

Everything that belongs to one configuration, traffic mix, metric or
cell sits in a file of its own under the benchmark's folder, found by
name:

  configs/<config>.json     the configuration as run (its `file` entry)
  traffic/<traffic>.json    a traffic mix: parameters, and the `kind`
                            that reads them
  kinds/<kind>.py           the general code of a kind of traffic:
                            its functions, or an object `KIND` that has
                            them (a kind built on another's class), and
                            `FAULTS`, the faults its cells can have
  reference/<kind>.py       that kind's plain reference
  datagen/<generator>.py    a configuration's data, made from the seed
  metrics/<metric>.py       a per-layer metric's reader
  limits/<workload>.json    the cell's limit on each number compared

so a new cell, mix, configuration or metric is new files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

# never in the process that prints a result: compared by whole
# top-level name, since the program's own name begins with "nmftpu"
FORBIDDEN = ("jax", "jaxlib", "flax", "nmftpu")


class NoDevice(RuntimeError):
    """The cell's chips are not there."""


def forbidden_modules() -> list[str]:
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


_MODULES: dict[str, object] = {}


def load_module(path: Path):
    """A module loaded from a file by path (names may hold dots)."""
    key = str(path.resolve())
    if key not in _MODULES:
        if not path.is_file():
            raise FileNotFoundError(f"no file {path}")
        spec = importlib.util.spec_from_file_location(
            "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


@dataclasses.dataclass
class Cell:
    """A workload of BENCHMARK.json with its files resolved."""

    root: Path
    bench: dict
    entry: dict
    config: dict
    traffic: dict

    @property
    def name(self) -> str:
        return self.entry["name"]

    @property
    def dir(self) -> Path:
        return self.root / self.bench["paths"][0]

    def file(self, *parts) -> Path:
        return self.dir.joinpath(*parts)

    @property
    def kind(self):
        mod = load_module(self.file("kinds", self.traffic["kind"] + ".py"))
        return getattr(mod, "KIND", mod)

    @property
    def reference(self):
        return load_module(self.file("reference",
                                     self.traffic["kind"] + ".py"))

    @property
    def limits(self) -> dict:
        return load_json(self.file("limits", self.name + ".json"))

    def end_to_end(self) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        """The per-layer metrics read in this cell's traced run: those
        whose `workloads` list it (every entry lists its cells)."""
        return [m for m in self.bench["per_layer"]
                if self.name in m["workloads"]]

    def reader(self, metric: str):
        return load_module(self.file("metrics", metric + ".py"))


def find_cell(root: Path, workload: str) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = entries[0]
    configs = [c for c in bench["configs"] if c["name"] == entry["config"]]
    if not configs:
        raise KeyError(f"no configuration {entry['config']!r}")
    config = load_json(root / configs[0]["file"])
    traffic = load_json(root / bench["paths"][0] / "traffic"
                        / (entry["traffic"] + ".json"))
    return Cell(root, bench, entry, config, traffic)


@dataclasses.dataclass
class Ctx:
    """What a kind's functions are given."""

    cell: Cell
    seed: int
    device: object

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def control(self) -> str:
        """The control precision: the step below the one the
        configuration states, whatever traffic runs on it."""
        return self.config["control"]

    def datagen(self, generator: str):
        return load_module(self.cell.file("datagen", generator + ".py"))

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def device_for(cell: Cell, device=None):
    """The cell's device: the card, which must be there with as many
    chips as the cell asks for, unless a caller (a test) names another."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: no card")
    if torch.cuda.device_count() < cell.entry["chips"]:
        raise NoDevice(f"{torch.cuda.device_count()} cards, the cell "
                       f"asks for {cell.entry['chips']}")
    return torch.device("cuda", 0)


def judged(numbers: dict, limits: dict) -> dict:
    """Each number compared beside its limit."""
    missing = set(numbers) ^ set(limits)
    if missing:
        raise KeyError(f"numbers and limits differ: {sorted(missing)}")
    return {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}


def is_correct(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, t0: float, device=None) -> dict:
    """One run of a cell: set-up, the window, the check. Returns the
    result line's object."""
    import torch

    from benchmark import tracing

    cell = find_cell(root, workload)
    dev = device_for(cell, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    kind = cell.kind
    ctx = Ctx(cell, seed, dev)
    state = kind.setup(ctx)
    setup_s = time.perf_counter() - t0
    sl = (tracing.Slice(cell.traffic["trace_seconds"], dev) if trace
          else None)
    rec = kind.window(state, seconds, sl)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    e2e = dict(kind.end_to_end(rec), setup_s=setup_s)
    layer = kind.layer_record(state, rec)
    kind.release(state)
    checks = judged(kind.compare(state, kind.answers(state, rec),
                                 cell.reference), cell.limits)
    metrics = {}
    if not trace:
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer():
            v = cell.reader(m["name"]).read(layer)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": is_correct(checks) and rec["failed"] == 0,
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else dev.type),
                      "count": cell.entry["chips"],
                      "memory_peak_bytes": peak}}
    slice_rec = layer.get("slice")
    if trace and slice_rec is not None:
        tr = slice_rec["trace"]
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = tr["breakdown"]
    out["checks"] = checks
    return out
