"""The harness: one run of one cell.

Everything that belongs to a cell, a configuration, a traffic mix or a
per-layer metric lives in a file of its own, found by the name that
`BENCHMARK.json` gives:
- `workloads/<cell>.json`: the cell's configuration, traffic, chips, why,
  and the limits of its correctness numbers;
- `configs/<config>.json`: the scene deployment (`scenes.py`);
- `traffic/<traffic>.json`: the mix's parameters, and in "loop" the name
  of the closed loop that runs it, `loops/<loop>.py`;
- `metrics/<metric>.py`: the reader of one per-layer metric, `read(trace,
  run)` → a number, or None where it finds nothing to read.
"""

import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_tpu")
NO_DEVICE_EXIT = 3


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(*parts):
    """The module in the file `portbench/<parts>` (names may hold dots)."""
    path = os.path.join(HERE, *parts)
    name = "portbench._loaded." + "_".join(parts).replace(".", "_").replace("/", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str) -> tuple:
    """(end-to-end, per-layer) metric entries that the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


class Run:
    """One run of a cell: what its loop is given and what it records."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool, device,
                 started: float, cfg=None, faults=()):
        from portbench import scenes

        w = _json("workloads", f"{cell}.json")
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.started = device, started
        self.config_name = w["config"]
        self.cfg = cfg if cfg is not None else scenes.load_config(w["config"])
        self.resized, self._counts = cfg is not None, None
        self.traffic = _json("traffic", f"{w['traffic']}.json")
        self.limits, self.chips = w["limits"], w["chips"]
        self.faults = set(faults)   # planted faults, for the harness's tests
        self.spans = {}

    @contextlib.contextmanager
    def span(self, name: str):
        """A host-clock span of the harness around a call into a layer."""
        t0 = time.perf_counter()
        yield
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def counts(self) -> dict:
        """The reference's counts of the configuration's frame (counted now
        for a configuration the test suite resized)."""
        from portbench.reference import counts

        if self.resized:
            if self._counts is None:
                self._counts = counts.count_frame(self.cfg, self.device)
            return self._counts
        return counts.load_counts(self.config_name, self.cfg, self.device)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    lines = out.stdout.strip().splitlines()
    return lines[0].split(",")[-1].strip() if out.returncode == 0 and lines else "not read"


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(run: Run) -> tuple:
    """Run the cell → (result line dict, checks): its loop runs the window
    and the comparison, the readers read the trace."""
    bench_metrics = benchmark()
    e2e, layer = metrics_of(bench_metrics, run.cell)
    loop = importlib.import_module(f"portbench.loops.{run.traffic['loop']}")
    out = loop.run(run)
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"]}
    if run.trace:
        tr = out["trace"]
        values = {}
        for m in layer:
            v = load_module("metrics", f"{m['name']}.py").read(tr, run)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = values
    else:
        result["metrics"] = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                             for m in e2e}
    result["device"] = out["device"]
    if run.trace:
        result["device"]["busy_s"] = out.get("busy_s", out["trace"].busy_s())
        result["device"]["window_s"] = out.get("window_s", out["trace"].window_s())
        result["breakdown"] = {"device_ops": out["trace"].top_ops(),
                               "idle_gaps": out["trace"].idle_gaps()}
    return result, out["checks"]


def device_info(run: Run, peak_bytes: int) -> dict:
    import torch

    if torch.device(run.device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.chips, "memory_peak_bytes": peak_bytes,
            "power_limit": power_limit()}


def report(result: dict, checks: list) -> None:
    """The compared numbers as the last lines of standard error, and the
    result as the last line of standard output, the checks last in it."""
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    for name, v, lim in checks:
        print(f"check {name} = {v!r} (limit {lim!r}): {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
