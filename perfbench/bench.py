"""The harness: one cell of ``BENCHMARK.json`` run once.

A cell names a configuration and a traffic mix; both are data files found
by name (``configs/<config>.json``, ``traffic/<mix>.json``), and the mix's
``kind`` names the loop that serves it (``kinds/<kind>.py``).  A model's
configuration names its family (``"reference"``), whose plain reference
and FLOP counts are ``reference/<family>.py`` and ``costs/<family>.py``.
Each per-layer metric is a reader of its own (``metrics/<metric>.py``),
found by the metric's name; the limits of the comparison that decides
``correct`` are the cell's file (``limits/<cell>.json``).  Adding a cell, a
mix of a known kind, a configuration, a model family or a metric adds
files and entries; no file of the harness changes.

A run: set-up (the program imported, its kernels loaded from the build
cache, the weights made on the device from the seed, every shape of the
cell's traffic warmed), the measured window (a closed loop for at least
``--seconds``, ending when the request or step under way completes), the
peak memory read, the program's state freed, then the comparison with the
plain reference.  ``--trace 1`` runs the window under the profiler and
reports the per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
import types
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A run that cannot produce a result (exit code `code`)."""

    def __init__(self, msg: str, code: int = 1):
        super().__init__(msg)
        self.code = code


# ------------------------------------------------------------- loading
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise BenchError(f"no workload {name!r} in BENCHMARK.json; have "
                     f"{[w['name'] for w in bench['workloads']]}", 2)


def config_file(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise BenchError(f"no configuration {name!r} in BENCHMARK.json", 2)


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return load_json(HERE / "limits" / f"{cell_name}.json")


def kind_module(kind: str):
    return importlib.import_module(f"perfbench.kinds.{kind}")


def metric_reader(name: str) -> types.ModuleType:
    """metrics/<name>.py, loaded by path (a metric's name holds dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell_name: str) -> bool:
    return "workloads" not in entry or cell_name in entry["workloads"]


def cell_metrics(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer ones (1)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if _applies(m, cell_name)]


# ------------------------------------------------------------- checks
def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its relatives' or the
    JAX package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


def import_program():
    """The port's package from the checkout's ``src``; a checkout that
    holds only the benchmark has none."""
    src = ROOT / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    try:
        return importlib.import_module("repro_torch")
    except ImportError as e:
        raise BenchError(f"the program (repro_torch under {src}) cannot be "
                         f"imported: {e}", 5) from e


def check_cuda(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is false: this "
                         "benchmark measures the CUDA port and needs a card",
                         3)
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} cards, "
                         f"torch.cuda.device_count() is "
                         f"{torch.cuda.device_count()}", 3)


def set_precision(torch, tf32: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


# ------------------------------------------------------------- comparison
class Check:
    """One number compared with its limit (value <= limit passes)."""

    def __init__(self, name: str, value: float, limit: float):
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit

    def as_dict(self) -> dict:
        return {"value": self.value, "limit": self.limit}


def checks_from(values: Dict[str, float], lim: dict) -> List[Check]:
    """The numbers the cell's limits file compares, each with its limit;
    a number the run could not read counts as failed (inf)."""
    return [Check(n, values.get(n, math.inf), spec["limit"])
            for n, spec in lim["compare"].items()]


# ------------------------------------------------------------- the window
def closed_loop(step: Callable[[int], float], seconds: float,
                now=time.perf_counter) -> dict:
    """Call step(i) (one request or train step, returning when its result
    is complete, with its work units) until `seconds` have passed; the
    window ends when the call under way completes."""
    t0 = now()
    work, i = 0.0, 0
    while True:
        work += step(i)
        i += 1
        t1 = now()
        if t1 - t0 >= seconds:
            break
    return {"t0": t0, "t1": t1, "window_s": t1 - t0, "units": i,
            "work": work}


def _ranged(torch, fn, label: str, stamps: dict):
    """fn with its stream time bracketed by CUDA events (appended to
    stamps[label]) inside a profiler range named `label`."""
    def wrapped(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with torch.profiler.record_function(label):
            ev[0].record()
            out = fn(*args, **kw)
            ev[1].record()
        stamps[label].append(ev)
        return out
    return wrapped


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def traced_loop(torch, step, seconds: float, ranges) -> dict:
    """closed_loop under torch.profiler, each (module, attribute, label) of
    `ranges` wrapped from outside for the window.  Adds the device's busy
    seconds (the union of its operations' intervals), the device time and
    launches of each operation by name, each range's stream seconds per
    call, and the breakdown (the ten longest device operations, and the
    idle gaps by the host operation under way)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    stamps = {label: [] for _, _, label in ranges}
    saved = [(importlib.import_module(m), a) for m, a, _ in ranges]
    originals = [getattr(mod, a) for mod, a in saved]
    for (mod, a), orig, (_, _, label) in zip(saved, originals, ranges):
        setattr(mod, a, _ranged(torch, orig, label, stamps))
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            win = closed_loop(step, seconds)
            torch.cuda.synchronize()
    finally:
        for (mod, a), orig in zip(saved, originals):
            setattr(mod, a, orig)
    labels = set(stamps)
    dev, host = [], []
    for e in prof.events():
        if e.name in labels:
            continue
        iv = (e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
        (dev if e.device_type == DeviceType.CUDA else host).append(iv)
    kernels: Dict[str, List[float]] = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += e - s
    busy = _union([(s, e) for s, e, _ in dev])
    win["busy_s"] = sum(e - s for s, e in busy)
    win["kernels"] = {n: (int(c), float(t)) for n, (c, t) in kernels.items()}
    win["ranges"] = {label: [a.elapsed_time(b) / 1e3 for a, b in evs]
                     for label, evs in stamps.items()}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    win["breakdown"] = {"device_ops": [[n, t] for n, (_, t) in top],
                        "idle_gaps": _idle_gaps(busy, host)}
    return win


def _idle_gaps(busy: List[Tuple[float, float]], host) -> List[list]:
    """Seconds of device idleness between busy intervals, summed by the
    innermost host operation under way at each gap's middle."""
    host = sorted(host)
    by: Dict[str, float] = {}
    active: list = []          # host operations started, latest last
    j = 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        while active and active[-1][1] < mid:
            active.pop()
        label = active[-1][2] if active else "no host operation recorded"
        by[label] = by.get(label, 0.0) + (s1 - e0)
    return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:10]]


# ------------------------------------------------------------- the run
def load_cell(workload: str, device: Optional[str] = None,
              model_override: Optional[dict] = None,
              traffic_override: Optional[dict] = None):
    """(BENCHMARK.json, the cell, its configuration, its mix, the device)
    with the program importable; without `device`, the card the cell
    needs or an error."""
    import torch
    bench = benchmark()
    c = cell(bench, workload)
    conf = config_file(bench, c["config"])
    if model_override is not None:
        conf = dict(conf, model=dict(conf["model"], **model_override))
    mix = traffic(c["traffic"])
    if traffic_override is not None:
        mix = dict(mix, **traffic_override)
    if device is None:
        check_cuda(torch, c["chips"])
        device = "cuda"
    import_program()
    set_precision(torch, conf.get("tf32", False))
    return bench, c, conf, mix, torch.device(device)


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: Optional[str] = None,
        model_override: Optional[dict] = None,
        traffic_override: Optional[dict] = None,
        fault: Optional[Callable] = None,
        limits_override: Optional[dict] = None) -> dict:
    """One run of the cell; returns the result line's object.

    `device`, `model_override`, `traffic_override`, `fault` and
    `limits_override` are the tests' (a CPU run at a small size, with the
    timed path broken by `fault`, held to limits read at that size); a
    measured run passes none of them."""
    import torch

    bench, c, conf, mix, dev = load_cell(workload, device, model_override,
                                         traffic_override)
    lim = limits_override or limits(workload)
    kind = kind_module(mix["kind"])
    readers = ({m["name"]: metric_reader(m["name"])
                for m in cell_metrics(bench, workload, True)}
               if trace else {})
    ranges = [r for mod in readers.values() for r in getattr(mod, "RANGES",
                                                             ())]

    on_card = dev.type == "cuda"
    if trace and not on_card:
        raise BenchError("--trace 1 reads the card's profiler", 3)
    job = kind.Job(conf, mix, seed, dev, fault=fault)
    job.setup()
    if on_card:
        torch.cuda.synchronize()
    if trace:
        win = traced_loop(torch, job.step, seconds, ranges)
    else:
        win = closed_loop(job.step, seconds)
        if on_card:
            torch.cuda.synchronize()
    setup_s = win["t0"] - t_start
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    banned = banned_modules()
    if banned:
        raise BenchError("modules of JAX or of the JAX package are loaded: "
                         + ", ".join(banned), 4)
    job.close_window()
    values = job.compare()
    checks = checks_from(values, lim)

    e2e = {"setup_s": setup_s, **job.end_to_end(win)}
    metrics = {}
    if trace:
        ctx = types.SimpleNamespace(conf=conf, model=conf["model"], mix=mix,
                                    cell=c, job=job, **win)
        for m in cell_metrics(bench, workload, True):
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, workload, False):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
    result = {
        "correct": all(ch.ok for ch in checks) and job.failed == 0,
        "attempted": int(win["units"]),
        "failed": int(job.failed),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else dev.type),
                   "count": int(c["chips"]),
                   "memory_peak_bytes": int(peak)},
    }
    if trace:
        result["device"]["busy_s"] = win["busy_s"]
        result["device"]["window_s"] = win["window_s"]
        result["breakdown"] = win["breakdown"]
    result["checks"] = {ch.name: ch.as_dict() for ch in checks}
    return result
