"""Times the ``ppa_eval`` CUDA kernel on the card, against its launch floor.

    PYTHONPATH=src python -m repro_torch.kernels.ppa_eval.bench \\
        [--source other/ppa_eval.cu ...] [--out times.json]

Each ``--source`` is a version of ``ppa_eval.cu``: one with this package's
C interface (``ppa_eval_tables_launch``, every workload in one launch) or
one with the earlier single-table interface (``ppa_eval_launch``, one
workload a launch), for instance the parent commit's, unpacked with ``git
archive``; the default is this package's.  Every source is built with
``ops.FLAGS`` and first held bit for bit to ``ppa_eval_plain`` on the
GPT-3 prefill and decode tables, alone and together: sampled designs at
B 1, 255, 256 and 4,113, and off-grid rows (sa_dim drawn from
``ops.MAX_SA + 1`` values, and from a continuum).  Then each is timed at
B 131,072 (the sweep's chunk), 4,096 (the evaluator's batch in
``chip_smoke.py`` phase 3) and 256: prefill alone, decode alone and both
(one launch where the source takes several workloads, else the two
single-table launches back to back), in the order given and then in
reverse (A B B A), so drift of the card's clock shows as a gap between
the two windows of one source.  Beside them: an empty kernel of the same
grid launched the same way (``launch_floor.cu``: the launch floor) and the
byte bound (each design row read once, each result row written once, at
3.35 TB/s).  A window is the mean device time of 100 launches queued
behind a device sleep (CUDA events).  Also prints each source's SASS
instructions per kernel (``cuobjdump -sass`` on the built library; with
the IEEE divisions' ``MUFU.RCP``), the card's name and power limit, and a
JSON line of everything.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ppa_eval import ops

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
CHECK_BATCHES = (1, 255, 256, 4_113)
TIME_BATCHES = (131_072, 4_096, 256)
WORKLOADS = ("prefill", "decode")


def off_grid_rows(n: int, seed: int, n_sa: int = 0) -> np.ndarray:
    """(n, 8) fp32 design values off the design space's grid: every
    parameter drawn from a continuum around its range (gbuf_mb also at the
    A100's 40), sa_dim from `n_sa` distinct values, or from a continuum
    when `n_sa` is 0 (every row its own value).  All positive and finite."""
    rng = np.random.default_rng(seed)
    lo = np.array([1, 1, 1, 2, 2, 16, 8, 1], np.float64)
    hi = np.array([32, 300, 10, 160, 160, 2048, 2048, 16], np.float64)
    rows = lo + (hi - lo) * rng.random((n, 8))
    if n_sa:
        rows[:, 3] = rng.choice(lo[3] + (hi[3] - lo[3]) * rng.random(n_sa),
                                size=n)
    rows[rng.random(n) < 0.25, 6] = 40.0
    return rows.astype(np.float32)


def design_batches(n: int, device, seed: int = 7):
    """{name: (n, 8) design values}: sampled ids of the design space, and
    off-grid rows with ops.MAX_SA + 1 and with n distinct sa values."""
    from repro_torch.perfmodel.designspace import SPACE
    idx = torch.as_tensor(SPACE.sample(np.random.default_rng(seed), n),
                          device=device)
    return {"sampled": SPACE.decode_values(idx),
            f"off-grid sa x{ops.MAX_SA + 1}": torch.as_tensor(
                off_grid_rows(n, seed, ops.MAX_SA + 1), device=device),
            "off-grid sa continuous": torch.as_tensor(
                off_grid_rows(n, seed + 1), device=device)}


def gpt3_tables(device) -> dict:
    """{name: KernelTables} for the GPT-3 prefill and decode tables, alone
    and both (the sweep's and the evaluator's pair)."""
    from repro_torch.perfmodel import workload as W
    wls = {w: getattr(W, f"gpt3_layer_{w}")() for w in WORKLOADS}
    out = {w: ops.kernel_tables([wl], device) for w, wl in wls.items()}
    out["both"] = ops.kernel_tables(list(wls.values()), device)
    return out


class Version:
    """A built version of ppa_eval.cu, launched into a given output."""

    def __init__(self, source: Path):
        self.source = source
        self.lib = _build.load_library(source, ops.FLAGS)
        p, i = ctypes.c_void_p, ctypes.c_int
        self.tables = hasattr(self.lib, "ppa_eval_tables_launch")
        if self.tables:
            fn = self.lib.ppa_eval_tables_launch
            fn.argtypes = [p, p, i, ctypes.POINTER(i),
                           ctypes.POINTER(ctypes.c_float), p,
                           ctypes.c_longlong, p]
        else:
            fn = self.lib.ppa_eval_launch
            fn.argtypes = [p, p, i, ctypes.c_float, p, ctypes.c_longlong, p]
        fn.restype = i
        self.lib.ppa_eval_error_string.argtypes = [i]
        self.lib.ppa_eval_error_string.restype = ctypes.c_char_p

    def launcher(self, dv: torch.Tensor, tabs: ops.KernelTables,
                 out: torch.Tensor):
        """A no-argument function that evaluates `tabs` on `dv` into `out`
        ((n_workloads, B, 8)): one launch, or one per workload for the
        single-table interface."""
        b, n = dv.shape[0], len(tabs)
        stream = torch.cuda.current_stream().cuda_stream
        if self.tables:
            ends = (ctypes.c_int * n)(*tabs.ends)
            tps = (ctypes.c_float * n)(*tabs.tps)
            calls = [lambda: self.lib.ppa_eval_tables_launch(
                dv.data_ptr(), tabs.ops.data_ptr(), n, ends, tps,
                out.data_ptr(), b, stream)]
        else:
            calls = [lambda t=tabs.table(w), tp=tabs.tps[w], o=out[w]:
                     self.lib.ppa_eval_launch(dv.data_ptr(), t.data_ptr(),
                                              t.shape[0], tp, o.data_ptr(),
                                              b, stream)
                     for w in range(n)]

        def run():
            for call in calls:
                err = call()
                if err:
                    raise RuntimeError(
                        f"{self.source}: launch failed: "
                        + self.lib.ppa_eval_error_string(err).decode())
        return run


def floor_launcher(b: int):
    """An empty kernel's launch at the grid ppa_eval takes for `b` designs."""
    lib = _build.load_library(ops.FLOOR_SOURCE, ops.FLAGS)
    lib.launch_floor.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.launch_floor.restype = ctypes.c_int
    blocks = -(-b // ops.BLOCK)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        if lib.launch_floor(blocks, ops.BLOCK, stream):
            raise RuntimeError("launch_floor: launch failed")
    return run


def bound_ms(b: int, tabs: ops.KernelTables) -> float:
    """Each design row read once, each (workload, design) row and the op
    tables once, at the HBM rate."""
    nbytes = (b * 8 + len(tabs) * b * 8 + tabs.ops.shape[0] * 8) * 4
    return nbytes / PEAK_BYTES_PER_S * 1e3


def window_ms(fn, iters: int = 100) -> float:
    """Mean device time of one fn() over `iters` calls queued behind a
    device sleep, so the host's enqueue cost stays out of the time; fails
    if the sleep ran out before the calls were queued."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(400_000_000)                 # ~200 ms
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        raise RuntimeError(f"enqueue took {host_ms:.2f} ms, longer than "
                           f"the device sleep")
    return ev[1].elapsed_time(ev[2]) / iters


def sass_counts(library: Path) -> dict:
    """{kernel: {"instructions": n, "mufu_rcp": n}} from ``cuobjdump
    -sass`` on a built library (static counts, padding included); empty
    where the toolkit has no cuobjdump."""
    cob = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.exists(cob):
        return {}
    sass = subprocess.run([cob, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), {"instructions": 0,
                                              "mufu_rcp": 0})
        elif cur is not None and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            cur["instructions"] += 1
            cur["mufu_rcp"] += "MUFU.RCP" in line
    return out


def check_version(v: Version, tables: dict) -> dict:
    """Hold `v` to ppa_eval_plain bit for bit on every batch and table
    set; {case: True} or raises."""
    seen = {}
    for b in CHECK_BATCHES:
        for name, dv in design_batches(b, "cuda", seed=b).items():
            for tname, tabs in tables.items():
                out = torch.empty((len(tabs), b, 8), device="cuda")
                v.launcher(dv, tabs, out)()
                want = torch.stack([ops.ppa_eval_plain(dv, t, tp)
                                    for t, tp in tabs.unpack()])
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    bad = int((out != want).any(dim=2).sum())
                    raise AssertionError(
                        f"{v.source}: {tname} B={b} {name}: {bad} rows "
                        f"differ from ppa_eval_plain")
                seen[f"{tname} B={b} {name}"] = True
    return seen


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", type=Path,
                    help="a version of ppa_eval.cu (repeatable; default: "
                         "this package's)")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ppa_eval bench: no CUDA device", file=sys.stderr)
        return 1
    sources = [s.resolve() for s in (args.source or [ops.SOURCE])]
    _build.build([(s, ops.FLAGS) for s in sources]
                 + [(ops.FLOOR_SOURCE, ops.FLAGS)])    # nvcc in parallel
    versions = [Version(s) for s in sources]
    print(f"card: {card()}", flush=True)
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    sass = {}
    for v in versions:
        sass[str(v.source)] = sass_counts(
            _build.library_path(v.source, ops.FLAGS))
        for fn, c in sass[str(v.source)].items():
            print(f"SASS {v.source}: {fn}: {c['instructions']} "
                  f"instructions, {c['mufu_rcp']} MUFU.RCP", flush=True)
    tables = gpt3_tables("cuda")
    for v in versions:
        n = len(check_version(v, tables))
        print(f"{v.source}: bitwise equal to ppa_eval_plain in {n} cases",
              flush=True)
    rows = []
    for b in TIME_BATCHES:
        dv = design_batches(b, "cuda", seed=1)["sampled"]
        timed = []                  # (label, source or None, fn)
        for tname, tabs in tables.items():
            out = torch.empty((len(tabs), b, 8), device="cuda")
            for v in versions:
                timed.append(((tname, str(v.source)), v,
                              v.launcher(dv, tabs, out)))
        timed.append((("floor", "launch_floor.cu"), None, floor_launcher(b)))
        ms = {label: [] for label, _, _ in timed}
        for label, _, fn in timed + timed[::-1]:
            ms[label].append(window_ms(fn))
        for (tname, src), v, _ in timed:
            tabs = tables.get(tname)
            row = {"B": b, "tables": tname, "source": src,
                   "launches": (1 if v is None or v.tables
                                else len(tabs)),
                   "ms": ms[(tname, src)],
                   "bound_ms": None if tabs is None else bound_ms(b, tabs)}
            rows.append(row)
            print(f"B={b} {tname}: "
                  f"{' / '.join(f'{x:.5f}' for x in row['ms'])} ms "
                  f"({row['launches']} launches) "
                  + (f"bound {row['bound_ms']:.5f} ms "
                     if row["bound_ms"] else "")
                  + src, flush=True)
    text = json.dumps({"card": card(), "sass": sass, "times": rows})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
