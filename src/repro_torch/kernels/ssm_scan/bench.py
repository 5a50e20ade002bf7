"""Times the ``ssm_scan`` CUDA kernel on the card at every state dim.

    PYTHONPATH=src python -m repro_torch.kernels.ssm_scan.bench \\
        [--source other/ssm_scan.cu ...] [--out times.json]

Each ``--source`` is a version of ``ssm_scan.cu`` with the same C interface
(``ssm_scan_launch``), for instance the parent commit's, unpacked with
``git archive``; the default is this package's.  Every source is built with
``ops.FLAGS`` and, at each (dtype, B, N), first held to ``ssm_scan_plain``
at a small ragged shape (fp32 5e-5, bf16 5e-2) and then timed at (B, T 4096,
D 16384, N): the jamba-1.5-large prefill's T and D, with N taking every
value the kernel builds, at B 1 and 4.  The sources are timed in the
order given and then in reverse (A B B A), so drift of the card's clock
shows as a gap between the two windows of one source.  A window is the
mean device time of 20 launches queued behind a device sleep (CUDA
events).  Prints one line per time, the card's name and power limit, and
a JSON line of every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels._build import build, load_library
from repro_torch.kernels.ssm_scan import ops

TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
CHECK_SHAPE = (2, 100, 130)          # B, T, D: T and D off every tile
BATCHES, SEQ, CHANNELS = (1, 4), 4096, 16384


def load(source: Path) -> ctypes.CDLL:
    lib = load_library(source, ops.FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssm_scan_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.ssm_scan_launch.restype = i
    lib.ssm_scan_error_string.argtypes = [i]
    lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def inputs(b, t, d, n, dtype, seed=0):
    """dt ~ U(0.001, 0.1), A = -U(0.5, 2), as the reference test draws
    them; u, B, C standard normal."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn((b, t, d), generator=g, device="cuda")
    dt = 0.001 + 0.099 * torch.rand((b, t, d), generator=g, device="cuda")
    a = -(0.5 + 1.5 * torch.rand((d, n), generator=g, device="cuda"))
    bm, cm = (torch.randn((b, t, n), generator=g, device="cuda")
              for _ in range(2))
    return u.to(dtype), dt.to(dtype), a, bm.to(dtype), cm.to(dtype)


def window_ms(fn, iters: int = 20) -> float:
    """Mean device time of one fn() over `iters` launches queued behind a
    device sleep, so the host's enqueue cost stays out of the time; fails
    if the sleep ran out before the launches were queued."""
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


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", type=Path,
                    help="a version of ssm_scan.cu (repeatable; default: "
                         "this package's)")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssm_scan bench: no CUDA device", file=sys.stderr)
        return 1
    sources = [s.resolve() for s in (args.source or [ops.SOURCE])]
    build([(s, ops.FLAGS) for s in sources])            # nvcc in parallel
    libs = [load(s) for s in sources]
    print(f"card: {card()}", flush=True)
    rows = []
    for dtype in TOL:
        for n in ops.STATE_DIMS:
            small = inputs(*CHECK_SHAPE, n, dtype, seed=n)
            want = ops.ssm_scan_plain(*small).float()
            errs = []
            for src, lib in zip(sources, libs):
                got = ops._launch(lib, *small).float()
                errs.append(float((got - want).abs().max()))
                ok = torch.allclose(got, want, rtol=TOL[dtype],
                                    atol=TOL[dtype])
                if not ok:
                    print(f"{src}: {dtype} N {n} off the plain version by "
                          f"{errs[-1]:.3g}", file=sys.stderr)
                    return 1
            for b in BATCHES:
                big = inputs(b, SEQ, CHANNELS, n, dtype)
                order = list(range(len(libs)))
                ms = {k: [] for k in order}
                for k in order + order[::-1]:
                    ms[k].append(window_ms(
                        lambda: ops._launch(libs[k], *big)))
                del big
                for k in order:
                    row = {"source": str(sources[k]),
                           "dtype": str(dtype).split(".")[-1], "B": b,
                           "T": SEQ, "D": CHANNELS, "N": n,
                           "ms": ms[k], "max_abs_err": errs[k]}
                    rows.append(row)
                    print(f"{row['dtype']} B={b} T={SEQ} D={CHANNELS} "
                          f"N={n}: "
                          f"{' / '.join(f'{x:.4f}' for x in ms[k])} ms "
                          f"(err {errs[k]:.3g} at {CHECK_SHAPE}) "
                          f"{sources[k]}", flush=True)
    text = json.dumps({"card": card(), "times": rows})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
