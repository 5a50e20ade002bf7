"""Times the ``ssm_scan`` CUDA kernels on the card: the forward at every
state dim, or (``--bwd``) the backward at the jamba cut's training shape.

    PYTHONPATH=src python -m repro_torch.kernels.ssm_scan.bench \\
        [--source other/ssm_scan.cu ...] [--out times.json]
    PYTHONPATH=src python -m repro_torch.kernels.ssm_scan.bench --bwd \\
        [--source other/ssm_scan.cu ...] [--stamps] [--out times.json]

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

``--bwd``: each source is driven through its own C entry points.  A source
with ``ssm_scan_fwd_states_launch`` takes the backward's checkpoints (h
every 64 steps) from its saving forward and passes them to
``ssm_scan_bwd_launch``; an earlier source (no such entry) runs its own
state pass inside ``ssm_scan_bwd_launch``.  Each is first held to
``ssm_scan_bwd_plain`` in float64 at a small ragged shape (5e-5 of each
gradient's max |g|, two launches bit for bit), then timed A B B A at (B 1,
T 4096, D 16384, N 16) fp32 in the model's dt/A regime: the no-grad
forward, the forward the backward needs (the saving forward, or the
no-grad one for an earlier source), the backward, and the two together;
a profiler window then gives each kernel's device time.  The backward's
ptxas registers and spills per entry are printed per source, and the
bound from ``ssm_scan_bwd_cost``.  ``--stamps`` also builds the first
source with ``-DSSM_BWD_STAMPS`` and prints where its walk's blocks spend
their clocks, phase by phase (the phases the source names in
``ssm_scan_bwd_stamp_names``), and, from every block's SM and
%globaltimer span, the SMs used, a block's mean life and the SM clock.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import build, load_library
from repro_torch.kernels.ssm_scan import ops

TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
CHECK_SHAPE = (2, 100, 130)          # B, T, D: T and D off every tile
BATCHES, SEQ, CHANNELS = (1, 4), 4096, 16384
BWD_SHAPE = (1, 4096, 16384, 16)            # B, T, D, N: the jamba cut's
BWD_CHECK = (2, 333, 1000, 16)              # T and D off every tile
BWD_TOL = 5e-5
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12      # H100 SXM: SIMT fp32, HBM3
NAMES = ("du", "ddt", "da", "db", "dc")
KERNEL = re.compile(r"(ssm_\w+?)(?:<|\(|$)")
STAMP_FLAGS = (*ops.FLAGS, "-DSSM_BWD_STAMPS")
STAMP_BLOCKS = 1024


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
    ap.add_argument("--bwd", action="store_true",
                    help="time the backward at the jamba training shape")
    ap.add_argument("--stamps", action="store_true",
                    help="with --bwd: also print the first source's walk "
                         "phase clocks (a build with -DSSM_BWD_STAMPS)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssm_scan bench: no CUDA device", file=sys.stderr)
        return 1
    if args.bwd:
        return main_bwd(args)
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


# ---------------------------------------------------------------- backward
def staged(sources, tag: str = "") -> list:
    """Copies of the sources under distinct names in the build directory,
    so that each build's ptxas output is kept apart."""
    out = []
    where = _build.BUILD_DIR / "ssm_scan_bench"
    where.mkdir(parents=True, exist_ok=True)
    for i, source in enumerate(sources):
        copy = where / f"ssm_scan{tag}_{i}.cu"
        copy.write_bytes(source.read_bytes())
        out.append(copy)
    return out


def load_bwd(source: Path, flags=ops.FLAGS) -> ctypes.CDLL:
    """`source` built with `flags`, its entry points typed; `lib.saving`
    says whether it has the saving forward (and a backward that takes its
    checkpoints) or runs its own state pass."""
    lib = load(source) if flags == ops.FLAGS else load_library(source, flags)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssm_scan_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.ssm_scan_launch.restype = i
    lib.saving = hasattr(lib, "ssm_scan_fwd_states_launch")
    if lib.saving:
        lib.ssm_scan_fwd_states_launch.argtypes = [p] * 7 + [ll, i, i, i, i,
                                                             p]
        lib.ssm_scan_fwd_states_launch.restype = i
        lib.ssm_scan_states_floats.argtypes = [i, i, i, i]
        lib.ssm_scan_states_floats.restype = ll
        lib.ssm_scan_bwd_launch.argtypes = [p] * 13 + [ll, i, i, i, i, p]
    else:
        lib.ssm_scan_bwd_launch.argtypes = [p] * 12 + [ll, i, i, i, i, p]
    lib.ssm_scan_bwd_launch.restype = i
    lib.ssm_scan_bwd_workspace_floats.argtypes = [i, i, i, i]
    lib.ssm_scan_bwd_workspace_floats.restype = ll
    lib.ssm_scan_error_string.argtypes = [i]
    lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def registers(source: Path) -> str:
    """`kernel<args>: registers/spill bytes` of the backward's entries and
    the saving forward, from the build's ptxas output."""
    name = re.compile(r"(ssm_bwd_state|ssm_bwd_reduce|ssm_bwd|ssm_fwd)"
                      r"(?:I(?:f)?Li(\d+)E(Lb1E)?)?")
    out, cur = [], None
    for line in _build.BUILD_LOGS.get(source.stem, "").splitlines():
        m = name.search(line) if "Compiling entry" in line else None
        if m and (m.group(1) != "ssm_fwd" or m.group(3)):
            cur = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            spill = None
        elif m:
            cur = None
        elif cur and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif cur and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{cur} {regs}/{spill}")
            cur = None
    return "; ".join(sorted(out))


def _check(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: "
                           + lib.ssm_scan_error_string(err).decode())


def forward(lib, u, dt, a, b, c, save: bool):
    """(y, checkpoints or None) from `lib`'s no-grad or saving forward."""
    bsz, t, d = u.shape
    n = a.shape[1]
    y = torch.empty_like(u)
    stream = torch.cuda.current_stream().cuda_stream
    if not save:
        _check(lib, lib.ssm_scan_launch(
            u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), bsz, t, d, n, 0, stream), "forward")
        return y, None
    hs = torch.empty(max(lib.ssm_scan_states_floats(bsz, t, d, n), 1),
                     dtype=torch.float32, device=u.device)
    _check(lib, lib.ssm_scan_fwd_states_launch(
        u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), hs.data_ptr(),
        lib.ssm_scan_states_floats(bsz, t, d, n), bsz, t, d, n, stream),
        "saving forward")
    return y, hs


def backward(lib, u, dt, a, b, c, dy, hs):
    """(du, ddt, da, db, dc) from `lib`'s backward launch (with the
    checkpoints `hs` where the source takes them)."""
    bsz, t, d = u.shape
    n = a.shape[1]
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    db, dc, da = torch.empty_like(b), torch.empty_like(c), torch.empty_like(a)
    ws = torch.empty(lib.ssm_scan_bwd_workspace_floats(bsz, t, d, n),
                     dtype=torch.float32, device=u.device)
    ptrs = [x.data_ptr() for x in (u, dt, a, b, c, dy)]
    if lib.saving:
        ptrs.append(hs.data_ptr())
    ptrs += [x.data_ptr() for x in (du, ddt, da, db, dc, ws)]
    _check(lib, lib.ssm_scan_bwd_launch(
        *ptrs, ws.numel(), bsz, t, d, n,
        torch.cuda.current_stream().cuda_stream), "backward")
    return du, ddt, da, db, dc


def bwd_inputs(b, t, d, n, seed=0):
    """fp32 (u, dt, a, b, c, dy) in the model's regime: dt =
    softplus(N(0, 1)), A = -(1..N), as init_mamba gives; u, B, C, dy
    standard normal."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn((b, t, d), generator=g, device="cuda")
    bm, cm = (torch.randn((b, t, n), generator=g, device="cuda")
              for _ in range(2))
    dt = torch.nn.functional.softplus(
        torch.randn((b, t, d), generator=g, device="cuda"))
    a = -torch.arange(1, n + 1, dtype=torch.float32,
                      device="cuda").repeat(d, 1)
    dy = torch.randn((b, t, d), generator=g, device="cuda")
    return u, dt, a, bm, cm, dy


def kernel_times(fn, calls: int = 3) -> dict:
    """Mean device time (ms) of each ssm_* kernel over a profiler window of
    `calls` calls of fn()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    seen: dict = {}
    for e in prof.events():
        m = KERNEL.search(e.name) if e.device_type == DeviceType.CUDA \
            else None
        if m:
            key = m.group(1)
            if key == "ssm_fwd":
                key += "(saving)" if "true" in e.name else "(no-grad)"
            seen.setdefault(key, []).append(e.time_range.elapsed_us() / 1e3)
    return {k: sum(t) / len(t) for k, t in sorted(seen.items())}


def stamps(lib, args6) -> dict:
    """Mean clocks per phase of one walk block of batch row 0, from a
    build that records them."""
    lib.ssm_scan_bwd_stamps.argtypes = [ctypes.c_void_p] * 2
    lib.ssm_scan_bwd_stamps.restype = ctypes.c_int
    lib.ssm_scan_bwd_stamp_names.restype = ctypes.c_char_p
    names = lib.ssm_scan_bwd_stamp_names().decode().split(",")
    hs = forward(lib, *args6[:5], save=lib.saving)[1]
    for _ in range(2):
        backward(lib, *args6, hs)
    torch.cuda.synchronize()
    buf = np.zeros(STAMP_BLOCKS * 8, dtype=np.int64)
    blocks = np.zeros(3 * STAMP_BLOCKS, dtype=np.uint64)
    _check(lib, lib.ssm_scan_bwd_stamps(buf.ctypes.data, blocks.ctypes.data),
           "ssm_scan_bwd_stamps")
    per = buf.reshape(STAMP_BLOCKS, 8)[:, :len(names)].astype(np.float64)
    sm, t0, t1 = blocks.reshape(-1, 3).astype(np.int64).T
    used = t1 > 0
    per, sm, t0, t1 = per[used], sm[used], t0[used], t1[used]
    life = t1 - t0
    span = t1.max() - t0.min()
    return {"blocks": int(per.shape[0]), "clocks": float(per.sum(1).mean()),
            "phases": dict(zip(names, per.mean(0).tolist())),
            "sms": int(len(np.unique(sm))),
            "life_us": float(life.mean() / 1e3),
            "span_us": float(span / 1e3),
            "max_blocks_an_sm": int(np.bincount(sm).max()),
            "sm_ghz": float(per.sum(1).mean() / life.mean())}


def main_bwd(args) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = [s.resolve() for s in (args.source or [ops.SOURCE])]
    copies = staged(sources)
    stamped = staged(sources[:1], "_stamps") if args.stamps else []
    build([(c, ops.FLAGS) for c in copies]              # nvcc in parallel
          + [(c, STAMP_FLAGS) for c in stamped])
    libs = [load_bwd(c) for c in copies]
    print(f"card: {card()}", flush=True)
    for src, copy, lib in zip(sources, copies, libs):
        print(f"registers/spill bytes {src} "
              f"({'saving forward' if lib.saving else 'own state pass'}): "
              f"{registers(copy)}", flush=True)
    nops, nbytes, exps = ops.ssm_scan_bwd_cost(*BWD_SHAPE, 4)
    bound = max(nops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
    print(f"bound {bound:.4f} ms ({nops / 1e9:.2f} GFLOP at 67 TFLOP/s, "
          f"{nbytes / 1e6:.1f} MB at 3.35 TB/s; {exps / 1e9:.3f} G exps)",
          flush=True)
    small = bwd_inputs(*BWD_CHECK, seed=1)
    want = ops.ssm_scan_bwd_plain(
        *(x.double() if x is not small[2] else x for x in small))
    errs = []
    for src, lib in zip(sources, libs):
        hs = forward(lib, *small[:5], save=lib.saving)[1]
        got, again = (backward(lib, *small, hs) for _ in range(2))
        torch.cuda.synchronize()
        rel = [float((g.double() - x).abs().max())
               / (float(x.abs().max()) or 1.0) for g, x in zip(got, want)]
        errs.append(dict(zip(NAMES, rel)))
        bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
        print(f"{src}: {BWD_CHECK} vs float64 "
              + ", ".join(f"{n} {e:.3g}" for n, e in errs[-1].items())
              + f" of max |g|; two launches bitwise equal: {bitwise}",
              flush=True)
        if max(rel) > BWD_TOL or not bitwise:
            print(f"{src}: off the float64 plain backward (tol {BWD_TOL}) "
                  f"or not deterministic", file=sys.stderr)
            return 1
    del small, want, got, again
    args6 = bwd_inputs(*BWD_SHAPE)
    states = [forward(lib, *args6[:5], save=lib.saving)[1] for lib in libs]
    fns = {
        "fwd_nograd": lambda i: forward(libs[i], *args6[:5], save=False),
        "fwd": lambda i: forward(libs[i], *args6[:5], save=libs[i].saving),
        "bwd": lambda i: backward(libs[i], *args6, states[i]),
        "fwd+bwd": lambda i: backward(
            libs[i], *args6,
            forward(libs[i], *args6[:5], save=libs[i].saving)[1])}
    order = list(range(len(libs)))
    ms = {i: {k: [] for k in fns} for i in order}
    for i in order + order[::-1]:
        for key, fn in fns.items():
            ms[i][key].append(window_ms(lambda: fn(i), iters=5))
    rows = []
    for i in order:
        parts = kernel_times(lambda: fns["fwd+bwd"](i))
        rows.append({"source": str(sources[i]), "shape": list(BWD_SHAPE),
                     "saving": libs[i].saving, "ms": ms[i],
                     "kernel_ms": parts, "rel_err": errs[i],
                     "bound_ms": bound})
        how = "saving forward" if libs[i].saving else "own state pass"
        print(f"{sources[i]} ({how}) {BWD_SHAPE} fp32: "
              + "; ".join(f"{k} " + " / ".join(f"{x:.4f}" for x in v)
                          for k, v in ms[i].items())
              + " ms; device time " + ", ".join(
                  f"{n} {t:.4f}" for n, t in parts.items())
              + f" ms; backward {min(ms[i]['bwd']) / bound:.1f}x the bound",
              flush=True)
    report = {"card": card(), "times": rows}
    if stamped:
        report["stamps"] = st = stamps(load_bwd(stamped[0], STAMP_FLAGS),
                                       args6)
        print(f"walk, {st['blocks']} blocks of batch row 0: "
              f"{st['clocks']:.0f} clocks a block; "
              + ", ".join(f"{n} {c:.0f} ({c / st['clocks']:.1%})"
                          for n, c in st["phases"].items())
              + f"; {st['sms']} SMs, at most {st['max_blocks_an_sm']} blocks "
              f"an SM, a block lives {st['life_us']:.1f} us of the "
              f"{st['span_us']:.1f} us span ({st['sm_ghz']:.3f} GHz) "
              f"({sources[0]}, -DSSM_BWD_STAMPS)", flush=True)
    text = json.dumps(report)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
