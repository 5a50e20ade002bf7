"""Times the ``rwkv6_scan`` backward kernel on the card at the rwkv6-7b
training shape.

    PYTHONPATH=src python -m repro_torch.kernels.rwkv6_scan.bench \\
        [--source other/rwkv6_scan.cu ...] [--out times.json]

Each ``--source`` is a version of ``rwkv6_scan.cu`` with the same C
interface (``rwkv6_scan_launch``, ``rwkv6_scan_bwd_launch`` and their
workspace sizes), for instance the parent commit's, unpacked with ``git
archive``; the default is this package's.  Every source is built with
``ops.FLAGS`` (nvcc in parallel; each source's ptxas registers and spills
of its backward kernels are printed).  At (B 1, T 4096, H 64, hd 64) fp32
with the model's w (~0.9975), each version's backward, from the chunk
states its own forward wrote, is first held to ``rwkv6_scan_bwd_plain`` in
float64 (5e-5 of each gradient's max |g|, the card tests' tolerance) and
then timed.  The sources are timed in the order given and then in reverse
(A B B A), so drift of the card's clock shows as a gap between the two
windows of one source.  A window is the mean device time of 5 backward
calls queued behind a device sleep (CUDA events); after it, a profiler
window over 3 calls gives each of the backward's kernels' mean device
time.  Prints one line per time, the card's name and power limit, the
bound from ``rwkv6_scan_bwd_cost``, and a JSON line of every time.

``--stamps`` also builds the first source with ``-DRWKV6_BWD_STAMPS``
(the backward's phase clocks; see ``BWD_PHASE`` in the source) and prints
where the chunk pass's blocks of one head spend their clocks: staging and
dy . v, the checkpoint pass, the sub-chunks' forward stepping, their
walks, the barriers and stores after them, du, the cluster's dv; and,
from every block's SM and %globaltimer span, the SMs the pass used, a
block's mean life, the blocks resident an SM on average (the sum of its
blocks' lives over its busy span) and the SM clock (clocks over life).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan import ops
from repro_torch.kernels.ssm_scan.bench import card, window_ms

TOL = 5e-5
SHAPE = (1, 4096, 64, 64)                  # B, T, H, hd: rwkv6-7b's step
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12     # H100 SXM: SIMT fp32, HBM3
NAMES = ("dr", "dk", "dv", "dw", "du")
KERNEL = re.compile(r"(wkv_bwd\w*)(?:<(\d+)>)?")
STAMP_FLAGS = (*ops.FLAGS, "-DRWKV6_BWD_STAMPS")
PHASES = ("staging and dy.v", "checkpoint pass", "forward stepping",
          "walks", "barriers and stores", "du", "cluster dv")


def staged(sources, tag: str = "") -> list:
    """Copies of the sources under distinct names in the build directory,
    so that each build's ptxas output is kept apart."""
    out = []
    where = _build.BUILD_DIR / "rwkv6_scan_bench"
    where.mkdir(parents=True, exist_ok=True)
    for i, source in enumerate(sources):
        copy = where / f"rwkv6_scan{tag}_{i}.cu"
        copy.write_bytes(source.read_bytes())
        out.append(copy)
    return out


def load(source: Path, flags=ops.FLAGS) -> ctypes.CDLL:
    lib = _build.load_library(source, flags)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rwkv6_scan_launch.argtypes = [p] * 7 + [ll, i, i, i, i, i, p]
    lib.rwkv6_scan_launch.restype = i
    lib.rwkv6_scan_bwd_launch.argtypes = [p] * 13 + [ll, i, i, i, i, p]
    lib.rwkv6_scan_bwd_launch.restype = i
    for fn in (lib.rwkv6_scan_workspace_floats,
               lib.rwkv6_scan_bwd_workspace_floats):
        fn.argtypes = [i, i, i, i]
        fn.restype = ll
    return lib


def registers(source: Path) -> str:
    """`kernel<hd>: registers/spill bytes` of each backward kernel, from
    the build's ptxas output."""
    name = re.compile(r"(wkv_bwd\w*?)(?:ILi(\d+)E|E)")
    out, cur = [], None
    for line in _build.BUILD_LOGS.get(source.stem, "").splitlines():
        m = name.search(line) if "Compiling entry" in line else None
        if m:
            cur = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            spill = None
        elif cur and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif cur and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{cur} {regs}/{spill}")
            cur = None
    return "; ".join(sorted(out))


def inputs(seed: int = 0):
    """fp32 (r, k, v, w, u, dy) at SHAPE: r, k, v ~ 0.5 N(0, 1), w the
    model's exp(-exp(-6 + 0.5 N(0, 1))), u ~ 0.1 N(0, 1), dy ~ N(0, 1)."""
    b, t, h, hd = SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (0.5 * torch.randn(SHAPE, generator=g, device="cuda")
               for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + 0.5 * torch.randn(
        SHAPE, generator=g, device="cuda")))
    u = 0.1 * torch.randn((h, hd), generator=g, device="cuda")
    dy = torch.randn(SHAPE, generator=g, device="cuda")
    return r, k, v, w, u, dy


def forward_states(lib, r, k, v, w, u):
    """The chunk states `lib`'s forward writes (its y is dropped)."""
    b, t, h, hd = r.shape
    y = torch.empty_like(r)
    ws = torch.empty(lib.rwkv6_scan_workspace_floats(b, t, h, hd),
                     dtype=torch.float32, device=r.device)
    err = lib.rwkv6_scan_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), ws.data_ptr(), ws.numel(), b, t, h, hd, 0,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rwkv6_scan_launch returned {err}")
    return ws


def backward(lib, r, k, v, w, u, dy, states):
    """(dr, dk, dv, dw, du) from `lib`'s backward launch."""
    b, t, h, hd = r.shape
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty_like(u)
    ws = torch.empty(lib.rwkv6_scan_bwd_workspace_floats(b, t, h, hd),
                     dtype=torch.float32, device=r.device)
    err = lib.rwkv6_scan_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        dy.data_ptr(), states.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dw.data_ptr(), du.data_ptr(), ws.data_ptr(),
        ws.numel(), b, t, h, hd, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rwkv6_scan_bwd_launch returned {err}")
    return dr, dk, dv, dw, du


def pass_ms(fn, calls: int = 3) -> dict:
    """Mean device time (ms) of each backward kernel (by name and head
    dim) over a profiler window of `calls` calls."""
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
            key = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            seen.setdefault(key, []).append(e.time_range.elapsed_us() / 1e3)
    return {n: sum(t) / len(t) for n, t in sorted(seen.items())}


def stamps(lib, args6) -> dict:
    """Mean clocks per phase of one chunk-pass block of (b, h) 0, from a
    build with -DRWKV6_BWD_STAMPS."""
    lib.rwkv6_scan_bwd_stamps.argtypes = [ctypes.c_void_p] * 2
    lib.rwkv6_scan_bwd_stamps.restype = ctypes.c_int
    st = forward_states(lib, *args6[:5])
    for _ in range(2):
        backward(lib, *args6, st)
    torch.cuda.synchronize()
    buf = np.zeros(64 * 8 * 8, dtype=np.int64)
    blocks = np.zeros(3 * 65536, dtype=np.uint64)
    if lib.rwkv6_scan_bwd_stamps(buf.ctypes.data, blocks.ctypes.data):
        raise RuntimeError("rwkv6_scan_bwd_stamps failed")
    b, t, h, hd = SHAPE
    per = buf.reshape(64, 8, 8)[:-(-t // 64), :hd // 16, :len(PHASES)]
    per = per.reshape(-1, len(PHASES)).astype(np.float64)
    n = min(b * h * -(-t // 64) * (hd // 16), 65536)
    sm, t0, t1 = blocks.reshape(-1, 3)[:n].astype(np.int64).T
    life = t1 - t0
    resident = [life[sm == s].sum() / (t1[sm == s].max() - t0[sm == s].min())
                for s in np.unique(sm)]
    return {"blocks": per.shape[0], "clocks": float(per.sum(1).mean()),
            "phases": dict(zip(PHASES, per.mean(0).tolist())),
            "sms": int(len(resident)), "life_us": float(life.mean() / 1e3),
            "resident": float(np.mean(resident)),
            "sm_ghz": float(per.sum(1).mean() / life.mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", type=Path,
                    help="a version of rwkv6_scan.cu (repeatable; default: "
                         "this package's)")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    ap.add_argument("--stamps", action="store_true",
                    help="also print the first source's chunk-pass phase "
                         "clocks (a build with -DRWKV6_BWD_STAMPS)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rwkv6_scan bench: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = [s.resolve() for s in (args.source or [ops.SOURCE])]
    copies = staged(sources)
    stamped = staged(sources[:1], "_stamps") if args.stamps else []
    _build.build([(c, ops.FLAGS) for c in copies]       # nvcc in parallel
                 + [(c, STAMP_FLAGS) for c in stamped])
    libs = [load(c) for c in copies]
    print(f"card: {card()}", flush=True)
    for src, copy in zip(sources, copies):
        print(f"registers/spill bytes {src}: {registers(copy)}", flush=True)
    nops, nbytes = ops.rwkv6_scan_bwd_cost(*SHAPE, 4)
    bound = max(nops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
    print(f"bound {bound:.4f} ms ({nops / 1e9:.2f} GFLOP at 67 TFLOP/s, "
          f"{nbytes / 1e6:.1f} MB at 3.35 TB/s)", flush=True)
    r, k, v, w, u, dy = args6 = inputs()
    want = ops.rwkv6_scan_bwd_plain(
        *(x.double() if x is not u else x for x in args6))
    states, errs = [], []
    for src, lib in zip(sources, libs):
        states.append(forward_states(lib, r, k, v, w, u))
        got = backward(lib, *args6, states[-1])
        again = backward(lib, *args6, states[-1])
        torch.cuda.synchronize()
        rel = [float((g.double() - x.double()).abs().max())
               / (float(x.abs().max()) or 1.0) for g, x in zip(got, want)]
        errs.append(dict(zip(NAMES, rel)))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"{src}: vs float64 "
              + ", ".join(f"{n} {e:.3g}" for n, e in errs[-1].items())
              + f" of max |g|; two launches bitwise equal: {bitwise}",
              flush=True)
        if max(rel) > TOL or not bitwise:
            print(f"{src}: off the float64 plain backward (tol {TOL}) or "
                  f"not deterministic", file=sys.stderr)
            return 1
    del want, got, again
    order = list(range(len(libs)))
    ms = {i: [] for i in order}
    for i in order + order[::-1]:
        ms[i].append(window_ms(
            lambda: backward(libs[i], *args6, states[i]), iters=5))
    rows = []
    for i in order:
        parts = pass_ms(lambda: backward(libs[i], *args6, states[i]))
        rows.append({"source": str(sources[i]), "shape": list(SHAPE),
                     "ms": ms[i], "pass_ms": parts, "rel_err": errs[i],
                     "bound_ms": bound})
        print(f"backward {SHAPE} fp32: "
              f"{' / '.join(f'{x:.3f}' for x in ms[i])} ms ("
              + ", ".join(f"{n} {t:.3f}" for n, t in parts.items())
              + f"; {min(ms[i]) / bound:.1f}x the bound) {sources[i]}",
              flush=True)
    report = {"card": card(), "times": rows}
    if stamped:
        report["stamps"] = st = stamps(load(stamped[0], STAMP_FLAGS), args6)
        print(f"chunk pass, {st['blocks']} blocks of (b, h) 0: "
              f"{st['clocks']:.0f} clocks a block; "
              + ", ".join(f"{n} {c:.0f} ({c / st['clocks']:.1%})"
                          for n, c in st["phases"].items())
              + f"; {st['sms']} SMs, a block lives {st['life_us']:.2f} us "
              f"({st['sm_ghz']:.3f} GHz), {st['resident']:.2f} resident "
              f"an SM ({sources[0]}, -DRWKV6_BWD_STAMPS)", flush=True)
    text = json.dumps(report)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
