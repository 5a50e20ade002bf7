"""Times the ``flash_attention`` backward kernel on the card at the
training shapes.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.bench \\
        [--source other/flash_attention.cu ...] [--out times.json]

Each ``--source`` is a version of ``flash_attention.cu`` with the same C
interface (``flash_attention_bwd_launch``), for instance the parent
commit's, unpacked with ``git archive``, or a copy with other tile
constants; the default is this package's.  Every source is built with
``ops.FLAGS`` (nvcc in parallel; each source's ptxas registers and spills
of ``fa_bwd_dkdv`` and ``fa_bwd_dq`` are printed) and, at each shape and
dtype, first held to ``flash_attention_bwd_plain`` in float64 from this
package's forward lse (fp32 1e-4, bf16 2e-2 of the largest max |ref| of
the three gradients, the card tests' tolerance) and then timed.  The
shapes are the llama3.2-1b, jamba-1.5-large and qwen2-moe-a2.7b attention
layers at B 2 / 1 / 1, S 4096, causal.  The sources are timed in the order
given and then in reverse (A B B A), so drift of the card's clock shows
as a gap between the two windows of one source.  A window is the mean
device time of 5 backward calls queued behind a device sleep (CUDA
events); after it, a profiler window over 3 calls gives each of the
backward's three kernels' mean device time.  Prints one line per time,
the card's name and power limit, and a JSON line of every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.ssm_scan.bench import card, window_ms

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (B, S, H, KVH, hd), causal, S = Sq = Sk
SHAPES = {"llama3.2-1b": (2, 4096, 32, 8, 64),
          "jamba": (1, 4096, 64, 8, 128),
          "qwen2-moe": (1, 4096, 16, 16, 128)}
PASSES = ("fa_bwd_dot", "fa_bwd_dkdv", "fa_bwd_dq")


def staged(sources) -> list:
    """Copies of the sources under distinct names in the build directory,
    so that each build's ptxas output is kept apart."""
    out = []
    where = _build.BUILD_DIR / "flash_attention_bench"
    where.mkdir(parents=True, exist_ok=True)
    for i, source in enumerate(sources):
        copy = where / f"flash_attention_{i}.cu"
        copy.write_bytes(source.read_bytes())
        out.append(copy)
    return out


def load(source: Path) -> ctypes.CDLL:
    lib = _build.load_library(source, ops.FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = [
        p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float,
        i, p]
    lib.flash_attention_bwd_launch.restype = i
    return lib


def registers(source: Path) -> str:
    """`pass<type, hd>: registers/spill bytes` of the backward's two
    tensor-core kernels, from the build's ptxas output."""
    name = re.compile(r"fa_bwd_(dkdv|dq)I(f|13__nv_bfloat16)Li(\d+)E")
    out, cur = [], None
    for line in _build.BUILD_LOGS.get(source.stem, "").splitlines():
        m = name.search(line) if "Compiling entry" in line else None
        if m:
            cur = (f"{m.group(1)}<{'fp32' if m.group(2) == 'f' else 'bf16'}"
                   f", {m.group(3)}>")
            spill = None
        elif cur and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif cur and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{cur} {regs}/{spill}")
            cur = None
    return "; ".join(sorted(out))


def backward(lib, q, k, v, o, do, lse):
    """(dq, dk, dv) from `lib`'s backward launch, causal."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, kvh, hd,
        ops.DTYPES[q.dtype], 1.0 / math.sqrt(hd), 1,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd_launch returned {err}")
    return dq, dk, dv


def pass_ms(fn, calls: int = 3) -> dict:
    """Mean device time (ms) of each of the backward's kernels over a
    profiler window of `calls` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    seen = {n: [] for n in PASSES}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for n in PASSES:
                if n in e.name:
                    seen[n].append(e.time_range.elapsed_us() / 1e3)
    return {n: sum(t) / len(t) if t else float("nan")
            for n, t in seen.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", type=Path,
                    help="a version of flash_attention.cu (repeatable; "
                         "default: this package's)")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_attention bench: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = [s.resolve() for s in (args.source or [ops.SOURCE])]
    copies = staged(sources)
    _build.build([(c, ops.FLAGS) for c in copies])      # nvcc in parallel
    libs = [load(c) for c in copies]
    print(f"card: {card()}", flush=True)
    for src, copy in zip(sources, copies):
        print(f"registers/spill bytes {src}: {registers(copy)}", flush=True)
    rows = []
    for name, (b, s, h, kvh, hd) in SHAPES.items():
        for dtype in TOL:
            g = torch.Generator(device="cuda").manual_seed(s + hd)
            q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                           .to(dtype) for shape in ((b, s, h, hd),
                                                    (b, s, kvh, hd),
                                                    (b, s, kvh, hd),
                                                    (b, s, h, hd)))
            o, lse = ops._forward(q, k, v, True, with_lse=True)
            want = ops.flash_attention_bwd_plain(
                *(x.double() for x in (q, k, v, o, do)), lse.double())
            scale = max(float(w.abs().max()) for w in want)
            errs = []
            for src, lib in zip(sources, libs):
                got = backward(lib, q, k, v, o, do, lse)
                errs.append(max(float((x.double() - w).abs().max())
                                for x, w in zip(got, want)) / scale)
                if errs[-1] > TOL[dtype]:
                    print(f"{src}: {name} {dtype} off the plain version "
                          f"by {errs[-1]:.3g} of max |ref|", file=sys.stderr)
                    return 1
            del want, got
            order = list(range(len(libs)))
            ms = {i: [] for i in order}
            for i in order + order[::-1]:
                ms[i].append(window_ms(
                    lambda: backward(libs[i], q, k, v, o, do, lse), iters=5))
            for i in order:
                parts = pass_ms(lambda: backward(libs[i], q, k, v, o, do,
                                                 lse))
                row = {"source": str(sources[i]), "shape": name,
                       "dtype": str(dtype).split(".")[-1], "ms": ms[i],
                       "pass_ms": parts, "rel_err": errs[i]}
                rows.append(row)
                print(f"{name} {row['dtype']}: "
                      f"{' / '.join(f'{x:.3f}' for x in ms[i])} ms ("
                      + ", ".join(f"{n} {t:.3f}" for n, t in parts.items())
                      + f"; err {errs[i]:.3g} of max |ref|) {sources[i]}",
                      flush=True)
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    text = json.dumps({"card": card(), "times": rows})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
