"""Times the ``pareto_reduce`` CUDA kernel on the card, chunk by chunk of a
full-space sweep, against its plain version and the host insert it
replaced, and the sweep with either.

    PYTHONPATH=src python -m repro_torch.kernels.pareto_reduce.bench \\
        [--arch qwen2-moe-a2.7b] [--chunk 524288] [--sweeps 4] \\
        [--out times.json]

The sweep is the architect's full-space sweep of ``--arch``'s prefill
(batch 8, seq 2048) and decode (KV 3,072) at TP 8 on the ``cuda`` backend,
top-k 16, stall top-k 8.  One sweep records each chunk's reduction inputs
(the chunk's rows, its filter survivors and the archive's rows); each
chunk's kernel result is held to the plain version's and to the host
insert's, then timed: the call's device time (its kernels and sort; CUDA
events, 20 calls queued behind a device sleep), the call as the sweep
makes it (launch, copy of the entering rows, ``ParetoArchive.apply``), the
plain version on the card, and the old host path (the survivors copied
over and ``ParetoArchive.insert``), beside the least work
(:func:`~repro_torch.kernels.pareto_reduce.ops.pareto_reduce_cost`).
Then whole sweeps, the engine as it is against the engine with the old
host path, A B B A, ``--sweeps`` each, with the result held equal.  Prints
the card's name and power limit and a JSON line of everything.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.core.pareto import ParetoArchive
from repro_torch.kernels.pareto_reduce import ops

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12             # H100 SXM fp32 outside the tensor cores


def absorb_by_insert(self, archives, survivor, ys, ids, front) -> None:
    """``SweepEngine._absorb`` of one scenario before the on-device
    reduction: every filter survivor copied to the host and inserted."""
    keep = torch.nonzero(survivor).squeeze(1)
    if keep.numel():
        archives[0].insert(ys[keep].cpu().numpy(),
                           ids=ids[keep].cpu().numpy())


def sweep_engine(arch: str, chunk: int, device):
    from repro_torch.configs import get_arch
    from repro_torch.perfmodel.evaluator import make_evaluator
    from repro_torch.perfmodel.sweep import SweepEngine
    from repro_torch.perfmodel.workload import from_arch
    cfg = get_arch(arch)
    wls = {"ttft": from_arch(cfg, 8, 2048, tp=8),
           "tpot": from_arch(cfg, 8, 2048, tp=8, decode=True, kv_len=3072)}
    ev = make_evaluator(wls, backend="cuda", device=device)
    return SweepEngine(ev, chunk_size=chunk, topk=16, stall_topk=8,
                       backend="cuda")


def record(engine) -> list:
    """Each chunk's reduction inputs over one sweep, cloned."""
    from repro_torch.perfmodel import sweep as sweep_mod
    calls, real = [], sweep_mod.pareto_reduce

    def recorder(ys, front, keep, ids, weights=None):
        calls.append({"ys": ys.clone(), "front": front.clone(),
                      "keep": keep.clone(), "ids": ids.clone(),
                      "weights": weights})
        return real(ys, front, keep=keep, ids=ids, weights=weights)

    sweep_mod.pareto_reduce = recorder
    try:
        engine.run()
    finally:
        sweep_mod.pareto_reduce = real
    return calls


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() (CUDA events) with its calls queued behind
    a device sleep long enough to cover the host's enqueue."""
    fn()
    torch.cuda.synchronize()
    for cycles in (100_000_000, 400_000_000, 1_600_000_000):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / iters
    raise RuntimeError("the host's enqueue outlasted the longest sleep")


def host_ms(fn, iters: int = 5) -> float:
    """Mean wall ms of fn() from a synchronised card to a synchronised
    card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def chunk_row(i: int, call: dict) -> dict:
    ys, front, keep, ids, w = (call[k] for k in ("ys", "front", "keep",
                                                 "ids", "weights"))
    kw = {"keep": keep, "ids": ids, "weights": w}
    got = ops.entrants(*ops.pareto_reduce(ys, front, **kw))
    plain = ops.entrants(*ops.pareto_reduce_plain(ys, front, keep, ids, w))
    n, y_in, ids_in, dead = got
    same = (n == plain[0] and np.array_equal(y_in, plain[1])
            and np.array_equal(ids_in, plain[2])
            and np.array_equal(dead, plain[3]))
    base = ParetoArchive(3, capacity=None)
    base.y = front.double().cpu().numpy()
    base.ids = np.arange(len(base.y), dtype=np.int64) + 2**40
    want, applied = copy.deepcopy(base), copy.deepcopy(base)
    sel = keep.cpu().numpy()
    want.insert(ys.cpu().numpy()[sel], ids=ids.cpu().numpy()[sel])
    applied.apply(y_in, ids_in, dead, n)
    same &= (np.array_equal(want.y, applied.y)
             and np.array_equal(want.ids, applied.ids)
             and want.n_seen == applied.n_seen)

    def as_swept():
        a = copy.deepcopy(base)
        r = ops.entrants(*ops.pareto_reduce(ys, front, **kw))
        a.apply(r[1], r[2], r[3], r[0])

    def old_host():
        a = copy.deepcopy(base)
        k = torch.nonzero(keep).squeeze(1)
        if k.numel():
            a.insert(ys[k].cpu().numpy(), ids=ids[k].cpu().numpy())

    cost = ops.pareto_reduce_cost(ys.shape[0], n, front.shape[0],
                                  len(ids_in))
    t_ops = cost["ops"] / PEAK_FP32_PER_S * 1e3
    t_bytes = cost["bytes"] / PEAK_BYTES_PER_S * 1e3
    return {"chunk": i, "n": n, "f": int(front.shape[0]),
            "m": len(ids_in), "dead": int(dead.sum()), "same": bool(same),
            "kernel_ms": device_ms(lambda: ops.pareto_reduce(ys, front,
                                                             **kw)),
            "as_swept_ms": host_ms(as_swept),
            "plain_ms": host_ms(lambda: ops.pareto_reduce_plain(
                ys, front, keep, ids, w), iters=2),
            "old_host_ms": host_ms(old_host),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "tests": cost["tests"]}


def sweeps_per_s(engine, old: bool, sweeps: int) -> tuple:
    from repro_torch.perfmodel.sweep import SweepEngine
    real = SweepEngine._absorb
    if old:
        SweepEngine._absorb = absorb_by_insert
    try:
        engine.run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(sweeps):
            res = engine.run()
        torch.cuda.synchronize()
        return engine.size * sweeps / (time.perf_counter() - t0), res
    finally:
        SweepEngine._absorb = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--chunk", type=int, default=524_288)
    ap.add_argument("--sweeps", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    engine = sweep_engine(args.arch, args.chunk, dev)
    engine.run(0, 2 * engine.chunk_size)                   # build + warm
    calls = record(engine)
    rows = []
    for i, call in enumerate(calls):
        row = chunk_row(i, call)
        rows.append(row)
        print(" ".join(f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in row.items()), flush=True)
        if not row["same"]:
            raise SystemExit(f"chunk {i}: the kernel's result differs")
    del calls
    rates = {"new": [], "old": []}
    results = {}
    for which in ("new", "old", "old", "new"):
        rate, results[which] = sweeps_per_s(engine, which == "old",
                                            args.sweeps)
        rates[which].append(rate)
        print(f"sweep {which}: {rate:,.0f} designs/s", flush=True)
    a, b = results["new"], results["old"]
    equal = all(np.array_equal(getattr(a, f), getattr(b, f)) for f in (
        "pareto_y", "pareto_ids", "topk_val", "topk_ids", "stall_topk_ids"))
    equal &= a.n_superior == b.n_superior
    print(f"sweep results equal: {equal}", flush=True)
    out = {"card": smi, "chunks": rows, "rates": rates, "equal": equal,
           "launches": ops.pareto_reduce.launches}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if equal else 1


if __name__ == "__main__":
    raise SystemExit(main())
