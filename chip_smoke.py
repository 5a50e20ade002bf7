#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``repro_torch``) once on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA device, nvcc and
PyTorch built for CUDA)::

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``src/repro_torch`` (nvcc, at
first use) and runs, in order — any failure exits non-zero before the last
line is printed:

1. card: name and power limit (nvidia-smi), torch/CUDA versions, build time;
2. each kernel against its plain PyTorch version on the card, at the
   reference's own kernel tolerances, at small and ragged batches and at
   the sweep's chunk shape;
3. the evaluator: ``backend="cuda"`` objectives against the torch roofline
   backend on 4,096 sampled designs, one dispatch per ``evaluate``, and
   ``backend="auto"`` timing the two on the card;
4. the main path, part 1: the full 4,741,632-design sweep through the
   kernel, then the same sweep on the torch roofline backend, which must
   find the same superior count, top-k ids and front;
5. the main path, part 2: a budget-20 LUMINA run on the GPT-3 pair, scored
   against the phase-4 front;
6. kernel timings at the sweep's chunk shape against their bounds (the
   timed outputs held against the plain version once more), and a short
   profiler window over the kernel sweep: device time by kernel and
   the device's idle share.

Kernel launch counters are zeroed just before each part of the main path
and read just after; every kernel must have launched there.  The second to
last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports torch, numpy and ``repro_torch``
only.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the reference's own ppa_eval tolerances (tests/test_kernels.py)
TOL_LAT_RTOL = 1e-4
TOL_STALL_RTOL, TOL_STALL_ATOL = 1e-4, 1e-9
TOL_AREA_RTOL = 1e-5

# NVIDIA H100 SXM data-sheet peaks (dense): HBM bandwidth and fp32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

SWEEP_CHUNK = 131_072   # SweepEngine's default chunk, the main path's shape
PHASE2_BATCHES = (1, 255, 256, 65_553, SWEEP_CHUNK)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def max_rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def check_ppa_rows(got: np.ndarray, want: np.ndarray, what: str) -> dict:
    """Hold (B, 8) ppa_eval rows to the reference kernel tolerances."""
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=TOL_LAT_RTOL,
                               err_msg=f"{what}: latency")
    np.testing.assert_allclose(got[:, 1:5], want[:, 1:5],
                               rtol=TOL_STALL_RTOL, atol=TOL_STALL_ATOL,
                               err_msg=f"{what}: stalls")
    np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=TOL_AREA_RTOL,
                               err_msg=f"{what}: area")
    return {"lat": max_rel(got[:, 0], want[:, 0]),
            "stall": float(np.max(np.abs(got[:, 1:5] - want[:, 1:5]))),
            "area": max_rel(got[:, 5], want[:, 5]),
            "abs": float(np.max(np.abs(got - want))),
            "bitwise": bool(np.array_equal(got, want))}


def time_ms(torch, fn, warm: int = 3, iters: int = 20) -> float:
    """Mean time of fn() over `iters` calls issued back to back from the
    host (CUDA events): device time, or the host's issue rate where that
    is slower."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(torch, fn, warm: int = 3, iters: int = 50) -> float:
    """Mean device time of one fn() launch (CUDA events).  A device sleep
    queued first keeps the card busy while the host enqueues all `iters`
    launches, so they run back to back and the host's per-launch cost
    does not leak into the time; fails if the sleep ran out first."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(100_000_000)          # ~50 ms at the H100's clock
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    check(host_ms < ev[0].elapsed_time(ev[1]),
          f"enqueue took {host_ms:.2f} ms, longer than the device sleep")
    return ev[1].elapsed_time(ev[2]) / iters


def profile_sweep(torch, eng, n_chunks: int = 4) -> None:
    """Device time by kernel name over `n_chunks` chunk steps of `eng`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(0, n_chunks * eng.chunk_size)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values())
    if not by_name:
        log("[6] profile: the profiler saw no device events; device time "
            "not measured")
        return
    log(f"[6] profile {n_chunks} sweep chunks: wall {wall_us / 1e3:.3f} ms "
        f"(profiled), device busy {busy / 1e3:.3f} ms, idle share "
        f"{1.0 - busy / wall_us:.3f}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    shown = ranked[:10] + [kv for kv in ranked[10:] if "ppa_eval" in kv[0]]
    for name, (n, us) in shown:
        log(f"[6]   {us / busy:6.1%} {us / 1e3:8.3f} ms x{n:<4d} {name[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.core.loop import LuminaDSE
    from repro_torch.kernels import _build
    from repro_torch.kernels.ppa_eval import ops as ppa_ops
    from repro_torch.kernels.ppa_eval import (op_table, op_table_tensor,
                                              ppa_eval, ppa_eval_op_count,
                                              ppa_eval_plain)
    from repro_torch.perfmodel import (OracleEvaluator, SweepEngine,
                                       get_evaluator, gpt3_layer_decode,
                                       gpt3_layer_prefill)
    from repro_torch.perfmodel.designspace import SPACE
    from repro_torch.perfmodel.evaluator import EvalRequest

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()

    # ---- 1. card + build --------------------------------------------------
    log(f"[1] card: {smi}")
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.load_library("ppa_eval", ppa_ops.SOURCE)
    log(f"[1] build ppa_eval: {time.perf_counter() - t0:.2f} s")
    for line in _build.BUILD_LOGS.get("ppa_eval", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[1]   {line.strip()}")

    # ---- 2. kernel vs plain on the card -----------------------------------
    wls = {"ttft": gpt3_layer_prefill(), "tpot": gpt3_layer_decode()}
    max_abs_err = 0.0
    for nm, wl in wls.items():
        tab = op_table_tensor(wl, dev)
        for b in PHASE2_BATCHES:
            idx = torch.as_tensor(SPACE.sample(np.random.default_rng(7), b),
                                  device=dev)
            dv = SPACE.decode_values(idx)
            got = ppa_eval(dv, tab, float(wl.tp))
            want = ppa_eval_plain(dv, tab, float(wl.tp))
            torch.cuda.synchronize()
            err = check_ppa_rows(got.cpu().numpy(), want.cpu().numpy(),
                                 f"ppa_eval {nm} B={b}")
            max_abs_err = max(max_abs_err, err["abs"])
            log(f"[2] ppa_eval {nm} B={b}: max rel lat {err['lat']:.3g} "
                f"area {err['area']:.3g}, max abs stall {err['stall']:.3g}, "
                f"bitwise {err['bitwise']}")

    # ---- 3. evaluator: cuda backend vs torch roofline ---------------------
    ev_k = get_evaluator("proxy", backend="cuda")
    ev_r = get_evaluator("proxy", backend="roofline")
    check(ev_k.backend == "cuda" and ev_r.backend == "roofline",
          f"backends {ev_k.backend}/{ev_r.backend}")
    idx = SPACE.sample(np.random.default_rng(7), 4096)
    d0 = ev_k.dispatches
    yk = ev_k.objectives(idx)
    check(ev_k.dispatches == d0 + 1, "objectives must cost one dispatch")
    yr = ev_r.objectives(idx)
    for j, what in enumerate(("ttft", "tpot")):
        np.testing.assert_allclose(yk[:, j], yr[:, j], rtol=TOL_LAT_RTOL,
                                   err_msg=f"evaluator {what}")
    np.testing.assert_allclose(yk[:, 2], yr[:, 2], rtol=TOL_AREA_RTOL,
                               err_msg="evaluator area")
    rep = ev_k.evaluate(EvalRequest(idx[:64], detail="stalls"))
    check(ev_k.dispatches == d0 + 2, "stalls evaluate must cost one dispatch")
    check(np.isfinite(rep.stall["ttft"]).all() and rep.stall["ttft"].shape
          == (64, 4), "stalls report malformed")
    log(f"[3] evaluator 4096 designs: cuda vs roofline max rel "
        f"ttft {max_rel(yk[:, 0], yr[:, 0]):.3g} "
        f"tpot {max_rel(yk[:, 1], yr[:, 1]):.3g} "
        f"area {max_rel(yk[:, 2], yr[:, 2]):.3g}, bitwise "
        f"{np.array_equal(yk, yr)}; dispatches +1 per evaluate")
    ev_a = get_evaluator("proxy", backend="auto")      # times both on card
    check(ev_a.backend in ("roofline", "cuda"), f"auto -> {ev_a.backend}")
    check(np.array_equal(ev_a.objectives(idx), yr),
          "backend='auto' objectives differ from the roofline backend's")
    log(f"[3] backend='auto' timed the candidates and chose {ev_a.backend}")

    # ---- 4. main path part 1: the full-space sweep through the kernel -----
    eng_k = SweepEngine(ev_k, stall_topk=8, backend="cuda")
    check(eng_k.backend == "cuda", "sweep did not take the kernel backend")
    check(eng_k.chunk_size == SWEEP_CHUNK,
          f"sweep chunk {eng_k.chunk_size}, but phase 2 checked "
          f"B={SWEEP_CHUNK}")
    eng_k.run(0, 2 * eng_k.chunk_size)                    # warm-up
    torch.cuda.synchronize()
    ppa_eval.launches = 0
    res_k = eng_k.run()
    sweep_launches = ppa_eval.launches
    n_chunks = -(-SPACE.size // eng_k.chunk_size)
    check(res_k.n_evaluated == SPACE.size,
          f"n_eval {res_k.n_evaluated} != {SPACE.size}")
    check(sweep_launches > 0, "the sweep never launched ppa_eval")
    check(sweep_launches == 2 * n_chunks,
          f"{sweep_launches} launches for {n_chunks} chunks x 2 workloads")
    check(np.isfinite(res_k.pareto_y).all() and len(res_k.pareto_ids) > 0,
          "empty or non-finite front")
    seeds = {k: len(v) for k, v in res_k.stall_seeds().items()}
    log(f"[4] sweep cuda: n_eval {res_k.n_evaluated} n_superior "
        f"{res_k.n_superior} front {len(res_k.pareto_ids)} stall seeds "
        f"{seeds} wall {res_k.seconds:.3f} s "
        f"{res_k.points_per_sec:,.0f} designs/s; chunk {eng_k.chunk_size} "
        f"x {n_chunks} chunks; ppa_eval launches {sweep_launches}")

    eng_r = SweepEngine(ev_r, stall_topk=8, backend="roofline")
    eng_r.run(0, 2 * eng_r.chunk_size)                    # warm-up
    res_r = eng_r.run()
    check(res_r.n_evaluated == res_k.n_evaluated, "n_eval differs")
    check(res_r.n_superior == res_k.n_superior,
          f"n_superior {res_r.n_superior} != {res_k.n_superior}")
    check(np.array_equal(res_r.topk_ids, res_k.topk_ids), "top-k ids differ")
    check(np.array_equal(res_r.stall_topk_ids, res_k.stall_topk_ids),
          "stall seeds differ")
    check(set(res_r.pareto_ids.tolist()) == set(res_k.pareto_ids.tolist()),
          "front id sets differ")
    check(np.array_equal(res_r.pareto_ids, res_k.pareto_ids)
          and np.array_equal(res_r.pareto_y, res_k.pareto_y),
          "front values differ between the cuda and roofline sweeps")
    log(f"[4] sweep roofline (torch ops): n_superior {res_r.n_superior} "
        f"front {len(res_r.pareto_ids)} wall {res_r.seconds:.3f} s "
        f"{res_r.points_per_sec:,.0f} designs/s; equal to the cuda sweep "
        f"(n_superior, top-k ids, stall seeds, front ids and values)")

    # ---- 5. main path part 2: budget-20 LUMINA run --------------------------
    ppa_eval.launches = 0
    d0 = ev_k.dispatches
    t0 = time.perf_counter()
    dse = LuminaDSE(ev_k, seed=0)
    out = dse.run(budget=20)
    loop_s = time.perf_counter() - t0
    loop_launches = ppa_eval.launches
    check(len(out.samples) == 20, f"{len(out.samples)} samples, want 20")
    check(loop_launches > 0, "the LUMINA run never launched ppa_eval")
    oracle = OracleEvaluator(ev_k, result=res_k)
    nphv = oracle.normalized_phv(out.phv, dse.ref_point)
    check(np.isfinite(out.phv) and 0.0 <= nphv <= 1.0 + 1e-9,
          f"phv {out.phv} normalized {nphv}")
    log(f"[5] LUMINA budget 20: superior_count {out.superior_count} "
        f"phv {out.phv:.6e} normalized_phv {nphv:.6f} dispatches "
        f"{ev_k.dispatches - d0} wall {loop_s:.3f} s ppa_eval launches "
        f"{loop_launches}")

    # ---- 6. kernel timing at the sweep's chunk shape ------------------------
    b = eng_k.chunk_size
    idx = torch.as_tensor(SPACE.sample(np.random.default_rng(1), b),
                          device=dev)
    dv = SPACE.decode_values(idx)
    times = {}
    for nm, wl in wls.items():
        tab = op_table_tensor(wl, dev)
        saved = ppa_eval.launches
        k_ms = kernel_ms(torch, lambda: ppa_eval(dv, tab, float(wl.tp)))
        loop_ms = time_ms(torch, lambda: ppa_eval(dv, tab, float(wl.tp)))
        ppa_eval.launches = saved           # timing launches are not the path's
        err = check_ppa_rows(ppa_eval(dv, tab, float(wl.tp)).cpu().numpy(),
                             ppa_eval_plain(dv, tab, float(wl.tp))
                             .cpu().numpy(), f"ppa_eval {nm} B={b} (timed)")
        ppa_eval.launches = saved
        max_abs_err = max(max_abs_err, err["abs"])
        p_ms = time_ms(torch, lambda: ppa_eval_plain(dv, tab, float(wl.tp)),
                       warm=1, iters=5)
        n_ops = tab.shape[0]
        nbytes = (2 * b * 8 + n_ops * 8) * 4
        nops = b * ppa_eval_op_count(op_table(wl))
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = nops / PEAK_FP32_PER_S * 1e3
        times[nm] = {"ms": k_ms, "loop_ms": loop_ms, "plain_ms": p_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        log(f"[6] ppa_eval {nm} B={b} n_ops={n_ops}: kernel {k_ms:.4f} ms "
            f"(back-to-back from Python: {loop_ms:.4f} ms per launch), "
            f"plain {p_ms:.3f} ms, bound {times[nm]['bound_ms']:.5f} ms "
            f"({times[nm]['bound_by']}: {nbytes} B, {nops} fp32 ops)")
    full = n_chunks * (times["ttft"]["ms"] + times["tpot"]["ms"])
    log(f"[6] ppa_eval per full sweep: {2 * n_chunks} launches, "
        f"~{full:.3f} ms of kernel time")
    saved = ppa_eval.launches
    profile_sweep(torch, eng_k)
    ppa_eval.launches = saved               # profiled launches likewise

    kt = times["ttft"]
    kernels = [{
        "name": "ppa_eval", "route": "cuda",
        "source": "src/repro_torch/kernels/ppa_eval/ppa_eval.cu",
        "replaces": "src/repro/kernels/ppa_eval/kernel.py:42",
        "launches": sweep_launches + loop_launches,
        "max_abs_err": max_abs_err,
        "ms": kt["ms"], "plain_ms": kt["plain_ms"],
        "bound_ms": kt["bound_ms"], "bound_by": kt["bound_by"],
        "library_ms": None,
    }]
    log(f"[7] total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
