#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``repro_torch``) once on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA device, nvcc and
PyTorch built for CUDA)::

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``src/repro_torch`` (nvcc, at
first use) and runs, in order — any failure exits non-zero before the last
line is printed:

1. card: name and power limit (nvidia-smi), torch/CUDA versions, build
   time; ppa_eval's registers and spills (ptxas) and SASS instructions
   (cuobjdump); each flash_attention instantiation's registers, spills
   (ptxas) and shared memory, and its tensor-core (HMMA) instructions in the
   built library's SASS (cuobjdump, where the toolkit has it; none fails),
   the same for the backward's ``fa_bwd_dkdv`` and ``fa_bwd_dq`` (16
   instantiations) and registers and spills of ``fa_bwd_dot``;
   each rwkv6_scan instantiation's (state and output pass) registers,
   spills and shared memory; each ssm_scan (``ssm_fwd``) instantiation's
   registers, spills and shared memory;
2. each kernel against its plain PyTorch version on the card, at the
   reference's own kernel tolerances, at small and ragged batches and at
   the sweep's chunk shape; ppa_eval's one launch for both GPT-3 workloads
   bit for bit against its single-table launches and the plain version,
   on sampled ids and on off-grid rows with more distinct sa_dim values
   than a block tabulates;
3. the evaluator: ``backend="cuda"`` objectives against the torch roofline
   backend on 4,096 sampled designs, one dispatch per ``evaluate``, and
   ``backend="auto"`` timing the two on the card;
4. the main path, part 1: the full 4,741,632-design sweep through the
   kernel (one launch a chunk), then the same sweep on the torch roofline
   backend, which must find the same superior count, top-k ids and front;
5. the main path, part 2: a budget-20 LUMINA run on the GPT-3 pair, scored
   against the phase-4 front;
6. kernel timings at the sweep's chunk shape against their bounds (the
   timed outputs held against the plain version once more): ppa_eval per
   workload and for both in one launch (the chunk), beside an empty
   kernel of the same grid (the launch floor); and a short
   profiler window over the kernel sweep: device time by kernel and
   the device's idle share;
7. the LM kernels against their plain versions on the card: flash_attention
   at the reference's test shapes, at (B 2, S 4096, H 32, hd 64), MHA and
   GQA, causal and not, and at jamba's (B 1, S 4096, H 64, KVH 8, hd 128,
   causal), fp32 and bf16 (2e-5 / 2e-2); rwkv6_scan at the test shapes and
   at (B 1, T 4096, H 64, hd 64), ssm_scan at the test shapes and at (B 1,
   T 4096, D 16384, N 16) (both 5e-5 / 5e-2); one ragged shape each;
   rwkv6_scan also at (1, 4096, 64, 64) with the model's w (~0.9975, held
   against the float64 plain version, since there the fp32 recurrence
   itself drifts) and with w holding exact zeros and fp32 denormals;
   ssm_scan also at (1, 4096, 16384, 16) in the model's regime (dt =
   softplus(N(0, 1)), A = -(1..16)) and in a long-memory one (dt 0.001, A
   -0.5; held against the float64 plain version);
8. the prefill step at full width in fp32, weights from a seeded
   ``torch.Generator``, prompts from ``np.random.default_rng(0)``:
   llama3.2-1b at B 2, S 4096 must launch flash_attention 16 times and
   rwkv6-7b at B 1, S 4096 rwkv6_scan 32 times; logits finite; the first
   64 positions decoded step by step must match the prefill at rtol = atol
   = 2e-3: llama3.2-1b's logits; for rwkv6-7b, ``decode_step``'s logits and
   each layer's output with every layer given the prefill's input to it,
   and the free-running logits unless one rounding of the embeddings moves
   the prefill's own logits further (the random-weight 32-layer stack
   amplifies rounding geometrically; the gaps and the drift by depth are
   printed); one profiled rwkv6-7b decode step;
9. ``serve`` at full width for both models (batch 4, prompt 32, gen 16):
   token shape, TTFT and TPOT (it prefills by decode steps, as the
   reference does, so it launches neither LM kernel);
10. LM kernel timings at phase 8's shapes (queue pre-filled, CUDA events)
   against their bounds (attention on its route: fp32 as three TF32
   products at 495 TFLOP/s, the 67 TFLOP/s SIMT figure printed beside
   it; bf16 at 989 TFLOP/s), the plain versions and, for attention, one
   ``F.scaled_dot_product_attention`` call (timed only, never used by the
   port), rwkv6_scan beside the times of its earlier, sequential version
   (recorded, not run) with the device time of each of its two passes,
   the prefill wall times, and profiler windows over one
   llama3.2-1b prefill and one decode step;
11. the hybrid path: jamba-1.5-large-398b cut to one attention and one
   Mamba sub-layer (n_layers 2, attn_every 2; every published width, 11.90
   B parameters) in fp32 from a seeded generator.  Its prefill at B 1,
   S 4096 must launch flash_attention and ssm_scan once each; 64 decode
   steps at batch 1 must match the prefill's logits at rtol = atol = 2e-3
   (MoE routings of both paths printed where they differ); greedy serving
   at batch 4 (prompt 32, gen 16): TTFT and TPOT; ssm_scan timed at the
   prefill shape against its bound, beside the times of its earlier
   kernel (4 states a lane; recorded, not run); flash_attention at hd 128
   against SDPA; a profiler window over one prefill;
12. the zoo-suite portfolio path at full width (the ten published configs
   at ``zoo_suite``'s defaults: batch 8, seq 2048, tp 8, decode at KV
   3,072; nothing cut): (a) 10 scenarios, 20 workloads, 351 op rows, 230
   unique stack rows; (b) ppa_eval's one launch for all 20 tables at B 1,
   255, 256, 4,096 and 131,072 on sampled ids and off-grid rows, bit for
   bit against the 20 single-table launches and the plain version; (c)
   ``get_evaluator("proxy", "cuda", suite="zoo")``: one dispatch and one
   ppa_eval launch per objectives evaluate, held against the roofline zoo
   evaluator (stacked torch ops); (d) the portfolio sweep over all
   4,741,632 designs (``stall_topk`` 8, ``robust="worst"``): no archive
   truncated, every front non-empty and finite; (e) each scenario's pair
   sweep on the kernel (one launch a chunk) and on torch ops equal to its
   portfolio result exactly; (f) over the first 8 portfolio chunks:
   ``workers=2`` and a resumed checkpoint equal one fresh process, and an
   ``oracle_store`` sweeps once and then loads; (g) a budget-20 LUMINA run
   on llama3.2-1b's pair through the kernel; (h) the 20-table launch at B
   4,096 and 131,072 against its bound, the empty-kernel floor and the 20
   single-table launches, and a profiler window over 4 portfolio chunks;
13. the paper's method comparison, every evaluation through the
   evaluator, phase 4's kernel sweep as the oracle front: (a) Figs. 4-6:
   the five black-box baselines (GS, RW, BO, GA, ACO) and LUMINA at the
   reference bench's settings (budget 300, 3 trials, seeds 0-2, ask
   batches of 8, proxy tier) on ``backend="cuda"``, each run equal to
   the same run on ``backend="roofline"`` (X, Y, PHV curve, superior
   count; LUMINA's trajectory), 38 ``ppa_eval`` launches (one per ask
   batch) per baseline trial; PHV, its oracle fraction, sample efficiency,
   superior count, best/worst PHV and wall per method, LUMINA's regret at
   25/50/100% of the budget and its gains over the best baseline beside
   the paper's (reported, not gated); ``ppa_eval`` at B 8 beside the
   empty kernel and one objectives dispatch's host time; (b) sweep-seeded
   campaigns (``stall_seeds()`` + the A100 start, budget 60, both
   policies): fused dispatches at most budget / K + 4, regret never
   rising, PHV fraction never falling, equal on both backends, the v5
   telemetry saved and loaded back equal (scratch under
   ``build/chip_smoke_campaigns/``, removed after); (c) Table 3: the DSE
   Benchmark at 308/127/30 generated on the card (wall printed) and the
   five backends' accuracies; the 80/40/20 suite generated on the card
   equal to the CPU's, question, options and answer; (d) the static
   influence map's edge counts and the rule audit (``metric_probe_only``
   empty), and a budget-20 LUMINA run on the static map through the
   kernel;
14. the fault-tolerant evaluation path, every evaluation on
   ``backend="cuda"``: (a) ``ShardedEvaluator`` in the inline, thread and
   device modes at 2 and 4 workers and the process mode at 2, on 65,536
   sampled designs at every detail level, each report bit for bit the
   unsharded evaluator's, ``ppa_eval`` launched once an objectives shard
   (process workers launch in their own CUDA contexts), and
   ``get_evaluator(workers=2)`` equal to ``workers=1``; (b) a fault plan
   with a crash, a corrupt payload, a slow shard and a hung one under a
   1 s shard timeout: a bit-identical report, the retry, rejection,
   timeout, eviction and re-registration counters; (c) a 2-worker sweep of
   all 4,741,632 designs under a seeded crash/slow plan, replayed from
   checkpoints every 4 chunks, equal to phase 4's (superior count, top-k,
   stall seeds, front) with its chunks counted clean + replayed, and the
   portfolio sweep killed at chunk 5 of 8 and resumed equal to a fresh run
   (scratch under ``build/chip_smoke_faults/``, removed after); (d)
   sweep-seeded campaigns at budget 60 through ``EvalService`` over a
   chaotic 2-worker ``ShardedEvaluator``, equal to the plain evaluator's,
   at most rounds + K + 2 fused service dispatches, ``service_counters``
   with the reference's keys; the degrade ladder (stalls dispatch and its
   narrowed retry crash, the objectives proxy rung serves through one
   ``ppa_eval`` launch); (e) the Perfetto trace of (c) and (d) written,
   its schema and completeness checks empty, and the fleet report; (f) one
   objectives dispatch at B 131,072 through 1, 2 and 4 thread workers,
   the chaos-off overhead (full sweeps without a plan and with an empty
   one, in turns), the chaos sweep's wall, and the service's p50/p99
   queue latency per QoS tier;
15. the moe, vlm and audio families at full width in fp32 from a seeded
   generator (every earlier model freed first): (a) internvl2-2b, full
   depth: the token prefill at B 1, S 4096 (flash_attention x24) with 64
   decode steps held to it at rtol = atol = 2e-3, then the vlm input (3,328
   stub patch rows at the embedding's scale and 768 prompt embeddings;
   flash_attention x24), the tokens' embeddings giving the tokens' logits
   bit for bit, and ``serve`` at batch 4; (b) qwen2-moe-a2.7b, full depth
   (shared experts): prefill (x24), 64 decode steps held to it (routing
   flips printed), a profiler window over a prefill with the MoE's, its
   expert products' and the shared expert's shares of device time, and
   ``serve`` at batch 4 (capacity 1 a step: colliding assignments drop,
   as in the reference); (c) arctic-480b cut to one layer (every published
   width; the dense residual beside 128 experts, attention at a group of
   7): prefill (x1), decode held to it, greedy serving at batch 4, peak
   memory; (d) whisper-medium, full depth: prefill at B 8 of 1,500 seeded
   frames and a teacher-forced decoder of S 448 (no kernel launch), 64
   decode steps from the encoder output held to it, a profiled decode
   step with the share of re-projecting the encoder output, ``serve`` at
   batch 4 (frames drawn as ``serve`` draws them); (e) flash_attention
   at the three new prefill shapes, (1, 4096, 16, 8, 128), (1, 4096, 16,
   16, 128) and (1, 4096, 56, 8, 128), causal, fp32 and bf16: held against
   its plain version, timed beside it, one SDPA call and its bound.

16. training (the kernels' backward path): (a) flash_attention's backward
   kernel against its plain version (float64, from the same lse) at
   llama3.2-1b's (2, 4096, 32/8, 64), jamba's (1, 4096, 64/8, 128) and
   qwen2-moe's (1, 4096, 16/16, 128) causal shapes and at ragged ones (S
   1000 and 2049 causal, 1000 non-causal, Sq 1000 / Sk 777 non-causal;
   these also against autograd through float64 attention), fp32 and bf16
   (1e-4 / 2e-2 of max |ref|); two launches bit for bit; the forward's lse
   against the plain version's (1e-5) and its output with lse bit for bit
   the output without; (b) llama3.2-1b at full width cut to 2 layers, B 1,
   S 4096, fp32: one loss.backward() through the kernels and one with the
   attention routed to flash_attention_plain under autograd, every
   gradient within 1e-3 of max |g|, the q/k/v weights' nonzero; (c)
   llama3.2-1b at full width and depth, B 2, S 4096, fp32, remat, AdamW
   at the reference's defaults on SyntheticLMDataset: 6 steps, each with
   32 flash_attention launches (16 recomputed) and 16 backward ones and no
   scan; losses and grad norms finite; step wall, tokens/s, peak memory
   and a profiled step (GEMMs, fa_fwd, fa_bwd, log-softmax, the
   optimizer, idle); (d) a smoke llama ``train()`` of 8 steps at B 2,
   S 4096 with checkpoints every 4 (scratch under
   ``build/chip_smoke_train/``, removed after), lost after step 4 and
   resumed in a fresh model: losses, params and moments bit for bit the
   uninterrupted run's under deterministic algorithms; (e) rwkv6 and
   jamba smoke models refuse ``loss.backward()`` on the card
   (NotImplementedError: the scans have no backward kernel); (f) the
   backward kernel (and the device time of each of its three kernels),
   its plain version and SDPA's backward (timed only) at (a)'s full-size
   shapes against the bound (as for the forward: fp32 as three TF32
   products at 495 TFLOP/s, bf16 at 989 TFLOP/s; the function's 5
   products) and the design's own floor (its 7 products at the same
   rates), the earlier SIMT kernel's recorded times printed beside, and
   the forward with lse against without.

Kernel launch counters are zeroed just before each part of the main path
and read just after; every kernel of that part must have launched there.
The second to last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports torch, numpy and ``repro_torch``
only.
"""
from __future__ import annotations

import gc
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

# NVIDIA H100 SXM data-sheet peaks (dense) of the tensor cores
PEAK_BF16_PER_S = 989e12
PEAK_TF32_PER_S = 495e12
# flash_attention's route per dtype: tensor-core products per product of
# the function, and their peak rate (fp32 is split into three TF32 ones)
FA_ROUTE = {"float32": (3, PEAK_TF32_PER_S, "3xTF32"),
            "bfloat16": (1, PEAK_BF16_PER_S, "bf16")}

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
    does not leak into the time.  If the sleep ran out first (a busy
    host), it is measured again behind a sleep four times as long; fails
    if the longest sleep still runs out."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for cycles in (100_000_000, 400_000_000, 1_600_000_000):  # ~50 ms up
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
    raise SmokeFailure(f"enqueue took {host_ms:.2f} ms, longer than the "
                       f"longest device sleep")


def _ranged(torch, fn, label: str, when, stamps: dict):
    """fn inside a profiler range named `label`, its stream time bracketed
    by CUDA events appended to stamps[label] (on calls whose arguments
    satisfy `when`, if given)."""
    def wrapped(*args, **kw):
        if when is not None and not when(*args, **kw):
            return fn(*args, **kw)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with torch.profiler.record_function(label):
            ev[0].record()
            out = fn(*args, **kw)
            ev[1].record()
        stamps[label].append(ev)
        return out
    return wrapped


def _under(e, label: str) -> bool:
    while e is not None:
        if e.name == label:
            return True
        e = e.cpu_parent
    return False


def profile_device(torch, fn, tag: str, what: str, keep: str = None,
                   ranges=(), ops_under=(), groups=None) -> dict:
    """Device time by kernel name over one call of fn(), and the device's
    idle share of the profiled window; kernels whose name holds `keep` are
    listed even outside the top ten.  Each (module, attribute, label,
    when) of `ranges` is wrapped for the window in a profiler range and in
    a pair of CUDA events, and its stream time between them (device time
    plus any wait for the host inside the range) is printed with its share
    of the busy time; for each (label, op) of `ops_under`, the device time
    of the kernels that op's calls inside the range launched; for each
    label: predicate of `groups`, the share of busy time of the kernels
    whose name it accepts.  (The profiler's own attribution of a whole
    range counted some kernels twice on the card: more device time than
    the range's stream time.)  Returns {label or "label/op": share of busy
    time, "idle": the idle share} (empty where the profiler saw no device
    events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    labels = {r[2] for r in ranges}
    stamps = {label: [] for label in labels}
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in ranges]
    for mod, attr, label, when in ranges:
        setattr(mod, attr, _ranged(torch, getattr(mod, attr), label, when,
                                   stamps))
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)
    by_name: dict = {}
    cpu_events = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name in labels:              # the ranges' own annotations
                continue
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        else:
            cpu_events.append(e)
    busy = sum(us for _, us in by_name.values())
    if not by_name:
        log(f"[{tag}] profile: the profiler saw no device events; device "
            f"time not measured")
        return {}
    log(f"[{tag}] profile {what}: wall {wall_us / 1e3:.3f} ms (profiled), "
        f"device busy {busy / 1e3:.3f} ms, idle share "
        f"{1.0 - busy / wall_us:.3f}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    shown = ranked[:10] + [kv for kv in ranked[10:]
                           if keep is not None and keep in kv[0]]
    for name, (n, us) in shown:
        log(f"[{tag}]   {us / busy:6.1%} {us / 1e3:8.3f} ms x{n:<4d} "
            f"{name[:90]}")
    shares = {}
    for label in sorted(labels):
        ms = sum(a.elapsed_time(b) for a, b in stamps[label])
        shares[label] = ms * 1e3 / busy
        log(f"[{tag}]   range {label}: {len(stamps[label])} calls, stream "
            f"time {ms:.3f} ms, {shares[label]:.1%} of busy")
    for label, op in ops_under:
        evs = [e for e in cpu_events
               if e.name == op and _under(e.cpu_parent, label)]
        us = sum(e.device_time_total for e in evs)
        shares[f"{label}/{op}"] = us / busy
        log(f"[{tag}]   {op} inside {label}: {len(evs)} calls, "
            f"{us / 1e3:.3f} ms of device time, {us / busy:.1%} of busy")
    for label, accept in (groups or {}).items():
        hit = [(n, us) for name, (n, us) in by_name.items() if accept(name)]
        shares[label] = sum(us for _, us in hit) / busy
        log(f"[{tag}]   group {label}: {sum(n for n, _ in hit)} launches of "
            f"{len(hit)} kernels, {shares[label]:.1%} of busy")
    shares["idle"] = 1.0 - busy / wall_us
    return shares


def pass_times(torch, fn, names, calls: int = 5) -> dict:
    """Mean device time (us) of one launch of each kernel whose name holds
    one of `names`, and how many launches the profiler recorded, from a
    window over `calls` calls of fn().  Late in a long process a window
    can lose its first kernel records (phase 10 saw windows of 2 and of 5
    of 5 calls in turn, phase 16f none of 3), so each window opens with a
    few short device sleeps, and up to three windows are taken until
    every launch is recorded; the mean is over the fullest window's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    best = None
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(16):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = {n: [] for n in names}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                for n in names:
                    if n in e.name:
                        seen[n].append(e.time_range.elapsed_us())
        if best is None or (min(map(len, seen.values()))
                            > min(map(len, best.values()))):
            best = seen
        if min(map(len, best.values())) >= calls:
            break
    return {n: (sum(us) / len(us) if us else float("nan"), len(us))
            for n, us in best.items()}


# ---------------------------------------------------------------- LM slice
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}       # tests/test_kernels.py
RWKV_TOL = {"float32": 5e-5, "bfloat16": 5e-2}
DECODE_TOL = 2e-3                                   # tests/test_models.py
# (B, S, H, KVH, hd, causal): the reference's test shapes, the llama3.2-1b
# prefill shape (MHA and GQA), and one ragged length
FA_SHAPES = [(2, 128, 2, 2, 64, True), (1, 256, 4, 4, 128, True),
             (2, 64, 2, 2, 32, False), (1, 128, 1, 1, 64, True),
             (2, 4096, 32, 32, 64, True), (2, 4096, 32, 32, 64, False),
             (2, 4096, 32, 8, 64, True), (2, 4096, 32, 8, 64, False),
             (2, 333, 8, 2, 64, True), (1, 4096, 64, 8, 128, True)]
# (B, T, H, hd): the test shapes, the rwkv6-7b prefill shape, one ragged T
RWKV_SHAPES = [(2, 64, 2, 16), (1, 128, 4, 32), (2, 32, 1, 64),
               (1, 4096, 64, 64), (2, 333, 3, 64)]
# w regimes at the prefill shape, and whether the plain version they are
# held against runs in float64 (near w = 1 the fp32 recurrence drifts)
RWKV_REGIMES = (("model", True), ("zeros", False))
# the sequential kernel's times at the prefill shape (B 1, T 4096, H 64,
# hd 64), from earlier runs of this script on NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md), printed beside the chunked kernel's
RWKV_SEQUENTIAL_MS = {"float32": "1.245-1.276", "bfloat16": "2.132-2.155"}
LLAMA = ("llama3.2-1b", 2, 4096)                    # arch, batch, seq
RWKV = ("rwkv6-7b", 1, 4096)
SSM_TOL = {"float32": 5e-5, "bfloat16": 5e-2}      # tests/test_kernels.py
# (B, T, D, N): the test shapes, the jamba prefill shape, one ragged shape
SSM_SHAPES = [(2, 64, 32, 8), (1, 128, 64, 16), (2, 32, 16, 4),
              (1, 4096, 16384, 16), (2, 333, 1000, 16)]
# dt, A regimes at the jamba shape, and whether the plain version they are
# held against runs in float64 (with a long memory the fp32 recurrence
# itself moves; tests/test_torch_ssm_scan.py pins by how much)
SSM_REGIMES = (("model", False), ("long", True))
# the earlier kernel's times (4 states a lane, one step at a time) at the
# jamba prefill shape (B 1, T 4096, D 16384, N 16), from earlier runs of
# this script on NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md), printed
# beside the current kernel's
SSM_EARLIER_MS = {"float32": "1.031-1.039", "bfloat16": "1.364-1.384"}
JAMBA = ("jamba-1.5-large-398b", 1, 4096)
JAMBA_FA = (1, 4096, 64, 8, 128)                    # B, S, H, KVH, hd
N_DECODE = 64


def _dtypes(torch):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}


def fa_inputs(torch, b, s, h, kvh, hd, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((b, s, kvh, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((b, s, kvh, hd), generator=g, device=dev).to(dtype)
    return q, k, v


def rwkv_inputs(torch, b, t, h, hd, dtype, dev, seed=0, regime="uniform"):
    """w ~ U(0.3, 0.99) as the reference test draws it; "model": w =
    exp(-exp(-6 + 0.5 N(0, 1))) ~ 0.9975, as the model's w_bias -6 makes
    it; "zeros": U(0, 1) with 10% exact zeros and 10% fp32 denormals."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, t, h, hd)
    r, k, v = (0.5 * torch.randn(shape, generator=g, device=dev)
               for _ in range(3))
    if regime == "uniform":
        w = 0.3 + 0.69 * torch.rand(shape, generator=g, device=dev)
    elif regime == "model":
        w = torch.exp(-torch.exp(
            -6.0 + 0.5 * torch.randn(shape, generator=g, device=dev)))
    else:
        w = torch.rand(shape, generator=g, device=dev)
        pick = torch.rand(shape, generator=g, device=dev)
        w = torch.where(pick < 0.1, 0.0, w)
        w = torch.where((pick >= 0.1) & (pick < 0.2), 1e-39, w)
    u = 0.1 * torch.randn((h, hd), generator=g, device=dev)
    return [x.to(dtype).contiguous() for x in (r, k, v, w)] + [u]


def ssm_inputs(torch, b, t, d, n, dtype, dev, seed=0, regime="test"):
    """"test": as the reference test draws them, dt ~ U(0.001, 0.1), A =
    -U(0.5, 2); "model": dt = softplus(N(0, 1)), A = -(1..N), as the
    model's initialisation gives; "long": dt 0.001, A -0.5 (decay 0.9995,
    a ~2,000-step memory)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.randn((b, t, d), generator=g, device=dev)
    if regime == "test":
        dt = 0.001 + 0.099 * torch.rand((b, t, d), generator=g, device=dev)
        a = -(0.5 + 1.5 * torch.rand((d, n), generator=g, device=dev))
    elif regime == "model":
        dt = torch.nn.functional.softplus(
            torch.randn((b, t, d), generator=g, device=dev))
        a = -torch.arange(1, n + 1, dtype=torch.float32,
                          device=dev).repeat(d, 1)
    else:
        dt = torch.full((b, t, d), 0.001, device=dev)
        a = torch.full((d, n), -0.5, device=dev)
    bm, cm = (torch.randn((b, t, n), generator=g, device=dev)
              for _ in range(2))
    return u.to(dtype), dt.to(dtype), a, bm.to(dtype), cm.to(dtype)


def hold(got, want, tol: float, what: str) -> float:
    """Fail unless |got - want| <= tol + tol |want|; returns max abs err."""
    g = got.float().cpu().numpy()
    w = want.float().cpu().numpy()
    check(bool(np.isfinite(g).all()), f"{what}: non-finite output")
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=what)
    return float(np.max(np.abs(g - w)))


def fa_bound(ops: int, nbytes: int, dn: str, simt: bool = True) -> dict:
    """The least time for flash_attention's work on its route: the larger
    of its bytes at the HBM rate and its tensor-core operations at their
    peak; with the SIMT fp32 figure for comparison (`simt`)."""
    mult, rate, route = FA_ROUTE[dn]
    t_ops = mult * ops / rate * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "text": f"{mult} x {ops / 1e9:.1f} GFLOP {route} at "
                    f"{rate / 1e12:.0f} TFLOP/s: {t_ops:.4f} ms; "
                    f"{nbytes / 1e6:.1f} MB at 3.35 TB/s: {t_bytes:.4f} ms"
                    + (f"; SIMT fp32 at 67 TFLOP/s: "
                       f"{ops / PEAK_FP32_PER_S * 1e3:.4f} ms"
                       if simt and dn == "float32" else "")}


def ptxas_by_entry(log_text: str, inst) -> dict:
    """{inst(line): {"regs": n, "spills": text}} from ptxas -v output, one
    entry per kernel that `inst` names (a key, or None to skip it)."""
    import re
    info, cur = {}, None
    for line in log_text.splitlines():
        if "Compiling entry" in line:
            cur = inst(line)
        elif cur and "spill stores" in line:
            info.setdefault(cur, {})["spills"] = line.strip()
        elif cur and "registers" in line:
            info.setdefault(cur, {})["regs"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return info


def sass_hmma(build_mod, fa_ops, inst) -> dict:
    """{inst(function line): HMMA instructions in its SASS} from
    cuobjdump of the flash_attention library; {} without cuobjdump."""
    import re
    cob = os.path.join(os.path.dirname(build_mod.find_nvcc()), "cuobjdump")
    if not os.path.exists(cob):
        return {}
    lib = build_mod.library_path(fa_ops.SOURCE, fa_ops.FLAGS)
    sass = subprocess.run([cob, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    hmma, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = inst(line)
            if cur:
                hmma[cur] = 0
        elif cur and re.search(r"\bHMMA\b", line):
            hmma[cur] += 1
    return hmma


def report_fa_build(torch, build_mod, fa_ops) -> None:
    """Registers and spills (ptxas) and shared memory of each fa_fwd,
    fa_bwd_dkdv and fa_bwd_dq instantiation, and the tensor-core
    instructions in its SASS; fails if cuobjdump is there and one has
    none."""
    import re
    name = re.compile(r"fa_fwdI(f|13__nv_bfloat16)Li(\d+)E")

    def inst(line):
        m = name.search(line)
        return m and ("float32" if m.group(1) == "f" else "bfloat16",
                      int(m.group(2)))
    bwd_name = re.compile(r"fa_bwd_(dot|dkdv|dq)I(f|13__nv_bfloat16)Li(\d+)E")

    def bwd_inst(line):
        m = bwd_name.search(line)
        return m and (m.group(1), "float32" if m.group(2) == "f"
                      else "bfloat16", int(m.group(3)))
    info = ptxas_by_entry(build_mod.BUILD_LOGS.get("flash_attention", ""),
                          inst)
    hmma = sass_hmma(build_mod, fa_ops,
                     lambda line: inst(line) or bwd_inst(line))
    if "flash_attention" not in build_mod.BUILD_LOGS:
        log("[1]   flash_attention was built by an earlier run: ptxas "
            "not reported")
        info = {key: {} for key in hmma if len(key) == 2}
    dts = _dtypes(torch)
    for dn, hd in sorted(info):
        i = info[(dn, hd)]
        h = hmma.get((dn, hd))
        log(f"[1]   fa_fwd<{dn}, {hd}>: {i.get('regs')} registers, "
            f"{i.get('spills')}; shared memory "
            f"{fa_ops.smem_bytes(hd, dts[dn])} B; "
            + (f"{h} HMMA in SASS" if h is not None else
               "SASS not read (no cuobjdump)"))
        check(h is None or h > 0, f"fa_fwd<{dn}, {hd}> has no HMMA")
    check(len(info) == 8 or not info, f"{len(info)} fa_fwd "
          f"instantiations reported, want 8")
    bwd = ptxas_by_entry(build_mod.BUILD_LOGS.get("flash_attention", ""),
                         bwd_inst)
    if not bwd:
        bwd = {key: {} for key in hmma if len(key) == 3}
    for key in sorted(bwd):
        part, dn, hd = key
        text = (f"[1]   fa_bwd_{part}<{dn}, {hd}>: {bwd[key].get('regs')} "
                f"registers, {bwd[key].get('spills')}")
        if part != "dot":                 # the two passes on the tensor cores
            h = hmma.get(key)
            text += (f"; shared memory "
                     f"{fa_ops.bwd_smem_bytes(hd, dts[dn])[part]} B; "
                     + (f"{h} HMMA in SASS" if h is not None else
                        "SASS not read (no cuobjdump)"))
            check(h is None or h > 0, f"fa_bwd_{part}<{dn}, {hd}> has no "
                  f"HMMA")
        log(text)
    check(len(bwd) == 24 or not bwd, f"{len(bwd)} fa_bwd instantiations "
          f"reported, want 24")
    n_mma = sum(1 for key in hmma if len(key) == 3 and key[0] != "dot")
    check(n_mma == 16 or not hmma, f"{n_mma} fa_bwd_dkdv / fa_bwd_dq "
          f"instantiations in the SASS, want 16")


def report_rwkv_build(build_mod, rwkv_ops) -> None:
    """Registers and spills (ptxas) of each rwkv6_scan instantiation of
    both passes, and its dynamic shared memory per block."""
    import re
    name = re.compile(r"(wkv_state|wkv_out)I(f|13__nv_bfloat16)Li(\d+)E")

    def inst(line):
        m = name.search(line)
        return m and (m.group(1), "float32" if m.group(2) == "f"
                      else "bfloat16", int(m.group(3)))
    if "rwkv6_scan" not in build_mod.BUILD_LOGS:
        log("[1]   rwkv6_scan was built by an earlier run: ptxas not "
            "reported")
        return
    info = ptxas_by_entry(build_mod.BUILD_LOGS["rwkv6_scan"], inst)
    for kern, dn, hd in sorted(info):
        i = info[(kern, dn, hd)]
        smem = rwkv_ops.smem_bytes(hd)["state" if kern == "wkv_state"
                                       else "out"]
        log(f"[1]   {kern}<{dn}, {hd}>: {i.get('regs')} registers, "
            f"{i.get('spills')}; shared memory {smem} B")
    check(len(info) == 16, f"{len(info)} rwkv6_scan instantiations "
          f"reported, want 16")


def report_ssm_build(torch, build_mod, ssm_ops) -> None:
    """Registers and spills (ptxas) and dynamic shared memory per block of
    each ssm_fwd instantiation."""
    import re
    name = re.compile(r"ssm_fwdI(f|13__nv_bfloat16)Li(\d+)E")

    def inst(line):
        m = name.search(line)
        return m and ("float32" if m.group(1) == "f" else "bfloat16",
                      int(m.group(2)))
    if "ssm_scan" not in build_mod.BUILD_LOGS:
        log("[1]   ssm_scan was built by an earlier run: ptxas not "
            "reported")
        return
    info = ptxas_by_entry(build_mod.BUILD_LOGS["ssm_scan"], inst)
    dts = _dtypes(torch)
    for dn, n in sorted(info):
        i = info[(dn, n)]
        log(f"[1]   ssm_fwd<{dn}, {n}>: {i.get('regs')} registers, "
            f"{i.get('spills')}; shared memory "
            f"{ssm_ops.smem_bytes(n, dts[dn])} B")
    check(len(info) == 10, f"{len(info)} ssm_scan instantiations "
          f"reported, want 10")


def phase7_lm_kernels(torch, dev) -> dict:
    """Each LM kernel against its plain version; max abs error per kernel
    over the fp32 checks (the main path's dtype)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_plain
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain
    err = {"flash_attention": 0.0, "rwkv6_scan": 0.0, "ssm_scan": 0.0}
    saved = (flash_attention.launches, rwkv6_scan.launches,
             ssm_scan.launches)
    for dn, dt in _dtypes(torch).items():
        for b, s, h, kvh, hd, causal in FA_SHAPES:
            q, k, v = fa_inputs(torch, b, s, h, kvh, hd, dt, dev)
            got = flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            e = hold(got, flash_attention_plain(q, k, v, causal=causal),
                     FA_TOL[dn], f"flash_attention {dn} {(b, s, h, kvh, hd)} "
                     f"causal={causal}")
            if dn == "float32":
                err["flash_attention"] = max(err["flash_attention"], e)
            log(f"[7] flash_attention {dn} B={b} S={s} H={h} KVH={kvh} "
                f"hd={hd} causal={causal}: max abs err {e:.3g} "
                f"(tol {FA_TOL[dn]})")
        for b, t, h, hd in RWKV_SHAPES:
            args = rwkv_inputs(torch, b, t, h, hd, dt, dev)
            got = rwkv6_scan(*args)
            torch.cuda.synchronize()
            e = hold(got, rwkv6_scan_plain(*args), RWKV_TOL[dn],
                     f"rwkv6_scan {dn} {(b, t, h, hd)}")
            if dn == "float32":
                err["rwkv6_scan"] = max(err["rwkv6_scan"], e)
            log(f"[7] rwkv6_scan {dn} B={b} T={t} H={h} hd={hd}: max abs "
                f"err {e:.3g} (tol {RWKV_TOL[dn]})")
        b, t, h, hd = RWKV[1], RWKV[2], 64, 64
        for regime, exact in RWKV_REGIMES:
            args = rwkv_inputs(torch, b, t, h, hd, dt, dev, regime=regime)
            got = rwkv6_scan(*args)
            torch.cuda.synchronize()
            want = (rwkv6_scan_plain(*(x.double() for x in args[:4]),
                                     args[4])
                    if exact else rwkv6_scan_plain(*args))
            e = hold(got, want, RWKV_TOL[dn],
                     f"rwkv6_scan {dn} {(b, t, h, hd)} w {regime}")
            if dn == "float32":
                err["rwkv6_scan"] = max(err["rwkv6_scan"], e)
            log(f"[7] rwkv6_scan {dn} B={b} T={t} H={h} hd={hd} w {regime}: "
                f"max abs err {e:.3g} against the "
                f"{'float64' if exact else dn} plain version "
                f"(tol {RWKV_TOL[dn]})")
            del args, got, want
        for b, t, d, n in SSM_SHAPES:
            args = ssm_inputs(torch, b, t, d, n, dt, dev)
            got = ssm_scan(*args)
            torch.cuda.synchronize()
            e = hold(got, ssm_scan_plain(*args), SSM_TOL[dn],
                     f"ssm_scan {dn} {(b, t, d, n)}")
            if dn == "float32":
                err["ssm_scan"] = max(err["ssm_scan"], e)
            log(f"[7] ssm_scan {dn} B={b} T={t} D={d} N={n}: max abs err "
                f"{e:.3g} (tol {SSM_TOL[dn]})")
            del args, got
        b, t, d, n = JAMBA[1], JAMBA[2], 16384, 16
        for regime, exact in SSM_REGIMES:
            args = ssm_inputs(torch, b, t, d, n, dt, dev, regime=regime)
            got = ssm_scan(*args)
            torch.cuda.synchronize()
            want = (ssm_scan_plain(*(x.double() if x.dim() == 3 else x
                                     for x in args))
                    if exact else ssm_scan_plain(*args))
            e = hold(got, want, SSM_TOL[dn],
                     f"ssm_scan {dn} {(b, t, d, n)} {regime}")
            log(f"[7] ssm_scan {dn} B={b} T={t} D={d} N={n} {regime} "
                f"regime: max abs err {e:.3g} against the "
                f"{'float64' if exact else dn} plain version "
                f"(tol {SSM_TOL[dn]})")
            del args, got, want
    flash_attention.launches, rwkv6_scan.launches, ssm_scan.launches = saved
    return err


def build_full_width(torch, arch, dev, seed: int = 0, tag: str = "8"):
    """`arch` (a name, or an ArchConfig) in fp32 on `dev`, weights drawn
    from a generator on the device seeded with `seed`."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    t0 = time.perf_counter()
    model = build_model(cfg, dtype=torch.float32, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"[{tag}] {cfg.name}: {n / 1e9:.3f} B parameters fp32 "
        f"({n * 4 / 2**30:.1f} GiB), seeded init "
        f"{time.perf_counter() - t0:.2f} s")
    return model


def phase8_prefill(torch, model, batch: int, seq: int, dev,
                   check_logits: bool = True, tag: str = "8",
                   frames=None) -> dict:
    """One counted prefill step, a timed second one, and the first
    N_DECODE positions decoded step by step against it: their logits are
    held to the prefill's at DECODE_TOL when `check_logits`, else only
    reported (rwkv_decode_tie and phases 11 and 15 hold them).  With
    `frames` (the audio family) the prefill reads them beside the tokens
    and the decode cache holds their encoder output."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    cfg = model.cfg
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, seq)), device=dev)
    prefill = make_prefill_step(model)
    feed = {"tokens": toks} if frames is None else {"tokens": toks,
                                                     "frames": frames}
    torch.cuda.synchronize()
    flash_attention.launches = rwkv6_scan.launches = ssm_scan.launches = 0
    t0 = time.perf_counter()
    logits = prefill(feed)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = {"flash_attention": flash_attention.launches,
              "rwkv6_scan": rwkv6_scan.launches,
              "ssm_scan": ssm_scan.launches}
    check(logits.shape == (batch, seq, cfg.vocab),
          f"{cfg.name} logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{cfg.name}: non-finite logits")
    head = logits[:, :N_DECODE].cpu().numpy()
    stats = (float(logits.float().abs().max()), float(logits.float().std()))
    del logits
    saved = dict(counts)
    t0 = time.perf_counter()
    prefill(feed)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    flash_attention.launches = saved["flash_attention"]
    rwkv6_scan.launches = saved["rwkv6_scan"]
    ssm_scan.launches = saved["ssm_scan"]
    log(f"[{tag}] {cfg.name} prefill B={batch} S={seq}: logits "
        f"{(batch, seq, cfg.vocab)} finite, max |logit| {stats[0]:.4g} std "
        f"{stats[1]:.4g}; wall {first_s:.3f} s (first), {second_s:.3f} s "
        f"(second); launches {counts}")

    step = make_serve_step(model)
    with torch.no_grad():
        enc = None if frames is None else model.encode(frames)
    cache = model.init_cache(batch, N_DECODE, enc_out=enc)
    worst = 0.0
    decoded = []
    t0 = time.perf_counter()
    for t in range(N_DECODE):
        lg, cache = step(cache, toks[:, t])
        got = lg.cpu().numpy()
        decoded.append(got)
        if check_logits:
            np.testing.assert_allclose(
                got, head[:, t], rtol=DECODE_TOL, atol=DECODE_TOL,
                err_msg=f"{cfg.name}: decode step {t} vs prefill")
        worst = max(worst, float(np.max(np.abs(got - head[:, t]))))
    decode_s = time.perf_counter() - t0
    log(f"[{tag}] {cfg.name} decode {N_DECODE} positions step by step vs "
        f"prefill logits: max abs diff {worst:.3g} "
        + (f"(held to rtol = atol = {DECODE_TOL})" if check_logits
           else "(reported here, held below)")
        + f"; {decode_s / N_DECODE * 1e3:.2f} ms per step")
    return {"counts": counts, "prefill_s": second_s, "first_s": first_s,
            "decode_diff": worst, "toks": toks, "head": head,
            "decoded": np.stack(decoded, axis=1)}


def rwkv_decode_tie(torch, model, toks, free_gap: float) -> float:
    """rwkv6-7b's decode_step against its forward over the first N_DECODE
    positions, through decode_step, its cache and every layer.

    Teacher-forced: a wrapper around ``model.rwkv_layer`` hands each layer
    of each decode step the forward's own input to that layer at that
    position; the layer's output and the step's logits are held to the
    forward's at DECODE_TOL.  Free-running (as the server decodes), the
    decode path's output of each layer is set against the forward's by
    depth, and its logits gap (`free_gap`, from phase 8) is held at
    DECODE_TOL unless the forward itself moves further than that when its
    embeddings are perturbed by one rounding (2^-24 relative; the move at
    the size of decode's own gap after layer 1 is printed beside it): with
    random weights the 32-layer stack amplifies rounding geometrically
    (tests/test_torch_models.py::test_rwkv_decode_gap_at_depth_is_rounding
    shows in fp64 that no fault needs depth).  Returns that sensitivity."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    cfg, n, b = model.cfg, N_DECODE, toks.shape[0]
    layer = model.rwkv_layer                    # the bound method
    saved = rwkv6_scan.launches
    fwd_in, fwd_out = [], []

    def record(i, h, state=None):
        out = layer(i, h, state)
        fwd_in.append(h[:, :n].clone())
        fwd_out.append(out[0][:, :n].clone())
        return out

    def decode(wrapper):
        model.rwkv_layer = wrapper
        try:
            step, cache, logits = make_serve_step(model), \
                model.init_cache(b, n), []
            for t in range(n):
                pos[0] = t
                lg, cache = step(cache, toks[:, t])
                logits.append(lg)
            return torch.stack(logits, dim=1)
        finally:
            del model.rwkv_layer

    pos = [0]
    model.rwkv_layer = record
    try:
        want = make_prefill_step(model)({"tokens": toks})[:, :n].clone()
    finally:
        del model.rwkv_layer
    forced_out = [[] for _ in range(cfg.n_layers)]

    def forced(i, h, state=None):
        out = layer(i, fwd_in[i][:, pos[0]:pos[0] + 1], state)
        forced_out[i].append(out[0])
        return out

    e_logits = hold(decode(forced), want, DECODE_TOL,
                    "rwkv6-7b teacher-forced decode_step logits vs prefill")
    per_layer = [hold(torch.cat(o, dim=1), fwd_out[i], DECODE_TOL,
                      f"rwkv6-7b layer {i}: teacher-forced decode_step vs "
                      f"forward") for i, o in enumerate(forced_out)]
    free_out = [[] for _ in range(cfg.n_layers)]

    def free(i, h, state=None):
        out = layer(i, h, state)
        free_out[i].append(out[0])
        return out

    decode(free)
    drift = [float((torch.cat(o, dim=1) - fwd_out[i]).abs().max()
                   / fwd_out[i].abs().max()) for i, o in enumerate(free_out)]
    emb = model.embed.detach().clone()
    prefill = make_prefill_step(model)
    base = prefill({"tokens": toks[:, :n]})

    def moved(eps):
        """max |logit change| of the prefill with embeddings * (1 + eps z)"""
        g = torch.Generator(device=toks.device).manual_seed(2)
        model.embed.mul_(1 + eps * torch.randn(emb.shape, generator=g,
                                               device=toks.device))
        out = float((prefill({"tokens": toks[:, :n]}) - base).abs().max())
        model.embed.copy_(emb)
        return out

    sens, sens_drift = moved(2.0 ** -24), moved(drift[0])
    del emb
    rwkv6_scan.launches = saved
    log(f"[8] rwkv6-7b teacher-forced decode_step, {cfg.n_layers} layers x "
        f"{n} positions, held at rtol = atol = {DECODE_TOL}: logits max "
        f"abs diff {e_logits:.3g}; by layer "
        f"{[float(f'{e:.2g}') for e in per_layer]}")
    depths = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(drift)]
    log(f"[8] rwkv6-7b free-running decode vs forward, max |diff| / max |h| "
        f"after layer {depths}: "
        f"{[float(f'{drift[d - 1]:.2g}') for d in depths]}")
    log(f"[8] rwkv6-7b prefill's logits moved by a relative perturbation "
        f"of the embeddings: max abs {sens:.3g} at 2^-24 (one rounding), "
        f"{sens_drift:.3g} at {drift[0]:.2g} (decode's own gap after layer "
        f"1); free-running decode's logits gap {free_gap:.3g}")
    check(free_gap <= DECODE_TOL or sens > DECODE_TOL,
          f"rwkv6-7b free-running decode leaves the prefill by {free_gap:.3g}"
          f" > {DECODE_TOL}, while one rounding moves the forward by only "
          f"{sens:.3g}")
    return sens


def profile_decode_step(torch, model, batch: int, tag: str, enc_out=None,
                        ranges=(), ops_under=()) -> dict:
    """A profiler window over one decode step after 32 (the serve path's
    unit of work), random tokens from a seeded generator; `enc_out` is the
    audio encoder's output the cache holds, `ranges` and `ops_under` as in
    `profile_device`."""
    from repro_torch.launch.steps import make_serve_step
    step = make_serve_step(model)
    g = torch.Generator(device=model.device).manual_seed(1)
    toks = torch.randint(0, model.cfg.vocab, (batch, 33), generator=g,
                         device=model.device)
    cache = model.init_cache(batch, 40, enc_out=enc_out)
    for t in range(32):
        _, cache = step(cache, toks[:, t])
    return profile_device(
        torch, lambda: step(cache, toks[:, 32]), tag,
        f"one {model.cfg.name} decode step (B {batch}, after 32)",
        ranges=ranges, ops_under=ops_under)


def phase9_serve(torch, dev) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.launch.serve import serve
    out = {}
    for arch in (LLAMA[0], RWKV[0]):
        flash_attention.launches = rwkv6_scan.launches = 0
        r = serve(arch, 4, 32, 16, smoke=False, seed=0, device=dev)
        counts = (flash_attention.launches, rwkv6_scan.launches)
        check(r["tokens"].shape == (4, 16), f"{arch} serve tokens "
              f"{r['tokens'].shape}")
        torch.cuda.empty_cache()
        log(f"[9] serve {arch} batch 4 prompt 32 gen 16: tokens "
            f"{r['tokens'].shape}, TTFT {r['ttft_s'] * 1e3:.1f} ms, TPOT "
            f"{r['tpot_s'] * 1e3:.2f} ms; launches (flash, rwkv6) {counts} "
            f"(prefill by decode steps); first row "
            f"{r['tokens'][0][:8].tolist()}")
        out[arch] = r
    return out


def time_flash_attention(torch, dev, shape, tag: str, iters: int = 10
                         ) -> dict:
    """flash_attention, causal, at `shape` (B, S, H, KVH, hd) in each
    dtype: held against its plain version at FA_TOL, timed per launch
    (`kernel_ms`), beside its plain version, one
    ``F.scaled_dot_product_attention`` call on the heads repeated (timed
    only, never used by the port) and its bound on its route.  Leaves the
    launch count as it found it; returns {dtype name: row}."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_cost,
                                                     flash_attention_plain)
    saved = flash_attention.launches
    b, s, h, kvh, hd = shape
    out = {}
    for dn, dt in _dtypes(torch).items():
        q, k, v = fa_inputs(torch, b, s, h, kvh, hd, dt, dev, seed=1)
        k_ms = kernel_ms(torch, lambda: flash_attention(q, k, v),
                         iters=iters)
        e = hold(flash_attention(q, k, v), flash_attention_plain(q, k, v),
                 FA_TOL[dn], f"flash_attention {dn} {shape} (timed)")
        p_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v),
                       warm=1, iters=3)
        qh, kh, vh = (x.permute(0, 2, 1, 3).repeat_interleave(
            h // x.shape[2], dim=1).contiguous() for x in (q, k, v))
        lib_ms = kernel_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), iters=iters)
        ops, nbytes = flash_attention_cost(b, s, s, h, kvh, hd, True,
                                           q.element_size())
        bd = fa_bound(ops, nbytes, dn)
        out[dn] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                   "bound_ms": bd["bound_ms"], "max_abs_err": e,
                   "bound_by": bd["bound_by"]}
        log(f"[{tag}] flash_attention {dn} B={b} S={s} H={h} KVH={kvh} "
            f"hd={hd} causal: kernel {k_ms:.3f} ms ({ops / k_ms / 1e9:.1f} "
            f"TFLOP/s), plain {p_ms:.3f} ms, SDPA {lib_ms:.3f} ms, bound "
            f"{bd['bound_ms']:.4f} ms ({bd['text']}); max abs err {e:.3g}")
        del q, k, v, qh, kh, vh
    flash_attention.launches = saved
    return out


def phase10_lm_timings(torch, dev) -> dict:
    """ms per launch at phase 8's shapes for each LM kernel and dtype."""
    from repro_torch.kernels.rwkv6_scan import (rwkv6_scan, rwkv6_scan_cost,
                                                rwkv6_scan_plain)
    fa = time_flash_attention(torch, dev, (LLAMA[1], LLAMA[2], 32, 8, 64),
                              "10", iters=20)
    out = {("flash_attention", dn): row for dn, row in fa.items()}
    saved = rwkv6_scan.launches
    b, t, h, hd = RWKV[1], RWKV[2], 64, 64
    for dn, dt in _dtypes(torch).items():
        args = rwkv_inputs(torch, b, t, h, hd, dt, dev, seed=1)
        k_ms = kernel_ms(torch, lambda: rwkv6_scan(*args), iters=20)
        e = hold(rwkv6_scan(*args), rwkv6_scan_plain(*args), RWKV_TOL[dn],
                 f"rwkv6_scan {dn} (timed)")
        p_ms = time_ms(torch, lambda: rwkv6_scan_plain(*args), warm=1,
                       iters=1)
        ops, nbytes = rwkv6_scan_cost(b, t, h, hd, args[0].element_size())
        t_ops = ops / PEAK_FP32_PER_S * 1e3     # the recurrence is fp32 math
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        out[("rwkv6_scan", dn)] = {
            "ms": k_ms, "plain_ms": p_ms, "library_ms": None,
            "bound_ms": max(t_ops, t_bytes), "max_abs_err": e,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        passes = pass_times(torch, lambda: rwkv6_scan(*args),
                            ("wkv_state", "wkv_out"))
        log(f"[10] rwkv6_scan {dn} B={b} T={t} H={h} hd={hd}: kernel "
            f"{k_ms:.3f} ms (chunked; the sequential kernel took "
            f"{RWKV_SEQUENTIAL_MS[dn]} ms in earlier runs), plain "
            f"{p_ms:.1f} ms, bound {max(t_ops, t_bytes):.4f} ms "
            f"({ops / 1e9:.2f} GFLOP at 67 TFLOP/s; {nbytes / 1e6:.1f} MB "
            f"at 3.35 TB/s), {max(t_ops, t_bytes) / k_ms:.1%} of it; no "
            f"single PyTorch call computes it; device time per pass "
            f"(profiler, 5 calls): "
            + ", ".join(f"{n} {us / 1e3:.4f} ms ({cnt} launches recorded)"
                        for n, (us, cnt) in passes.items()))
    rwkv6_scan.launches = saved
    return out


def _routings(moe_mod):
    """Wrap ``moe.route`` (which ``moe_block`` calls) to record each call's
    gate_idx and probs; returns (records, restore)."""
    orig, records = moe_mod.route, []

    def recording(*args, **kw):
        r = orig(*args, **kw)
        records.append((r["gate_idx"].cpu(), r["probs"].cpu()))
        return r

    moe_mod.route = recording

    def restore():
        moe_mod.route = orig
    return records, restore


def routing_flips(records, n_moe: int, tag: str, shown: int = 8) -> int:
    """Print where decode's MoE routing differs from the prefill's over
    the first N_DECODE positions, from `_routings` records of one counted
    prefill, a timed one and N_DECODE decode steps at batch 1, each
    calling `n_moe` MoE layers in order; returns the count of (position,
    layer) pairs that differ."""
    check(len(records) == (2 + N_DECODE) * n_moe,
          f"{len(records)} MoE calls recorded, want {(2 + N_DECODE) * n_moe}")
    flips = 0
    for t in range(N_DECODE):
        for layer in range(n_moe):
            pre_idx, pre_probs = records[layer]
            idx, probs = records[(2 + t) * n_moe + layer]
            a, b = sorted(pre_idx[0, t].tolist()), sorted(idx[0, 0].tolist())
            if a == b:
                continue
            flips += 1
            if flips <= shown:
                pa, pb = pre_probs[0, t], probs[0, 0]
                log(f"[{tag}] MoE routing differs at position {t}, layer "
                    f"{layer}: prefill experts {a} (probs "
                    f"{pa[a].tolist()}), decode {b} (probs {pb[b].tolist()})")
    log(f"[{tag}] MoE routing, prefill vs decode over {N_DECODE} positions "
        f"x {n_moe} layers: {flips} (position, layer) pairs differ")
    return flips


def phase11_jamba(torch, dev) -> dict:
    """The hybrid path at full width, cut in depth: prefill (counted),
    decode tied to it, greedy serving, timings and a profiled prefill."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.kernels.ssm_scan import (ssm_scan, ssm_scan_cost,
                                              ssm_scan_plain)
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import moe as moe_mod
    arch, batch, seq = JAMBA
    cfg = dataclasses.replace(get_arch(arch), n_layers=2, attn_every=2)
    torch.cuda.reset_peak_memory_stats()
    model = build_full_width(torch, cfg, dev, tag="11")

    # ---- prefill (counted) and 64 decode steps tied to it
    records, restore = _routings(moe_mod)
    try:
        pre = phase8_prefill(torch, model, batch, seq, dev,
                             check_logits=False, tag="11")
    finally:
        restore()
    check(pre["counts"] == {"flash_attention": 1, "rwkv6_scan": 0,
                            "ssm_scan": 1},
          f"{arch} prefill launches {pre['counts']}, want flash_attention "
          f"x1 and ssm_scan x1")
    routing_flips(records, 1, "11")
    e_dec = hold(torch.as_tensor(pre["decoded"]),
                 torch.as_tensor(pre["head"]), DECODE_TOL,
                 f"{arch}: decode vs prefill logits")

    # ---- greedy serving at batch 4 (prefills by decode steps)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 32)), device=dev)
    flash_attention.launches = rwkv6_scan.launches = ssm_scan.launches = 0
    srv = greedy_generate(model, prompts, 16)
    srv_counts = (flash_attention.launches, ssm_scan.launches)
    check(srv["tokens"].shape == (4, 16),
          f"serve tokens {srv['tokens'].shape}")
    log(f"[11] serve {arch} cut batch 4 prompt 32 gen 16: tokens "
        f"{srv['tokens'].shape}, TTFT {srv['ttft_s'] * 1e3:.1f} ms, TPOT "
        f"{srv['tpot_s'] * 1e3:.2f} ms; launches (flash, ssm) {srv_counts} "
        f"(prefill by decode steps); first row "
        f"{srv['tokens'][0][:8].tolist()}")

    # ---- profiled prefill
    saved = (flash_attention.launches, ssm_scan.launches)
    toks = pre["toks"]
    step = make_prefill_step(model)
    profile_device(torch, lambda: step({"tokens": toks}), "11",
                   f"one {arch} cut prefill (B {batch}, S {seq})", "_fwd")
    flash_attention.launches, ssm_scan.launches = saved
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[11] peak device memory over the phase: {peak:.1f} GiB")
    del model, step, toks
    torch.cuda.empty_cache()

    # ---- kernel timings at the prefill's shapes
    saved = (flash_attention.launches, ssm_scan.launches)
    out = {"prefill": pre, "decode_err": e_dec, "serve": srv}
    b, t, d, n = batch, seq, 2 * cfg.d_model, cfg.d_state
    for dn, dt in _dtypes(torch).items():
        args = ssm_inputs(torch, b, t, d, n, dt, dev, seed=1)
        k_ms = kernel_ms(torch, lambda: ssm_scan(*args), iters=20)
        e = hold(ssm_scan(*args), ssm_scan_plain(*args), SSM_TOL[dn],
                 f"ssm_scan {dn} (timed)")
        p_ms = time_ms(torch, lambda: ssm_scan_plain(*args), warm=1,
                       iters=1)
        ops, nbytes, exps = ssm_scan_cost(b, t, d, n, args[0].element_size())
        t_ops = ops / PEAK_FP32_PER_S * 1e3     # the recurrence is fp32 math
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_exp = exps / (16 * 132 * 1.98e9) * 1e3     # SFU: 16/clock/SM
        out[("ssm_scan", dn)] = {
            "ms": k_ms, "plain_ms": p_ms, "library_ms": None,
            "bound_ms": max(t_ops, t_bytes), "max_abs_err": e,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        t_issue = exps / 32 * 12 / (528 * 1.98e9) * 1e3
        log(f"[11] ssm_scan {dn} B={b} T={t} D={d} N={n}: kernel "
            f"{k_ms:.4f} ms ({k_ms / t * 1e6:.1f} ns per step), the "
            f"earlier 4-states-a-lane kernel {SSM_EARLIER_MS[dn]} ms in "
            f"earlier runs; plain {p_ms:.1f} ms, "
            f"bound {max(t_ops, t_bytes):.4f} ms ({nbytes / 1e6:.1f} MB at "
            f"3.35 TB/s; {ops / 1e9:.2f} GFLOP at 67 TFLOP/s: "
            f"{t_ops:.4f} ms), {max(t_ops, t_bytes) / k_ms:.1%} of it; "
            f"{exps / 1e9:.3f} G exps on the SFU at 16/clock/SM, 1.98 GHz: "
            f"{t_exp:.4f} ms; issue slots at 12 warp instructions per 32 "
            f"state-steps, one a clock on 528 schedulers: {t_issue:.4f} ms; "
            f"no single PyTorch call computes it")
        del args
    out.update({("flash_attention_hd128", dn): row for dn, row in
                time_flash_attention(torch, dev, JAMBA_FA, "11").items()})
    flash_attention.launches, ssm_scan.launches = saved
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------ remaining LM families
VLM = ("internvl2-2b", 1, 4096)                     # arch, batch, seq
QWEN_MOE = ("qwen2-moe-a2.7b", 1, 4096)
ARCTIC = ("arctic-480b", 1, 4096)                   # cut to n_layers 1
WHISPER = ("whisper-medium", 8, 448)                # the decoder's context
# internvl2's stub image: up to 12 tiles and a thumbnail of 256 patch
# embeddings each (the model card's dynamic tiling), before the prompt
VLM_PATCH_ROWS = 13 * 256
# flash_attention launches per prefill: one per causal self-attention
# layer at S > 2048 (whisper's decoder runs at 448; its encoder and its
# cross-attention are not causal)
PHASE15_LAUNCHES = {"internvl2-2b": 24, "qwen2-moe-a2.7b": 24,
                    "arctic-480b": 1, "whisper-medium": 0}
# the shapes flash_attention meets there (B, S, H, KVH, hd): internvl2
# (GQA 16/8), qwen2-moe (MHA 16/16) and arctic (a group of 7, 56/8)
PHASE15_FA = ((1, 4096, 16, 8, 128), (1, 4096, 16, 16, 128),
              (1, 4096, 56, 8, 128))


def _moe_prefill(torch, model, dev, arch_seq, tag: str) -> dict:
    """phase8_prefill of an MoE model with its routings recorded: the
    flips printed, then decode held to the prefill at DECODE_TOL."""
    from repro_torch.models import moe as moe_mod
    _, batch, seq = arch_seq
    records, restore = _routings(moe_mod)
    try:
        pre = phase8_prefill(torch, model, batch, seq, dev,
                             check_logits=False, tag=tag)
    finally:
        restore()
    pre["flips"] = routing_flips(records, model.cfg.n_layers, tag)
    pre["decode_err"] = hold(torch.as_tensor(pre["decoded"]),
                             torch.as_tensor(pre["head"]), DECODE_TOL,
                             f"{model.cfg.name}: decode vs prefill logits")
    return pre


def phase15_families(torch, dev) -> dict:
    """The moe, vlm and audio families at full width in fp32, weights from
    a seeded generator: internvl2-2b and qwen2-moe-a2.7b at full depth,
    arctic-480b cut to one layer, whisper-medium at full depth.  Prefills
    (counted), decode tied to them, serving, profiles, and flash_attention
    at the three new prefill shapes.  Returns the path's flash_attention
    launches and the kernel's rows at those shapes."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import greedy_generate, serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[15] device memory allocated at the start: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    launches, walls = {}, {}

    def want(name, counts):
        check(counts["flash_attention"] == PHASE15_LAUNCHES[name]
              and counts["rwkv6_scan"] == counts["ssm_scan"] == 0,
              f"{name} prefill launches {counts}, want flash_attention x"
              f"{PHASE15_LAUNCHES[name]} and no scan")

    def served(name, fn):
        """Greedy serving at batch 4, prompt 32, gen 16 through fn()."""
        flash_attention.launches = 0
        srv = fn()
        check(srv["tokens"].shape == (4, 16), f"{name} serve tokens "
              f"{srv['tokens'].shape}")
        log(f"[15] serve {name} batch 4 prompt 32 gen 16: tokens "
            f"{srv['tokens'].shape}, TTFT {srv['ttft_s'] * 1e3:.1f} ms, "
            f"TPOT {srv['tpot_s'] * 1e3:.2f} ms; flash_attention launches "
            f"{flash_attention.launches} (prefill by decode steps); first "
            f"row {srv['tokens'][0][:8].tolist()}")

    # ---- 15a. internvl2-2b: the token prefill, decode tied to it, then
    # the vlm input (stub patch rows and prompt embeddings)
    arch, batch, seq = VLM
    model = build_full_width(torch, arch, dev, tag="15")
    pre = phase8_prefill(torch, model, batch, seq, dev, tag="15")
    want(arch, pre["counts"])
    walls[arch] = pre["prefill_s"]
    toks = pre["toks"]
    g = torch.Generator(device=dev).manual_seed(15)
    patches = torch.randn((batch, VLM_PATCH_ROWS, model.cfg.d_model),
                          generator=g, device=dev) * 0.02
    embeds = torch.cat([patches, model.embed[toks[:, VLM_PATCH_ROWS:]]],
                       dim=1)
    prefill = make_prefill_step(model)
    flash_attention.launches = 0
    logits = prefill({"embeds": embeds})
    torch.cuda.synchronize()
    launches[arch] = flash_attention.launches
    check(launches[arch] == PHASE15_LAUNCHES[arch],
          f"{arch} embeds prefill launched flash_attention "
          f"{launches[arch]} times, want {PHASE15_LAUNCHES[arch]}")
    check(logits.shape == (batch, seq, model.cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"{arch} embeds prefill logits {tuple(logits.shape)} not finite")
    del logits
    t0 = time.perf_counter()
    prefill({"embeds": embeds})
    torch.cuda.synchronize()
    walls[arch + " embeds"] = time.perf_counter() - t0
    a = prefill({"tokens": toks})
    b = prefill({"embeds": model.embed[toks]})
    same = bool(torch.equal(a, b))
    del a, b
    check(same, f"{arch}: forward on the tokens' embeddings is not the "
          f"tokens' forward bit for bit")
    log(f"[15] {arch} prefill B={batch} S={seq} on embeds ({VLM_PATCH_ROWS} "
        f"stub patch rows at 0.02, then {seq - VLM_PATCH_ROWS} prompt "
        f"embeddings): flash_attention x{launches[arch]}, wall "
        f"{walls[arch + ' embeds']:.3f} s (second call); the tokens' "
        f"embeddings give the tokens' logits bit for bit")
    del model, prefill, embeds, patches, toks
    gc.collect()
    torch.cuda.empty_cache()
    served(arch, lambda: serve(arch, 4, 32, 16, smoke=False, seed=0,
                               device=dev))

    # ---- 15b. qwen2-moe-a2.7b: shared experts, 60 experts top-4
    arch, batch, seq = QWEN_MOE
    model = build_full_width(torch, arch, dev, tag="15")
    pre = _moe_prefill(torch, model, dev, QWEN_MOE, "15")
    want(arch, pre["counts"])
    launches[arch] = pre["counts"]["flash_attention"]
    walls[arch] = pre["prefill_s"]
    step = make_prefill_step(model)
    toks = pre["toks"]
    moe_shares = profile_device(
        torch, lambda: step({"tokens": toks}), "15",
        f"one {arch} prefill (B {batch}, S {seq})", "fa_fwd",
        ranges=[(moe_mod, "moe_block", "moe_block", None),
                (moe_mod, "mlp", "moe.shared", None)],
        ops_under=[("moe_block", "aten::einsum")])
    del model, step, toks
    gc.collect()
    torch.cuda.empty_cache()
    served(arch, lambda: serve(arch, 4, 32, 16, smoke=False, seed=0,
                               device=dev))

    # ---- 15c. arctic-480b cut to one layer: the dense residual beside
    # 128 experts top-2, attention at a group of 7
    arch, batch, seq = ARCTIC
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_arch(arch), n_layers=1)
    model = build_full_width(torch, cfg, dev, tag="15")
    pre = _moe_prefill(torch, model, dev, ARCTIC, "15")
    want(arch, pre["counts"])
    launches[arch] = pre["counts"]["flash_attention"]
    walls[arch] = pre["prefill_s"]
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 32)), device=dev)
    served(arch + " cut", lambda: greedy_generate(model, prompts, 16))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[15] {arch} cut: peak device memory {peak:.1f} GiB")
    del model, prompts
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 15d. whisper-medium: 30 s of frames, teacher-forced decoder
    arch, batch, seq = WHISPER
    model = build_full_width(torch, arch, dev, tag="15")
    g = torch.Generator(device=dev).manual_seed(15)
    frames = torch.randn((batch, model.cfg.enc_ctx, model.cfg.d_model),
                         generator=g, device=dev)
    pre = phase8_prefill(torch, model, batch, seq, dev, tag="15",
                         frames=frames)
    want(arch, pre["counts"])
    launches[arch] = pre["counts"]["flash_attention"]
    walls[arch] = pre["prefill_s"]
    with torch.no_grad():
        model.encode(frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = model.encode(frames[:4])
        torch.cuda.synchronize()
    log(f"[15] {arch} encoder alone, B 4, {model.cfg.enc_ctx} frames: "
        f"{time.perf_counter() - t0:.3f} s")
    enc_ctx = model.cfg.enc_ctx
    xattn = profile_decode_step(
        torch, model, 4, "15", enc_out=enc,
        ranges=[(attn_mod, "attention_block", "xattn", None),
                (attn_mod, "linear", "xattn.kv_proj",
                 lambda p, x: x.shape[-2] == enc_ctx)],
        ops_under=[("xattn.kv_proj", "aten::matmul")])
    del model, frames, enc
    gc.collect()
    torch.cuda.empty_cache()
    served(arch, lambda: serve(arch, 4, 32, 16, smoke=False, seed=0,
                               device=dev))

    # ---- 15e. flash_attention at the three new prefill shapes
    fa = {shape: time_flash_attention(torch, dev, shape, "15")
          for shape in PHASE15_FA}
    log(f"[15] prefill wall (second call): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()))
    log(f"[15] flash_attention launches per prefill: {launches}; MoE "
        f"shares of qwen2-moe's prefill device time {moe_shares}; "
        f"cross-attention shares of a whisper decode step {xattn}")
    log(f"[15] phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": sum(launches.values()), "fa": fa}


# ------------------------------------------------------------- zoo slice
ZOO_BATCHES = (1, 255, 256, 4_096, SWEEP_CHUNK)
ZOO_TIMED = (4_096, SWEEP_CHUNK)
ZOO_COUNTS = {"scenarios": 10, "workloads": 20, "rows": 351, "unique": 230}
ZOO_LOOP_PAIR = ("llama3.2-1b:prefill", "llama3.2-1b:decode")
ZOO_STALL_TOPK = 8
SWEEP_FIELDS = ("n_evaluated", "n_superior", "pareto_y", "pareto_ids",
                "topk_val", "topk_ids", "stall_topk_val", "stall_topk_ids",
                "archive_truncated", "ref_point")


def same_sweep(a, b, what: str, fields=SWEEP_FIELDS) -> None:
    """Fail unless two SweepResults agree exactly on `fields` (and, for
    portfolio results, in every scenario)."""
    for f in fields:
        va, vb = getattr(a, f), getattr(b, f)
        ok = (np.array_equal(va, vb) if isinstance(vb, np.ndarray)
              else va == vb)
        check(ok, f"{what}: {f} differs")
    if b.per_scenario is not None:
        check(a.scenario_names == b.scenario_names, f"{what}: scenarios")
        for nm in b.scenario_names:
            same_sweep(a.scenario(nm), b.scenario(nm), f"{what} [{nm}]",
                       fields)


def phase12_zoo(torch, dev, work_dir: str) -> dict:
    """The zoo-suite portfolio path at full width: the ten published
    configs at zoo_suite's defaults (batch 8, seq 2048, tp 8, decode at KV
    3,072), nothing cut.  Returns the phase's ppa_eval launches on the
    path and the 20-table launch's timings."""
    import shutil

    from repro_torch.core.loop import LuminaDSE
    from repro_torch.kernels.ppa_eval import (KernelTables, kernel_tables,
                                              ppa_eval, ppa_eval_op_count,
                                              ppa_eval_plain,
                                              ppa_eval_workloads)
    from repro_torch.kernels.ppa_eval import bench as ppa_bench
    from repro_torch.perfmodel import (OracleEvaluator, SweepEngine,
                                       WorkloadStack, get_evaluator,
                                       pair_view, zoo_suite)
    from repro_torch.perfmodel.designspace import SPACE
    from repro_torch.perfmodel.evaluator import EvalRequest
    t_phase = time.perf_counter()
    out = {"launches": 0, "max_abs_err": 0.0}

    # ---- 12a. the suite
    wls, scen = zoo_suite()
    counts = {"scenarios": len(scen), "workloads": len(wls),
              "rows": sum(len(w.ops) for w in wls.values()),
              "unique": WorkloadStack.build(wls).n_unique}
    check(counts == ZOO_COUNTS, f"zoo suite {counts}, want {ZOO_COUNTS}")
    log(f"[12a] zoo suite: {counts['scenarios']} scenarios, "
        f"{counts['workloads']} workloads, {counts['rows']} op rows, "
        f"{counts['unique']} unique stack rows")
    for s in scen:
        log(f"[12a]   {s.name}: rows prefill {len(wls[s.prefill].ops)} / "
            f"decode {len(wls[s.decode].ops)}")

    # ---- 12b. the kernel on the 20 tables, bit for bit
    tables = kernel_tables(list(wls.values()), dev)
    for b in ZOO_BATCHES:
        batches = ppa_bench.design_batches(b, dev)
        for what, dv in batches.items():
            lat, area, stall = ppa_eval_workloads(dv, tables)
            for w, (tab, tp) in enumerate(tables.unpack()):
                got = torch.cat([lat[w][:, None], stall[w], area[:, None]],
                                dim=1)
                single = ppa_eval(dv, tab, tp)[:, :6]
                plain = ppa_eval_plain(dv, tab, tp)[:, :6]
                out["max_abs_err"] = max(out["max_abs_err"], float(
                    (got - plain).abs().max()))
                check(torch.equal(got, single) and torch.equal(got, plain),
                      f"ppa_eval zoo B={b} {what}: workload {w} differs "
                      f"from its single-table launch or the plain version")
        log(f"[12b] ppa_eval 20 zoo tables in one launch B={b}: bitwise "
            f"equal to the 20 single-table launches and the plain version "
            f"({', '.join(batches)})")

    # ---- 12c. the zoo evaluator: one dispatch, one launch
    ev_k = get_evaluator("proxy", "cuda", suite="zoo")
    ev_r = get_evaluator("proxy", "roofline", suite="zoo")
    check(ev_k.backend == "cuda" and ev_r.backend == "roofline"
          and ev_r.stacked, f"zoo backends {ev_k.backend}/{ev_r.backend}")
    idx = SPACE.sample(np.random.default_rng(7), 4096)
    ev_k.objectives(idx[:8])                           # tables to the card
    ppa_eval.launches = 0
    d0 = ev_k.dispatches
    yk = ev_k.objectives(idx)
    n_launch = ppa_eval.launches
    out["launches"] += n_launch
    check(ev_k.dispatches == d0 + 1 and n_launch == 1,
          f"zoo objectives: {ev_k.dispatches - d0} dispatches, {n_launch} "
          f"ppa_eval launches; want one each")
    yr = ev_r.objectives(idx)
    check(yk.shape == (4096, 21), f"zoo objectives shape {yk.shape}")
    for j in range(20):
        np.testing.assert_allclose(yk[:, j], yr[:, j], rtol=TOL_LAT_RTOL,
                                   err_msg=f"zoo evaluator {ev_k.workloads[j]}")
    np.testing.assert_allclose(yk[:, 20], yr[:, 20], rtol=TOL_AREA_RTOL,
                               err_msg="zoo evaluator area")
    d0 = ev_r.dispatches
    rep = ev_r.evaluate(EvalRequest(idx, detail="stalls"))
    check(ev_r.dispatches == d0 + 1, "zoo stalls evaluate: one dispatch")
    check(all(np.isfinite(rep.stall[w]).all() and rep.stall[w].shape
              == (4096, 4) for w in ev_r.workloads), "zoo stalls malformed")
    log(f"[12c] zoo evaluator 4096 designs: cuda (1 dispatch, {n_launch} "
        f"ppa_eval launch) vs roofline (stacked torch ops) max rel latency "
        f"{max(max_rel(yk[:, j], yr[:, j]) for j in range(20)):.3g}, area "
        f"{max_rel(yk[:, 20], yr[:, 20]):.3g}, bitwise "
        f"{np.array_equal(yk, yr)}; stalls evaluate one dispatch, finite")

    # ---- 12d. the portfolio sweep over the full space
    eng_p = SweepEngine(ev_r, stall_topk=ZOO_STALL_TOPK, robust="worst")
    check(eng_p._portfolio and eng_p.backend == "roofline",
          "the zoo sweep did not take the portfolio path")
    eng_p.run(0, 2 * eng_p.chunk_size)                 # warm-up
    res = eng_p.run()
    check(res.n_evaluated == SPACE.size,
          f"portfolio n_eval {res.n_evaluated} != {SPACE.size}")
    n_chunks = -(-SPACE.size // eng_p.chunk_size)
    for nm, r in [("robust", res)] + [(s.name, res.scenario(s.name))
                                      for s in scen]:
        check(not r.archive_truncated, f"portfolio {nm}: archive truncated")
        check(len(r.pareto_ids) > 0 and np.isfinite(r.pareto_y).all(),
              f"portfolio {nm}: empty or non-finite front")
        log(f"[12d] portfolio {nm}: n_superior {r.n_superior} front "
            f"{len(r.pareto_ids)} (the one sweep's wall {res.seconds:.3f} s, "
            f"{res.points_per_sec:,.0f} designs/s)")
    log(f"[12d] portfolio sweep, 10 scenarios + robust (worst), stall_topk "
        f"{ZOO_STALL_TOPK}: n_eval {res.n_evaluated} wall {res.seconds:.3f} "
        f"s {res.points_per_sec:,.0f} designs/s; chunk {eng_p.chunk_size} "
        f"x {n_chunks} chunks")
    out["sweep_s"], out["sweep_pps"] = res.seconds, res.points_per_sec

    # ---- 12e. each scenario's pair sweep equals its portfolio result
    pair_kw = dict(stall_topk=ZOO_STALL_TOPK)
    fronts = {}
    for s in scen:
        names = (s.prefill, s.decode)
        eng_k = SweepEngine(pair_view(ev_k, names), **pair_kw)
        check(eng_k.backend == "cuda" and not eng_k._portfolio,
              f"{s.name}: pair sweep not on the kernel")
        ppa_eval.launches = 0
        rk = eng_k.run()
        n_launch = ppa_eval.launches
        out["launches"] += n_launch
        want = -(-SPACE.size // eng_k.chunk_size)
        check(n_launch == want, f"{s.name}: {n_launch} ppa_eval launches "
              f"for {want} chunks")
        rr = SweepEngine(pair_view(ev_r, names), **pair_kw).run()
        same_sweep(rk, res.scenario(s.name), f"{s.name} kernel pair sweep")
        same_sweep(rr, res.scenario(s.name), f"{s.name} torch pair sweep")
        fronts[s.name] = rk
        log(f"[12e] {s.name}: pair sweeps on the kernel ({n_launch} "
            f"launches, {rk.seconds:.3f} s) and on torch ops "
            f"({rr.seconds:.3f} s) equal the portfolio's scenario exactly "
            f"(n_superior {rk.n_superior}, top-k, stall seeds, front of "
            f"{len(rk.pareto_ids)})")

    # ---- 12f. workers, resume and the store over the first 8 chunks
    stop = 8 * eng_p.chunk_size
    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    try:
        one = eng_p.run(0, stop)
        t0 = time.perf_counter()
        two = eng_p.run(0, stop, workers=2)
        t_two = time.perf_counter() - t0
        same_sweep(two, one, "portfolio workers=2")
        ck = os.path.join(work_dir, "ck")
        eng_p.run(0, stop // 2, checkpoint_path=ck)
        resumed = eng_p.run(0, stop, resume_from=ck)
        same_sweep(resumed, one, "portfolio resumed")
        store = os.path.join(work_dir, "store")
        kw = {"stall_topk": ZOO_STALL_TOPK}
        t0 = time.perf_counter()
        first = OracleEvaluator(ev_r, stop=stop, oracle_store=store,
                                sweep_kwargs=kw).sweep_result()
        t_sweep = time.perf_counter() - t0
        check(len(os.listdir(store)) == 1, "the store holds no artifact")
        t0 = time.perf_counter()
        loaded = OracleEvaluator(ev_r, stop=stop, oracle_store=store,
                                 sweep_kwargs=kw).sweep_result()
        t_load = time.perf_counter() - t0
        same_sweep(first, one, "oracle store (swept)")
        same_sweep(loaded, one, "oracle store (loaded)")
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    log(f"[12f] first 8 portfolio chunks ({stop} ids): workers=2 "
        f"({t_two:.3f} s) == one process ({one.seconds:.3f} s); stopped at "
        f"4 chunks and resumed == fresh; oracle store: swept and stored "
        f"{t_sweep:.3f} s, loaded without sweeping {t_load:.3f} s, equal")

    # ---- 12g. the loop on one zoo scenario
    view = pair_view(ev_k, ZOO_LOOP_PAIR)
    scen_name = ZOO_LOOP_PAIR[0].split(":")[0]
    ppa_eval.launches = 0
    d0 = view.dispatches
    t0 = time.perf_counter()
    dse = LuminaDSE(view, seed=0)
    res_l = dse.run(budget=20)
    loop_s = time.perf_counter() - t0
    n_launch = ppa_eval.launches
    out["launches"] += n_launch
    check(len(res_l.samples) == 20, f"{len(res_l.samples)} samples")
    check(n_launch > 0, "the zoo LUMINA run never launched ppa_eval")
    nphv = OracleEvaluator(view, result=fronts[scen_name]).normalized_phv(
        res_l.phv, dse.ref_point)
    check(np.isfinite(res_l.phv) and 0.0 <= nphv <= 1.0 + 1e-9,
          f"zoo loop phv {res_l.phv} normalized {nphv}")
    log(f"[12g] LUMINA budget 20 on {scen_name}'s pair: superior_count "
        f"{res_l.superior_count} normalized_phv {nphv:.6f} dispatches "
        f"{view.dispatches - d0} wall {loop_s:.3f} s ppa_eval launches "
        f"{n_launch}")

    # ---- 12h. the 20-table launch against its bound, and a profile
    saved = ppa_eval.launches
    n_ops = tables.ends[-1]
    op_count = ppa_eval_op_count(*[t.cpu().numpy()
                                   for t, _ in tables.unpack()])
    singles = [KernelTables.pack([p]) for p in tables.unpack()]
    for b in ZOO_TIMED:
        dv = SPACE.decode_values(torch.as_tensor(
            SPACE.sample(np.random.default_rng(1), b), device=dev))
        floor_ms = kernel_ms(torch, ppa_bench.floor_launcher(b))
        k_ms = kernel_ms(torch, lambda: ppa_eval_workloads(dv, tables))
        s_ms = kernel_ms(torch, lambda: [ppa_eval_workloads(dv, t)
                                         for t in singles], iters=10)
        lat, area, stall = ppa_eval_workloads(dv, tables)
        for w, (tab, tp) in enumerate(tables.unpack()):
            plain = ppa_eval_plain(dv, tab, tp)
            check(torch.equal(lat[w], plain[:, 0])
                  and torch.equal(stall[w], plain[:, 1:5])
                  and torch.equal(area, plain[:, 5]),
                  f"ppa_eval zoo B={b} (timed): workload {w} not bitwise "
                  f"equal to the plain version")
        p_ms = time_ms(torch, lambda: [ppa_eval_plain(dv, t, tp)
                                       for t, tp in tables.unpack()],
                       warm=1, iters=2)
        nbytes = (b * 8 + len(tables) * b * 8 + n_ops * 8) * 4
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = b * op_count / PEAK_FP32_PER_S * 1e3
        out[("zoo", b)] = {"ms": k_ms, "plain_ms": p_ms, "floor_ms": floor_ms,
                           "singles_ms": s_ms, "bound_ms": max(t_bytes, t_ops),
                           "bound_by": ("bytes" if t_bytes >= t_ops
                                        else "operations")}
        log(f"[12h] ppa_eval 20 zoo tables B={b} ({n_ops} rows): one launch "
            f"{k_ms:.5f} ms, the 20 single-table launches {s_ms:.5f} ms, "
            f"plain {p_ms:.3f} ms, bound {max(t_bytes, t_ops):.5f} ms "
            f"(bytes {nbytes} B: {t_bytes:.5f} ms; {b * op_count} fp32 ops: "
            f"{t_ops:.5f} ms), {max(t_bytes, t_ops) / k_ms:.1%} of it; "
            f"empty-kernel floor {floor_ms:.5f} ms")
    ppa_eval.launches = saved          # timing launches are not the path's
    profile_device(torch, lambda: eng_p.run(0, 4 * eng_p.chunk_size), "12h",
                   "4 portfolio chunks (torch ops)")
    ppa_eval.launches = saved
    log(f"[12] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return out


# ------------------------------------------------------ method comparison
# the reference bench's settings (benchmarks/bench_dse_methods.py,
# bench_campaigns.py, bench_dse_benchmark.py)
METHOD_BUDGET, METHOD_TRIALS, METHOD_BATCH = 300, 3, 8
CAMPAIGN_BUDGET = 60
TABLE3_SIZES = (308, 127, 30)
TABLE3_CHECK_SIZES = (80, 40, 20)
PAPER_PHV_GAIN_PCT, PAPER_EFF_GAIN_X = 32.9, 17.5
METHOD_ARRAYS = ("X", "Y", "phv_curve")


def _same_method(a, b, what: str) -> None:
    for f in METHOD_ARRAYS:
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"{what}: {f} differs between the cuda and roofline backends")
    check(a.superior_count == b.superior_count and a.phv == b.phv,
          f"{what}: superior_count/phv differ between the backends")


def _same_dse(a, b, what: str) -> None:
    check(np.array_equal(np.stack([s.idx for s in a.samples]),
                         np.stack([s.idx for s in b.samples]))
          and np.array_equal(np.stack([s.objectives for s in a.samples]),
                             np.stack([s.objectives for s in b.samples]))
          and a.superior_count == b.superior_count and a.phv == b.phv
          and a.trajectory_notes == b.trajectory_notes,
          f"{what}: the LUMINA trajectory differs between the cuda and "
          f"roofline backends")


def _table3_backends():
    from repro_torch.core.llm import DegradedOracle, RuleOracle
    return [RuleOracle(enhanced=True), RuleOracle(enhanced=False),
            DegradedOracle(0.18, seed=0, enhanced=True, name="qwen3-proxy"),
            DegradedOracle(0.30, seed=1, enhanced=True, name="phi4-proxy"),
            DegradedOracle(0.50, seed=2, enhanced=False,
                           name="llama31-proxy")]


def phase13_methods(torch, dev, res_k, smi: str, work_dir: str) -> dict:
    """The paper's method comparison on the card: the five black-box
    baselines and LUMINA (Figs. 4-6), sweep-seeded campaigns, the DSE
    Benchmark (Table 3) and the rule audit, every evaluation through the
    evaluator, with phase 4's kernel sweep as the oracle front.  Returns
    the phase's ppa_eval launches on the path and the B 8 timings."""
    import shutil

    from repro_torch.core.baselines import METHODS, run_method
    from repro_torch.core.bench import accuracy_table, generate_suite
    from repro_torch.core.campaign import CampaignRunner, load_telemetry
    from repro_torch.core.loop import LuminaDSE
    from repro_torch.core.quale import static_influence_map
    from repro_torch.kernels.ppa_eval import (kernel_tables, ppa_eval,
                                              ppa_eval_workloads)
    from repro_torch.kernels.ppa_eval import bench as ppa_bench
    from repro_torch.perfmodel import (ModelEvaluator, OracleEvaluator,
                                       get_evaluator)
    from repro_torch.perfmodel.designspace import A100_REFERENCE, SPACE
    t_phase = time.perf_counter()
    out = {"launches": 0}
    ev_k = get_evaluator("proxy", backend="cuda", device=dev)
    ev_r = get_evaluator("proxy", backend="roofline", device=dev)
    oracle = OracleEvaluator(ev_k, result=res_k)
    a100 = SPACE.encode_nearest(A100_REFERENCE)[None, :]
    ref = ev_k.objectives(a100)[0]
    check(np.array_equal(ref, ev_r.objectives(a100)[0]),
          "the A100 reference point differs between the backends")

    # ---- 13a. Figs. 4-6: five baselines and LUMINA, budget 300, 3 trials
    per_trial = -(-METHOD_BUDGET // METHOD_BATCH)
    stats = {}
    for name, cls in METHODS.items():
        phvs, effs, sups, walls, walls_r = [], [], [], [], []
        for trial in range(METHOD_TRIALS):
            ppa_eval.launches = 0
            d0 = ev_k.dispatches
            t0 = time.perf_counter()
            r = run_method(cls, ev_k, METHOD_BUDGET, ref, seed=trial,
                           batch=METHOD_BATCH)
            walls.append(time.perf_counter() - t0)
            n_launch = ppa_eval.launches
            out["launches"] += n_launch
            check(n_launch == per_trial and ev_k.dispatches - d0 == per_trial,
                  f"{name} trial {trial}: {n_launch} ppa_eval launches, "
                  f"{ev_k.dispatches - d0} dispatches, want {per_trial} "
                  f"(one per ask batch of {METHOD_BATCH})")
            t0 = time.perf_counter()
            r_r = run_method(cls, ev_r, METHOD_BUDGET, ref, seed=trial,
                             batch=METHOD_BATCH)
            walls_r.append(time.perf_counter() - t0)
            _same_method(r, r_r, f"{name} trial {trial}")
            check(r.X.shape == (METHOD_BUDGET, SPACE.n_params)
                  and np.isfinite(r.Y).all() and r.phv >= 0,
                  f"{name} trial {trial}: malformed result")
            phvs.append(r.phv)
            effs.append(r.sample_efficiency)
            sups.append(r.superior_count)
        stats[name] = (phvs, effs)
        log(f"[13a] {name}: phv mean {np.mean(phvs):.6e} (oracle fraction "
            f"{oracle.normalized_phv(np.mean(phvs), ref):.6f}), sample "
            f"efficiency {np.mean(effs):.6f}, superior mean "
            f"{np.mean(sups):.1f}, best/worst phv "
            f"{max(phvs) / max(min(phvs), 1e-12):.3f}; wall per trial "
            f"cuda {np.mean(walls):.3f} s, roofline {np.mean(walls_r):.3f} s "
            f"({per_trial} launches a trial; equal trajectories) ({smi})")
    phvs, effs, sups, walls, curves = [], [], [], [], []
    for trial in range(METHOD_TRIALS):
        best = np.full(3, np.inf)
        curve = []

        def track(campaign, sample, _best=best, _curve=curve):
            np.minimum(_best, sample.objectives, out=_best)
            _curve.append(oracle.regret(_best[None, :]))

        ppa_eval.launches = 0
        t0 = time.perf_counter()
        res = LuminaDSE(ev_k, seed=trial).run(budget=METHOD_BUDGET,
                                              step_callback=track)
        walls.append(time.perf_counter() - t0)
        n_launch = ppa_eval.launches
        out["launches"] += n_launch
        check(n_launch > 0, f"LUMINA trial {trial} never launched ppa_eval")
        _same_dse(res, LuminaDSE(ev_r, seed=trial).run(budget=METHOD_BUDGET),
                  f"LUMINA trial {trial}")
        curves.append(np.stack(curve))
        phvs.append(res.phv)
        effs.append(res.sample_efficiency)
        sups.append(res.superior_count)
    log(f"[13a] LUMINA: phv mean {np.mean(phvs):.6e} (oracle fraction "
        f"{oracle.normalized_phv(np.mean(phvs), ref):.6f}), sample "
        f"efficiency {np.mean(effs):.6f}, superior mean {np.mean(sups):.1f}, "
        f"best/worst phv {max(phvs) / max(min(phvs), 1e-12):.3f}; wall per "
        f"trial cuda {np.mean(walls):.3f} s (equal trajectories on "
        f"roofline) ({smi})")
    mean_regret = np.mean(np.stack(curves), axis=0)
    for frac in (0.25, 0.5, 1.0):
        i = max(0, int(round(frac * METHOD_BUDGET)) - 1)
        log(f"[13a] LUMINA regret at {int(frac * 100)}% of the budget "
            f"(ttft|tpot|area): "
            + "|".join(f"{v:.6f}" for v in mean_regret[i]))
    best_phv = max(np.mean(p) for p, _ in stats.values())
    best_eff = max(np.mean(e) for _, e in stats.values())
    log(f"[13a] LUMINA vs the best baseline: phv gain "
        f"{(np.mean(phvs) / max(best_phv, 1e-12) - 1) * 100:.1f}% (paper "
        f"+{PAPER_PHV_GAIN_PCT}%), sample-efficiency gain "
        f"{np.mean(effs) / max(best_eff, 1e-9):.1f}x (paper "
        f"{PAPER_EFF_GAIN_X}x); oracle phv {oracle.oracle_phv(ref):.6e}")

    # the baselines' launch shape: one evaluator dispatch at B 8
    X8 = SPACE.sample(np.random.default_rng(8), METHOD_BATCH)
    dv8 = SPACE.decode_values(torch.as_tensor(X8, device=dev))
    pair = kernel_tables(list(ev_k.models[nm].wl for nm in ev_k.workloads),
                         dev)
    saved = ppa_eval.launches
    k8 = kernel_ms(torch, lambda: ppa_eval_workloads(dv8, pair))
    f8 = kernel_ms(torch, ppa_bench.floor_launcher(METHOD_BATCH))
    t_disp = {}
    for nm, ev in (("cuda", ev_k), ("roofline", ev_r)):
        ev.objectives(X8)
        t0 = time.perf_counter()
        for _ in range(200):
            ev.objectives(X8)
        t_disp[nm] = (time.perf_counter() - t0) / 200 * 1e3
    ppa_eval.launches = saved          # timing launches are not the path's
    out.update(b8_ms=k8, b8_floor_ms=f8)
    log(f"[13a] ppa_eval at B {METHOD_BATCH} (both tables, one launch): "
        f"{k8:.5f} ms, empty-kernel floor {f8:.5f} ms; one objectives "
        f"dispatch from the host: cuda {t_disp['cuda']:.4f} ms, roofline "
        f"(torch ops) {t_disp['roofline']:.4f} ms ({smi})")

    # ---- 13b. sweep-seeded campaigns, both policies, budget 60
    os.makedirs(work_dir, exist_ok=True)
    try:
        seeds = res_k.stall_seeds()
        for policy in ("uniform", "adaptive"):
            runs, walls = {}, {}
            for nm, ev in (("cuda", ev_k), ("roofline", ev_r)):
                proxy = ModelEvaluator(ev.models, backend=ev.backend,
                                       device=dev)
                ppa_eval.launches = 0
                t0 = time.perf_counter()
                runs[nm] = CampaignRunner(
                    ev, proxy=proxy, oracle=oracle, seed=0,
                    policy=policy).run(budget=CAMPAIGN_BUDGET, seeds=seeds)
                walls[nm] = time.perf_counter() - t0
                if nm == "cuda":
                    n_launch = ppa_eval.launches
                    out["launches"] += n_launch
            c, r = runs["cuda"], runs["roofline"]
            k = len(c.per_campaign)
            check(c.dispatches <= CAMPAIGN_BUDGET / k + 4,
                  f"campaigns {policy}: {c.dispatches} dispatches for {k} "
                  f"campaigns at budget {CAMPAIGN_BUDGET}")
            check(len(c.telemetry) == CAMPAIGN_BUDGET,
                  f"campaigns {policy}: {len(c.telemetry)} observations")
            regret, frac = c.regret_curve(), c.phv_frac_curve()
            check((np.diff(regret, axis=0) <= 0).all(),
                  f"campaigns {policy}: the regret curve rises")
            check((np.diff(frac) >= 0).all(),
                  f"campaigns {policy}: the phv fraction falls")
            check(np.array_equal(np.stack([s.idx for s in c.samples]),
                                 np.stack([s.idx for s in r.samples]))
                  and [(t.campaign, t.step, t.objectives, t.regret)
                       for t in c.telemetry]
                  == [(t.campaign, t.step, t.objectives, t.regret)
                      for t in r.telemetry]
                  and c.phv == r.phv and c.dispatches == r.dispatches,
                  f"campaigns {policy}: the cuda and roofline runs differ")
            path = os.path.join(work_dir, f"campaigns_{policy}.json")
            c.save_telemetry(path)
            back = load_telemetry(path)
            check(back == json.loads(json.dumps(c.telemetry_dict()))
                  and back["version"] == 5 and back["rule_audit"]
                  and back["metrics"],
                  f"campaigns {policy}: the v5 telemetry does not load back "
                  f"equal")
            log(f"[13b] campaigns {policy}: {k} campaigns "
                f"({', '.join(sorted(c.per_campaign))}), superior "
                f"{c.superior_count}, phv fraction {frac[-1]:.6f}, regret "
                + "|".join(f"{v:.6f}" for v in regret[-1])
                + f", {c.rounds} rounds, {c.dispatches} fused dispatches, "
                f"ppa_eval launches {n_launch}, wall cuda "
                f"{walls['cuda']:.3f} s, roofline {walls['roofline']:.3f} s "
                f"(equal runs; v5 telemetry round trip equal) ({smi})")
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    # ---- 13c. Table 3: the DSE Benchmark at the paper's sizes
    t0 = time.perf_counter()
    suite = generate_suite(*TABLE3_SIZES, device=dev)
    gen_s = time.perf_counter() - t0
    check(len(suite.questions) == sum(TABLE3_SIZES),
          f"{len(suite.questions)} questions")
    for task, backend, acc in accuracy_table(_table3_backends(), suite):
        log(f"[13c] table 3 {task} / {backend}: {acc:.3f}")
    log(f"[13c] suite {'/'.join(map(str, TABLE3_SIZES))} generated on the "
        f"card in {gen_s:.3f} s ({smi})")
    small = {d: generate_suite(*TABLE3_CHECK_SIZES, device=d)
             for d in (dev, "cpu")}
    for i, (a, b) in enumerate(zip(small[dev].questions,
                                   small["cpu"].questions)):
        check(a.task == b.task and a.prompt == b.prompt
              and a.options == b.options and a.answer == b.answer,
              f"suite {TABLE3_CHECK_SIZES}: question {i} differs between "
              f"the card and the CPU")
    check(len(small[dev].questions) == len(small["cpu"].questions)
          == sum(TABLE3_CHECK_SIZES), "suite sizes differ")
    log(f"[13c] suite {'/'.join(map(str, TABLE3_CHECK_SIZES))}: the card's "
        f"equals the CPU's question for question, option for option, "
        f"answer for answer")

    # ---- 13d. the rule audit, and a budget-20 run on the static map
    imap = static_influence_map()
    log(f"[13d] static influence map: "
        f"{sum(len(v) for v in imap.metric_edges.values())} metric edges, "
        f"{sum(len(v) for v in imap.stall_edges.values())} stall edges "
        f"over {len(imap.metric_edges)} parameters")
    counts = LuminaDSE(ev_k, seed=0).rule_audit().counts()
    log(f"[13d] rule audit: {counts}")
    check(counts["metric_probe_only"] == 0,
          "rule audit: metric_probe_only is not empty")
    ppa_eval.launches = 0
    dse = LuminaDSE(ev_k, seed=0, imap=imap)
    res = dse.run(budget=20)
    n_launch = ppa_eval.launches
    out["launches"] += n_launch
    check(len(res.samples) == 20 and n_launch > 0,
          f"static-map run: {len(res.samples)} samples, {n_launch} launches")
    nphv = oracle.normalized_phv(res.phv, dse.ref_point)
    log(f"[13d] LUMINA budget 20 on the static map: superior_count "
        f"{res.superior_count} normalized_phv {nphv:.6f} ppa_eval launches "
        f"{n_launch}")
    log(f"[13] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return out


# ----------------------------------------------- fault-tolerant evaluation
PHASE14_ROWS = 65_536            # designs per sharded evaluate in 14a
PHASE14_SHARDINGS = (("inline", 2), ("inline", 4), ("thread", 2),
                     ("thread", 4), ("device", 2), ("device", 4),
                     ("process", 2))
EVAL_DETAILS = ("objectives", "ppa", "stalls")
CHAOS_TIMEOUT_S = 1.0            # 14b's shard deadline (a healthy shard: ms)
CHAOS_SWEEP_SEED, CHAOS_SWEEP_RATE, CHAOS_SWEEP_EVERY = 3, 0.25, 4
CHAOS_SWEEP_RETRIES = 8
CHAOS_CAMPAIGN_SEED = 11
PORTFOLIO_KILL_CHUNKS = 8
DISPATCH_B, DISPATCH_WORKERS, DISPATCH_CALLS = SWEEP_CHUNK, (1, 2, 4), 10
TIER_ROWS = {"interactive": 8, "batch": 1_024, "scavenger": 4_096}
TIER_TICK_ROWS = 8_192           # 14f's service burst: fresh rows per tick
# the reference's frozen EvalService.telemetry() keys (tests/test_obs.py),
# plus the runner's resubmission count
SERVICE_COUNTER_KEYS = frozenset(
    {"submits", "cache_hits", "fused_dispatches", "coalesced_requests",
     "degraded", "tiers", "campaign_resubmits"}
    | {f"evaluator_{n}" for n in ("dispatches", "worker_dispatches",
                                  "retried", "straggler_redispatches",
                                  "timeouts", "corrupt_rejected",
                                  "resizes")})


def same_report(a, b, what: str) -> None:
    """Fail unless two PPAReports are equal bit for bit."""
    ok = (a.workloads == b.workloads and a.detail == b.detail
          and np.array_equal(a.area, b.area))
    for w in a.workloads:
        ok = ok and np.array_equal(a.latency[w], b.latency[w])
        for f in ("op_time", "stall", "op_class"):
            fa, fb = getattr(a, f), getattr(b, f)
            ok = ok and ((fa is None and fb is None)
                         or np.array_equal(fa[w], fb[w]))
    check(ok, f"{what}: differs from the unsharded report")


def expected_sweep_chunks(plan, span_chunks, every: int):
    """(chunks run, spans replayed) by a chaos sweep: a worker span fires
    (span, chunk ordinal of the attempt) before each chunk, consumes each
    event once, and replays a crashed attempt from its last checkpoint
    (written every `every` chunks of an attempt), from scratch before the
    first."""
    events = {(w, d): plan.peek(w, d).kind
              for w in range(len(span_chunks))
              for d in range(max(span_chunks))
              if plan.peek(w, d) is not None}
    total = replays = 0
    for w, n in enumerate(span_chunks):
        saved = 0
        while True:
            pos, i, crashed = saved, 0, False
            while pos < n:
                if events.pop((w, i), None) == "crash":
                    crashed = True
                    break
                pos, i, total = pos + 1, i + 1, total + 1
                if i % every == 0:
                    saved = pos
            if not crashed:
                break
            replays += 1
    return total, replays


def phase14_faults(torch, dev, res_k, smi: str, work_dir: str,
                   stop=None) -> dict:
    """The fault-tolerant evaluation path on the card, every evaluation on
    ``backend="cuda"``: (a) ShardedEvaluator in every local mode, (b) a
    chaos plan with a hung shard, (c) a chaos sweep equal to phase 4's and
    a killed-and-resumed portfolio sweep, (d) campaigns through a chaotic
    EvalService and its degrade ladder, (e) the Perfetto trace and the
    fleet report, (f) timings.  `res_k` is phase 4's sweep over [0, stop).
    Returns the phase's ppa_eval launches on the path."""
    import shutil

    from repro_torch.core.campaign import CampaignRunner
    from repro_torch.distributed import (EvalService, FaultEvent, FaultPlan,
                                         ShardedEvaluator)
    from repro_torch.kernels.ppa_eval import ppa_eval
    from repro_torch.obs import (Tracer, completeness_errors, trace_events,
                                 validate_trace_events, write_trace)
    from repro_torch.obs.report import fleet_report
    from repro_torch.perfmodel import (ModelEvaluator, OracleEvaluator,
                                       SweepEngine, get_evaluator)
    from repro_torch.perfmodel.designspace import SPACE
    from repro_torch.perfmodel.evaluator import EvalRequest
    from repro_torch.runtime import RetryPolicy
    t_phase = time.perf_counter()
    out = {"launches": 0}
    stop = SPACE.size if stop is None else int(stop)
    ev_k = get_evaluator("proxy", backend="cuda", device=dev)

    def fresh():
        return ModelEvaluator(ev_k.models, backend="cuda", device=dev)

    # ---- 14a. ShardedEvaluator in every local mode, bit for bit
    idx = SPACE.sample(np.random.default_rng(14), PHASE14_ROWS)
    want = {d: fresh().evaluate(EvalRequest(idx, d)) for d in EVAL_DETAILS}
    for mode, workers in PHASE14_SHARDINGS:
        t0 = time.perf_counter()
        # no speculative twins: each shard dispatches (and launches) once
        sh = ShardedEvaluator(fresh(), workers=workers, mode=mode,
                              speculate=False)
        try:
            for d in EVAL_DETAILS:
                ppa_eval.launches = 0
                w0 = sh.worker_dispatches
                rep = sh.evaluate(EvalRequest(idx, d))
                n_launch, shards = ppa_eval.launches, sh.worker_dispatches - w0
                same_report(rep, want[d], f"{mode} x{workers} {d}")
                # objectives launch the kernel once a shard; ppa and
                # stalls run torch ops; a process worker counts its own
                expect = (shards if d == "objectives" and mode != "process"
                          else 0)
                check(n_launch == expect,
                      f"{mode} x{workers} {d}: {n_launch} ppa_eval launches "
                      f"for {shards} shards, want {expect}")
                out["launches"] += n_launch
                if d == "objectives":
                    obj = (shards, n_launch)
        finally:
            sh.close()
        log(f"[14a] ShardedEvaluator {mode} x{workers}: {PHASE14_ROWS} "
            f"designs at {'/'.join(EVAL_DETAILS)} bit for bit equal to the "
            f"unsharded cuda evaluator; objectives in {obj[0]} shard(s), "
            f"{obj[1]} ppa_eval launch(es) in this process"
            f"{' (the workers launch their own)' if mode == 'process' else ''}"
            f"; {time.perf_counter() - t0:.2f} s")
    ev2 = get_evaluator("proxy", backend="cuda", workers=2, device=dev)
    check(isinstance(ev2, ShardedEvaluator) and ev2.workers == 2,
          "get_evaluator(workers=2) is not a 2-worker ShardedEvaluator")
    for d in ("objectives", "stalls"):
        same_report(ev2.evaluate(EvalRequest(idx, d)),
                    ev_k.evaluate(EvalRequest(idx, d)),
                    f"get_evaluator(workers=2) {d}")
    log("[14a] get_evaluator('proxy', 'cuda', workers=2) equals workers=1 "
        "(objectives, stalls)")

    # ---- 14b. chaos on the card: crash, corrupt, slow and hang
    plan = FaultPlan([FaultEvent(0, 0, "crash"), FaultEvent(1, 1, "corrupt"),
                      FaultEvent(2, 2, "slow", delay_s=0.05),
                      FaultEvent(3, 3, "hang")])
    sh = ShardedEvaluator(fresh(), workers=4, mode="thread", fault_plan=plan,
                          shard_timeout_s=CHAOS_TIMEOUT_S, speculate=False)
    try:
        ppa_eval.launches = 0
        t0 = time.perf_counter()
        rep = sh.evaluate(EvalRequest(idx, "objectives"))
        chaos_s = time.perf_counter() - t0
        n_launch = ppa_eval.launches
        same_report(rep, want["objectives"], "chaos objectives")
        same_report(sh.evaluate(EvalRequest(idx, "stalls")), want["stalls"],
                    "chaos stalls")
        inj = dict(sh._pool.injected)
        reg = sh.registry
        check(inj == {"crash": 1, "hang": 1, "slow": 1, "corrupt": 1}
              and len(plan) == 0, f"chaos: injected {inj}, {len(plan)} left")
        check(sh.retried == 3 and sh.corrupt_rejected == 1
              and sh.timeouts == 1 and reg.evictions == 3
              and reg.reregistrations == 3
              and sorted(reg.live()) == [0, 1, 2, 3],
              f"chaos counters: retried {sh.retried} corrupt_rejected "
              f"{sh.corrupt_rejected} timeouts {sh.timeouts} evictions "
              f"{reg.evictions} reregistrations {reg.reregistrations}")
        # a crash and a hang never reach the worker; every other dispatch
        # of the objectives request launched the kernel once
        check(n_launch == 4 + 3 - 2,
              f"chaos: {n_launch} ppa_eval launches, want 5")
        out["launches"] += n_launch
        log(f"[14b] chaos x4 (crash, corrupt, slow, hang; shard timeout "
            f"{CHAOS_TIMEOUT_S} s): report bit for bit equal; retried "
            f"{sh.retried}, corrupt_rejected {sh.corrupt_rejected}, timeouts "
            f"{sh.timeouts}, evictions {reg.evictions}, re-registrations "
            f"{reg.reregistrations}, ppa_eval launches {n_launch}, objectives "
            f"request {chaos_s:.3f} s")
    finally:
        sh.close()

    # ---- 14c. a chaos sweep equal to phase 4's, and a portfolio kill
    os.makedirs(work_dir, exist_ok=True)
    tracer = Tracer(proc="chip_smoke")
    try:
        eng = SweepEngine(ev_k, stall_topk=8, backend="cuda", tracer=tracer)
        n_chunks = -(-stop // eng.chunk_size)
        per = -(-n_chunks // 2)
        span_chunks = (per, n_chunks - per)
        splan = FaultPlan.seeded(CHAOS_SWEEP_SEED, workers=2,
                                 dispatches=per, rate=CHAOS_SWEEP_RATE,
                                 kinds=("crash", "slow"), delay_s=0.01)
        want_chunks, replays = expected_sweep_chunks(
            splan, span_chunks, CHAOS_SWEEP_EVERY)
        check(replays >= 1, f"seed {CHAOS_SWEEP_SEED} crashes no span")
        ppa_eval.launches = 0
        res = eng.run(0, stop, workers=2, fault_plan=splan,
                      checkpoint_path=os.path.join(work_dir, "chaos"),
                      checkpoint_every=CHAOS_SWEEP_EVERY,
                      span_retry=RetryPolicy(max_retries=CHAOS_SWEEP_RETRIES,
                                             retryable=(RuntimeError,)))
        n_launch = ppa_eval.launches
        out["launches"] += n_launch
        out["chaos_sweep_s"] = res.seconds
        same_sweep(res, res_k, "chaos sweep",
                   ("n_evaluated", "n_superior", "pareto_y", "pareto_ids",
                    "topk_val", "topk_ids", "stall_topk_val",
                    "stall_topk_ids", "archive_truncated"))
        tel = eng.telemetry()
        check(tel["chunks"] == want_chunks and n_launch == want_chunks,
              f"chaos sweep: {tel['chunks']} chunks, {n_launch} launches; "
              f"want {n_chunks} + {want_chunks - n_chunks} replayed")
        log(f"[14c] chaos sweep x2 over {stop:,} designs (seed "
            f"{CHAOS_SWEEP_SEED}: {splan.fired['crash']} crashes, "
            f"{splan.fired['slow']} slow chunks, {replays} span replays from "
            f"checkpoints every {CHAOS_SWEEP_EVERY} chunks): equal to phase "
            f"4's sweep (n_superior {res.n_superior}, top-k ids, front "
            f"{len(res.pareto_ids)}); telemetry chunks {tel['chunks']} = "
            f"{n_chunks} + {tel['chunks'] - n_chunks} replayed, ppa_eval "
            f"launches {n_launch}, wall {res.seconds:.3f} s")
        zoo = get_evaluator("proxy", suite="zoo", device=dev)
        peng = SweepEngine(zoo, stall_topk=8)
        n = PORTFOLIO_KILL_CHUNKS * peng.chunk_size
        clean = peng.run(0, n)
        ck = os.path.join(work_dir, "portfolio")
        try:
            peng.run(0, n, checkpoint_path=ck, checkpoint_every=2,
                     fault_plan=FaultPlan([FaultEvent(0, 5, "crash")]),
                     span_retry=RetryPolicy(max_retries=0))
            check(False, "the killed portfolio sweep did not fail")
        except RuntimeError as exc:
            check("failed after 0 retries" in str(exc),
                  f"portfolio kill: {exc}")
        same_sweep(peng.run(0, n, resume_from=ck), clean,
                   "portfolio resume")
        log(f"[14c] portfolio sweep killed at chunk 5 of "
            f"{PORTFOLIO_KILL_CHUNKS} and resumed from its checkpoint: "
            f"equal to a fresh run (robust and {len(clean.scenario_names)} "
            f"scenario fronts)")

        # ---- 14d. campaigns through a chaotic service, and its ladder
        oracle = OracleEvaluator(ev_k, result=res_k)
        seeds = res_k.stall_seeds()
        proxy = fresh()
        t0 = time.perf_counter()
        plain = CampaignRunner(ev_k, proxy=proxy, oracle=oracle,
                               seed=0).run(budget=CAMPAIGN_BUDGET,
                                           seeds=seeds)
        plain_s = time.perf_counter() - t0
        cplan = FaultPlan.seeded(CHAOS_CAMPAIGN_SEED, workers=2,
                                 dispatches=256, rate=0.3,
                                 kinds=("crash", "slow", "corrupt"),
                                 delay_s=0.01)
        sharded = ShardedEvaluator(fresh(), workers=2, retries=5,
                                   shard_timeout_s=5.0, fault_plan=cplan,
                                   speculate=False, tracer=tracer)
        svc = EvalService(sharded, tracer=tracer)
        ppa_eval.launches = 0
        t0 = time.perf_counter()
        res_c = CampaignRunner(svc, proxy=proxy, oracle=oracle,
                               seed=0).run(budget=CAMPAIGN_BUDGET,
                                           seeds=seeds)
        chaos_campaign_s = time.perf_counter() - t0
        n_launch = ppa_eval.launches
        out["launches"] += n_launch
        k = len(res_c.per_campaign)
        check(np.array_equal(np.stack([s.idx for s in res_c.samples]),
                             np.stack([s.idx for s in plain.samples]))
              and [(t.campaign, t.step, t.objectives, t.regret, t.phv_frac)
                   for t in res_c.telemetry]
              == [(t.campaign, t.step, t.objectives, t.regret, t.phv_frac)
                  for t in plain.telemetry]
              and res_c.phv == plain.phv,
              "campaigns through the chaotic service differ from the plain "
              "evaluator's")
        check(svc.fused_dispatches <= res_c.rounds + k + 2,
              f"{svc.fused_dispatches} fused dispatches for {res_c.rounds} "
              f"rounds of {k} campaigns")
        sc = res_c.service_counters
        check(set(sc) == SERVICE_COUNTER_KEYS,
              f"service_counters keys {sorted(sc)}")
        check(cplan.scheduled > len(cplan)
              and sc["evaluator_retried"] + sc["evaluator_corrupt_rejected"]
              > 0, "the chaos plan never fired in the campaigns")
        frac = res_c.phv_frac_curve()
        log(f"[14d] campaigns through EvalService(ShardedEvaluator x2, chaos "
            f"seed {CHAOS_CAMPAIGN_SEED}): {k} campaigns, budget "
            f"{CAMPAIGN_BUDGET}, equal to the plain cuda evaluator's "
            f"(samples, regret, phv fraction {frac[-1]:.6f}); {res_c.rounds} "
            f"rounds, {svc.fused_dispatches} fused service dispatches; "
            f"injected {dict(sharded._pool.injected)}, retried "
            f"{sc['evaluator_retried']}, corrupt_rejected "
            f"{sc['evaluator_corrupt_rejected']}, resubmits "
            f"{sc['campaign_resubmits']}, degraded {sc['degraded']}; "
            f"ppa_eval launches {n_launch} (the QuanE probes); wall "
            f"{chaos_campaign_s:.3f} s (plain {plain_s:.3f} s)")
        # the ladder: the stalls dispatch fails, narrowing fails, the
        # objectives proxy rung serves, through the kernel
        lplan = FaultPlan([FaultEvent(0, 0, "crash"),
                           FaultEvent(0, 2, "crash")])
        lsh = ShardedEvaluator(fresh(), workers=2, retries=0,
                               fault_plan=lplan, speculate=False,
                               tracer=tracer)
        lsvc = EvalService(lsh, tracer=tracer)
        rows = idx[:4_096]
        ppa_eval.launches = 0
        fut = lsvc.submit(EvalRequest(rows, "stalls"), client="ladder")
        lsvc.tick()
        rep = fut.result()
        n_launch = ppa_eval.launches
        out["launches"] += n_launch
        check(rep.detail == "objectives"
              and dict(lsvc.degraded) == {"deadline": 0, "narrow": 1,
                                          "proxy": 1, "cached": 1},
              f"ladder: detail {rep.detail}, degraded {dict(lsvc.degraded)}")
        check(n_launch == 1, f"ladder: {n_launch} ppa_eval launches, want "
              f"the proxy rung's 1")
        same_report(rep, fresh().evaluate(EvalRequest(rows, "objectives")),
                    "ladder proxy rung")
        lsh.close()
        log(f"[14d] degrade ladder: stalls dispatch and its narrowed retry "
            f"crash, the objectives proxy rung dispatches on the card "
            f"({n_launch} ppa_eval launch) and the request is served from "
            f"those cached rows, bit for bit equal; degraded "
            f"{dict(lsvc.degraded)}")

        # ---- 14e. the Perfetto trace of (c) and (d), the fleet report
        spans = tracer.spans()
        obj = trace_events(spans)
        path = write_trace(os.path.join(work_dir, "trace.json"), spans)
        errs = validate_trace_events(obj) + completeness_errors(spans)
        check(errs == [], f"trace: {errs[:5]}")
        names = [s.name for s in spans]
        log(f"[14e] trace {os.path.relpath(path, ROOT)}: {len(spans)} spans "
            f"(sweep.run {names.count('sweep.run')}, sweep.span "
            f"{names.count('sweep.span')}, campaign.round "
            f"{names.count('campaign.round')}, service.tick "
            f"{names.count('service.tick')}, shard {names.count('shard')}), "
            f"{len(obj['traceEvents'])} events; schema and completeness "
            f"checks empty")
        for line in fleet_report(svc).splitlines():
            log(f"[14e] {line}")
        sharded.close()

        # ---- 14f. times
        big = SPACE.sample(np.random.default_rng(15), DISPATCH_B)
        saved = ppa_eval.launches
        for w in DISPATCH_WORKERS:
            sh = ShardedEvaluator(fresh(), workers=w, mode="thread")
            try:
                for _ in range(2):
                    sh.objectives(big)                    # warm
                ts = []
                for _ in range(DISPATCH_CALLS):
                    t0 = time.perf_counter()
                    sh.objectives(big)
                    ts.append(time.perf_counter() - t0)
                log(f"[14f] one objectives dispatch at B {DISPATCH_B:,} "
                    f"through {w} thread worker(s): median "
                    f"{np.median(ts) * 1e3:.3f} ms, min {min(ts) * 1e3:.3f} "
                    f"ms over {DISPATCH_CALLS} calls ({smi})")
                if w == 2:
                    profile_device(torch, lambda: [sh.objectives(big)
                                                   for _ in range(3)],
                                   "14f", f"3 objectives dispatches at B "
                                   f"{DISPATCH_B:,} through 2 thread "
                                   f"workers", "ppa_eval")
            finally:
                sh.close()
        profile_device(torch, lambda: eng.run(
            0, 4 * eng.chunk_size, workers=2,
            fault_plan=FaultPlan([FaultEvent(0, 1, "crash")])), "14f",
            "a 2-worker chaos sweep over 4 chunks (one crash)", "ppa_eval")
        plain_eng = SweepEngine(ev_k, stall_topk=8, backend="cuda")
        walls = {"off": [], "empty plan": []}
        for what in ("off", "empty plan", "empty plan", "off"):
            plan_ = FaultPlan() if what == "empty plan" else None
            walls[what].append(plain_eng.run(0, stop,
                                             fault_plan=plan_).seconds)
        off, on = np.mean(walls["off"]), np.mean(walls["empty plan"])
        log(f"[14f] chaos-off overhead: full sweep without a plan "
            f"{'/'.join(f'{t:.3f}' for t in walls['off'])} s, with an empty "
            f"FaultPlan {'/'.join(f'{t:.3f}' for t in walls['empty plan'])} "
            f"s ({100 * (on - off) / off:+.1f}%); chaos sweep x2 "
            f"{out['chaos_sweep_s']:.3f} s ({smi})")
        tsvc = EvalService(ShardedEvaluator(fresh(), workers=2),
                           max_rows_per_tick=TIER_TICK_ROWS)
        rng = np.random.default_rng(16)
        for _ in range(8):
            for tier, n_rows in TIER_ROWS.items():
                tsvc.submit(EvalRequest(SPACE.sample(rng, n_rows),
                                        "objectives"),
                            client=tier, tier=tier)
        while tsvc.tick():
            pass
        tsvc.evaluator.close()
        ppa_eval.launches = saved             # timing launches are not the path's
        tiers = tsvc.telemetry()["tiers"]
        log("[14f] service queue latency, 8 requests a tier in one burst "
            "(rows " + ", ".join(f"{t} {n}" for t, n in TIER_ROWS.items())
            + "): " + "; ".join(
                f"{t} p50 {d['p50_ms']} ms p99 {d['p99_ms']} ms"
                for t, d in tiers.items()))
        camp = sc["tiers"]["interactive"]
        log(f"[14f] campaign service, interactive tier: {camp['served']} "
            f"requests, p50 {camp['p50_ms']} ms, p99 {camp['p99_ms']} ms")
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    log(f"[14] phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------- training slice
# flash_attention's backward: max |kernel - plain(float64)| / max |plain|
FA_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FA_LSE_TOL = 1e-5
# (B, Sq, Sk, H, KVH, hd, causal): llama3.2-1b, jamba and qwen2-moe at
# S 4096 (timed), then ragged causal and non-causal ones, Sq != Sk unmasked
FA_BWD_FULL = {"llama3.2-1b": (2, 4096, 4096, 32, 8, 64, True),
               "jamba": (1, 4096, 4096, 64, 8, 128, True),
               "qwen2-moe": (1, 4096, 4096, 16, 16, 128, True)}
FA_BWD_SMALL = [(1, 1000, 1000, 4, 2, 64, True),
                (1, 2049, 2049, 4, 2, 64, True),
                (1, 1000, 1000, 4, 2, 64, False),
                (2, 1000, 777, 4, 2, 64, False)]
# the backward's three kernels, timed apart in 16f
FA_BWD_PASSES = ("fa_bwd_dot", "fa_bwd_dkdv", "fa_bwd_dq")
# the earlier backward's times (fp32 FMA on the SIMT cores for both types)
# at FA_BWD_FULL, from earlier runs of this script on NVIDIA H100 80GB HBM3
# at 700.00 W (PERF.md), printed beside the current kernel's
FA_BWD_EARLIER_MS = {
    "llama3.2-1b": {"float32": "21.468-21.805", "bfloat16": "20.855-20.970"},
    "jamba": {"float32": "54.872-55.376", "bfloat16": "54.045-54.205"},
    "qwen2-moe": {"float32": "13.509-13.52", "bfloat16": "13.508-13.695"}}
TRAIN = ("llama3.2-1b", 2, 4096)                     # arch, batch, seq
TRAIN_STEPS = 6
GRAD_ROUTE_REL = 1e-3                                # 16b: kernel vs plain
RESUME_STEPS, RESUME_EVERY = 8, 4


def fa_bwd_inputs(torch, b, sq, sk, h, kvh, hd, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, sq, h, hd), (b, sk, kvh, hd), (b, sk, kvh, hd),
                          (b, sq, h, hd))]


def _fa_grads64(torch, q, k, v, do, causal: bool):
    """(dq, dk, dv) by autograd through float64 full attention (heads
    repeated), the oracle of 16a's small shapes."""
    from repro_torch.models.attention import _repeat_kv
    rep = q.shape[2] // k.shape[2]
    qq, kk, vv = (x.double().requires_grad_(True) for x in (q, k, v))
    scale = 1.0 / qq.shape[-1] ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", qq, _repeat_kv(kk, rep)) * scale
    if causal:
        keep = (torch.arange(s.shape[-1], device=s.device)[None]
                <= torch.arange(s.shape[-2], device=s.device)[:, None])
        s = torch.where(keep, s, -torch.inf)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                       _repeat_kv(vv, rep))
    return torch.autograd.grad(out, (qq, kk, vv), do.double())


def phase16a_fa_bwd(torch, dev) -> dict:
    """16a: the backward kernel against its plain version (float64, from
    the same lse) at the three full-size shapes and the small ones, fp32
    and bf16; two launches bit for bit; the forward's lse against the
    plain version's, and its output with lse bit for bit the output
    without.  Returns the max abs error over the fp32 checks."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain)
    from repro_torch.kernels.flash_attention.ops import (_forward,
                                                         _plain_forward)
    saved = (flash_attention.launches, flash_attention_bwd.launches)
    max_abs = 0.0
    cases = [(n, s) for n, s in FA_BWD_FULL.items()] + [
        (f"small {s[:6]}", s) for s in FA_BWD_SMALL]
    for name, (b, sq, sk, h, kvh, hd, causal) in cases:
        for dn, dt in _dtypes(torch).items():
            q, k, v, do = fa_bwd_inputs(torch, b, sq, sk, h, kvh, hd, dt, dev,
                                        seed=sq + hd)
            o, lse = _forward(q, k, v, causal, with_lse=True)
            o_bare, _ = _forward(q, k, v, causal, with_lse=False)
            check(torch.equal(o, o_bare), f"fa_bwd {name} {dn}: the "
                  f"forward's output with lse differs from without")
            lse_p = _plain_forward(q, k, v, causal)[1]
            lse_err = float((lse - lse_p).abs().max())
            check(lse_err <= FA_LSE_TOL * (1 + float(lse_p.abs().max())),
                  f"fa_bwd {name} {dn}: lse off the plain version's by "
                  f"{lse_err:.3g}")
            got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
            again = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
            torch.cuda.synchronize()
            check(all(torch.equal(a, c) for a, c in zip(got, again)),
                  f"fa_bwd {name} {dn}: two launches differ")
            want = flash_attention_bwd_plain(
                *(x.double() for x in (q, k, v, o, do)), lse.double(),
                causal=causal)
            oracles = [("plain float64", want)]
            if name.startswith("small"):
                oracles.append(("autograd float64",
                                _fa_grads64(torch, q, k, v, do, causal)))
            msgs = []
            for what, ref in oracles:
                errs = []
                for g, w, part in zip(got, ref, ("dq", "dk", "dv")):
                    check(bool(torch.isfinite(g).all()),
                          f"fa_bwd {name} {dn} {part}: non-finite")
                    diff = float((g.double() - w).abs().max())
                    rel = diff / float(w.abs().max())
                    check(rel <= FA_BWD_TOL[dn], f"fa_bwd {name} {dn} "
                          f"{part} vs {what}: {rel:.3g} of max |ref| > "
                          f"{FA_BWD_TOL[dn]}")
                    errs.append(rel)
                    if dn == "float32" and what == "plain float64":
                        max_abs = max(max_abs, diff)
                msgs.append(f"{what} rel err dq/dk/dv "
                            + "/".join(f"{e:.3g}" for e in errs))
            del want, oracles
            log(f"[16a] fa_bwd {name} {dn}: " + "; ".join(msgs)
                + f" (tol {FA_BWD_TOL[dn]}); two launches bitwise equal; "
                f"lse max abs err {lse_err:.3g}; output with lse bitwise "
                f"the output without")
            torch.cuda.empty_cache()
    flash_attention.launches, flash_attention_bwd.launches = saved
    return {"max_abs_err": max_abs}


def phase16f_fa_bwd_timings(torch, dev) -> dict:
    """16f: at each full-size shape and type: the backward kernel (and the
    device time of each of its three kernels), its plain version (in the
    input type) and SDPA's backward (the library call, timed only), the
    bound on the card's tensor cores (fa_bound, the function's 5 products)
    beside the design's own floor (its 7 products at the same rate) and
    the earlier kernel's recorded times; the forward with lse against
    without."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_cost,
        flash_attention_bwd_plain)
    from repro_torch.kernels.flash_attention.ops import _forward
    saved = (flash_attention.launches, flash_attention_bwd.launches)
    rows = {}
    for name, (b, sq, sk, h, kvh, hd, causal) in FA_BWD_FULL.items():
        for dn, dt in _dtypes(torch).items():
            q, k, v, do = fa_bwd_inputs(torch, b, sq, sk, h, kvh, hd, dt,
                                        dev)
            o, lse = _forward(q, k, v, causal, with_lse=True)

            def bwd():
                return flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
            k_ms = kernel_ms(torch, bwd, warm=1, iters=5)
            parts = pass_times(torch, bwd, FA_BWD_PASSES, calls=3)
            p_ms = time_ms(torch, lambda: flash_attention_bwd_plain(
                q, k, v, o, do, lse, causal=causal), warm=1, iters=2)
            fwd_lse = kernel_ms(torch, lambda: _forward(
                q, k, v, causal, with_lse=True), iters=20)
            fwd_bare = kernel_ms(torch, lambda: _forward(
                q, k, v, causal, with_lse=False), iters=20)
            qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k.repeat_interleave(h // kvh, dim=2),
                                    v.repeat_interleave(h // kvh, dim=2)))
            out = F.scaled_dot_product_attention(qs, ks, vs,
                                                 is_causal=causal)
            dos = do.transpose(1, 2)
            lib_ms = kernel_ms(torch, lambda: torch.autograd.grad(
                out, (qs, ks, vs), dos, retain_graph=True), warm=1, iters=5)
            ops, nbytes = flash_attention_bwd_cost(b, sq, sk, h, kvh, hd,
                                                   causal, q.element_size())
            bnd = fa_bound(ops, nbytes, dn, simt=False)
            mult, rate, route = FA_ROUTE[dn]
            floor_ms = mult * ops * 7 / 5 / rate * 1e3
            rows[(name, dn)] = {"ms": k_ms, "plain_ms": p_ms,
                                "library_ms": lib_ms,
                                "bound_ms": bnd["bound_ms"],
                                "bound_by": bnd["bound_by"],
                                "floor_ms": floor_ms,
                                "fwd_lse_ms": fwd_lse, "fwd_ms": fwd_bare}
            log(f"[16f] fa_bwd {name} {(b, sq, h, kvh, hd)} {dn}: kernel "
                f"{k_ms:.3f} ms ({ops / k_ms / 1e9:.1f} TFLOP/s of the "
                f"function's 5 products; device time "
                + ", ".join(f"{n} {us / 1e3:.3f} ms ({k} of 3 launches "
                            f"recorded)" if k else f"{n} not recorded"
                            for n, (us, k) in parts.items())
                + f"; the earlier SIMT kernel {FA_BWD_EARLIER_MS[name][dn]} "
                f"ms), plain {p_ms:.2f} ms, SDPA backward {lib_ms:.3f} ms "
                f"(heads repeated), bound {bnd['bound_ms']:.4f} ms "
                f"({bnd['text']}), the design's 7 products {floor_ms:.4f} "
                f"ms ({mult} x {ops * 7 / 5 / 1e9:.1f} GFLOP {route}: "
                f"{k_ms / floor_ms:.2f}x); forward with lse {fwd_lse:.3f} "
                f"ms, without {fwd_bare:.3f} ms")
            del out, qs, ks, vs, q, k, v, do, o, lse
            torch.cuda.empty_cache()
    flash_attention.launches, flash_attention_bwd.launches = saved
    return rows


def _train_batch(torch, cfg, batch: int, seq: int, dev, seed: int = 0):
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, seq + 1)), device=dev)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def phase16b_grad_route(torch, dev) -> None:
    """16b: llama3.2-1b at full width cut to 2 layers, B 1, S 4096, fp32:
    one loss.backward() through the kernels, one with the attention
    routed to flash_attention_plain under autograd (a switch of this
    script only): every gradient within GRAD_ROUTE_REL of max |g|, every
    q/k/v weight's nonzero."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_plain)
    from repro_torch.models import attention as attn_mod
    cfg = dataclasses.replace(get_arch(TRAIN[0]), n_layers=2)
    model = build_full_width(torch, cfg, dev, tag="16b")
    model.requires_grad_(True)
    batch = _train_batch(torch, cfg, 1, TRAIN[2], dev, seed=3)
    saved = (flash_attention.launches, flash_attention_bwd.launches)
    flash_attention.launches = flash_attention_bwd.launches = 0
    loss_k = model.loss(batch)
    loss_k.backward()
    torch.cuda.synchronize()
    counts = (flash_attention.launches, flash_attention_bwd.launches)
    check(counts == (4, 2), f"16b: kernel route launched fwd/bwd {counts}, "
          f"want 4/2 (2 layers, remat)")
    grads_k = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    kernel = attn_mod.flash_attention
    attn_mod.flash_attention = lambda q, k, v, causal=True: \
        flash_attention_plain(q, k, v, causal=causal)
    try:
        loss_p = model.loss(batch)
        loss_p.backward()
        torch.cuda.synchronize()
    finally:
        attn_mod.flash_attention = kernel
    check(flash_attention.launches == 4 and flash_attention_bwd.launches == 2,
          "16b: the plain route launched a kernel")
    flash_attention.launches, flash_attention_bwd.launches = saved
    worst = ("", 0.0)
    for n, p in model.named_parameters():
        gp, gk = p.grad, grads_k[n]
        scale = float(gp.abs().max())
        rel = float((gk - gp).abs().max()) / max(scale, 1e-30)
        check(rel <= GRAD_ROUTE_REL, f"16b: {n} gradient off the plain "
              f"route's by {rel:.3g} of max |g|")
        if rel > worst[1]:
            worst = (n, rel)
        if n.endswith((".attn.q.w", ".attn.k.w", ".attn.v.w")):
            check(float(gk.abs().max()) > 0, f"16b: {n} has no gradient")
    log(f"[16b] {cfg.name} (2 layers, full width) B=1 S={TRAIN[2]}: loss "
        f"kernel {loss_k.item():.6f} plain {loss_p.item():.6f}; every "
        f"gradient within {GRAD_ROUTE_REL} of max |g| of the plain route "
        f"(worst {worst[0]} {worst[1]:.3g}); q/k/v weights' gradients "
        f"nonzero; launches fwd 4 (remat) bwd 2")
    del model, grads_k
    gc.collect()
    torch.cuda.empty_cache()


def phase16c_train(torch, dev) -> dict:
    """16c: llama3.2-1b at full width and depth, B 2, S 4096, fp32, remat,
    AdamW at the reference's defaults, SyntheticLMDataset: TRAIN_STEPS
    steps, each launching flash_attention 32 times (16 + 16 recomputed)
    and its backward 16 times, neither scan; step wall, tokens/s, peak
    memory and a profiled step."""
    from repro_torch.data import SyntheticLMDataset, make_batch_iter
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import AdamWConfig, adamw_init
    arch, b, s = TRAIN
    torch.cuda.reset_peak_memory_stats()
    model = build_full_width(torch, arch, dev, tag="16c")
    check(model.remat, "16c: the model must train with remat")
    step = steps_mod.make_train_step(model, AdamWConfig())
    state = adamw_init(dict(model.named_parameters()))
    ds = SyntheticLMDataset(model.cfg.vocab, s, b)
    walls, losses, gnorms, counts = [], [], [], []
    for batch in make_batch_iter(ds, 0, TRAIN_STEPS, device=dev):
        torch.cuda.synchronize()
        flash_attention.launches = flash_attention_bwd.launches = 0
        rwkv6_scan.launches = ssm_scan.launches = 0
        t0 = time.perf_counter()
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append((flash_attention.launches, flash_attention_bwd.launches,
                       rwkv6_scan.launches, ssm_scan.launches))
    peak = torch.cuda.max_memory_allocated()
    check(all(c == (32, 16, 0, 0) for c in counts),
          f"16c: launches per step (fwd, bwd, rwkv6, ssm) {counts}, want "
          f"(32, 16, 0, 0)")
    check(bool(np.isfinite(losses).all() and np.isfinite(gnorms).all()),
          f"16c: losses {losses} grad norms {gnorms}")
    med = float(np.median(walls[1:]))
    log(f"[16c] {arch} train B={b} S={s} fp32 remat, AdamW defaults: "
        f"losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in gnorms]}; step walls "
        f"{[round(x, 3) for x in walls]} s, median of steps 2-{TRAIN_STEPS} "
        f"{med:.3f} s, {b * s / med:,.0f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); launches per step "
        f"fwd 32 bwd 16, no scan")
    batch = next(iter(make_batch_iter(ds, TRAIN_STEPS, 1, device=dev)))
    saved = (flash_attention.launches, flash_attention_bwd.launches)
    shares = profile_device(
        torch, lambda: step(state, batch), "16c",
        "one llama3.2-1b train step (B 2, S 4096)", keep="fa_",
        ranges=((steps_mod, "adamw_update", "adamw_update", None),),
        groups={"fp32 GEMMs": lambda n: "gemm" in n.lower(),
                "fa_fwd": lambda n: "fa_fwd" in n,
                "fa_bwd": lambda n: "fa_bwd" in n,
                "log-softmax": lambda n: "softmax" in n.lower()})
    flash_attention.launches, flash_attention_bwd.launches = saved
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_s": med, "tokens_per_s": b * s / med, "peak": peak,
            "fwd_launches": sum(c[0] for c in counts),
            "bwd_launches": sum(c[1] for c in counts), "shares": shares}


def phase16d_resume(torch, dev, work_dir: str) -> None:
    """16d: a smoke llama train() of RESUME_STEPS steps at B 2, S 4096
    (the kernels' branch), checkpoints every RESUME_EVERY; the run lost
    after step RESUME_EVERY (its later checkpoint removed) resumes in a
    fresh model with the same losses bit for bit and the same final
    params and moments, under torch.use_deterministic_algorithms."""
    import shutil
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    shutil.rmtree(work_dir, ignore_errors=True)
    torch.use_deterministic_algorithms(True)
    saved = (flash_attention.launches, flash_attention_bwd.launches)
    try:
        flash_attention.launches = flash_attention_bwd.launches = 0
        kw = dict(arch=TRAIN[0], steps=RESUME_STEPS, batch=2, seq=TRAIN[2],
                  smoke=True, ckpt_dir=work_dir, ckpt_every=RESUME_EVERY,
                  log_every=1000, device=dev)
        whole = train(**kw)
        n_fwd, n_bwd = flash_attention.launches, flash_attention_bwd.launches
        cfg = get_arch(TRAIN[0]).smoke()
        check((n_fwd, n_bwd) == (RESUME_STEPS * cfg.n_layers,) * 2,
              f"16d: launches fwd/bwd {n_fwd}/{n_bwd}")
        m = build_model(cfg, dtype=torch.float32, device=dev)
        like = {"params": dict(m.named_parameters()),
                "opt": adamw_init(dict(m.named_parameters()))}
        end = restore_checkpoint(work_dir, RESUME_STEPS, like, device=dev)
        shutil.rmtree(os.path.join(work_dir, f"step_{RESUME_STEPS:08d}"))
        resumed = train(**kw)
        check(resumed == whole[RESUME_EVERY:],
              f"16d: resumed losses {resumed} != {whole[RESUME_EVERY:]}")
        again = restore_checkpoint(work_dir, RESUME_STEPS, like, device=dev)
        for part in ("params", "m", "v"):
            a = again["params"] if part == "params" else again["opt"][part]
            e = end["params"] if part == "params" else end["opt"][part]
            check(all(torch.equal(a[n], e[n]) for n in e),
                  f"16d: resumed final {part} differ")
        check(torch.equal(again["opt"]["step"], end["opt"]["step"]),
              "16d: resumed final step differs")
    finally:
        torch.use_deterministic_algorithms(False)
        flash_attention.launches, flash_attention_bwd.launches = saved
        shutil.rmtree(work_dir, ignore_errors=True)
    log(f"[16d] {cfg.name} train B=2 S={TRAIN[2]}, {RESUME_STEPS} steps, "
        f"checkpoints every {RESUME_EVERY}: resumed from step "
        f"{RESUME_EVERY} in a fresh model, losses {resumed} bit for bit the "
        f"uninterrupted run's, final params, m, v and step equal "
        f"(deterministic algorithms); launches fwd {n_fwd} bwd {n_bwd}")


def phase16e_guard(torch, dev) -> None:
    """16e: rwkv6 and jamba smoke models on the card refuse a loss that
    would need a scan's backward (NotImplementedError); under no_grad
    their loss is finite."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    for arch in ("rwkv6-7b", "jamba-1.5-large-398b"):
        cfg = get_arch(arch).smoke()
        m = build_model(cfg, dtype=torch.float32, device=dev)
        m.init_weights(torch.Generator(device=dev).manual_seed(0))
        m.requires_grad_(True)
        batch = _train_batch(torch, cfg, 1, 64, dev)
        try:
            m.loss(batch).backward()
        except NotImplementedError as e:
            msg = str(e).split(";")[0]
        else:
            raise SmokeFailure(f"16e: {arch} trained through a scan kernel "
                               f"that has no backward")
        with torch.no_grad():
            check(bool(torch.isfinite(m.loss(batch))),
                  f"16e: {arch} no_grad loss")
        log(f"[16e] {arch} smoke on the card: loss.backward() raised "
            f"NotImplementedError ({msg}); no_grad loss finite")


def phase16_training(torch, dev, work_dir: str) -> dict:
    t0 = time.perf_counter()
    fa_bwd = phase16a_fa_bwd(torch, dev)
    phase16b_grad_route(torch, dev)
    train = phase16c_train(torch, dev)
    phase16d_resume(torch, dev, work_dir)
    phase16e_guard(torch, dev)
    fa_bwd["times"] = phase16f_fa_bwd_timings(torch, dev)
    log(f"[16] phase 16 took {time.perf_counter() - t0:.1f} s")
    return {"fa_bwd": fa_bwd, "train": train}


def main() -> int:
    # cuBLAS reads its workspace size once, at its first call: fix it here,
    # before any, so that 16d's deterministic algorithms hold for every GEMM
    # (32 MiB, the size PyTorch already picks on sm_90)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.core.loop import LuminaDSE
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ppa_eval import ops as ppa_ops
    from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ppa_eval import (kernel_tables,
                                              op_table_tensor, ppa_eval,
                                              ppa_eval_op_count,
                                              ppa_eval_plain,
                                              ppa_eval_workloads)
    from repro_torch.kernels.ppa_eval import bench as ppa_bench
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
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    kernel_mods = (ppa_ops, fa_ops, rwkv_ops, ssm_ops)
    _build.build([(m.SOURCE, m.FLAGS) for m in kernel_mods]
                 + [(ppa_ops.FLOOR_SOURCE, ppa_ops.FLAGS)])
    for m in kernel_mods:
        m._library()                      # loads what build() compiled
    log(f"[1] build ppa_eval, flash_attention, rwkv6_scan, ssm_scan (nvcc "
        f"in parallel): {time.perf_counter() - t0:.2f} s")
    for line in _build.BUILD_LOGS.get("ppa_eval", "").splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            log(f"[1]   ppa_eval: {line.strip()}")
    ppa_sass = ppa_bench.sass_counts(
        _build.library_path(ppa_ops.SOURCE, ppa_ops.FLAGS))
    for fn, c in ppa_sass.items():
        log(f"[1]   ppa_eval SASS {fn}: {c['instructions']} instructions, "
            f"{c['mufu_rcp']} MUFU.RCP")
    if not ppa_sass:
        log("[1]   ppa_eval SASS not read (no cuobjdump)")
    report_fa_build(torch, _build, fa_ops)
    report_rwkv_build(_build, rwkv_ops)
    report_ssm_build(torch, _build, ssm_ops)

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
    # both workloads in one launch, as the sweep and the evaluator make it:
    # bit for bit the single-table launches' and the plain version's rows,
    # on sampled ids and on off-grid rows with more distinct sa_dim values
    # than a block's table holds
    pair = kernel_tables(list(wls.values()), dev)
    for b in PHASE2_BATCHES:
        batches = ppa_bench.design_batches(b, dev)
        for what, dv in batches.items():
            lat, area, stall = ppa_eval_workloads(dv, pair)
            got = torch.stack([torch.cat([lat[w][:, None], stall[w],
                                          area[:, None]], dim=1)
                               for w in range(len(pair))])
            for w, (tab, tp) in enumerate(pair.unpack()):
                single = ppa_eval(dv, tab, tp)[:, :6]
                plain = ppa_eval_plain(dv, tab, tp)[:, :6]
                check(torch.equal(got[w], single)
                      and torch.equal(got[w], plain),
                      f"ppa_eval both workloads B={b} {what}: workload {w} "
                      f"differs from its single-table launch or the plain "
                      f"version")
        log(f"[2] ppa_eval both workloads in one launch B={b}: bitwise "
            f"equal to the single-table launches and the plain version "
            f"({', '.join(batches)})")

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
    check(sweep_launches == n_chunks,
          f"{sweep_launches} launches for {n_chunks} chunks (one a chunk)")
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
    saved = ppa_eval.launches
    floor_ms = kernel_ms(torch, ppa_bench.floor_launcher(b))
    # each workload alone (one launch each) and both in one launch (the
    # sweep's chunk and the evaluator's dispatch)
    for nm, tabs in (("ttft", kernel_tables([wls["ttft"]], dev)),
                     ("tpot", kernel_tables([wls["tpot"]], dev)),
                     ("both", pair)):
        k_ms = kernel_ms(torch, lambda: ppa_eval_workloads(dv, tabs))
        loop_ms = time_ms(torch, lambda: ppa_eval_workloads(dv, tabs))
        lat, area, stall = ppa_eval_workloads(dv, tabs)
        ppa_eval.launches = saved      # timing launches are not the path's
        pad = torch.zeros((b, 2), device=dev)
        for w, (tab, tp) in enumerate(tabs.unpack()):
            got = torch.cat([lat[w][:, None], stall[w], area[:, None], pad],
                            dim=1)
            err = check_ppa_rows(got.cpu().numpy(),
                                 ppa_eval_plain(dv, tab, tp).cpu().numpy(),
                                 f"ppa_eval {nm} B={b} (timed)")
            check(err["bitwise"], f"ppa_eval {nm} B={b} (timed): not "
                  f"bitwise equal to the plain version")
            max_abs_err = max(max_abs_err, err["abs"])
        p_ms = time_ms(torch, lambda: [ppa_eval_plain(dv, t, tp)
                                       for t, tp in tabs.unpack()],
                       warm=1, iters=5)
        n_ops = tabs.ends[-1]
        # each design row read once, each (workload, design) row written
        # once, the op tables read once
        nbytes = (b * 8 + len(tabs) * b * 8 + n_ops * 8) * 4
        nops = b * ppa_eval_op_count(*[t.cpu().numpy()
                                       for t, _ in tabs.unpack()])
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = nops / PEAK_FP32_PER_S * 1e3
        times[nm] = {"ms": k_ms, "loop_ms": loop_ms, "plain_ms": p_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        log(f"[6] ppa_eval {nm} B={b} workloads={len(tabs)} n_ops={n_ops}: "
            f"kernel {k_ms:.5f} ms (back-to-back from Python: "
            f"{loop_ms:.5f} ms per launch), plain {p_ms:.3f} ms, bound "
            f"{times[nm]['bound_ms']:.5f} ms ({times[nm]['bound_by']}: "
            f"{nbytes} B, {nops} fp32 ops), launch floor {floor_ms:.5f} ms")
    both = times["both"]["ms"]
    pair_ms = times["ttft"]["ms"] + times["tpot"]["ms"]
    log(f"[6] ppa_eval per chunk: one launch {both:.5f} ms against the two "
        f"single-table launches' {pair_ms:.5f} ms; bound "
        f"{times['both']['bound_ms']:.5f} ms (96 B a design), empty-kernel "
        f"floor {floor_ms:.5f} ms at the same grid")
    log(f"[6] ppa_eval per full sweep: {sweep_launches} launches, "
        f"~{sweep_launches * both:.3f} ms of kernel time")
    saved = ppa_eval.launches
    profile_device(torch, lambda: eng_k.run(0, 4 * eng_k.chunk_size), "6",
                   "4 sweep chunks", "ppa_eval")
    ppa_eval.launches = saved               # profiled launches likewise

    # ---- 7. LM kernels vs plain on the card --------------------------------
    lm_err = phase7_lm_kernels(torch, dev)

    # ---- 8. prefill step at full width --------------------------------------
    llama = build_full_width(torch, LLAMA[0], dev)
    pre_llama = phase8_prefill(torch, llama, LLAMA[1], LLAMA[2], dev)
    check(pre_llama["counts"] == {"flash_attention": 16, "rwkv6_scan": 0,
                                  "ssm_scan": 0},
          f"llama3.2-1b prefill launches {pre_llama['counts']}, want 16 "
          f"flash_attention")
    rwkv = build_full_width(torch, RWKV[0], dev)
    pre_rwkv = phase8_prefill(torch, rwkv, RWKV[1], RWKV[2], dev,
                              check_logits=False)
    check(pre_rwkv["counts"] == {"flash_attention": 0, "rwkv6_scan": 32,
                                 "ssm_scan": 0},
          f"rwkv6-7b prefill launches {pre_rwkv['counts']}, want 32 "
          f"rwkv6_scan")
    rwkv_decode_tie(torch, rwkv, pre_rwkv["toks"], pre_rwkv["decode_diff"])
    profile_decode_step(torch, rwkv, 4, "8")
    del rwkv
    torch.cuda.empty_cache()

    # ---- 9. serve at full width --------------------------------------------
    phase9_serve(torch, dev)

    # ---- 10. LM kernel timings and a profiled prefill -----------------------
    lm_times = phase10_lm_timings(torch, dev)
    log(f"[10] prefill wall (second call): llama3.2-1b B=2 S=4096 "
        f"{pre_llama['prefill_s']:.3f} s, rwkv6-7b B=1 S=4096 "
        f"{pre_rwkv['prefill_s']:.3f} s")
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import make_prefill_step
    saved = flash_attention.launches
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, llama.cfg.vocab, (LLAMA[1], LLAMA[2])), device=dev)
    step = make_prefill_step(llama)
    profile_device(torch, lambda: step({"tokens": toks}), "10",
                   "one llama3.2-1b prefill (B 2, S 4096)", "fa_fwd")
    flash_attention.launches = saved
    profile_decode_step(torch, llama, 4, "10")
    del llama, step
    torch.cuda.empty_cache()

    # ---- 11. the hybrid path: jamba cut to n_layers 2, full width -----------
    jamba = phase11_jamba(torch, dev)
    log(f"[11] prefill wall (second call): {JAMBA[0]} cut B={JAMBA[1]} "
        f"S={JAMBA[2]} {jamba['prefill']['prefill_s']:.3f} s")
    jamba["prefill"] = {"counts": jamba["prefill"]["counts"]}
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 12. the zoo-suite portfolio path at full width ---------------------
    zoo = phase12_zoo(torch, dev, os.path.join(ROOT, "build",
                                               "chip_smoke_zoo"))

    # ---- 13. the method comparison, campaigns, Table 3, rule audit ----------
    methods = phase13_methods(torch, dev, res_k, smi, os.path.join(
        ROOT, "build", "chip_smoke_campaigns"))

    # ---- 14. the fault-tolerant evaluation path ------------------------------
    faults = phase14_faults(torch, dev, res_k, smi, os.path.join(
        ROOT, "build", "chip_smoke_faults"))

    # ---- 15. the moe, vlm and audio families at full width ------------------
    families = phase15_families(torch, dev)

    # ---- 16. training: flash_attention's backward, a full-width step -------
    training = phase16_training(torch, dev, os.path.join(
        ROOT, "build", "chip_smoke_train"))

    kt = times["both"]                 # the main path's launch: a chunk
    kernels = [{
        "name": "ppa_eval", "route": "cuda",
        "source": "src/repro_torch/kernels/ppa_eval/ppa_eval.cu",
        "replaces": "src/repro/kernels/ppa_eval/kernel.py:42",
        "launches": (sweep_launches + loop_launches + zoo["launches"]
                     + methods["launches"] + faults["launches"]),
        "max_abs_err": max(max_abs_err, zoo["max_abs_err"]),
        "ms": kt["ms"], "plain_ms": kt["plain_ms"],
        "bound_ms": kt["bound_ms"], "bound_by": kt["bound_by"],
        "library_ms": None,
    }]
    lm_times.update({k: v for k, v in jamba.items() if isinstance(k, tuple)})
    jc = jamba["prefill"]["counts"]
    for name, src, replaces, launches in (
            ("flash_attention",
             "src/repro_torch/kernels/flash_attention/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:25",
             pre_llama["counts"]["flash_attention"] + jc["flash_attention"]
             + families["launches"] + training["train"]["fwd_launches"]),
            ("rwkv6_scan", "src/repro_torch/kernels/rwkv6_scan/rwkv6_scan.cu",
             "src/repro/kernels/rwkv6_scan/kernel.py:25",
             pre_rwkv["counts"]["rwkv6_scan"]),
            ("ssm_scan", "src/repro_torch/kernels/ssm_scan/ssm_scan.cu",
             "src/repro/kernels/ssm_scan/kernel.py:24", jc["ssm_scan"])):
        t32 = lm_times[(name, "float32")]     # the main path runs fp32
        err = max(lm_err[name], t32["max_abs_err"])
        if name == "flash_attention":
            err = max([err] + [row["float32"]["max_abs_err"]
                               for row in families["fa"].values()])
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err,
            "ms": t32["ms"], "plain_ms": t32["plain_ms"],
            "bound_ms": t32["bound_ms"], "bound_by": t32["bound_by"],
            "library_ms": t32["library_ms"]})
    bwd = training["fa_bwd"]["times"][("llama3.2-1b", "float32")]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:25",
        "launches": training["train"]["bwd_launches"],
        "max_abs_err": training["fa_bwd"]["max_abs_err"],
        "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"]})
    log(f"[end] total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
