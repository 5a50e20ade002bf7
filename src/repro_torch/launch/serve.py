"""Batched decode server: prefill + greedy decode with a KV/state cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --smoke --batch 4 --prompt-len 32 --gen 16

Runs on the CUDA device unless ``--device cpu`` is given, under
``choose_mesh()`` as the reference's server does (one card is a mesh of
1); as there, nothing is placed on the mesh, so the tokens are the
unsharded model's.  As in the reference, the prompt is prefilled by decode
steps (cache-correct), then tokens are decoded greedily; the audio
family's encoder runs once first, on frames drawn from the seed after the
prompts.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import activate_mesh
from repro_torch.launch.steps import make_serve_step
from repro_torch.launch.train import choose_mesh
from repro_torch.models import Model, build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_generate(model: Model, prompts: torch.Tensor, gen: int,
                    enc_out: Optional[torch.Tensor] = None) -> Dict:
    """prompts (B, P) on the model's device -> {"tokens": (B, gen) int
    numpy, "ttft_s", "tpot_s"}: P decode steps over the prompt, then `gen`
    greedy tokens; `enc_out` is the audio encoder's output, which every
    step cross-attends to.  Times are wall clock around synchronized
    work."""
    step = make_serve_step(model)
    b, prompt_len = prompts.shape
    cache = model.init_cache(b, prompt_len + gen + 1, enc_out=enc_out)
    dev = model.device
    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(prompt_len):
        logits, cache = step(cache, prompts[:, t])
    tok = torch.argmax(logits, dim=-1)
    _sync(dev)
    ttft = time.perf_counter() - t0

    toks = []
    t0 = time.perf_counter()
    for _ in range(gen):
        toks.append(tok)            # stays on the device: no per-token sync
        logits, cache = step(cache, tok)
        tok = torch.argmax(logits, dim=-1)
    _sync(dev)
    tpot = (time.perf_counter() - t0) / max(gen, 1)
    out = torch.stack(toks, dim=1).cpu().numpy()
    return {"tokens": out, "ttft_s": ttft, "tpot_s": tpot}


def serve(arch: str, batch: int, prompt_len: int, gen: int, smoke: bool,
          dtype=torch.float32, greedy: bool = True, seed: int = 0,
          device: DeviceLike = None) -> Dict:
    """Build `arch` (its smoke config with `smoke`) with weights drawn from
    a ``torch.Generator`` seeded with `seed`, take the reference's prompts
    (``np.random.default_rng(seed)``) and, for the audio family, its
    frames (B, enc_ctx, d) from the same generator, encode them once and
    run :func:`greedy_generate`."""
    if not greedy:
        raise ValueError("only greedy decoding is implemented, as in the "
                         "reference")
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.smoke()
    dev = resolve_device(device)
    mesh = choose_mesh(dev)
    with activate_mesh(mesh):
        model = build_model(cfg, dtype=dtype, device=dev)
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
        rng = np.random.default_rng(seed)
        prompts = torch.as_tensor(
            rng.integers(0, cfg.vocab, (batch, prompt_len)), device=dev)
        enc = None
        if cfg.family == "audio":
            frames = torch.as_tensor(
                rng.standard_normal((batch, cfg.enc_ctx, cfg.d_model)),
                dtype=dtype, device=dev)
            with torch.no_grad():
                enc = model.encode(frames)
        return greedy_generate(model, prompts, gen, enc_out=enc)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    r = serve(args.arch, args.batch, args.prompt_len, args.gen, args.smoke,
              device=args.device)
    print(f"generated {r['tokens'].shape} tokens; "
          f"TTFT {r['ttft_s'] * 1e3:.1f}ms TPOT {r['tpot_s'] * 1e3:.2f}ms")
    print("first row:", r["tokens"][0][:16])


if __name__ == "__main__":
    main()
