"""End-to-end trainer under a device mesh.

The port's counterpart of ``repro.launch.train``: the sharded train step
(``make_train_step`` on DTensor parameters: loss, backward, in-place
AdamW with ZeRO-1 moments), the deterministic replayable data pipeline
with prefetch (each rank copies its own rows), async checkpointing with
resume from the newest step onto the mesh's placements, straggler
monitoring and optional int8 gradient compression with error feedback.
It always runs under :func:`choose_mesh`, as the reference's does: one
card (None: the CUDA device) or ``device="cpu"`` is a (1, 1) mesh; a
world of N processes (one per card, started with
``torch.distributed.init_process_group``) a (N / model, model) one.
Weights come from a ``torch.Generator`` seeded with 0, the same on every
rank; each keeps its own shard.  The losses printed and returned are
global.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticLMDataset, make_batch_iter
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import activate_mesh, data_axes, make_mesh
from repro_torch.models import build_model
from repro_torch.optim import (AdamWConfig, adamw_init,
                               compress_grads as cg, decompress_grads as dg,
                               ef_init)
from repro_torch.runtime import StragglerMonitor


def _ef_compression(params: dict):
    """The gradients through int8 compression with error feedback (the
    buffers live with the closure)."""
    ef = [ef_init(params)]

    def grad_fn(grads: dict) -> dict:
        comp, ef[0] = cg(grads, ef[0])
        return dg(comp, grads)
    return grad_fn


def choose_mesh(device: DeviceLike = None):
    """The largest (data, model) grid on the world's devices, model <= 16
    (a mesh of 1 without a process group)."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = 1
    for m in (16, 8, 4, 2, 1):
        if n % m == 0 and n >= m:
            model = m
            break
    return make_mesh((n // model, model), ("data", "model"), device)


def train(arch: str, steps: int, batch: int, seq: int, smoke: bool,
          ckpt_dir: Optional[str], ckpt_every: int = 50,
          lr: float = 3e-4, log_every: int = 10, resume: bool = True,
          dtype=torch.float32, compress_grads: bool = False,
          device: DeviceLike = None) -> List[float]:
    """Train `arch` for `steps` steps at (batch, seq) under
    :func:`choose_mesh`; returns the losses of the steps this call ran
    (from the resumed step on)."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.smoke()
    mesh = choose_mesh(dev)
    model = build_model(cfg, dtype=dtype, device=dev, remat=not smoke)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=max(10, steps // 20))

    shape = ShapeConfig("cli", seq, batch, "train")
    with activate_mesh(mesh):
        sh = ST.shard_model(mesh, model, cfg, shape)
        param_sh, opt_sh = sh["params"], sh["opt"]
        params = dict(model.named_parameters())
        opt_state = adamw_init(params, opt_sh)
        start = 0
        ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
        if ckpt_dir and resume:
            s = latest_step(ckpt_dir)
            if s is not None:
                state = restore_checkpoint(
                    ckpt_dir, s, {"params": params, "opt": opt_state},
                    shardings={"params": param_sh,
                               "opt": dict(opt_sh, step=None)})
                with torch.no_grad():
                    for name, p in params.items():
                        p.copy_(state["params"][name])
                opt_state = state["opt"]
                start = s
                print(f"resumed from step {s}")

        step_fn = ST.make_train_step(
            model, opt_cfg,
            _ef_compression(params) if compress_grads else None)
        ds = SyntheticLMDataset(cfg.vocab, seq, batch)
        it = make_batch_iter(ds, start, steps - start, mesh=mesh,
                             dp_axes=data_axes(mesh))
        mon = StragglerMonitor()
        losses = []
        for i, host_batch in zip(range(start, steps), it):
            t0 = time.time()
            opt_state, metrics = step_fn(opt_state, host_batch)
            loss = float(metrics["loss"])             # waits for the step
            losses.append(loss)
            dt = time.time() - t0
            mon.record(i, dt)
            if i % log_every == 0 or i == steps - 1:
                print(f"step {i:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f}ms",
                      flush=True)
            if ckpt and (i + 1) % ckpt_every == 0:
                ckpt.save(i + 1, {"params": params, "opt": opt_state})
        if ckpt:
            ckpt.save(steps, {"params": params, "opt": opt_state})
            ckpt.wait()
        if mon.flagged:
            print(f"straggler steps flagged: {len(mon.flagged)}")
        return losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradient compression with error feedback")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    losses = train(args.arch, args.steps, args.batch, args.seq, args.smoke,
                   args.ckpt_dir, args.ckpt_every, args.lr,
                   compress_grads=args.compress_grads, device=args.device)
    first = np.mean(losses[:10])
    last = np.mean(losses[-10:])
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()
