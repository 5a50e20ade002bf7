"""Process side of the mesh tests (``test_torch_mesh.py``,
``test_torch_moe_shard.py``): gloo ranks on the CPU that run the port's
sharded train step, ``train()``, the resharding restore and the
expert-parallel MoE block, and write what rank 0 gathered to files the
test reads.  Imports the port only (no jax), so that each spawned process
starts in a second or two.

:func:`start_group` spawns `world` processes, each joining one process
group over a ``FileStore`` (no TCP port, so parallel test workers never
collide) and running the jobs in order; :func:`join_group` waits for
them, and a rank that fails or outlives the deadline fails the call with
its traceback, every process stopped.
"""
from __future__ import annotations

import os
import time
import traceback
from typing import Dict, List

import torch

B = 2                              # batch rows; divides every data axis here
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)
N_STEPS = 3


def start_group(world: int, jobs: List[dict], work_dir: str,
                deadline_s: float = 120.0) -> tuple:
    """Spawns the group's `world` processes and returns at once; the
    caller may work meanwhile, then :func:`join_group` waits."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    store = os.path.join(work_dir, f"store_{world}_{time.monotonic_ns()}")
    procs = [ctx.Process(target=_child, args=(r, world, store, work_dir, jobs))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, time.monotonic() + deadline_s, work_dir, deadline_s


def join_group(group: tuple) -> None:
    procs, end, work_dir, deadline_s = group
    try:
        while any(p.is_alive() for p in procs):
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > end:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    errors = []
    for r, p in enumerate(procs):
        path = os.path.join(work_dir, f"error_{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    if errors:
        raise AssertionError("mesh group failed (or passed its "
                             f"{deadline_s:.0f} s deadline):\n"
                             + "\n".join(errors))


def _child(rank: int, world: int, store: str, work_dir: str,
           jobs: List[dict]) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        for job in jobs:
            out = JOBS[job["kind"]](job)
            if rank == 0 and out is not None:
                torch.save(out, os.path.join(work_dir, job["out"]))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(work_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _full(x):
    """x whole (it may share storage with x's local shard)."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _model(job: dict):
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    cfg = get_arch(job["arch"]).smoke()
    dtype = getattr(torch, job.get("dtype", "float32"))
    m = build_model(cfg, dtype=dtype, device="cpu",
                    remat=job.get("remat", False))
    m.load_state_dict(torch.load(job["params"]), strict=True)
    return cfg, m


def _sharded(job: dict):
    """The model placed on the job's mesh, its shardings and batches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticLMDataset, make_batch_iter
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import data_axes, make_mesh
    cfg, model = _model(job)
    b = job.get("batch", B)
    mesh = make_mesh(tuple(job["mesh"]), ("data", "model"), device="cpu")
    sh = ST.shard_model(mesh, model, cfg,
                        ShapeConfig("t", job["seq"], b, "train"))
    ds = SyntheticLMDataset(cfg.vocab, job["seq"], b)
    batches = list(make_batch_iter(ds, 0, job.get("steps", N_STEPS),
                                   mesh=mesh, dp_axes=data_axes(mesh)))
    return model, mesh, sh, batches


def _gathered(model, state) -> Dict:
    return {"params": {n: _full(p).detach().clone()
                       for n, p in model.named_parameters()},
            "m": {n: _full(t).clone() for n, t in state["m"].items()},
            "v": {n: _full(t).clone() for n, t in state["v"].items()}}


def steps_job(job: dict) -> Dict:
    """The gradient at the loaded parameters on batch 0, then the job's
    AdamW steps (N_STEPS unless it says) (the state after the first gathered whole), every tensor
    gathered whole.  Also the placements the residual stream left each
    block with, each moment's local and whole size, the CPU attention's
    and Mamba scan's calls through ``local_map``, the loss's calls of the
    vocab-parallel NLL, and whether one update from a gradient
    whose norm is under the clip equals the unsharded update bit for
    bit."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tf_mod
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    t0 = time.perf_counter()
    model, mesh, sh, batches = _sharded(job)
    hidden = []
    constrain = model._constrain

    def recording(x):
        y = constrain(x)
        hidden.append([str(p) for p in y.placements])
        return y
    model._constrain = recording
    chunked, calls = attn_mod._chunked, []

    def counting(q, k, v):
        calls.append((type(q).__name__, tuple(q.shape), tuple(k.shape)))
        return chunked(q, k, v)
    attn_mod._chunked = counting
    ssm_local, ssm_calls = ssm_mod._ssm_local, []

    def counting_ssm(u, *rest):
        ssm_calls.append((type(u).__name__, tuple(u.shape)))
        return ssm_local(u, *rest)
    ssm_mod._ssm_local = counting_ssm
    vocab_nll, nll_calls = tf_mod.vocab_parallel_nll, []
    split_dims, losses_seen = tf_mod.vocab_split_dims, []

    def counting_nll(logits, labels):
        nll_calls.append([str(p) for p in logits.placements])
        return vocab_nll(logits, labels)

    def seeing(logits):
        losses_seen.append([str(p) for p in logits.placements])
        return split_dims(logits)
    tf_mod.vocab_parallel_nll = counting_nll
    tf_mod.vocab_split_dims = seeing
    opt = AdamWConfig(**OPT)
    opt_sh = sh["opt"]
    try:
        model.requires_grad_(True)
        t1 = time.perf_counter()
        loss0, grads = ST.loss_and_grads(model, batches[0])
        t2 = time.perf_counter()
        model.zero_grad(set_to_none=True)
        step = ST.make_train_step(model, opt)
        params = dict(model.named_parameters())
        state = adamw_init(params, opt_sh)
        losses, gnorms, first = [], [], None
        for b in batches:
            state, met = step(state, b)
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
            if first is None:
                first = _gathered(model, state)
    finally:
        attn_mod._chunked = chunked
        ssm_mod._ssm_local = ssm_local
        tf_mod.vocab_parallel_nll = vocab_nll
        tf_mod.vocab_split_dims = split_dims
        model._constrain = constrain
    # one update from the same gradient, scaled under the clip (scale 1
    # whatever order the norm's sum takes): sharded == unsharded
    small = {n: g * 1e-3 for n, g in grads.items()}
    plain_p = {n: _full(p).detach().clone() for n, p in params.items()}
    plain_s = {"m": {n: _full(t).clone() for n, t in state["m"].items()},
               "v": {n: _full(t).clone() for n, t in state["v"].items()},
               "step": state["step"].clone()}
    adamw_update(opt, {n: _full(g) for n, g in small.items()}, plain_s,
                 plain_p)
    state, _ = adamw_update(opt, small, state, params)
    after = _gathered(model, state)
    same = all(torch.equal(after["params"][n], plain_p[n])
               and torch.equal(after["m"][n], plain_s["m"][n])
               and torch.equal(after["v"][n], plain_s["v"][n])
               for n in params)
    zero1 = {n: (m.to_local().numel(), m.numel(),
                 [str(p) for p in m.placements])
             for n, m in state["m"].items()}
    return {"loss0": float(loss0),
            "grads": {n: _full(g) for n, g in grads.items()},
            "losses": losses, "gnorms": gnorms, "step1": first,
            "update_equal": same, "hidden": hidden, "zero1": zero1,
            "chunked_calls": calls, "ssm_calls": ssm_calls,
            "nll_calls": nll_calls, "loss_logits": losses_seen,
            "seconds": (t1 - t0, t2 - t1, time.perf_counter() - t2),
            "param_placements": {n: [str(p) for p in t.placements]
                                 for n, t in params.items()}}


def train_job(job: dict) -> Dict:
    """``train()`` under ``choose_mesh()`` on this world."""
    from repro_torch.launch.train import choose_mesh, train
    mesh = choose_mesh("cpu")
    losses = train(job["arch"], steps=job["steps"], batch=job["batch"],
                   seq=job["seq"], smoke=True, ckpt_dir=None,
                   log_every=1000, device="cpu")
    return {"losses": losses, "mesh": tuple(mesh.mesh.shape),
            "axes": tuple(mesh.mesh_dim_names)}


def save_job(job: dict) -> Dict:
    """One step on the job's mesh, then a checkpoint of the parameters
    and moments; returns what was saved, gathered whole."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch import steps as ST
    from repro_torch.optim import AdamWConfig, adamw_init
    model, mesh, sh, batches = _sharded(job)
    step = ST.make_train_step(model, AdamWConfig(**OPT))
    params = dict(model.named_parameters())
    state = adamw_init(params, sh["opt"])
    state, _ = step(state, batches[0])
    tree = {"params": params, "opt": state}
    save_checkpoint(job["dir"], 1, tree)
    return {"params": {n: _full(p).detach().clone()
                       for n, p in params.items()},
            "m": {n: _full(t) for n, t in state["m"].items()},
            "v": {n: _full(t) for n, t in state["v"].items()},
            "step": int(state["step"])}


def restore_job(job: dict) -> Dict:
    """The checkpoint restored onto the job's mesh with its shardings:
    each leaf's placements and whole value."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw_init
    cfg, model = _model(job)
    mesh = make_mesh(tuple(job["mesh"]), ("data", "model"), device="cpu")
    sh = ST.shardings_for(mesh, model, cfg,
                          ShapeConfig("t", job["seq"], B, "train"))
    params = dict(model.named_parameters())
    like = {"params": params, "opt": adamw_init(params)}
    opt_sh = ST.named(mesh, sh["opt"])
    got = restore_checkpoint(job["dir"], 1, like, shardings={
        "params": ST.named(mesh, sh["params"]),
        "opt": dict(opt_sh, step=None)})
    want_pl = {n: s.placements for n, s in opt_sh["m"].items()}
    placed = all(tuple(got["opt"]["m"][n].placements) == want_pl[n]
                 for n in want_pl)
    return {"params": {n: _full(t) for n, t in got["params"].items()},
            "m": {n: _full(t) for n, t in got["opt"]["m"].items()},
            "v": {n: _full(t) for n, t in got["opt"]["v"].items()},
            "step": int(got["opt"]["step"]), "placed": placed,
            "local": {n: t.to_local().numel()
                      for n, t in got["opt"]["m"].items()}}


AUX_W = 0.37                       # the aux loss's weight in moe jobs' loss


def _placed(t, mesh, spec, requires_grad=True):
    """The whole tensor t (the same on every rank) as a DTensor in spec's
    placements, a leaf that requires grad."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.dtensor import to_placements
    d = distribute_tensor(t.detach(), mesh, to_placements(mesh, spec, t.dim()),
                          src_data_rank=None)
    return d.requires_grad_(requires_grad)


def moe_block_job(job: dict) -> Dict:
    """``moe_block_sharded`` on each of the job's cases whose mesh has this
    world's size: the inputs of ``job["inputs"]`` placed as the model
    places them (x split over data, expert stacks over model, the router
    and shared expert replicated), loss = sum(out * r) + AUX_W aux, and
    out, aux and every gradient gathered whole.  Also the placements of
    the block's output and aux, and of a dispatch buffer constrained by
    ``moe.constrain`` to ``P("data", "model")``."""
    import numpy as np
    from types import SimpleNamespace
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.dtensor import P
    from repro_torch.models.moe_shard import moe_block_sharded
    world = torch.distributed.get_world_size()
    inp = {k: torch.from_numpy(v) for k, v in np.load(job["inputs"]).items()}
    out = {}
    for case in job["cases"]:
        if int(np.prod(case["mesh"])) != world:
            continue
        mesh = make_mesh(tuple(case["mesh"]), ("data", "model"), device="cpu")
        dt = getattr(torch, case["dtype"])
        w = {k: _placed(inp[k].to(dt), mesh, P("model"))
             for k in ("w_gate", "w_up", "w_down")}
        p = SimpleNamespace(router=_placed(inp["router"], mesh, P()), **w,
                            shared=None)
        if case["shared"]:
            p.shared = SimpleNamespace(gated=True, b_down=None, **{
                k: _placed(inp["shared_" + k].to(dt), mesh, P())
                for k in ("w_gate", "w_up", "w_down")})
        x = _placed(inp["x"].to(dt), mesh, P("data"))
        y, aux = moe_block_sharded(
            p, x, n_experts=case["n_experts"], top_k=case["top_k"],
            mesh=mesh, dp_axes=("data",), capacity_factor=case["capacity"])
        loss = (y.full_tensor().float() * inp["r"]).sum() \
            + AUX_W * aux.full_tensor()
        loss.backward()
        grads = {"x": x.grad, "router": p.router.grad,
                 **{k: t.grad for k, t in w.items()}}
        if p.shared is not None:
            grads.update({f"shared/{k}": getattr(p.shared, k).grad
                          for k in ("w_gate", "w_up", "w_down")})
        buf = _placed(torch.zeros(2, 8, 3, 4), mesh, P(), False)
        out[case["tag"]] = {
            "out": _full(y).detach().float(), "aux": float(_full(aux)),
            "grads": {k: _full(g).float() for k, g in grads.items()},
            "placements": ([str(q) for q in y.placements],
                           [str(q) for q in aux.placements]),
            "buf": [str(q) for q in moe_mod.constrain(
                buf, P("data", "model")).placements]}
    return out


def moe_decode_job(job: dict) -> Dict:
    """``moe_block_grouped`` (the decode step's block) on each of the
    job's meshes with this world's size: x's batch rows split over data,
    the expert stacks split over model on the experts (``split="expert"``)
    or on the FF dim (``"ff"``), the router and shared expert replicated,
    the dispatch groups the data shards; the output gathered whole, with
    its placements and the local shape of x the block saw."""
    import numpy as np
    from types import SimpleNamespace
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.dtensor import P
    from repro_torch.models.moe_shard import moe_block_grouped
    world = torch.distributed.get_world_size()
    inp = {k: torch.from_numpy(v) for k, v in np.load(job["inputs"]).items()}
    out = {}
    for case in job["cases"]:
        if int(np.prod(case["mesh"])) != world:
            continue
        mesh = make_mesh(tuple(case["mesh"]), ("data", "model"), device="cpu")
        specs = {"expert": {k: P("model") for k in ("w_gate", "w_up",
                                                    "w_down")},
                 "ff": {"w_gate": P(None, None, "model"),
                        "w_up": P(None, None, "model"),
                        "w_down": P(None, "model")}}[case["split"]]
        w = {k: _placed(inp[k], mesh, specs[k], False) for k in specs}
        p = SimpleNamespace(router=_placed(inp["router"], mesh, P(), False),
                            shared=None, **w)
        if case["shared"]:
            p.shared = SimpleNamespace(gated=True, b_down=None, **{
                k: _placed(inp["shared_" + k], mesh, P(), False)
                for k in ("w_gate", "w_up", "w_down")})
        x = _placed(inp["x"], mesh, P("data"), False)
        with torch.no_grad():
            y = moe_block_grouped(
                p, x, n_experts=case["n_experts"], top_k=case["top_k"],
                n_groups=case["mesh"][0], capacity_factor=case["capacity"],
                buf_pspec=P("data", "model", None, None))
        out[case["tag"]] = {"out": _full(y).detach(),
                            "placements": [str(q) for q in y.placements]}
    return out


def einsum_job(job: dict) -> Dict:
    """``local_einsum`` on each of the job's cases whose mesh has this
    world's size: seeded fp32 operands (the same on every rank) placed by
    the case's specs, the output gathered whole beside ``torch.einsum`` of
    the whole operands, and the output's placements."""
    import numpy as np
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.dtensor import P, local_einsum
    world = torch.distributed.get_world_size()
    out = {}
    for case in job["cases"]:
        if int(np.prod(case["mesh"])) != world:
            continue
        mesh = make_mesh(tuple(case["mesh"]), ("data", "model"), device="cpu")
        rng = np.random.default_rng(case["seed"])
        whole = [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) for shape in case["shapes"]]
        xs = [_placed(t, mesh, P(*spec), False)
              for t, spec in zip(whole, case["specs"])]
        y = local_einsum(case["eq"], *xs)
        out[case["tag"]] = {"out": _full(y), "want": torch.einsum(
            case["eq"], *whole), "placements": [str(q) for q in y.placements]}
    return out


def moe_model_job(job: dict) -> Dict:
    """The smoke model on the job's mesh with ``moe_impl="shard_map"``:
    loss and every gradient (gathered whole) on batch 0."""
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import data_axes
    from repro_torch.models import moe_shard as ms_mod
    job = dict(job, steps=1)
    model, mesh, sh, batches = _sharded(job)
    model.moe_impl, model.moe_mesh = "shard_map", mesh
    model.moe_dp_axes = data_axes(mesh)
    model.moe_capacity = job.get("capacity", model.moe_capacity)
    model.requires_grad_(True)
    a2a, sent = ms_mod.funcol.all_to_all_single_autograd, []

    def recording(t, *rest):
        sent.append(tuple(t.shape))
        return a2a(t, *rest)
    ms_mod.funcol.all_to_all_single_autograd = recording
    try:
        loss, grads = ST.loss_and_grads(model, batches[0])
    finally:
        ms_mod.funcol.all_to_all_single_autograd = a2a
    params = dict(model.named_parameters())
    return {"loss": float(loss),
            "grads": {n: _full(g) for n, g in grads.items()},
            "all_to_all": sent,
            "param_placements": {n: [str(p) for p in t.placements]
                                 for n, t in params.items()},
            "expert_local": {n: tuple(t.to_local().shape)
                             for n, t in params.items() if ".w_up" in n}}


def vocab_nll_job(job: dict) -> Dict:
    """``Model.loss`` from the logits of ``job["inputs"]`` placed as the
    model's are (batch rows over data, vocab over model), on each of the
    job's meshes with this world's size: the loss and the logits'
    gradient gathered whole, the per-position NLL's placements and the
    vocab dims the loss saw."""
    import numpy as np
    from types import SimpleNamespace
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.dtensor import P, vocab_split_dims
    from repro_torch.models.transformer import Model
    world = torch.distributed.get_world_size()
    inp = {k: torch.from_numpy(v) for k, v in np.load(job["inputs"]).items()}
    out = {}
    for shape in job["meshes"]:
        if int(np.prod(shape)) != world:
            continue
        mesh = make_mesh(tuple(shape), ("data", "model"), device="cpu")
        lg = _placed(inp["logits"], mesh, P("data", None, "model"))
        lab = _placed(inp["labels"], mesh, P("data"), False)
        aux = torch.tensor(0.25)
        model = SimpleNamespace(embed=lg,
                                forward=lambda b, collect_aux: (lg, aux))
        loss = Model.loss(model, {"labels": lab})
        loss.backward()
        out[tuple(shape)] = {"loss": _full(loss).detach(),
                             "grad": _full(lg.grad),
                             "vocab_dims": vocab_split_dims(lg)}
    return out


JOBS = {"steps": steps_job, "train": train_job, "save": save_job,
        "restore": restore_job, "moe_block": moe_block_job,
        "moe_decode": moe_decode_job, "einsum": einsum_job,
        "moe_model": moe_model_job, "vocab_nll": vocab_nll_job}
