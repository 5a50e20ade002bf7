"""Multi-pod dry run: trace every (architecture x input shape x mesh) cell
on a world of fake ranks and count each device's work.

The port's counterpart of ``repro.launch.dryrun``.  Usage (its own
process, as the reference's)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape decode_32k --mesh multi --out build/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The process joins torch's ``fake`` process group of 256 (single pod,
(data 16, model 16)) or 512 ranks (multi-pod, (pod 2, data 16, model
16)) as rank 0, and :func:`~repro_torch.launch.mesh.make_production_mesh`
builds the mesh on it.  The parameters, optimizer moments, batch and
decode cache are fake tensors placed as ``steps.shardings_for`` says, and
the step runs once on them: nothing is allocated on any device, no kernel
runs and no collective moves data, so no card is touched, with a card or
without.  The fake tensors are CPU-typed, so the step runs inside
``models.attention.kernel_route``: the attention takes the kernel's
wrapper, which traces its plain version (``flash_attention_plain``,
counted unfused, block by block) and keeps for a train step's backward
what the card keeps (q, k, v, the output and lse), not the per-block
scores that autograd through ``chunked_attention`` would; each scan
(``ssm_scan``, ``rwkv6_scan``) is one counted op forward and one
backward (``ssm_scan_counted``, ``rwkv6_scan_counted``): its FLOPs the
plain recurrence's products, its bytes its inputs' and outputs' (counted
fused, as the kernel reads and writes them), and its temporaries the
card's (the saving forward's checkpoints, the chunk states' workspace),
where the recurrence traced one time step at a time took minutes a
layer.  This is the counterpart of the reference counting
``chunked_attention`` and ``lax.scan`` through XLA.

The MoE fields are set as the reference's ``run_cell`` sets them: the
dense dispatch's groups from the data axes and its buffer spec over
(data axes, "model"), and for train and prefill cells the expert-parallel
block (``moe_impl="shard_map"``) on the mesh.

Each cell's record (``<arch>__<shape>__<mesh>[__L<n>][__<policy>].json``
under ``--out``; a cell whose record says OK or SKIP is skipped as
``[cached]``) keeps the reference's schema where a field has a
counterpart, all counts per device (rank 0's):

* ``flops``: matmul-class FLOPs (``torch.utils.flop_counter``'s rules:
  mm, bmm, addmm, baddbmm, convolutions, attention) of each local aten
  op, counted below DTensor on the local shards (DTensor's own counting
  mode sees the global op);
* ``bytes_accessed``: the bytes of each local aten op's tensor inputs
  and outputs (views excluded).  This count is unfused, so larger than
  XLA's, which keeps fused intermediates out of memory;
* ``collectives``: output bytes per kind of the functional collectives
  the step issues (:func:`count_collectives`, the counterpart of
  ``parse_collectives``; the port has no HLO text to parse), under the
  reference's keys ``all-gather``, ``all-reduce``, ``reduce-scatter``,
  ``all-to-all``.  On a CPU mesh DTensor moves a shard from one dim to
  another by an all-gather (its all-to-all is for CUDA meshes), so such
  moves count as all-gathers, and every all-to-all is the expert-parallel
  MoE block's;
* ``memory``: ``argument_size_in_bytes`` (the local shards of the step's
  inputs), ``output_size_in_bytes`` (the local shards of what the step
  returns, and of the parameters and cache it updates in place, which the
  reference's step returns) and ``temp_size_in_bytes`` (the peak of the
  bytes of the tensors the step allocates and keeps alive at once);
* ``roofline``: :func:`roofline_terms` of the three, at one H100 SXM5's
  datasheet rates (NVIDIA H100 Tensor Core GPU datasheet, SXM5 column):
  989 TFLOP/s dense bf16 (``PEAK_FLOPS``), 3.35 TB/s HBM3 (``HBM_BW``)
  and, for the collective term, one NVLink 4 link, 25 GB/s each way of
  the 900 GB/s over 18 links (``LINK_BW``): a hop is one link, as the
  reference's ICI term takes one link per collective hop.  These are
  datasheet constants, not measurements.

Left out, having no counterpart: ``generated_code_size_in_bytes`` (no
program is compiled) and ``compile_s`` (nothing compiles; ``lower_s`` is
the trace's wall time).  The reference's ``scan_unroll`` has none either:
the port's layers are an ``nn.ModuleList`` and every layer is traced, so
``--layers`` only cuts the depth.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import data_axes, make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.attention import kernel_route
from repro_torch.models.dtensor import P
from repro_torch.optim import AdamWConfig, adamw_init

# ---- hardware constants: one NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor
# Core GPU datasheet, SXM5 column).  Datasheet figures, not measurements.
PEAK_FLOPS = 989e12     # bf16 dense tensor-core FLOP/s (1,979 with sparsity)
HBM_BW = 3.35e12        # HBM3 bytes/s
# NVLink 4: 900 GB/s per GPU over its 18 links, both directions together;
# one hop is one link, 25 GB/s each way (the reference's ICI_BW is also
# one link per collective hop)
LINK_BW = 25e9

WORLD = {False: 256, True: 512}

# functional collectives -> the reference's HLO collective names
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D = ("_c10d_functional", "c10d_functional")


def roofline_terms(flops: float, bytes_acc: float, coll: Dict[str, float]):
    """The three roofline terms, in seconds per step per card."""
    comm_bytes = sum(coll.values())
    return {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_acc / HBM_BW,
        "collective_s": comm_bytes / LINK_BW,
        "collective_bytes": comm_bytes,
    }


def fake_world(world: int) -> None:
    """Make this process rank 0 of a fake process group of `world` ranks
    (a group of another size is torn down first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """The bytes of the local shards of the tensors in `tree` (each
    storage once)."""
    seen, total = set(), 0
    for t in _tensors(tree):
        t = _local(t)
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


class Counter:
    """Per-device counts of the ops run inside :meth:`counting`: FLOPs,
    bytes accessed, collective bytes by kind, and the peak of the live
    bytes allocated meanwhile.  :meth:`active` enters a ``FakeTensorMode``
    that sees each local op (DTensor hands its local shards down to it);
    the op on the DTensors themselves is not counted."""

    def __init__(self):
        from torch._subclasses.fake_tensor import FakeTensorMode
        counter = self

        class _Mode(FakeTensorMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                # ops the fake mode runs inside an op (decompositions)
                # are that op's, not counted again
                top = counter._depth == 0
                counter._depth += 1
                try:
                    out = super().__torch_dispatch__(func, types, args,
                                                     kwargs)
                finally:
                    counter._depth -= 1
                if top and counter.on and out is not NotImplemented:
                    counter._record(func, args, kwargs, out)
                return out

        self.mode = _Mode(allow_non_fake_inputs=False)
        self._depth = 0
        self.on = False
        self.reset()

    def reset(self) -> None:
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}

    def _record(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        name = func._schema.name.split("::")[-1]
        outs = list(_tensors(out))
        if func.namespace in _C10D:
            if name != "wait_tensor":
                kind = COLLECTIVE_KINDS.get(name, name)
                self.collectives[kind] = self.collectives.get(kind, 0.0) + \
                    sum(t.numel() * t.element_size() for t in outs)
            return
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        for t in outs:
            self._track(t)
        if func.is_view or not outs:         # an alias, or metadata only
            return
        self.bytes += sum(t.numel() * t.element_size()
                          for t in (*_tensors(args), *_tensors(kwargs),
                                    *outs))

    def _track(self, t: torch.Tensor) -> None:
        """Count t's storage as live until the last tensor on it seen
        here dies."""
        key = t.untyped_storage()._cdata
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [0, t.untyped_storage().nbytes()]
            self.live += ref[1]
            self.peak = max(self.peak, self.live)
        ref[0] += 1
        weakref.finalize(t, self._release, key, ref)

    def _release(self, key: int, ref: list) -> None:
        ref[0] -= 1
        if ref[0] == 0 and self._refs.get(key) is ref:
            del self._refs[key]
            self.live -= ref[1]

    @contextlib.contextmanager
    def active(self):
        """The fake mode, with DTensor's sharding propagation,
        redistribution planning and strided-shard sizes computed outside
        it: they compute on small real tensors (a strided shard's indices)
        and propagate shapes in a fake mode of their own, so none of their
        ops is counted."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor import _redistribute
        from torch.distributed.tensor._dispatch import OpDispatcher
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.distributed.tensor.placement_types import _StridedShard

        def outside(fn):
            def run(*a, **kw):
                with unset_fake_temporarily():
                    return fn(*a, **kw)
            return run

        patched = [(ShardingPropagator, "propagate"),
                   (ShardingPropagator, "_propagate_tensor_meta_non_cached"),
                   (_redistribute, "_gen_transform_infos_non_cached"),
                   (_StridedShard, "local_shard_size_and_offset")]
        # newer torch propagates from its C++ dispatch through this method;
        # outside the fake mode its sharding and redistribution plans are
        # cached (inside it DTensor takes itself to be tracing, and plans
        # every op afresh: minutes a cell on a 3-D mesh)
        if hasattr(OpDispatcher, "_propagate_op_sharding_dispatch_slow_path"):
            patched.append((OpDispatcher,
                            "_propagate_op_sharding_dispatch_slow_path"))
        saved = [getattr(o, n) for o, n in patched]
        for (o, n), fn in zip(patched, saved):
            setattr(o, n, outside(fn))
        try:
            with self.mode:
                yield self
        finally:
            for (o, n), fn in zip(patched, saved):
                setattr(o, n, fn)

    @contextlib.contextmanager
    def counting(self):
        """Count the ops run in the block (from zero), within
        :meth:`active`."""
        self.reset()
        self.on = True
        try:
            yield self
        finally:
            self.on = False


def count_collectives(fn, counter: Optional[Counter] = None
                      ) -> Dict[str, float]:
    """Output bytes per collective kind of the functional collectives
    that fn() issues, under the reference's names (``all-gather``,
    ``all-reduce``, ``reduce-scatter``, ``all-to-all``).  fn runs in
    `counter`'s fake mode (a new one when none is given)."""
    counter = counter or Counter()
    with counter.active(), counter.counting():
        fn()
    return dict(counter.collectives)


def _place(mesh, tree, specs):
    """`tree` (tensors in nested dicts and lists) with each tensor a
    DTensor holding its local shard of `specs`' placements (nothing is
    sent: the source is every rank's own copy)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.dtensor import to_placements
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, mesh, to_placements(
            mesh, specs, tree.dim()), src_data_rank=None)
    if isinstance(tree, dict):
        return {k: _place(mesh, v, specs[k]) if k in specs else v
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(mesh, v, s) for v, s in zip(tree, specs))
    return tree


def _set_moe_fields(model, mesh, cfg, sh, mode: str) -> None:
    """``run_cell``'s MoE fields: the dense dispatch grouped by the data
    axes with its buffer over (data, "model"); the expert-parallel block
    for train and prefill."""
    names = tuple(mesh.mesh_dim_names)
    model_size = mesh.size(names.index("model")) if "model" in names else 1
    e_tot = cfg.n_experts + cfg.expert_pad
    if cfg.n_experts and e_tot % max(model_size, 1) == 0:
        dp = data_axes(mesh)
        model.moe_groups = sh["divisors"][0]
        model.moe_buf_pspec = P(dp, "model", None, None)
        if mode != "decode":
            model.moe_impl = "shard_map"
            model.moe_mesh = mesh
            model.moe_dp_axes = dp


def build_cell(arch: str, shape_name: str, multi_pod: bool, counter: Counter,
               zero1: bool = True, layers: Optional[int] = None,
               policy: str = "tp"):
    """The cell's model, step and placed inputs, built in `counter`'s fake
    mode on the production mesh of a fake world (joined here).  Returns
    (step, args, in_place, model): ``step(*args)`` runs the cell's step,
    which updates `in_place` (the parameters of a train step, the decode
    cache) where the reference's step returns new ones."""
    cfg = ARCHS[arch]
    if layers is not None:
        nl = layers * cfg.attn_every if cfg.attn_every else layers
        cfg = dataclasses.replace(cfg, n_layers=nl,
                                  enc_layers=layers if cfg.enc_layers else 0)
    shape = SHAPES[shape_name]
    fake_world(WORLD[multi_pod])
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    with counter.active():
        model = build_model(cfg, remat=shape.mode == "train", device="cpu")
        sh = ST.shardings_for(mesh, model, cfg, shape, zero1=zero1,
                              policy=policy)
        _set_moe_fields(model, mesh, cfg, sh, shape.mode)
        placed = ST.shard_model(mesh, model, cfg, shape, zero1=zero1,
                                policy=policy)
        specs = ST.input_specs(cfg, shape)
        batch = _place(mesh, {k: torch.empty(v.shape, dtype=v.dtype)
                              for k, v in specs.items()}, sh["batch"])
        params = dict(model.named_parameters())
        if shape.mode == "train":
            opt = adamw_init(params, placed["opt"])
            step = ST.make_train_step(model, AdamWConfig())
            return step, (opt, batch), params, model
        if shape.mode == "prefill":
            return ST.make_prefill_step(model), (batch,), None, model
        enc = None
        if cfg.family == "audio":
            enc = torch.empty((shape.global_batch, cfg.enc_ctx, cfg.d_model),
                              dtype=torch.bfloat16)
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 enc_out=enc)
        cache = _place(mesh, cache, sh["cache"])
        return (ST.make_serve_step(model), (cache, batch["tokens"]), cache,
                model)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             zero1: bool = True, extra: Optional[dict] = None,
             layers: Optional[int] = None, policy: str = "tp") -> dict:
    """layers: cut the depth (in scan units, as the reference counts
    them: layers for most archs, Jamba periods for the hybrid one, both
    encoder and decoder layers for audio)."""
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "multi" if multi_pod else "single",
                 "layers_override": layers}
    if shape.name in cfg.skip_shapes:
        rec["status"] = "SKIP"
        rec["reason"] = ("full-attention arch: quadratic-history 500k decode"
                         if shape.name == "long_500k" else "n/a")
        return rec
    t0 = time.time()
    counter = Counter()
    step, args, in_place, model = build_cell(arch, shape_name, multi_pod,
                                             counter, zero1, layers, policy)
    rec["policy"] = policy
    params = dict(model.named_parameters())
    with counter.active():
        arg_bytes = local_bytes((args, params))
        with counter.counting(), kernel_route():
            out = step(*args)
        out_bytes = local_bytes((out, in_place))
    rec["lower_s"] = round(time.time() - t0, 1)
    rec["memory"] = {"argument_size_in_bytes": arg_bytes,
                     "output_size_in_bytes": out_bytes,
                     "temp_size_in_bytes": counter.peak}
    rec["flops"] = float(counter.flops)
    rec["bytes_accessed"] = float(counter.bytes)
    rec["collectives"] = dict(counter.collectives)
    rec["roofline"] = roofline_terms(rec["flops"], rec["bytes_accessed"],
                                     rec["collectives"])
    rec["status"] = "OK"
    if extra:
        rec.update(extra)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth cut for per-layer cost extraction")
    ap.add_argument("--policy", default="tp", choices=("tp", "fsdp", "dp"))
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                if args.layers is not None:
                    tag += f"__L{args.layers}"
                if args.policy != "tp":
                    tag += f"__{args.policy}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    with open(path) as f:
                        rec = json.load(f)
                    if rec.get("status") in ("OK", "SKIP"):
                        print(f"[cached] {tag}: {rec['status']}")
                        continue
                try:
                    rec = run_cell(arch, shape, mp, zero1=not args.no_zero1,
                                   layers=args.layers, policy=args.policy)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "status": "FAIL",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    n_fail += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "OK":
                    r = rec["roofline"]
                    print(f"{tag}: OK trace={rec['lower_s']}s "
                          f"compute={r['compute_s']:.4f}s "
                          f"mem={r['memory_s']:.4f}s "
                          f"coll={r['collective_s']:.4f}s "
                          f"temp={rec['memory']['temp_size_in_bytes'] / 2**30:.2f}GiB",
                          flush=True)
                else:
                    print(f"{tag}: {rec['status']} "
                          f"{rec.get('error', rec.get('reason', ''))}",
                          flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
