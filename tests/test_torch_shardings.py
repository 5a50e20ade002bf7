"""The port's spec rules (``repro_torch.launch.shardings`` and the
sharding half of ``repro_torch.launch.steps``) against the reference's
(``repro.launch.shardings``, ``repro.launch.steps``) on ``jax.eval_shape``
trees, at full width, on the production mesh sizes (single pod (16, 16),
multi-pod (2, 16, 16)) without devices: the port reads a ``MeshShape``,
the reference a stand-in with its mesh's ``axis_names``, ``shape`` and
``size``.

The port keeps one module per layer, so its parameter ``layers.3.attn.q.w``
is the reference's stacked leaf ``layers/attn/q/w`` with the layer dim
dropped (and the Jamba sub-layer dim too: ``layers.0.mamba.2.in_proj.w``).
The test learns that map from ``params_from_jax`` itself, on stand-in
leaves holding their own ids, and holds every spec to the reference's
stacked spec with those dims dropped, entry for entry.  The moments'
ZeRO-1 specs and the FSDP specs are chosen by shape: where the
reference's rule picks a stack dim (llama3.2-1b's 16 layers take the 16
data ranks), the port's per-layer leaf must get the reference's own rule
applied to its shape instead.
"""
import dataclasses
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as J_ARCHS, SHAPES as J_SHAPES
from repro.launch import shardings as JSH
from repro.launch import steps as JST
from repro.models import build_model as j_build
from repro.perfmodel import sweep as j_sweep_mod
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import shardings as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax

MODEL = 16
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
DP = {"single": (("data",), 16), "multi": (("pod", "data"), 32)}
BLOCK_LISTS = ("mamba", "moe", "mlp")


def _ref_mesh(kind):
    shape, axes = MESHES[kind]
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)),
                                 size=math.prod(shape))


def _port_mesh(kind):
    return MeshShape(*MESHES[kind])


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    """(reference eval_shape tree, port meta params, {port name:
    (reference path, stack dims)})."""
    cfg = J_ARCHS[arch]
    tree = jax.eval_shape(j_build(cfg).init, jax.random.key(0))
    flat = jax.tree_util.tree_leaves_with_path(tree)
    paths = [tuple(str(getattr(k, "key", k)) for k in p) for p, _ in flat]

    def stack_dims(path):
        if path[0] not in ("layers", "enc_layers"):
            return 0
        return 2 if cfg.family == "hybrid" and path[1] in BLOCK_LISTS else 1

    # each leaf replaced by its id over its stack dims: params_from_jax
    # tells which port name each (leaf, layer) went to
    ids = [np.full(leaf.shape[:stack_dims(p)], i, dtype=np.int64)
           for i, (p, (_, leaf)) in enumerate(zip(paths, flat))]
    stand_in = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree), ids)
    names = {n: (paths[int(t)], stack_dims(paths[int(t)]))
             for n, t in params_from_jax(cfg, stand_in).items()}
    port = ST.abstract_params(build_model(ARCHS[arch], device="meta"))
    return tree, port, names


def _ref_leaf(tree, path):
    node = tree
    for k in path:
        node = node[k]
    return node


def _dropped(spec, ndim, k):
    """A reference spec padded to its leaf's ndim, stack dims dropped."""
    parts = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return parts[k:]


def _uses_stack_dim(spec, k):
    return any(e is not None for e in tuple(spec)[:k])


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_param_specs_equal_the_reference(arch):
    tree, port, names = _abstract(arch)
    ref = JSH.param_specs(tree, MODEL)
    got = SH.param_specs(port, MODEL)
    assert set(got) == set(names) == set(port)
    assert len({p for p, _ in names.values()}) == len(jax.tree.leaves(tree))
    for n, spec in got.items():
        path, k = names[n]
        leaf = _ref_leaf(tree, path)
        assert tuple(port[n].shape) == leaf.shape[k:], n
        assert isinstance(spec, SH.PartitionSpec)
        assert tuple(spec) == _dropped(_ref_leaf(ref, path), leaf.ndim, k), \
            (n, spec, _ref_leaf(ref, path))


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
@pytest.mark.parametrize("kind", ["single", "multi"])
def test_cache_specs_equal_the_reference(arch, kind):
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    dp, dp_size = DP[kind]
    n_decode = 0
    for sname, shape in SHAPES.items():
        if shape.mode != "decode" or sname in cfg.skip_shapes:
            continue
        n_decode += 1
        got = SH.cache_spec(cfg, shape, dp, dp_size, MODEL)
        want = JSH.cache_spec(jcfg, J_SHAPES[sname], dp, dp_size, MODEL)
        cache = ST.abstract_cache(build_model(cfg, device="meta"), cfg, shape)
        _same_cache(got, want, cache, f"{arch}/{sname}/{kind}")
    assert n_decode >= 1


def _same_cache(got, want, cache, what):
    """The port's spec tree against the reference's: dicts key for key;
    a port list (per layer, per block, per Mamba sub-layer) stands for the
    reference's stacked leaves, whose stack dims it drops."""
    if isinstance(got, list):
        assert isinstance(cache, list) and len(got) == len(cache), what
        for g, c in zip(got, cache):
            _same_cache(g, _drop_one(want), c, what)
        return
    if isinstance(got, dict):
        assert set(got) == set(want) == set(cache), what
        for key in got:
            _same_cache(got[key], want[key], cache[key], f"{what}.{key}")
        return
    assert tuple(got) == tuple(want), (what, got, want)
    shape = tuple(getattr(cache, "shape", ()))
    assert len(tuple(got)) <= len(shape) or not shape, (what, got, shape)


def _drop_one(tree):
    if isinstance(tree, dict):
        return {k: _drop_one(v) for k, v in tree.items()}
    assert tree[0] is None, tree           # a stack dim is never sharded
    return JP(*tuple(tree)[1:])


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_batch_specs_equal_the_reference(arch):
    cfg = ARCHS[arch]
    for sname, shape in SHAPES.items():
        for kind in ("single", "multi"):
            dp, dp_size = DP[kind]
            got = SH.batch_spec(cfg, shape, dp, dp_size)
            want = JSH.batch_spec(J_ARCHS[arch], J_SHAPES[sname], dp, dp_size)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}, (arch, sname, kind)
    assert tuple(SH.hidden_spec(("pod", "data"))) == \
        tuple(JSH.hidden_spec(("pod", "data")))


def _moe_up(arch, **changes):
    cfg = dataclasses.replace(ARCHS[arch], **changes)
    port = ST.abstract_params(build_model(cfg, device="meta"))
    spec = SH.param_specs(port, MODEL)
    return spec["layers.0.moe.w_up"]


def test_moe_ep_rules():
    """qwen2-moe pads 60 -> 64 experts so EP applies on a 16-mesh;
    arctic (128) EP-shards natively; an unpadded 60-expert stack falls
    back to TP on the expert FF dim — the reference's own cases."""
    assert tuple(_moe_up("qwen2-moe-a2.7b")) == ("model", None, None)
    assert tuple(_moe_up("arctic-480b")) == ("model", None, None)
    assert tuple(_moe_up("qwen2-moe-a2.7b", expert_pad=0)) == \
        (None, None, "model")


def test_whisper_vocab_fallback():
    """51865 doesn't divide 16: embed falls back to d_model sharding."""
    _, port, _ = _abstract("whisper-medium")
    assert tuple(SH.param_specs(port, MODEL)["embed"]) == (None, "model")


def test_gqa_cache_fallback():
    """kv=8 archs shard the KV sequence (flash-decode), kv>=16 shard
    heads."""
    nemo = SH.cache_spec(ARCHS["mistral-nemo-12b"], SHAPES["decode_32k"],
                         ("data",), 16, MODEL)
    cq = SH.cache_spec(ARCHS["codeqwen1.5-7b"], SHAPES["decode_32k"],
                       ("data",), 16, MODEL)
    assert nemo["k"][2] in ("model", ("model",)) and nemo["k"][3] is None
    assert cq["k"][3] == "model" and cq["k"][2] is None


def _sizes(kind):
    shape, axes = MESHES[kind]
    return dict(zip(axes, shape))


def _check_by_shape(got, want, port, names, tree, redo, what):
    """Each port spec is the reference's stacked spec with its stack dims
    dropped, or, where the reference's shape rule put an axis on a stack
    dim, the reference's rule (`redo`) applied to the port's leaf."""
    by_shape = 0
    for n, spec in got.items():
        path, k = names[n]
        ref = _ref_leaf(want, path)
        ndim = _ref_leaf(tree, path).ndim
        if _uses_stack_dim(ref, k):
            by_shape += 1
            assert tuple(spec) == tuple(redo(n, tuple(port[n].shape))), \
                (what, n, spec)
        else:
            assert tuple(spec) == _dropped(ref, ndim, k), (what, n, spec, ref)
    return by_shape


@pytest.mark.parametrize("policy", ["tp", "fsdp", "dp"])
@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_shardings_for_equals_the_reference(arch, kind, policy):
    tree, port, names = _abstract(arch)
    cfg = ARCHS[arch]
    shape_name = "decode_32k" if "decode_32k" not in cfg.skip_shapes \
        else "train_4k"
    jm = j_build(J_ARCHS[arch])
    want = JST.shardings_for(_ref_mesh(kind), jm, J_ARCHS[arch],
                             J_SHAPES[shape_name], policy=policy)
    got = ST.shardings_for(_port_mesh(kind), build_model(cfg, device="meta"),
                           cfg, SHAPES[shape_name], policy=policy)
    assert set(got) == set(want)
    assert got["divisors"] == tuple(want["divisors"])
    assert (got["hidden"] is None) == (want["hidden"] is None)
    if got["hidden"] is not None:
        assert tuple(got["hidden"]) == tuple(want["hidden"])
    assert {k: tuple(v) for k, v in got["batch"].items()} == \
        {k: tuple(v) for k, v in want["batch"].items()}
    if "cache" in want:
        cache = ST.abstract_cache(build_model(cfg, device="meta"), cfg,
                                  SHAPES[shape_name])
        _same_cache(got["cache"], want["cache"], cache, arch)
    all_axes, total = MESHES[kind][1], math.prod(MESHES[kind][0])
    if policy == "fsdp":
        _check_by_shape(got["params"], want["params"], port, names, tree,
                        lambda n, s: JSH.fsdp_param_spec(
                            (), jax.ShapeDtypeStruct(s, jnp.float32),
                            all_axes, total), arch)
    else:
        assert _check_by_shape(got["params"], want["params"], port, names,
                               tree, None, arch) == 0
    if policy == "tp":
        dp, dp_size = DP[kind]
        zero = lambda n, s: JST._zero1_checked(JP(*got["params"][n]), dp,
                                               dp_size, s)
    elif policy == "dp":
        zero = lambda n, s: JST._zero1_checked(
            JP(*got["params"][n]), all_axes, total, s, _sizes(kind))
    else:
        zero = lambda n, s: got["params"][n]
    for key in ("m", "v"):
        _check_by_shape(got["opt"][key], want["opt"][key], port, names,
                        tree, zero, f"{arch} opt.{key}")
    assert tuple(got["opt"]["step"]) == tuple(want["opt"]["step"]) == ()


def test_zero1_by_shape_differs_only_where_the_reference_takes_the_layer_dim():
    """llama3.2-1b's 16 layers divide the 16 data ranks: the reference
    puts the moment's data axis on the layer dim of q.w (16, 2048, 2048);
    the port's per-layer q.w (2048, 2048) takes it on its first free dim."""
    want = JST.shardings_for(_ref_mesh("single"), j_build(
        J_ARCHS["llama3.2-1b"]), J_ARCHS["llama3.2-1b"],
        J_SHAPES["train_4k"])
    got = ST.shardings_for(_port_mesh("single"), build_model(
        ARCHS["llama3.2-1b"], device="meta"), ARCHS["llama3.2-1b"],
        SHAPES["train_4k"])
    assert tuple(want["opt"]["m"]["layers"]["attn"]["q"]["w"]) == \
        ("data", None, "model")
    assert tuple(got["opt"]["m"]["layers.0.attn.q.w"]) == ("data", "model")


SPECS = [(), (None,), ("model",), (None, "model"), ("model", None),
         (("pod", "data"), None), (None, None, "model"), ("data", None),
         (None, ("data", "model"))]
SHAPES_GRID = [(16,), (4096,), (60, 2048), (2048, 60), (32, 64, 64),
               (17, 32), (2, 16, 16), (8, 3), (65536, 4096)]


@pytest.mark.parametrize("dp,dp_size", [(("data",), 16), (("pod", "data"), 32),
                                        (("data",), 1), ((), 1)])
@pytest.mark.parametrize("sizes", [None, {"pod": 2, "data": 2, "model": 4}])
def test_zero1_checked_equals_the_reference(dp, dp_size, sizes):
    for spec in SPECS:
        for shape in SHAPES_GRID:
            if len(spec) > len(shape):
                continue
            got = ST._zero1_checked(SH.P(*spec), dp, dp_size, shape, sizes)
            want = JST._zero1_checked(JP(*spec), dp, dp_size, shape, sizes)
            assert tuple(got) == tuple(want), (spec, shape, dp, sizes)


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_input_specs_equal_the_reference(arch):
    cfg = ARCHS[arch]
    for sname, shape in SHAPES.items():
        got = ST.input_specs(cfg, shape)
        want = JST.input_specs(J_ARCHS[arch], J_SHAPES[sname])
        assert set(got) == set(want), (arch, sname)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[k].shape, (arch, sname, k)
            assert str(t.dtype).split(".")[-1] == str(want[k].dtype), \
                (arch, sname, k)


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_abstract_cache_equals_the_reference(arch):
    cfg = ARCHS[arch]
    model = build_model(cfg, device="meta")
    for sname, shape in SHAPES.items():
        if shape.mode != "decode" or sname in cfg.skip_shapes:
            continue
        got = ST.abstract_cache(model, cfg, shape)
        want = JST.abstract_cache(j_build(J_ARCHS[arch]), J_ARCHS[arch],
                                  J_SHAPES[sname])
        _same_leaves(got, want, f"{arch}/{sname}")


def _same_leaves(got, want, what):
    if isinstance(got, list):
        for i, g in enumerate(got):
            _same_leaves(g, jax.tree.map(lambda x: jax.ShapeDtypeStruct(
                x.shape[1:], x.dtype), want), f"{what}[{i}]")
        return
    if isinstance(got, dict):
        assert set(got) == set(want), what
        for k in got:
            _same_leaves(got[k], want[k], f"{what}.{k}")
        return
    if isinstance(got, int):                      # "len": a host int
        assert got == 0 and want.shape == (), what
        return
    assert got.device.type == "meta", what
    assert tuple(got.shape) == want.shape, (what, got.shape, want.shape)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), what


def test_abstract_params_allocate_nothing():
    model = build_model(ARCHS["arctic-480b"], device="meta")
    params = ST.abstract_params(model)
    assert all(p.device.type == "meta" for p in params.values())
    assert sum(p.numel() for p in params.values()) > 4e11


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MeshShape((2, 2), ("data", "model"))
    assert SH.to_placements(mesh, SH.P("data", None), 2) == \
        (Shard(0), Replicate())
    assert SH.to_placements(mesh, SH.P(None, "model"), 2) == \
        (Replicate(), Shard(1))
    assert SH.to_placements(mesh, SH.P(None, ("data", "model")), 2) == \
        (Shard(1), Shard(1))
    assert SH.to_placements(mesh, SH.P(), 3) == (Replicate(), Replicate())
    one = MeshShape((1, 4), ("data", "model"))
    assert SH.to_placements(one, SH.P("data", "model"), 2) == \
        (Replicate(), Shard(1))
    multi = MeshShape((2, 2, 2), ("pod", "data", "model"))
    assert SH.to_placements(multi, SH.P(("pod", "data"), "model"), 2) == \
        (Shard(0), Shard(0), Shard(1))


@pytest.mark.parametrize("spec,ndim,match", [
    (SH.P(("model", "data"), None), 2, "mesh's order"),
    (SH.P(("data", "pod")), 1, "mesh's order"),
    (SH.P("data", "data"), 2, "twice"),
    (SH.P("expert", None), 2, "names axis"),
    (SH.P(None, None, "model"), 2, "more entries")])
def test_to_placements_refuses_what_dtensor_cannot_place(spec, ndim, match):
    """DTensor splits a dim over mesh dims in mesh order: a tuple in
    another order is another layout, refused loudly."""
    mesh = MeshShape((2, 2, 2), ("pod", "data", "model"))
    with pytest.raises(ValueError, match=match):
        SH.to_placements(mesh, spec, ndim)


def test_named_carries_placements():
    mesh = MeshShape((2, 2), ("data", "model"))
    tree = ST.named(mesh, {"a": SH.P("data"), "b": [SH.P(None, "model")]})
    from torch.distributed.tensor import Replicate, Shard
    assert tree["a"].placements == (Shard(0), Replicate())
    assert tree["b"][0].placements == (Replicate(), Shard(1))
    assert tree["a"].mesh is mesh


# ---------------------------------------------------------------- sweep
def _ref_chunk(monkeypatch, n, chunk, backend):
    """The reference engine's chunk with `n` local devices: the device
    list, the mesh and the placement of its iota stood in for."""
    from repro.perfmodel import get_evaluator as j_get_evaluator
    dev = jax.devices()[0]
    with monkeypatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a: [dev] * n)
        mp.setattr(jax, "make_mesh", lambda *a, **k: object())
        mp.setattr(jax.sharding, "NamedSharding", lambda *a, **k: object())
        mp.setattr(jax, "device_put", lambda x, *a, **k: x)
        eng = j_sweep_mod.SweepEngine(j_get_evaluator("proxy"),
                                      chunk_size=chunk, shard=True,
                                      backend=backend, ref_point=np.ones(3))
    return eng.chunk_size


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("backend,ref_backend", [("roofline", "roofline"),
                                                 ("cuda", "pallas")])
def test_sweep_chunk_rounds_as_the_reference(monkeypatch, n, backend,
                                             ref_backend):
    """shard=True rounds the chunk up to a multiple of the device count,
    and on the kernel backend to lcm(devices, 256)."""
    from repro_torch.perfmodel import get_evaluator, sweep as sweep_mod
    monkeypatch.setattr(sweep_mod, "_device_count", lambda device: n)
    ev = get_evaluator("proxy", device="cpu")
    for chunk in (1_000, 4_097, 5_000, 131_072):
        eng = sweep_mod.SweepEngine(ev, chunk_size=chunk, shard=True,
                                    backend=backend, ref_point=np.ones(3))
        assert eng.chunk_size == _ref_chunk(monkeypatch, n, chunk,
                                            ref_backend), (n, chunk, backend)
        assert len(eng._shard_devs) == (n if n > 1 else 0)
        plain = sweep_mod.SweepEngine(ev, chunk_size=chunk, backend=backend,
                                      ref_point=np.ones(3))
        assert plain._shard_devs == []


@pytest.mark.parametrize("backend", ["roofline", "cuda"])
def test_sharded_sweep_equals_the_unsharded_one(monkeypatch, backend):
    """Each chunk split in 3 parts (here all on the CPU), evaluated part
    by part and joined in order: the same sweep bit for bit, and probe
    engines inherit the flag."""
    from repro_torch.perfmodel import get_evaluator, sweep as sweep_mod
    monkeypatch.setattr(sweep_mod, "_device_count", lambda device: 3)
    monkeypatch.setattr(sweep_mod, "_shard_devices",
                        lambda device, n: [device] * n)
    ev = get_evaluator("proxy", device="cpu")
    calls = []
    chunk_eval = sweep_mod.SweepEngine._chunk_eval

    def counting(self, idx):
        calls.append(idx.shape[0])
        return chunk_eval(self, idx)
    monkeypatch.setattr(sweep_mod.SweepEngine, "_chunk_eval", counting)
    kw = dict(chunk_size=6_000, stall_topk=4, backend=backend)
    eng = sweep_mod.SweepEngine(ev, shard=True, **kw)
    got = eng.run(0, 30_000)
    assert eng.chunk_size % 3 == 0
    assert calls == [eng.chunk_size // 3] * (3 * -(-30_000 // eng.chunk_size))
    want = sweep_mod.SweepEngine(ev, **dict(kw, chunk_size=eng.chunk_size)
                                 ).run(0, 30_000)
    assert got.n_superior == want.n_superior and got.n_evaluated == 30_000
    for f in ("topk_ids", "topk_val", "stall_topk_ids", "pareto_ids",
              "pareto_y"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    seen = []
    monkeypatch.setattr(sweep_mod.SweepEngine, "run",
                        lambda self, *a, **k: seen.append(self.shard)
                        or want)
    sweep_mod._CHUNK_AUTO_CACHE.clear()
    sweep_mod.SweepEngine(ev, chunk_size="auto", shard=True,
                          chunk_candidates=(3_000,), backend=backend)
    assert seen and all(seen)


# ---------------------------------------------------------------- the mesh
def test_mesh_helpers_on_a_mesh_of_one():
    from torch.distributed.tensor import Replicate, zeros
    from repro_torch.launch.mesh import (activate_mesh, axis_size, data_axes,
                                         make_mesh, make_production_mesh,
                                         mesh_devices)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    assert data_axes(mesh) == ("data",) and mesh_devices(mesh) == 1
    assert axis_size(mesh, "model") == 1 and axis_size(mesh, "pod") == 1
    multi = MeshShape(*MESHES["multi"])
    assert data_axes(multi) == ("pod", "data") and mesh_devices(multi) == 512
    with activate_mesh(mesh) as active:       # the ambient mesh
        t = zeros((2, 3), placements=(Replicate(), Replicate()))
    assert active is mesh and t.device_mesh is mesh
    with pytest.raises(ValueError, match="256 processes"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 processes"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="world of 4"):
        make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="distinct name"):
        make_mesh((1, 1), ("data", "data"), device="cpu")


@pytest.mark.parametrize("backend, ok", [
    ("gloo", {"cpu"}), ("nccl", {"cuda"}),
    ("cpu:gloo,cuda:nccl", {"cpu", "cuda"}), ("cpu:gloo", {"cpu"}),
    ("cuda:gloo,cpu:gloo", {"cpu"}), ("mpi", set())])
def test_mesh_refuses_a_group_whose_backend_does_not_suit_it(
        monkeypatch, backend, ok):
    """A mesh of CPU tensors needs gloo collectives and one of CUDA tensors
    nccl, from the process's group as it stands: a group another entry
    point started for the other device type is refused, never used."""
    from repro_torch.launch import mesh as mesh_mod
    monkeypatch.setattr(mesh_mod.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh_mod.dist, "get_world_size", lambda *a: 1)
    monkeypatch.setattr(mesh_mod.dist, "get_backend", lambda *a: backend)
    for dev in ("cpu", "cuda"):
        if dev in ok:
            mesh_mod._ensure_group(dev, 1)
        else:
            with pytest.raises(ValueError, match=mesh_mod.BACKENDS[dev]):
                mesh_mod._ensure_group(dev, 1)


@pytest.mark.parametrize("rows", [1, 2])
def test_batch_iter_places_batches_on_the_mesh(rows):
    """make_batch_iter(mesh=) gives DTensors holding the plain batch;
    the rows split over the data axes (a dim of one rank replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.data import SyntheticLMDataset, make_batch_iter
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    ds = SyntheticLMDataset(256, 16, rows)
    plain = list(make_batch_iter(ds, 3, 2, device="cpu"))
    placed = list(make_batch_iter(ds, 3, 2, mesh=mesh, dp_axes=("data",)))
    for p, d in zip(plain, placed):
        for k in ("tokens", "labels"):
            assert isinstance(d[k], DTensor)
            assert d[k].placements == (Replicate(), Replicate())
            assert torch.equal(d[k].full_tensor(), p[k])
