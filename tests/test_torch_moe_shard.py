"""The port's expert-parallel MoE block (``repro_torch.models.moe_shard``)
and ``Model``'s ``moe_impl="shard_map"`` on gloo meshes of CPU processes,
held to the reference's ``moe_block_sharded`` and ``Model.loss`` on host
CPU devices.

Three kinds of process run once per module, side by side where they can:

* the reference child (``_moe_shard_reference.py``): a process that sets
  ``--xla_force_host_platform_device_count=4`` before it imports jax and
  runs the reference's block and model on meshes (1, 2), (2, 1), (2, 2)
  and (1, 4) of host devices, ``jax.grad`` included;
* two gloo groups (``_torch_mesh_worker``: 2 ranks, then 4), which run
  the port on the same meshes from the same arrays;
* this process, which runs the port's own unsharded ``moe_block`` and
  model for the no-drop comparisons.

Block inputs come from ``np.random.default_rng(SEED)``: d 64, 6 experts
plus 2 zero-traffic ones, top-2, B 2, S 16, with and without a shared
expert, in fp32 and bf16; the loss is sum(out * r) + 0.37 aux.  Held:
outputs at rtol 1e-5 in fp32 (2e-2 in bf16, the reference kernel tests'
bf16 tolerance), the aux loss's value (data shard 0's, on (2, 2) too) and
every gradient within 1e-4 of max |g| + 1e-7 (2e-2 of max |g| in bf16).
At capacity_factor = n_experts (no drops) the sharded block equals the
port's own ``moe_block``: outputs on every mesh, gradients on the (1, mp)
meshes (with data shards, the aux gradient is the mean of the shards'
gradients, not the whole batch's).  The smoke qwen2-moe-a2.7b and jamba
with ``moe_impl="shard_map"``: loss equal to the reference's on (1, 2)
and (2, 2), every gradient equal to the reference's on (2, 2) and to the
port's unsharded model at no-drop capacity on (1, 2).
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import _torch_mesh_worker as W
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticLMDataset, make_batch_iter
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import build_model
from repro_torch.models import moe as moe_mod
from repro_torch.models.convert import params_from_jax
from repro_torch.models.moe_shard import moe_block_sharded

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SEED = 30
D, FF, SHARED_FF = 64, 32, 48
N_EXPERTS, PAD, TOP_K = 6, 2, 2
B, S = 2, 16
CAP, NO_DROP = 1.25, float(N_EXPERTS)
OUT_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_REL = {"float32": 1e-4, "bfloat16": 2e-2}
GRAD_ATOL = 1e-7
MODEL_ARCHS = ("qwen2-moe-a2.7b", "jamba-1.5-large-398b")
CHILD_TIMEOUT_S = 300


def _block(mesh, dtype="float32", shared=True, capacity=CAP, ref=True):
    tag = (f"{mesh[0]}x{mesh[1]}_{dtype}_{'shared' if shared else 'routed'}"
           f"_cap{capacity:g}")
    return dict(kind="block", tag=tag, mesh=list(mesh), dtype=dtype,
                shared=shared, capacity=capacity, n_experts=N_EXPERTS,
                top_k=TOP_K, ref=ref)


BLOCKS = ([_block(m) for m in ((1, 2), (2, 1), (2, 2), (1, 4))]
          + [_block(m, shared=False) for m in ((1, 2), (2, 2))]
          + [_block(m, "bfloat16") for m in ((2, 2), (1, 4))]
          + [_block((1, 2), "bfloat16", shared=False)]
          + [_block(m, capacity=NO_DROP, ref=False)
             for m in ((1, 2), (2, 1), (2, 2), (1, 4))])
REF_BLOCKS = [c for c in BLOCKS if c["ref"]]
NO_DROP_BLOCKS = [c for c in BLOCKS if not c["ref"]]


# the decode step's grouped block (moe_block_grouped): expert stacks split
# over model on the experts or on the FF dim, the data shards the groups
DECODES = [dict(tag=f"decode_{m[0]}x{m[1]}_{split}_"
                    f"{'shared' if shared else 'routed'}",
                mesh=list(m), split=split, shared=shared, capacity=CAP,
                n_experts=N_EXPERTS, top_k=TOP_K)
           for m in ((1, 2), (2, 1), (2, 2), (1, 4))
           for split in ("expert", "ff") for shared in (False, True)
           if not (m[1] == 1 and split == "ff")]


# models.dtensor.local_einsum, the decode step's products: GQA decode
# against a cache split on its KV heads or on its sequence (the
# flash-decode layout: the contraction over it is then a partial sum), and
# the RWKV state read with a replicated r sliced to the state's heads
EINSUMS = [dict(tag=f"einsum_{tag}_{m[0]}x{m[1]}", mesh=list(m), seed=i,
                eq=eq, shapes=shapes, specs=specs)
           for i, (tag, eq, shapes, specs) in enumerate([
               ("gqa_heads", "bkgd,bskd->bkgs",
                [(4, 4, 2, 8), (4, 12, 4, 8)],
                [("data", "model"), ("data", None, "model")]),
               ("gqa_seq", "bkgd,bskd->bkgs",
                [(4, 2, 3, 8), (4, 12, 2, 8)],
                [("data",), ("data", "model")]),
               ("gqa_seq_out", "bkgs,bskd->bkgd",
                [(4, 2, 3, 12), (4, 12, 2, 8)],
                [("data", None, None, "model"), ("data", "model")]),
               ("wkv", "bhk,bhkv->bhv",
                [(4, 4, 8), (4, 4, 8, 8)],
                [("data",), ("data", "model")])])
           for m in ((2, 2), (1, 4))]


def _model_tag(arch, mesh, capacity=None):
    tag = f"{arch}_{mesh[0]}x{mesh[1]}"
    return tag if capacity is None else f"{tag}_cap{capacity:g}"


# reference model cases: loss on (1, 2), loss and gradients on (2, 2)
REF_MODELS = [dict(kind="model", tag=_model_tag(a, m), arch=a, mesh=list(m),
                   seq=S, batch=B, grads=m == (2, 2))
              for a in MODEL_ARCHS for m in ((1, 2), (2, 2))]


def _inputs(path):
    rng = np.random.default_rng(SEED)
    e_tot = N_EXPERTS + PAD
    arr = {"x": rng.standard_normal((B, S, D)),
           "r": rng.standard_normal((B, S, D)),
           "router": rng.standard_normal((D, N_EXPERTS)) / np.sqrt(D),
           "w_gate": rng.standard_normal((e_tot, D, FF)) / np.sqrt(D),
           "w_up": rng.standard_normal((e_tot, D, FF)) / np.sqrt(D),
           "w_down": rng.standard_normal((e_tot, FF, D)) / np.sqrt(FF),
           "shared_w_gate": rng.standard_normal((D, SHARED_FF)) / np.sqrt(D),
           "shared_w_up": rng.standard_normal((D, SHARED_FF)) / np.sqrt(D),
           "shared_w_down": (rng.standard_normal((SHARED_FF, D))
                             / np.sqrt(SHARED_FF))}
    arr = {k: v.astype(np.float32) for k, v in arr.items()}
    np.savez(path, **arr)
    return arr


def _unflatten(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *path, leaf = key[len(prefix):].split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _port_moe(inp, dtype, shared):
    """The port's MoE module holding the block inputs, gradients on."""
    dt = getattr(torch, dtype)
    p = moe_mod.MoE(D, FF, N_EXPERTS, n_shared=int(shared),
                    shared_ff=SHARED_FF, expert_pad=PAD, dtype=dt,
                    device="cpu")
    with torch.no_grad():
        p.router.copy_(torch.from_numpy(inp["router"]))
        for k in ("w_gate", "w_up", "w_down"):
            getattr(p, k).copy_(torch.from_numpy(inp[k]))
            if shared:
                getattr(p.shared, k).copy_(torch.from_numpy(
                    inp["shared_" + k]))
    return p.requires_grad_(True)


def _dense_block(inp, case):
    """The port's unsharded moe_block on the block inputs: out, aux and
    the gradients of the same loss."""
    p = _port_moe(inp, case["dtype"], case["shared"])
    x = torch.from_numpy(inp["x"]).to(getattr(torch, case["dtype"]))
    x.requires_grad_(True)
    out, aux = moe_mod.moe_block(p, x, n_experts=N_EXPERTS, top_k=TOP_K,
                                 capacity_factor=case["capacity"])
    loss = (out.float() * torch.from_numpy(inp["r"])).sum() + W.AUX_W * aux
    loss.backward()
    grads = {"x": x.grad, **{n.replace(".", "/"): t.grad
                             for n, t in p.named_parameters()}}
    return {"out": out.detach().float(), "aux": float(aux.detach()),
            "grads": {k: g.float() for k, g in grads.items()}}


def _model(arch, params, capacity=CAP):
    m = build_model(get_arch(arch).smoke(), dtype=torch.float32,
                    device="cpu", remat=False, moe_capacity=capacity)
    m.load_state_dict(params, strict=True)
    return m.requires_grad_(True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from repro.configs import ARCHS as J_ARCHS
    from repro.models import build_model as j_build
    work = str(tmp_path_factory.mktemp("moe_shard"))
    inputs = os.path.join(work, "inputs.npz")
    inp = _inputs(inputs)
    params = {}
    for arch in MODEL_ARCHS:
        cfg = J_ARCHS[arch].smoke()
        jm = j_build(cfg, dtype=jax.numpy.float32, remat=False)
        params[arch] = params_from_jax(cfg, jax.jit(jm.init)(
            jax.random.key(0)))
        torch.save(params[arch], os.path.join(work, f"{arch}.pt"))
    cases = os.path.join(work, "cases.json")
    with open(cases, "w") as f:
        json.dump(REF_BLOCKS + REF_MODELS, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    ref_out = os.path.join(work, "reference.npz")
    child = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_moe_shard_reference.py"),
         inputs, cases, ref_out], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def jobs(world):
        blocks = [c for c in BLOCKS if np.prod(c["mesh"]) == world]
        out = [{"kind": "moe_block", "inputs": inputs, "cases": blocks,
                "out": f"blocks_{world}.pt"},
               {"kind": "moe_decode", "inputs": inputs,
                "cases": [c for c in DECODES
                          if np.prod(c["mesh"]) == world],
                "out": f"decode_{world}.pt"},
               {"kind": "einsum", "out": f"einsum_{world}.pt",
                "cases": [c for c in EINSUMS
                          if np.prod(c["mesh"]) == world]}]
        meshes = {2: [((1, 2), None), ((1, 2), NO_DROP)],
                  4: [((2, 2), None)]}[world]
        for arch in MODEL_ARCHS:
            for mesh, cap in meshes:
                job = {"kind": "moe_model", "arch": arch, "mesh": mesh,
                       "seq": S, "batch": B,
                       "params": os.path.join(work, f"{arch}.pt"),
                       "out": _model_tag(arch, mesh, cap) + ".pt"}
                if cap is not None:
                    job["capacity"] = cap
                out.append(job)
        return out

    try:
        group2 = W.start_group(2, jobs(2), work, deadline_s=180.0)
        try:
            dense = {c["tag"]: _dense_block(inp, c) for c in NO_DROP_BLOCKS}
            unsharded = {}
            for arch in MODEL_ARCHS:
                model = _model(arch, params[arch], NO_DROP)
                ds = SyntheticLMDataset(model.cfg.vocab, S, B)
                batch = next(iter(make_batch_iter(ds, 0, 1, device="cpu")))
                loss, grads = loss_and_grads(model, batch)
                unsharded[arch] = {"loss": float(loss), "grads": grads}
        finally:
            W.join_group(group2)
        W.join_group(W.start_group(4, jobs(4), work, deadline_s=180.0))
        log, _ = child.communicate(timeout=CHILD_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, log[-4000:]
    load = lambda name: torch.load(os.path.join(work, name))
    sharded = {**load("blocks_2.pt"), **load("blocks_4.pt")}
    models = {}
    for world, meshes in ((2, [((1, 2), None), ((1, 2), NO_DROP)]),
                          (4, [((2, 2), None)])):
        for arch in MODEL_ARCHS:
            for mesh, cap in meshes:
                tag = _model_tag(arch, mesh, cap)
                models[tag] = load(tag + ".pt")
    return {"inp": inp, "ref": dict(np.load(ref_out)), "sharded": sharded,
            "dense": dense, "models": models, "unsharded": unsharded,
            "decode": {**load("decode_2.pt"), **load("decode_4.pt")},
            "einsum": {**load("einsum_2.pt"), **load("einsum_4.pt")}}


def _hold_grads(got, want, dtype, what):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for name, g in got.items():
        w = want[name].numpy() if isinstance(want[name], torch.Tensor) \
            else np.asarray(want[name])
        tol = GRAD_REL[dtype] * float(np.abs(w).max()) + GRAD_ATOL
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol, f"{what} {name}: max |d| {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("case", REF_BLOCKS, ids=[c["tag"] for c in REF_BLOCKS])
def test_sharded_block_matches_the_reference(runs, case):
    """Output, aux value and every gradient against the reference's
    moe_block_sharded on the same mesh."""
    tag, dtype = case["tag"], case["dtype"]
    got, ref = runs["sharded"][tag], runs["ref"]
    want_out = ref[f"{tag}/out"]
    tol = OUT_RTOL[dtype]
    np.testing.assert_allclose(got["out"].numpy(), want_out, rtol=tol,
                               atol=tol * float(np.abs(want_out).max()),
                               err_msg=tag)
    np.testing.assert_allclose(got["aux"], float(ref[f"{tag}/aux"]),
                               rtol=OUT_RTOL["float32"], err_msg=tag)
    want = {k[len(tag) + len("/grad/"):]: v for k, v in ref.items()
            if k.startswith(f"{tag}/grad/")}
    _hold_grads(got["grads"], want, dtype, tag)


def test_aux_on_data_shards_is_shard_zero_with_the_mean_gradient(runs):
    """On (2, 2) the reference's aux is data shard 0's value, not the
    whole batch's, and the port's is too (held above); the whole batch's
    value differs here by more than the tolerance, so the test sees the
    difference."""
    tag = _block((2, 2))["tag"]
    inp = runs["inp"]
    whole = _dense_block(inp, _block((2, 2)))["aux"]
    shard0 = float(runs["ref"][f"{tag}/aux"])
    assert abs(whole - shard0) > 1e-4 * abs(shard0), (whole, shard0)
    np.testing.assert_allclose(runs["sharded"][tag]["aux"], shard0,
                               rtol=1e-5)


@pytest.mark.parametrize("case", NO_DROP_BLOCKS,
                         ids=[c["tag"] for c in NO_DROP_BLOCKS])
def test_sharded_block_without_drops_is_the_dense_block(runs, case):
    """At capacity_factor = n_experts nothing drops: the sharded block's
    output is moe_block's on every mesh, and on (1, mp) meshes (one data
    shard) its aux and every gradient too."""
    tag = case["tag"]
    got, want = runs["sharded"][tag], runs["dense"][tag]
    np.testing.assert_allclose(got["out"].numpy(), want["out"].numpy(),
                               rtol=1e-5, atol=1e-6, err_msg=tag)
    if case["mesh"][0] == 1:
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)
        _hold_grads(got["grads"], want["grads"], "float32", tag)


@pytest.mark.parametrize("case", REF_BLOCKS[:4], ids=lambda c: c["tag"])
def test_sharded_block_keeps_the_models_placements(runs, case):
    """The output comes back split over data and replicated over model,
    the aux replicated; a buffer constrained to P('data', 'model') is
    split on each mesh dim of size > 1."""
    data, model = case["mesh"]
    got = runs["sharded"][case["tag"]]
    out_pl, aux_pl = got["placements"]
    assert out_pl == ["S(0)" if data > 1 else "R", "R"], out_pl
    assert aux_pl == ["R", "R"], aux_pl
    assert got["buf"] == ["S(0)" if data > 1 else "R",
                          "S(1)" if model > 1 else "R"], got["buf"]


def test_sharded_block_refuses_what_the_reference_cannot_split():
    """E_tot % mp (the reference's assert) and t_loc != mp * per (where its
    reshape fails) raise ValueError, and so does a batch the data axes do
    not divide; the mesh's shape is all they read."""
    p = SimpleNamespace(w_up=torch.empty(6, D, FF))
    kw = dict(n_experts=6, top_k=2, dp_axes=("data",))
    with pytest.raises(ValueError, match=r"6 experts .* size 4"):
        moe_block_sharded(p, torch.empty(2, 16, D), **kw,
                          mesh=MeshShape((1, 4), ("data", "model")))
    p = SimpleNamespace(w_up=torch.empty(8, D, FF))
    with pytest.raises(ValueError, match=r"\(1, 6, 64\): 6 tokens"):
        moe_block_sharded(p, torch.empty(1, 6, D), **kw,
                          mesh=MeshShape((1, 4), ("data", "model")))
    with pytest.raises(ValueError, match=r"batch 3 .*\(2 shards\)"):
        moe_block_sharded(p, torch.empty(3, 16, D), **kw,
                          mesh=MeshShape((2, 2), ("data", "model")))


@pytest.mark.parametrize("arch", MODEL_ARCHS)
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_model_with_shard_map_matches_the_reference_loss(runs, arch, mesh):
    got = runs["models"][_model_tag(arch, mesh)]["loss"]
    want = float(runs["ref"][_model_tag(arch, mesh) + "/loss"])
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_model_gradients_on_2x2_match_the_reference(runs, arch):
    tag = _model_tag(arch, (2, 2))
    cfg = get_arch(arch).smoke()
    want = params_from_jax(cfg, _unflatten(runs["ref"], tag + "/grad/"))
    _hold_grads(runs["models"][tag]["grads"], want, "float32", tag)


def test_moe_block_runs_expert_parallel_with_shard_map(runs):
    """The counterpart of test_torch_mesh.py's
    test_moe_block_runs_replicated_in_the_jamba_mesh: with moe_impl=
    "shard_map" the jamba cut's expert stacks are split over model and
    each MoE sub-layer of the (1, 2) step sends its (e_tot, cap, d) buffer
    through the model group twice (out and back), cap from the rank's own
    B S / 2 tokens.  Each Mamba sub-layer's one all-to-all, on the same
    group, is its in_proj output's u and z halves going to the ranks that
    hold them in their split (``models.dtensor.chunk_last``)."""
    cfg = get_arch("jamba-1.5-large-398b").smoke()
    got = runs["models"][_model_tag("jamba-1.5-large-398b", (1, 2))]
    moe = {n: p for n, p in got["param_placements"].items()
           if ".moe." in n and "w_up" in n}
    assert moe and all(p[1] == "S(0)" for p in moe.values()), moe
    e_tot = cfg.n_experts + cfg.expert_pad
    assert {s for n, s in got["expert_local"].items() if ".moe." in n} == {
        (e_tot // 2, cfg.d_model, cfg.expert_ff)}
    per = B * S // 2
    cap = -(-per * cfg.top_k * 5 // (cfg.n_experts * 4))   # ceil(., x 1.25)
    n_moe = cfg.n_layers // cfg.attn_every * (cfg.attn_every // 2)
    moe_sends = [s for s in got["all_to_all"] if len(s) == 2]
    assert moe_sends == [(e_tot * cap, cfg.d_model)] * (2 * n_moe)
    n_mamba = cfg.n_layers // cfg.attn_every * (cfg.attn_every - 1)
    assert [s for s in got["all_to_all"] if len(s) != 2] == \
        [(2, B, S, cfg.d_model)] * n_mamba      # d_in / 2 = d_model


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_model_gradients_without_drops_match_the_unsharded_model(runs, arch):
    """On (1, 2) at no-drop capacity, one step's loss and gradients equal
    the port's unsharded model's."""
    got = runs["models"][_model_tag(arch, (1, 2), NO_DROP)]
    want = runs["unsharded"][arch]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _hold_grads(got["grads"], want["grads"], "float32", arch)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_mesh_of_one_is_the_dense_block_bit_for_bit(arch):
    """On a mesh of one (this process's one-rank gloo group) the sharded
    block runs its collectives on the one-rank group and routes as
    moe_block(n_groups=1): the smoke model's logits, loss and every
    gradient equal the dense path's bit for bit, as chip_smoke.py's
    phase 19 holds them on the card."""
    from repro_torch.launch.train import choose_mesh
    mesh = choose_mesh("cpu")
    cfg = get_arch(arch).smoke()
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    runs = {}
    for impl in ("dense", "shard_map"):
        model.moe_impl = impl
        model.moe_mesh = mesh if impl == "shard_map" else None
        with torch.no_grad():
            logits = model({"tokens": batch["tokens"]})
        model.requires_grad_(True)
        loss, grads = loss_and_grads(model, batch)
        model.zero_grad(set_to_none=True)
        model.requires_grad_(False)
        runs[impl] = logits, loss, grads
    (la, sa, ga), (lb, sb, gb) = runs["dense"], runs["shard_map"]
    assert type(lb) is torch.Tensor and torch.equal(la, lb)
    assert torch.equal(sa, sb)
    assert sorted(ga) == sorted(gb)
    assert [n for n in ga if not torch.equal(ga[n], gb[n])] == []
    assert all(float(gb[n].abs().max()) > 0 for n in gb
               if n.endswith((".router", ".w_up")))


@pytest.mark.parametrize("case", DECODES, ids=[c["tag"] for c in DECODES])
def test_grouped_decode_block_equals_moe_block(runs, case):
    """The decode step's block on a mesh (``moe_block_grouped``: each rank
    routes its data shard's rows and runs its model rank's experts or FF
    slice, its output a partial sum over model) against the unsharded
    ``moe_block`` whose groups are the data shards, at capacity 1.25
    (drops included).  With the experts split and no shared expert, bit
    for bit: a token's output is its gated expert outputs added, the
    other ranks adding zeros.  Otherwise (a sum split over the FF dim, or
    the shared expert added beside a partial sum) at the fp32 output
    tolerance.  x's batch rows stay split over data."""
    inp = runs["inp"]
    p = _port_moe(inp, "float32", case["shared"])
    with torch.no_grad():
        want, _ = moe_mod.moe_block(
            p, torch.from_numpy(inp["x"]), n_experts=N_EXPERTS, top_k=TOP_K,
            capacity_factor=CAP, n_groups=case["mesh"][0])
    got = runs["decode"][case["tag"]]
    if case["split"] == "expert" and not case["shared"]:
        assert torch.equal(got["out"], want)
    else:
        np.testing.assert_allclose(got["out"].numpy(), want.numpy(),
                                   rtol=OUT_RTOL["float32"], atol=1e-6)
    if case["mesh"][0] > 1:
        assert got["placements"][0] == "S(0)"


@pytest.mark.parametrize("case", EINSUMS, ids=[c["tag"] for c in EINSUMS])
def test_local_einsum_equals_the_whole_einsum(runs, case):
    """``local_einsum`` on each rank's shards, gathered, against
    ``torch.einsum`` of the whole operands: bit for bit where each output
    element's sum is one rank's (batch and heads split), at 1e-6 where a
    split dim is summed over (the flash-decode cache's sequence: a
    partial sum over model)."""
    got = runs["einsum"][case["tag"]]
    summed = case["tag"].startswith("einsum_gqa_seq_out")
    if summed:
        np.testing.assert_allclose(got["out"].numpy(), got["want"].numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert "P(sum)" in got["placements"] or case["mesh"][1] == 1
    else:
        assert torch.equal(got["out"], got["want"])
