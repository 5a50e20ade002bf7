"""The port's dry run (``repro_torch.launch.dryrun``): per-device counts on
a world of fake ranks, with no card.

Every check that needs a process group runs in a subprocess: an xdist
worker may already hold a default group, and the fake one must be the
process's own.  One subprocess holds the unit checks (collectives of known
redistributions on a fake (2, 2) world, the per-device FLOPs of a product
split over a (16, 16) one); two run cells through ``python -m
repro_torch.launch.dryrun``, side by side:

* llama3.2-1b x decode_32k x multi, the reference's own test cell: OK,
  FLOPs > 0, temporaries under the H100's 80 GiB;
* qwen2-moe-a2.7b x prefill_32k x single at ``--layers 2``: the sharded
  MoE blocks' all-to-all bytes are 2 x L x e_tot x cap x d x 2 B.  On a
  CPU mesh DTensor moves a shard to another dim by an all-gather (its
  all-to-all is for CUDA meshes), so every all-to-all of the cell is a
  block's;
* llama3.2-1b x train_4k x single at ``--layers 1``: the sharded train
  step fits a card (its loss is vocab-parallel);
* jamba-1.5-large-398b x train_4k x single at ``--layers 1``: its Mamba
  blocks and scans fit a card (569.40 GiB of temporaries a device while
  the block's softplus backward ran on the global batch, on the parent's
  tree with the scans counted as one op each).

The unit subprocess also runs ``Model.loss`` from logits split over the
full 128,256-token vocab of llama3.2-1b on the (16, 16) world: the loss's
collectives are three all-reduces of (B_local, S) values and no rank holds
the global (B, S, V) logits, where DTensor's log-softmax and gather
all-gather them and build their global gradient on every rank.  And it
runs jamba's train_4k step at S 96 with a ``Counter`` that records the
shapes of the local tensors the step makes: none has the global batch as
its dim 0, or a Mamba block's whole width.
"""
import json
import math
import os
import subprocess
import sys

import pytest

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import dryrun as DR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL_TIMEOUT_S = 420

UNIT = r'''
import json, torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_mesh
out = {}
DR.fake_world(4)
mesh = make_mesh((2, 2), ("data", "model"), "cpu")

def moved(src, dst, local):
    def fn():
        x = DTensor.from_local(torch.empty(local), mesh, src, run_check=False)
        x.redistribute(mesh, dst)
    return DR.count_collectives(fn)

out["gather"] = moved([Shard(0), Shard(1)], [Shard(0), Replicate()], (4, 8))
out["reduce"] = moved([Shard(0), Partial()], [Shard(0), Replicate()], (4, 16))
out["scatter"] = moved([Shard(0), Partial()], [Shard(0), Shard(1)], (4, 16))
out["both"] = moved([Partial(), Shard(1)], [Replicate(), Replicate()], (8, 8))
out["shard_to_shard"] = moved([Replicate(), Shard(1)],
                              [Replicate(), Shard(0)], (8, 8))
out["a2a"] = DR.count_collectives(lambda: funcol.wait_tensor(
    funcol.all_to_all_single(torch.empty(6, 4, dtype=torch.bfloat16), None,
                             None, mesh.get_group("model"))))
DR.fake_world(256)
mesh = make_mesh((16, 16), ("data", "model"), "cpu")
c = DR.Counter()
with c.active():
    x = DTensor.from_local(torch.empty(16, 4096), mesh,
                           [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(4096, 256), mesh,
                           [Replicate(), Shard(1)], run_check=False)
    with c.counting():
        y = x @ w
    out["flops"], out["bytes"] = c.flops, c.bytes
    out["y"] = [list(y.shape), list(y.to_local().shape)]
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        x @ w
    out["global_flops"] = fc.get_total_flops()

# Model.loss from logits split over llama3.2-1b's vocab (B 16, S 64),
# and DTensor's log-softmax + gather on the same logits for contrast
from types import SimpleNamespace
from repro_torch.models.transformer import Model
B, S, V = 16, 64, 128256

def loss_counts(route):
    c = DR.Counter()
    with c.active():
        lg = DTensor.from_local(torch.empty(1, S, V // 16), mesh,
                                [Shard(0), Shard(2)], run_check=False)
        lg.requires_grad_(True)
        lab = DTensor.from_local(torch.zeros(1, S, dtype=torch.int32), mesh,
                                 [Shard(0), Replicate()], run_check=False)
        with c.counting():
            if route == "model":
                m = SimpleNamespace(embed=lg, forward=lambda b, collect_aux:
                                    (lg, torch.zeros(())))
                Model.loss(m, {"labels": lab}).backward()
            else:
                ll = torch.gather(torch.log_softmax(lg, dim=-1), -1,
                                  lab[..., None].long())
                ll.sum().backward()
    return {"peak": c.peak, "collectives": c.collectives}

out["loss"] = {r: loss_counts(r) for r in ("model", "dtensor")}

# Model.loss from logits whose vocab (whisper's 51,865) no mesh dim
# splits: a partial sum over model (the head splits d_model), batch rows
# over data (B 16, S 64)
VW = 51865


def local_counts(route):
    c = DR.Counter()
    with c.active():
        lg = DTensor.from_local(torch.empty(1, S, VW), mesh,
                                [Shard(0), Partial()], run_check=False)
        lg.requires_grad_(True)
        lab = DTensor.from_local(torch.zeros(1, S, dtype=torch.int32), mesh,
                                 [Shard(0), Replicate()], run_check=False)
        with c.counting():
            if route == "model":
                m = SimpleNamespace(embed=lg, forward=lambda b, collect_aux:
                                    (lg, torch.zeros(())))
                Model.loss(m, {"labels": lab}).backward()
            else:
                ll = torch.gather(torch.log_softmax(lg, dim=-1), -1,
                                  lab[..., None].long())
                ll.sum().backward()
    return {"peak": c.peak, "collectives": c.collectives}


out["local_loss"] = {r: local_counts(r) for r in ("model", "dtensor")}

# the jamba train_4k step at S 96 (layers 1) on (16, 16): the local
# tensors it makes whose dim 0 is the global batch 256 (a broadcast
# scalar, which holds fewer elements, aside) or that hold a Mamba block's
# whole d_in (16,384) or in_proj width (32,768); DTensor's redistribution
# buffers, which stack the group's pieces on dim 0, aside
import dataclasses, traceback
from repro_torch.configs import SHAPES
SHAPES["train_4k"] = dataclasses.replace(SHAPES["train_4k"], seq_len=96)
wide = []


class Shapes(DR.Counter):
    def _record(self, func, args, kwargs, out):
        super()._record(func, args, kwargs, out)
        if func.namespace in DR._C10D:
            return
        for t in DR._tensors(out):
            s = tuple(t.shape)
            batch = s[:1] == (256,) and \
                t.untyped_storage().nbytes() >= 256 * t.element_size()
            if (batch or 16384 in s or 32768 in s) and not any(
                    "tensor/_redistribute.py" in f.filename
                    for f in traceback.extract_stack()):
                wide.append([func._schema.name.split("::")[-1], list(s)])


DR.Counter = Shapes
rec = DR.run_cell("jamba-1.5-large-398b", "train_4k", False, layers=1)
out["jamba"] = {"status": rec["status"], "wide": wide,
                "temp": rec["memory"]["temp_size_in_bytes"]}
print(json.dumps(out))
'''

LLAMA = ("llama3.2-1b", "decode_32k", "multi", None)
QWEN = ("qwen2-moe-a2.7b", "prefill_32k", "single", 2)
TRAIN = ("llama3.2-1b", "train_4k", "single", 1)
JAMBA = ("jamba-1.5-large-398b", "train_4k", "single", 1)


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    return env


def _cell_cmd(cell, out):
    arch, shape, mesh, layers = cell
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", out]
    return cmd + (["--layers", str(layers)] if layers else [])


def _tag(cell):
    arch, shape, mesh, layers = cell
    return f"{arch}__{shape}__{mesh}" + (f"__L{layers}" if layers else "")


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    """The unit checks and the four cells, their processes started
    together."""
    out = str(tmp_path_factory.mktemp("dryrun"))
    procs = {c: subprocess.Popen(_cell_cmd(c, out), env=_env(), cwd=REPO,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for c in (QWEN, LLAMA, TRAIN, JAMBA)}
    try:
        unit = subprocess.run([sys.executable, "-c", UNIT], env=_env(),
                              cwd=REPO, capture_output=True, text=True,
                              timeout=300)
        logs = {c: p.communicate(timeout=CELL_TIMEOUT_S)[0]
                for c, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    assert unit.returncode == 0, unit.stdout[-2000:] + unit.stderr[-3000:]
    recs = {}
    for c, p in procs.items():
        assert p.returncode == 0, logs[c][-4000:]
        with open(os.path.join(out, _tag(c) + ".json")) as f:
            recs[c] = json.load(f)
    return {"unit": json.loads(unit.stdout.strip().splitlines()[-1]),
            "cells": recs, "out": out}


def test_roofline_terms_use_the_h100_constants():
    t = DR.roofline_terms(989e12, 3.35e12, {"all-reduce": 20e9,
                                            "all-to-all": 5e9})
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(1.0)
    assert t["collective_bytes"] == 25e9
    assert (DR.PEAK_FLOPS, DR.HBM_BW, DR.LINK_BW) == (989e12, 3.35e12, 25e9)
    assert DR.roofline_terms(0.0, 0.0, {})["collective_s"] == 0.0


@pytest.mark.parametrize("move,want", [
    ("gather", {"all-gather": 4 * 16 * 4}),
    ("reduce", {"all-reduce": 4 * 16 * 4}),
    ("scatter", {"reduce-scatter": 4 * 8 * 4}),
    ("both", {"all-reduce": 8 * 16 * 4, "all-gather": 8 * 16 * 4}),
    # on a CPU mesh DTensor moves a shard to another dim by an all-gather
    ("shard_to_shard", {"all-gather": 8 * 16 * 4}),
    ("a2a", {"all-to-all": 6 * 4 * 2})])
def test_count_collectives_on_known_redistributions(dry, move, want):
    """A (8, 16) fp32 DTensor on a fake (2, 2) world: each move's output
    bytes per device, under the reference's collective names."""
    assert dry["unit"][move] == want


def test_flops_are_per_device_not_global(dry):
    """(256, 4096) @ (4096, 4096), split by data over rows and by model
    over columns on (16, 16): each device counts its local product, 1/256
    of the 8.59 GFLOP that a counting mode over the DTensors reports."""
    u = dry["unit"]
    assert u["global_flops"] == 2 * 256 * 4096 * 4096 == 8_589_934_592
    assert u["flops"] == u["global_flops"] // 256 == 2 * 16 * 4096 * 256
    assert u["y"] == [[256, 4096], [16, 256]]
    assert u["bytes"] == 4 * (16 * 4096 + 4096 * 256 + 16 * 256)


def test_llama_decode_cell_on_the_multi_pod_mesh(dry):
    rec = dry["cells"][LLAMA]
    assert rec["status"] == "OK", rec
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["memory"]["temp_size_in_bytes"] < 80 * 2 ** 30  # fits an H100
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "collective_bytes"}
    assert rec["roofline"]["collective_bytes"] == \
        sum(rec["collectives"].values())
    assert rec["policy"] == "tp" and rec["layers_override"] is None


def test_qwen_moe_prefill_all_to_all_is_the_sharded_blocks(dry):
    """Each of the 2 layers' expert-parallel blocks sends its (e_tot, cap,
    d) bf16 buffer out and back: 2 x 2 x 64 x 342 x 2048 x 2 B."""
    rec = dry["cells"][QWEN]
    assert rec["status"] == "OK", rec
    cfg, shape = ARCHS[QWEN[0]], SHAPES[QWEN[1]]
    dp, mp, layers = 16, 16, QWEN[3]
    per = shape.global_batch // dp * shape.seq_len // mp
    cap = math.ceil(per * cfg.top_k / cfg.n_experts * 1.25)
    e_tot = cfg.n_experts + cfg.expert_pad
    assert (per, cap, e_tot) == (4096, 342, 64)
    want = 2 * layers * e_tot * cap * cfg.d_model * 2
    assert want == 358_612_992
    assert rec["collectives"]["all-to-all"] == want
    assert rec["layers_override"] == 2 and rec["flops"] > 0


def test_loss_is_vocab_parallel_on_the_production_mesh(dry):
    """Model.loss on llama3.2-1b's full vocab split over model 16 (B 16,
    S 64): its collectives are the three all-reduces of (B_local, S) fp32
    values (the max, the sum of exponentials, the label's logit) and the
    mean's scalars; no all-gather, and no rank's temporaries reach the
    global logits.  DTensor's log-softmax and gather on the same logits
    all-gather them and hold their global gradient."""
    b, s, v = 16, 64, 128256
    global_fp32 = b * s * v * 4
    got, old = dry["unit"]["loss"]["model"], dry["unit"]["loss"]["dtensor"]
    coll = got["collectives"]
    assert set(coll) == {"all-reduce"}, coll
    assert 3 * s * 4 <= coll["all-reduce"] < 3 * s * 4 + 64
    assert got["peak"] < global_fp32 // 16       # a few local shards
    assert old["collectives"].get("all-gather", 0) >= global_fp32 // 16
    assert old["peak"] >= global_fp32


def test_loss_without_a_vocab_split_stays_local(dry):
    """Model.loss on (16, 64, 51865) fp32 logits that are a partial sum
    over model (the head splits d_model where the vocab does not divide
    16) and split over data by rows: each rank reduce-scatters its row
    into 4 positions each and takes their log-softmax, and the backward
    all-gathers the row's cotangent (the head's backward needs it whole);
    its temporaries stay at a few of a rank's rows, where DTensor's
    log-softmax and gather hold the global gradient (the gather's
    backward zeros at (16, 64, 51865) on every rank)."""
    b, s, v = 16, 64, 51865
    row = s * v * 4                          # one rank's logits, fp32
    got = dry["unit"]["local_loss"]["model"]
    old = dry["unit"]["local_loss"]["dtensor"]
    assert got["collectives"]["reduce-scatter"] == row // 16
    assert got["collectives"]["all-gather"] == row
    assert got["peak"] < 3 * row
    assert old["peak"] >= b * row


def test_llama_train_cell_fits_a_card(dry):
    """llama3.2-1b train_4k at one layer on (16, 16): under 80 GiB of
    temporaries a device (595.30 GiB while the loss ran DTensor's rules)."""
    rec = dry["cells"][TRAIN]
    assert rec["status"] == "OK", rec
    assert rec["memory"]["temp_size_in_bytes"] < 80 * 2 ** 30
    assert rec["collectives"]["all-gather"] < 33.6e9 / 4
    assert rec["layers_override"] == 1 and rec["flops"] > 0


def test_cached_cells_are_skipped(dry):
    r = subprocess.run(_cell_cmd(LLAMA, dry["out"]), env=_env(), cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"[cached] {_tag(LLAMA)}: OK" in r.stdout


def test_skip_shapes_are_recorded_without_tracing():
    arch = next(a for a, c in ARCHS.items() if "long_500k" in c.skip_shapes)
    rec = DR.run_cell(arch, "long_500k", False)
    assert rec["status"] == "SKIP"
    assert "500k" in rec["reason"]


def test_jamba_train_cell_fits_a_card(dry):
    """jamba-1.5-large-398b train_4k at one layer (one Jamba period: 1
    attention, 7 Mamba sub-layers) on (16, 16): under 80 GiB of
    temporaries a device.  Before its Mamba blocks kept the batch and
    widths their specs give, 569.40 GiB (the scans counted as one op)."""
    rec = dry["cells"][JAMBA]
    assert rec["status"] == "OK", rec
    assert rec["memory"]["temp_size_in_bytes"] < 80 * 2 ** 30
    assert rec["layers_override"] == 1 and rec["flops"] > 0


def test_jamba_step_holds_no_global_batch_and_no_whole_mamba_width(dry):
    """At S 96 (at S 128 a rank's MoE dispatch rows, 16 x 128 / 16 x top-2,
    are 256 too) no local tensor of jamba's train step has dim 0 the global
    batch 256 or a dim of the Mamba block's whole d_in or in_proj width:
    each rank holds its 16 batch rows and its 1,024 channels (the parent
    held, among others, softplus's backward at (256, S, 16384) fp32 and u
    and z at (16, S, 16384))."""
    jamba = dry["unit"]["jamba"]
    assert jamba["status"] == "OK"
    assert jamba["wide"] == []
    assert 0 < jamba["temp"] < 80 * 2 ** 30
