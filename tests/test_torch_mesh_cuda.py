"""The sharded step on a mesh of one card: the same step as the plain one,
bit for bit, with the kernels reached through ``local_map``; and the
sweep's ``shard=True`` against ``shard=False`` on one card.

Needs an NVIDIA GPU with nvcc (the kernels are built at first use);
skipped elsewhere.  On the card: ``python -m pytest -q -m cuda
tests/test_torch_mesh_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticLMDataset, make_batch_iter
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import activate_mesh, data_axes
from repro_torch.launch.train import choose_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

B, S, STEPS = 2, 4096, 2          # S above 2048: the flash_attention branch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(cfg, dev):
    m = build_model(cfg, dtype=torch.float32, device=dev, remat=True)
    m.init_weights(torch.Generator(device=dev).manual_seed(0))
    return m


def test_mesh_of_one_equals_the_plain_step_bit_for_bit(cuda):
    cfg = get_arch("llama3.2-1b").smoke()
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    ds = SyntheticLMDataset(cfg.vocab, S, B)
    plain = _model(cfg, cuda)
    step = ST.make_train_step(plain, opt)
    state = adamw_init(dict(plain.named_parameters()))
    want = []
    for b in make_batch_iter(ds, 0, STEPS, device=cuda):
        state, met = step(state, b)
        want.append((float(met["loss"]), float(met["grad_norm"])))

    mesh = choose_mesh(cuda)
    assert tuple(mesh.mesh.shape) == (1, 1)
    model = _model(cfg, cuda)
    with activate_mesh(mesh):
        sh = ST.shard_model(mesh, model, cfg, ShapeConfig("t", S, B, "train"))
        mstep = ST.make_train_step(model, opt)
        mstate = adamw_init(dict(model.named_parameters()), sh["opt"])
        got, counts = [], []
        for b in make_batch_iter(ds, 0, STEPS, mesh=mesh,
                                 dp_axes=data_axes(mesh)):
            flash_attention.launches = flash_attention_bwd.launches = 0
            mstate, met = mstep(mstate, b)
            got.append((float(met["loss"]), float(met["grad_norm"])))
            counts.append((flash_attention.launches,
                           flash_attention_bwd.launches))
    assert got == want
    # remat: every layer's forward twice, its backward once
    assert counts == [(2 * cfg.n_layers, cfg.n_layers)] * STEPS
    mp = dict(model.named_parameters())
    for n, p in plain.named_parameters():
        assert torch.equal(mp[n].full_tensor(), p), n
        assert torch.equal(mstate["m"][n].full_tensor(), state["m"][n]), n
        assert torch.equal(mstate["v"][n].full_tensor(), state["v"][n]), n


def test_cpu_and_cuda_meshes_in_one_process(cuda):
    """A CPU mesh and a CUDA mesh built one after the other in one process
    each reduce over their own backend (gloo, nccl): a Partial tensor made
    Replicate is a real all-reduce on either."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch.launch.mesh import group_backend, make_mesh
    for dev in ("cpu", "cuda"):
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        assert mesh.device_type == dev
        assert group_backend(dev) == {"cpu": "gloo", "cuda": "nccl"}[dev]
        x = torch.arange(6.0, device=dev).reshape(2, 3)
        d = DTensor.from_local(x, mesh, (Partial(), Replicate()))
        y = d.redistribute(mesh, (Replicate(), Replicate())).to_local()
        assert torch.equal(y, x)


def test_sharded_sweep_on_one_card_equals_the_unsharded_sweep(cuda):
    from repro_torch.kernels.ppa_eval import ppa_eval
    from repro_torch.perfmodel import SweepEngine, get_evaluator
    ev = get_evaluator("proxy", backend="cuda")
    kw = dict(chunk_size=65_536, stall_topk=4, backend="cuda")
    sharded = SweepEngine(ev, shard=True, **kw)
    assert sharded.chunk_size == 65_536 or torch.cuda.device_count() > 1
    ppa_eval.launches = 0
    got = sharded.run(0, 1_000_000)
    assert ppa_eval.launches >= -(-1_000_000 // sharded.chunk_size)
    want = SweepEngine(ev, **kw).run(0, 1_000_000)
    assert got.n_superior == want.n_superior
    for f in ("topk_ids", "topk_val", "stall_topk_ids", "pareto_ids",
              "pareto_y"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
