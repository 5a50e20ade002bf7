"""The port stands alone: no jax, nothing of ``repro``, the card by default."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

SUBPACKAGES = ("repro_torch", "repro_torch.perfmodel", "repro_torch.core",
               "repro_torch.kernels", "repro_torch.kernels.ppa_eval",
               "repro_torch.analysis", "repro_torch.configs",
               "repro_torch.models", "repro_torch.launch",
               "repro_torch.kernels.flash_attention",
               "repro_torch.kernels.rwkv6_scan",
               "repro_torch.kernels.ssm_scan", "repro_torch.models.moe",
               "repro_torch.core.baselines", "repro_torch.core.bench",
               "repro_torch.core.campaign", "repro_torch.obs",
               "repro_torch.analysis.influence", "repro_torch.runtime",
               "repro_torch.distributed", "repro_torch.obs.export",
               "repro_torch.obs.report", "repro_torch.optim",
               "repro_torch.data", "repro_torch.checkpoint",
               "repro_torch.launch.steps", "repro_torch.launch.train",
               "repro_torch.serve", "repro_torch.serve.worker",
               "repro_torch.launch.mesh", "repro_torch.launch.shardings",
               "repro_torch.models.dtensor", "repro_torch.models.moe_shard",
               "repro_torch.launch.dryrun", "repro_torch.analysis.dataflow",
               "repro_torch.analysis.extract", "repro_torch.analysis.lint",
               "repro_torch.core.quale_ast")


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "repro"
            or name.startswith("repro."))


def test_import_leaves_jax_and_reference_out():
    code = ("import json, sys\n"
            + "".join(f"import {m}\n" for m in SUBPACKAGES)
            + "import repro_torch.core.loop, repro_torch.perfmodel.sweep\n"
            + "import repro_torch.models.convert, repro_torch.launch.serve\n"
            + "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
              "or m.startswith('jax.') or m == 'repro' "
              "or m.startswith('repro.'))))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_source_imports_neither_jax_nor_reference():
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(SRC)}:{node.lineno} {n}"
                          for n in names if _forbidden(n)]
    assert offenders == []
    assert len(list(PORT.rglob("*.py"))) >= 20        # the scan saw the port


def test_entry_points_default_to_the_card():
    """device=None means CUDA; without a card every entry point raises."""
    from repro_torch.perfmodel import (ModelEvaluator, RooflineModel,
                                       get_evaluator, gpt3_layer_prefill,
                                       make_evaluator)
    from repro_torch.perfmodel.evaluator import evaluator_for_model
    m1 = RooflineModel(gpt3_layer_prefill())
    calls = [lambda: get_evaluator("proxy"),
             lambda: make_evaluator({"a": gpt3_layer_prefill()}),
             lambda: ModelEvaluator({"a": m1}),
             lambda: evaluator_for_model(m1),
             lambda: get_evaluator("proxy", workers=2)]
    if torch.cuda.is_available():
        for call in calls:
            assert call().device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_benchmark_generator_defaults_to_the_card():
    """The DSE Benchmark builds its evaluators on the CUDA device unless
    asked for the CPU; the baselines and campaigns run where their
    evaluator does."""
    from repro_torch.core.bench import generate_bottleneck, generate_suite
    calls = [lambda: generate_suite(1, 1, 1),
             lambda: generate_bottleneck(1)]
    if not torch.cuda.is_available():
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    assert len(generate_bottleneck(1, device="cpu")) == 1


def test_ppa_eval_wrapper_rejects_what_the_kernel_does_not_take():
    from repro_torch.kernels.ppa_eval import ppa_eval
    dv = torch.ones((4, 8), dtype=torch.float32)
    tab = torch.ones((3, 8), dtype=torch.float32)
    with pytest.raises(TypeError):
        ppa_eval(dv.double(), tab, 8.0)
    with pytest.raises(ValueError, match="shape"):
        ppa_eval(dv[:, :7].contiguous(), tab, 8.0)
    with pytest.raises(ValueError, match="contiguous"):
        ppa_eval(torch.ones((8, 4)).t(), tab, 8.0)
    with pytest.raises(ValueError, match="rows"):
        ppa_eval(dv, torch.ones((0, 8)), 8.0)
    assert np.isfinite(ppa_eval(dv, tab, 8.0).numpy()).all()


def test_lm_entry_points_default_to_the_card():
    """serve and Model take the CUDA device unless asked for the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model, build_model
    cfg = get_arch("llama3.2-1b").smoke()
    calls = [lambda: Model(cfg), lambda: build_model(cfg),
             lambda: serve("llama3.2-1b", 1, 2, 1, smoke=True)]
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
        assert build_model(cfg).embed.device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    assert Model(cfg, device="cpu").embed.device.type == "cpu"


def test_training_entry_points_default_to_the_card(tmp_path):
    """train, the batch iterator and restore take the CUDA device unless
    asked for the CPU."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.data import SyntheticLMDataset, make_batch_iter
    from repro_torch.launch.train import train
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})
    calls = [lambda: train("llama3.2-1b", 1, 1, 8, True, None),
             lambda: make_batch_iter(SyntheticLMDataset(8, 4, 1), 0, 1),
             lambda: restore_checkpoint(str(tmp_path), 1,
                                        {"w": torch.ones(2)})]
    if torch.cuda.is_available():
        assert restore_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})[
            "w"].device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    assert len(train("llama3.2-1b", 1, 1, 8, True, None,
                     device="cpu")) == 1


def test_mesh_entry_points_default_to_the_card():
    """make_mesh and choose_mesh take the CUDA device (nccl) unless asked
    for the CPU (gloo), and never fall back on their own."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import choose_mesh
    if torch.cuda.is_available():
        assert choose_mesh().device_type == "cuda"
    else:
        for call in (lambda: make_mesh((1, 1), ("data", "model")),
                     choose_mesh):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    mesh = choose_mesh("cpu")
    assert mesh.device_type == "cpu" and tuple(mesh.mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == ("data", "model")


def test_kernel_libraries_are_keyed_by_their_own_flags():
    """Each kernel module states its nvcc flags once (``ops.FLAGS``), and a
    library's path hashes source and flags, so no caller can load a kernel
    built with another module's flags; ppa_eval keeps its bit-exact set."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ppa_eval import ops as ppa
    from repro_torch.kernels.rwkv6_scan import ops as rwkv
    assert ppa.FLAGS == _build.NVCC_FLAGS and "-fmad=false" in ppa.FLAGS
    assert fa.FLAGS == rwkv.FLAGS == _build.TOLERANCE_FLAGS
    paths = {_build.library_path(m.SOURCE, f) for m in (ppa, fa, rwkv)
             for f in (_build.NVCC_FLAGS, _build.TOLERANCE_FLAGS)}
    assert len(paths) == 6
    assert all(p.parent == _build.BUILD_DIR for p in paths)


def test_kernels_package_reexports_the_reference_functions():
    """As ``repro.kernels`` does, ``repro_torch.kernels`` re-exports the
    four wrappers under the same ``__all__``: each name is the function of
    its ``ops`` module, and the subpackages stay importable by their full
    names.  Nothing is built on import."""
    import importlib

    import repro.kernels as ref
    import repro_torch.kernels as port
    from repro_torch.kernels import _build
    built = set(_build._LIBS)
    assert port.__all__ == ref.__all__
    for name in port.__all__:
        fn = getattr(port, name)
        assert callable(fn) and fn.__name__ == name
        ops = importlib.import_module(f"repro_torch.kernels.{name}.ops")
        assert fn is getattr(ops, name)
    from repro_torch.kernels.flash_attention import ops as fa
    assert fa.flash_attention is port.flash_attention
    assert set(_build._LIBS) == built
