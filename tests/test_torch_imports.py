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
               "repro_torch.analysis")


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "repro"
            or name.startswith("repro."))


def test_import_leaves_jax_and_reference_out():
    code = ("import json, sys\n"
            + "".join(f"import {m}\n" for m in SUBPACKAGES)
            + "import repro_torch.core.loop, repro_torch.perfmodel.sweep\n"
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
             lambda: evaluator_for_model(m1)]
    if torch.cuda.is_available():
        for call in calls:
            assert call().device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


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
