"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"


def test_a_fresh_process_loads_no_jax():
    code = f"""
import importlib, json, sys
from pathlib import Path
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
root = Path({str(PB)!r})
for p in sorted(root.rglob('*.py')):
    rel = p.relative_to(root.parent).with_suffix('')
    if 'tests' in rel.parts or p.name in ('run.py', 'calibrate.py'):
        continue
    if rel.parts[1] == 'metrics':
        from perfbench import bench
        bench.metric_reader(p.stem)
        continue
    importlib.import_module('.'.join(rel.parts))
import perfbench.run, perfbench.calibrate
for m in ('repro_torch', 'repro_torch.launch.steps', 'repro_torch.models',
          'repro_torch.optim', 'repro_torch.kernels.flash_attention'):
    importlib.import_module(m)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT, timeout=300)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "perfbench" in top and "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_neither_jax_nor_either_package():
    for p in (PB / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "flax",
                                               "repro", "repro_torch"), (p, m)


def test_the_harness_refuses_a_process_holding_jax_names():
    from perfbench import bench
    sys.modules["repro"] = sys.modules.get("repro") or type(sys)("repro")
    try:
        assert bench.banned_modules() == ["repro"]
    finally:
        del sys.modules["repro"]
    assert "repro" not in bench.banned_modules()
