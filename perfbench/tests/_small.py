"""Small runs of the benchmark's cells for CPU tests, one data file a cell
(``small/<cell>.json``): ``model``, the override that cuts the model in
every width with its structure kept (null where the cell runs no model),
``traffic``, the mix's override (short prompts or rows, the sweep over the
first ids of the space), and, where the cell's limits hold only at its
own size, ``limits`` read at this size."""
import json
from pathlib import Path

from perfbench import bench

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parents[1] / "BENCHMARK.json").read_text())
CELLS = sorted(w["name"] for w in BENCH["workloads"])
CONFIGS = sorted(c["name"] for c in BENCH["configs"])


def small(cell: str) -> dict:
    """The cell's small run: its ``model``, ``traffic`` and ``limits``
    (None where the file gives none)."""
    got = json.loads((HERE / "small" / f"{cell}.json").read_text())
    return {"model": got["model"], "traffic": got["traffic"],
            "limits": got.get("limits")}


def small_model(config: str) -> dict:
    """The model override the configuration's cells share: every cell of
    it that runs a model has to give the same one."""
    models = [small(w["name"])["model"] for w in BENCH["workloads"]
              if w["config"] == config]
    models = [m for m in models if m is not None]
    if not models:
        raise LookupError(f"no cell of {config!r} has a small model")
    if any(m != models[0] for m in models):
        raise ValueError(f"the cells of {config!r} give different small "
                         "models")
    return models[0]


def cells_of(kind: str) -> list:
    """The cells whose traffic mix is of `kind` (train, prefill, sweep)."""
    return [c for c in CELLS
            if bench.traffic(bench.cell(BENCH, c)["traffic"])["kind"] == kind]


def has_experts(cell: str) -> bool:
    """Whether the cell's model routes tokens to experts."""
    conf = bench.config_file(BENCH, bench.cell(BENCH, cell)["config"])
    return bool(conf["model"].get("n_experts"))
