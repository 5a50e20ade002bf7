"""Design-sweep traffic: one architect's full-space sweeps, back to back.

The configuration's model gives the workload pair the sweep scores (its
prefill of ``batch`` x ``seq`` and its decode at KV length ``seq`` +
``out_pos``, at tensor-parallel degree ``tp``); each request of the window
is one ``SweepEngine.run()`` over the whole design space (or its first
``stop`` ids), in chunks of ``chunk`` designs on the ``backend`` the mix
names, keeping the ``topk`` best designs of each objective and the
``stall_topk`` best of each dominant stall class.  Where the mix names
``threads``, the process keeps that many intra-op threads for the window.

Every sweep of the window is checked once it has closed, against the
plain reference's sweep: the numbers compared count what differs (the
count of designs beating the A100, the best designs and their
objectives, the stall seeds, and the Pareto front, ids and points); the
model states an exact result, so each limit is 0.  The seed draws
nothing here: the space and the workload are fixed, so every seed makes
the same work."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench import program
from perfbench.reference import dse


def mismatches(got, ref: dict) -> Dict[str, float]:
    """Counts of what a SweepResult `got` reports otherwise than `ref`."""
    front_got = {int(i): tuple(y) for i, y in zip(got.pareto_ids,
                                                  got.pareto_y)}
    front_ref = {int(i): tuple(float(v) for v in y)
                 for i, y in zip(ref["front_ids"].tolist(),
                                 ref["front_y"].double().numpy())}
    common = front_got.keys() & front_ref.keys()
    return {
        "superior_gap": float(abs(got.n_superior - ref["n_superior"])
                              + abs(got.n_evaluated - ref["n"])),
        "topk_mismatch": float(
            np.sum(np.asarray(got.topk_ids) != ref["topk_ids"].numpy())
            + np.sum(np.asarray(got.topk_val, dtype=np.float32)
                     != ref["topk_val"].numpy())),
        "stall_mismatch": float(np.sum(np.asarray(got.stall_topk_ids)
                                       != ref["stall_ids"].numpy())),
        "front_mismatch": float(
            len(front_got.keys() ^ front_ref.keys())
            + sum(front_got[i] != front_ref[i] for i in common)
            + int(bool(got.archive_truncated))),
    }


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in rows) for k in rows[0]}


class Job:
    def __init__(self, conf: dict, mix: dict, seed: int, device,
                 fault=None):
        self.conf, self.mix, self.seed, self.dev = conf, mix, seed, device
        self.fault = fault
        self.failed = 0
        self.results: list = []
        self._threads = None

    def setup(self) -> None:
        from repro_torch.perfmodel.evaluator import make_evaluator
        from repro_torch.perfmodel.sweep import SweepEngine
        from repro_torch.perfmodel.workload import from_arch
        m = self.mix
        if "threads" in m:
            self._threads = torch.get_num_threads()
            torch.set_num_threads(m["threads"])
        cfg = program.arch_config(self.conf["model"])
        wls = {"ttft": from_arch(cfg, m["batch"], m["seq"], tp=m["tp"]),
               "tpot": from_arch(cfg, m["batch"], m["seq"], tp=m["tp"],
                                 decode=True, kv_len=m["seq"] + m["out_pos"])}
        ev = make_evaluator(wls, backend=m["backend"], device=self.dev)
        self.engine = SweepEngine(ev, chunk_size=m["chunk"], topk=m["topk"],
                                  stall_topk=m["stall_topk"],
                                  backend=m["backend"])
        if self.fault is not None:
            self.fault(self.engine)
        self.engine.run(stop=m.get("stop"))          # warms every shape
        self._chunk0 = self.engine.telemetry()["chunk_s"]

    def step(self, i: int) -> float:
        res = self.engine.run(stop=self.mix.get("stop"))
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.results.append(res)
        return float(res.n_evaluated)

    def close_window(self) -> None:
        st = self.engine.telemetry()["chunk_s"]
        self.chunks = st["count"] - self._chunk0["count"]
        self.chunk_s = st["sum"] - self._chunk0["sum"]
        del self.engine
        if self._threads is not None:
            torch.set_num_threads(self._threads)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float32) -> dict:
        return dse.sweep(self.conf["model"], self.mix, self.dev, dtype)

    def compare(self) -> Dict[str, float]:
        return self.compare_with_control(False)["program"]

    def compare_with_control(self, control: bool) -> dict:
        """Every sweep's mismatches against the reference (the worst), and
        with `control` the reference's own in bfloat16 against it."""
        ref = self.reference()
        out = {"program": worst([mismatches(r, ref) for r in self.results]),
               "control": None}
        self.results.clear()
        if control:
            c = self.reference(torch.bfloat16)
            out["control"] = {
                "superior_gap": float(abs(c["n_superior"]
                                          - ref["n_superior"])),
                "topk_mismatch": float(
                    (c["topk_ids"] != ref["topk_ids"]).sum()
                    + (c["topk_val"] != ref["topk_val"]).sum()),
                "stall_mismatch": float((c["stall_ids"]
                                         != ref["stall_ids"]).sum()),
                "front_mismatch": float(len(
                    set(c["front_ids"].tolist())
                    ^ set(ref["front_ids"].tolist())))}
        return out

    def end_to_end(self, win: dict) -> Dict[str, float]:
        return {"sweep_designs_per_s": win["work"] / win["window_s"]}
