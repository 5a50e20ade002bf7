"""Readings from which a cell's comparison limits are set.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 2] [--fault NAME] [--out FILE]

For each seed, in one process: the cell's set-up and a short window at the
cell's own load, then the numbers its limits file compares, read for the
program against the plain reference (the lower readings) and, on the
control seeds, for the control against the reference (the upper ones).
The control is the reference put in the program's place and computed in
the precision below the configuration's: TF32 for fp32 with TF32 off.
Each seed's readings are one JSON line on standard output (and in
`--out`)."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seed: int, seconds: float, control: bool,
             device=None, model_override=None, traffic_override=None,
             fault=None) -> dict:
    """One seed's readings: {"program": numbers, "control": numbers}; with
    `fault` (a function of perfbench.faults) the program's run has it."""
    import torch
    from perfbench import bench
    _, _, conf, mix, dev = bench.load_cell(workload, device, model_override,
                                           traffic_override)
    job = bench.kind_module(mix["kind"]).Job(conf, mix, seed, dev,
                                             fault=fault)
    job.setup()
    win = bench.closed_loop(job.step, seconds)
    job.close_window()
    out = {"seed": seed, "units": win["units"],
           **job.compare_with_control(control)}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None,
                    help="a fault of perfbench/faults.py planted in the run")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import faults
    fault = faults.BY_NAME[args.fault] if args.fault else None
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds:
        t0 = time.perf_counter()
        r = readings(args.workload, seed, args.seconds, seed in ctrl,
                     fault=fault)
        r["fault"] = args.fault
        r["seconds"] = time.perf_counter() - t0
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
