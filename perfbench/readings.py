#!/usr/bin/env python3
"""The readings that a cell's limits are set from (``limits/<cell>.json``).

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--faults half_batch] [--fault-seeds 7,8,9] [--seconds 6]

In one process, for each seed: the cell's set-up, a window of
``--seconds`` at the cell's own load (long enough to finish its longest
requests), and the correctness check, printing the numbers it compares as
one JSON line. With ``--control-seeds``, those seeds' lines also hold the
control's numbers (the reference in float8, ``control_*``); with
``--faults``, each fault is planted in the program on each of
``--fault-seeds`` and its numbers read. The benchmark's own runs run none
of this.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=6.0)
    a = p.parse_args(argv)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness
    ints = lambda s: [int(x) for x in s.split(",") if x]
    control = set(ints(a.control_seeds))
    jobs = [(s, None, s in control) for s in ints(a.seeds)]
    jobs += [(s, None, True) for s in control if s not in ints(a.seeds)]
    jobs += [(s, f, False) for f in a.faults.split(",") if f for s in ints(a.fault_seeds)]
    for seed, fault, ctl in jobs:
        t0 = time.time()
        ctx = harness.Ctx.of_cell(a.workload, seed, a.seconds, False, "cuda",
                                  control=ctl, fault=fault)
        out = harness.run(ctx)
        line = {"workload": a.workload, "seed": seed, "fault": fault, "control": ctl,
                "correct": out["correct"], "seconds": time.time() - t0,
                "checks": {k: v["value"] for k, v in out["checks"].items()},
                "readings": out["readings"], "metrics": out["metrics"]}
        print(json.dumps(line), flush=True)
        del ctx, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
