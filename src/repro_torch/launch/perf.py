"""Hill-climbing aid: count ONE cell with ``CellPlan`` overrides and print the
three roofline terms, the counterpart of ``src/repro/launch/perf.py``.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch grok-1-314b \\
        --shape train_4k --set microbatches=4 --set cast_params=bfloat16

The cell is counted as ``launch/dryrun.py`` counts it, on a fake process group
of the mesh's size (no device runs). Appends each measurement to
``results/perf_log_torch.json``; the terms are predictions for an H100 SXM5
(``launch/roofline.py``), not measurements.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.dryrun import init_fake_group, run_cell

LOG = Path("results/perf_log_torch.json")


def parse_val(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return int(v)
    except ValueError:
        return v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE", help="CellPlan override")
    ap.add_argument("--tag", default="")
    ap.add_argument("--log", default=str(LOG), help="the JSON list each run is appended to")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    shape = SHAPES[args.shape]
    multi = args.mesh == "multi"
    init_fake_group(512 if multi else 256)
    mesh = mesh_lib.make_production_mesh(multi_pod=multi)
    mesh_kind = "multi_pod_2x16x16" if multi else "single_pod_16x16"

    overrides = {}
    for s in args.set:
        k, v = s.split("=", 1)
        overrides[k] = parse_val(v)

    base_plan = specs_lib.plan_cell(cfg, shape, mesh)
    plan = dataclasses.replace(base_plan, **overrides)
    print(f"plan: {plan}")

    t0 = time.time()
    try:
        rec = run_cell(cfg, shape, mesh, mesh_kind, plan=plan)
    finally:
        dist.destroy_process_group()
    r = roofline.analyze_record(f"{args.arch}|{args.shape}|{mesh_kind}", rec)
    out = {
        "tag": args.tag or ",".join(args.set) or "baseline",
        "arch": args.arch, "shape": args.shape, "mesh": mesh_kind,
        "overrides": overrides,
        "t_compute_s": r["t_compute_s"],
        "t_memory_s": r["t_memory_s"],
        "t_collective_s": r["t_collective_s"],
        "bottleneck": r["bottleneck"],
        "useful_flops_ratio": r["useful_flops_ratio"],
        "roofline_fraction": r["roofline_fraction"],
        "peak_gb": rec["mem"]["peak_bytes"] / 1e9,
        "flops_per_device": rec["flops_per_device"],
        "bytes_per_device": rec["bytes_per_device"],
        "collective_bytes_per_device": rec["collective_bytes_per_device"],
        "seq_split": (specs_lib.prefill_split(cfg, shape, mesh, plan)
                      if shape.kind == "prefill" else None),
        "collectives": rec["collectives"],
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(out, indent=1))
    log_path = Path(args.log)
    log_path.parent.mkdir(parents=True, exist_ok=True)
    log = json.loads(log_path.read_text()) if log_path.exists() else []
    log.append(out)
    log_path.write_text(json.dumps(log, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
