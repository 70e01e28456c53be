"""Pipeline analysis CLI: stall attribution, critical path, what-if replay
(the PyTorch port's twin of ``examples/analyze_pipeline.py``: the same
command line and the same numbers, from the port's copy of the simulator,
``repro_torch.core`` / ``analysis`` / ``obs``; it imports neither JAX nor the
JAX package, and launches no kernel).

Simulate one FlashAttention-3 launch with event recording, then ask the
questions the flat gantt chart could not answer:

  where did each warpgroup's idle cycles go?      (stall buckets)
  what sequence of operations bounds the kernel?  (critical path)
  what if TMA bandwidth / WGMMA throughput / softmax cost changed?
                                                  (DAG replay, no resim)

    PYTHONPATH=src python examples/torch_analyze_pipeline.py
    PYTHONPATH=src python examples/torch_analyze_pipeline.py \
        --model 8B --seqlen 2048 --knob tma_bw=2 --knob wgmma=1.5
    PYTHONPATH=src python examples/torch_analyze_pipeline.py \
        --sweep tma_bw=0.5,1,2,4 --json results/whatif.json
    PYTHONPATH=src python examples/torch_analyze_pipeline.py \
        --report --trace-out results/fa3.trace.json   # open in ui.perfetto.dev
    PYTHONPATH=src python examples/torch_analyze_pipeline.py \
        --kernel fa2 --verify                # pre-simulation lint, exit != 0
                                             # when the spec is illegal
"""
from __future__ import annotations

import argparse
import sys

from repro_torch import obs
from repro_torch.analysis import critical_path as cp
from repro_torch.analysis import dag as dag_mod
from repro_torch.analysis import report
from repro_torch.analysis.sweep import SweepPoint, knob_grid, run_sweep
from repro_torch.configs.llama3 import FAMILY, AttnWorkload, workload
from repro_torch.core.kprog import registry as kernel_registry
from repro_torch.core.machine import H800
from repro_torch.core.simfa import simulate_fa3


def _parse_knob(spec: str):
    name, _, val = spec.partition("=")
    if name not in ("tma_bw", "wgmma", "softmax"):
        raise argparse.ArgumentTypeError(f"unknown knob {name!r}")
    return name, [float(v) for v in val.split(",")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="8B", choices=("8B", "70B", "405B"))
    ap.add_argument("--kernel", default="fa3",
                    choices=kernel_registry.available(),
                    help="registered kernel program to analyze "
                         "(splitkv_decode forces a decode-shaped workload)")
    ap.add_argument("--seqlen", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--fidelity", default="auto",
                    choices=("auto", "full", "hierarchical"))
    ap.add_argument("--knob", action="append", default=[], type=_parse_knob,
                    metavar="NAME=K[,K...]",
                    help="what-if multiplier(s): tma_bw / wgmma / softmax; "
                         "repeatable, values form a cartesian grid")
    ap.add_argument("--sweep", action="append", default=[], type=_parse_knob,
                    help="alias of --knob (reads better for multi-point runs)")
    ap.add_argument("--top", type=int, default=8,
                    help="show the N widest-idle warpgroups (0 = all)")
    ap.add_argument("--json", default="", help="dump results to this path")
    ap.add_argument("--trace-out", default="",
                    help="export a Perfetto/Chrome trace_event JSON of the "
                         "run (PipeEvents + counter tracks) to this path; "
                         "open in ui.perfetto.dev")
    ap.add_argument("--report", action="store_true",
                    help="print the NCU-style section report (speed-of-"
                         "light %%, occupancy, stall buckets)")
    ap.add_argument("--counter-window", type=int, default=256,
                    help="PM-counter sampling window in cycles")
    ap.add_argument("--verify", action="store_true",
                    help="statically verify the kernel program for this "
                         "workload (deadlock freedom, ring/barrier/commit "
                         "protocol, hazards) and exit: 0 clean, 1 errors. "
                         "A pre-simulation lint — nothing is simulated.")
    args = ap.parse_args(argv)

    if args.kernel == "splitkv_decode":
        # decode shape: one new token per sequence against a resident cache
        f = FAMILY[args.model]
        w = AttnWorkload(name=f"llama3-{args.model}-decode-s{args.seqlen}",
                         B=args.batch, L=1, S=args.seqlen,
                         H_kv=f["H_kv"], G=f["G"], D=f["D"])
    else:
        w = workload(args.model, args.seqlen, batch=args.batch,
                     causal=args.causal)

    if args.verify:
        from repro_torch.core.kprog.verify import verify_spec
        spec = kernel_registry.get(args.kernel, verify=False)
        vrep = verify_spec(spec, cfg=H800, w=w)
        print(vrep.render())
        sys.exit(0 if vrep.ok else 1)

    print(f"simulating {w.name} ({args.kernel}) on {H800.name} "
          f"(fidelity={args.fidelity}) ...")
    want_counters = bool(args.trace_out) or args.report
    res = simulate_fa3(w, H800, fidelity=args.fidelity, record_events=True,
                       record_counters=want_counters,
                       counter_window=args.counter_window,
                       kernel=args.kernel)
    print(f"  {res.cycles:.0f} cycles = {res.latency_us:.1f} us "
          f"({res.fidelity}, {len(res.trace.events)} events)\n")

    if args.report:
        rep_ncu = obs.build_report(res, H800, workload=w,
                                   manifest=res.manifest)
        print(obs.render_report(rep_ncu))
        print()

    dag = dag_mod.build(res.trace.events, res.trace.dispatch_parent)

    rep = cp.attribute_stalls(dag)
    print(report.render_stall_report(rep, top=args.top))
    print()
    print("per-role totals (declared warpgroup roles):")
    for role, buckets in sorted(rep.by_role().items()):
        parts = ", ".join(f"{k}={v}" for k, v in sorted(buckets.items())
                          if v and k not in ("busy", "idle"))
        print(f"  {role:12s} busy={buckets['busy']} idle={buckets['idle']}"
              + (f"  ({parts})" if parts else ""))
    print()

    path = cp.critical_path(dag)
    summary = cp.path_summary(dag, path)
    print(report.render_critical_path(dag, path, summary))
    print()

    knob_axes = {"tma_bw": (1.0,), "wgmma": (1.0,), "softmax": (1.0,)}
    for name, vals in args.knob + args.sweep:
        knob_axes[name] = tuple(vals)
    grid = knob_grid(**knob_axes)
    if len(grid) > 1 or not grid[0].is_baseline():
        rows = run_sweep([SweepPoint(workload=w, machine=H800,
                                     fidelity=args.fidelity,
                                     kernel=args.kernel)],
                         grid, processes=1)
        print(report.render_whatif_table(rows))
    else:
        rows = []
        print("(no what-if knobs given; try --knob tma_bw=0.5,1,2)")

    if args.trace_out:
        obs.export_trace(args.trace_out, res.trace, res.counters,
                         res.manifest, name=f"{w.name} ({args.kernel})")
        print(f"\nwrote {args.trace_out} (open in ui.perfetto.dev)")

    if args.json:
        report.save_json(args.json, {
            "workload": w.name, "kernel": args.kernel, "cycles": res.cycles,
            "stalls": {"per_wg": rep.per_wg, "meta": rep.meta,
                       "totals": rep.totals()},
            "critical_path_summary": summary,
            "whatif": rows,
        }, manifest=res.manifest)
        print(f"\nwrote {args.json}")


if __name__ == "__main__":
    main()
