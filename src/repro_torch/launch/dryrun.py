"""Multi-pod dry-run: count every (arch x shape) cell on the production meshes
without running it on a device, the counterpart of
``src/repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--out results/dryrun_torch.json]

Each mesh is a ``"fake"`` process group of 256 or 512 ranks, this process
being rank 0; the cell's meta arguments are placed by their
``in_shardings`` as ``DTensor``s and the step runs on meta tensors under
``utils.cost.CostCounter``. Its numbers are rank 0's, one device's, as the
reference's are. Results are written incrementally (resumable; ``--force``
recomputes). The default output is not the reference's file.

The record has the reference's keys, less what has no counterpart in an eager
step (``xla_flops_per_device``, ``xla_bytes_per_device``,
``mem.generated_code_bytes``, ``t_lower_s``, ``t_compile_s``); ``t_run_s``
takes the place of the two times. ``mem.temp_bytes`` is the counter's peak of
the bytes the step created, ``mem.peak_bytes`` that plus the arguments' bytes.

Serving cells. Every cell, of every family, runs the sharded serving steps
(``serve.decode``'s ``mesh=``) on the cell's arguments placed as
``DTensor``s: the parameters in the serving layout, the batch, the cache
and the tokens by their specs; nothing is gathered whole. A decode cell is
one new token against a full cache (``long_500k``'s too, its cache laid out
by ``seq_shard_cache``): the cache's ``idx`` is set to ``seq_len - 1``.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.parallel import sharding as shd
from repro_torch.utils.cost import CostCounter, nbytes

OUT_DEFAULT = "results/dryrun_torch.json"
MESHES = {"single_pod_16x16": False, "multi_pod_2x16x16": True}
PLAN_KEYS = ("microbatches", "remat", "moe_impl", "moe_sharding", "opt_dtype",
             "grad_dtype", "seq_shard_acts", "seq_shard_cache")


def init_fake_group(world: int) -> None:
    """A ``"fake"`` process group of ``world`` ranks, this process rank 0
    (replacing one of another size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _place(args, shardings, mesh, requires_grad=False):
    """Each meta tensor of ``args`` as a DTensor placed by its entry of
    ``shardings`` (no data moves: meta tensors, ``src_data_rank=None``)."""
    return tree.rebuild(args, [
        distribute_tensor(x, mesh, pl, src_data_rank=None).requires_grad_(requires_grad)
        for x, pl in zip(tree.leaves(args), tree.leaves(shardings, is_leaf=shd.is_spec))])


def _serve_args(shape, cell, mesh):
    """The arguments of a serving cell, each placed by its entry of
    ``in_shardings``; a decode cell's cache at ``idx`` ``seq_len - 1``."""
    if shape.kind == "prefill":
        params, batch = cell["args"]
        p_sh, b_sh = cell["in_shardings"]
        return _place(params, p_sh, mesh), _place(batch, b_sh, mesh)
    params, cache, tokens = cell["args"]
    p_sh, c_sh, t_sh = cell["in_shardings"]
    placed = _place({k: cache[k] for k in c_sh}, c_sh, mesh)
    placed["idx"] = shape.seq_len - 1
    return (_place(params, p_sh, mesh), placed,
            distribute_tensor(tokens, mesh, t_sh, src_data_rank=None))


def _train_args(cell, mesh):
    state, batch = cell["args"]
    st_sh, b_sh = cell["in_shardings"]
    # the step count stays a plain tensor, as trainer.shard_state keeps it
    params = _place(state.params, st_sh.params, mesh, requires_grad=True)
    o = state.opt_state
    opt_state = o._replace(m=_place(o.m, st_sh.opt_state.m, mesh),
                           v=_place(o.v, st_sh.opt_state.v, mesh))
    return (state._replace(params=params, opt_state=opt_state),
            _place(batch, b_sh, mesh))


def run_cell(cfg, shape, mesh, mesh_kind: str, plan=None) -> dict:
    t0 = time.time()
    cell = specs_lib.build_cell(cfg, shape, mesh, plan=plan)
    args = (_train_args(cell, mesh) if shape.kind == "train"
            else _serve_args(shape, cell, mesh))
    arg_bytes = sum(nbytes(x) for x in tree.leaves(args) if isinstance(x, torch.Tensor))
    with CostCounter() as c:
        out = cell["fn"](*args)
    t_run = time.time() - t0
    coll = c.collective_bytes()
    out_bytes = sum(nbytes(x) for x in tree.leaves(out) if isinstance(x, torch.Tensor))
    plan = cell["plan"]
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_kind,
        "status": "ok",
        "devices": mesh.size(),
        "kind": cell["meta"]["kind"],
        "tokens": cell["meta"]["tokens"],
        "plan": {k: getattr(plan, k) for k in PLAN_KEYS},
        "flops_per_device": c.flops,
        "bytes_per_device": c.bytes,
        "collective_bytes_per_device": coll.get("total", 0.0),
        "collectives": {k: v for k, v in coll.items() if not k.startswith("count")},
        "collective_counts": {k: v for k, v in coll.items() if k.startswith("count")},
        "mem": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": c.peak_bytes,
            "peak_bytes": arg_bytes + c.peak_bytes,
        },
        "t_run_s": round(t_run, 2),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT_DEFAULT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--include-extra", action="store_true",
                    help="also run llama3-8b (not part of the 40 cells)")
    args = ap.parse_args(argv)

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = {}
    if out_path.exists():
        results = json.loads(out_path.read_text())

    kinds = [k for k, multi in MESHES.items()
             if args.mesh == "both" or (args.mesh == "multi") == multi]
    cells = [c for c in registry.cells(include_extra=args.include_extra)
             if (not args.arch or c[0].name == args.arch)
             and (not args.shape or c[1].name == args.shape)]
    for mesh_kind in kinds:
        multi = MESHES[mesh_kind]
        init_fake_group(512 if multi else 256)
        mesh = mesh_lib.make_production_mesh(multi_pod=multi)
        for cfg, shape, supported, why in cells:
            key = f"{cfg.name}|{shape.name}|{mesh_kind}"
            if key in results and results[key].get("status") == "ok" \
                    and not args.force:
                print(f"[skip cached] {key}")
                continue
            if not supported:
                results[key] = {"arch": cfg.name, "shape": shape.name,
                                "mesh": mesh_kind, "status": "skipped",
                                "reason": why}
                print(f"[skip arch] {key}: {why}")
                out_path.write_text(json.dumps(results, indent=1))
                continue
            print(f"[count] {key} ...", flush=True)
            try:
                rec = run_cell(cfg, shape, mesh, mesh_kind)
                peak = rec["mem"]["peak_bytes"]
                print(f"  ok: flops/dev={rec['flops_per_device']:.3g} "
                      f"peak={peak/1e9:.2f}GB coll={rec['collective_bytes_per_device']:.3g}B "
                      f"run={rec['t_run_s']}s", flush=True)
            except Exception as e:  # noqa: BLE001 - record and continue
                rec = {"arch": cfg.name, "shape": shape.name,
                       "mesh": mesh_kind, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                print(f"  ERROR {type(e).__name__}: {str(e)[:300]}", flush=True)
            results[key] = rec
            out_path.write_text(json.dumps(results, indent=1))
    if dist.is_initialized():
        dist.destroy_process_group()
    n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
    n_err = sum(1 for r in results.values() if r.get("status") == "error")
    n_skip = sum(1 for r in results.values() if r.get("status") == "skipped")
    print(f"done: {n_ok} ok, {n_err} errors, {n_skip} skipped -> {out_path}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
