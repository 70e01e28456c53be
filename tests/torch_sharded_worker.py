"""One rank of a sharded training run through ``trainer.make_train_step(...,
mesh=)``, for the parity tests on gloo ranks (``tests/test_torch_parallel.py``,
``tests/test_torch_parallel_families.py``) and for the same run on cards over
NCCL.

    python tests/torch_sharded_worker.py RANK WORLD JOB_JSON

runs one rank of ``JOB_JSON`` (the tests start one process a rank on a
``file://`` store and read rank 0's ``<out>.json`` / ``<out>.npz``). The job's
keys: ``arch``, ``mesh`` (data, model), ``batch``, ``seq``, ``steps``,
``microbatches``; optional ``replace`` (config fields; the reduced config in
fp32 compute is the default), ``residual`` (the activation scope's residual
spec each step runs in, as a train cell's plan gives it:
``["data", "model", null]``), ``resume`` (a checkpoint directory whose latest
step, in the port's layout or the JAX package's, the run restores and trains on
from, up to ``steps``), ``store``, ``out``, ``ckpt``.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tests/torch_sharded_worker.py --chip --arch olmo-1b --tp 4 --out F.json

runs full-width ``arch`` in its own compute type on one card a rank (NCCL;
without ``torch.distributed.run``, one rank on one card), 3 steps with the
launcher's optimizer settings, once without and once with the train cell's
residual spec, and writes each run's losses, step ms, every rank's peak
memory and one profiled step to ``F.json``. ``--cut FIELD=N`` (repeated)
cuts the depth (``--cut num_layers=4``; zamba2-7b as ``chip_smoke.py``'s
parallel phase: ``--cut hybrid_prologue=1 --cut hybrid_groups=2 --cut
hybrid_mamba_per_group=2 --cut num_layers=7``).
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch import compat, tree
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data.synthetic import DataIterator
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import encdec, moe, transformer
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as shd
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer

SP_RESIDUAL = ("data", "model", None)       # a train cell's residual spec


def run_config(cfg, job):
    """The launcher's optimizer settings over ``job``'s steps."""
    return trainer.RunConfig(microbatches=job["microbatches"], remat=job.get("remat", "full"),
                             opt=opt.OptConfig(lr=3e-4, warmup_steps=10,
                                               total_steps=job["steps"],
                                               schedule=cfg.lr_schedule))


def scoped(step, residual):
    """``step`` run inside the activation scope of ``residual`` (none: as is)."""
    if residual is None:
        return step

    def run(state, batch):
        with pctx.activation_sharding(residual=tuple(residual)):
            return step(state, batch)
    return run


def dropped_in_first_group(idx, cfg, group):
    """(tokens, group size, dropped (token, choice) pairs of the first group)
    of one routing ``idx`` (T, k) in the einsum dispatch's groups."""
    T, k = idx.shape
    g = min(group, T)
    cap = max(1, int(g * k / cfg.num_experts * cfg.capacity_factor))
    first = idx[:g].reshape(-1)
    pos = torch.cumsum(torch.nn.functional.one_hot(first, cfg.num_experts), dim=0) - 1
    return [T, g, int((pos.gather(1, first[:, None]) >= cap).sum())]


# the sequence-parallel operators of ``parallel.ctx`` that move a sequence
# between rows and the whole (a ``Recorder`` counts their calls under the split)
SEQ_OPS = ("seq_rows", "seq_gather", "seq_gather_f32", "seq_columns_to_rows",
           "seq_rows_of_sum")
# the blocks of the hybrid, ssm and encdec stacks whose input rows a
# ``Recorder`` notes, by (module, function)
STACK_BLOCKS = {"mamba": (transformer, "_mamba_layer_apply"),
                "rwkv": (transformer, "_rwkv_layer_apply"),
                "enc": (encdec, "_enc_block"), "dec": (encdec, "_dec_block")}


class Recorder:
    """What a run's checks read, recorded while it trains: each block's input
    rows (``_block_apply``'s, and apart those of ``STACK_BLOCKS``), the
    routing groups each MoE layer queues, the model-group all-reduces of
    inputs' gradients (``all_reduce_f32``), the reduce-scatters of a gathered
    sequence's gradient back to the rows (``seq_gather_f32``'s), the calls of
    ``SEQ_OPS`` under the split, the forward all-reduces of 2-d or larger
    tensors (a sum of per-rank partial products, C32) and any
    ``full_tensor``."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.block_rows, self.groups, self.fwd_reduces = set(), [], []
        self.stack_rows = {k: set() for k in STACK_BLOCKS}
        self.model_sums, self.seq_scatters, self.seq_ops, self.gathers = 0, 0, 0, 0

    def __enter__(self):
        self.saved = (transformer._block_apply, moe.aux_load_balance_loss, DTensor.full_tensor,
                      pctx.all_reduce_f32, dist.all_reduce, pctx._SeqGatherF32.backward)
        self.saved_fns = {k: getattr(m, f) for k, (m, f) in STACK_BLOCKS.items()}
        self.saved_ops = {op: getattr(pctx, op) for op in SEQ_OPS}
        block, aux, full_tensor, all_reduce_f32, all_reduce, seq_scatter = self.saved

        def rec_block(p, x, cfg, **kw):
            self.block_rows.add(int(x.shape[1]))
            return block(p, x, cfg, **kw)

        def rec_stack(key, fn):
            def run(p, x, *a, **kw):
                self.stack_rows[key].add(int(x.shape[1]))
                return fn(p, x, *a, **kw)
            return run

        def rec_op(fn):
            def run(x):
                self.seq_ops += pctx.seq_parallel()
                return fn(x)
            return run

        def rec_aux(probs, idx, n):
            self.groups.append(dropped_in_first_group(idx, self.cfg, 512))
            return aux(probs, idx, n)

        def rec_full(t, **kw):
            self.gathers += 1
            return full_tensor(t, **kw)

        def rec_f32(x, group):
            self.model_sums += 1
            return all_reduce_f32(x, group)

        def rec_all_reduce(t, *a, **kw):
            if torch._C._current_autograd_node() is None and t.dim() >= 2:
                self.fwd_reduces.append(list(t.shape))
            return all_reduce(t, *a, **kw)

        def rec_seq_scatter(ctx, grad):
            self.seq_scatters += 1
            return seq_scatter(ctx, grad)

        transformer._block_apply, moe.aux_load_balance_loss = rec_block, rec_aux
        DTensor.full_tensor, pctx.all_reduce_f32 = rec_full, rec_f32
        dist.all_reduce = rec_all_reduce
        pctx._SeqGatherF32.backward = staticmethod(rec_seq_scatter)
        for key, (module, name) in STACK_BLOCKS.items():
            setattr(module, name, rec_stack(key, self.saved_fns[key]))
        for op, fn in self.saved_ops.items():
            setattr(pctx, op, rec_op(fn))
        return self

    def __exit__(self, *exc):
        (transformer._block_apply, moe.aux_load_balance_loss, DTensor.full_tensor,
         pctx.all_reduce_f32, dist.all_reduce) = self.saved[:5]
        pctx._SeqGatherF32.backward = staticmethod(self.saved[5])
        for key, (module, name) in STACK_BLOCKS.items():
            setattr(module, name, self.saved_fns[key])
        for op, fn in self.saved_ops.items():
            setattr(pctx, op, fn)


def run_job(rank, world, job):
    """One rank of a parity job on gloo (the module's docstring)."""
    dist.init_process_group("gloo", init_method="file://" + job["store"], rank=rank,
                            world_size=world)
    cfg = dataclasses.replace(registry.get(job["arch"]).reduced(),
                              **{"compute_dtype": "float32", **job.get("replace", {})})
    mesh = make_mesh(tuple(job["mesh"]), ("data", "model"))
    run = run_config(cfg, job)
    state = trainer.shard_state(cfg, trainer.init_state(cfg, run, 0, device="cpu"), mesh)
    sizes = shd.axis_sizes(mesh)
    specs = tree.leaves(shd.param_specs(cfg, state.params, mesh), is_leaf=shd.is_spec)
    for leaf in (state.params, state.opt_state.m, state.opt_state.v):
        for p, spec in zip(tree.leaves(leaf), specs):
            want = list(p.shape)
            for i, e in enumerate(spec):
                if e is not None:
                    want[i] //= int(np.prod([sizes[a] for a in (e if isinstance(e, tuple)
                                                                else (e,))]))
            assert isinstance(p, DTensor) and list(p.to_local().shape) == want, (p.shape, spec)

    start, resumed = 0, None
    if "resume" in job:
        mgr = CheckpointManager(job["resume"], writer=False)
        stacked = compat.jax_layout(state)
        start, restored = mgr.restore_latest(state, stacked=stacked)
        resumed = {"step": start, "layout": mgr.layout(start, state, stacked)}
        state = restored

    residual = job.get("residual")
    step = scoped(trainer.make_train_step(cfg, run, mesh=mesh), residual)
    data = DataIterator(cfg, batch=job["batch"], seq=job["seq"], start_step=start)
    metrics = []
    # the partitioned route: no parameter gathered whole, and the inputs'
    # gradients summed over model: all-reduced where the residual is whole;
    # under sequence parallelism the sequence operators ran (the dense jobs'
    # test also asks for reduce-scatters to the rows)
    with Recorder(cfg) as rec:
        for _ in range(start, job["steps"]):
            batch = trainer.shard_batch({k: torch.from_numpy(v) for k, v in next(data).items()},
                                        mesh, job["microbatches"])
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    assert trainer.route(cfg) == "partitioned" and not rec.gathers
    batch = next(DataIterator(cfg, batch=job["batch"], seq=job["seq"]))
    with pctx.activation_sharding(residual=tuple(residual or ("data", None, None))):
        seq, stacks = trainer.seq_split(cfg, mesh, batch)
    if seq or any(stacks.values()):
        assert rec.seq_ops > 0
    else:
        assert rec.model_sums > 0 and rec.seq_ops == 0 and rec.seq_scatters == 0
    # copies: a replicated leaf's full_tensor is its local tensor, which a later
    # step updates in place
    full = [p.full_tensor().detach().numpy().copy() for p in tree.leaves(state.params)]

    out = {"metrics": metrics, "resumed": resumed, "model_reduces": rec.model_sums,
           "seq_scatters": rec.seq_scatters, "seq_ops": rec.seq_ops, "seq_parallel": seq,
           "seq_stacks": stacks, "block_rows": sorted(rec.block_rows),
           "stack_rows": {k: sorted(v) for k, v in rec.stack_rows.items()},
           "moe_groups": rec.groups,
           "forward_reduces": rec.fwd_reduces}
    if cfg.family == "moe" and job["mesh"][0] > 1:
        # a rank's rows short of a dispatch group are refused
        small = trainer.shard_batch({k: torch.from_numpy(v[:, :16]) for k, v in
                                     next(DataIterator(cfg, batch=4, seq=16)).items()}, mesh)
        try:
            step(state, small)
            out["moe_small_batch"] = "trained"
        except ValueError as e:
            out["moe_small_batch"] = str(e)
        try:                            # an evaluation's forward, without grad: alike
            with torch.no_grad():
                step(state, small)
            out["moe_small_batch_no_grad"] = "ran"
        except ValueError as e:
            out["moe_small_batch_no_grad"] = str(e)
    elif cfg.family == "moe":
        # the scatter dispatch's loss on the partitioned experts, and on one device
        srun = dataclasses.replace(run, moe_impl="scatter")
        batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
        params = [p.full_tensor().detach() for p in tree.leaves(state.params)]
        one = trainer.make_loss_fn(cfg, srun)(tree.rebuild(state.params, params), batch)
        loss = scoped(trainer.make_train_step(cfg, srun, mesh=mesh), residual)(
            state, trainer.shard_batch(batch, mesh))[1]["loss"]
        out["scatter_loss"], out["scatter_loss_one"] = float(loss), float(one[1]["loss"])
    elif world == 4:
        # constrain: a DTensor is redistributed to its kind's placements
        x = distribute_tensor(torch.arange(48.0).reshape(4, 3, 4), mesh,
                              (Replicate(), Replicate()))
        with pctx.activation_sharding(residual=("data", None, "model")):
            y = pctx.constrain(x)
        assert tuple(y.placements) == (Shard(0), Shard(2)), y.placements
        assert torch.equal(y.full_tensor(), x.full_tensor())

        # elastic restore: saved under 2 x 2, restored under 4 x 1
        ck = CheckpointManager(job["ckpt"], async_save=False, writer=rank == 0)
        w = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
        wa = distribute_tensor(w, mesh, shd.placements(("data", "model"), mesh))
        ck.save(job["steps"], {"state": state, "w": wa})
        dist.barrier()
        mesh_b = make_mesh((4, 1), ("data", "model"))
        target = {"state": trainer.shard_state(
                      cfg, trainer.init_state(cfg, run, 1, device="cpu"), mesh_b),
                  "w": distribute_tensor(torch.zeros(64, 32), mesh_b,
                                         shd.placements(("model", "data"), mesh_b))}
        restored = ck.restore(job["steps"], target)
        assert torch.equal(restored["w"].full_tensor(), w)
        assert restored["w"].device_mesh is mesh_b
        assert tuple(restored["w"].placements) == (Shard(1), Shard(0))
        for a, b, t in zip(tree.leaves(restored["state"]), tree.leaves(state),
                           tree.leaves(target["state"])):
            if isinstance(a, DTensor):
                assert a.device_mesh is mesh_b and a.placements == t.placements
                assert a.requires_grad == t.requires_grad
                assert torch.equal(a.full_tensor(), b.full_tensor())
            else:
                assert torch.equal(a, b)
        out["elastic"] = "ok"
    if rank == 0:
        np.savez(job["out"] + ".npz", *full)
        with open(job["out"] + ".json", "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the same run on cards
# ---------------------------------------------------------------------------

def _device_ms(prof):
    """(all, NCCL) device ms of a profiled window's kernels."""
    total = nccl = 0.0
    for e in prof.key_averages():
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3
        if ms and e.device_type == torch.autograd.DeviceType.CUDA:
            total += ms
            nccl += ms if "nccl" in e.key.lower() else 0.0
    return total, nccl


def chip_run(cfg, mesh, job, residual, dev, data):
    """``job``'s steps of the sharded step inside ``residual``'s scope, timed,
    then one more step under the profiler."""
    run = run_config(cfg, job)
    torch.cuda.reset_peak_memory_stats()
    state = trainer.shard_state(cfg, trainer.init_state(cfg, run, 0, device=dev), mesh)
    set_up_peak = torch.cuda.max_memory_allocated()
    step = scoped(trainer.make_train_step(cfg, run, mesh=mesh), residual)
    batches = [trainer.shard_batch({k: torch.from_numpy(v).to(dev) for k, v in b.items()}, mesh)
               for b in data]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log = []
    with Recorder(cfg) as rec:
        for batch in batches[:job["steps"]]:
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            log.append({"ms": (time.perf_counter() - t0) * 1e3,
                        **{k: float(v) for k, v in m.items()}})
    steps_peak = torch.cuda.max_memory_allocated()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batches[-1])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, nccl = _device_ms(prof)
    with pctx.activation_sharding(residual=tuple(residual or ("data", None, None))):
        seq, stacks = trainer.seq_split(cfg, mesh, data[0])
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, [set_up_peak / 1e9, steps_peak / 1e9])
    del state, step, batches
    torch.cuda.empty_cache()
    return {"residual": residual, "seq_parallel": seq, "seq_stacks": stacks,
            "block_rows": sorted(rec.block_rows),
            "stack_rows": {k: sorted(v) for k, v in rec.stack_rows.items()},
            "losses": [x["loss"] for x in log], "grad_norms": [x["grad_norm"] for x in log],
            "step_ms": [x["ms"] for x in log],
            "set_up_peak_gb": [p[0] for p in peaks], "steps_peak_gb": [p[1] for p in peaks],
            "profiled_step": {"wall_ms": wall, "device_busy_ms": busy, "nccl_ms": nccl,
                              "idle_share": 1 - busy / wall if wall else None}}


def chip_main(argv):
    ap = argparse.ArgumentParser(prog="torch_sharded_worker.py --chip")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--tp", type=int, default=None, help="model ranks (default: all)")
    ap.add_argument("--cut", action="append", default=[], metavar="FIELD=N",
                    help="a config field's value, to cut the depth (repeated)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    rank, world = int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    store = None
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group("nccl", device_id=dev)
    else:                               # one rank without torch.distributed.run
        store = os.path.abspath(args.out) + ".store"
        if os.path.exists(store):
            os.remove(store)
        dist.init_process_group("nccl", init_method="file://" + store, rank=0, world_size=1,
                                device_id=dev)
    tp = args.tp or world
    cut = {k: int(v) for k, v in (c.split("=", 1) for c in args.cut)}
    cfg = dataclasses.replace(registry.get(args.arch), **cut)
    mesh = make_mesh((world // tp, tp), ("data", "model"))
    job = {"microbatches": 1, "steps": args.steps, "remat": args.remat}
    it = DataIterator(cfg, batch=args.batch, seq=args.seq)
    data = [next(it) for _ in range(args.steps + 1)]
    runs = [chip_run(cfg, mesh, job, residual, dev, data) for residual in (None, SP_RESIDUAL)]
    if rank == 0:
        out = {"arch": cfg.name, "cut": cut, "mesh": {"data": world // tp, "model": tp},
               "batch": args.batch, "seq": args.seq, "steps": args.steps, "remat": args.remat,
               "compute_dtype": cfg.compute_dtype, "device": torch.cuda.get_device_name(dev),
               "runs": runs}
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps(out))
    dist.destroy_process_group()
    if store is not None and os.path.exists(store):
        os.remove(store)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--chip"]:
        chip_main(sys.argv[2:])
    else:
        run_job(int(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3]))
