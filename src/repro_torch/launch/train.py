"""Training launcher: a (dp, tp) mesh over the process group, state init on
the card placed by the sharding rules, checkpoint/restart, straggler watchdog
calibrated off the first step, preemption-signal save.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \\
        --batch 8 --seq 64 --steps 20
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --device cpu --dp 2 --tp 2 --reduced --steps 3

``--device`` defaults to ``cuda`` and a missing card is an error; ``--device
cpu`` trains through the plain PyTorch path on gloo. Under
``torch.distributed.run`` each process is one rank (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``; rank r on ``cuda:LOCAL_RANK`` under NCCL); without it, and
without a process group set up by the caller, the launcher makes a one-rank
group on a local file store, so one card runs the same code. The mesh is
``(dp, tp)`` over ``("data", "model")`` (``launch/mesh.py``): a group of another
size raises ``MeshSizeError``. Parameters and AdamW moments are ``DTensor``s
placed by ``parallel.sharding.param_specs``; each rank trains on its rows of
the batch (``trainer.make_train_step(..., mesh=)``), every family partitioned
over ``model`` (ROADMAP A1, A1b). Only rank 0 prints and writes checkpoints;
every rank takes part in gathering them, and a checkpoint restores under
another ``(dp, tp)``.

Every ``--arch`` value trains: dense, moe, vlm, hybrid, ssm and encdec (the
loss adds 0.01 x the MoE load-balance loss; an encdec batch carries the stub
front end's frames). A moe model at published width does not fit one card:
one ``dbrx-132b`` layer with its embeddings is about 4.5 B parameters, about
72 GB of fp32 weights, gradients and AdamW moments before activations. Nor
does ``zamba2-7b`` at published width: its 5.63 B parameters come to about
90 GB of fp32 weights, gradients and AdamW moments, nor ``rwkv6-7b`` (7.58 B
parameters, about 121 GB). ``whisper-large-v3`` (1.62 B, about 26 GB) would.
Before training it prints the simulator's attention prediction for the
training workload on the H800 preset and, where the JAX launcher prints its
SimFA-TPU line, the ``SimFA-H100`` line: ``core/sm90``'s plan for the port's
own bf16 forward kernel (its ring depth, predicted µs and bound) beside the
kernel's default depth, which the trainer keeps.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import signal
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.llama3 import AttnWorkload
from repro_torch.core import analytical
from repro_torch.core.machine import H800
from repro_torch.core.sm90.analytical import analyze_sm90
from repro_torch.core.sm90.autotune import autotune_flash
from repro_torch.data.synthetic import DataIterator
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import api
from repro_torch.serve.engine import StragglerPolicy
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-trainable)")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="results/train_launch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap


def attention_prediction(cfg, batch: int, seq: int) -> str:
    """The analytical model's causal FA3 forward for one layer of the training
    workload, on the H800 preset, as one line of text."""
    w = AttnWorkload(name="train", B=batch, L=seq, S=seq,
                     H_kv=cfg.num_kv_heads or 4, G=cfg.q_group_size or 1,
                     D=cfg.head_dim, causal=True)
    gpu = analytical.analyze(w, H800, kernel="fa3")
    return (f"SimFA-H800 attention prediction: {gpu.latency*1e6:.1f} us/layer "
            f"({gpu.bottleneck}-bound) — watchdog calibrates off step 1")


def sm90_attention_prediction(cfg, batch: int, seq: int) -> str:
    """SimFA-H100's plan for one layer's bf16 forward kernel
    (``csrc/flash_fwd_sm90.cu``, causal) at the training workload, beside the
    kernel's default."""
    w = AttnWorkload(name="train", B=batch, L=seq, S=seq,
                     H_kv=cfg.num_kv_heads or 4, G=cfg.q_group_size or 1,
                     D=cfg.head_dim, causal=True)
    if w.D > 128:
        return f"SimFA-H100 bf16 forward kernel: no plan (head_dim {w.D} > 128)"
    plan = autotune_flash(w, causal=True)
    rule = analyze_sm90(w, kernel="flash_fwd")
    return (f"SimFA-H100 bf16 forward kernel plan: stages {plan.stages}, "
            f"{plan.predicted_us:.1f} us/layer ({plan.bottleneck}-bound); the kernel's "
            f"default stages {rule.stages}: {rule.latency*1e6:.1f} us/layer")


@contextlib.contextmanager
def process_group(device: torch.device):
    """The default process group for the run: the caller's, if one is set up;
    else ``torch.distributed.run``'s (from its environment) or a one-rank group
    on a local file store, either destroyed on exit. NCCL for a CUDA device,
    gloo for the CPU."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                                    rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _all_ranks_agree(flag: bool, device) -> bool:
    """True on every rank when any rank's ``flag`` is: a checkpoint's gather
    needs every rank in the same step."""
    if dist.get_world_size() == 1:
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def main(argv=None):
    """Trains; returns 0, or 17 after a SIGTERM's checkpoint. The SIGTERM
    handler the run installs is taken down on every way out, the previous one
    put back (the reference's launcher leaves its own installed): a process
    that calls ``main`` and forks later, as a test worker running a sweep
    does, must not hand the flag-only handler to its children (ROADMAP C31)."""
    args = build_parser().parse_args(argv)
    device = api.resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    handler = signal.getsignal(signal.SIGTERM)
    try:
        with process_group(device):
            return _train(args, device)
    finally:
        signal.signal(signal.SIGTERM, handler)


def _train(args, device):
    mesh = make_mesh((args.dp, args.tp), ("data", "model"))
    lead = dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    say(f"mesh (data {args.dp}, model {args.tp}) on {dist.get_world_size()} rank(s), "
        f"device {device}; arch {cfg.name} ({cfg.param_count()/1e6:.1f}M params analytic)")

    run = trainer.RunConfig(
        microbatches=args.microbatches, remat=args.remat,
        opt=opt.OptConfig(lr=args.lr, warmup_steps=10,
                          total_steps=args.steps, schedule=cfg.lr_schedule))
    state = trainer.shard_state(cfg, trainer.init_state(cfg, run, 0, device=device), mesh)

    ckpt = CheckpointManager(args.ckpt_dir, keep_last=2, writer=lead)
    start = 0
    if ckpt.latest_step() is not None:
        start, state = ckpt.restore_latest(state)
        say(f"[restart] resumed from step {start}")

    # straggler deadline: the first step's time (set below) times the factor;
    # the simulator's prediction is printed beside it
    watchdog = StragglerPolicy(expected_step_s=1.0, factor=5.0)
    say(attention_prediction(cfg, args.batch, args.seq))
    say(sm90_attention_prediction(cfg, args.batch, args.seq))

    step_fn = trainer.make_train_step(cfg, run, mesh=mesh)
    data = DataIterator(cfg, batch=args.batch, seq=args.seq, start_step=start)

    # preemption: SIGTERM triggers a final checkpoint before exit
    preempted = {"flag": False}
    signal.signal(signal.SIGTERM, lambda *a: preempted.__setitem__("flag", True))

    for step in range(start, args.steps):
        batch = trainer.shard_batch(
            {k: torch.from_numpy(v).to(device) for k, v in next(data).items()},
            mesh, args.microbatches)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])             # waits for the step
        dt = time.time() - t0
        if step == start:
            watchdog.expected_step_s = dt          # calibrate
        slow = watchdog.observe(dt)
        say(f"step {step+1:4d} loss={loss:.4f} "
            f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms"
            + ("  [STRAGGLER]" if slow else ""), flush=True)
        stop = _all_ranks_agree(preempted["flag"], device)
        if (step + 1) % args.ckpt_every == 0 or stop:
            ckpt.save(step + 1, state)
        if stop:
            ckpt.wait()
            say("[preempt] checkpoint published; exiting")
            return 17
    ckpt.wait()
    peak = _peak_gb(device)
    ckpt.save(args.steps, state, blocking=True)
    say(f"done: {args.steps} steps; {watchdog.slow_steps} straggler "
        f"step(s); checkpoints in {args.ckpt_dir}"
        + (f"; peak memory {peak:.3f} GB a rank (the ranks' largest)" if peak else ""))
    return 0


def _peak_gb(device):
    """The largest ``torch.cuda.max_memory_allocated`` of the ranks, in GB
    (``None`` on the CPU)."""
    if device.type != "cuda":
        return None
    t = torch.tensor([torch.cuda.max_memory_allocated(device) / 1e9], device=device)
    if dist.get_world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


if __name__ == "__main__":
    raise SystemExit(main())
