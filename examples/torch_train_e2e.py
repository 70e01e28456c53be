"""End-to-end training example of the PyTorch/CUDA port: ~100M-parameter LM,
synthetic data pipeline, AdamW + WSD/cosine schedule, microbatched gradient
accumulation, async checkpointing with atomic publish, and preemption/restart
recovery, as ``examples/train_e2e.py`` runs them on the JAX package.

    PYTHONPATH=src python examples/torch_train_e2e.py --steps 300
    PYTHONPATH=src python examples/torch_train_e2e.py --steps 300 --preempt-at 40
    PYTHONPATH=src python examples/torch_train_e2e.py --steps 300   # resumes at 40

The model is an olmo-family LM scaled to ~100M params; any ``--arch`` from the
registry works (its reduced config). ``--device`` defaults to ``cuda`` and a
missing card is an error; ``--device cpu`` trains through the plain PyTorch
path. ``--preempt-at`` ends the process (exit code 17) after that step, once the
last checkpoint is published; re-running resumes from the latest published
step with the same data order (a stateless data iterator keyed on (seed,
step)). The latest step may be one that ``examples/train_e2e.py`` wrote with
the JAX package's checkpoint manager, for the same ``--arch``: it is read in
that layout (``CheckpointManager.restore`` with ``compat.jax_layout``), so a
run of the JAX example resumes here. The port writes its own layout.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch import compat, tree
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import DataIterator
from repro_torch.models import api
from repro_torch.train import trainer
from repro_torch.train.optimizer import OptConfig


def model_100m() -> ModelConfig:
    """olmo-style dense LM, ~100M params (8L x 768, vocab 32k)."""
    return dataclasses.replace(
        registry.get("olmo-1b"), name="olmo-100m", num_layers=8,
        d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
        d_ff=3072, vocab_size=32_000)


def main(argv=None):
    """Trains; returns each step's loss and the run's rates and checkpoint
    times. A ``--preempt-at`` run exits with code 17 instead."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="100m",
                    help="'100m' or a registry id (reduced config)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="results/train_e2e_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--preempt-at", type=int, default=None,
                    help="simulate preemption: exit after this step")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = api.resolve_device(args.device)

    cfg = model_100m() if args.arch == "100m" \
        else registry.get(args.arch).reduced()
    print(f"arch={cfg.name} ~{cfg.param_count()/1e6:.1f}M params "
          f"(schedule={cfg.lr_schedule}) on {device}")

    run = trainer.RunConfig(
        microbatches=args.microbatches, remat="none",
        opt=OptConfig(lr=args.lr, warmup_steps=20, schedule=cfg.lr_schedule,
                      total_steps=args.steps))
    state = trainer.init_state(cfg, run, args.seed, device=device)
    n_params = sum(p.numel() for p in tree.leaves(state.params))
    print(f"actual params: {n_params/1e6:.1f}M")

    ckpt = CheckpointManager(args.ckpt_dir, keep_last=3)
    stacked = compat.jax_layout(state)        # the JAX example's layout of it
    t0 = time.perf_counter()
    start_step, restored = ckpt.restore_latest(state, stacked=stacked)
    _sync(device)
    restore_s = None
    if start_step is None:
        start_step = 0
    else:
        restore_s = time.perf_counter() - t0
        print(f"[restart] resumed from checkpoint step {start_step} "
              f"({ckpt.layout(start_step, state, stacked)} layout, {restore_s:.2f}s)")
        state = restored

    step_fn = trainer.make_train_step(cfg, run)
    data = DataIterator(cfg, batch=args.batch, seq=args.seq,
                        start_step=start_step)

    losses = []
    t_start = t_last = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(data).items()}
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"])
        if (step + 1) % args.log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            tok_s = args.batch * args.seq * args.log_every / max(dt, 1e-9)
            print(f"step {step+1:4d}  loss={loss:.4f}  "
                  f"lr={float(metrics['lr']):.2e}  "
                  f"{tok_s/1e3:.1f}k tok/s", flush=True)
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state)          # async, atomic
        if args.preempt_at is not None and step + 1 >= args.preempt_at:
            ckpt.wait()
            print(f"[preempt] simulated preemption at step {step+1} — "
                  f"re-run to resume")
            sys.exit(17)

    _sync(device)
    train_s = time.perf_counter() - t_start
    ckpt.wait()
    t0 = time.perf_counter()
    ckpt.save(args.steps, state, blocking=True)
    save_s = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    tok_s = args.batch * args.seq * len(losses) / train_s
    print(f"done: {args.steps} steps, final loss "
          f"{losses[-1] if losses else float('nan'):.4f}; {tok_s/1e3:.1f}k tok/s; "
          f"last save {save_s:.2f}s; checkpoints in {args.ckpt_dir}")
    return {"start_step": start_step, "losses": losses, "tokens_per_s": tok_s,
            "save_seconds": save_s, "restore_seconds": restore_s}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    main()
