"""Serving launcher: continuous-batching engine over the decode step, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --full \\
        --requests 8 --slots 4 --prompt-len 512 --max-new 16 --max-seq 1024

``--reduced`` (the default) serves the tiny same-family config; ``--full`` (or
``--no-reduced``) serves the architecture at its published size. ``--device``
defaults to ``cuda`` and a missing card is an error; ``--device cpu`` runs the
plain PyTorch path. Before serving it prints the simulator's split-KV decode
prediction for the serving workload on the H800 preset, as the JAX launcher
does. The JAX launcher's ``SimFA-TPU`` line has no counterpart while
``core/tpu/`` is not ported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.llama3 import AttnWorkload
from repro_torch.core import analytical
from repro_torch.core.machine import H800
from repro_torch.models import api
from repro_torch.serve.engine import Request, ServeEngine, StragglerPolicy


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="published width and depth (same as --no-reduced)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def decode_prediction(cfg, slots: int, max_seq: int) -> str:
    """The analytical model's split-KV decode step for ``slots`` rows of a
    ``max_seq`` cache, on the H800 preset, as one line of text."""
    w = AttnWorkload(name="decode", B=slots, L=1, S=max_seq,
                     H_kv=cfg.num_kv_heads or 4, G=cfg.q_group_size or 1,
                     D=cfg.head_dim)
    gpu = analytical.analyze(w, H800, kernel="splitkv_decode")
    return (f"SimFA-H800 split-KV decode prediction: {gpu.latency*1e6:.1f} us "
            f"({gpu.bottleneck}-bound, "
            f"{gpu.dram_bytes/1e6:.2f} MB DRAM/step)")


def main(argv=None):
    args = build_parser().parse_args(argv)

    device = api.resolve_device(args.device)
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = api.init(cfg, args.seed, device=device)
    print(decode_prediction(cfg, args.slots, args.max_seq))

    eng = ServeEngine(cfg, params, slots=args.slots, max_seq=args.max_seq,
                      straggler=StragglerPolicy(expected_step_s=0.5, factor=10),
                      device=device)
    del params
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(rid=i,
                           prompt=rng.integers(0, cfg.vocab_size,
                                               args.prompt_len),
                           max_new=args.max_new))
    t0 = time.time()
    while eng.queue or any(eng.active):
        eng.step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = args.requests * args.max_new
    print(f"served {args.requests} requests / {toks} tokens of {cfg.name} on "
          f"{device} in {eng.steps} steps, {dt:.2f}s; "
          f"{eng.straggler.slow_steps} straggler step(s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
