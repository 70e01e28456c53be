"""End-to-end serving example of the PyTorch/CUDA port: batched requests
through the continuous-batching engine, as ``examples/serve_e2e.py`` drives
the JAX package's, beside the simulator's predictions of the decode step.

    PYTHONPATH=src python examples/torch_serve_e2e.py --requests 12 --slots 4
    PYTHONPATH=src python examples/torch_serve_e2e.py --full --arch qwen2.5-3b
    PYTHONPATH=src python examples/torch_serve_e2e.py --device cpu

The tiny same-family config is served unless ``--full`` asks for the published
width and depth. ``--device`` defaults to ``cuda`` and a missing card is an
error; there the prefills and decode steps go through the hand-written
attention kernels. The lines ``SimFA-H800 split-KV decode prediction`` and
``SimFA-H100 bf16 decode kernel plan`` are ``launch/serve.py``'s.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.launch.serve import decode_prediction, sm90_decode_prediction
from repro_torch.models import api
from repro_torch.serve.engine import Request, ServeEngine, StragglerPolicy


def main(argv=None):
    """Serves the requests; returns the tokens, seconds and tokens/s."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--full", action="store_true",
                    help="published width and depth (default: the reduced config)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = api.resolve_device(args.device)
    cfg = registry.get(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    print(f"serving {cfg.name}: {args.requests} requests, "
          f"{args.slots} slots, prompt={args.prompt_len}")
    params = api.init(cfg, args.seed, device=device)

    # the simulator predicts the decode step on the target hardware; the
    # engine flags steps slower than factor x the expected step as stragglers
    print(f"  {decode_prediction(cfg, args.slots, args.max_seq)}")
    print(f"  {sm90_decode_prediction(cfg, args.slots, args.max_seq)}")
    policy = StragglerPolicy(expected_step_s=0.05, factor=20.0)

    eng = ServeEngine(cfg, params, slots=args.slots, max_seq=args.max_seq,
                      straggler=policy, device=device)
    del params
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, args.prompt_len),
                    max_new=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)

    t0 = time.time()
    while eng.queue or any(eng.active):
        eng.step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0

    toks = sum(len(r.out) for r in reqs)
    if not all(len(r.out) == args.max_new for r in reqs):
        raise AssertionError(f"every request should get {args.max_new} tokens")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU"
    print(f"  generated {toks} tokens in {eng.steps} engine steps, "
          f"{dt:.2f}s wall ({toks/dt:.1f} tok/s on {where})")
    print(f"  straggler watchdog: {eng.straggler.slow_steps} slow steps")
    for r in reqs[:4]:
        print(f"  req {r.rid}: {r.out}")
    print("serve_e2e OK")
    return {"tokens": toks, "seconds": dt, "tokens_per_s": toks / dt, "steps": eng.steps}


if __name__ == "__main__":
    main()
