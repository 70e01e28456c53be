"""Serving launcher: continuous-batching engine over the decode step, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --full \\
        --requests 8 --slots 4 --prompt-len 512 --max-new 16 --max-seq 1024

``--reduced`` (the default) serves the tiny same-family config; ``--full`` (or
``--no-reduced``) serves the architecture at its published size. Dense, moe,
vlm, hybrid and ssm ``--arch`` values are served (a vlm on its tokens alone, as
the JAX launcher serves it; ``--arch zamba2-7b`` is the hybrid, ``rwkv6-7b``
the ssm). An encdec ``--arch`` (``whisper-large-v3``) raises the engine's
``NotImplementedError``: requests carry tokens alone, as in the JAX engine,
which cannot serve it either. ``--full`` must fit one card: ``zamba2-7b`` does
(5.63 B parameters, about 34 GB at the peak: the fp32 init plus the bf16 copy),
and so does ``rwkv6-7b`` (7.58 B, about 31.5 GB: its blocks stay fp32, so the
copy is the bf16 embeddings alone); at 40 layers ``dbrx-132b`` is 132 B parameters,
528 GB in fp32 before the bf16 copy, and CUDA's out-of-memory error says so;
``chip_smoke.py`` serves it at 2 layers. ``--device``
defaults to ``cuda`` and a missing card is an error; ``--device cpu`` runs the
plain PyTorch path. Before serving it prints the simulator's split-KV decode
prediction for the serving workload on the H800 preset, as the JAX launcher
does, and, where the JAX launcher prints its ``SimFA-TPU`` line, the
``SimFA-H100`` line: ``core/sm90``'s plan for the port's own bf16 decode kernel
(its split count, predicted µs and bound) beside the kernel's default split,
which the engine keeps. Its closing line gives, from the engine's request
stamps, the p50 and p95 of each request's admission wait, its time to first
token and its latency. The admission wait (``t_admit``) is when the host began
to enqueue the request's prefill, which can run ahead of the card; the first
token and the last (``t_first``, ``t_done``) are stamped after the decode
step's readback, which waits for the card.
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
from repro_torch.core.sm90.analytical import analyze_sm90
from repro_torch.core.sm90.autotune import autotune_decode
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


def sm90_decode_prediction(cfg, slots: int, max_seq: int) -> str:
    """SimFA-H100's plan for the bf16 decode kernel (``csrc/flash_decode_sm90.cu``)
    at ``slots`` rows of a full ``max_seq`` cache, beside the kernel's default."""
    w = AttnWorkload(name="decode", B=slots, L=1, S=max_seq,
                     H_kv=cfg.num_kv_heads or 4, G=cfg.q_group_size or 1,
                     D=cfg.head_dim)
    if w.D > 128 or w.G > 16:
        return (f"SimFA-H100 bf16 decode kernel: no plan (head_dim {w.D}, {w.G} query "
                "heads a KV head; the kernel takes <= 128 and <= 16)")
    plan = autotune_decode(w)
    rule = analyze_sm90(w, kernel="flash_decode")
    return (f"SimFA-H100 bf16 decode kernel plan: n_split {plan.n_split}, "
            f"{plan.predicted_us:.1f} us ({plan.bottleneck}-bound); the kernel's "
            f"default n_split {rule.n_split}: {rule.latency*1e6:.1f} us")


def stamp_quantiles(reqs, stamp: str, label: str) -> str:
    """The p50 and p95 over ``reqs`` of the engine's stamp ``stamp`` less
    its ``t_submit``, in ms, as text."""
    ms = [(getattr(r, stamp) - r.t_submit) * 1e3 for r in reqs]
    p50, p95 = np.percentile(ms, [50, 95])
    return f"{label} p50 {p50:.1f} ms, p95 {p95:.1f} ms"


def main(argv=None):
    args = build_parser().parse_args(argv)

    device = api.resolve_device(args.device)
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = api.init(cfg, args.seed, device=device)
    print(decode_prediction(cfg, args.slots, args.max_seq))
    print(sm90_decode_prediction(cfg, args.slots, args.max_seq))

    eng = ServeEngine(cfg, params, slots=args.slots, max_seq=args.max_seq,
                      straggler=StragglerPolicy(expected_step_s=0.5, factor=10),
                      device=device)
    del params
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, args.prompt_len),
                    max_new=args.max_new) for i in range(args.requests)]
    for req in reqs:
        eng.submit(req)
    t0 = time.time()
    while eng.queue or any(eng.active):
        eng.step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = args.requests * args.max_new
    print(f"served {args.requests} requests / {toks} tokens of {cfg.name} on "
          f"{device} in {eng.steps} steps, {dt:.2f}s; "
          f"{eng.straggler.slow_steps} straggler step(s); "
          f"{stamp_quantiles(reqs, 't_admit', 'admission wait (host)')}, "
          f"{stamp_quantiles(reqs, 't_first', 'time to first token')}, "
          f"{stamp_quantiles(reqs, 't_done', 'request latency')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
