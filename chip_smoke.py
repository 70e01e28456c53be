#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py                  # everything, as the acceptance run
    python3 chip_smoke.py --phases device,build,kernels   # a short first check

Phases, each printing one JSON line:
  device   the card (torch and nvidia-smi), torch / CUDA / nvcc versions
  build    first use of the kernels' build (one nvcc per source, in parallel)
  kernels  each hand-written kernel against its plain PyTorch version on the
           card over a grid of shapes (fp32 at 2e-5 through flash_fwd.cu and
           flash_decode.cu, bf16 at 2e-2 through flash_fwd_sm90.cu, also at
           every ring depth it is built with, and flash_decode_sm90.cu), and
           timed at the serving shapes and at a
           long context (the bf16 kernels also at zamba2-7b's shapes, head_dim
           112 and G = 1, and the bf16 forward at olmo-1b's training shape;
           both types at whisper-large-v3's: the encoder's non-causal
           1500 x 1500, the cross-attention's 64 x 1500, and a decode step's
           cross-attention at cache_len 1500, D 64, G = 1)
           beside its plain version, one library call (a
           yardstick only: the port never calls it) and its roofline bound.
           Kernel and library times are device times (kernel durations from
           torch.profiler); wrapper_ms is the host-clocked time of a call
           through the wrapper; a decode call must run one device kernel
  sim      the simulator's predictions for the bf16 kernels' timed shapes, one
           line each beside the kernels phase's device time (not timed again)
           and the card's SM clock: simulate_fa3 and analytical.analyze on the
           H800 preset (1.83 GHz) at the four shapes of the paper's own kernel
           models, and SimFA-H100 (core/sm90: fwd_trace / decode_trace on the
           engine, analyze_sm90) on the H100 preset at the clock read at
           timing, at each bf16 shape of PERF.md's kernel table: the forward
           at serving, 2048, train, zamba2, whisper's encoder and
           cross-attention, the decode at serving, 32k, zamba2 and whisper.
           The simulations run in worker processes on the host's cores while
           the plan phase times the card
  plan     (with sim) each of those shapes through the kernels' tiling
           parameters: every ring depth the bf16 forward is built with, and
           the bf16 decode at the split rule's n_split and at each n_split of
           autotune_decode's short-list; every candidate's output is held
           against the plain version at 2e-2 (a mismatch fails the run) and
           timed by device time. Each row gives the plan's pick and its
           predicted us, each candidate's ms, the measured best and whether
           the pick is it or within 5 %; then one line of readings: the H100
           preset's fields beside the card's, the mean absolute percentage
           error of sim and analytical against measured over the sim rows
  serve    qwen2.5-3b at full width and depth, bf16, random seeded weights:
           8 requests of 512 prompt tokens through ServeEngine (4 slots,
           16 new tokens each); asserts the kernels' launch counts
  path     the same engine at 4 layers, once through the kernels and once with
           mode="reference", from the same weights: first-step logits compared
  path_f32 the model in float32 at 2 layers: the engine's prefills go through
           the fp32 kernel (launch counts asserted), and first-step logits
           match mode="reference" at 1e-3
  moe      dbrx-132b at full width (48 query / 8 KV heads, G = 6; 16 experts
           top-4), its depth cut to 2 layers, bf16, random seeded weights:
           8 requests of 512 prompt tokens through ServeEngine (4 slots, 16 new
           tokens each); asserts both bf16 kernels' launch counts, prints the
           share of decode's (token, choice) pairs dropped at capacity; then one
           prompt through the kernels, through mode="reference" and through the
           plain route that rounds P to bf16 as the bf16 forward does: the
           chosen experts must agree with both (ROUTING_AGREEMENT), and the last
           prefill position's and first decode step's logits must lie within
           LOGITS_TOL of the bf16-P route's where that position's routing
           agreed in both layers (against fp32 P they are a reading: rounding P
           alone moves them as far, see moe_check)
  hybrid   zamba2-7b at full width and depth (81 layers: 3 Mamba2 layers, then
           13 groups of 5 Mamba2 layers each followed by the one shared
           attention block; 32 query / 32 KV heads, head_dim 112), bf16, random
           seeded weights: the serve phase's traffic through ServeEngine;
           asserts 8 x 13 forward and steps x 13 decode launches on the bf16
           kernels; peak memory and one profiled decode step. Checks: at 2
           groups, one prompt's last prefill and first decode logits within
           LOGITS_TOL of the plain route that rounds P to bf16 as the bf16
           forward does (against fp32 P, and at full depth, readings); one
           full-width Mamba2 layer's 512 tokens as one chunked call and as 512
           one-token calls: the final state within 1e-3, the outputs within 2e-2
  encdec   whisper-large-v3 at full width and depth (32 encoder + 32 decoder
           layers, d_model 1280, 20 / 20 heads, head_dim 64), bf16, random
           seeded weights: 4 sequences of 1500 stub frames and 64-token prompts
           through the serve steps' prefill, then 31 greedy decode steps (32 new
           tokens; ServeEngine refuses the family, as the reference's cannot
           serve it); asserts 96 forward launches a prefill (32 encoder
           non-causal 1500 x 1500, 32 decoder causal 64 x 64, 32 cross
           non-causal 64 x 1500) and 64 decode launches a step (32 self, 32
           cross at cache_len 1500), all bf16; peak memory, one profiled decode
           step. Check: at 4 + 4 layers, one sequence's last prefill and first
           decode logits within LOGITS_TOL of the plain route that rounds P to
           bf16 as the bf16 forward does (at full depth, a reading)
  ssm      rwkv6-7b at full width and depth (32 layers, d_model 4096), its
           blocks fp32, random seeded weights: the serve phase's traffic through
           ServeEngine; asserts no attention-kernel launch; peak memory, one
           profiled decode step beside its bound (the fp32 block weights' and
           the bf16 unembedding's bytes). Checks: at 2 layers, one decode step's
           logits within LOGITS_TOL of the full forward's; one full-width
           time_mix's 512 tokens as one chunked call and as 512 one-token calls:
           the final state within 1e-3, the outputs within 2e-3
  train    olmo-1b at full width and depth, bf16 compute on fp32 master weights:
           5 AdamW steps of batch 4 x 512 tokens (remat "full"); the attention
           gradients through the kernel route against mode="reference" at the
           training shape (bf16) and at one fp32 shape, step 1's loss and
           grad-norm against a step under mode="reference" from the same
           weights, every layer's wq/wk/wv gradients (none zero, each within
           WGRAD_TOL of a plain route that rounds P as the kernel does), 2 x 16
           forward-kernel launches a step (the forward and its recompute);
           step ms, tokens/s, model FLOP/s share, peak memory, and one more
           step under the profiler (with the forward kernel's row)
  parallel olmo-1b at full width and depth through the sharded trainer: a
           one-rank NCCL group on a local file store, launch/train.py's main
           with --dp 1 --tp 1 (its (data, model) mesh, parameters and AdamW
           moments as DTensors placed by the sharding rules, remat "full",
           batch 4 x 512, 3 steps, the bf16 forward kernel), and the same 3
           steps through the unsharded trainer from the same seed and
           batches: losses and global gradient norms within 1e-5 relative,
           the same forward-kernel launches a step (2 x 16) on both routes;
           step ms and peak memory of both; the card's total_memory against
           launch/specs.py's HBM_BUDGET. Then, in the same NCCL group, one
           run a family through trainer.make_train_step(..., mesh=) on a
           (1, 1) mesh at full width, bf16 compute, remat "full", 3 steps,
           beside the unsharded trainer from the same seed and batches:
           zamba2-7b with its depth cut to 1 + 2 x (2 Mamba2 layers + the
           shared attention block), B 2 x 512; rwkv6-7b cut to 4 layers, B 2
           x 512; whisper-large-v3 at full depth, B 2 x (1500 frames, 64
           tokens: the forward kernel under autograd, non-causal at 1500 x
           1500 and 64 x 1500). Each takes the partitioned route, its losses
           and gradient norms equal the unsharded trainer's bit for bit, and
           its forward-kernel launches a step are asserted on both routes
           (2 a use of an attention: the forward and its recompute); each
           prints its depth cut, route, losses, norms, step ms, the steps'
           peak and one more sharded step under the profiler
  cost     the eager cost counter (utils/cost.py) against the card: four steps
           at full width, each counted twice, once as it runs on the card and
           once on meta tensors of the same shapes (api.init(cfg,
           device="meta")): a qwen2.5-3b prefill of 512 tokens, a qwen2.5-3b
           decode step at 4 slots (cache_len 520), an olmo-1b training step at
           the train phase's batch, and one olmo-1b step through a (1, 1) mesh
           (the parallel phase's sharded trainer; its meta count on a "fake"
           group of one). Asserts the FLOPs and bytes of the two counts equal,
           the kernel records equal the launch counters' deltas, and each
           roofline bound max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s)
           (launch/roofline.py) at most BOUND_OVER_BUSY times the step's busy
           device time (the profiler's kernel durations, summed); prints per
           step the bound, busy and wall ms, bound / busy, the useful-FLOP
           share and the top 5 ops by bytes, and the host µs of the kernels'
           cost hook with no counter open (hook_us)
  profile  (only when named in --phases) one prefill and four decode steps of
           the full model under torch.profiler: wall time, device-busy time,
           idle share and the kernels that take most of the device time
Then one line {"kernels": [...]}, the card's name and power limit, and the last
line {"ok": true, "device": {...}}. Any failing phase ends the run non-zero.
Needs a CUDA device and nvcc; imports torch and the port only.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import tree                                  # noqa: E402
from repro_torch.configs import registry                      # noqa: E402
from repro_torch.configs.llama3 import AttnWorkload           # noqa: E402
from repro_torch.core import analytical                       # noqa: E402
from repro_torch.core.machine import H800                     # noqa: E402
from repro_torch.core.simfa import simulate_fa3               # noqa: E402
from repro_torch.core.sm90 import machine as sm90             # noqa: E402
from repro_torch.core.sm90.analytical import analyze_sm90     # noqa: E402
from repro_torch.core.sm90.autotune import (autotune_decode, autotune_flash,  # noqa: E402
                                            decode_candidates, flash_candidates)
from repro_torch.core.sm90.tracegen import simulate_sm90      # noqa: E402
from repro_torch.kernels import _build, ops                   # noqa: E402
from repro_torch.kernels import flash_attention as fa         # noqa: E402
from repro_torch.kernels import flash_decode as fd            # noqa: E402
from repro_torch.launch import roofline                       # noqa: E402
from repro_torch.launch import specs                          # noqa: E402
from repro_torch.launch import train as launch_train          # noqa: E402
from repro_torch.launch.mesh import make_mesh                 # noqa: E402
from repro_torch.models import api, mamba, moe, rwkv          # noqa: E402
from repro_torch.models.attention import knob_attention       # noqa: E402
from repro_torch.serve.decode import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine     # noqa: E402
from repro_torch.data.synthetic import DataIterator, token_batch  # noqa: E402
from repro_torch.train import optimizer as opt                # noqa: E402
from repro_torch.train import trainer                         # noqa: E402
from repro_torch.utils import cost                            # noqa: E402
from repro_torch.utils.cost import CostCounter                # noqa: E402

# published peaks of one H100 SXM (dense): operations per second by input type,
# and bytes per second of device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LOGITS_TOL = 5e-2     # bf16 model logits: two roundings to bf16 per layer drift apart
LOGITS_TOL_F32 = 1e-3  # fp32 model logits: the same arithmetic summed in another order
DEV = "cuda"

FWD_GRID = [  # B, H, Hkv, L, S, D
    (2, 4, 2, 128, 128, 64),
    (1, 8, 2, 256, 256, 128),
    (2, 4, 4, 100, 100, 64),       # ragged: not a multiple of the tile
    (1, 4, 1, 64, 384, 128),       # L != S (non-causal only)
    (1, 2, 2, 192, 192, 112),      # head_dim 112
    (1, 16, 2, 512, 512, 128),     # serving shape, G = 8
    (4, 20, 20, 64, 64, 64),       # whisper-large-v3's decoder prefill, G = 1
    (4, 20, 20, 64, 1500, 64),     # its cross-attention, L != S, S ragged
    (4, 20, 20, 1500, 1500, 64),   # its encoder (non-causal), ragged
]
FWD_EXTRA = [  # causal, both types: deep K/V rings, many diagonal tiles
    (1, 16, 2, 1024, 1024, 64),
    (2, 32, 8, 2048, 2048, 128),
    (1, 4, 2, 12, 12, 16),         # the launcher's default (reduced) width
    (1, 48, 8, 512, 512, 128),     # dbrx-132b's prefill, G = 6
    (1, 32, 32, 512, 512, 112),    # zamba2-7b's shared block's prefill, G = 1, D 112
]
FWD_STAGES = [  # bf16, both masks, at every ring depth the forward is built with
    (2, 4, 4, 100, 100, 64),       # ragged: not a multiple of the tile
    (1, 16, 2, 1024, 1024, 64),    # more K/V tiles than the deepest ring
    (1, 2, 2, 192, 192, 112),      # head_dim 112 in the 128-column template
    (1, 8, 2, 640, 640, 128),
]
FWD_ODD = [  # fp32 only, causal: the pairing of 32-row tiles in flash_fwd.cu
    (1, 4, 1, 80, 80, 112),        # 3 row tiles: the middle one alone, ragged rows
    (1, 2, 2, 288, 288, 64),       # 9 row tiles
    (2, 4, 2, 300, 300, 128),      # 10 row tiles, ragged rows
]
DECODE_GRID = [  # B, H, Hkv, S, D, clen
    (2, 8, 2, 512, 64, 300),
    (1, 16, 8, 1024, 128, 1024),
    (2, 4, 4, 256, 64, 1),
    (1, 6, 1, 640, 128, 77),       # G = 6, ragged length
    (4, 16, 2, 1024, 128, 512),    # serving shape, G = 8
    (4, 16, 2, 1024, 128, 528),
]
DECODE_EXTRA = [  # both types: the kernels' edges
    (2, 32, 2, 512, 128, 333),     # G = 16, the largest group
    (1, 8, 2, 384, 112, 200),      # head_dim 112
    (1, 4, 2, 64, 16, 13),         # the launcher's default (reduced) width
    (4, 16, 2, 1024, 128, 1),      # one cached row
    (1, 16, 2, 32768, 128, 32768), # the longest context of qwen2.5-3b
    (4, 48, 8, 1024, 128, 520),    # dbrx-132b's decode step, G = 6
    (4, 32, 32, 1024, 112, 520),   # zamba2-7b's decode step, G = 1, D 112
    (4, 20, 20, 128, 64, 80),      # whisper-large-v3's decoder self-attention step
    (4, 20, 20, 1500, 64, 1500),   # its cross-attention step: the full encoder rows
]
TRAIN = dict(arch="olmo-1b", batch=4, seq=512, steps=5)
TRAIN_GRAD_CASES = [  # (B, H, Hkv, L = S, D), dtype: causal attention gradients
    ((4, 16, 16, 512, 128), torch.bfloat16),   # olmo-1b's training shape
    ((2, 8, 2, 300, 128), torch.float32),      # fp32, G = 4, ragged rows
]
TRAIN_TOL = 1e-3       # step 1's loss and grad-norm, kernels against mode="reference", relative
PARALLEL = dict(arch="olmo-1b", batch=4, seq=512, steps=3, remat="full")
# the parallel phase's runs of the hybrid, ssm and encdec families at full width
# through the sharded step on a (1, 1) mesh: their depth cut (config fields)
# where the full depth's fp32 master, gradient and two moments (16 bytes a
# parameter) would not fit one card: zamba2-7b's 5.6 B parameters need ~90 GB,
# rwkv6-7b's 7.6 B ~122 GB; whisper-large-v3's 1.6 B (~26 GB) run at full depth
PARALLEL_FAMILIES = [
    dict(arch="zamba2-7b", batch=2, seq=512,
         cut=dict(hybrid_prologue=1, hybrid_groups=2, hybrid_mamba_per_group=2, num_layers=7)),
    dict(arch="rwkv6-7b", batch=2, seq=512, cut=dict(num_layers=4)),
    dict(arch="whisper-large-v3", batch=2, seq=64, cut={}),
]
PARALLEL_TOL = 1e-5    # sharded (1, 1) mesh against the unsharded trainer: losses, grad norms
WGRAD_TOL = 4e-2       # wq/wk/wv grads, kernels against the plain bf16-P route, relative in
                       # norm: twice the largest reading (1.92e-2, layer 0 wq)
MOE = dict(arch="dbrx-132b", layers=2, requests=8, prompt_len=512, slots=4, max_new=16,
           max_seq=1024)
ROUTING_AGREEMENT = 0.99   # share of the kernels' (token, layer, choice) experts a plain route
                           # chooses too
HYBRID = dict(arch="zamba2-7b", requests=8, prompt_len=512, slots=4, max_new=16,
              max_seq=1024, check_groups=2)
SSD_TOL = dict(state=1e-3, out=2e-2)   # the reference's own chunked-against-recurrent
                                       # tolerances (tests/test_models.py)
ENCDEC = dict(arch="whisper-large-v3", batch=4, prompt_len=64, new_tokens=32, max_seq=128,
              check_layers=4)
SSM = dict(arch="rwkv6-7b", requests=8, prompt_len=512, slots=4, max_new=16, max_seq=1024,
           check_layers=2)
WKV_TOL = dict(state=1e-3, out=2e-3)   # the reference's test_rwkv_chunked_matches_recurrent
SERVE_FWD = dict(B=1, H=16, Hkv=2, L=512, D=128)
LONG_FWD = (2, 32, 8, 2048, 128)   # B, H, Hkv, L = S, D
ZAMBA_FWD = (1, 32, 32, 512, 112)  # zamba2-7b's shared block's prefill
WHISPER_ENC = (4, 20, 20, 1500, 1500, 64)   # B, H, Hkv, L, S, D: the encoder, non-causal
WHISPER_CROSS = (4, 20, 20, 64, 1500, 64)   # the prefill's cross-attention, non-causal
SERVE_DEC = dict(B=4, H=16, Hkv=2, S_max=1024, D=128, clen=520, layers=36)
ZAMBA_DEC = dict(B=4, H=32, Hkv=32, S_max=1024, D=112, clen=520, layers=13)
WHISPER_DEC = dict(B=4, H=20, Hkv=20, S_max=1500, D=64, clen=1500, layers=32)  # cross
LONG_DEC = dict(B=4, H=16, Hkv=2, D=128, clen=32768)
COST = dict(arch="qwen2.5-3b", prompt_len=512, slots=4, clen=520, max_seq=1024)
BOUND_OVER_BUSY = 1.05  # a roofline bound above the card's own busy time means a count or a
                        # constant is wrong; 5 % for the profiler's own spread
PLAN_SHORTLIST = 3      # autotune_decode's candidates timed beside the split rule
PICK_WITHIN = 0.05      # a pick within 5 % of the measured best counts as agreeing


# profiler readings that stood on a window short of kernel records (see
# device_profile and kernel_ms): the call site that took each, the records the
# window held and the whole count it stood for; emit() adds those taken since
# its last line to the next line it prints, as "extrapolated"
EXTRAPOLATED = []


def emit(obj):
    if EXTRAPOLATED:
        obj = {**obj, "extrapolated": list(EXTRAPOLATED)}
        EXTRAPOLATED.clear()
    print(json.dumps(obj), flush=True)


def note_extrapolated(held, whole):
    """Records a reading taken from a window of ``held`` kernel records that
    stands for ``whole``, under the first caller outside the profiling helpers."""
    f = sys._getframe(1)
    while f.f_code.co_name in ("note_extrapolated", "device_profile", "device_ms", "kernel_ms"):
        f = f.f_back
    EXTRAPOLATED.append({"at": f"{f.f_code.co_name}:{f.f_lineno}", "records": held,
                         "of": whole, "lost": whole - held})


def sm_clock():
    """The card's SM clock and its maximum, now, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def randn(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(DEV).to(dtype)


def compare(got, want, dtype, what):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (got - want).abs()
    tol = TOL[dtype]
    bad = err > tol + tol * want.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements beyond atol=rtol={tol}, "
                             f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def time_ms(fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_rows(prof):
    """(ms, count, name) of each kernel in a profile, largest first."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:      # host-side op rows repeat their kernels' time
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return rows


def _profile_window(fn, iters):
    """(summed ms, kernel count, rows) of the device kernels of ``iters`` calls
    of ``fn``, traced after one untraced profiler step: a window opened cold
    has been seen to miss its first kernel record, every time, at one shape."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        prof.step()
    rows = [r for r in device_rows(prof) if not r[2].startswith("ProfilerStep")]
    return sum(r[0] for r in rows), sum(r[1] for r in rows), rows


def device_profile(fn, iters=20, warmup=3, attempts=8, calls=1):
    """Device time of one call of ``fn`` and the device kernels that each of the
    ``calls`` wrapper calls inside ``fn`` launches: the durations of the kernels
    of ``iters`` calls of ``fn`` (torch.profiler), summed, over ``iters``, and
    their count over ``iters * calls``. Gaps between kernels do not count, so
    the host's enqueue rate cannot hide the kernels' own time. The profiler has
    been seen to return a window with kernel records missing: a window whose
    kernel count is not a whole multiple of ``iters * calls`` is taken again,
    up to ``attempts`` windows (one run lost records in four windows in a row,
    holding 0 to 10 of 20; each incomplete window is logged to stderr). A
    record was seen lost in every window of a run (SDPA's fp32 kernel at
    whisper's shapes, 19 of 20): then the last window stands while it lacks at
    most a tenth of the next whole multiple, its mean kernel time taken for
    the lost ones, as ``kernel_ms`` takes it, and the reading is marked
    "extrapolated" on the next JSON line (``note_extrapolated``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    want = iters * calls
    for _ in range(attempts):
        busy, launched, rows = _profile_window(fn, iters)
        if launched and launched % want == 0:
            return busy / iters, launched // want
        print(f"profiler window: {launched} kernel records for {iters} x {calls} calls: "
              f"{[(n, name[:50]) for _, n, name in rows]}", file=sys.stderr, flush=True)
    whole = launched + (-launched % want)
    if launched and whole - launched <= 0.1 * whole:
        note_extrapolated(launched, whole)
        return busy / launched * whole / iters, whole // want
    raise AssertionError(f"the profiler recorded no whole window of {iters} x {calls} "
                         f"calls in {attempts} attempts; the last held {launched} kernels: "
                         f"{[(n, name[:60]) for _, n, name in rows]}")


def kernel_ms(fn, calls=1, iters=20, warmup=3, attempts=8):
    """Device time of one kernel of ``fn``, whose ``calls`` wrapper calls each
    launch one kernel: the summed durations of the profiled kernels over their
    count. A window may lose a kernel record (the <128, 3> forward lost one in
    every window of a run, with the simulations' worker processes busy); the
    mean over the records it holds stands while it holds 90 % of them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    want = iters * calls
    for _ in range(attempts):
        busy, launched, rows = _profile_window(fn, iters)
        if want * 0.9 <= launched <= want:
            if launched < want:
                note_extrapolated(launched, want)
            return busy / launched
        print(f"profiler window: {launched} of {want} kernel records", file=sys.stderr,
              flush=True)
    raise AssertionError(f"the profiler recorded {launched} of {want} kernels in each of "
                         f"{attempts} windows: {[(n, name[:60]) for _, n, name in rows]}")


def device_ms(fn, iters=20, warmup=3, attempts=8):
    """Device time of one call of ``fn`` (see ``device_profile``)."""
    return device_profile(fn, iters, warmup, attempts)[0]


def sdpa(q, k, v, causal):
    """One library call computing the same function; q (B,H,L,D), k/v (B,Hkv,S,D)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True)


# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-2:]
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": " | ".join(nvcc)})
    return smi


def phase_build(verbose):
    t0 = time.time()
    _build.build_all(verbose_ptxas=verbose)
    for name in _build.SOURCES:
        _build.load(name)
    emit({"phase": "build", "seconds": round(time.time() - t0, 2),
          "nvcc_seconds": round(_build.last_build_seconds, 2),
          "dir": str(_build.build_dir())})
    if verbose:
        print(_build.last_build_log, file=sys.stderr, flush=True)


def fwd_costs(B, H, Hkv, L, S, D, dtype, causal):
    pairs = L * (L + 1) // 2 if causal else L * S
    flops = 4 * B * H * D * pairs
    nbytes = (2 * B * H * L * D + 2 * B * Hkv * S * D) * dtype.itemsize
    return flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3


def dec_costs(B, H, Hkv, D, clen, dtype):
    flops = 4 * B * H * D * clen
    nbytes = (2 * B * Hkv * clen * D + 2 * B * H * D) * dtype.itemsize
    return flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3


def bound(ops_ms, bytes_ms):
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def fwd_grid_cases():
    """(shape, causal, dtype) of every forward case held against the plain version."""
    for shape in FWD_GRID:
        for causal in (True, False):
            if causal and shape[3] != shape[4]:
                continue
            for dtype in (torch.float32, torch.bfloat16):
                yield shape, causal, dtype
    for shape in FWD_EXTRA:
        for dtype in (torch.float32, torch.bfloat16):
            yield shape, True, dtype
    for shape in FWD_ODD:
        yield shape, True, torch.float32


def check_tma_refusal(rng):
    """A bf16 view TMA cannot address raises in both wrappers, and so does an fp32
    view the 16-byte copies of either fp32 kernel cannot address; none takes
    another kernel or moves a launch counter."""
    flat = randn(rng, (1 + 4 * 64 * 64,), torch.bfloat16)
    view = flat[1:].view(1, 4, 64, 64)               # base 2 bytes off a 16-byte boundary
    kv = randn(rng, (1, 2, 64, 64), torch.bfloat16)
    q = randn(rng, (1, 8, 64), torch.bfloat16)
    flat32 = randn(rng, (1 + 4 * 64 * 64,), torch.float32)
    view32 = flat32[1:].view(1, 4, 64, 64)           # base 4 bytes off a 16-byte boundary
    kv32 = randn(rng, (1, 2, 64, 64), torch.float32)
    q32 = randn(rng, (1, 8, 64), torch.float32)
    for name, mod, call in (
            ("flash_fwd bf16", fa, lambda: fa.flash_attention(view, kv, kv, causal=True)),
            ("flash_fwd fp32", fa, lambda: fa.flash_attention(view32, kv32, kv32, causal=True)),
            ("flash_decode bf16", fd, lambda: fd.flash_decode(q, view, view, 40)),
            ("flash_decode fp32", fd, lambda: fd.flash_decode(q32, view32, view32, 40))):
        before = (mod.launches, mod.launches_sm90, mod.launches_f32)
        try:
            call()
        except ValueError:
            pass
        else:
            raise AssertionError(f"{name}: a view the kernel cannot address did not raise")
        if (mod.launches, mod.launches_sm90, mod.launches_f32) != before:
            raise AssertionError(f"{name}: a refused call moved a launch counter")


def decode_grid_cases():
    """(shape, dtype) of every decode case held against the plain version."""
    for shape in DECODE_GRID:
        for dtype in (torch.float32, torch.bfloat16):
            yield shape, dtype
    for shape in DECODE_EXTRA:
        for dtype in (torch.float32, torch.bfloat16):
            yield shape, dtype


def time_decode(rng, dt, s=SERVE_DEC):
    """Times decode at shape ``s`` (the serving shape unless given), cycling over
    its layers' slices of one cache as a decode step does, so that each launch
    finds its K/V rows cold in L2; checks the first and last layer through ops
    (strided views) and the library call. Returns (timings, worst error)."""
    cache_k = randn(rng, (s["layers"], s["B"], s["S_max"], s["Hkv"], s["D"]), dt)
    cache_v = randn(rng, (s["layers"], s["B"], s["S_max"], s["Hkv"], s["D"]), dt)
    qd = randn(rng, (s["B"], 1, s["H"], s["D"]), dt)
    clen = s["clen"]
    worst = 0.0
    for layer in (0, s["layers"] - 1):
        got = ops.decode_forward(qd, cache_k[layer], cache_v[layer], clen)
        torch.cuda.synchronize()
        want = ops.decode_forward(qd, cache_k[layer], cache_v[layer], clen, mode="reference")
        worst = max(worst, compare(got, want, dt, f"flash_decode {dt} {s} via ops, "
                                                  f"layer {layer}"))
    qdt = qd.transpose(1, 2)
    compare(sdpa(qdt, cache_k[0, :, :clen].transpose(1, 2),
                 cache_v[0, :, :clen].transpose(1, 2), False).transpose(1, 2),
            ops.decode_forward(qd, cache_k[0], cache_v[0], clen, mode="reference"),
            dt, f"library yardstick (decode, {dt})")

    def sweep(fn):
        def run():
            for layer in range(s["layers"]):
                fn(layer)
        return run

    n = s["layers"]
    kernel = sweep(lambda i: ops.decode_forward(qd, cache_k[i], cache_v[i], clen))
    library = sweep(lambda i: sdpa(qdt, cache_k[i, :, :clen].transpose(1, 2),
                                   cache_v[i, :, :clen].transpose(1, 2), False))
    ms, per_call = device_profile(kernel, iters=5, warmup=1, calls=n)
    dec = dict(
        ms=ms / n,
        sm_clock=sm_clock(),
        device_kernels_per_call=per_call,
        wrapper_ms=time_ms(kernel, iters=10, warmup=2) / n,
        plain_ms=time_ms(sweep(lambda i: ops.decode_forward(
            qd, cache_k[i], cache_v[i], clen, mode="reference")), iters=5, warmup=1) / n,
        library_ms=device_ms(library, iters=5, warmup=1) / n,
        library_wrapper_ms=time_ms(library, iters=10, warmup=2) / n)
    if dec["device_kernels_per_call"] != 1:
        raise AssertionError(f"flash_decode {dt}: {dec['device_kernels_per_call']} device "
                             "kernels a call, not one")
    dec["bound_ms"], dec["bound_by"] = bound(*dec_costs(s["B"], s["H"], s["Hkv"], s["D"],
                                                        clen, dt))
    return dec, worst


def time_long_decode(rng, dt):
    """The decode kernel of ``dt`` at a 32k cache (K/V beyond L2: 134 MB in
    bf16, 268 MB in fp32): device time, its share of the memory rate, the
    library call. Returns (timings, error)."""
    s = LONG_DEC
    kc = randn(rng, (s["B"], s["clen"], s["Hkv"], s["D"]), dt)
    vc = randn(rng, (s["B"], s["clen"], s["Hkv"], s["D"]), dt)
    qd = randn(rng, (s["B"], 1, s["H"], s["D"]), dt)
    got = ops.decode_forward(qd, kc, vc, s["clen"])
    torch.cuda.synchronize()
    err = compare(got, ops.decode_forward(qd, kc, vc, s["clen"], mode="reference"), dt,
                  f"flash_decode {dt} long cache via ops")
    qdt, kt, vt = qd.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    ms = device_ms(lambda: ops.decode_forward(qd, kc, vc, s["clen"]))
    clock = sm_clock()
    bound_ms = bound(*dec_costs(s["B"], s["H"], s["Hkv"], s["D"], s["clen"], dt))[0]
    return dict(at="B{B} H{H} Hkv{Hkv} cache_len{clen} D{D} ".format(**s) + str(dt)[6:],
                ms=ms, sm_clock=clock, library_ms=device_ms(lambda: sdpa(qdt, kt, vt, False)),
                bound_ms=bound_ms, share_of_3_35_tb_s=bound_ms / ms), err


def time_fwd(rng, shape, dt, plain=False, S=None, causal=True):
    """The forward through ops at ``shape`` (B, H, Hkv, L, D) against ``S`` keys
    (L by default): device time beside the library call's and the bound; with
    ``plain`` also the wrapper's host time, and checked against and timed
    beside the plain version. Returns (timings, error)."""
    B, H, Hkv, L, D = shape
    S = S or L
    q = randn(rng, (B, L, H, D), dt)
    k = randn(rng, (B, S, Hkv, D), dt)
    v = randn(rng, (B, S, Hkv, D), dt)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lens = f"L=S={L}" if S == L else f"L={L} S={S}"
    out = dict(at=f"B{B} H{H} Hkv{Hkv} {lens} D{D} {'causal' if causal else 'non-causal'} "
                  f"{str(dt)[6:]}",
               ms=device_ms(lambda: ops.mha_forward(q, k, v, causal=causal)),
               sm_clock=sm_clock(),
               library_ms=device_ms(lambda: sdpa(qt, kt, vt, causal)))
    out["bound_ms"], out["bound_by"] = bound(*fwd_costs(B, H, Hkv, L, S, D, dt, causal))
    err = 0.0
    if plain:
        got = ops.mha_forward(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = ops.mha_forward(q, k, v, causal=causal, mode="reference")
        err = compare(got, want, dt, f"forward {out['at']} via ops")
        compare(sdpa(qt, kt, vt, causal).transpose(1, 2), want, dt,
                f"library yardstick (forward {out['at']})")
        out["wrapper_ms"] = time_ms(lambda: ops.mha_forward(q, k, v, causal=causal), iters=20)
        out["plain_ms"] = time_ms(lambda: ops.mha_forward(q, k, v, causal=causal,
                                                          mode="reference"), iters=10)
    return out, err


def phase_kernels():
    rng = np.random.default_rng(0)
    names = ("flash_fwd", "flash_fwd_f32", "flash_decode", "flash_decode_f32")
    worst = dict.fromkeys(names, 0.0)
    cases = dict.fromkeys(names, 0)
    worst_pv_bf16 = 0.0       # the bf16 kernel against the plain version that rounds P as it does

    # the grid, in the kernels' own layout (contiguous (B,H,L,D) / (B,Hkv,S,D))
    for (B, H, Hkv, L, S, D), causal, dtype in fwd_grid_cases():
        name = "flash_fwd" if dtype == torch.bfloat16 else "flash_fwd_f32"
        q = randn(rng, (B, H, L, D), dtype)
        k = randn(rng, (B, Hkv, S, D), dtype)
        v = randn(rng, (B, Hkv, S, D), dtype)
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        what = f"{name} {(B, H, Hkv, L, S, D)} causal={causal} {dtype}"
        worst[name] = max(worst[name], compare(got, want, dtype, what))
        cases[name] += 1
        if dtype == torch.bfloat16:
            err = (got.float() - fa.flash_attention_plain(q, k, v, causal=causal,
                                                          pv_bf16=True).float()).abs()
            worst_pv_bf16 = max(worst_pv_bf16, float(err.max()))
    for (B, H, Hkv, L, S, D) in FWD_STAGES:
        q = randn(rng, (B, H, L, D), torch.bfloat16)
        k = randn(rng, (B, Hkv, S, D), torch.bfloat16)
        v = randn(rng, (B, Hkv, S, D), torch.bfloat16)
        for causal in (True, False):
            want = fa.flash_attention_plain(q, k, v, causal=causal)
            for stages in fa.STAGES_SM90[fa.head_dim_template(D)]:
                got = fa.flash_attention(q, k, v, causal=causal, stages=stages)
                torch.cuda.synchronize()
                what = f"flash_fwd {(B, H, Hkv, L, S, D)} causal={causal} stages={stages}"
                worst["flash_fwd"] = max(worst["flash_fwd"],
                                         compare(got, want, torch.bfloat16, what))
                cases["flash_fwd"] += 1
    check_tma_refusal(rng)
    for (B, H, Hkv, S, D, clen), dtype in decode_grid_cases():
        name = "flash_decode" if dtype == torch.bfloat16 else "flash_decode_f32"
        q = randn(rng, (B, H, D), dtype)
        kc = randn(rng, (B, Hkv, S, D), dtype)
        vc = randn(rng, (B, Hkv, S, D), dtype)
        what = f"{name} {(B, H, Hkv, S, D, clen)} {dtype}"
        got = fd.flash_decode(q, kc, vc, clen)
        torch.cuda.synchronize()
        want = fd.flash_decode_plain(q, kc, vc, clen)
        err = compare(got, want, dtype, what)
        acc, m, l = fd.flash_decode(q, kc, vc, clen, return_partials=True)
        torch.cuda.synchronize()
        acc_w, m_w, l_w = fd.flash_decode_plain(q, kc, vc, clen, return_partials=True)
        # partials carry no rounding to the query type: fp32 tolerance on
        # the normalised result, for both input types
        err = max(err, compare(acc / l[..., None], acc_w / l_w[..., None],
                               torch.float32, what + " partials"))
        compare(m + torch.log(l), m_w + torch.log(l_w), torch.float32,
                what + " partials log-sum-exp")
        worst[name] = max(worst[name], err)
        cases[name] += 2
        del q, kc, vc, got, want, acc, m, l, acc_w, m_w, l_w

    # the serving shapes, in the model-side layout, through ops (strided views);
    # the fp32 kernel is timed at the same shape in fp32
    s = SERVE_FWD
    fwd = {}
    for dt in (torch.bfloat16, torch.float32):
        name = "flash_fwd" if dt == torch.bfloat16 else "flash_fwd_f32"
        q = randn(rng, (s["B"], s["L"], s["H"], s["D"]), dt)
        k = randn(rng, (s["B"], s["L"], s["Hkv"], s["D"]), dt)
        v = randn(rng, (s["B"], s["L"], s["Hkv"], s["D"]), dt)
        got = ops.mha_forward(q, k, v, causal=True)
        torch.cuda.synchronize()
        want = ops.mha_forward(q, k, v, causal=True, mode="reference")
        if not got.is_contiguous():
            raise AssertionError("mha_forward: the kernel's output should be contiguous (B,L,H,D)")
        worst[name] = max(worst[name], compare(got, want, dt, f"{name} serving shape via ops"))
        cases[name] += 1
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        compare(sdpa(qt, kt, vt, True).transpose(1, 2), want, dt,
                f"library yardstick (forward, {dt})")
        fwd[name] = dict(
            ms=device_ms(lambda: ops.mha_forward(q, k, v, causal=True)),
            sm_clock=sm_clock(),
            wrapper_ms=time_ms(lambda: ops.mha_forward(q, k, v, causal=True)),
            plain_ms=time_ms(lambda: ops.mha_forward(q, k, v, causal=True, mode="reference"),
                             iters=10),
            library_ms=device_ms(lambda: sdpa(qt, kt, vt, True)),
            library_wrapper_ms=time_ms(lambda: sdpa(qt, kt, vt, True)))
        fwd[name]["bound_ms"], fwd[name]["bound_by"] = bound(
            *fwd_costs(s["B"], s["H"], s["Hkv"], s["L"], s["L"], s["D"], dt, True))

    # both kernels at a long context as well (more K/V tiles than ring stages)
    for dt in (torch.bfloat16, torch.float32):
        name = "flash_fwd" if dt == torch.bfloat16 else "flash_fwd_f32"
        fwd[name]["long"] = time_fwd(rng, LONG_FWD, dt)[0]

    # the bf16 kernel at olmo-1b's training shape (the train phase's forward) and
    # at zamba2-7b's prefill (the hybrid phase's: G = 1, D 112 in 128-column tiles)
    bf16 = torch.bfloat16
    fwd["flash_fwd"]["train"] = time_fwd(rng, TRAIN_GRAD_CASES[0][0], bf16)[0]
    fwd["flash_fwd"]["zamba2"], err = time_fwd(rng, ZAMBA_FWD, bf16, plain=True)
    worst["flash_fwd"] = max(worst["flash_fwd"], err)
    cases["flash_fwd"] += 1
    # both kernels at whisper-large-v3's non-causal shapes (the encdec phase's
    # prefill): the encoder's L = S = 1500 and the cross-attention's L 64, S 1500
    for dt in (torch.bfloat16, torch.float32):
        name = "flash_fwd" if dt == torch.bfloat16 else "flash_fwd_f32"
        for key, (B, H, Hkv, L, S, D) in (("whisper_enc", WHISPER_ENC),
                                          ("whisper_cross", WHISPER_CROSS)):
            fwd[name][key], err = time_fwd(rng, (B, H, Hkv, L, D), dt, plain=True, S=S,
                                           causal=False)
            worst[name] = max(worst[name], err)
            cases[name] += 1

    # decode in both types at the serving shape and at a long cache
    dec = {}
    for dt in (torch.bfloat16, torch.float32):
        name = "flash_decode" if dt == torch.bfloat16 else "flash_decode_f32"
        dec[name], err = time_decode(rng, dt)
        dec[name]["long"], err_long = time_long_decode(rng, dt)
        worst[name] = max(worst[name], err, err_long)
        cases[name] += 3
    # the bf16 kernel at zamba2-7b's decode step (G = 1 in an 8-column MMA, D 112)
    z = ZAMBA_DEC
    dec["flash_decode"]["zamba2"], err = time_decode(rng, bf16, z)
    dec["flash_decode"]["zamba2"]["at"] = (
        "B{B} H{H} Hkv{Hkv} S_max{S_max} cache_len{clen} D{D} bf16, {layers} layers' "
        "slices, cold L2".format(**z))
    worst["flash_decode"] = max(worst["flash_decode"], err)
    cases["flash_decode"] += 2
    # both decode kernels at whisper-large-v3's cross-attention step: one token
    # against the 1500 encoder rows (G = 1, D 64), over the decoder's 32 layers
    w = WHISPER_DEC
    for dt in (torch.bfloat16, torch.float32):
        name = "flash_decode" if dt == torch.bfloat16 else "flash_decode_f32"
        dec[name]["whisper_cross"], err = time_decode(rng, dt, w)
        dec[name]["whisper_cross"]["at"] = (
            "B{B} H{H} Hkv{Hkv} S_max{S_max} cache_len{clen} D{D} ".format(**w)
            + f"{str(dt)[6:]}, {w['layers']} layers' slices, cold L2")
        worst[name] = max(worst[name], err)
        cases[name] += 2

    emit({"phase": "kernels", "cases": cases, "max_abs_err": worst,
          "flash_fwd_max_abs_err_vs_pv_bf16_plain": worst_pv_bf16,
          "tolerance": {"float32": TOL[torch.float32], "bfloat16": TOL[torch.bfloat16]}})
    serve_fwd = "B1 H16 Hkv2 L=S=512 D128 causal"
    serve_dec = "B{B} H{H} Hkv{Hkv} S_max{S_max} cache_len{clen} D{D}".format(**SERVE_DEC)
    return [
        {"name": "flash_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_fwd_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention.py:110",
         "launches": 0, "max_abs_err": worst["flash_fwd"], **fwd["flash_fwd"],
         "cases": cases["flash_fwd"], "timed_at": serve_fwd + " bf16"},
        {"name": "flash_fwd_f32", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:110",
         "launches": 0, "max_abs_err": worst["flash_fwd_f32"], **fwd["flash_fwd_f32"],
         "cases": cases["flash_fwd_f32"], "timed_at": serve_fwd + " float32"},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode_sm90.cu",
         "replaces": "src/repro/kernels/flash_decode.py:83",
         "launches": 0, "max_abs_err": worst["flash_decode"], **dec["flash_decode"],
         "cases": cases["flash_decode"], "timed_at": serve_dec + " bf16, cold L2"},
        {"name": "flash_decode_f32", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:83",
         "launches": 0, "max_abs_err": worst["flash_decode_f32"], **dec["flash_decode_f32"],
         "cases": cases["flash_decode_f32"], "timed_at": serve_dec + " float32, cold L2"},
    ]


def sim_shapes():
    """(kernels-line row, "serving" or "long", kernel program, workload) of each
    shape the sim phase predicts: the bf16 kernels' four timed shapes. A decode
    workload's S is the cache length the kernel was timed at."""
    s, (B, H, Hkv, L, D), d, dl = SERVE_FWD, LONG_FWD, SERVE_DEC, LONG_DEC
    return [
        ("flash_fwd", "serving", "fa3",
         AttnWorkload("prefill", B=s["B"], L=s["L"], S=s["L"], H_kv=s["Hkv"],
                      G=s["H"] // s["Hkv"], D=s["D"], causal=True)),
        ("flash_fwd", "long", "fa3",
         AttnWorkload("prefill_long", B=B, L=L, S=L, H_kv=Hkv, G=H // Hkv, D=D, causal=True)),
        ("flash_decode", "serving", "splitkv_decode",
         AttnWorkload("decode", B=d["B"], L=1, S=d["clen"], H_kv=d["Hkv"],
                      G=d["H"] // d["Hkv"], D=d["D"])),
        ("flash_decode", "long", "splitkv_decode",
         AttnWorkload("decode_long", B=dl["B"], L=1, S=dl["clen"], H_kv=dl["Hkv"],
                      G=dl["H"] // dl["Hkv"], D=dl["D"])),
    ]


def bf16_shapes():
    """(kernel, key of its timing in the kernels line, workload) of each bf16
    shape of PERF.md's kernel table. A decode workload's S is the cache length
    the kernel was timed at; a forward's causal flag is the timed call's."""
    s, d, dl, z, w = SERVE_FWD, SERVE_DEC, LONG_DEC, ZAMBA_DEC, WHISPER_DEC

    def fwd(name, B, H, Hkv, L, D, S=None, causal=True):
        return AttnWorkload(name, B=B, L=L, S=S or L, H_kv=Hkv, G=H // Hkv, D=D,
                            causal=causal)

    def dec(name, x):
        return AttnWorkload(name, B=x["B"], L=1, S=x["clen"], H_kv=x["Hkv"],
                            G=x["H"] // x["Hkv"], D=x["D"])

    eB, eH, eHkv, eL, eS, eD = WHISPER_ENC
    cB, cH, cHkv, cL, cS, cD = WHISPER_CROSS
    return [
        ("flash_fwd", None, fwd("prefill", s["B"], s["H"], s["Hkv"], s["L"], s["D"])),
        ("flash_fwd", "long", fwd("prefill_2048", *LONG_FWD)),
        ("flash_fwd", "train", fwd("train", *TRAIN_GRAD_CASES[0][0])),
        ("flash_fwd", "zamba2", fwd("zamba2_prefill", *ZAMBA_FWD)),
        ("flash_fwd", "whisper_enc", fwd("whisper_enc", eB, eH, eHkv, eL, eD, S=eS,
                                         causal=False)),
        ("flash_fwd", "whisper_cross", fwd("whisper_cross", cB, cH, cHkv, cL, cD, S=cS,
                                           causal=False)),
        ("flash_decode", None, dec("decode", d)),
        ("flash_decode", "long", dec("decode_32k", dl)),
        ("flash_decode", "zamba2", dec("zamba2_decode", z)),
        ("flash_decode", "whisper_cross", dec("whisper_cross_decode", w)),
    ]


# a decode shape's cache as the kernels phase timed it: its layers' slices of one cache
PLAN_DECODE = {"decode": SERVE_DEC, "zamba2_decode": ZAMBA_DEC,
               "whisper_cross_decode": WHISPER_DEC,
               "decode_32k": dict(LONG_DEC, S_max=LONG_DEC["clen"], layers=1)}
SIM_MAX_CTAS = {"decode_32k": 64}   # sampled (one wave: the sample reads as the full launch)


def clock_ghz(smi_clock):
    """The SM clock of an ``sm_clock()`` reading, in GHz."""
    return float(smi_clock.split()[0]) / 1000


def shape_text(w):
    return (f"B{w.B} H{w.H_kv * w.G} Hkv{w.H_kv} L{w.L} S{w.S} D{w.D}"
            + (" causal" if w.causal else ""))


def simulate_task(kind, w, machine, setting, max_ctas):
    """One simulation in a worker process: what a sim row prints of it."""
    t0 = time.perf_counter()
    if kind == "h800":
        res = simulate_fa3(w, H800, kernel=setting)
        out = dict(cycles=res.cycles, us=res.cycles / (H800.freq_ghz * 1e3),
                   deadlocked=res.deadlocked, aborted=res.aborted, fidelity=res.fidelity,
                   ctas=res.n_ctas_total)
    else:
        res = simulate_sm90(w, machine, kernel=kind, max_ctas=max_ctas, **setting)
        out = dict(cycles=res.cycles, us=res.us, deadlocked=res.deadlocked, aborted=False,
                   ctas=res.ctas, ctas_simulated=res.ctas_simulated,
                   sms_simulated=res.sms_simulated)
    out["host_seconds"] = time.perf_counter() - t0
    return out


def phase_sim(kernels, plan=False):
    """The simulator's prediction of each bf16 kernel's timed shape, beside the
    device time the kernels phase measured there: the four H800 rows of the
    paper's kernel models, then SimFA-H100's rows of the port's own kernels at
    their default settings. The simulations run in worker processes. With
    ``plan`` the plan phase times the card meanwhile, the workers simulate each
    of its candidates too, and its rows are printed after the sim rows with
    each candidate's simulated us. Fails when a simulation deadlocks, aborts
    or counts no cycle; the ratios are readings, not checks. Returns the
    SimFA-H100 rows and the plan rows."""
    if not kernels:
        raise SystemExit("the sim phase reads the kernels phase's times: run both")
    rows = {k["name"]: k for k in kernels}

    def timing(name, key):
        return rows[name] if key is None else rows[name][key]

    h800 = sim_shapes()
    h100 = []
    for kernel, key, w in bf16_shapes():
        clock = timing(kernel, key)["sm_clock"]
        m = sm90.h100_sxm(clock_ghz(clock))
        h100.append((kernel, key, w, clock, m, analyze_sm90(w, m, kernel=kernel)))
    ctx = multiprocessing.get_context("spawn")
    workers = max(1, (os.cpu_count() or 2) - 1)
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        def sim(kernel, w, m, setting):
            return pool.submit(simulate_task, kernel, w, m, setting, SIM_MAX_CTAS.get(w.name))

        h800_jobs = [pool.submit(simulate_task, "h800", w, None, program, None)
                     for _, _, program, w in h800]
        h100_jobs = [sim(kernel, w, m, dict(stages=rep.stages, n_split=rep.n_split))
                     for kernel, _, w, _, m, rep in h100]
        cand_jobs = {}
        if plan:
            for kernel, _, w, _, m, _ in h100:
                knob, _, settings = plan_settings(kernel, w, m)
                for value in settings:
                    cand_jobs[w.name, value] = sim(kernel, w, m, {knob: value})
        plan_rows = phase_plan([m for *_, m, _ in h100]) if plan else []
        for (name, which, program, w), job in zip(h800, h800_jobs):
            res = job.result()
            if res["deadlocked"] or res["aborted"] or not res["cycles"] > 0:
                raise AssertionError(f"sim {w.name}: {res}")
            t = timing(name, None if which == "serving" else "long")
            ana = analytical.analyze(w, H800, kernel=program)
            measured_us = t["ms"] * 1e3
            emit({"phase": "sim", "kernel": name, "program": program, "workload": w.name,
                  "shape": shape_text(w), "preset": H800.name, "freq_ghz": H800.freq_ghz,
                  "sim_cycles": res["cycles"], "sim_us": res["us"],
                  "analytical_us": ana.latency * 1e6, "analytical_bound": ana.bottleneck,
                  "measured_us": measured_us, "sim_over_measured": res["us"] / measured_us,
                  "fidelity": res["fidelity"], "ctas": res["ctas"],
                  "host_seconds": res["host_seconds"], "sm_clock_at_timing": t["sm_clock"],
                  "sm_clock_now": sm_clock()})
        sim_rows = []
        for (kernel, key, w, clock, m, rep), job in zip(h100, h100_jobs):
            res = sim_result(job, f"SimFA-H100 {kernel} {w.name}")
            measured_us = timing(kernel, key)["ms"] * 1e3
            row = {"phase": "sim", "kernel": kernel,
                   "program": "fwd_trace" if kernel == "flash_fwd" else "decode_trace",
                   "workload": w.name, "shape": shape_text(w), "preset": "H100-SXM",
                   "freq_ghz": m.freq_ghz, "setting": (
                       {"stages": rep.stages} if kernel == "flash_fwd"
                       else {"n_split": rep.n_split}),
                   "sim_cycles": res["cycles"], "sim_us": res["us"],
                   "analytical_us": rep.latency * 1e6, "analytical_bound": rep.bottleneck,
                   "measured_us": measured_us, "sim_over_measured": res["us"] / measured_us,
                   "analytical_over_measured": rep.latency * 1e6 / measured_us,
                   "ctas": res["ctas"], "ctas_simulated": res["ctas_simulated"],
                   "sms_simulated": res["sms_simulated"], "host_seconds": res["host_seconds"],
                   "sm_clock_at_timing": clock}
            emit(row)
            sim_rows.append(row)
        for row in plan_rows:
            knob = row["knob"]
            for c in row["candidates"]:
                c["sim_us"] = sim_result(cand_jobs[row["workload"], c[knob]],
                                         f"plan {row['workload']} {knob} {c[knob]}")["us"]
            row["sim_pick"] = min(row["candidates"], key=lambda c: c["sim_us"])[knob]
            emit(row)
    return sim_rows, plan_rows


def sim_result(job, what):
    res = job.result()
    if res["deadlocked"] or not res["cycles"] > 0:
        raise AssertionError(f"{what}: {res}")
    return res


def machine_check():
    """The H100 preset's fields beside the card's own readings (a reading)."""
    props = torch.cuda.get_device_properties(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm,"
                          "clocks.max.mem", "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    card = {k: getattr(props, k, None) for k in (
        "multi_processor_count", "L2_cache_size", "shared_memory_per_block_optin",
        "shared_memory_per_multiprocessor", "regs_per_multiprocessor",
        "max_threads_per_multi_processor", "memory_clock_rate", "memory_bus_width",
        "total_memory")}
    bw = None
    if card["memory_clock_rate"] and card["memory_bus_width"]:
        # kHz, double data rate, bits -> bytes a second
        bw = 2 * card["memory_clock_rate"] * 1e3 * card["memory_bus_width"] / 8
    m = sm90.H100_SXM
    preset = {"num_sms": m.num_sms, "l2_bytes": m.l2_bytes, "dram_bw_gbps": m.dram_bw_gbps,
              "peak_tflops_fp16": m.peak_tflops_fp16, "smem_per_block": sm90.SMEM_PER_BLOCK,
              "smem_per_sm": sm90.SMEM_PER_SM, "regs_per_sm": sm90.REGS_PER_SM,
              "threads_per_sm": sm90.THREADS_PER_SM}
    pairs = {"num_sms": card["multi_processor_count"], "l2_bytes": card["L2_cache_size"],
             "smem_per_block": card["shared_memory_per_block_optin"],
             "smem_per_sm": card["shared_memory_per_multiprocessor"],
             "regs_per_sm": card["regs_per_multiprocessor"],
             "threads_per_sm": card["max_threads_per_multi_processor"],
             "dram_bw_gbps": bw and bw / 1e9}
    return {"preset": preset, "card": card, "nvidia_smi": smi,
            "matches": {k: (v == preset[k] if k != "dram_bw_gbps" else
                            abs(v - preset[k]) / preset[k] < 0.01)
                        for k, v in pairs.items() if v is not None}}


def plan_settings(kernel, w, m):
    """(knob, the plan's pick, the settings the plan phase times) at ``w``: every
    ring depth the bf16 forward is built with, or the decode's split rule and
    autotune_decode's short-list."""
    if kernel == "flash_fwd":
        pick = autotune_flash(w, m, causal=w.causal).stages
        return "stages", pick, sorted(c.stages for c in flash_candidates(w, m, causal=w.causal))
    pick = autotune_decode(w, m).n_split
    short = {c.n_split for c in decode_candidates(w, m)[:PLAN_SHORTLIST]}
    return "n_split", pick, sorted(short | {fd.num_splits_sm90(w.S, w.B * w.H_kv)})


def plan_forward(rng, w, m):
    """The bf16 forward at each of ``plan_settings``, each held to the plain
    version and timed."""
    q = randn(rng, (w.B, w.L, w.H_kv * w.G, w.D), torch.bfloat16)
    k = randn(rng, (w.B, w.S, w.H_kv, w.D), torch.bfloat16)
    v = randn(rng, (w.B, w.S, w.H_kv, w.D), torch.bfloat16)
    want = ops.mha_forward(q, k, v, causal=w.causal, mode="reference")
    _, pick, settings = plan_settings("flash_fwd", w, m)
    timed = []
    for stages in settings:
        def call(st=stages):
            return ops.mha_forward(q, k, v, causal=w.causal, stages=st)
        got = call()
        torch.cuda.synchronize()
        err = compare(got, want, torch.bfloat16, f"plan {w.name} stages {stages}")
        rep = analyze_sm90(w, m, kernel="flash_fwd", stages=stages)
        timed.append(dict(stages=stages, predicted_us=rep.latency * 1e6, ms=kernel_ms(call),
                          max_abs_err=err))
    return plan_row(w, "stages", pick, sm90.FWD.default_stages(w.D), timed)


def plan_decode(rng, w, m):
    """The bf16 decode at each of ``plan_settings``, over the cache the kernels
    phase timed (its layers' slices, cold in L2), each held to the plain
    version and timed."""
    s = PLAN_DECODE[w.name]
    ck = randn(rng, (s["layers"], s["B"], s["S_max"], s["Hkv"], s["D"]), torch.bfloat16)
    cv = randn(rng, (s["layers"], s["B"], s["S_max"], s["Hkv"], s["D"]), torch.bfloat16)
    qd = randn(rng, (s["B"], 1, s["H"], s["D"]), torch.bfloat16)
    clen, n = s["clen"], s["layers"]
    want = ops.decode_forward(qd, ck[0], cv[0], clen, mode="reference")
    _, pick, settings = plan_settings("flash_decode", w, m)
    timed = []
    for split in settings:
        got = ops.decode_forward(qd, ck[0], cv[0], clen, n_split=split)
        torch.cuda.synchronize()
        err = compare(got, want, torch.bfloat16, f"plan {w.name} n_split {split}")

        def sweep(split=split):
            for i in range(n):
                ops.decode_forward(qd, ck[i], cv[i], clen, n_split=split)
        rep = analyze_sm90(w, m, kernel="flash_decode", n_split=split)
        # a window of at least 20 kernels, so that one lost record stays within
        # kernel_ms's 90 % (decode_32k sweeps one layer a call)
        iters = max(5, -(-20 // n))
        timed.append(dict(n_split=split, predicted_us=rep.latency * 1e6,
                          ms=kernel_ms(sweep, calls=n, iters=iters, warmup=1),
                          max_abs_err=err))
    return plan_row(w, "n_split", pick, fd.num_splits_sm90(clen, s["B"] * s["Hkv"]), timed)


def plan_row(w, knob, pick, default, timed):
    ms = {t[knob]: t["ms"] for t in timed}
    best = min(ms, key=ms.get)
    return {"phase": "plan", "kernel": "flash_fwd" if knob == "stages" else "flash_decode",
            "workload": w.name, "shape": shape_text(w), "knob": knob, "pick": pick,
            "pick_predicted_us": next(t["predicted_us"] for t in timed if t[knob] == pick),
            "pick_ms": ms[pick], "default": default, "default_ms": ms[default],
            "candidates": timed, "measured_best": best, "best_ms": ms[best],
            "pick_is_best": pick == best,
            "pick_within_5pct": ms[pick] <= (1 + PICK_WITHIN) * ms[best],
            "sm_clock": sm_clock()}


def phase_plan(machines=None):
    """Each bf16 shape through its kernel's tiling parameter (see the module's
    docstring), on the H100 preset of ``machines`` (one a shape; by default at
    the SM clock read now). Returns the rows; the caller prints them."""
    rng = np.random.default_rng(22)
    shapes = bf16_shapes()
    machines = machines or [sm90.h100_sxm(clock_ghz(sm_clock()))] * len(shapes)
    return [(plan_forward if kernel == "flash_fwd" else plan_decode)(rng, w, m)
            for (kernel, _, w), m in zip(shapes, machines)]


def plan_readings(sim_rows, plan_rows, seconds):
    """One line of readings (no check): the preset against the card, the mean
    absolute percentage error of SimFA-H100's sim and analytical predictions
    against the measured device time over the sim rows, and how often the
    plan's pick was the measured best."""
    def mape(pairs):
        pairs = list(pairs)
        return sum(abs(p - t) / t for p, t in pairs) / len(pairs) if pairs else None
    emit({"phase": "plan", "reading": True, "machine": machine_check(),
          "rows": len(sim_rows),
          "sim_mape": mape((r["sim_us"], r["measured_us"]) for r in sim_rows),
          "analytical_mape": mape((r["analytical_us"], r["measured_us"]) for r in sim_rows),
          "plan_candidates_analytical_mape": mape(
              (c["predicted_us"], c["ms"] * 1e3) for r in plan_rows for c in r["candidates"]),
          "picks_best": sum(r["pick_is_best"] for r in plan_rows),
          "picks_within_5pct": sum(r["pick_within_5pct"] for r in plan_rows),
          "plan_rows": len(plan_rows), "sim_and_plan_seconds": seconds})


def reset_counts():
    fa.launches = fa.launches_sm90 = fa.launches_f32 = 0
    fd.launches = fd.launches_sm90 = fd.launches_f32 = 0


def read_counts():
    return {"flash_fwd": fa.launches_sm90, "flash_fwd_f32": fa.launches_f32,
            "flash_decode": fd.launches_sm90, "flash_decode_f32": fd.launches_f32}


def make_requests(cfg, n, prompt_len, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, prompt_len),
                    max_new=max_new) for i in range(n)]


def drive(eng, reqs):
    """Runs the engine to the end; returns (prefill ms per request, decode ms per step)."""
    prefill_ms, decode_ms = [], []
    inner = eng._prefill_slot

    def timed_prefill(slot, req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(slot, req)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)

    # the wrapper holds a bound method of the engine: removed again at the end,
    # or the engine, its weights and cache would live on in a reference cycle
    # until the garbage collector runs
    eng._prefill_slot = timed_prefill
    try:
        for r in reqs:
            eng.submit(r)
        while eng.queue or any(eng.active):
            before = sum(prefill_ms)
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t0) * 1e3 - (sum(prefill_ms) - before))
    finally:
        del eng._prefill_slot
    return prefill_ms, decode_ms


def phase_serve(kernels):
    cfg = registry.get("qwen2.5-3b")
    n_req, prompt_len, slots, max_new, max_seq = 8, 512, 4, 16, 1024
    t0 = time.time()
    params = api.init(cfg, 0, device=DEV)
    eng = ServeEngine(cfg, params, slots=slots, max_seq=max_seq, device=DEV)
    del params
    torch.cuda.synchronize()
    init_s = time.time() - t0
    reqs = make_requests(cfg, n_req, prompt_len, max_new)

    reset_counts()
    t0 = time.time()
    prefill_ms, decode_ms = drive(eng, reqs)
    wall = time.time() - t0
    counts = read_counts()

    L = cfg.num_layers
    if counts["flash_fwd"] != n_req * L or fa.launches != counts["flash_fwd"]:
        raise AssertionError(f"forward launches {counts['flash_fwd']} on the sm90 route "
                             f"({fa.launches} in all) != {n_req} x {L}")
    if (counts["flash_decode"] != eng.steps * L or eng.steps == 0
            or fd.launches != counts["flash_decode"]):
        raise AssertionError(f"decode launches {counts['flash_decode']} on the sm90 route "
                             f"({fd.launches} in all) != {eng.steps} x {L}")
    for r in reqs:
        if len(r.out) != max_new or not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"request {r.rid}: bad output {r.out}")
    for kern in kernels:
        if kern["name"] in ("flash_fwd", "flash_decode"):
            kern["launches"] = counts[kern["name"]]
    emit({"phase": "serve", "model": cfg.name, "layers": L, "d_model": cfg.d_model,
          "compute_dtype": cfg.compute_dtype, "requests": n_req, "prompt_len": prompt_len,
          "slots": slots, "max_new": max_new, "max_seq": max_seq,
          "init_seconds": round(init_s, 2), "decode_steps": eng.steps, "launches": counts,
          "prefill_ms_per_request": prefill_ms, "decode_ms_per_step_median":
          float(np.median(decode_ms)), "decode_ms_per_step_first": decode_ms[0],
          "tokens_per_s": n_req * max_new / wall, "wall_seconds": wall,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "sample_tokens": reqs[0].out})
    del eng
    torch.cuda.empty_cache()


def phase_path():
    cfg = dataclasses.replace(registry.get("qwen2.5-3b"), num_layers=4)
    params = api.cast_params(cfg, api.init(cfg, 1, device=DEV))
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 512))).to(DEV)
    logits = {}
    with torch.no_grad():
        for mode in (None, "reference"):
            hidden, cache = api.prefill(cfg, params, {"tokens": toks}, max_seq=1024, mode=mode)
            first, _ = api.decode(cfg, params, cache, toks[:, -1:], mode=mode)
            logits[mode] = (api.unembed(cfg, params, hidden[:, -1:]).float(), first.float())
    errs = []
    for got, want in zip(logits[None], logits["reference"]):
        if got.shape != (1, 1, cfg.vocab_size) or not torch.isfinite(got).all():
            raise AssertionError(f"path check: logits shape {tuple(got.shape)} or values are off")
        err = (got - want).abs()
        if (err > LOGITS_TOL + LOGITS_TOL * want.abs()).any():
            raise AssertionError(f"path check: logits differ, max abs err {float(err.max()):.3e}")
        errs.append(float(err.max()))

    outs = {}
    for mode in (None, "reference"):
        eng = ServeEngine(cfg, params, slots=4, max_seq=1024, device=DEV, mode=mode)
        reqs = make_requests(cfg, 4, 512, 16, seed=2)
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs[mode] = [t for r in reqs for t in r.out]
    same = sum(a == b for a, b in zip(outs[None], outs["reference"]))
    emit({"phase": "path", "layers": cfg.num_layers, "logits_tolerance": LOGITS_TOL,
          "prefill_logits_max_abs_err": errs[0], "decode_logits_max_abs_err": errs[1],
          "greedy_tokens_equal_share": same / len(outs[None]), "tokens": len(outs[None])})


def phase_path_f32(kernels):
    """The model in float32: its prefills take the fp32 kernel, its logits match the plain path."""
    cfg = dataclasses.replace(registry.get("qwen2.5-3b"), num_layers=2, compute_dtype="float32")
    params = api.cast_params(cfg, api.init(cfg, 3, device=DEV))
    n_req, prompt_len, max_new = 2, 256, 4
    eng = ServeEngine(cfg, params, slots=2, max_seq=512, device=DEV)
    reqs = make_requests(cfg, n_req, prompt_len, max_new, seed=3)
    reset_counts()
    for r in reqs:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    counts = read_counts()
    L = cfg.num_layers
    if counts["flash_fwd_f32"] != n_req * L or counts["flash_fwd"] != 0:
        raise AssertionError(f"fp32 forward launches {counts} != {n_req} x {L} on the fp32 route")
    if (counts["flash_decode_f32"] != eng.steps * L or eng.steps == 0
            or counts["flash_decode"] != 0):
        raise AssertionError(f"fp32 decode launches {counts} != {eng.steps} x {L} "
                             "on the fp32 route")
    for kern in kernels:
        if kern["name"] in ("flash_fwd_f32", "flash_decode_f32"):
            kern["launches"] = counts[kern["name"]]
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 256))).to(DEV)
    logits = {}
    with torch.no_grad():
        for mode in (None, "reference"):
            hidden, _ = api.prefill(cfg, params, {"tokens": toks}, max_seq=512, mode=mode)
            logits[mode] = api.unembed(cfg, params, hidden[:, -1:]).float()
    got, want = logits[None], logits["reference"]
    err = (got - want).abs()
    if not torch.isfinite(got).all() or (err > LOGITS_TOL_F32 + LOGITS_TOL_F32 * want.abs()).any():
        raise AssertionError(f"fp32 path check: logits differ, max abs err {float(err.max()):.3e}")
    emit({"phase": "path_f32", "layers": L, "launches": counts, "decode_steps": eng.steps,
          "logits_tolerance": LOGITS_TOL_F32, "prefill_logits_max_abs_err": float(err.max())})


@contextlib.contextmanager
def recorded_routes():
    """The experts ``moe._route`` chooses while the block runs: one (T, k) index
    tensor a call, in call order (a layer's prefill or decode step)."""
    seen, route = [], moe._route

    def recording(p, x2d, cfg):
        out = route(p, x2d, cfg)
        seen.append(out[1])
        return out

    moe._route = recording
    try:
        yield seen
    finally:
        moe._route = route


def dropped(idx, cfg, group):
    """Which (token, choice) pairs of ``idx`` (T, k) find their expert's queue
    full in the einsum dispatch, tokens taken in groups of ``group``."""
    k, E = cfg.experts_per_token, cfg.num_experts
    cap = max(1, int(group * k / E * cfg.capacity_factor))
    flat = idx.reshape(-1, group * k)
    pos = torch.cumsum(torch.nn.functional.one_hot(flat, E), dim=1) - 1
    return (pos.gather(2, flat[..., None]) >= cap).reshape(idx.shape)


def logits_of(cfg, params, toks, max_seq, mode=None, attn_fn=None):
    """One prompt's prefill and first decode step through one attention route:
    (last prefill position's logits, first decode step's logits)."""
    with torch.no_grad():
        hidden, cache = api.prefill(cfg, params, {"tokens": toks}, max_seq=max_seq, mode=mode,
                                    attn_fn=attn_fn)
        first, _ = api.decode(cfg, params, cache, toks[:, -1:], mode=mode)
        return api.unembed(cfg, params, hidden[:, -1:]).float(), first.float()


def moe_route(cfg, params, toks, max_seq, mode=None, attn_fn=None):
    """One prompt's prefill and first decode step through one attention route:
    (last prefill position's logits, first decode step's logits), and the
    experts each layer chose in the prefill and in the decode step."""
    with recorded_routes() as seen:
        logits = logits_of(cfg, params, toks, max_seq, mode, attn_fn)
    L = cfg.num_layers
    if len(seen) != 2 * L:
        raise AssertionError(f"moe check: {len(seen)} routings, want {2 * L}")
    return logits, seen[:L], seen[L:]


def compare_routes(cfg, ours, ref, prompt_len):
    """The share of (token, layer, choice) experts of ``ours`` that ``ref`` chose
    too, and each logits vector's max abs error and its worst ratio to
    LOGITS_TOL where that position's routing (chosen and kept experts) agreed
    in every layer (None where it did not)."""
    (lg, pre, dec), (lg_ref, pre_ref, dec_ref) = ours, ref
    a, b = torch.cat(pre + dec), torch.cat(pre_ref + dec_ref)
    out = {"routing_agreement": float((a[:, :, None] == b[:, None, :]).any(-1).float().mean())}

    def routing(idx, group):
        """(chosen, kept) expert sets of the last token of ``idx``."""
        chosen, drop = idx[-1].tolist(), dropped(idx, cfg, group)[-1].tolist()
        return set(chosen), {e for e, d in zip(chosen, drop) if not d}

    for what, j, x, y, group in (("prefill_last", 0, pre, pre_ref, prompt_len),
                                 ("decode_first", 1, dec, dec_ref, 1)):
        got, want = lg[j], lg_ref[j]
        if got.shape != (1, 1, cfg.vocab_size) or not torch.isfinite(got).all():
            raise AssertionError(f"moe check {what}: logits shape {tuple(got.shape)} "
                                 "or values are off")
        if any(routing(u, group) != routing(v, group) for u, v in zip(x, y)):
            out[what] = None
            continue
        err = (got - want).abs()
        out[what] = {"max_abs_err": float(err.max()),
                     "worst_ratio_to_tol": float((err / (LOGITS_TOL + LOGITS_TOL * want.abs()))
                                                 .max())}
    return out


def moe_check(cfg, params, prompt_len, max_seq):
    """One prompt through the kernels, through mode="reference" (fp32 P) and through
    the plain route that rounds P to bf16 over 128-key tiles as the bf16 forward
    kernel does. Routing agreement with both plain routes must reach
    ROUTING_AGREEMENT; the logits must lie within LOGITS_TOL of the bf16-P route's
    where that position's routing agreed. Against fp32 P the logits are a reading
    beside the witness: the two plain routes against each other, which differ by
    rounding P alone."""
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, prompt_len))).to(DEV)
    bf16_p = knob_attention(fa.DEFAULT_BLOCK_K, True, device=DEV, dtype=torch.bfloat16,
                            mode="reference")
    kernel = moe_route(cfg, params, toks, max_seq)
    plain = moe_route(cfg, params, toks, max_seq, mode="reference")
    plain_bf16_p = moe_route(cfg, params, toks, max_seq, mode="reference", attn_fn=bf16_p)
    result = {"routing_agreement_min": ROUTING_AGREEMENT, "logits_tolerance": LOGITS_TOL,
              "kernel_vs_plain_bf16_p": compare_routes(cfg, kernel, plain_bf16_p, prompt_len),
              "kernel_vs_plain_fp32_p": compare_routes(cfg, kernel, plain, prompt_len),
              "plain_bf16_p_vs_plain_fp32_p": compare_routes(cfg, plain_bf16_p, plain,
                                                             prompt_len)}
    for pair in ("kernel_vs_plain_bf16_p", "kernel_vs_plain_fp32_p"):
        if result[pair]["routing_agreement"] < ROUTING_AGREEMENT:
            raise AssertionError(f"moe check {pair}: routing agreement "
                                 f"{result[pair]['routing_agreement']:.4f} < "
                                 f"{ROUTING_AGREEMENT}; {result}")
    held = result["kernel_vs_plain_bf16_p"]
    for what in ("prefill_last", "decode_first"):
        if held[what] is None:
            print(f"moe check {what}: the routing of its position differs from the bf16-P "
                  "route's; its logits are not compared", flush=True)
        elif held[what]["worst_ratio_to_tol"] > 1:
            raise AssertionError(f"moe check {what}: logits beyond LOGITS_TOL of the plain "
                                 f"bf16-P route; {result}")
    return result


def phase_moe(kernels):
    """Full-width dbrx-132b, its depth cut to 2 layers, served through both bf16
    kernels at G = 6 (see the module docstring)."""
    m = MOE
    base = registry.get(m["arch"])
    cfg = dataclasses.replace(base, num_layers=m["layers"])
    n_req, prompt_len, slots, max_new, max_seq = (m[k] for k in (
        "requests", "prompt_len", "slots", "max_new", "max_seq"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = api.init(cfg, 0, device=DEV)
    eng = ServeEngine(cfg, params, slots=slots, max_seq=max_seq, device=DEV)
    del params
    torch.cuda.synchronize()
    init_s = time.time() - t0
    reqs = make_requests(cfg, n_req, prompt_len, max_new, seed=5)

    reset_counts()
    with recorded_routes() as routes:
        t0 = time.time()
        prefill_ms, decode_ms = drive(eng, reqs)
        wall = time.time() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    L = cfg.num_layers
    if (counts["flash_fwd"] != n_req * L or fa.launches != counts["flash_fwd"]
            or counts["flash_decode"] != eng.steps * L or eng.steps == 0
            or fd.launches != counts["flash_decode"]):
        raise AssertionError(f"moe: launches {counts} ({fa.launches} forward, {fd.launches} "
                             f"decode in all); want {n_req} x {L} on the bf16 forward and "
                             f"{eng.steps} x {L} on the bf16 decode, nothing else")
    for r in reqs:
        if len(r.out) != max_new or not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"moe: request {r.rid}: bad output {r.out}")
    steps = [r for r in routes if r.shape[0] == slots]
    if len(steps) != eng.steps * L or len(routes) != len(steps) + n_req * L:
        raise AssertionError(f"moe: {len(routes)} routings, {len(steps)} of decode steps; want "
                             f"{n_req} x {L} prefills and {eng.steps} x {L} steps")
    drop_share = float(torch.cat([dropped(r, cfg, slots).reshape(-1) for r in steps])
                       .float().mean())
    for kern in kernels:
        if kern["name"] in ("flash_fwd", "flash_decode"):
            kern["launches_moe"] = counts[kern["name"]]
    check = moe_check(cfg, eng.params, prompt_len, max_seq)
    with torch.no_grad():           # two more decode steps of the 4 slots: untraced, traced
        prof = profiled(lambda: api.decode(cfg, eng.params, eng.cache, eng.tokens),
                        watch=("flash_decode_sm90",))
    emit({"phase": "moe", "model": cfg.name, "layers": L, "published_layers": base.num_layers,
          "d_model": cfg.d_model, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
          "experts": cfg.num_experts, "experts_per_token": cfg.experts_per_token,
          "capacity_factor": cfg.capacity_factor, "compute_dtype": cfg.compute_dtype,
          "params": sum(p.numel() for p in tree.leaves(eng.params)),
          "requests": n_req, "prompt_len": prompt_len, "slots": slots, "max_new": max_new,
          "max_seq": max_seq, "init_seconds": round(init_s, 2), "decode_steps": eng.steps,
          "launches": counts, "prefill_ms_per_request": prefill_ms,
          "decode_ms_per_step_median": float(np.median(decode_ms)),
          "decode_ms_per_step_first": decode_ms[0], "tokens_per_s": n_req * max_new / wall,
          "wall_seconds": wall, "peak_memory_gb": peak_gb,
          "decode_dropped_choice_share": drop_share, "check": check,
          "profile_decode_step": prof, "sample_tokens": reqs[0].out})
    del eng
    torch.cuda.empty_cache()


def logits_far(cfg, got, want):
    """Each logits vector's max abs error and worst ratio to LOGITS_TOL."""
    out = {}
    for what, g, w in zip(("prefill_last", "decode_first"), got, want):
        if g.shape != (1, 1, cfg.vocab_size) or not torch.isfinite(g).all():
            raise AssertionError(f"{cfg.name} {what}: logits shape {tuple(g.shape)} "
                                 "or values are off")
        err = (g - w).abs()
        out[what] = {"max_abs_err": float(err.max()), "worst_ratio_to_tol": float(
            (err / (LOGITS_TOL + LOGITS_TOL * w.abs())).max())}
    return out


def hybrid_routes(cfg, params, prompt_len, max_seq):
    """One prompt through the kernels, through the plain route that rounds P to
    bf16 over 128-key tiles as the bf16 forward does, and through
    mode="reference" (fp32 P): the kernels against each plain route, and the
    two plain routes against each other (the scale of a right answer)."""
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, prompt_len))).to(DEV)
    bf16_p = knob_attention(fa.DEFAULT_BLOCK_K, True, device=DEV, dtype=torch.bfloat16,
                            mode="reference")
    kernel = logits_of(cfg, params, toks, max_seq)
    plain_bf16_p = logits_of(cfg, params, toks, max_seq, mode="reference", attn_fn=bf16_p)
    plain = logits_of(cfg, params, toks, max_seq, mode="reference")
    return {"kernel_vs_plain_bf16_p": logits_far(cfg, kernel, plain_bf16_p),
            "kernel_vs_plain_fp32_p": logits_far(cfg, kernel, plain),
            "plain_bf16_p_vs_plain_fp32_p": logits_far(cfg, plain_bf16_p, plain)}


def ssd_check(cfg):
    """One full-width Mamba2 layer takes a prompt two ways: one chunked call
    (chunks of ``ssm_chunk``) and one-token decode calls carried through the
    state. The final ssm state must agree at SSD_TOL["state"] and the outputs
    at SSD_TOL["out"]: TF32 products or a wrong carry between chunks break it."""
    S = HYBRID["prompt_len"]
    p = mamba.mamba_init(torch.Generator(device=DEV).manual_seed(8), cfg)
    x = (0.5 * torch.randn((1, S, cfg.d_model), device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(9))).bfloat16()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_chunk, st_chunk = mamba.mamba_apply(p, x, cfg)
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - t0) * 1e3
        st, ys = mamba.mamba_state_init(cfg, 1, device=DEV), []
        t0 = time.perf_counter()
        for t in range(S):
            y_t, st = mamba.mamba_apply(p, x[:, t:t + 1], cfg, state=st)
            ys.append(y_t)
        y_seq = torch.cat(ys, dim=1)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / S
    out = {"tokens": S, "chunks": -(-S // cfg.ssm_chunk), "tolerance": SSD_TOL,
           "chunked_call_ms": chunk_ms, "one_token_call_ms": step_ms}
    for what, got, want, tol in (("state", st["ssm"], st_chunk["ssm"], SSD_TOL["state"]),
                                 ("out", y_seq.float(), y_chunk.float(), SSD_TOL["out"])):
        err = (got - want).abs()
        if not torch.isfinite(got).all() or (err > tol + tol * want.abs()).any():
            raise AssertionError(f"ssd check {what}: the recurrence and the chunked scan "
                                 f"differ on the card, max abs err {float(err.max()):.3e}")
        out[f"{what}_max_abs_err"] = float(err.max())
    if not torch.equal(st["conv"], st_chunk["conv"]):
        raise AssertionError("ssd check: the convolution states differ")
    return out


def phase_hybrid(kernels):
    """Full-width, full-depth zamba2-7b served through both bf16 kernels at
    head_dim 112 and G = 1 (see the module docstring)."""
    h = HYBRID
    cfg = registry.get(h["arch"])
    n_req, prompt_len, slots, max_new, max_seq = (h[k] for k in (
        "requests", "prompt_len", "slots", "max_new", "max_seq"))
    allocated_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = api.init(cfg, 0, device=DEV)
    eng = ServeEngine(cfg, params, slots=slots, max_seq=max_seq, device=DEV)
    del params
    torch.cuda.synchronize()
    init_s = time.time() - t0
    reqs = make_requests(cfg, n_req, prompt_len, max_new, seed=7)

    reset_counts()
    t0 = time.time()
    prefill_ms, decode_ms = drive(eng, reqs)
    wall = time.time() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    G = cfg.hybrid_groups
    if (counts["flash_fwd"] != n_req * G or fa.launches != counts["flash_fwd"]
            or counts["flash_decode"] != eng.steps * G or eng.steps == 0
            or fd.launches != counts["flash_decode"]):
        raise AssertionError(f"hybrid: launches {counts} ({fa.launches} forward, {fd.launches} "
                             f"decode in all); want {n_req} x {G} on the bf16 forward and "
                             f"{eng.steps} x {G} on the bf16 decode, nothing else")
    for r in reqs:
        if len(r.out) != max_new or not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"hybrid: request {r.rid}: bad output {r.out}")
    for kern in kernels:
        if kern["name"] in ("flash_fwd", "flash_decode"):
            kern["launches_hybrid"] = counts[kern["name"]]
    with torch.no_grad():           # two more decode steps of the 4 slots: untraced, traced
        prof = profiled(lambda: api.decode(cfg, eng.params, eng.cache, eng.tokens),
                        watch=("flash_decode_sm90",))
    full_depth = hybrid_routes(cfg, eng.params, prompt_len, max_seq)
    n_params, steps = sum(p.numel() for p in tree.leaves(eng.params)), eng.steps
    del eng
    torch.cuda.empty_cache()

    # the check: the kernels against the plain bf16-P route at a cut depth
    cut = dataclasses.replace(cfg, hybrid_groups=h["check_groups"], num_layers=(
        cfg.hybrid_prologue + h["check_groups"] * (cfg.hybrid_mamba_per_group + 1)))
    params = api.cast_params(cut, api.init(cut, 1, device=DEV))
    check = hybrid_routes(cut, params, prompt_len, max_seq)
    del params
    torch.cuda.empty_cache()
    held = check["kernel_vs_plain_bf16_p"]
    if any(held[w]["worst_ratio_to_tol"] > 1 for w in held):
        raise AssertionError(f"hybrid check: logits beyond LOGITS_TOL of the plain bf16-P "
                             f"route at {h['check_groups']} groups; {check}")
    ssd = ssd_check(cfg)
    emit({"phase": "hybrid", "model": cfg.name, "layers": cfg.num_layers,
          "prologue": cfg.hybrid_prologue, "groups": G,
          "mamba_per_group": cfg.hybrid_mamba_per_group, "d_model": cfg.d_model,
          "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
          "ssm_state": cfg.ssm_state, "ssm_chunk": cfg.ssm_chunk,
          "compute_dtype": cfg.compute_dtype, "params": n_params,
          "allocated_gb_before_init": allocated_gb,
          "requests": n_req, "prompt_len": prompt_len, "slots": slots, "max_new": max_new,
          "max_seq": max_seq, "init_seconds": round(init_s, 2), "decode_steps": steps,
          "launches": counts, "prefill_ms_per_request": prefill_ms,
          "decode_ms_per_step_median": float(np.median(decode_ms)),
          "decode_ms_per_step_first": decode_ms[0], "tokens_per_s": n_req * max_new / wall,
          "wall_seconds": wall, "peak_memory_gb": peak_gb,
          "check_groups": h["check_groups"], "logits_tolerance": LOGITS_TOL,
          "check": check, "full_depth_reading": full_depth, "ssd_check": ssd,
          "profile_decode_step": prof, "sample_tokens": reqs[0].out})


@contextlib.contextmanager
def plain_forward_rounds_p():
    """Under mode="reference" the forward's plain version rounds P (and V) to
    bf16 over 128-key tiles before P·V, as the bf16 forward kernel does. An
    encdec model's prefill takes no attn_fn (as the reference's), so the route
    is set here, in the plain version ``ops.mha_forward`` calls."""
    plain = fa.flash_attention_plain
    fa.flash_attention_plain = lambda *a, **kw: plain(*a, **dict(kw, pv_bf16=True))
    try:
        yield
    finally:
        fa.flash_attention_plain = plain


def encdec_logits(cfg, params, batch, max_seq, mode=None):
    """One sequence's prefill and first decode step through one attention route:
    (last prefill position's logits, first decode step's logits)."""
    with torch.no_grad():
        hidden, cache = api.prefill(cfg, params, batch, max_seq=max_seq, mode=mode)
        first, _ = api.decode(cfg, params, cache, batch["tokens"][:, -1:], mode=mode)
        return api.unembed(cfg, params, hidden[:, -1:]).float(), first.float()


def encdec_routes(cfg, params, batch, max_seq):
    """The kernels against the plain route that rounds P to bf16 as the bf16
    forward does and against mode="reference" (fp32 P), and the two plain routes
    against each other (the scale of a right answer)."""
    kernel = encdec_logits(cfg, params, batch, max_seq)
    with plain_forward_rounds_p():
        plain_bf16_p = encdec_logits(cfg, params, batch, max_seq, mode="reference")
    plain = encdec_logits(cfg, params, batch, max_seq, mode="reference")
    return {"kernel_vs_plain_bf16_p": logits_far(cfg, kernel, plain_bf16_p),
            "kernel_vs_plain_fp32_p": logits_far(cfg, kernel, plain),
            "plain_bf16_p_vs_plain_fp32_p": logits_far(cfg, plain_bf16_p, plain)}


def phase_encdec(kernels):
    """Full-width, full-depth whisper-large-v3 through both bf16 kernels on
    every attention: the encoder's, the decoder's and the cross-attention (see
    the module docstring)."""
    e = ENCDEC
    cfg = registry.get(e["arch"])
    B, P, n_new, max_seq = e["batch"], e["prompt_len"], e["new_tokens"], e["max_seq"]
    allocated_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = api.init(cfg, 0, device=DEV)
    served = api.cast_params(cfg, params, device=DEV)   # as ServeEngine would
    del params
    torch.cuda.synchronize()
    init_s = time.time() - t0
    try:
        ServeEngine(cfg, served, device=DEV)
    except NotImplementedError as err:
        refusal = str(err)
    else:
        raise AssertionError("encdec: ServeEngine took an encdec model")
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in token_batch(cfg, batch=B, seq=P, step=0).items() if k != "labels"}
    prefill, step = make_prefill_step(cfg, max_seq=max_seq), make_serve_step(cfg)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, cache = prefill(served, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre_counts = read_counts()
    out, decode_ms = [tok], []
    for _ in range(n_new - 1):
        t0 = time.perf_counter()
        tok, cache = step(served, cache, tok)
        out.append(tok)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps, L = len(decode_ms), cfg.dec_layers
    want_fwd = cfg.enc_layers + 2 * L
    if (pre_counts != {"flash_fwd": want_fwd, "flash_fwd_f32": 0, "flash_decode": 0,
                       "flash_decode_f32": 0}
            or counts["flash_fwd"] != want_fwd or counts["flash_decode"] != 2 * L * steps
            or fa.launches != want_fwd or fd.launches != counts["flash_decode"]):
        raise AssertionError(f"encdec: launches {pre_counts} in the prefill, {counts} in all "
                             f"({fa.launches} forward, {fd.launches} decode); want {want_fwd} "
                             f"on the bf16 forward and {steps} x {2 * L} on the bf16 decode")
    toks = torch.cat(out, dim=1)
    if toks.shape != (B, n_new) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"encdec: bad tokens {toks.shape} {toks[0].tolist()}")
    for kern in kernels:
        if kern["name"] in ("flash_fwd", "flash_decode"):
            kern["launches_encdec"] = counts[kern["name"]]
    with torch.no_grad():           # two more decode steps of the 4 sequences: untraced, traced
        prof = profiled(lambda: api.decode(cfg, served, cache, tok),
                        watch=("flash_decode_sm90",))
    one = {k: v[:1] for k, v in batch.items()}
    full_depth = encdec_routes(cfg, served, one, max_seq)
    n_params = sum(p.numel() for p in tree.leaves(served))
    del served, cache
    torch.cuda.empty_cache()

    # the check: the kernels against the plain bf16-P route at a cut depth
    n = e["check_layers"]
    cut = dataclasses.replace(cfg, num_layers=n, enc_layers=n, dec_layers=n)
    params = api.cast_params(cut, api.init(cut, 1, device=DEV))
    check = encdec_routes(cut, params, one, max_seq)
    del params
    torch.cuda.empty_cache()
    held = check["kernel_vs_plain_bf16_p"]
    if any(held[w]["worst_ratio_to_tol"] > 1 for w in held):
        raise AssertionError(f"encdec check: logits beyond LOGITS_TOL of the plain bf16-P "
                             f"route at {n} + {n} layers; {check}")
    emit({"phase": "encdec", "model": cfg.name, "enc_layers": cfg.enc_layers,
          "dec_layers": cfg.dec_layers, "d_model": cfg.d_model, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim, "frames": cfg.frontend_len,
          "compute_dtype": cfg.compute_dtype, "params": n_params,
          "allocated_gb_before_init": allocated_gb, "init_seconds": round(init_s, 2),
          "batch": B, "prompt_len": P, "new_tokens": n_new, "max_seq": max_seq,
          "decode_steps": steps, "launches_prefill": pre_counts, "launches": counts,
          "prefill_ms": prefill_ms, "decode_ms_per_step_median": float(np.median(decode_ms)),
          "decode_ms_per_step_first": decode_ms[0],
          "tokens_per_s": B * n_new / ((prefill_ms + sum(decode_ms)) / 1e3),
          "peak_memory_gb": peak_gb, "serve_engine_refusal": refusal,
          "check_layers": n, "logits_tolerance": LOGITS_TOL, "check": check,
          "full_depth_reading": full_depth, "profile_decode_step": prof,
          "sample_tokens": toks[0].tolist()})


def wkv_check(cfg):
    """One full-width time_mix takes a prompt two ways: one chunked call (chunks
    of 64) and one-token calls carried through the state. The final state must
    agree at WKV_TOL["state"] and the outputs at WKV_TOL["out"], the reference's
    own tolerances: TF32 products or a wrong carry between chunks break it."""
    S = SSM["prompt_len"]
    p = rwkv.rwkv_init(torch.Generator(device=DEV).manual_seed(8), cfg)["tmix"]
    x = 0.5 * torch.randn((1, S, cfg.d_model), device=DEV,
                          generator=torch.Generator(device=DEV).manual_seed(9))
    st = rwkv.rwkv_state_init(cfg, 1, device=DEV)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_chunk, S_chunk, _ = rwkv.time_mix(p, x, cfg, S0=st["S"], x_prev=st["x_att"])
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - t0) * 1e3
        Sr, xp, ys = st["S"], st["x_att"], []
        t0 = time.perf_counter()
        for t in range(S):
            y_t, Sr, xp = rwkv.time_mix(p, x[:, t:t + 1], cfg, S0=Sr, x_prev=xp)
            ys.append(y_t)
        y_seq = torch.cat(ys, dim=1)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / S
    out = {"tokens": S, "chunks": -(-S // 64), "tolerance": WKV_TOL,
           "chunked_call_ms": chunk_ms, "one_token_call_ms": step_ms}
    for what, got, want, tol in (("state", Sr, S_chunk, WKV_TOL["state"]),
                                 ("out", y_seq, y_chunk, WKV_TOL["out"])):
        err = (got - want).abs()
        if not torch.isfinite(got).all() or (err > tol + tol * want.abs()).any():
            raise AssertionError(f"wkv check {what}: the recurrence and the chunked form "
                                 f"differ on the card, max abs err {float(err.max()):.3e}")
        out[f"{what}_max_abs_err"] = float(err.max())
    return out


def phase_ssm(kernels):
    """Full-width, full-depth rwkv6-7b served through ServeEngine (see the module
    docstring): no attention, its blocks fp32."""
    m = SSM
    cfg = registry.get(m["arch"])
    n_req, prompt_len, slots, max_new, max_seq = (m[k] for k in (
        "requests", "prompt_len", "slots", "max_new", "max_seq"))
    allocated_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = api.init(cfg, 0, device=DEV)
    eng = ServeEngine(cfg, params, slots=slots, max_seq=max_seq, device=DEV)
    del params
    torch.cuda.synchronize()
    init_s = time.time() - t0
    reqs = make_requests(cfg, n_req, prompt_len, max_new, seed=10)

    reset_counts()
    t0 = time.time()
    prefill_ms, decode_ms = drive(eng, reqs)
    wall = time.time() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(counts.values()) or fa.launches or fd.launches or eng.steps == 0:
        raise AssertionError(f"ssm: attention-kernel launches {counts} in an attention-free "
                             f"model, or no decode step ({eng.steps})")
    for r in reqs:
        if len(r.out) != max_new or not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"ssm: request {r.rid}: bad output {r.out}")
    blocks = [t for t in tree.leaves(eng.params["blocks"])]
    if any(t.dtype != torch.float32 for t in blocks + tree.leaves(eng.params["ln0"])):
        raise AssertionError("ssm: ServeEngine's cast rounded a block leaf")
    # a decode step reads every fp32 block weight and the bf16 unembedding once
    step_bytes = (sum(t.numel() * t.element_size() for t in blocks)
                  + eng.params["unembed"]["w"].numel() * 2)
    with torch.no_grad():           # two more decode steps of the 4 slots: untraced, traced
        prof = profiled(lambda: api.decode(cfg, eng.params, eng.cache, eng.tokens))
    n_params, steps = sum(p.numel() for p in tree.leaves(eng.params)), eng.steps
    del eng
    torch.cuda.empty_cache()

    # the check: one decode step against the full forward at a cut depth
    cut = dataclasses.replace(cfg, num_layers=m["check_layers"])
    params = api.cast_params(cut, api.init(cut, 1, device=DEV))
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (1, prompt_len + 1))).to(DEV)
    with torch.no_grad():
        hidden, _ = api.forward_hidden(cut, params, {"tokens": toks}, remat="none")
        full = api.unembed(cut, params, hidden[:, -1:]).float()
        _, cache = api.prefill(cut, params, {"tokens": toks[:, :-1]}, max_seq=max_seq)
        dec, _ = api.decode(cut, params, cache, toks[:, -1:])
    err = (dec.float() - full).abs()
    ratio = float((err / (LOGITS_TOL + LOGITS_TOL * full.abs())).max())
    if not torch.isfinite(dec).all() or ratio > 1:
        raise AssertionError(f"ssm check: decode logits beyond LOGITS_TOL of the full "
                             f"forward's, max abs err {float(err.max()):.3e}")
    del params, cache
    torch.cuda.empty_cache()
    wkv = wkv_check(cfg)
    emit({"phase": "ssm", "model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
          "d_ff": cfg.d_ff, "rwkv_head_dim": cfg.rwkv_head_dim,
          "compute_dtype": cfg.compute_dtype, "params": n_params,
          "allocated_gb_before_init": allocated_gb,
          "requests": n_req, "prompt_len": prompt_len, "slots": slots, "max_new": max_new,
          "max_seq": max_seq, "init_seconds": round(init_s, 2), "decode_steps": steps,
          "launches": counts, "prefill_ms_per_request": prefill_ms,
          "decode_ms_per_step_median": float(np.median(decode_ms)),
          "decode_ms_per_step_first": decode_ms[0], "tokens_per_s": n_req * max_new / wall,
          "wall_seconds": wall, "peak_memory_gb": peak_gb,
          "decode_step_bytes": step_bytes, "decode_step_bound_ms": step_bytes / PEAK_BYTES * 1e3,
          "check_layers": m["check_layers"], "logits_tolerance": LOGITS_TOL,
          "check_decode_vs_forward": {"max_abs_err": float(err.max()),
                                      "worst_ratio_to_tol": ratio},
          "wkv_check": wkv, "profile_decode_step": prof, "sample_tokens": reqs[0].out})


def attention_grads(rng, shape, dtype):
    """The forward output and q/k/v gradients of ``ops.mha_forward`` (model-side
    layout) through the kernel route against ``mode="reference"``, both under
    autograd; returns the worst error of each, and times (CUDA events): the
    plain version without grad beside the forward's bound, and forward plus
    backward through the kernel route and through the library call. (The
    kernels phase times the forward kernel at the training shape.)"""
    B, H, Hkv, L, D = shape
    q, k, v = (randn(rng, (B, L, h, D), dtype).requires_grad_(True) for h in (H, Hkv, Hkv))
    r = randn(rng, (B, L, H, D), torch.float32)
    out = {}
    for mode in (None, "reference"):
        o = ops.mha_forward(q, k, v, causal=True, mode=mode)
        if mode is None and o.grad_fn is None:
            raise AssertionError("mha_forward under grad gave an output with no grad_fn")
        out[mode] = (o.detach(),) + torch.autograd.grad((o.float() * r).sum(), (q, k, v))
    what = f"attention gradients {shape} causal {dtype}"
    errs = {name: compare(got, want, dtype, f"{what}: {name}")
            for name, got, want in zip(("o", "dq", "dk", "dv"), out[None], out["reference"])}

    def fwd_bwd(fn):
        def run():
            o = fn()
            torch.autograd.grad((o.float() * r).sum(), (q, k, v))
        return run

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rt = r.transpose(1, 2)
    lib = lambda: torch.autograd.grad((sdpa(qt, kt, vt, True).float() * rt).sum(), (q, k, v))
    with torch.no_grad():
        times = dict(plain_fwd_ms=time_ms(lambda: ops.mha_forward(q, k, v, causal=True,
                                                                  mode="reference"), iters=5))
    times["bound_fwd_ms"], times["bound_fwd_by"] = bound(
        *fwd_costs(B, H, Hkv, L, L, D, dtype, True))
    times.update(fwd_bwd_ms=time_ms(fwd_bwd(lambda: ops.mha_forward(q, k, v, causal=True)),
                                    iters=10, warmup=2),
                 library_fwd_bwd_ms=time_ms(lib, iters=10, warmup=2))
    return errs, times


def attention_weight_grads(cfg, run, params, batch):
    """The gradients of every layer's wq, wk and wv through the kernel route,
    held against a plain route that rounds P as the kernel does.

    None may be zero, and every one must lie within ``WGRAD_TOL`` (relative,
    in norm) of the plain route ``flash_ref(chunk=128, pv_bf16=True)`` under
    ``mode="reference"``: P·V of bf16 P over the kernel's 128-key tiles, and
    autograd of the same in the backward, as ``FlashAttentionFn`` does. A wrong
    attention moves these gradients by O(1). Two readings set the scale of a
    right one: the kernel route against P kept fp32, and the two plain bf16-P
    routes against each other (chunks of 128 and 512 keys: the same function,
    rounded against other running maxima). bf16 rounding of P, and of its
    gradient in the backward, is redrawn by any change of the inputs, so
    correct routes sit as far apart as the latter reads."""
    names = ("wq", "wk", "wv")
    ws = [blk["attn"][n]["w"] for blk in params["blocks"] for n in names]
    bf16_p = dict(attn_chunk=fa.DEFAULT_BLOCK_K, attn_pv_bf16=True)
    routes = {"kernel": (run, None), "plain_fp32_p": (run, "reference"),
              "plain_bf16_p": (dataclasses.replace(run, **bf16_p), "reference"),
              "plain_bf16_p_chunk512": (dataclasses.replace(run, attn_pv_bf16=True),
                                        "reference")}
    got = {}
    for route, (r, mode) in routes.items():
        loss, _ = trainer.make_loss_fn(cfg, r, mode=mode)(params, batch)
        got[route] = torch.autograd.grad(loss, ws)
    zero = [f"layer {i // 3} {names[i % 3]}" for i, g in enumerate(got["kernel"])
            if not float(g.abs().sum()) > 0]
    if zero:
        raise AssertionError(f"train: no gradient through the kernel route for {zero}")

    def rel(a, b):
        return [float((x - y).norm() / y.norm()) for x, y in zip(got[a], got[b])]

    pairs = {"kernel_vs_plain_bf16_p": rel("kernel", "plain_bf16_p"),
             "kernel_vs_plain_fp32_p": rel("kernel", "plain_fp32_p"),
             "plain_bf16_p_vs_plain_fp32_p": rel("plain_bf16_p", "plain_fp32_p"),
             "plain_bf16_p_chunk512_vs_chunk128": rel("plain_bf16_p_chunk512",
                                                      "plain_bf16_p")}
    out = {"tolerance": WGRAD_TOL}
    for pair, xs in pairs.items():
        out[pair] = {"max": max(xs), "median": float(np.median(xs))}
        for layer in (0, cfg.num_layers - 1):
            out[pair].update({f"layer{layer}.{n}": xs[3 * layer + k]
                              for k, n in enumerate(names)})
    far = [(f"layer {i // 3} {names[i % 3]}", x)
           for i, x in enumerate(pairs["kernel_vs_plain_bf16_p"]) if x > WGRAD_TOL]
    if far:
        raise AssertionError(f"train: wq/wk/wv gradients through the kernel route beyond "
                             f"{WGRAD_TOL} of the plain bf16-P route: {far}; {out}")
    return out


def train_flops(cfg, params, tokens):
    """Model FLOPs of one step with remat "full" and the tied unembedding: 6 N T
    for the blocks' forward and backward, 2 N T for their recompute (N the
    parameters outside the embedding), and 8 T d V for the unembedding's forward,
    its recompute in the chunked loss and its backward."""
    n = sum(p.numel() for p in tree.leaves(params["blocks"]))
    return 8 * n * tokens + 8 * tokens * cfg.d_model * cfg.vocab_size


def phase_train(kernels):
    """Full-width olmo-1b trained for a few steps through the forward kernel."""
    rng = np.random.default_rng(4)
    grads, grad_times = {}, {}
    for shape, dt in TRAIN_GRAD_CASES:
        key = f"B{shape[0]} H{shape[1]} Hkv{shape[2]} L=S={shape[3]} D{shape[4]} {str(dt)[6:]}"
        grads[key], grad_times[key] = attention_grads(rng, shape, dt)

    cfg = registry.get(TRAIN["arch"])
    B, S, n_steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    run = trainer.RunConfig(remat="full", microbatches=1,
                            opt=opt.OptConfig(lr=3e-4, warmup_steps=2))
    data = DataIterator(cfg, batch=B, seq=S, seed=0)
    batches = [{k: torch.from_numpy(v).to(DEV) for k, v in next(data).items()}
               for _ in range(n_steps)]

    # step 1 through the plain attention, from the same seeded weights
    state = trainer.init_state(cfg, run, 0, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = trainer.make_train_step(cfg, run, mode="reference")(state, batches[0])
    ref = {k: float(m[k]) for k in ("loss", "grad_norm")}
    ref_ms = (time.perf_counter() - t0) * 1e3
    del state, m
    torch.cuda.empty_cache()

    t0 = time.time()
    state = trainer.init_state(cfg, run, 0, device=DEV)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    weight_grads = attention_weight_grads(cfg, run, state.params, batches[0])
    step_fn = trainer.make_train_step(cfg, run)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms, metrics, launches = [], [], []
    for batch in batches:
        before = fa.launches_sm90
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(fa.launches_sm90 - before)
        metrics.append({k: float(v) for k, v in m.items()})
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # two more steps after the counted ones: one untraced, one traced
    n0 = fa.launches_sm90
    prof = profiled(lambda: step_fn(state, batches[0]), watch=("flash_fwd_sm90",))
    prof["watched"]["flash_fwd_sm90"]["wrapper_launches"] = (fa.launches_sm90 - n0) // 2

    L = cfg.num_layers
    if launches != [2 * L] * n_steps or counts["flash_fwd"] != 2 * L * n_steps or any(
            counts[k] for k in ("flash_fwd_f32", "flash_decode", "flash_decode_f32")):
        raise AssertionError(f"train launches {launches} a step, {counts} in all; want "
                             f"{2 * L} on the bf16 forward kernel a step (forward + "
                             "recompute) and nothing else")
    losses = [x["loss"] for x in metrics]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: non-finite loss in {losses}")
    rel = {k: abs(metrics[0][k] - ref[k]) / abs(ref[k]) for k in ref}
    if any(x > TRAIN_TOL for x in rel.values()):
        raise AssertionError(f"train step 1 through the kernels {metrics[0]} against "
                             f"mode='reference' {ref}: relative differences {rel}")
    for kern in kernels:
        if kern["name"] == "flash_fwd":
            kern["launches_train"] = counts["flash_fwd"]

    tokens = B * S
    flops = train_flops(cfg, state.params, tokens)
    med_ms = float(np.median(step_ms[1:]))
    emit({"phase": "train", "model": cfg.name, "layers": L, "d_model": cfg.d_model,
          "compute_dtype": cfg.compute_dtype,
          "params": sum(p.numel() for p in tree.leaves(state.params)),
          "batch": B, "seq": S, "steps": n_steps, "remat": run.remat,
          "init_seconds": round(init_s, 2), "losses": losses,
          "grad_norms": [x["grad_norm"] for x in metrics], "lrs": [x["lr"] for x in metrics],
          "step1_reference": ref, "step1_relative_difference": rel,
          "step1_tolerance": TRAIN_TOL, "reference_step_ms": ref_ms,
          "attention_weight_grads": weight_grads,
          "attention_grad_max_abs_err": grads, "attention_grad_tolerance":
          {"float32": TOL[torch.float32], "bfloat16": TOL[torch.bfloat16]},
          "attention_timings": grad_times,
          "flash_fwd_launches_per_step": launches, "launches": counts,
          "step_ms": step_ms, "step_ms_median_2_to_5": med_ms,
          "tokens_per_s": tokens / (med_ms / 1e3), "model_flops_per_step": flops,
          "model_flops_share_of_989_tflops": flops / (med_ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
          "peak_memory_gb": peak_gb, "profile_one_step": prof})
    del state
    torch.cuda.empty_cache()


def recorded_steps(make_step, log):
    """``make_step`` wrapped so that each step it makes appends its step ms, its
    bf16 forward-kernel launches, the peak memory since the first step began
    (the steps' peak, not the set-up's) and its metrics (floats) to ``log``."""
    def make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def recorded(state, batch):
            n0 = fa.launches_sm90
            torch.cuda.synchronize()
            if not log:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            log.append({"ms": (time.perf_counter() - t0) * 1e3,
                        "launches": fa.launches_sm90 - n0,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        **{k: float(v) for k, v in m.items()}})
            return state, m
        return recorded
    return make


# the readings of the sharded (1, 1) step on the full-gather route, before the
# partitioned one (PERF.md, H100 80GB HBM3, 700 W),
# printed beside this run's
PARALLEL_GATHERED_ROUTE = {"steps_peak_memory_gb": 23.608, "device_busy_ms": 169.11}


def phase_parallel(kernels):
    """Full-width olmo-1b through launch/train.py's sharded trainer on a (1, 1)
    mesh, held to the unsharded trainer bit for bit; olmo-1b's family takes the
    partitioned route (trainer.route). Then the hybrid, ssm and encdec
    families through the sharded step (``parallel_family``)."""
    total = torch.cuda.get_device_properties(0).total_memory
    if not specs.HBM_BUDGET < total:
        raise AssertionError(f"parallel: launch/specs.py's HBM_BUDGET {specs.HBM_BUDGET} is "
                             f"not below the card's total_memory {total}")
    cfg = registry.get(PARALLEL["arch"])
    B, S, n = PARALLEL["batch"], PARALLEL["seq"], PARALLEL["steps"]
    # the launcher's optimizer settings and data (seed 0, from step 0)
    run = trainer.RunConfig(remat=PARALLEL["remat"], microbatches=1, opt=opt.OptConfig(
        lr=3e-4, warmup_steps=10, total_steps=n, schedule=cfg.lr_schedule))
    data = DataIterator(cfg, batch=B, seq=S)
    batches = [{k: torch.from_numpy(v).to(DEV) for k, v in next(data).items()}
               for _ in range(n)]

    plain = []
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state(cfg, run, 0, device=DEV)
    init_peak = {"unsharded": torch.cuda.max_memory_allocated() / 1e9}
    step_fn = recorded_steps(trainer.make_train_step, plain)(cfg, run)
    for batch in batches:
        state, _ = step_fn(state, batch)
    del state, step_fn
    torch.cuda.empty_cache()

    sharded = []
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="parallel_", dir=root)
    argv = ["--arch", cfg.name, "--batch", str(B), "--seq", str(S), "--steps", str(n),
            "--remat", PARALLEL["remat"], "--dp", "1", "--tp", "1",
            "--ckpt-dir", os.path.join(work, "ckpt"), "--ckpt-every", str(n + 1)]
    make_step = trainer.make_train_step
    trainer.make_train_step = recorded_steps(make_step, sharded)
    dist.init_process_group("nccl", init_method=f"file://{work}/store", rank=0, world_size=1,
                            device_id=torch.device(DEV, 0))
    try:
        reset_counts()
        t0 = time.perf_counter()
        rc = launch_train.main(argv)
        main_s = time.perf_counter() - t0
        counts = read_counts()
        trainer.make_train_step = make_step
        torch.cuda.empty_cache()
        # one more step of each route under the profiler, in turns (sharded
        # first: the unsharded route had the card's first steps)
        mesh = make_mesh((1, 1), ("data", "model"))
        torch.cuda.reset_peak_memory_stats()
        state = trainer.shard_state(cfg, trainer.init_state(cfg, run, 0, device=DEV), mesh)
        init_peak["sharded"] = torch.cuda.max_memory_allocated() / 1e9
        step_fn = trainer.make_train_step(cfg, run, mesh=mesh)
        batch = trainer.shard_batch(batches[0], mesh)
        profile = {"sharded": profiled(lambda: step_fn(state, batch), watch=("nccl",))}
        del state, step_fn, batch
        torch.cuda.empty_cache()
        family_launches = {spec["arch"]: parallel_family(spec, mesh, n)
                           for spec in PARALLEL_FAMILIES}
    finally:
        trainer.make_train_step = make_step
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    state = trainer.init_state(cfg, run, 0, device=DEV)
    step_fn = trainer.make_train_step(cfg, run)
    profile["unsharded"] = profiled(lambda: step_fn(state, batches[0]), watch=("nccl",))
    del state, step_fn
    torch.cuda.empty_cache()

    L = cfg.num_layers
    rel = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm")}
           for a, b in zip(sharded, plain)]
    emit({"phase": "parallel", "model": cfg.name, "layers": L, "mesh": {"data": 1, "model": 1},
          "batch": B, "seq": S, "steps": n, "remat": run.remat, "launcher_rc": rc,
          "launcher_seconds": main_s,
          "sharded": {"losses": [x["loss"] for x in sharded],
                      "grad_norms": [x["grad_norm"] for x in sharded],
                      "step_ms": [x["ms"] for x in sharded],
                      "flash_fwd_launches_per_step": [x["launches"] for x in sharded],
                      "steps_peak_memory_gb": max(x["peak_gb"] for x in sharded),
                      "init_peak_memory_gb": init_peak["sharded"]},
          "unsharded": {"losses": [x["loss"] for x in plain],
                        "grad_norms": [x["grad_norm"] for x in plain],
                        "step_ms": [x["ms"] for x in plain],
                        "flash_fwd_launches_per_step": [x["launches"] for x in plain],
                        "steps_peak_memory_gb": max(x["peak_gb"] for x in plain),
                        "init_peak_memory_gb": init_peak["unsharded"]},
          "profile_one_step": profile, "route": trainer.route(cfg),
          "gathered_route_sharded": PARALLEL_GATHERED_ROUTE,
          "relative_difference": rel, "tolerance": PARALLEL_TOL, "launches": counts,
          "total_memory": total, "hbm_budget": specs.HBM_BUDGET})
    if rc != 0 or len(sharded) != n:
        raise AssertionError(f"parallel: launch/train.py returned {rc} after {len(sharded)} "
                             f"of {n} steps")
    if trainer.route(cfg) != "partitioned":
        raise AssertionError(f"parallel: {cfg.name}'s sharded step takes the "
                             f"{trainer.route(cfg)!r} route, not the partitioned one")
    if any(x > PARALLEL_TOL for r in rel for x in r.values()):
        raise AssertionError(f"parallel: sharded against unsharded beyond {PARALLEL_TOL}: {rel}")
    if any(a[k] != b[k] for a, b in zip(sharded, plain) for k in ("loss", "grad_norm")):
        raise AssertionError(f"parallel: the (1, 1) partitioned route is not the unsharded "
                             f"trainer bit for bit: {rel}")
    want = [2 * L] * n
    got = [x["launches"] for x in sharded]
    if got != want or [x["launches"] for x in plain] != want or counts["flash_fwd"] != 2 * L * n:
        raise AssertionError(f"parallel: forward-kernel launches a step {got} sharded, "
                             f"{[x['launches'] for x in plain]} unsharded, {counts} in the "
                             f"launcher's run; want {want}")
    for kern in kernels:
        if kern["name"] == "flash_fwd":
            kern["launches_parallel"] = counts["flash_fwd"]
            kern["launches_parallel_families"] = family_launches


def attention_uses(cfg) -> int:
    """The attention calls of one forward of ``cfg``'s model."""
    if cfg.family == "hybrid":
        return cfg.hybrid_groups
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.dec_layers
    if cfg.family == "ssm":
        return 0
    return cfg.num_layers


def layer_count(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.hybrid_prologue + cfg.hybrid_groups * (cfg.hybrid_mamba_per_group + 1)
    if cfg.family == "encdec":
        return cfg.enc_layers + cfg.dec_layers
    return cfg.num_layers


def parallel_family(spec, mesh, n):
    """``spec``'s family through the sharded step on the (1, 1) ``mesh`` and
    through the unsharded trainer, ``n`` steps each from the same seed and
    batches; returns the run's line and its forward-kernel launches."""
    full = registry.get(spec["arch"])
    cfg = dataclasses.replace(full, **spec["cut"])
    B, S = spec["batch"], spec["seq"]
    run = trainer.RunConfig(remat=PARALLEL["remat"], microbatches=1, opt=opt.OptConfig(
        lr=3e-4, warmup_steps=10, total_steps=n, schedule=cfg.lr_schedule))
    data = DataIterator(cfg, batch=B, seq=S)
    batches = [{k: torch.from_numpy(v).to(DEV) for k, v in next(data).items()}
               for _ in range(n)]
    logs, launches, n_params, profile = {"unsharded": [], "sharded": []}, 0, 0, None
    for name, log in logs.items():
        sharded = name == "sharded"
        state = trainer.init_state(cfg, run, 0, device=DEV)
        n_params = sum(p.numel() for p in tree.leaves(state.params))
        if sharded:
            state = trainer.shard_state(cfg, state, mesh)
        step_fn = recorded_steps(trainer.make_train_step, log)(
            cfg, run, **({"mesh": mesh} if sharded else {}))
        reset_counts()
        for batch in batches:
            state, _ = step_fn(state, trainer.shard_batch(batch, mesh) if sharded else batch)
        if sharded:
            launches = read_counts()["flash_fwd"]
            # two more steps, the second under the profiler: where a step's time goes
            batch = trainer.shard_batch(batches[0], mesh)
            profile = profiled(lambda: step_fn(state, batch), top=8,
                               watch=("flash_fwd_sm90", "nccl"))
            del log[n:], batch
        del state, step_fn
        torch.cuda.empty_cache()
    sharded, plain = logs["sharded"], logs["unsharded"]
    want = [2 * attention_uses(cfg)] * n
    row = {"phase": "parallel", "model": cfg.name, "mesh": {"data": 1, "model": 1},
           "route": trainer.route(cfg), "family": cfg.family,
           "depth_cut": {"fields": spec["cut"], "layers": layer_count(cfg),
                         "layers_full": layer_count(full),
                         "layers_left_out": layer_count(full) - layer_count(cfg)},
           "params": n_params, "batch": B, "seq": S,
           "frames": cfg.frontend_len if cfg.family == "encdec" else None,
           "steps": n, "remat": run.remat, "compute_dtype": cfg.compute_dtype,
           "launches": launches, "flash_fwd_launches_per_step_want": want[0]}
    for name, log in logs.items():
        row[name] = {"losses": [x["loss"] for x in log],
                     "grad_norms": [x["grad_norm"] for x in log],
                     "step_ms": [x["ms"] for x in log],
                     "flash_fwd_launches_per_step": [x["launches"] for x in log],
                     "steps_peak_memory_gb": max(x["peak_gb"] for x in log)}
    row["sharded"]["profile_one_step"] = profile
    emit(row)
    if trainer.route(cfg) != "partitioned":
        raise AssertionError(f"parallel: {cfg.name}'s sharded step takes the "
                             f"{trainer.route(cfg)!r} route, not the partitioned one")
    losses = [x["loss"] for x in sharded]
    if len(sharded) != n or not all(np.isfinite(losses)):
        raise AssertionError(f"parallel: {cfg.name} took {len(sharded)} of {n} steps, "
                             f"losses {losses}")
    if any(a[k] != b[k] for a, b in zip(sharded, plain) for k in ("loss", "grad_norm")):
        raise AssertionError(f"parallel: {cfg.name}'s (1, 1) partitioned route is not the "
                             f"unsharded trainer bit for bit: {row}")
    if ([x["launches"] for x in sharded] != want or [x["launches"] for x in plain] != want
            or launches != sum(want)):
        raise AssertionError(f"parallel: {cfg.name}'s forward-kernel launches a step "
                             f"{row['sharded']['flash_fwd_launches_per_step']} sharded, "
                             f"{row['unsharded']['flash_fwd_launches_per_step']} unsharded, "
                             f"{launches} in all; want {want}")
    return launches


def counted(fn):
    """(counter, forward launches, decode launches) of one call of ``fn`` under
    the cost counter."""
    n_fa, n_fd = fa.launches, fd.launches
    with CostCounter() as c:
        fn()
    torch.cuda.synchronize()
    return c, fa.launches - n_fa, fd.launches - n_fd


def cost_row(name, arch, kind, tokens, card_fn, meta_count):
    """One step counted on the card, profiled, and held to its count on meta
    (``meta_count``, what ``counted`` gave for the same step on meta tensors)
    and to its roofline bound."""
    card_fn()                                         # warm-up, not counted
    torch.cuda.synchronize()
    card, n_fa, n_fd = counted(card_fn)
    prof = profiled(card_fn, top=5)
    meta, m_fa, m_fd = meta_count
    bound_s = {"operations": card.flops / roofline.PEAK_FLOPS,
               "bytes": card.bytes / roofline.HBM_BW}
    bound_by = max(bound_s, key=bound_s.get)
    bound_ms = bound_s[bound_by] * 1e3
    busy = prof["device_busy_ms"]
    row = {"step": name, "model": arch, "flops": card.flops, "flops_meta": meta.flops,
           "bytes": card.bytes, "bytes_meta": meta.bytes, "instr_count": card.instr_count,
           "kernel_records": dict(card.kernels), "kernel_records_meta": dict(meta.kernels),
           "launches": {"flash_fwd": n_fa, "flash_decode": n_fd},
           "bound_ms": bound_ms, "bound_by": bound_by, "busy_ms": busy,
           "wall_ms": prof["wall_ms"], "bound_over_busy": bound_ms / busy,
           "device_idle_share": prof["device_idle_share"],
           "useful_flops_ratio": roofline.model_flops_total(arch, kind, tokens) / card.flops,
           "top_bytes": [{"bytes": b, "op": op, "shape": shape, "calls": n}
                         for b, op, shape, n in card.top_bytes(5)],
           "top_kernels": prof["top_kernels"]}
    emit({"phase": "cost", **row})
    if card.flops != meta.flops or card.bytes != meta.bytes:
        raise AssertionError(f"cost {name}: the card's count ({card.flops} FLOPs, {card.bytes} "
                             f"bytes) is not the meta count ({meta.flops}, {meta.bytes})")
    want = {"flash_attention": n_fa, "flash_decode": n_fd}
    got = {k: card.kernels.get(k, 0) for k in want}
    if got != want or {k: meta.kernels.get(k, 0) for k in want} != got or m_fa or m_fd:
        raise AssertionError(f"cost {name}: kernel records {dict(card.kernels)} on the card, "
                             f"{dict(meta.kernels)} on meta; launches {want} on the card, "
                             f"{m_fa} / {m_fd} on meta")
    if bound_ms > BOUND_OVER_BUSY * busy:
        raise AssertionError(f"cost {name}: the roofline bound {bound_ms:.3f} ms ({bound_by}) "
                             f"is above {BOUND_OVER_BUSY} x the busy time {busy:.3f} ms")
    return row


def hook_us(n=200_000):
    """Host µs of the kernels' cost hook with no counter open: one
    ``cost.kernel`` region opened and left as the forward's wrapper opens it
    (the loop's own time included)."""
    q = torch.empty((1, 16, 512, 128), dtype=torch.bfloat16, device=DEV)
    k = torch.empty((1, 2, 512, 128), dtype=torch.bfloat16, device=DEV)
    t = time.perf_counter()
    for _ in range(n):
        with cost.kernel("flash_attention", fa._fwd_counts, q, k, k):
            pass
    return (time.perf_counter() - t) / n * 1e6


def meta_like(batch):
    """Empty meta tensors of the batch's shapes, types and strides."""
    return {k: torch.empty_strided(v.shape, v.stride(), dtype=v.dtype, device="meta")
            for k, v in batch.items()}


def phase_cost(smi):
    """The eager cost counter on the card: four full-width steps, counted on the
    card and on meta, against their busy time."""
    rows = []
    no_counter_us = hook_us()
    cfg = registry.get(COST["arch"])
    params = api.cast_params(cfg, api.init(cfg, 0, device=DEV))
    mparams = api.cast_params(cfg, api.init(cfg, device="meta"))
    L, B = COST["prompt_len"], COST["slots"]
    toks = torch.randint(0, cfg.vocab_size, (1, L), dtype=torch.int32, device=DEV)
    prefill = make_prefill_step(cfg, max_seq=COST["max_seq"])
    rows.append(cost_row(
        "prefill", COST["arch"], "prefill", L, lambda: prefill(params, {"tokens": toks}),
        counted(lambda: prefill(mparams, meta_like({"tokens": toks})))))

    serve = make_serve_step(cfg)
    caches = {d: api.init_cache(cfg, B, COST["max_seq"], device=d) for d in (DEV, "meta")}
    tok = torch.randint(0, cfg.vocab_size, (B, 1), dtype=torch.int32, device=DEV)

    def decode(p, dev, t):
        caches[dev]["idx"] = COST["clen"] - 1          # one new token: cache_len clen
        return serve(p, caches[dev], t)

    rows.append(cost_row(
        "decode", COST["arch"], "decode", B, lambda: decode(params, DEV, tok),
        counted(lambda: decode(mparams, "meta", meta_like({"t": tok})["t"]))))
    del params, mparams, caches, prefill, serve
    torch.cuda.empty_cache()

    tcfg = registry.get(TRAIN["arch"])
    run = trainer.RunConfig(remat="full", microbatches=1,
                            opt=opt.OptConfig(lr=3e-4, warmup_steps=2))
    tokens = TRAIN["batch"] * TRAIN["seq"]
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in
             next(DataIterator(tcfg, batch=TRAIN["batch"], seq=TRAIN["seq"])).items()}
    step = trainer.make_train_step(tcfg, run)
    state = trainer.init_state(tcfg, run, 0, device=DEV)
    mstate = trainer.init_state(tcfg, run, 0, device="meta")
    rows.append(cost_row("train", TRAIN["arch"], "train", tokens, lambda: step(state, batch),
                         counted(lambda: step(mstate, meta_like(batch)))))
    del state, mstate, step
    torch.cuda.empty_cache()

    # the (1, 1) mesh: the meta count on a fake group of one, then the card's on NCCL
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        mstate = trainer.shard_state(tcfg, trainer.init_state(tcfg, run, 0, device="meta"), mesh)
        mstep = trainer.make_train_step(tcfg, run, mesh=mesh)
        mbatch = trainer.shard_batch(meta_like(batch), mesh)
        meta_count = counted(lambda: mstep(mstate, mbatch))
    finally:
        dist.destroy_process_group()
    del mstate, mstep, mbatch
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="cost_", dir=root)
    dist.init_process_group("nccl", init_method=f"file://{work}/store", rank=0, world_size=1,
                            device_id=torch.device(DEV, 0))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        state = trainer.shard_state(tcfg, trainer.init_state(tcfg, run, 0, device=DEV), mesh)
        sstep = trainer.make_train_step(tcfg, run, mesh=mesh)
        sbatch = trainer.shard_batch(batch, mesh)
        rows.append(cost_row("train_mesh_1x1", TRAIN["arch"], "train", tokens,
                             lambda: sstep(state, sbatch), meta_count))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    del state, sstep, sbatch
    torch.cuda.empty_cache()
    emit({"phase": "cost", "card": smi, "peak_flops": roofline.PEAK_FLOPS,
          "hbm_bw": roofline.HBM_BW, "bound_over_busy_limit": BOUND_OVER_BUSY,
          "hook_us_no_counter": no_counter_us,
          "steps": {r["step"]: {k: r[k] for k in ("bound_ms", "bound_by", "busy_ms", "wall_ms",
                                                  "bound_over_busy", "useful_flops_ratio")}
                    for r in rows}})


def profiled(fn, top=12, watch=()):
    """Wall time of ``fn`` (untraced), then its device-busy time and top kernels (traced).

    ``fn`` is run twice and must do the same work each time. The idle share sets
    the traced run's device time against the untraced run's wall time, because
    tracing slows the host. Each name in ``watch`` also gets the summed time and
    count of the kernel rows whose name holds it, in the top rows or not.
    """
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    return {"wall_ms": wall_ms, "traced_wall_ms": traced_wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "device_kernel_launches": sum(r[1] for r in rows),
            "watched": {w: {"ms": sum(ms for ms, _, name in rows if w in name),
                            "count": sum(n for _, n, name in rows if w in name)}
                        for w in watch},
            "top_kernels": [{"ms": round(ms, 4), "count": n, "name": name[:80]}
                            for ms, n, name in rows[:top]]}


def phase_profile():
    """Where a prefill and a decode step spend their time (not part of the default run)."""
    cfg = registry.get("qwen2.5-3b")
    eng = ServeEngine(cfg, api.init(cfg, 0, device=DEV), slots=4, max_seq=1024, device=DEV)
    reqs = make_requests(cfg, 5, 512, 64)
    for r in reqs:
        eng.submit(r)
    for _ in range(3):                      # warm up: 4 prefills, 3 decode steps
        eng.step()
    spare = eng.queue.pop(0)
    pre = profiled(lambda: eng._prefill_slot(0, spare))
    steps = 4
    dec = profiled(lambda: [eng.step() for _ in range(steps)])
    for key in ("wall_ms", "traced_wall_ms", "device_busy_ms", "device_kernel_launches"):
        dec[key] = dec[key] / steps
    for row in dec["top_kernels"]:
        row["ms"], row["count"] = round(row["ms"] / steps, 4), row["count"] // steps
    emit({"phase": "profile", "model": cfg.name, "layers": cfg.num_layers,
          "prefill_512_tokens": pre, "decode_step_4_slots": dec})


def main(argv=None):
    # the plain versions and the library call run in full fp32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="device,build,kernels,sim,plan,serve,path,path_f32,moe,hybrid,"
                            "encdec,ssm,train,parallel,cost")
    ap.add_argument("--ptxas", action="store_true", help="print the compiler's resource report")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    smi = phase_device()
    if "build" in phases:
        phase_build(args.ptxas)
    kernels = phase_kernels() if "kernels" in phases else []
    sim_rows, plan_rows = [], []
    t_sim = time.time()
    if "sim" in phases:
        sim_rows, plan_rows = phase_sim(kernels, plan="plan" in phases)
    elif "plan" in phases:
        plan_rows = phase_plan()
        for row in plan_rows:
            emit(row)
    if "plan" in phases:
        plan_readings(sim_rows, plan_rows, time.time() - t_sim)
    if "serve" in phases:
        phase_serve(kernels)
    if "path" in phases:
        phase_path()
    if "path_f32" in phases:
        phase_path_f32(kernels)
    if "moe" in phases:
        phase_moe(kernels)
    if "hybrid" in phases:
        phase_hybrid(kernels)
    if "encdec" in phases:
        phase_encdec(kernels)
    if "ssm" in phases:
        phase_ssm(kernels)
    if "train" in phases:
        phase_train(kernels)
    if "parallel" in phases:
        phase_parallel(kernels)
    if "cost" in phases:
        phase_cost(smi)
    if "profile" in phases:
        phase_profile()
    torch.cuda.synchronize()
    complete = all(p in phases for p in ("build", "kernels", "sim", "plan", "serve", "path",
                                         "path_f32", "moe", "hybrid", "encdec", "ssm", "train",
                                         "parallel", "cost"))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": complete, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
    return 0 if complete else 4


if __name__ == "__main__":
    raise SystemExit(main())
