#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py                  # everything, as the acceptance run
    python3 chip_smoke.py --phases device,build,kernels   # a short first check

Phases, each printing one JSON line:
  device   the card (torch and nvidia-smi), torch / CUDA / nvcc versions
  build    first use of the kernels' build (one nvcc per source, in parallel)
  kernels  each hand-written kernel against its plain PyTorch version on the
           card over a grid of shapes (fp32 at 2e-5 through flash_fwd.cu and
           flash_decode.cu, bf16 at 2e-2 through flash_fwd_sm90.cu and
           flash_decode_sm90.cu), and timed at the serving shapes and at a
           long context beside its plain version, one library call (a
           yardstick only: the port never calls it) and its roofline bound.
           Kernel and library times are device times (kernel durations from
           torch.profiler); wrapper_ms is the host-clocked time of a call
           through the wrapper; a decode call must run one device kernel
  serve    qwen2.5-3b at full width and depth, bf16, random seeded weights:
           8 requests of 512 prompt tokens through ServeEngine (4 slots,
           16 new tokens each); asserts the kernels' launch counts
  path     the same engine at 4 layers, once through the kernels and once with
           mode="reference", from the same weights: first-step logits compared
  path_f32 the model in float32 at 2 layers: the engine's prefills go through
           the fp32 kernel (launch counts asserted), and first-step logits
           match mode="reference" at 1e-3
  profile  (only when named in --phases) one prefill and four decode steps of
           the full model under torch.profiler: wall time, device-busy time,
           idle share and the kernels that take most of the device time
Then one line {"kernels": [...]}, the card's name and power limit, and the last
line {"ok": true, "device": {...}}. Any failing phase ends the run non-zero.
Needs a CUDA device and nvcc; imports torch and the port only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import registry                      # noqa: E402
from repro_torch.kernels import _build, ops                   # noqa: E402
from repro_torch.kernels import flash_attention as fa         # noqa: E402
from repro_torch.kernels import flash_decode as fd            # noqa: E402
from repro_torch.models import api                            # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine     # noqa: E402

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
]
FWD_EXTRA = [  # causal, both types: deep K/V rings, many diagonal tiles
    (1, 16, 2, 1024, 1024, 64),
    (2, 32, 8, 2048, 2048, 128),
    (1, 4, 2, 12, 12, 16),         # the launcher's default (reduced) width
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
]
SERVE_FWD = dict(B=1, H=16, Hkv=2, L=512, D=128)
LONG_FWD = (2, 32, 8, 2048, 128)   # B, H, Hkv, L = S, D
SERVE_DEC = dict(B=4, H=16, Hkv=2, S_max=1024, D=128, clen=520, layers=36)
LONG_DEC = dict(B=4, H=16, Hkv=2, D=128, clen=32768)


def emit(obj):
    print(json.dumps(obj), flush=True)


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


def device_profile(fn, iters=20, warmup=3, attempts=3, calls=1):
    """Device time of one call of ``fn`` and the device kernels that each of the
    ``calls`` wrapper calls inside ``fn`` launches: the durations of the kernels
    of ``iters`` calls of ``fn`` (torch.profiler), summed, over ``iters``, and
    their count over ``iters * calls``. Gaps between kernels do not count, so
    the host's enqueue rate cannot hide the kernels' own time. The profiler has
    been seen to return a window with kernel records missing: a window whose
    kernel count is not a whole multiple of ``iters * calls`` is taken again."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        launched = sum(r[1] for r in rows)
        if launched and launched % (iters * calls) == 0:
            return sum(r[0] for r in rows) / iters, launched // (iters * calls)
    raise AssertionError(f"the profiler recorded no whole window of {iters} x {calls} "
                         f"calls in {attempts} attempts")


def device_ms(fn, iters=20, warmup=3, attempts=3):
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


def time_decode(rng, dt):
    """Times decode at the serving shape, cycling over the 36 layers' slices of
    one cache as a decode step does, so that each launch finds its K/V rows
    cold in L2; checks the first and last layer through ops (strided views)
    and the library call. Returns (timings, worst error)."""
    s = SERVE_DEC
    cache_k = randn(rng, (s["layers"], s["B"], s["S_max"], s["Hkv"], s["D"]), dt)
    cache_v = randn(rng, (s["layers"], s["B"], s["S_max"], s["Hkv"], s["D"]), dt)
    qd = randn(rng, (s["B"], 1, s["H"], s["D"]), dt)
    clen = s["clen"]
    worst = 0.0
    for layer in (0, s["layers"] - 1):
        got = ops.decode_forward(qd, cache_k[layer], cache_v[layer], clen)
        torch.cuda.synchronize()
        want = ops.decode_forward(qd, cache_k[layer], cache_v[layer], clen, mode="reference")
        worst = max(worst, compare(got, want, dt, f"flash_decode {dt} serving shape via ops, "
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
    bound_ms = bound(*dec_costs(s["B"], s["H"], s["Hkv"], s["D"], s["clen"], dt))[0]
    return dict(at="B{B} H{H} Hkv{Hkv} cache_len{clen} D{D} ".format(**s) + str(dt)[6:],
                ms=ms, library_ms=device_ms(lambda: sdpa(qdt, kt, vt, False)),
                bound_ms=bound_ms, share_of_3_35_tb_s=bound_ms / ms), err


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
            wrapper_ms=time_ms(lambda: ops.mha_forward(q, k, v, causal=True)),
            plain_ms=time_ms(lambda: ops.mha_forward(q, k, v, causal=True, mode="reference"),
                             iters=10),
            library_ms=device_ms(lambda: sdpa(qt, kt, vt, True)),
            library_wrapper_ms=time_ms(lambda: sdpa(qt, kt, vt, True)))
        fwd[name]["bound_ms"], fwd[name]["bound_by"] = bound(
            *fwd_costs(s["B"], s["H"], s["Hkv"], s["L"], s["L"], s["D"], dt, True))

    # both kernels at a long context as well (more K/V tiles than ring stages)
    B, H, Hkv, L, D = LONG_FWD
    for dt in (torch.bfloat16, torch.float32):
        name = "flash_fwd" if dt == torch.bfloat16 else "flash_fwd_f32"
        q = randn(rng, (B, L, H, D), dt)
        k = randn(rng, (B, L, Hkv, D), dt)
        v = randn(rng, (B, L, Hkv, D), dt)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fwd[name]["long"] = dict(
            at=f"B{B} H{H} Hkv{Hkv} L=S={L} D{D} causal {str(dt)[6:]}",
            ms=device_ms(lambda: ops.mha_forward(q, k, v, causal=True)),
            library_ms=device_ms(lambda: sdpa(qt, kt, vt, True)),
            bound_ms=bound(*fwd_costs(B, H, Hkv, L, L, D, dt, True))[0])
        del q, k, v, qt, kt, vt

    # decode in both types at the serving shape and at a long cache
    dec = {}
    for dt in (torch.bfloat16, torch.float32):
        name = "flash_decode" if dt == torch.bfloat16 else "flash_decode_f32"
        dec[name], err = time_decode(rng, dt)
        dec[name]["long"], err_long = time_long_decode(rng, dt)
        worst[name] = max(worst[name], err, err_long)
        cases[name] += 3

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

    eng._prefill_slot = timed_prefill
    for r in reqs:
        eng.submit(r)
    while eng.queue or any(eng.active):
        before = sum(prefill_ms)
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3 - (sum(prefill_ms) - before))
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


def profiled(fn, top=12):
    """Wall time of ``fn`` (untraced), then its device-busy time and top kernels (traced).

    ``fn`` is run twice and must do the same work each time. The idle share sets
    the traced run's device time against the untraced run's wall time, because
    tracing slows the host.
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
    ap.add_argument("--phases", default="device,build,kernels,serve,path,path_f32")
    ap.add_argument("--ptxas", action="store_true", help="print the compiler's resource report")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    smi = phase_device()
    if "build" in phases:
        phase_build(args.ptxas)
    kernels = phase_kernels() if "kernels" in phases else []
    if "serve" in phases:
        phase_serve(kernels)
    if "path" in phases:
        phase_path()
    if "path_f32" in phases:
        phase_path_f32(kernels)
    if "profile" in phases:
        phase_profile()
    torch.cuda.synchronize()
    complete = all(p in phases for p in ("build", "kernels", "serve", "path", "path_f32"))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": complete, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
    return 0 if complete else 4


if __name__ == "__main__":
    raise SystemExit(main())
