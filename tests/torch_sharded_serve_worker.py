"""One rank of a sharded serving run through ``serve.decode.make_prefill_step``
and ``make_serve_step`` with ``mesh=``, for the parity tests on gloo ranks
(``tests/test_torch_parallel_serve.py``), and the same run on cards over NCCL.

    python tests/torch_sharded_serve_worker.py RANK WORLD JOB_JSON

runs one rank of ``JOB_JSON`` (the test starts one process a rank on a
``file://`` store and reads rank 0's ``<out>.json``). The job's keys:
``arch``, ``mesh`` (data, model), ``batch``, ``prompt`` (its length),
``max_seq``, ``steps`` (decode steps after the prefill); optional
``replace`` (config fields; the reduced config in fp32 compute is the
default), ``seq_shard`` (the cache's long-context layout), ``residual``
(the activation scope's residual spec the steps run in, as a cell's plan
gives it: ``["data", "model", null]`` splits the prefill's residual by
sequence, ``serve.decode.seq_split``), ``states`` (every rank's blocks of
the prefill's cache written out, ``prefill_blocks``), ``store``, ``out``. The parameters
are ``api.init(cfg, 0)``'s, the prompts ``serve_inputs``'s: the test serves
the same on one device.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tests/torch_sharded_serve_worker.py --chip --arch qwen2.5-3b --out F.json

serves full-width ``arch`` in bf16 on one card a rank (NCCL; without
``torch.distributed.run``, one rank on one card): 8 prompts of 512 tokens
and 16 new tokens by default (qwen's traffic; an encoder-decoder's stub
frames ``frontend_len`` long), ``--tp`` model ranks (default: all), with
``--compare`` the same on one card (rank 0, after the mesh's run: the first
decode step's logits and the share of equal greedy tokens; needs the whole
model on one card), ``--cut num_layers=N`` to cut the depth. A first, short
run warms the card; the second is timed. It writes the prefill ms, each
decode step's ms, tokens/s, every rank's peak memory and the kernels' launch
counts to ``F.json``. ``--seq-acts`` serves the same prompts once more
inside the activation scope of ``REPRO_PERF``'s ``seq_shard_acts`` plan (the
residual split by sequence; the plan's ``attn_chunk`` / ``attn_pv_bf16``
have no kernel on the card, ROADMAP C15, and are not set) and reports that
run beside the first (``split``), its tokens and logits against the first's
and, with ``--compare``, against one card's, and the unsplit steps' ms once
more after it (unsplit, split, unsplit in turns). ``--long N`` runs the
long-context decode instead: batch 1 under the ``seq_shard`` layout, from a
cache of N positions filled with seeded values (no prefill), ``--new`` timed
steps after a warm one (``long_main``). ``--device cpu --reduced`` runs the same on gloo ranks on the
host, to rehearse.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention, flash_decode, ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import api, attention, moe, transformer
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as shd
from repro_torch.serve import decode

from torch_sharded_worker import STACK_BLOCKS


def serve_inputs(cfg, batch: int, prompt: int, seed: int = 0):
    """The prompts (numpy int64, (batch, prompt)) and, for a vlm, the prefix
    embeddings, for an encoder-decoder the stub frames (float32, (batch,
    frontend_len, d_model)), from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, prompt))}
    key = {"vlm": "embeds", "encdec": "frames"}.get(cfg.family)
    if key:
        out[key] = (0.5 * rng.standard_normal((batch, cfg.frontend_len, cfg.d_model))
                    ).astype(np.float32)
    return out


def dropped_in_first_group(idx, cfg, group=512):
    """(tokens, group size, dropped (token, choice) pairs of the first group)
    of one routing ``idx`` (T, k) in the einsum dispatch's groups."""
    T, k = idx.shape
    g = min(group, T)
    cap = max(1, int(g * k / cfg.num_experts * cfg.capacity_factor))
    first = idx[:g].reshape(-1)
    pos = torch.cumsum(torch.nn.functional.one_hot(first, cfg.num_experts), dim=0) - 1
    return [T, g, int((pos.gather(1, first[:, None]) >= cap).sum())]


SP_RESIDUAL = ("data", "model", None)       # a cell's residual spec split by sequence


def scoped(residual):
    """The activation scope of the residual spec ``residual`` (none: no scope)."""
    if residual is None:
        return contextlib.nullcontext()
    return pctx.activation_sharding(residual=tuple(residual))


class Recorder:
    """What a run's checks read, recorded while it serves: the logits each
    greedy token is taken from (gathered over a vocabulary split by
    ``model``), each MoE routing's first dispatch group (of the tokens the
    dispatch queues: under sequence parallelism the model ranks' rows
    gathered), the decode partials' calls (``_decode_blocks``) and the
    kernel seam's decode calls (a block with no filled row calls none), the
    input rows of every ``_block_apply`` call with whether the residual was
    split there, those of the hybrid, ssm and encdec stacks' blocks
    (``STACK_BLOCKS``) likewise, and any ``full_tensor``."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.logits, self.groups, self.block_rows, self.prefill = [], [], set(), None
        self.stack_rows, self.prefill_blocks = set(), None
        self.blocks, self.decode_calls, self.partials_calls, self.gathers = 0, 0, 0, 0

    def __enter__(self):
        self.saved = (decode.greedy, moe._routed, attention._decode_blocks, ops.decode_forward,
                      DTensor.full_tensor, transformer._block_apply)
        self.saved_fns = {k: getattr(m, f) for k, (m, f) in STACK_BLOCKS.items()}
        greedy, routed, blocks, decode_forward, full_tensor, block = self.saved

        def rec_greedy(logits):
            lay = pctx.layout()
            whole = logits
            if lay is not None and lay.vocab:
                whole = pctx.all_gather(logits, -1, pctx.model_group())
            self.logits.append(whole.float().reshape(whole.shape[0], -1).clone())
            return greedy(logits)

        def rec_routed(p, x, cfg):
            out = tuple(routed(p, x, cfg))
            self.groups.append(dropped_in_first_group(out[1], self.cfg))
            return out

        def rec_block(p, x, cfg, **kw):
            self.block_rows.add((int(x.shape[1]), pctx.seq_parallel()))
            return block(p, x, cfg, **kw)

        def rec_stack(key, fn):
            def run(p, x, *a, **kw):
                self.stack_rows.add((key, int(x.shape[1]), pctx.seq_parallel()))
                return fn(p, x, *a, **kw)
            return run

        def rec_blocks(*a, **kw):
            self.blocks += 1
            return blocks(*a, **kw)

        def rec_decode(*a, **kw):
            self.decode_calls += 1
            self.partials_calls += bool(kw.get("return_partials"))
            return decode_forward(*a, **kw)

        def rec_full(t, **kw):
            self.gathers += 1
            return full_tensor(t, **kw)

        decode.greedy, moe._routed, attention._decode_blocks = rec_greedy, rec_routed, rec_blocks
        ops.decode_forward, DTensor.full_tensor = rec_decode, rec_full
        transformer._block_apply = rec_block
        for key, (module, name) in STACK_BLOCKS.items():
            setattr(module, name, rec_stack(key, self.saved_fns[key]))
        return self

    def __exit__(self, *exc):
        (decode.greedy, moe._routed, attention._decode_blocks, ops.decode_forward,
         DTensor.full_tensor, transformer._block_apply) = self.saved
        for key, (module, name) in STACK_BLOCKS.items():
            setattr(module, name, self.saved_fns[key])


def one_device(cfg, params, inputs, max_seq: int, steps: int, device="cpu"):
    """The unsharded steps over the same prompts: (greedy tokens (B, 1 +
    steps), a ``Recorder`` whose ``ms`` holds the prefill's and each decode
    step's ms)."""
    prefill = decode.make_prefill_step(cfg, max_seq=max_seq)
    step = decode.make_serve_step(cfg)
    batch = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
    with Recorder(cfg) as rec:
        t0 = _clock(device)
        tok, cache = prefill(params, batch)
        rec.ms = [_clock(device) - t0]
        toks = [tok]
        for _ in range(steps):
            t0 = _clock(device)
            tok, cache = step(params, cache, tok)
            rec.ms.append(_clock(device) - t0)
            toks.append(tok)
    return torch.cat(toks, dim=1), rec


def _rows_of_every_rank(x, block):
    """The data ranks' rows of ``x`` joined in batch order (every rank's
    copy; ``x`` itself where every rank serves the whole batch)."""
    if not block.rows_split:
        return x
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (block.rows[0], x.cpu()))
    seen = {}
    for first, rows in parts:
        seen.setdefault(first, rows)
    return torch.cat([seen[k] for k in sorted(seen)], dim=0)


def profile_summary(prof, wall_ms, n=10):
    """A profiled window's wall and device-busy ms, its NCCL kernels' ms,
    and its heaviest host ops (self CPU ms) and device kernels (ms)."""
    rows = prof.key_averages()
    dev = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3) for e in rows
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ms for _, ms in dev)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in rows),
                  key=lambda r: -r[1])[:n]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "nccl_ms": sum(ms for k, ms in dev if "nccl" in k.lower()),
            "top_host_ops": host, "top_kernels": sorted(dev, key=lambda r: -r[1])[:n]}


def prefill_record(cache):
    """The prefill's cache on this rank: ``idx``, and the positions of its
    block of the self K stack that hold a value in some layer, row or head
    (``None`` for a family without one)."""
    kv = next((cache[k] for k in ("k", "attn_k") if k in cache), None)
    if kv is None:
        return {"idx": cache["idx"], "filled": None}
    k = kv.to_local() if isinstance(kv, DTensor) else kv
    filled = (k.abs().amax(dim=(0, 1, 3, 4)) > 0).nonzero().flatten().tolist()
    return {"idx": cache["idx"], "filled": filled}


def serve(cfg, mesh, params, inputs, max_seq, steps, seq_shard, device, profile=False,
          residual=None):
    """The sharded steps over the prompts, inside the activation scope of
    ``residual`` where given: (tokens (B, 1 + steps) of every rank's rows,
    the ``CacheBlock``, the cache's local shape, a ``Recorder`` (its
    ``prefill``: ``prefill_record`` of the prefill's cache; its
    ``prefill_blocks``: ``local_blocks`` of it, on the host), ms of the
    prefill and of each decode step); with ``profile`` the last decode step
    runs under ``torch.profiler`` and its summary (``profile_summary``) is
    the sixth."""
    prefill = decode.make_prefill_step(cfg, max_seq=max_seq, mesh=mesh, seq_shard=seq_shard)
    step = decode.make_serve_step(cfg, mesh=mesh, seq_shard=seq_shard)
    batch = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
    block = shd.cache_block(cfg, mesh, batch=batch["tokens"].shape[0], max_seq=max_seq,
                            seq_shard=seq_shard)
    tok_pl = shd.placements((block.spec[1], None), mesh)
    ms, summary = [], None
    with Recorder(cfg) as rec, scoped(residual):
        t0 = _clock(device)
        tok, cache = prefill(params, batch)
        ms.append(_clock(device) - t0)
        if torch.device(device).type == "cpu":      # on a card: not to move the peak
            rec.prefill = prefill_record(cache)
            rec.prefill_blocks = local_blocks(cache)
        toks = [tok]
        for i in range(steps):
            glob = DTensor.from_local(tok, mesh, tok_pl,
                                      shape=(batch["tokens"].shape[0], 1), stride=(1, 1))
            traced = profile and i == steps - 1
            with (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                     torch.profiler.ProfilerActivity.CUDA])
                  if traced else contextlib.nullcontext()) as prof:
                t0 = _clock(device)
                tok, cache = step(params, cache, glob)
                ms.append(_clock(device) - t0)
            if traced:
                summary = profile_summary(prof, ms[-1])
            toks.append(tok)
    return torch.cat(toks, dim=1), block, local_shapes(cache), rec, ms, summary


def local_shapes(cache):
    """{"/"-joined path: the rank's block's shape} of each cache tensor."""
    return {"/".join(map(str, path)): tuple(t.to_local().shape)
            for path, t in tree.leaves_with_paths({k: v for k, v in cache.items()
                                                   if k != "idx"})}


def local_blocks(cache):
    """{"/"-joined path: a copy of the rank's block} of each cache tensor (the
    decode steps write the K/V blocks in place)."""
    return {"/".join(map(str, path)): t.to_local().clone()
            for path, t in tree.leaves_with_paths({k: v for k, v in cache.items()
                                                   if k != "idx"})}


def kv_local_shape(local):
    """The local shape of the self K/V stack among ``local_shapes``' (``None``
    for a family without one)."""
    return next((local[k] for k in ("k", "attn_k") if k in local), None)


def block_dict(block):
    """A ``CacheBlock`` as plain data, its ``cross`` block too."""
    out = {"rows": block.rows, "seq": block.seq, "heads": block.heads,
           "seq_axes": block.seq_axes, "spec": block.spec}
    if block.cross is not None:
        out["cross"] = block_dict(block.cross)
    return out


def _clock(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() * 1e3


def run_job(rank, world, job):
    """One rank of a parity job on gloo (the module's docstring)."""
    dist.init_process_group("gloo", init_method="file://" + job["store"], rank=rank,
                            world_size=world)
    cfg = dataclasses.replace(registry.get(job["arch"]).reduced(),
                              **{"compute_dtype": "float32", **job.get("replace", {})})
    mesh = make_mesh(tuple(job["mesh"]), ("data", "model"))
    whole = api.init(cfg, 0, device="cpu")
    params = decode.shard_params(cfg, whole, mesh)
    # no rank holds a leaf the layout splits whole; a Segments leaf is its
    # rank-major layout, the one-device leaf again through the inverse map
    major = shd.rank_major(cfg, whole, mesh)
    for a, b in zip(tree.leaves(shd.one_device(cfg, major, mesh)), tree.leaves(whole)):
        assert torch.equal(a, b)
    for p, w in zip(tree.leaves(params), tree.leaves(major)):
        assert isinstance(p, DTensor) and p.shape == w.shape
        split = any(pl.is_shard() for pl in p.placements)
        assert (p.to_local().numel() < w.numel()) == split
    # the drawn-and-placed build holds the same blocks, in fp32 and cast to bf16
    for dt in (None, torch.bfloat16):
        want = decode.shard_params(cfg, api.cast_params(cfg, whole, dt), mesh)
        got = decode.init_params(cfg, mesh, 0, device="cpu", dtype=dt)
        for a, b in zip(tree.leaves(got), tree.leaves(want)):
            assert a.placements == b.placements and a.shape == b.shape
            assert torch.equal(a.to_local(), b.to_local()) and a.dtype == b.dtype
    del whole
    inputs = serve_inputs(cfg, job["batch"], job["prompt"])
    toks, block, local, rec, _, _ = serve(cfg, mesh, params, inputs, job["max_seq"],
                                          job["steps"], job.get("seq_shard", False), "cpu",
                                          residual=job.get("residual"))
    assert not rec.gathers
    with scoped(job.get("residual")):
        seq = decode.seq_split(cfg, mesh, {k: torch.from_numpy(v) for k, v in inputs.items()})
    out = {"tokens": _rows_of_every_rank(toks, block).tolist(),
           "seq_split": seq, "block_rows": sorted(rec.block_rows),
           "stack_rows": sorted(rec.stack_rows),
           "logits": [_rows_of_every_rank(x, block).tolist() for x in rec.logits],
           "moe_groups": rec.groups,
           "block": block_dict(block),
           "cache_local_shape": kv_local_shape(local), "cache_local_shapes": local,
           "decode_blocks": rec.blocks, "decode_calls": rec.decode_calls,
           "partials_calls": rec.partials_calls, "prefill_cache": rec.prefill,
           "layout": dataclasses.asdict(shd.model_layout(cfg, job["mesh"][1]))}
    every = [None] * world
    dist.all_gather_object(every, {k: out[k] for k in ("block", "cache_local_shape",
                                                       "cache_local_shapes", "decode_blocks",
                                                       "decode_calls", "partials_calls",
                                                       "prefill_cache", "block_rows",
                                                       "stack_rows")}
                           | ({"prefill_blocks": {k: v.tolist() for k, v in
                                                  rec.prefill_blocks.items()}}
                              if job.get("states") else {}))
    out["ranks"] = every
    if rank == 0:
        with open(job["out"] + ".json", "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the same run on cards
# ---------------------------------------------------------------------------

def _launches():
    return {"flash_attention": flash_attention.launches, "flash_decode": flash_decode.launches}


def _peak(dev):
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


_KV_KEYS = ("k", "v", "attn_k", "attn_v")


def seeded_cache(cfg, mesh, batch: int, max_seq: int, idx: int, device, chunk: int = 4096):
    """A decode cache of ``batch`` rows and ``max_seq`` positions filled with
    seeded values, at ``idx``: with ``mesh``, this rank's blocks as
    ``DTensor``s placed as the long-context serving layout places them
    (``sharding.serve_cache_specs`` with ``seq_shard``), each drawn without
    drawing the whole; without, the whole cache on one device. Both hold the
    same values: a K/V stack is drawn by layer and ``chunk`` positions, every
    head at once, and cut to the rank's heads and positions; a state (small)
    is drawn whole (0.1 of a normal draw) and cut, a Mamba2 ``conv`` state
    through its rank-major layout (``sharding.rank_major_cache``)."""
    one = api.init_cache(cfg, batch, max_seq, dtype=cfg.compute_dtype, device="meta")
    parts = {k: v for k, v in one.items() if k != "idx"}
    specs = (shd.serve_cache_specs(cfg, mesh, batch=batch, max_seq=max_seq, seq_shard=True)
             if mesh is not None else [None] * len(tree.leaves(parts)))
    tp = 1 if mesh is None else shd.axis_sizes(mesh)["model"]
    major = dict(shd.rank_major_cache(cfg, one, mesh) if mesh is not None else one)
    f32 = dict(dtype=torch.float32, device=device)

    def block(spec, dim, size):
        return (0, size) if spec is None else shd.entry_block(mesh, spec[dim], size)

    local = []
    for i, ((path, x), spec) in enumerate(zip(tree.leaves_with_paths(parts), specs)):
        if path[0] in _KV_KEYS:
            L, B, S, H, D = x.shape
            (r0, nr), (s0, ns), (h0, nh) = (block(spec, d, x.shape[d]) for d in (1, 2, 3))
            t = torch.empty((L, nr, ns, nh, D), dtype=x.dtype, device=device)
            for layer in range(L):
                for c in range(s0 // chunk, -(-(s0 + ns) // chunk)):
                    g = torch.Generator(device=device).manual_seed(
                        (i * 1000 + layer) * 100000 + c)
                    draw = torch.randn((B, chunk, H, D), generator=g, **f32).to(x.dtype)
                    t[layer, :, c * chunk - s0:(c + 1) * chunk - s0] = \
                        draw[r0:r0 + nr, :, h0:h0 + nh]
        else:
            g = torch.Generator(device=device).manual_seed(i)
            t = (0.1 * torch.randn(tuple(x.shape), generator=g, **f32)).to(x.dtype)
            if spec is not None:
                if path[-1] == "conv" and tp > 1 and spec[-1] == "model":
                    t = shd.conv_segments(cfg).to_rank_major(t, t.dim() - 1, tp)
                for d, e in enumerate(spec):
                    if e is not None:
                        t = t.narrow(d, *shd.entry_block(mesh, e, t.shape[d])).clone()
        local.append(t)
    if mesh is not None:
        glob = tree.leaves({k: v for k, v in major.items() if k != "idx"})
        local = [DTensor.from_local(t, mesh, shd.placements(spec, mesh), shape=g.shape,
                                    stride=g.stride())
                 for t, spec, g in zip(local, specs, glob)]
    cache = tree.rebuild(parts, local)
    cache["idx"] = idx
    return cache


def decode_steps(cfg, mesh, params, cache, n: int, device):
    """``n`` greedy decode steps from ``cache`` (batch 1, the long-context
    layout over ``mesh``; one device without), from token 7: (tokens (1, n),
    a ``Recorder``, ms of each step)."""
    step = decode.make_serve_step(cfg, mesh=mesh, seq_shard=mesh is not None)
    tok = torch.full((1, 1), 7, dtype=torch.int32, device=device)
    toks, ms = [], []
    with Recorder(cfg) as rec:
        for _ in range(n):
            t0 = _clock(device)
            tok, cache = step(params, cache, tok)
            ms.append(_clock(device) - t0)
            toks.append(tok)
    return torch.cat(toks, dim=1), rec, ms


def one_card_params(cfg, dev):
    """The whole model's serving parameters on one card, each part cast to
    the compute type as it is drawn (``api.init``'s ``place``): the values
    of ``api.cast_params(cfg, api.init(cfg, 0))`` without the whole fp32
    tree beside them."""
    return api.init(cfg, 0, device=dev, place=lambda key, part: api.cast_params(
        cfg, {key: part})[key])


def _against(got, want):
    """Max absolute and relative (to max(|x|, 1)) difference of two logits."""
    diff = (got.cpu() - want.cpu()).abs()
    return {"max_abs": float(diff.max()),
            "max_rel": float((diff / want.cpu().abs().clamp(min=1.0)).max())}


def long_main(args, cfg, mesh, dev, rank, world):
    """``--long N``: the long-context decode cell at batch 1, no prefill: a
    cache of N positions filled with seeded values (``seeded_cache``), one
    warm decode step then ``--new`` timed ones, the last writing position N -
    1; with ``--compare`` the same on one card (rank 0)."""
    n = args.new
    idx = args.long - n - 1
    _reset_peak(dev)
    t0 = time.perf_counter()
    params = decode.init_params(cfg, mesh, 0, device=dev)
    cache = seeded_cache(cfg, mesh, 1, args.long, idx, dev)
    set_up_s, set_up_peak = time.perf_counter() - t0, _peak(dev)
    before = _launches()
    toks, rec, ms = decode_steps(cfg, mesh, params, cache, n + 1, dev)
    launches = {k: v - before[k] for k, v in _launches().items()}
    peaks = [None] * world
    dist.all_gather_object(peaks, [set_up_peak, _peak(dev)])
    block = shd.cache_block(cfg, mesh, batch=1, max_seq=args.long, seq_shard=True)
    out = {"arch": cfg.name, "cut": args.cut, "mesh": dict(zip(("data", "model"), mesh.shape)),
           "long": args.long, "start_idx": idx, "new_tokens": n,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "compute_dtype": cfg.compute_dtype,
           "layout": dataclasses.asdict(shd.model_layout(cfg, mesh.shape[1])),
           "cache_block": dict(block_dict(block), local_shapes=local_shapes(cache)),
           "set_up_s": set_up_s, "warm_step_ms": ms[0], "decode_ms": ms[1:],
           "launches": launches, "decode_partials_calls": rec.partials_calls,
           "set_up_peak_gb": [p[0] for p in peaks], "steps_peak_gb": [p[1] for p in peaks]}
    logits = [x.cpu() for x in rec.logits]
    del params, cache, rec
    _reset_peak(dev)
    if args.compare and rank == 0:
        whole = one_card_params(cfg, dev)
        one_toks, one_rec, one_ms = decode_steps(
            cfg, None, whole, seeded_cache(cfg, None, 1, args.long, idx, dev), n + 1, dev)
        out["one_card"] = {"peak_gb": _peak(dev), "decode_ms": one_ms[1:]}
        # each step's logits against one card's (relative to max(|x|, 1)): a
        # step after the first token that differs reads another sequence
        out["logits_max_rel_by_step"] = [
            float(((a - b.cpu()).abs() / b.cpu().abs().clamp(min=1.0)).max())
            for a, b in zip(logits, one_rec.logits)]
        out["tokens_equal_by_step"] = (one_toks.cpu() == toks.cpu())[0].tolist()
        del whole, one_rec
    return out


def chip_main(argv):
    ap = argparse.ArgumentParser(prog="torch_sharded_serve_worker.py --chip")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--new", type=int, default=16, help="new tokens a prompt")
    ap.add_argument("--tp", type=int, default=None, help="model ranks (default: all)")
    ap.add_argument("--cut", action="append", default=[], metavar="FIELD=N",
                    help="a config field's value, to cut the depth (repeated)")
    ap.add_argument("--compare", action="store_true",
                    help="serve the same on one card after the mesh's run (rank 0)")
    ap.add_argument("--device", default="cuda",
                    help="cpu: gloo ranks on the host, to rehearse (with --reduced)")
    ap.add_argument("--reduced", action="store_true", help="the reduced config")
    ap.add_argument("--dtype", default=None, help="the compute type (the config's by default)")
    ap.add_argument("--profile", action="store_true",
                    help="the last decode step (and one card's, with --compare) profiled")
    ap.add_argument("--seq-acts", action="store_true",
                    help="serve once more with the prefill's residual split by sequence "
                         "(REPRO_PERF's seq_shard_acts scope), reported as 'split'")
    ap.add_argument("--long", type=int, default=None, metavar="N",
                    help="the long-context decode at batch 1 from a seeded cache of N "
                         "positions (long_main), no prefill")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    rank, world = int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))
    cuda = args.device == "cuda"
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))) if cuda else \
        torch.device("cpu")
    backend = dict(backend="nccl", device_id=dev) if cuda else dict(backend="gloo")
    if cuda:
        torch.cuda.set_device(dev)
    store = None
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(**backend)
    else:                               # one rank without torch.distributed.run
        store = os.path.abspath(args.out) + ".store"
        if os.path.exists(store):
            os.remove(store)
        dist.init_process_group(init_method="file://" + store, rank=0, world_size=1, **backend)
    tp = args.tp or world
    cut = {k: int(v) for k, v in (c.split("=", 1) for c in args.cut)}
    cfg = registry.get(args.arch)
    cfg = dataclasses.replace(cfg.reduced() if args.reduced else cfg, **cut,
                              **({"compute_dtype": args.dtype} if args.dtype else {}))
    mesh = make_mesh((world // tp, tp), ("data", "model"))
    if args.long:
        out = long_main(args, cfg, mesh, dev, rank, world)
        _finish(args, out, rank, store)
        return
    max_seq = args.prompt + args.new
    inputs = serve_inputs(cfg, args.batch, args.prompt)
    _reset_peak(dev)
    t0 = time.perf_counter()
    params = decode.init_params(cfg, mesh, 0, device=dev)
    set_up_s = time.perf_counter() - t0
    set_up_peak = _peak(dev)
    # a first run warms the card (kernel loads, cuBLAS handles, NCCL channels);
    # the second is timed
    serve(cfg, mesh, params, inputs, max_seq, 1, False, dev)
    _reset_peak(dev)
    before = _launches()
    toks, block, local, rec, ms, prof = serve(cfg, mesh, params, inputs, max_seq,
                                              args.new - 1, False, dev, profile=args.profile)
    launches = {k: v - before[k] for k, v in _launches().items()}
    steps_peak = _peak(dev)
    toks = _rows_of_every_rank(toks, block)
    first_logits = _rows_of_every_rank(rec.logits[1], block)
    peaks = [None] * world
    dist.all_gather_object(peaks, [set_up_peak, steps_peak])
    out = {"arch": cfg.name, "cut": cut, "mesh": {"data": world // tp, "model": tp},
           "batch": args.batch, "prompt": args.prompt, "new_tokens": args.new,
           "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "layout": dataclasses.asdict(shd.model_layout(cfg, tp)),
           "cache_block": dict(block_dict(block), local_shapes=local),
           "set_up_s": set_up_s, "prefill_ms": ms[0], "decode_ms": ms[1:],
           "tokens_per_s": args.batch * args.new / (sum(ms) / 1e3),
           "decode_tokens_per_s": args.batch * (args.new - 1) / (sum(ms[1:]) / 1e3),
           "launches": launches, "decode_partials_calls": rec.partials_calls,
           "set_up_peak_gb": [p[0] for p in peaks], "steps_peak_gb": [p[1] for p in peaks],
           "compute_dtype": cfg.compute_dtype, "profiled_decode_step": prof}
    prefill_logits = _rows_of_every_rank(rec.logits[0], block)
    del rec
    split = None
    if args.seq_acts:
        split, s_toks, s_logits = split_run(cfg, mesh, params, inputs, max_seq, args.new, dev,
                                            block, world)
        split["tokens_equal_unsplit"] = float((s_toks.cpu() == toks.cpu()).float().mean())
        split["prefill_logits_against_unsplit"] = _against(s_logits[0], prefill_logits)
        split["first_decode_logits_against_unsplit"] = _against(s_logits[1], first_logits)
        # the unsplit steps once more, after the split: unsplit, split, unsplit in turns
        *_, again, _ = serve(cfg, mesh, params, inputs, max_seq, args.new - 1, False, dev)
        split["unsplit_again_ms"] = {"prefill": again[0], "decode": again[1:]}
        out["split"] = split
    del params
    _reset_peak(dev)
    if args.compare and rank == 0:
        whole = one_card_params(cfg, dev)
        one_device(cfg, whole, inputs, max_seq, 1, device=dev)           # warm
        t0 = _clock(dev)
        one, one_rec = one_device(cfg, whole, inputs, max_seq, args.new - 1, device=dev)
        one_ms = _clock(dev) - t0
        want = one_rec.logits[1].cpu()
        first = _against(first_logits, want)
        out["one_card"] = {"peak_gb": _peak(dev), "serve_ms": one_ms,
                           "prefill_ms": one_rec.ms[0], "decode_ms": one_rec.ms[1:],
                           "tokens_per_s": args.batch * args.new / (one_ms / 1e3)}
        out["equal_token_share"] = float((one.cpu() == toks.cpu()).float().mean())
        out["first_decode_logits_max_abs"] = first["max_abs"]
        out["first_decode_logits_max_rel"] = first["max_rel"]
        out["prefill_logits_against_one_card"] = _against(prefill_logits, one_rec.logits[0])
        if split is not None:
            split["tokens_equal_one_card"] = float((one.cpu() == s_toks.cpu()).float().mean())
            split["prefill_logits_against_one_card"] = _against(s_logits[0], one_rec.logits[0])
            split["first_decode_logits_against_one_card"] = _against(s_logits[1], want)
        del whole
    _finish(args, out, rank, store)


def split_run(cfg, mesh, params, inputs, max_seq, new, dev, block, world):
    """``--seq-acts``: the same prompts served inside the activation scope of
    ``REPRO_PERF``'s ``seq_shard_acts`` plan (``SP_RESIDUAL``: the prefill's
    residual split by sequence, ``serve.decode.seq_split``), a short warm
    run first: (its record, tokens of every rank's rows, the prefill's and
    the first decode step's logits)."""
    serve(cfg, mesh, params, inputs, max_seq, 1, False, dev, residual=SP_RESIDUAL)
    _reset_peak(dev)
    before = _launches()
    toks, _, local, rec, ms, _ = serve(cfg, mesh, params, inputs, max_seq, new - 1, False, dev,
                                       residual=SP_RESIDUAL)
    launches = {k: v - before[k] for k, v in _launches().items()}
    peaks = [None] * world
    dist.all_gather_object(peaks, _peak(dev))
    with scoped(SP_RESIDUAL):
        seq = decode.seq_split(cfg, mesh, {k: torch.from_numpy(v) for k, v in inputs.items()})
    record = {"residual": SP_RESIDUAL, "seq_split": seq[0], "seq_stacks": seq[1],
              "prefill_ms": ms[0], "decode_ms": ms[1:], "launches": launches,
              "steps_peak_gb": peaks,
              "cache_local_shapes": local}
    logits = [_rows_of_every_rank(x, block) for x in rec.logits[:2]]
    return record, _rows_of_every_rank(toks, block), logits


def _finish(args, out, rank, store):
    """Rank 0 writes ``out`` to ``--out`` and prints it; every rank leaves
    the group."""
    if rank == 0:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()
    if store is not None and os.path.exists(store):
        os.remove(store)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--chip"]:
        chip_main(sys.argv[2:])
    else:
        run_job(int(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3]))
